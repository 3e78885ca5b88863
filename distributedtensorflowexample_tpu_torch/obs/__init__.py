"""obs/ — the telemetry the port reports through, copies of the JAX
package's stdlib-only ``obs/`` modules: the metrics registry (counters,
gauges, histograms: ``metrics.py``), trace spans (``trace.py``), the
flight recorder (``recorder.py``: ``OBS_FLIGHT``), the run ledger
(``ledger.py``: ``OBS_LEDGER``), the live scrape server (``serve.py``:
``OBS_HTTP_PORT``), the online anomaly detectors and ``health.json``
(``anomaly.py``: ``OBS_HEALTH``), the Prometheus-text and JSONL exporters
(``export.py``) and the cross-rank timeline (``timeline.py``).  The
trainers (``engine/engine.py``, ``training/hooks.MetricsHook`` and
``AnomalyHook``) and ``serving/serve_lm.py`` arm them where the JAX
package's entry points do.
"""

from distributedtensorflowexample_tpu_torch.obs.anomaly import (  # noqa: F401
    EwmaRegression, PlateauSentinel, RunHealth, detect_skew, read_health,
    write_health)
from distributedtensorflowexample_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, registry)
from distributedtensorflowexample_tpu_torch.obs.trace import (  # noqa: F401
    add_sink, event, remove_sink, span)
