"""obs/ — the telemetry the port reports through, copies of the JAX
package's stdlib-only ``obs/`` modules: the metrics registry (counters,
gauges, histograms: ``metrics.py``), trace spans (``trace.py``), the
flight recorder (``recorder.py``: ``OBS_FLIGHT``), the run ledger
(``ledger.py``: ``OBS_LEDGER``) and the live scrape server
(``serve.py``: ``OBS_HTTP_PORT``).  The trainers (``engine/engine.py``,
``training/hooks.MetricsHook``) and ``serving/serve_lm.py`` arm them where
the JAX package's entry points do.
"""

from distributedtensorflowexample_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, registry)
from distributedtensorflowexample_tpu_torch.obs.trace import (  # noqa: F401
    add_sink, event, remove_sink, span)
