"""obs/ — the telemetry the serving path reports through: the metrics
registry (counters, gauges, histograms) and trace spans, copies of the
JAX package's stdlib-only ``obs/metrics.py`` and ``obs/trace.py``.

The JAX package's flight recorder, run ledger and live scrape server
(``obs/recorder.py``, ``ledger.py``, ``serve.py``) are not ported yet;
``serving/serve_lm.py`` refuses their environment variables by name.
"""

from distributedtensorflowexample_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, registry)
from distributedtensorflowexample_tpu_torch.obs.trace import (  # noqa: F401
    add_sink, event, remove_sink, span)
