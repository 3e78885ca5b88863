"""serving/ — continuous-batching LM inference (the JAX package's
``serving/``), the read path the training stack's snapshots promote into:

- :mod:`.engine` — prefill and the decode step over a preallocated
  per-slot KV cache written in place, on the training ``TransformerLM``'s
  own submodules; :data:`~.engine.DECODE_CONTRACT` and its checker;
- :mod:`.promote` — snapshot → serving promotion over the SnapshotStore
  validity checks (a torn newest snapshot falls back), the canary;
- :mod:`.queue` — the request queue and the continuous batcher: requests
  admitted into open decode slots at step boundaries, bucketed batched
  prefill, a latency-SLO admission knob, drain, p50/p99 and tokens/s
  through the ``obs/`` registry;
- :mod:`.sampling`, :mod:`.prefix`, :mod:`.spec` — per-request sampling
  lanes, prefix-cache sharing, speculative decoding;
- :mod:`.loadgen`, :mod:`.frontend` — the closed-loop load generator and
  the opt-in stdlib HTTP request front;
- :mod:`.sharded` — the params-stay-sharded engine: ZeRO-3's
  per-bucket gathers and a slot-sharded KV cache over D ranks
  (``serve_lm --sharded_mesh D``);
- :mod:`.serve_lm` — the serving worker's entry point.
"""

from distributedtensorflowexample_tpu_torch.serving.engine import (  # noqa: F401
    DECODE_CONTRACT, DecodeEngine, ServingLM, check_decode_contract,
    serving_lm_for)
from distributedtensorflowexample_tpu_torch.serving.promote import (  # noqa: F401
    PromotedModel, init_lm_snapshot, promote)
from distributedtensorflowexample_tpu_torch.serving.queue import (  # noqa: F401
    ContinuousBatcher, Request, RequestQueue)

__all__ = [
    "DECODE_CONTRACT", "DecodeEngine", "ServingLM", "check_decode_contract",
    "serving_lm_for", "PromotedModel", "init_lm_snapshot", "promote",
    "ContinuousBatcher", "Request", "RequestQueue",
]
