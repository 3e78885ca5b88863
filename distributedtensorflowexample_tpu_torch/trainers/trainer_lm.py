"""graft-LM — the decoder-only transformer LM on the seeded Markov token
corpus (the JAX package's ``trainers/trainer_lm.py``, same defaults).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_lm \
        --size lm_base --pallas_ce true

runs on the CUDA card (``--device cpu --size lm_tiny`` for the plain
versions on the CPU).  ``--size`` picks the rung (lm_tiny | lm_small |
lm_base, ``models.LM_SIZES``); lm_base defaults to ``--remat block`` and
``--bucket_grads auto``, as in the JAX package (explicit flags win: the
fused SGD apply, ``--fused_optimizer true``, is refused with bucketing,
as in JAX, so it takes ``--bucket_grads ""`` beside it).  Multi-rank
runs take the flags of ``trainer_sync_mnist`` (``--num_devices N``, the
cluster flags) and every replication mode (``--shard_update``,
``--shard_params``); on one rank the bucket knobs fall through to the
plain step.
"""

from __future__ import annotations

import argparse
import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.models import LM_SIZES


def build_config(argv=None) -> tuple[str, RunConfig]:
    """``(size, config)`` from the trainer's argv and its defaults."""
    sp = argparse.ArgumentParser(add_help=False)
    sp.add_argument("--size", default="lm_tiny", choices=sorted(LM_SIZES))
    ns, rest = sp.parse_known_args(argv)
    overrides = dict(batch_size=16, train_steps=600, learning_rate=0.1,
                     momentum=0.9, dataset="lm", dropout=0.0,
                     log_every=100)
    if ns.size == "lm_base":
        overrides.update(remat="block", bucket_grads="auto")
    return ns.size, parse_flags(rest, description=__doc__, **overrides)


def main(argv=None) -> dict:
    size, cfg = build_config(argv)
    return Engine(RunSpec(model=size, dataset="lm", config=cfg)).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if summary.get("rank", 0) == 0:         # the chief prints, as it logs
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
