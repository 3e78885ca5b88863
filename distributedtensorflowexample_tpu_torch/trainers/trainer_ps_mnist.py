"""Config 2 — async parameter-server MNIST CNN on the port (the JAX
package's ``trainers/trainer_ps_mnist.py``, same defaults: B=64 per
worker, 2000 steps, lr 0.05, momentum 0.9, ``--sync_mode async``).

    python -m distributedtensorflowexample_tpu_torch.trainers.trainer_ps_mnist \\
        --dataset synthetic --dequant_impl pallas --pallas_ce true

runs on the CUDA card (``--device cpu`` for the CPU).  There are no
parameter-server processes: ``--job_name ps`` prints a notice and exits,
and the ClusterSpec flags are accepted as aliases.  Async mode is local
SGD: each rank is one worker that steps its own copy of the parameters on
its slice of the global batch, and the copies are averaged every
``--async_period`` steps (``parallel/async_ps.py``); ``--num_devices N``
starts N workers on this host.  ``--sync_mode sync`` makes this config 3.
"""

from __future__ import annotations

import sys

from distributedtensorflowexample_tpu_torch.config import RunConfig, parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec


def build_config(argv=None) -> RunConfig:
    """The config from the trainer's argv and its defaults."""
    return parse_flags(argv, description=__doc__,
                       batch_size=64, train_steps=2000, learning_rate=0.05,
                       momentum=0.9, dataset="mnist", sync_mode="async")


def main(argv=None) -> dict:
    return Engine(RunSpec(model="mnist_cnn", dataset="mnist",
                          config=build_config(argv))).run()


if __name__ == "__main__":
    summary = main(sys.argv[1:])
    if not summary.get("exited") and summary.get("rank", 0) == 0:
        print(f"final accuracy: "
              f"{summary.get('final_accuracy', float('nan')):.4f}")
