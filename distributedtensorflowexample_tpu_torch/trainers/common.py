"""The shared trainer runner as a one-line declaration adapter (the JAX
package's ``trainers/common.py``): ``run_training`` wraps its arguments
into a :class:`~distributedtensorflowexample_tpu_torch.engine.RunSpec`
and the Engine runs it."""

from __future__ import annotations

from distributedtensorflowexample_tpu_torch.config import RunConfig
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec


def run_training(cfg: RunConfig, model_name: str, dataset_name: str,
                 augment: bool = False) -> dict:
    """Train per ``cfg``; returns the run's summary.  The same as
    ``Engine(RunSpec(model_name, dataset_name, cfg, augment)).run()``."""
    return Engine(RunSpec(model=model_name, dataset=dataset_name,
                          config=cfg, augment=augment)).run()
