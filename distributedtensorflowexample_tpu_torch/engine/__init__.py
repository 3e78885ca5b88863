from distributedtensorflowexample_tpu_torch.engine.engine import (
    Engine, RunSpec, auto_steps_per_loop)

__all__ = ["Engine", "RunSpec", "auto_steps_per_loop"]
