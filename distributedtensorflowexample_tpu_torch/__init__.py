"""PyTorch/CUDA port of ``distributedtensorflowexample_tpu`` for an NVIDIA
H100, held against the JAX package by ``tests/test_torch_*.py``.

It imports torch and numpy, never JAX and nothing of the JAX package; its
module layout mirrors the JAX package's so each module's counterpart is
easy to find.  Every Pallas kernel of the JAX package has a hand-written
CUDA kernel in ``csrc/`` with its wrapper and plain PyTorch version in
``ops/kernels/``.
"""
