"""Resolve ``--device`` to a ``torch.device`` (the device role of the JAX
package's ``compat.py``).

The port runs on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` on a host with no visible card raises :class:`DeviceUnavailable`;
there is no fallback, so a CPU number can never pass for a card number.

TF32 is switched OFF explicitly for both matrix products and cuDNN
convolutions: PyTorch's default runs float32 convolutions in TF32 (about
three decimal digits), which would make an f32 run on the card a different
computation from the same run on the CPU or in the JAX reference.  The
model's bf16 compute (``--dtype bfloat16``) is unaffected by these flags.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


class DeviceUnavailable(RuntimeError):
    """``--device cuda`` was asked for but no CUDA card is visible."""


def require_cuda() -> None:
    """Raise :class:`DeviceUnavailable` unless a CUDA card is visible."""
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "--device cuda: torch.cuda.is_available() is False (no "
            "visible CUDA card, or a CPU-only PyTorch build). Pass "
            "--device cpu to run the port's plain versions on the CPU")


def resolve_device(name: str, local_rank: int = 0) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> ``torch.device``; sets the TF32 policy.
    On ``cuda`` the device is card ``local_rank`` (this rank's card,
    ``parallel/mesh.py``), which becomes the current CUDA device: the
    kernels launch on the current device."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r} (one of {DEVICES})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "cuda":
        require_cuda()
        visible = torch.cuda.device_count()
        if not 0 <= local_rank < visible:
            raise ValueError(f"--device cuda: card {local_rank} requested, "
                             f"{visible} visible")
        torch.cuda.set_device(local_rank)
        return torch.device("cuda", local_rank)
    return torch.device("cpu")
