"""Loss/metric math (the JAX package's ``ops/losses.py``): the
``ce_impl="xla"`` counterpart, in plain PyTorch ops.  Everything runs in
float32 on [B, C]-sized tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy_rows(logits: torch.Tensor, labels: torch.Tensor,
                               label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example cross-entropy [B] from int labels; logits [B, C]."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    log_probs = torch.log_softmax(logits, dim=-1)
    return -(onehot * log_probs).sum(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
