"""Sync data-parallel train and eval steps (the JAX package's
``parallel/sync.py``), on one rank.

The step gathers its minibatch from the device-resident split by index
(:func:`make_device_gather`), runs the model forward and the per-row loss
head, backpropagates into the optimizer's flat gradient buffer, and
applies the update.  With one rank the gradient all-reduce is the
identity; ``--replicas_to_aggregate`` (and, in the engine, every
multi-rank flag) is refused by name until the multi-rank slice.

With the three kernel flags (``--dequant_impl pallas --pallas_ce
--fused_optimizer``) one step launches each port kernel once: the
dequant gather, the cross-entropy forward, its backward, and the SGD
apply.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DEQUANT_IMPLS, DeviceDataset, apply_dequant_affine, resolve_dequant_impl)
from distributedtensorflowexample_tpu_torch.data.dequant import (
    make_dequant_affine, try_quantize)
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    fused_gather_dequant, fused_softmax_cross_entropy_rows)
from distributedtensorflowexample_tpu_torch.ops.losses import (
    accuracy, softmax_cross_entropy_rows)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal


def make_loss_rows(label_smoothing: float = 0.0,
                   ce_impl: str = "xla") -> Callable:
    """Per-example loss head [B, C] -> [B].  ``ce_impl="pallas"`` (the
    ``--pallas_ce`` flag; the name is the JAX package's) runs the fused
    cross-entropy kernel pair; ``"xla"`` the plain PyTorch ops."""
    if ce_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ce_impl {ce_impl!r}")
    if ce_impl == "xla":
        return lambda l, y: softmax_cross_entropy_rows(l, y, label_smoothing)
    return lambda l, y: fused_softmax_cross_entropy_rows(l, y,
                                                         label_smoothing)


def _resolve_num_slots(unroll_steps: int, steps_per_epoch: int,
                       num_slots: int | None) -> int:
    if unroll_steps < 1:
        raise ValueError(f"unroll_steps {unroll_steps} must be >= 1")
    needed = DeviceDataset.ring_slots_for(unroll_steps, steps_per_epoch)
    if num_slots is None:
        return needed
    if num_slots < needed:
        raise ValueError(
            f"num_slots {num_slots} cannot hold a {unroll_steps}-step "
            f"window over {steps_per_epoch}-step epochs (needs {needed})")
    return num_slots


def make_device_gather(batch_size: int, steps_per_epoch: int, *,
                       num_slots: int, dequant_impl: str = "auto") -> Callable:
    """(step, data) -> batch: the on-device minibatch gather from a
    resident split (``DeviceDataset``), with the JAX package's slot and
    position arithmetic.  ``dequant_impl="pallas"`` gathers and
    dequantizes in one kernel launch; otherwise the rows are gathered and
    dequantized by the plain affine."""
    if dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")

    def gather(step: int, data: dict) -> dict:
        slot = (step // steps_per_epoch) % num_slots
        pos = (step % steps_per_epoch) * batch_size
        idx = data["perm"][slot, pos:pos + batch_size]
        if dequant_impl == "pallas" and "dq_scale" in data:
            img = fused_gather_dequant(data["images"], idx,
                                       data["dq_scale"], data["dq_bias"])
        else:
            img = data["images"].index_select(0, idx)
            if img.dtype == torch.uint8:
                if "dq_scale" not in data:
                    raise TypeError("gathered batch is uint8 but the data "
                                    "carries no dequant constants")
                img = apply_dequant_affine(img, data["dq_scale"],
                                           data["dq_bias"])
        return {"image": img, "label": data["labels"].index_select(0, idx)}

    return gather


def _build_step_fn(label_smoothing: float = 0.0, ce_impl: str = "xla",
                   replicas_to_aggregate: int = 0) -> Callable:
    """The (state, batch) -> metrics step body: forward, loss, backward
    into the flat gradient buffer, one optimizer apply."""
    if replicas_to_aggregate not in (0, 1):
        raise ModeRefusal(
            "--replicas_to_aggregate selects R of N rank gradients per "
            "step; the PyTorch package runs one rank until the multi-rank "
            "slice")
    loss_rows = make_loss_rows(label_smoothing, ce_impl)

    def step(state, batch) -> dict:
        state.optimizer.zero_grad()
        logits = state.model(batch["image"], train=True,
                             generator=state.generator)
        loss = loss_rows(logits, batch["label"]).mean()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), batch["label"])}

    return step


def make_indexed_train_step(batch_size: int, steps_per_epoch: int,
                            label_smoothing: float = 0.0,
                            ce_impl: str = "xla",
                            unroll_steps: int = 1,
                            replicas_to_aggregate: int = 0,
                            num_slots: int | None = None,
                            dequant_impl: str = "auto") -> Callable:
    """Step over a device-resident dataset: ``(state, data) -> (state,
    metrics)``.  ``unroll_steps=K`` runs K consecutive updates per call (a
    Python loop; each sub-step picks its epoch's perm slot, so a window
    may cross epochs) and returns metrics averaged over the K updates,
    still on the device."""
    num_slots = _resolve_num_slots(unroll_steps, steps_per_epoch, num_slots)
    inner = _build_step_fn(label_smoothing, ce_impl, replicas_to_aggregate)
    gather = make_device_gather(batch_size, steps_per_epoch,
                                num_slots=num_slots,
                                dequant_impl=dequant_impl)

    def step(state, data):
        tape = [inner(state, gather(state.step, data))
                for _ in range(unroll_steps)]
        if unroll_steps == 1:
            return state, tape[0]
        return state, {k: torch.stack([m[k] for m in tape]).mean()
                       for k in tape[0]}

    return step


def make_resident_eval(images: np.ndarray, labels: np.ndarray,
                       device: torch.device, batch_size: int = 1000,
                       quantize: str = "auto",
                       dequant_impl: str = "auto") -> Callable:
    """Exact accuracy over a split held on the device: ``eval_fn(state)
    -> float``, one host read per eval.

    The split is uploaded once, padded to whole batches with label -1
    (never an argmax) and stored uint8 when quantizable.  With
    ``dequant_impl="pallas"`` each batch is dequantized by the kernel
    (gathering rows ``i*batch .. (i+1)*batch``), so a card run of the
    main path never leaves the kernel for the plain version; otherwise by
    the plain affine."""
    if quantize not in ("auto", "off", "exact", "scale"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    images = np.asarray(images)
    dequant = None
    if quantize != "off":
        q = try_quantize(images)
        if q is not None:
            images, dequant = q
    impl = (resolve_dequant_impl(dequant, dequant_impl)
            if dequant is not None else None)
    n = len(labels)
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate([labels, np.full((pad,), -1, np.int32)])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    xs = put(images)
    ys = put(np.asarray(labels, np.int32))
    rows = torch.arange(num_batches * batch_size, dtype=torch.int32,
                        device=device)
    if dequant is not None:
        s, b = (put(a) for a in make_dequant_affine(dequant))

    @torch.no_grad()
    def run(state) -> float:
        total = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(num_batches):
            lo, hi = i * batch_size, (i + 1) * batch_size
            if impl == "pallas":
                bx = fused_gather_dequant(xs, rows[lo:hi], s, b)
            elif dequant is not None:
                bx = apply_dequant_affine(xs[lo:hi], s, b)
            else:
                bx = xs[lo:hi]
            logits = state.model(bx, train=False)
            total += (logits.argmax(dim=-1) == ys[lo:hi]).sum()
        return int(total.item()) / n

    return run
