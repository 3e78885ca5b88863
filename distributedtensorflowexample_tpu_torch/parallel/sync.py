"""Sync data-parallel train and eval steps (the JAX package's
``parallel/sync.py``), on one rank or on a mesh of N (``parallel/mesh.py``).

The step gathers this rank's rows of the global minibatch from the
device-resident split by index (:func:`make_device_gather`; rank ``i``
owns rows ``[i*per, (i+1)*per)`` of each global batch, as the JAX step
shards them), runs the model forward and the per-row loss head,
backpropagates into the optimizer's flat gradient buffer, all-reduces
that buffer once (the JAX step's psum), and applies the update.  The
loss each rank differentiates is its share of the global loss: its mean
over its rows divided by N (exact for a power of two), so the summed
gradient is the gradient of the mean over the global batch.  With
``replicas_to_aggregate`` R (0 < R < N) rank ``i`` counts at step ``s``
iff ``(i - s) mod N < R``, and the loss is ``sum(rows * sel) / (R *
per)`` (the JAX package's rotating subset).

The host-fed path (``--device_data off``): :func:`make_train_step` runs
the same step body on this rank's uploaded rows (``data/pipeline.py``),
dequantized in the step (:func:`dequant_host_batch`), and
:func:`evaluate` uploads the test split a batch at a time.

A model with batch norm (``models/resnet.py``) normalizes over the
global batch: each of its batch-norm layers adds one all-reduce of its
statistics in the forward and one of their cotangents in the backward,
so a ResNet-20 step issues 21 + 21 + 1 = 43 all-reduces per rank at
N > 1.  Its running statistics are the model's buffers, updated in the
forward; the eval reads them.

The replication mode (``engine/spec.MODES``) picks what follows the
backward (:func:`_build_step_fn`): the one all-reduce (``sync_dp``), one
per bucket (``bucketed``, ``parallel/bucketing.py``), a reduce-scatter,
row update and all-gather per bucket (``zero1``, and ``--shard_update``'s
tree form over one bucket), or the ZeRO-3 step, whose forward gathers the
parameter rows (``parallel/zero3.py``).  The gather, the loss heads and
the loss shares are the same in every mode.

The step's metrics are this rank's shares of the global ones (summing
over the ranks gives the global loss and accuracy); they stay on the
device, and the loop sums them once per host read (``Mesh.sum_metrics``).

With the three kernel flags (``--dequant_impl pallas --pallas_ce
--fused_optimizer``) one step launches each port kernel once per rank:
the dequant gather, the cross-entropy forward, its backward, and the SGD
apply.  The CIFAR trainers take weight decay, which the SGD kernel does
not implement (refused by name, as in the JAX package): there one step
launches the dequant gather and the cross-entropy pair.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DEQUANT_IMPLS, DeviceDataset, apply_dequant_affine, apply_dequant_gather,
    apply_dequant_lut, dequantize_images, resolve_dequant_impl)
from distributedtensorflowexample_tpu_torch.data.augment_device import (
    crop_flip, crop_flip_dequant, step_draws)
from distributedtensorflowexample_tpu_torch.data.dequant import (
    make_dequant_affine, try_quantize)
from distributedtensorflowexample_tpu_torch.data.pipeline import (
    put_global_batch)
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    fused_gather_dequant, fused_softmax_cross_entropy_rows)
from distributedtensorflowexample_tpu_torch.ops.losses import (
    accuracy, softmax_cross_entropy_rows)
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    BucketPlan, bucketed_all_reduce, sharded_update)
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh)
from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
    Zero3Layout, build_zero3_step_fn)

def _per_example_rows(impl: Callable) -> Callable:
    """Let a [rows, C] loss head also take sequence logits [B, T, C] with
    labels [B, T] (the transformer LM): the tokens flatten row-major into
    [B*T, C] rows for ``impl`` and fold back to one value per example,
    the mean over T, so the batch mean downstream is the image models'."""
    def rows(logits, labels):
        if logits.dim() == 3:
            r = impl(logits.reshape(-1, logits.shape[-1]),
                     labels.reshape(-1))
            return r.reshape(logits.shape[0], -1).mean(dim=1)
        return impl(logits, labels)
    return rows


def make_loss_rows(label_smoothing: float = 0.0,
                   ce_impl: str = "xla") -> Callable:
    """Per-example loss head [B, C] -> [B] (or [B, T, C] with [B, T]
    labels -> [B], see :func:`_per_example_rows`).  ``ce_impl="pallas"``
    (the ``--pallas_ce`` flag; the name is the JAX package's) runs the
    fused cross-entropy kernel pair; ``"xla"`` the plain PyTorch ops."""
    if ce_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown ce_impl {ce_impl!r}")
    if ce_impl == "xla":
        return _per_example_rows(
            lambda l, y: softmax_cross_entropy_rows(l, y, label_smoothing))
    return _per_example_rows(
        lambda l, y: fused_softmax_cross_entropy_rows(l, y, label_smoothing))


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


def _dequant_gathered(img: torch.Tensor, data: dict,
                      dequant_impl: str) -> torch.Tensor:
    """Dequantize a gathered uint8 batch by the family the data carries
    (the JAX package's ``_dequant_gathered``): ``dq_scale``/``dq_bias``
    (affine) or ``lut`` (``onehot``, or the ``lut`` index).  A factory
    asking for the other family than the dataset resolved raises, as does
    a uint8 batch with no constants."""
    if img.dtype != torch.uint8:
        return img
    if "dq_scale" in data:
        if dequant_impl in ("onehot", "lut"):
            raise ValueError(
                f"step factory asked for dequant_impl={dequant_impl!r} but "
                f"the dataset resolved to the affine family (it carries "
                f"dq_scale/dq_bias) — pass the same dequant_impl to "
                f"DeviceDataset and the step factory")
        return apply_dequant_affine(img, data["dq_scale"], data["dq_bias"])
    if "lut" in data:
        if dequant_impl in ("affine", "pallas"):
            raise ValueError(
                f"step factory asked for dequant_impl={dequant_impl!r} but "
                f"the dataset resolved to the LUT family (it carries lut) "
                f"— pass the same dequant_impl to DeviceDataset and the "
                f"step factory")
        if dequant_impl == "lut":
            return apply_dequant_gather(img, data["lut"])
        return apply_dequant_lut(img, data["lut"])
    raise TypeError("gathered batch is uint8 but the data carries no "
                    "dequant constants")


def make_device_gather(batch_size: int, steps_per_epoch: int, *,
                       num_slots: int, dequant_impl: str = "auto",
                       token_data: bool = False, augment: str = "none",
                       seed: int = 0, draws_fn: Callable | None = None,
                       mesh: Mesh = ONE_RANK,
                       data_sharding: str = "replicated") -> Callable:
    """(step, data) -> batch: the on-device minibatch gather from a
    resident split (``DeviceDataset``), with the JAX package's slot and
    position arithmetic over the GLOBAL ``batch_size``; on a ``mesh`` this
    rank takes its ``batch_size // N`` rows of the global index slice.
    ``dequant_impl="pallas"`` gathers and dequantizes in one kernel
    launch; otherwise the rows are gathered and dequantized by the family
    the data carries (:func:`_dequant_gathered`).  ``token_data=True`` (a
    token split) passes the gathered ids through: they are not pixels.

    ``data_sharding="sharded"`` pairs with a ``DeviceDataset`` of the same
    mode: the data holds this rank's block of rows only, and the global
    positions this rank reads always hold its own rows (the interleaved
    per-shard order), so the indices are translated into the block (minus
    ``rank * rows``) and no row moves between ranks.  The dequant kernel
    gathers over the whole split and is refused there, as in JAX.

    ``augment="cifar"`` adds the random crop and flip
    (``data/augment_device.py``) in the JAX package's order: after the
    dequant kernel on its float32 output under ``dequant_impl="pallas"``;
    on the gathered uint8 rows fused with their affine dequant; or, for
    the LUT family, on the uint8 rows before the table.  The draws are the
    global batch's at each step (``step_draws`` from ``seed``), this rank
    taking its rows; ``draws_fn(step) -> (ys, xs, flips)`` over the global
    batch replaces them (an injected tape)."""
    if dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")
    if augment not in ("none", "cifar"):
        raise ValueError(f"unknown augment {augment!r}")
    if data_sharding not in ("replicated", "sharded"):
        raise ValueError(f"unknown data_sharding {data_sharding!r}")
    if data_sharding == "sharded" and dequant_impl == "pallas":
        raise ValueError(
            "dequant_impl='pallas' fuses the gather over the WHOLE "
            "resident split; pair it with data_sharding='replicated'")
    if augment == "cifar" and token_data:
        raise ValueError("augment='cifar' crops images; a token split "
                         "has none")
    rank, n = mesh.rank, mesh.size
    if batch_size % n:
        raise ValueError(f"global batch {batch_size} not divisible by {n} "
                         f"replicas")
    per = batch_size // n
    sharded = data_sharding == "sharded"
    generators: dict = {}

    def draws(step: int, device: torch.device) -> tuple:
        if draws_fn is not None:
            full = [torch.as_tensor(np.asarray(a)) for a in draws_fn(step)]
        else:
            gen = generators.get(device)
            if gen is None:
                gen = generators[device] = torch.Generator(device=device)
            full = step_draws(batch_size, seed, step, gen)
        return tuple(a[rank * per:(rank + 1) * per].to(device)
                     for a in full)

    def gather(step: int, data: dict) -> dict:
        slot = (step // steps_per_epoch) % num_slots
        pos = (step % steps_per_epoch) * batch_size + rank * per
        idx = data["perm"][slot, pos:pos + per]
        images = data["images"]
        if sharded:
            idx = idx - rank * images.shape[0]     # into this rank's block
        cut = draws(step, images.device) if augment == "cifar" else None
        if token_data:
            img = images.index_select(0, idx)
        elif dequant_impl == "pallas" and "dq_scale" in data:
            img = fused_gather_dequant(images, idx, data["dq_scale"],
                                       data["dq_bias"])
            if cut is not None:
                img = crop_flip(img, *cut)
        else:
            img = images.index_select(0, idx)
            if (cut is not None and img.dtype == torch.uint8
                    and "dq_scale" in data
                    and dequant_impl not in ("onehot", "lut")):
                img = crop_flip_dequant(img, *cut, data["dq_scale"],
                                        data["dq_bias"])
            else:
                if cut is not None:
                    img = crop_flip(img, *cut)
                img = _dequant_gathered(img, data, dequant_impl)
        return {"image": img, "label": data["labels"].index_select(0, idx)}

    return gather


def _make_share(replicas_to_aggregate: int, mesh: Mesh) -> Callable:
    """``step -> weight`` of this rank's mean loss: 1/N, or under partial
    aggregation (R of N) 1/R when the rotating subset selects it, else 0
    (its rows still run forward and backward, with a zero gradient)."""
    rank, n = mesh.rank, mesh.size
    r = int(replicas_to_aggregate)
    if not 0 <= r <= n:
        raise ValueError(
            f"replicas_to_aggregate {r} must be in [0, {n}] (0 = all)")
    if not 0 < r < n:
        return lambda step: 1.0 / n
    return lambda step: 1.0 / r if (rank - step) % n < r else 0.0


def _build_step_fn(label_smoothing: float = 0.0, ce_impl: str = "xla",
                   replicas_to_aggregate: int = 0,
                   mesh: Mesh = ONE_RANK, mode: str = "sync_dp",
                   plan: BucketPlan | None = None,
                   zero3_layout: Zero3Layout | None = None,
                   zero3_overlap: bool = True) -> Callable:
    """The (state, batch) -> metrics step body on this rank's rows, by
    the resolved ``mode`` (``engine/spec.resolve_mode``): forward, this
    rank's share of the global loss, backward into the flat gradient
    buffer, then

    * ``sync_dp``: one all-reduce of that buffer (after the batch-norm
      layers' own, if any) and one optimizer apply; under
      ``--shard_update``'s tree form (the optimizer holds its momentum
      as rows of a one-bucket plan) the ZeRO-1 schedule over that bucket;
    * ``bucketed``: one all-reduce per bucket of ``plan``, then the apply;
    * ``zero1``: per bucket of the optimizer's plan reduce-scatter, row
      update, all-gather (``parallel/bucketing.sharded_update``);
    * ``zero3``: ``parallel/zero3.build_zero3_step_fn`` over
      ``zero3_layout``.

    On one rank every knob resolves to ``sync_dp``, as in the JAX
    package; the Engine refuses the bucketed modes for a batch-norm model
    by name."""
    n = mesh.size
    share = _make_share(replicas_to_aggregate, mesh)
    loss_rows = make_loss_rows(label_smoothing, ce_impl)
    if mode == "zero3":
        return build_zero3_step_fn(loss_rows, share, zero3_layout, mesh,
                                   zero3_overlap)
    if mode == "bucketed" and plan is None:
        raise ValueError("the bucketed step needs the bucket plan")

    def reduce_and_apply(opt) -> None:
        if opt.plan is not None:
            sharded_update(opt, mesh)
        elif mode == "zero1":
            raise ValueError("the ZeRO-1 step expects the momentum as bucket "
                             "rows (MomentumSGD.shard_rows); the state was "
                             "not laid out in bucket rows")
        elif mode == "bucketed":
            bucketed_all_reduce(opt.grads_flat, plan, mesh)
            opt.step()
        else:
            mesh.all_reduce(opt.grads_flat)
            opt.step()

    def step(state, batch) -> dict:
        state.optimizer.zero_grad()
        logits = state.model(batch["image"], train=True,
                             generator=state.generator)
        loss = loss_rows(logits, batch["label"]).mean() * share(state.step)
        loss.backward()
        reduce_and_apply(state.optimizer)
        state.step += 1
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), batch["label"]) / n}

    return step


def dequant_host_batch(batch: dict, dequant: str | None,
                       dequant_impl: str = "auto",
                       quantize: str = "auto") -> dict:
    """Dequantize an uploaded uint8 batch in the step (the JAX package's
    ``dequant_host_batch``); a float batch passes through.  A uint8 batch
    with no ``dequant`` spec raises ``TypeError``: training on raw 0-255
    bytes is what the guard prevents (pass ``dequant=batcher.dequant``).
    The impl resolves by the resident path's rule, so both paths run the
    same dequant; ``pallas`` becomes ``affine``, since an uploaded batch
    has no row gather to fuse."""
    img = batch["image"]
    if img.dtype != torch.uint8:
        return batch
    if dequant is None:
        raise TypeError(
            "host-fed batch images are uint8 but the train step was "
            "built without dequant=; pass dequant=batcher.dequant")
    impl = resolve_dequant_impl(dequant, dequant_impl, quantize, img.device)
    impl = "affine" if impl == "pallas" else impl
    return dict(batch, image=dequantize_images(img, dequant, impl))


def make_train_step(label_smoothing: float = 0.0, ce_impl: str = "xla",
                    replicas_to_aggregate: int = 0,
                    dequant: str | None = None, dequant_impl: str = "auto",
                    quantize: str = "auto", mesh: Mesh = ONE_RANK,
                    mode: str = "sync_dp", plan: BucketPlan | None = None,
                    zero3_layout: Zero3Layout | None = None,
                    zero3_overlap: bool = True) -> Callable:
    """The host-fed step (``--device_data off``): ``(state, batch) ->
    (state, metrics)`` on this rank's uploaded rows (``data/pipeline.py``
    ``Batcher`` through ``DevicePrefetcher``), dequantized in the step by
    :func:`dequant_host_batch`, then the resolved mode's body
    (:func:`_build_step_fn`)."""
    inner = _build_step_fn(label_smoothing, ce_impl, replicas_to_aggregate,
                           mesh, mode, plan, zero3_layout, zero3_overlap)

    def step(state, batch):
        return state, inner(state, dequant_host_batch(
            batch, dequant, dequant_impl, quantize))

    return step


def make_indexed_train_step(batch_size: int, steps_per_epoch: int,
                            label_smoothing: float = 0.0,
                            ce_impl: str = "xla",
                            unroll_steps: int = 1,
                            replicas_to_aggregate: int = 0,
                            num_slots: int | None = None,
                            dequant_impl: str = "auto",
                            token_data: bool = False,
                            augment: str = "none", seed: int = 0,
                            draws_fn: Callable | None = None,
                            mesh: Mesh = ONE_RANK, mode: str = "sync_dp",
                            plan: BucketPlan | None = None,
                            zero3_layout: Zero3Layout | None = None,
                            zero3_overlap: bool = True,
                            data_sharding: str = "replicated") -> Callable:
    """Step over a device-resident dataset: ``(state, data) -> (state,
    metrics)``.  ``batch_size`` is the global batch; on a ``mesh`` each
    rank trains on its slice of it.  ``unroll_steps=K`` runs K consecutive
    updates per call (a Python loop; each sub-step picks its epoch's perm
    slot, so a window may cross epochs) and returns this rank's metric
    shares averaged over the K updates, still on the device.
    ``token_data=True``: the split holds token ids; ``augment``,
    ``seed`` and ``draws_fn``: the crop and flip and their draws;
    ``data_sharding``: the dataset's row placement
    (:func:`make_device_gather`); ``mode``, ``plan``, ``zero3_layout``
    and ``zero3_overlap``: the replication mode (:func:`_build_step_fn`)."""
    num_slots = _resolve_num_slots(unroll_steps, steps_per_epoch, num_slots)
    inner = _build_step_fn(label_smoothing, ce_impl, replicas_to_aggregate,
                           mesh, mode, plan, zero3_layout, zero3_overlap)
    gather = make_device_gather(batch_size, steps_per_epoch,
                                num_slots=num_slots,
                                dequant_impl=dequant_impl,
                                token_data=token_data, augment=augment,
                                seed=seed, draws_fn=draws_fn, mesh=mesh,
                                data_sharding=data_sharding)

    return indexed_step(inner, gather, unroll_steps)


def indexed_step(inner: Callable, gather: Callable,
                 unroll_steps: int) -> Callable:
    """``(state, data) -> (state, metrics)``: ``unroll_steps`` calls of the
    step body ``inner(state, batch)``, each on ``gather(state.step,
    data)``, and the metrics averaged over them (still on the device)."""
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
                       dequant_impl: str = "auto",
                       token_data: bool = False,
                       mesh: Mesh = ONE_RANK) -> Callable:
    """Exact accuracy over a split held on the device: ``eval_fn(state)
    -> float``, one host read per eval.  On a ``mesh`` every rank holds
    the split and evaluates its ``batch_size // N`` rows of each batch;
    the correct count is summed over the ranks (the batch must divide
    across them, as in the JAX package).

    The split is uploaded once, padded to whole batches with label -1
    (never an argmax) and stored uint8 when quantizable.  With
    ``dequant_impl="pallas"`` each batch is dequantized by the kernel
    (gathering rows ``i*batch .. (i+1)*batch``), so a card run of the
    main path never leaves the kernel for the plain version; otherwise by
    the impl the train path resolves (``quantize`` and ``dequant_impl``
    by the same rule: the affine, or the LUT family's
    ``dequantize_images``).

    ``token_data=True`` (the LM): the split is token ids, nothing is
    dequantized, and accuracy counts label elements (tokens of the
    [N, T] targets), so the denominator is ``labels.size``."""
    if quantize not in ("auto", "off", "exact", "scale"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    images = np.asarray(images)
    labels = np.asarray(labels)
    dequant = None
    if not token_data and quantize != "off":
        q = try_quantize(images)
        if q is not None:
            images, dequant = q
    impl = (resolve_dequant_impl(dequant, dequant_impl, quantize, device)
            if dequant is not None else None)
    rank, ranks = mesh.rank, mesh.size
    if batch_size % ranks:
        raise ValueError(f"eval batch {batch_size} must divide across "
                         f"{ranks} devices")
    per = batch_size // ranks
    n = len(labels)
    denom = labels.size
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate(
            [labels, np.full((pad,) + labels.shape[1:], -1, labels.dtype)])
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
            lo = i * batch_size + rank * per
            hi = lo + per
            if impl == "pallas":
                bx = fused_gather_dequant(xs, rows[lo:hi], s, b)
            elif impl in ("onehot", "lut"):
                bx = dequantize_images(xs[lo:hi], dequant, impl)
            elif dequant is not None:
                bx = apply_dequant_affine(xs[lo:hi], s, b)
            else:
                bx = xs[lo:hi]
            logits = state.model(bx, train=False)
            total += (logits.argmax(dim=-1) == ys[lo:hi]).sum()
        mesh.all_reduce(total, counted=False)
        return int(total.item()) / denom

    return run


def evaluate(state, images: np.ndarray, labels: np.ndarray,
             batch_size: int = 1000, device: torch.device | str = "cpu",
             mesh: Mesh = ONE_RANK) -> float:
    """Exact accuracy over a host split, uploaded a batch at a time (the
    JAX package's host-fed ``evaluate``, the eval of ``--device_data
    off``).  Every rank holds the split and evaluates its ``batch_size //
    N`` rows of each batch; the correct count is summed over the ranks.
    A last partial batch is padded with label -1 (never an argmax)."""
    if batch_size % mesh.size:
        raise ValueError(f"eval batch {batch_size} must divide across "
                         f"{mesh.size} devices")
    images, labels = np.asarray(images), np.asarray(labels, np.int32)
    n = len(labels)
    total = torch.zeros((), dtype=torch.int64, device=device)
    with torch.no_grad():
        for i in range(0, n, batch_size):
            bx, by = images[i:i + batch_size], labels[i:i + batch_size]
            pad = batch_size - len(by)
            if pad:
                bx = np.concatenate(
                    [bx, np.zeros((pad,) + bx.shape[1:], bx.dtype)])
                by = np.concatenate([by, np.full((pad,), -1, by.dtype)])
            batch = put_global_batch({"image": bx, "label": by}, device,
                                     mesh.rank, mesh.size)
            logits = state.model(batch["image"], train=False)
            total += (logits.argmax(dim=-1) == batch["label"]).sum()
    mesh.all_reduce(total, counted=False)
    return int(total.item()) / n
