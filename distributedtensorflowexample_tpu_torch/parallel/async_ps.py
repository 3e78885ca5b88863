"""Async parameter-server emulation by local SGD (the JAX package's
``parallel/async_ps.py``; config 2, BASELINE.json ``configs[1]``).

The reference's workers each pull the variables, step on their own
minibatch and push updates with no sync between them.  The JAX package
emulates that with one virtual worker per device: worker-tiled state,
each worker stepping its own copy on its slice of the global batch, and
the copies averaged every ``period`` steps.  In the port each rank is one
worker, as one device is in JAX, so W is the mesh size:

* the worker-tiled state (JAX ``make_worker_state``) is each rank's own
  ``TrainState``: ``TrainState.create`` broadcasts rank 0's parameters,
  so the copies start equal, as the tiled ones do, and the momentum
  (zero) and the dropout generator are the rank's own;
* each rank gathers its ``G/W`` rows of the global batch
  (``parallel/sync.make_device_gather``: the dequant kernel under
  ``--dequant_impl pallas``; host-fed, :func:`make_async_train_step`
  takes its uploaded rows), differentiates the plain mean loss over
  them (``make_loss_rows``: the cross-entropy pair under ``--pallas_ce``)
  and takes a local momentum-SGD step: worker w's gradient is
  d(loss_w)/d(params_w), with no 1/W and no gradient all-reduce (JAX
  ``_worker_updates``);
* when ``(step + 1) % period == 0`` the rank all-reduces its flat float32
  parameters and divides by W (the shard_map step's ``psum / W``); only
  the parameters are averaged, the momentum stays each worker's; with
  ``--bucket_grads`` the average goes out as one all-reduce per bucket
  of the plan (JAX ``bucketed_tree_psum``), bitwise the same sums;
* a batch-norm model (ResNet-20) normalizes over the worker's own rows
  and keeps its own running statistics (the Engine builds it over
  ``ONE_RANK``, so ``GlobalMean`` is skipped), as each of the JAX
  package's vmapped workers does; the statistics are not averaged at a
  period;
* the metrics are each rank's share, summed by the loop: the loss
  ``loss_w / W`` (the mean over workers) and the accuracy ``correct_w /
  G``.

``period=1`` is sync SGD up to float rounding; W=1 is the sync step.
``--fused_optimizer`` is refused in async mode, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from distributedtensorflowexample_tpu_torch.ops.losses import accuracy
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    BucketPlan, bucketed_all_reduce)
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    _resolve_num_slots, dequant_host_batch, indexed_step, make_device_gather,
    make_loss_rows)


def _build_async_step_fn(period: int, label_smoothing: float = 0.0,
                         ce_impl: str = "xla", mesh: Mesh = ONE_RANK,
                         plan: BucketPlan | None = None) -> Callable:
    """The (state, batch) -> metrics local-SGD body of this rank's
    worker (JAX ``_build_async_step_fn``, its shard_map form)."""
    period = max(1, int(period))
    workers = mesh.size
    loss_rows = make_loss_rows(label_smoothing, ce_impl)

    def average(opt) -> None:
        flat = opt.params_flat
        if plan is not None:
            bucketed_all_reduce(flat, plan, mesh)
        else:
            mesh.all_reduce(flat)
        flat.div_(workers)

    def step(state, batch) -> dict:
        state.optimizer.zero_grad()
        logits = state.model(batch["image"], train=True,
                             generator=state.generator)
        loss = loss_rows(logits, batch["label"]).mean()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        if state.step % period == 0:
            with torch.no_grad():
                average(state.optimizer)
        return {"loss": loss.detach() / workers,
                "accuracy": accuracy(logits.detach(),
                                     batch["label"]) / workers}

    return step


def make_indexed_async_train_step(period: int, batch_size: int,
                                  steps_per_epoch: int,
                                  label_smoothing: float = 0.0,
                                  ce_impl: str = "xla",
                                  unroll_steps: int = 1,
                                  num_slots: int | None = None,
                                  dequant_impl: str = "auto",
                                  token_data: bool = False,
                                  augment: str = "none", seed: int = 0,
                                  draws_fn: Callable | None = None,
                                  mesh: Mesh = ONE_RANK,
                                  plan: BucketPlan | None = None,
                                  data_sharding: str = "replicated"
                                  ) -> Callable:
    """Local-SGD step over a device-resident dataset: ``(state, data) ->
    (state, metrics)``, the async counterpart of
    ``parallel/sync.make_indexed_train_step`` (same gather, same unrolled
    windows; the averaging falls on ``(step + 1) % period == 0`` whatever
    the unroll).  ``batch_size`` is the global batch G; ``plan`` (the
    ``--bucket_grads`` plan) buckets the average; ``data_sharding``: the
    dataset's row placement (``parallel/sync.make_device_gather``)."""
    num_slots = _resolve_num_slots(unroll_steps, steps_per_epoch, num_slots)
    inner = _build_async_step_fn(period, label_smoothing, ce_impl, mesh,
                                 plan)
    gather = make_device_gather(batch_size, steps_per_epoch,
                                num_slots=num_slots,
                                dequant_impl=dequant_impl,
                                token_data=token_data, augment=augment,
                                seed=seed, draws_fn=draws_fn, mesh=mesh,
                                data_sharding=data_sharding)
    return indexed_step(inner, gather, unroll_steps)


def make_async_train_step(period: int, label_smoothing: float = 0.0,
                          ce_impl: str = "xla", mesh: Mesh = ONE_RANK,
                          dequant: str | None = None,
                          dequant_impl: str = "auto",
                          quantize: str = "auto",
                          plan: BucketPlan | None = None) -> Callable:
    """The host-fed local-SGD step (``--device_data off``; JAX
    ``make_async_train_step``): ``(state, batch) -> (state, metrics)`` on
    this worker's uploaded rows, dequantized in the step
    (``parallel/sync.dequant_host_batch``)."""
    inner = _build_async_step_fn(period, label_smoothing, ce_impl, mesh,
                                 plan)

    def step(state, batch):
        return state, inner(state, dequant_host_batch(
            batch, dequant, dequant_impl, quantize))

    return step


@contextlib.contextmanager
def consolidated(state, mesh: Mesh = ONE_RANK):
    """The workers' average for the enclosed block (JAX ``consolidate``,
    for the eval): the flat parameters and the model's buffers (batch
    norm's running statistics) hold the mean over the ranks inside, and
    each rank's own again, bit for bit, after.  The momentum and the rest
    of the state are not touched."""
    held = [state.optimizer.params_flat,
            *(buf for _, buf in state.model.named_buffers())]
    own = [t.clone() for t in held]
    with torch.no_grad():
        for t in held:
            mesh.all_reduce(t, counted=False).div_(mesh.size)
    try:
        yield state
    finally:
        with torch.no_grad():
            for t, mine in zip(held, own):
                t.copy_(mine)
