"""The Engine (the JAX package's ``engine/engine.py`` ``Engine.run``), for
the ``sync_dp`` mode on one rank.

``Engine(spec).run()`` resolves the flags (refusing by name every mode
the port does not run yet), loads the split, builds the model, optimizer
and state on ``--device`` with the device-resident dataset and the
indexed train step (``Engine.build``), runs the loop with its hooks, and
ends with an exact eval on the held-out split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from distributedtensorflowexample_tpu_torch.config import RunConfig
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DEQUANT_IMPLS, DeviceDataset)
from distributedtensorflowexample_tpu_torch.data.mnist import load_mnist
from distributedtensorflowexample_tpu_torch.device import resolve_device
from distributedtensorflowexample_tpu_torch.models.mnist_cnn import MnistCNN
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_indexed_train_step, make_resident_eval)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.training.hooks import (
    EvalHook, MetricsHook)
from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
from distributedtensorflowexample_tpu_torch.training.metrics import (
    MetricsLogger)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState

# Auto --steps_per_loop unroll ceiling (the JAX package's value).
_AUTO_UNROLL_CAP = 64

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class RunSpec:
    """What to run: the workload's model and dataset names plus the
    parsed flags (the slice of the JAX package's ``engine/spec.py``
    RunSpec that config 3 uses)."""

    model: str
    dataset: str
    config: RunConfig


def auto_steps_per_loop(remaining: int, steps_per_epoch: int,
                        cap: int = _AUTO_UNROLL_CAP,
                        intervals: tuple = (), start: int = 0) -> int:
    """The unroll ``--steps_per_loop 0`` selects: the largest value <=
    min(cap, steps_per_epoch, remaining) dividing the remaining steps,
    every positive interval and the start step, so hooks fire on their
    exact marks."""
    g = math.gcd(remaining, start)
    for iv in intervals:
        if iv and iv > 0:
            g = math.gcd(g, iv)
    hi = min(cap, steps_per_epoch, remaining)
    for d in range(min(hi, g), 1, -1):
        if g % d == 0:
            return d
    return 1


def _load_dataset(cfg: RunConfig, name: str, split: str):
    if cfg.dataset not in (name, "synthetic"):
        raise ModeRefusal(
            f"--dataset {cfg.dataset!r} does not match this trainer's "
            f"dataset {name!r}; pass --dataset {name} (real bytes in "
            f"--data_dir) or --dataset synthetic")
    if name != "mnist":
        raise ModeRefusal(f"the {name!r} dataset is not ported to the "
                          f"PyTorch package yet")
    source = "synthetic" if cfg.dataset == "synthetic" else "real"
    return load_mnist(cfg.data_dir, split, seed=cfg.seed, source=source)


def _refuse_unported(cfg: RunConfig) -> None:
    """Named refusals for every mode this slice does not run, checked
    before any data is loaded."""
    if cfg.sync_mode not in ("sync", "async"):
        raise ValueError(f"unknown sync_mode {cfg.sync_mode!r}")
    if cfg.device_data not in ("auto", "on", "off"):
        raise ValueError(f"unknown device_data {cfg.device_data!r}")
    if cfg.data_sharding not in ("replicated", "sharded"):
        raise ValueError(f"unknown data_sharding {cfg.data_sharding!r}")
    if cfg.dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {cfg.dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} (one of "
                         f"{tuple(_DTYPES)})")
    not_yet = [
        (cfg.sync_mode == "async", "--sync_mode async (local-SGD "
         "emulation of parameter-server staleness)"),
        (bool(cfg.bucket_grads), "--bucket_grads (bucketed gradient "
         "all-reduce)"),
        (cfg.shard_update, "--shard_update (ZeRO-1 update sharding)"),
        (cfg.shard_params, "--shard_params (ZeRO-3)"),
        (cfg.data_sharding == "sharded", "--data_sharding sharded"),
        (cfg.device_data == "off", "--device_data off (the host-fed "
         "Batcher path)"),
        (cfg.checkpoint_every > 0, "--checkpoint_every > 0 (the port has "
         "no checkpoint format yet)"),
        (cfg.num_processes > 1 or bool(cfg.coordinator_address)
         or len(cfg.worker_host_list) > 1,
         "multi-process runs (--num_processes, --coordinator_address, "
         "--worker_hosts)"),
        (cfg.num_devices > 1, "--num_devices > 1 (one rank per card; "
         "multi-rank sync comes with the NCCL slice)"),
        (bool(cfg.profile_dir), "--profile_dir (the profiler hook)"),
    ]
    for hit, what in not_yet:
        if hit:
            raise ModeRefusal(f"{what} is not ported to the PyTorch package "
                              f"yet; this slice runs sync_dp on one rank")


@dataclasses.dataclass
class EngineBuild:
    """What :meth:`Engine.build` hands a caller: the state, the resident
    dataset and the indexed train step over it."""

    state: TrainState
    ds: DeviceDataset
    step: Callable
    unroll: int


class Engine:
    """Runs a :class:`RunSpec`.  ``run()`` is the trainer surface;
    ``build()`` is the same construction cut down to state + dataset +
    step, with no hooks and no eval (the profiler and the chip smoke's
    card-against-CPU check drive it)."""

    def __init__(self, spec: RunSpec):
        self.spec = spec

    def build(self, device: torch.device, unroll: int = 1, data=None,
              perm_fn=None) -> EngineBuild:
        """State, resident dataset and train step on ``device``.  ``data``
        ``(images, labels)`` replaces the spec's train split; ``perm_fn``
        injects an index tape (``DeviceDataset``)."""
        cfg = self.spec.config
        if self.spec.model != "mnist_cnn":
            raise ModeRefusal(f"model {self.spec.model!r} is not ported to "
                              f"the PyTorch package yet")
        x, y = (data if data is not None else
                _load_dataset(cfg, self.spec.dataset, "train"))
        model = MnistCNN(num_classes=10, dropout_rate=cfg.dropout,
                         dtype=_DTYPES[cfg.dtype])
        state = TrainState.create(model, lambda m: build_optimizer(cfg, m),
                                  cfg.seed, device)
        ds = DeviceDataset(x, y, cfg.batch_size, device=device,
                           seed=cfg.seed, start_step=state.step,
                           steps_per_next=unroll, quantize=cfg.quantize,
                           dequant_impl=cfg.dequant_impl, perm_fn=perm_fn)
        step = make_indexed_train_step(
            cfg.batch_size, ds.steps_per_epoch, cfg.label_smoothing,
            ce_impl="pallas" if cfg.pallas_ce else "xla",
            unroll_steps=unroll,
            replicas_to_aggregate=cfg.replicas_to_aggregate,
            num_slots=ds.num_slots, dequant_impl=cfg.dequant_impl)
        return EngineBuild(state=state, ds=ds, step=step, unroll=unroll)

    def run(self) -> dict:
        """Train per the spec; returns a summary dict."""
        spec = self.spec
        cfg: RunConfig = spec.config
        if cfg.job_name == "ps":
            print("--job_name ps: there are no parameter servers in "
                  "synchronous data parallelism; this process exits.",
                  flush=True)
            return {"role": "ps", "exited": True}
        _refuse_unported(cfg)
        device = resolve_device(cfg.device)
        if cfg.resume:
            print("--resume: the PyTorch package has no checkpoint format "
                  "yet, so there is nothing to resume from (no-op)",
                  flush=True)
        num_replicas = 1
        global_batch = cfg.batch_size

        train_x, train_y = _load_dataset(cfg, spec.dataset, "train")
        test_x, test_y = _load_dataset(cfg, spec.dataset, "test")

        # A fresh run starts at step 0 (the port has no resume yet).
        remaining = cfg.train_steps
        if cfg.steps_per_loop == 0:
            steps_per_call = (auto_steps_per_loop(
                remaining, len(train_x) // global_batch,
                intervals=(cfg.log_every, cfg.eval_every))
                if remaining > 0 else 1)
            if steps_per_call > 1:
                print(f"steps_per_loop auto: fusing {steps_per_call} steps "
                      f"per call (--steps_per_loop 1 for per-step calls)",
                      flush=True)
        else:
            steps_per_call = max(1, cfg.steps_per_loop)
            if remaining > 0 and remaining % steps_per_call:
                raise ModeRefusal(
                    f"remaining steps {remaining} (train_steps "
                    f"{cfg.train_steps}) must be a multiple of "
                    f"--steps_per_loop {steps_per_call}")
        built = self.build(device, unroll=steps_per_call,
                           data=(train_x, train_y))

        logger = MetricsLogger(cfg.log_dir, num_chips=num_replicas,
                               log_every=cfg.log_every, device=device)
        hooks = []
        eval_batch = max(global_batch, 1000)
        eval_fn = make_resident_eval(test_x, test_y, device,
                                     batch_size=eval_batch,
                                     quantize=cfg.quantize,
                                     dequant_impl=cfg.dequant_impl)
        if cfg.eval_every > 0:
            hooks.append(EvalHook(eval_fn, cfg.eval_every, logger))
        metrics_hook = MetricsHook(every=cfg.log_every)
        hooks.append(metrics_hook)

        loop = TrainLoop(built.step, built.ds, cfg.train_steps, hooks, logger,
                         steps_per_call=steps_per_call)
        state = loop.run(built.state)
        final_acc = eval_fn(state)
        logger.scalar(state.step, "final_accuracy", final_acc)
        steps_per_sec = logger.last_steps_per_sec
        logger.close()
        return {"final_accuracy": final_acc,
                "steps": state.step,
                "steps_per_sec": steps_per_sec,
                "steps_per_sec_per_chip": steps_per_sec / num_replicas,
                "num_replicas": num_replicas,
                "global_batch": global_batch,
                "steps_per_call": steps_per_call,
                "eval_batches": -(-len(test_y) // eval_batch),
                "device": str(device),
                "loss_tape": metrics_hook.loss_tape}
