"""Trace capture, and where a training step's time goes on the card.

:class:`ProfilerHook` (the JAX package's ``utils/profiling.ProfilerHook``,
armed by ``--profile_dir``) traces a steady-state window of the live
loop with ``torch.profiler``.  The rest of the module is a profiler of
the train step:

    python -m distributedtensorflowexample_tpu_torch.utils.profiling \
        [--model mnist_cnn | mnist_cnn_async | lm_base | resnet20] \
        [--batch 64 256] [--steps 100] [--warmup 50] [--dequant_impl ...]

Builds the train step with ``Engine.build`` from the trainer's own config
(``build_config``) plus the kernel flags: for ``mnist_cnn`` (the default)
config 3's, synthetic MNIST resident on the card, at B=64 and 256 with
all three kernel flags; for ``lm_base`` ``trainer_lm``'s, the token split
resident on the card, at B=16 with ``--pallas_ce`` and
``--fused_optimizer`` (and ``--bucket_grads ""``, which the fused apply
needs); for ``resnet20`` config 4's
(``trainer_mirrored_cifar``: weight decay, the crop and flip), synthetic
CIFAR-10 resident on the card, at B=128 with ``--dequant_impl pallas``
and ``--pallas_ce`` (weight decay rules out the SGD kernel); for
``mnist_cnn_async`` config 2's (``trainer_ps_mnist``: async local SGD,
one worker) at B=64 with the same two flags (the fused apply is refused
in async mode).  It warms the step up, then for each batch size
prints one JSON line with:

- ``wall_ms_per_step``: host clock around ``--steps`` steps ending in
  ``torch.cuda.synchronize`` (no profiler attached);
- ``device_busy_ms_per_step``: the sum of every kernel's, memset's and
  copy's device time from ``torch.profiler`` over the same number of
  steps, and ``idle_share`` = 1 - busy / wall;
- ``top``: the largest device-time entries per step, ``top_host``: the
  largest host (CPU self) times per step under the profiler,
  ``by_kind``: device time and launches per step by kind of kernel
  (``kind_of``: matrix products, the port's kernels, elementwise and
  copies, reductions, softmax, other),
  ``port_us_per_launch``: each port kernel's device time per launch, and
  ``port_launches_per_step``.

Any flag of the trainer CLI (``config.py``) is accepted after the
script's own.

The bytes audit (:class:`BytesAudit`, :func:`bytes_audit`,
:func:`audit_step`; the JAX module's ``hlo_bytes_by_op``,
``bytes_audit`` and ``cost_and_bytes_audit``) counts each train step's
bytes by op and category, raw and effective, from the aten ops the step
dispatches; ``tools/bytes_audit.py`` and the harnesses' bytes fields
read it.

:func:`collective_ms` times one collective of each kind (all-reduce,
reduce-scatter, all-gather) on a mesh's ranks (``chip_smoke.py`` calls it
in its two gloo ranks, for the replication modes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.module_tracker import ModuleTracker

from distributedtensorflowexample_tpu_torch.device import resolve_device
from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
from distributedtensorflowexample_tpu_torch.serving.engine import (
    _COLLECTIVE_NAMESPACES)
from distributedtensorflowexample_tpu_torch.training.hooks import Hook


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class ProfilerHook(Hook):
    """Trace a window of live training steps.

    Starts after step ``start_step`` completes and stops once at least
    ``num_steps`` further steps have run, so the window holds steady-state
    steps only (never the first step's warm-up, given ``start_step`` > 0);
    with ``K`` steps a call the window rounds up to whole calls.  A resume
    that lands inside or past the window slides it forward, and a window
    is captured once.  The loop synchronizes the card before the hook
    starts and stops the profiler (``needs_sync``).  Each boundary inside
    the window opens a ``ProfilerStep#<n>`` span, ``n`` the first step of
    the call.  Each rank writes its own trace:
    ``<logdir>/rank<rank>/trace_<first>_<last>.json``."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 5,
                 rank: int = 0, device: torch.device | str = "cpu"):
        self._dir = os.path.join(logdir, f"rank{rank}")
        self._start = max(0, start_step)
        self._stop = self._start + max(1, num_steps)
        self._device = torch.device(device)
        self._prof = None
        self._span = None
        self._first = None
        self._done = False
        self.path = None

    def _window(self, step: int) -> tuple:
        if self._prof is None and step > self._start:
            width = self._stop - self._start
            return step, step + width
        return self._start, self._stop

    def needs_sync(self, step) -> bool:
        if self._done:
            return False
        start, stop = self._window(step)
        if self._prof is None:
            return start <= step < stop
        return step >= stop

    def _mark(self, step: int) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._span = torch.profiler.record_function(
            f"ProfilerStep#{step + 1}")
        self._span.__enter__()

    def after_step(self, step, state, metrics) -> bool:
        if self._done:
            return False
        self._start, self._stop = self._window(step)
        if self._prof is None and self._start <= step < self._stop:
            self._prof = torch.profiler.profile(
                activities=_activities(self._device))
            self._prof.start()
            self._first = step + 1
            self._mark(step)
        elif self._prof is not None and step >= self._stop:
            self._finish(step)
        elif self._prof is not None:
            self._mark(step)
        return False

    def _finish(self, last: int) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        self.path = os.path.join(self._dir,
                                 f"trace_{self._first}_{last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True

    def end(self, state) -> None:
        if self._prof is not None:      # the loop stopped inside the window
            self._finish(int(state.step))


# ---------------------------------------------------------------------------
# The bytes audit: each step's bytes by op and category, raw and effective
# (the JAX package's ``hlo_bytes_by_op``, ``bytes_audit`` and
# ``cost_and_bytes_audit``).  JAX parses the compiled module's HLO text;
# PyTorch runs eagerly and has none, so :class:`BytesAudit` counts the
# aten ops the step actually dispatches, forward and backward, under a
# ``TorchDispatchMode``, and keeps JAX's byte convention, categories and
# record.

#: Short dtype names, as XLA prints them (a row's ``out``).
_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128"}

#: Ops that move no bytes of their own (the JAX ``_SKIP_OPS``): views,
#: allocations and the scalar read.  A transpose that is materialised
#: shows up as the ``clone``/``copy_`` that follows it, under ``layout``.
#: Any other view (``OpOverload.is_view``: ``split``, ``unbind``, ...) is
#: skipped too.
_SKIP_OPS = frozenset({
    "view", "_unsafe_view", "expand", "permute", "t", "transpose", "slice",
    "select", "unsqueeze", "squeeze", "as_strided", "alias", "detach",
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_local_scalar_dense"})

#: aten op (overload packet) -> the JAX category.  ``_to_copy`` is
#: ``cast`` when the dtype changes and ``layout`` when it does not; the
#: ``scatter*``, ``index_put*`` and ``index_add*`` families are
#: ``gather``; the ``c10d`` namespaces are ``collective``; anything else
#: is ``elementwise``.  Reductions take ``reduce`` over ``elementwise``,
#: as JAX's fusion priority does; pooling is ``reduce``, as XLA's
#: ``reduce-window`` and ``select-and-scatter`` are.
_CATEGORY = {
    "convolution": "conv", "convolution_backward": "conv",
    "mm": "matmul", "addmm": "matmul", "bmm": "matmul",
    "baddbmm": "matmul",
    "index_select": "gather", "index": "gather", "embedding": "gather",
    "embedding_dense_backward": "gather", "gather": "gather",
    "clone": "layout", "copy_": "layout", "cat": "layout",
    "stack": "layout", "constant_pad_nd": "layout", "flip": "layout",
    **dict.fromkeys((
        "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
        "var_mean", "var", "logsumexp", "prod", "_softmax", "_log_softmax",
        "_softmax_backward_data", "_log_softmax_backward_data",
        "native_batch_norm", "native_batch_norm_backward",
        "native_layer_norm", "native_layer_norm_backward",
        "max_pool2d_with_indices", "max_pool2d_with_indices_backward",
        "avg_pool2d", "avg_pool2d_backward"), "reduce"),
    **dict.fromkeys((
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
        "bernoulli", "bernoulli_", "normal", "normal_", "uniform_",
        "random_", "exponential_", "native_dropout"), "rng"),
}
_GATHER_FAMILIES = ("scatter", "index_put", "index_add")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _shape_token(ts: list) -> str:
    """``f32[64,10]`` (XLA's spelling), a tuple for several outputs."""
    toks = [f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(d) for d in t.shape)}]" for t in ts]
    return toks[0] if len(toks) == 1 else f"({', '.join(toks)})"


def _op_category(func, inputs: list, outputs: list) -> str:
    """The JAX category of one dispatched aten op (``_CATEGORY``)."""
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return "collective"
    name = func._overloadpacket.__name__
    if name == "_to_copy":
        same = inputs and outputs and inputs[0].dtype == outputs[0].dtype
        return "layout" if same else "cast"
    if name.startswith(_GATHER_FAMILIES):
        return "gather"
    return _CATEGORY.get(name, "elementwise")


def _row(opcode: str, category: str, inputs: list, outputs: list,
         op_name: str, effective: int | None = None) -> dict:
    """One row in the JAX convention: every tensor input at full size plus
    every output (an in-place op pays its ``self`` twice: read, then
    written).  ``effective`` defaults to the JAX rule: a ``gather`` row
    re-prices its largest input at its output's size (the cost convention
    charges an indexed read for its whole operand; the data moved is one
    output's worth of rows)."""
    in_b = [_nbytes(t) for t in inputs]
    out_b = sum(_nbytes(t) for t in outputs)
    raw = sum(in_b) + out_b
    if effective is None:
        effective = raw
        if category == "gather" and in_b:
            effective = raw - max(0, max(in_b) - out_b)
    return {"bytes": raw, "effective_bytes": effective,
            "category": category, "opcode": opcode,
            "out": _shape_token(outputs) if outputs else "",
            "op_name": op_name}


class BytesAudit(TorchDispatchMode):
    """Open around a train step (``with audit: step(state, batch)``), it
    adds one row (:func:`_row`) for every aten op the step dispatches,
    forward and backward, skipping the ops that move nothing
    (``_SKIP_OPS``), and one for every launch of a port kernel, which
    ``ops/kernels.charge`` hands it (a ``ctypes`` launch is no aten op):
    its inputs at full size plus its output, ``effective_bytes`` its
    module's ``bytes_per_launch``.  ``op_name`` is the module path the op
    ran under (``torch.utils.module_tracker.ModuleTracker``, the
    counterpart of flax's ``op_name``), ``backward/`` before it in the
    backward pass.

    The mode reaches the autograd engine's device thread: the engine
    carries the caller's dispatch modes into the threads that run the
    backward.  Under ``--remat block`` the recompute in the backward is
    counted, as XLA counts rematerialised ops.  Eager ops are unfused, so
    an intermediate that XLA would keep inside a fusion is written and
    read again here: the port's one difference from XLA's convention.
    On the CPU the kernel wrappers run their plain versions, whose ops
    are counted as any other (the plain dequant's float64 casts and
    elementwise ops belong to the CPU audit only).  The audit may be
    opened again for the next call; ``rows`` collects every call's."""

    def __init__(self):
        super().__init__()
        self.rows: list[dict] = []
        self._tracker = ModuleTracker()

    def __enter__(self):
        from distributedtensorflowexample_tpu_torch.ops import kernels
        self._tracker.__enter__()
        kernels.AUDITS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from distributedtensorflowexample_tpu_torch.ops import kernels
        try:
            return super().__exit__(*exc)
        finally:
            kernels.AUDITS.remove(self)
            self._tracker.__exit__(*exc)

    def _op_name(self) -> str:
        deepest = max(self._tracker.parents,
                      key=lambda p: (p.count("."), len(p)))
        path = "" if deepest == "Global" else deepest.replace(".", "/")
        if self._tracker.is_bw:
            return f"backward/{path}" if path else "backward"
        return path

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name not in _SKIP_OPS and not func.is_view:
            inputs = _tensors((args, kwargs))
            outputs = _tensors(out)
            self.rows.append(_row(str(func).removeprefix("aten."),
                                  _op_category(func, inputs, outputs),
                                  inputs, outputs, self._op_name()))
        return out

    def kernel_row(self, name: str, category: str, inputs: tuple,
                   outputs: tuple, effective_bytes: int) -> None:
        self.rows.append(_row(name, category, list(inputs), list(outputs),
                              self._op_name(), effective_bytes))


def bytes_audit(rows: list[dict], unroll: int = 1, top_k: int = 12) -> dict:
    """The JAX ``bytes_audit`` record from :class:`BytesAudit` rows:
    whole-run and per-step totals (raw and effective), the totals by
    category, the phantom gather bytes (raw minus effective) and the
    ``top_k`` ops.  ``per_step`` divides by ``unroll``, the steps the rows
    cover.  A top op is one ``(opcode, category, out, op_name)``: the
    rows of the same op in every step (and any twin in one step) summed,
    as a JAX row weighs a scan body's instruction by its trip count."""
    by_cat: dict[str, float] = defaultdict(float)
    by_cat_eff: dict[str, float] = defaultdict(float)
    ops: dict[tuple, int] = defaultdict(int)
    total = eff = 0
    for r in rows:
        by_cat[r["category"]] += r["bytes"]
        by_cat_eff[r["category"]] += r["effective_bytes"]
        total += r["bytes"]
        eff += r["effective_bytes"]
        ops[(r["opcode"], r["category"], r["out"], r["op_name"])] += \
            r["bytes"]
    u = max(1, unroll)
    top = [{"bytes_per_step": round(b / u), "category": cat,
            "opcode": opcode, "op_name": op_name[-80:], "out": out[:60]}
           for (opcode, cat, out, op_name), b in sorted(
               ops.items(), key=lambda kv: -kv[1])[:top_k]]
    return {
        "bytes_total": total, "bytes_effective_total": eff,
        "bytes_per_step": round(total / u),
        "bytes_effective_per_step": round(eff / u),
        "phantom_gather_bytes_per_step": round((total - eff) / u),
        "by_category_per_step": {k: round(v / u) for k, v in
                                 sorted(by_cat.items(),
                                        key=lambda kv: -kv[1])},
        "by_category_effective_per_step": {
            k: round(v / u) for k, v in
            sorted(by_cat_eff.items(), key=lambda kv: -kv[1])},
        "top_ops": top,
    }


def audit_step(step, ds, state, unroll: int = 1, calls: int = 1,
               flops: int | None = None, top_k: int = 12,
               audit: BytesAudit | None = None) -> tuple[dict, dict]:
    """``(cost, audit)`` of ``calls`` calls of a built train step (the
    JAX ``cost_and_bytes_audit``; the arguments in ``tools.bench._measure``'s
    order): each call's batch is drawn with ``next(ds)`` outside the
    audit, then the call runs inside it.
    ``unroll`` is the build's steps a call, so the record is per step.
    ``cost`` holds ``flops`` (the caller's count from ``utils/flops.py``,
    when given) and ``bytes_accessed``, the raw bytes a step.

    Give it a build of its own: the calls advance its state and data
    cursor, and the dispatch mode's Python overhead slows them, so never
    audit the state, cursor or window that a harness then times or holds
    bitwise.  ``audit`` (a :class:`BytesAudit`) keeps the rows for the
    caller."""
    audit = BytesAudit() if audit is None else audit
    start = len(audit.rows)
    for _ in range(calls):
        data = next(ds)
        with audit:
            state, _ = step(state, data)
    record = bytes_audit(audit.rows[start:], unroll=calls * unroll,
                         top_k=top_k)
    cost = {} if flops is None else {"flops": flops}
    cost["bytes_accessed"] = record["bytes_per_step"]
    return cost, record


#: Substrings of the port kernels' device names.
PORT_KERNELS = {"dequant": "dequant_gather_kernel", "ce_fwd": "ce_fwd_kernel",
                "ce_bwd": "ce_bwd_kernel", "sgd": "sgd_momentum_kernel"}
KERNEL_FLAGS = ["--dequant_impl", "pallas", "--pallas_ce", "true",
                "--fused_optimizer", "true"]
MODELS = ("mnist_cnn", "mnist_cnn_async", "lm_base", "resnet20")


def workload(model: str, argv: list) -> tuple:
    """``(spec, default batches)`` for ``--model``: the trainer's config
    with the kernel flags, then ``argv``."""
    from distributedtensorflowexample_tpu_torch.engine import RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_lm, trainer_mirrored_cifar, trainer_ps_mnist,
        trainer_sync_mnist)
    if model == "mnist_cnn":
        cfg = trainer_sync_mnist.build_config(
            KERNEL_FLAGS + ["--dataset", "synthetic"] + argv)
        return RunSpec(model, "mnist", cfg), [64, 256]
    if model == "mnist_cnn_async":
        cfg = trainer_ps_mnist.build_config(
            ["--dequant_impl", "pallas", "--pallas_ce", "true",
             "--dataset", "synthetic"] + argv)
        return RunSpec("mnist_cnn", "mnist", cfg), [64]
    if model == "lm_base":
        size, cfg = trainer_lm.build_config(
            ["--size", model, "--pallas_ce", "true", "--fused_optimizer",
             "true", "--bucket_grads", ""] + argv)
        return RunSpec(size, "lm", cfg), [16]
    if model == "resnet20":
        cfg = trainer_mirrored_cifar.build_config(
            ["--dequant_impl", "pallas", "--pallas_ce", "true",
             "--dataset", "synthetic"] + argv)
        return RunSpec(model, "cifar10", cfg, augment=True), [128]
    raise ValueError(f"unknown model {model!r} (one of {MODELS})")


#: (kind, substrings of the device names that select it), first match wins.
KINDS = (
    ("port", tuple(PORT_KERNELS.values())),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("elementwise_copy", ("elementwise", "copy", "fill", "Memset",
                          "Memcpy")),
)


def kind_of(name: str) -> str:
    for kind, subs in KINDS:
        if any(sub in name for sub in subs):
            return kind
    return "other"


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _on_device(evt) -> bool:
    # Kernels, memsets and copies are CUDA-typed entries; the CPU-side
    # aten ops that launched them also carry their kernels' time, so
    # summing every entry would count each kernel twice.
    return evt.device_type == torch.autograd.DeviceType.CUDA


def profile_step(spec, steps: int, warmup: int, built=None) -> dict:
    """The step's wall and device time (module docstring) on ``built``, an
    ``Engine.build`` of ``spec`` made here when not given."""
    from distributedtensorflowexample_tpu_torch.engine import Engine
    cfg = spec.config
    device = resolve_device(cfg.device)
    if built is None:
        built = Engine(spec).build(Mesh(device))

    def run(n):
        for _ in range(n):
            built.step(built.state, next(built.ds))
            built.ds.prefetch()
        torch.cuda.synchronize(device)

    run(warmup)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(steps)
    averages = prof.key_averages()
    events = [e for e in averages if _on_device(e)]
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / steps
    events.sort(key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "us_per_step": _device_us(e) / steps,
            "calls_per_step": e.count / steps} for e in events[:10]]
    host = sorted((e for e in averages if not _on_device(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    top_host = [{"name": e.key[:60],
                 "self_cpu_us_per_step": e.self_cpu_time_total / steps,
                 "calls_per_step": e.count / steps} for e in host[:10]]
    by_kind: dict = {}
    for e in events:
        k = by_kind.setdefault(kind_of(e.key), {"us_per_step": 0.0,
                                                "launches_per_step": 0.0})
        k["us_per_step"] += _device_us(e) / steps
        k["launches_per_step"] += e.count / steps
    port, port_calls = {}, {}
    for name, sub in PORT_KERNELS.items():
        hits = [e for e in events if sub in e.key]
        calls = sum(e.count for e in hits)
        port[name] = (sum(_device_us(e) for e in hits) / calls
                      if calls else None)
        port_calls[name] = calls / steps
    return {"model": spec.model, "sync_mode": cfg.sync_mode,
            "batch": cfg.batch_size, "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top": top, "top_host": top_host, "by_kind": by_kind,
            "port_us_per_launch": port,
            "port_launches_per_step": port_calls}


def collective_ms(mesh, numel: int, iters: int) -> dict:
    """Host milliseconds per gradient collective of each kind on this
    rank's device, back to back and synchronized: an all-reduce of
    ``numel`` float32, a reduce-scatter of ``numel`` to ``numel / D``,
    an all-gather of ``numel / D`` to ``numel`` (the sizes a step's
    buffers give them; uncounted).  Every rank of ``mesh`` calls it."""
    full = torch.zeros(numel - numel % mesh.size, device=mesh.device)
    row = full[:full.numel() // mesh.size].clone()
    calls = {"all-reduce": lambda: mesh.all_reduce(full, counted=False),
             "reduce-scatter": lambda: mesh.reduce_scatter(full,
                                                           counted=False),
             "all-gather": lambda: mesh.all_gather_into(row, counted=False)}
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)
    out = {}
    for kind, call in calls.items():
        for _ in range(2):
            call()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        sync()
        out[kind] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mnist_cnn", choices=MODELS)
    p.add_argument("--batch", type=int, nargs="+", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=50)
    args, rest = p.parse_known_args(argv)
    spec, batches = workload(args.model, rest)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for batch in args.batch or batches:
        spec.config.batch_size = batch
        row = profile_step(spec, args.steps, args.warmup)
        print(json.dumps({"gpu": gpu, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
