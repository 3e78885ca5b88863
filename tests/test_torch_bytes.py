"""The port's bytes audit (``utils/profiling``: ``BytesAudit``,
``bytes_audit``, ``audit_step``; ``tools.bytes_audit``) held to the JAX
package's HLO parser (``hlo_bytes_by_op``) on the CPU:

- per op, exactly: a one-op JAX program compiled on XLA:CPU, printed with
  its operand shapes (this jaxlib's ``as_text()`` drops them), gives the
  same row (raw bytes, effective bytes, category) as the port's audit of
  the same op on the same numpy inputs: a gather of a resident uint8
  split, a matmul, a float32 -> bfloat16 cast, an NHWC convolution;
- the named differences, pinned with their numbers: XLA:CPU splits a
  column sum into two fusions where the eager ``sum(0)`` is one op, and
  a transpose is a view in eager, its bytes at the copy that materialises
  it; an unrolled call adds its metrics' averaging once a call;
- whole steps: K calls audit to exactly the per-step bytes of one, the
  categories sum to the totals, phantom = raw - effective, the phantom of
  a softmax step over a 2048-row split covers the split (the JAX bound,
  and exactly (2048 - 64) rows of image and label);
- the collective category is twice the payload of the step's
  ``Mesh.order`` records on 2 gloo ranks (sync_dp softmax), the JAX
  tie-out of its collective inventory against the audit;
- a budget gate on the port's own bytes a step (mnist_cnn momentum 0.9,
  softmax; B=64 on a 2048-row split), as the JAX ``_BUDGETS``;
- the kernels' rows through a stand-in launch path (the wrappers take
  their launch branch, the launch itself a no-op): one row per launch,
  ``effective_bytes`` each module's ``bytes_per_launch``, and no row of a
  plain version;
- the CLI's record has the JAX tool's keys (``device`` for ``backend``),
  the bandwidth field null on the CPU.

This module's top level imports no JAX: a spawned rank imports it.
"""

import collections
import contextlib
import io
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.ops.kernels import build
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    cross_entropy as ce, dequant as dq, sgd)
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from distributedtensorflowexample_tpu_torch.tools import bench as pbench
from distributedtensorflowexample_tpu_torch.tools import bytes_audit
from distributedtensorflowexample_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, B = 2048, 64
CNN_PARAMS = 3_274_634
#: The port's bytes a step at B=64 on a 2048-row split (``_make``'s
#: synthetic MNIST, uint8-resident, affine dequant), recorded here: raw
#: and effective.  >10% growth fails, as does a drop below half (a
#: different program, not a win).
_BUDGETS = {
    "mnist_cnn": {"bytes": 720_442_320, "effective": 718_878_928},
    "softmax": {"bytes": 5_643_160, "effective": 4_079_768},
}
_WORKLOADS = {"mnist_cnn": (0.9, 0.05), "softmax": (0.0, 0.5)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- one op against the JAX parser ------------------------------------------

def _jax_rows(fn, *args) -> list[tuple]:
    """``(bytes, effective, category)`` rows of ``fn``'s compiled XLA:CPU
    module, printed with its operand shapes."""
    import jax
    from jax._src.lib import xla_client

    from distributedtensorflowexample_tpu.utils.profiling import (
        hlo_bytes_by_op)
    compiled = jax.jit(fn).lower(*args).compile()
    opts = xla_client._xla.HloPrintOptions()
    opts.print_operand_shape = True
    text = compiled.runtime_executable().hlo_modules()[0].to_string(opts)
    return [(r["bytes"], r["effective_bytes"], r["category"])
            for r in hlo_bytes_by_op(text)]


def _port_rows(fn, *args) -> list[tuple]:
    audit = profiling.BytesAudit()
    with audit:
        fn(*args)
    return [(r["bytes"], r["effective_bytes"], r["category"])
            for r in audit.rows]


def _inputs():
    rs = np.random.RandomState(0)
    return {"split": rs.randint(0, 256, (ROWS, 784)).astype(np.uint8),
            "idx": rs.randint(0, ROWS, B).astype(np.int32),
            "a": rs.randn(B, 784).astype(np.float32),
            "b": rs.randn(784, 10).astype(np.float32),
            "x": rs.randn(8, 28, 28, 1).astype(np.float32),
            "w": rs.randn(5, 5, 1, 32).astype(np.float32)}


def _conv_jax(x, w):
    import jax
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _conv_port(x, w):
    # NHWC -> NCHW and HWIO -> OIHW are views; the convolution reads them.
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=2)


# name -> (JAX fn, port fn, input names, the row both give)
_ONE_OPS = {
    "gather": (lambda s, i: s[i], lambda s, i: s.index_select(0, i),
               ("split", "idx"), (1_656_064, 100_608, "gather")),
    "matmul": (lambda a, b: a @ b, torch.mm, ("a", "b"),
               (234_624, 234_624, "matmul")),
    "cast": (lambda a: a.astype("bfloat16"),
             lambda a: a.to(torch.bfloat16), ("a",),
             (301_056, 301_056, "cast")),
    "conv": (_conv_jax, _conv_port, ("x", "w"), (831_104, 831_104, "conv")),
}


@pytest.mark.parametrize("op", list(_ONE_OPS))
def test_one_op_row_equals_the_jax_parser(op):
    import jax.numpy as jnp
    jfn, pfn, names, want = _ONE_OPS[op]
    arrays = _inputs()
    jrows = _jax_rows(jfn, *(jnp.asarray(arrays[n]) for n in names))
    prows = _port_rows(pfn, *(torch.from_numpy(arrays[n]) for n in names))
    assert prows == jrows == [want]


def test_a_column_sum_is_one_op_where_xla_cpu_fuses_two():
    import jax.numpy as jnp
    a = _inputs()["a"]
    assert _jax_rows(lambda a: a.sum(0), jnp.asarray(a)) == [
        (206_980, 206_980, "reduce"), (9_412, 9_412, "reduce")]
    assert _port_rows(lambda a: a.sum(0), torch.from_numpy(a)) == [
        (203_840, 203_840, "reduce")]


def test_a_transpose_pays_at_the_copy_that_materialises_it():
    import jax.numpy as jnp
    a = _inputs()["a"]
    assert _jax_rows(lambda a: a.T, jnp.asarray(a)) == [
        (401_408, 401_408, "layout")]
    t = torch.from_numpy(a)
    assert _port_rows(lambda a: a.t(), t) == []
    assert _port_rows(lambda a: a.t().contiguous(), t) == [
        (401_408, 401_408, "layout")]


# --- whole steps ------------------------------------------------------------

@pytest.fixture
def small_split(monkeypatch):
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": ROWS, "cifar10": 256})


def _audit(model: str, calls: int = 1, unroll: int = 1, mesh=None,
           rows: list | None = None) -> tuple[dict, dict]:
    momentum, lr = _WORKLOADS[model]
    mesh = mesh or make_mesh("cpu")
    step, ds, state, u = pbench._make(model, "mnist", B, unroll, mesh,
                                      momentum=momentum, lr=lr)
    audit = profiling.BytesAudit()
    out = profiling.audit_step(step, ds, state, unroll=u, calls=calls,
                               audit=audit)
    if rows is not None:
        rows.extend(audit.rows)
    return out


@pytest.mark.parametrize("model", list(_WORKLOADS))
def test_k_calls_audit_to_the_bytes_of_one(small_split, model):
    _, one = _audit(model)
    _, four = _audit(model, calls=4)
    assert four["bytes_total"] == 4 * one["bytes_total"]
    for key in ("bytes_per_step", "bytes_effective_per_step",
                "phantom_gather_bytes_per_step", "by_category_per_step",
                "by_category_effective_per_step", "top_ops"):
        assert four[key] == one[key], key
    # The record is self-consistent.
    assert sum(one["by_category_per_step"].values()) == one["bytes_per_step"]
    assert sum(one["by_category_effective_per_step"].values()) == \
        one["bytes_effective_per_step"]
    assert one["phantom_gather_bytes_per_step"] == \
        one["bytes_per_step"] - one["bytes_effective_per_step"]


def test_an_unrolled_call_adds_its_metrics_averaging(small_split):
    """Unroll 4 runs four step bodies a call, then stacks each metric's
    four values and takes their mean once: those rows, and only they, are
    the difference from four one-step calls."""
    one, four = [], []
    _audit("softmax", calls=4, rows=one)
    _audit("softmax", unroll=4, rows=four)
    key = lambda r: (r["opcode"], r["category"], r["bytes"])
    extra = collections.Counter(map(key, four))
    extra.subtract(collections.Counter(map(key, one)))
    assert +extra == {("stack.default", "layout", 4 * 4 + 16): 2,
                      ("mean.default", "reduce", 16 + 4): 2}
    assert -extra == {}


def test_the_phantom_covers_the_resident_split(small_split):
    """JAX ``test_effective_bytes_reprice_resident_split_gather``'s bound,
    and the exact phantom: every unread row of the uint8 images (784
    bytes) and the int32 labels (4 bytes)."""
    _, audit = _audit("softmax")
    phantom = audit["phantom_gather_bytes_per_step"]
    assert phantom >= 0.8 * ROWS * 784
    assert phantom == (ROWS - B) * (784 + 4)
    assert audit["bytes_effective_per_step"] <= \
        audit["bytes_per_step"] - 0.8 * ROWS * 784


@pytest.mark.parametrize("model", list(_WORKLOADS))
def test_cost_budget_gate(small_split, model):
    cost, audit = _audit(model)
    budget = _BUDGETS[model]
    assert cost["bytes_accessed"] == audit["bytes_per_step"]
    for got, want in ((audit["bytes_per_step"], budget["bytes"]),
                      (audit["bytes_effective_per_step"],
                       budget["effective"])):
        assert got <= 1.10 * want, (
            f"{model} step bytes {got:,} grew >10% over the recorded "
            f"budget {want:,}: memory traffic regressed (or the budget "
            f"needs a justified bump)")
        assert got >= 0.5 * want


def _rank_collectives() -> dict:
    """One of two gloo ranks: a sync_dp softmax step audited, with its
    ``Mesh.order`` records."""
    torch.set_num_threads(1)
    pbench.TRAIN_N = {"mnist": 256, "cifar10": 256}
    mesh = make_mesh("cpu")
    step, ds, state, _ = pbench._make("softmax", "mnist", 32, 1, mesh,
                                      momentum=0.0, lr=0.5)
    mesh.order = []
    _, audit = profiling.audit_step(step, ds, state)
    return {"collective": audit["by_category_per_step"].get("collective"),
            "payload": sum(nbytes for _, _, nbytes in mesh.order),
            "kinds": [kind for kind, _, _ in mesh.order]}


def test_collective_bytes_are_twice_the_payload_on_two_ranks():
    ranks = launch.spawn(_rank_collectives, 2, "gloo")
    for r in ranks:
        assert r["kinds"] == ["all-reduce"]
        assert r["payload"] == (784 * 10 + 10) * 4
        assert r["collective"] == 2 * r["payload"]


# --- the kernels' rows ------------------------------------------------------

@pytest.fixture
def launch_path(monkeypatch):
    """The wrappers take their launch branch on CPU tensors; the launch
    itself does nothing (the outputs stay as allocated)."""
    monkeypatch.setattr(build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(build, "bind", lambda *a: (lambda *args: 0))
    monkeypatch.setattr(build, "check", lambda *a: None)
    monkeypatch.setattr(build, "stream_of", lambda *a: None)
    for w in kernels.WRAPPERS.values():
        monkeypatch.setattr(w, "launches", 0)


def test_each_launch_is_one_row_at_its_bytes_per_launch(small_split,
                                                        launch_path):
    mesh = make_mesh("cpu")
    step, ds, state, u = pbench._make(
        "mnist_cnn", "mnist", B, 1, mesh, ce_impl="pallas", fused_opt=True,
        dequant_impl="pallas")
    audit = profiling.BytesAudit()
    profiling.audit_step(step, ds, state, calls=2, audit=audit)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 2)
    rows = {name: [r for r in audit.rows if r["opcode"] == name]
            for name in kernels.WRAPPERS}
    split = ROWS * 784 + B * 4 + 4 + 4
    want = {  # name: (category, raw, effective, out)
        "dequant": ("gather", split + B * 784 * 4,
                    dq.bytes_per_launch(B, 784, 1), "f32[64,28,28,1]"),
        "ce_fwd": ("reduce", ce.bytes_per_launch(B, 10),
                   ce.bytes_per_launch(B, 10), "f32[64]"),
        "ce_bwd": ("reduce", ce.bytes_per_launch(B, 10, backward=True),
                   ce.bytes_per_launch(B, 10, backward=True), "f32[64,10]"),
        "sgd": ("elementwise", sgd.bytes_per_launch(CNN_PARAMS),
                sgd.bytes_per_launch(CNN_PARAMS),
                f"(f32[{CNN_PARAMS}], f32[{CNN_PARAMS}])")}
    for name, (cat, raw, eff, out) in want.items():
        assert [(r["category"], r["bytes"], r["effective_bytes"], r["out"])
                for r in rows[name]] == [(cat, raw, eff, out)] * 2, name
    assert dq.bytes_per_launch(B, 784, 1) == B * 784 * 5 + B * 4 + 8
    assert sgd.bytes_per_launch(CNN_PARAMS) == 20 * CNN_PARAMS
    # No plain version ran: no float64 dequant, no float64 optimizer line.
    assert not [r for r in audit.rows if "f64" in r["out"]]
    assert kernels.AUDITS == []


# --- the CLI ----------------------------------------------------------------

def test_the_cli_record_has_the_jax_tool_keys(monkeypatch, tmp_path):
    import distributedtensorflowexample_tpu.parallel as jparallel
    sys.path.insert(0, os.path.join(REPO, "tools"))
    sys.path.insert(0, REPO)
    try:
        import bench as jbench
        import bytes_audit as jbytes_audit
    finally:
        del sys.path[:2]
    real_mesh = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh", lambda: real_mesh(1))
    monkeypatch.setattr(jbench, "TRAIN_N", {"mnist": 64, "cifar10": 64})
    want = jbytes_audit.build_and_audit("softmax", 8, 1)

    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": 64, "cifar10": 64})
    path = tmp_path / "out.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bytes_audit.main(["--device", "cpu", "--workload", "softmax",
                                 "--batch_per_chip", "8", "--json",
                                 str(path)]) == 0
    got = json.loads(path.read_text())
    assert set(got) == set(want) - {"backend"} | {"device"}
    assert set(got["audit"]) == set(want["audit"])
    assert set(got["audit"]["top_ops"][0]) == set(want["audit"]["top_ops"][0])
    assert set(got["cost_per_step"]) == set(want["cost_per_step"])
    assert got["bw_roofline_effective_steps_per_sec"] is None
    assert got["device"]["platform"] == "cpu"
    assert got["arith_intensity_effective"] == round(
        got["cost_per_step"]["flops"]
        / got["audit"]["bytes_effective_per_step"], 3)
    text = out.getvalue()
    assert "by category" in text and "top " in text and str(path) in text
    # The card's tool exits 1 without a card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bytes_audit.main(["--workload", "softmax"]) == 1


def test_an_audit_leaves_no_mode_or_hook_behind(small_split):
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from torch.nn.modules import module as nn_module
    hooks = len(nn_module._global_forward_pre_hooks)
    _audit("softmax")
    assert _get_current_dispatch_mode() is None
    assert kernels.AUDITS == []
    assert len(nn_module._global_forward_pre_hooks) == hooks
    # itertools.repeat stands in for a dataset (the bench probe's use).
    step = lambda st, b: (st, {"sum": b.sum()})
    cost, audit = profiling.audit_step(step, itertools.repeat(
        torch.ones(4)), None)
    assert cost == {"bytes_accessed": 16 + 4} and \
        audit["by_category_per_step"] == {"reduce": 20}
