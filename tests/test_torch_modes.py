"""The replication modes on the CPU: the port's ``bucketed``, ``zero1``,
``zero3`` and ``--shard_update``'s tree form on 2 and 4 gloo ranks, one
process each (``parallel/launch.spawn``), against the JAX package's step
builders on a mesh of the conftest's virtual CPU devices, from the same
converted parameters and the JAX dataset's index tape; and the mode
resolution, the refusals, the bucket plan and the resume layouts against
the JAX package's.

Two groups (2 and 4 ranks) start once for the module and run every
check that needs a group, while the JAX side runs here.  The rank
workers import no JAX (a spawned rank imports this module to find them).

The JAX side runs ``make_indexed_train_step`` with the mode's knobs
(``bucket_bytes``, ``bucket_shard_update``, ``zero3_layout``: the
bucketed, ZeRO-1 and ZeRO-3 step builders) and, for the tree form,
``cross_replica_update_sharding`` around ``optax.sgd`` (the setup of
``tests/test_lm.py``'s constraint-form test), with the dequant and
cross-entropy Pallas kernels in interpret mode; the state comes from
``init_bucketed_opt_state`` and ``Zero3Layout.init_rows``.  The JAX
package's golden-inventory tests of these modes fail on this jax pin (one
fused metrics all-reduce where they expect two), so their verdicts are
not used.

Every model runs in float32: softmax (one bucket), MnistCNN (16 KiB
buckets: 4 of them) and lm_tiny (64 KiB buckets: 5), B=8 per rank (lm:
4 rows of 32 tokens), lr 0.05, momentum 0.9, 3 steps.  Tolerances: the
loss tape, the final parameters and the momentum rows within rtol 1e-5
(atol 1e-6) of the JAX mode's, which is the port's sync step against
JAX's (the two sides' matrix products sum in other orders, so not
bitwise, softmax included); the ZeRO-3 parameter rows at init bitwise
the converted ``init_rows``.  Between the port's own modes at 2 ranks:
bitwise (a two-operand sum commutes, and every mode adds the same two
partial gradients).  At 4 ranks gloo's ring sums each element in an
order that depends on where its chunk boundaries fall, which a bucket
moves: the modes agree within rtol 1e-5 there, and ZeRO-1 and ZeRO-3
(the same reduce-scatters of the same rows) bitwise with each other.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.data.lm import load_lm
from distributedtensorflowexample_tpu_torch.data.synthetic import (
    make_synthetic)
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from distributedtensorflowexample_tpu_torch.parallel.zero3 import materialized
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal

B, ROWS, STEPS, LR, MU = 8, 256, 3, 0.05, 0.9
LM_B, SEQ = 4, 32
BUCKET_BYTES = {"softmax": 1 << 20, "mnist_cnn": 16 << 10,
                "lm_tiny": 64 << 10}
MODELS = tuple(BUCKET_BYTES)
MODES = ("sync_dp", "bucketed", "zero1", "zero3", "tree")
JAX_MODES = ("bucketed", "zero1", "zero3", "tree")
PARTIAL_R = 3                   # replicas_to_aggregate at 4 ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every spawned rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mode_flags(mode: str, bucket_bytes: int) -> list[str]:
    bb = str(bucket_bytes)
    return {"sync_dp": [], "bucketed": ["--bucket_grads", bb],
            "zero1": ["--bucket_grads", bb, "--shard_update", "true"],
            "zero3": ["--bucket_grads", bb, "--shard_params", "true"],
            "tree": ["--shard_update", "true"]}[mode]


def _flags(model: str, mode: str, *extra) -> list[str]:
    batch = LM_B if model.startswith("lm") else B
    return ["--device", "cpu", "--momentum", str(MU), "--learning_rate",
            str(LR), "--dropout", "0", "--dtype", "float32",
            "--pallas_ce", "true", "--batch_size", str(batch),
            *(() if model.startswith("lm") else ("--dequant_impl",
                                                 "pallas")),
            *_mode_flags(mode, BUCKET_BYTES[model]), *extra]


def _data(model: str):
    if model.startswith("lm"):
        return load_lm("", "train", num=64, seq_len=SEQ)
    return make_synthetic(ROWS, (28, 28, 1), 10, seed=0, sample_seed=1)


def _spec(model: str, mode: str, *extra) -> RunSpec:
    dataset = "lm" if model.startswith("lm") else "mnist"
    return RunSpec(model, dataset, parse_flags(_flags(model, mode, *extra)))


def _small_mnist() -> None:
    from distributedtensorflowexample_tpu_torch.data import mnist
    mnist._SYNTH_SIZES = {"train": 512, "test": 128}


def _numpy(obj):
    """Tensors to numpy arrays, through dicts and lists: a tensor sent
    back from a rank would be shared through a file descriptor that dies
    with it."""
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_numpy(v) for v in obj]
    return (obj.detach().numpy().copy() if isinstance(obj, torch.Tensor)
            else obj)


# --- rank workers (run in the spawned ranks; no JAX) ----------------------

def _flat_params(state, mesh) -> np.ndarray:
    """The full flat parameters (gathered from the rows under ZeRO-3)."""
    if state.optimizer.params_rows is not None:
        with materialized(state, mesh) as flat:
            return flat.numpy().copy()
    return state.optimizer.params_flat.detach().numpy().copy()


def _as_flax(state, flat: np.ndarray) -> dict:
    views = {n: flat[off:off + shape.numel()].reshape(tuple(shape))
             for n, (off, shape) in state.optimizer.slices.items()}
    return convert.port_to_flax(views, convert.embedding_modules(
        state.model))


def _run(mesh, inp, model: str, mode: str, *extra, steps: int = STEPS,
         params0=None) -> dict:
    """``steps`` steps of ``model`` in ``mode`` from the converted JAX
    init over the JAX index tape: the global loss tape, the final flat
    parameters, this rank's rows, the collectives a step."""
    engine = Engine(_spec(model, mode, *extra))
    state = engine.create_state(mesh)
    convert.load_into_state(state, inp[model]["params0"]
                            if params0 is None else params0)
    state, layout = engine.laid_out_state(mesh, state)
    opt = state.optimizer
    rows0 = (None if opt.params_rows is None else
             [r.detach().numpy().copy() for r in opt.params_rows])
    built = engine.build(mesh, data=_data(model), state=state,
                         zero3_layout=layout,
                         perm_fn=inp[model]["perms"].__getitem__)
    before = dict(mesh.collectives)
    tape = []
    for _ in range(steps):
        _, m = built.step(built.state, next(built.ds))
        tape.append(float(mesh.sum_metrics(m)["loss"]))
    flat = _flat_params(state, mesh)
    return {"tape": tape, "flat": flat,
            "params": _as_flax(state, flat) if mesh.rank == 0 else None,
            "momentum_rows": _numpy(opt.momentum_rows),
            "rows0": rows0, "rows": _numpy(opt.params_rows),
            "num_buckets": (None if built.plan is None
                            else built.plan.num_buckets),
            "collectives": {k: (mesh.collectives[k] - before[k]) / steps
                            for k in before}}


def _resident(mesh) -> dict:
    """The bytes of this rank's optimizer state per layout, lm_tiny."""
    out = {}
    for mode in ("sync_dp", "zero1", "zero3"):
        engine = Engine(_spec("lm_tiny", mode))
        state, layout = engine.laid_out_state(mesh)
        opt = state.optimizer
        tensors = [opt.params_flat, opt.grads_flat, opt.momentum_flat,
                   *(opt.params_rows or ()), *(opt.momentum_rows or ())]
        out[mode] = sum(t.numel() * 4 for t in tensors if t is not None)
        if layout is not None:
            out["zero3_report"] = (layout.resident_bytes(),
                                   layout.padding_bytes)
    return out


def _trainer_argv(log_dir, *extra) -> list[str]:
    return ["--device", "cpu", "--dataset", "synthetic", "--batch_size",
            str(B), "--log_every", "2", "--learning_rate", "0.02",
            "--dropout", "0.5", "--checkpoint_every", "2",
            "--log_dir", str(log_dir), *extra]


def _resume(mesh, dirs) -> dict:
    """Config 3 through the trainer in each row layout (dropout on): 4
    steps, and 2 steps then a resume to 4 in another log dir; each
    rank's final checkpoint part.  Then a tree run in the ZeRO-3 dir,
    which must be refused by name."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    _small_mnist()
    out = {}
    for layout, flags in (("bucket_rows", ["--bucket_grads", "65536",
                                           "--shard_update", "true"]),
                          ("zero3_rows", ["--bucket_grads", "65536",
                                          "--shard_params", "true"])):
        for name, stops in (("straight", (4,)), ("resumed", (2, 4))):
            log_dir = dirs[f"{layout}_{name}"]
            for steps in stops:
                summary = trainer_sync_mnist.main(_trainer_argv(
                    log_dir, *flags, "--train_steps", str(steps)))
            out[(layout, name)] = {"summary": summary, "part": _numpy(
                torch.load(f"{log_dir}/checkpoints/4/rank-{mesh.rank}.pt",
                           weights_only=True))}
    try:
        trainer_sync_mnist.main(_trainer_argv(
            dirs["zero3_rows_straight"], "--train_steps", "6"))
    except ModeRefusal as err:
        out["cross_layout"] = str(err)
    # --shard_update's tree form keeps the tree layout: one part with the
    # full momentum, which a plain sync run resumes as well as itself.
    tree = ("--shard_update", "true")
    for name, stops in (("straight", (4,)), ("resumed", (2, 4))):
        for steps in stops:
            summary = trainer_sync_mnist.main(_trainer_argv(
                dirs[f"tree_{name}"], *tree, "--train_steps", str(steps)))
        out[("tree", name)] = {"summary": summary, "part": _numpy(
            torch.load(f"{dirs[f'tree_{name}']}/checkpoints/4/rank-0.pt",
                       weights_only=True))}
    out[("tree", "sharded_to_6")] = trainer_sync_mnist.main(_trainer_argv(
        dirs["tree_straight"], *tree, "--train_steps", "6"))
    out[("tree", "plain_to_6")] = trainer_sync_mnist.main(_trainer_argv(
        dirs["tree_resumed"], "--train_steps", "6"))
    return out


def _rank_checks(inp, dirs) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank}
    for model in MODELS:
        for mode in MODES:
            out[(model, mode)] = _run(mesh, inp, model, mode)
    out["zero3_serial"] = _run(mesh, inp, "lm_tiny", "zero3",
                               "--zero3_overlap", "false")
    out["bucketed_16k"] = _run(mesh, inp, "lm_tiny", "bucketed",
                               "--bucket_grads", str(16 << 10))
    out["resident"] = _resident(mesh)
    if mesh.size == 4:
        for mode in ("sync_dp", "bucketed"):
            out[("partial", mode)] = _run(
                mesh, inp, "softmax", mode, "--replicas_to_aggregate",
                str(PARTIAL_R))
    if mesh.size == 2:
        out["resume"] = _resume(mesh, dirs)
    return out


# --- the JAX side and the groups ------------------------------------------

def _jax_model(model: str):
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    if model == "mnist_cnn":
        return jax_build_model(model, dropout=0.0, dtype=jnp.float32)
    if model.startswith("lm"):
        return jax_build_model(model, dtype=jnp.float32)
    return jax_build_model(model)


def _jax_params0(model: str) -> dict:
    import jax
    import jax.numpy as jnp
    shape = (2, SEQ) if model.startswith("lm") else (2, 28, 28, 1)
    dtype = jnp.int32 if model.startswith("lm") else jnp.float32
    params = jax.jit(_jax_model(model).init)(
        jax.random.PRNGKey(0), jnp.zeros(shape, dtype))["params"]
    return jax.tree.map(lambda a: np.array(a, copy=True), params)


def _jax_dataset(model: str, n: int):
    from distributedtensorflowexample_tpu.data.device_dataset import (
        DeviceDataset as JaxDeviceDataset)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)
    x, y = _data(model)
    lm = model.startswith("lm")
    return JaxDeviceDataset(x, y, (LM_B if lm else B) * n,
                            mesh=jax_make_mesh(n), seed=0, token_data=lm,
                            dequant_impl="auto" if lm else "pallas")


def _jax_perms(model: str, n: int) -> list:
    import jax.numpy as jnp
    jds = _jax_dataset(model, n)
    return [np.asarray(jds._make_perm(jnp.asarray(e, jnp.int32)))
            for e in range(4)]


def _jax_run(model: str, n: int, mode: str, params0: dict,
             replicas_to_aggregate: int = 0) -> dict:
    """STEPS steps of the JAX package's ``mode`` step on an n-device
    mesh: the tape, the final params tree, and the bucket rows of the
    momentum (and of the params under zero3, at init too)."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.parallel.bucketing import (
        init_bucketed_opt_state)
    from distributedtensorflowexample_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.parallel.sync import (
        make_indexed_train_step as jax_make_indexed_train_step)
    from distributedtensorflowexample_tpu.parallel.zero3 import Zero3Layout
    from distributedtensorflowexample_tpu.training.optimizers import (
        cross_replica_update_sharding, update_shardings)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    mesh = jax_make_mesh(n)
    bb = BUCKET_BYTES[model]
    host = lambda t: jax.tree.map(lambda a: np.array(a, copy=True), t)
    tx = optax.sgd(LR, momentum=MU)
    params = jax.tree.map(jnp.asarray, params0)
    opt_state = tx.init(params)
    if mode == "tree":
        tx = cross_replica_update_sharding(tx, mesh)
    state = jax.device_put(JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        opt_state=opt_state, batch_stats={},
        rng=jax.random.PRNGKey(1), tx=tx, apply_fn=_jax_model(model).apply),
        replicated_sharding(mesh))
    layout, out = None, {}
    if mode == "tree":
        state = state.replace(opt_state=jax.device_put(
            state.opt_state, update_shardings(state.opt_state, mesh)))
    if mode in ("zero1", "zero3"):
        state = state.replace(opt_state=init_bucketed_opt_state(
            optax.sgd(LR, momentum=MU), state.params, bb, mesh))
    if mode == "zero3":
        layout = Zero3Layout(state.params, bb, mesh)
        state = state.replace(params=layout.init_rows(state.params))
        out["rows0"] = host(state.params)
    jds = _jax_dataset(model, n)
    lm = model.startswith("lm")
    step = jax_make_indexed_train_step(
        (LM_B if lm else B) * n, jds.steps_per_epoch, ce_impl="pallas",
        dequant_impl="auto" if lm else "pallas", mesh=mesh, num_replicas=n,
        replicas_to_aggregate=replicas_to_aggregate,
        num_slots=jds.num_slots,
        bucket_bytes=bb if mode in ("bucketed", "zero1") else None,
        bucket_shard_update=mode == "zero1", zero3_layout=layout)
    tape = []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, next(jds))
            tape.append(float(m["loss"]))
    out["tape"] = tape
    out["params"] = host(layout.materialize(state.params)
                         if layout is not None else state.params)
    if mode in ("zero1", "zero3"):
        out["momentum_rows"] = [np.asarray(s[0].trace)
                                for s in state.opt_state]
    if mode == "zero3":
        out["rows"] = host(state.params)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sizes = (2, 4)
    params0 = {m: _jax_params0(m) for m in MODELS}
    inputs = {n: {m: {"params0": params0[m], "perms": _jax_perms(m, n)}
                  for m in MODELS} for n in sizes}
    dirs = {f"{layout}_{name}": str(tmp_path_factory.mktemp(
        f"{layout}_{name}")) for layout in ("bucket_rows", "zero3_rows",
                                            "tree")
        for name in ("straight", "resumed")}
    with ThreadPoolExecutor(len(sizes)) as pool:
        groups = {n: pool.submit(launch.spawn, _rank_checks, n, "gloo",
                                 (inputs[n], dirs), 400) for n in sizes}
        jax_side = {(n, m, mode): _jax_run(m, n, mode, params0[m])
                    for n in sizes for m in MODELS for mode in JAX_MODES
                    if mode != "tree" or m == "lm_tiny"}
        jax_side[(4, "partial")] = _jax_run("softmax", 4, "bucketed",
                                            params0["softmax"], PARTIAL_R)
        ranks = {n: g.result() for n, g in groups.items()}
    return {"params0": params0, "ranks": ranks, "jax": jax_side}


# --- the checks -----------------------------------------------------------

def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


def _bits(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


CASES = [(n, m, mode) for n in (2, 4) for m in MODELS for mode in JAX_MODES
         if mode != "tree" or m == "lm_tiny"]


@pytest.mark.parametrize("n,model,mode", CASES)
def test_modes_track_the_jax_step(runs, n, model, mode):
    """Each mode against the JAX package's step of that mode: the tape,
    the final parameters and every rank's momentum rows after 3 steps;
    under ZeRO-3 the parameter rows too, bitwise at init."""
    ranks = [r[(model, mode)] for r in runs["ranks"][n]]
    want = runs["jax"][(n, model, mode)]
    tape = ranks[0]["tape"]
    assert all(r["tape"] == tape for r in ranks)
    assert all(np.isfinite(tape))
    _close(tape, want["tape"], "tape")
    mine = dict(_leaves(ranks[0]["params"]))
    for path, w in _leaves(want["params"]):
        _close(mine[path], w, path)
    assert all(_bits(r["flat"]) == _bits(ranks[0]["flat"]) for r in ranks)
    params0 = runs["params0"][model]
    bb = BUCKET_BYTES[model]
    for key in ("momentum_rows", "rows0", "rows"):
        if key not in want:
            continue
        conv = convert.jax_rows_to_port(want[key], params0, bb, n)
        for d, r in enumerate(ranks):
            assert len(r[key]) == len(conv[d])
            for b, (g, w) in enumerate(zip(r[key], conv[d])):
                if key == "rows0":
                    np.testing.assert_array_equal(g, w, err_msg=f"{d} {b}")
                else:
                    _close(g, w, f"{key} rank {d} bucket {b}")
        if key == "momentum_rows":
            # and back: the converters are each other's inverse
            back = convert.port_rows_to_jax(conv, params0, bb)
            for a, w in zip(back, want[key]):
                np.testing.assert_array_equal(a, np.asarray(w))


@pytest.mark.parametrize("n", [2, 4])
def test_every_mode_against_the_ports_sync_step(runs, n):
    """At 2 ranks every mode is bitwise the port's sync_dp (one sum of
    two operands per element, in any grouping).  At 4 ranks gloo's ring
    orders each element's sum by its chunk, which the buckets move: the
    modes agree within rtol 1e-5, and ZeRO-1 and ZeRO-3 (the same
    reduce-scatters of the same rows) bitwise."""
    for r in runs["ranks"][n]:
        for model in MODELS:
            ref = r[(model, "sync_dp")]
            for mode in MODES[1:]:
                got = r[(model, mode)]
                if n == 2:
                    assert got["tape"] == ref["tape"], (model, mode)
                    assert _bits(got["flat"]) == _bits(ref["flat"]), \
                        (model, mode)
                else:
                    _close(got["tape"], ref["tape"], f"{model} {mode}")
                    _close(got["flat"], ref["flat"], f"{model} {mode}")
            assert _bits(r[(model, "zero1")]["flat"]) == \
                _bits(r[(model, "zero3")]["flat"]), model


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_per_step_match_the_budgets(runs, n):
    """Per step: sync_dp one all-reduce; bucketed B all-reduces; ZeRO-1 B
    reduce-scatters and B all-gathers; ZeRO-3 B all-gathers and B
    reduce-scatters (no step-closing all-gather); the tree form of
    --shard_update one of each.  Each run is held to the budget of the
    mode its flags resolve to (``engine/spec.collective_budget``), every
    other kind 0; B is the JAX plan's on the converted tree."""
    import jax

    from distributedtensorflowexample_tpu.parallel.bucketing import (
        plan_buckets as jax_plan_buckets)
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        collective_budget)
    for r in runs["ranks"][n]:
        for model in MODELS:
            b = len(jax_plan_buckets(jax.tree.leaves(
                runs["params0"][model]), BUCKET_BYTES[model]))
            for mode, buckets, want in (
                    ("sync_dp", None, {"all-reduce": 1}),
                    ("bucketed", b, {"all-reduce": b}),
                    ("zero1", b, {"reduce-scatter": b, "all-gather": b}),
                    ("zero3", b, {"all-gather": b, "reduce-scatter": b}),
                    ("tree", 1, {"reduce-scatter": 1, "all-gather": 1})):
                got = r[(model, mode)]
                assert got["num_buckets"] == buckets, (model, mode)
                budget = collective_budget(_spec(model, mode).config, n,
                                           got["num_buckets"])
                assert budget == want, (model, mode, budget)
                assert {k: v for k, v in got["collectives"].items()
                        if v} == budget, (model, mode, got["collectives"])
    assert b >= 3           # lm_tiny: a real multi-bucket ladder


class _OneProcessMesh:
    """Rank 0 of a two-rank mesh in one process, for the ZeRO-3 schedule:
    an all-gather tiles this rank's row twice, a reduce-scatter sums the
    two halves, and each issue, wait and reduce-scatter is logged (by
    bucket where it has one)."""

    size, rank = 2, 0

    def __init__(self, log: list):
        self.log, self.buckets = log, {}

    def all_gather_into(self, row, counted=True, async_op=False):
        b = self.buckets[row.data_ptr()]
        self.log.append(("issue", b))
        log = self.log

        class Pending:
            def wait(self):
                log.append(("wait", b))
                return torch.cat([row, row])

        return Pending()

    def reduce_scatter(self, flat, counted=True):
        self.log.append(("reduce-scatter", None))
        return flat.view(2, -1).sum(0)


def _zero3_one_process(remat: str, overlap: bool, log: list,
                       monkeypatch) -> tuple:
    """Three ZeRO-3 steps of lm_tiny (float32, 64 KiB buckets) on
    :class:`_OneProcessMesh`, each first read of a bucket in the forward
    logged: the losses and the final parameter rows."""
    from types import SimpleNamespace

    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.parallel import zero3
    from distributedtensorflowexample_tpu_torch.parallel.sync import (
        make_loss_rows)
    from distributedtensorflowexample_tpu_torch.training.optimizers import (
        build_optimizer)
    leaf = zero3._StepGathers.leaf

    def logged_leaf(self, name):
        if name not in self.leaves:
            log.append(("read", self.plan.bucket_of[name]))
        return leaf(self, name)

    monkeypatch.setattr(zero3._StepGathers, "leaf", logged_leaf)
    cfg = parse_flags(_flags("lm_tiny", "zero3", "--remat", remat))
    model = build_model("lm_tiny", dropout=0.0, dtype=torch.float32,
                        remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = build_optimizer(cfg, model)
    mesh = _OneProcessMesh(log)
    layout = zero3.Zero3Layout(opt.slices, BUCKET_BYTES["lm_tiny"], mesh)
    opt.shard_params(layout, 0, model)
    mesh.buckets = {r.data_ptr(): b for b, r in enumerate(opt.params_rows)}
    step = zero3.build_zero3_step_fn(make_loss_rows(ce_impl="pallas"),
                                     lambda s: 0.5, layout, mesh, overlap)
    state = SimpleNamespace(model=model, optimizer=opt, step=0,
                            generator=None)
    x, y = (torch.from_numpy(a) for a in _data("lm_tiny"))
    losses = []
    for i in range(3):
        log.append(("step", i))
        m = step(state, {"image": x[4 * i:4 * i + 4],
                         "label": y[4 * i:4 * i + 4]})
        losses.append(float(m["loss"]))
    return losses, [r.detach().clone() for r in opt.params_rows], \
        layout.num_buckets


@pytest.mark.parametrize("overlap", [True, False])
def test_zero3_gathers_each_bucket_at_its_first_read(overlap, monkeypatch):
    """Per step every bucket is gathered once and reduce-scattered once;
    each gather is waited on at its bucket's first read in the forward
    (the buckets arrive while the forward runs, not all before it); with
    overlap two gathers are in flight ahead of the reads, in the order of
    the previous step's reads; without, one, issued at the read.  Under
    ``--remat block`` the replay in the backward gathers nothing, and the
    step is bitwise the one without remat."""
    log: list = []
    losses, rows, nb = _zero3_one_process("block", overlap, log, monkeypatch)
    assert nb >= 3
    steps = [[]]
    for event in log[1:]:
        if event[0] == "step":
            steps.append([])
        else:
            steps[-1].append(event)
    previous_reads = None
    for i, events in enumerate(steps):
        issues = [b for k, b in events if k == "issue"]
        waits = [b for k, b in events if k == "wait"]
        reads = [b for k, b in events if k == "read"]
        assert sorted(issues) == sorted(waits) == list(range(nb)), i
        assert sum(k == "reduce-scatter" for k, _ in events) == nb, i
        # each wait directly follows its bucket's first read (and its
        # issue, where the read came before it)
        after = [events[j + 1] if events[j + 1] != ("issue", e[1])
                 else events[j + 2]
                 for j, e in enumerate(events) if e[0] == "read"]
        assert after == [("wait", b) for b in reads], i
        in_flight, most = set(), 0
        for k, b in events:
            if k == "issue":
                in_flight.add(b)
                most = max(most, len(in_flight))
            elif k == "wait":
                in_flight.discard(b)
        first_read = events.index(("read", reads[0]))
        last_issue = max(j for j, e in enumerate(events) if e[0] == "issue")
        assert first_read < last_issue, i
        if overlap and previous_reads is not None:
            assert issues == previous_reads, i
            assert most == 2, i
        if not overlap:
            assert most == 1, i
        previous_reads = reads
    plain, plain_rows, _ = _zero3_one_process("none", overlap, [],
                                              monkeypatch)
    assert losses == plain
    assert all(torch.equal(a, b) for a, b in zip(rows, plain_rows))


@pytest.mark.parametrize("n", [2, 4])
def test_zero3_overlap_is_scheduling_only(runs, n):
    for r in runs["ranks"][n]:
        on, off = r[("lm_tiny", "zero3")], r["zero3_serial"]
        assert on["tape"] == off["tape"]
        assert _bits(on["flat"]) == _bits(off["flat"])
        for a, b in zip(on["rows"] + on["momentum_rows"],
                        off["rows"] + off["momentum_rows"]):
            np.testing.assert_array_equal(a, b)
        assert on["collectives"] == off["collectives"]


@pytest.mark.parametrize("n", [2, 4])
def test_bucket_size_invariance(runs, n):
    """lm_tiny bucketed at 64 KiB and 16 KiB: more all-reduces, the same
    sums; bitwise at 2 ranks, within rtol 1e-5 at 4 (gloo's chunks)."""
    for r in runs["ranks"][n]:
        big, small = r[("lm_tiny", "bucketed")], r["bucketed_16k"]
        assert small["collectives"]["all-reduce"] > \
            big["collectives"]["all-reduce"]
        if n == 2:
            assert big["tape"] == small["tape"]
            assert _bits(big["flat"]) == _bits(small["flat"])
        else:
            _close(small["flat"], big["flat"], "16 KiB against 64 KiB")


@pytest.mark.parametrize("n", [2, 4])
def test_per_rank_state_bytes_in_each_layout(runs, n):
    """lm_tiny's optimizer state per rank: sync_dp holds parameters,
    gradients and momentum in full; ZeRO-1 the momentum as rows; ZeRO-3
    the parameters and the momentum as rows only: (params + momentum)/D
    plus the JAX row padding, with no gradient kept between steps."""
    import jax

    from distributedtensorflowexample_tpu.parallel.bucketing import (
        bucket_padding_bytes as jax_padding)
    leaves = jax.tree.leaves(runs["params0"]["lm_tiny"])
    full = sum(l.size for l in leaves) * 4
    rows = (full + jax_padding(leaves, n)) // n
    for r in runs["ranks"][n]:
        assert r["resident"] == {"sync_dp": 3 * full,
                                 "zero1": 2 * full + rows,
                                 "zero3": 2 * rows,
                                 "zero3_report": (2 * rows,
                                                  jax_padding(leaves, n))}


def test_partial_aggregation_composes_with_bucketing(runs):
    """replicas_to_aggregate 3 of 4 under --bucket_grads, against the JAX
    bucketed step with the same R (its rotating subset in global row
    coordinates), and against the port's own sync step with R."""
    want = runs["jax"][(4, "partial")]
    for r in runs["ranks"][4]:
        got, ref = r[("partial", "bucketed")], r[("partial", "sync_dp")]
        _close(got["tape"], want["tape"], "tape")
        mine = dict(_leaves(got["params"])) if got["params"] else None
        if mine is not None:
            for path, w in _leaves(want["params"]):
                _close(mine[path], w, path)
        _close(got["flat"], ref["flat"], "bucketed against sync_dp")
        assert got["collectives"]["all-reduce"] == 1.0     # one bucket


def test_resume_is_bitwise_in_the_row_layouts(runs):
    for r in runs["ranks"][2]:
        for layout in ("bucket_rows", "zero3_rows"):
            straight = r["resume"][(layout, "straight")]
            resumed = r["resume"][(layout, "resumed")]
            assert resumed["summary"]["start_step"] == 2
            assert straight["summary"]["update_layout"] == layout
            a, b = straight["part"], resumed["part"]
            assert a["layout"] == b["layout"] == layout
            assert a["step"] == b["step"] == 4
            if layout == "bucket_rows":
                np.testing.assert_array_equal(a["params"], b["params"])
            else:
                assert "params" not in a
            rows = ("momentum_rows",) + (("params_rows",)
                                         if layout == "zero3_rows" else ())
            for key in rows:
                assert len(a[key]) == len(b[key]) > 1
                for x, y in zip(a[key], b[key]):
                    np.testing.assert_array_equal(x, y, err_msg=key)
            assert set(a["generators"]) == {r["rank"]}
            np.testing.assert_array_equal(a["generators"][r["rank"]],
                                          b["generators"][r["rank"]])
            assert straight["summary"]["params_digest"] == \
                resumed["summary"]["params_digest"]
    digests = {r["resume"][("zero3_rows", "straight")]["summary"][
        "params_digest"] for r in runs["ranks"][2]}
    assert len(digests) == 1        # the rows gathered agree on every rank


def test_tree_form_checkpoint_holds_the_full_momentum(runs):
    """--shard_update without --bucket_grads keeps its momentum as this
    rank's row of one bucket, and saves the tree: one part, the full
    flat momentum gathered from the rows; a resume of it is bitwise, and
    a plain sync run takes it up as well as the sharded one does."""
    ranks = runs["ranks"][2]
    for r in ranks:
        straight, resumed = (r["resume"][("tree", k)]
                             for k in ("straight", "resumed"))
        assert straight["summary"]["update_layout"] == "tree"
        assert resumed["summary"]["start_step"] == 2
        a, b = straight["part"], resumed["part"]
        assert a["layout"] == "tree" and "momentum_rows" not in a
        assert a["momentum"].shape == a["params"].shape
        for key in ("params", "momentum"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert set(a["generators"]) == {0, 1}
        sharded = r["resume"][("tree", "sharded_to_6")]
        plain = r["resume"][("tree", "plain_to_6")]
        assert sharded["start_step"] == plain["start_step"] == 4
        assert sharded["params_digest"] == plain["params_digest"]
        assert sharded["collectives"]["reduce-scatter"] == 2
        assert plain["collectives"]["all-reduce"] == 2


def test_cross_layout_resume_is_refused_by_name(runs):
    for r in runs["ranks"][2]:
        assert "'zero3_rows'" in r["resume"]["cross_layout"]
        assert "'tree'" in r["resume"]["cross_layout"]


# --- resolution, refusals and the plan (no group) -------------------------

def _jax_engine_modes():
    from test_engine import MODES as JAX_ENGINE_MODES
    return JAX_ENGINE_MODES


@pytest.mark.parametrize("row", range(6))
def test_mode_resolution_matches_jax(row):
    """Every row of the JAX engine tests' MODES table, on a RunConfig and
    on a plain dict, at 1, 2 and 8 ranks."""
    from distributedtensorflowexample_tpu.config import (
        RunConfig as JaxRunConfig)
    from distributedtensorflowexample_tpu.engine.spec import (
        resolve_mode as jax_resolve_mode,
        resolve_update_layout as jax_resolve_update_layout)
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        MODES as PORT_MODES, resolve_mode, resolve_update_layout)
    _, overrides, mode, layout, _ = _jax_engine_modes()[row]
    for n in (1, 2, 8):
        want = jax_resolve_mode(JaxRunConfig(**overrides), n)
        for cfg in (RunConfig(**overrides), dict(overrides)):
            got = resolve_mode(cfg, n)
            assert (got.name, got.update_layout) == (want.name,
                                                     want.update_layout)
            assert resolve_update_layout(cfg, n) == \
                jax_resolve_update_layout(dict(overrides), n)
        if n == 8:
            assert (want.name, want.update_layout) == (mode, layout)
    assert set(PORT_MODES) == set(
        __import__("distributedtensorflowexample_tpu.engine.spec",
                   fromlist=["MODES"]).MODES)


@pytest.mark.parametrize("row", range(6))
def test_describe_matches_jax(row, monkeypatch):
    """``Engine.describe()`` resolves what the JAX Engine's does, at 2
    ranks, building nothing; the contract is the port's own budget (the
    tree form of --shard_update: one reduce-scatter and one all-gather)."""
    from distributedtensorflowexample_tpu.config import (
        RunConfig as JaxRunConfig)
    from distributedtensorflowexample_tpu.engine.engine import (
        Engine as JaxEngine)
    from distributedtensorflowexample_tpu.engine.spec import (
        RunSpec as JaxRunSpec)
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    monkeypatch.delenv("SUPERVISE_HEARTBEAT", raising=False)
    monkeypatch.delenv("SNAPSHOT_DIR", raising=False)
    _, overrides, mode, layout, _ = _jax_engine_modes()[row]
    kw = dict(overrides, num_devices=2, checkpoint_every=5, eval_every=10)
    want = JaxEngine(JaxRunSpec("softmax", "mnist",
                                JaxRunConfig(**kw))).describe()
    got = Engine(RunSpec("softmax", "mnist",
                         RunConfig(device="cpu", **kw))).describe()
    for key in ("mode", "update_layout", "bucket_bytes", "mesh_size",
                "token_data", "checkpointing", "entrypoint"):
        assert got[key] == want[key], key
    assert got["hooks"] == want["hooks"]
    assert (got["contract"] is None) == (want["contract"] is None)
    tree_form = {"reduce-scatter": 1, "all-gather": 1}
    assert got["contract"] == {
        "sync_dp": tree_form if kw.get("shard_update") else {"all-reduce": 1},
        "async_ps": None, "bucketed": {"all-reduce": "B"},
        "zero1": {"reduce-scatter": "B", "all-gather": "B"},
        "zero3": {"all-gather": "B", "reduce-scatter": "B"}}[got["mode"]]


REFUSALS = [
    dict(sync_mode="async", fused_optimizer=True),
    dict(sync_mode="async", shard_update=True),
    dict(bucket_grads="auto", fused_optimizer=True, momentum=0.9),
    dict(sync_mode="async", bucket_grads="auto", shard_params=True),
    dict(shard_params=True),
    dict(bucket_grads="bogus"),
    dict(bucket_grads="0"),
]


@pytest.mark.parametrize("overrides", REFUSALS)
def test_flag_refusals_read_as_jax(overrides):
    from distributedtensorflowexample_tpu.config import (
        RunConfig as JaxRunConfig)
    from distributedtensorflowexample_tpu.engine.engine import (
        Engine as JaxEngine)
    from distributedtensorflowexample_tpu.engine.spec import (
        RunSpec as JaxRunSpec)
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        _resolve_flags)
    jax_engine = JaxEngine(JaxRunSpec("softmax", "mnist",
                                      JaxRunConfig(**overrides)))
    with pytest.raises(ValueError) as want:
        jax_engine._resolve_flags(JaxRunConfig(**overrides), 2)
    with pytest.raises(ModeRefusal) as got:
        _resolve_flags(RunConfig(**overrides), 2)
    assert str(got.value) == str(want.value)


def test_optimizer_refusal_reads_as_jax():
    from distributedtensorflowexample_tpu.config import (
        RunConfig as JaxRunConfig)
    from distributedtensorflowexample_tpu.training.optimizers import (
        build_optimizer as jax_build_optimizer)
    from distributedtensorflowexample_tpu_torch.config import RunConfig
    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.training.optimizers import (
        build_optimizer)
    kw = dict(fused_optimizer=True, shard_update=True, momentum=0.9)
    with pytest.raises(ValueError) as want:
        jax_build_optimizer(JaxRunConfig(**kw))
    with pytest.raises(ModeRefusal) as got:
        build_optimizer(RunConfig(**kw), build_model("softmax"))
    assert str(got.value) == str(want.value)


def test_resolve_bucket_bytes_matches_jax(monkeypatch):
    from distributedtensorflowexample_tpu.parallel.bucketing import (
        resolve_bucket_bytes as jax_resolve)
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        DEFAULT_BUCKET_BYTES, resolve_bucket_bytes)
    assert DEFAULT_BUCKET_BYTES == 1 << 20
    for env in (None, "123456", "0", "junk"):
        if env is None:
            monkeypatch.delenv("BUCKET_GRADS_AUTO_BYTES", raising=False)
        else:
            monkeypatch.setenv("BUCKET_GRADS_AUTO_BYTES", env)
        for flag in ("", "auto", "65536", "bogus", "0", "-4"):
            try:
                want = jax_resolve(flag)
            except ValueError as err:
                with pytest.raises(ModeRefusal, match="^" + str(err)
                                   .replace("(", r"\(").replace(")", r"\)")
                                   + "$"):
                    resolve_bucket_bytes(flag)
                continue
            assert resolve_bucket_bytes(flag) == want


def test_plan_buckets_and_padding_match_jax():
    """The JAX collectives tests' plan and padding cases, on both."""
    from distributedtensorflowexample_tpu.parallel.bucketing import (
        bucket_padding_bytes as jax_padding, plan_buckets as jax_plan)
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        bucket_padding_bytes, plan_buckets)
    mk = lambda shape, dt=np.float32: np.zeros(shape, dt)
    leaves = [mk(100), mk(200), mk(50, np.int32), mk(4000)]
    for cap in (1300 * 4, 4, 1 << 20, 800):
        assert plan_buckets(leaves, cap) == jax_plan(leaves, cap)
    assert plan_buckets(leaves, 1300 * 4) == [[0, 1], [2], [3]]
    assert plan_buckets([mk(10_000)], 4) == [[0]]
    for d in (2, 4, 8):
        assert bucket_padding_bytes([mk(10), mk(16)], d) == \
            jax_padding([mk(10), mk(16)], d)
    assert bucket_padding_bytes([mk(10), mk(16)], 8) == 6 * 4


@pytest.mark.parametrize("model,bucket_bytes", [
    ("mnist_cnn", 16 << 10), ("mnist_cnn", 1 << 20), ("lm_tiny", 64 << 10),
    ("lm_base", 1 << 20)])
def test_port_plan_is_the_jax_plan(model, bucket_bytes):
    """The port's flat buffer holds the parameters in named_parameters()
    order; its plan is made in the JAX leaf order, so bucket membership,
    B, the widths and the padding are the JAX plan's on the converted
    tree (lm_base from shapes alone)."""
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.parallel.bucketing import (
        bucket_padding_bytes as jax_padding, plan_buckets as jax_plan)
    from distributedtensorflowexample_tpu.parallel.zero3 import (
        LeafSpec as JaxLeafSpec)
    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        BucketPlan)
    lm = model.startswith("lm")
    shape = (2, SEQ) if lm else (2, 28, 28, 1)
    tree = jax.eval_shape(_jax_model(model).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.int32 if lm
                                               else jnp.float32))["params"]
    paths, leaves = zip(*jax.tree.leaves_with_path(tree))
    specs = [JaxLeafSpec(tuple(l.shape), np.dtype(l.dtype)) for l in leaves]
    with torch.device("meta"):
        port = build_model(model, dropout=0.0)
    slices, off = {}, 0
    for name, p in port.named_parameters():
        slices[name] = (off, p.shape)
        off += p.numel()
    plan = BucketPlan(slices, bucket_bytes, 4)
    names = [".".join(k.key for k in path) for path in paths]
    flax_names = list(convert.flax_to_port(
        jax.tree.map(lambda l: np.zeros((1,) * len(l.shape)), tree)))
    assert plan.names == flax_names
    assert [".".join(n.split(".")[:-1]) for n in plan.names] == \
        [".".join(n.split(".")[:-1]) for n in names]
    assert [list(b) for b in plan.plan] == jax_plan(specs, bucket_bytes)
    assert plan.padding_bytes == jax_padding(specs, 4)
    assert [s.size for s in plan.specs] == [s.size for s in specs]
    assert plan.names != [n for n, _ in port.named_parameters()]


def test_restore_refusals_match_jax():
    """The JAX collectives tests' layout guards, through both functions:
    the same refusals, word for word."""
    from distributedtensorflowexample_tpu.engine.engine import (
        _refuse_incompatible_restore as jax_refuse)
    from distributedtensorflowexample_tpu_torch.engine.engine import (
        _refuse_incompatible_restore)
    cur = {"sync_mode": "sync", "mesh_size": 8, "num_workers": None,
           "update_layout": "bucket_rows"}
    cur_z = dict(cur, update_layout="zero3_rows")
    cur_t = dict(cur, update_layout="tree")
    cases = [({"sync_mode": "sync", "mesh_size": 8}, cur, "'tree'"),
             ({"sync_mode": "sync", "mesh_size": 4,
               "update_layout": "bucket_rows"}, cur, "structural"),
             ({"sync_mode": "sync", "mesh_size": 4,
               "update_layout": "tree"}, cur_t, None),
             ({"sync_mode": "sync", "mesh_size": 8,
               "update_layout": "tree"}, cur_z, "zero3_rows"),
             ({"sync_mode": "sync", "mesh_size": 4,
               "update_layout": "zero3_rows"}, cur_z, "structural")]
    for saved, current, match in cases:
        if match is None:
            jax_refuse(saved, current, "/l", False)
            _refuse_incompatible_restore(saved, current, "/l", False)
            continue
        with pytest.raises(ValueError, match=match) as want:
            jax_refuse(saved, current, "/l", True)
        with pytest.raises(ModeRefusal) as got:
            _refuse_incompatible_restore(saved, current, "/l", True)
        assert str(got.value) == str(want.value)


def test_trainer_lm_base_takes_bucket_grads_auto():
    """lm_base's JAX defaults: --remat block and --bucket_grads auto; the
    fused apply with it is refused as in JAX, unless --bucket_grads ""
    is given."""
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    size, cfg = trainer_lm.build_config(["--size", "lm_base"])
    assert (size, cfg.remat, cfg.bucket_grads) == ("lm_base", "block",
                                                   "auto")
    assert trainer_lm.build_config(["--size", "lm_tiny"])[1].bucket_grads \
        == ""
    base = ["--device", "cpu", "--size", "lm_base", "--fused_optimizer",
            "true", "--train_steps", "2", "--log_dir", ""]
    with pytest.raises(ModeRefusal, match="--bucket_grads restructures"):
        trainer_lm.main(base)
    _, cfg = trainer_lm.build_config(base + ["--bucket_grads", ""])
    assert cfg.bucket_grads == "" and cfg.fused_optimizer


def test_zero3_layout_refuses_one_device():
    from distributedtensorflowexample_tpu_torch.parallel.mesh import ONE_RANK
    from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
        Zero3Layout)
    with pytest.raises(ValueError, match="multi-device"):
        Zero3Layout({"w": (0, torch.Size([4]))}, 1 << 20, ONE_RANK)
