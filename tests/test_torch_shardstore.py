"""The port's shard-redundant snapshots (``resilience/shardstore.py``)
against the JAX package's ``ShardStore`` on the same state.

The JAX side trains the softmax model for 3 steps under ZeRO-3 and under
ZeRO-1 (``make_train_step`` with ``zero3_layout``, and with
``bucket_shard_update``) on a 4-device CPU mesh at ``_BB = 1 << 20`` and
saves each state with its ``ShardStore``.  The port's 4 gloo ranks load
the same trained state, converted (``convert.jax_rows_to_port``), and save
it with the port's store: each rank's ``own.npz`` holds the JAX store's
rows for the same state, converted, bitwise.  Then, in the port (the JAX
package's ``tests/test_checkpoint.py`` shard-store checks): every single
rank directory lost in turn, and a flipped byte, restore bitwise from the
ring mirrors; loss past redundancy is refused with the JAX store's own
words; a D=4 set restored on the 2-rank group, saved there, and restored
on the 4 ranks again is bitwise the first.  The 2-rank group also tears
a save before its manifest (the step reads as absent), fails one rank's
write (no rank writes the manifest), and runs ``trainer_lm`` (lm_tiny,
dropout on) with ``SNAPSHOT_DIR`` under zero1 and zero3: 2 steps, then a
resume from the shard set to 4, against a straight 4-step run — the
step-4 sets' digests equal, so every rank's rows and its dropout
generator are bitwise.  Both groups start once and run beside each other
(the way back from D=2 waits on a marker file).
"""

import hashlib
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.config import parse_flags
from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    jax_leaf_order)
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from distributedtensorflowexample_tpu_torch.parallel.zero3 import materialized
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.resilience import snapshot
from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
    ShardLayout, ShardStore, _rebucket, _unbucket)

_BB = 1 << 20
STEPS = 3
LAYOUTS = ("zero3_rows", "bucket_rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(layout: str) -> RunSpec:
    knob = "--shard_params" if layout == "zero3_rows" else "--shard_update"
    return RunSpec("softmax", "mnist", parse_flags([
        "--device", "cpu", "--momentum", "0.9", "--learning_rate", "0.1",
        "--dtype", "float32", "--batch_size", "8", "--bucket_grads",
        str(_BB), knob, "true"]))


def _digest(state, mesh) -> str:
    """sha256 of the full parameters and momentum, gathered from the rows
    (uncounted): one value for one state at any width."""
    opt = state.optimizer
    h = hashlib.sha256()
    if opt.params_rows is not None:
        with materialized(state, mesh) as flat:
            h.update(flat.numpy().tobytes())
            full = torch.zeros_like(flat)
    else:
        h.update(opt.params_flat.numpy().tobytes())
        full = torch.zeros_like(opt.params_flat)
    for b, row in enumerate(opt.momentum_rows):
        opt.plan.unpack(mesh.all_gather_into(row, counted=False), full, b)
    h.update(full.numpy().tobytes())
    return h.hexdigest()


def _port_state(mesh, layout: str, jax_state: dict):
    """This rank's row state holding the JAX trained state, converted."""
    engine = Engine(_spec(layout))
    state = engine.create_state(mesh)
    convert.load_into_state(state, jax_state["params"])
    state, _ = engine.laid_out_state(mesh, state)
    opt = state.optimizer
    to_port = lambda rows: convert.jax_rows_to_port(
        rows, jax_state["params"], _BB, mesh.size)[mesh.rank]
    with torch.no_grad():
        for row, v in zip(opt.momentum_rows,
                          to_port(jax_state["momentum_rows"])):
            row.copy_(torch.from_numpy(v))
        if layout == "zero3_rows":
            for row, v in zip(opt.params_rows,
                              to_port(jax_state["param_rows"])):
                row.copy_(torch.from_numpy(v))
    state.step = opt.count = STEPS
    return state


def _fresh(mesh):
    return Engine(_spec("zero3_rows")).create_state(mesh)


def _copy(src: str, dst: str, mesh) -> str:
    if mesh.rank == 0:
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    mesh.all_gather_int(0)
    return dst


def _mark(path: str, mesh) -> None:
    mesh.all_gather_int(0)
    if mesh.rank == 0:
        open(path, "w").close()


def _wait_for(path: str, timeout_s: float = 240.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


# --- rank workers (no JAX) ------------------------------------------------

def _four(inp: dict, dirs: dict) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank}
    states = {}
    for layout in LAYOUTS:
        state = _port_state(mesh, layout, inp[layout])
        lay = ShardLayout.for_params(layout, _BB,
                                     dict(state.model.named_parameters()),
                                     mesh.size)
        ShardStore(dirs[f"port4_{layout}"], layout=lay).save(
            state, mesh, cursor={"seed": 0})
        states[layout] = state
        out[f"digest_{layout}"] = _digest(state, mesh)
    _mark(dirs["port4_done"], mesh)
    src, ref = dirs["port4_zero3_rows"], out["digest_zero3_rows"]
    for r in range(mesh.size):
        d = _copy(src, os.path.join(dirs["work"], f"loss_{r}"), mesh)
        if mesh.rank == 0:
            assert ShardStore(d).drop_rank_dir(r) == STEPS
        mesh.all_gather_int(0)
        ok = ShardStore(d).validate(STEPS)[0]
        state, aux = ShardStore(d).restore_elastic(_fresh(mesh), mesh=mesh)
        out[f"loss_{r}"] = (ok, aux["step"], aux["reconstructed"],
                            _digest(state, mesh) == ref)
    d = _copy(src, os.path.join(dirs["work"], "bitflip"), mesh)
    if mesh.rank == 0:
        assert ShardStore(d).flip_payload_byte(1)[0] == STEPS
    mesh.all_gather_int(0)
    ok = ShardStore(d).validate(STEPS)[0]
    state, aux = ShardStore(d).restore_elastic(_fresh(mesh), mesh=mesh)
    out["bitflip"] = (ok, aux["reconstructed"], _digest(state, mesh) == ref)
    d = _copy(src, os.path.join(dirs["work"], "past"), mesh)
    if mesh.rank == 0:
        ShardStore(d).drop_rank_dir(2)
        ShardStore(d).drop_rank_dir(3)
    mesh.all_gather_int(0)
    out["past_validate"] = ShardStore(d).validate(STEPS)
    try:
        ShardStore(d).restore_elastic(_fresh(mesh), mesh=mesh, step=STEPS)
        out["past"] = None
    except ModeRefusal as e:
        out["past"] = str(e)
    # ... and back from the 2-rank group's D=2 set: the full row state.
    _wait_for(dirs["port2_done"])
    state, aux = ShardStore(dirs["port2"]).restore_elastic(
        _fresh(mesh), mesh=mesh)
    first = states["zero3_rows"].optimizer
    opt = state.optimizer
    out["back"] = (aux["from_ranks"], _digest(state, mesh) == ref,
                   all(torch.equal(a, b) for a, b in zip(
                       opt.params_rows + opt.momentum_rows,
                       first.params_rows + first.momentum_rows)))
    return out


def _counting_reads(store: ShardStore) -> list:
    """The copies ``store`` reads and hashes from now on, by file name."""
    reads, real = [], store._good_bytes

    def good_bytes(path, digest):
        reads.append(os.path.relpath(path, store._dir))
        return real(path, digest)
    store._good_bytes = good_bytes
    return reads


def _same_width_restores(dirs: dict, mesh) -> dict:
    """The D=2 set restored at D=2 (``ShardStore.restore``): intact, with
    rank 1's directory lost, and with shard 0 past redundancy; the files
    each rank reads, and the elastic path's for comparison."""
    engine = Engine(_spec("zero3_rows"))
    out = {}
    for case in ("intact", "lost_rank1", "past"):
        d = _copy(dirs["port2"], os.path.join(dirs["work"], f"two_{case}"),
                  mesh)
        if mesh.rank == 0 and case == "lost_rank1":
            ShardStore(d).drop_rank_dir(1)
        if mesh.rank == 0 and case == "past":
            step_dir = os.path.join(d, f"shards_{STEPS:08d}")
            os.remove(os.path.join(step_dir, "rank_00000", "own.npz"))
            os.remove(os.path.join(step_dir, "rank_00001",
                                   "mirror_00000.npz"))
        mesh.all_gather_int(0)
        state, _ = engine.laid_out_state(mesh, engine.create_state(mesh))
        store = ShardStore(d)
        reads = _counting_reads(store)
        try:
            # A named step refuses; with None the newest readable set.
            store.restore(state, mesh, STEPS if case == "past" else None)
            out[case] = (store.last_restore, _digest(state, mesh), reads)
        except ModeRefusal as e:
            out[case] = str(e)
    store = ShardStore(dirs["port2"])
    reads = _counting_reads(store)
    store.restore_elastic(_fresh(mesh), mesh=mesh)
    out["elastic_reads"] = reads
    return out


def _trainer_lm(snap: str, log_dir: str, steps: int, layout: str) -> dict:
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    knob = "--shard_params" if layout == "zero3_rows" else "--shard_update"
    os.environ["SNAPSHOT_DIR"] = snap
    try:
        return trainer_lm.main([
            "--device", "cpu", "--size", "lm_tiny", "--dropout", "0.1",
            "--batch_size", "4", "--bucket_grads", str(64 << 10), knob,
            "true", "--train_steps", str(steps), "--checkpoint_every", "2",
            "--log_every", "2", "--log_dir", log_dir])
    finally:
        del os.environ["SNAPSHOT_DIR"]


def _two(dirs: dict) -> dict:
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank}
    # D=4 -> 2, then saved at D=2 for the way back.
    _wait_for(dirs["port4_done"])
    state, aux = ShardStore(dirs["port4_zero3_rows"]).restore_elastic(
        _fresh(mesh), mesh=mesh)
    out["four_to_two"] = (aux["from_ranks"], _digest(state, mesh))
    lay = ShardLayout.for_params("zero3_rows", _BB,
                                 dict(state.model.named_parameters()), 2)
    ShardStore(dirs["port2"], layout=lay).save(state, mesh)
    _mark(dirs["port2_done"], mesh)
    out["same_width"] = _same_width_restores(dirs, mesh)
    # A torn save: the manifest write fails on rank 0.
    store = ShardStore(dirs["torn"], layout=lay)
    store.save(state, mesh)
    state.step += 1
    real = store._atomic_write

    def torn(path, data):
        if path.endswith("manifest.json"):
            raise OSError(28, "No space left on device")
        real(path, data)

    store._atomic_write = torn
    try:
        store.save(state, mesh)
        out["torn"] = None
    except OSError as e:
        out["torn"] = str(e)
    out["torn_steps"] = (store.steps(), store.quorum_steps(),
                         store.latest_valid())
    # A failed rank write: rank 1's own.npz.
    store = ShardStore(dirs["failed"], layout=lay)
    if mesh.rank == 1:
        def fail(path, data):
            if path.endswith("own.npz"):
                raise OSError(5, "Input/output error")
            real(path, data)
        store._atomic_write = fail
    try:
        store.save(state, mesh)
        out["failed"] = None
    except OSError as e:
        out["failed"] = str(e)
    out["failed_steps"] = (store.steps(), store.quorum_steps())
    # A rank whose rows fail on their way to the host (before any write).
    store = ShardStore(dirs["failed_serialize"], layout=lay)
    if mesh.rank == 1:
        def no_host_memory(state, mesh):
            raise MemoryError("injected: no host memory for the rows")
        store._serialize = no_host_memory
    try:
        store.save(state, mesh)
        out["failed_serialize"] = None
    except (OSError, MemoryError) as e:
        out["failed_serialize"] = (type(e).__name__, str(e),
                                   getattr(e, "__notes__", []))
    out["failed_serialize_steps"] = (store.steps(), store.quorum_steps())
    # The engine: zero1 and zero3 resumed from a shard set against
    # straight runs, dropout on.
    for layout in LAYOUTS:
        base = os.path.join(dirs["work"], f"lm_{layout}")
        runs = {"straight": _trainer_lm(f"{base}_s", f"{base}_log_s", 4,
                                        layout),
                "first": _trainer_lm(f"{base}_r", f"{base}_log_r1", 2,
                                     layout),
                "resumed": _trainer_lm(f"{base}_r", f"{base}_log_r2", 4,
                                       layout)}
        out[f"lm_{layout}"] = {
            "start_steps": [r["start_step"] for r in runs.values()],
            "resumed_from": runs["resumed"]["shard_snapshots"][
                "resumed_from"],
            "digests": [ShardStore(f"{base}_{k}").manifest(4)["digests"]
                        for k in ("s", "r")]}
    return out


# --- the JAX side and the groups ------------------------------------------

def _jax_trained(layout: str) -> tuple:
    """The JAX package's softmax after STEPS steps of its ``layout`` step
    on a 4-device mesh, as the row state and its host copy."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributedtensorflowexample_tpu.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu.engine.engine import (
        apply_update_layout)
    from distributedtensorflowexample_tpu.models import build_model
    from distributedtensorflowexample_tpu.parallel import make_mesh as jmesh
    from distributedtensorflowexample_tpu.parallel.sync import make_train_step
    from distributedtensorflowexample_tpu.training.state import TrainState
    mesh = jmesh(4)
    tx = optax.sgd(0.1, momentum=0.9)
    state = TrainState.create(build_model("softmax"), tx,
                              jnp.zeros((8, 28, 28, 1), jnp.float32), seed=0)
    params = jax.tree.map(lambda a: np.array(a, copy=True), state.params)
    rows, z3 = apply_update_layout(state, tx, update_layout=layout,
                                   bucket_bytes=_BB, mesh=mesh)
    step = make_train_step(mesh=mesh, zero3_layout=z3,
                           bucket_bytes=None if z3 else _BB,
                           bucket_shard_update=z3 is None)
    x, y = make_synthetic(8 * STEPS, (28, 28, 1), 10, seed=3)
    with mesh:
        for i in range(STEPS):
            rows, _ = step(rows, {"image": jnp.asarray(x[8 * i:8 * i + 8]),
                                  "label": jnp.asarray(y[8 * i:8 * i + 8])})
    host = {"params": (jax.tree.map(np.asarray, z3.materialize(rows.params))
                       if z3 else jax.tree.map(np.asarray, rows.params)),
            "momentum_rows": [np.asarray(s[0].trace)
                              for s in rows.opt_state]}
    if z3:
        host["param_rows"] = [np.asarray(r) for r in rows.params]
    return rows, host, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from distributedtensorflowexample_tpu.resilience import (
        shardstore as jax_shardstore)
    root = tmp_path_factory.mktemp("shards")
    dirs = {k: str(root / k) for k in (
        "port4_zero3_rows", "port4_bucket_rows", "port2", "torn", "failed",
        "failed_serialize", "work", "jax_zero3_rows", "jax_bucket_rows", "jax_past")}
    dirs["port4_done"] = str(root / "port4.done")
    dirs["port2_done"] = str(root / "port2.done")
    os.makedirs(dirs["work"])
    jax_states, inp = {}, {}
    for layout in LAYOUTS:
        jax_states[layout], inp[layout], params0 = _jax_trained(layout)
    with ThreadPoolExecutor(2) as pool:
        four = pool.submit(launch.spawn, _four, 4, "gloo", (inp, dirs), 300)
        two = pool.submit(launch.spawn, _two, 2, "gloo", (dirs,), 300)
        jax_side = {}
        for layout in LAYOUTS:
            lay = jax_shardstore.ShardLayout.for_params(layout, _BB,
                                                        params0, 4)
            jax_shardstore.ShardStore(dirs[f"jax_{layout}"], layout=lay) \
                .save(jax_states[layout], cursor={"seed": 0})
        shutil.copytree(dirs["jax_zero3_rows"], dirs["jax_past"])
        hurt = jax_shardstore.ShardStore(dirs["jax_past"])
        hurt.drop_rank_dir(2)
        hurt.drop_rank_dir(3)
        jax_side["past_validate"] = hurt.validate(STEPS)
        try:
            from distributedtensorflowexample_tpu.parallel import (
                make_mesh as jmesh)
            import optax
            from distributedtensorflowexample_tpu.models import build_model
            from distributedtensorflowexample_tpu.training.state import (
                TrainState)
            import jax.numpy as jnp
            fresh = TrainState.create(build_model("softmax"),
                                      optax.sgd(0.1, momentum=0.9),
                                      jnp.zeros((8, 28, 28, 1), jnp.float32))
            jax_shardstore.ShardStore(dirs["jax_past"]).restore_elastic(
                fresh, optax.sgd(0.1, momentum=0.9), mesh=jmesh(4),
                step=STEPS)
        except Exception as e:          # the JAX ModeRefusal
            jax_side["past"] = str(e)
        ranks = {4: four.result(), 2: two.result()}
    return {"dirs": dirs, "inp": inp, "ranks": ranks, "jax": jax_side,
            "params0": params0}


# --- the checks -----------------------------------------------------------

@pytest.mark.parametrize("model", ["softmax", "lm_tiny"])
@pytest.mark.parametrize("D", [2, 4])
def test_layout_plan_and_widths_equal_the_jax_layout(model, D):
    import jax
    import jax.numpy as jnp

    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    from distributedtensorflowexample_tpu.resilience.shardstore import (
        ShardLayout as JaxShardLayout)
    from distributedtensorflowexample_tpu_torch.models import build_model
    bb = _BB if model == "softmax" else 16 << 10
    shape, dt = (((2, 28, 28, 1), jnp.float32) if model == "softmax"
                 else ((2, 8), jnp.int32))
    params = jax.eval_shape(jax_build_model(model).init,
                            jax.random.PRNGKey(0), jnp.zeros(shape, dt))
    want = JaxShardLayout.for_params("zero3_rows", bb, params["params"], D)
    got = ShardLayout.for_params(
        "zero3_rows", bb, dict(build_model(model).named_parameters()), D)
    assert got.plan == want.plan and len(got.plan) >= 1
    assert [got.bucket_width(b, D) for b in range(len(got.plan))] == \
        [want.bucket_width(b, D) for b in range(len(want.plan))]
    assert [s.size for s in got.param_specs] == \
        [s.size for s in want.param_specs]
    assert got.to_manifest()["plan"] == want.to_manifest()["plan"]
    assert got.param_names == jax_leaf_order(got.param_names)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_own_shards_hold_the_jax_stores_rows(runs, layout):
    """Each rank's own.npz: the JAX store's rows of the same state,
    converted, bitwise (parameter rows under zero3, momentum rows under
    both), under the JAX store's keys."""
    dirs, params = runs["dirs"], runs["inp"][layout]["params"]
    port = ShardStore(dirs[f"port4_{layout}"])
    jax_store = ShardStore(dirs[f"jax_{layout}"])     # the same file format
    assert port.quorum_steps() == jax_store.quorum_steps() == [STEPS]
    pm, jm = port.manifest(STEPS), jax_store.manifest(STEPS)
    for key in ("num_ranks", "redundancy", "plan", "bucket_bytes",
                "update_layout"):
        assert pm[key] == jm[key], key
    for field in ("params", "opt_state"):
        assert [r["size"] for r in pm["fields"][field]["rows"]] == \
            [r["size"] for r in jm["fields"][field]["rows"]], field
    _, jrows, _, _, _ = jax_store._load(STEPS, report=False)
    fields = ("params", "opt_state") if layout == "zero3_rows" \
        else ("opt_state",)
    for field in fields:
        want = convert.jax_rows_to_port(jrows[field], params, _BB, 4)
        for r in range(4):
            path = os.path.join(dirs[f"port4_{layout}"], f"shards_{STEPS:08d}",
                                f"rank_{r:05d}", "own.npz")
            with np.load(path) as z:
                for b, w in enumerate(want[r]):
                    got = z[f"{field}__{b:05d}"]
                    assert got.dtype == w.dtype
                    assert np.array_equal(got, w), (field, r, b)


def test_any_single_rank_loss_and_a_bitflip_restore_bitwise(runs):
    for r in runs["ranks"][4]:
        for lost in range(4):
            ok, step, recon, same = r[f"loss_{lost}"]
            assert ok and step == STEPS and recon == [lost] and same
        ok, recon, same = r["bitflip"]
        assert ok and recon == [1] and same


def test_loss_past_redundancy_refused_with_the_jax_words(runs):
    jax_side = runs["jax"]
    for r in runs["ranks"][4]:
        assert tuple(r["past_validate"]) == tuple(jax_side["past_validate"])
        assert not r["past_validate"][0]
        assert "no intact copy" in r["past_validate"][1]
        assert r["past"] is not None
        assert "exceeds redundancy R=2" in r["past"]
        assert r["past"] == jax_side["past"]


def test_elastic_d4_d2_d4_bitwise(runs):
    four, two = runs["ranks"][4], runs["ranks"][2]
    ref = four[0]["digest_zero3_rows"]
    for r in two:
        assert r["four_to_two"] == (4, ref)
    for r in four:
        assert r["back"] == (2, True, True)


def test_a_torn_or_failed_save_leaves_the_step_absent(runs):
    for r in runs["ranks"][2]:
        assert r["torn"] is not None and "manifest" in r["torn"]
        steps, quorum, latest = r["torn_steps"]
        assert steps == [STEPS, STEPS + 1]
        assert quorum == [STEPS] and latest == STEPS
        assert r["failed"] is not None and "[1]" in r["failed"]
        assert r["failed_steps"] == ([STEPS + 1], [])


def test_a_rank_failing_before_its_writes_leaves_no_rank_waiting(runs):
    """A rank whose rows fail on their way to the host says so in the
    agreement: it raises its own error, the other rank an OSError naming
    it, no manifest is written, and neither waits in a collective (the
    group went on to the engine runs)."""
    r0, r1 = runs["ranks"][2]
    kind, message, _ = r0["failed_serialize"]
    assert kind == "OSError" and "rank(s) [1] failed" in message
    kind, message, notes = r1["failed_serialize"]
    assert kind == "MemoryError" and "injected" in message
    assert any("rank(s) [1] failed" in n for n in notes)
    for r in (r0, r1):
        assert r["failed_serialize_steps"] == ([STEPS + 1], [])


def test_same_width_restore_reads_only_its_own_shard(runs):
    """``ShardStore.restore`` at D=2: each rank reads its own shard (or
    its ring mirror) and ``repl.npz`` once, and nothing else; every rank
    agrees on the reconstruction, and on the refusal past redundancy.
    The elastic path reads each shard and ``repl.npz`` once."""
    two = runs["ranks"][2]
    ref = two[0]["four_to_two"][1]
    own = lambda r: f"shards_{STEPS:08d}/rank_{r:05d}/own.npz"
    mirror = lambda r: (f"shards_{STEPS:08d}/rank_{(r + 1) % 2:05d}/"
                        f"mirror_{r:05d}.npz")
    repl = f"shards_{STEPS:08d}/rank_00000/repl.npz"
    for r in two:
        got = r["same_width"]
        facts, digest, reads = got["intact"]
        assert facts == {"step": STEPS, "reconstructed": []}
        assert digest == ref and reads == [own(r["rank"]), repl]
        facts, digest, reads = got["lost_rank1"]
        assert facts == {"step": STEPS, "reconstructed": [1]}
        assert digest == ref
        assert reads == ([own(0), repl] if r["rank"] == 0 else
                         [own(1), mirror(1), repl])
        assert "exceeds redundancy R=2" in got["past"]
        assert "shard 0 of step" in got["past"]
        assert got["elastic_reads"] == [own(0), own(1), repl]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_resumes_from_its_shard_set_bitwise(runs, layout):
    for r in runs["ranks"][2]:
        got = r[f"lm_{layout}"]
        assert got["start_steps"] == [0, 0, 2]
        assert got["resumed_from"] == {"step": 2, "from_ranks": 2,
                                       "reconstructed": []}
        straight, resumed = got["digests"]
        assert straight == resumed      # every rank's rows and generator


def test_valid_steps_and_discard_newer_cover_both_formats(runs, tmp_path):
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        template_state)
    d = str(tmp_path / "both")
    shutil.copytree(runs["dirs"]["port2"], d)          # a set at STEPS
    state = template_state("lm_tiny", torch.device("cpu"))
    state.step = 1
    snapshot.SnapshotStore(d).save(state)
    state.step = STEPS + 2
    snapshot.SnapshotStore(d).save(state)
    assert snapshot.valid_steps(d) == [1, STEPS, STEPS + 2]
    assert snapshot.SnapshotStore(d).discard_newer(1) == [STEPS, STEPS + 2]
    assert snapshot.valid_steps(d) == [1]
    assert ShardStore(d).steps() == []


def test_regroup_twins_move_bytes_only():
    """``_unbucket`` and ``_rebucket`` invert each other at any width,
    padding included (the numpy twins of the bucket layout)."""
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        LeafSpec)
    rng = np.random.default_rng(0)
    specs = [LeafSpec((3, 5), np.dtype(np.float32)),
             LeafSpec((7,), np.dtype(np.float32)),
             LeafSpec((2, 2, 2), np.dtype(np.float32))]
    values = [rng.standard_normal(s.shape).astype(np.float32) for s in specs]
    for d in (1, 2, 3, 4, 8):
        flat = _rebucket(values, d)
        back = _unbucket(flat, specs, d)
        assert all(np.array_equal(a, b) for a, b in zip(values, back))
        assert np.array_equal(_rebucket(_unbucket(_rebucket(values, 4),
                                                  specs, 4), d), flat)
