"""The port's params-stay-sharded serving (``serving/sharded.py``,
``promote.promote_sharded``, row-layout ``promote``, ``serve_lm
--sharded_mesh``) against the JAX package's, on lm_tiny (a 32-row cache,
4 slots over 2 gloo ranks, 16 KiB buckets).

Every engine runs the JAX ``TrainState`` init, converted into the port's
snapshots: ``tree``, and the single-controller row views ``zero3_rows``
(at D=2 and D=4) and ``bucket_rows`` (``promote.full_row_state``).  One
2-rank group, started once, promotes sharded and decodes while the JAX
side runs here.  Claims: the sharded tokens bitwise a replicated engine
of S/D slots (the same shapes), and equal to the S-slot engine wherever
the top-2 gap exceeds ``SERVE_TAU`` (0.25, the card's bound; bitwise on
the CPU); against the JAX ``ShardedDecodeEngine`` on a 2-device mesh,
equal, or parted where the JAX top-2 gap is under the bf16 bound 3e-2
(``tests/test_torch_serving.py``'s rule); residency exactly 1/D; the
refusals by name; ``SHARDED_DECODE_CONTRACT`` holding, and catching a
step that gathers twice and one that reallocates its cache; row-layout
``promote`` bitwise the JAX package's materialized tree; SIGTERM to a
sharded ``serve_lm`` exits 143 on both ranks.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
    SnapshotStore)
from distributedtensorflowexample_tpu_torch.serving.engine import DecodeEngine
from distributedtensorflowexample_tpu_torch.serving.promote import (
    full_row_state, promote, promote_sharded, template_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = "lm_tiny"
CACHE = 32
SLOTS = 4
D = 2
BB = 16 << 10
SERVE_TAU = 0.25
ATOL = 3e-2
PROMPTS = ([5, 9, 17, 3, 88, 120, 7], [200, 1, 42],
           [7, 7, 99, 14, 2, 64, 31, 8, 150], [4, 8, 15, 16, 23, 42])
NEW = 8
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _greedy(engine, slot, prompt, n=NEW):
    toks = [engine.prefill(slot, np.asarray(prompt, np.int32), max_new=n)]
    while len(toks) < n:
        toks.append(int(engine.decode()[slot]))
    engine.set_slot(slot, 0, 0)
    return toks


def _write_snapshots(params: dict, dirs: dict) -> None:
    """The converted JAX init as the port's snapshots: tree, and the row
    views of zero3_rows (D=2 and 4) and bucket_rows (D=2)."""
    def state():
        s = template_state(SIZE, torch.device("cpu"))
        convert.load_into_state(s, params)
        return s
    meta = {"model": SIZE, "update_layout": "tree"}
    SnapshotStore(dirs["tree"]).save(state(), meta=meta)
    for name, layout, width in (("z3", "zero3_rows", D),
                                ("z3_4", "zero3_rows", 4),
                                ("z1", "bucket_rows", D)):
        SnapshotStore(dirs[name]).save(
            full_row_state(state(), layout, width, BB),
            meta={"model": SIZE, "update_layout": layout,
                  "mesh_size": width, "bucket_bytes": BB})


# --- the rank worker (no JAX) ---------------------------------------------

def _broadcast_sizes(engine) -> dict:
    """The values rank 0 broadcasts for one decode step, and for one
    prefill of a prompt in the 16-row bucket."""
    sizes, real = [], engine.mesh.broadcast

    def broadcast(flat):
        sizes.append(flat.numel())
        return real(flat)
    engine.mesh.broadcast = broadcast
    try:
        engine.decode()
        out = {"decode": list(sizes)}
        del sizes[:]
        engine.prefill(1, np.arange(1, 12, dtype=np.int32), max_new=2)
        out["prefill"] = list(sizes)
    finally:
        engine.mesh.broadcast = real
        engine.set_slot(1, 0, 0)
    return out


def _rank(dirs: dict) -> dict:
    from distributedtensorflowexample_tpu_torch.serving.prefix import (
        PrefixCache)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)
    from distributedtensorflowexample_tpu_torch.serving.sampling import (
        Sampler)
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        ShardedDecodeEngine, check_sharded_decode_contract)
    from distributedtensorflowexample_tpu_torch.serving.spec import (
        SpecDecoder)
    mesh = make_mesh("cpu")
    out = {"rank": mesh.rank}
    refusals = {}
    for name, call in (
            ("mesh", lambda: promote_sharded(dirs["tree"], SIZE, mesh=mesh,
                                             mesh_size=3)),
            ("zero3_width", lambda: promote_sharded(dirs["z3_4"], SIZE,
                                                    mesh=mesh))):
        try:
            call()
        except ModeRefusal as e:
            refusals[name] = str(e)
    for source in ("tree", "z3", "z1"):
        pm = promote_sharded(dirs[source], SIZE, mesh=mesh, bucket_bytes=BB)
        engine = ShardedDecodeEngine(pm.model, pm.rows, pm.layout,
                                     mesh=mesh, slots=SLOTS, cache_len=CACHE)
        res = {"layout": pm.source_layout, "buckets": pm.layout.num_buckets,
               "rows": [r.numpy().copy() for r in pm.rows],
               "residency": engine.params_residency()}
        if mesh.rank != 0:
            res["followed"] = engine.follow()
            out[source] = res
            continue
        try:
            res["tokens"] = [_greedy(engine, s, p)
                             for s, p in enumerate(PROMPTS)]
            if source == "tree":
                res["contract"] = check_sharded_decode_contract(engine,
                                                                steps=4)
                res["broadcast_sizes"] = _broadcast_sizes(engine)

                def gathers_twice():
                    engine.decode()
                    return engine.decode()

                def reallocates():
                    out_ = engine.decode()
                    old = engine.cache
                    fresh = copy.copy(old)
                    fresh.k_store = old.k_store.clone()
                    fresh.v_store = old.v_store.clone()
                    rows = old.k.shape[1] * CACHE
                    fresh.k = fresh.k_store[:, :rows].view(old.shape)
                    fresh.v = fresh.v_store[:, :rows].view(old.shape)
                    engine.cache = fresh
                    return out_

                res["twice"] = check_sharded_decode_contract(
                    engine, steps=3, step=gathers_twice)
                res["realloc"] = check_sharded_decode_contract(
                    engine, steps=3, step=reallocates)
                for name, make in (
                        ("sampling", lambda: ContinuousBatcher(
                            engine, RequestQueue(engine.vocab),
                            sampler=Sampler(temperature=0.8, top_k=20))),
                        ("speculation", lambda: SpecDecoder(engine, engine)),
                        ("prefix", lambda: PrefixCache(engine))):
                    try:
                        make()
                    except ModeRefusal as e:
                        refusals[name] = str(e)
                for name, kw in (("slots", {"slots": 3, "cache_len": CACHE}),
                                 ("max_len", {"slots": SLOTS, "cache_len":
                                              pm.model.max_len + 1})):
                    try:
                        ShardedDecodeEngine(pm.model, pm.rows, pm.layout,
                                            mesh=mesh, **kw)
                    except ModeRefusal as e:
                        refusals[name] = str(e)
        finally:
            engine.stop_followers()
        out[source] = res
    out["refusals"] = refusals
    return out


# --- the JAX side and the group -------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from distributedtensorflowexample_tpu.models import (
        build_model as jax_build_model)
    from distributedtensorflowexample_tpu.parallel import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.parallel.zero3 import (
        Zero3Layout as JaxZero3Layout)
    from distributedtensorflowexample_tpu.serving.sharded import (
        ShardedDecodeEngine as JaxShardedDecodeEngine)
    root = tmp_path_factory.mktemp("sharded")
    dirs = {k: str(root / k) for k in ("tree", "z3", "z3_4", "z1")}
    jmodel = jax_build_model(SIZE)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    _write_snapshots(params, dirs)
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(launch.spawn, _rank, D, "gloo", (dirs,), 300)
        mesh = jax_make_mesh(D)
        repl = jax.device_put(params, replicated_sharding(mesh))
        layout = JaxZero3Layout(repl, BB, mesh)
        jeng = JaxShardedDecodeEngine(jmodel, layout.init_rows(repl), layout,
                                      slots=SLOTS, cache_len=CACHE)
        jax_tokens = [_greedy(jeng, s, p) for s, p in enumerate(PROMPTS)]
        jax_res = jeng.params_residency()
        ranks = group.result()
    return {"dirs": dirs, "params": params, "jmodel": jmodel,
            "jax_tokens": jax_tokens, "jax_residency": jax_res,
            "jax_buckets": layout.num_buckets, "ranks": ranks}


@pytest.fixture(scope="module")
def replicated(runs):
    """The replicated engines of S/D and S slots on the tree snapshot."""
    pm = promote(runs["dirs"]["tree"], SIZE)
    return {n: DecodeEngine(pm.model, slots=n, cache_len=CACHE)
            for n in (SLOTS // D, SLOTS)}


# --- the checks -----------------------------------------------------------

def test_sharded_decode_bitwise_the_s_over_d_slot_engine(runs, replicated):
    local, full = replicated[SLOTS // D], replicated[SLOTS]
    got = runs["ranks"][0]["tree"]["tokens"]
    want = [_greedy(local, s % (SLOTS // D), p) for s, p in enumerate(PROMPTS)]
    assert got == want
    for toks, prompt in zip(got, PROMPTS):
        ref = full.prefill_many([(0, np.asarray(prompt, np.int32), NEW)])
        seq, (tok, logits) = [], ref[0]
        while True:
            top = np.sort(logits)[-2:]
            if tok != toks[len(seq)]:
                assert top[1] - top[0] <= SERVE_TAU
                break
            seq.append(tok)
            if len(seq) == NEW:
                break
            full.set_slot(0, tok, int(full.positions[0]))
            logits = full.decode_logits(busy=[0])[0]
            tok = int(logits.argmax())
        full.set_slot(0, 0, 0)


def test_sharded_tokens_track_the_jax_sharded_engine(runs):
    jmodel, params = runs["jmodel"], runs["params"]
    got = runs["ranks"][0]["tree"]["tokens"]
    for prompt, mine, theirs in zip(PROMPTS, got, runs["jax_tokens"]):
        if mine == theirs:
            continue
        i = next(i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b)
        seq = jnp.asarray([list(prompt) + theirs[:i]], jnp.int32)
        fn = lambda p, t: jmodel.apply({"params": p}, t)
        p = jax.tree.map(jnp.asarray, params)
        logits = jax.jit(fn).lower(p, seq).compile(NO_EXCESS)(p, seq)
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < ATOL, (prompt, i, mine, theirs)


def test_residency_is_one_over_d_and_the_plan_is_the_jax_plan(runs):
    jres = runs["jax_residency"]
    for r in runs["ranks"]:
        for source in ("tree", "z3", "z1"):
            res = r[source]["residency"]
            assert res["frac_per_device"] == 1 / D == jres["frac_per_device"]
            assert res["params_bytes_per_device"] * D == \
                res["params_bytes_total"] == jres["params_bytes_total"]
            assert res["num_buckets"] == runs["jax_buckets"] == \
                r[source]["buckets"]
    followers = [r for r in runs["ranks"] if r["rank"] != 0]
    assert all(r["tree"]["followed"] > 0 for r in followers)


def test_promote_sharded_from_tree_zero3_and_bucket_rows_decode_alike(
        runs):
    r0, r1 = runs["ranks"]
    assert [r0[s]["layout"] for s in ("tree", "z3", "z1")] == \
        ["tree", "zero3_rows", "bucket_rows"]
    for r in (r0, r1):
        for source in ("z3", "z1"):
            assert all(np.array_equal(a, b) for a, b in
                       zip(r[source]["rows"], r["tree"]["rows"]))
    assert r0["z3"]["tokens"] == r0["z1"]["tokens"] == r0["tree"]["tokens"]


def test_promote_of_row_layouts_equals_the_jax_materialized_tree(runs,
                                                                 tmp_path):
    """Row-layout ``promote`` bitwise the JAX package's, each side from
    its own snapshot of the same rows."""
    from distributedtensorflowexample_tpu.parallel import (
        make_mesh as jax_make_mesh, replicated_sharding)
    from distributedtensorflowexample_tpu.parallel.bucketing import (
        init_bucketed_opt_state)
    from distributedtensorflowexample_tpu.parallel.zero3 import (
        Zero3Layout as JaxZero3Layout)
    from distributedtensorflowexample_tpu.resilience.snapshot import (
        SnapshotStore as JaxSnapshotStore)
    from distributedtensorflowexample_tpu.serving.promote import (
        _default_tx)
    from distributedtensorflowexample_tpu.training.state import (
        TrainState as JaxTrainState)
    import importlib
    jax_promote = importlib.import_module(
        "distributedtensorflowexample_tpu.serving.promote")
    params = runs["params"]
    state = JaxTrainState.create(runs["jmodel"], _default_tx(),
                                 jnp.zeros((1, 8), jnp.int32))
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    mesh = jax_make_mesh(D)
    repl = jax.device_put(jax.tree.map(np.asarray, params),
                          replicated_sharding(mesh))
    layout = JaxZero3Layout(repl, BB, mesh)
    opt = init_bucketed_opt_state(_default_tx(), repl, BB, mesh)
    jdirs = {"zero3_rows": str(tmp_path / "jz3"),
             "bucket_rows": str(tmp_path / "jz1")}
    JaxSnapshotStore(jdirs["zero3_rows"]).save(
        state.replace(opt_state=opt, params=layout.init_rows(repl)),
        meta={"model": SIZE, "update_layout": "zero3_rows",
              "mesh_size": D, "bucket_bytes": BB})
    JaxSnapshotStore(jdirs["bucket_rows"]).save(
        state.replace(opt_state=init_bucketed_opt_state(
            _default_tx(), state.params, BB, mesh)),
        meta={"model": SIZE, "update_layout": "bucket_rows",
              "mesh_size": D, "bucket_bytes": BB})
    for layout_name, mine in (("zero3_rows", "z3"), ("bucket_rows", "z1")):
        jpm = jax_promote.promote(jdirs[layout_name], SIZE)
        want = convert.flax_to_port(jax.tree.map(np.asarray, jpm.params))
        pm = promote(runs["dirs"][mine], SIZE)
        assert pm.layout == jpm.layout == layout_name
        got = dict(pm.model.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            assert np.array_equal(got[name].numpy(), w), name


def test_refusals_by_name(runs):
    refused = runs["ranks"][0]["refusals"]
    assert "--sharded_mesh 3" in refused["mesh"]
    assert "mesh_size 4" in refused["zero3_width"]
    for name in ("sampling", "speculation", "prefix"):
        assert "--sharded_mesh" in refused[name], name
    assert "--slots 3" in refused["slots"]
    assert "--max_len" in refused["max_len"]
    assert set(runs["ranks"][1]["refusals"]) == {"mesh", "zero3_width"}


def test_contract_holds_and_catches_violations(runs):
    tree = runs["ranks"][0]["tree"]
    assert tree["contract"] == []
    twice = tree["twice"]
    assert any("all-gather" in f and "budget" in f for f in twice)
    assert any("control-broadcast" in f for f in twice)
    assert len(tree["realloc"]) == 1
    assert "storage moved" in tree["realloc"][0]


def test_a_decode_command_is_the_header_alone(runs):
    """A decode step broadcasts the ``2 + 3*S`` header and nothing else;
    a prefill sends its ``[S, bucket]`` prompts after it."""
    sizes = runs["ranks"][0]["tree"]["broadcast_sizes"]
    assert sizes == {"decode": [2 + 3 * SLOTS],
                     "prefill": [2 + 3 * SLOTS, SLOTS * 16]}


def test_serve_lm_sharded_drive_reports_each_ranks_launches(runs, tmp_path):
    """``serve_lm --sharded_mesh 2`` answers a drive, and its stats carry
    each rank's kernel launches, counted in the serving ranks themselves
    (none: serving runs no kernel)."""
    stats = tmp_path / "stats.json"
    p = subprocess.run(
        [sys.executable, "-m",
         "distributedtensorflowexample_tpu_torch.serving.serve_lm",
         "--device", "cpu", "--sharded_mesh", str(D), "--snapshot",
         runs["dirs"]["tree"], "--slots", str(SLOTS), "--max_len",
         str(CACHE), "--drive", "4", "--clients", "2", "--drive_max_new",
         "4", "--stats", str(stats)], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(stats.read_text())
    assert got["completed"] == 4 and got["sharded_mesh"] == D
    assert got["launches_by_rank"] == [
        {"dequant": 0, "ce_fwd": 0, "ce_bwd": 0, "sgd": 0}] * D


def test_serve_lm_sharded_sigterm_exits_143_on_both_ranks(runs, tmp_path):
    ready, stats = tmp_path / "ready", tmp_path / "stats.json"
    cmd = [sys.executable, "-m",
           "distributedtensorflowexample_tpu_torch.serving.serve_lm",
           "--device", "cpu", "--sharded_mesh", str(D), "--snapshot",
           runs["dirs"]["tree"], "--slots", str(SLOTS), "--max_len",
           str(CACHE), "--drive", "100000", "--clients", "4",
           "--drive_max_new", "4", "--ready_file", str(ready),
           "--stats", str(stats)]
    p = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.monotonic() + 120
        while not ready.exists() and p.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)
        p.send_signal(signal.SIGTERM)
        text, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 143, text[-3000:]
    for r in range(D):
        assert f"serve_lm: rank {r}: TERM — exit 143" in text
    got = json.loads(stats.read_text())
    assert got["preempted"] and got["admitted"] == got["completed"]
    assert got["sharded_mesh"] == D
    assert got["params_residency"]["frac_per_device"] == 1 / D


def test_promotion_keeps_its_own_generators(tmp_path, monkeypatch):
    """A snapshot written on the card holds a CUDA generator state, which
    a host template cannot take: promotion, which has no use for dropout
    generators, leaves them out of the restore."""
    from distributedtensorflowexample_tpu_torch.resilience import snapshot
    d = str(tmp_path / "foreign")
    real = snapshot.saveable_state_dict

    def on_the_card(state, *a, **k):
        content = real(state, *a, **k)
        content["generators"] = {0: torch.zeros(16, dtype=torch.uint8)}
        return content

    monkeypatch.setattr(snapshot, "saveable_state_dict", on_the_card)
    SnapshotStore(d).save(template_state(SIZE, torch.device("cpu")),
                          meta={"model": SIZE, "update_layout": "tree"})
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="RNG state"):
        SnapshotStore(d).restore(template_state(SIZE, torch.device("cpu")))
    assert promote(d, SIZE).step == 0
