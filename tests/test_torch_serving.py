"""The serving slice of the port (engine, batcher, promotion, sampling,
prefix cache, speculative decoding, load generator, HTTP front, serve_lm)
against the JAX package's ``serving/``, on lm_tiny at a 32-row cache and
3 slots.

Both engines run the same weights: the JAX ``TrainState`` init converted
into the port (``convert.flax_to_port``).  The JAX serving programs that
are compared number for number are compiled without XLA's excess
precision, as ``tests/test_torch_lm.py`` compiles the forward; the JAX
``DecodeEngine`` runs its own programs as its users do.

Tolerances: logits and K/V within 3e-2 absolute (the bf16 bound of
``tests/test_torch_lm.py``); greedy tokens equal, and where the two
engines part, the JAX top-2 logit gap at the first difference under that
bound; everything host-side (buckets, refusal texts, sampler draws,
percentiles, prompts, env defaults, canary verdicts) equal.  The
counterparts of the JAX package's ``tests/test_serving.py`` hold the same
bitwise claims on the CPU.
"""

import ast
import copy
import importlib
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.models import (
    build_model as jax_build_model)
from distributedtensorflowexample_tpu.serving import engine as jax_engine_mod
from distributedtensorflowexample_tpu.serving import loadgen as jax_loadgen
from distributedtensorflowexample_tpu.serving import queue as jax_queue
from distributedtensorflowexample_tpu.serving import sampling as jax_sampling
from distributedtensorflowexample_tpu.refusal import (
    ModeRefusal as JaxModeRefusal)
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
    SnapshotHook, SnapshotStore, newest_common_step, valid_steps)
from distributedtensorflowexample_tpu_torch.serving import (
    engine as engine_mod, loadgen, queue as queue_mod, serve_lm)
from distributedtensorflowexample_tpu_torch.serving.engine import (
    DecodeEngine, KVCache, ServingLM, check_decode_contract)
from distributedtensorflowexample_tpu_torch.serving.frontend import (
    RequestFront)
from distributedtensorflowexample_tpu_torch.serving.prefix import PrefixCache
from distributedtensorflowexample_tpu_torch.serving.promote import (
    init_lm_snapshot, promote, template_state)
from distributedtensorflowexample_tpu_torch.serving.queue import (
    ContinuousBatcher, RequestQueue)
from distributedtensorflowexample_tpu_torch.serving.sampling import Sampler
from distributedtensorflowexample_tpu_torch.serving.spec import SpecDecoder
from distributedtensorflowexample_tpu_torch.training.state import (
    saveable_state_dict)

# The packages' ``serving.promote`` attribute is the function, not the module.
jax_promote = importlib.import_module(
    "distributedtensorflowexample_tpu.serving.promote")
promote_mod = importlib.import_module(
    "distributedtensorflowexample_tpu_torch.serving.promote")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = "lm_tiny"
CACHE = 32
SLOTS = 3
ATOL = 3e-2          # bf16 logits and K/V (tests/test_torch_lm.py)
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """(flax lm_tiny, its init params as numpy, the JAX DecodeEngine)."""
    model = jax_build_model(SIZE)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    engine = jax_engine_mod.DecodeEngine(
        model, jax.tree.map(jnp.asarray, params), slots=SLOTS,
        cache_len=CACHE)
    return model, params, engine


def _port_model(params, scale: float = 1.0):
    model = build_model(SIZE)
    model.load_state_dict({k: torch.from_numpy(v * np.float32(scale))
                           for k, v in convert.flax_to_port(params).items()})
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def model(jax_side):
    return _port_model(jax_side[1])


@pytest.fixture(scope="module")
def engine(model):
    return DecodeEngine(model, slots=SLOTS, cache_len=CACHE)


@pytest.fixture(scope="module")
def draft_engine(jax_side):
    """A draft that genuinely DISAGREES with the target (the same
    architecture, parameters halved): acceptance must survive rejection,
    not only the self-draft fast path."""
    return DecodeEngine(_port_model(jax_side[1], 0.5), slots=SLOTS,
                        cache_len=CACHE)


def _no_excess(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)(*args)


def _greedy_reference(model, prompt, n, got):
    """Teacher-forced greedy through the port's TRAINING forward: one
    forward over [prompt + got]; the argmax at each position must select
    the next candidate, which by induction proves ``got`` is the greedy
    chain."""
    seq = [int(t) for t in prompt] + [int(t) for t in got]
    with torch.inference_mode():
        logits = model(torch.tensor([seq]))[0]
    P = len(prompt)
    return [int(logits[P - 1 + i].argmax()) for i in range(n)]


def _engine_greedy(engine, slot, prompt, n):
    toks = [engine.prefill(slot, np.asarray(prompt, np.int32), max_new=n)]
    while len(toks) < n:
        toks.append(int(engine.decode()[slot]))
    return toks


def _run(engine, prompt, max_new, rid, **kw):
    queue = RequestQueue(engine.vocab)
    b = ContinuousBatcher(engine, queue, slo_ms=0.0, **kw)
    r = queue.submit(prompt, max_new, rid=rid)
    while not r.done.is_set():
        b.step()
    return r.tokens


# ---- against the JAX package ---------------------------------------------

def test_prefill_and_verify_match_jax(jax_side, model):
    """ServingLM.prefill logits and K/V, then verify at K=1 and K=4 on
    the same cache (the window's rows written into it), within 3e-2."""
    jmodel, params, _ = jax_side
    smodel = jax_engine_mod.serving_lm_for(jmodel)
    jparams = jax.tree.map(jnp.asarray, params)
    rs = np.random.RandomState(3)
    toks = rs.randint(0, 250, (SLOTS, 8)).astype(np.int32)

    def jprefill(p, t):
        return smodel.apply({"params": p}, t,
                            method=jax_engine_mod.ServingLM.prefill)

    jl, jk, jv = _no_excess(jprefill, jparams, jnp.asarray(toks))
    port = ServingLM(model)
    with torch.inference_mode():
        pl, pk, pv = port.prefill(torch.from_numpy(toks).long())
    for a, b in ((pl, jl), (pk.float(), jk), (pv.float(), jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=ATOL, rtol=0)

    L, _, _, H, Dh = jk.shape
    cache = KVCache(L, SLOTS, CACHE, H, Dh, torch.bfloat16,
                    torch.device("cpu"))
    with torch.inference_mode():
        cache.k[:, :, :8] = pk
        cache.v[:, :, :8] = pv
    ck = jnp.zeros((L, SLOTS, CACHE, H, Dh), jnp.bfloat16).at[:, :, :8] \
        .set(jk)
    cv = jnp.zeros((L, SLOTS, CACHE, H, Dh), jnp.bfloat16).at[:, :, :8] \
        .set(jv)

    def jverify(p, t, pos, ck, cv):
        return smodel.apply({"params": p}, t, pos, ck, cv,
                            method=jax_engine_mod.ServingLM.verify)

    pos = np.array([8, 5, CACHE], np.int32)   # slot 2 parked at the end
    for K in (1, 4):
        window = rs.randint(0, 250, (SLOTS, K)).astype(np.int32)
        jl, ck, cv = _no_excess(jverify, jparams, jnp.asarray(window),
                                jnp.asarray(pos), ck, cv)
        with torch.inference_mode():
            pl = port.verify(torch.from_numpy(window).long(),
                             torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(pl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=ATOL, rtol=0)
        for mine, theirs in ((cache.k, ck), (cache.v, cv)):
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(theirs, np.float32),
                                       atol=ATOL, rtol=0)


def test_greedy_tokens_match_jax_engine(jax_side, engine):
    jmodel, params, jeng = jax_side
    for slot, prompt in enumerate(([5, 9, 17, 3, 88, 120, 7], [200, 1, 42],
                                   [7, 7, 99, 14, 2, 64, 31, 8, 150])):
        want = _engine_greedy(jeng, slot, prompt, 8)
        got = _engine_greedy(engine, slot, prompt, 8)
        if got == want:
            continue
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = jnp.asarray([list(prompt) + want[:i]], jnp.int32)
        logits = _no_excess(lambda p, t: jmodel.apply({"params": p}, t),
                            jax.tree.map(jnp.asarray, params), seq)
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < ATOL, (slot, i, got, want)


def test_bucket_table_and_refusal_texts_equal_jax(jax_side, engine, model):
    jeng = jax_side[2]
    assert engine.buckets == jeng.buckets == (8, 16, 32)
    for n in range(1, CACHE - 4):
        assert engine.bucket_for(n, 4) == jeng.bucket_for(n, 4)
    with pytest.raises(ModeRefusal) as mine:
        engine.bucket_for(CACHE - 2, 4)
    with pytest.raises(JaxModeRefusal) as theirs:
        jeng.bucket_for(CACHE - 2, 4)
    assert str(mine.value) == str(theirs.value)
    assert "--max_len" in str(mine.value)
    with pytest.raises(ModeRefusal) as mine:
        DecodeEngine(model, slots=1, cache_len=model.max_len + 1)
    with pytest.raises(JaxModeRefusal) as theirs:
        jax_engine_mod.DecodeEngine(jeng.model, jeng.params, slots=1,
                                    cache_len=jeng.model.max_len + 1)
    assert str(mine.value) == str(theirs.value)


def test_sampler_draws_equal_jax():
    logits = np.random.RandomState(0).normal(size=250).astype(np.float32)
    for kw in (dict(temperature=0.8, top_k=20, seed=3),
               dict(temperature=1.3, top_k=0, seed=9)):
        mine, theirs = Sampler(**kw), jax_sampling.Sampler(**kw)
        assert mine.describe() == theirs.describe()
        for rid in ("r1", "d17"):
            assert [mine.sample(rid, i, logits) for i in range(12)] == \
                [theirs.sample(rid, i, logits) for i in range(12)]


def test_host_helpers_and_env_defaults_equal_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(1)
    tape = sorted(rs.exponential(size=37).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert queue_mod.percentile(tape, q) == jax_queue.percentile(tape, q)
    done = [queue_mod.Request(rid=str(i), prompt=np.zeros(1), max_new=1,
                              submit_t=0.0, done_t=float(t))
            for i, t in enumerate(rs.exponential(size=50))]
    assert queue_mod.recent_p99_ms(done) == jax_queue.recent_p99_ms(done)
    assert queue_mod.recent_p99_ms([]) is jax_queue.recent_p99_ms([])
    for i in range(20):
        assert np.array_equal(loadgen.make_prompt(i, 250, seed=3),
                              jax_loadgen.make_prompt(i, 250, seed=3))
    path = str(tmp_path / "tape.jsonl")
    loadgen.DriveFile(path).append(3, [1, 2])
    jax_loadgen.DriveFile(path).append(0, [9])
    with open(path, "a") as f:
        f.write('{"id": 7, "tok')               # torn tail
    assert loadgen.DriveFile(path).done_ids() == \
        jax_loadgen.DriveFile(path).done_ids() == {3: [1, 2], 0: [9]}
    pairs = [(engine_mod.serve_slots_default,
              jax_engine_mod.serve_slots_default, "SERVE_SLOTS"),
             (queue_mod.serve_slo_ms_default, jax_queue.serve_slo_ms_default,
              "SERVE_SLO_MS"),
             (loadgen.load_clients_default, jax_loadgen.load_clients_default,
              "SERVE_LOAD_CLIENTS"),
             (loadgen.load_requests_default,
              jax_loadgen.load_requests_default, "SERVE_LOAD_REQUESTS"),
             (promote_mod.serve_snapshot_default,
              jax_promote.serve_snapshot_default, "SERVE_SNAPSHOT"),
             (promote_mod.canary_window_default,
              jax_promote.canary_window_default, "HEAL_CANARY_WINDOW")]
    for mine, theirs, name in pairs:
        for value in (None, "7", "125.5", "bogus"):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
            assert mine() == theirs(), (name, value)


def test_canary_verdicts_equal_jax():
    rs = np.random.RandomState(2)
    tape = [(("canary" if rs.rand() < 0.3 else "baseline"),
             float(rs.exponential(0.05)) * (3.0 if i > 40 else 1.0))
            for i in range(80)]
    for window, ratio in ((8, 2.0), (16, 10.0)):
        mine = promote_mod.Canary(0, 7, fraction=0.25, window=window,
                                  p99_ratio=ratio)
        theirs = jax_promote.Canary(0, 7, fraction=0.25, window=window,
                                    p99_ratio=ratio)
        mine.state = theirs.state = "serving"
        assert [mine.route(f"r{i}") for i in range(40)] == \
            [theirs.route(f"r{i}") for i in range(40)]
        verdicts = []
        for arm, lat in tape:
            mine.observe(arm, lat)
            theirs.observe(arm, lat)
            verdicts.append((mine.verdict(), theirs.verdict()))
        assert all(a == b for a, b in verdicts)
        assert mine.payload() == theirs.payload()


# ---- counterparts of the JAX package's tests/test_serving.py -------------

def test_decode_matches_training_forward_token_exact(model, engine):
    for slot, prompt, n in ((0, [5, 9, 17, 3, 88, 120, 7], 6),
                            (2, [200, 1, 42], 5)):
        got = _engine_greedy(engine, slot, prompt, n)
        assert got == _greedy_reference(model, prompt, n, got)


def test_request_admitted_mid_decode_completes_bitwise(model, engine):
    prompt_a, prompt_b = [10, 20, 30, 40, 50], [7, 7, 99]
    solo_b = _engine_greedy(engine, 1, prompt_b, 5)
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    ra = queue.submit(prompt_a, 12, rid="A")
    batcher.step()
    batcher.step()
    assert not ra.done.is_set()
    rb = queue.submit(prompt_b, 5, rid="B")
    batcher.step()
    assert rb.admit_t is not None and not ra.done.is_set()
    while not (ra.done.is_set() and rb.done.is_set()):
        assert batcher.step() > 0
    assert ra.outcome == rb.outcome == "ok"
    assert rb.tokens == solo_b
    assert ra.tokens[:6] == _greedy_reference(model, prompt_a, 6,
                                              ra.tokens[:6])
    assert len(ra.tokens) == 12 and ra.first_token_t <= rb.admit_t


def test_batched_prefill_matches_solo(engine):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7]]
    solo = [_engine_greedy(engine, 0, p, 4) for p in prompts]
    out = engine.prefill_many([(s, np.asarray(p, np.int32), 4)
                               for s, p in enumerate(prompts)])
    toks = [[int(out[s][0])] for s in range(3)]
    for _ in range(3):
        step = engine.decode(busy=[0, 1, 2])
        for s in range(3):
            toks[s].append(int(step[s]))
    assert toks == solo


def test_slo_admission_rejects_predicted_misses(engine):
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=50.0)
    batcher._step_ewma_s = 0.050
    req = queue.submit([1, 2, 3], 8)
    batcher.step()
    assert req.done.is_set() and req.outcome == "slo_rejected"
    batcher2 = ContinuousBatcher(engine, queue, slo_ms=0.0)
    batcher2._step_ewma_s = 0.050
    req2 = queue.submit([1, 2, 3], 2)
    batcher2.step()
    assert req2.admit_t is not None
    while not req2.done.is_set():
        batcher2.step()
    assert req2.outcome == "ok"


def test_drain_answers_inflight_and_rejects_queued(engine):
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    inflight = [queue.submit([3, 1, 4], 6, rid=f"f{i}") for i in range(3)]
    batcher.step()
    queued = queue.submit([9, 9], 4, rid="tail")
    batcher.drain()
    assert all(r.outcome == "ok" and len(r.tokens) == 6 for r in inflight)
    assert queued.outcome == "drained" and queued.tokens == []
    stats = batcher.stats()
    assert stats["rejected"]["drained"] == 1
    assert stats["admitted"] == stats["completed"] == 3
    late = queue.submit([1, 2], 3, rid="late")
    assert late.done.is_set() and late.outcome == "drained"
    assert engine.positions.tolist() == [0] * engine.slots


def test_oversized_and_oov_requests_refused_by_name(engine):
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    bad = queue.submit(list(range(CACHE - 2)), 8)
    ok = queue.submit([1, 2, 3], 3)
    batcher.step()
    assert bad.outcome == "refused" and "--max_len" in bad.error
    while not ok.done.is_set():
        batcher.step()
    assert ok.outcome == "ok" and len(ok.tokens) == 3
    assert batcher.stats()["rejected"]["refused"] == 1
    with pytest.raises(ModeRefusal, match="out-of-vocab"):
        queue.submit([5, engine.vocab + 7], 4)
    with pytest.raises(ValueError, match="non-empty"):
        queue.submit([], 4)
    with pytest.raises(ValueError, match="integers"):
        queue.submit([1.5, 2.5], 4)
    assert len(queue) == 0


def test_promotion_falls_back_past_torn_newest_and_refuses_other_models(
        tmp_path):
    d = str(tmp_path / "snaps")
    init_lm_snapshot(d, SIZE, seed=0)
    state = template_state(SIZE, torch.device("cpu"), seed=1)
    state.step = 7
    store = SnapshotStore(d)
    store.save(state, meta={"model": SIZE, "update_layout": "tree"})
    pm = promote(d, SIZE)
    assert pm.step == 7 and torch.equal(
        pm.model.block0.qkv.weight, state.model.block0.qkv.weight)
    store.tear_latest()
    assert promote(d, SIZE).step == 0
    with pytest.raises(ModeRefusal, match="--size"):
        promote(d, "lm_small")
    for s in store.steps():
        os.remove(store._payload_path(s))
    with pytest.raises(ValueError, match="no valid snapshot"):
        promote(d, SIZE)


def test_spec_decode_is_bitwise_greedy_incl_mid_decode_admission(
        engine, draft_engine):
    prompt_a, prompt_b = [10, 20, 30, 40, 50], [7, 7, 99]
    solo_a = _engine_greedy(engine, 0, prompt_a, 9)
    solo_b = _engine_greedy(engine, 1, prompt_b, 5)
    queue = RequestQueue(engine.vocab)
    spec = SpecDecoder(engine, draft_engine, k=3)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0, spec=spec)
    ra = queue.submit(prompt_a, 9, rid="A")
    batcher.step()
    assert not ra.done.is_set()
    rb = queue.submit(prompt_b, 5, rid="B")
    while not (ra.done.is_set() and rb.done.is_set()):
        batcher.step()
    assert ra.tokens == solo_a and rb.tokens == solo_b
    st = spec.stats()
    assert st["emitted"] == (9 - 1) + (5 - 1)
    assert 1.0 <= st["accept_len_mean"] <= 4.0


def test_spec_round_truncates_at_eos_and_drain_completes(engine,
                                                         draft_engine):
    prompt = [5, 9, 17, 3]
    ref = _engine_greedy(engine, 0, prompt, 8)
    eos = ref[4]
    expected = ref[:ref.index(eos) + 1]
    assert _run(engine, prompt, 8, "E", eos_id=eos) == expected
    assert _run(engine, prompt, 8, "E", eos_id=eos, spec=SpecDecoder(
        engine, draft_engine, k=3)) == expected
    prompts = {0: [3, 1, 4], 1: [2, 7, 1, 8], 2: [6, 6, 6]}
    solo = {s: _engine_greedy(engine, s, p, 7) for s, p in prompts.items()}
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0,
                                spec=SpecDecoder(engine, draft_engine, k=3))
    reqs = [queue.submit(p, 7, rid=f"d{s}") for s, p in sorted(
        prompts.items())]
    batcher.step()
    assert not all(r.done.is_set() for r in reqs)
    batcher.drain()
    for s, r in enumerate(reqs):
        assert r.outcome == "ok" and r.tokens == solo[s]
    assert engine.positions.tolist() == [0] * engine.slots
    assert draft_engine.positions.tolist() == [0] * engine.slots


def test_spec_self_draft_full_acceptance_under_slot_churn(model, engine):
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(1, engine.vocab, size=int(
        rng.integers(4, 13))).astype(np.int32), 8) for _ in range(16)]

    def run(spec):
        queue = RequestQueue(engine.vocab)
        b = ContinuousBatcher(engine, queue, slo_ms=0.0, spec=spec)
        reqs = [queue.submit(p, m, rid=f"c{i}")
                for i, (p, m) in enumerate(prompts)]
        while any(not r.done.is_set() for r in reqs):
            b.step()
        return {r.rid: list(r.tokens) for r in reqs}

    greedy = run(None)
    draft = DecodeEngine(model, slots=engine.slots, cache_len=CACHE)
    for k in (2, 4):
        spec = SpecDecoder(engine, draft, k=k)
        assert run(spec) == greedy, f"spec k={k} diverged from greedy"
        st = spec.stats()
        assert st["emitted"] == 16 * 7
        assert st["accepted_draft"] == 16 * {2: 2 + 2 + 1, 4: 4 + 2}[k]


def test_spec_and_seam_refusals_by_name(engine, draft_engine, model):
    with pytest.raises(ValueError, match="k 0"):
        SpecDecoder(engine, draft_engine, k=0)
    with pytest.raises(ValueError, match="lockstep"):
        SpecDecoder(engine, DecodeEngine(model, slots=2, cache_len=CACHE),
                    k=2)
    with pytest.raises(ModeRefusal, match="--spec_draft"):
        ContinuousBatcher(engine, RequestQueue(engine.vocab),
                          spec=SpecDecoder(engine, draft_engine, k=2),
                          sampler=Sampler(seed=0))
    with pytest.raises(ModeRefusal, match="--prefix_cache"):
        PrefixCache(object(), capacity=4)
    with pytest.raises(ModeRefusal, match="--sample_temp"):
        Sampler(temperature=0.0)


def test_sampled_serving_is_deterministic_per_request_id(engine):
    def run():
        return _run(engine, [8, 6, 7], 6, "fixed", sampler=Sampler(
            temperature=0.7, top_k=10, seed=5))

    a, b = run(), run()
    assert a == b and len(a) == 6


def test_prefix_cache_full_and_partial_hits_bitwise(engine):
    head = [11, 22, 33, 44, 55]
    ext = head + [66, 77]
    solo_head = _engine_greedy(engine, 0, head, 5)
    solo_ext = _engine_greedy(engine, 0, ext, 5)
    pc = PrefixCache(engine, capacity=8)
    assert _run(engine, head, 5, "cold", prefix_cache=pc) == solo_head
    assert pc.stats()["misses"] == 1
    assert _run(engine, head, 5, "warm", prefix_cache=pc) == solo_head
    assert pc.stats()["hits"] == 1
    assert _run(engine, ext, 5, "ext", prefix_cache=pc) == solo_ext
    st = pc.stats()
    assert st["partial_hits"] == 1 and st["rows_reused"] == 2 * len(head)
    assert st["entries"] == 2


def test_decode_contract_holds_and_catches_violations(engine):
    assert check_decode_contract(engine, steps=6) == []

    def reallocating_decode():
        # What an eager port of the JAX step's jnp.stack(new_k) would do.
        out = engine.decode()
        old = engine.cache
        fresh = copy.copy(old)
        fresh.k_store, fresh.v_store = old.k_store.clone(), \
            old.v_store.clone()
        fresh.k = fresh.k_store[:, :old.k.shape[1] * CACHE].view(old.shape)
        fresh.v = fresh.v_store[:, :old.k.shape[1] * CACHE].view(old.shape)
        engine.cache = fresh
        return out

    def widening_decode():
        torch.zeros(2, dtype=torch.float64).sum()
        return engine.decode()

    found = check_decode_contract(engine, steps=3, step=reallocating_decode)
    assert len(found) == 1 and "storage moved" in found[0]
    found = check_decode_contract(engine, steps=3, step=widening_decode)
    assert len(found) == 1 and "wider than torch.float32" in found[0]


# ---- new for the port ----------------------------------------------------

def test_snapshot_store_roundtrip_torn_payload_and_keep_n(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=2)
    state = template_state(SIZE, torch.device("cpu"), seed=4)
    state.optimizer.momentum_flat.normal_()
    for step in (1, 2, 3):
        state.step = step
        assert store.save(state, meta={"model": SIZE})
    assert not store.save(state)                # the step is committed
    assert store.steps() == [2, 3]
    other = template_state(SIZE, torch.device("cpu"), seed=5)
    store.restore(other)
    a, b = saveable_state_dict(state), saveable_state_dict(other)
    assert b["step"] == 3 and b["count"] == a["count"]
    for key in ("params", "momentum"):
        assert torch.equal(a[key], b[key])
    assert torch.equal(a["generators"][0], b["generators"][0])
    assert store.tear_latest() == 3
    assert not store.validate(3)[0] and "torn" in store.validate(3)[1]
    assert store.latest_valid() == 2
    with pytest.raises(ValueError, match="failed validation"):
        store.restore(other, step=3)
    assert valid_steps(str(tmp_path)) == [2]


def test_snapshot_hook_common_step_and_discard(tmp_path):
    """The hook saves on its interval and once more off the grid at the
    end; the newest step every rank's store holds valid is the common
    one; a rank's snapshots past it are discarded."""
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    state = template_state(SIZE, torch.device("cpu"))
    for d, last in zip(dirs, (7, 5)):
        hook = SnapshotHook(SnapshotStore(d, keep=5), every=2,
                            cursor={"seed": 0}, meta={"model": SIZE})
        hook.begin(type("Loop", (), {"start_step": 0})())
        for step in range(1, last + 1):
            state.step = step
            hook.after_step(step, state, {})
        hook.end(state)
    assert valid_steps(dirs[0]) == [2, 4, 6, 7]
    assert valid_steps(dirs[1]) == [2, 4, 5]
    assert SnapshotStore(dirs[0]).manifest(7)["cursor"] == {"seed": 0,
                                                            "step": 7}
    assert newest_common_step(dirs) == 4
    assert SnapshotStore(dirs[0]).discard_newer(4) == [6, 7]
    assert valid_steps(dirs[0]) == [2, 4]


def test_parked_slot_and_extend_past_cache_end_do_not_raise(engine):
    """Out-of-bounds rows go to the sink: a slot parked at pos == T and a
    window padded past the cache's end leave every slot's rows alone."""
    _engine_greedy(engine, 1, [4, 8, 15], 3)
    before_k = engine.cache.k.clone()
    pos = np.full((SLOTS,), CACHE, np.int32)
    engine.verify_step(np.ones((SLOTS, 4), np.int32), pos)
    assert torch.equal(engine.cache.k, before_k)
    # 3 tokens at rows 30..32, padded to a window of 4: rows 32 and 33
    # are past the end of a 32-row cache.
    tok, _ = engine.extend(0, [5, 6, 7], start=CACHE - 2)
    assert 0 <= tok < engine.vocab
    changed = (engine.cache.k != before_k).flatten(3).any(-1)   # [L, S, T]
    assert changed[:, 0, CACHE - 2:].all()
    assert not changed[:, 0, :CACHE - 2].any() and not changed[:, 1:].any()
    for slot in range(SLOTS):
        engine.set_slot(slot, 0, 0)


def test_serve_lm_cpu_drive_answers_with_the_jax_tools_stats_keys(
        tmp_path, jax_side):
    stats_path = str(tmp_path / "stats.json")
    rc = serve_lm.main(["--device", "cpu", "--snapshot",
                        str(tmp_path / "snaps"), "--init_if_missing",
                        "--drive", "8", "--stats", stats_path])
    assert rc == 0
    with open(stats_path) as f:
        stats = json.load(f)
    assert stats["completed"] == 8 and stats["tokens"] == 64
    assert stats["platform"] == "cpu" and not stats["preempted"]
    # The JAX tool's keys: its batcher's stats, and what the tool adds.
    jax_keys = set(jax_queue.ContinuousBatcher(
        jax_side[2], jax_queue.RequestQueue(250)).stats())
    with open(os.path.join(REPO, "tools", "serve_lm.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "update" and getattr(
                node.func.value, "id", "") == "stats":
            jax_keys |= {kw.arg for kw in node.keywords}
    assert "platform" in jax_keys and jax_keys <= set(stats)


def test_request_front_answers_as_in_process(engine):
    prompt = [31, 41, 59, 26]
    want = _engine_greedy(engine, 0, prompt, 5)
    engine.set_slot(0, 0, 0)
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    stop = threading.Event()
    loop = threading.Thread(target=batcher.run, args=(stop.is_set,),
                            daemon=True)
    loop.start()
    front = RequestFront(queue, batcher, 0).start()
    try:
        body = json.dumps({"tokens": prompt, "max_new": 5}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        front.stop()
        stop.set()
        loop.join(timeout=60)
    assert not loop.is_alive()
    assert got["outcome"] == "ok" and got["tokens"] == want


def test_unported_modes_refused_by_name(tmp_path, monkeypatch, capsys):
    """What stays refused by name: a one-rank --sharded_mesh, a slot
    count the ranks do not divide, a row-layout snapshot with no geometry
    in its manifest.  The run ledger is served (OBS_LEDGER: a run_start
    and a run_end row)."""
    from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
    d = str(tmp_path / "snaps")
    argv = ["--device", "cpu", "--snapshot", d, "--init_if_missing",
            "--drive", "1"]
    assert serve_lm.main(argv + ["--sharded_mesh", "1"]) == 2
    assert "--sharded_mesh 1" in capsys.readouterr().err
    assert serve_lm.main(argv + ["--sharded_mesh", "2", "--slots", "3"]) == 2
    assert "--slots 3" in capsys.readouterr().err
    runs = str(tmp_path / "runs.jsonl")
    monkeypatch.setenv("OBS_LEDGER", runs)
    monkeypatch.setattr(obs_ledger, "_GLOBAL", None)
    assert serve_lm.main(argv) == 0
    obs_ledger.end_global(rc=0)
    monkeypatch.setattr(obs_ledger, "_GLOBAL", None)
    (run,) = obs_ledger.run_table(runs)
    assert run["entrypoint"] == "serve_lm" and run["outcome"] == "ok"
    state = template_state(SIZE, torch.device("cpu"))
    state.step = 9
    SnapshotStore(d).save(state, meta={"model": SIZE,
                                       "update_layout": "zero3_rows"})
    with pytest.raises(ValueError, match="mesh_size"):
        promote(d, SIZE)
