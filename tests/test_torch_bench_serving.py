"""The port's serving bench (``tools.bench_serving``) held against the JAX
package's root ``bench_serving.py`` on the CPU, at lm_tiny:

- the oracle: seeded prompts decoded by the JAX harness's own
  ``_oracle_run`` on the JAX ``DecodeEngine`` and by the port's on the
  port engine built from ``convert.flax_to_port`` of the same parameters
  give bitwise the same token maps, plain and speculative;
- one CPU run of the CLI at tiny counts, all six instruments (the
  sharded point on two gloo ranks): its metric names and each line's
  ``detail`` keys include those of the JAX package's own record
  ``SERVE_lm_cpu_r17.json``; ``spec_mismatch`` 0, the sharded residency
  1/2 and lm_base's 1/4; every line names its device; no kernel
  launched;
- a failed instrument exits 1 with its error in the meta line; an
  indivisible or negative ``--sharded_mesh`` is refused by name (exit 2)
  before anything is measured; the default device raises
  ``DeviceUnavailable`` without a card;
- the card's gap rule: a difference counts only where the greedy top-2
  logit gap at its first position exceeds ``tau``;
- the port's ``bench_ratchet`` holds the record's zero invariant, and
  fails a copy with the mismatch set to 1.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.models import (
    build_model as jax_build_model)
from distributedtensorflowexample_tpu.serving import engine as jax_engine_mod
from distributedtensorflowexample_tpu.serving import spec as jax_spec
from distributedtensorflowexample_tpu_torch import convert
from distributedtensorflowexample_tpu_torch.device import DeviceUnavailable
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.serving.engine import DecodeEngine
from distributedtensorflowexample_tpu_torch.serving.spec import SpecDecoder
from distributedtensorflowexample_tpu_torch.tools import bench_ratchet
from distributedtensorflowexample_tpu_torch.tools import bench_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = "lm_tiny"
SLOTS = 4
CACHE = 64
JAX_RECORD = os.path.join(REPO, "SERVE_lm_cpu_r17.json")
with open(JAX_RECORD) as _f:
    JAX_LINES = [json.loads(line) for line in _f if line.strip()]
#: The CLI at tiny counts: every instrument, the sharded point at D=2.
TINY = ["--device", "cpu", "--size", SIZE, "--slots", str(SLOTS),
        "--max_len", str(CACHE), "--requests", "8", "--repeats", "1",
        "--supervised_repeats", "1", "--clients_sweep", "1,4",
        "--slo_sweep_ms", "0,50", "--spec_k_sweep", "2",
        "--sharded_mesh", "2", "--sharded_requests", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_harness():
    sys.path.insert(0, REPO)
    try:
        import bench_serving as jax_bench_serving
    finally:
        sys.path.pop(0)
    return jax_bench_serving


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX draft, port engine, port draft) over the same
    lm_tiny parameters (the JAX init, converted)."""
    model = jax_build_model(SIZE)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    jparams = jax.tree.map(jnp.asarray, params)
    port = build_model(SIZE)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          convert.flax_to_port(params).items()})
    port.requires_grad_(False)
    return tuple(
        [jax_engine_mod.DecodeEngine(model, jparams, slots=SLOTS,
                                     cache_len=CACHE) for _ in range(2)]
        + [DecodeEngine(port, slots=SLOTS, cache_len=CACHE)
           for _ in range(2)])


def _prompts(seed: int, vocab: int, n: int, max_new: int) -> list:
    """The harness's speculative workload (``bench_serving.py:481-485``)."""
    rng = np.random.default_rng(seed + 7)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 13)))
             .astype(np.int32), max_new) for _ in range(n)]


@pytest.mark.parametrize("k", [0, 2], ids=["greedy", "spec_k2"])
def test_oracle_tokens_are_bitwise_the_jax_harness(jax_harness, engines, k):
    jeng, jdraft, peng, pdraft = engines
    prompts = _prompts(0, peng.vocab, 2 * SLOTS + 1, 8)
    jspec = jax_spec.SpecDecoder(jeng, jdraft, k=k) if k else None
    pspec = SpecDecoder(peng, pdraft, k=k) if k else None
    want, jrates = jax_harness._oracle_run(jeng, prompts, spec=jspec,
                                           repeats=2)
    got, rates = bench_serving._oracle_run(peng, prompts, spec=pspec,
                                           repeats=2)
    assert got == want
    assert len(rates) == len(jrates) == 2 and min(rates) > 0
    assert sorted(got) == [f"o{i}" for i in range(len(prompts))]
    assert all(len(t) == 8 for t in got.values())


def test_gap_rule_counts_only_differences_past_tau(engines):
    peng = engines[2]
    prompts = _prompts(3, peng.vocab, 3, 6)
    greedy, _ = bench_serving._oracle_run(peng, prompts, repeats=1)
    # The greedy top-2 gap at token j from a teacher-forced forward.
    prompt, j = prompts[1][0], 2
    seq = [int(t) for t in prompt] + greedy["o1"][:j]
    with torch.inference_mode():
        logits = peng.model(torch.tensor([seq]))[0, -1].float().numpy()
    top2 = np.sort(logits)[-2:]
    gap = bench_serving._greedy_gap(peng, prompt, greedy["o1"], j)
    assert abs(gap - float(top2[1] - top2[0])) < 3e-2
    assert peng.positions[0] == 0 and peng.last_tokens[0] == 0  # parked
    spec = {**greedy, "o1": greedy["o1"][:j] + [(greedy["o1"][j] + 1)
                                               % peng.vocab] * 4}
    assert bench_serving._mismatches(peng, prompts, greedy, greedy,
                                     None) == (0, 0, [])
    counted, raw, where = bench_serving._mismatches(peng, prompts, greedy,
                                                    spec, None)
    assert (counted, raw) == (1, 1)
    assert where == [{"rid": "o1", "position": j, "gap": round(gap, 6)}]
    for tau, want in ((gap / 2, 1), (gap * 2, 0)):
        counted, raw, where = bench_serving._mismatches(
            peng, prompts, greedy, spec, tau)
        assert (counted, raw) == (want, 1)
        assert where[0]["gap"] == round(gap, 6)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CPU run of the CLI at tiny counts: (rc, its record's lines)."""
    root = tmp_path_factory.mktemp("bench_serving")
    path = root / "records" / "SERVE_lm_cpu_r18.json"
    path.parent.mkdir()
    rc = bench_serving.main(TINY + ["--workdir", str(root / "work"),
                                    "--json", str(path)])
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return rc, lines, path


def _by_metric(lines):
    return {rec["metric"]: rec for rec in lines}


@pytest.mark.parametrize("jax_line", JAX_LINES,
                         ids=[rec["metric"] for rec in JAX_LINES])
def test_cli_record_has_each_jax_metric_and_detail_key(cli_run, jax_line):
    rc, lines, _ = cli_run
    assert rc == 0
    mine = _by_metric(lines)[jax_line["metric"]]
    assert set(jax_line) <= set(mine)
    assert set(jax_line["detail"]) <= set(mine["detail"])
    assert mine["unit"] == jax_line["unit"]


def test_cli_record_spec_exact_residency_device_and_no_launches(cli_run):
    rc, lines, _ = cli_run
    by = _by_metric(lines)
    assert rc == 0 and [r["metric"] for r in lines][-1] == \
        "serving_bench_meta"
    meta = by["serving_bench_meta"]["detail"]
    assert meta["errors"] == {} and by["serving_bench_meta"]["value"] == 11
    spec = by[f"serve_{SIZE}_spec_mismatch"]
    assert spec["value"] == 0 and spec["detail"]["mismatch_raw"] == 0
    assert spec["detail"]["tau"] is None         # the CPU counts exactly
    assert by[f"serve_{SIZE}_sharded_params_frac_per_device"]["value"] \
        == 0.5
    assert by["serve_lm_base_sharded_params_frac_per_device"]["value"] \
        == 0.25
    for rec in lines:
        assert rec["detail"]["device"]["platform"] == "cpu", rec["metric"]
        assert rec["detail"]["platform"] == "cpu", rec["metric"]
    zero = {"dequant": 0, "ce_fwd": 0, "ce_bwd": 0, "sgd": 0}
    sharded = by[f"serve_{SIZE}_sharded_tokens_per_sec"]["detail"]
    assert sharded["launches_by_rank"] == [zero, zero]
    assert by["serve_lm_base_sharded_params_frac_per_device"]["detail"][
        "launches_by_rank"] == [zero] * 4
    assert by[f"serve_{SIZE}_supervised_tokens_per_sec"]["detail"][
        "launches"] == zero
    assert meta["launches"] == zero
    assert by[f"serve_{SIZE}_supervised_tokens_per_sec"]["detail"][
        "supervision"]["status"] == "ok"


def test_ratchet_holds_the_zero_invariant_and_fails_a_mismatch(
        cli_run, tmp_path, capsys):
    _, lines, path = cli_run
    shutil.copy(path, tmp_path / path.name)
    assert bench_ratchet.main(["--records_dir", str(tmp_path),
                               "--json"]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["unexplained"] == 0 and verdict["records"] == 11
    bad = [dict(rec, value=1.0) if rec["metric"].endswith("_mismatch")
           else rec for rec in lines]
    with open(tmp_path / "SERVE_lm_cpu_r19.json", "w") as f:
        f.writelines(json.dumps(rec) + "\n" for rec in bad)
    assert bench_ratchet.main(["--records_dir", str(tmp_path),
                               "--json"]) == 1
    verdict = json.loads(capsys.readouterr().out)
    assert [(f["metric"], f["severity"]) for f in verdict["findings"]
            if f["prior_file"] == "(invariant)"] == \
        [(f"serve_{SIZE}_spec_mismatch", "regression")]


def test_a_failed_instrument_fails_the_run_with_its_error(tmp_path):
    path = tmp_path / "SERVE_lm_cpu_r18.json"
    rc = bench_serving.main(TINY + [
        "--skip_supervised", "--sharded_mesh", "0", "--spec_k_sweep", "0",
        "--workdir", str(tmp_path / "work"), "--json", str(path)])
    assert rc == 1
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    meta = lines[-1]
    assert meta["metric"] == "serving_bench_meta"
    assert list(meta["detail"]["errors"]) == ["spec"]
    assert "draft window k 0" in meta["detail"]["errors"]["spec"]
    # The other instruments still measured and wrote their lines.
    assert {r["metric"] for r in lines[:-1]} == {
        f"serve_{SIZE}_tokens_per_sec", f"serve_{SIZE}_p99_ms",
        f"serve_{SIZE}_throughput_vs_slo",
        f"serve_{SIZE}_prefill_batch_amortization"}


@pytest.mark.parametrize("flags,words", [
    (["--sharded_mesh", "3"], "--slots 4 does not divide across the 3-rank"),
    (["--sharded_mesh", "-1"], "--sharded_mesh -1: a mesh has at least"),
    (["--clients_sweep", ""], "--clients_sweep is empty"),
], ids=["indivisible", "negative", "no_clients"])
def test_impossible_flags_are_refused_before_measuring(tmp_path, capsys,
                                                       flags, words):
    work = tmp_path / "work"
    rc = bench_serving.main(TINY + flags + ["--workdir", str(work)])
    assert rc == 2
    assert f"bench_serving: refused: {words}" in capsys.readouterr().err
    assert not work.exists()


def test_default_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(DeviceUnavailable):
        bench_serving.main(argv + ["--workdir", str(tmp_path / "work")])
    assert not (tmp_path / "work").exists()
