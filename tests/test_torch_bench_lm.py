"""``tools.bench_lm`` (the port's LM harness) and the LM's FLOP count
(``utils/flops.py``) held against the JAX package's root ``bench_lm.py``
on the CPU:

- the FLOP count of an lm_tiny training step equals the JAX
  ``flops_audit`` of the compiled JAX step (``bench_lm._build`` on a
  one-device CPU mesh) exactly.  The audit reads each dot's operand
  shapes from the HLO text; this jaxlib's ``as_text()`` leaves them out
  (``dot(%a, %b)``), so the audit then prices every dot at one
  contracted element (2 x its output elements).  The module is printed
  with ``print_operand_shape`` here, and the difference of the plain
  text's audit is named and checked too;
- ``tools.bench_lm --device cpu`` at lm_tiny, sequence 16: one rank
  (base and remat), then two gloo ranks with every knob (``--ab_steps
  1``): the JAX line names in the JAX order, the MFU identity
  (``rel=1e-4``, as the JAX test), a remat saving in (0, 1), zero3 and
  zero3_nooverlap both timed, no kernel launched;
- at D=2 each knob's ``opt_state_bytes_per_device`` and
  ``state_bytes_per_device`` equal the JAX ``optstate_bytes_per_device``
  and ``state_residency_per_device`` of the same knob's JAX ``_build`` on
  a 2-device CPU mesh, exactly.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu.parallel import make_mesh as jmake_mesh
from distributedtensorflowexample_tpu.utils.profiling import (
    flops_audit, state_residency_per_device)
from distributedtensorflowexample_tpu_torch.tools import bench as pbench
from distributedtensorflowexample_tpu_torch.tools import bench_lm
from distributedtensorflowexample_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
BATCH = 2
# The JAX harness's emission order (bench_lm.py run_throughput, then
# run_ab_matrix's derived lines, then the matrix).
ONE_RANK = ["lm_tiny_tokens_per_sec_per_chip", "lm_tiny_mfu",
            "lm_tiny_remat_activation_savings_frac", "lm_tiny_knob_ab_matrix"]
TWO_RANKS = ["lm_tiny_tokens_per_sec_per_chip", "lm_tiny_mfu",
             "lm_tiny_remat_activation_savings_frac",
             "lm_tiny_shard_update_optstate_shrink_x",
             "lm_tiny_zero1_optstate_shrink_x",
             "lm_tiny_zero3_state_residency_shrink_x",
             "lm_tiny_zero3_overlap_speedup_x", "lm_tiny_knob_ab_matrix",
             "lm_bench_meta"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbench_lm():
    sys.path.insert(0, REPO)
    try:
        import bench_lm as jax_bench_lm
    finally:
        sys.path.pop(0)
    return jax_bench_lm


def _argv(*extra) -> list:
    return ["--device", "cpu", "--throughput_size", "lm_tiny", "--size",
            "lm_tiny", "--seq_len", str(SEQ), "--batch_per_chip",
            str(BATCH), "--ab_batch_per_chip", str(BATCH), "--steps", "2",
            "--unroll", "1", "--repeats", "1", "--ab_steps", "1", *extra]


def _lines(text: str) -> list[dict]:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


@pytest.fixture(scope="module")
def two_rank_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm") / "BENCH_lm_cpu.json"
    assert bench_lm.main(_argv("--devices", "2", "--json", str(out))) == 0
    return [json.loads(l) for l in out.read_text().splitlines()]


# --- the FLOP count ---------------------------------------------------------

def _dot_output_elements(hlo: str) -> int:
    """Sum of 2 x output elements over the dot instructions."""
    total = 0
    for m in re.finditer(r"= f32\[([\d,]*)\]\S* dot\(", hlo):
        total += 2 * int(np.prod([int(d) for d in m.group(1).split(",")]))
    return total


@pytest.mark.parametrize("batch,seq", [(2, 16), (3, 32)])
def test_lm_flops_equal_the_jax_flops_audit(jbench_lm, batch, seq):
    from jax._src.lib import xla_client
    mesh = jmake_mesh(1)
    with mesh:
        step, ds, state, _ = jbench_lm._build("lm_tiny", mesh, batch, seq, 1)
        compiled = step.lower(state, ds.peek()).compile()
    opts = xla_client._xla.HloPrintOptions()
    opts.print_operand_shape = True
    shaped = compiled.runtime_executable().hlo_modules()[0].to_string(opts)
    want = flops_audit(shaped)["flops_per_step"]
    assert want == flops.train_flops_per_step("lm_tiny", batch, seq)
    plain = compiled.as_text()
    got = flops_audit(plain)["flops_per_step"]
    # The named difference: without operand shapes every dot is priced at
    # one contracted element.
    assert got == want or got == _dot_output_elements(plain)


def test_lm_flops_are_six_macs_of_every_product():
    layers = flops.layer_macs("lm_base", 128)
    assert [n for n, _ in layers[:6]] == [
        "block0.qkv", "block0.scores", "block0.values", "block0.attn_out",
        "block0.mlp_in", "block0.mlp_out"] and layers[-1][0] == "head"
    assert len(layers) == 8 * 6 + 1
    macs = sum(m for _, m in layers)
    assert flops.train_flops_per_row("lm_base", 128) == 6 * macs
    assert flops.train_flops_per_step("lm_base", 16, 128) == 16 * 6 * macs
    # Other models keep the first layer's input gradient out.
    cnn = [m for _, m in flops.layer_macs("mnist_cnn")]
    assert flops.train_flops_per_row("mnist_cnn") == \
        6 * sum(cnn) - 2 * cnn[0]


# --- the harness ------------------------------------------------------------

def test_one_rank_lines_in_the_jax_order(capsys):
    assert bench_lm.main(_argv("--devices", "1")) == 0
    lines = _lines(capsys.readouterr().out)
    assert [l["metric"] for l in lines] == ONE_RANK
    matrix = lines[-1]["detail"]
    assert sorted(matrix["matrix"]) == ["base", "remat"]
    assert matrix["backend"] is None and matrix["devices"] == 1


def test_two_ranks_every_knob_in_the_jax_order(two_rank_record):
    assert [r["metric"] for r in two_rank_record] == TWO_RANKS
    by = {r["metric"]: r for r in two_rank_record}
    d = by["lm_tiny_knob_ab_matrix"]["detail"]
    assert list(d["matrix"]) == list(bench_lm.KNOBS)
    assert d["backend"] == "gloo" and d["devices"] == 2
    assert "errors" not in d and not by["lm_bench_meta"]["detail"]["errors"]
    for name, e in d["matrix"].items():
        assert e["config"] == bench_lm.KNOBS[name]
        assert e["launches"] == [dict.fromkeys(e["launches"][0], 0)] * 2
        assert e["memory"]["activation_bytes"] > 0
        assert "peak_bytes" not in e["memory"]          # cuda only
        timed = name != "shard_update"
        assert ("steps_per_sec" in e) == timed
    for name in ("zero3", "zero3_nooverlap"):
        assert d["matrix"][name]["steps_per_sec"] > 0
    assert by["lm_tiny_zero3_overlap_speedup_x"]["value"] == pytest.approx(
        d["matrix"]["zero3"]["steps_per_sec"]
        / d["matrix"]["zero3_nooverlap"]["steps_per_sec"], rel=1e-9)
    base = d["matrix"]["base"]["collectives"]
    assert base["multiset"] == {"all-reduce": 1}
    assert base["per_step"]["all-reduce"]["bytes"] == \
        d["matrix"]["base"]["opt_state_bytes_per_device"]


def test_mfu_identity_and_remat_saving(two_rank_record):
    by = {r["metric"]: r for r in two_rank_record}
    tput, mfu = by["lm_tiny_tokens_per_sec_per_chip"], by["lm_tiny_mfu"]
    d = tput["detail"]
    assert tput["unit"] == "tokens/sec/chip" and tput["value"] > 0
    assert d["token_storage"] == "uint8" and d["tokens_per_step"] == \
        BATCH * SEQ
    assert d["model_flops_per_step_per_device"] == \
        flops.train_flops_per_step("lm_tiny", BATCH, SEQ)
    assert mfu["detail"]["model_flops_per_step_per_device"] == \
        d["model_flops_per_step_per_device"]
    # MFU = per-rank flops x rate / peak (no second /n), as in JAX.
    assert mfu["value"] > 0 and mfu["detail"]["peak_flops"] == \
        pbench.PEAK_FLOPS
    assert mfu["value"] == pytest.approx(
        d["model_flops_per_step_per_device"] * d["steps_per_sec"]
        / mfu["detail"]["peak_flops"], rel=1e-4)
    sav = by["lm_tiny_remat_activation_savings_frac"]
    assert 0 < sav["value"] < 1
    assert sav["value"] == pytest.approx(
        1 - sav["detail"]["activation_bytes_remat"]
        / sav["detail"]["activation_bytes_base"])
    # The throughput line's JAX bytes fields (no top ops; the bandwidth
    # roofline null on the CPU), and no other line's.
    audit = d["bytes_audit"]
    assert "top_ops" not in audit and audit["bytes_per_step"] > \
        audit["bytes_effective_per_step"] > 0
    assert d["bw_roofline_effective_steps_per_sec"] is None
    assert d["arith_intensity_effective"] == round(
        d["model_flops_per_step_per_device"]
        / audit["bytes_effective_per_step"], 3)
    assert [r["metric"] for r in two_rank_record
            if "bytes_audit" in r["detail"]] == [tput["metric"]]


@pytest.mark.parametrize("knob", list(bench_lm.KNOBS))
def test_rank_bytes_equal_the_jax_build(jbench_lm, two_rank_record, knob):
    mesh = jmake_mesh(2)
    with mesh:
        _, _, state, _ = jbench_lm._build("lm_tiny", mesh, BATCH, SEQ, 1,
                                          **bench_lm.KNOBS[knob])
    want_opt = jbench_lm.optstate_bytes_per_device(state.opt_state)
    want = state_residency_per_device(state)
    entry = {r["metric"]: r for r in two_rank_record}[
        "lm_tiny_knob_ab_matrix"]["detail"]["matrix"][knob]
    assert entry["opt_state_bytes_per_device"] == want_opt
    assert entry["residency"]["state_bytes_per_device"] == \
        want["state_bytes_per_device"]
    assert entry["residency"] == want


def test_a_missing_card_prints_the_unavailable_line(monkeypatch, capsys,
                                                    tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rec.json"
    assert bench_lm.main(["--json", str(out)]) == 1
    cap = capsys.readouterr()
    line = _lines(cap.out)[0]
    assert line["metric"] == "lm_tokens_per_sec_per_chip"
    assert line["unit"] == "unavailable" and \
        line["detail"]["provisional"] is True
    assert json.loads(out.read_text()) == line
    assert "cuda" in cap.err
