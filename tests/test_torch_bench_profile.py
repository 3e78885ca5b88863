"""``tools.bench_profile`` (ResNet-20's decomposition) on the CPU, held
to the JAX package's root ``bench_profile.py``:

- the lines in the JAX order: the two variants (augment, no augment),
  the traced window after the augment variant, the roofline and the
  attribution, at a tiny ResNet-20 run;
- the shares are the JAX formulas (``1 - aug/noaug``, ``1 -
  noaug/roofline``, rounded to 4 places; the value ``aug/roofline``) on
  the rates the lines record;
- the trace is a Chrome trace file in ``--trace_dir``, and the profiler
  is off after the run;
- a variant that fails still yields the other lines, and the attribution
  from what survived, with the error (exit 1);
- the FLOPs a step are ``utils/flops.py``'s; no kernel is launched;
  each variant carries the JAX bytes fields (``utils/profiling``'s
  audit), the bandwidth ones null on the CPU.
"""

import json

import pytest
import torch

from distributedtensorflowexample_tpu_torch.tools import bench as pbench
from distributedtensorflowexample_tpu_torch.tools import bench_profile
from distributedtensorflowexample_tpu_torch.utils import flops

LINES = ["resnet20_profile_augment", "resnet20_traced_window",
         "resnet20_profile_no_augment", "resnet20_roofline",
         "resnet20_attribution"]
B = 4
ARGV = ["--device", "cpu", "--batch_per_chip", str(B), "--unroll", "2",
        "--steps", "2", "--roofline_length", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(pbench, "TRAIN_N", {"mnist": 16, "cifar10": 16})
    monkeypatch.setattr(pbench, "REPEATS", 1)


def _lines(text: str) -> list[dict]:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def _profiler_on() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    trace_dir = tmp_path_factory.mktemp("trace") / "resnet_trace"
    mp = pytest.MonkeyPatch()
    mp.setattr(pbench, "TRAIN_N", {"mnist": 16, "cifar10": 16})
    mp.setattr(pbench, "REPEATS", 1)
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench_profile.main(ARGV + ["--trace_dir", str(trace_dir)])
    finally:
        mp.undo()
    return rc, _lines(buf.getvalue()), trace_dir


def test_lines_in_the_jax_order(run):
    rc, lines, _ = run
    assert rc == 0
    assert [l["metric"] for l in lines] == LINES
    for l in lines[:-1]:
        assert l["unit"] == "steps/sec/chip" and l["value"] > 0
        assert l["detail"]["device"]["platform"] == "cpu"
    for tag in ("augment", "no_augment"):
        d = lines[LINES.index(f"resnet20_profile_{tag}")]["detail"]
        assert d["flops_per_step"] == flops.train_flops_per_step(
            "resnet20", B)
        assert d["mfu"] is None and d["unroll"] == 2
        assert d["launches"] == d["kernel_steps"] == dict.fromkeys(
            d["launches"], 0)
        # The JAX bytes fields, from a build of the variant's own; the
        # bandwidth ones null on the CPU.
        audit = d["bytes_audit"]
        assert d["bytes_per_step"] == audit["bytes_per_step"] > \
            audit["bytes_effective_per_step"] > 0
        assert len(audit["top_ops"]) == 8
        assert d["arith_intensity_flop_per_byte"] == round(
            d["flops_per_step"] / d["bytes_per_step"], 2)
        assert d["arith_intensity_effective"] == round(
            d["flops_per_step"] / audit["bytes_effective_per_step"], 2)
        for key in ("bw_roofline_steps_per_sec",
                    "bw_roofline_effective_steps_per_sec",
                    "mfu_ceiling_at_bw", "mfu_ceiling_at_bw_effective"):
            assert d[key] is None


def test_shares_are_the_jax_formulas_on_the_recorded_rates(run):
    _, lines, _ = run
    by = {l["metric"]: l for l in lines}
    aug = by["resnet20_profile_augment"]["detail"]["steps_per_sec"]
    noaug = by["resnet20_profile_no_augment"]["detail"]["steps_per_sec"]
    roof = by["resnet20_roofline"]["detail"]["steps_per_sec"]
    assert roof == max(by["resnet20_roofline"]["detail"]["repeats"])
    attr = by["resnet20_attribution"]
    assert attr["unit"] == "measured/roofline"
    assert attr["detail"]["augment_share"] == round(1 - aug / noaug, 4)
    assert attr["detail"]["input_dispatch_share"] == round(
        1 - noaug / roof, 4)
    assert attr["value"] == round(aug / roof, 4)


def test_trace_on_disk_and_the_profiler_off(run):
    _, lines, trace_dir = run
    window = {l["metric"]: l for l in lines}["resnet20_traced_window"]
    d = window["detail"]
    assert d["trace_dir"] == str(trace_dir)
    files = list(trace_dir.iterdir())
    assert [f.name for f in files] == ["trace.json"]
    assert d["trace_files"] == 1 and d["trace_bytes"] == \
        files[0].stat().st_size > 0
    assert json.loads(files[0].read_text())["traceEvents"]
    assert d["steps_in_window"] == 2 and window["value"] > 0
    assert d["device_us_per_step_by_kind"] == {}      # no card
    assert not _profiler_on()


def test_a_failed_variant_still_yields_the_other_lines(monkeypatch, capsys,
                                                       tmp_path):
    make = pbench._make

    def failing(*a, **kw):
        if kw.get("augment") == "none":
            raise RuntimeError("no_augment build failed")
        return make(*a, **kw)

    monkeypatch.setattr(pbench, "_make", failing)
    rc = bench_profile.main(ARGV + ["--trace_dir", str(tmp_path / "t")])
    lines = _lines(capsys.readouterr().out)
    assert rc == 1
    assert [l["metric"] for l in lines] == [
        "resnet20_profile_augment", "resnet20_traced_window",
        "resnet20_roofline", "resnet20_attribution"]
    attr = lines[-1]
    assert "no_augment build failed" in attr["detail"]["errors"][
        "no_augment"]
    assert "augment_share" not in attr["detail"]
    assert "input_dispatch_share" not in attr["detail"]
    aug = lines[0]["detail"]["steps_per_sec"]
    roof = lines[2]["detail"]["steps_per_sec"]
    assert attr["value"] == round(aug / roof, 4)
    assert not _profiler_on()


def test_attribution_from_what_survived():
    assert bench_profile.attribution({}, {}) is None
    only = bench_profile.attribution({"augment": 2.0}, {"x": "e"})
    assert only["value"] == 0.0 and only["detail"] == {"errors": {"x": "e"}}
    both = bench_profile.attribution(
        {"augment": 1.0, "no_augment": 2.0, "roofline": 4.0}, {})
    assert both["value"] == 0.25 and both["detail"] == {
        "augment_share": 0.5, "input_dispatch_share": 0.5}


def test_a_missing_card_prints_the_unavailable_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_profile.main([]) == 1
    line = _lines(capsys.readouterr().out)[0]
    assert line["metric"] == "resnet20_attribution"
    assert line["unit"] == "unavailable" and line["value"] == 0.0
