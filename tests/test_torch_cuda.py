"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips where no CUDA card is visible (decided
inside the fixture, never at import).  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest configures JAX, which the
card's machine does not need; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from distributedtensorflowexample_tpu_torch.data.dequant import (
    make_dequant_affine)
from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    build, cross_entropy as ce, dequant as dq, sgd)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible (the kernels run only on one)")
    return torch.device("cuda")


def _affine(spec, channels, device):
    """The named dequant constants, or for ``spec=None`` one scale and
    bias per channel (the kernel's any-channel-count form)."""
    if spec is not None:
        return (torch.from_numpy(a).to(device)
                for a in make_dequant_affine(spec))
    s = torch.tensor([1 / 255, 2 / 255, 0.5, 0.25][:channels])
    b = torch.tensor([0.0, -0.5, 0.25, -1.0][:channels])
    return s.to(device), b.to(device)


@pytest.mark.parametrize("batch", [1, 64, 128, 1000])
@pytest.mark.parametrize("spec,shape,offset", [
    ("unit", (28, 28, 1), 0),       # MNIST rows: the 16-byte path
    ("cifar", (32, 32, 3), 0),
    (None, (8, 8, 4), 0),           # C=4: the any-channel-count form
    ("unit", (5, 7, 1), 0),         # a 35-byte row: the scalar path
    ("unit", (28, 28, 1), 1),       # a split sliced at an odd byte
    ("cifar", (32, 32, 3), 3),
])
def test_dequant_kernel_bitwise(cuda, spec, shape, offset, batch):
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 500
    row_len = int(np.prod(shape))
    flat = torch.randint(0, 256, (offset + n * row_len,), dtype=torch.uint8,
                         device=cuda, generator=g)
    images = flat[offset:].view(n, *shape)
    idx = torch.randint(-3, n + 3, (batch,), dtype=torch.int32, device=cuda,
                        generator=g)          # out of range rows clamp
    s, b = _affine(spec, shape[-1], cuda)
    before = dq.fused_gather_dequant.launches
    got = dq.fused_gather_dequant(images, idx, s, b)
    want = dq.gather_dequant_plain(images, idx, s, b)
    torch.cuda.synchronize()
    assert dq.fused_gather_dequant.launches == before + 1
    assert dq.vector_path(row_len, images.data_ptr(), got.data_ptr()) is (
        offset == 0 and row_len % 16 == 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("batch,classes", [
    *((b, c) for c in (1, 10, 16, 17, 32, 33, 250, 1000)
      for b in (1, 7, 67, 256)),
    (2048, 250),                              # the LM head: 16 x 128 rows
])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_kernels_match_plain(cuda, classes, smoothing, batch):
    g = torch.Generator(device=cuda).manual_seed(classes)
    logits = torch.randn(batch, classes, device=cuda, generator=g) * 3
    labels = torch.randint(0, classes, (batch,), dtype=torch.int32,
                           device=cuda, generator=g)
    if batch > 2:
        labels[1] = -1                        # a padding row
        labels[2] = classes                   # a label past every column
    up = torch.rand(batch, device=cuda, generator=g)
    x = logits.clone().requires_grad_(True)
    rows = kernels.fused_softmax_cross_entropy_rows(x, labels, smoothing)
    rows.backward(up)
    torch.cuda.synchronize()
    want_rows = ce.ce_fwd_plain(logits, labels, smoothing)
    want_grad = ce.ce_bwd_plain(logits, labels, up, smoothing)
    assert (rows.detach() - want_rows).abs().max().item() <= 1e-5
    assert (x.grad - want_grad).abs().max().item() <= 1e-6
    if batch > 2:
        assert rows[1].item() == 0.0 and not x.grad[1].any()


@pytest.mark.parametrize("batch", [1, 7, 67])
@pytest.mark.parametrize("classes", [10, 17, 1000])
def test_ce_bwd_stores_nothing_past_the_batch(cuda, classes, batch):
    # The C entry itself, into a buffer two rows longer than the batch and
    # filled with NaN: the rows of the batch get the gradient and the two
    # past its end stay NaN (a row group past the end stores nothing).
    g = torch.Generator(device=cuda).manual_seed(batch * classes)
    logits = torch.randn(batch, classes, device=cuda, generator=g) * 3
    labels = torch.randint(0, classes, (batch,), dtype=torch.int32,
                           device=cuda, generator=g)
    up = torch.rand(batch, device=cuda, generator=g)
    out = torch.full((batch + 2, classes), float("nan"), device=cuda)
    one_minus_s, _, s_over_c = ce._smoothing_constants(0.1, classes)
    fn = build.bind("cross_entropy", "ce_bwd", ce._BWD_ARGTYPES)
    code = fn(logits.data_ptr(), labels.data_ptr(), up.data_ptr(), batch,
              classes, 1, one_minus_s, s_over_c, out.data_ptr(),
              build.stream_of(logits))
    torch.cuda.synchronize()
    assert code == 0
    want = ce.ce_bwd_plain(logits, labels, up, 0.1)
    assert (out[:batch] - want).abs().max().item() <= 1e-6
    assert out[batch:].isnan().all()


def test_sgd_kernel_within_one_ulp(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    n = 3_274_634
    p, m, gr = (torch.randn(n, device=cuda, generator=g) for _ in range(3))
    pk, mk, pp, mp = p.clone(), m.clone(), p.clone(), m.clone()
    sgd.fused_sgd_apply(pk, mk, gr, 0.05, 0.9)
    sgd.sgd_plain(pp, mp, gr, 0.05, 0.9)
    torch.cuda.synchronize()
    for a, b in ((pk, pp), (mk, mp)):
        d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        assert int(d.max()) <= 1
        assert float((d > 0).float().mean()) < 1e-4


def test_main_path_launches_every_kernel(cuda, tmp_path, monkeypatch):
    from distributedtensorflowexample_tpu_torch.data import mnist
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    monkeypatch.setattr(mnist, "_SYNTH_SIZES", {"train": 2048, "test": 512})
    kernels.reset_launch_counts()
    summary = trainer_sync_mnist.main([
        "--dataset", "synthetic", "--train_steps", "40", "--batch_size",
        "32", "--log_every", "20", "--dequant_impl", "pallas",
        "--pallas_ce", "true", "--fused_optimizer", "true",
        "--log_dir", str(tmp_path)])
    assert summary["device"].startswith("cuda")
    assert kernels.launch_counts() == {
        "dequant": 40 + summary["eval_batches"], "ce_fwd": 40,
        "ce_bwd": 40, "sgd": 40}
    losses = [l for _, l in summary["loss_tape"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_config4_launches_dequant_and_ce_not_sgd(cuda, tmp_path,
                                                 monkeypatch):
    """A short config-4 run on the card: the dequant kernel once per step
    and per eval batch, the CE pair once per step, SGD never (weight
    decay rules it out), and a finite, falling loss."""
    from distributedtensorflowexample_tpu_torch.data import cifar10
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    monkeypatch.setattr(cifar10, "_SYNTH_SIZES", {"train": 1024,
                                                  "test": 512})
    kernels.reset_launch_counts()
    summary = trainer_mirrored_cifar.main([
        "--dataset", "synthetic", "--train_steps", "40", "--batch_size",
        "32", "--log_every", "20", "--warmup_steps", "5",
        "--dequant_impl", "pallas", "--pallas_ce", "true",
        "--log_dir", str(tmp_path)])
    assert summary["device"].startswith("cuda")
    assert kernels.launch_counts() == {
        "dequant": 40 + summary["eval_batches"], "ce_fwd": 40,
        "ce_bwd": 40, "sgd": 0}
    losses = [l for _, l in summary["loss_tape"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert summary["all_reduces"] == 0 and summary["num_replicas"] == 1


@pytest.mark.parametrize("size", ["lm_tiny", "lm_small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_on_the_card_matches_the_cpu(cuda, dtype, size):
    """One init, one token batch: the card's logits against the CPU's.
    float32 within 1e-4 of the largest logit (TF32 off, summation order
    only); bfloat16 within 6e-2 absolute (two bf16 ulps at |logit| < 8:
    cuBLAS and the CPU round their products at different places).  One
    out-of-vocabulary id poisons every logit on the card too."""
    from distributedtensorflowexample_tpu_torch.device import resolve_device
    from distributedtensorflowexample_tpu_torch.models import build_model
    resolve_device("cuda")
    dt = getattr(torch, dtype)
    model = build_model(size, dtype=dt).reset_parameters(
        torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 250, (4, 128)).astype(np.uint8))
    bad = tokens.clone()
    bad[3, 7] = 253
    with torch.no_grad():
        want = model(tokens)
        model.to(cuda)
        got = model(tokens.to(cuda)).cpu()
        assert model(bad.to(cuda)).isnan().all()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    if dtype == "float32":
        assert err <= 1e-4 * want.abs().max().item()
    else:
        assert err <= 6e-2


def _two_ranks_on_one_card(log_dir: str) -> dict:
    """One of two gloo ranks (``launch.spawn``'s child): 20 config-3 steps
    on cuda:0 through the trainer, then this process's launch counts."""
    from distributedtensorflowexample_tpu_torch.data import mnist
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    mnist._SYNTH_SIZES = {"train": 2048, "test": 512}
    kernels.reset_launch_counts()
    summary = trainer_sync_mnist.main([
        "--dataset", "synthetic", "--train_steps", "20", "--batch_size",
        "32", "--log_every", "10", "--dequant_impl", "pallas",
        "--pallas_ce", "true", "--fused_optimizer", "true",
        "--log_dir", log_dir])
    return dict(summary, launches=kernels.launch_counts())


def test_two_gloo_ranks_on_one_card(cuda, tmp_path):
    from distributedtensorflowexample_tpu_torch.parallel import launch
    build.build()                   # once, before the ranks start
    ranks = launch.spawn(_two_ranks_on_one_card, 2, "gloo",
                         (str(tmp_path),), timeout_s=600)
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]
    assert ranks[0]["params_digest"] == ranks[1]["params_digest"]
    for r in ranks:
        assert r["global_batch"] == 64 and r["all_reduces"] == 20
        # Two ranks on one card: the per-chip rate is that card's.
        assert r["num_chips"] == 1
        assert r["launches"] == {"dequant": 20 + r["eval_batches"],
                                 "ce_fwd": 20, "ce_bwd": 20, "sgd": 20}


def test_checkpoint_round_trip_of_state_on_the_card(cuda, tmp_path,
                                                   monkeypatch):
    """State that lives on the card (parameters, momentum, the dropout
    generator of ``cuda:0``) through a checkpoint and back: bitwise, and
    the restored state's next steps draw the same dropout masks."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.parallel.mesh import Mesh
    from distributedtensorflowexample_tpu_torch.training.checkpoint import (
        CheckpointManager)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    data = make_synthetic(256, (28, 28, 1), 10, seed=0, sample_seed=1)
    engine = Engine(RunSpec("mnist_cnn", "mnist", parse_flags(
        ["--device", "cuda", "--momentum", "0.9", "--batch_size", "32",
         "--fused_optimizer", "true", "--pallas_ce", "true",
         "--dequant_impl", "pallas"])))
    mesh = Mesh(cuda)
    built = engine.build(mesh, data=data)
    for _ in range(3):
        built.step(built.state, next(built.ds))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(built.state.step, built.state)
    mgr.wait()
    restored = engine.create_state(mesh)
    CheckpointManager(str(tmp_path)).restore(restored)
    states = [built.state, restored]
    opts = [s.optimizer for s in states]
    assert restored.step == 3 and opts[1].count == 3
    assert opts[1].params_flat.device.type == "cuda"
    for name in ("params_flat", "momentum_flat"):
        assert torch.equal(getattr(opts[0], name), getattr(opts[1], name))
    assert torch.equal(built.state.generator.get_state(),
                       restored.generator.get_state())
    again = engine.build(mesh, data=data, state=restored)
    for _ in range(2):
        built.step(built.state, next(built.ds))
        again.step(again.state, next(again.ds))
    assert torch.equal(opts[0].params_flat, opts[1].params_flat)


def test_config2_launches_dequant_and_ce_not_sgd(cuda, tmp_path,
                                                 monkeypatch):
    """A short config-2 run on the card: the dequant kernel once per step
    and per eval batch, the CE pair once per step, SGD never (refused in
    async mode), and a finite, falling loss."""
    from distributedtensorflowexample_tpu_torch.data import mnist
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_ps_mnist)
    monkeypatch.setattr(mnist, "_SYNTH_SIZES", {"train": 2048, "test": 512})
    kernels.reset_launch_counts()
    summary = trainer_ps_mnist.main([
        "--dataset", "synthetic", "--train_steps", "40", "--batch_size",
        "32", "--log_every", "20", "--dequant_impl", "pallas",
        "--pallas_ce", "true", "--log_dir", str(tmp_path)])
    assert summary["device"].startswith("cuda")
    assert kernels.launch_counts() == {
        "dequant": 40 + summary["eval_batches"], "ce_fwd": 40,
        "ce_bwd": 40, "sgd": 0}
    losses = [l for _, l in summary["loss_tape"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
