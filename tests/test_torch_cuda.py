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
    cross_entropy as ce, dequant as dq, sgd)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible (the kernels run only on one)")
    return torch.device("cuda")


@pytest.mark.parametrize("spec,shape", [("unit", (28, 28, 1)),
                                        ("cifar", (32, 32, 3))])
def test_dequant_kernel_bitwise(cuda, spec, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (500,) + shape, dtype=torch.uint8,
                           device=cuda, generator=g)
    idx = torch.randint(-3, 503, (64,), dtype=torch.int32, device=cuda,
                        generator=g)          # out of range rows clamp
    s, b = (torch.from_numpy(a).to(cuda) for a in make_dequant_affine(spec))
    before = dq.fused_gather_dequant.launches
    got = dq.fused_gather_dequant(images, idx, s, b)
    want = dq.gather_dequant_plain(images, idx, s, b)
    torch.cuda.synchronize()
    assert dq.fused_gather_dequant.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("classes", [10, 250, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_kernels_match_plain(cuda, classes, smoothing):
    g = torch.Generator(device=cuda).manual_seed(classes)
    logits = torch.randn(67, classes, device=cuda, generator=g) * 3
    labels = torch.randint(0, classes, (67,), dtype=torch.int32, device=cuda,
                           generator=g)
    labels[5] = -1
    up = torch.rand(67, device=cuda, generator=g)
    x = logits.clone().requires_grad_(True)
    rows = kernels.fused_softmax_cross_entropy_rows(x, labels, smoothing)
    rows.backward(up)
    torch.cuda.synchronize()
    want_rows = ce.ce_fwd_plain(logits, labels, smoothing)
    want_grad = ce.ce_bwd_plain(logits, labels, up, smoothing)
    assert (rows.detach() - want_rows).abs().max().item() <= 1e-5
    assert (x.grad - want_grad).abs().max().item() <= 1e-6
    assert rows[5].item() == 0.0 and not x.grad[5].any()


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
