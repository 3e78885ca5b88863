"""Config 4's ResNet-20 in async mode on the CPU: the port's local SGD
with each worker's own batch-norm statistics (one worker per gloo rank,
``parallel/async_ps.py``) against the JAX package's
``make_indexed_async_train_step`` on a W-device mesh of the conftest's
virtual CPU devices (its shard_map path), at 2 and 4 workers, from the
same per-worker parameters, momentum and statistics
(``convert.worker_slice`` of the JAX ``make_worker_state`` tiles) over
the JAX dataset's index tape.

ResNet-20 at full width (272,474 parameters), float32, B=8 per worker,
no augment or weight decay, lr 0.05, momentum 0.9, 5 steps at period 2
(two averagings and one step after), the dequant and cross-entropy
kernels (the JAX side in interpret mode, the port through their plain
versions).  Tolerances: each loss of the tape within rtol 1e-5 of the
JAX step's, and each worker's parameters, momentum and statistics, and
the eval's average (``consolidated`` against JAX ``consolidate``), each
leaf within 1e-5 of its largest value of the JAX step's; or, for a loss
or a leaf, no further from the same JAX step run in float64
(``jax.enable_x64``) than the JAX float32 step is.  At 8 rows a worker
the two float32 sides part: many of ResNet-20's gradients (a batch
norm's bias, a convolution feeding a batch norm) are sums of terms that
nearly cancel, so their float32 values are mostly rounding, and five
steps of momentum carry it into every leaf.  In this test on the CPU the JAX
float32 step's leaves sit up to 1.36 times their largest value from the
float64 step's, the port's up to 0.31 times and never further than the
JAX float32 step's; the port's tape is within 6e-5 relative of the
float64 step's, the JAX float32 step's within 5e-3.

Two groups (2 and 4 ranks) start once for the module while the JAX side
runs here; the rank workers import no JAX.  The shared helpers are
``tests/test_torch_async.py``'s.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import make_mesh
from test_torch_async import (PERIOD, STEPS, _against_jax,
                              _jax_resnet_perms, _jax_resnet_tape,
                              _jax_resnet_tape_f64, _jax_resnet_workers,
                              _resnet_tapes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every spawned rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank_run(inp) -> dict:
    return _resnet_tapes(make_mesh("cpu"), inp, "resnet20_jax")


@pytest.fixture(scope="module")
def runs():
    sizes = (2, 4)
    states, inputs, host0 = {}, {}, {}
    for n in sizes:
        states[n], (rp, rm, rs, rng) = _jax_resnet_workers(n)
        host0[n] = ((rp, rm, rs), rng)
        inputs[n] = {"resnet_params0": rp, "resnet_momentum0": rm,
                     "resnet_stats0": rs, "resnet_perms": _jax_resnet_perms(n)}
    with ThreadPoolExecutor(len(sizes)) as pool:
        groups = {n: pool.submit(launch.spawn, _rank_run, n, "gloo",
                                 (inputs[n],), 300) for n in sizes}
        jax32 = {n: _jax_resnet_tape(n, states[n]) for n in sizes}
        jax64 = {n: _jax_resnet_tape_f64(n, *host0[n]) for n in sizes}
        ranks = {n: g.result() for n, g in groups.items()}
    return {"ranks": ranks, "jax": jax32, "jax64": jax64}


@pytest.mark.parametrize("n", [2, 4])
def test_async_resnet20_tracks_the_jax_workers(runs, n):
    """Each worker's parameters, momentum and batch-norm statistics after
    two averagings and a step, against the JAX step's tiled state; the
    averaging is the only all-reduce."""
    want, want64 = runs["jax"][n], runs["jax64"][n]
    ranks = runs["ranks"][n]
    tape = ranks[0]["tape"]
    assert all(r["tape"] == tape for r in ranks)
    for got, ref, exact in zip(tape, want["tape"], want64["tape"]):
        assert abs(got - ref) <= 1e-5 * abs(ref) or \
            abs(got - exact) <= abs(ref - exact), (tape, want["tape"],
                                                   want64["tape"])
    for w, r in enumerate(ranks):
        assert r["all_reduces"] == STEPS // PERIOD
        for key in ("params", "momentum", "stats"):
            _against_jax(r[key], want[key], want64[key], w, key)


@pytest.mark.parametrize("n", [2, 4])
def test_async_resnet20_eval_average_tracks_jax(runs, n):
    """The eval's average of the parameters and statistics against JAX
    ``consolidate``, and each worker's own state back bit for bit."""
    want, want64 = runs["jax"][n]["average"], runs["jax64"][n]["average"]
    for r in runs["ranks"][n]:
        for k, got in enumerate(r["average"]):
            _against_jax(got, want[k], want64[k], None,
                         ("params", "stats")[k])
        assert r["after_average"]
