"""Chip smoke for the PyTorch/CUDA port: proves, on one CUDA card, that the
port builds, that each hand-written kernel agrees with its plain PyTorch
version, that config 3 (sync-SGD MNIST CNN) trains through all four
kernels, that the transformer LM (lm_base, 57,289,728 parameters)
trains through the cross-entropy and SGD kernels, that both train as
synchronous data parallelism over several ranks: two gloo ranks on the
one card, and an NCCL group over the visible cards, that configs 1,
4 and 5 (MNIST softmax; CIFAR-10 ResNet-20 with weight decay, the
on-device crop and flip and global-batch batch norm) train through
their trainers, that a run resumes from its checkpoint and stops on
SIGTERM with a save, that config 2 (async local SGD) trains on one
worker and on two, that every replication mode (bucketed all-reduce,
ZeRO-1, ZeRO-3, and async for a batch-norm model) trains on two ranks
within its collective budget, that a ZeRO-3 lm_base run writes
shard-redundant snapshots that survive a lost or corrupt rank directory
and restore onto another width, that lm_base serves with its
parameters left sharded over two ranks, that config 3 trains from the
host-fed input path (``--device_data off``: the native loader, pinned
uploads, the LUT dequants) and with the split sharded over two ranks,
that ResNet-20 trains with each block rematerialized, and that every
run's telemetry (tfevents, the profiler window, ``health.json``) is
written.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``distributedtensorflowexample_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build time;
3. each kernel against its plain version on the card at the main path's
   shapes (B=64, the bench's B=256, for dequant the eval's B=1000, and
   for cross-entropy config 4's [128, 10] and the LM head's [2048, 250]
   as well; dequant also at config 4's three-channel [128, 32, 32, 3] and
   its eval's [1000, 32, 32, 3] over a 50,000-row split): dequant bitwise,
   cross-entropy forward and backward within 1e-5 absolute (float32
   summation order), SGD within 1 ulp (the plain version's float64 route
   can double-round) over config 3's 3,274,634 parameters and lm_base's
   57,289,728; one JSON line with the card's launch floor, then one per
   kernel and shape with the kernel's, the plain version's and the
   comparable PyTorch library call's times and the kernel's bound;
4. 5 training steps on the card against the same 5 steps on the CPU
   (plain versions) from one init and one index tape, for config 3, for
   lm_small and for ResNet-20 at B=128 (config 4's update, one tape of
   augment draws): loss tapes within 2e-2 relative (all bf16; cuDNN,
   cuBLAS and the CPU round at different places);
5. config 3's main path: ``trainer_sync_mnist.main`` on ``cuda`` at full
   width with ``--dequant_impl pallas --pallas_ce --fused_optimizer``,
   launch counters set to 0 just before and read just after; every
   kernel must have launched the count the steps imply, the loss must be
   finite and fall, and ``final_accuracy`` must be printed;
6. the LM's main path: ``trainer_lm.main`` at ``--size lm_base`` on
   ``cuda`` with ``--pallas_ce true --fused_optimizer true
   --learning_rate 0.02``, counters set to 0 just before and read just
   after: ``ce_fwd``, ``ce_bwd`` and ``sgd`` once per step, ``dequant``
   never; a finite, falling loss and a per-token ``final_accuracy`` of at
   least 0.5 (the corpus's bigram ceiling is ~0.85; uniform guessing
   scores 0.004); its final checkpoint (``--checkpoint_every 600``) is
   what phase S serves; then one ``lm_main_path`` JSON line;
A. two ranks on the one card over gloo (``parallel/launch.spawn``: two
   processes, a gloo group over a file store in a temporary directory,
   both ranks on ``cuda:0``; gloo reduces the CUDA tensors through host
   memory): ``trainer_sync_mnist.main`` at full width, ``--batch_size 64``
   per rank (global 128), the three kernel flags, 300 steps, counters set
   to 0 in each rank just before and read just after.  Each rank must
   have launched every kernel once per step (dequant also once per eval
   batch), run one gradient all-reduce per step, end with parameters
   bitwise equal to the other rank's (sha256 of ``params_flat``) and a
   ``final_accuracy`` of at least 0.9; then one ``multirank_path`` JSON
   line with steps/s and the host-staged all-reduce time of the flat
   3,274,634-element gradient;
B. in the same two ranks first: 5 steps of config 3 on the card against
   5 steps of the same two gloo ranks on the CPU (plain versions), one
   init and one index tape: global loss tapes within 2e-2 relative, the
   bound of phase 4;
C. config 3 through an NCCL group of the largest power of two of
   ``min(device_count, 4)`` ranks for 50 steps (one rank on a one-card machine, which still runs the NCCL
   all-reduce on the card): with one rank the parameters must be bitwise
   those of the same 50 steps with no process group (both with cuDNN's
   deterministic algorithms); with two or more, phase A's cross-rank
   checks;
D. in the same two gloo ranks last: first 3 steps of lm_base at B=16
   per rank against the same 3 steps of one rank at B=32 with no group,
   from one init and one index tape (global loss tapes within 2e-2
   relative, the bound of phase 4; the first update within 8e-2 of its
   largest element, ``tests/test_torch_slice.py``'s bf16 bound: a wrong
   share of the gradient, e.g. a missing 1/N, is off by 100%); then
   ``trainer_lm.main`` at lm_base, 20 steps at lr 0.02 with the CE and
   SGD kernels (B=16 per rank): a finite, falling loss, bitwise-equal
   parameters across the ranks, ``ce_fwd``, ``ce_bwd`` and ``sgd`` once
   per step in each rank; each step all-reduces the 57,289,728-element
   gradient;
E. config 4's main path: ``trainer_mirrored_cifar.main`` on ``cuda`` at
   full width (ResNet-20, 272,474 parameters, synthetic CIFAR-10: 50,000
   train rows resident as uint8) with ``--dequant_impl pallas
   --pallas_ce true``, 600 steps at B=128, counters set to 0 just before
   and read just after: dequant once per step and per eval batch (610),
   ``ce_fwd`` = ``ce_bwd`` = 600, ``sgd`` never (weight decay rules the
   fused apply out); the loss logged at step 100 above the one at step
   600, all finite, and a final accuracy above 0.2 (chance is 0.1);
   then one ``cifar_main_path`` JSON line;
F. in two gloo ranks on the one card: config 4 for 50 steps at B=128
   per rank: every rank 43 all-reduces a step (21 batch-norm layers, one
   forward and one backward each, plus the flat gradient), parameters
   and batch-norm buffers bitwise equal across the ranks, the launch
   counts of phase E per step; then one ``multirank_cifar_path`` line;
G. config 1: ``trainer_local_mnist.main`` on ``cuda`` with its defaults
   (1000 steps at B=100, lr 0.5, no kernel flag, so no kernel launches);
   a finite, falling loss and a final accuracy of at least 0.9;
H. config 5: ``trainer_multiworker_cifar.main`` as one NCCL process,
   started with the cluster flags (``--worker_hosts``, ``--task_index``)
   inside a one-rank NCCL group, 50 steps: a host-name exchange places
   the rank, one gradient all-reduce a step and none for batch norm (one
   rank), phase E's launches per step;
K. config 2's main path: ``trainer_ps_mnist.main`` on ``cuda`` at full
   width (``MnistCNN``, 3,274,634 parameters) with ``--dequant_impl
   pallas --pallas_ce true``, 600 steps at B=64: dequant once per step
   and per eval batch, ``ce_fwd`` = ``ce_bwd`` = 600, ``sgd`` never (the
   fused apply is refused in async mode); a finite, falling loss and a
   final accuracy of at least 0.9.  In the two gloo ranks of phases A-F
   last: 296 steps of two workers at ``--async_period 8`` (a multiple of
   8, so the two workers end bitwise equal), 37 parameter all-reduces
   and no gradient all-reduce per rank, the same launches per step; then
   one ``async_path`` JSON line;
I. checkpoints on the card: config 3 with all four kernels for 200 steps
   twice, and for 100 steps then resumed to 200 in the same
   ``--log_dir`` (``--checkpoint_every 100``, cuDNN's deterministic
   algorithms): the parameters of the final checkpoints compared (the
   resumed run bitwise equal to the uninterrupted ones if those two are
   bitwise equal, else within twice their gap), the launches of every
   run, the save (blocking and background write) and restore wall
   times; one ``resume_path`` JSON line;
J. the SIGTERM drill on the card: ``trainer_sync_mnist`` in a process of
   its own on ``cuda`` with the four kernels, SIGTERM after its first log
   line: exit code 143 and ``SIGTERM at step N: checkpoint saved``, then
   a restart in the same ``--log_dir`` resumes from N and ends with code
   0; then the same for two gloo ranks on the one card started through
   ``parallel/launch.spawn`` (the launcher ``--num_devices N`` uses),
   which forwards the signal to both ranks; one ``sigterm_drill`` line;
L. the replication modes on the two gloo ranks, under cuDNN's
   deterministic algorithms: config 3 (``trainer_sync_mnist``, B=64 per
   rank, the dequant and CE kernels, plain momentum SGD: the fused apply
   is refused with the bucket knobs, as in JAX) for 50 steps in each of
   ``sync_dp``, ``bucketed`` (``--bucket_grads auto``: B=3), ``zero1``
   and ``zero3``: per rank the launches of phase E per step and eval
   batch, the gradient and parameter collectives per step equal to the
   mode's budget (``engine/spec.MODES``: sync_dp one all-reduce, bucketed
   B all-reduces, zero1 and zero3 B reduce-scatters and B all-gathers),
   the replicas bitwise equal, and the four modes' loss tapes and final
   parameters bitwise equal (two-operand sums commute); then one
   ``modes_path`` line with steps/s per mode and the host-staged ms per
   collective of each kind at 3,274,634 float32;
M. lm_base at full width on the two gloo ranks (B=16 x T=128 per rank,
   ``--remat block``, lr 0.02, the CE pair), 10 steps in each of
   ``sync_dp``, ``bucketed`` (auto), ``zero1`` and ``zero3`` with the
   gathers overlapped and serial: the loss tapes within 1e-5 relative of
   ``sync_dp``'s, the budgets per step, B per mode, each rank's
   ``torch.cuda.memory_allocated`` by its state after init (and the
   state's own tensor bytes) and its peak over the steps
   (``torch.cuda.max_memory_allocated``, both above what was allocated
   before the state), against sync_dp's, steps/s over the last 9
   steps; then one ``lm_modes_path`` line (and the ms per collective at
   57,289,728 float32);
N. config 4's ResNet-20 in async mode on the two gloo ranks (B=128 per
   worker, period 8, the crop and flip, dequant and CE kernels), 40
   steps: the workers' parameters bitwise equal after each averaging and
   only then, each worker's batch-norm statistics its own at every step,
   one all-reduce per period and none for batch norm; one
   ``async_bn_path`` line;
I'. resume in ``zero3_rows`` on the two gloo ranks: config 3 under
   ``--bucket_grads auto --shard_params true`` for 40 steps, and for 20
   then resumed to 40 (``--checkpoint_every 20``): each rank's final
   part (its parameter and momentum rows) bitwise equal; one
   ``zero3_resume_path`` line;
S. serving lm_base at full width: phase 6's final checkpoint written
   once through ``resilience/snapshot.SnapshotStore``, promoted
   (``serving/promote.promote``) and served by ``serve_lm.main`` on
   ``cuda`` with 8 slots of 128 cache rows (2 x 8 x 8 x 128 x 12 x 64 x
   2 B = 25,165,824 B of caches), a closed-loop drive of 64 requests
   from 8 clients, 32 tokens each, counters set to 0 just before and
   read just after (no kernel of this slice's path: all 0).  Checks, each
   fatal: (a) all 64 answered with 32 tokens; (b) one teacher-forced
   training forward per request agrees with the served tokens wherever
   its top-2 logit gap exceeds ``SERVE_TAU``; (c) a request admitted
   mid-decode, and a batched prefill of 3, bitwise equal to solo runs;
   (d) ``DECODE_CONTRACT`` over 100 decode steps (cache storage fixed,
   ``memory_allocated`` flat); (e) the engine on the card against the
   engine on the CPU at lm_small, 4 prompts x 8 tokens, logits within
   3e-2; (f) a self-drafted speculative run (k=4) equals the plain run
   where the gap exceeds ``SERVE_TAU``; (g) two sampled runs
   (temperature 0.8, top-k 20) give identical tokens; (h) ``serve_lm``
   as a subprocess, SIGTERM after its ``--ready_file`` appears: exit 143,
   every admitted request answered, the queued tail ``drained``.  Then
   one ``serving_path`` line: tokens/s, p50/p99 latency, prefill ms by
   bucket, decode ms a step, launches a decode step and the device-busy
   share over decode steps (``torch.profiler``), cache bytes, load time,
   the positions inside ``SERVE_TAU``;
O. (after I', before S) shard-redundant snapshots at lm_base, full
   width, on the two gloo ranks: ``trainer_lm`` under ``--bucket_grads
   auto --shard_params true`` (B=66 buckets), B=16 x T=128 a rank,
   ``--remat block``, lr 0.02, the CE pair, with ``SNAPSHOT_DIR``, a set
   (and a checkpoint) every 5 steps to step 10, keep 2; twice, and a copy
   of the first run's step-5 set resumed to step 10.  Checks, each fatal:
   (a) both sets quorum-valid, each rank directory holding ``own``, one
   mirror and ``repl``; (b) rank 1's directory dropped: the restore at
   D=2 reconstructs shard 1 and is bitwise the intact restore (sha256 of
   the gathered parameters and momentum); (c) one byte of rank 0's
   ``own.npz`` flipped: refused by sha256, rebuilt from its mirror,
   bitwise; (d) shard 0's own copy and its mirror dropped: ``ModeRefusal``
   naming "exceeds redundancy R=2"; (e) the D=2 set restored on four gloo
   ranks, saved there as a D=4 set, and that restored on two (after S,
   in phase P's group): bitwise; (f) the resumed step-10 shards bitwise the straight
   run's if the two straight runs are bitwise equal, else within twice
   their gap; (g) the collectives a step the zero3 budget with the hook
   on; (h) ``ce_fwd`` = ``ce_bwd`` = 1 launch a step on each rank,
   ``dequant`` = ``sgd`` = 0.  One ``shard_snapshot_path`` line: save
   blocking ms, bytes a rank, restore ms at the same width and elastic,
   the reconstructions (host-staged gloo numbers);
P. params-stay-sharded serving at lm_base, full width: phase S's tree
   snapshot promoted into 1/2 rows a rank (``promote_sharded``) and
   served by ``serve_lm --sharded_mesh 2`` (two gloo ranks on the card)
   with 8 slots of 128 rows (4 a rank), 16 requests of 4-12-token prompts
   from 4 closed-loop clients, 16 tokens each.  Checks, each fatal: (a)
   all 16 answered; (b) each request's tokens bitwise a replicated engine
   of 4 slots fed its prompt; (c) equal to an 8-slot engine up to the
   first position whose top-2 gap is at most ``SERVE_TAU``; (d)
   ``params_residency`` 1/2 a rank (114,579,456 of 229,158,912 bytes plus
   padding) and ``memory_allocated`` after promotion below the full
   float32 tree plus the caches; (e) ``SHARDED_DECODE_CONTRACT`` over 20
   decode steps (B all-gathers, one command broadcast and one token
   gather a step, storage fixed, memory flat); (f) ``--slots 7``,
   sampling and speculation refused by name; (g) SIGTERM to the sharded
   ``serve_lm``: 143, both ranks report 143, every admitted request
   answered.  Launch counters 0 in both ranks.  One
   ``sharded_serving_path`` line: tokens/s, p50/p99, decode ms a step,
   bytes gathered a step, ms an all-gather, residency a rank;
Q. (after J) the host-fed input path: the native loader built
   (``native.available()``) and its ``gather`` and ``gather_augment``
   bitwise numpy's on the synthetic MNIST split (uint8 and float32);
   ``trainer_sync_mnist`` with ``--device_data off --pallas_ce true
   --fused_optimizer true``, 200 steps at B=64 and one eval: ``ce_fwd``
   = ``ce_bwd`` = ``sgd`` = 200, ``dequant`` 0, a finite and falling
   loss, 64 x 784 uint8 + 64 int32 labels = 50,432 bytes uploaded a
   step; then, under cuDNN's deterministic algorithms, 20 steps each with
   ``--dequant_impl affine``, ``onehot`` and ``lut`` (losses bitwise
   equal), and 20 steps through ``Engine.build_host_fed`` with the
   prefetcher's pinned, stream-ordered uploads against the same steps fed
   by synchronous copies, the host never waiting on the card (losses
   bitwise equal); one ``host_fed_path`` line: steps/s, bytes a step;
R. config 4 with ``--remat block`` against ``--remat none``, 50 steps
   each from one seed under cuDNN's deterministic algorithms (one
   synthetic split for both runs): the final parameters and batch-norm
   running statistics bitwise equal (else within the 2e-2 relative bound
   of phase 4, and the line says which); ``dequant`` 50 + the eval
   batches, ``ce_fwd`` = ``ce_bwd`` = 50, ``sgd`` 0 in each run; the
   peak ``max_memory_allocated`` of each run, and of 3 train steps
   through ``Engine.build`` above the state and the split (the run's
   peak is the eval's batch of 1000); one ``remat_path`` line;
SH. (in phase L's two gloo ranks, last) config 3 with ``--data_sharding
   sharded --pallas_ce true --fused_optimizer true``, 20 steps at B=64 a
   rank: each rank's resident split is 30,000 of the 60,000 rows,
   ``ce_fwd`` = ``ce_bwd`` = ``sgd`` = 20 and ``dequant`` 0 a rank, the
   replicas bitwise equal, a finite and falling loss; one
   ``sharded_data_path`` line;
T. telemetry: config 3 with the four kernels, 60 steps, with
   ``--log_dir``, ``--profile_dir`` (steps 21-30) and ``OBS_HEALTH``:
   ``utils/tfevents.read_events`` reads back the steps and values of
   ``scalars.jsonl`` (as float32), the rank-0 Chrome trace holds CUDA
   kernel events inside its ``ProfilerStep`` window, ``health.json`` is
   written, and ``AnomalyHook`` fired nothing; one ``telemetry_path``
   line;
7. the ``kernels`` JSON line (each kernel's launches summed over every
   path and rank, and per path: per rank for the multi-rank paths, per
   run for phase I), then the ``ok`` line last.

Times come from ``utils/kernel_timing.py``, by CUDA events after a
warm-up, each launch on fresh indices (dequant) or buffers (SGD) where
the caller would find them cold in L2: ``kernel_ms``, ``plain_ms`` and
``library_ms`` are means of back-to-back calls from Python (for a kernel
shorter than its wrapper, the host's cost per call); ``kernel_device_us``
and ``library_device_us`` replay the same calls from a CUDA graph (device
time per call, the host out of the way); ``floor_device_us`` is a
1-element ``zero_()`` timed that way, the card's launch floor.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s memory, 67 TFLOP/s
float32 outside the tensor cores.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributedtensorflowexample_tpu_torch.ops import kernels
from distributedtensorflowexample_tpu_torch.ops.kernels import build as kbuild
from distributedtensorflowexample_tpu_torch.ops.kernels import (
    cross_entropy as ce, dequant as dq, sgd)
from distributedtensorflowexample_tpu_torch.parallel import launch
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    Mesh, make_mesh)
from distributedtensorflowexample_tpu_torch.utils import kernel_timing as kt

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROOT = Path(__file__).resolve().parent
TRAIN_STEPS = 600
BATCH = 64
LM_SIZE = "lm_base"
LM_STEPS = 600
LM_BATCH = 16
# trainer_lm's default lr 0.1 spikes lm_base's loss above 10 nats before
# it settles near uniform; at 0.02 the 600 steps learn the chain.
LM_LR = 0.02
LM_MIN_ACCURACY = 0.5
MR_RANKS = 2                # phases A, B, D: gloo ranks on the one card
MR_STEPS = 300
MR_LM_STEPS = 20
MR_LM_REF_STEPS = 3         # phase D's reference: 2 ranks against 1
NCCL_STEPS = 50
CIFAR_STEPS = 600
CIFAR_BATCH = 128
CIFAR_MIN_ACCURACY = 0.2
MR_CIFAR_STEPS = 50
BN_LAYERS = 21              # ResNet-20's batch-norm layers
ASYNC_STEPS = 600           # phase K, one worker
MR_ASYNC_STEPS = 296        # phase K, two workers: a multiple of the period
ASYNC_PERIOD = 8
RESUME_STEPS = 200          # phase I: 100 steps, then resumed to 200
MODE_STEPS = 50             # phase L, each mode
MODE_LM_STEPS = 10          # phase M, each mode
ASYNC_BN_STEPS = 40         # phase N
HOST_STEPS = 200            # phase Q: host-fed config 3
HOST_CMP_STEPS = 20         # phase Q: the dequants and the copies compared
REMAT_STEPS = 50            # phase R
REMAT_PEAK_STEPS = 3        # phase R: the steps whose peak is read
SHARDED_DATA_STEPS = 20     # phase SH
TELEMETRY_STEPS = 60        # phase T
Z3_RESUME_STEPS = 40        # phase I': 20 steps, then resumed to 40
#: The replication modes' flags (phase L; lm_base takes --bucket_grads
#: auto by default, so its sync_dp turns it off).
MODE_FLAGS = {"sync_dp": [], "bucketed": ["--bucket_grads", "auto"],
              "zero1": ["--bucket_grads", "auto", "--shard_update", "true"],
              "zero3": ["--bucket_grads", "auto", "--shard_params", "true"]}
LM_MODE_FLAGS = {"sync_dp": ["--bucket_grads", ""], "bucketed": [],
                 "zero1": ["--shard_update", "true"],
                 "zero3": ["--shard_params", "true"],
                 "zero3_serial": ["--shard_params", "true",
                                  "--zero3_overlap", "false"]}
CNN_PARAMS = 3_274_634
LM_PARAMS = 57_289_728
SERVE_SLOTS = 8             # phase S: decode slots
SERVE_CACHE = 128           # phase S: cache rows a slot
SERVE_REQUESTS = 64
SERVE_CLIENTS = 8
SERVE_NEW = 32              # tokens a request
SERVE_CPU_SIZE = "lm_small"  # phase S (e): the engine on the card vs the CPU
#: Phase S's top-2 logit gap at or below which a served token may differ
#: from the teacher-forced forward's argmax: the two run products of other
#: row counts, which cuBLAS may compute with other kernels and roundings.
#: A token can differ only where the gap is at most twice the largest
#: logit difference between the two; on an H100 that difference measured
#: 0.0625 (one bf16 ulp of a logit in [8, 16), ``max_abs_logit_err`` in
#: the ``serving_path`` line), and the tolerance doubles that bound.
SERVE_TAU = 0.25
SOURCES = {
    "dequant": ("distributedtensorflowexample_tpu_torch/csrc/dequant.cu",
                "distributedtensorflowexample_tpu/ops/pallas/dequant.py:35"),
    "ce_fwd": ("distributedtensorflowexample_tpu_torch/csrc/cross_entropy.cu",
               "distributedtensorflowexample_tpu/ops/pallas/cross_entropy.py:36"),
    "ce_bwd": ("distributedtensorflowexample_tpu_torch/csrc/cross_entropy.cu",
               "distributedtensorflowexample_tpu/ops/pallas/cross_entropy.py:57"),
    "sgd": ("distributedtensorflowexample_tpu_torch/csrc/sgd.cu",
            "distributedtensorflowexample_tpu/ops/pallas/sgd.py:52"),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def time_ms(fn, iters: int) -> float:
    """Mean host milliseconds per call of ``fn(i)``, back to back."""
    return kt.host_us(fn, iters) / 1e3


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def check_dequant(batch: int, gen: torch.Generator, iters: int,
                  shape: tuple = (28, 28, 1), rows: int = 60000,
                  spec: str = "unit") -> dict:
    images, idx, s, b = kt.dequant_inputs(batch, iters + 5, gen, shape,
                                          rows, spec)
    got = dq.fused_gather_dequant(images, idx[0], s, b)
    want = dq.gather_dequant_plain(images, idx[0], s, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            f"dequant [{batch}, {shape}] is not bitwise equal to its plain "
            f"version")
    row = int(np.prod(shape))
    nbytes = batch * row * (1 + 4) + batch * 4 + 2 * 4 * s.numel()
    b_ms, b_by = bound(nbytes, 2 * batch * row)
    kern = lambda i: dq.fused_gather_dequant(images, idx[i], s, b)
    lib = lambda i: torch.addcmul(b, images[idx[i]].float(), s)
    return {"max_abs_err": err, "ms": time_ms(kern, iters),
            "plain_ms": time_ms(lambda i: dq.gather_dequant_plain(
                images, idx[i], s, b), iters),
            "library_ms": time_ms(lib, iters),
            "kernel_device_us": kt.device_us(kern),
            "library_device_us": kt.device_us(lib),
            "bound_ms": b_ms, "bound_by": b_by}


def check_ce(batch: int, classes: int, gen: torch.Generator,
             iters: int) -> tuple[dict, dict]:
    logits, labels, g = kt.ce_inputs(batch, classes, gen)
    out = {}
    for s in (0.0, 0.1):
        fwd = (ce.ce_fwd(logits, labels, s)
               - ce.ce_fwd_plain(logits, labels, s)).abs().max().item()
        bwd = (ce.ce_bwd(logits, labels, g, s)
               - ce.ce_bwd_plain(logits, labels, g, s)).abs().max().item()
        torch.cuda.synchronize()
        require(fwd <= 1e-5 and bwd <= 1e-5,
                f"cross-entropy [{batch}, {classes}] s={s}: |fwd| {fwd}, "
                f"|bwd| {bwd} exceed 1e-5")
        out[s] = (fwd, bwd)
    labels64 = labels.long()
    lib_fwd = lambda i: F.cross_entropy(logits, labels64, reduction="none")
    lib_bwd, lib_forward = kt.ce_library_backward(logits, labels64, g)
    kern_fwd = lambda i: ce.ce_fwd(logits, labels)
    kern_bwd = lambda i: ce.ce_bwd(logits, labels, g)
    n_in = batch * classes
    fb_ms, fb_by = bound(n_in * 4 + batch * 4 + batch * 4, 6 * n_in)
    bb_ms, bb_by = bound(n_in * 4 + batch * 8 + n_in * 4, 11 * n_in)
    fwd = {"max_abs_err": max(v[0] for v in out.values()),
           "ms": time_ms(kern_fwd, iters),
           "plain_ms": time_ms(lambda i: ce.ce_fwd_plain(logits, labels),
                               iters),
           "library_ms": time_ms(lib_fwd, iters),
           "kernel_device_us": kt.device_us(kern_fwd),
           "library_device_us": kt.device_us(lib_fwd),
           "bound_ms": fb_ms, "bound_by": fb_by}
    bwd = {"max_abs_err": max(v[1] for v in out.values()),
           "ms": time_ms(kern_bwd, iters),
           "plain_ms": time_ms(lambda i: ce.ce_bwd_plain(logits, labels, g),
                               iters),
           "library_ms": time_ms(lib_bwd, iters),
           "kernel_device_us": kt.device_us(kern_bwd),
           "library_device_us": kt.device_us(lib_bwd, prepare=lib_forward),
           "bound_ms": bb_ms, "bound_by": bb_by}
    return fwd, bwd


def param_shapes(name: str) -> list[torch.Size]:
    """The parameter shapes of a registered model, on the meta device."""
    from distributedtensorflowexample_tpu_torch.models import build_model
    with torch.device("meta"):
        return [p.shape for p in build_model(name).parameters()]


def check_sgd(gen: torch.Generator, iters: int, model: str) -> dict:
    dev = torch.device("cuda")
    shapes = param_shapes(model)
    n = sum(s.numel() for s in shapes)
    lr, mu = 0.05, 0.9
    # Three (p, m, g) sets (3 x 39 MB of inputs for config 3), used in
    # turn: each timed launch finds its buffers out of the 50 MB L2, as
    # one apply per training step does after the forward and backward
    # passes.
    sets = [[torch.randn(n, device=dev, generator=gen) for _ in range(3)]
            for _ in range(3)]
    p, m, g = sets[0]
    pk, mk = p.clone(), m.clone()
    sgd.fused_sgd_apply(pk, mk, g, lr, mu)
    pp, mp = p.clone(), m.clone()
    sgd.sgd_plain(pp, mp, g, lr, mu)
    torch.cuda.synchronize()
    dp, dm = ulps(pk, pp), ulps(mk, mp)
    require(int(dp.max()) <= 1 and int(dm.max()) <= 1,
            f"sgd differs from its plain version by more than 1 ulp "
            f"(p {int(dp.max())}, m {int(dm.max())})")
    offs = np.cumsum([0] + [s.numel() for s in shapes])
    views = lambda t: [t[a:b] for a, b in zip(offs[:-1], offs[1:])]
    per_layer = [[views(t) for t in st] for st in sets]

    def foreach(i):
        ps, ms, gs = per_layer[i % 3]
        torch._foreach_mul_(ms, mu)
        torch._foreach_add_(ms, gs)
        torch._foreach_add_(ps, ms, alpha=-lr)

    kern = lambda i: sgd.fused_sgd_apply(*sets[i % 3], lr, mu)
    b_ms, b_by = bound(20 * n, 4 * n)
    return {"n": n, "max_abs_err": max((pk - pp).abs().max().item(),
                                       (mk - mp).abs().max().item()),
            "ulp_mismatches": int((dp > 0).sum() + (dm > 0).sum()),
            "ms": time_ms(kern, iters),
            "plain_ms": time_ms(lambda i: sgd.sgd_plain(
                *sets[i % 3], lr, mu), iters),
            "library_ms": time_ms(foreach, iters),
            "kernel_device_us": kt.device_us(kern, calls=12, replays=5),
            "library_device_us": kt.device_us(foreach, calls=12, replays=5),
            "bound_ms": b_ms, "bound_by": b_by}


def check_card_against_cpu(model: str) -> dict:
    """5 steps with the kernels on the card against the same 5 steps with
    the plain versions on the CPU, from one init and one index tape:
    config 3 (``mnist_cnn``) at B=8, the LM (``lm_small``) at B=16 with
    ``--remat block``, as lm_base's main path runs it, or ResNet-20 at
    config 4's B=128 with its update (weight decay, no fused SGD) and
    one tape of crop and flip draws."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    fused, augment, draws_fn = ["--fused_optimizer", "true"], False, None
    rows = 256
    if model == "mnist_cnn":
        from distributedtensorflowexample_tpu_torch.data.synthetic import (
            make_synthetic)
        x, y = make_synthetic(rows, (28, 28, 1), 10, seed=0, sample_seed=1)
        dataset, flags = "mnist", ["--learning_rate", "0.05",
                                   "--batch_size", "8",
                                   "--dequant_impl", "pallas"]
    elif model == "resnet20":
        from distributedtensorflowexample_tpu_torch.data.cifar10 import (
            load_cifar10)
        x, y = load_cifar10("", "train", synthetic_size=rows,
                            source="synthetic")
        dataset, flags = "cifar10", ["--learning_rate", "0.1",
                                     "--weight_decay", "1e-4",
                                     "--batch_size", str(CIFAR_BATCH),
                                     "--dequant_impl", "pallas"]
        fused, augment = [], True
        rs = np.random.RandomState(1)
        draws = [(rs.randint(0, 9, CIFAR_BATCH), rs.randint(0, 9, CIFAR_BATCH),
                  rs.rand(CIFAR_BATCH) < 0.5) for _ in range(5)]
        draws_fn = draws.__getitem__
    else:
        from distributedtensorflowexample_tpu_torch.data.lm import load_lm
        x, y = load_lm("", "train", num=rows)
        dataset, flags = "lm", ["--learning_rate", "0.1",
                                "--batch_size", str(LM_BATCH),
                                "--remat", "block"]
    perm = np.random.RandomState(0).permutation(rows)
    cfg = parse_flags(fused + ["--momentum", "0.9", "--dropout", "0",
                               "--pallas_ce", "true"] + flags)
    tapes = {}
    for name in ("cuda", "cpu"):
        built = Engine(RunSpec(model, dataset, cfg, augment=augment)).build(
            Mesh(torch.device(name)), data=(x, y), perm_fn=lambda e: perm,
            draws_fn=draws_fn)
        tapes[name] = [float(built.step(built.state, next(built.ds))[1]
                             ["loss"]) for _ in range(5)]
    a, b = np.array(tapes["cuda"]), np.array(tapes["cpu"])
    require(np.all(np.isfinite(a)), f"{model}: card loss tape not finite: "
                                    f"{a}")
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    require(rel <= 2e-2, f"{model}: card vs CPU loss tapes differ by "
                         f"{rel:.3g} relative (cuda {a}, cpu {b})")
    return {"model": model, "cuda": tapes["cuda"], "cpu": tapes["cpu"],
            "max_rel": rel}


def check_loss_tape(summary: dict, text: str) -> None:
    losses = [l for _, l in summary["loss_tape"]]
    require(len(losses) >= 2 and all(np.isfinite(losses))
            and losses[-1] < losses[0], f"loss tape {losses}")
    require("final_accuracy=" in text, "no final_accuracy line")


def run_main_path(gpu: str) -> tuple[dict, dict]:
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    log_dir = ROOT / "build" / "chip_smoke"
    argv = ["--device", "cuda", "--dataset", "synthetic",
            "--dequant_impl", "pallas", "--pallas_ce", "true",
            "--fused_optimizer", "true", "--train_steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--log_every", "100",
            "--resume", "false", "--log_dir", str(log_dir)]
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = trainer_sync_mnist.main(argv)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    text = out.getvalue()
    print(text, end="")
    steps, evals = summary["steps"], summary["eval_batches"]
    expect = {"dequant": steps + evals, "ce_fwd": steps, "ce_bwd": steps,
              "sgd": steps}
    require(steps == TRAIN_STEPS, f"trained {steps} of {TRAIN_STEPS} steps")
    require(counts == expect, f"launch counts {counts}, expected {expect} "
                              f"(one of each per step, plus one dequant "
                              f"per eval batch)")
    check_loss_tape(summary, text)
    require(summary["final_accuracy"] >= 0.9,
            f"final accuracy {summary['final_accuracy']}")
    result = {"steps": steps, "batch": BATCH,
              "steps_per_call": summary["steps_per_call"],
              "steps_per_sec": summary["steps_per_sec"],
              "wall_s_incl_setup_and_eval": wall,
              "final_accuracy": summary["final_accuracy"],
              "loss_tape": summary["loss_tape"], "launches": counts,
              "gpu": gpu}
    return result, counts


LM_LOG_DIR = ROOT / "build" / "chip_smoke_lm"
LM_ARGV = ["--device", "cuda", "--size", LM_SIZE, "--pallas_ce", "true",
           "--fused_optimizer", "true", "--bucket_grads", "",
           "--learning_rate", str(LM_LR),
           "--train_steps", str(LM_STEPS), "--log_every", "100",
           "--checkpoint_every", str(LM_STEPS), "--resume", "false",
           "--log_dir", str(LM_LOG_DIR)]


def run_lm_main_path(gpu: str) -> tuple[dict, dict]:
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    argv = LM_ARGV
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = trainer_lm.main(argv)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    text = out.getvalue()
    print(text, end="")
    steps = summary["steps"]
    expect = {"dequant": 0, "ce_fwd": steps, "ce_bwd": steps, "sgd": steps}
    require(steps == LM_STEPS, f"{LM_SIZE}: trained {steps} of {LM_STEPS} "
                               f"steps")
    require(counts == expect, f"{LM_SIZE}: launch counts {counts}, expected "
                              f"{expect} (CE forward, backward and SGD once "
                              f"per step; a token split never dequantizes)")
    check_loss_tape(summary, text)
    require(summary["final_accuracy"] >= LM_MIN_ACCURACY,
            f"{LM_SIZE}: per-token final accuracy "
            f"{summary['final_accuracy']} < {LM_MIN_ACCURACY}")
    result = {"model": LM_SIZE, "params": sum(
                  s.numel() for s in param_shapes(LM_SIZE)),
              "steps": steps, "batch": LM_BATCH, "seq_len": 128,
              "learning_rate": LM_LR,
              "steps_per_call": summary["steps_per_call"],
              "steps_per_sec": summary["steps_per_sec"],
              "tokens_per_sec": summary["steps_per_sec"] * LM_BATCH * 128,
              "wall_s_incl_setup_and_eval": wall,
              "final_accuracy": summary["final_accuracy"],
              "loss_tape": summary["loss_tape"], "launches": counts,
              "gpu": gpu}
    return result, counts


def cifar_argv(steps: int, log_dir: str, log_every: int = 100) -> list:
    """Config 4's trainer flags on the card: its defaults with the dequant
    and CE kernels (weight decay rules the SGD kernel out)."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--train_steps", str(steps),
            "--log_every", str(log_every), "--resume", "false",
            "--log_dir", str(ROOT / "build" / log_dir)]


def dequant_ce_expect(steps: int, evals: int) -> dict:
    """The launches of a path with the dequant and CE kernels but no fused
    SGD (config 4: weight decay; config 2: async mode)."""
    return {"dequant": steps + evals, "ce_fwd": steps, "ce_bwd": steps,
            "sgd": 0}


def run_cifar_main_path(gpu: str) -> tuple[dict, dict]:
    """Phase E: config 4 through ``trainer_mirrored_cifar``."""
    r = run_trainer("trainer_mirrored_cifar",
                    cifar_argv(CIFAR_STEPS, "chip_smoke_cifar"))
    print(r["text"], end="")
    steps, counts = r["steps"], r["launches"]
    require(steps == CIFAR_STEPS, f"config 4: trained {steps} of "
                                  f"{CIFAR_STEPS} steps")
    expect = dequant_ce_expect(steps, r["eval_batches"])
    require(counts == expect, f"config 4: launch counts {counts}, expected "
                              f"{expect} (dequant per step and eval batch, "
                              f"the CE pair per step, no fused SGD)")
    check_loss_tape(r, r["text"])
    require(r["final_accuracy"] > CIFAR_MIN_ACCURACY,
            f"config 4: final accuracy {r['final_accuracy']} <= "
            f"{CIFAR_MIN_ACCURACY}")
    result = {"model": "resnet20", "steps": steps, "batch": CIFAR_BATCH,
              "steps_per_call": r["steps_per_call"],
              "steps_per_sec": r["steps_per_sec"],
              "images_per_sec": r["steps_per_sec"] * CIFAR_BATCH,
              "wall_s_incl_setup_and_eval": r["wall_s_incl_setup_and_eval"],
              "final_accuracy": r["final_accuracy"],
              "loss_tape": r["loss_tape"], "launches": counts, "gpu": gpu}
    return result, counts


def run_local_mnist(gpu: str) -> dict:
    """Phase G: config 1 through ``trainer_local_mnist`` with its
    defaults; no kernel flag is set, so no kernel launches."""
    r = run_trainer("trainer_local_mnist", [
        "--device", "cuda", "--dataset", "synthetic", "--resume", "false",
        "--log_dir", str(ROOT / "build" / "chip_smoke_softmax")])
    print(r["text"], end="")
    require(r["steps"] == 1000 and r["global_batch"] == 100,
            f"config 1: {r['steps']} steps at B={r['global_batch']}")
    require(r["launches"] == {k: 0 for k in r["launches"]},
            f"config 1: launch counts {r['launches']}, expected none")
    check_loss_tape(r, r["text"])
    require(r["final_accuracy"] >= 0.9,
            f"config 1: final accuracy {r['final_accuracy']}")
    result = {"model": "softmax", "steps": r["steps"], "batch": 100,
              "steps_per_sec": r["steps_per_sec"],
              "final_accuracy": r["final_accuracy"],
              "loss_tape": r["loss_tape"], "launches": r["launches"],
              "gpu": gpu}
    print(json.dumps({"local_mnist_path": result}), flush=True)
    return r["launches"]


def run_trainer(trainer: str, argv: list) -> dict:
    """One trainer run in this process, its stdout captured: the launch
    counters set to 0 just before and read just after."""
    module = importlib.import_module(
        f"distributedtensorflowexample_tpu_torch.trainers.{trainer}")
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = module.main(argv)
    wall = time.perf_counter() - t0
    return dict(summary, launches=kernels.launch_counts(),
                text=out.getvalue(), wall_s_incl_setup_and_eval=wall)


def all_reduce_ms(numel: int, iters: int) -> float:
    """Host milliseconds per ``all_reduce`` of a float32 buffer of
    ``numel`` on this rank's card, back to back, synchronized."""
    buf = torch.zeros(numel, device="cuda")
    for _ in range(2):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def two_rank_card_vs_cpu() -> dict:
    """Phase B in one rank: config 3 at B=8 per rank for 5 steps on the
    card, then the same 5 steps on the CPU, both through this rank's
    group, from one init and one index tape; the global loss tapes."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.data.synthetic import (
        make_synthetic)
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    x, y = make_synthetic(256, (28, 28, 1), 10, seed=0, sample_seed=1)
    perm = np.random.RandomState(0).permutation(256)
    cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9",
                       "--dropout", "0", "--pallas_ce", "true",
                       "--learning_rate", "0.05", "--batch_size", "8",
                       "--dequant_impl", "pallas"])
    tapes = {}
    for name in ("cuda", "cpu"):
        mesh = make_mesh(name)
        built = Engine(RunSpec("mnist_cnn", "mnist", cfg)).build(
            mesh, data=(x, y), perm_fn=lambda e: perm)
        tapes[name] = [float(mesh.sum_metrics(
            built.step(built.state, next(built.ds))[1])["loss"])
            for _ in range(5)]
    return tapes


def two_rank_lm_vs_one_rank() -> dict:
    """Phase D's reference in one of the two gloo ranks: 3 steps of
    lm_base at B=16 per rank from one init and one index tape, then (rank
    0 only) the same 3 steps as one rank at B=32 with no group; the
    global loss tapes and the first step's update of the flat
    parameters."""
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    from distributedtensorflowexample_tpu_torch.data.lm import load_lm
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    x, y = load_lm("", "train", num=256)
    perm = np.random.RandomState(0).permutation(256)

    def run(mesh, batch):
        cfg = parse_flags(["--fused_optimizer", "true", "--momentum", "0.9",
                           "--dropout", "0", "--pallas_ce", "true",
                           "--remat", "block", "--learning_rate", str(LM_LR),
                           "--batch_size", str(batch)])
        built = Engine(RunSpec(LM_SIZE, "lm", cfg)).build(
            mesh, data=(x, y), perm_fn=lambda e: perm)
        flat = built.state.optimizer.params_flat
        start, tape = flat.clone(), []
        for i in range(MR_LM_REF_STEPS):
            metrics = built.step(built.state, next(built.ds))[1]
            tape.append(float(mesh.sum_metrics(metrics)["loss"]))
            if i == 0:
                update = flat - start
        return tape, update

    mesh = make_mesh("cuda")
    tape, update = run(mesh, LM_BATCH)
    out = {"tape": tape}
    if mesh.rank == 0:
        one_tape, one_update = run(Mesh(mesh.device), LM_BATCH * mesh.size)
        out.update(one_rank_tape=one_tape, update_rel=float(
            (update - one_update).abs().max() / one_update.abs().max()))
    return out


def gloo_rank_phases() -> dict:
    """Phases B, A, D and F in one of the two gloo ranks on ``cuda:0``."""
    out = {"card_vs_cpu": two_rank_card_vs_cpu()}
    out["mnist"] = run_trainer("trainer_sync_mnist", [
        "--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
        "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
        "--train_steps", str(MR_STEPS), "--batch_size", str(BATCH),
        "--log_every", "100", "--resume", "false",
        "--log_dir", str(ROOT / "build" / "chip_smoke_gloo")])
    out["mnist"]["all_reduce_ms"] = all_reduce_ms(CNN_PARAMS, 50)
    out["lm_vs_one_rank"] = two_rank_lm_vs_one_rank()
    out["lm"] = run_trainer("trainer_lm", [
        "--device", "cuda", "--size", LM_SIZE, "--pallas_ce", "true",
        "--fused_optimizer", "true", "--bucket_grads", "",
        "--learning_rate", str(LM_LR),
        "--train_steps", str(MR_LM_STEPS), "--log_every", "10",
        "--resume", "false",
        "--log_dir", str(ROOT / "build" / "chip_smoke_gloo_lm")])
    out["lm"]["all_reduce_ms"] = all_reduce_ms(LM_PARAMS, 10)
    out["cifar"] = run_trainer("trainer_mirrored_cifar", cifar_argv(
        MR_CIFAR_STEPS, "chip_smoke_gloo_cifar", log_every=10))
    out["async"] = run_trainer("trainer_ps_mnist", async_argv(
        MR_ASYNC_STEPS, "chip_smoke_gloo_async", log_every=74))
    return out


@contextlib.contextmanager
def deterministic_cudnn():
    held = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = held


def every_kind(budget: dict) -> dict:
    """A collective budget (``engine/spec.collective_budget``: the
    resolved mode's, B resolved) over every kind ``Mesh.collectives``
    counts, 0 where it has none."""
    from distributedtensorflowexample_tpu_torch.parallel.mesh import (
        COLLECTIVE_KINDS)
    return {k: float(budget.get(k, 0)) for k in COLLECTIVE_KINDS}


def mode_argv(mode: str, steps: int, log_dir: str, *extra) -> list:
    """Config 3 on the card with the dequant and CE kernels and plain
    momentum SGD, in ``mode``."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--train_steps", str(steps),
            "--batch_size", str(BATCH), "--log_every", "10",
            "--log_dir", str(ROOT / "build" / log_dir), *MODE_FLAGS[mode],
            *extra]


def lm_mode_runs(mesh) -> dict:
    """Phase M in one rank: lm_base in each mode of ``LM_MODE_FLAGS``
    through ``Engine.build`` (``trainer_lm``'s config), from one seed and
    one index tape: the tape, the state's device bytes after init, the
    peak bytes of the steps (both above what was allocated before the
    state was made), the collectives per step and the resolved mode's
    budget, steps/s, the launches."""
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        collective_budget)
    from distributedtensorflowexample_tpu_torch.data.lm import load_lm
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    x, y = load_lm("", "train", num=256)
    perm = np.random.RandomState(0).permutation(256)
    out = {}
    for mode, flags in LM_MODE_FLAGS.items():
        size, cfg = trainer_lm.build_config([
            "--size", LM_SIZE, "--device", "cuda", "--pallas_ce", "true",
            "--learning_rate", str(LM_LR), "--batch_size", str(LM_BATCH),
            *flags])
        engine = Engine(RunSpec(size, "lm", cfg))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state, layout = engine.laid_out_state(mesh)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - before
        built = engine.build(mesh, data=(x, y), state=state,
                             zero3_layout=layout, perm_fn=lambda e: perm)
        kernels.reset_launch_counts()
        counted = dict(mesh.collectives)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tape = []
        for i in range(MODE_LM_STEPS):
            if i == 1:              # the first step warms the card up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            metrics = built.step(built.state, next(built.ds))[1]
            tape.append(float(mesh.sum_metrics(metrics)["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        opt = state.optimizer
        buckets = None if built.plan is None else built.plan.num_buckets
        tensors = [opt.params_flat, opt.grads_flat, opt.momentum_flat,
                   *(opt.params_rows or ()), *(opt.momentum_rows or ())]
        out[mode] = {
            "tape": tape, "state_bytes_after_init": resident,
            "peak_bytes_in_steps": peak - before,
            "state_tensor_bytes": sum(t.numel() * t.element_size()
                                      for t in tensors if t is not None),
            "steps_per_sec": (MODE_LM_STEPS - 1) / wall,
            "num_buckets": buckets,
            "budget": every_kind(collective_budget(cfg, mesh.size, buckets)),
            "collectives": {k: (mesh.collectives[k] - counted[k])
                            / MODE_LM_STEPS for k in counted},
            "launches": kernels.launch_counts(), "mode": built.mode}
        del state, built, layout, opt, tensors
    return out


def async_bn_run(mesh) -> dict:
    """Phase N in one rank: config 4 in async mode through
    ``Engine.build`` (``trainer_mirrored_cifar``'s config): this worker's
    parameter and statistics digests after every step, the launches and
    the all-reduces."""
    import hashlib

    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    cfg = trainer_mirrored_cifar.build_config([
        "--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
        "pallas", "--pallas_ce", "true", "--sync_mode", "async",
        "--async_period", str(ASYNC_PERIOD)])
    built = Engine(RunSpec("resnet20", "cifar10", cfg, augment=True)).build(
        mesh)
    state = built.state
    digest = lambda ts: hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
    kernels.reset_launch_counts()
    before = mesh.all_reduces
    digests, tape, rates = [], [], []
    t0 = time.perf_counter()
    for _ in range(ASYNC_BN_STEPS):
        rates.append(state.optimizer.learning_rate())
        metrics = built.step(state, next(built.ds))[1]
        tape.append(float(mesh.sum_metrics(metrics)["loss"]))
        digests.append((digest([state.optimizer.params_flat]),
                        digest(list(state.model.buffers()))))
    torch.cuda.synchronize()
    return {"digests": digests, "tape": tape, "learning_rates": rates,
            "steps_per_sec": ASYNC_BN_STEPS / (time.perf_counter() - t0),
            "launches": kernels.launch_counts(),
            "all_reduces": mesh.all_reduces - before,
            "batch_per_worker": cfg.batch_size}


def zero3_resume_runs() -> dict:
    """Phase I' in one rank: config 3 under ZeRO-3, 40 steps straight and
    20 then resumed to 40; each run's summary and launches, and this
    rank's final parts."""
    dirs = ("chip_smoke_z3_straight", "chip_smoke_z3_resumed")
    half = Z3_RESUME_STEPS // 2
    runs = []
    for log_dir, steps in ((dirs[0], Z3_RESUME_STEPS), (dirs[1], half),
                           (dirs[1], Z3_RESUME_STEPS)):
        runs.append(run_trainer("trainer_sync_mnist", mode_argv(
            "zero3", steps, log_dir, "--checkpoint_every", str(half))))
    rank = dist.get_rank()
    parts = [torch.load(ROOT / "build" / d / "checkpoints"
                        / str(Z3_RESUME_STEPS) / f"rank-{rank}.pt",
                        weights_only=True) for d in dirs]
    same = all(torch.equal(a, b) for key in ("params_rows", "momentum_rows")
               for a, b in zip(parts[0][key], parts[1][key]))
    return {"runs": runs, "bitwise": same,
            "rows": len(parts[0]["params_rows"]),
            "part_bytes": os.path.getsize(
                ROOT / "build" / dirs[0] / "checkpoints"
                / str(Z3_RESUME_STEPS) / f"rank-{rank}.pt")}


def mode_rank_phases(phases: tuple) -> dict:
    """Phases L, M, N, I' and SH (those in ``phases``) in one of the two
    gloo ranks on ``cuda:0``, under cuDNN's deterministic algorithms."""
    from distributedtensorflowexample_tpu_torch.utils.profiling import (
        collective_ms)
    out = {}
    with deterministic_cudnn():
        if "L" in phases:
            out["L"] = {mode: run_trainer("trainer_sync_mnist", mode_argv(
                mode, MODE_STEPS, f"chip_smoke_{mode}", "--resume", "false"))
                for mode in MODE_FLAGS}
            out["L_collective_ms"] = collective_ms(make_mesh("cuda"),
                                                   CNN_PARAMS, 20)
        if "M" in phases:
            mesh = make_mesh("cuda")
            out["M"] = lm_mode_runs(mesh)
            out["M_collective_ms"] = collective_ms(mesh, LM_PARAMS, 5)
        if "N" in phases:
            out["N"] = async_bn_run(make_mesh("cuda"))
        if "I'" in phases:
            if dist.get_rank() == 0:
                for d in ("chip_smoke_z3_straight", "chip_smoke_z3_resumed"):
                    shutil.rmtree(ROOT / "build" / d, ignore_errors=True)
            dist.barrier()
            out["I'"] = zero3_resume_runs()
        if "SH" in phases:
            out["SH"] = run_trainer("trainer_sync_mnist", [
                "--device", "cuda", "--dataset", "synthetic",
                "--data_sharding", "sharded", "--pallas_ce", "true",
                "--fused_optimizer", "true", "--train_steps",
                str(SHARDED_DATA_STEPS), "--batch_size", str(BATCH),
                "--log_every", "10", "--log_dir", ""])
    return out


def run_mode_phases(gpu: str, phases: tuple) -> dict:
    """Phases L, M, N, I' and SH on the two gloo ranks: the checks and
    their JSON lines; the launch counts by path."""
    ranks = launch.spawn(mode_rank_phases, MR_RANKS, "gloo", (phases,),
                         timeout_s=900)
    by_path = {}
    if "L" in phases:
        by_path.update(check_mode_phase(ranks, gpu))
    if "M" in phases:
        by_path.update(check_lm_mode_phase(ranks, gpu))
    if "N" in phases:
        by_path.update(check_async_bn_phase(ranks, gpu))
    if "I'" in phases:
        by_path.update(check_zero3_resume_phase(ranks, gpu))
    if "SH" in phases:
        by_path.update(check_sharded_data_phase(ranks, gpu))
    return by_path


def check_mode_phase(ranks: list, gpu: str) -> dict:
    runs = {mode: [r["L"][mode] for r in ranks] for mode in MODE_FLAGS}
    print(runs["zero3"][0]["text"], end="")
    for mode, rs in runs.items():
        evals = rs[0]["eval_batches"]
        for r in rs:
            require(r["steps"] == MODE_STEPS and r["mode"] == mode,
                    f"phase L: {mode} ran {r['mode']} for {r['steps']} steps")
            require(r["launches"] == dequant_ce_expect(MODE_STEPS, evals),
                    f"phase L: {mode} rank {r['rank']} launch counts "
                    f"{r['launches']}")
            per_step = {k: v / MODE_STEPS for k, v in r["collectives"].items()}
            want = every_kind(r["collective_budget"])
            require(per_step == want, f"phase L: {mode} rank {r['rank']} "
                                      f"collectives per step {per_step}, "
                                      f"budget {want}")
            losses = [l for _, l in r["loss_tape"]]
            require(all(np.isfinite(losses)), f"phase L: {mode} {losses}")
        require(len({r["params_digest"] for r in rs}) == 1,
                f"phase L: {mode}: the replicas differ")
    ref = runs["sync_dp"][0]
    for mode, rs in runs.items():
        require(rs[0]["loss_tape"] == ref["loss_tape"]
                and rs[0]["params_digest"] == ref["params_digest"],
                f"phase L: {mode} is not bitwise sync_dp: tape "
                f"{rs[0]['loss_tape']} against {ref['loss_tape']}, "
                f"parameters {rs[0]['params_digest']} against "
                f"{ref['params_digest']}")
    print(json.dumps({"modes_path": {
        "model": "mnist_cnn", "ranks": MR_RANKS, "backend": "gloo",
        "steps": MODE_STEPS, "batch_per_rank": BATCH,
        "num_buckets": {m: rs[0]["num_buckets"] for m, rs in runs.items()},
        "steps_per_sec": {m: rs[0]["steps_per_sec"] for m, rs in
                          runs.items()},
        "collectives_per_step": {m: {k: v / MODE_STEPS for k, v in
                                     rs[0]["collectives"].items()}
                                 for m, rs in runs.items()},
        "collective_ms_host_staged": [r["L_collective_ms"] for r in ranks],
        "collective_numel": CNN_PARAMS,
        "bitwise_across_modes": True, "loss_tape": ref["loss_tape"],
        "final_accuracy": ref["final_accuracy"],
        "params_digest": ref["params_digest"], "gpu": gpu}}), flush=True)
    return {f"mnist_cnn_{mode}_gloo2": [r["launches"] for r in rs]
            for mode, rs in runs.items()}


def check_lm_mode_phase(ranks: list, gpu: str) -> dict:
    runs = {mode: [r["M"][mode] for r in ranks] for mode in LM_MODE_FLAGS}
    ref = np.array(runs["sync_dp"][0]["tape"])
    rel = {}
    for mode, rs in runs.items():
        tape = np.array(rs[0]["tape"])
        require(all(r["tape"] == rs[0]["tape"] for r in rs)
                and np.all(np.isfinite(tape)),
                f"phase M: {mode} tapes {[r['tape'] for r in rs]}")
        rel[mode] = float(np.max(np.abs(tape - ref) / np.abs(ref)))
        require(rel[mode] <= 1e-5, f"phase M: {mode}'s tape is {rel[mode]:.3g}"
                                   f" relative from sync_dp's ({tape} "
                                   f"against {ref})")
        decl = "zero3" if mode == "zero3_serial" else mode
        for r in rs:
            want = r["budget"]
            require(r["collectives"] == want and r["mode"] == decl,
                    f"phase M: {mode} ran {r['mode']}, collectives per step "
                    f"{r['collectives']}, budget {want}")
            require(r["launches"] == {"dequant": 0, "ce_fwd": MODE_LM_STEPS,
                                      "ce_bwd": MODE_LM_STEPS, "sgd": 0},
                    f"phase M: {mode} launch counts {r['launches']}")
    print(json.dumps({"lm_modes_path": {
        "model": LM_SIZE, "params": LM_PARAMS, "ranks": MR_RANKS,
        "backend": "gloo", "steps": MODE_LM_STEPS,
        "batch_per_rank": LM_BATCH, "seq_len": 128, "remat": "block",
        "learning_rate": LM_LR,
        "num_buckets": {m: rs[0]["num_buckets"] for m, rs in runs.items()},
        "steps_per_sec": {m: rs[0]["steps_per_sec"] for m, rs in
                          runs.items()},
        "state_bytes_after_init_by_rank": {
            m: [r["state_bytes_after_init"] for r in rs]
            for m, rs in runs.items()},
        "state_tensor_bytes": {m: rs[0]["state_tensor_bytes"]
                               for m, rs in runs.items()},
        "peak_bytes_in_steps_by_rank": {
            m: [r["peak_bytes_in_steps"] for r in rs]
            for m, rs in runs.items()},
        "collectives_per_step": {m: rs[0]["collectives"] for m, rs in
                                 runs.items()},
        "tape_max_rel_to_sync_dp": rel,
        "bitwise_to_sync_dp": {m: rel[m] == 0.0 for m in rel},
        "collective_ms_host_staged": [r["M_collective_ms"] for r in ranks],
        "collective_numel": LM_PARAMS, "tape": runs["sync_dp"][0]["tape"],
        "gpu": gpu}}), flush=True)
    return {f"{LM_SIZE}_{mode}_gloo2": [r["launches"] for r in rs]
            for mode, rs in runs.items()}


def check_async_bn_phase(ranks: list, gpu: str) -> dict:
    rs = [r["N"] for r in ranks]
    for s in range(ASYNC_BN_STEPS):
        params = {r["digests"][s][0] for r in rs}
        stats = {r["digests"][s][1] for r in rs}
        # the warmup's first step has learning rate 0: nothing moves
        averaged = ((s + 1) % ASYNC_PERIOD == 0
                    or not any(rs[0]["learning_rates"][:s + 1]))
        require(len(params) == (1 if averaged else MR_RANKS),
                f"phase N: after step {s + 1} the workers' parameters are "
                f"{'not ' if averaged else ''}equal")
        require(len(stats) == MR_RANKS,
                f"phase N: after step {s + 1} the workers share their "
                f"batch-norm statistics")
    for r in rs:
        require(r["launches"] == dequant_ce_expect(ASYNC_BN_STEPS, 0),
                f"phase N: launch counts {r['launches']}")
        require(r["all_reduces"] == ASYNC_BN_STEPS // ASYNC_PERIOD,
                f"phase N: {r['all_reduces']} all-reduces")
        require(np.all(np.isfinite(r["tape"])), f"phase N: {r['tape']}")
    print(json.dumps({"async_bn_path": {
        "model": "resnet20", "workers": MR_RANKS, "backend": "gloo",
        "steps": ASYNC_BN_STEPS, "batch_per_worker": rs[0]["batch_per_worker"],
        "async_period": ASYNC_PERIOD, "steps_per_sec": rs[0]["steps_per_sec"],
        "param_all_reduces": rs[0]["all_reduces"], "loss_tape": rs[0]["tape"],
        "launches_by_rank": [r["launches"] for r in rs], "gpu": gpu}}),
        flush=True)
    return {"resnet20_async_gloo2": [r["launches"] for r in rs]}


def check_zero3_resume_phase(ranks: list, gpu: str) -> dict:
    rs = [r["I'"] for r in ranks]
    half = Z3_RESUME_STEPS // 2
    for r in rs:
        straight, first, resumed = r["runs"]
        require(resumed["start_step"] == half
                and resumed["update_layout"] == "zero3_rows",
                f"phase I': the resumed run started at "
                f"{resumed['start_step']} in {resumed['update_layout']}")
        require(r["bitwise"], "phase I': the resumed rows differ from the "
                              "straight run's")
        require(straight["params_digest"] == resumed["params_digest"],
                "phase I': the gathered parameters differ")
        for run, steps in zip(r["runs"], (Z3_RESUME_STEPS, half, half)):
            require(run["launches"] == dequant_ce_expect(
                steps, run["eval_batches"]),
                f"phase I': launch counts {run['launches']}")
    print(json.dumps({"zero3_resume_path": {
        "model": "mnist_cnn", "ranks": MR_RANKS, "steps": Z3_RESUME_STEPS,
        "resumed_at": half, "bitwise": True, "buckets": rs[0]["rows"],
        "part_bytes_by_rank": [r["part_bytes"] for r in rs],
        "steps_per_sec": [run["steps_per_sec"] for run in rs[0]["runs"]],
        "gpu": gpu}}), flush=True)
    return {"mnist_cnn_zero3_resume_gloo2": [
        {k: sum(run["launches"][k] for run in r["runs"])
         for k in SOURCES} for r in rs]}


def check_sharded_data_phase(ranks: list, gpu: str) -> dict:
    """Phase SH: each rank's half of the split, the CE and SGD kernels
    only, the replicas bitwise equal."""
    rs = [r["SH"] for r in ranks]
    print(rs[0]["text"], end="")
    steps = SHARDED_DATA_STEPS
    expect = {"dequant": 0, "ce_fwd": steps, "ce_bwd": steps, "sgd": steps}
    for r in rs:
        require(r["steps"] == steps and r["launches"] == expect,
                f"phase SH: {r['steps']} steps, launches {r['launches']}, "
                f"expected {expect}")
        require(r["resident_rows"] == 60000 // MR_RANKS,
                f"phase SH: {r['resident_rows']} rows resident on a rank, "
                f"expected {60000 // MR_RANKS}")
        require(r["loss_tape"] == rs[0]["loss_tape"],
                "phase SH: the ranks' loss tapes differ")
    check_loss_tape(rs[0], rs[0]["text"])      # rank 0 prints
    require(len({r["params_digest"] for r in rs}) == 1,
            "phase SH: the replicas' parameters differ")
    print(json.dumps({"sharded_data_path": {
        "model": "mnist_cnn", "ranks": MR_RANKS, "steps": steps,
        "batch_per_rank": BATCH,
        "resident_rows_by_rank": [r["resident_rows"] for r in rs],
        "steps_per_sec": rs[0]["steps_per_sec"],
        "loss_tape": rs[0]["loss_tape"],
        "launches_by_rank": [r["launches"] for r in rs], "gpu": gpu}}),
        flush=True)
    return {"mnist_cnn_sharded_data_gloo2": [r["launches"] for r in rs]}


def nccl_rank(argv: list) -> dict:
    torch.backends.cudnn.deterministic = True
    return run_trainer("trainer_sync_mnist", argv)


def check_ranks(ranks: list, what: str, expect: dict, steps: int,
                all_reduces: int | None = None) -> None:
    """Phase A's cross-rank checks: every rank trained ``steps`` steps
    with ``all_reduces`` all-reduces (default one a step: the gradient's;
    batch norm adds its own, async mode averages once a period), launched
    ``expect``, and holds the same parameters and buffers bit for bit;
    only rank 0 printed step lines."""
    for r in ranks:
        want = steps if all_reduces is None else all_reduces
        require(r["steps"] == steps and r["all_reduces"] == want,
                f"{what}: rank {r['rank']} trained {r['steps']} steps with "
                f"{r['all_reduces']} all-reduces, expected {steps} steps "
                f"and {want}")
        require(r["launches"] == expect,
                f"{what}: rank {r['rank']} launch counts {r['launches']}, "
                f"expected {expect}")
        losses = [l for _, l in r["loss_tape"]]
        require(len(losses) >= 1 and all(np.isfinite(losses)),
                f"{what}: rank {r['rank']} loss tape {r['loss_tape']}")
    digests = {(r["params_digest"], r["stats_digest"]) for r in ranks}
    require(len(digests) == 1, f"{what}: replicas or their batch-norm "
                               f"buffers differ ({digests})")
    require(all("step " not in r["text"] for r in ranks[1:]),
            f"{what}: a rank other than 0 printed step lines")


def run_gloo_phases(gpu: str) -> dict:
    """Phases A, B and D: two gloo ranks on the one card."""
    ranks = launch.spawn(gloo_rank_phases, MR_RANKS, "gloo", timeout_s=900)
    b = [r["card_vs_cpu"] for r in ranks]
    a, c = np.array(b[0]["cuda"]), np.array(b[0]["cpu"])
    require(all(t == b[0] for t in b), f"phase B: the ranks' tapes differ {b}")
    require(np.all(np.isfinite(a)), f"phase B: card tape not finite {a}")
    rel = float(np.max(np.abs(a - c) / np.abs(c)))
    require(rel <= 2e-2, f"phase B: 2-rank card vs CPU loss tapes differ by "
                         f"{rel:.3g} relative (cuda {a}, cpu {c})")
    print(json.dumps({"multirank_card_vs_cpu_5_steps": {
        "ranks": MR_RANKS, "cuda": b[0]["cuda"], "cpu": b[0]["cpu"],
        "max_rel": rel}}), flush=True)

    mn = [r["mnist"] for r in ranks]
    print(mn[0]["text"], end="")
    evals = mn[0]["eval_batches"]
    check_ranks(mn, "phase A", {"dequant": MR_STEPS + evals,
                                "ce_fwd": MR_STEPS, "ce_bwd": MR_STEPS,
                                "sgd": MR_STEPS}, MR_STEPS)
    check_loss_tape(mn[0], mn[0]["text"])
    require(mn[0]["final_accuracy"] >= 0.9,
            f"phase A: final accuracy {mn[0]['final_accuracy']}")
    path = {"ranks": MR_RANKS, "backend": "gloo", "device": mn[0]["device"],
            "steps": MR_STEPS, "batch_per_rank": BATCH,
            "global_batch": mn[0]["global_batch"],
            "steps_per_call": mn[0]["steps_per_call"],
            "steps_per_sec": mn[0]["steps_per_sec"],
            "all_reduce_ms_host_staged": [r["all_reduce_ms"] for r in mn],
            "all_reduce_numel": CNN_PARAMS,
            "wall_s_incl_setup_and_eval": mn[0]["wall_s_incl_setup_and_eval"],
            "final_accuracy": mn[0]["final_accuracy"],
            "loss_tape": mn[0]["loss_tape"],
            "launches_by_rank": [r["launches"] for r in mn],
            "params_digest": mn[0]["params_digest"], "gpu": gpu}
    print(json.dumps({"multirank_path": path}), flush=True)

    ref = [r["lm_vs_one_rank"] for r in ranks]
    two, one = np.array(ref[0]["tape"]), np.array(ref[0]["one_rank_tape"])
    require(ref[1]["tape"] == ref[0]["tape"],
            f"phase D: the ranks' reference tapes differ {ref}")
    rel = float(np.max(np.abs(two - one) / np.abs(one)))
    require(np.all(np.isfinite(two)) and rel <= 2e-2,
            f"phase D: 2 ranks at B={LM_BATCH} against 1 rank at "
            f"B={LM_BATCH * MR_RANKS}: loss tapes differ by {rel:.3g} "
            f"relative (2 ranks {two}, 1 rank {one})")
    require(ref[0]["update_rel"] <= 8e-2,
            f"phase D: the first update differs from one rank's by "
            f"{ref[0]['update_rel']:.3g} of its largest element")
    print(json.dumps({"multirank_lm_vs_one_rank": {
        "model": LM_SIZE, "ranks": MR_RANKS, "batch_per_rank": LM_BATCH,
        "steps": MR_LM_REF_STEPS, "two_ranks": ref[0]["tape"],
        "one_rank": ref[0]["one_rank_tape"], "max_rel": rel,
        "first_update_rel": ref[0]["update_rel"]}}), flush=True)

    lm = [r["lm"] for r in ranks]
    print(lm[0]["text"], end="")
    check_ranks(lm, "phase D", {"dequant": 0, "ce_fwd": MR_LM_STEPS,
                                "ce_bwd": MR_LM_STEPS, "sgd": MR_LM_STEPS},
                MR_LM_STEPS)
    check_loss_tape(lm[0], lm[0]["text"])
    lm_path = {"model": LM_SIZE, "ranks": MR_RANKS, "backend": "gloo",
               "steps": MR_LM_STEPS, "batch_per_rank": LM_BATCH,
               "global_batch": lm[0]["global_batch"],
               "steps_per_sec": lm[0]["steps_per_sec"],
               "all_reduce_ms_host_staged": [r["all_reduce_ms"] for r in lm],
               "all_reduce_numel": LM_PARAMS,
               "wall_s_incl_setup_and_eval":
                   lm[0]["wall_s_incl_setup_and_eval"],
               "final_accuracy": lm[0]["final_accuracy"],
               "loss_tape": lm[0]["loss_tape"],
               "launches_by_rank": [r["launches"] for r in lm], "gpu": gpu}
    print(json.dumps({"multirank_lm_path": lm_path}), flush=True)

    cf = [r["cifar"] for r in ranks]
    print(cf[0]["text"], end="")
    check_ranks(cf, "phase F", dequant_ce_expect(MR_CIFAR_STEPS,
                                            cf[0]["eval_batches"]),
                MR_CIFAR_STEPS,
                all_reduces=MR_CIFAR_STEPS * (2 * BN_LAYERS + 1))
    losses = [l for _, l in cf[0]["loss_tape"]]
    require(all(np.isfinite(losses)), f"phase F: loss tape {losses}")
    cifar_path = {"model": "resnet20", "ranks": MR_RANKS, "backend": "gloo",
                  "steps": MR_CIFAR_STEPS, "batch_per_rank": CIFAR_BATCH,
                  "global_batch": cf[0]["global_batch"],
                  "steps_per_sec": cf[0]["steps_per_sec"],
                  "all_reduces_per_step": cf[0]["all_reduces"]
                  / MR_CIFAR_STEPS,
                  "final_accuracy": cf[0]["final_accuracy"],
                  "loss_tape": cf[0]["loss_tape"],
                  "launches_by_rank": [r["launches"] for r in cf],
                  "params_digest": cf[0]["params_digest"],
                  "stats_digest": cf[0]["stats_digest"], "gpu": gpu}
    print(json.dumps({"multirank_cifar_path": cifar_path}), flush=True)

    an = [r["async"] for r in ranks]
    print(an[0]["text"], end="")
    check_ranks(an, "phase K", dequant_ce_expect(MR_ASYNC_STEPS,
                                                 an[0]["eval_batches"]),
                MR_ASYNC_STEPS, all_reduces=MR_ASYNC_STEPS // ASYNC_PERIOD)
    check_loss_tape(an[0], an[0]["text"])
    return {"mnist_cnn_gloo2": [r["launches"] for r in mn],
            f"{LM_SIZE}_gloo2": [r["launches"] for r in lm],
            "resnet20_gloo2": [r["launches"] for r in cf],
            "mnist_cnn_async_gloo2": [r["launches"] for r in an],
            "async_gloo2": an}


def run_nccl_phase(gpu: str) -> dict:
    """Phase C: config 3 through an NCCL group on the visible cards: the
    largest power of two of them up to 4, so that the eval batch of 1000
    divides across the ranks."""
    world = 1 << (min(torch.cuda.device_count(), 4).bit_length() - 1)
    argv = ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--train_steps", str(NCCL_STEPS), "--batch_size", str(BATCH),
            "--log_every", "10", "--resume", "false",
            "--log_dir", str(ROOT / "build" / "chip_smoke_nccl")]
    ranks = launch.spawn(nccl_rank, world, "nccl", (argv,), timeout_s=600)
    evals = ranks[0]["eval_batches"]
    check_ranks(ranks, "phase C", {"dequant": NCCL_STEPS + evals,
                                   "ce_fwd": NCCL_STEPS,
                                   "ce_bwd": NCCL_STEPS, "sgd": NCCL_STEPS},
                NCCL_STEPS)
    result = {"world": world, "backend": "nccl",
              "global_batch": ranks[0]["global_batch"],
              "steps": NCCL_STEPS,
              "steps_per_sec": ranks[0]["steps_per_sec"],
              "loss_tape": ranks[0]["loss_tape"],
              "launches_by_rank": [r["launches"] for r in ranks],
              "params_digest": ranks[0]["params_digest"], "gpu": gpu}
    if world == 1:
        cudnn = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            alone = run_trainer("trainer_sync_mnist", argv)
        finally:
            torch.backends.cudnn.deterministic = cudnn
        require(alone["params_digest"] == ranks[0]["params_digest"],
                "phase C: the 1-rank NCCL run's parameters differ from the "
                "same steps with no process group")
        require(alone["loss_tape"] == ranks[0]["loss_tape"],
                f"phase C: loss tapes differ ({alone['loss_tape']} without "
                f"a group, {ranks[0]['loss_tape']} under NCCL)")
        result["bitwise_equal_to_no_group"] = True
    print(json.dumps({"nccl_path": result}), flush=True)
    return {"mnist_cnn_nccl": [r["launches"] for r in ranks]}


def multiworker_rank(argv: list) -> dict:
    return run_trainer("trainer_multiworker_cifar", argv)


def run_multiworker_phase(gpu: str) -> dict:
    """Phase H: config 5 as one NCCL process started with the cluster
    flags; the process group is the one-rank NCCL group it runs in."""
    argv = cifar_argv(MR_CIFAR_STEPS, "chip_smoke_multiworker",
                      log_every=10) + ["--worker_hosts", "localhost:2222",
                                       "--task_index", "0"]
    (r,) = launch.spawn(multiworker_rank, 1, "nccl", (argv,), timeout_s=600)
    print(r["text"], end="")
    check_ranks([r], "phase H", dequant_ce_expect(MR_CIFAR_STEPS,
                                             r["eval_batches"]),
                MR_CIFAR_STEPS)
    require(r["device"] == "cuda:0", f"phase H: placed on {r['device']}")
    losses = [l for _, l in r["loss_tape"]]
    require(all(np.isfinite(losses)), f"phase H: loss tape {losses}")
    print(json.dumps({"multiworker_path": {
        "model": "resnet20", "world": 1, "backend": "nccl",
        "steps": r["steps"], "steps_per_sec": r["steps_per_sec"],
        "final_accuracy": r["final_accuracy"],
        "loss_tape": r["loss_tape"], "launches": r["launches"],
        "gpu": gpu}}), flush=True)
    return {"resnet20_nccl": [r["launches"]]}


def async_argv(steps: int, log_dir: str, log_every: int = 100) -> list:
    """Config 2's trainer flags on the card: its defaults with the dequant
    and CE kernels (the fused apply is refused in async mode)."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--train_steps", str(steps),
            "--async_period", str(ASYNC_PERIOD), "--log_every",
            str(log_every), "--resume", "false",
            "--log_dir", str(ROOT / "build" / log_dir)]


def run_async_main_path() -> dict:
    """Phase K on one worker: config 2 through ``trainer_ps_mnist``."""
    r = run_trainer("trainer_ps_mnist", async_argv(ASYNC_STEPS,
                                                   "chip_smoke_async"))
    print(r["text"], end="")
    steps, counts = r["steps"], r["launches"]
    require(steps == ASYNC_STEPS, f"config 2: trained {steps} of "
                                  f"{ASYNC_STEPS} steps")
    expect = dequant_ce_expect(steps, r["eval_batches"])
    require(counts == expect, f"config 2: launch counts {counts}, expected "
                              f"{expect} (dequant per step and eval batch, "
                              f"the CE pair per step, no fused SGD)")
    check_loss_tape(r, r["text"])
    require(r["final_accuracy"] >= 0.9,
            f"config 2: final accuracy {r['final_accuracy']}")
    return r


def report_async_path(one: dict, two: list, gpu: str) -> None:
    row = lambda r, workers: {
        "workers": workers, "steps": r["steps"],
        "batch_per_worker": BATCH, "global_batch": r["global_batch"],
        "async_period": ASYNC_PERIOD, "steps_per_call": r["steps_per_call"],
        "steps_per_sec": r["steps_per_sec"],
        "param_all_reduces": r["all_reduces"],
        "wall_s_incl_setup_and_eval": r["wall_s_incl_setup_and_eval"],
        "final_accuracy": r["final_accuracy"], "loss_tape": r["loss_tape"]}
    print(json.dumps({"async_path": {
        "model": "mnist_cnn", "one_card": dict(row(one, 1),
                                               launches=one["launches"]),
        "two_gloo_ranks": dict(row(two[0], 2),
                               launches_by_rank=[r["launches"] for r in two],
                               params_digest=two[0]["params_digest"]),
        "gpu": gpu}}), flush=True)


def resume_argv(steps: int, log_dir: str) -> list:
    """Phase I: config 3 with the four kernels, a checkpoint every 100
    steps (``--resume`` is the default)."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--train_steps", str(steps), "--batch_size", str(BATCH),
            "--log_every", "100", "--checkpoint_every", "100",
            "--log_dir", str(ROOT / "build" / log_dir)]


def final_part(log_dir: str, step: int) -> dict:
    return torch.load(ROOT / "build" / log_dir / "checkpoints" / str(step)
                      / "rank-0.pt", weights_only=True)


def run_resume_phase(gpu: str) -> dict:
    """Phase I: two uninterrupted runs and one stopped and resumed, from
    empty log dirs, under cuDNN's deterministic algorithms."""
    dirs = ("chip_smoke_resume_a", "chip_smoke_resume_b",
            "chip_smoke_resume_c")
    for d in dirs:
        shutil.rmtree(ROOT / "build" / d, ignore_errors=True)
    half = RESUME_STEPS // 2
    plan = [(dirs[0], RESUME_STEPS), (dirs[1], RESUME_STEPS),
            (dirs[2], half), (dirs[2], RESUME_STEPS)]
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [run_trainer("trainer_sync_mnist", resume_argv(steps, d))
                for d, steps in plan]
    finally:
        torch.backends.cudnn.deterministic = cudnn
    resumed = runs[-1]
    print(resumed["text"], end="")
    require(resumed["start_step"] == half
            and f"resumed from checkpoint at step {half}" in resumed["text"],
            f"phase I: the second run started at {resumed['start_step']}, "
            f"not at the checkpoint of step {half}")
    for r, (_, steps) in zip(runs, plan):
        trained = steps - r["start_step"]
        expect = {"dequant": trained + r["eval_batches"], "ce_fwd": trained,
                  "ce_bwd": trained, "sgd": trained}
        require(r["steps"] == steps and r["launches"] == expect,
                f"phase I: {r['steps']} steps, launches {r['launches']}, "
                f"expected {steps} and {expect}")
    a, b, c = (final_part(d, RESUME_STEPS) for d in dirs)
    gap = (a["params"] - b["params"]).abs().max().item()
    off = (c["params"] - a["params"]).abs().max().item()
    same = torch.equal(a["params"], b["params"])
    if same:
        require(torch.equal(c["params"], a["params"])
                and torch.equal(c["momentum"], a["momentum"])
                and runs[0]["loss_tape"][-1] == resumed["loss_tape"][-1],
                f"phase I: the two uninterrupted runs are bitwise equal, the "
                f"resumed one is {off:.3g} away")
    else:
        # Three samples of one non-deterministic run: the resumed one
        # within twice the gap between the other two.
        require(off <= 2 * gap, f"phase I: the resumed run is {off:.3g} "
                                f"away, the uninterrupted ones {gap:.3g}")
    saves = [r["checkpoint"] for r in runs]
    result = {
        "steps": RESUME_STEPS, "resumed_at": half, "batch": BATCH,
        "uninterrupted_bitwise_equal": same, "uninterrupted_gap": gap,
        "resumed_max_abs_diff": off, "resumed_bitwise_equal": off == 0.0,
        "checkpoint_bytes": os.path.getsize(
            ROOT / "build" / dirs[0] / "checkpoints" / str(RESUME_STEPS)
            / "rank-0.pt"),
        "save_blocking_s": [t for st in saves for t in st["save_s"]],
        "save_write_s": [t for st in saves for t in st["write_s"]],
        "restore_s": resumed["checkpoint"]["restore_s"],
        "steps_per_sec": [r["steps_per_sec"] for r in runs],
        "launches_by_run": [r["launches"] for r in runs], "gpu": gpu}
    print(json.dumps({"resume_path": result}), flush=True)
    return {"mnist_cnn_resume": [r["launches"] for r in runs]}


def gloo_drill_rank(argv: list) -> dict:
    """One of phase J's two gloo ranks: the trainer, printing as a user
    sees it (rank 0's lines)."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    return trainer_sync_mnist.main(argv)


def gloo_drill(argv: list) -> None:
    """Phase J's second process: two gloo ranks on the one card through
    ``parallel/launch.spawn``, which forwards a SIGTERM to both."""
    launch.spawn(gloo_drill_rank, MR_RANKS, "gloo", (argv,), timeout_s=600)


def drill(cmd: list) -> dict:
    """Start ``cmd`` (a trainer with ``--train_steps`` left to add), send
    SIGTERM after its first log line, then restart it to 20 steps past
    the step it saved.  Exit codes, the saved step, the output."""
    p = subprocess.Popen(cmd + ["--train_steps", "1000000"], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    lines, first = [], threading.Event()

    def drain():
        for line in p.stdout:
            lines.append(line)
            if line.startswith("step ") and "loss" in line:
                first.set()
        first.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        first.wait(timeout=300)
        alive = p.poll() is None
        t_signal = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=300)
        t_exit = time.perf_counter()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        reader.join(timeout=30)
    text = "".join(lines)
    m = re.search(r"SIGTERM at step (\d+): checkpoint saved", text)
    require(alive and p.returncode == 143 and m is not None
            and "Traceback" not in text,
            f"phase J: {cmd[2:4]} gave exit code {p.returncode} after "
            f"SIGTERM (want 143 and the saved line):\n{text[-3000:]}")
    saved = int(m.group(1))
    r = subprocess.run(cmd + ["--train_steps", str(saved + 20)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    require(r.returncode == 0 and f"resumed from checkpoint at step {saved}"
            in r.stdout, f"phase J: the restart gave exit code "
                         f"{r.returncode}:\n{(r.stdout + r.stderr)[-3000:]}")
    return {"rc": p.returncode, "saved_step": saved,
            "first_line_s": t_signal - t0, "stop_s": t_exit - t_signal,
            "restart_rc": r.returncode}


def run_drill_phase(gpu: str) -> None:
    """Phase J: one trainer process, then two gloo ranks."""
    flags = ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
             "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
             "--batch_size", str(BATCH), "--steps_per_loop", "1",
             "--log_every", "10"]
    out = {}
    for name, head in (
            ("one_process", ["-m", "distributedtensorflowexample_tpu_torch."
                                   "trainers.trainer_sync_mnist"]),
            ("two_gloo_ranks", ["-c", "import sys, chip_smoke; "
                                      "chip_smoke.gloo_drill(sys.argv[1:])"])):
        log_dir = ROOT / "build" / f"chip_smoke_drill_{name}"
        shutil.rmtree(log_dir, ignore_errors=True)
        out[name] = drill([sys.executable, "-u", *head, *flags,
                           "--log_dir", str(log_dir)])
    print(json.dumps({"sigterm_drill": dict(out, gpu=gpu)}), flush=True)


# --- phase S: serving lm_base ---------------------------------------------

def host_argv(steps: int, log_dir: str, log_every: int, *extra) -> list:
    """Phase Q: config 3 host-fed, with the CE and SGD kernels."""
    return ["--device", "cuda", "--dataset", "synthetic", "--device_data",
            "off", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--train_steps", str(steps), "--batch_size", str(BATCH),
            "--log_every", str(log_every), "--resume", "false",
            "--log_dir", str(ROOT / "build" / log_dir) if log_dir else "",
            *extra]


def check_native_loader() -> dict:
    """Phase Q (a): the native loader builds, and its gathers are numpy's
    bit for bit on the synthetic MNIST split."""
    from distributedtensorflowexample_tpu_torch import native
    from distributedtensorflowexample_tpu_torch.data import cifar10
    from distributedtensorflowexample_tpu_torch.data.dequant import (
        try_quantize)
    from distributedtensorflowexample_tpu_torch.data.mnist import load_mnist
    require(native.available(), "phase Q: the native loader did not build "
                                "(native.available() is False)")
    x, _ = load_mnist("", "train", seed=0, source="synthetic")
    u8, _ = try_quantize(x)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, len(u8), size=1024)
    draws = cifar10._draw(rng, idx.size)
    checks = {
        "gather_u8": np.array_equal(native.gather(u8, idx), u8[idx]),
        "gather_f32": np.array_equal(native.gather(x, idx), x[idx]),
        "gather_augment_u8": np.array_equal(
            native.gather_augment(u8, idx, *draws),
            cifar10._augment_numpy(u8[idx], *draws)),
        "gather_augment_f32": np.array_equal(
            native.gather_augment(x, idx, *draws),
            cifar10._augment_numpy(x[idx], *draws))}
    require(all(checks.values()), f"phase Q: native against numpy {checks}")
    return {"omp_threads": native.omp_threads(), **checks}


def prefetch_against_sync_copies() -> dict:
    """Phase Q (d): the host-fed step fed by the prefetcher (pinned slots,
    side-stream copies, ``depth`` 2) and by synchronous copies of the same
    batches; the losses stay on the card until the end, so the host runs
    ahead and the prefetcher's slots are refilled while the card works."""
    from distributedtensorflowexample_tpu_torch.data.pipeline import (
        put_local_batch)
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    cfg = trainer_sync_mnist.build_config(host_argv(HOST_CMP_STEPS, "", 1))
    engine = Engine(RunSpec("mnist_cnn", "mnist", cfg))
    mesh = Mesh(torch.device("cuda"))
    data = engine.input("train")
    kernels.reset_launch_counts()
    tapes = {}
    for how in ("prefetched", "synchronous"):
        built = engine.build_host_fed(mesh, data=data)
        batches = (built.ds if how == "prefetched" else
                   (put_local_batch(b, mesh.device) for b in built.ds.source))
        losses = [built.step(built.state, next(batches))[1]["loss"]
                  for _ in range(HOST_CMP_STEPS)]
        tapes[how] = torch.stack(losses).cpu().numpy()
    require(np.array_equal(tapes["prefetched"], tapes["synchronous"]),
            f"phase Q: prefetched losses {tapes['prefetched']} differ from "
            f"the synchronous copies' {tapes['synchronous']}")
    return {"tape": tapes["prefetched"].tolist(),
            "launches": kernels.launch_counts()}


def run_host_fed_phase(gpu: str) -> dict:
    """Phase Q: the host-fed input path of config 3."""
    native_checks = check_native_loader()
    r = run_trainer("trainer_sync_mnist", host_argv(HOST_STEPS,
                                                    "chip_smoke_host", 50))
    print(r["text"], end="")
    steps = r["steps"]
    expect = {"dequant": 0, "ce_fwd": steps, "ce_bwd": steps, "sgd": steps}
    require(steps == HOST_STEPS and r["input"] == "host",
            f"phase Q: {steps} steps on the {r['input']} input path")
    require(r["launches"] == expect, f"phase Q: launch counts "
                                     f"{r['launches']}, expected {expect}")
    check_loss_tape(r, r["text"])
    h2d = BATCH * 28 * 28 + BATCH * 4          # uint8 pixels, int32 labels
    require(r["h2d_bytes_per_step"] == h2d,
            f"phase Q: {r['h2d_bytes_per_step']} bytes uploaded a step, "
            f"expected {h2d}")
    tapes, launches = {}, [r["launches"]]
    with deterministic_cudnn():
        for impl in ("affine", "onehot", "lut"):
            q = run_trainer("trainer_sync_mnist", host_argv(
                HOST_CMP_STEPS, f"chip_smoke_host_{impl}", 1,
                "--dequant_impl", impl))
            tapes[impl] = [loss for _, loss in q["loss_tape"]]
            launches.append(q["launches"])
        copies = prefetch_against_sync_copies()
    launches.append(copies["launches"])
    require(len(tapes["affine"]) == HOST_CMP_STEPS
            and tapes["onehot"] == tapes["affine"] == tapes["lut"],
            f"phase Q: the dequants' losses differ: {tapes}")
    result = {"model": "mnist_cnn", "input": "host", "steps": steps,
              "batch": BATCH, "steps_per_sec": r["steps_per_sec"],
              "h2d_bytes_per_step": r["h2d_bytes_per_step"],
              "h2d_image_bytes_per_step": BATCH * 28 * 28,
              "final_accuracy": r["final_accuracy"],
              "loss_tape": r["loss_tape"], "native": native_checks,
              "dequant_tapes_bitwise": True,
              "prefetch_vs_sync_copies_bitwise": True,
              "launches": r["launches"], "gpu": gpu}
    print(json.dumps({"host_fed_path": result}), flush=True)
    return {"mnist_cnn_host_fed": launches}


def run_remat_phase(gpu: str) -> dict:
    """Phase R: config 4 with ``--remat block`` against ``--remat none``."""
    from distributedtensorflowexample_tpu_torch.data.cifar10 import (
        load_cifar10)
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_mirrored_cifar)
    splits = {s: load_cifar10("", s, seed=0, source="synthetic")
              for s in ("train", "test")}
    runs = {}
    with deterministic_cudnn():
        for remat in ("none", "block"):
            log_dir = f"chip_smoke_remat_{remat}"
            shutil.rmtree(ROOT / "build" / log_dir, ignore_errors=True)
            cfg = trainer_mirrored_cifar.build_config(
                cifar_argv(REMAT_STEPS, log_dir, 25)
                + ["--remat", remat, "--checkpoint_every", str(REMAT_STEPS)])
            spec = RunSpec("resnet20", "cifar10", cfg, augment=True,
                           input_fn=lambda _cfg, split: splits[split])
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                summary = Engine(spec).run()
            runs[remat] = dict(summary, launches=kernels.launch_counts(),
                               peak_bytes=torch.cuda.max_memory_allocated(),
                               text=out.getvalue(), spec=spec)
        peaks, step_launches = {}, []
        for remat, r in runs.items():
            peaks[remat], launches = remat_step_peak(r["spec"], splits)
            step_launches.append(launches)
    print(runs["block"]["text"], end="")
    for remat, r in runs.items():
        expect = dequant_ce_expect(REMAT_STEPS, r["eval_batches"])
        require(r["steps"] == REMAT_STEPS and r["launches"] == expect,
                f"phase R ({remat}): {r['steps']} steps, launches "
                f"{r['launches']}, expected {expect}")
        check_loss_tape(r, r["text"])
    a, b = (final_part(f"chip_smoke_remat_{m}", REMAT_STEPS)
            for m in ("none", "block"))
    pairs = [("params", a["params"], b["params"])] + [
        (name, a["buffers"][name], b["buffers"][name])
        for name in a["buffers"]]
    bitwise = all(torch.equal(x, y) for _, x, y in pairs)
    worst = max(((x - y).abs().max() / x.abs().max().clamp_min(1e-30))
                .item() for _, x, y in pairs)
    require(bitwise or worst <= 2e-2,
            f"phase R: remat block is {worst:.3g} (relative) from remat "
            f"none")
    result = {"model": "resnet20", "steps": REMAT_STEPS,
              "batch": CIFAR_BATCH, "bitwise": bitwise,
              "max_rel_diff": worst, "tolerance": None if bitwise else 2e-2,
              "peak_bytes_run": {m: r["peak_bytes"]
                                 for m, r in runs.items()},
              "peak_bytes_train_steps": peaks,
              "steps_per_sec": {m: r["steps_per_sec"]
                                for m, r in runs.items()},
              "loss_tape": {m: r["loss_tape"] for m, r in runs.items()},
              "launches": {m: r["launches"] for m, r in runs.items()},
              "gpu": gpu}
    print(json.dumps({"remat_path": result}), flush=True)
    return {"resnet20_remat": [r["launches"] for r in runs.values()]
            + step_launches}


def remat_step_peak(spec, splits: dict) -> tuple:
    """Phase R: the device bytes the train steps take above what the
    state and the resident split hold (``max_memory_allocated`` over
    ``REMAT_PEAK_STEPS`` steps through ``Engine.build``, the eval's
    batch of 1000 out of the way), and their launches."""
    from distributedtensorflowexample_tpu_torch.engine import Engine
    gc.collect()
    torch.cuda.empty_cache()
    built = Engine(spec).build(Mesh(torch.device("cuda")),
                               data=splits["train"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(REMAT_PEAK_STEPS):
        built.step(built.state, next(built.ds))
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before,
            kernels.launch_counts())


def run_telemetry_phase(gpu: str) -> dict:
    """Phase T: tfevents, the profiler's window and ``health.json``."""
    from distributedtensorflowexample_tpu_torch.obs.anomaly import (
        read_health)
    from distributedtensorflowexample_tpu_torch.utils.tfevents import (
        read_events)
    log_dir = ROOT / "build" / "chip_smoke_telemetry"
    shutil.rmtree(log_dir, ignore_errors=True)
    health = log_dir / "health.json"
    held = os.environ.get("OBS_HEALTH")
    os.environ["OBS_HEALTH"] = str(health)
    try:
        r = run_trainer("trainer_sync_mnist", [
            "--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--train_steps", str(TELEMETRY_STEPS), "--batch_size",
            str(BATCH), "--log_every", "10", "--resume", "false",
            "--log_dir", str(log_dir), "--profile_dir",
            str(log_dir / "profile"), "--profile_start_step", "20",
            "--profile_num_steps", "5"])
    finally:
        if held is None:
            os.environ.pop("OBS_HEALTH", None)
        else:
            os.environ["OBS_HEALTH"] = held
    steps = r["steps"]
    expect = {"dequant": steps + r["eval_batches"], "ce_fwd": steps,
              "ce_bwd": steps, "sgd": steps}
    require(r["launches"] == expect, f"phase T: launch counts "
                                     f"{r['launches']}, expected {expect}")
    (events_file,) = log_dir.glob("events.out.tfevents.*")
    events = {(e["step"], e["tag"]): e["value"]
              for e in read_events(str(events_file)) if "tag" in e}
    rows = [json.loads(line) for line in
            (log_dir / "scalars.jsonl").read_text().splitlines()]
    scalars = {(row["step"], k): v for row in rows for k, v in row.items()
               if k != "step"}
    require(set(events) == set(scalars) and all(
        events[k] == float(np.float32(v)) for k, v in scalars.items()),
        f"phase T: tfevents {events} against scalars.jsonl {scalars}")
    trace = json.loads(Path(r["profile_trace"]).read_text())["traceEvents"]
    marks = [e for e in trace if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    require(marks, "phase T: no ProfilerStep span in the trace")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    in_window = [e for e in trace if e.get("cat") == "kernel"
                 and lo <= e["ts"] <= hi]
    require(in_window, f"phase T: no CUDA kernel event between {lo} and "
                       f"{hi} in {r['profile_trace']}")
    payload = read_health(str(health))
    require(payload is not None and payload["anomalies_total"] == 0
            and r["anomalies"] == 0,
            f"phase T: health {payload}, anomalies {r['anomalies']}")
    result = {"model": "mnist_cnn", "steps": steps,
              "tfevents_scalars": len(events),
              "profile_trace": os.path.relpath(r["profile_trace"], ROOT),
              "profile_window_steps": [m["name"] for m in marks],
              "kernel_events_in_window": len(in_window),
              "health_step": payload["step"],
              "step_time_detector_armed": payload["detectors"]["step_time"][
                  "baseline_mean_s"] is not None,
              "anomalies": r["anomalies"], "launches": r["launches"],
              "gpu": gpu}
    print(json.dumps({"telemetry_path": result}), flush=True)
    return {"mnist_cnn_telemetry": [r["launches"]]}


SERVE_DIR = ROOT / "build" / "chip_smoke_serve"
SERVE_SNAP = SERVE_DIR / "snapshots"


def snapshot_trained_lm() -> dict:
    """Phase 6's final checkpoint of lm_base, restored into the trainer's
    state and written once through the port's ``SnapshotStore`` (as the
    JAX package's ``tools/faultline.py`` writes one)."""
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.resilience.snapshot import (
        SnapshotStore)
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    from distributedtensorflowexample_tpu_torch.training.checkpoint import (
        CheckpointManager)
    size, cfg = trainer_lm.build_config(LM_ARGV[:])
    state = Engine(RunSpec(size, "lm", cfg)).create_state(
        Mesh(torch.device("cuda")))
    CheckpointManager(str(LM_LOG_DIR / "checkpoints")).restore(state)
    require(state.step == LM_STEPS, f"phase S: phase 6's checkpoint is at "
                                    f"step {state.step}, not {LM_STEPS}")
    store = SnapshotStore(str(SERVE_SNAP))
    t0 = time.perf_counter()
    store.save(state, cursor={"seed": cfg.seed, "step": state.step},
               meta={"model": size, "update_layout": "tree",
                     "writer": "chip_smoke"})
    return {"step": state.step, "save_s": time.perf_counter() - t0,
            "bytes": store.manifest(state.step)["nbytes"]}


def serve_argv(name: str, *extra) -> list:
    return ["--device", "cuda", "--snapshot", str(SERVE_SNAP), "--size",
            LM_SIZE, "--slots", str(SERVE_SLOTS), "--max_len",
            str(SERVE_CACHE), "--drive", str(SERVE_REQUESTS), "--clients",
            str(SERVE_CLIENTS), "--drive_max_new", str(SERVE_NEW),
            "--stats", str(SERVE_DIR / f"{name}.json"),
            "--results", str(SERVE_DIR / f"{name}.jsonl"), *extra]


def serve_drive(name: str, *extra) -> dict:
    """``serve_lm.main`` on the card, the launch counters set to 0 just
    before and read just after; check (a) on its answers."""
    from distributedtensorflowexample_tpu_torch.serving import serve_lm
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        DriveFile)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = serve_lm.main(serve_argv(name, *extra))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    require(rc == 0, f"phase S: serve_lm ({name}) exited {rc}")
    with open(SERVE_DIR / f"{name}.json") as f:
        stats = json.load(f)
    tokens = DriveFile(str(SERVE_DIR / f"{name}.jsonl")).done_ids()
    require(stats["completed"] == SERVE_REQUESTS
            and sorted(tokens) == list(range(SERVE_REQUESTS))
            and all(len(t) == SERVE_NEW for t in tokens.values()),
            f"phase S (a): {name} answered {stats['completed']} of "
            f"{SERVE_REQUESTS} requests, token counts "
            f"{sorted(set(len(t) for t in tokens.values()))}")
    return {"stats": stats, "tokens": tokens, "launches": counts,
            "wall_s": wall}


def check_against_forward(model, tokens: dict, what: str) -> dict:
    """One teacher-forced training forward per request over its prompt
    and served tokens: every served token must be the forward's argmax
    wherever the forward's top-2 logit gap exceeds ``SERVE_TAU``."""
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        make_prompt)
    inside = differ = 0
    widest = 0.0                # the widest gap where a token differs
    with torch.inference_mode():
        for rid, toks in sorted(tokens.items()):
            prompt = [int(t) for t in make_prompt(rid, model.vocab_size)]
            seq = torch.tensor([prompt + toks[:-1]], device="cuda")
            logits = model(seq)[0, len(prompt) - 1:]
            top2 = logits.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            want = logits.argmax(-1).cpu().numpy()
            bad = [j for j in range(SERVE_NEW)
                   if want[j] != toks[j] and gap[j] > SERVE_TAU]
            require(not bad, f"phase S ({what}): request {rid} differs "
                             f"from the teacher-forced forward at "
                             f"{bad} with top-2 gaps "
                             f"{[float(gap[j]) for j in bad]} > "
                             f"{SERVE_TAU}")
            inside += int((gap <= SERVE_TAU).sum())
            for j in range(SERVE_NEW):
                if want[j] != toks[j]:
                    differ += 1
                    widest = max(widest, float(gap[j]))
    return {"positions": len(tokens) * SERVE_NEW, "inside_tau": inside,
            "differ": differ, "widest_gap_differing": widest,
            "tau": SERVE_TAU}


def logit_err_vs_forward(engine, model, tokens: dict) -> float:
    """The largest |logit| difference between the engine (prefill, then
    decode steps fed the served tokens) and the teacher-forced training
    forward, over the first ``engine.slots`` requests: a served token can
    differ from the forward's argmax only where the forward's top-2 gap
    is at most twice this."""
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        make_prompt)
    rids = sorted(tokens)[:engine.slots]
    prompts = {s: [int(t) for t in make_prompt(rid, model.vocab_size)]
               for s, rid in enumerate(rids)}
    out = engine.prefill_many([(s, p, SERVE_NEW)
                               for s, p in prompts.items()])
    got = {s: [out[s][1]] for s in prompts}
    for j in range(SERVE_NEW - 1):
        for s, rid in enumerate(rids):
            engine.set_slot(s, tokens[rid][j], int(engine.positions[s]))
        logits = engine.decode_logits(busy=list(prompts))
        for s in prompts:
            got[s].append(logits[s])
    err = 0.0
    with torch.inference_mode():
        for s, rid in enumerate(rids):
            seq = torch.tensor([prompts[s] + tokens[rid][:-1]],
                               device="cuda")
            want = model(seq)[0, len(prompts[s]) - 1:].cpu().numpy()
            err = max(err, float(np.abs(np.stack(got[s]) - want).max()))
    for s in range(engine.slots):
        engine.set_slot(s, 0, 0)
    return err


def engine_greedy(engine, slot: int, prompt, n: int) -> list:
    toks = [engine.prefill(slot, prompt, max_new=n)]
    while len(toks) < n:
        toks.append(int(engine.decode(busy=[slot])[slot]))
    return toks


def admission_bitwise(engine) -> dict:
    """(c): a request admitted while another is mid-decode, and three
    prompts prefilled in one batch, bitwise their solo runs."""
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        make_prompt)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)
    prompt_a, prompt_b = make_prompt(100, 250), make_prompt(101, 250)
    solo_b = engine_greedy(engine, 1, prompt_b, 16)
    engine.set_slot(1, 0, 0)
    queue = RequestQueue(engine.vocab)
    batcher = ContinuousBatcher(engine, queue, slo_ms=0.0)
    ra = queue.submit(prompt_a, 48, rid="A")
    batcher.step()
    batcher.step()
    rb = queue.submit(prompt_b, 16, rid="B")
    batcher.step()
    require(not ra.done.is_set() and rb.admit_t is not None,
            "phase S (c): B was not admitted while A was decoding")
    while not (ra.done.is_set() and rb.done.is_set()):
        batcher.step()
    require(rb.tokens == solo_b, f"phase S (c): B admitted mid-decode "
                                 f"{rb.tokens} != solo {solo_b}")
    prompts = [make_prompt(i, 250) for i in (102, 103, 104)]
    solo = []
    for p in prompts:
        solo.append(engine_greedy(engine, 0, p, 8))
        engine.set_slot(0, 0, 0)
    out = engine.prefill_many([(s, p, 8) for s, p in enumerate(prompts)])
    got = [[out[s][0]] for s in range(3)]
    for _ in range(7):
        step = engine.decode(busy=[0, 1, 2])
        for s in range(3):
            got[s].append(int(step[s]))
    require(got == solo, f"phase S (c): batched prefill {got} != solo "
                         f"{solo}")
    for s in range(engine.slots):
        engine.set_slot(s, 0, 0)
    return {"mid_decode_admission": "bitwise", "batched_prefill_3":
            "bitwise"}


def serving_timings(engine) -> dict:
    """Prefill ms by bucket (one prompt, 5 calls after a warm-up), decode
    ms a step with every slot busy (50 steps), and under
    ``torch.profiler`` over 20 decode steps the launches a step and the
    device-busy share (``utils/profiling.py``'s counting)."""
    from distributedtensorflowexample_tpu_torch.utils import profiling
    prefill_ms = {}
    for bucket in engine.buckets:
        job = [(0, np.arange(bucket, dtype=np.int32) % 250,
                SERVE_CACHE - bucket)]
        engine.prefill_many(job)
        t0 = time.perf_counter()
        for _ in range(5):
            engine.prefill_many(job)
        prefill_ms[bucket] = (time.perf_counter() - t0) * 1e3 / 5
    for s in range(engine.slots):
        engine.set_slot(s, s + 1, 16)
    engine.decode()
    t0 = time.perf_counter()
    for _ in range(50):
        engine.decode()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 50
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            engine.decode()
    events = [e for e in prof.key_averages() if profiling._on_device(e)]
    busy_ms = sum(profiling._device_us(e) for e in events) / 1e3 / 20
    for s in range(engine.slots):
        engine.set_slot(s, 0, 0)
    return {"prefill_ms_by_bucket": prefill_ms, "decode_ms_per_step":
            decode_ms, "device_busy_ms_per_decode_step": busy_ms,
            "decode_idle_share": max(0.0, 1.0 - busy_ms / decode_ms),
            "launches_per_decode_step": sum(e.count for e in events) / 20}


def card_vs_cpu_engine() -> dict:
    """(e): the engine on the card against the engine on the CPU at
    lm_small, one seeded init, 4 prompts x 8 tokens, every step fed the
    CPU's greedy token: logits within 3e-2 (``tests/test_torch_lm.py``'s
    bf16 bound)."""
    import copy

    from distributedtensorflowexample_tpu_torch.models import build_model
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        make_prompt)
    cpu = build_model(SERVE_CPU_SIZE).reset_parameters(
        torch.Generator().manual_seed(0)).requires_grad_(False)
    engines = {"cpu": DecodeEngine(cpu, slots=4, cache_len=32),
               "cuda": DecodeEngine(copy.deepcopy(cpu).to("cuda"), slots=4,
                                    cache_len=32)}
    prompts = [(s, make_prompt(s, 250, seed=1), 8) for s in range(4)]
    outs = {d: e.prefill_many(prompts) for d, e in engines.items()}
    err = max(float(np.abs(outs["cpu"][s][1] - outs["cuda"][s][1]).max())
              for s in range(4))
    toks = [outs["cpu"][s][0] for s in range(4)]
    for _ in range(7):
        for e in engines.values():
            for s in range(4):
                e.set_slot(s, toks[s], int(e.positions[s]))
        logits = {d: e.decode_logits(busy=[0, 1, 2, 3])
                  for d, e in engines.items()}
        err = max(err, float(np.abs(logits["cpu"] - logits["cuda"]).max()))
        toks = [int(t) for t in logits["cpu"].argmax(-1)]
    require(err <= 3e-2, f"phase S (e): {SERVE_CPU_SIZE} logits on the card "
                         f"differ from the CPU's by {err:.3g} > 3e-2")
    return {"model": SERVE_CPU_SIZE, "max_abs_err": err}


def serve_sigterm_drill() -> dict:
    """(h): ``serve_lm`` in a process of its own, SIGTERM once its
    ``--ready_file`` exists and requests are in flight: exit 143, every
    admitted request answered, the queued tail ``drained``."""
    ready, stats_path = SERVE_DIR / "ready", SERVE_DIR / "term.json"
    cmd = [sys.executable, "-u", "-m",
           "distributedtensorflowexample_tpu_torch.serving.serve_lm",
           "--device", "cuda", "--snapshot", str(SERVE_SNAP), "--size",
           LM_SIZE, "--slots", str(SERVE_SLOTS), "--max_len",
           str(SERVE_CACHE), "--drive", "100000", "--clients",
           str(2 * SERVE_SLOTS), "--drive_max_new", str(SERVE_NEW),
           "--ready_file", str(ready), "--stats", str(stats_path)]
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(p.stdout),
                              daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        while not ready.exists() and p.poll() is None \
                and time.perf_counter() - t0 < 300:
            time.sleep(0.05)
        t_ready = time.perf_counter()
        time.sleep(2.0)             # requests in flight and queued
        alive = p.poll() is None
        p.send_signal(signal.SIGTERM)
        t_signal = time.perf_counter()
        p.wait(timeout=120)
        t_exit = time.perf_counter()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        reader.join(timeout=30)
    text = "".join(lines)
    require(alive and p.returncode == 143 and "Traceback" not in text,
            f"phase S (h): serve_lm gave exit code {p.returncode} after "
            f"SIGTERM (want 143):\n{text[-3000:]}")
    with open(stats_path) as f:
        stats = json.load(f)
    require(stats["preempted"] and stats["admitted"] == stats["completed"]
            and stats["rejected"]["drained"] >= 1,
            f"phase S (h): after SIGTERM admitted {stats['admitted']}, "
            f"completed {stats['completed']}, drained "
            f"{stats['rejected']['drained']}")
    return {"rc": p.returncode, "ready_s": t_ready - t0,
            "stop_s": t_exit - t_signal, "admitted": stats["admitted"],
            "completed": stats["completed"],
            "drained": stats["rejected"]["drained"]}


def run_serving_phase(gpu: str) -> dict:
    """Phase S; returns the kernels' launches on the serving path."""
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine, check_decode_contract)
    from distributedtensorflowexample_tpu_torch.serving.promote import promote
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    snap = snapshot_trained_lm()
    gc.collect()
    t0 = time.perf_counter()
    pm = promote(str(SERVE_SNAP), LM_SIZE, device=torch.device("cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    runs = {"plain": serve_drive("plain")}
    greedy = check_against_forward(pm.model, runs["plain"]["tokens"], "b")
    engine = DecodeEngine(pm.model, slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    greedy["max_abs_logit_err"] = logit_err_vs_forward(
        engine, pm.model, runs["plain"]["tokens"])
    bitwise = admission_bitwise(engine)
    found = check_decode_contract(engine, steps=100)
    require(found == [], f"phase S (d): DECODE_CONTRACT broken: {found}")
    timings = serving_timings(engine)
    card_cpu = card_vs_cpu_engine()
    runs["spec"] = serve_drive("spec", "--spec_draft", LM_SIZE,
                               "--spec_k", "4")
    spec = check_against_forward(pm.model, runs["spec"]["tokens"], "f")
    spec["requests_equal_plain"] = sum(
        runs["spec"]["tokens"][i] == runs["plain"]["tokens"][i]
        for i in range(SERVE_REQUESTS))
    sampled = ["--sample_temp", "0.8", "--sample_top_k", "20"]
    runs["sampled"] = serve_drive("sampled", *sampled)
    runs["sampled_again"] = serve_drive("sampled_again", *sampled)
    require(runs["sampled"]["tokens"] == runs["sampled_again"]["tokens"],
            "phase S (g): two sampled runs answered different tokens")
    drill_result = serve_sigterm_drill()
    counts = runs["plain"]["launches"]
    for name, r in runs.items():
        require(not any(r["launches"].values()),
                f"phase S: serving ({name}) launched {r['launches']}: no "
                f"kernel of this slice is on the serving path")
    plain = runs["plain"]["stats"]
    result = {
        "model": LM_SIZE, "slots": SERVE_SLOTS, "cache_rows": SERVE_CACHE,
        "cache_bytes": engine.cache_bytes, "snapshot": snap,
        "load_s": load_s, "requests": SERVE_REQUESTS,
        "clients": SERVE_CLIENTS, "tokens_per_request": SERVE_NEW,
        "tokens_per_sec": plain["tokens_per_sec"],
        "p50_ms": plain["p50_ms"], "p99_ms": plain["p99_ms"],
        "ttft_p50_ms": plain["ttft_p50_ms"],
        "ttft_p99_ms": plain["ttft_p99_ms"],
        "decode_steps": plain["decode_steps"], **timings,
        "greedy_vs_forward": greedy, "admission": bitwise,
        "decode_contract": "holds over 100 steps",
        "card_vs_cpu": card_cpu, "spec_vs_forward": spec,
        "spec": runs["spec"]["stats"]["spec"],
        "spec_tokens_per_sec": runs["spec"]["stats"]["tokens_per_sec"],
        "sampled_tokens_per_sec": runs["sampled"]["stats"]["tokens_per_sec"],
        "drive_wall_s": {n: r["wall_s"] for n, r in runs.items()},
        "sigterm": drill_result, "launches": counts, "gpu": gpu}
    print(json.dumps({"serving_path": result}), flush=True)
    print(f"serving: {plain['tokens_per_sec']} tokens/s, p50 "
          f"{plain['p50_ms']} ms, p99 {plain['p99_ms']} ms, decode "
          f"{timings['decode_ms_per_step']:.3f} ms a step ({LM_SIZE}, "
          f"{SERVE_SLOTS} slots) on {gpu}", flush=True)
    return counts


# --- phase O: shard-redundant snapshots of lm_base -------------------------

SHARD_STEPS = 10            # phase O: ZeRO-3 lm_base, a shard set every 5
SHARD_EVERY = 5
SHARD_KEEP = 2
SHARD_ROOT = ROOT / "build" / "chip_smoke_shards"
ELASTIC_RANKS = 4           # phase O (e): the D=2 set restored on 4 ranks


def shard_argv(steps: int, log_dir: str) -> list:
    """lm_base under ZeRO-3 with the CE pair (``trainer_lm``), a shard set
    (and a checkpoint) every ``SHARD_EVERY`` steps, keep 2."""
    return ["--device", "cuda", "--size", LM_SIZE, "--pallas_ce", "true",
            "--learning_rate", str(LM_LR), "--batch_size", str(LM_BATCH),
            "--bucket_grads", "auto", "--shard_params", "true",
            "--train_steps", str(steps), "--log_every", str(SHARD_EVERY),
            "--checkpoint_every", str(SHARD_EVERY), "--keep_checkpoints",
            str(SHARD_KEEP), "--log_dir", str(SHARD_ROOT / "logs" / log_dir)]


def shard_run(snap: Path, steps: int, log_dir: str) -> dict:
    """``trainer_lm`` with ``SNAPSHOT_DIR=snap`` (``run_trainer``)."""
    os.environ["SNAPSHOT_DIR"] = str(snap)
    try:
        return run_trainer("trainer_lm", shard_argv(steps, log_dir))
    finally:
        del os.environ["SNAPSHOT_DIR"]


def shard_engine():
    from distributedtensorflowexample_tpu_torch.engine import Engine, RunSpec
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    size, cfg = trainer_lm.build_config(shard_argv(SHARD_STEPS, "x"))
    return Engine(RunSpec(size, "lm", cfg))


def full_state_digest(state, mesh) -> str:
    """sha256 of the full parameters and momentum in the port's flat
    order, gathered from every rank's rows (uncounted): equal for one
    state at any mesh width."""
    import hashlib

    from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
        materialized)
    opt = state.optimizer
    h = hashlib.sha256()
    with materialized(state, mesh) as flat:
        h.update(flat.cpu().numpy().tobytes())
        momentum = torch.zeros_like(flat)
    for b, row in enumerate(opt.momentum_rows):
        opt.plan.unpack(mesh.all_gather_into(row, counted=False), momentum, b)
    h.update(momentum.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def shard_restore(snap: Path, mesh, same_width: bool = False,
                  step: int | None = None) -> tuple:
    """(state, facts) of a restore of ``snap`` onto ``mesh``: elastic
    (``restore_elastic`` into a fresh tree state) or at the same width
    (``restore`` into a laid-out state); the restore's ms (the fresh
    state's creation excluded), its reconstructions, the full digest."""
    from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
        ShardStore)
    engine = shard_engine()
    state = engine.create_state(mesh)
    store = ShardStore(str(snap))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if same_width:
        state, _ = engine.laid_out_state(mesh, state)
        store.restore(state, mesh, step=step)
        aux = store.last_restore
    else:
        state, aux = store.restore_elastic(state, mesh=mesh, step=step)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return state, {"ms": ms, "step": aux["step"],
                   "reconstructed": aux["reconstructed"],
                   "digest": full_state_digest(state, mesh)}


def shard_copy(src: Path, name: str, mesh, step: int = SHARD_STEPS) -> Path:
    """A shard directory holding a copy of ``src``'s set at ``step``
    alone, made by rank 0."""
    dst = SHARD_ROOT / name
    if mesh.rank == 0:
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src / f"shards_{step:08d}", dst / f"shards_{step:08d}")
    dist.barrier()
    return dst


def shard_rank_phase() -> dict:
    """Phase O (a)-(d) and (f)-(h) in one of the two gloo ranks: two
    straight 10-step runs, a resume of the first run's step-5 set, and
    the restores of the first run's step-10 set, intact, with rank 1's
    directory lost (elastic and at the same width), with a byte of rank
    0's shard flipped, and with shard 0's every copy lost (both ways)."""
    from distributedtensorflowexample_tpu_torch.obs import metrics as obs_m
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
        ShardStore)
    mesh = make_mesh("cuda")
    if mesh.rank == 0:
        shutil.rmtree(SHARD_ROOT, ignore_errors=True)
    dist.barrier()
    snap = {k: SHARD_ROOT / k for k in ("a", "b", "resumed")}
    out = {"rank": mesh.rank,
           "runs": {"a": shard_run(snap["a"], SHARD_STEPS, "a"),
                    "b": shard_run(snap["b"], SHARD_STEPS, "b")}}
    store = ShardStore(str(snap["a"]))
    out["steps_a"] = store.steps()
    out["quorum_a"] = store.quorum_steps()
    rdir = snap["a"] / f"shards_{SHARD_STEPS:08d}" / f"rank_{mesh.rank:05d}"
    out["files"] = {f.name: f.stat().st_size for f in sorted(rdir.iterdir())}
    # (f) the step-5 set alone, resumed to step 10
    resumed = shard_copy(snap["a"], "resumed", mesh, SHARD_EVERY)
    out["runs"]["resumed"] = shard_run(resumed, SHARD_STEPS, "resumed")
    out["digests"] = {k: ShardStore(str(d)).manifest(SHARD_STEPS)["digests"]
                      for k, d in (("a", snap["a"]), ("b", snap["b"]),
                                   ("resumed", resumed))}
    if out["digests"]["a"] != out["digests"]["b"]:
        # Not bitwise: the resumed rows within twice the straight runs' gap.
        rows = {k: ShardStore(str(d))._load(SHARD_STEPS, report=False)[1]
                for k, d in (("a", snap["a"]), ("b", snap["b"]),
                             ("resumed", resumed))}
        gap = lambda x, y: max(float(np.abs(p - q).max())
                               for f in ("params", "opt_state")
                               for p, q in zip(rows[x][f], rows[y][f]))
        out["gap_ab"], out["gap_resumed"] = gap("a", "b"), gap("a", "resumed")
    # (b)-(d) the restores of run a's step-10 set
    _, out["intact"] = shard_restore(snap["a"], mesh)
    _, out["same_width"] = shard_restore(snap["a"], mesh, same_width=True)
    lost = shard_copy(snap["a"], "lost_rank1", mesh)
    if mesh.rank == 0:
        ShardStore(str(lost)).drop_rank_dir(1, SHARD_STEPS)
    dist.barrier()
    _, out["lost_rank1"] = shard_restore(lost, mesh)
    _, out["lost_rank1_same_width"] = shard_restore(lost, mesh,
                                                    same_width=True)
    flipped = shard_copy(snap["a"], "bitflip", mesh)
    if mesh.rank == 0:
        ShardStore(str(flipped)).flip_payload_byte(0, SHARD_STEPS)
    dist.barrier()
    refused = obs_m.counter("ckpt_digest_mismatches_total").value
    _, out["bitflip"] = shard_restore(flipped, mesh)
    out["bitflip"]["digest_mismatches"] = (
        obs_m.counter("ckpt_digest_mismatches_total").value - refused)
    past = shard_copy(snap["a"], "past_redundancy", mesh)
    if mesh.rank == 0:
        step_dir = past / f"shards_{SHARD_STEPS:08d}"
        os.remove(step_dir / "rank_00000" / "own.npz")
        os.remove(step_dir / "rank_00001" / "mirror_00000.npz")
    dist.barrier()
    for key, same_width in (("past_redundancy", False),
                            ("past_redundancy_same_width", True)):
        try:
            shard_restore(past, mesh, same_width, step=SHARD_STEPS)
            out[key] = None
        except ModeRefusal as e:
            out[key] = str(e)
    return out


def elastic_rank(src: Path, dst: Path) -> dict:
    """Phase O (e) in one of the four gloo ranks: the D=2 set restored
    here, then saved again as a D=4 set."""
    from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
        ShardLayout, ShardStore)
    mesh = make_mesh("cuda")
    state, out = shard_restore(src, mesh)
    layout = ShardLayout.for_params(
        "zero3_rows", ShardStore(str(src)).manifest(out["step"])[
            "bucket_bytes"], dict(state.model.named_parameters()), mesh.size)
    store = ShardStore(str(dst), layout=layout, keep=1)
    store.save(state, mesh)
    out["save_s"] = store.last_save["seconds"]
    out["own_bytes"] = store.last_save["own_bytes"]
    return out


def check_shard_phase(ranks: list, four: list, back: list, gpu: str) -> dict:
    """Phase O's checks and its ``shard_snapshot_path`` line; the launch
    counts of its runs, per rank."""
    from distributedtensorflowexample_tpu_torch.engine.spec import (
        collective_budget)
    from distributedtensorflowexample_tpu_torch.trainers import trainer_lm
    r0 = ranks[0]
    require(r0["steps_a"] == [SHARD_EVERY, SHARD_STEPS]
            and r0["quorum_a"] == r0["steps_a"],
            f"phase O (a): sets {r0['steps_a']}, quorum-valid "
            f"{r0['quorum_a']} (want [{SHARD_EVERY}, {SHARD_STEPS}])")
    for r in ranks:
        want = {"own.npz", f"mirror_{1 - r['rank']:05d}.npz", "repl.npz"}
        require(set(r["files"]) == want,
                f"phase O (a): rank {r['rank']} holds {sorted(r['files'])}")
    half = 2 * LM_PARAMS * 4 // MR_RANKS
    intact = r0["intact"]["digest"]
    require(all(r["runs"]["a"]["params_digest"]
                == r0["runs"]["a"]["params_digest"] for r in ranks),
            "phase O: the ranks' gathered parameters differ")
    for key in ("intact", "same_width", "lost_rank1",
                "lost_rank1_same_width", "bitflip"):
        require(all(r[key]["digest"] == intact for r in ranks),
                f"phase O: the {key} restore differs from the intact one "
                f"{[r[key]['digest'] for r in ranks]}")
    require(all(r[key]["reconstructed"] == [1] for r in ranks
                for key in ("lost_rank1", "lost_rank1_same_width")),
            "phase O (b): reconstructed " + str(
                [[r[k]["reconstructed"] for k in ("lost_rank1",
                                                  "lost_rank1_same_width")]
                 for r in ranks]))
    require(r0["bitflip"]["reconstructed"] == [0]
            and r0["bitflip"]["digest_mismatches"] >= 1,
            f"phase O (c): reconstructed {r0['bitflip']['reconstructed']}, "
            f"{r0['bitflip']['digest_mismatches']} copies refused by sha256")
    past = [r[k] for r in ranks
            for k in ("past_redundancy", "past_redundancy_same_width")]
    require(all(m is not None and "exceeds redundancy R=2" in m
                for m in past), f"phase O (d): {past}")
    require(all(r["digest"] == intact for r in four + back),
            f"phase O (e): D=2 -> {ELASTIC_RANKS} -> 2 digests "
            f"{[r['digest'] for r in four]}, {[r['digest'] for r in back]} "
            f"against {intact}")
    if "gap_ab" in r0:
        for r in ranks:
            require(r["gap_resumed"] <= 2 * r["gap_ab"],
                    f"phase O (f): the resumed rows differ by "
                    f"{r['gap_resumed']} > twice the straight runs' gap "
                    f"{r['gap_ab']}")
        resume = "within twice the straight runs' gap"
    else:
        require(r0["digests"]["resumed"] == r0["digests"]["a"],
                f"phase O (f): the resumed step-{SHARD_STEPS} shards differ "
                f"from the straight run's: {r0['digests']}")
        resume = "bitwise"
    _, cfg = trainer_lm.build_config(shard_argv(SHARD_STEPS, "x"))
    counts = []
    for r in ranks:
        per_rank = {k: 0 for k in SOURCES}
        for name, run in r["runs"].items():
            steps = run["steps"] - run["start_step"]
            require(run["steps"] == SHARD_STEPS
                    and run["update_layout"] == "zero3_rows",
                    f"phase O: run {name} ended at {run['steps']} in "
                    f"{run['update_layout']}")
            want_start = SHARD_EVERY if name == "resumed" else 0
            require(run["start_step"] == want_start
                    and (name != "resumed" or
                         "resumed from shard set at step" in run["text"]
                         or r["rank"] != 0),
                    f"phase O (f): run {name} started at "
                    f"{run['start_step']}")
            budget = every_kind(collective_budget(cfg, MR_RANKS,
                                                  run["num_buckets"]))
            got = {k: v / steps for k, v in run["collectives"].items()}
            require(got == budget, f"phase O (g): run {name} rank "
                                   f"{r['rank']} collectives per step {got}, "
                                   f"budget {budget}")
            want = {"dequant": 0, "ce_fwd": steps, "ce_bwd": steps, "sgd": 0}
            require(run["launches"] == want,
                    f"phase O (h): run {name} rank {r['rank']} launches "
                    f"{run['launches']}, expected {want}")
            for k in SOURCES:
                per_rank[k] += run["launches"][k]
        counts.append(per_rank)
    run_a = r0["runs"]["a"]["shard_snapshots"]
    result = {
        "model": LM_SIZE, "params": LM_PARAMS, "ranks": MR_RANKS,
        "steps": SHARD_STEPS, "every": SHARD_EVERY, "keep": SHARD_KEEP,
        "redundancy": 2, "buckets": r0["runs"]["a"]["num_buckets"],
        "save_blocking_ms_by_rank": [
            [s * 1e3 for s in r["runs"]["a"]["shard_snapshots"]["saves"]]
            for r in ranks],
        "files_bytes_by_rank": [r["files"] for r in ranks],
        "half_params_plus_momentum_bytes": half,
        "restore_ms_same_width": [r["same_width"]["ms"] for r in ranks],
        "restore_ms_elastic_2_to_2": [r["intact"]["ms"] for r in ranks],
        f"restore_ms_elastic_2_to_{ELASTIC_RANKS}": [r["ms"] for r in four],
        f"restore_ms_elastic_{ELASTIC_RANKS}_to_2": [r["ms"] for r in back],
        f"save_s_at_{ELASTIC_RANKS}": [r["save_s"] for r in four],
        "restore_ms_same_width_lost_rank1": [
            r["lost_rank1_same_width"]["ms"] for r in ranks],
        "reconstructed": {"lost_rank1": r0["lost_rank1"]["reconstructed"],
                          "bitflip": r0["bitflip"]["reconstructed"]},
        "past_redundancy": "refused", "resume": resume,
        "collectives_per_step": "the zero3 budget",
        "steps_per_sec": {k: v["steps_per_sec"]
                          for k, v in r0["runs"].items()},
        "last_save": run_a["last"], "digest": intact,
        "launches_by_rank": counts, "gpu": gpu}
    print(json.dumps({"shard_snapshot_path": result}), flush=True)
    print(f"shard snapshots: save {result['save_blocking_ms_by_rank'][0]} ms "
          f"(rank 0), restore {result['restore_ms_same_width'][0]:.1f} ms "
          f"same width, {result['restore_ms_elastic_2_to_2'][0]:.1f} ms "
          f"elastic ({LM_SIZE}, 2 gloo ranks, host-staged) on {gpu}",
          flush=True)
    return {f"{LM_SIZE}_shard_snapshots_gloo2": counts}


# --- phase P: params-stay-sharded serving of lm_base -----------------------

SHARDED_SLOTS = 8           # 4 a rank
SHARDED_REQUESTS = 16
SHARDED_CLIENTS = 4
SHARDED_NEW = 16
SHARDED_CONTRACT_STEPS = 20


def sharded_argv(name: str, *extra) -> list:
    return ["--device", "cuda", "--snapshot", str(SERVE_SNAP), "--size",
            LM_SIZE, "--sharded_mesh", str(MR_RANKS), "--slots",
            str(SHARDED_SLOTS), "--max_len", str(SERVE_CACHE), *extra]


def sharded_rank_phase(snap4: Path) -> dict:
    """Phase O (e)'s way back, then phase P's engine checks in one of the
    two gloo ranks: promotion into 1/D rows, the engine's bytes, its
    refusals, the contract over 20 decode steps, its timings."""
    from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
    from distributedtensorflowexample_tpu_torch.serving.promote import (
        promote_sharded)
    from distributedtensorflowexample_tpu_torch.serving.queue import (
        ContinuousBatcher, RequestQueue)
    from distributedtensorflowexample_tpu_torch.serving.sampling import (
        Sampler)
    from distributedtensorflowexample_tpu_torch.serving.sharded import (
        ShardedDecodeEngine, check_sharded_decode_contract)
    from distributedtensorflowexample_tpu_torch.serving.spec import (
        SpecDecoder)
    mesh = make_mesh("cuda")
    state, back = shard_restore(snap4, mesh)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pm = promote_sharded(str(SERVE_SNAP), LM_SIZE, mesh=mesh,
                         mesh_size=MR_RANKS)
    engine = ShardedDecodeEngine(pm.model, pm.rows, pm.layout, mesh=mesh,
                                 slots=SHARDED_SLOTS, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "elastic_back": back,
           "load_s": time.perf_counter() - t0,
           "allocated_after_promotion": torch.cuda.memory_allocated()
           - before, "residency": engine.params_residency(),
           "local_cache_bytes": engine.local_cache_bytes}
    if mesh.rank != 0:
        out["followed_steps"] = engine.follow()
    else:
        try:
            refusals = {}
            for name, make in (
                    ("sampling", lambda: ContinuousBatcher(
                        engine, RequestQueue(engine.vocab),
                        sampler=Sampler(temperature=0.8, top_k=20))),
                    ("speculation", lambda: SpecDecoder(engine, engine)),):
                try:
                    make()
                    refusals[name] = None
                except ModeRefusal as e:
                    refusals[name] = str(e)
            out["refusals"] = refusals
            out["contract"] = check_sharded_decode_contract(
                engine, steps=SHARDED_CONTRACT_STEPS)
            for s in range(engine.slots):
                engine.set_slot(s, s + 1, 16)
            engine.decode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                engine.decode()
            torch.cuda.synchronize()
            out["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 10
            for s in range(engine.slots):
                engine.set_slot(s, 0, 0)
        finally:
            engine.stop_followers()
    # Every bucket's all-gather, timed alone (uncounted, both ranks).
    mesh.all_gather_int(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        for row in engine.rows:
            mesh.all_gather_into(row, counted=False)
    torch.cuda.synchronize()
    out["gathers_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 3
    return out



def run_shard_phase() -> tuple:
    """Phase O's groups: the two gloo ranks, then the D=2 set restored on
    four and saved again (the way back runs with phase P)."""
    ranks = launch.spawn(shard_rank_phase, MR_RANKS, "gloo", timeout_s=900)
    four = launch.spawn(elastic_rank, ELASTIC_RANKS, "gloo",
                        (SHARD_ROOT / "a", SHARD_ROOT / "d4"),
                        timeout_s=600)
    return ranks, four


def greedy_with_gaps(engine, prompt, n: int) -> tuple:
    """A replicated engine's greedy tokens for ``prompt`` in slot 0 and
    each position's top-2 logit gap."""
    (tok, logits), = engine.prefill_many([(0, prompt, n)]).values()
    toks, gaps = [tok], []
    while True:
        top = np.sort(logits)[-2:]
        gaps.append(float(top[1] - top[0]))
        if len(toks) == n:
            break
        engine.set_slot(0, toks[-1], int(engine.positions[0]))
        logits = engine.decode_logits(busy=[0])[0]
        toks.append(int(logits.argmax()))
    engine.set_slot(0, 0, 0)
    return toks, gaps


def check_sharded_tokens(tokens: dict) -> dict:
    """(b) each served request bitwise a replicated engine of S/D slots
    fed its prompt; (c) equal to an S-slot engine up to the first
    position whose top-2 gap is at most ``SERVE_TAU``."""
    from distributedtensorflowexample_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        make_prompt)
    from distributedtensorflowexample_tpu_torch.serving.promote import promote
    pm = promote(str(SERVE_SNAP), LM_SIZE, device=torch.device("cuda"))
    local = DecodeEngine(pm.model, slots=SHARDED_SLOTS // MR_RANKS,
                         cache_len=SERVE_CACHE)
    full = DecodeEngine(pm.model, slots=SHARDED_SLOTS, cache_len=SERVE_CACHE)
    inside = differ = 0
    for rid, toks in sorted(tokens.items()):
        prompt = make_prompt(rid, pm.model.vocab_size)
        want = engine_greedy(local, 0, prompt, SHARDED_NEW)
        local.set_slot(0, 0, 0)
        require(toks == want, f"phase P (b): request {rid} served {toks}; "
                              f"the {SHARDED_SLOTS // MR_RANKS}-slot "
                              f"replicated engine gives {want}")
        ref, gaps = greedy_with_gaps(full, prompt, SHARDED_NEW)
        inside += sum(g <= SERVE_TAU for g in gaps)
        for j in range(SHARDED_NEW):
            if toks[j] != ref[j]:
                differ += 1
                require(gaps[j] <= SERVE_TAU,
                        f"phase P (c): request {rid} differs from the "
                        f"{SHARDED_SLOTS}-slot engine at {j}, top-2 gap "
                        f"{gaps[j]} > {SERVE_TAU}")
                break
    return {"bitwise_vs_local_slots": "all", "requests_diverging_from_S":
            differ, "positions_inside_tau": inside, "tau": SERVE_TAU}


def sharded_serve(name: str, *extra, timeout: float = 600) -> tuple:
    """``serve_lm --sharded_mesh 2`` in a process of its own: (rc, output,
    stats)."""
    stats = SERVE_DIR / f"sharded_{name}.json"
    p = subprocess.run(
        [sys.executable, "-u", "-m",
         "distributedtensorflowexample_tpu_torch.serving.serve_lm",
         *sharded_argv(name, "--stats", str(stats), *extra)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    text = p.stdout + p.stderr
    loaded = json.loads(stats.read_text()) if stats.exists() else None
    return p.returncode, text, loaded


def sharded_sigterm_drill() -> dict:
    """(g): the sharded ``serve_lm`` SIGTERMed once its ``--ready_file``
    appears: 143 from the launcher, both ranks report their exit 143,
    every admitted request answered."""
    ready, stats_path = SERVE_DIR / "sharded_ready", \
        SERVE_DIR / "sharded_term.json"
    ready.unlink(missing_ok=True)
    cmd = [sys.executable, "-u", "-m",
           "distributedtensorflowexample_tpu_torch.serving.serve_lm",
           *sharded_argv("term", "--drive", "100000", "--clients",
                         str(2 * SHARDED_SLOTS), "--drive_max_new",
                         str(SHARDED_NEW), "--ready_file", str(ready),
                         "--stats", str(stats_path))]
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(p.stdout),
                              daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        while not ready.exists() and p.poll() is None \
                and time.perf_counter() - t0 < 300:
            time.sleep(0.05)
        t_ready = time.perf_counter()
        time.sleep(3.0)             # requests in flight and queued
        alive = p.poll() is None
        p.send_signal(signal.SIGTERM)
        t_signal = time.perf_counter()
        p.wait(timeout=180)
        t_exit = time.perf_counter()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        reader.join(timeout=30)
    text = "".join(lines)
    require(alive and p.returncode == 143 and "Traceback" not in text
            and all(f"rank {r}: TERM — exit 143" in text
                    for r in range(MR_RANKS)),
            f"phase P (g): sharded serve_lm gave exit code {p.returncode} "
            f"after SIGTERM (want 143 on every rank):\n{text[-3000:]}")
    stats = json.loads(stats_path.read_text())
    require(stats["preempted"] and stats["admitted"] == stats["completed"],
            f"phase P (g): after SIGTERM admitted {stats['admitted']}, "
            f"completed {stats['completed']}")
    return {"rc": p.returncode, "ready_s": t_ready - t0,
            "stop_s": t_exit - t_signal, "admitted": stats["admitted"],
            "completed": stats["completed"],
            "drained": stats["rejected"]["drained"]}


def run_sharded_phase(gpu: str, shard_ranks: list, four: list) -> dict:
    """Phase O's way back and its checks, then phase P; the launch counts
    by path."""
    from distributedtensorflowexample_tpu_torch.serving import serve_lm
    from distributedtensorflowexample_tpu_torch.serving.loadgen import (
        DriveFile)
    ranks = launch.spawn(sharded_rank_phase, MR_RANKS, "gloo",
                         (SHARD_ROOT / "d4",), timeout_s=600)
    by_path = check_shard_phase(shard_ranks, four,
                                [r["elastic_back"] for r in ranks], gpu)
    results = SERVE_DIR / "sharded_drive.jsonl"
    results.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rc, text, stats = sharded_serve(
        "drive", "--drive", str(SHARDED_REQUESTS), "--clients",
        str(SHARDED_CLIENTS), "--drive_max_new", str(SHARDED_NEW),
        "--results", str(results))
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase P: sharded serve_lm exited {rc}:\n"
                     f"{text[-3000:]}")
    tokens = DriveFile(str(results)).done_ids()
    require(stats["completed"] == SHARDED_REQUESTS
            and sorted(tokens) == list(range(SHARDED_REQUESTS))
            and all(len(t) == SHARDED_NEW for t in tokens.values()),
            f"phase P (a): answered {stats['completed']} of "
            f"{SHARDED_REQUESTS}")
    agree = check_sharded_tokens(tokens)
    r0 = ranks[0]
    full_bytes = LM_PARAMS * 4
    for r in ranks:
        res = r["residency"]
        require(res["frac_per_device"] == 1 / MR_RANKS
                and res["params_bytes_per_device"] * MR_RANKS
                == res["params_bytes_total"]
                and res["params_bytes_total"] - res["padding_bytes"]
                == full_bytes,
                f"phase P (d): rank {r['rank']} residency {res}")
        require(r["allocated_after_promotion"]
                < full_bytes + MR_RANKS * r["local_cache_bytes"],
                f"phase P (d): rank {r['rank']} holds "
                f"{r['allocated_after_promotion']} bytes after promotion")
    # The launches of the drive's own ranks, each counted from 0 where
    # the rank starts (serve_lm's stats).
    launches = stats["launches_by_rank"]
    require(len(launches) == MR_RANKS
            and all(set(c) == set(SOURCES) and not any(c.values())
                    for c in launches),
            f"phase P: the serving ranks launched {launches}")
    require(r0["contract"] == [], f"phase P (e): SHARDED_DECODE_CONTRACT "
                                  f"broken: {r0['contract']}")
    require(all(v is not None and "--sharded_mesh" in v
                for v in r0["refusals"].values()),
            f"phase P (f): {r0['refusals']}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc7 = serve_lm.main(sharded_argv("seven", "--slots", "7",
                                         "--drive", "1"))
    require(rc7 == 2 and "--slots 7" in err.getvalue(),
            f"phase P (f): --slots 7 gave {rc7}: {err.getvalue()}")
    drill_result = sharded_sigterm_drill()
    B = r0["residency"]["num_buckets"]
    result = {
        "model": LM_SIZE, "ranks": MR_RANKS, "backend": "gloo",
        "slots": SHARDED_SLOTS, "cache_rows": SERVE_CACHE,
        "requests": SHARDED_REQUESTS, "clients": SHARDED_CLIENTS,
        "tokens_per_request": SHARDED_NEW,
        "tokens_per_sec": stats["tokens_per_sec"], "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"], "ttft_p50_ms": stats["ttft_p50_ms"],
        "decode_steps": stats["decode_steps"], "drive_wall_s": wall,
        "decode_ms_per_step": r0["decode_ms_per_step"],
        "buckets": B, "gathered_bytes_per_step":
            r0["residency"]["params_bytes_total"],
        "gathers_ms_per_step": [r["gathers_ms_per_step"] for r in ranks],
        "ms_per_all_gather": [r["gathers_ms_per_step"] / B for r in ranks],
        "residency_by_rank": [r["residency"] for r in ranks],
        "allocated_after_promotion_by_rank": [
            r["allocated_after_promotion"] for r in ranks],
        "load_s": [r["load_s"] for r in ranks],
        "contract": f"holds over {SHARDED_CONTRACT_STEPS} steps",
        "agreement": agree, "refused": ["--slots 7", *r0["refusals"]],
        "sigterm": drill_result,
        "launches_by_rank": launches, "gpu": gpu}
    print(json.dumps({"sharded_serving_path": result}), flush=True)
    print(f"sharded serving: {stats['tokens_per_sec']} tokens/s, decode "
          f"{r0['decode_ms_per_step']:.1f} ms a step, {B} all-gathers a step "
          f"({LM_SIZE}, 2 gloo ranks on one card: host-staged) on {gpu}",
          flush=True)
    by_path[f"{LM_SIZE}_sharded_serving_gloo2"] = launches
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu, flush=True)

    t0 = time.perf_counter()
    report = kbuild.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_source_s": {k: v["seconds"]
                                       for k, v in report.items()}}),
          flush=True)
    for name, r in report.items():
        print(json.dumps({"ptxas": name,
                          "kernels": kt.ptxas_summary(r["ptxas"])}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"floor_device_us": kt.floor_device_us(), "gpu": gpu}),
          flush=True)
    rows = {}                       # (kernel, B, C or None) -> row
    for batch in (BATCH, 256, 1000):
        rows[("dequant", batch, None)] = check_dequant(batch, gen, 200)
    for batch in (CIFAR_BATCH, 1000):
        rows[("dequant", batch, 3)] = check_dequant(
            batch, gen, 200, (32, 32, 3), 50000, "cifar")
    for batch, classes in kt.CE_SHAPES:
        rows[("ce_fwd", batch, classes)], rows[("ce_bwd", batch, classes)] = \
            check_ce(batch, classes, gen, 200)
    rows[("sgd", BATCH, None)] = check_sgd(gen, 50, "mnist_cnn")
    rows[("sgd", LM_BATCH, None)] = check_sgd(gen, 20, LM_SIZE)
    for (name, batch, classes), r in rows.items():
        extra = ({"n": r["n"], "ulp_mismatches": r["ulp_mismatches"]}
                 if "ulp_mismatches" in r else {})
        if classes is not None:
            # classes for cross-entropy; channels for dequant
            extra["C"] = classes
        print(json.dumps({"kernel": name, "B": batch, "kernel_ms": r["ms"],
                          "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"],
                          "kernel_device_us": r["kernel_device_us"],
                          "library_device_us": r["library_device_us"],
                          "bound_us": r["bound_ms"] * 1e3,
                          "max_abs_err": r["max_abs_err"], **extra,
                          "gpu": gpu}), flush=True)

    for model in ("mnist_cnn", "lm_small", "resnet20"):
        print(json.dumps({"card_vs_cpu_5_steps":
                          check_card_against_cpu(model)}), flush=True)

    result, counts = run_main_path(gpu)
    print(json.dumps({"main_path": result}), flush=True)
    print(f"main path: {result['steps_per_sec']:.1f} steps/s (last "
          f"100-step window, B={BATCH}) on {gpu}", flush=True)
    lm, lm_counts = run_lm_main_path(gpu)
    print(json.dumps({"lm_main_path": lm}), flush=True)
    print(f"lm main path: {lm['steps_per_sec']:.2f} steps/s (last 100-step "
          f"window, {LM_SIZE}, B={LM_BATCH} x T=128) on {gpu}", flush=True)

    cifar, cifar_counts = run_cifar_main_path(gpu)
    print(json.dumps({"cifar_main_path": cifar}), flush=True)
    print(f"cifar main path: {cifar['steps_per_sec']:.1f} steps/s (last "
          f"100-step window, resnet20, B={CIFAR_BATCH}) on {gpu}",
          flush=True)

    async_one = run_async_main_path()

    by_path = run_gloo_phases(gpu)
    report_async_path(async_one, by_path.pop("async_gloo2"), gpu)
    by_path.update(run_nccl_phase(gpu))
    softmax_counts = run_local_mnist(gpu)
    by_path.update(run_multiworker_phase(gpu))
    by_path.update(run_resume_phase(gpu))
    run_drill_phase(gpu)
    by_path.update(run_host_fed_phase(gpu))
    by_path.update(run_remat_phase(gpu))
    by_path.update(run_telemetry_phase(gpu))
    by_path.update(run_mode_phases(gpu, ("L", "M", "N", "I'", "SH")))
    shard_ranks, four = run_shard_phase()
    serving_counts = run_serving_phase(gpu)
    by_path.update(run_sharded_phase(gpu, shard_ranks, four))

    line = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[(name, BATCH, 10 if name.startswith("ce_") else None)]
        paths = {"mnist_cnn": counts[name], LM_SIZE: lm_counts[name],
                 "resnet20": cifar_counts[name],
                 "softmax": softmax_counts[name],
                 "mnist_cnn_async": async_one["launches"][name],
                 "serving": serving_counts[name],
                 **{p: [c[name] for c in per_rank]
                    for p, per_rank in by_path.items()}}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(sum(v) if isinstance(v, list) else v
                                     for v in paths.values()),
                     "launches_by_path": paths,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
