"""Run configuration and the reference-compatible CLI flag surface.

A copy of the JAX package's ``config.py``: the same ``RunConfig`` fields,
flags and defaults, so one command line drives either package.  The port
adds ``--device cuda|cpu`` (default ``cuda``); flags whose modes the port
does not run yet are still parsed and are refused by name where they are
read (``engine/engine.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence


@dataclasses.dataclass
class RunConfig:
    """Everything a trainer needs, parsed from flags.

    Mirrors the flag surface of the reference scripts; cluster fields are
    compatibility aliases interpreted by :mod:`..cluster` rather than a
    description of real parameter-server processes.
    """

    # --- cluster compatibility flags (reference: tf.train.ClusterSpec) ---
    job_name: str = ""              # "", "ps", "worker"
    task_index: int = 0
    ps_hosts: str = ""              # comma-separated host:port (compat alias)
    worker_hosts: str = ""          # comma-separated host:port (compat alias)

    # --- multi-host bootstrap (replaces TF_CONFIG / tf.train.Server) ---
    coordinator_address: str = ""   # host:port of process 0; "" = single host
    num_processes: int = 1
    process_id: int = -1            # -1 = derive from task_index

    # --- training hyper-parameters ---
    batch_size: int = 100           # per-replica batch size (reference semantics:
                                    # per-worker batching; global = batch*replicas)
    global_batch: bool = False      # if True, batch_size is the global batch
    train_steps: int = 1000
    learning_rate: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    lr_schedule: str = "constant"   # constant | cosine | step
    warmup_steps: int = 0
    dropout: float = 0.5
    label_smoothing: float = 0.0
    seed: int = 0

    # --- data / logging ---
    data_dir: str = "/tmp/data"
    log_dir: str = "/tmp/train_logs"
    dataset: str = "mnist"          # mnist | cifar10 | synthetic
    eval_every: int = 0             # 0 = eval only at end
    log_every: int = 100
    checkpoint_every: int = 0       # 0 = no periodic checkpoints
    keep_checkpoints: int = 3
    async_checkpoint: bool = True   # background (async) Orbax saves;
                                    # false = synchronous saves (the
                                    # reference Saver's behavior)
    resume: bool = True             # auto-restore latest checkpoint if present
    profile_dir: str = ""           # "" = no trace; else jax.profiler logdir
    profile_start_step: int = 10    # trace starts after this step completes
                                    # (first traced step is start+1, past compile)
    profile_num_steps: int = 5      # trace window length

    # --- parallelism ---
    num_devices: int = 0            # 0 = all visible devices
    sync_mode: str = "sync"         # sync | async (async = local-SGD emulation)
    async_period: int = 8           # param-averaging period for async emulation
    replicas_to_aggregate: int = 0  # SyncReplicasOptimizer partial
                                    # aggregation: R of N replica gradients
                                    # enter each update (rotating subset);
                                    # 0 = all
    dtype: str = "bfloat16"         # compute dtype (params stay f32)
    device: str = "cuda"            # cuda | cpu — where the port runs; cuda
                                    # without a card raises, never falls
                                    # back to the CPU

    # --- memory-traffic knobs (PR-2 bytes diet) ---
    remat: str = "none"             # none | block — checkpoint each residual
                                    # block: backward recomputes the block's
                                    # forward instead of keeping activations
                                    # resident (~1 extra forward of flops for
                                    # an activation footprint of one block);
                                    # resnet20 only, other models ignore it
    shard_update: bool = False      # shard the f32 master-param update +
                                    # optimizer state across the data mesh
                                    # (arXiv:2004.13336): per-chip weight-
                                    # update bytes drop ~1/D; params stay
                                    # replicated for fwd/bwd (sync mode only)
    bucket_grads: str = ""          # "" | auto | <bytes> — fuse the
                                    # per-parameter gradient all-reduces
                                    # into knee-sized buckets (one psum
                                    # per bucket; auto = the measured
                                    # collective knee, bench_collectives).
                                    # With --shard_update: the explicit
                                    # per-bucket reduce-scatter + sharded
                                    # update + all-gather ZeRO-1 schedule.
                                    # Async mode buckets the worker-
                                    # average psums.  No BatchNorm models
    shard_params: bool = False      # ZeRO-3/FSDP (parallel/zero3.py):
                                    # params AND grads live as 1/D
                                    # bucket rows; each bucket's params
                                    # all-gathered just before use and
                                    # freed after, grads reduce-
                                    # scattered per bucket by the
                                    # gather's transpose.  Requires
                                    # --bucket_grads (the row layout);
                                    # sync mode only; no BN models
    zero3_overlap: bool = True      # --shard_params gather schedule:
                                    # true = double-buffered prefetch
                                    # (bucket i+1's all-gather issues
                                    # while bucket i's compute runs);
                                    # false = strictly serial gathers
                                    # (the A/B control bench_lm times).
                                    # Pure scheduling — bitwise-same

    # --- hand-written TPU kernels (ops/pallas) ---
    pallas_ce: bool = False         # fused Pallas loss head in the train step
    fused_optimizer: bool = False   # fused Pallas momentum-SGD apply; measured
                                    # 2.3x SLOWER than XLA's fused apply on a
                                    # v5e chip (flatten/unflatten HBM traffic,
                                    # see BASELINE.md round-2) — kept opt-in
                                    # as the kernel-authoring reference

    # --- input pipeline ---
    device_data: str = "auto"       # auto | on | off — dataset resident in
                                    # HBM with on-device batch gather (kills
                                    # the per-step H2D copy). auto ≡ on in
                                    # EVERY mode (sync, async, augmented)
                                    # since the round-2 unfencing; "off"
                                    # selects the host Batcher+prefetch path
    steps_per_loop: int = 0         # SGD steps fused into one compiled call
                                    # (lax.scan); device_data path only.
                                    # Amortizes dispatch latency like Keras
                                    # steps_per_execution.  0 = AUTO: the
                                    # largest divisor of the remaining
                                    # steps AND the log/eval/checkpoint
                                    # intervals, <= min(64, steps_per_
                                    # epoch) — out-of-box dispatch
                                    # amortization with hooks still on
                                    # their exact steps; pass 1 for one
                                    # dispatch per step
    quantize: str = "auto"          # auto | off | exact | scale — hold
                                    # 8-bit-exact splits as uint8 (4x less
                                    # HBM + gather/upload bytes); all of
                                    # auto/exact/scale select uint8
                                    # storage, off keeps float32
    dequant_impl: str = "auto"      # auto | affine | onehot | lut |
                                    # pallas — the in-step dequant kernel
                                    # for quantized splits.  auto lowers
                                    # to the fused affine (bitwise-
                                    # verified against the 256-entry LUT
                                    # per split; true for MNIST/CIFAR),
                                    # falling back to the one-hot form
                                    # only for non-affine-representable
                                    # splits; lut is the known-slow
                                    # elementwise-gather diagnostic;
                                    # pallas fuses gather+dequant into
                                    # one kernel (replicated data only)
    data_sharding: str = "replicated"  # replicated | sharded — sharded
                                    # splits the resident dataset row-wise
                                    # over the mesh (per-device HBM /
                                    # mesh_size; per-shard shuffling like
                                    # the reference's per-worker dataset
                                    # sharding); device_data path only

    @property
    def ps_host_list(self) -> list[str]:
        return [h for h in self.ps_hosts.split(",") if h]

    @property
    def worker_host_list(self) -> list[str]:
        return [h for h in self.worker_hosts.split(",") if h]


# --help text per flag, kept in sync with actual behavior (round-2 verdict
# caught "auto = sync mode without augmentation" surviving the async
# unfencing; tests/test_config.py asserts the corrected semantics).
_FLAG_HELP = {
    "job_name": 'reference role: "", "ps", or "worker" (ps exits with a '
                "notice: no parameter servers exist on the SPMD mesh)",
    "task_index": "reference task index within --job_name",
    "ps_hosts": "compat alias (comma-separated host:port); no gRPC PS "
                "processes are spawned",
    "worker_hosts": "compat alias; worker list maps onto the device mesh",
    "coordinator_address": "host:port of process 0 for multi-host "
                           "jax.distributed; empty = single host",
    "num_processes": "number of participating host processes",
    "process_id": "this process's id; -1 = derive from --task_index",
    "batch_size": "per-replica batch (reference per-worker semantics; "
                  "global = batch_size x replicas)",
    "global_batch": "if true, --batch_size is the GLOBAL batch",
    "train_steps": "total optimizer steps",
    "learning_rate": "SGD learning rate",
    "momentum": "SGD momentum (0 = plain SGD)",
    "weight_decay": "decoupled weight decay",
    "lr_schedule": "constant | cosine | step",
    "warmup_steps": "linear LR warmup steps",
    "dropout": "dropout rate for CNN FC head",
    "label_smoothing": "cross-entropy label smoothing",
    "seed": "global RNG seed (data order + init)",
    "data_dir": "dataset directory (IDX/.gz MNIST, pickle/binary CIFAR); "
                "missing files are an error unless --dataset synthetic",
    "log_dir": "logs, scalars.jsonl, tfevents, checkpoints",
    "dataset": "mnist | cifar10 | synthetic — synthetic is the explicit "
               "opt-in to the deterministic synthetic split (missing real "
               "bytes never silently substitute)",
    "eval_every": "eval every N steps (0 = only at end)",
    "log_every": "log scalars every N steps",
    "checkpoint_every": "checkpoint every N steps (0 = none periodic)",
    "keep_checkpoints": "keep newest N checkpoints",
    "async_checkpoint": "background Orbax saves (training does not stall "
                        "on serialization); false = synchronous saves "
                        "like the reference's Saver",
    "resume": "auto-restore latest checkpoint in --log_dir",
    "profile_dir": "jax.profiler trace output dir (empty = no trace)",
    "profile_start_step": "trace starts after this step (skips compile)",
    "profile_num_steps": "trace window length in steps",
    "num_devices": "mesh size (0 = all visible devices)",
    "sync_mode": "sync (psum all-reduce per step) | async (local-SGD "
                 "emulation of PS staleness, averaged every --async_period)",
    "async_period": "async mode: steps between parameter averagings",
    "replicas_to_aggregate": "SyncReplicasOptimizer parity: R of N replica "
                             "gradients enter each update (rotating "
                             "subset); 0 = all",
    "dtype": "compute dtype (params stay float32)",
    "device": "cuda | cpu — the torch device the port runs on; cuda "
              "without a visible card is an error (no CPU fallback)",
    "remat": "none | block — rematerialize each residual block in the "
             "backward pass (recompute instead of store; trades ~1 extra "
             "forward of flops for an activation HBM footprint of one "
             "block). Same math bitwise; resnet20 only",
    "shard_update": "shard the optimizer state + weight-update compute "
                    "across the data-parallel mesh (ZeRO-1 / "
                    "arXiv:2004.13336): each chip updates 1/D of the "
                    "params and the update is all-gathered; params stay "
                    "replicated for compute. Sync mode only",
    "bucket_grads": "'' | auto | <bytes> — fuse per-parameter gradient "
                    "all-reduces into buckets of at most this many bytes "
                    "(strictly fewer, larger collectives; same gradient "
                    "math — see DESIGN.md §15). auto = sized from the "
                    "measured collective knee (bench_collectives.py; "
                    "BUCKET_GRADS_AUTO_BYTES overrides). Composes with "
                    "--shard_update into the explicit per-bucket "
                    "reduce-scatter + sharded-update + all-gather ZeRO-1 "
                    "schedule; in async mode buckets the worker-average "
                    "psums. Refused by name for BatchNorm models and "
                    "--fused_optimizer",
    "shard_params": "ZeRO-3/FSDP full param+grad sharding "
                    "(arXiv:2004.13336 stage 3): params and grads live "
                    "resident as 1/D bucket rows, each bucket's params "
                    "all-gathered just before its layer consumes them "
                    "(double-buffered prefetch — see --zero3_overlap) "
                    "and freed after last use, grads reduce-scattered "
                    "per bucket, the 1/D update written straight back "
                    "(no step-closing all-gather). Per-device "
                    "param+grad+opt residency ~1/D. Requires "
                    "--bucket_grads; sync mode only; changes the "
                    "checkpoint layout (zero3_rows — cross-layout and "
                    "cross-mesh-size resume refused by name)",
    "zero3_overlap": "with --shard_params: true (default) issues bucket "
                     "i+1's all-gather while bucket i's compute runs "
                     "(at most two gathered buckets in flight — the "
                     "double buffer); false chains the gathers strictly "
                     "serially. Scheduling only, bitwise-identical "
                     "results — the overlap A/B bench_lm.py measures",
    "pallas_ce": "fused cross-entropy head (the CUDA kernel pair in "
                 "ops/kernels/cross_entropy.py; the flag keeps the JAX "
                 "package's name)",
    "fused_optimizer": "fused momentum-SGD apply over flat parameter "
                       "buffers (CUDA kernel, ops/kernels/sgd.py); "
                       "rejected under async",
    "device_data": "auto | on | off — dataset resident in HBM with "
                   "on-device batch gather; auto is equivalent to on in "
                   "every mode (sync, async, augmented CIFAR); off = host "
                   "Batcher + prefetch",
    "steps_per_loop": "SGD steps fused per compiled call (lax.scan over "
                      "the device-resident dataset); like Keras "
                      "steps_per_execution. 0 = auto: largest divisor of "
                      "the remaining steps and the log/eval/checkpoint "
                      "intervals, <= min(64, steps_per_epoch); 1 = one "
                      "dispatch per step",
    "quantize": "auto | off | exact | scale — store 8-bit-exact splits "
                "as uint8 in HBM/host memory (4x less gather and upload "
                "traffic; 8-bit recoverability verified bitwise at build "
                "time); off = always float32.  Which dequant kernel runs "
                "in-step is --dequant_impl's decision",
    "dequant_impl": "auto | affine | onehot | lut | pallas — in-step "
                    "dequant kernel for quantized splits. auto = fused "
                    "affine (u8 * scale + bias, one fused multiply-add) "
                    "when it reproduces the 256-entry LUT bitwise "
                    "(verified per split at quantize time; true for the "
                    "MNIST/CIFAR loader specs — measured 4.1x over the "
                    "round-4 LUT gather on chip), else one-hot-matmul "
                    "LUT (bitwise on any backend). lut = elementwise "
                    "gather diagnostic (the known-slow round-4 form); "
                    "pallas = fused gather+dequant kernel (CUDA, "
                    "ops/kernels/dequant.py; replicated device_data only)",
    "data_sharding": "replicated | sharded — sharded stores the resident "
                     "split row-wise across the mesh (per-device HBM "
                     "divided by mesh size; shuffling becomes per-shard, "
                     "like the reference's per-worker dataset sharding); "
                     "requires the device_data path",
}


def build_parser(description: str = "PyTorch trainer") -> argparse.ArgumentParser:
    """Argparse parser exposing the full reference-compatible flag surface."""
    p = argparse.ArgumentParser(description=description)
    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    for name, f in fields.items():
        arg = "--" + name
        doc = _FLAG_HELP.get(name, "")
        helptext = f"{doc} (default: {f.default})" if doc else \
            f"(default: {f.default})"
        if f.type in ("bool", bool):
            p.add_argument(arg, type=_str2bool, default=f.default,
                           help=helptext)
        else:
            typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            if isinstance(f.default, int) and not isinstance(f.default, bool):
                typ = int
            elif isinstance(f.default, float):
                typ = float
            p.add_argument(arg, type=typ, default=f.default, help=helptext)
    return p


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def parse_flags(argv: Sequence[str] | None = None,
                description: str = "PyTorch trainer",
                **overrides) -> RunConfig:
    """Parse argv into a RunConfig; ``overrides`` win over defaults."""
    parser = build_parser(description)
    parser.set_defaults(**overrides)
    ns, _ = parser.parse_known_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(RunConfig)}
    return RunConfig(**kwargs)
