"""The Engine (the JAX package's ``engine/engine.py`` ``Engine.run``), for
every replication mode of ``engine/spec.MODES`` (``sync_dp``,
``async_ps``, ``bucketed``, ``zero1``, ``zero3``) on one rank or on N
ranks, one process each.

``Engine(spec).run()`` resolves the cluster flags (a ``ps`` role prints
the notice and exits), refuses by name every mode the port does not run
yet, and then either

* starts ``--num_devices N`` local ranks (N > 1, no cluster flags, no
  process group yet: ``parallel/launch.py``; on ``cuda`` 0 means every
  visible card), each of which runs this same method inside the group and
  sends back its summary, rank 0's being the one returned; or
* under the cluster flags with M = ``--num_devices / num_processes`` > 1
  (``parallel/mesh.ranks_per_process``; ``--num_devices`` is the global
  rank count, as in JAX), is a launcher: it starts its M ranks, the
  global ranks ``process_id*M ..``, into the one group of N*M ranks over
  ``tcp://<coordinator_address>``, joins no group itself and returns its
  first rank's summary; or
* runs one rank: joins or takes the process group
  (``cluster.maybe_initialize_distributed``), places itself on its card
  (``parallel/mesh.py``), checks that every rank was started with the
  same config (a crc32 digest, all-gathered), loads the split, builds the
  model, optimizer and state with the device-resident dataset and the
  indexed train step over this rank's slice of the global batch
  (``Engine.build``), runs the loop with its hooks, and ends with an
  exact eval on the held-out split.

Checkpoints (``training/checkpoint.py``) go to ``<log_dir>/checkpoints``
whenever ``--checkpoint_every > 0`` or ``--resume`` (the default), unless
``--log_dir`` is empty.  A resumed run restores the newest checkpoint
before the dataset is built, so the epoch slots line up with the
restored step, and trains the remaining ``train_steps - step`` steps.
SIGTERM (preemption) sets a flag that the loop polls at call boundaries;
on N ranks they agree on the stop through an all-gather every
``max(1, 64 // steps_per_call)`` boundaries.  The run then saves, prints
``SIGTERM at step N: checkpoint saved, restart auto-resumes; exiting
143`` and raises ``SystemExit(143)``.

``--device_data off`` feeds the step from the host instead
(``data/pipeline.py``: the ``Batcher``'s shuffled rows, this rank's part
of each global batch, uploaded by a ``DevicePrefetcher``; the JAX
Engine's refusals with it: token data, ``--data_sharding sharded``,
``--dequant_impl pallas`` and ``--steps_per_loop > 1``), and evaluates
with the host-fed ``parallel/sync.evaluate``.  ``--data_sharding
sharded`` keeps only this rank's block of the split resident
(``data/device_dataset.py``).

``--sync_mode async`` (config 2) runs local SGD with one worker per rank
(``parallel/async_ps.py``): its checkpoint holds every rank's own part,
and its eval runs on the workers' average (parameters and batch-norm
statistics).

The mode comes from the flags and the rank count (``_resolve_flags``,
the JAX package's, with its refusals and messages; ``describe()`` shows
the resolution without building anything).  ``apply_update_layout``
lays the fresh state out for it before any restore: the momentum as
this rank's bucket rows (``bucket_rows``; and the tree form of
``--shard_update``, whose checkpoint stays ``tree``), or the parameters
too (``zero3_rows``).  A row layout is one checkpoint part per rank, and
``run_metadata.json`` records the layout and the bucket cap, so a
resume into another layout, or a row layout on another mesh size, is
refused by name.  With ``SNAPSHOT_DIR`` set, a row-layout run also
writes shard-redundant snapshots there every ``--checkpoint_every`` steps
(``resilience/shardstore.py``: per-rank shards, ring mirrors, a quorum
manifest), and a resume restores the newest quorum-valid set first,
written at any mesh width (``ShardStore.restore_elastic``), ahead of the
checkpoints.  The flight recorder (``OBS_FLIGHT``), the run ledger
(``OBS_LEDGER``) and the live scrape (``OBS_HTTP_PORT``) arm as in the JAX
Engine; every run also arms ``AnomalyHook`` after ``MetricsHook``
(``health.json`` under ``OBS_HEALTH``), writes a tfevents file beside
``scalars.jsonl`` when ``--log_dir`` is set, and with ``--profile_dir``
traces a window of steps (``utils/profiling.ProfilerHook``).

The workloads: config 1 (``softmax`` on ``mnist``), config 3
(``mnist_cnn`` on ``mnist``), configs 4 and 5 (``resnet20`` on
``cifar10``, with the on-device crop and flip: ``RunSpec.augment``) and
the transformer LM (``lm_tiny``, ``lm_small``, ``lm_base`` on the ``lm``
token split); ``RunSpec.model_fn`` and ``input_fn`` declare any other
(``trainers/trainer_tiny_mlp.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import os
import zlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributedtensorflowexample_tpu_torch import cluster
from distributedtensorflowexample_tpu_torch.config import RunConfig
from distributedtensorflowexample_tpu_torch.data.cifar10 import (
    augment as cifar_augment)
from distributedtensorflowexample_tpu_torch.data.cifar10 import load_cifar10
from distributedtensorflowexample_tpu_torch.data.device_dataset import (
    DEQUANT_IMPLS, DeviceDataset)
from distributedtensorflowexample_tpu_torch.data.lm import load_lm
from distributedtensorflowexample_tpu_torch.data.mnist import load_mnist
from distributedtensorflowexample_tpu_torch.data.pipeline import (
    Batcher, DevicePrefetcher)
from distributedtensorflowexample_tpu_torch.engine.spec import (
    ModeDecl, collective_budget, resolve_contract, resolve_mode,
    shards_tree_update)
from distributedtensorflowexample_tpu_torch.models import build_model
from distributedtensorflowexample_tpu_torch.obs import ledger as obs_ledger
from distributedtensorflowexample_tpu_torch.obs import recorder as obs_recorder
from distributedtensorflowexample_tpu_torch.obs import serve as obs_serve
from distributedtensorflowexample_tpu_torch.ops.kernels import launch_counts
from distributedtensorflowexample_tpu_torch.ops.kernels import build as kbuild
from distributedtensorflowexample_tpu_torch.parallel.launch import spawn
from distributedtensorflowexample_tpu_torch.parallel.async_ps import (
    consolidated, make_async_train_step, make_indexed_async_train_step)
from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
    BucketPlan, resolve_bucket_bytes)
from distributedtensorflowexample_tpu_torch.parallel.mesh import (
    ONE_RANK, Mesh, local_world_size, make_mesh, ranks_per_process)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    make_indexed_train_step, make_resident_eval, make_train_step)
from distributedtensorflowexample_tpu_torch.parallel.sync import (
    evaluate as host_evaluate)
from distributedtensorflowexample_tpu_torch.parallel.zero3 import (
    Zero3Layout, materialized)
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.resilience.shardstore import (
    ShardLayout, ShardSnapshotHook, ShardStore)
from distributedtensorflowexample_tpu_torch.training.checkpoint import (
    CheckpointManager)
from distributedtensorflowexample_tpu_torch.training.hooks import (
    AnomalyHook, CheckpointHook, EvalHook, HeartbeatHook, MetricsHook)
from distributedtensorflowexample_tpu_torch.training.loop import TrainLoop
from distributedtensorflowexample_tpu_torch.training.metrics import (
    MetricsLogger)
from distributedtensorflowexample_tpu_torch.training.optimizers import (
    build_optimizer)
from distributedtensorflowexample_tpu_torch.training.state import TrainState
from distributedtensorflowexample_tpu_torch.utils.signals import sigterm_flag

# Auto --steps_per_loop unroll ceiling (the JAX package's value).
_AUTO_UNROLL_CAP = 64
# Global steps between two stop-consensus polls on N ranks (and between
# two heartbeat touches): tens of steps of latency are nothing against a
# preemption's grace period, and a poll per step would tax every step.
_CONSENSUS_POLL_STEPS = 64
# Models with batch norm: the bucketed and ZeRO steps would normalize
# over each rank's rows (refused in sync mode, as in JAX); async mode
# normalizes each worker over its own rows, as the JAX vmap does.
_BATCH_NORM_MODELS = frozenset({"resnet20"})

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class RunSpec:
    """What to run: the workload's model and dataset names plus the
    parsed flags (the JAX package's ``engine/spec.py`` RunSpec).  The
    ``lm`` dataset is an integer token split; every other one holds
    images.  ``augment``: the CIFAR random crop and flip in the train step.
    ``model_fn(cfg) -> nn.Module`` replaces the models registry (the
    module has the port models' ``reset_parameters(generator)`` and
    ``forward(x, train, generator)``), and ``input_fn(cfg, split) -> (x,
    y)`` the dataset loader."""

    model: str
    dataset: str
    config: RunConfig
    augment: bool = False
    model_fn: Optional[Callable] = None
    input_fn: Optional[Callable] = None


def auto_steps_per_loop(remaining: int, steps_per_epoch: int,
                        cap: int = _AUTO_UNROLL_CAP,
                        intervals: tuple = (), start: int = 0) -> int:
    """The unroll ``--steps_per_loop 0`` selects: the largest value <=
    min(cap, steps_per_epoch, remaining) dividing the remaining steps,
    every positive interval and the start step, so hooks fire on their
    exact marks."""
    g = math.gcd(remaining, start)
    for iv in intervals:
        if iv and iv > 0:
            g = math.gcd(g, iv)
    hi = min(cap, steps_per_epoch, remaining)
    for d in range(min(hi, g), 1, -1):
        if g % d == 0:
            return d
    return 1


def _load_dataset(cfg: RunConfig, name: str, split: str):
    if cfg.dataset not in (name, "synthetic"):
        raise ModeRefusal(
            f"--dataset {cfg.dataset!r} does not match this trainer's "
            f"dataset {name!r}; pass --dataset {name} (real bytes in "
            f"--data_dir) or --dataset synthetic")
    source = "synthetic" if cfg.dataset == "synthetic" else "real"
    if name == "mnist":
        return load_mnist(cfg.data_dir, split, seed=cfg.seed, source=source)
    if name == "cifar10":
        return load_cifar10(cfg.data_dir, split, seed=cfg.seed,
                            source=source)
    if name == "lm":
        # Both sources are the synthetic chain (data/lm.py).
        return load_lm(cfg.data_dir, split, seed=cfg.seed, source=source)
    raise ModeRefusal(f"the {name!r} dataset is not ported to the PyTorch "
                      f"package yet")


def _resolve_flags(cfg: RunConfig, num_replicas: int,
                   token_data: bool = False) -> tuple:
    """The JAX Engine's ``_resolve_flags``: flag validation before any data
    is loaded, with its refusals and their messages.  Returns
    ``(bucket_bytes, mode)``: the cap, and the ``engine/spec.MODES`` row
    the flags resolve to on ``num_replicas`` ranks (on one rank, or in
    async mode, the bucket knobs fall through to the plain step)."""
    if cfg.sync_mode == "async" and cfg.fused_optimizer:
        raise ModeRefusal(
            "--fused_optimizer is not supported with sync_mode=async")
    if cfg.device_data not in ("auto", "on", "off"):
        raise ValueError(f"unknown device_data {cfg.device_data!r}")
    if token_data and cfg.device_data == "off":
        raise ModeRefusal(
            "the lm dataset is an integer token split and runs on the "
            "device-resident input path only; --device_data off selects "
            "the host float-image Batcher, which would dequantize token "
            "ids into pixels. Drop --device_data off")
    if cfg.sync_mode not in ("sync", "async"):
        raise ValueError(f"unknown sync_mode {cfg.sync_mode!r}")
    if cfg.data_sharding not in ("replicated", "sharded"):
        raise ValueError(f"unknown data_sharding {cfg.data_sharding!r}")
    if cfg.data_sharding == "sharded" and cfg.device_data == "off":
        raise ModeRefusal("--data_sharding sharded requires the "
                          "device-resident input path (device_data)")
    if cfg.dequant_impl not in DEQUANT_IMPLS:
        raise ValueError(f"unknown dequant_impl {cfg.dequant_impl!r} "
                         f"(one of {DEQUANT_IMPLS})")
    if cfg.dequant_impl == "pallas" and (cfg.device_data == "off"
                                         or cfg.data_sharding == "sharded"):
        raise ModeRefusal("--dequant_impl pallas fuses the on-device "
                          "row gather with the dequant; it requires the "
                          "replicated device-resident input path")
    if cfg.shard_update and cfg.sync_mode == "async":
        raise ModeRefusal(
            "--shard_update shards ONE replicated update across the "
            "mesh; async mode's state is already worker-tiled (each "
            "device owns its workers' whole update) — there is no "
            "cross-replica redundancy to shard away")
    bucket_bytes = resolve_bucket_bytes(cfg.bucket_grads)
    if bucket_bytes and cfg.fused_optimizer:
        raise ModeRefusal(
            "--bucket_grads restructures the gradient reduction around "
            "the optimizer apply; the Pallas fused apply is a custom "
            "call with its own layout contract — use one or the other")
    if cfg.shard_params and cfg.sync_mode != "sync":
        raise ModeRefusal(
            "--shard_params shards the sync data-parallel step's "
            "params across the mesh; async mode's state is "
            "worker-tiled (each device already owns its workers' "
            "whole copy) — there is no cross-replica redundancy to "
            "shard away")
    if cfg.shard_params and not bucket_bytes:
        raise ModeRefusal(
            "--shard_params lays params out in the knee-sized "
            "dtype-homogeneous bucket rows; pass --bucket_grads (auto, "
            "or a byte cap) to size them")
    return bucket_bytes, resolve_mode(cfg, num_replicas)


def _refuse_for_mode(cfg: RunConfig, model: str, bucket_bytes,
                     num_replicas: int) -> None:
    """The JAX Engine's refusal that depends on the model and the rank
    count, by the model's name before any data is loaded: a batch-norm
    model under ``--bucket_grads`` in sync mode."""
    if (bucket_bytes and cfg.sync_mode == "sync" and num_replicas > 1
            and model in _BATCH_NORM_MODELS):
        raise ModeRefusal(
            f"--bucket_grads cannot run {model!r}: its BatchNorm "
            f"computes global-batch statistics, which the bucketed "
            f"per-shard gradient region would silently turn into "
            f"per-shard statistics (a different model, not a "
            f"different collective schedule). Use the default fused "
            f"all-reduce for BatchNorm models")


def _refuse_unported(cfg: RunConfig, info: cluster.ClusterInfo) -> None:
    """Named refusals checked before any data is loaded or any rank is
    started: a bad dtype, knobs of the other sync mode, checkpoints with
    no ``--log_dir``, and a ``--num_devices`` that is not the rank count
    of a group the caller already initialized."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} (one of "
                         f"{tuple(_DTYPES)})")
    if cfg.sync_mode == "async" and cfg.replicas_to_aggregate:
        raise ModeRefusal(
            "--replicas_to_aggregate is a SyncReplicasOptimizer "
            "(sync-mode) concept; async mode has no aggregation "
            "barrier to relax")
    if cfg.checkpoint_every > 0 and not cfg.log_dir:
        raise ModeRefusal(
            "--checkpoint_every > 0 writes checkpoints under --log_dir, "
            "which is empty; pass a --log_dir (or --checkpoint_every 0)")
    if dist.is_initialized():
        world = dist.get_world_size()
        if cfg.num_devices not in (0, world):
            raise ModeRefusal(
                f"--num_devices {cfg.num_devices} inside a process group of "
                f"{world} ranks: the group is the mesh (--num_devices 0 or "
                f"{world})")


def _expected_ranks(cfg: RunConfig, info: cluster.ClusterInfo) -> int:
    """The global rank count a run will have, before any rank is started:
    the caller's group, N*M under the cluster flags, or the local ranks."""
    if dist.is_initialized():
        return dist.get_world_size()
    if info.is_distributed:
        return info.num_processes * ranks_per_process(
            cfg.num_devices, info.num_processes, cfg.device)
    return local_world_size(cfg.num_devices, cfg.device)


def _refuse_incompatible_restore(saved: dict | None, current: dict,
                                 log_dir: str, is_chief: bool) -> None:
    """Named refusal of a restore into another state layout (the JAX
    Engine's, with its messages): another ``sync_mode``, another
    ``update_layout``, a row layout on another mesh size, or async state
    of another worker count.  A ``tree`` restore on another mesh size is
    allowed (the state is replicated), with a note.  ``saved`` is None
    for a directory with no metadata: the restore proceeds."""
    if not saved:
        return
    if saved.get("sync_mode", current["sync_mode"]) != current["sync_mode"]:
        raise ModeRefusal(
            f"checkpoint in {log_dir}/checkpoints was written by a "
            f"sync_mode={saved['sync_mode']!r} run; restoring it into "
            f"sync_mode={current['sync_mode']!r} would mismatch the state "
            f"layout (worker-tiled vs replicated). Use a fresh --log_dir "
            f"or rerun with --sync_mode={saved['sync_mode']}")
    # A checkpoint with no update_layout key can only hold the tree.
    saved_layout = saved.get("update_layout", "tree")
    if saved_layout != current.get("update_layout"):
        raise ModeRefusal(
            f"checkpoint in {log_dir}/checkpoints holds "
            f"{saved_layout!r} optimizer state; this run uses "
            f"{current['update_layout']!r} (--bucket_grads with "
            f"--shard_update stores per-bucket flat rows instead of the "
            f"params-shaped tree; --shard_params stores the PARAMS as "
            f"rows too — zero3_rows). Resume with the writing run's "
            f"knobs or start fresh with a new --log_dir")
    if (saved_layout.endswith("_rows")
            and saved.get("mesh_size") is not None
            and saved["mesh_size"] != current["mesh_size"]):
        raise ModeRefusal(
            f"checkpoint in {log_dir}/checkpoints holds {saved_layout} "
            f"state laid out for mesh_size="
            f"{saved['mesh_size']}; this run has mesh_size="
            f"{current['mesh_size']} — the 1/D row layout is structural. "
            f"Resume on {saved['mesh_size']} devices or start fresh "
            f"with a new --log_dir")
    if (saved.get("num_workers") is not None
            and saved["num_workers"] != current["num_workers"]):
        raise ModeRefusal(
            f"checkpoint in {log_dir}/checkpoints holds async worker-tiled "
            f"state for num_workers={saved['num_workers']}; this run has "
            f"num_workers={current['num_workers']} (mesh size "
            f"{current['mesh_size']}). The leading worker axis is "
            f"structural — resume on {saved['num_workers']} devices or "
            f"start fresh with a new --log_dir")
    if (is_chief and saved.get("mesh_size") is not None
            and saved["mesh_size"] != current["mesh_size"]):
        print(f"note: resuming a mesh_size={saved['mesh_size']} checkpoint "
              f"on mesh_size={current['mesh_size']} (fine for sync mode: "
              f"state is replicated)", flush=True)


def apply_update_layout(state: TrainState, *, update_layout: str,
                        bucket_bytes: int | None = None,
                        mesh: Mesh = ONE_RANK,
                        shard_update: bool = False):
    """The one re-layout of a fresh (replicated) state into the mode's
    working layout (the JAX Engine's): returns ``(state,
    zero3_layout_or_None)``.

    * ``zero3_rows``: the parameters and the momentum become this rank's
      bucket rows (``MomentumSGD.shard_params``); the flat buffers go.
    * ``bucket_rows``: the momentum becomes this rank's bucket rows
      (ZeRO-1); the parameters stay replicated.
    * ``tree`` with ``shard_update`` on N > 1 ranks: the momentum as
      this rank's rows of ONE bucket over every parameter (the tree form
      of ``--shard_update``; its checkpoint keeps the full tree).
    """
    opt = state.optimizer
    if update_layout == "zero3_rows":
        layout = Zero3Layout(opt.slices, bucket_bytes, mesh)
        opt.shard_params(layout, mesh.rank, state.model)
        return state, layout
    if update_layout == "bucket_rows":
        opt.shard_rows(BucketPlan(opt.slices, bucket_bytes, mesh.size),
                       mesh.rank)
    elif shard_update and mesh.size > 1:
        # One bucket of every parameter: a cap no bucket reaches.
        everything = 4 * sum(shape.numel() for _, shape in
                             opt.slices.values())
        opt.shard_rows(BucketPlan(opt.slices, everything, mesh.size),
                       mesh.rank, layout="tree")
    return state, None


def _step_plan(state: TrainState, mode: ModeDecl, bucket_bytes,
               mesh: Mesh) -> BucketPlan | None:
    """The bucket plan a step runs on, made once: the optimizer's, where
    :func:`apply_update_layout` laid the state out in rows (``zero1``,
    ``zero3`` and ``--shard_update``'s tree form), else the
    ``--bucket_grads`` plan of the bucketed all-reduce or of async
    mode's bucketed average on N > 1 ranks."""
    opt = state.optimizer
    if opt.plan is not None:
        return opt.plan
    if (bucket_bytes and mesh.size > 1
            and mode.name in ("bucketed", "async_ps")):
        return BucketPlan(opt.slices, bucket_bytes, mesh.size)
    return None


def _global_batch(cfg: RunConfig, replicas: int) -> int:
    """``--batch_size`` per replica (or the global batch with
    ``--global_batch``), which must divide across the replicas."""
    batch = cfg.batch_size if cfg.global_batch else cfg.batch_size * replicas
    if batch % replicas:
        raise ValueError(f"global batch {batch} not divisible by "
                         f"{replicas} replicas")
    return batch


def eval_batch_size(global_batch: int, ranks: int) -> int:
    """The JAX Engine's eval batch: the global batch, or the largest
    multiple of the rank count up to 1000 if that is larger, so that it
    divides across the ranks at any rank count."""
    return max(global_batch, (1000 // ranks) * ranks or ranks)


# Fields a process may legitimately set on its own (the JAX Engine's set):
# cluster identity and local data / profile paths.
_PER_PROCESS = frozenset({"job_name", "task_index", "process_id", "ps_hosts",
                          "worker_hosts", "coordinator_address",
                          "num_processes", "data_dir", "profile_dir"})


def _config_digest(cfg: RunConfig) -> int:
    """crc32 of the config without its per-process fields (and without
    ``--log_dir`` when neither checkpoints nor resume touch it), as the
    JAX Engine digests it."""
    per_process = _PER_PROCESS
    if not (cfg.checkpoint_every > 0 or cfg.resume):
        per_process = per_process | {"log_dir"}
    blob = repr(sorted((k, v) for k, v in dataclasses.asdict(cfg).items()
                       if k not in per_process)).encode()
    return zlib.crc32(blob)


def _check_same_config(cfg: RunConfig, mesh: Mesh) -> None:
    """Every later collective (loop length, unroll, eval cadence) assumes
    the ranks run one config: all-gather the digests and refuse by name,
    on every rank, instead of hanging in a mismatched collective."""
    digests = mesh.all_gather_int(_config_digest(cfg))
    if len(set(digests)) > 1:
        raise ModeRefusal(
            f"run configuration differs across the {mesh.size} processes "
            f"(config digests {sorted(set(digests))}). Collective decisions "
            f"(train_steps, steps_per_loop, eval cadence) must agree on "
            f"every process — launch all workers with identical flags (only "
            f"cluster identity, --data_dir and --profile_dir may differ)")


def _uses_kernels(cfg: RunConfig) -> bool:
    return (cfg.pallas_ce or cfg.fused_optimizer
            or cfg.dequant_impl == "pallas")


def _build_kernels_once(cfg: RunConfig, mesh: Mesh) -> None:
    """The first rank of each host compiles the kernels into that host's
    build directory while the others wait (one all-gather as the
    barrier), so N ranks do not run N compiles of each source, and two
    launchers on one host never compile at once."""
    if mesh.grouped and mesh.device.type == "cuda" and _uses_kernels(cfg):
        if mesh.host_rank == 0:
            kbuild.build()
        mesh.all_gather_int(0)


def _params_digest(state, mesh: Mesh = ONE_RANK) -> str:
    """A short sha256 of the flat parameters (under ZeRO-3 gathered from
    every rank's rows: a collective): replicas that agree bit for bit
    have one digest."""
    if state.optimizer.params_rows is not None:
        with materialized(state, mesh) as flat:
            return hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest()[:16]
    flat = state.optimizer.params_flat.detach().cpu().numpy()
    return hashlib.sha256(flat.tobytes()).hexdigest()[:16]


def _stats_digest(state) -> str:
    """The same of the model's buffers (batch norm's running statistics;
    the digest of nothing for a model without them)."""
    h = hashlib.sha256()
    for _, buf in state.model.named_buffers():
        h.update(buf.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _local_rank_run(spec: "RunSpec", offset: int | None = None) -> dict:
    """One local rank (``parallel/launch.spawn``'s child): the run inside
    the group, plus this process's kernel launch counts.  Under the N x M
    layout (``offset``: the launcher's first global rank) the rank stamps
    its global rank in ``OBS_RANK`` (a launcher's inherited one would
    give its M ranks one id, and their flights and ledger rows would
    collide), and only the launcher's first rank touches the
    supervisor's one ``SUPERVISE_HEARTBEAT`` file of the process."""
    if offset is not None:
        rank = dist.get_rank()
        os.environ["OBS_RANK"] = str(rank)
        if rank != offset:
            os.environ.pop("SUPERVISE_HEARTBEAT", None)
    return dict(Engine(spec).run(), launches=launch_counts())


def _run_local_ranks(spec: "RunSpec", ranks: int,
                     info: cluster.ClusterInfo | None = None) -> dict:
    """Start ``ranks`` local ranks and return the first one's summary,
    with every local rank's counts and digests under ``ranks``.  With
    ``info`` (the cluster flags) they are this process's M ranks of the
    global group of ``num_processes * ranks``."""
    backend = cluster.BACKENDS[spec.config.device]
    if info is None:
        results = spawn(_local_rank_run, ranks, backend, args=(spec,))
    else:
        offset = info.process_id * ranks
        results = spawn(_local_rank_run, info.num_processes * ranks, backend,
                        args=(spec, offset), local=ranks, offset=offset,
                        init_method=f"tcp://{info.coordinator_address}")
    summary = dict(results[0])
    summary["ranks"] = [{k: r[k] for k in ("rank", "launches", "all_reduces",
                                          "collectives", "params_digest",
                                          "stats_digest")}
                        for r in results]
    return summary


@dataclasses.dataclass
class EngineBuild:
    """What :meth:`Engine.build` (or :meth:`Engine.build_host_fed`) hands
    a caller: the state, the batches (the resident dataset, or the
    host-fed prefetcher), the train step over them, the resolved mode and
    the bucket plan the step runs on."""

    state: TrainState
    ds: DeviceDataset | DevicePrefetcher
    step: Callable
    unroll: int
    mode: str = "sync_dp"
    bucket_bytes: int | None = None
    plan: BucketPlan | None = None
    zero3_layout: Zero3Layout | None = None


class Engine:
    """Runs a :class:`RunSpec`.  ``run()`` is the trainer surface;
    ``build()`` is the same construction cut down to state + dataset +
    step, with no hooks and no eval (the profiler, the chip smoke's
    card-against-CPU check and the tests drive it)."""

    def __init__(self, spec: RunSpec):
        self.spec = spec
        self.token_data = spec.dataset == "lm"

    def describe(self) -> dict:
        """What this spec resolves to (the JAX Engine's ``describe``):
        mode, update layout, the mode's collective budget, bucket cap and
        hook stack, with the same flag refusals, and nothing built.  The
        rank count is ``--num_devices`` (the global N*M under the cluster
        flags), or every visible card on ``cuda`` (one rank on ``cpu``),
        on each process under the cluster flags."""
        cfg = self.spec.config
        info = cluster.resolve(cfg)
        num_replicas = (
            info.num_processes * ranks_per_process(
                cfg.num_devices, info.num_processes, cfg.device)
            if info.is_distributed else cfg.num_devices or (
                torch.cuda.device_count() if cfg.device == "cuda" else 1))
        bucket_bytes, mode = _resolve_flags(cfg, num_replicas,
                                            self.token_data)
        hooks = []
        if cfg.checkpoint_every > 0:
            hooks.append("CheckpointHook")
        if os.environ.get("SNAPSHOT_DIR", "") \
                and mode.update_layout != "tree":
            hooks.append("ShardSnapshotHook")
        if cfg.eval_every > 0:
            hooks.append("EvalHook")
        if cfg.profile_dir:
            hooks.append("ProfilerHook")
        if os.environ.get("SUPERVISE_HEARTBEAT", ""):
            hooks.append("HeartbeatHook")
        hooks += ["MetricsHook", "AnomalyHook"]
        return {"entrypoint": f"trainer:{self.spec.model}",
                "mode": mode.name,
                "update_layout": mode.update_layout,
                "contract": resolve_contract(cfg, num_replicas),
                "bucket_bytes": bucket_bytes,
                "mesh_size": num_replicas,
                "token_data": self.token_data,
                "checkpointing": cfg.checkpoint_every > 0 or cfg.resume,
                "hooks": hooks}

    def create_state(self, mesh: Mesh) -> TrainState:
        """The model, its optimizer and the state of this rank of ``mesh``
        (``Mesh(device)`` is one rank on that device), initialized from
        the seed, in the replicated (``tree``) layout.  In async mode a
        batch-norm model normalizes over this worker's rows alone (built
        over ``ONE_RANK``)."""
        cfg = self.spec.config
        if self.spec.model_fn is not None:
            model = self.spec.model_fn(cfg)
        else:
            model = build_model(self.spec.model, dropout=cfg.dropout,
                                dtype=_DTYPES[cfg.dtype], remat=cfg.remat,
                                mesh=ONE_RANK if cfg.sync_mode == "async"
                                else mesh)
        return TrainState.create(model, lambda m: build_optimizer(cfg, m),
                                  cfg.seed, mesh.device, mesh=mesh)

    def laid_out_state(self, mesh: Mesh,
                       state: TrainState | None = None) -> tuple:
        """``state`` (a fresh :meth:`create_state` by default) in the
        resolved mode's layout (:func:`apply_update_layout`): ``(state,
        zero3_layout or None)``."""
        cfg = self.spec.config
        bucket_bytes, mode = _resolve_flags(cfg, mesh.size, self.token_data)
        return apply_update_layout(
            self.create_state(mesh) if state is None else state,
            update_layout=mode.update_layout, bucket_bytes=bucket_bytes,
            mesh=mesh, shard_update=shards_tree_update(cfg, mesh.size))

    def _setup(self, mesh: Mesh, data, state: TrainState | None,
               zero3_layout: Zero3Layout | None) -> tuple:
        """What :meth:`build` and :meth:`build_host_fed` share: the global
        batch, the resolved flags and their refusals, the train split,
        the laid-out state and the bucket plan."""
        cfg = self.spec.config
        global_batch = _global_batch(cfg, mesh.size)
        bucket_bytes, mode = _resolve_flags(cfg, mesh.size, self.token_data)
        _refuse_for_mode(cfg, self.spec.model, bucket_bytes, mesh.size)
        train = data if data is not None else self.input("train")
        if state is None:
            state, zero3_layout = self.laid_out_state(mesh)
        plan = _step_plan(state, mode, bucket_bytes, mesh)
        return (global_batch, bucket_bytes, mode, train, state, zero3_layout,
                plan)

    def build(self, mesh: Mesh, unroll: int = 1, data=None,
              perm_fn=None, draws_fn=None,
              state: TrainState | None = None,
              zero3_layout: Zero3Layout | None = None) -> EngineBuild:
        """State, resident dataset and train step (the resolved mode's:
        ``engine/spec.MODES``) for this rank of ``mesh``.  ``state`` (a
        restored one, laid out by :meth:`laid_out_state`, with its
        ``zero3_layout``) replaces a fresh one, and the dataset starts at
        its step.  ``data`` ``(images, labels)`` replaces the spec's train
        split; ``perm_fn`` injects an index tape (``DeviceDataset``) and
        ``draws_fn`` the augment draws
        (``parallel/sync.make_device_gather``)."""
        cfg = self.spec.config
        global_batch, bucket_bytes, mode, (x, y), state, zero3_layout, \
            plan = self._setup(mesh, data, state, zero3_layout)
        ds = DeviceDataset(x, y, global_batch, device=mesh.device,
                           seed=cfg.seed, start_step=state.step,
                           steps_per_next=unroll, quantize=cfg.quantize,
                           dequant_impl=cfg.dequant_impl, perm_fn=perm_fn,
                           token_data=self.token_data,
                           data_sharding=cfg.data_sharding, mesh=mesh)
        common = dict(label_smoothing=cfg.label_smoothing,
                      ce_impl="pallas" if cfg.pallas_ce else "xla",
                      unroll_steps=unroll, num_slots=ds.num_slots,
                      dequant_impl=cfg.dequant_impl,
                      token_data=self.token_data,
                      augment="cifar" if self.spec.augment else "none",
                      seed=cfg.seed, draws_fn=draws_fn, mesh=mesh,
                      data_sharding=cfg.data_sharding)
        if cfg.sync_mode == "async":
            step = make_indexed_async_train_step(
                cfg.async_period, global_batch, ds.steps_per_epoch,
                plan=plan, **common)
        else:
            step = make_indexed_train_step(
                global_batch, ds.steps_per_epoch,
                replicas_to_aggregate=cfg.replicas_to_aggregate,
                mode=mode.name, plan=plan, zero3_layout=zero3_layout,
                zero3_overlap=cfg.zero3_overlap, **common)
        return EngineBuild(state=state, ds=ds, step=step, unroll=unroll,
                           mode=mode.name, bucket_bytes=bucket_bytes,
                           plan=plan, zero3_layout=zero3_layout)

    def build_host_fed(self, mesh: Mesh, data=None,
                       state: TrainState | None = None,
                       zero3_layout: Zero3Layout | None = None,
                       depth: int = 2) -> EngineBuild:
        """The ``--device_data off`` counterpart of :meth:`build`: the
        ``Batcher`` over the train split (the JAX Engine's: seeded by
        ``--seed`` and built afresh, so a resumed run replays the tape
        from its start, as in JAX), this rank's rows of each global batch
        uploaded ``depth`` ahead by a ``DevicePrefetcher``, and the
        host-fed step, which dequantizes them (one step a call)."""
        cfg = self.spec.config
        global_batch, bucket_bytes, mode, (x, y), state, zero3_layout, \
            plan = self._setup(mesh, data, state, zero3_layout)
        batcher = Batcher(x, y, global_batch, seed=cfg.seed,
                          process_index=mesh.rank, process_count=mesh.size,
                          augment_fn=cifar_augment if self.spec.augment
                          else None, quantize=cfg.quantize)
        common = dict(ce_impl="pallas" if cfg.pallas_ce else "xla",
                      dequant=batcher.dequant,
                      dequant_impl=cfg.dequant_impl, quantize=cfg.quantize,
                      mesh=mesh, plan=plan)
        if cfg.sync_mode == "async":
            step = make_async_train_step(cfg.async_period,
                                         cfg.label_smoothing, **common)
        else:
            step = make_train_step(
                cfg.label_smoothing,
                replicas_to_aggregate=cfg.replicas_to_aggregate,
                mode=mode.name, zero3_layout=zero3_layout,
                zero3_overlap=cfg.zero3_overlap, **common)
        return EngineBuild(state=state,
                           ds=DevicePrefetcher(batcher, mesh.device, depth),
                           step=step, unroll=1, mode=mode.name,
                           bucket_bytes=bucket_bytes, plan=plan,
                           zero3_layout=zero3_layout)

    def input(self, split: str):
        """The ``(images, labels)`` of ``split``: ``RunSpec.input_fn``,
        or the dataset family's loader."""
        if self.spec.input_fn is not None:
            return self.spec.input_fn(self.spec.config, split)
        return _load_dataset(self.spec.config, self.spec.dataset, split)

    def run(self) -> dict:
        """Train per the spec; returns a summary dict."""
        spec = self.spec
        cfg: RunConfig = spec.config
        info = cluster.resolve(cfg)
        if info.role == "ps":
            print(cluster.PS_NOTICE, flush=True)
            return {"role": "ps", "exited": True}
        _refuse_unported(cfg, info)
        ranks = _expected_ranks(cfg, info)
        bucket_bytes, mode = _resolve_flags(cfg, ranks, self.token_data)
        update_layout = mode.update_layout
        _refuse_for_mode(cfg, spec.model, bucket_bytes, ranks)
        if not dist.is_initialized():
            if info.is_distributed and ranks > info.num_processes:
                return _run_local_ranks(spec, ranks // info.num_processes,
                                        info)
            if not info.is_distributed and ranks > 1:
                return _run_local_ranks(spec, ranks)
        cluster.maybe_initialize_distributed(info, cfg.device)
        mesh = make_mesh(cfg.device)
        device = mesh.device
        if mesh.size > 1:
            _check_same_config(cfg, mesh)
        _build_kernels_once(cfg, mesh)
        num_replicas = mesh.size
        global_batch = _global_batch(cfg, num_replicas)
        is_async = cfg.sync_mode == "async"

        train_x, train_y = self.input("train")
        test_x, test_y = self.input("test")
        use_device_data = cfg.device_data != "off"

        # Laid out before any restore, which fills the layout's tensors.
        # With SNAPSHOT_DIR a row layout also writes shard-redundant
        # snapshots (resilience/shardstore.py), whose layout facts come
        # from the tree-form parameters, and a resume restores the newest
        # quorum-valid set, written at any mesh width, through the same
        # re-layout pass.
        state = self.create_state(mesh)
        shard_store = None
        if os.environ.get("SNAPSHOT_DIR", "") and update_layout != "tree":
            shard_store = ShardStore(
                os.environ["SNAPSHOT_DIR"],
                layout=ShardLayout.for_params(
                    update_layout, bucket_bytes,
                    dict(state.model.named_parameters()), num_replicas),
                keep=cfg.keep_checkpoints)
        shard_aux = None
        if shard_store is not None and cfg.resume:
            state, shard_aux = shard_store.restore_elastic(
                state, mesh=mesh, update_layout=update_layout,
                required=False)
        shard_step = None if shard_aux is None else shard_aux["step"]
        if shard_aux is not None:
            zero3_layout = shard_aux["zero3_layout"]
            if mesh.is_chief:
                print(f"resumed from shard set at step {shard_aux['step']} "
                      f"(written at D={shard_aux['from_ranks']}, this mesh "
                      f"is D={num_replicas})", flush=True)
        else:
            state, zero3_layout = self.laid_out_state(mesh, state)
        start_step = state.step
        # This run's layout facts, kept beside the checkpoints so that a
        # later resume into another layout is refused by name: async
        # state is one part per worker, so the worker count is
        # structural, and so is the mesh size of a row layout; tree state
        # is replicated and restores on any mesh.
        run_meta = {"sync_mode": cfg.sync_mode, "mesh_size": num_replicas,
                    "num_workers": num_replicas if is_async else None,
                    "update_layout": update_layout,
                    "bucket_bytes": bucket_bytes}
        manager = None
        if cfg.log_dir and (cfg.checkpoint_every > 0 or cfg.resume):
            manager = CheckpointManager(
                os.path.join(cfg.log_dir, "checkpoints"),
                max_to_keep=cfg.keep_checkpoints,
                async_save=cfg.async_checkpoint, run_metadata=run_meta,
                mesh=mesh, per_rank=is_async or update_layout != "tree")
            if cfg.resume and shard_step is None \
                    and manager.latest_step() is not None:
                _refuse_incompatible_restore(manager.saved_run_metadata(),
                                             run_meta, cfg.log_dir,
                                             mesh.is_chief)
                manager.restore(state)
                start_step = state.step
                if mesh.is_chief:
                    print(f"resumed from checkpoint at step {state.step}",
                          flush=True)

        remaining = cfg.train_steps - state.step
        if not use_device_data:
            if cfg.steps_per_loop > 1:
                raise ModeRefusal("--steps_per_loop > 1 requires the "
                                  "device-resident input path (device_data)")
            steps_per_call = 1
        elif cfg.steps_per_loop == 0:
            steps_per_call = (auto_steps_per_loop(
                remaining, len(train_x) // global_batch,
                intervals=(cfg.log_every, cfg.eval_every,
                           cfg.checkpoint_every),
                start=state.step)
                if remaining > 0 else 1)
            if steps_per_call > 1 and mesh.is_chief:
                print(f"steps_per_loop auto: fusing {steps_per_call} steps "
                      f"per call (--steps_per_loop 1 for per-step calls)",
                      flush=True)
        else:
            steps_per_call = max(1, cfg.steps_per_loop)
            if remaining > 0 and remaining % steps_per_call:
                raise ModeRefusal(
                    f"remaining steps {remaining} (train_steps "
                    f"{cfg.train_steps} - resumed step {state.step}) must be "
                    f"a multiple of --steps_per_loop {steps_per_call}")
        # Built after the restore: the epoch slots follow the restored step.
        if use_device_data:
            built = self.build(mesh, unroll=steps_per_call,
                               data=(train_x, train_y), state=state,
                               zero3_layout=zero3_layout)
        else:
            built = self.build_host_fed(mesh, data=(train_x, train_y),
                                        state=state,
                                        zero3_layout=zero3_layout)

        logger = MetricsLogger(cfg.log_dir, num_chips=mesh.num_chips,
                               log_every=cfg.log_every, device=device,
                               is_chief=mesh.is_chief)
        hooks = []
        if manager is not None and cfg.checkpoint_every > 0:
            hooks.append(CheckpointHook(manager, cfg.checkpoint_every))
        if shard_store is not None:
            # Beside (not instead of) the checkpoints: the shard sets are
            # what an elastic resume reads.
            shard_hook = ShardSnapshotHook(
                shard_store, mesh, every=max(1, cfg.checkpoint_every),
                cursor={"seed": cfg.seed})
            hooks.append(shard_hook)
        eval_batch = eval_batch_size(global_batch, num_replicas)
        if use_device_data:
            evaluate = make_resident_eval(
                test_x, test_y, device, batch_size=eval_batch,
                quantize=cfg.quantize, dequant_impl=cfg.dequant_impl,
                token_data=self.token_data, mesh=mesh)
        else:
            evaluate = functools.partial(
                host_evaluate, images=test_x, labels=test_y,
                batch_size=eval_batch, device=device, mesh=mesh)

        def eval_fn(s) -> float:
            if is_async:
                with consolidated(s, mesh):     # on the workers' average
                    return evaluate(s)
            if zero3_layout is not None:
                with materialized(s, mesh):     # the rows, gathered
                    return evaluate(s)
            return evaluate(s)

        if cfg.eval_every > 0:
            hooks.append(EvalHook(eval_fn, cfg.eval_every, logger))
        profiler = None
        if cfg.profile_dir:
            # Imported here: utils/profiling imports this module.
            from distributedtensorflowexample_tpu_torch.utils.profiling \
                import ProfilerHook
            profiler = ProfilerHook(cfg.profile_dir, cfg.profile_start_step,
                                    cfg.profile_num_steps, rank=mesh.rank,
                                    device=device)
            hooks.append(profiler)
        heartbeat = os.environ.get("SUPERVISE_HEARTBEAT", "")
        if heartbeat:
            hooks.append(HeartbeatHook(heartbeat,
                                       every=_CONSENSUS_POLL_STEPS))
        metrics_hook = MetricsHook(every=cfg.log_every)
        hooks.append(metrics_hook)
        # Always on, after MetricsHook (whose loss gauge it reads):
        # detection only, never a stop.
        anomaly_hook = AnomalyHook(every=cfg.log_every,
                                   health_path=os.environ.get("OBS_HEALTH",
                                                              ""))
        hooks.append(anomaly_hook)
        # Telemetry (obs/): the flight recorder arms under a supervisor or
        # OBS_FLIGHT=1, the run ledger under OBS_LEDGER, the live scrape
        # under OBS_HTTP_PORT; ranks of a group stamp OBS_RANK so their
        # flights and ledger rows stay apart.
        if mesh.size > 1:
            os.environ.setdefault("OBS_RANK", str(mesh.rank))
        rec = obs_recorder.maybe_install()
        if rec is not None:
            rec.note(trainer=spec.model, dataset=spec.dataset,
                     sync_mode=cfg.sync_mode, log_dir=cfg.log_dir)
        obs_ledger.maybe_begin(
            entrypoint=f"trainer:{spec.model}",
            config=dataclasses.asdict(cfg), platform=device.type,
            mesh_size=num_replicas, num_processes=mesh.size,
            dataset=spec.dataset)
        obs_serve.maybe_start()

        # The stop after a SIGTERM is agreed by every rank at one call
        # boundary: a rank stopping alone would leave the others waiting
        # in the next collective, and every rank takes part in the save.
        preempted = None                # the flag, bound below
        stop_agreed = []
        poll_every = max(1, _CONSENSUS_POLL_STEPS // steps_per_call)
        boundaries = [0]

        def consensus() -> bool:
            agreed = (max(mesh.all_gather_int(bool(preempted))) > 0
                      if mesh.size > 1 else bool(preempted))
            if agreed:
                stop_agreed.append(True)
            return agreed

        def should_stop() -> bool:
            if mesh.size > 1:
                boundaries[0] += 1
                if (boundaries[0] - 1) % poll_every:
                    return False        # the same skips on every rank
            return consensus()

        with sigterm_flag() as preempted:
            loop = TrainLoop(built.step, built.ds, cfg.train_steps, hooks,
                             logger, steps_per_call=steps_per_call,
                             reduce_metrics=mesh.sum_metrics,
                             should_stop=should_stop)
            state = loop.run(built.state)
            if not stop_agreed:
                # One more poll, reached by every rank: a signal after the
                # last boundary's poll still saves before the eval.
                consensus()
            if stop_agreed:
                # CheckpointHook.end has saved; a resume-only run saves here.
                if manager is not None and cfg.checkpoint_every == 0:
                    manager.save(state.step, state)
                    manager.wait()
                saved = ("checkpoint saved, restart auto-resumes"
                         if manager is not None else
                         "NO checkpoint manager (--checkpoint_every 0 "
                         "--resume false, or no --log_dir) — NOTHING SAVED")
                logger.note(f"SIGTERM at step {state.step}: {saved}; "
                            f"exiting 143")
                logger.close()
                obs_recorder.dump_global("preempted")
                obs_ledger.end_global(rc=143, final_step=state.step)
                raise SystemExit(143)
            final_acc = eval_fn(state)
        if manager is not None and cfg.checkpoint_every == 0:
            manager.save(state.step, state)
            manager.wait()
        logger.scalar(state.step, "final_accuracy", final_acc)
        steps_per_sec = logger.last_steps_per_sec
        logger.close()
        obs_ledger.end_global(rc=0, final_step=state.step,
                              final_accuracy=round(float(final_acc), 6))
        return {"final_accuracy": final_acc,
                "steps": state.step,
                "start_step": start_step,
                "steps_per_sec": steps_per_sec,
                "steps_per_sec_per_chip": steps_per_sec / mesh.num_chips,
                "num_replicas": num_replicas,
                "num_chips": mesh.num_chips,
                "global_batch": global_batch,
                "steps_per_call": steps_per_call,
                "eval_batches": -(-len(test_y) // eval_batch),
                "device": str(device),
                "rank": mesh.rank,
                "all_reduces": mesh.all_reduces,
                "collectives": dict(mesh.collectives),
                "mode": built.mode,
                "update_layout": update_layout,
                "bucket_bytes": bucket_bytes,
                "num_buckets": (None if built.plan is None
                                else built.plan.num_buckets),
                "collective_budget": collective_budget(
                    cfg, num_replicas,
                    None if built.plan is None else built.plan.num_buckets),
                "input": "device" if use_device_data else "host",
                "resident_rows": (built.ds.images.shape[0]
                                  if use_device_data else None),
                "h2d_bytes_per_step": (None if use_device_data
                                       else built.ds.bytes_per_batch),
                "anomalies": anomaly_hook.health.anomalies,
                "profile_trace": None if profiler is None else profiler.path,
                "params_digest": _params_digest(state, mesh),
                "stats_digest": _stats_digest(state),
                "checkpoint": None if manager is None else manager.stats,
                "shard_snapshots": None if shard_store is None else {
                    "saves": shard_hook.save_seconds,
                    "last": shard_store.last_save,
                    "resumed_from": {k: shard_aux[k] for k in (
                        "step", "from_ranks", "reconstructed")}
                    if shard_step is not None else None},
                "loss_tape": metrics_hook.loss_tape}
