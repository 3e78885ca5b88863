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
that ResNet-20 trains with each block rematerialized, that every
run's telemetry (tfevents, the profiler window, ``health.json``) is
written, that the resilience drivers supervise runs on the card: a
preempted config-3 child restarted and resumed bitwise, a wedge killed
by the heartbeat watchdog, and a two-rank gang restarted from its agreed
snapshot step, and that the control plane schedules and heals on it: a
config-3 job evicted by a more urgent one and resumed bitwise, a wedged
job quarantined, a damaged ZeRO-3 shard set reconstructed, and a slow
rank evicted and its gang resumed bitwise, that the same control
plane runs at fleet scale on the card's host: the simulator's four
10,000-rank storms are deterministic, and the ledger's readers explain
the card's eviction, quarantine and gang restart, and that config 3
trains in the N-process x M-local-rank layout: two launcher processes
of two ranks each, one group of four, bitwise the same four ranks
started by one process, and that the port's measurement tools measure
the card and its host: the collectives' fit, the host loader against
numpy, the input path's variants bitwise, and their records' trajectory,
and that the serving bench (``tools.bench_serving``) measures lm_base on
the card: the supervised headline, the saturation and SLO curves, the
sharded, speculative and batched-prefill points, in a record the ratchet
reads, and that the harnesses measure the card under ``supervise
--capture``: the headline harness (``tools.bench``: six lines with the
headline last, each of its kernel variants launching its kernel once a
step), the ResNet-20 profile and its trace, the collectives, the LM
bench (lm_base's knob matrix over two ranks), the CLI trainer, then the
resident-storage A/B (``tools.ab_quantize``) and the 1 -> 2 rank
efficiency over gloo.

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
   checks; run after U, beside H, J and V (its steps/s is then not a
   quiet card's);
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
   rank), phase E's launches per step; run after U, beside C, J and V
   (its steps/s is then not a quiet card's);
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
   0; beside it the same for two gloo ranks on the one card started
   through ``parallel/launch.spawn`` (the launcher ``--num_devices N``
   uses), which forwards the signal to both ranks; run after U, beside
   C, H and V; one ``sigterm_drill`` line;
X. (after V, beside W) the N-process x M-local-rank layout:
   two launcher processes joined by ``TF_CONFIG`` on 127.0.0.1, each
   starting M=2 gloo ranks on ``cuda:0`` into one group of four
   (``parallel/launch.spawn`` with the rank offset ``process_id*M`` and
   the TCP rendezvous at the coordinator: the layer beneath the Engine's
   launcher, whose command line refuses two ranks on one card, as the
   JAX package does), each rank ``Engine(spec).run()`` of config 3 with
   the four kernels, 20 steps at B=64 a rank under cuDNN's deterministic
   algorithms; beside them the same four ranks started by this process.
   Every rank launches ``dequant`` 20 + the eval batches and ``ce_fwd``
   = ``ce_bwd`` = ``sgd`` = 20 and runs 20 gradient all-reduces, the
   four replicas are bitwise equal across both processes and bitwise
   the one-process group's, only global rank 0 prints, and the loss is
   finite and falls; one ``nxm_path`` line (the phase's wall seconds,
   each rank's steps/s: gloo, host-staged, on one card).  After V, so
   that V keeps the company it had (C, H and J); W is host work with no
   timed gate;
U. (after I) supervision on the card, through the port's entry points
   (``python -m distributedtensorflowexample_tpu_torch.tools.<name>``):
   (a) ``supervise --retries 2`` of config 3 with the four kernels
   (1,000 steps, B=64, deterministic cuDNN) in a child process; SIGTERM
   to the child (found through ``/proc/<pid>/task/*/children``) after
   its first log line: the journal holds rc 143 then 0, the supervisor
   exits 0, attempt 1 logs ``resumed from checkpoint at step N``, each
   attempt's launches are ``dequant`` = the steps it trained (+ the eval
   batches), ``ce_fwd`` = ``ce_bwd`` = ``sgd`` = the steps it trained,
   and the final parameters and momentum are bitwise those of an
   uninterrupted run of the same flags in this process; (b) ``faultline
   --model mnist_cnn --plan wedge@3:60`` under ``supervise
   --heartbeat_timeout_s 3 --kill_grace_s 2``: the watchdog kills attempt
   0's group, attempt 1 resumes at step 3 and exits 0; the time from the
   last beat to the kill is at least the timeout; (c) ``supervise_fleet
   --num_ranks 2`` of faultline ranks on the one card with ``kill@4%1``
   (rank 0 slowed from step 2 so the gang is whole when rank 1 dies):
   rank 1 dies by SIGKILL, the gang is torn down, both ranks restart
   from the agreed step (``FLEET_RESUME_STEP``) and end with the digest
   and tape of an uninterrupted ``--plan none`` run; (b) and (c) start
   first and run beside (a); one ``supervision_path`` line;
V. (after U, beside C, H and J) the scheduler and the heal drills on
   the card, through the port's entry points; (b) and (c) start first
   and run beside (a):
   (a) ``schedule --devices 1`` of a three-job queue: the config-3
   victim (phase U (a)'s flags and 1,000 steps, ``--checkpoint_every
   50``, priority 10), a priority-0 one-rank ``faultline`` evictor gated
   on the victim's step-50 checkpoint, and a wedge (``sys.exit(3)``).
   The ledger holds ``sched_evict`` of the victim (rc 143, clean) before
   the evictor's ``sched_place``, the victim's second placement
   ``resumed``, ``sched_done`` for both, ``sched_quarantine`` for the
   wedge (placed once; exit code 3); each placement's launches are
   ``dequant`` = the steps it trained (+ the eval batches), ``ce_fwd`` =
   ``ce_bwd`` = ``sgd`` = the steps it trained; the final parameters
   and momentum are bitwise phase U's uninterrupted run; the ``--record``
   names the card and its power limit; the time from the eviction's
   intent to the victim's 143 is printed; (b) ``heal_drill --drill ckpt
   --model softmax --mesh 2``: a ZeRO-3 faultline of two gloo ranks on
   the card, ``shard_loss`` and ``bitflip`` after the final save, each
   reconstructed (``ckpt_reconstruct``, ``ckpt_digest_mismatch``),
   bitwise, 0 steps lost, ``ckpt_shard_restore_failures`` and
   ``ckpt_digest_mismatch_unrecovered`` 0, MTTD and MTTR printed; (c)
   ``supervise_fleet --heal`` of two faultline ranks (mnist_cnn, 16
   steps), rank 1 slowed 2 s a step from step 5, the per-rank
   regression detector unarmed: a ``heal_evict`` of rank 1 named
   straggler by the fleet, one relaunch from the agreed step, both
   ranks' digests and tapes those of an uninterrupted run beside it; one
   ``scheduling_path`` line and one line for each part;
W. (after V, beside X) the control plane at fleet scale and the
   ledger's readers, each a ``python -m`` child process that imports
   neither torch nor JAX (checked first; the simulator patches
   process-wide clock seams, so it never runs in a thread of this
   script): (a) ``sim_run --battery``, the
   four 10,000-rank storms (host-loss waves, a straggler epidemic, a
   serve spike, a wedge cascade) each run twice against the port's real
   ``Scheduler`` and ``Remediator``: 0 determinism violations, 0 steps
   lost, 0 unbalanced WAL intents, 10,000 ranks in ``fleet10k``, and the
   host wall seconds; (b) ``obs_query why victim`` and ``why wedge`` over
   phase V (a)'s ledger (``sched/RUNS.jsonl``): the victim's eviction for
   the priority-0 evictor, its resumed placement and its completion; the
   wedge's quarantine; ``obs_query list`` over the same ledger; (c)
   ``obs_report`` over phase U (c)'s fleet journal and flights: the
   markdown names rank 1's SIGKILL, the teardown and the agreed restart
   step, ``--format trace`` parses with one lane per rank, and phase V
   (c)'s healed gang renders too.  This process's launch counts are the
   same after W as before; one ``control_plane_path`` line;
Y. (after V, beside W and X) the port's measurement tools, each a
   ``python -m`` child process writing its record into
   ``build/chip_smoke_measure/records`` (named ``_r16``): (a)
   ``bench_collectives --backend gloo --submeshes 2,4``, every kind at 4
   KiB-4 MiB through ``parallel/mesh.Mesh`` (``all_to_all`` through
   ``dist.all_to_all_single``) on ranks sharing the one card, host-staged;
   each kind at each size fitted or named unmeasured with its error, and
   ``resilience/scheduler.load_collective_fit`` reads the psum fit at 2
   and at 4 back; NCCL at 2 ranks, 4 KiB-256 MiB, only where 2 cards
   are visible (else the line says ``nccl unmeasured``); (b)
   ``bench_input`` on the host,
   its four stages bit-identical to numpy before they are timed; (c)
   ``ab_augment`` (B=128, 195 steps a window, the 50,000-row synthetic
   split resident as uint8): base, selmm, selmm_oh, noaug and kernel,
   each bitwise base before it is timed; the kernel variant launches
   ``dequant`` once a step (4 x 195), the others no kernel; (a), (b)
   and (c) side by side, then (d)
   ``bench_ratchet --trajectory`` and ``obs_query trajectory`` over the
   records: one row per family, the same rows from both, and
   ``predict_cost`` prices a job from the trajectory; one
   ``measure_path`` line;
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
   ``--remat block``, lr 0.02, the CE pair), 4 steps in each of
   ``sync_dp``, ``bucketed`` (auto), ``zero1`` and ``zero3`` with the
   gathers overlapped and serial: the loss tapes within 1e-5 relative of
   ``sync_dp``'s, the budgets per step, B per mode, each rank's
   ``torch.cuda.memory_allocated`` by its state after init (and the
   state's own tensor bytes) and its peak over the steps
   (``torch.cuda.max_memory_allocated``, both above what was allocated
   before the state), against sync_dp's, steps/s over the last 3
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
   (and a checkpoint) every 2 steps to step 4, keep 2; twice, and a copy
   of the first run's step-2 set resumed to step 4.  Checks, each fatal:
   (a) both sets quorum-valid, each rank directory holding ``own``, one
   mirror and ``repl``; (b) rank 1's directory dropped: the restore at
   D=2 reconstructs shard 1 and is bitwise the intact restore (sha256 of
   the gathered parameters and momentum); (c) one byte of rank 0's
   ``own.npz`` flipped: refused by sha256, rebuilt from its mirror,
   bitwise; (d) shard 0's own copy and its mirror dropped: ``ModeRefusal``
   naming "exceeds redundancy R=2"; (e) the D=2 set restored on four gloo
   ranks, saved there as a D=4 set, and that restored on two (after S,
   in phase P's group): bitwise; (f) the resumed step-4 shards bitwise the straight
   run's if the two straight runs are bitwise equal, else within twice
   their gap; (g) the collectives a step the zero3 budget with the hook
   on; (h) ``ce_fwd`` = ``ce_bwd`` = 1 launch a step on each rank,
   ``dequant`` = ``sgd`` = 0.  One ``shard_snapshot_path`` line: save
   blocking ms, bytes a rank, restore ms at the same width and elastic,
   the reconstructions (host-staged gloo numbers);
P. params-stay-sharded serving at lm_base, full width: phase S's tree
   snapshot promoted into 1/2 rows a rank (``promote_sharded``) and
   served by ``serve_lm --sharded_mesh 2`` (two gloo ranks on the card)
   with 8 slots of 128 rows (4 a rank), 8 requests of 4-12-token prompts
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
Z. (after P) the serving bench: ``tools.bench_serving --device cuda
   --size lm_base --slots 8 --max_len 128`` as a child process on phase
   S's snapshot, at reduced counts (32 requests a point, clients 1 and 8,
   SLO 0 and 200 ms, one repeat, one supervised repeat, draft window 4,
   the sharded point on 2 gloo ranks with 16 requests; at lm_base a
   request's p50 is ~130 ms, so an SLO of 100 ms or less rejects nearly
   every request and the knee would read near 0).  Checks, each
   fatal: exit 0; every metric name of the JAX harness at lm_base; the
   gap-aware ``serve_lm_base_spec_mismatch`` 0 at ``SERVE_TAU``; the
   sharded residency 1/2 a rank and lm_base's 1/4 at D=4; every line's
   ``detail.device`` names the card; ``tools.bench_ratchet`` reads the
   record's 11 lines and finds nothing unexplained; no kernel launched
   by the tool, its supervised worker or any of its ranks.  One
   ``serving_bench`` line: the knee (best in-SLO tokens/s), the headline
   tokens/s and p50/p99, the other instruments' values, the wall s;
HB. (after Z) the harnesses: ``tools.supervise --capture --tiny
   --records_dir build/chip_smoke_capture`` as a child process, its six
   tasks each a child of it (``tools.bench --headline_only --tiny``,
   ``tools.bench_profile --tiny``, ``tools.bench_collectives`` at 2
   ranks and two sizes, ``tools.bench_lm --tiny``: lm_tiny throughput
   and lm_base's seven knobs over two gloo ranks, ``tools.bench --tiny``
   and ``trainer_sync_mnist`` for 200 steps), with ``tools.ab_quantize
   --tiny`` and then ``tools.bench_scaling --max_devices 2`` (B=64 a
   rank) beside it.  Checks, each fatal: exit 0; the journal ends with
   ``capture_end``, every task ``done`` in priority order; the full
   bench's record (``tools.bench.TINY``: 256-row splits, B=64, two
   repeats, the A/B's ``pallas`` arm alone): the provisional line first,
   then the six JAX metric lines with the headline last, unit
   ``steps/sec/chip``, every line's ``detail.device`` this card, every
   line's launches equal to its ``kernel_steps`` (the steps, warm-up
   included, its builds ran with each kernel requested): ``dequant`` > 0
   on the headline (its ``pallas`` A/B arm) and 0 elsewhere, ``ce_fwd``
   = ``ce_bwd`` > 0 on the ``pallas_ce`` line alone, ``sgd`` > 0 on the
   ``fused_sgd`` line alone; ``vs_roofline`` > 0 on the headline,
   ResNet-20 and softmax lines; ResNet-20's ``mfu`` in (0, 1]; the
   headline-only record's one measured line; the LM record's two
   lm_tiny lines, the five derived lines of a 2-rank matrix and the
   matrix (gloo, host-staged, one card, seven knobs, activation and peak
   bytes > 0, base momentum 4 x 57,289,728 bytes, ZeRO-1 and ZeRO-3
   shrinks in [1.99, 2], a remat saving in (0, 1)), no kernel launched;
   the profile record's five lines, a trace with device time by kind and
   its tarball, both shares; the collective fit read back at 2 ranks;
   the trainer's ``final accuracy`` line.  ``ab_quantize``: six variants
   in order, each > 0 and bitwise ``off``'s first batch, the dequant
   kernel once a step on ``u8_kernel`` alone.  ``bench_scaling``: the
   per-count lines at 1 and 2 ranks and the ``sync_sgd_weak_scaling``
   line, ``efficiency_1_to_2``, over ``gloo``, ``host_staged``, one
   card; 2 ranks' all-reduce bytes a step = 4 x config 3's 3,274,634
   parameters; no kernel launched.  One ``bench_path`` line: each
   record's rates, the shares, the LM matrix's rates and peaks, the
   launches, the wall s;
Q. (after C, H, J, V, W, X and Y) the host-fed input path: the native loader
   built (``native.available()``) and its ``gather`` and ``gather_augment``
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
7. a ``phase_wall_s`` line (each phase's wall seconds, and their sum),
   the ``kernels`` JSON line (each kernel's launches summed over every
   path and rank, and per path: per rank for the multi-rank paths, per
   run for phase I, per attempt for phase U, per placement for phase
   V, per variant for phase Y), then the ``ok`` line last.

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

import concurrent.futures
import contextlib
import gc
import importlib
import io
import json
import os
import re
import shutil
import signal
import socket
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
MODE_LM_STEPS = 4           # phase M, each mode (6 until PR 15)
ASYNC_BN_STEPS = 40         # phase N
HOST_STEPS = 200            # phase Q: host-fed config 3
HOST_CMP_STEPS = 20         # phase Q: the dequants and the copies compared
REMAT_STEPS = 50            # phase R
REMAT_PEAK_STEPS = 3        # phase R: the steps whose peak is read
SHARDED_DATA_STEPS = 20     # phase SH
NXM_PROCESSES = 2           # phase X: launcher processes
NXM_LOCAL = 2               # phase X: gloo ranks each launcher starts
NXM_STEPS = 20              # phase X
TELEMETRY_STEPS = 60        # phase T
Z3_RESUME_STEPS = 40        # phase I': 20 steps, then resumed to 40
SUPERVISED_STEPS = 1000     # phase U (a): SIGTERM after the step-100 line
SUPERVISED_HB_S = 120.0     # phase U (a): far above the trainer's beats
FAULT_STEPS = 10            # phase U (b), (c): faultline steps
WEDGE_HB_S = 3.0            # phase U (b): the watchdog's timeout
WEDGE_GRACE_S = 2.0         # phase U (b): TERM-to-KILL grace
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


def run_nccl_phase(gpu: str) -> tuple:
    """Phase C: config 3 through an NCCL group on the visible cards: the
    largest power of two of them up to 4, so that the eval batch of 1000
    divides across the ranks.  Returns the ``nccl_path`` line to print
    and the launches by path."""
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
    return (json.dumps({"nccl_path": result}) + "\n",
            {"mnist_cnn_nccl": [r["launches"] for r in ranks]})


def multiworker_rank(argv: list) -> dict:
    return run_trainer("trainer_multiworker_cifar", argv)


def run_multiworker_phase(gpu: str) -> tuple:
    """Phase H: config 5 as one NCCL process started with the cluster
    flags; the process group is the one-rank NCCL group it runs in.
    Returns the text to print (the trainer's lines and the
    ``multiworker_path`` line) and the launches by path."""
    argv = cifar_argv(MR_CIFAR_STEPS, "chip_smoke_multiworker",
                      log_every=10) + ["--worker_hosts", "localhost:2222",
                                       "--task_index", "0"]
    (r,) = launch.spawn(multiworker_rank, 1, "nccl", (argv,), timeout_s=600)
    check_ranks([r], "phase H", dequant_ce_expect(MR_CIFAR_STEPS,
                                             r["eval_batches"]),
                MR_CIFAR_STEPS)
    require(r["device"] == "cuda:0", f"phase H: placed on {r['device']}")
    losses = [l for _, l in r["loss_tape"]]
    require(all(np.isfinite(losses)), f"phase H: loss tape {losses}")
    line = json.dumps({"multiworker_path": {
        "model": "resnet20", "world": 1, "backend": "nccl",
        "steps": r["steps"], "steps_per_sec": r["steps_per_sec"],
        "final_accuracy": r["final_accuracy"],
        "loss_tape": r["loss_tape"], "launches": r["launches"],
        "gpu": gpu}})
    return r["text"] + line + "\n", {"resnet20_nccl": [r["launches"]]}


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


def run_drill_phase(gpu: str) -> tuple:
    """Phase J: one trainer process and two gloo ranks, side by side (each
    drill is two process start-ups in turn).  Returns the
    ``sigterm_drill`` line to print, and no launches by path."""
    flags = ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
             "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
             "--batch_size", str(BATCH), "--steps_per_loop", "1",
             "--log_every", "10"]
    heads = {"one_process": ["-m", "distributedtensorflowexample_tpu_torch."
                                   "trainers.trainer_sync_mnist"],
             "two_gloo_ranks": ["-c", "import sys, chip_smoke; "
                                      "chip_smoke.gloo_drill(sys.argv[1:])"]}
    with concurrent.futures.ThreadPoolExecutor(len(heads)) as pool:
        runs = {}
        for name, head in heads.items():
            log_dir = ROOT / "build" / f"chip_smoke_drill_{name}"
            shutil.rmtree(log_dir, ignore_errors=True)
            runs[name] = pool.submit(drill, [sys.executable, "-u", *head,
                                             *flags, "--log_dir",
                                             str(log_dir)])
        out = {name: run.result() for name, run in runs.items()}
    return json.dumps({"sigterm_drill": dict(out, gpu=gpu)}) + "\n", {}


def nxm_argv() -> list:
    """Phase X's config 3: the four kernels, ``--num_devices`` the global
    rank count."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--train_steps", str(NXM_STEPS), "--batch_size", str(BATCH),
            "--log_every", "10", "--resume", "false", "--log_dir", "",
            "--num_devices", str(NXM_PROCESSES * NXM_LOCAL)]


#: What phase X keeps of each rank's run.
NXM_KEYS = ("rank", "steps", "all_reduces", "launches", "loss_tape",
            "params_digest", "stats_digest", "text", "steps_per_sec",
            "final_accuracy", "device", "num_replicas", "global_batch",
            "eval_batches", "wall_s_incl_setup_and_eval")


def nxm_rank(argv: list) -> dict:
    """One of phase X's ranks: ``Engine(spec).run()`` inside the group,
    under cuDNN's deterministic algorithms (so that two groups of the
    same ranks can be compared bit for bit)."""
    r = nccl_rank(argv)
    return {k: r[k] for k in NXM_KEYS}


def nxm_launcher(argv: list) -> None:
    """Phase X's launcher process: ``TF_CONFIG`` names it process p of N;
    it starts its M gloo ranks on ``cuda:0`` as the global ranks
    ``p*M ..`` of one group of N*M over ``tcp://<coordinator>``
    (``parallel/launch.spawn``'s rank offset and TCP rendezvous: what the
    Engine's launcher runs, whose command line refuses M ranks on one
    card), joins no group itself, and prints its ranks' results as one
    JSON line."""
    from distributedtensorflowexample_tpu_torch import cluster
    from distributedtensorflowexample_tpu_torch.config import parse_flags
    info = cluster.resolve(parse_flags(argv))
    ranks = launch.spawn(
        nxm_rank, info.num_processes * NXM_LOCAL, "gloo", (argv,),
        timeout_s=600, local=NXM_LOCAL, offset=info.process_id * NXM_LOCAL,
        init_method=f"tcp://{info.coordinator_address}")
    print("NXM " + json.dumps(ranks), flush=True)


def run_nxm_phase(gpu: str) -> tuple:
    """Phase X: two launcher processes joined by ``TF_CONFIG`` on
    127.0.0.1, two gloo ranks each on ``cuda:0``, config 3 with the four
    kernels; beside them the same four ranks started by this process.
    Returns the trainer's lines and the ``nxm_path`` line to print, and
    the launches by path (per global rank)."""
    from distributedtensorflowexample_tpu_torch import cluster
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    workers = [f"127.0.0.1:{port}", f"127.0.0.1:{port + 1}"]
    argv = nxm_argv()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.nxm_launcher(sys.argv[1:])", *argv], cwd=ROOT,
        env=dict(os.environ, TF_CONFIG=cluster.tf_config_env(workers, pid)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(NXM_PROCESSES)]
    try:
        # Through JSON, as the launchers' results come (tuples to lists).
        one = json.loads(json.dumps(launch.spawn(
            nxm_rank, NXM_PROCESSES * NXM_LOCAL, "gloo", (argv,),
            timeout_s=600)))
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for p, (out, err) in zip(procs, outs):
        lines = [l for l in out.splitlines() if l.startswith("NXM ")]
        require(p.returncode == 0 and len(lines) == 1,
                f"phase X: a launcher gave exit code {p.returncode}:\n"
                f"{(out + err)[-3000:]}")
        ranks += json.loads(lines[0][4:])
    world = NXM_PROCESSES * NXM_LOCAL
    require([r["rank"] for r in ranks] == list(range(world)),
            f"phase X: global ranks {[r['rank'] for r in ranks]}")
    evals = ranks[0]["eval_batches"]
    expect = {"dequant": NXM_STEPS + evals, "ce_fwd": NXM_STEPS,
              "ce_bwd": NXM_STEPS, "sgd": NXM_STEPS}
    check_ranks(ranks, "phase X", expect, NXM_STEPS)
    check_ranks(one, "phase X (one process)", expect, NXM_STEPS)
    require(ranks[0]["params_digest"] == one[0]["params_digest"]
            and ranks[0]["loss_tape"] == one[0]["loss_tape"],
            f"phase X: the 2 x 2 ranks ({ranks[0]['params_digest']}, "
            f"{ranks[0]['loss_tape']}) differ from the same 4 ranks in one "
            f"process ({one[0]['params_digest']}, {one[0]['loss_tape']})")
    check_loss_tape(ranks[0], ranks[0]["text"])
    require(all(r["num_replicas"] == world and r["device"] == "cuda:0"
                for r in ranks), "phase X: a rank's mesh or card is wrong")
    line = json.dumps({"nxm_path": {
        "processes": NXM_PROCESSES, "ranks_per_process": NXM_LOCAL,
        "world": world, "backend": "gloo", "device": ranks[0]["device"],
        "steps": NXM_STEPS, "batch_per_rank": BATCH,
        "global_batch": ranks[0]["global_batch"],
        "steps_per_sec_by_rank": [r["steps_per_sec"] for r in ranks],
        "one_process_steps_per_sec": one[0]["steps_per_sec"],
        "wall_s": round(wall, 1),
        "final_accuracy": ranks[0]["final_accuracy"],
        "loss_tape": ranks[0]["loss_tape"],
        "launches_by_rank": [r["launches"] for r in ranks],
        "params_digest": ranks[0]["params_digest"],
        "bitwise_equal_to_one_process": True, "gpu": gpu}})
    return (ranks[0]["text"] + line + "\n",
            {"mnist_cnn_nxm": [r["launches"] for r in ranks]})


def run_side_and_scheduling_phases(gpu: str) -> dict:
    """Phases C, H and J beside phase V: all four are mostly process
    start-ups, none is timed against a limit (C's and H's steps/s are
    then not a quiet card's), and V (a) reads phase U's uninterrupted
    run, so U runs before them.  C, H and J each return their lines,
    printed in that order, then V's, after all end: one thread prints,
    and C's in-process trainer redirects this process's stdout while it
    runs."""
    side_phases = (run_nccl_phase, run_multiworker_phase, run_drill_phase)
    with concurrent.futures.ThreadPoolExecutor(len(side_phases)) as pool:
        sides = [pool.submit(phase, gpu) for phase in side_phases]
        try:
            scheduling = run_scheduling_phase(gpu)
        finally:
            done = [side.result() for side in sides]
    launches = {}
    for text, side_launches in done + [scheduling]:
        print(text, end="", flush=True)
        launches.update(side_launches)
    return launches


# --- phase U: supervision on the card --------------------------------------

TOOLS = "distributedtensorflowexample_tpu_torch.tools."


def supervised_trainer(argv: list) -> None:
    """Phase U (a)'s supervised child: ``trainer_sync_mnist`` under cuDNN's
    deterministic algorithms; its last stdout line is the attempt's
    kernel launches and summary, also when SIGTERM ends it with 143."""
    from distributedtensorflowexample_tpu_torch.trainers import (
        trainer_sync_mnist)
    torch.backends.cudnn.deterministic = True
    summary = None
    try:
        summary = trainer_sync_mnist.main(argv)
    finally:
        keep = ("start_step", "steps", "eval_batches", "params_digest",
                "final_accuracy", "steps_per_sec")
        print(json.dumps({"supervised_attempt": {
            "attempt": int(os.environ.get("SUPERVISE_ATTEMPT", "-1")),
            "launches": kernels.launch_counts(),
            "summary": None if summary is None else
            {k: summary[k] for k in keep}}}), flush=True)


def child_pids(pid: int) -> list:
    """The child processes of ``pid``: the ids in
    ``/proc/<pid>/task/*/children`` that lead their own thread group and
    whose parent is ``pid`` (a sandboxed kernel may list a child's
    threads there too)."""
    found = set()
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            found.update(int(c) for c in
                         (task / "children").read_text().split())
        except OSError:
            continue
    out = []
    for c in sorted(found):
        try:
            status = Path(f"/proc/{c}/status").read_text()
        except OSError:
            continue
        fields = dict(line.split(":", 1) for line in status.splitlines()
                      if ":" in line)
        if (int(fields.get("Tgid", -1)) == c
                and int(fields.get("PPid", -1)) == pid):
            out.append(c)
    return out


def stop(p: subprocess.Popen) -> None:
    """End ``p`` if it still runs: SIGTERM first, which a supervisor
    forwards to its children's process groups, then SIGKILL."""
    if p.poll() is None:
        p.terminate()
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def journal_rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


def supervised_preemption(gpu: str) -> tuple:
    """Phase U (a): config 3 with the four kernels under the port's
    ``supervise``; SIGTERM to the child after its first log line; 143 then
    0, the resume bitwise an uninterrupted run's."""
    root = ROOT / "build" / "chip_smoke_supervised"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    flags = supervised_flags(500)
    cmd = [sys.executable, "-m", TOOLS + "supervise", "--retries", "2",
           "--heartbeat_timeout_s", str(SUPERVISED_HB_S), "--heartbeat",
           str(root / "hb"), "--journal", str(root / "journal.jsonl"),
           "--seed", "0", "--", sys.executable, "-u", "-c",
           "import sys, chip_smoke; chip_smoke.supervised_trainer("
           "sys.argv[1:])", *flags, "--log_dir", str(root / "supervised")]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines, first = [], threading.Event()

    def drain():
        for line in p.stdout:
            lines.append(line)
            if line.startswith("step ") and "loss" in line:
                first.set()
        first.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        first.wait(timeout=300)
        kids = child_pids(p.pid)
        require(len(kids) == 1, f"phase U (a): the supervisor has children "
                                f"{kids}, want the one trainer:\n"
                                f"{''.join(lines)[-3000:]}")
        t_signal, signal_wall = time.perf_counter(), time.time()
        os.kill(kids[0], signal.SIGTERM)
        p.wait(timeout=600)
    finally:
        stop(p)
        reader.join(timeout=30)
    wall = time.perf_counter() - t0
    text = "".join(lines)
    attempts = [json.loads(l)["supervised_attempt"] for l in lines
                if l.startswith('{"supervised_attempt"')]
    rows = [r for r in journal_rows(root / "journal.jsonl")
            if r["event"] == "attempt_end"]
    ends = [(r["attempt"], r["rc"], r["reason"]) for r in rows]
    m = re.search(r"SIGTERM at step (\d+): checkpoint saved", text)
    require(p.returncode == 0 and ends == [(0, 143, "exit"), (1, 0, "exit")]
            and m is not None and len(attempts) == 2
            and "Traceback" not in text,
            f"phase U (a): supervise exit code {p.returncode}, attempts "
            f"{ends}:\n{text[-4000:]}")
    saved = int(m.group(1))
    require(f"resumed from checkpoint at step {saved}" in text
            and attempts[1]["summary"]["start_step"] == saved,
            f"phase U (a): attempt 1 did not resume at step {saved}")
    trained = [saved, SUPERVISED_STEPS - saved]
    evals = attempts[1]["summary"]["eval_batches"]
    for a, n, ev in zip(attempts, trained, (0, evals)):
        want = {"dequant": n + ev, "ce_fwd": n, "ce_bwd": n, "sgd": n}
        require(a["launches"] == want and n > 0,
                f"phase U (a): attempt {a['attempt']} launches "
                f"{a['launches']}, expected {want}")
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = run_trainer("trainer_sync_mnist",
                          flags + ["--log_dir", str(root / "straight")])
    finally:
        torch.backends.cudnn.deterministic = cudnn
    last = SUPERVISED_STEPS
    a, b = (torch.load(root / d / "checkpoints" / str(last) / "rank-0.pt",
                       weights_only=True) for d in ("supervised", "straight"))
    bitwise = (torch.equal(a["params"], b["params"])
               and torch.equal(a["momentum"], b["momentum"])
               and attempts[1]["summary"]["params_digest"]
               == ref["params_digest"])
    require(bitwise, f"phase U (a): the resumed parameters are "
                     f"{(a['params'] - b['params']).abs().max().item():.3g} "
                     f"from the uninterrupted run's")
    return {"steps": SUPERVISED_STEPS, "preempted_at": saved,
            "attempt_rcs": [rc for _, rc, _ in ends],
            "launches_by_attempt": [x["launches"] for x in attempts],
            "resumed_bitwise": bitwise,
            "signal_to_attempt_end_s": rows[0]["ts"] - signal_wall,
            "first_line_s": t_signal - t0,
            "wall_s": wall}, [x["launches"] for x in attempts]


def watch_mtimes(path: Path, stop: threading.Event, seen: set) -> None:
    """Phase U (b): every mtime ``path`` shows, polled every 10 ms."""
    while not stop.is_set():
        try:
            seen.add(os.path.getmtime(path))
        except OSError:
            pass
        time.sleep(0.01)


def faultline_argv(*extra) -> list:
    return [sys.executable, "-m", TOOLS + "faultline", "--device", "cuda",
            "--model", "mnist_cnn", "--steps", str(FAULT_STEPS), "--seed",
            "0", *extra]


def last_json(path: Path) -> dict:
    return json.loads(path.read_text().strip().splitlines()[-1])


def start(cmd: list, log: Path) -> subprocess.Popen:
    with open(log, "wb") as f:
        return subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)


def wedge_under_watchdog(root: Path) -> tuple:
    """Phase U (b): ``faultline --plan wedge@3:60`` under ``supervise``;
    returns the process and what to check once it ends."""
    hb = root / "hb"
    cmd = [sys.executable, "-m", TOOLS + "supervise", "--retries", "1",
           "--backoff_base_s", "0.01", "--heartbeat_timeout_s",
           str(WEDGE_HB_S), "--kill_grace_s", str(WEDGE_GRACE_S),
           "--heartbeat", str(hb), "--journal", str(root / "journal.jsonl"),
           "--stdout", str(root / "out.json"), "--seed", "0", "--",
           *faultline_argv("--plan", "wedge@3:60", "--workdir",
                           str(root / "w"))]
    stop, seen = threading.Event(), set()
    watcher = threading.Thread(target=watch_mtimes, args=(hb, stop, seen),
                               daemon=True)
    watcher.start()
    return start(cmd, root / "log.txt"), (stop, watcher, seen)


def check_wedge(root: Path, rc: int, watch: tuple) -> dict:
    stop, watcher, seen = watch
    stop.set()
    watcher.join(timeout=10)
    text = (root / "log.txt").read_text()
    ends = [(r["attempt"], r["rc"], r["reason"], r["ts"])
            for r in journal_rows(root / "journal.jsonl")
            if r["event"] == "attempt_end"]
    require(rc == 0 and [e[:3] for e in ends] == [
        (0, None, "heartbeat_timeout"), (1, 0, "exit")],
        f"phase U (b): supervise exit code {rc}, attempts {ends}:\n"
        f"{text[-4000:]}")
    final = last_json(root / "out.json")
    require(final["status"] == "ok" and final["step"] == FAULT_STEPS
            and final["start_step"] == 3,
            f"phase U (b): the retry gave {final}")
    killed_at = ends[0][3]
    beats = [t for t in seen if t <= killed_at]
    require(bool(beats), "phase U (b): no beat seen before the kill")
    gap = killed_at - max(beats)
    require(WEDGE_HB_S <= gap <= WEDGE_HB_S + WEDGE_GRACE_S + 5.0,
            f"phase U (b): {gap:.3f} s from the last beat to the kill, "
            f"timeout {WEDGE_HB_S} s, grace {WEDGE_GRACE_S} s")
    stale = re.search(r"heartbeat stale ([0-9.]+)s", text)
    return {"heartbeat_timeout_s": WEDGE_HB_S, "kill_grace_s": WEDGE_GRACE_S,
            "last_beat_to_kill_s": gap,
            "stale_age_at_detection_s": float(stale.group(1)) if stale
            else None, "retry_start_step": final["start_step"]}


def gang_on_the_card(root: Path) -> tuple:
    """Phase U (c): ``supervise_fleet --num_ranks 2`` of faultline ranks on
    the one card, rank 1 SIGKILLed at step 4; rank 0 is slowed from step 2
    so the gang is still whole when rank 1 dies, and the teardown has a
    live rank to stop.  With the uninterrupted reference, in parallel."""
    cmd = [sys.executable, "-m", TOOLS + "supervise_fleet", "--num_ranks",
           "2", "--retries", "1", "--backoff_base_s", "0.01",
           "--kill_grace_s", "30", "--workdir", str(root / "fleet"),
           "--seed", "0", "--",
           *faultline_argv("--plan", "kill@4%1,slow_rank@2:1.0%0", "--keep",
                           "20", "--workdir", str(root / "fleet"
                                                  / "rank{rank}"))]
    ref = faultline_argv("--plan", "none", "--workdir", str(root / "ref"))
    return (start(cmd, root / "fleet_log.txt"),
            start(ref, root / "ref_log.txt"))


def check_gang(root: Path, rc: int, ref_rc: int) -> dict:
    fleet = root / "fleet"
    text = (root / "fleet_log.txt").read_text()
    require(rc == 0 and ref_rc == 0,
            f"phase U (c): supervise_fleet exit code {rc}, reference "
            f"{ref_rc}:\n{text[-4000:]}")
    ref = last_json(root / "ref_log.txt")
    rows = journal_rows(fleet / "fleet.jsonl")
    killed = [r for r in rows if r["event"] == "rank_exit"
              and r["attempt"] == 0 and r["rank"] == 1]
    tear = [r for r in rows if r["event"] == "gang_teardown"]
    agree = [r for r in rows if r["event"] == "resume_agreement"]
    starts = [r for r in rows if r["event"] == "gang_start"]
    require(killed and killed[0]["rc"] == -signal.SIGKILL,
            f"phase U (c): rank 1's attempt-0 exit {killed}")
    require(tear and tear[0]["why"] == "rank_crash" and tear[0]["rank"] == 1,
            f"phase U (c): teardown {tear}")
    require(len(agree) == 1 and len(starts) == 2,
            f"phase U (c): agreements {agree}, gang starts {starts}")
    agreed = agree[0]["agreed"]
    require(agreed >= 1 and starts[1]["resume_step"] == agreed,
            f"phase U (c): agreed step {agreed}, exported "
            f"{starts[1]['resume_step']}")
    finals = [last_json(fleet / f"rank{r}_attempt1.out") for r in (0, 1)]
    for r, f in enumerate(finals):
        require(f["status"] == "ok" and f["start_step"] == agreed
                and f["step"] == FAULT_STEPS and f["digest"] == ref["digest"]
                and f["losses"] == ref["losses"][agreed:],
                f"phase U (c): rank {r} ended {f}, the uninterrupted run "
                f"{ref['digest']}")
    teardown_rcs = {r["rank"]: r["rc"] for r in rows
                    if r["event"] == "rank_exit" and r["attempt"] == 0}
    return {"agreed_step": agreed, "attempt0_rcs": teardown_rcs,
            "discarded": agree[0]["discarded"],
            "digest_equal_uninterrupted": True}


def run_supervision_phase(gpu: str) -> dict:
    """Phase U: (b) and (c) started first, (a) in the meantime (their
    processes share the one card)."""
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_faults"
    shutil.rmtree(root, ignore_errors=True)
    (root / "wedge").mkdir(parents=True)
    (root / "gang").mkdir(parents=True)
    wedge, watch = wedge_under_watchdog(root / "wedge")
    gang, ref = gang_on_the_card(root / "gang")
    procs = (wedge, gang, ref)
    try:
        pre, launches = supervised_preemption(gpu)
        for q in procs:
            q.wait(timeout=600)
    finally:
        for q in procs:
            stop(q)
    result = {"supervised_preemption": pre,
              "wedge_watchdog": check_wedge(root / "wedge", wedge.returncode,
                                            watch),
              "gang": check_gang(root / "gang", gang.returncode,
                                 ref.returncode),
              "wall_s": time.perf_counter() - t0, "gpu": gpu}
    print(json.dumps({"supervision_path": result}), flush=True)
    return {"mnist_cnn_supervised": launches}


# --- phase V: the scheduler and the heal drills on the card ---------------

SCHED_ROOT = ROOT / "build" / "chip_smoke_sched"
SCHED_CKPT_EVERY = 50       # phase V (a): the evictor waits for step 50's
HEAL_STEPS = 16             # phase V (c): faultline steps
HEAL_SLOW_AT = 5            # phase V (c): rank 1 slow from this step ...
HEAL_SLOW_S = 2.0           # ... by this much a step
#: Phase V (c) leaves each rank's step-time regression detector unarmed
#: (its warm-up longer than the run): with a few warm-up steps, a hiccup
#: of the front rank's host on this loaded machine fired it and evicted
#: the gang for the wrong rank.  The eviction rests on the fleet's
#: straggler naming instead (3 steps behind the front and a step time
#: over 4x the other rank's), which the front rank cannot meet.
HEAL_ENV = {"OBS_ANOMALY_WARMUP": "1000"}


def supervised_flags(checkpoint_every: int) -> list:
    """Phase U (a)'s and V (a)'s config-3 run: the four kernels, 1,000
    steps at B=64 (the caller adds ``--log_dir``)."""
    return ["--device", "cuda", "--dataset", "synthetic", "--dequant_impl",
            "pallas", "--pallas_ce", "true", "--fused_optimizer", "true",
            "--batch_size", str(BATCH), "--train_steps",
            str(SUPERVISED_STEPS), "--log_every", "100",
            "--checkpoint_every", str(checkpoint_every)]


def write_queue(root: Path) -> Path:
    """Phase V (a)'s queue: the config-3 victim (priority 10), the
    priority-0 faultline evictor gated on the victim's first committed
    checkpoint, and a wedge (rc 3)."""
    victim = root / "victim"
    jobs = [
        {"job": "victim", "kind": "train", "priority": 10,
         "steps": SUPERVISED_STEPS, "est_step_time_s": 0.01,
         "wall_timeout_s": 600, "kill_grace_s": 60, "retries": 0,
         # Every checkpoint kept: the evictor's gate file must still be
         # there when the evictor comes up after the eviction.
         "argv": [sys.executable, "-u", "-c",
                  "import sys, chip_smoke; chip_smoke.supervised_trainer("
                  "sys.argv[1:])",
                  *supervised_flags(SCHED_CKPT_EVERY),
                  "--log_dir", str(victim), "--keep_checkpoints",
                  str(SUPERVISED_STEPS // SCHED_CKPT_EVERY)]},
        {"job": "evictor", "kind": "train", "priority": 0,
         "steps": FAULT_STEPS, "est_step_time_s": 0.1,
         "wall_timeout_s": 600, "retries": 0,
         "argv": faultline_argv("--plan", "none", "--workdir",
                                str(root / "evictor")),
         "after_file": str(victim / "checkpoints" / str(SCHED_CKPT_EVERY)
                           / "rank-0.pt")},
        {"job": "wedge", "kind": "drill", "priority": 20, "retries": 0,
         "argv": [sys.executable, "-c", "import sys; sys.exit(3)"]},
    ]
    path = root / "queue.json"
    path.write_text(json.dumps({"jobs": jobs}, indent=1))
    return path


def scheduled_attempt(path: Path) -> dict:
    return next(json.loads(l)["supervised_attempt"] for l in
                reversed(path.read_text().splitlines())
                if l.startswith('{"supervised_attempt"'))


def check_scheduled_queue(root: Path, rc: int, gpu: str) -> tuple:
    """Phase V (a): evict -> 143 -> resume, the victim bitwise phase U's
    uninterrupted run, the wedge quarantined, launches by placement."""
    sched = root / "sched"
    text = (root / "sched_log.txt").read_text()
    require(rc == 3, f"phase V (a): schedule exit code {rc}, want 3 (the "
                     f"wedge quarantined):\n{text[-4000:]}")
    rows = journal_rows(sched / "RUNS.jsonl")
    dec = [(r["event"], r.get("job")) for r in rows
           if r["event"].startswith("sched_")]
    evict = [r for r in rows if r["event"] == "sched_evict"]
    places = [r for r in rows if r["event"] == "sched_place"
              and r["job"] == "victim"]
    require(len(evict) == 1 and evict[0]["job"] == "victim"
            and evict[0]["for_job"] == "evictor"
            and evict[0]["rcs"] == {"0": 143} and evict[0]["clean"],
            f"phase V (a): evictions {evict}; decisions {dec}")
    order = [dec.index(d) if d in dec else -1 for d in (
        ("sched_evict", "victim"), ("sched_place", "evictor"),
        ("sched_done", "victim"))]
    require([p["resumed"] for p in places] == [False, True]
            and order == sorted(order) and -1 not in order,
            f"phase V (a): victim placements {places}; decisions {dec}")
    require(("sched_quarantine", "wedge") in dec
            and ("sched_done", "evictor") in dec
            and sum(1 for d in dec if d == ("sched_place", "wedge")) == 1,
            f"phase V (a): decisions {dec}")
    out = sched / "jobs" / "victim" / "out"
    first, second = (scheduled_attempt(out / f"place{n}" /
                                       "rank0_attempt0.out") for n in (1, 2))
    prose = "".join(p.read_text() for p in
                    (sched / "jobs" / "victim" / "fleet").glob("rank*.log"))
    prose += "".join(p.read_text() for p in out.glob("place*/*.out"))
    m = re.search(r"SIGTERM at step (\d+): checkpoint saved", prose)
    require(m is not None and second["summary"] is not None,
            f"phase V (a): no save at the eviction:\n{prose[-3000:]}")
    saved = int(m.group(1))
    require(second["summary"]["start_step"] == saved
            and SCHED_CKPT_EVERY <= saved < SUPERVISED_STEPS,
            f"phase V (a): resumed at {second['summary']['start_step']}, "
            f"saved at {saved}")
    trained = [saved, SUPERVISED_STEPS - saved]
    evals = second["summary"]["eval_batches"]
    for a, n, ev in zip((first, second), trained, (0, evals)):
        want = {"dequant": n + ev, "ce_fwd": n, "ce_bwd": n, "sgd": n}
        require(a["launches"] == want,
                f"phase V (a): placement launches {a['launches']}, expected "
                f"{want}")
    last = str(SUPERVISED_STEPS)
    a, b = (torch.load(d / "checkpoints" / last / "rank-0.pt",
                       weights_only=True)
            for d in (root / "victim",
                      ROOT / "build" / "chip_smoke_supervised" / "straight"))
    bitwise = (torch.equal(a["params"], b["params"])
               and torch.equal(a["momentum"], b["momentum"]))
    require(bitwise, "phase V (a): the resumed victim differs from phase "
                     "U's uninterrupted run")
    intent = next(r for r in journal_rows(sched / "sched.jsonl")
                  if r["event"] == "sched_intent"
                  and r.get("action") == "evict")
    exit143 = next(r for r in journal_rows(sched / "jobs" / "victim" /
                                           "fleet.jsonl")
                   if r["event"] == "rank_exit" and r.get("rc") == 143)
    record = journal_rows(root / "record.jsonl")
    require(record[0]["platform"] == "cuda"
            and record[0]["detail"]["gpu"] == gpu,
            f"phase V (a): record {record[0]}")
    return {"decisions": dec, "preempted_at": saved,
            "launches_by_placement": [first["launches"], second["launches"]],
            "resumed_bitwise": bitwise,
            "term_to_143_s": exit143["ts"] - intent["ts"],
            "makespan_s": record[0]["detail"]["makespan_s"]}, \
        [first["launches"], second["launches"]]


def check_ckpt_drill(root: Path, rc: int) -> dict:
    """Phase V (b): ``heal_drill --drill ckpt --mesh 2`` on the card."""
    text = (root / "heal_log.txt").read_text()
    require(rc == 0, f"phase V (b): heal_drill exit code {rc}:\n"
                     f"{text[-4000:]}")
    rows = {}
    for r in journal_rows(root / "heal.jsonl"):
        rows.setdefault(r["metric"], []).append(r)
    out = {}
    for plan, event in (("shard_loss", "ckpt_reconstruct"),
                        ("bitflip", "ckpt_digest_mismatch")):
        (lost,) = rows[f"heal_ckpt_{plan}_steps_lost"]
        d = lost["detail"]
        require(lost["value"] == 0 and d["bitwise_resume"]
                and d["reconstructs"] >= 1 and d["detect_event"] == event
                and lost["platform"] == "cuda",
                f"phase V (b): {plan}: {lost}")
        out[plan] = {"mttd_ms": d["mttd_ms"], "mttr_ms": d["mttr_ms"],
                     "reconstructs": d["reconstructs"],
                     "detect_event": d["detect_event"],
                     "steps_lost": lost["value"], "bitwise_resume": True}
    for metric in ("ckpt_shard_restore_failures",
                   "ckpt_digest_mismatch_unrecovered"):
        values = [r["value"] for r in rows[metric]]
        require(values == [0, 0], f"phase V (b): {metric} {values}")
        out[metric] = 0
    return out


def healed_gang(root: Path) -> tuple:
    """Phase V (c): ``supervise_fleet --heal`` of two faultline ranks on
    the card, rank 1 slow from step ``HEAL_SLOW_AT``; with the
    uninterrupted reference beside it."""
    cmd = [sys.executable, "-m", TOOLS + "supervise_fleet", "--num_ranks",
           "2", "--heal", "--kill_grace_s", "30", "--backoff_base_s", "0.01",
           "--workdir", str(root / "gang"), "--seed", "0", "--",
           *faultline_argv("--plan", f"slow_rank@{HEAL_SLOW_AT}:"
                           f"{HEAL_SLOW_S}%1", "--steps", str(HEAL_STEPS),
                           "--keep", "50", "--workdir",
                           str(root / "gang" / "rank{rank}"))]
    ref = faultline_argv("--plan", "none", "--steps", str(HEAL_STEPS),
                         "--workdir", str(root / "heal_ref"))
    with open(root / "gang_log.txt", "wb") as f:
        gang = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT,
                                env={**os.environ, **HEAL_ENV})
    return gang, start(ref, root / "heal_ref_log.txt")


def check_healed_gang(root: Path, rc: int, ref_rc: int) -> dict:
    gang = root / "gang"
    text = (root / "gang_log.txt").read_text()
    require(rc == 0 and ref_rc == 0,
            f"phase V (c): supervise_fleet --heal exit code {rc}, reference "
            f"{ref_rc}:\n{text[-4000:]}")
    ref = last_json(root / "heal_ref_log.txt")
    rows = journal_rows(gang / "RUNS.jsonl")
    evict = [r for r in rows if r["event"] == "heal_evict"]
    detect = [r for r in rows if r["event"] == "heal_detect"]
    require(evict and evict[0]["rank"] == 1
            and evict[0]["kind"] == "straggler" and detect,
            f"phase V (c): heal rows "
            f"{[(r['event'], r.get('kind'), r.get('rank')) for r in rows]}")
    launches = sorted(p.name for p in gang.glob("launch*"))
    require(launches == ["launch0", "launch1"],
            f"phase V (c): launches {launches}")
    finals = [last_json(gang / "launch1" / f"rank{r}_attempt0.out")
              for r in (0, 1)]
    agreed = finals[0]["start_step"]
    for r, f in enumerate(finals):
        require(f["status"] == "ok" and f["start_step"] == agreed
                and f["step"] == HEAL_STEPS and f["digest"] == ref["digest"]
                and f["losses"] == ref["losses"][agreed:]
                and HEAL_SLOW_AT <= agreed < HEAL_STEPS,
                f"phase V (c): rank {r} ended {f}, the uninterrupted run "
                f"{ref['digest']}")
    onset = (detect[0].get("detail") or {}).get("updated_unix")
    return {"agreed_step": agreed, "evict_kind": evict[0]["kind"],
            "detect_to_evict_s": evict[0]["ts"] - detect[0]["ts"],
            "onset_to_detect_s": (detect[0]["ts"] - onset
                                  if onset else None),
            "digest_equal_uninterrupted": True}


def run_scheduling_phase(gpu: str) -> tuple:
    """Phase V: (b) and (c) started first, (a) in the meantime; all three
    through the port's ``-m`` entry points.  Not beside phase U: its
    wedge drill's 3 s heartbeat timeout does not survive the disk and
    CPU load of (b) and (c).  Returns the lines to print and the
    launches by path."""
    t0 = time.perf_counter()
    root = SCHED_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    heal = start([sys.executable, "-m", TOOLS + "heal_drill", "--drill",
                  "ckpt", "--model", "softmax", "--mesh", str(MR_RANKS),
                  "--device", "cuda", "--workdir", str(root / "heal"),
                  "--out", str(root / "heal.jsonl")], root / "heal_log.txt")
    gang, ref = healed_gang(root)
    procs = (heal, gang, ref)
    try:
        cmd = [sys.executable, "-m", TOOLS + "schedule", "--queue",
               str(write_queue(root)), "--workdir", str(root / "sched"),
               "--devices", "1", "--device", "cuda", "--seed", "0",
               "--record", str(root / "record.jsonl")]
        with open(root / "sched_log.txt", "wb") as f:
            rc = subprocess.run(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=600).returncode
        queue, launches = check_scheduled_queue(root, rc, gpu)
        for q in procs:
            q.wait(timeout=600)
    finally:
        for q in procs:
            stop(q)
    result = {"scheduled_queue": queue,
              "ckpt_drill": check_ckpt_drill(root, heal.returncode),
              "healed_gang": check_healed_gang(root, gang.returncode,
                                               ref.returncode),
              "wall_s": time.perf_counter() - t0, "gpu": gpu}
    lines = [{"scheduling_path": result}] + [
        {f"scheduling_{part}": result[part], "gpu": gpu}
        for part in ("scheduled_queue", "ckpt_drill", "healed_gang")]
    return ("".join(json.dumps(line) + "\n" for line in lines),
            {"mnist_cnn_scheduled": launches})


# --- phase W: the control plane at fleet scale, and the ledger's readers --

SIM_ROOT = ROOT / "build" / "chip_smoke_sim"
#: Phase W's tools are torch-free: a child that imports them loads none of
#: these, so W launches no kernel and touches no device.
W_BANNED = ("torch", "jax", "jaxlib", "distributedtensorflowexample_tpu")
W_TOOLS = ("sim", "tools.sim_run", "tools.obs_query", "tools.obs_report")


def run_tool(name: str, *args, timeout: float = 300) -> tuple:
    """(exit code, stdout, stderr) of ``python -m <port>.tools.<name>``."""
    proc = subprocess.run([sys.executable, "-m", TOOLS + name, *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def tools_stay_torch_free() -> None:
    """Phase W: a fresh interpreter imports the simulator and the three
    tools and loads neither torch nor JAX."""
    pkg = TOOLS.rsplit(".", 2)[0]
    probe = ("import importlib, sys\n"
             f"for m in {W_TOOLS!r}:\n"
             f"    importlib.import_module({pkg!r} + '.' + m)\n"
             "print(sorted(m for m in sys.modules\n"
             f"             if m.split('.')[0] in {W_BANNED!r}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    require(out.returncode == 0 and out.stdout.strip() == "[]",
            f"phase W: the tools import {out.stdout.strip()} "
            f"{out.stderr[-2000:]}")


def check_battery() -> dict:
    """Phase W (a): ``sim_run --battery``, the four 10,000-rank storms
    each twice against the port's scheduler and remediator."""
    record = SIM_ROOT / "battery.jsonl"
    t0 = time.perf_counter()
    rc, out, err = run_tool("sim_run", "--battery", "--workdir",
                            str(SIM_ROOT / "battery"), "--out", str(record))
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase W (a): sim_run --battery exit code {rc}:\n"
                     f"{err[-4000:]}")
    rows = {r["metric"]: r for r in journal_rows(record)}
    storms = {}
    for name in ("fleet10k", "epidemic10k", "servespike", "cascade10k"):
        zeros = {m: rows[f"sim_{name}_{m}"]["value"] for m in (
            "determinism_violations", "fleet_steps_lost",
            "wal_unbalanced_violations")}
        require(not any(zeros.values()), f"phase W (a): {name} {zeros}")
        storms[name] = {
            "ranks": rows[f"sim_{name}_ranks"]["value"],
            "virtual_s": rows[f"sim_{name}_virtual_s"]["value"],
            "jobs_done": rows[f"sim_{name}_jobs_done"]["value"],
            "evictions": rows[f"sim_{name}_evictions"]["value"],
            "queue_wait_p99_s": rows[f"sim_{name}_queue_wait_p99_s"]["value"],
            **zeros}
    require(storms["fleet10k"]["ranks"] == 10_000,
            f"phase W (a): fleet10k ranks {storms['fleet10k']['ranks']}")
    return {"storms": storms, "wall_s": wall}


def why(ledger: Path, job: str) -> dict:
    rc, out, err = run_tool("obs_query", "why", job, "--ledger", str(ledger),
                            "--format", "json")
    require(rc == 0, f"phase W (b): obs_query why {job} exit code {rc}:\n"
                     f"{err[-2000:]}")
    return json.loads(out)


def check_why() -> dict:
    """Phase W (b): ``obs_query why`` and ``list`` over phase V (a)'s live
    ledger: the victim's eviction for the priority-0 job, its resumed
    placement and its completion; the wedge's quarantine."""
    ledger = SCHED_ROOT / "sched" / "RUNS.jsonl"
    victim, wedge = why(ledger, "victim"), why(ledger, "wedge")
    texts = [line["text"] for line in victim["timeline"]]
    evicted = [t for t in texts if t.startswith("EVICTED:")]
    resumed = [t for t in texts if t.startswith("placed on")
               and "resuming from snapshots" in t]
    require(len(evicted) == 1 and "`evictor`" in evicted[0]
            and len(resumed) == 1 and texts[-1].startswith("done:")
            and "preempted 1x (for `evictor`)" in victim["verdict"]
            and victim["verdict"].endswith("finally completed"),
            f"phase W (b): why victim {victim}")
    require(any(t.startswith("QUARANTINED") for t in
                (line["text"] for line in wedge["timeline"]))
            and wedge["verdict"].endswith("finally quarantined"),
            f"phase W (b): why wedge {wedge}")
    rc, out, err = run_tool("obs_query", "list", "--ledger", str(ledger),
                            "--format", "json")
    require(rc == 0, f"phase W (b): obs_query list exit code {rc}:\n"
                     f"{err[-2000:]}")
    runs = json.loads(out)["runs"]
    outcomes = sorted(f"{r['entrypoint']}:{r['outcome']}" for r in runs)
    require(len(runs) >= 3 and any(r["outcome"] == "ok" for r in runs),
            f"phase W (b): obs_query list {outcomes}")
    return {"victim_verdict": victim["verdict"],
            "wedge_verdict": wedge["verdict"],
            "victim_timeline": len(texts), "runs_listed": outcomes}


def report(flight_dir: Path, journal: Path, fmt: str) -> str:
    rc, out, err = run_tool("obs_report", "--dir", str(flight_dir),
                            "--journal", str(journal), "--format", fmt)
    require(rc == 0, f"phase W (c): obs_report --format {fmt} on "
                     f"{journal} exit code {rc}:\n{err[-2000:]}")
    return out


def check_reports() -> dict:
    """Phase W (c): ``obs_report`` over phase U (c)'s two-rank fleet
    journal and flights (the lost rank, the agreed restart step, one
    trace lane per rank), and over phase V (c)'s healed gang."""
    fleet = ROOT / "build" / "chip_smoke_faults" / "gang" / "fleet"
    journal = fleet / "fleet.jsonl"
    (agree,) = [r for r in journal_rows(journal)
                if r["event"] == "resume_agreement"]
    md = report(fleet / "flight", journal, "md")
    require("## Per-rank timeline — `fleet.jsonl`" in md
            and "| 1 | 0 | `rank_exit` | rc=-9" in md
            and "`gang_teardown` | rank_crash" in md
            and f"agreed step {agree['agreed']}; " in md,
            f"phase W (c): the fleet report:\n{md[-4000:]}")
    lanes = [e["args"]["name"] for e in
             json.loads(report(fleet / "flight", journal,
                               "trace"))["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"]
    require(lanes.count("rank 0") == 1 and lanes.count("rank 1") == 1,
            f"phase W (c): trace lanes {lanes}")
    merged = json.loads(report(fleet / "flight", journal, "json"))
    healed = SCHED_ROOT / "gang"
    healed_md = report(healed / "flight", healed / "fleet.jsonl", "md")
    require("## Merged timeline" in healed_md,
            f"phase W (c): the healed gang's report:\n{healed_md[-2000:]}")
    return {"agreed_step": agree["agreed"], "trace_lanes": lanes,
            "flights": len(list((fleet / "flight").glob("flight_*.json"))),
            "ranks_present": merged["coverage"]["ranks_present"],
            "healed_gang_flights": len(list(
                (healed / "flight").glob("flight_*.json"))),
            "markdown_bytes": len(md)}


def run_control_plane_phase(gpu: str) -> None:
    """Phase W: the fleet simulator and the ledger's readers, each in a
    child process (the simulator patches process-wide clock seams), after
    phase V, whose ledger (b) reads.  No kernel launches: the launch
    counts of this process are the same after as before."""
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    shutil.rmtree(SIM_ROOT, ignore_errors=True)
    SIM_ROOT.mkdir(parents=True)
    tools_stay_torch_free()
    result = {"battery": check_battery(), "why": check_why(),
              "report": check_reports()}
    after = kernels.launch_counts()
    require(after == before, f"phase W: launches {before} -> {after}")
    result.update(launches={k: after[k] - before[k] for k in after},
                  wall_s=time.perf_counter() - t0, gpu=gpu)
    print(json.dumps({"control_plane_path": result}), flush=True)
    print(f"control plane: the 10,000-rank battery (four storms, each "
          f"twice) in {result['battery']['wall_s']:.2f} s of host wall "
          f"time on the card's machine ({gpu})", flush=True)


# --- phase Y: the port's own measurement tools -----------------------------

MEASURE_ROOT = ROOT / "build" / "chip_smoke_measure"
#: The round in the phase's record names (``_r<N>``), by which the ratchet
#: and the trajectory order rows.
MEASURE_ROUND = 16
#: NCCL over NVLink shows no bandwidth term below a few MiB (4 KiB-4 MiB
#: took 49-155 us flat on four H100s, and the fit came out degenerate), so
#: its sweep runs to 256 MiB; gloo, host-staged, keeps the JAX tool's
#: 4 KiB-4 MiB.
NCCL_SIZES = "4096,65536,1048576,16777216,268435456"
#: ab_augment: steps a timed window (half an epoch of 50,000 rows at
#: B=128; the JAX tool's window is 195 steps too).
AB_STEPS = 195


def measure_record(family: str) -> Path:
    return MEASURE_ROOT / "records" / f"{family}_r{MEASURE_ROUND}.json"


def check_collectives(backend: str, counts: tuple, gpu: str,
                      *extra) -> dict:
    """Phase Y (a): ``bench_collectives --backend <backend>`` (and
    ``extra`` flags) over every kind at the group sizes ``counts``; every
    kind is fitted or named unmeasured with its error, and the scheduler
    reads the psum fit of each group size back."""
    from distributedtensorflowexample_tpu_torch.resilience.scheduler import (
        load_collective_fit)
    family = ("BENCH_collectives_gpu" if backend == "gloo"
              else f"BENCH_collectives_{backend}_gpu")
    path = measure_record(family)
    t0 = time.perf_counter()
    rc, out, err = run_tool("bench_collectives", "--backend", backend,
                            "--submeshes", ",".join(map(str, counts)),
                            "--json", str(path), *extra, timeout=900)
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase Y (a): bench_collectives --backend {backend} "
                     f"exit code {rc}:\n{err[-4000:]}")
    detail = json.loads(path.read_text())["detail"]
    require(detail["backends"] == {str(n): backend for n in counts}
            and detail["device"]["platform"] == "gpu"
            and gpu.startswith(detail["device"]["name"]),
            f"phase Y (a): the record's backends and card "
            f"{detail['backends']} {detail['device']}")
    kinds = ("psum", "reduce_scatter", "all_gather", "all_to_all")
    for kind in kinds:
        for n in counts:
            fitted = str(n) in detail["knees"].get(kind, {})
            named = str(n) in detail["unmeasured"].get(kind, {})
            require(fitted != named, f"phase Y (a): {kind} at {n} ranks is "
                                     f"neither fitted nor named unmeasured")
    fits = {}
    for n in counts:
        fit = load_collective_fit(str(path), n)
        require(fit is not None and fit["fit_devices"] == n,
                f"phase Y (a): load_collective_fit({path.name}, {n}) = "
                f"{fit} ({detail['knees'].get('psum')})")
        fits[str(n)] = fit
    return {"backend": backend, "devices": list(counts),
            "host_staged": detail["host_staged"], "knees": detail["knees"],
            "unmeasured": detail["unmeasured"],
            "suggested_bucket_bytes": detail["suggested_bucket_bytes"],
            "read_back": fits, "wall_s": round(wall, 1)}


def check_ab_augment(gpu: str) -> tuple:
    """Phase Y (c): ``ab_augment`` on the card, every variant bitwise
    base before it is timed (the tool asserts it); the kernel variant
    launches the dequant kernel once a step, the others none.  Returns
    the line's dict and the launches by variant."""
    path = measure_record("BENCH_augment_gpu")
    t0 = time.perf_counter()
    rc, out, err = run_tool("ab_augment", "--steps", str(AB_STEPS),
                            "--out", str(path), timeout=600)
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase Y (c): ab_augment exit code {rc}:\n"
                     f"{err[-4000:]}")
    lines = journal_rows(path)
    variants = [l["metric"][len("input_path_"):-len("_steps_per_sec")]
                for l in lines]
    require(variants == ["base", "selmm", "selmm_oh", "noaug", "kernel"],
            f"phase Y (c): variants {variants}")
    windows = lines[0]["detail"]["timed_windows"]
    launches = {}
    for v, l in zip(variants, lines):
        d = l["detail"]
        want = {k: 0 for k in d["launches"]}
        if v == "kernel":
            want["dequant"] = windows * AB_STEPS
        require(d["bitwise_equal_to_base"] and d["launches"] == want
                and d["device"]["platform"] == "gpu"
                and gpu.startswith(d["device"]["name"]) and l["value"] > 0,
                f"phase Y (c): {v} {d}")
        launches[f"cifar_input_ab_{v}"] = [d["launches"]]
    rates = {v: {"steps_per_sec": l["value"],
                 "ms_per_step": l["detail"]["ms_per_step"],
                 "repeats": l["detail"]["repeats"]}
             for v, l in zip(variants, lines)}
    return {"batch": lines[0]["detail"]["batch"], "steps": AB_STEPS,
            "dequant_impl_base": lines[0]["detail"]["dequant_impl"],
            "variants": rates, "wall_s": round(wall, 1)}, launches


def check_bench_input() -> dict:
    """Phase Y (b): ``bench_input`` on the card machine's host, each of
    the four stages bit-identical to numpy before it is timed."""
    path = measure_record("BENCH_input_cpu")
    t0 = time.perf_counter()
    rc, out, err = run_tool("bench_input", "--out", str(path), timeout=600)
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase Y (b): bench_input exit code {rc}:\n"
                     f"{err[-4000:]}")
    lines = journal_rows(path)
    require(len(lines) == 4 and all(
        l["value"] > 0 and l["detail"]["device"]["platform"] == "cpu"
        for l in lines), f"phase Y (b): {lines}")
    return {"host": lines[0]["detail"]["device"], "stages": {
        l["metric"]: {"value": l["value"], "unit": l["unit"],
                      "vs_numpy": l["vs_baseline"],
                      "repeats": l["detail"]["repeats"]} for l in lines},
            "wall_s": round(wall, 1)}


def check_trajectory(families: list) -> dict:
    """Phase Y (d): ``bench_ratchet --trajectory`` and ``obs_query
    trajectory`` over the phase's records: one row per family, the same
    rows from both, and ``tools.schedule``'s price of a job named after
    the input A/B family reads the trajectory."""
    from distributedtensorflowexample_tpu_torch.resilience import (
        scheduler as sched)
    records = MEASURE_ROOT / "records"
    rc, out, err = run_tool("bench_ratchet", "--records_dir", str(records),
                            "--trajectory", "--json")
    require(rc == 0, f"phase Y (d): bench_ratchet exit code {rc}:\n"
                     f"{out[-2000:]}{err[-2000:]}")
    verdict = json.loads(out)
    traj = records / "BENCH_trajectory.json"
    written = journal_rows(traj)
    rc, out, err = run_tool("obs_query", "trajectory", "--records_dir",
                            str(records), "--format", "json")
    require(rc == 0, f"phase Y (d): obs_query trajectory exit code {rc}:\n"
                     f"{err[-2000:]}")
    rows = json.loads(out)
    got = sorted(r["family"] for r in rows)
    require(got == sorted(families) and rows == written
            and all(r["round"] == MEASURE_ROUND for r in rows),
            f"phase Y (d): trajectory families {got}, want "
            f"{sorted(families)}")
    cost = sched.predict_cost(sched.Job(job="aug", argv=["x"], steps=1000,
                                        family="BENCH_augment"), str(traj))
    require(cost["source"] == f"trajectory:BENCH_augment_gpu_r"
                              f"{MEASURE_ROUND}.json",
            f"phase Y (d): predict_cost {cost}")
    return {"rows": len(rows), "families": got,
            "platforms": {r["family"]: r["platforms"] for r in rows},
            "ratchet_findings": len(verdict["findings"]),
            "schedule_price": cost}


def run_measure_phase(gpu: str) -> tuple:
    """Phase Y: the port's measurement tools, each a ``python -m`` child
    process, beside W and X and beside each other (their readings are
    then not a quiet card's or host's): (a) ``bench_collectives`` over
    gloo at 2 and 4 ranks on the card (then NCCL at 2 where there are 2
    cards), (b) ``bench_input`` on the host, (c) ``ab_augment`` on the
    card; then (d) the ratchet's trajectory and ``obs_query trajectory``
    over their records.  Returns the lines to print and the launches by
    path."""
    t0 = time.perf_counter()
    shutil.rmtree(MEASURE_ROOT, ignore_errors=True)
    (MEASURE_ROOT / "records").mkdir(parents=True)
    families = ["BENCH_collectives_gpu", "BENCH_input_cpu",
                "BENCH_augment_gpu"]
    cards = torch.cuda.device_count()
    nccl = f"nccl unmeasured, {cards} card"
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        gloo = pool.submit(check_collectives, "gloo", (2, 4), gpu)
        ab = pool.submit(check_ab_augment, gpu)
        host = pool.submit(check_bench_input)
        result = {"collectives": {"gloo": gloo.result()}}
        if cards >= 2:
            result["collectives"]["nccl"] = check_collectives(
                "nccl", (2,), gpu, "--sizes", NCCL_SIZES)
            families.append("BENCH_collectives_nccl_gpu")
            nccl = "nccl measured at 2 ranks"
        result["input_ab"], launches = ab.result()
        result["host_input"] = host.result()
    result["trajectory"] = check_trajectory(families)
    result.update(nccl=nccl, wall_s=round(time.perf_counter() - t0, 1),
                  gpu=gpu)
    gloo = result["collectives"]["gloo"]["knees"]["psum"]
    ab = result["input_ab"]["variants"]
    text = (json.dumps({"measure_path": result}) + "\n"
            + f"measurement tools: psum knee {gloo['2']['knee_bytes']} B at "
              f"2 ranks, {gloo['4']['knee_bytes']} B at 4 (gloo, "
              f"host-staged; {nccl}); input path base "
              f"{ab['base']['steps_per_sec']:.1f}, kernel "
              f"{ab['kernel']['steps_per_sec']:.1f} steps/s on {gpu}\n")
    return text, launches


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

SHARD_STEPS = 4             # phase O: ZeRO-3 lm_base, a shard set every 2
SHARD_EVERY = 2
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
SHARDED_REQUESTS = 8
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


# --- phase Z: the serving bench --------------------------------------------

BENCH_ROOT = ROOT / "build" / "chip_smoke_bench_serving"
#: The round in the record's name (``_r<N>``), by which the ratchet orders.
BENCH_ROUND = 18
BENCH_ARGV = ["--device", "cuda", "--size", LM_SIZE, "--slots",
              str(SERVE_SLOTS), "--max_len", str(SERVE_CACHE), "--requests",
              "32", "--clients_sweep", "1,8", "--slo_sweep_ms", "0,200",
              "--repeats", "1", "--supervised_repeats", "1",
              "--spec_k_sweep", "4", "--sharded_mesh", str(MR_RANKS),
              "--sharded_requests", "16"]
#: The JAX harness's metric names (root ``bench_serving.py``) at lm_base.
BENCH_METRICS = tuple(f"serve_{LM_SIZE}_{m}" for m in (
    "supervised_tokens_per_sec", "tokens_per_sec", "p99_ms",
    "throughput_vs_slo", "sharded_tokens_per_sec",
    "sharded_params_frac_per_device", "spec_tokens_per_sec",
    "spec_accept_len", "spec_mismatch", "prefill_batch_amortization")) + (
    "serve_lm_base_sharded_params_frac_per_device", "serving_bench_meta")


def run_serving_bench_phase(gpu: str) -> dict:
    """Phase Z; returns the launches by path (the tool's process, its
    supervised worker, the sharded point's and the residency's ranks)."""
    shutil.rmtree(BENCH_ROOT, ignore_errors=True)
    record = BENCH_ROOT / "records" / f"SERVE_lm_gpu_r{BENCH_ROUND}.json"
    record.parent.mkdir(parents=True)
    t0 = time.perf_counter()
    rc, out, err = run_tool(
        "bench_serving", *BENCH_ARGV, "--snapshot", str(SERVE_SNAP),
        "--workdir", str(BENCH_ROOT / "work"), "--json", str(record),
        timeout=600)
    wall = time.perf_counter() - t0
    require(rc == 0, f"phase Z: bench_serving exit code {rc}:\n"
                     f"{err[-4000:]}")
    lines = journal_rows(record)
    names = [l["metric"] for l in lines]
    require(sorted(names) == sorted(BENCH_METRICS),
            f"phase Z: the record's metrics {names}")
    by = {}
    for l in lines:
        by.setdefault(l["metric"], []).append(l)
    for l in lines:
        dev = l["detail"]["device"]
        require(dev["platform"] == "gpu" and gpu.startswith(dev["name"]),
                f"phase Z: {l['metric']} names the device {dev}")
    meta = by["serving_bench_meta"][0]["detail"]
    require(meta["errors"] == {}, f"phase Z: errors {meta['errors']}")
    spec = by[f"serve_{LM_SIZE}_spec_mismatch"][0]
    require(spec["value"] == 0 and spec["detail"]["tau"] == SERVE_TAU,
            f"phase Z: spec mismatch {spec['value']} at tau "
            f"{spec['detail']['tau']} (raw {spec['detail']['mismatch_raw']})")
    fracs = {l["detail"]["mesh_size"]: l
             for l in by[f"serve_{LM_SIZE}_sharded_params_frac_per_device"]}
    require(sorted(fracs) == [MR_RANKS, 4]
            and fracs[MR_RANKS]["value"] == 1 / MR_RANKS
            and fracs[4]["value"] == 0.25,
            f"phase Z: residency {[(d, l['value']) for d, l in fracs.items()]}")
    rc, out, err = run_tool("bench_ratchet", "--records_dir",
                            str(record.parent), "--json")
    verdict = json.loads(out) if out.strip() else {}
    require(rc == 0 and verdict.get("records") == len(lines) - 1
            and verdict.get("unexplained") == 0,
            f"phase Z: bench_ratchet exit code {rc}: {out[-2000:]}"
            f"{err[-2000:]}")
    sup = by[f"serve_{LM_SIZE}_supervised_tokens_per_sec"][0]["detail"]
    sharded = by[f"serve_{LM_SIZE}_sharded_tokens_per_sec"][0]["detail"]
    launches = {"serving_bench": [meta["launches"]],
                "serving_bench_supervised": [sup["launches"]],
                f"{LM_SIZE}_sharded_serving_bench_gloo{MR_RANKS}":
                    sharded["launches_by_rank"],
                "lm_base_residency_bench_gloo4":
                    fracs[4]["detail"]["launches_by_rank"]}
    for path, per_rank in launches.items():
        require(len(per_rank) >= 1 and all(
            set(c) == set(SOURCES) and not any(c.values())
            for c in per_rank), f"phase Z: {path} launched {per_rank}")
    head = by[f"serve_{LM_SIZE}_tokens_per_sec"][0]
    slo = by[f"serve_{LM_SIZE}_throughput_vs_slo"][0]
    value = {m: by[m][0]["value"] for m in BENCH_METRICS[:-2]}
    result = {
        "knee_tokens_per_sec": slo["value"],
        "knee_slo_ms": slo["detail"]["best_point_slo_ms"],
        "tokens_per_sec": head["value"], "p50_ms": head["detail"]["p50_ms"],
        "p99_ms": head["detail"]["p99_ms"],
        "saturation": [(p["clients"], p["goodput_tokens_per_sec"],
                        p["p99_ms"])
                       for p in slo["detail"]["saturation_sweep"]],
        "slo": [(p["slo_ms"], p["goodput_tokens_per_sec"],
                 p["rejected_slo"]) for p in slo["detail"]["slo_sweep"]],
        "values": value, "spec_mismatch_raw": spec["detail"]["mismatch_raw"],
        "ratchet_findings": len(verdict["findings"]), "argv": BENCH_ARGV,
        "wall_s": round(wall, 1), "launches": launches, "gpu": gpu}
    print(json.dumps({"serving_bench": result}), flush=True)
    print(f"serving bench: knee {slo['value']} tokens/s in-SLO, headline "
          f"{head['value']} tokens/s, p50 {head['detail']['p50_ms']} ms, "
          f"p99 {head['detail']['p99_ms']} ms ({LM_SIZE}, {SERVE_SLOTS} "
          f"slots), {wall:.1f} s on {gpu}", flush=True)
    return launches


# --- phase HB: the harnesses, under supervise --capture ----------------------

#: ``tools.bench``'s metric lines in emission order (the headline last) and
#: the kernels each line's builds request (its ``kernel_steps``).
HB_LINES = {
    "cifar_resnet20_steps_per_sec_per_chip": (),
    "mnist_cnn_async_steps_per_sec_per_chip": (),
    "mnist_softmax_steps_per_sec_per_chip": (),
    "mnist_cnn_sync_pallas_ce_steps_per_sec_per_chip": ("ce_fwd", "ce_bwd"),
    "mnist_cnn_sync_fused_sgd_steps_per_sec_per_chip": ("sgd",),
    "mnist_cnn_sync_steps_per_sec_per_chip": ("dequant",),
}
HB_SCALING_ARGV = ["--device", "cuda", "--max_devices", str(MR_RANKS),
                   "--batch_per_chip", str(BATCH), "--unroll", "8",
                   "--steps", "16"]
CAPTURE_ROOT = ROOT / "build" / "chip_smoke_capture"
#: ``supervise --capture``'s queue, by priority.
CAPTURE_TASKS = ("headline_bench", "profile", "collectives", "lm",
                 "full_bench", "cli_trainer")
PROFILE_LINES = ("resnet20_profile_augment", "resnet20_traced_window",
                 "resnet20_profile_no_augment", "resnet20_roofline",
                 "resnet20_attribution")
#: ``bench_lm --tiny``'s lines: lm_tiny throughput, then the lm_base matrix
#: over two gloo ranks (every derived line a 2-rank group allows).
LM_LINES = ("lm_tiny_tokens_per_sec_per_chip", "lm_tiny_mfu",
            *(f"{LM_SIZE}_{m}" for m in (
                "remat_activation_savings_frac",
                "shard_update_optstate_shrink_x", "zero1_optstate_shrink_x",
                "zero3_state_residency_shrink_x", "zero3_overlap_speedup_x",
                "knob_ab_matrix")), "lm_bench_meta")
AB_VARIANTS = ("off", "auto", "u8_mul", "u8_onehot", "u8_lut", "u8_kernel")


def json_lines(text: str) -> list:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def zero_launches(counts: dict, what: str) -> None:
    require(not any(counts.values()), f"phase HB: {what} launched {counts}")


def check_bench_record(text: str, gpu: str) -> tuple:
    """``tools.bench --tiny``'s record (the capture's ``full_bench``):
    every line in order, each line's launches = its steps with each
    kernel, ``vs_roofline``, ResNet-20's MFU.  Returns (launches by path,
    rates, the headline's detail, the MFU)."""
    lines = json_lines(text)
    require(lines and lines[0]["detail"].get("provisional") is True,
            f"phase HB: first line {lines[:1]}")
    lines = lines[1:]
    require([l["metric"] for l in lines] == list(HB_LINES),
            f"phase HB: lines {[l['metric'] for l in lines]}")
    launches, rates = {}, {}
    for l in lines:
        d, metric = l["detail"], l["metric"]
        dev = d["device"]
        require(l["unit"] == "steps/sec/chip" and l["value"] > 0
                and dev["platform"] == "gpu" and gpu.startswith(dev["name"]),
                f"phase HB: {metric}: {l['value']} {l['unit']} on {dev}")
        want = HB_LINES[metric]
        require(d["launches"] == d["kernel_steps"] and all(
            (d["launches"][k] > 0) == (k in want) for k in SOURCES),
            f"phase HB: {metric} launched {d['launches']}, its steps with "
            f"each kernel {d['kernel_steps']}")
        if "roofline_probe" in d or metric.startswith(("cifar", "mnist_soft")):
            require(d.get("vs_roofline", 0) > 0,
                    f"phase HB: {metric} vs_roofline {d.get('vs_roofline')}")
        name = metric.replace("_steps_per_sec_per_chip", "")
        launches[f"bench:{name}"] = [d["launches"]]
        rates[name] = l["value"]
    head = lines[-1]["detail"]
    require(head.get("vs_roofline", 0) > 0 and "pallas" in head["dequant_ab"]
            and "errors" not in head,
            f"phase HB: headline {head.get('vs_roofline')} "
            f"{head.get('dequant_ab')} {head.get('errors')}")
    mfu = lines[0]["detail"]["mfu"]
    require(mfu is not None and 0 < mfu <= 1, f"phase HB: ResNet-20 mfu {mfu}")
    return launches, rates, head, mfu


def check_lm_record(path: Path, gpu: str) -> tuple:
    """The capture's ``lm`` record: both LM lines, the derived lines of a
    2-rank matrix, the matrix; no kernel launched anywhere."""
    recs = json_lines(path.read_text())
    require([r["metric"] for r in recs] == list(LM_LINES),
            f"phase HB: lm record {[r['metric'] for r in recs]}")
    by = {r["metric"]: r for r in recs}
    for r in recs[:-1]:
        require(r["value"] > 0
                and gpu.startswith(r["detail"]["device"]["name"]),
                f"phase HB: {r['metric']} = {r['value']}")
    tput, mfu = by["lm_tiny_tokens_per_sec_per_chip"], by["lm_tiny_mfu"]
    zero_launches(tput["detail"]["launches"], "bench_lm's throughput")
    launches = {"lm:lm_tiny_throughput": [tput["detail"]["launches"]]}
    d = by[f"{LM_SIZE}_knob_ab_matrix"]["detail"]
    require(d["devices"] == MR_RANKS and d["backend"] == "gloo"
            and d["host_staged"] is True and d["num_chips"] == 1
            and "errors" not in d and len(d["matrix"]) == 7,
            f"phase HB: lm matrix {d['devices']} {d['backend']} "
            f"{d.get('errors')} {sorted(d['matrix'])}")
    matrix = d["matrix"]
    for knob, e in matrix.items():
        for c in e["launches"]:
            zero_launches(c, f"bench_lm's {knob}")
        launches[f"lm:{LM_SIZE}_{knob}"] = e["launches"]
        require(e["memory"]["activation_bytes"] > 0
                and e["memory"]["peak_bytes"] > 0,
                f"phase HB: lm {knob} memory {e['memory']}")
    base = matrix["base"]
    require(base["opt_state_bytes_per_device"] == 4 * LM_PARAMS
            and base["collectives"]["multiset"] == {"all-reduce": 1},
            f"phase HB: lm base {base['opt_state_bytes_per_device']} "
            f"{base['collectives']}")
    for m in ("zero1_optstate_shrink_x", "zero3_state_residency_shrink_x"):
        v = by[f"{LM_SIZE}_{m}"]["value"]
        require(1.99 <= v <= 2.0, f"phase HB: {m} {v}")
    saving = by[f"{LM_SIZE}_remat_activation_savings_frac"]["value"]
    require(0 < saving < 1, f"phase HB: remat saving {saving}")
    return {"tokens_per_sec": tput["value"], "mfu": mfu["value"],
            "remat_saving": saving,
            "zero3_overlap_speedup_x":
                by[f"{LM_SIZE}_zero3_overlap_speedup_x"]["value"],
            "steps_per_sec": {k: e.get("steps_per_sec")
                              for k, e in matrix.items()},
            "peak_bytes": {k: e["memory"]["peak_bytes"]
                           for k, e in matrix.items()}}, launches


def check_profile_record(path: Path, tgz: Path) -> tuple:
    """The capture's ``profile`` record: the five lines, a trace on disk
    (and its tarball), the shares."""
    recs = json_lines(path.read_text())
    require([r["metric"] for r in recs] == list(PROFILE_LINES),
            f"phase HB: profile lines {[r['metric'] for r in recs]}")
    by = {r["metric"]: r for r in recs}
    window = by["resnet20_traced_window"]["detail"]
    attr = by["resnet20_attribution"]
    require(window["trace_files"] >= 1 and window["trace_bytes"] > 0
            and window["device_us_per_step_by_kind"] and tgz.is_file()
            and attr["value"] > 0 and "errors" not in attr["detail"]
            and {"augment_share", "input_dispatch_share"}
            <= set(attr["detail"]),
            f"phase HB: profile {window} {attr} {tgz.is_file()}")
    launches = {}
    for tag in ("augment", "no_augment"):
        d = by[f"resnet20_profile_{tag}"]["detail"]
        zero_launches(d["launches"], f"bench_profile's {tag}")
        launches[f"profile:{tag}"] = [d["launches"]]
    return {"rates": {r["metric"]: r["value"] for r in recs},
            "shares": {k: attr["detail"][k] for k in
                       ("augment_share", "input_dispatch_share")},
            "device_us_by_kind": window["device_us_per_step_by_kind"]}, \
        launches


def check_capture(gpu: str) -> tuple:
    """``supervise --capture --tiny`` ran to its end with every task ok;
    each artifact checked."""
    rows = journal_rows(CAPTURE_ROOT / "supervise_capture.jsonl")
    done = [r["task"] for r in rows if r["event"] == "task_done"]
    end = rows[-1] if rows else {}
    require(done == list(CAPTURE_TASKS) and end.get("event") == "capture_end"
            and end["results"] == dict.fromkeys(CAPTURE_TASKS, "done"),
            f"phase HB: capture journal {done} {end}")
    launches, rates, head, mfu = check_bench_record(
        (CAPTURE_ROOT / "BENCH_capture.json").read_text(), gpu)
    headline = json_lines(
        (CAPTURE_ROOT / "BENCH_headline_capture.json").read_text())[-1]
    d = headline["detail"]
    require(headline["metric"] == "mnist_cnn_sync_steps_per_sec_per_chip"
            and headline["value"] > 0 and d.get("headline_only") is True
            and d["launches"] == d["kernel_steps"],
            f"phase HB: headline_bench {headline}")
    launches["capture:headline_bench"] = [d["launches"]]
    lm, lm_launches = check_lm_record(
        CAPTURE_ROOT / "BENCH_lm_capture.json", gpu)
    profile, profile_launches = check_profile_record(
        CAPTURE_ROOT / "PROFILE_capture.json",
        CAPTURE_ROOT / "resnet_trace_capture.tgz")
    from distributedtensorflowexample_tpu_torch.resilience.scheduler import (
        load_collective_fit)
    fit = load_collective_fit(
        str(CAPTURE_ROOT / "BENCH_collectives_capture.json"), 2)
    require(fit is not None and fit["fit_devices"] == 2,
            f"phase HB: the capture's collective fit {fit}")
    cli = (CAPTURE_ROOT / "CLI_capture.log").read_text()
    require("final accuracy:" in cli, f"phase HB: cli_trainer {cli[-500:]}")
    launches.update(lm_launches)
    launches.update(profile_launches)
    return {"steps_per_sec_per_chip": rates,
            "headline_only": headline["value"],
            "headline_dequant": head["dequant"],
            "headline_vs_roofline": head["vs_roofline"],
            "headline_dequant_ab": head["dequant_ab"], "resnet20_mfu": mfu,
            "lm": lm, "profile": profile, "psum_fit": fit}, launches


def check_ab_quantize(gpu: str) -> tuple:
    """``ab_quantize --tiny``: every variant positive, bitwise off's
    batch, and the dequant kernel launched once a step on ``u8_kernel``
    only."""
    rc, out, err = run_tool("ab_quantize", "--device", "cuda", "--tiny",
                            timeout=300)
    require(rc == 0, f"phase HB: ab_quantize exit code {rc}:\n{err[-4000:]}")
    lines = json_lines(out)
    require([l["metric"] for l in lines] == [
        f"headline_{v}_steps_per_sec_per_chip" for v in AB_VARIANTS],
        f"phase HB: ab_quantize lines {[l['metric'] for l in lines]}")
    launches, rates = {}, {}
    for v, l in zip(AB_VARIANTS, lines):
        d = l["detail"]
        require(l["value"] > 0 and d["bitwise_vs_off"] is True
                and d["launches"] == d["kernel_steps"]
                and (d["launches"]["dequant"] > 0) == (v == "u8_kernel")
                and not any(d["launches"][k] for k in SOURCES
                            if k != "dequant")
                and gpu.startswith(d["device"]["name"]),
                f"phase HB: ab_quantize {v}: {l}")
        launches[f"ab_quantize:{v}"] = [d["launches"]]
        rates[v] = l["value"]
    return rates, launches


def check_scaling() -> tuple:
    """``bench_scaling`` at 1 and 2 gloo ranks on the card."""
    rc, out, err = run_tool("bench_scaling", *HB_SCALING_ARGV, timeout=300)
    require(rc == 0, f"phase HB: tools.bench_scaling exit code {rc}:\n"
                     f"{err[-4000:]}")
    lines = json_lines(out)
    *per_count, summary = lines
    require([l["devices"] for l in per_count] == [1, MR_RANKS]
            and summary["metric"] == "sync_sgd_weak_scaling"
            and summary["unit"] == f"efficiency_1_to_{MR_RANKS}"
            and summary["value"] > 0,
            f"phase HB: scaling lines {lines}")
    d, two = summary["detail"], per_count[-1]
    require(d["backend"] == "gloo" and d["host_staged"] is True
            and d["num_chips"] == 1 and two["backend"] == "gloo",
            f"phase HB: scaling ran over {d['backend']}, host_staged "
            f"{d['host_staged']}, {d['num_chips']} card(s)")
    require(two["collectives_per_step"] == {
        "all-reduce": {"count": 1, "bytes": 4 * CNN_PARAMS}},
        f"phase HB: collectives a step {two['collectives_per_step']}")
    launches = {}
    for l in per_count:
        require(all(not any(c.values()) for c in l["launches"]),
                f"phase HB: scaling launched {l['launches']}")
        launches[f"bench:sync_scaling_{l['devices']}"] = l["launches"]
    return {"efficiency": d["efficiency"], "value": summary["value"],
            "steps_per_sec": [l["steps_per_sec"] for l in per_count]}, \
        launches


def side_tools(gpu: str) -> tuple:
    """HB's tools outside the capture, one after the other:
    ``ab_quantize --tiny``, then ``bench_scaling``."""
    t0 = time.perf_counter()
    ab, launches = check_ab_quantize(gpu)
    t1 = time.perf_counter()
    scaling, scaling_launches = check_scaling()
    launches.update(scaling_launches)
    return ab, scaling, launches, {
        "ab_quantize_s": round(t1 - t0, 1),
        "scaling_s": round(time.perf_counter() - t1, 1)}


def run_bench_phase(gpu: str) -> dict:
    """Phase HB: ``supervise --capture --tiny`` over the harnesses (the
    headline, the ResNet-20 profile, the collectives, the LM bench, the
    full bench, the CLI trainer), with ``ab_quantize --tiny`` and then
    ``bench_scaling`` beside it on the card (their rates are then not a
    quiet card's).  Returns the launches by path: ``bench:<line>``,
    ``capture:headline_bench``, ``lm:<line>``, ``profile:<variant>``,
    ``ab_quantize:<variant>`` (one process each) and
    ``bench:sync_scaling_<N>`` (per rank)."""
    shutil.rmtree(CAPTURE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        side = pool.submit(side_tools, gpu)
        rc, out, err = run_tool("supervise", "--capture", "--tiny",
                                "--records_dir", str(CAPTURE_ROOT),
                                timeout=900)
        capture_s = round(time.perf_counter() - t0, 1)
        ab, scaling, side_launches, side_s = side.result()
    log = CAPTURE_ROOT / "capture.log"
    tail = lambda: log.read_text()[-6000:] if log.is_file() else ""
    require(rc == 0, f"phase HB: supervise --capture exit code {rc}:\n"
                     f"{err[-4000:]}\n--- capture.log ---\n{tail()}")
    try:
        result, launches = check_capture(gpu)
    except (RuntimeError, OSError, KeyError, ValueError) as e:
        raise RuntimeError(f"{e}\n--- capture.log ---\n{tail()}") from e
    launches.update(side_launches)
    result.update(ab_quantize=ab, scaling=scaling, capture_s=capture_s,
                  **side_s, wall_s=round(time.perf_counter() - t0, 1),
                  launches=launches, gpu=gpu)
    print(json.dumps({"bench_path": result}), flush=True)
    print(f"bench: headline "
          f"{result['steps_per_sec_per_chip']['mnist_cnn_sync']} "
          f"steps/s/chip (tiny sizes), lm_tiny "
          f"{result['lm']['tokens_per_sec']} tokens/s, ResNet-20 shares "
          f"{result['profile']['shares']}, ab_quantize {ab}, weak scaling "
          f"1 -> {MR_RANKS} gloo ranks {scaling['value']} on {gpu}",
          flush=True)
    return launches


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

    laps, last = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        """Wall seconds since the previous lap, under ``phase``."""
        now = time.perf_counter()
        laps[phase] = round(now - last[0], 1)
        last[0] = now

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
    lap("1-2")
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

    lap("3")
    for model in ("mnist_cnn", "lm_small", "resnet20"):
        print(json.dumps({"card_vs_cpu_5_steps":
                          check_card_against_cpu(model)}), flush=True)
    lap("4")

    result, counts = run_main_path(gpu)
    print(json.dumps({"main_path": result}), flush=True)
    print(f"main path: {result['steps_per_sec']:.1f} steps/s (last "
          f"100-step window, B={BATCH}) on {gpu}", flush=True)
    lap("5")
    lm, lm_counts = run_lm_main_path(gpu)
    print(json.dumps({"lm_main_path": lm}), flush=True)
    print(f"lm main path: {lm['steps_per_sec']:.2f} steps/s (last 100-step "
          f"window, {LM_SIZE}, B={LM_BATCH} x T=128) on {gpu}", flush=True)

    lap("6")
    cifar, cifar_counts = run_cifar_main_path(gpu)
    print(json.dumps({"cifar_main_path": cifar}), flush=True)
    print(f"cifar main path: {cifar['steps_per_sec']:.1f} steps/s (last "
          f"100-step window, resnet20, B={CIFAR_BATCH}) on {gpu}",
          flush=True)

    lap("E")
    async_one = run_async_main_path()
    lap("K one worker")

    by_path = run_gloo_phases(gpu)
    report_async_path(async_one, by_path.pop("async_gloo2"), gpu)
    lap("A B D F K")
    softmax_counts = run_local_mnist(gpu)
    lap("G")
    by_path.update(run_resume_phase(gpu))
    lap("I")
    by_path.update(run_supervision_phase(gpu))
    lap("U")
    by_path.update(run_side_and_scheduling_phases(gpu))
    lap("C H J V")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        nxm = pool.submit(run_nxm_phase, gpu)
        measure = pool.submit(run_measure_phase, gpu)
        run_control_plane_phase(gpu)
        nxm_text, nxm_launches = nxm.result()
        measure_text, measure_launches = measure.result()
    print(nxm_text + measure_text, end="", flush=True)
    by_path.update(nxm_launches)
    by_path.update(measure_launches)
    lap("W X Y")
    by_path.update(run_host_fed_phase(gpu))
    lap("Q")
    by_path.update(run_remat_phase(gpu))
    lap("R")
    by_path.update(run_telemetry_phase(gpu))
    lap("T")
    by_path.update(run_mode_phases(gpu, ("L", "M", "N", "I'", "SH")))
    lap("L M N I' SH")
    shard_ranks, four = run_shard_phase()
    lap("O")
    serving_counts = run_serving_phase(gpu)
    lap("S")
    by_path.update(run_sharded_phase(gpu, shard_ranks, four))
    lap("P")
    by_path.update(run_serving_bench_phase(gpu))
    lap("Z")
    by_path.update(run_bench_phase(gpu))
    lap("HB")
    print(json.dumps({"phase_wall_s": laps,
                      "script_wall_s": round(sum(laps.values()), 1),
                      "gpu": gpu}), flush=True)

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
