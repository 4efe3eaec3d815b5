#!/usr/bin/env python3
"""Chip smoke for autodist_tpu_torch: the port's main paths on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
nvcc and PyTorch for CUDA. Phases, each fatal on failure (exit code 1, no
result line):

1. build every CUDA kernel of the paths from ``autodist_tpu_torch/csrc``
   (one nvcc per source, started together), print each kernel's
   registers, shared memory and spills, and print the card;
2. hold each kernel, in each design (variant) its dispatch rule picks —
   ``mma.sync bf16`` on the tensor cores for bf16, ``scalar f32`` for
   f32 — against its plain PyTorch version at the shapes the main paths
   give it: the forward at the decode shape (f32 at 2e-5, the JAX package's
   flash-decode bound; bf16 at 2e-2 atol/rtol: bf16 inputs, f32
   accumulation in another order), then (2b) at the lm1b training shape
   [64, 128, 16, 64] and a smaller shape with segments and an empty query
   row (out and lse, the same bounds), and the two backward kernels at
   those two shapes (f32 2e-5, bf16 2e-2, each as an error relative to the
   plain version's largest magnitude); then all three at the bert_base
   shape [128, 128, 12, 64], non-causal, with key-padding segment ids of
   lengths 64-128 drawn from a seed (one row of 64, so whole 64-row tiles
   are skipped), bf16 at batch 128 and f32 at batch 16, the same bounds;
2c. (run after phase 4, so that phase 3's timed serving, which is bound
   by host dispatch, runs first in the process) time each kernel at the
   decode, lm1b training and bert_base shapes (bert with the all-ones
   mask the bench batch has), in device time (calls queued back to back
   behind a sleep kernel, CUDA events) and as a call with host dispatch,
   beside its plain version, one PyTorch library call computing the same
   function (SDPA, with the segments as a boolean mask where there are
   any) and its bound; and ``flash_bwd_delta`` (four PyTorch ops, which
   the backward runs before its two kernels) beside its byte bound;
3. serve lm1b at full width in bf16 through the entry points a user calls
   (``AutoDist(...).build`` -> ``Runner.init`` -> ``DecodeEngine`` with
   ``decode_attn="flash"``): 64 prompts of mixed lengths through 32 slots;
   every future resolves, no errors, and the kernel ran exactly 8 times a
   decode step, all in its bf16 design;
4. the same model in f32: flash decode and reference decode give the same
   tokens, and both equal greedy full recompute;
5. train lm1b at full width in bf16 (seq 128, batch 64, lean head, flash
   attention) through ``AutoDist(...).build`` -> ``Runner.init`` ->
   ``Runner.run``: 2 warm-up and 10 timed Adam steps on one random batch;
   every loss finite, the last below the first, each of the three kernels
   launched 8 times a step, all on the tensor-core design, the f32 master
   params moved; then a device profile of 3 more steps;
6. the same model in f32 at batch 8: 3 Adam steps with flash attention and
   3 with the reference attention from the same init agree in loss and
   params;
7. train bert_base at full width in bf16 (seq 128, batch 128, the bench
   batch with its all-ones mask) the same way with ``attention="flash"``:
   each kernel launched 12 times a step, all on the tensor-core design,
   with a device profile of 3 steps; then the same with
   ``attention="xla"`` (the plain attention) in the same process, from
   the same seed-0 init on the same batch. The fixed-batch run spikes
   near step 10 and oscillates, so its gate is: every loss finite, each
   run's loss after 3 steps below its first, and the flash run's first 3
   losses within 2e-2 relative (the bf16 bound) of the xla run's;
8. train resnet50 at full width (bf16 convs, f32 params and BatchNorm,
   image 224, batch 256) the same way: every BatchNorm ``mean``/``var``
   bit-equal before and after the steps, a device profile of 3 steps;
9. bert_base at full width in f32, batch 8, with ragged key padding and
   ``mlm_weights`` on real tokens only: 3 Adam steps with flash attention
   and 3 with the plain attention from the same init agree in loss and
   params at phase 6's bounds;
10. data parallelism, N = 2: two ranks spawned on ``cuda:0`` in a gloo
   group created from a ``FileStore`` (NCCL refuses two ranks on one
   card; a resource spec listing GPU 0 twice says the two replicas share
   it), each through ``AutoDist(...).build`` -> ``Runner.init`` ->
   ``Runner.run`` with the global batch: (a) bert_base bf16 at full width
   (seq 128, global batch 128, 64 a rank, flash, ``AllReduce()`` at chunk
   128), 5 steps with the fp32 wire in deterministic mode (phase 19
   (a)'s uninterrupted reference), then 3 with ``wire_dtype="int8"``
   (two Int8CompressorEF buckets) from a fresh init: every loss finite
   and the same on both ranks, both ranks' params ``torch.equal`` after
   the steps, each kernel launched 12 times a step a rank on its
   tensor-core design, the embedding tables outside the int8 buckets;
   step p50 and the payload bytes a step handed to the collectives;
   (b) the int8 two-phase all-reduce on CUDA over one bucket-sized vector
   with a NaN block, bit-equal to the numpy mirror of the codec, and the
   torch codec bit-equal to ``quant_wire_np``; (c) lm1b in f32 at global
   batch 8 with flash attention: the 2 ranks' 3 Adam steps against this
   process's 1 rank on the whole batch, at phase 6's bounds. A failure in
   either rank fails the run;
11. checkpoints on the card: bert_base bf16 at full width (seq 128,
   batch 128, flash) trains 4 random batches through ``Runner.fit(
   save_every=2)`` with the default async ``Saver`` on a temporary
   ``ADT_CKPT_DIR`` (run A); a new runner resumes by ``ADT_AUTO_RESUME``
   in ``Runner.init`` (the newest, step 4) and then by
   ``restore(ckpt-2)``, each ``torch.equal`` to run A's state at that
   step (params, Adam moments, count, step), and its steps 3-4 give run
   A's losses and state bit for bit (run B). Both runs are in PyTorch's
   deterministic mode: ``F.embedding``'s CUDA backward sums a repeated
   index's rows in a varying order, which the phase shows by taking one
   step's gradients twice in each mode. Each kernel 12 launches a
   step on its tensor-core design; ``python -m
   autodist_tpu_torch.checkpoint fsck`` exits 0 on the directory; the
   files' bytes, the save's time in ``save()`` and in the background
   writer, and the share of the write hidden behind the steps;
12. the cnn family at full width: VGG16 (image 224), InceptionV3 (299)
   and DenseNet121 (224), bf16 convs, f32 params and BatchNorm, batch 64,
   2 warm-up and 5 timed Adam steps each: every loss finite, every
   BatchNorm ``mean``/``var`` bit-equal before and after, every other
   variable moved; step p50 (min-max), images/s, MFU, peak memory and a
   device profile of 3 steps by kind;
13. the user API, fused supersteps and the input plane, at full width:
   (a) lm1b bf16 (seq 128, batch 64, flash, lean head) trained on the
   repository's own docs (``README.md`` + ``docs/``) written into an ADT1
   record file, read by the native loader (``RecordFileDataset``, built
   from the checkout's C++ source), stacked and copied to the card by
   ``DevicePrefetcher(stack=4)`` (pinned buffers, side stream), and run
   by ``fit(fuse_steps=4, metrics_every=2)`` for 16 microsteps: 4
   dispatches (replays of one captured CUDA graph) against 16, 2
   readbacks against 16, ``step_stats`` supersteps 4 and microsteps 16,
   each kernel 8 launches a microstep on its tensor-core design (the
   replays' and the capture's one warm-up microstep), and 8 a microstep
   counted by name in a device trace of one more replay, finite and
   falling losses; the same 16 batches per step from the same init agree in
   losses and params, bit for bit or at phase 6's bounds (printed which);
   (b) bert_base bf16 (phase 7's batch size) through ``ad.function`` (3
   steps) and ``create_distributed_session().run`` (3 more), bit-equal to
   ``build`` + ``Runner.run`` from the same init in deterministic mode;
   (c) a hand-written ``build_step`` step on lm1b (its own Adam) through
   ``fit(fuse_steps=4)``, against its own per-step loop; (d) InceptionV3
   (299) and DenseNet121 (224) at batch 64, fused k = 4 against the
   per-step loop on a batch on the card: ms a microstep p50 (min-max), the
   idle share of one superstep (or step) in a device trace, peak memory,
   BatchNorm statistics bit-equal, losses within 2e-2; (e) resnet50 at
   batch 256 fed through ``DevicePrefetcher`` against the pageable feed,
   6 steps of ``fit(metrics_every=6)`` each: the host-to-device copies'
   share of device time, their streams, and
   the share of their time that overlaps kernels on another stream
   (fatal unless the prefetcher's copies run off the kernels' stream and
   overlap them);
14. the sync variants, the bf16 compute tier and remat: (a)-(c) two ranks
   on ``cuda:0`` over gloo (as phase 10), bert_base bf16 at full width
   (seq 128, global batch 128, flash), 2 steps of each plan from one init
   on the same 2 batches, in deterministic mode: ``AllReduce()``,
   ``ZeroSharded()`` (losses within 1e-4 and params within 1e-5 relative
   of AllReduce's, ``tests/test_zero_sharded.py``'s bounds; each rank's
   Adam moments of the sharded variables half of AllReduce's plus
   padding, printed beside the whole moments of the lookup tables;
   ``zero.rs_bytes``/``zero.ag_bytes`` a step equal to the JAX package's
   formula), ``ZeroSharded(wire_dtype="int8")`` (losses within 2e-4
   relative of AllReduce's; its update to the ZeRO variables within 0.2
   of AllReduce's in norm, :func:`update_error`), ``PartitionedAR()``
   (the same bounds; a rank stores half of each partitioned variable and
   of its moments; ``gather_params`` in the original layout) and
   ``AllReduce(overlap=True)`` (bit-equal to the epilogue, at least 2
   stages, the launch order printed); both ranks' params ``torch.equal``
   and each kernel 12 launches a step a rank in every run; (d) lm1b at
   full width in its f32 config (seq 128, batch 64) under
   ``AllReduce(compute_dtype="bf16")`` against ``AllReduce()``, 2 + 4
   steps each from one init: final losses within 5% (``bench.py``'s
   ``ADT_BENCH_BF16_TOL``), step p50 (min-max) of both; the tier rounds
   the params to bf16 while the f32 config computes in f32 (flax's
   ``Dense(dtype=float32)`` does the same in the JAX package), so each
   kernel launches 8 times a step on its ``scalar f32`` design; (e)
   bert_base bf16 at phase 7's shape under ``WithRemat(AllReduce(),
   "full")`` and ``"dots"`` against plain, 3 steps each, deterministic
   mode, 2 steps each: losses and params bit-equal, peak memory below
   plain's (all three printed), and under "full" the forward kernel
   launches 24 times a step (the recomputed forward runs it again), dQ
   and dK/dV 12;
15. the parameter-server family and the sparse (ids, values) wire, with
   the PS spans recorded (tracing on): (a) DLRM at its default config
   (8 tables, 1 622 100 x 64, and the MLPs; batch 256, the hot-id batch)
   under ``Parallax()``, 2 + 5 steps: the 8 tables host-resident (the
   tables and their moments absent from the device state, the store's
   ``resident_bytes`` the values' bytes, as the JAX store counts, and its
   moments, counted from its per-shard states, twice that), finite and
   falling losses, the
   bytes a pull and a push equal to the plan's (every table whole; each
   sparse-wire table's (ids, values) pairs, a dense table's gradient
   whole); step p50 (min-max), examples/s, ``ps.pull``/``ps.push``/
   ``ps.apply`` ms a step, peak HBM and the device's idle share over 3
   more steps; (b) ``Parallax()`` against ``AllReduce()`` from one init, 3
   steps each: losses within 1e-5 relative, params within 2 x steps x lr,
   the share of elements beyond 1e-6 printed; (c) NCF at its default
   config under ``PS()`` and under the default builder
   (``PSLoadBalancing``), the readings of (a); (d) bert_base bf16 (seq
   128, batch 128, flash) under ``Parallax()``, its three tables
   host-resident, 2 + 5 steps: each kernel 12 launches a step on its
   tensor-core design, the loss after 3 steps below the first, the first 3
   losses within 2e-2 of ``AllReduce()``'s from the same init; (e) DLRM's
   PS pipeline in deterministic mode: exact (``ADT_PS_OVERLAP=1``) and
   serial (``0``) ``torch.equal`` after 3 steps, then
   ``Parallax(staleness=1)`` 2 + 5 steps: finite losses, every read
   lagging the applies by at most 1, its readings; (f) N = 2 on
   ``cuda:0`` over gloo (as phase 10), DLRM under ``Parallax()`` and
   ``AllReduce()`` (the tables on the sparse wire), 3 steps each from one
   init in deterministic mode: both ranks' losses and params equal, the
   Parallax ranks' store digests equal, the wire bytes a step a rank
   printed against the tables' dense bytes.
16. host-PS variables inside fused supersteps (the device-resident PS
   carry) and the optax optimizers (tracing on): (a) DLRM at its default
   config under ``Parallax()``, batch 256, 8 batches (the hot-id draw
   from seeds 1-8) per step and then through ``fit(fuse_steps=4,
   metrics_every=2)`` from the same init: losses and gathered params
   agree (bit-equal, or phase 6's bounds: losses 1e-4 relative, params 2
   x steps x lr each and 1e-6 on average); ms a microstep over 3 more
   supersteps, the idle share of one superstep in a device trace, the
   carry's bytes and its load (``dstep.pull_ps``) and write-back
   (``ps.absorb``) ms, peak HBM; the same pair again in deterministic
   mode, whether it is bit-equal printed; (b) NCF at its default config
   under ``PS()``, every variable in the carry, (a)'s readings; (c)
   bert_base bf16 (seq 128, batch 128, flash) under ``Parallax()``,
   ``fit(fuse_steps=4)`` over 8 microsteps on phase 15 (d)'s batch: the
   losses within 2e-2 of phase 15 (d)'s per-step ones, each kernel 12
   launches a microstep on its tensor-core design, counted by name in a
   device trace of one more replay; (d) the optimizers: resnet50 bf16
   (batch 256) under ``optim.chain(optim.clip_by_global_norm(1.0),
   SGD(lr=0.1, momentum=0.9))`` (the imagenet example's optimizer), fused
   k = 4 against per step over 8 microsteps in deterministic mode
   (agreement as in (a), whether bit-equal printed), and bert_base bf16
   under ``AdamW(lr=1e-4, weight_decay=1e-4)`` (the bert example's),
   3 steps: finite losses, the loss after 3 steps below the first, 12
   launches a step; for both, the first update on the card against the
   port's own update run on the CPU from the same gradients, state and
   params, each element within 1e-5 of the update's largest magnitude
   plus one float32 ulp of the param.
17. the coordination service (built from the port's copy of its source,
   started on a free port, stopped at the end of the phase), async host
   PS served over it and bounded staleness across ranks (tracing on): (a)
   bert_base bf16 (seq 128, batch 128, flash) under ``PS(sync=False)``,
   one process, every variable on the host PS: 3 steps drained
   (``flush_ps(); store.drain()`` after each, the serial path,
   deterministic mode) bit-equal in losses to ``PS()`` from the same
   init, then 1 + 7 steps undrained on the pipeline: ms a step, blobs
   applied, the reads' lag behind the pushes (bound ``ADT_PS_MAX_LAG`` +
   2) and the owner queue's length (bound ``ADT_PS_MAX_LAG``), the owner
   loop's apply and publish ms and bytes; each kernel 12 launches a step
   on its tensor-core design; (b), run beside phases 16 and 17 (a), DLRM
   at its default config under
   ``PSLoadBalancing(sync=False)``, two processes on ``cuda:0`` (owner
   hosts 127.0.0.1 and localhost; a gloo group that no step may use),
   Adam at 1e-4, 1 + 2 steps each at least, then on until its loss
   falls (at most 12): ms a step a process, BPUT bytes a publish, BGET bytes
   a pull, QPUSH bytes a push, each owner's applies, no collective and
   ``sync.wire_bytes`` 0, each process's loss falling; (c) DLRM under
   ``Parallax(staleness=2)`` at N = 2 over gloo, paced by the service,
   1 + 3 steps: the ``runner.barrier`` span's ms a step, the largest
   step gap on the service (bound 2), both ranks' losses and store
   digests equal.
18. launch and handoff: a user script in a temporary directory, its chief
   run as a subprocess on free ports (whatever is left of a job is killed
   at its end) on a two-node spec (127.0.0.1 the chief, localhost; ``gpus:
   [0]`` each); bert_base launched by the chief, the file handoff, is
   phase 19 (a) (which was (a) here); (b) NCF at its default config under
   ``PartitionedPS()``, two processes started by the phase with
   ``ADT_EXTERNAL_LAUNCH`` (beside (d), in a directory of its own), 3
   steps:
   the worker's strategy byte-equal to the chief's file and no file read
   on the worker, equal losses, ``broadcast_bytes`` ms; (d) NCF under
   ``PSLoadBalancing(sync=False)`` launched by the chief (the service
   started by ``Cluster.start`` only), Adam 1e-4, 1 + 3 steps at least,
   then on until its loss falls (at most 12): both hosts
   publish, each process's loss falls, ms a step a process (the fail-fast
   job that was (c) is phase 19 (c)).
19. supervised recovery, phase 18's way (a user script in a temporary
   directory, its chief a subprocess on free ports, each process writing
   its events to a file as it goes, whatever is left killed at the end):
   (a) bert_base bf16 (seq 128, global batch 128, flash) under
   ``AllReduce()`` on phase 18's two-node spec, one command on the chief
   with ``ADT_ELASTIC=1 ADT_ELASTIC_SYNC=1``, a temporary
   ``ADT_CKPT_DIR``, deterministic mode, seed 0: the chief launches the
   worker, both join one group on ``cuda:0`` (the backend rule must pick
   gloo: one card), the worker loads the chief's strategy file; 5 steps
   with a save after step 2, after which the worker's first incarnation
   exits 3: the chief re-execs once, launches the worker again, both
   ranks restore step 3 and run steps 3-4, every loss bit-equal on both
   ranks and to phase 10 (a)'s uninterrupted fp32-wire run (steps 0-2
   hold the launch plane to it, 3-4 the restore), each kernel 12 launches
   a step a rank on its tensor-core design in both incarnations;
   AutoDist() on the chief (launch + join) ms, the worker's strategy
   wait, the first incarnation's steps, the save's ms, the worker's death
   to the chief's ``execv``, the ``execv`` to the resumed job's first
   step, the restore's ms, the whole recovery and the resumed steps' ms;
   (b), run beside (a) and phases 18 and 22, NCF at its default config
   under ``PS(sync=False)`` launched by the chief with
   ``ADT_HEARTBEAT_TIMEOUT_S=15``: the worker's first incarnation stops
   heartbeating at step 2 and sleeps; the watchdog kills it once, the
   process watcher relaunches it once, the relaunched incarnation's first
   dispatch lasts 24 s more (past the bring-up grace) and the watchdog
   reads its compile-grace mark instead of killing it; the chief steps
   until that incarnation is done; both processes' losses fall (the
   relaunched one over 6 steps); the last heartbeat to the kill and the
   kill to the new incarnation's first dispatch and step; (c), run beside
   (a) and (b), a sync-elastic worker exits 3 right after
   AutoDist(), before any checkpoint: the chief exits 1 ("nothing to
   restore", "aborting job") and no process is left.
20. tensor parallelism: tp_lm at ``TPLMConfig.flagship()`` (vocab 32 768,
   d 1 024, 12 layers, 16 heads, mlp 4 096, bf16, 185 722 880 parameters
   from seed 0), seq 1 024, batch 8, the JAX model's loss with the flash
   kernels in its ``attn_fn`` slot, Adam 1e-3. First the three kernels at
   its causal shapes [8, 1024, 16, 64] and [8, 1024, 8, 64] vs their plain
   versions (bf16 2e-2) and timed beside SDPA and their bounds; the first
   loss through flash vs the plain causal attention (2e-2). (a) one
   process under ``TensorParallel(1, tp_rules())``, 2 + 5 steps: step
   p50, tokens/s, MFU, 12 launches a step of each kernel, then a device
   profile of 3 more steps; (b)
   ``TensorParallel(2, tp_rules())`` on two processes of ``cuda:0`` over
   gloo (as phase 10), 5 steps: each rank stores half of every
   model-parallel variable's bytes, 2 x layers + 5 forward all-reduces a
   step (and their bytes), the flash slot sees [8, 1024, 8, 64] only, the
   ranks' losses equal and the first 3 within 2e-2 of (a)'s, step p50,
   one save (ms, bytes).
21. sharded checkpoints, the health sentinel, the rhd and hierarchical
   all-reduce schedules. (a) tp_lm flagship under ``TensorParallel(2)``
   on two processes of ``cuda:0`` over gloo, deterministic mode: 2 steps,
   ``ShardedSaver.save`` (its ms, each rank's bytes, no all-gather), a
   gathered ``Saver.save`` at the same step (phase 20 (b)'s kind), 2 more
   steps; the sharded restore at tp 2 repeats those 2 steps' losses bit
   for bit, and at tp 1 (one process) the params and both Adam moments
   are bit-equal to the gathered save's. (b) bert_base (bf16, seq 128,
   batch 128, flash, ``AllReduce()``, one process): the sentinel armed
   and unarmed, per step and in fused supersteps of 4, paired in
   alternating order (p50s, the same dispatches, readbacks and launches a
   step); ``ADT_GRAD_FAULT_PLAN`` NaN at step 3: verdicts [1, 1, 1, 0, 1,
   1], one skip, the params unchanged by it; NaN at steps 3-5 with a
   budget of one skip: two rollbacks to the step-2 checkpoint (their ms),
   the second halving the LR, the run on to step 8. (c) bert_base under
   ``AllReduce()`` pinned to ``schedule="rhd"`` at N = 2 (losses within
   2e-2 of phase 10's fp32 wire) and to ``"hier"`` at N = 4 on two
   loopback nodes of two ranks (within 2e-2 of the ring's), deterministic
   mode, the ranks bit-equal, step p50s (gloo's speed).
23. the preemption plane (``runtime/preemption.py``). (a) bert_base bf16
   (seq 128, global batch 128, flash) under ``AllReduce()``, launched by
   the chief on two processes of ``cuda:0`` over gloo (phase 22's job)
   with ``ADT_ELASTIC_INRUN=1``, a flight recorder directory and
   deterministic mode, 6 steps: after step 1 the chief evicts its worker
   with ``faultinject.deliver_preemption`` (a real SIGTERM, a SIGKILL at
   60 s). Both processes commit the rescue checkpoint at the agreed step,
   the chief publishes the survivors' epoch while the worker is alive, the
   worker exits 0 through ``PlannedDeparture`` with ``preempt/left``
   stamped and its SIGTERM dump holding the notice before the ``signal``
   record, and the chief runs on at N = 1 with ``planned`` on its
   reconfigure span, no step re-run, no checkpoint fallback and no
   whole-job restart; the steps at N = 2 bit-equal to phase 10's fp32
   wire, those at N = 1 within 1e-3 of it; 12 launches of each kernel a
   rank-step on ``mma.sync bf16``; the notice to the exit, the rescue
   save's ms, the planned reconfigure beside phase 22's unplanned one,
   the notice to the first step at N = 1 and the steps lost. (b) beside
   (a), one process of bert_base at 2 of its 12 layers: after a measured
   save, a maintenance file whose grace is below that save's p99 x 1.5 —
   the rescue save skipped, no torn checkpoint directory, exit 0 through
   the solo departure. (c) phase 3's lm1b decode engine (bf16, flash, 32
   slots) with 32 sequences in flight and 32 queued when
   ``preemption.drain_serving`` runs: the 32 complete on the card, the 32
   queued shed with the typed Retry-After, and 32 is returned. Phase 21
   runs beside (a) too.
24. pipeline parallelism: pipe_lm (the stacked-blocks tp_lm) at
   ``TPLMConfig.flagship()`` (185 722 880 parameters, bf16, seq 1024,
   global batch 8, Adam 1e-3, the flash kernels through ``attn_fn``).
   (a) the three kernels held to their plain versions and timed at
   (b)'s microbatch shape [2, 1024, 16, 64] causal, then
   ``PipelineParallel(pp_shards=1)``, one process: the parameter
   count, the first loss within 2e-2 of the plain attention's on the
   card, 2 warm-up and 10 timed steps with 12 launches of each kernel a
   step; step p50 (min-max), tokens/s and MFU beside phase 20 (a)'s
   tp_lm. (b) ``PipelineParallel(pp_shards=2, n_microbatches=4)`` on two
   processes of ``cuda:0`` over gloo, beside phases 21 and 23: gpipe,
   1f1b and interleaved (V = 2) in turn in the same two processes, 2
   warm-up and 3 timed steps each: the ranks' losses equal, the first
   within 2e-2 of the same setup's unbound loss on the card (the hint's
   layer order for interleaved), every loss finite, each kernel's
   launches a rank-step as the schedule predicts (at the microbatch
   shape [2, 1024, 16, 64]); step p50, ``pp.p2p_bytes`` a step and each
   rank's peak memory (reset between schedules).
25. sequence and expert parallelism (no flash kernel on these paths: the
   ring and Ulysses attention and the MoE experts are plain PyTorch, as
   the JAX package computes them outside any Pallas kernel; each part
   checks that none of the three kernels launched). (a) moe_lm at
   ``MoEConfig()`` (70 724 608 parameters, 33 603 584 of them
   expert-stacked, f32, seq 256, batch 16, Adam 1e-3) through
   ``ExpertParallel(ep_shards=1, mp_rules=ep_rules())``, one process,
   right after phase 24 (a): the counts, the first loss, 2 warm-up and 8
   timed steps, the loss falling; step p50 (min-max), tokens/s. (b) and
   (c) on two processes of ``cuda:0`` over gloo, beside phases 11-12:
   (b) moe_lm under ``ExpertParallel(ep_shards=2)`` on the same batch:
   the ranks' losses equal, the first the mean of the unbound loss on
   each rank's 8 rows within 2e-5 (each rank's capacity, 512, is the
   unbound one on 8 rows), each rank holding its ``[4, ...]`` expert
   slice; ``ep.a2a_bytes`` a rank-step, step p50, peak memory a rank. (c)
   tp_lm flagship (bf16, seq 1024, batch 8) under
   ``TensorParallel(tp_shards=1, seq_shards=2)``, ``attention="ring"``,
   then ``"ulysses"``: the ranks' losses equal, the first within 2e-2
   of the one-process plain-attention loss over the same S - 1 targets;
   ``sp.p2p_bytes`` (ring) or ``sp.a2a_bytes`` (Ulysses) a rank-step,
   step p50, peak memory a rank.

26. serving at N = 2: two processes of ``cuda:0`` over gloo, one
   controller (rank 0) and one executor, run last. (b) lm1b f32 at 2 of its
   8 layers, flash decode, 8 slots (4 a rank), phase 4's 8 prompts: the
   tokens equal greedy full recompute on the card, token for token, and
   flash_fwd launches 2 a decode step on each rank, all ``scalar f32``. (a)
   lm1b bf16 at full width under ``AllReduce()``, ``DecodeEngine(
   decode_attn="flash")`` with phase 3's ``DecodeConfig`` (32 slots, 16 a
   rank): the chief submits phase 3's 64 prompts; every future resolves
   with no error; both ranks run the same decode steps, each holding 16
   slots, and flash_fwd launches 8 times a decode step on each rank, all
   on ``mma.sync bf16``; each rank holds the kernel to its plain version at
   its shape [16, 1, 256, 16, 64] (bf16 2e-2) and the chief times it;
   tokens/s, token p50/p99 and the share of sequences equal to phase 3's
   are printed. (c) a ``MicroBatcher`` over an ``InferenceEngine`` on (a)'s
   runner (the prefill's next_token, buckets (2, 16, 64), ``max_queue``
   256): 4 closed-loop client threads on the chief send 512 requests; every
   future resolves, every group's rows are bit-equal to the same program
   called directly on the same padded bucket; one burst past
   ``max_queue`` behind a held dispatch sheds typed, each with a
   ``retry_after_s``, and enters brownout; the follower's batcher refuses a
   request; QPS, latency p50/p99 (``serve.latency_ms``) and batch fill. (d)
   a ``FleetAutoscaler`` on the chief, on the port's coordination service,
   over the live batcher's signals, the phantom-peer ramp of ``bench.py``'s
   autoscale leg (roster [me, replica-b], pool [replica-c, replica-d]): at
   least one grow and one planned shrink (an ``autoscale-idle`` notice and
   the survivors' epoch), no ``ckpt.fallback``; a synthetic 15 ms a batch
   only if the real forward drains every burst before the sustain window
   (printed). Last, with both engines held at their next dispatch, 48
   prompts on the decode engine (16 queued) and 11 requests on the batcher
   (10 queued): ``preemption.drain_serving`` completes the in-flight work,
   sheds the 26 queued with the typed Retry-After, returns 26, and ends
   both engines' follower loops.
27. storage and serving beside a model axis: tp_lm flagship (bf16, seq
   1024, global batch 8, Adam 1e-3, flash through ``attn_fn``) on four
   processes of ``cuda:0`` over gloo, ``{data: 2, model: 2}``, started
   right after phase 20 and run beside phases 24 (a) and 25 (a) (one
   process each). (a) ``TensorParallel(2, tp_rules())`` with every
   LayerNorm and post-reduce bias (``ln1``, ``ln2``, ``final_ln``,
   ``bo``, ``b2``) on ``ZeroShardedSynchronizer`` and ``pos_embed``
   partitioned ``"2,1"``, phase 20 (b)'s steps on its batch: the ranks'
   losses equal and within 2e-2 of phase 20 (b)'s; each rank stores half
   of each ZeRO moment and half of ``pos_embed`` (its data index's); 12
   launches of each kernel a rank-step on ``mma.sync bf16``; step p50
   (min-max), peak memory a rank, ``zero.rs_bytes``, ``zero.ag_bytes``
   and ``tp.fwd_allreduces`` a rank-step. (b) the same four ranks serve an
   ``InferenceEngine`` over (a)'s trained state (the last position's
   logits over the whole vocabulary, the model line's columns put
   together in the serve function; buckets (2, 8), 256-token requests):
   every row within 2e-2 (relative to the largest magnitude) of
   ``tp_lm.forward`` on the params ``gather_params`` returns, run in the
   chief's process unbound with the plain attention; flash_fwd launches
   12 a dispatch on each rank (and 12 for the first call's classifying
   forward on the example bucket); QPS and latency p50/p99.

TF32 is off for the whole run (``torch.backends.cuda.matmul`` and
``cudnn``): float32 is computed in float32, as the f32 checks' 2e-5 and
parity bounds need; the bf16 paths are not affected except their float32
GEMMs (the lm1b and bert heads), which run as full float32.

Each phase from 5 on prints its seconds, and the end the whole smoke's.
The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_SMOKE = 0.0   # the smoke's start (perf_counter), set by main
READINGS = {}   # numbers a later phase compares with

# H100 SXM published peaks (NVIDIA data sheet, dense rates): memory rate, and
# the dense bf16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12

DECODE_SLOTS, DECODE_T, HEADS, HEAD_DIM, LAYERS = 32, 256, 16, 64, 8
TRAIN_BATCH, TRAIN_SEQ = 64, 128
# the bench configurations of bert_base and resnet50 (bench.py:106-115)
BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_LAYERS = 128, 128, 12, 12
RESNET_BATCH, RESNET_IMAGE = 256, 224
KERNEL_SOURCES = {
    "flash_fwd": ("autodist_tpu_torch/csrc/flash_fwd.cu",
                  "autodist_tpu/ops/flash_attention.py:97"),
    "flash_bwd_dq": ("autodist_tpu_torch/csrc/flash_bwd.cu",
                     "autodist_tpu/ops/flash_attention.py:213"),
    "flash_bwd_dkdv": ("autodist_tpu_torch/csrc/flash_bwd.cu",
                       "autodist_tpu/ops/flash_attention.py:252"),
}


# the design each kernel runs on the bf16 main paths
MAIN_DESIGN = {"flash_fwd": "mma.sync bf16", "flash_bwd_dq": "mma.sync bf16",
               "flash_bwd_dkdv": "mma.sync bf16"}
# device kernels by kind, for the profiles' summary: the first kind with a
# word in the kernel's name
KERNEL_KINDS = (
    ("flash", ("flash_",)),
    ("gemm/conv", ("gemm", "xmma", "nvjet", "cutlass", "conv", "cudnn",
                   "fprop", "dgrad", "wgrad", "implicit")),
    ("adam (foreach)", ("multi_tensor_apply",)),
    ("reduce/norm/softmax", ("reduce", "norm", "SoftMax", "softmax")),
    ("copy/cast", ("copy", "Memcpy")),
    ("elementwise", ("elementwise",)),
)
# the CUDA function each kernel's main design runs, as ptxas names it
# each wrapper's CUDA functions by name in a device trace; group 1 is set
# for the tensor-core design
DEVICE_FUNCTIONS = {"flash_fwd": r"\bflash_fwd_(mma_)?kernel\b",
                    "flash_bwd_dq": r"\bflash_bwd_dq_(mma_)?kernel\b",
                    "flash_bwd_dkdv": r"\bflash_bwd_dkdv_(mma_)?kernel\b"}
DESIGN_FUNCTION = {"flash_fwd": "flash_fwd_mma_kernel",
                   "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
                   "flash_bwd_dkdv": "flash_bwd_dkdv_mma_kernel"}


def ptxas_usage(log):
    """(kernel, "registers, shared memory, spills") for each kernel that
    ``nvcc -Xptxas -v`` reported on (static shared memory only: the
    dynamic shared memory a launch asks for is not in it)."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?\d+(flash_\w+?kernel)", line)
        if m:
            kernel = m.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            usage = line.split(":", 1)[1].strip()
            out.append((kernel, "%s; %s" % (usage, spills)))
            kernel = None
    return out


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


class _ThreadStdout:
    """``sys.stdout`` that holds back what a :class:`Beside` thread
    prints, so that its lines come out as one block when it is joined."""

    def __init__(self, real):
        self.real = real
        self.held = {}

    def write(self, text):
        held = self.held.get(threading.get_ident())
        if held is None:
            return self.real.write(text)
        held.append(text)
        return len(text)

    def flush(self):
        self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


class Beside:
    """Run ``fn(*args)`` in a thread beside the main thread's phases (the
    two drive processes of their own, on the one card): :meth:`result`
    joins it, prints what it printed, and returns its value or raises its
    error (a ``fail`` inside exits the smoke)."""

    def __init__(self, fn, *args):
        self._out, self._exc, self._held = None, None, []
        if not isinstance(sys.stdout, _ThreadStdout):
            sys.stdout = _ThreadStdout(sys.stdout)

        def run():
            sys.stdout.held[threading.get_ident()] = self._held
            try:
                self._out = fn(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised in join
                self._exc = e
            finally:
                sys.stdout.held.pop(threading.get_ident(), None)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the thread, holding its prints for :meth:`result`."""
        self._thread.join()

    def result(self):
        self._thread.join()
        # through the proxy: a Beside joined inside another's thread
        # holds its lines in that thread's block
        sys.stdout.write("".join(self._held))
        sys.stdout.flush()
        if self._exc is not None:
            raise self._exc
        return self._out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, repeats=5):
    """Device time of one ``fn()`` call: the median over ``repeats`` runs
    of the mean over ``iters`` calls (CUDA events), after two warm-up
    calls."""
    import statistics
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters, repeats=5):
    """Device time of one ``fn()`` call, without the host's time between
    launches (which for a kernel of tens of microseconds behind a Python
    wrapper can be longer than the kernel itself): a sleep kernel holds the
    card while the host queues ``iters`` calls, so that they run back to
    back, and CUDA events around the calls time them. If the card reached
    the first event before the host had queued the last call, the sleep
    was too short (or the launch queue full) and the run is taken again
    with a longer sleep, then with fewer calls. The median over
    ``repeats`` runs, after two warm-up calls."""
    import statistics
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    cycles, times = 4 * 10 ** 7, []       # about 20 ms at 2 GHz
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()          # the card still sleeps
        torch.cuda.synchronize()
        if held:
            times.append(start.elapsed_time(end) / iters)
        elif cycles < 2 ** 4 * 4 * 10 ** 7:
            cycles *= 2
        elif iters > 1:
            iters //= 2
        else:
            fail("the host could not queue one timed call behind a %d-cycle "
                 "sleep" % cycles)
    return statistics.median(times)


def timed(fn, iters):
    """(device ms, ms a call with host dispatch) of one ``fn()`` call."""
    return device_ms(fn, iters), cuda_time_ms(fn, iters)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def kernels():
    from autodist_tpu_torch.ops import flash_attention as fa
    return (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkdv)


def launch_counts():
    """Each kernel's launches by design, a copy."""
    from autodist_tpu_torch.ops import flash_attention as fa
    return fa.launch_counts()


def reset_counts():
    from autodist_tpu_torch.ops import flash_attention as fa
    fa.set_launch_counts({})


@contextlib.contextmanager
def uncounted():
    """Launches made to compare or time a kernel do not count toward the
    main paths' numbers: the counts are restored on the way out."""
    from autodist_tpu_torch.ops import flash_attention as fa
    saved = fa.launch_counts()
    try:
        yield
    finally:
        fa.set_launch_counts(saved)


def record(name, max_abs_err, ms, plain_ms, library_ms, t_bytes, t_ops,
           call_ms):
    """One entry of the kernels' JSON line for one path's shape (launches
    filled in later). ``ms``, ``plain_ms`` and ``library_ms`` are device
    times (:func:`device_ms`); ``call_ms`` is the kernel's time a call
    with its wrapper's host dispatch (:func:`cuda_time_ms`)."""
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "call_ms": call_ms,
            "design": MAIN_DESIGN[name], "design_launches": 0}


def check_rel(name, got, want, tol):
    """Kernel vs plain version, the error relative to the plain version's
    largest magnitude."""
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    print("  %-44s max_abs_err %.3e, / max|ref| %.3e = %.3e (tol %.0e)"
          % (name, err, scale, err / max(scale, 1e-30), tol))
    if not err <= tol * scale:
        fail("%s disagrees with the plain version (max err %.3e, max|ref| "
             "%.3e)" % (name, err, scale))
    return err


def check_close(name, got, want, tol):
    import torch
    err = max_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    print("  %-44s max_abs_err %.3e (tol %.0e)" % (name, err, tol))
    if not ok:
        fail("%s disagrees with the plain version (max err %.3e)"
             % (name, err))
    return err


# ------------------------------------------------------------- phase 2


def decode_inputs(dtype, seed, slots=DECODE_SLOTS):
    """A full-size layer-stacked KV cache [slots, layers, T, H, D], one
    query per slot, cursors spread over [0, T-1] with both ends present."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (slots, LAYERS, DECODE_T, HEADS, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((slots, HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(dtype)
    cursor = torch.randint(0, DECODE_T, (slots,), generator=gen,
                           device="cuda")
    cursor[0], cursor[1] = 0, DECODE_T - 1
    return q, k, v, cursor.int()


def segs_for(cursor):
    import torch
    q_seg = torch.ones((cursor.shape[0], 1), dtype=torch.int32,
                       device=cursor.device)
    kv_seg = (torch.arange(DECODE_T, device=cursor.device)[None, :]
              <= cursor[:, None]).int()
    return q_seg, kv_seg


def kernel_phase():
    """Phase 2: flash_fwd vs its plain version at the decode and prefill
    shapes; returns the largest error of the outputs."""
    import torch
    from autodist_tpu_torch.ops import flash_attention as fa

    errs = []
    print("phase 2: flash_fwd vs flash_fwd_reference")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tag = "%s, %s" % (str(dtype).replace("torch.", ""),
                          fa._fwd_variant(dtype))
        q, k, v, cursor = decode_inputs(dtype, seed=1)
        q_seg, kv_seg = segs_for(cursor)
        layer = 3
        out, lse = fa.flash_fwd(q[:, None], k[:, layer], v[:, layer], q_seg,
                                kv_seg)
        ref, ref_lse = fa.flash_fwd_reference(q[:, None], k[:, layer],
                                              v[:, layer], q_seg, kv_seg)
        torch.cuda.synchronize()
        errs.append(check_close("decode out [32,1,256,16,64] (%s)" % tag,
                                out, ref, tol))
        check_close("decode lse (%s)" % tag, lse, ref_lse, tol)

        gen = torch.Generator(device="cuda").manual_seed(2)
        shape = (8, 256, HEADS, HEAD_DIM)   # [B, S, H, D] = [8,16,256,64]
        pq, pk, pv = (torch.randn(shape, generator=gen, device="cuda")
                      .to(dtype) for _ in range(3))
        seg = (torch.arange(256, device="cuda") >= 100).int()[None].repeat(
            8, 1).contiguous()
        q_empty = seg.clone()
        q_empty[:, 5] = 7                   # an id no key carries
        for name, segs in (("causal", None), ("causal+segments", (seg, seg)),
                           ("causal+empty row", (q_empty, seg))):
            qs, ks = segs if segs is not None else (None, None)
            out, lse = fa.flash_fwd(pq, pk, pv, qs, ks, causal=True)
            ref, ref_lse = fa.flash_fwd_reference(pq, pk, pv, qs, ks,
                                                  causal=True)
            torch.cuda.synchronize()
            errs.append(check_close("prefill %s (%s)" % (name, tag), out, ref,
                                    tol))
            check_close("prefill %s lse (%s)" % (name, tag), lse, ref_lse,
                        tol)
            if name == "causal+empty row":
                if bool(out[:, 5].float().abs().max() != 0) or \
                        bool(lse[:, :, 5].abs().max() != 0):
                    fail("an empty query row did not give 0 output, 0 lse")
                print("  empty query row: output 0, lse 0")
    return max(errs)


def decode_timing(card, err, slots=DECODE_SLOTS):
    """flash_fwd at the decode shape of ``slots`` slots, timed beside its
    plain version, SDPA and its bound; returns its record (``err`` its
    largest error, without its main-path launch count). ``card`` tags the
    timing line."""
    import torch
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import flash_attention as fa

    # bf16, rotating over the 8 layers' cache slices as the main path does
    # (268 MB per cache half at 32 slots > the 50 MB L2)
    q, k, v, cursor = decode_inputs(torch.bfloat16, seed=3, slots=slots)
    q_seg, kv_seg = segs_for(cursor)
    q1 = q[:, None]
    mask = (torch.arange(DECODE_T, device="cuda")[None, :]
            <= cursor[:, None])[:, None, None, :]      # [B,1,1,T]
    qh = q1.transpose(1, 2)                             # [B,H,1,D]
    kh = [k[:, i].transpose(1, 2) for i in range(LAYERS)]
    vh = [v[:, i].transpose(1, 2) for i in range(LAYERS)]

    def over_layers(f):
        def run():
            for i in range(LAYERS):
                f(i)
        return run

    def per_layer(f, iters):
        return [t / LAYERS for t in timed(over_layers(f), iters)]

    with uncounted():
        ms, call_ms = per_layer(lambda i: fa.flash_fwd(
            q1, k[:, i], v[:, i], q_seg, kv_seg), 20)
        plain_ms, _ = per_layer(lambda i: fa.flash_fwd_reference(
            q1, k[:, i], v[:, i], q_seg, kv_seg), 5)
        library_ms, library_call_ms = per_layer(
            lambda i: F.scaled_dot_product_attention(qh, kh[i], vh[i],
                                                     attn_mask=mask), 20)

    live_rows = int((cursor.long() + 1).sum())
    itemsize = 2
    bytes_moved = (2 * live_rows * HEADS * HEAD_DIM * itemsize    # K, V
                   + 2 * slots * HEADS * HEAD_DIM * itemsize        # q, o
                   + slots * HEADS * 4                              # lse
                   + slots * (1 + DECODE_T) * 4)                    # seg ids
    flops = 4 * live_rows * HEADS * HEAD_DIM
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print("  decode bf16 [%d,1,256,16,64] (%d live rows), device ms (a call "
          "with host dispatch): kernel (%s) %.4f (%.4f); plain %.4f; sdpa "
          "%.4f (%.4f); bound %.4f (%s) [%s]"
          % (slots, live_rows, fa._fwd_variant(torch.bfloat16), ms, call_ms,
             plain_ms, library_ms, library_call_ms, bound_ms,
             "bytes" if t_bytes >= t_ops else "operations", card))
    return record("flash_fwd", err, ms, plain_ms, library_ms, t_bytes, t_ops,
                  call_ms)


def bwd_kernel_phase():
    """Phase 2b: both backward kernels vs their plain versions, and the
    forward kernel at the training shape (whose out and lse feed them) vs
    its own; returns each kernel's errors."""
    import torch
    from autodist_tpu_torch.ops import flash_attention as fa

    print("phase 2b: flash_fwd at the training shape, flash_bwd_dq, "
          "flash_bwd_dkdv vs their plain versions")
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkdv": []}
    train_shape = (TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        designs = {"flash_fwd": fa._fwd_variant(dtype),
                   "flash_bwd_dq": fa._dq_variant(dtype),
                   "flash_bwd_dkdv": fa._dkdv_variant(dtype)}
        gen = torch.Generator(device="cuda").manual_seed(4)
        train = [torch.randn(train_shape, generator=gen, device="cuda")
                 .to(dtype) for _ in range(4)]
        small = [torch.randn((8, 256, HEADS, HEAD_DIM), generator=gen,
                             device="cuda").to(dtype) for _ in range(4)]
        seg = (torch.arange(256, device="cuda") >= 100).int()[None].repeat(
            8, 1).contiguous()
        q_empty = seg.clone()
        q_empty[:, 5] = 7                   # an id no key carries
        for name, (q, k, v, do), segs in (
                ("train [64,128,16,64] causal", train, (None, None)),
                ("[8,256,16,64] causal+segments+empty row", small,
                 (q_empty, seg))):
            out, lse = fa.flash_fwd(q, k, v, *segs, causal=True)
            ref, ref_lse = fa.flash_fwd_reference(q, k, v, *segs,
                                                  causal=True)
            torch.cuda.synchronize()
            what = "%s %s (%s)" % (tag, name, designs["flash_fwd"])
            errs["flash_fwd"].append(max(
                check_close("out " + what, out, ref, tol),
                check_close("lse " + what, lse, ref_lse, tol)))
            delta = fa.flash_bwd_delta(out, do)
            args = (q, k, v, do, lse, delta, *segs)
            dq = fa.flash_bwd_dq(*args, causal=True)
            dk, dv = fa.flash_bwd_dkdv(*args, causal=True)
            dq_ref = fa.flash_bwd_dq_reference(*args, causal=True)
            dk_ref, dv_ref = fa.flash_bwd_dkdv_reference(*args, causal=True)
            torch.cuda.synchronize()
            errs["flash_bwd_dq"].append(check_rel(
                "dq %s %s (%s)" % (tag, name, designs["flash_bwd_dq"]), dq,
                dq_ref, tol))
            for g, r, grad in ((dk, dk_ref, "dk"), (dv, dv_ref, "dv")):
                errs["flash_bwd_dkdv"].append(check_rel(
                    "%s %s %s (%s)" % (grad, tag, name,
                                       designs["flash_bwd_dkdv"]),
                    g, r, tol))
            if segs[0] is not None:
                if bool(dq[:, 5].float().abs().max() != 0):
                    fail("an empty query row did not get a 0 gradient")
                print("  empty query row: dq 0")
    return errs


def bert_segments(batch, seed):
    """Key-padding segment ids [batch, BERT_SEQ] on the card (1 real, 0
    padding) with lengths from ``seed`` in [64, 128]: row 0 has 64 real
    keys, so its real query tile skips the all-padding key tile and its
    padding query tile the real one; row 1 is not padded."""
    import numpy as np
    import torch
    lengths = np.random.RandomState(seed).randint(64, BERT_SEQ + 1, batch)
    lengths[0], lengths[1] = 64, BERT_SEQ
    seg = (np.arange(BERT_SEQ)[None] < lengths[:, None]).astype(np.int32)
    return torch.as_tensor(seg, device="cuda")


def bert_kernel_phase():
    """Phase 2b at the bert_base shape: the three kernels, non-causal, with
    ragged key-padding segment ids, vs their plain versions (bf16 at the
    bench batch, f32 at batch 16); returns each kernel's errors."""
    import torch
    from autodist_tpu_torch.ops import flash_attention as fa

    print("phase 2b: the three kernels at the bert_base shape [%d, %d, %d, "
          "%d], non-causal, ragged key padding as segment ids"
          % (BERT_BATCH, BERT_SEQ, BERT_HEADS, HEAD_DIM))
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkdv": []}
    for dtype, tol, batch in ((torch.float32, 2e-5, 16),
                              (torch.bfloat16, 2e-2, BERT_BATCH)):
        shape = (batch, BERT_SEQ, BERT_HEADS, HEAD_DIM)
        what = "%s [%d,%d,%d,%d] padding" % (
            str(dtype).replace("torch.", ""), *shape)
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        seg = bert_segments(batch, seed=7)
        out, lse = fa.flash_fwd(q, k, v, seg, seg)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, seg, seg)
        torch.cuda.synchronize()
        design = " (%s)" % fa._fwd_variant(dtype)
        errs["flash_fwd"].append(max(
            check_close("out " + what + design, out, ref, tol),
            check_close("lse " + what + design, lse, ref_lse, tol)))
        args = (q, k, v, do, lse, fa.flash_bwd_delta(out, do), seg, seg)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkdv(*args)
        dq_ref = fa.flash_bwd_dq_reference(*args)
        dk_ref, dv_ref = fa.flash_bwd_dkdv_reference(*args)
        torch.cuda.synchronize()
        errs["flash_bwd_dq"].append(check_rel(
            "dq %s (%s)" % (what, fa._dq_variant(dtype)), dq, dq_ref, tol))
        for g, r, grad in ((dk, dk_ref, "dk"), (dv, dv_ref, "dv")):
            errs["flash_bwd_dkdv"].append(check_rel(
                "%s %s (%s)" % (grad, what, fa._dkdv_variant(dtype)), g, r,
                tol))
    return errs


def kernel_timing(card, errs, shape, causal, seg, label):
    """The three kernels at ``shape`` [B, S, H, D] in bf16 (``causal``,
    segment ids ``seg`` [B, S] or None), each timed beside its plain
    version, SDPA computing the same function and its bound; returns their
    records (``errs`` their errors, without main-path launch counts), and
    prints ``flash_bwd_delta``'s time beside its byte bound. ``label``
    and ``card`` tag the lines."""
    import torch
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import flash_attention as fa

    # four bf16 inputs of 16.8 MB (lm1b's shape) or 25.2 MB (bert's), so
    # L2 holds at most part of them, as for a layer of the main path
    B, S, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    segs = (seg, seg) if seg is not None else (None, None)
    with uncounted():
        out, lse = fa.flash_fwd(q, k, v, *segs, causal=causal)
        delta = fa.flash_bwd_delta(out, do)
        args = (q, k, v, do, lse, delta, *segs)
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, *segs, causal=causal),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args, causal=causal),
            "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(*args,
                                                        causal=causal)}
        ms, call = {}, {}
        for name, fn in calls.items():
            ms[name], call[name] = timed(fn, 20)
        plain = {"flash_fwd": device_ms(
                     lambda: fa.flash_fwd_reference(q, k, v, *segs,
                                                    causal=causal), 3),
                 "flash_bwd_dq": device_ms(
                     lambda: fa.flash_bwd_dq_reference(*args, causal=causal),
                     3),
                 "flash_bwd_dkdv": device_ms(
                     lambda: fa.flash_bwd_dkdv_reference(*args,
                                                         causal=causal),
                     3)}
    # library yardstick: SDPA's forward, and its backward (its own fused
    # kernel, which computes dq, dk and dv together) asked for each
    # kernel's outputs; segments become a boolean [B, 1, S, S] mask
    mask = None if seg is None else \
        (seg[:, None, :, None] == seg[:, None, None, :])
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              is_causal=causal)
    oh = sdpa()
    doh = do.transpose(1, 2)
    library = {"flash_fwd": timed(sdpa, 20),
               "flash_bwd_dq": timed(lambda: torch.autograd.grad(
                   oh, (qh,), doh, retain_graph=True), 20),
               "flash_bwd_dkdv": timed(lambda: torch.autograd.grad(
                   oh, (kh, vh), doh, retain_graph=True), 20)}

    n = B * S * H * D                   # elements a tensor
    rows = B * H * S                    # lse / delta rows
    # visible (query, key) pairs, counted from this run's masks
    if seg is not None:
        live = H * int((seg[:, :, None] == seg[:, None, :]).sum())
    elif causal:
        live = B * H * S * (S + 1) // 2
    else:
        live = B * H * S * S
    seg_bytes = 0 if seg is None else 2 * B * S * 4
    work = {  # (bytes: inputs read once + outputs written once, flops)
        "flash_fwd": ((3 * n + n) * 2 + rows * 4 + seg_bytes,  # q,k,v; o,lse
                      2 * 2 * live * D),                   # s, p.v
        "flash_bwd_dq": ((4 * n + n) * 2 + 2 * rows * 4 + seg_bytes,
                         3 * 2 * live * D),                # s, dp, dq
        "flash_bwd_dkdv": ((4 * n + 2 * n) * 2 + 2 * rows * 4 + seg_bytes,
                           4 * 2 * live * D)}              # s, dp, dv, dk
    records = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        rec = record(name, max(errs[name]), ms[name], plain[name],
                     library[name][0], t_bytes, t_ops, call[name])
        print("  %s bf16 %s, device ms (a call with host dispatch): kernel "
              "(%s) %.4f (%.4f); plain %.4f; sdpa %s %.4f (%.4f); bound "
              "%.4f (%s: %.1f MB, %.2f GFLOP) [%s]"
              % (name, label, rec["design"], rec["ms"], rec["call_ms"],
                 rec["plain_ms"],
                 "forward" if name == "flash_fwd" else "backward",
                 *library[name], rec["bound_ms"], rec["bound_by"],
                 nbytes / 1e6, flops / 1e9, card))
        records[name] = rec

    # delta = rowsum(dO * O) in f32: four PyTorch ops the backward runs
    # before the two kernels; reads O and dO, writes [B, H, S] f32
    d_ms, c_ms = timed(lambda: fa.flash_bwd_delta(out, do), 20)
    nbytes = 2 * n * 2 + rows * 4
    print("  flash_bwd_delta bf16 %s, device ms (a call with host dispatch): "
          "%.4f (%.4f); bound %.4f (bytes: %.1f MB) [%s]"
          % (label, d_ms, c_ms, nbytes / H100_BYTES_PER_S * 1e3,
             nbytes / 1e6, card))
    return records


# ------------------------------------------------------------- phase 3/4


def device_profile(run, label):
    """Run ``run()`` under torch.profiler and print where the device time
    went: busy share of the window and the top kernels. Only device events
    (kernels, copies, fills) count, their overlaps merged: the CPU ops the
    profiler records also carry their kernels' time, and summing both
    would count it twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("  device profile: not measured (the profiler saw no device "
              "time)")
        return
    busy, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += stop - start
        tot[1] += 1
    total = sum(t for t, _ in by_name.values())
    print("  device profile over %s: window %.1f ms, device busy %.1f ms "
          "(%.1f%%, idle %.1f%%)" % (
              label, window_us / 1e3, busy / 1e3,
              100 * busy / window_us, 100 * (1 - busy / window_us)))
    for key, (dev, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        print("    %6.2f%% of device time  %5d calls  %s"
              % (100 * dev / total, count, key[:90]))
    kinds = {}
    for key, (dev, _) in by_name.items():
        kind = next((k for k, words in KERNEL_KINDS if any(
            w in key for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + dev
    print("    by kind: %s" % ", ".join(
        "%s %.1f%%" % (k, 100 * t / total)
        for k, t in sorted(kinds.items(), key=lambda kv: -kv[1])))
    # each kernel under the host-side PyTorch op that launched it (an op's
    # own device time, not its children's); the profiler also lists the
    # kernels themselves, which are left out
    ops = []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", 0.0)
        if own > 0 and e.device_type != DeviceType.CUDA:
            ops.append((own, e.count, e.key))
    print("    by op: %s" % ", ".join(
        "%s %.1f%% (%d calls)" % (key, 100 * own / total, count)
        for own, count, key in sorted(ops, reverse=True)[:8]))


def serve(cfg, loss_fn, params, batch, decode_attn, dcfg, prompts,
          profile_prompts=None):
    """Build -> init -> DecodeEngine through the public entry points;
    returns (results, engine stats, wall seconds, flash_fwd's launches by
    design in the timed run, runner)."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeEngine

    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, decode_attn),
                          dcfg)
    try:
        engine.warmup()
        torch.cuda.synchronize()
        from autodist_tpu_torch.ops import flash_attention as fa
        reset_counts()
        t0 = time.perf_counter()
        futures = [engine.submit(p) for p in prompts]
        results = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.flash_fwd.launches_by_variant)
        if sum(launches.values()) != fa.flash_fwd.launches:
            fail("flash_fwd's launches by design do not add up: %r vs %d"
                 % (launches, fa.flash_fwd.launches))
        stats = engine.stats()
        if profile_prompts:
            def submit_all():
                for f in [engine.submit(p) for p in profile_prompts]:
                    f.result(timeout=600)
            device_profile(submit_all, "%d prompts" % len(profile_prompts))
    finally:
        engine.close()
    return results, stats, wall, launches, runner


def build_runner(loss_fn, params, batch):
    """Build -> init through the public entry points, on the card."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner


def train_runner(cfg, batch_size, attention):
    """lm1b's runner; returns (runner, init params on the host, batch)."""
    from autodist_tpu_torch.models import lm
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=batch_size, seed=0,
        attention=attention, lean_head=True)
    return build_runner(loss_fn, params, batch), params, batch


def timed_steps(runner, batch, label, warmup=2, steps=10, must_fall=True,
                losses_out=None):
    """``warmup`` + ``steps`` training steps, each ended by a sync; fails
    unless every loss is finite and (``must_fall``) the last is below the
    first; appends the losses to ``losses_out`` when given. Returns
    (the timed steps' seconds, each kernel's launches by design over all
    the steps); the counts are set to 0 just before the first step."""
    import math
    import torch
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        metrics = runner.run(batch)      # sync: reads the loss back
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = launch_counts()
    if losses_out is not None:
        losses_out.extend(losses)
    print("  losses: %s" % " ".join("%.4f" % x for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail("%s: a loss is not finite: %r" % (label, losses))
    if must_fall and not losses[-1] < losses[0]:
        fail("%s: the loss did not fall (%.4f -> %.4f)"
             % (label, losses[0], losses[-1]))
    return times[warmup:], launches


def check_launches(label, launches, per_step, steps, design=None):
    """Each kernel launched ``per_step`` times a step over ``steps`` steps,
    all in ``design`` (default: its main design)."""
    for kern in kernels():
        name = kern.__name__
        want = {(design or MAIN_DESIGN[name]): per_step * steps}
        if launches[name] != want:
            fail("%s: %s launched %r over %d steps (want %r)"
                 % (label, name, launches[name], steps, want))


def report_steps(label, times, items, unit, flops, card, launches):
    """Step p50 (min-max), items a second, MFU and peak memory; returns the
    p50 in ms."""
    import statistics
    import torch
    p50 = statistics.median(times)
    print("  %s, %d steps: step p50 %.2f ms (min %.2f, max %.2f), %.0f %s/s, "
          "%.2f TFLOP/step, MFU %.2f%% of %.0f TFLOP/s bf16, peak memory "
          "%.2f GB, launches %s [%s]"
          % (label, len(times), p50 * 1e3, min(times) * 1e3,
             max(times) * 1e3, items / p50, unit, flops / 1e12,
             100 * flops / p50 / H100_BF16_FLOPS, H100_BF16_FLOPS / 1e12,
             torch.cuda.max_memory_allocated() / 1e9, launches, card))
    return p50 * 1e3


def profile_steps(runner, batch, label, steps=3):
    def run():
        for _ in range(steps):
            runner.run(batch)
    device_profile(run, "%d %s steps" % (steps, label))


def train_flops_per_step(cfg, n_params):
    """Closed-form training FLOPs of one lm1b step: 6 x tokens x
    (parameters outside the two embedding tables, lm_head included) plus
    the attention products, 12 x layers x seq x d_model per token (PaLM's
    count, which ignores the causal half)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dense = n_params - (cfg.vocab_size + cfg.max_seq_len) * cfg.d_model
    return 6 * tokens * dense + 12 * cfg.num_layers * TRAIN_SEQ * \
        cfg.d_model * tokens


def train_phase(card):
    """Phase 5: lm1b full width, bf16, lean head, flash attention. Returns
    each kernel's launches by design over the phase's steps."""
    import torch
    from autodist_tpu_torch.models import lm
    print("phase 5: lm1b full width (bf16, seq %d, batch %d, lean head, "
          "flash) through AutoDist -> Runner.init -> Runner.run"
          % (TRAIN_SEQ, TRAIN_BATCH))
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    runner, params, batch = train_runner(cfg, TRAIN_BATCH, "flash")
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for p in params.values())
    print("  %d parameters (random, seed 0), setup %.1f s"
          % (n_params, time.perf_counter() - t0))
    times, launches = timed_steps(runner, batch, "lm1b training")
    check_launches("lm1b training", launches, cfg.num_layers,
                   2 + len(times))
    final = runner.gather_params()
    if any(t.dtype != torch.float32 for t in final.values()):
        fail("training: the master params are not all float32")
    moved = [n for n in ("embed.embedding",
                         "layer_0.MultiHeadAttention_0.query.weight",
                         "layer_%d.Dense_1.weight" % (cfg.num_layers - 1),
                         "final_ln.weight",
                         "lm_head.weight")
             if not torch.equal(final[n].cpu(), params[n])]
    if len(moved) != 5:
        fail("training: some params did not move (moved: %r)" % moved)
    report_steps("lm1b", times, TRAIN_BATCH * TRAIN_SEQ, "tokens",
                 train_flops_per_step(cfg, n_params), card, launches)
    stats = runner.step_stats()
    print("  step_stats: first_step_s %s steady_median_s %s goodput %s"
          % (stats["first_step_s"], stats["steady_median_s"],
             stats["goodput"]))
    profile_steps(runner, batch, "training")
    return launches


def check_parity(label, got, steps, lr=1e-3):
    """Two runs from one init, ``got[label] = (losses, final params)``
    (flash and the plain path; or two replica counts): losses within 1e-4
    relative; params within 2 x steps x lr each and 1e-6 on average. Adam
    moves every element by up to lr a step whatever its gradient's size,
    so an element whose gradient is at the rounding-noise level (the key
    biases' gradient is zero analytically) may step either way."""
    (lf, pf), (lr_, pr) = got.values()
    for a, b in zip(lf, lr_):
        if abs(a - b) > 1e-4 * abs(b):
            fail("%s: losses differ (%r vs %r)" % (label, lf, lr_))
    worst, total, count = 0.0, 0.0, 0
    for name in pf:
        d = (pf[name] - pr[name]).abs()
        worst = max(worst, float(d.max()))
        total += float(d.double().sum())
        count += d.numel()
    mean = total / count
    print("  params after %d steps: max |%s - %s| %.3e (bound %.0e), "
          "mean %.3e (bound 1e-06)" % (steps, *got, worst, 2 * steps * lr,
                                       mean))
    if worst > 2 * steps * lr or mean > 1e-6:
        fail("%s: params differ beyond the bounds" % label)


def parity_runs(label, make_runner, attentions, layers, steps=3):
    """3 Adam steps with each attention from the same init; the flash run
    must launch every kernel ``layers`` times a step, all ``scalar f32``."""
    got = {}
    for attention in attentions:
        runner, batch = make_runner(attention)
        reset_counts()
        losses = [float(runner.run(batch)["loss"]) for _ in range(steps)]
        if attention == "flash":
            check_launches(label, launch_counts(), layers, steps,
                           design="scalar f32")
        got[attention] = (losses, runner.gather_params())
        print("  %-8s losses %s" % (attention,
                                    " ".join("%.6f" % x for x in losses)))
    check_parity(label, got, steps)


def train_parity_phase():
    """Phase 6: lm1b full width in f32, batch 8: 3 Adam steps with flash
    attention (the three kernels) vs 3 with the reference attention."""
    from autodist_tpu_torch.models import lm
    print("phase 6: lm1b full width (f32, seq %d, batch 8): flash vs "
          "reference attention, 3 Adam steps each" % TRAIN_SEQ)
    cfg = lm.LMConfig.lm1b()
    parity_runs("training parity",
                lambda attention: train_runner(cfg, 8, attention)[::2],
                ("flash", "default"), cfg.num_layers)


def bert_setup(dtype, batch_size, attention, ragged=False):
    """(runner, init params, batch, config) of bert_base at seq 128;
    ``ragged`` pads the batch from a seed (lengths 64-128) and weighs
    real tokens only."""
    from autodist_tpu_torch.models import bert
    cfg = bert.BertConfig.base(dtype=dtype)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=batch_size, seed=0,
        attention=attention)
    if ragged:
        mask = bert_segments(batch_size, seed=9).cpu().numpy()
        batch = dict(batch, attention_mask=mask,
                     mlm_weights=batch["mlm_weights"] * mask)
    return build_runner(loss_fn, params, batch), params, batch, cfg


def bert_flops_per_step(cfg, n_params):
    """Closed-form training FLOPs of one bert_base step: 6 x tokens x
    (parameters outside the three embedding tables, the MLM head
    included) plus 12 x layers x seq x hidden per token for attention."""
    tokens = BERT_BATCH * BERT_SEQ
    tables = (cfg.vocab_size + cfg.max_position + cfg.type_vocab_size) * \
        cfg.hidden_size
    return 6 * tokens * (n_params - tables) + 12 * cfg.num_layers * \
        BERT_SEQ * cfg.hidden_size * tokens


def bert_train_phase(card):
    """Phase 7: bert_base full width, bf16, the bench batch, with flash
    attention and then the plain attention. Returns the flash run's
    launches by design."""
    import torch
    print("phase 7: bert_base full width (bf16, seq %d, batch %d) through "
          "AutoDist -> Runner.init -> Runner.run, attention flash then xla"
          % (BERT_SEQ, BERT_BATCH))
    p50, flash_launches, losses_of = {}, None, {}
    for attention in ("flash", "xla"):
        t0 = time.perf_counter()
        runner, params, batch, cfg = bert_setup(torch.bfloat16, BERT_BATCH,
                                                attention)
        torch.cuda.synchronize()
        n_params = sum(int(p.numel()) for p in params.values())
        print("  %s: %d parameters (random, seed 0), setup %.1f s"
              % (attention, n_params, time.perf_counter() - t0))
        label = "bert_base %s" % attention
        # the fixed-batch run spikes near step 10 and oscillates, so "the
        # last loss below the first" cannot judge it: each run's loss after
        # 3 steps must be below its first, and the two attentions' first 3
        # losses agree (below)
        losses = losses_of[attention] = []
        times, launches = timed_steps(runner, batch, label, must_fall=False,
                                      losses_out=losses)
        if not losses[3] < losses[0]:
            fail("%s: the loss after 3 steps is not below the first (%.4f "
                 "-> %.4f)" % (label, losses[0], losses[3]))
        if attention == "flash":
            check_launches(label, launches, cfg.num_layers, 2 + len(times))
            flash_launches = launches
        elif any(launches.values()):
            fail("%s launched a flash kernel: %r" % (label, launches))
        final = runner.gather_params()
        for name in ("encoder.word_embeddings.embedding",
                     "encoder.layer_0.MultiHeadAttention_0.query.weight",
                     "mlm_output.weight"):
            if torch.equal(final[name].cpu(), params[name]):
                fail("%s: %s did not move" % (label, name))
        p50[attention] = report_steps(
            label, times, BERT_BATCH * BERT_SEQ, "tokens",
            bert_flops_per_step(cfg, n_params), card, launches)
        profile_steps(runner, batch, label)
        if attention == "flash":
            # the wrapper turns each layer's [B, 1, 1, S] mask into segment
            # ids (a slice and an int cast) in every layer's forward
            mask = torch.as_tensor(batch["attention_mask"],
                                   device="cuda")[:, None, None, :].bool()
            seg_ms = cuda_time_ms(lambda: mask[:, 0, 0, :].int(), 50)
            print("  segment ids from the mask: %.4f ms a layer (a call with "
                  "host dispatch), %.3f ms a step over %d layers"
                  % (seg_ms, seg_ms * cfg.num_layers, cfg.num_layers))
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        losses_of["flash"][:3], losses_of["xla"][:3]))
    if worst > 2e-2:
        fail("phase 7: the flash run's first 3 losses %r are not within 2e-2 "
             "of the xla run's %r" % (losses_of["flash"][:3],
                                      losses_of["xla"][:3]))
    print("  flash vs xla at bert_base seq %d, batch %d: first 3 losses "
          "within %.2e relative (bound 2e-2); step p50 %.2f vs %.2f ms [%s]"
          % (BERT_SEQ, BERT_BATCH, worst, p50["flash"], p50["xla"], card))
    return flash_launches


def forward_flops_per_image(model, image=RESNET_IMAGE):
    """Closed-form forward FLOPs of one image (2 per multiply-add) of the
    convs and Dense layers, from each layer's output shape (a forward on
    the meta device)."""
    import torch
    from autodist_tpu_torch.models import resnet
    from autodist_tpu_torch.models.layers import Dense
    total = []

    def hook(mod, inputs, out):
        total.append(2 * out.numel() * mod.weight.shape[1]
                     * (mod.kernel ** 2 if isinstance(mod, resnet.Conv)
                        else 1))
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (resnet.Conv, Dense))]
    try:
        model(torch.empty((1, image, image, 3), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def resnet_phase(card):
    """Phase 8: resnet50 full width, bf16 convs, image 224, batch 256."""
    import torch
    from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
    from autodist_tpu_torch.models import resnet
    print("phase 8: resnet50 full width (bf16 convs, f32 params, image %d, "
          "batch %d) through AutoDist -> Runner.init -> Runner.run"
          % (RESNET_IMAGE, RESNET_BATCH))
    t0 = time.perf_counter()
    loss_fn, params, batch, _ = resnet.make_train_setup(
        resnet.ResNet50, image_size=RESNET_IMAGE, batch_size=RESNET_BATCH,
        dtype=torch.bfloat16, seed=0)
    runner = build_runner(loss_fn, params, batch)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for n, p in params.items()
                   if not n.startswith(BATCH_STATS_PREFIX))
    print("  %d parameters and %d BatchNorm statistics (random, seed 0), "
          "setup %.1f s" % (n_params, sum(
              int(p.numel()) for n, p in params.items()
              if n.startswith(BATCH_STATS_PREFIX)),
              time.perf_counter() - t0))
    times, launches = timed_steps(runner, batch, "resnet50")
    final = runner.gather_params()
    stats = [n for n in final if n.startswith(BATCH_STATS_PREFIX)]
    moved = [n for n in stats if not torch.equal(final[n].cpu(), params[n])]
    if not stats or moved:
        fail("resnet50: BatchNorm statistics moved: %r" % moved[:5])
    with torch.device("meta"):
        model = resnet.ResNet50(num_classes=1000)
    for name in ("conv_init.weight", "bn_init.weight", "%s_%d.Conv_2.weight"
                 % (model.block_name, model.num_blocks - 1), "head.weight"):
        if torch.equal(final[name].cpu(), params[name]):
            fail("resnet50: %s did not move" % name)
    print("  %d BatchNorm mean/var tensors bit-equal before and after the "
          "steps" % len(stats))
    flops = 3 * RESNET_BATCH * forward_flops_per_image(model)
    report_steps("resnet50", times, RESNET_BATCH, "images", flops, card,
                 launches)
    profile_steps(runner, batch, "resnet50")


def bert_parity_phase():
    """Phase 9: bert_base full width in f32, batch 8, ragged padding: 3 Adam
    steps with flash attention vs 3 with the plain attention."""
    import torch
    print("phase 9: bert_base full width (f32, seq %d, batch 8, ragged "
          "padding, mlm_weights on real tokens): flash vs xla attention, 3 "
          "Adam steps each" % BERT_SEQ)
    parity_runs("bert parity", lambda attention: bert_setup(
        torch.float32, 8, attention, ragged=True)[:3:2], ("flash", "xla"),
        BERT_LAYERS)


# ------------------------------------------------------------- phase 10


DP_RANKS = 2
# phase 10 (a)'s steps: the fp32 wire's, in deterministic mode, are phase
# 19 (a)'s uninterrupted reference, so it runs as many as 19 (a)
DP_STEPS = {"fp32": 5, "int8": 3}
# two replicas of one card: the index listed once a rank, never inferred
DP_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                      "gpus": [0] * DP_RANKS}]}


def dp_runner(loss_fn, params, batch, **strategy_kw):
    """Build -> init through the public entry points on ``cuda:0``, one
    replica of the process group's DP_RANKS."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(**strategy_kw),
                      resource_spec=ResourceSpec.from_dict(DP_SPEC),
                      device="cuda:0")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner


def ranks_equal(params):
    """Whether every rank holds bit-equal params: rank 0's, broadcast,
    against this rank's, with ``torch.equal``."""
    import torch
    import torch.distributed as dist
    mine = torch.cat([t.reshape(-1) for t in params.values()])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(mine, ref))


def two_phase_np(xs, block):
    """The int8 two-phase all-reduce of the per-rank vectors ``xs``, in
    numpy from the codec's mirror (``quant_wire_np`` / ``dequant_wire_np``):
    each rank's padded chunks quantized blockwise, each chunk's f32
    dequant-sum over the ranks in rank order, requantized and
    dequantized."""
    import numpy as np
    from autodist_tpu_torch.parallel.collectives import (dequant_wire_np,
                                                         quant_wire_np)
    n, L = len(xs), xs[0].shape[0]
    chunk = -(-(-(-L // n)) // block) * block
    deq = []
    for x in xs:
        w = quant_wire_np(np.pad(x, (0, n * chunk - L)), block)
        deq.append(dequant_wire_np(w, (n, chunk)))
    out = []
    for c in range(n):
        acc = deq[0][c]
        for d in deq[1:]:
            acc = acc + d[c]
        out.append(dequant_wire_np(quant_wire_np(acc, block), (chunk,)))
    return np.concatenate(out)[:L]


def dp_vector(rank, length):
    import numpy as np
    rng = np.random.RandomState(100 + rank)
    x = (rng.randn(length) * np.exp(rng.randn(length))).astype(np.float32)
    if rank == 1:
        x[3 * 256 + 5] = np.nan           # one NaN block
    return x


def dp_child(rank, store, out_dir):
    """One rank of phase 10 (spawned): join the gloo group, run (a)-(c)'s
    rank side, write this rank's results to ``out_dir``."""
    import math
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, DP_RANKS),
                            rank=rank, world_size=DP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.models import bert, lm
    from autodist_tpu_torch.parallel import collectives
    from autodist_tpu_torch.telemetry import spans as tel
    out = {"rank": rank, "bert": {}}
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    for wire in ("fp32", "int8"):
        steps = DP_STEPS[wire]
        # F.embedding's CUDA backward sums a repeated index's rows in a
        # varying order outside deterministic mode
        torch.use_deterministic_algorithms(wire == "fp32")
        runner = dp_runner(loss_fn, params, batch, wire_dtype=wire)
        dstep = runner.distributed_step
        reset_counts()
        sent = tel.counters().get("sync.wire_bytes", 0.0)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(runner.run(batch)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = launch_counts()
        check_launches("phase 10 bert_base %s wire, rank %d" % (wire, rank),
                       launches, cfg.num_layers, steps)
        if not all(math.isfinite(x) for x in losses):
            fail("phase 10: rank %d %s wire: a loss is not finite: %r"
                 % (rank, wire, losses))
        tables = [n for b in dstep.buckets for n in b.var_names
                  if n.endswith(".embedding")]
        out["bert"][wire] = {
            "losses": losses, "p50_ms": statistics.median(times) * 1e3,
            "times_ms": [t * 1e3 for t in times], "launches": launches,
            "wire_bytes_per_step": (tel.counters().get(
                "sync.wire_bytes", 0.0) - sent) / steps,
            "buckets": [(b.key, len(b.var_names), b.total_size)
                        for b in dstep.buckets],
            "tables_in_buckets": tables,
            "per_var_syncs": len(dstep.syncs) - sum(
                len(b.var_names) for b in dstep.buckets),
            "params_equal": ranks_equal(runner.gather_params()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del runner, dstep
        adt.reset()
    torch.use_deterministic_algorithms(False)
    del params
    torch.cuda.empty_cache()
    # (b) the int8 two-phase codec on CUDA, one bucket's length
    length = out["bert"]["int8"]["buckets"][0][2]
    xs = [dp_vector(r, length) for r in range(DP_RANKS)]
    got = collectives.int8_block_all_reduce(
        torch.from_numpy(xs[rank]).cuda(), None, DP_RANKS).cpu().numpy()
    want = two_phase_np(xs, collectives.wire_block_size())
    wire = collectives.quant_wire(torch.from_numpy(xs[rank]).cuda())
    mirror = collectives.quant_wire_np(xs[rank])
    out["codec"] = {
        "length": length,
        "two_phase_equal": bool(np.array_equal(got, want, equal_nan=True)),
        "nan_out": bool(np.isnan(got).any()),
        "quant_equal": bool(np.array_equal(wire["q"].cpu().numpy(),
                                           mirror["q"])
                            and np.array_equal(wire["s"].cpu().numpy(),
                                               mirror["s"], equal_nan=True))}
    # (c) lm1b f32, global batch 8, flash
    lcfg = lm.LMConfig.lm1b()
    loss_fn, params, batch, _ = lm.make_train_setup(
        lcfg, seq_len=TRAIN_SEQ, batch_size=8, seed=0, attention="flash",
        lean_head=True)
    runner = dp_runner(loss_fn, params, batch)
    out["lm1b"] = {"losses": [float(runner.run(batch)["loss"])
                              for _ in range(3)]}
    final = runner.gather_params()
    out["lm1b"]["params_equal"] = ranks_equal(final)
    if rank == 0:
        torch.save({n: t.cpu() for n, t in final.items()},
                   os.path.join(out_dir, "lm1b_2ranks.pt"))
    adt.reset()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def dp_phase(card):
    """Phase 10: N = 2 data parallelism, two ranks on cuda:0 over gloo.
    Returns each kernel's launches over both ranks' bert_base steps, and
    the fp32-wire losses."""
    import gc
    import tempfile
    import torch
    import torch.multiprocessing as mp
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.models import lm
    print("phase 10: N = %d data parallelism on cuda:0 over gloo: bert_base "
          "bf16 (seq %d, global batch %d) fp32 wire (%d steps, deterministic "
          "mode) then int8 wire (%d steps); the int8 two-phase codec; lm1b "
          "f32 (global batch 8) 2 ranks vs 1"
          % (DP_RANKS, BERT_SEQ, BERT_BATCH, DP_STEPS["fp32"],
             DP_STEPS["int8"]))
    # (c)'s one-rank reference, in this process, first
    cfg = lm.LMConfig.lm1b()
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=8, seed=0, attention="flash",
        lean_head=True)
    runner = build_runner(loss_fn, params, batch)
    one = ([float(runner.run(batch)["loss"]) for _ in range(3)],
           {n: t.cpu() for n, t in runner.gather_params().items()})
    del runner, params
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(dp_child, args=(os.path.join(tmp, "store"),
                                               tmp),
                               nprocs=DP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 10: a rank failed: %s" % (str(e).strip()[-2000:],))
        res = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
        two = (res[0]["lm1b"]["losses"],
               torch.load(os.path.join(tmp, "lm1b_2ranks.pt")))
    print("  two ranks ran in %.1f s" % (time.perf_counter() - t0))
    launches = {}
    for wire in ("fp32", "int8"):
        r0, r1 = (r["bert"][wire] for r in res)
        if r0["losses"] != r1["losses"]:
            fail("phase 10 %s wire: the ranks' losses differ: %r vs %r"
                 % (wire, r0["losses"], r1["losses"]))
        if not (r0["params_equal"] and r1["params_equal"]):
            fail("phase 10 %s wire: the ranks' params are not bit-equal"
                 % wire)
        if r0["tables_in_buckets"]:
            fail("phase 10 %s wire: embedding tables in a bucket: %r"
                 % (wire, r0["tables_in_buckets"]))
        want = 2 if wire == "int8" else 0
        if len(r0["buckets"]) != want:
            fail("phase 10 %s wire: %d buckets (want %d): %r"
                 % (wire, len(r0["buckets"]), want, r0["buckets"]))
        for r in (r0, r1):
            for name, by in r["launches"].items():
                for design, n in by.items():
                    launches.setdefault(name, {})
                    launches[name][design] = \
                        launches[name].get(design, 0) + n
        print("  bert_base %s wire: losses %s (both ranks), params "
              "bit-equal; step p50 %.1f / %.1f ms (ranks 0 / 1; steps %s "
              "ms), %.1f MB a step a rank handed to the collectives, %d "
              "buckets %r, %d per-variable syncs, peak %.2f GB a rank [%s]"
              % (wire, " ".join("%.4f" % x for x in r0["losses"]),
                 r0["p50_ms"], r1["p50_ms"],
                 " ".join("%.1f" % t for t in r0["times_ms"]),
                 r0["wire_bytes_per_step"] / 1e6, len(r0["buckets"]),
                 [(k, n) for k, n, _ in r0["buckets"]],
                 r0["per_var_syncs"], r0["peak_gb"], card))
    for r in res:
        codec = r["codec"]
        if not (codec["two_phase_equal"] and codec["quant_equal"]
                and codec["nan_out"]):
            fail("phase 10: rank %d: the int8 codec on CUDA disagrees with "
                 "its numpy mirror: %r" % (r["rank"], codec))
    print("  int8 two-phase all-reduce on CUDA over %d elements (one bucket, "
          "a NaN block): bit-equal to the numpy mirror on both ranks; "
          "quant_wire bit-equal to quant_wire_np" % res[0]["codec"]["length"])
    if res[0]["lm1b"]["losses"] != res[1]["lm1b"]["losses"] or not all(
            r["lm1b"]["params_equal"] for r in res):
        fail("phase 10 lm1b: the ranks disagree")
    print("  lm1b f32: 1 rank losses %s, 2 ranks %s"
          % (" ".join("%.6f" % x for x in one[0]),
             " ".join("%.6f" % x for x in two[0])))
    check_parity("phase 10 lm1b 2 ranks vs 1", {"1 rank": one,
                                                 "2 ranks": two}, 3)
    return launches, res[0]["bert"]["fp32"]["losses"]



# ------------------------------------------------------------- phase 11


RESUME_STEPS, RESUME_EVERY = 4, 2


def bert_batches(cfg, n, seed):
    """``n`` bert_base batches in the bench batch's format (all-ones mask,
    ``mlm_weights`` on 15% of the tokens), drawn from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    shape = (BERT_BATCH, BERT_SEQ)
    return [{"input_ids": rng.randint(0, cfg.vocab_size, shape).astype(
                np.int32),
             "token_type_ids": np.zeros(shape, np.int32),
             "attention_mask": np.ones(shape, np.int32),
             "labels": rng.randint(0, cfg.vocab_size, shape).astype(
                 np.int32),
             "mlm_weights": (rng.rand(*shape) < 0.15).astype(np.float32)}
            for _ in range(n)]


def state_copy(runner):
    """The runner's state, copied on the card: step, count, params, mu,
    nu."""
    st = runner.state
    return {"step": st.step, "count": int(st.opt_state["count"]),
            "params": {n: t.clone() for n, t in st.params.items()},
            "mu": {n: t.clone() for n, t in st.opt_state["mu"].items()},
            "nu": {n: t.clone() for n, t in st.opt_state["nu"].items()}}


def states_equal(label, got, want):
    """``torch.equal`` over every tensor of two :func:`state_copy`s, and
    the same step and count; fails naming every tensor that differs."""
    import torch
    if (got["step"], got["count"]) != (want["step"], want["count"]):
        fail("%s: step/count %r vs %r" % (label, (got["step"], got["count"]),
                                          (want["step"], want["count"])))
    differ = ["%s %s (max |diff| %.3e)" % (part, n, max_err(got[part][n], t))
              for part in ("params", "mu", "nu")
              for n, t in want[part].items()
              if not torch.equal(got[part][n], t)]
    if differ:
        fail("%s: %d tensors differ: %s" % (label, len(differ),
                                            "; ".join(differ[:10])))


def grad_repeats(loss_fn, params, batch):
    """The variables whose gradient differs between two runs of the same
    step (``torch.autograd.grad`` of the loss at ``params`` on ``batch``),
    with the largest difference: ``[(name, max |diff|)]``."""
    import torch
    leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
    device = next(iter(leaves.values())).device
    placed = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def grads():
        return torch.autograd.grad(loss_fn(leaves, placed),
                                   list(leaves.values()))
    with uncounted():
        a, b = grads(), grads()
    return [(n, max_err(x, y)) for n, x, y in zip(leaves, a, b)
            if not torch.equal(x, y)]


def resume_phase(card):
    """Phase 11: bert_base bf16 saved and resumed on the card. Returns
    each kernel's launches by design over the phase's steps (run A's 4
    and run B's 2)."""
    import subprocess
    import tempfile
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.telemetry import spans as tel
    print("phase 11: bert_base full width (bf16, seq %d, batch %d, flash) "
          "saved every %d of %d steps by Runner.fit, resumed by "
          "ADT_AUTO_RESUME and restore(ckpt-2)"
          % (BERT_SEQ, BERT_BATCH, RESUME_EVERY, RESUME_STEPS))
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    n_params = sum(int(p.numel()) for p in params.values())
    batches = bert_batches(cfg, RESUME_STEPS, seed=11)
    env = {k: os.environ.get(k) for k in ("ADT_CKPT_DIR", "ADT_AUTO_RESUME")}
    launches = {}

    def add_launches():
        for kern in kernels():
            by = launches.setdefault(kern.__name__, {})
            for design, n in kern.launches_by_variant.items():
                by[design] = by.get(design, 0) + n

    with tempfile.TemporaryDirectory() as ckdir:
        os.environ["ADT_CKPT_DIR"] = ckdir
        # F.embedding's CUDA backward sums the rows of a repeated index in
        # an order that varies from run to run (measured below), so the
        # bitwise comparison of runs A and B runs in PyTorch's
        # deterministic mode, which picks its deterministic kernel
        torch.use_deterministic_algorithms(True)
        try:
            # run A: 4 steps, the default async saver at steps 2 and 4
            runner = build_runner(loss_fn, params, batch)
            saved, losses, stamps = {}, [], []

            def on_step(i, metrics):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                losses.append(float(metrics["loss"]))
                if (i + 1) % RESUME_EVERY == 0:
                    saved[i + 1] = state_copy(runner)
            tel.configure("1")
            reset_counts()
            t0 = time.perf_counter()
            runner.fit(iter(batches), callbacks=[on_step],
                       save_every=RESUME_EVERY)
            fit_s = time.perf_counter() - t0
            add_launches()
            check_launches("phase 11 run A", launches, cfg.num_layers,
                           RESUME_STEPS)
            rec = tel.get_recorder()
            spans = {name: [d * 1e3 for d in rec.durations_s(name)]
                     for name in ("ckpt.gather", "ckpt.to_host", "ckpt.write",
                                  "ckpt.gc", "ckpt.wait")}
            save_hist = tel.histograms().get("ckpt.save_ms", {})
            tel.configure(None)
            metas = sorted(f for f in os.listdir(ckdir)
                           if f.endswith(".meta.json"))
            if metas != ["ckpt-2.meta.json", "ckpt-4.meta.json"]:
                fail("phase 11: fit(save_every=2) committed %r" % metas)
            for m in metas:
                with open(os.path.join(ckdir, m)) as f:
                    files = json.load(f)["files"]
                print("  %s: %s" % (m[:-len(".meta.json")], ", ".join(
                    "%s %d bytes" % (k.split(".", 1)[1], v["bytes"])
                    for k, v in sorted(files.items()))))
            write_ms = sum(spans["ckpt.write"]) + sum(spans["ckpt.gc"])
            sync_ms = sum(spans["ckpt.gather"]) + sum(spans["ckpt.to_host"])
            wait_ms = sum(spans["ckpt.wait"])
            print("  run A: losses %s; fit %.1f ms for %d steps (step ends "
                  "at %s ms); %d parameters"
                  % (" ".join("%.4f" % x for x in losses), fit_s * 1e3,
                     RESUME_STEPS, " ".join("%.1f" % ((t - t0) * 1e3)
                                            for t in stamps), n_params))
            print("  saves: in save() (gather + copy to the host in the JAX "
                  "layout) %s ms; background write + gc %s ms; ckpt.save_ms "
                  "count %s sum %.1f ms; the steps waited %s ms on the "
                  "writer: %.1f%% of the write hidden behind the steps [%s]"
                  % ([round(x, 1) for x in spans["ckpt.to_host"]],
                     [round(x, 1) for x in spans["ckpt.write"]],
                     save_hist.get("count"), save_hist.get("sum", 0.0),
                     [round(x, 1) for x in spans["ckpt.wait"]],
                     100 * (1 - wait_ms / max(write_ms, 1e-9)), card))
            if sync_ms <= 0 or write_ms <= 0:
                fail("phase 11: the save's spans were not recorded")
            out = subprocess.run(
                [sys.executable, "-m", "autodist_tpu_torch.checkpoint",
                 "fsck", "--dir", ckdir], capture_output=True, text=True,
                cwd=HERE, timeout=600)
            print("  fsck: exit %d: %s" % (out.returncode,
                                           out.stdout.strip().splitlines()
                                           [-1] if out.stdout else ""))
            if out.returncode != 0:
                fail("phase 11: fsck exited %d: %s" % (out.returncode,
                                                       out.stderr[-2000:]))
            del runner
            adt.reset()
            # run B: a new runner, resumed from the newest checkpoint by
            # ADT_AUTO_RESUME, then explicitly from ckpt-2
            os.environ["ADT_AUTO_RESUME"] = "1"
            t1 = time.perf_counter()
            runner = build_runner(loss_fn, params, batch)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
            states_equal("phase 11 auto-resume", state_copy(runner),
                         saved[4])
            t1 = time.perf_counter()
            Saver(ckdir).restore(runner, os.path.join(ckdir, "ckpt-2"))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            states_equal("phase 11 restore(ckpt-2)", state_copy(runner),
                         saved[2])
            reset_counts()
            again = [float(runner.run(b)["loss"])
                     for b in batches[RESUME_EVERY:]]
            add_launches()
            check_launches("phase 11 runs A and B", launches,
                           cfg.num_layers, RESUME_STEPS + len(again))
            if again != losses[RESUME_EVERY:]:
                fail("phase 11: steps 3-4 after the restore give losses %r, "
                     "the run without it %r" % (again,
                                                losses[RESUME_EVERY:]))
            states_equal("phase 11 steps 3-4 after the restore",
                         state_copy(runner), saved[4])
            print("  run B: ADT_AUTO_RESUME restored step 4 in %.1f ms "
                  "(build, init and read), restore(ckpt-2) %.1f ms, both "
                  "torch.equal to run A's state there; steps 3-4 losses %s "
                  "and state bit-equal to run A's (deterministic mode); "
                  "launches %r [%s]"
                  % (resume_s * 1e3, restore_s * 1e3,
                     " ".join("%.4f" % x for x in again), launches, card))
            # why the deterministic mode: one step's gradients, twice from
            # the same state, in the default mode and in deterministic mode
            for mode in (False, True):
                torch.use_deterministic_algorithms(mode)
                differ = grad_repeats(loss_fn, runner.state.params,
                                      batches[-1])
                print("  the same step's gradients twice, deterministic "
                      "mode %s: %d of %d variables differ %s"
                      % (mode, len(differ), len(params), differ))
                if mode and differ:
                    fail("phase 11: gradients differ in deterministic mode")
        finally:
            torch.use_deterministic_algorithms(False)
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            adt.reset()
    return launches


# ------------------------------------------------------------- phase 12


CNN_BATCH, CNN_STEPS = 64, 5
CNN_MODELS = (("vgg16", 224), ("inceptionv3", 299), ("densenet121", 224))
CNN_CLASSES = {"vgg16": "VGG16", "inceptionv3": "InceptionV3",
               "densenet121": "DenseNet121"}


def cnn_phase(card):
    """Phase 12: VGG16, InceptionV3 and DenseNet121 at full width, bf16
    convs, f32 params and BatchNorm, batch 64: 2 warm-up and 5 timed Adam
    steps each, BatchNorm statistics bit-equal after them, a device
    profile of 3 steps."""
    import gc
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import models
    from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
    from autodist_tpu_torch.models import cnn
    print("phase 12: the cnn family at full width (bf16 convs, f32 params "
          "and BatchNorm, batch %d) through AutoDist -> Runner.init -> "
          "Runner.run" % CNN_BATCH)
    for name, image in CNN_MODELS:
        t0 = time.perf_counter()
        loss_fn, params, batch, _ = models.make_train_setup(
            name, image_size=image, batch_size=CNN_BATCH,
            dtype=torch.bfloat16, seed=0)
        runner = build_runner(loss_fn, params, batch)
        torch.cuda.synchronize()
        stats = [n for n in params if n.startswith(BATCH_STATS_PREFIX)]
        n_params = sum(int(p.numel()) for n, p in params.items()
                       if n not in stats)
        print("  %s (image %d): %d parameters and %d BatchNorm statistics "
              "(random, seed 0), setup %.1f s" % (
                  name, image, n_params,
                  sum(int(params[n].numel()) for n in stats),
                  time.perf_counter() - t0))
        # Adam at 1e-3 on one random batch need not lower these models'
        # loss within 7 steps (VGG16's and InceptionV3's spike in their
        # first steps); finite losses are required
        times, launches = timed_steps(runner, batch, name,
                                      steps=CNN_STEPS, must_fall=False)
        if any(launches.values()):
            fail("%s launched a flash kernel: %r" % (name, launches))
        final = runner.gather_params()
        moved = [n for n in stats if not torch.equal(final[n].cpu(),
                                                     params[n])]
        if not stats or moved:
            fail("%s: BatchNorm statistics moved: %r" % (name, moved[:5]))
        frozen = [n for n in params if n not in stats
                  and torch.equal(final[n].cpu(), params[n])]
        if frozen:
            fail("%s: params did not move: %r" % (name, frozen[:5]))
        print("  %s: %d BatchNorm mean/var tensors bit-equal before and "
              "after the steps, every other variable moved"
              % (name, len(stats)))
        kw = {"image_size": image} if name == "vgg16" else {}
        with torch.device("meta"):
            model = getattr(cnn, CNN_CLASSES[name])(num_classes=1000, **kw)
        flops = 3 * CNN_BATCH * forward_flops_per_image(model, image)
        report_steps(name, times, CNN_BATCH, "images", flops, card,
                     launches)
        profile_steps(runner, batch, name)
        del runner, params, final
        adt.reset()
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 13


FUSE_K, FUSED_MICROSTEPS, METRICS_EVERY = 4, 16, 2
CNN_FUSED = (("inceptionv3", 299), ("densenet121", 224))


def device_trace(run):
    """Run ``run()`` under torch.profiler and return the device events of
    its trace, ``[(category, name, stream, start us, end us)]``: kernels,
    copies and fills."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["cat"], e.get("name", ""), e.get("args", {}).get("stream"),
             float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]


def trace_launches(events):
    """Each kernel's launches by design in a device trace (:func:
    `device_trace`), its CUDA functions matched by name."""
    import re
    counts = {kern.__name__: {} for kern in kernels()}
    for cat, name, _, _, _ in events:
        if cat != "kernel":
            continue
        for kern, pattern in DEVICE_FUNCTIONS.items():
            found = re.search(pattern, name)
            if found:
                design = ("mma.sync bf16" if found.group(1) else "scalar")
                counts[kern][design] = counts[kern].get(design, 0) + 1
    return counts


def merged(intervals):
    """The union of ``[(start, end)]`` as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(spans, union):
    """Time of ``spans`` that lies inside the disjoint ``union``."""
    total = 0.0
    for a, b in spans:
        for c, d in union:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def idle_share(run):
    """The device's idle share of the window of ``run()`` (wall clock),
    from a device trace; None when the profiler saw no device event."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = device_trace(run)
    window_us = (time.perf_counter() - t0) * 1e6
    if not events:
        return None, window_us / 1e3
    busy = sum(b - a for a, b in merged([(e[3], e[4]) for e in events]))
    span = max(e[4] for e in events) - min(e[3] for e in events)
    return 1 - busy / max(span, 1e-9), span / 1e3


def params_diff(got, want):
    """(max |diff|, mean |diff|, bit-equal) over two ``{name: tensor}``."""
    import torch
    worst, total, count, equal = 0.0, 0.0, 0, True
    for n, t in want.items():
        d = (got[n].float() - t.float()).abs()
        worst = max(worst, float(d.max()))
        total += float(d.double().sum())
        count += d.numel()
        equal = equal and torch.equal(got[n], t)
    return worst, total / max(count, 1), equal


def agree(label, got, want, steps, lr=1e-3):
    """Fused against per-step from one init: ``got``/``want`` =
    ``(losses, params)``. Bit-equal, or at phase 6's bounds (losses 1e-4
    relative, params 2 x steps x lr each and 1e-6 on average); prints
    which, with the largest difference."""
    (lf, pf), (lp, pp) = got, want
    worst, mean, equal = params_diff(pf, pp)
    loss_equal = lf == lp
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lf, lp))
    print("  %s: losses %s (max rel diff %.3e), params %s (max |diff| "
          "%.3e, mean %.3e)" % (
              label, "bit-equal" if loss_equal else "differ",
              loss_err, "bit-equal" if equal else "differ", worst, mean))
    if not (loss_equal and equal):
        if loss_err > 1e-4 or worst > 2 * steps * lr or mean > 1e-6:
            fail("%s: fused and per-step disagree beyond phase 6's bounds "
                 "(losses %r vs %r)" % (label, lf, lp))
    return loss_equal and equal


def host_params(runner):
    return {n: t.detach().clone() for n, t in
            runner.gather_params().items()}


def fused_text_phase(card):
    """Phase 13 (a): lm1b bf16 on the repository's docs through the native
    loader, the pinned prefetcher and fit(fuse_steps=4), against the same
    batches per step. Returns each kernel's launches by design over the
    fused run (replayed microsteps and the capture's warm-up), and each
    kernel's launches a microstep in a device trace of one more replay."""
    import math
    import tempfile
    import torch
    from autodist_tpu_torch.data import DevicePrefetcher, RecordFileDataset
    from autodist_tpu_torch.data import text
    from autodist_tpu_torch.data.prefetch import stack_batches
    from autodist_tpu_torch.models import lm
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0,
        attention="flash", lean_head=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "docs.adt")
        corpus = text.repo_docs_corpus(HERE)
        t0 = time.perf_counter()
        records = text.write_lm_records(corpus, path, TRAIN_SEQ)
        ds = RecordFileDataset(path, TRAIN_BATCH, shuffle=True, seed=0)
        print("  (a) %d files, %d bytes -> %d records of %d tokens; native "
              "loader built and opened in %.2f s" % (
                  len(corpus), sum(os.path.getsize(p) for p in corpus),
                  records, TRAIN_SEQ + 1, time.perf_counter() - t0))
        seen = []

        def source():
            for b in ds:
                seen.append(b)
                yield b
        runner = build_runner(loss_fn, params, batch)
        dstep = runner.distributed_step
        pf = DevicePrefetcher(source(), runner, depth=2, stack=FUSE_K)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = runner.fit(pf, steps=FUSED_MICROSTEPS, fuse_steps=FUSE_K,
                          metrics_every=METRICS_EVERY)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        fused_peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()
        fused = ([float(m["loss"]) for m in hist], host_params(runner))
        stats = runner.step_stats()
        fused_dispatches, fused_readbacks = dstep.dispatches, \
            runner.readbacks
        warm = dstep.warmup_microsteps
        ds.close()
        # one more superstep under a device trace: the replay's launches
        # counted by name on the card, not by the wrappers' bookkeeping
        # (which adds the capture's recording at every replay)
        traced = stack_batches(seen[:FUSE_K])
        reset_counts()
        on_card = trace_launches(device_trace(
            lambda: runner.run_superstep(traced, sync=True)))
        booked = launch_counts()
        if dstep.warmup_microsteps != warm:
            fail("phase 13 (a): the traced superstep captured a new graph")
    batches = seen[:FUSED_MICROSTEPS]
    adt_reset()
    runner = build_runner(loss_fn, params, batch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(runner.run(b)["loss"]) for b in batches]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    per_step = (losses, host_params(runner))
    print("  (a) fused: %d microsteps in %d dispatches, %d readbacks, "
          "supersteps %d / microsteps %d, %.2f s (capture included), peak "
          "memory %.2f GB; per step: %d dispatches, %d readbacks, %.2f s, "
          "peak %.2f GB" % (
              len(hist), fused_dispatches, fused_readbacks,
              stats["supersteps"], stats["microsteps"], fused_s,
              fused_peak / 1e9, runner.distributed_step.dispatches,
              runner.readbacks, step_s,
              torch.cuda.max_memory_allocated() / 1e9))
    print("  (a) losses fused %s" % " ".join("%.4f" % x for x in fused[0]))
    bitwise = agree("(a) lm1b fused vs per step", fused, per_step,
                    FUSED_MICROSTEPS)
    if not all(math.isfinite(x) for x in fused[0]) or \
            not fused[0][-1] < fused[0][0]:
        fail("phase 13 (a): losses not finite or not falling: %r"
             % (fused[0],))
    if len(hist) != FUSED_MICROSTEPS or \
            fused_dispatches != FUSED_MICROSTEPS // FUSE_K or \
            runner.distributed_step.dispatches != FUSED_MICROSTEPS:
        fail("phase 13 (a): %d microsteps in %d dispatches (want %d in %d)"
             % (len(hist), fused_dispatches, FUSED_MICROSTEPS,
                FUSED_MICROSTEPS // FUSE_K))
    want_readbacks = FUSED_MICROSTEPS // FUSE_K // METRICS_EVERY
    if fused_readbacks != want_readbacks or \
            runner.readbacks != FUSED_MICROSTEPS:
        fail("phase 13 (a): %d readbacks fused, %d per step (want %d, %d)"
             % (fused_readbacks, runner.readbacks, want_readbacks,
                FUSED_MICROSTEPS))
    if stats["supersteps"] != FUSED_MICROSTEPS // FUSE_K or \
            stats["microsteps"] != FUSED_MICROSTEPS:
        fail("phase 13 (a): step_stats %r" % (stats,))
    check_launches("phase 13 (a) fused lm1b", launches, cfg.num_layers,
                   FUSED_MICROSTEPS + warm)
    check_launches("phase 13 (a) traced replay, device trace", on_card,
                   cfg.num_layers, FUSE_K)
    check_launches("phase 13 (a) traced replay, wrappers' counts", booked,
                   cfg.num_layers, FUSE_K)
    per_microstep = {name: by[MAIN_DESIGN[name]] / FUSE_K
                     for name, by in on_card.items()}
    print("  (a) launches %r = %d a microstep x (%d replayed + %d warm-up "
          "microsteps); one traced replay of %d microsteps: %r on the card "
          "(kernels by name in the device trace), %r counted; fused vs per "
          "step %s [%s]" % (
              launches, cfg.num_layers, FUSED_MICROSTEPS, warm, FUSE_K,
              on_card, booked, "bit-equal" if bitwise else "within bounds",
              card))
    return launches, per_microstep


def adt_reset():
    import gc
    import torch
    import autodist_tpu_torch as adt
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()


def user_api_phase(card):
    """Phase 13 (b): bert_base bf16 through ad.function (3 steps) and
    create_distributed_session().run (3 more), against build + Runner.run
    from the same init, bit for bit in deterministic mode."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import bert
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    batches = bert_batches(cfg, 6, seed=13)
    opt = functools.partial(torch.optim.Adam, lr=1e-3)
    torch.use_deterministic_algorithms(True)
    try:
        adt_reset()
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
        step = ad.function(loss_fn, optimizer=opt, params=params)
        if step.get_runner() is not None:
            fail("phase 13 (b): ad.function built before its first call")
        losses = [float(step(b)["loss"]) for b in batches[:3]]
        session = ad.create_distributed_session()
        if session.state is not step.get_runner().state:
            fail("phase 13 (b): the session does not wrap the function's "
                 "runner")
        losses += [float(session.run(b)["loss"]) for b in batches[3:]]
        api = (losses, host_params(step.get_runner()))
        adt_reset()
        runner = build_runner(loss_fn, params, batch)
        plain = ([float(runner.run(b)["loss"]) for b in batches],
                 host_params(runner))
    finally:
        torch.use_deterministic_algorithms(False)
    print("  (b) ad.function x3 + session.run x3: losses %s"
          % " ".join("%.4f" % x for x in api[0]))
    if not agree("(b) user API vs build + run", api, plain, len(batches)):
        fail("phase 13 (b): the user API is not bit-equal to build + run "
             "in deterministic mode")
    adt_reset()


def step_fn_phase(card):
    """Phase 13 (c): a hand-written step on lm1b (its own Adam) through
    build_step and fit(fuse_steps=4), against its own per-step loop."""
    import numpy as np
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0,
        attention="flash", lean_head=True)
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8

    def step_fn(state, batch):
        p = {n: t.detach().requires_grad_() for n, t in
             state["params"].items()}
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        count = state["count"] + 1
        c1 = 1 - torch.full((), b1, device=count.device).pow(count.float())
        c2 = 1 - torch.full((), b2, device=count.device).pow(count.float())
        new = {"params": {}, "mu": {}, "nu": {}, "count": count}
        for (n, w), g in zip(state["params"].items(), grads):
            mu = b1 * state["mu"][n] + (1 - b1) * g
            nu = b2 * state["nu"][n] + (1 - b2) * g * g
            new["mu"][n], new["nu"][n] = mu, nu
            new["params"][n] = w - lr * (mu / c1) / ((nu / c2).sqrt() + eps)
        return new, {"loss": loss.detach()}

    state = {"params": params,
             "mu": {n: torch.zeros_like(t) for n, t in params.items()},
             "nu": {n: torch.zeros_like(t) for n, t in params.items()},
             "count": torch.zeros((), dtype=torch.int32)}
    rng = np.random.RandomState(17)
    batches = [{"tokens": rng.randint(0, cfg.vocab_size, (
        TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)} for _ in range(8)]
    got = {}
    for mode in ("fused", "per step"):
        adt_reset()
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
        runner = ad.build_step(step_fn, state, batch)
        runner.init(state)
        reset_counts()
        hist = runner.fit(iter(batches), fuse_steps=FUSE_K if
                          mode == "fused" else 1)
        final = runner.gather_params()
        got[mode] = ([float(m["loss"]) for m in hist],
                     {n: t.detach().clone()
                      for n, t in final["params"].items()})
        if mode == "fused":
            warm = runner.distributed_step.warmup_microsteps
            check_launches("phase 13 (c) step_fn fused",
                           launch_counts(), cfg.num_layers,
                           len(batches) + warm)
            if runner.distributed_step.dispatches != len(batches) // FUSE_K \
                    or int(final["count"]) != len(batches):
                fail("phase 13 (c): %d dispatches, count %d"
                     % (runner.distributed_step.dispatches,
                        int(final["count"])))
    print("  (c) step_fn losses fused %s"
          % " ".join("%.4f" % x for x in got["fused"][0]))
    agree("(c) step_fn fused vs per step", got["fused"], got["per step"],
          len(batches))
    adt_reset()


def cnn_fused_phase(card):
    """Phase 13 (d): InceptionV3 and DenseNet121 at batch 64, fused k = 4
    against the per-step loop, both on a batch already on the card: ms a
    microstep, the idle share of one superstep (or step) in a device
    trace, peak memory, BatchNorm statistics bit-equal, losses at the
    bf16 bound."""
    import statistics
    import torch
    from autodist_tpu_torch import models
    from autodist_tpu_torch.data.prefetch import stack_batches
    from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
    out = {}
    for name, image in CNN_FUSED:
        loss_fn, params, batch, _ = models.make_train_setup(
            name, image_size=image, batch_size=CNN_BATCH,
            dtype=torch.bfloat16, seed=0)
        stats = [n for n in params if n.startswith(BATCH_STATS_PREFIX)]
        row = {}
        for mode in ("per step", "fused"):
            adt_reset()
            runner = build_runner(loss_fn, params, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if mode == "fused":
                feed = runner.remapper.remap_feed_stack(
                    stack_batches([batch] * FUSE_K))

                def one():
                    return runner.run_superstep(feed, sync=True)["loss"]
                per = FUSE_K
            else:
                feed = runner.remapper.remap_feed(batch)

                def one():
                    return [runner.run(feed)["loss"]]
                per = 1
            losses, times = [], []
            for _ in range(2 + 3):        # 2 warm-up (or capture) calls
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses += [float(x) for x in one()]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / per)
            times = times[2:]
            peak = torch.cuda.max_memory_allocated()
            idle, window = idle_share(one)
            final = runner.gather_params()
            moved = [n for n in stats
                     if not torch.equal(final[n].cpu(), params[n])]
            if moved:
                fail("phase 13 (d) %s %s: BatchNorm statistics moved: %r"
                     % (name, mode, moved[:5]))
            row[mode] = losses
            p50 = statistics.median(times) * 1e3
            print("  (d) %s %s: %.2f ms a microstep p50 (min %.2f, max "
                  "%.2f), idle %s of one %s (%.1f ms), peak memory %.2f "
                  "GB [%s]" % (
                      name, mode, p50, min(times) * 1e3, max(times) * 1e3,
                      "not measured" if idle is None else
                      "%.1f%%" % (100 * idle),
                      "superstep" if mode == "fused" else "step", window,
                      peak / 1e9, card))
            out["%s %s" % (name, mode)] = p50
            del runner, feed, final
        lp = row["per step"]
        lf = row["fused"][:len(lp)]
        err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lf, lp))
        print("  (d) %s: the first %d losses fused vs per step, max rel "
              "diff %.3e (bound 2e-2), BatchNorm statistics bit-equal"
              % (name, len(lp), err))
        if not all(abs(a - b) <= 2e-2 * abs(b) for a, b in zip(lf, lp)):
            fail("phase 13 (d) %s: fused losses %r vs per step %r"
                 % (name, lf, lp))
    adt_reset()
    return out


def prefetch_phase(card):
    """Phase 13 (e): resnet50 at batch 256 fed through DevicePrefetcher
    (pinned, side stream) against the pageable feed, 6 steps of
    ``fit(metrics_every=6)`` each: each feed's host-to-device copies,
    their streams, their share of device time and the share of copy time
    that overlaps kernels on another stream."""
    import numpy as np
    import torch
    from autodist_tpu_torch.data import DevicePrefetcher
    from autodist_tpu_torch.models import resnet
    loss_fn, params, batch, _ = resnet.make_train_setup(
        resnet.ResNet50, image_size=RESNET_IMAGE, batch_size=RESNET_BATCH,
        dtype=torch.bfloat16, seed=0)
    rng = np.random.RandomState(5)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    hosts = [{"image": rng.standard_normal(shape).astype(np.float32),
              "label": rng.randint(0, 1000, (RESNET_BATCH,)).astype(
                  np.int32)} for _ in range(2)]
    adt_reset()
    runner = build_runner(loss_fn, params, batch)
    for h in hosts:
        runner.run(h)                     # warm-up
    # fit with metrics_every > 1 dispatches without reading back between
    # steps, so the host runs ahead and the prefetcher's next copy is
    # queued while the card computes the current step
    feeds = {
        "pageable": lambda: runner.fit(iter(hosts * 3), metrics_every=6),
        "pinned prefetcher": lambda: runner.fit(DevicePrefetcher(
            iter(hosts * 3), runner, depth=2), metrics_every=6)}
    for label, run in feeds.items():
        events = device_trace(run)
        copies = [e for e in events
                  if e[0] == "gpu_memcpy" and "HtoD" in e[1]]
        kernels_ = [e for e in events if e[0] == "kernel"]
        if not events or not copies:
            fail("phase 13 (e) %s: the trace shows no host-to-device copy"
                 % label)
        busy = merged([(e[3], e[4]) for e in events])
        busy_us = sum(b - a for a, b in busy)
        copy_us = sum(e[4] - e[3] for e in copies)
        copy_streams = sorted({e[2] for e in copies if e[4] - e[3] > 100})
        kernel_streams = sorted({e[2] for e in kernels_})
        other = merged([(e[3], e[4]) for e in kernels_
                        if e[2] not in copy_streams])
        big = [(e[3], e[4]) for e in copies if e[4] - e[3] > 100]
        hidden = overlap_us(big, other) / max(sum(b - a for a, b in big),
                                               1e-9)
        print("  (e) resnet50 %s: %d host-to-device copies (%s), %.2f ms "
              "= %.2f%% of device time; the large ones on stream(s) %s, "
              "kernels on %s; %.1f%% of the large copies' time overlaps "
              "kernels on another stream [%s]" % (
                  label, len(copies), ", ".join(sorted({e[1] for e in
                                                        copies})),
                  copy_us / 1e3, 100 * copy_us / busy_us, copy_streams,
                  kernel_streams, 100 * hidden, card))
        if label != "pageable":
            if set(copy_streams) & set(kernel_streams) or not copy_streams:
                fail("phase 13 (e): the prefetcher's copies run on the "
                     "kernels' stream")
            if hidden <= 0:
                fail("phase 13 (e): the prefetcher's copies overlap no "
                     "kernel")
    adt_reset()


def fused_phase(card):
    """Phase 13: the user API, fused supersteps as one CUDA graph and the
    input plane. Returns (a)'s launches and its launches a microstep
    under replay."""
    print("phase 13: (a) lm1b bf16 (seq %d, batch %d, flash, lean head) on "
          "the repository's docs: RecordFileDataset -> DevicePrefetcher("
          "stack=%d) -> fit(fuse_steps=%d, metrics_every=%d), %d "
          "microsteps, vs the same batches per step; (b) bert_base bf16 "
          "through ad.function and create_distributed_session; (c) "
          "build_step on lm1b fused; (d) InceptionV3 and DenseNet121 fused; "
          "(e) resnet50 through the pinned prefetcher"
          % (TRAIN_SEQ, TRAIN_BATCH, FUSE_K, FUSE_K, METRICS_EVERY,
             FUSED_MICROSTEPS))
    launches, per_microstep = fused_text_phase(card)
    user_api_phase(card)
    step_fn_phase(card)
    cnn_fused_phase(card)
    prefetch_phase(card)
    return launches, per_microstep


# ------------------------------------------------------------- phase 14


SYNC_STEPS = 2
# test_zero_sharded.py's bounds for ZeroSharded against AllReduce
SYNC_LOSS_RTOL, SYNC_PARAM_RTOL, SYNC_ATOL = 1e-4, 1e-5, 1e-6
# ZeroSharded(int8) against AllReduce: the losses' relative gap, and the
# update error over the ZeRO variables (update_error; 1.0 for an update
# that applied nothing). About twice to four times the readings on an
# H100 (5.1e-5 and 0.114, PERF.md §6).
INT8_LOSS_RTOL, INT8_UPDATE_ERR = 2e-4, 0.2


def sync_runner(loss_fn, params, batch, builder):
    """Build -> init through the public entry points on ``cuda:0``, one
    replica of the process group's DP_RANKS, under ``builder``."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(strategy_builder=builder,
                      resource_spec=ResourceSpec.from_dict(DP_SPEC),
                      device="cuda:0")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner


def nbytes(tensors):
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def moment_bytes(runner):
    """This rank's Adam moment bytes by variable: the device optimizer
    tree's and ``sync_state['zero']``'s shards."""
    st = runner.state
    out = {}
    for slot in ("mu", "nu"):
        for n, t in st.opt_state[slot].items():
            out[n] = out.get(n, 0) + nbytes([t])
        for n, little in st.sync_state.get("zero", {}).items():
            out[n] = out.get(n, 0) + nbytes([little[slot]["v"]])
    return out


def close_to(got, want, rtol, atol=SYNC_ATOL):
    """The largest |got - want| - (atol + rtol |want|) over two params
    trees on the card (<= 0: allclose)."""
    return max(float(((got[n] - w).abs() - atol - rtol * w.abs()).max())
               for n, w in want.items())


def update_error(got, want, init, names):
    """||got - want|| / ||want - init|| over the variables ``names``: how
    far one run's parameters lie from a reference run's, in units of the
    reference's own update from the common init."""
    import math
    num = den = 0.0
    for n in names:
        w = want[n].double()
        num += float((got[n].double() - w).pow(2).sum())
        den += float((w - init[n].to(w.device).double()).pow(2).sum())
    return math.sqrt(num / den)


def sync_child(rank, store, out_dir):
    """One rank of phase 14 (a)-(c) (spawned): join the gloo group, train
    bert_base under each plan from the same init and batches in
    deterministic mode, and write this rank's results to ``out_dir``."""
    import math
    import statistics
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store, DP_RANKS),
                            rank=rank, world_size=DP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.telemetry import spans as tel
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    batches = bert_batches(cfg, SYNC_STEPS, seed=14)
    plans = (("allreduce", strategy.AllReduce()),
             ("zero", strategy.ZeroSharded()),
             ("zero_int8", strategy.ZeroSharded(wire_dtype="int8")),
             ("partitioned", strategy.PartitionedAR()),
             ("overlap", strategy.AllReduce(overlap=True)))
    out, ref = {"rank": rank, "launches": {}}, None
    for label, builder in plans:
        runner = sync_runner(loss_fn, params, batch, builder)
        dstep = runner.distributed_step
        meta = dstep.metadata
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = dict(tel.counters())
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            losses.append(float(runner.run(b)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not all(math.isfinite(x) for x in losses):
            fail("phase 14 %s: rank %d: a loss is not finite: %r"
                 % (label, rank, losses))
        launches = launch_counts()
        check_launches("phase 14 %s, rank %d" % (label, rank), launches,
                       cfg.num_layers, SYNC_STEPS)
        for name, by in launches.items():
            for design, n in by.items():
                slot = out["launches"].setdefault(name, {})
                slot[design] = slot.get(design, 0) + n
        after = tel.counters()
        final = runner.gather_params()
        res = {"losses": losses, "p50_ms": statistics.median(times) * 1e3,
               "times_ms": [t * 1e3 for t in times],
               "params_equal": ranks_equal(final),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "layout_ok": all(tuple(final[n].shape) == tuple(t.shape)
                                for n, t in params.items()),
               "rs_bytes": after.get("zero.rs_bytes", 0.0)
               - before.get("zero.rs_bytes", 0.0),
               "ag_bytes": after.get("zero.ag_bytes", 0.0)
               - before.get("zero.ag_bytes", 0.0)}
        sharded = set(meta["zero_sharded"]) | set(meta["partitioned"])
        res["moments"] = moment_bytes(runner)
        res["param_bytes_sharded"] = nbytes(
            [runner.state.params[n] for n in sharded])
        res["param_bytes_full"] = nbytes([params[n].float()
                                          for n in sharded])
        res["sharded"] = sorted(sharded)
        # the JAX formula (zero_synchronizer.py): each ZeRO variable's
        # padded flat payload, 4 bytes an element on the fp32 wire, the
        # int8 body + one f32 scale a 256-element block on the int8 wire
        formula = 0
        for n in meta["zero_sharded"]:
            elems = int(params[n].numel())
            shard = -(-elems // DP_RANKS)
            if n in meta["zero_wire_int8"]:
                shard = -(-shard // 256) * 256
                formula += shard * DP_RANKS + shard * DP_RANKS // 256 * 4
            else:
                formula += shard * DP_RANKS * 4
        res["formula_bytes"] = formula
        res["zero_meta"] = [meta["zero_rs_bytes_per_step"],
                            meta["zero_ag_bytes_per_step"],
                            meta["zero_hbm_saved_bytes"]]
        if label == "allreduce":
            ref = {n: t.clone() for n, t in final.items()}
            res["vs_allreduce"] = 0.0
            res["bit_equal"] = True
        else:
            res["vs_allreduce"] = close_to(final, ref, SYNC_PARAM_RTOL)
            res["bit_equal"] = all(torch.equal(final[n], t)
                                   for n, t in ref.items())
            if meta["zero_sharded"]:
                res["update_err"] = update_error(final, ref, params,
                                                 meta["zero_sharded"])
        if label == "overlap":
            res["stages"] = meta["overlap_stages"]
            res["schedule"] = meta["overlap_schedule"].splitlines()
            res["launch_log"] = [list(x) for x in dstep.overlap_log]
        out[label] = res
        del runner, dstep, final
        adt.reset()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "sync%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def sync_phase(card):
    """Phase 14 (a)-(c): ZeroSharded, PartitionedAR and the overlapped
    schedule at N = 2, two ranks on cuda:0 over gloo. Returns each
    kernel's launches over both ranks' steps."""
    import tempfile
    import torch.multiprocessing as mp
    print("phase 14 (a)-(c): N = %d on cuda:0 over gloo, bert_base bf16 "
          "(seq %d, global batch %d, flash), %d steps of each plan from one "
          "init, deterministic mode: AllReduce, ZeroSharded, "
          "ZeroSharded(int8), PartitionedAR, AllReduce(overlap=True) (run "
          "beside phase 10)"
          % (DP_RANKS, BERT_SEQ, BERT_BATCH, SYNC_STEPS))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(sync_child, args=(os.path.join(tmp, "store"),
                                                 tmp),
                               nprocs=DP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 14: a rank failed: %s" % (str(e).strip()[-2000:],))
        res = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, "sync%d.json" % r)) as f:
                res.append(json.load(f))
    print("  two ranks ran in %.1f s" % (time.perf_counter() - t0))
    r0 = res[0]
    ar = r0["allreduce"]
    for label in ("allreduce", "zero", "zero_int8", "partitioned",
                  "overlap"):
        a, b = (r[label] for r in res)
        if a["losses"] != b["losses"] or not (a["params_equal"]
                                              and b["params_equal"]):
            fail("phase 14 %s: the ranks disagree (losses %r vs %r)"
                 % (label, a["losses"], b["losses"]))
        print("  %-11s losses %s (both ranks, params torch.equal), step p50 "
              "%.1f ms (steps %s ms), peak %.2f GB a rank [%s]"
              % (label, " ".join("%.6f" % x for x in a["losses"]),
                 a["p50_ms"], " ".join("%.1f" % t for t in a["times_ms"]),
                 a["peak_gb"], card))
    for label in ("zero", "partitioned"):
        got = r0[label]
        for x, y in zip(got["losses"], ar["losses"]):
            if abs(x - y) > SYNC_ATOL + SYNC_LOSS_RTOL * abs(y):
                fail("phase 14 %s: losses %r vs AllReduce's %r"
                     % (label, got["losses"], ar["losses"]))
        if got["vs_allreduce"] > 0:
            fail("phase 14 %s: params beyond rtol %.0e of AllReduce's "
                 "(excess %.3e)" % (label, SYNC_PARAM_RTOL,
                                    got["vs_allreduce"]))
        if not got["layout_ok"]:
            fail("phase 14 %s: gather_params is not in the original layout"
                 % label)
        print("  %s vs AllReduce: losses within %.0e, params within rtol "
              "%.0e (bit-equal: %s)" % (label, SYNC_LOSS_RTOL,
                                        SYNC_PARAM_RTOL, got["bit_equal"]))
    # (a) the optimizer state a rank holds, and the wire bytes
    zero = r0["zero"]
    names = set(zero["sharded"])

    def split(moments):
        mine = sum(b for n, b in moments.items() if n in names)
        return mine, sum(moments.values()) - mine
    z_mine, z_rest = split(zero["moments"])
    a_mine, a_rest = split(ar["moments"])
    # each variable's shard pads its flat length to an even one
    if not a_mine / 2 <= z_mine <= a_mine / 2 + 2 * 4 * len(names) \
            or z_rest != a_rest:
        fail("phase 14 (a): the ZeRO variables' moments take %d bytes a "
             "rank (AllReduce's %d), the rest %d (AllReduce's %d)"
             % (z_mine, a_mine, z_rest, a_rest))
    tables = sorted(n for n in ar["moments"] if n not in names)
    print("  (a) Adam moments a rank: ZeroSharded %.1f MB for its %d "
          "sharded variables + %.1f MB for the %d it keeps whole (%s); "
          "AllReduce %.1f MB + %.1f MB [%s]"
          % (z_mine / 1e6, len(names), z_rest / 1e6, len(tables),
             ", ".join(tables), a_mine / 1e6, a_rest / 1e6, card))
    for label in ("zero", "zero_int8"):
        got = r0[label]
        rs, ag = got["rs_bytes"] / SYNC_STEPS, got["ag_bytes"] / SYNC_STEPS
        if not rs == ag == got["formula_bytes"]:
            fail("phase 14 %s: zero.rs_bytes %r / zero.ag_bytes %r a step, "
                 "the formula gives %r" % (label, rs, ag,
                                           got["formula_bytes"]))
        print("  (a) %s: zero.rs_bytes = zero.ag_bytes = %.1f MB a step a "
              "rank (the JAX formula: %.1f MB); zero_hbm_saved_bytes %.1f "
              "MB" % (label, rs / 1e6, got["formula_bytes"] / 1e6,
                      got["zero_meta"][2] / 1e6))
    i8 = r0["zero_int8"]
    worst = max(abs(x - y) / abs(y)
                for x, y in zip(i8["losses"], ar["losses"]))
    if worst > INT8_LOSS_RTOL or not i8["update_err"] <= INT8_UPDATE_ERR:
        fail("phase 14 (a): the int8 ZeRO wire left the fp32 trajectory: "
             "losses %r vs %r (%.3e relative, bound %.0e), update error "
             "%.4f over the ZeRO variables (bound %.2f)"
             % (i8["losses"], ar["losses"], worst, INT8_LOSS_RTOL,
                i8["update_err"], INT8_UPDATE_ERR))
    print("  (a) ZeroSharded(int8) vs AllReduce: losses within %.3e "
          "relative (bound %.0e); update error over the %d ZeRO variables "
          "%.4f (bound %.2f; fp32 ZeRO %.4f; an update that applied nothing "
          "gives 1) [%s]"
          % (worst, INT8_LOSS_RTOL, len(names), i8["update_err"],
             INT8_UPDATE_ERR, zero["update_err"], card))
    # (b) the partitioned layouts' storage
    part = r0["partitioned"]
    full_p = part["param_bytes_full"]
    if not full_p / 2 <= part["param_bytes_sharded"] <= full_p / 2 * 1.01:
        fail("phase 14 (b): partitioned params take %d of %d bytes a rank"
             % (part["param_bytes_sharded"], full_p))
    p_mom = sum(b for n, b in part["moments"].items()
                if n in part["sharded"])
    if not full_p <= p_mom <= full_p * 1.01:
        fail("phase 14 (b): partitioned moments take %d bytes a rank (want "
             "half of %d)" % (p_mom, 2 * full_p))
    print("  (b) PartitionedAR: %d variables partitioned; a rank stores "
          "%.1f of their %.1f MB of params and %.1f of their %.1f MB of "
          "moments; gather_params in the original layout [%s]"
          % (len(part["sharded"]), part["param_bytes_sharded"] / 1e6,
             full_p / 1e6, p_mom / 1e6, 2 * full_p / 1e6, card))
    # (c) the overlapped schedule
    ov = r0["overlap"]
    if not ov["bit_equal"] or ov["losses"] != ar["losses"]:
        fail("phase 14 (c): overlap=True is not bit-equal to the epilogue")
    if ov["stages"] < 2:
        fail("phase 14 (c): %d overlap stages" % ov["stages"])
    during = sum(1 for _, d in ov["launch_log"] if d)
    order = [u for u, _ in ov["launch_log"]]
    print("  (c) overlap=True bit-equal to the epilogue; %d stages, %d "
          "launched during the backward of the last step; launch order: %s"
          " ... %s" % (ov["stages"], during, ", ".join(order[:8]),
                       ", ".join(order[-3:])))
    print("  (c) step p50 overlap %.1f ms vs epilogue %.1f ms [%s]"
          % (ov["p50_ms"], ar["p50_ms"], card))
    launches = {}
    for r in res:
        for name, by in r["launches"].items():
            for design, n in by.items():
                launches.setdefault(name, {})
                launches[name][design] = launches[name].get(design, 0) + n
    return launches


TIER_WARMUP, TIER_STEPS = 2, 4


def tier_phase(card):
    """Phase 14 (d): lm1b full width in its f32 config under the bf16
    compute tier against f32, one replica. Returns each kernel's launches
    over the tier run's steps."""
    import statistics
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    print("phase 14 (d): lm1b full width, f32 config (seq %d, batch %d, "
          "flash, lean head): AllReduce(compute_dtype='bf16') vs "
          "AllReduce(), %d + %d steps each from one init"
          % (TRAIN_SEQ, TRAIN_BATCH, TIER_WARMUP, TIER_STEPS))
    cfg = lm.LMConfig.lm1b()
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0,
        attention="flash", lean_head=True)
    got = {}
    for label, builder in (("bf16", strategy.AllReduce(compute_dtype="bf16")),
                           ("f32", strategy.AllReduce())):
        adt_reset()
        ad = adt.AutoDist(strategy_builder=builder)
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-3), params, batch)
        runner.init(params)
        losses = []
        times, launches = timed_steps(runner, batch, "lm1b %s" % label,
                                      warmup=TIER_WARMUP, steps=TIER_STEPS,
                                      losses_out=losses)
        # the tier rounds the params to bf16 and the f32 config computes
        # in f32, as flax's Dense(dtype=float32) does in the JAX package:
        # the kernels see f32 inputs and run their f32 design
        check_launches("phase 14 (d) %s" % label, launches, cfg.num_layers,
                       TIER_WARMUP + TIER_STEPS, design="scalar f32")
        meta = runner.distributed_step.metadata
        if meta["compute_dtype"] != label:
            fail("phase 14 (d): the runner lowered compute_dtype %r"
                 % meta["compute_dtype"])
        final = losses[-1]
        got[label] = (final, times, launches)
        print("  %s: step p50 %.2f ms (min %.2f, max %.2f) over %d steps, "
              "final loss %.6f, peak %.2f GB [%s]"
              % (label, statistics.median(times) * 1e3, min(times) * 1e3,
                 max(times) * 1e3, len(times), final,
                 torch.cuda.max_memory_allocated() / 1e9, card))
        del runner
    adt_reset()
    b, f = got["bf16"][0], got["f32"][0]
    if abs(b - f) > 0.05 * abs(f):
        fail("phase 14 (d): final losses %.6f (bf16) vs %.6f (f32) beyond "
             "5%%" % (b, f))
    print("  final losses within %.3f%% (bound 5%%, bench.py's "
          "ADT_BENCH_BF16_TOL)" % (100 * abs(b - f) / abs(f)))
    return got["bf16"][2]


def remat_phase(card):
    """Phase 14 (e): bert_base bf16 at phase 7's shape under WithRemat
    "full" and "dots" against plain, deterministic mode. Returns each
    kernel's launches over the remat runs' steps."""
    import statistics
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import bert
    print("phase 14 (e): bert_base bf16 (seq %d, batch %d, flash), "
          "WithRemat(AllReduce(), 'full' / 'dots') vs AllReduce(), %d steps "
          "each from one init, deterministic mode"
          % (BERT_SEQ, BERT_BATCH, SYNC_STEPS))
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    batches = bert_batches(cfg, SYNC_STEPS, seed=15)
    got, launches = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, builder in (
                ("plain", strategy.AllReduce()),
                ("full", strategy.WithRemat(strategy.AllReduce(), "full")),
                ("dots", strategy.WithRemat(strategy.AllReduce(), "dots"))):
            adt_reset()
            held = torch.cuda.memory_allocated() / 1e9
            ad = adt.AutoDist(strategy_builder=builder)
            runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                         lr=1e-3),
                              params, batch)
            runner.init(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            losses, times = [], []
            for b in batches:
                t0 = time.perf_counter()
                losses.append(float(runner.run(b)["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            got[label] = (losses, host_params(runner), peak, counts)
            print("  %-5s losses %s, peak %.2f GB (%.2f GB of it held "
                  "before the runner was built), step p50 %.1f ms (steps "
                  "%s ms, the first builds), launches a step %s [%s]"
                  % (label, " ".join("%.6f" % x for x in losses), peak,
                     held, statistics.median(times),
                     " ".join("%.1f" % t for t in times), {n: {d: c / len(batches)
                                      for d, c in by.items()}
                                  for n, by in counts.items()}, card))
            if label != "plain":
                for name, by in counts.items():
                    for design, n in by.items():
                        slot = launches.setdefault(name, {})
                        slot[design] = slot.get(design, 0) + n
            del runner
    finally:
        torch.use_deterministic_algorithms(False)
    adt_reset()
    plain = got["plain"]
    for label in ("full", "dots"):
        losses, final, peak, counts = got[label]
        worst, _, equal = params_diff(final, plain[1])
        if losses != plain[0] or not equal:
            fail("phase 14 (e): remat %s is not bit-equal to plain (losses "
                 "%r vs %r, params max |diff| %.3e)"
                 % (label, losses, plain[0], worst))
        if not peak < plain[2]:
            fail("phase 14 (e): remat %s peak %.2f GB is not below plain's "
                 "%.2f GB" % (label, peak, plain[2]))
        for name, by in counts.items():
            per = 2 if name == "flash_fwd" else 1
            if label == "full" and by != {
                    MAIN_DESIGN[name]: per * cfg.num_layers * SYNC_STEPS}:
                fail("phase 14 (e): remat full: %s launched %r over %d "
                     "steps (want %d a step: the recomputed forward runs the "
                     "forward kernel again)" % (name, by, SYNC_STEPS,
                                                per * cfg.num_layers))
    return launches


def sync_variants_phase(card, sync_ac):
    """Phase 14: the sync variants (``sync_ac``, the :class:`Beside` of
    :func:`sync_phase`, started beside phase 10), the bf16 compute tier
    and remat. Returns each kernel's launches over (a)-(c), (d) and
    (e)."""
    return sync_ac.result(), tier_phase(card), remat_phase(card)


# ------------------------------------------------------------- phase 15


PS_WARMUP, PS_STEPS = 2, 5
PS_BATCH = 256
PS_PARITY_STEPS = 3
PS_LOSS_RTOL = 1e-5
# Adam moves an element whose gradient is 0 in one run and rounding noise
# in the other by up to lr a step (tests/test_torch_train.py)
PS_PARAM_DRIFT = 2 * PS_PARITY_STEPS * 1e-3
PS_SPANS = ("ps.pull", "ps.push", "ps.apply")


def ps_runner(loss_fn, params, batch, builder, optimizer=None):
    """Build -> init through the public entry points on the card under
    ``builder``, with ``optimizer`` (default Adam at 1e-3)."""
    import torch
    import autodist_tpu_torch as adt
    adt_reset()
    ad = adt.AutoDist(strategy_builder=builder)
    runner = ad.build(loss_fn, optimizer or functools.partial(
        torch.optim.Adam, lr=1e-3), params, batch)
    runner.init(params)
    return runner


def ps_plan_bytes(dstep, rows):
    """(bytes a pull, bytes a push) the plan gives at ``rows`` ids a lookup
    a step: every host-PS variable whole in f32; a push carries each
    sparse-wire table's (ids, values) pairs — an int32 id and ``features``
    f32 values a row — and every other host-PS variable's whole f32
    gradient."""
    infos = dstep.model_item.var_infos
    pull = push = 0
    for n in dstep.ps_store.var_names:
        info = infos[n]
        pull += info.byte_size
        if n in dstep.sparse_wire:
            feat = info.num_elements // info.shape[0]
            push += rows * (4 + 4 * feat)
        else:
            push += info.byte_size
    return pull, push


def span_totals():
    """Each host-PS span's (count, total seconds) recorded so far."""
    from autodist_tpu_torch.telemetry import spans as tel
    summary = tel.get_recorder().summary()
    return {n: (summary.get(n, {}).get("count", 0),
                summary.get(n, {}).get("total_s", 0.0)) for n in PS_SPANS}


def ps_readings(label, runner, batch, card, items, rows=None,
                must_fall=True, unit="examples"):
    """PS_WARMUP + PS_STEPS steps of a host-PS runner, each ended by a
    sync, then a device profile of 3 more. Gates: every loss finite and
    (``must_fall``) the last below the first; the host-PS variables and
    their moments absent from the device state; the store's values
    (``resident_bytes``, which counts values only, as the JAX store's
    does) and both moments (counted from its per-shard states) resident;
    with ``rows`` (ids a lookup a step), the
    bytes a pull and a push equal to the plan's (:func:`ps_plan_bytes`).
    Prints step p50 (min-max), examples/s, each PS span's ms a step, the
    bytes a step, peak HBM and the device's idle share. Returns (the
    p50 in ms, the kernels' launches by design, the losses)."""
    import math
    import statistics
    import torch
    dstep = runner.distributed_step
    store = dstep.ps_store
    names = set(store.var_names)
    st = runner.state
    leaked = names & (set(st.params) | set(st.opt_state["mu"])
                      | set(st.opt_state["nu"]))
    if leaked:
        fail("%s: host-PS variables on the device: %s" % (label,
                                                          sorted(leaked)))
    values = sum(dstep.model_item.var_infos[n].byte_size for n in names)
    if store.resident_bytes() != values:
        fail("%s: the store reports %d B of values resident, not %d B"
             % (label, store.resident_bytes(), values))
    # the moments, counted from the store's per-shard states
    moments = sum(int(st[slot]["v"].numel() * st[slot]["v"].element_size())
                  for n in names for st in store._opt[n]
                  for slot in ("mu", "nu"))
    if moments != 2 * values:
        fail("%s: the store holds %d B of moments, not 2 x %d B"
             % (label, moments, values))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(PS_WARMUP + PS_STEPS):
        if i == PS_WARMUP:
            dstep.flush_ps()
            stats0, spans0 = dict(store.stats), span_totals()
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dstep.flush_ps()
    launches = launch_counts()
    stats1, spans1 = dict(store.stats), span_totals()
    times = times[PS_WARMUP:]
    print("  losses: %s" % " ".join("%.5f" % x for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail("%s: a loss is not finite: %r" % (label, losses))
    if must_fall and not losses[-1] < losses[0]:
        fail("%s: the loss did not fall (%.5f -> %.5f)"
             % (label, losses[0], losses[-1]))
    pulls = stats1["pulls"] - stats0["pulls"]
    pushes = stats1["pushes"] - stats0["pushes"]
    if pulls != PS_STEPS or pushes != PS_STEPS:
        fail("%s: %d pulls and %d pushes over %d steps"
             % (label, pulls, pushes, PS_STEPS))
    pulled = (stats1["bytes_pulled"] - stats0["bytes_pulled"]) / pulls
    pushed = (stats1["bytes_pushed"] - stats0["bytes_pushed"]) / pushes
    if rows is not None:
        want = ps_plan_bytes(dstep, rows)
        if (pulled, pushed) != want:
            fail("%s: %d B pulled and %d B pushed a step, the plan gives "
                 "%d and %d" % (label, pulled, pushed, want[0], want[1]))
    span_ms = {n: 1e3 * (spans1[n][1] - spans0[n][1])
               / max(spans1[n][0] - spans0[n][0], 1) for n in PS_SPANS}
    p50 = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print("  %s, %d steps: step p50 %.2f ms (min %.2f, max %.2f), %.0f "
          "%s/s; a step: ps.pull %.2f ms, ps.push %.2f ms (of which "
          "ps.apply %.2f), %d B pulled, %d B pushed; store %d B of values "
          "and %d B of moments resident; peak HBM %.2f GB [%s]"
          % (label, len(times), p50 * 1e3, min(times) * 1e3,
             max(times) * 1e3, items / p50, unit, span_ms["ps.pull"],
             span_ms["ps.push"], span_ms["ps.apply"], pulled, pushed,
             store.resident_bytes(), moments, peak, card))
    share, window = idle_share(lambda: [runner.run(batch) for _ in range(3)])
    print("  device idle share over 3 steps: %s of %.1f ms [%s]"
          % ("not measured" if share is None else "%.1f%%" % (100 * share),
             window, card))
    return p50 * 1e3, launches, losses


def dlrm_setup(**cfg_kw):
    from autodist_tpu_torch.models import dlrm
    cfg = dlrm.DLRMConfig(**cfg_kw)
    loss_fn, params, batch, _ = dlrm.make_train_setup(cfg, batch_size=PS_BATCH,
                                                      seed=0)
    return cfg, loss_fn, params, batch


def dlrm_ps_phase(card):
    """Phase 15 (a)-(b): DLRM at its default config under Parallax(),
    then Parallax() against AllReduce() from one init."""
    import torch
    from autodist_tpu_torch import strategy
    cfg, loss_fn, params, batch = dlrm_setup()
    n_tables = sum(s * cfg.embed_dim for s in cfg.table_sizes)
    print("phase 15 (a): DLRM default config (%d tables, %d table "
          "parameters, %d in all), batch %d (the hot-id batch), Parallax(), "
          "%d + %d steps" % (len(cfg.table_sizes), n_tables,
                             sum(int(p.numel()) for p in params.values()),
                             PS_BATCH, PS_WARMUP, PS_STEPS))
    runner = ps_runner(loss_fn, params, batch, strategy.Parallax())
    tables = {"table_%d.embedding" % t for t in range(len(cfg.table_sizes))}
    if set(runner.distributed_step.ps_names) != tables:
        fail("phase 15 (a): host-PS variables %r are not the 8 tables"
             % sorted(runner.distributed_step.ps_names))
    print("  sparse wire: %s; dense pushes: %s"
          % (sorted(runner.distributed_step.sparse_wire),
             sorted(tables - runner.distributed_step.sparse_wire)))
    p50, _, _ = ps_readings("DLRM Parallax", runner, batch, card, PS_BATCH,
                            rows=PS_BATCH)
    del runner
    print("phase 15 (b): DLRM Parallax() vs AllReduce() from one init, %d "
          "steps each" % PS_PARITY_STEPS)
    got = {}
    for label, builder in (("parallax", strategy.Parallax()),
                           ("allreduce", strategy.AllReduce())):
        runner = ps_runner(loss_fn, params, batch, builder)
        losses = [float(runner.run(batch)["loss"])
                  for _ in range(PS_PARITY_STEPS)]
        got[label] = (losses, host_params(runner))
        del runner
    adt_reset()
    (lp, pp), (la, pa) = got["parallax"], got["allreduce"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lp, la))
    worst, beyond, total = 0.0, 0, 0
    for n, t in pa.items():
        d = (pp[n] - t).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    print("  losses %s vs %s: within %.3e relative (bound %.0e); params "
          "max |diff| %.3e (bound %.0e = 2 x steps x lr), %.4f%% of %d "
          "elements beyond 1e-6 [%s]"
          % (" ".join("%.6f" % x for x in lp),
             " ".join("%.6f" % x for x in la), loss_err, PS_LOSS_RTOL, worst,
             PS_PARAM_DRIFT, 100.0 * beyond / total, total, card))
    if loss_err > PS_LOSS_RTOL or worst > PS_PARAM_DRIFT:
        fail("phase 15 (b): Parallax and AllReduce disagree (losses %r vs "
             "%r, params %.3e)" % (lp, la, worst))
    return p50


def ncf_ps_phase(card):
    """Phase 15 (c): NCF at its default config under PS() and under the
    default builder (PSLoadBalancing)."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import ncf
    cfg = ncf.NCFConfig()
    loss_fn, params, batch, _ = ncf.make_train_setup(cfg,
                                                     batch_size=PS_BATCH,
                                                     seed=0)
    for label, builder in (("PS()", strategy.PS()), ("default", None)):
        print("phase 15 (c): NCF default config (%d parameters), batch %d, "
              "%s, %d + %d steps"
              % (sum(int(p.numel()) for p in params.values()), PS_BATCH,
                 label if builder is not None else
                 "the default builder (PSLoadBalancing)", PS_WARMUP,
                 PS_STEPS))
        runner = ps_runner(loss_fn, params, batch, builder)
        if set(runner.distributed_step.ps_names) != set(params):
            fail("phase 15 (c) %s: host-PS variables %r are not all %d"
                 % (label, sorted(runner.distributed_step.ps_names),
                    len(params)))
        ps_readings("NCF %s" % label, runner, batch, card, PS_BATCH,
                    rows=PS_BATCH)
        del runner
    adt_reset()


def bert_ps_phase(card):
    """Phase 15 (d): bert_base bf16 (seq 128, batch 128, flash) under
    Parallax(), the three tables host-resident; then AllReduce() from the
    same init. Returns the Parallax run's launches by design."""
    import torch
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import bert
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    print("phase 15 (d): bert_base bf16 (seq %d, batch %d, flash) under "
          "Parallax(), %d + %d steps, then AllReduce() %d steps from the "
          "same init" % (BERT_SEQ, BERT_BATCH, PS_WARMUP, PS_STEPS,
                         PS_PARITY_STEPS))
    runner = ps_runner(loss_fn, params, batch, strategy.Parallax())
    tables = {"encoder.word_embeddings.embedding",
              "encoder.position_embeddings.embedding",
              "encoder.token_type_embeddings.embedding"}
    if set(runner.distributed_step.ps_names) != tables:
        fail("phase 15 (d): host-PS variables %r are not the 3 tables"
             % sorted(runner.distributed_step.ps_names))
    print("  sparse wire: %s" % sorted(runner.distributed_step.sparse_wire))
    _, launches, losses = ps_readings(
        "bert_base Parallax", runner, batch, card, BERT_BATCH * BERT_SEQ,
        must_fall=False, unit="tokens")
    check_launches("phase 15 (d)", launches, cfg.num_layers,
                   PS_WARMUP + PS_STEPS)
    if not losses[3] < losses[0]:
        fail("phase 15 (d): the loss after 3 steps is not below the first "
             "(%.4f -> %.4f)" % (losses[0], losses[3]))
    del runner
    runner = ps_runner(loss_fn, params, batch, strategy.AllReduce())
    with uncounted():
        want = [float(runner.run(batch)["loss"])
                for _ in range(PS_PARITY_STEPS)]
    del runner
    adt_reset()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    if worst > 2e-2:
        fail("phase 15 (d): Parallax's first losses %r are not within 2e-2 "
             "of AllReduce's %r" % (losses[:PS_PARITY_STEPS], want))
    print("  first %d losses within %.2e relative of AllReduce's (bound "
          "2e-2); each kernel %d launches a step [%s]"
          % (PS_PARITY_STEPS, worst, cfg.num_layers, card))
    return launches, losses


def pipeline_phase(card):
    """Phase 15 (e): the PS pipeline on DLRM, deterministic mode: exact
    (ADT_PS_OVERLAP=1) against serial (0), and staleness=1."""
    import statistics
    import torch
    from autodist_tpu_torch import strategy
    print("phase 15 (e): DLRM Parallax(): the exact pipeline vs the serial "
          "path (%d steps each, deterministic mode), then staleness=1, "
          "%d + %d steps" % (PS_PARITY_STEPS, PS_WARMUP, PS_STEPS))
    _, loss_fn, params, batch = dlrm_setup()
    torch.use_deterministic_algorithms(True)
    got = {}
    try:
        for label, overlap in (("exact", "1"), ("serial", "0")):
            os.environ["ADT_PS_OVERLAP"] = overlap
            runner = ps_runner(loss_fn, params, batch, strategy.Parallax())
            if (runner.distributed_step._ps_pipe is None) != (overlap == "0"):
                fail("phase 15 (e): ADT_PS_OVERLAP=%s did not pick its path"
                     % overlap)
            losses = [float(runner.run(batch)["loss"])
                      for _ in range(PS_PARITY_STEPS)]
            got[label] = (losses, host_params(runner))
            del runner
    finally:
        os.environ.pop("ADT_PS_OVERLAP", None)
        torch.use_deterministic_algorithms(False)
    (le, pe), (ls, ps_) = got["exact"], got["serial"]
    if le != ls or not all(torch.equal(pe[n], t) for n, t in ps_.items()):
        fail("phase 15 (e): the exact pipeline differs from the serial "
             "path (losses %r vs %r)" % (le, ls))
    print("  exact == serial: losses and params torch.equal after %d steps"
          % PS_PARITY_STEPS)
    del got
    runner = ps_runner(loss_fn, params, batch,
                       strategy.Parallax(staleness=1))
    p50, _, _ = ps_readings("DLRM Parallax(staleness=1)", runner, batch,
                            card, PS_BATCH, rows=PS_BATCH)
    lags = list(runner.distributed_step.ps_read_lags)
    if max(lags) > 1 or min(lags) < 0:
        fail("phase 15 (e): stale reads lag %r applies (bound 1)" % lags)
    print("  staleness=1: reads lag %s applies (bound 1); step p50 %.2f ms "
          "[%s]" % (sorted(set(lags)), p50, card))
    del runner
    adt_reset()
    return p50


def ps_child(rank, store, out_dir):
    """One rank of phase 15 (f) (spawned): DLRM under Parallax() and under
    AllReduce() at N = 2 from one init, deterministic mode."""
    import math
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store, DP_RANKS),
                            rank=rank, world_size=DP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.telemetry import spans as tel
    _, loss_fn, params, batch = dlrm_setup()
    out = {"rank": rank}
    for label, builder in (("parallax", strategy.Parallax()),
                           ("allreduce", strategy.AllReduce())):
        runner = sync_runner(loss_fn, params, batch, builder)
        dstep = runner.distributed_step
        before = dict(tel.counters())
        losses = [float(runner.run(batch)["loss"])
                  for _ in range(PS_PARITY_STEPS)]
        after = tel.counters()
        if not all(math.isfinite(x) for x in losses):
            fail("phase 15 (f) %s: rank %d: a loss is not finite: %r"
                 % (label, rank, losses))
        res = {"losses": losses,
               "sparse_wire": sorted(dstep.sparse_wire),
               "ps_names": sorted(dstep.ps_names),
               "wire": (after.get("sync.wire_bytes", 0.0)
                        - before.get("sync.wire_bytes", 0.0))
               / PS_PARITY_STEPS,
               "sparse": (after.get("sync.sparse_wire_bytes", 0.0)
                          - before.get("sync.sparse_wire_bytes", 0.0))
               / PS_PARITY_STEPS}
        final = runner.gather_params()
        res["params_equal"] = ranks_equal(final)
        if dstep.ps_store is not None:
            dstep.flush_ps()
            res["digest"] = dstep.ps_store.mirror_digest()
        out[label] = res
        del runner, dstep, final
        adt.reset()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "ps%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def ps_dp_phase(card):
    """Phase 15 (f): DLRM at N = 2, two ranks on cuda:0 over gloo."""
    import tempfile
    import torch.multiprocessing as mp
    print("phase 15 (f): DLRM at N = %d on cuda:0 over gloo (global batch "
          "%d), Parallax() and AllReduce() (the tables on the sparse wire), "
          "%d steps each from one init, deterministic mode (run beside "
          "(a)-(e))"
          % (DP_RANKS, PS_BATCH, PS_PARITY_STEPS))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(ps_child, args=(os.path.join(tmp, "store"),
                                               tmp),
                               nprocs=DP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 15 (f): a rank failed: %s" % (str(e).strip()[-2000:],))
        res = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, "ps%d.json" % r)) as f:
                res.append(json.load(f))
    print("  two ranks ran in %.1f s" % (time.perf_counter() - t0))
    from autodist_tpu_torch.models import dlrm
    cfg = dlrm.DLRMConfig()
    dense = 4 * cfg.embed_dim * sum(cfg.table_sizes)
    for label in ("parallax", "allreduce"):
        a, b = (r[label] for r in res)
        if a["losses"] != b["losses"] or not (a["params_equal"]
                                              and b["params_equal"]):
            fail("phase 15 (f) %s: the ranks disagree (losses %r vs %r)"
                 % (label, a["losses"], b["losses"]))
        if label == "parallax" and a["digest"] != b["digest"]:
            fail("phase 15 (f): the ranks' store mirrors differ (%s vs %s)"
                 % (a["digest"], b["digest"]))
        if len(a["sparse_wire"]) < 7:
            fail("phase 15 (f) %s: only %r on the sparse wire"
                 % (label, a["sparse_wire"]))
        print("  %-9s losses %s (both ranks, params torch.equal%s); a step a "
              "rank: sync.wire_bytes %d B, of which the tables' (ids, "
              "values) pairs %d B, against the tables' dense %d B [%s]"
              % (label, " ".join("%.6f" % x for x in a["losses"]),
                 ", store digests equal %s" % a["digest"][:12]
                 if label == "parallax" else "", a["wire"], a["sparse"],
                 dense, card))


def ps_phase(card):
    """Phase 15: the parameter-server family and the sparse (ids, values)
    wire. Returns each kernel's launches in (d), bert_base under
    Parallax, and (d)'s per-step losses."""
    from autodist_tpu_torch.telemetry import spans as tel
    # the PS spans (ps.pull, ps.push, ps.apply) record while tracing is on
    tel.configure("1")
    # (f)'s two ranks run beside (a)-(e) (their gates are exactness and
    # bounds; their step times are informational)
    ranks = Beside(ps_dp_phase, card)
    try:
        dlrm_ps_phase(card)
        ncf_ps_phase(card)
        launches, bert_losses = bert_ps_phase(card)
        pipeline_phase(card)
    finally:
        ranks.result()
        tel.configure(None)
    return launches, bert_losses


# ------------------------------------------------------------- phase 16


CARRY_K, CARRY_MICROSTEPS, CARRY_TIMED = 4, 8, 3
# the bound of the first update on the card against the CPU's, each
# element's: 1e-5 of the update's largest magnitude (the same float32
# arithmetic, in another order for the clip's norm and with the card's
# pow) plus one float32 ulp of the param, which p + u may round either
# way when the two updates differ in their last bits
FIRST_UPDATE_RTOL = 1e-5
CARRY_SPANS = ("dstep.pull_ps", "ps.absorb")


def recsys_batches(name, cfg, n):
    """``n`` batches of ``name``'s model (``dlrm`` or ``ncf``) at
    ``cfg``, drawn as its ``make_train_setup`` draws the example batch,
    from seeds 1..n (without making params again)."""
    import numpy as np
    out = []
    for seed in range(1, n + 1):
        npr = np.random.RandomState(seed)
        if name == "ncf":
            out.append({
                "user": npr.randint(0, cfg.num_users, (PS_BATCH,)).astype(
                    np.int32),
                "item": npr.randint(0, cfg.num_items, (PS_BATCH,)).astype(
                    np.int32),
                "label": npr.randint(0, 2, (PS_BATCH,)).astype(np.int32)})
            continue
        sparse = np.stack(
            [np.where(npr.rand(PS_BATCH) < 0.8,
                      npr.randint(0, max(1, int(size * 0.05)), PS_BATCH),
                      npr.randint(0, size, PS_BATCH))
             for size in cfg.table_sizes], axis=1).astype(np.int32)
        out.append({
            "dense": npr.randn(PS_BATCH, cfg.num_dense).astype(np.float32),
            "sparse": sparse,
            "label": npr.randint(0, 2, (PS_BATCH,)).astype(np.int32)})
    return out


def tree_bytes(tree):
    from torch.utils import _pytree as pytree
    return sum(int(t.numel() * t.element_size())
               for t in pytree.tree_leaves(tree))


def carry_span_totals():
    from autodist_tpu_torch.telemetry import spans as tel
    summary = tel.get_recorder().summary()
    return {n: (summary.get(n, {}).get("count", 0),
                summary.get(n, {}).get("total_s", 0.0))
            for n in CARRY_SPANS}


def fused_ps_pair(label, loss_fn, params, batches, make_builder, card,
                  items, unit):
    """Per step over ``batches``, then ``fit(fuse_steps=4,
    metrics_every=2)`` over them from the same init; then 1 + 3 more
    supersteps (the first loads the carry again after the gather's
    write-back; the other 3 timed) and one under a device trace. Gates:
    :func:`agree`, 2 dispatches, one carry load and one write-back before
    the gather. Returns (ms a microstep, per-step p50 ms, bit-equal)."""
    import statistics
    import torch
    from autodist_tpu_torch.data.prefetch import stack_batches
    runner = ps_runner(loss_fn, params, batches[0], make_builder())
    times = []
    losses = []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(runner.run(b)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_step = (losses, host_params(runner))
    per_p50 = statistics.median(times[2:]) * 1e3
    del runner
    runner = ps_runner(loss_fn, params, batches[0], make_builder())
    dstep = runner.distributed_step
    store = dstep.ps_store
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    spans0, stats0 = carry_span_totals(), dict(store.stats)
    t0 = time.perf_counter()
    hist = runner.fit(iter(batches), fuse_steps=CARRY_K, metrics_every=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    carry = tree_bytes(dstep._ps_carry)
    values = tree_bytes(dstep._ps_carry[0])
    if dstep.dispatches != CARRY_MICROSTEPS // CARRY_K or \
            store.stats["pushes"] != stats0["pushes"] or \
            store.stats["pulls"] != stats0["pulls"] + 1:
        fail("%s: %d dispatches, %d pulls and %d pushes of the store in "
             "the fused fit (want %d, 1, 0: the carry stays on the card)"
             % (label, dstep.dispatches,
                store.stats["pulls"] - stats0["pulls"],
                store.stats["pushes"] - stats0["pushes"],
                CARRY_MICROSTEPS // CARRY_K))
    fused = ([float(m["loss"]) for m in hist], host_params(runner))
    if store.stats["pushes"] != stats0["pushes"] + 1 or \
            store.stats["bytes_pushed"] - stats0["bytes_pushed"] != values:
        fail("%s: the gather did not write the carry back once (%d pushes, "
             "%d B)" % (label, store.stats["pushes"] - stats0["pushes"],
                        store.stats["bytes_pushed"] - stats0["bytes_pushed"]))
    peak = torch.cuda.max_memory_allocated()
    bitwise = agree("%s fused vs per step" % label, fused, per_step,
                    CARRY_MICROSTEPS)
    stack = runner.remapper.remap_feed_stack(
        stack_batches(batches[:CARRY_K]))
    runner.run_superstep(stack, sync=True)        # loads the carry again
    steady = []
    for _ in range(CARRY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_superstep(stack, sync=True)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) / CARRY_K)
    idle, window = idle_share(lambda: runner.run_superstep(stack, sync=True))
    dstep.flush_ps()
    spans1 = carry_span_totals()
    span_ms = {n: 1e3 * (spans1[n][1] - spans0[n][1])
               / max(spans1[n][0] - spans0[n][0], 1) for n in CARRY_SPANS}
    loads = spans1["dstep.pull_ps"][0] - spans0["dstep.pull_ps"][0]
    absorbs = spans1["ps.absorb"][0] - spans0["ps.absorb"][0]
    ms = statistics.median(steady) * 1e3
    print("  %s: fused %d microsteps in %d dispatches (%.2f s, the capture "
          "included); %.2f ms a microstep p50 over %d supersteps (min "
          "%.2f, max %.2f), %.0f %s/s, against %.2f ms a step per step; "
          "idle %s of one superstep (%.1f ms); the carry %d B (%d B of "
          "values, the rest the optimizer state), each way once a run of "
          "supersteps: load (H2D) %.2f ms over %d loads, write-back (D2H, "
          "ps.absorb) %.2f ms over %d; peak HBM %.2f GB (%.2f GB held "
          "before the run) [%s]" % (
              label, len(hist), CARRY_MICROSTEPS // CARRY_K, fit_s, ms,
              CARRY_TIMED, min(steady) * 1e3, max(steady) * 1e3,
              items / (ms / 1e3), unit, per_p50,
              "not measured" if idle is None else "%.1f%%" % (100 * idle),
              window, carry, values, span_ms["dstep.pull_ps"], loads,
              span_ms["ps.absorb"], absorbs, peak / 1e9, held / 1e9, card))
    del runner, stack
    adt_reset()
    return ms, per_p50, bitwise


def dlrm_fused_phase(card):
    """Phase 16 (a): DLRM at its default config under Parallax(), fused
    against per step, in the default mode and in deterministic mode."""
    import torch
    from autodist_tpu_torch import strategy
    cfg, loss_fn, params, _ = dlrm_setup()
    batches = recsys_batches("dlrm", cfg, CARRY_MICROSTEPS)
    print("phase 16 (a): DLRM default config (%d parameters), batch %d, "
          "Parallax(), %d batches per step then fit(fuse_steps=%d, "
          "metrics_every=2) from the same init"
          % (sum(int(p.numel()) for p in params.values()), PS_BATCH,
             CARRY_MICROSTEPS, CARRY_K))
    fused_ps_pair("DLRM Parallax", loss_fn, params, batches,
                  strategy.Parallax, card, PS_BATCH, "examples")
    torch.use_deterministic_algorithms(True)
    try:
        _, _, bitwise = fused_ps_pair(
            "DLRM Parallax, deterministic mode", loss_fn, params, batches,
            strategy.Parallax, card, PS_BATCH, "examples")
    finally:
        torch.use_deterministic_algorithms(False)
    print("  deterministic mode: fused vs per step %s"
          % ("bit-equal" if bitwise else "not bit-equal (within bounds)"))


def ncf_fused_phase(card):
    """Phase 16 (b): NCF at its default config under PS(): every variable
    in the carry."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import ncf
    cfg = ncf.NCFConfig()
    loss_fn, params, _, _ = ncf.make_train_setup(cfg, batch_size=PS_BATCH,
                                                 seed=0)
    batches = recsys_batches("ncf", cfg, CARRY_MICROSTEPS)
    print("phase 16 (b): NCF default config (%d parameters), batch %d, "
          "PS(), every variable in the carry, %d batches per step then "
          "fused" % (sum(int(p.numel()) for p in params.values()),
                     PS_BATCH, CARRY_MICROSTEPS))
    fused_ps_pair("NCF PS()", loss_fn, params, batches, strategy.PS, card,
                  PS_BATCH, "examples")


def bert_fused_ps_phase(card, per_step_losses):
    """Phase 16 (c): bert_base bf16 under Parallax() through
    fit(fuse_steps=4), its losses against phase 15 (d)'s per-step ones,
    and each kernel's launches a microstep under replay, counted by name
    in a device trace. Returns the launches and the launches a
    microstep."""
    import math
    import torch
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.data.prefetch import stack_batches
    from autodist_tpu_torch.models import bert
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    print("phase 16 (c): bert_base bf16 (seq %d, batch %d, flash) under "
          "Parallax(), the three tables in the carry, fit(fuse_steps=%d) "
          "over %d microsteps on phase 15 (d)'s batch"
          % (BERT_SEQ, BERT_BATCH, CARRY_K, CARRY_MICROSTEPS))
    runner = ps_runner(loss_fn, params, batch, strategy.Parallax())
    dstep = runner.distributed_step
    reset_counts()
    hist = runner.fit([batch] * CARRY_MICROSTEPS, fuse_steps=CARRY_K)
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [float(m["loss"]) for m in hist]
    warm = dstep.warmup_microsteps
    check_launches("phase 16 (c)", launches, cfg.num_layers,
                   CARRY_MICROSTEPS + warm)
    stack = runner.remapper.remap_feed_stack(
        stack_batches([batch] * CARRY_K))
    with uncounted():
        reset_counts()
        on_card = trace_launches(device_trace(
            lambda: runner.run_superstep(stack, sync=True)))
    if dstep.warmup_microsteps != warm:
        fail("phase 16 (c): the traced superstep captured a new graph")
    check_launches("phase 16 (c) traced replay, device trace", on_card,
                   cfg.num_layers, CARRY_K)
    want = per_step_losses[:CARRY_MICROSTEPS]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print("  losses fused %s; per step (phase 15 (d)) %s: within %.2e "
          "relative (bound 2e-2); launches %r = %d a microstep x (%d "
          "replayed + %d warm-up); one traced replay of %d microsteps: %r "
          "on the card [%s]" % (
              " ".join("%.4f" % x for x in losses),
              " ".join("%.4f" % x for x in want), worst, launches,
              cfg.num_layers, CARRY_MICROSTEPS, warm, CARRY_K, on_card,
              card))
    if not all(math.isfinite(x) for x in losses) or worst > 2e-2:
        fail("phase 16 (c): fused losses %r vs per step %r" % (losses, want))
    del runner, stack
    adt_reset()
    per_microstep = {name: by[MAIN_DESIGN[name]] / CARRY_K
                     for name, by in on_card.items()}
    return launches, per_microstep


class FirstUpdate:
    """An optimizer spec that records its first ``update``: copies on the
    CPU of the gradients, the state and the params it was given, and of
    the params it left."""

    def __init__(self, spec):
        self.spec = spec
        self.seen = None

    def __getattr__(self, key):
        return getattr(self.spec, key)

    def update(self, grads, state, params, scale=None):
        if self.seen is not None:
            return self.spec.update(grads, state, params, scale=scale)
        from torch.utils import _pytree as pytree

        def cpu(t):
            return t.detach().to("cpu", copy=True)
        before = (pytree.tree_map(cpu, dict(grads)),
                  pytree.tree_map(cpu, dict(state)),
                  {n: cpu(params[n]) for n in grads})
        out = self.spec.update(grads, state, params, scale=scale)
        self.seen = before + ({n: cpu(params[n]) for n in grads},)
        return out


def first_update_check(label, recorder, card):
    """The first update on the card against the port's own update run on
    the CPU from the same gradients, state and params."""
    import math
    import torch
    grads, state, params, after = recorder.seen
    if recorder.spec.clip is not None:
        # the clip's global norm, as each device computes it, against a
        # float64 reference: the one input of the update that is a
        # reduction over every gradient
        def norm_on(device):
            gs = [g.to(device) for g in grads.values()]
            return float(torch.stack([g.square().sum()
                                      for g in gs]).sum().sqrt())
        exact = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        card_norm, cpu_norm = norm_on("cuda"), norm_on("cpu")
        print("  %s: the clip's global norm %.9g on the card, %.9g on the "
              "CPU, %.9g in float64 (relative %.3e and %.3e); bound %g, "
              "clipping %s" % (
                  label, card_norm, cpu_norm, exact,
                  abs(card_norm - exact) / exact,
                  abs(cpu_norm - exact) / exact, recorder.spec.clip,
                  "on" if exact >= recorder.spec.clip else "off"))
    start = {n: t.clone() for n, t in params.items()}
    recorder.spec.update(grads, state, params)
    scale = max(float((after[n] - start[n]).abs().max()) for n in params)
    ulp = torch.finfo(torch.float32).eps
    err = worst = 0.0
    beyond = 0
    for n in params:
        d = (params[n] - after[n]).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (FIRST_UPDATE_RTOL * scale + ulp
                                       * start[n].abs())).max()))
        beyond += int((d > 0).sum())
    print("  %s: the first update on the card vs on the CPU from the same "
          "gradients and state: max |diff| %.3e (%.2f of the bound: %.0e "
          "of the largest update %.3e plus one ulp of the param), %d of %d "
          "elements differ, over %d variables [%s]"
          % (label, err, worst, FIRST_UPDATE_RTOL, scale, beyond,
             sum(t.numel() for t in params.values()), len(params), card))
    if not scale > 0 or worst > 1.0:
        fail("phase 16 (d) %s: the card's first update differs from the "
             "CPU's by %.3e (%.2f of the bound)" % (label, err, worst))


def optimizer_phase(card):
    """Phase 16 (d): resnet50 under the imagenet example's clip chain,
    fused against per step in deterministic mode, and bert_base under the
    bert example's AdamW; the first update of each against the CPU.
    Returns the bert run's launches."""
    import math
    import torch
    from autodist_tpu_torch import optim, strategy
    from autodist_tpu_torch.data.prefetch import stack_batches
    from autodist_tpu_torch.models import bert, resnet
    chain = optim.chain(optim.clip_by_global_norm(1.0), functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))
    loss_fn, params, batch, _ = resnet.make_train_setup(
        resnet.ResNet50, image_size=RESNET_IMAGE, batch_size=RESNET_BATCH,
        dtype=torch.bfloat16, seed=0)
    print("phase 16 (d): resnet50 bf16 (batch %d) under chain("
          "clip_by_global_norm(1.0), SGD(lr=0.1, momentum=0.9)): per step "
          "then fit(fuse_steps=%d) over %d microsteps from one init, "
          "deterministic mode; bert_base bf16 under AdamW(lr=1e-4, "
          "weight_decay=1e-4), 3 steps" % (RESNET_BATCH, CARRY_K,
                                           CARRY_MICROSTEPS))
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for mode in ("per step", "fused"):
            runner = ps_runner(loss_fn, params, batch, strategy.AllReduce(),
                               optimizer=chain)
            dstep = runner.distributed_step
            if mode == "per step":
                recorder = FirstUpdate(dstep.optimizer)
                dstep.optimizer = recorder
                losses = [float(runner.run(batch)["loss"])
                          for _ in range(CARRY_MICROSTEPS)]
            else:
                losses = [float(m["loss"]) for m in runner.fit(
                    [batch] * CARRY_MICROSTEPS, fuse_steps=CARRY_K)]
                if dstep.dispatches != CARRY_MICROSTEPS // CARRY_K:
                    fail("phase 16 (d): %d dispatches fused"
                         % dstep.dispatches)
            # optax.sgd's state: a trace beside each variable, moved for
            # the trainable ones and zero for the BatchNorm statistics
            trace = runner.state.opt_state.get("trace", {})
            trainable = set(dstep.model_item.trainable_var_names)
            moved = {n for n, t in trace.items() if float(t.abs().max()) > 0}
            if sorted(runner.state.opt_state) != ["trace"] or \
                    not moved or not moved <= trainable:
                fail("phase 16 (d): the SGD momentum state: keys %r, %d of "
                     "%d traces moved, frozen ones among them: %r" % (
                         sorted(runner.state.opt_state), len(moved),
                         len(trace), sorted(moved - trainable)[:5]))
            runs[mode] = (losses, host_params(runner))
            del runner
            adt_reset()
    finally:
        torch.use_deterministic_algorithms(False)
    print("  losses fused %s" % " ".join("%.4f" % x
                                         for x in runs["fused"][0]))
    if not all(math.isfinite(x) for x in runs["fused"][0]):
        fail("phase 16 (d): resnet50 losses not finite")
    bitwise = agree("(d) resnet50 clip chain fused vs per step",
                    runs["fused"], runs["per step"], CARRY_MICROSTEPS,
                    lr=0.1)
    print("  (d) resnet50 under the clip chain: fused vs per step %s in "
          "deterministic mode" % ("bit-equal" if bitwise
                                  else "not bit-equal (within bounds)"))
    first_update_check("resnet50 clip chain", recorder, card)
    del params, batch, recorder

    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    runner = ps_runner(loss_fn, params, batch, strategy.AllReduce(),
                       optimizer=adamw)
    recorder = FirstUpdate(runner.distributed_step.optimizer)
    runner.distributed_step.optimizer = recorder
    reset_counts()
    losses = [float(runner.run(batch)["loss"]) for _ in range(3)]
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches("phase 16 (d) bert_base AdamW", launches, cfg.num_layers,
                   3)
    print("  (d) bert_base AdamW losses %s; each kernel %d launches a step "
          "[%s]" % (" ".join("%.4f" % x for x in losses), cfg.num_layers,
                    card))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail("phase 16 (d): bert_base AdamW losses %r" % (losses,))
    del runner
    adt_reset()
    first_update_check("bert_base AdamW", recorder, card)
    return launches


def carry_phase(card, bert_per_step_losses):
    """Phase 16: host-PS variables in fused supersteps and the optax
    optimizers. Returns (c)'s launches and launches a microstep under
    replay, and (d)'s bert_base launches."""
    from autodist_tpu_torch.telemetry import spans as tel
    # the carry's spans (dstep.pull_ps, ps.absorb) record while tracing is
    # on
    tel.configure("1")
    try:
        dlrm_fused_phase(card)
        ncf_fused_phase(card)
        fused_launches, per_microstep = bert_fused_ps_phase(
            card, bert_per_step_losses)
    finally:
        tel.configure(None)
    adamw_launches = optimizer_phase(card)
    return fused_launches, per_microstep, adamw_launches


# ------------------------------------------------------------- phase 17


ASYNC_WARMUP, ASYNC_STEPS = 1, 7
# drained steps of phase 17 (a), each against PS()'s
ASYNC_DRAINED = 3
# 17 (a): bert_base's depth there (the host's Adam over every variable
# sets its time; full width, 2 of the 12 layers)
ASYNC_LAYERS = 2
# (b) and (c) at fewer steps: the phase stays near two minutes on the card
# phase 17 (b) and 18 (d): async steps at least (warm-up + steps), then
# on until the process's loss has fallen, at most ASYNC_MAX_STEPS: a
# process's own owner applies and publishes behind its steps, so when
# its loss first moves depends on the host's speed
DLRM_WARMUP, DLRM_STEPS = 1, 2
ASYNC_MAX_STEPS = 12
STALE_WARMUP, STALE_STEPS = 1, 3
ASYNC_RANKS = 2
# two hosts sharing one card: under async each process builds one replica
# of its own and owns the host-PS groups of its host
ASYNC_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True, "gpus": [0]},
                        {"address": "localhost", "gpus": [0]}]}
ASYNC_SPANS = ("ps_service.apply", "ps_service.publish", "ps.pull",
               "ps.push", "runner.barrier")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def span_ms(names):
    """Each span's ms an occurrence and its count, recorded so far."""
    from autodist_tpu_torch.telemetry import spans as tel
    summary = tel.get_recorder().summary()
    out = {}
    for n in names:
        s = summary.get(n, {})
        count = int(s.get("count", 0))
        out[n] = (1e3 * s.get("total_s", 0.0) / max(count, 1), count)
    return out


def count_collectives():
    """Wrap the default group's collectives with a call counter; returns
    the one-element list it counts in."""
    import torch.distributed as dist
    calls = [0]
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast", "barrier",
                 "all_to_all", "send", "recv"):
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*a, **kw)
        setattr(dist, name, counted)
    return calls


def bert_async_phase(card):
    """Phase 17 (a): bert_base at full width, cut to ``ASYNC_LAYERS``
    layers, under PS(sync=False), one process. Returns the kernels'
    launches over (a)'s async steps."""
    import statistics
    import torch
    from autodist_tpu_torch import const, strategy
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.runtime import ps_service as pss
    cfg = bert.BertConfig.base(dtype=torch.bfloat16, num_layers=ASYNC_LAYERS)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    print("phase 17 (a): bert_base bf16 at full width, %d of its 12 layers "
          "(seq %d, batch %d, flash) under PS(sync=False), one process, "
          "every variable on the host PS: %d steps drained (flush_ps(); "
          "store.drain() after each, serial path, deterministic mode) "
          "against PS() from the same init, then %d + %d steps undrained on "
          "the pipeline"
          % (ASYNC_LAYERS, BERT_SEQ, BERT_BATCH, ASYNC_DRAINED, ASYNC_WARMUP,
             ASYNC_STEPS))
    torch.use_deterministic_algorithms(True)
    os.environ["ADT_PS_OVERLAP"] = "0"
    got = {}
    try:
        with uncounted():
            runner = ps_runner(loss_fn, params, batch, strategy.PS())
            got["PS()"] = [float(runner.run(batch)["loss"])
                           for _ in range(ASYNC_DRAINED)]
            del runner
            adt_reset()
        # the main path: the async runs, counted from here
        reset_counts()
        runner = ps_runner(loss_fn, params, batch, strategy.PS(sync=False))
        dstep, store = runner.distributed_step, runner.distributed_step.ps_store
        if not (dstep.metadata["async"] and store.serving
                and dstep.num_replicas == 1):
            fail("phase 17 (a): PS(sync=False) did not build an async "
                 "serving store (metadata %r)" % (dstep.metadata,))
        losses = []
        for _ in range(ASYNC_DRAINED):
            losses.append(float(runner.run(batch)["loss"]))
            dstep.flush_ps()
            store.drain()
        got["async drained"] = losses
        if store.applied_total() != ASYNC_DRAINED:
            fail("phase 17 (a): %d blobs applied over %d drained steps"
                 % (store.applied_total(), ASYNC_DRAINED))
        del runner, dstep, store
        adt_reset()
    finally:
        os.environ.pop("ADT_PS_OVERLAP", None)
        torch.use_deterministic_algorithms(False)
    sync, drained = got["PS()"], got["async drained"]
    equal = sync == drained
    worst = max(abs(a - b) / abs(b) for a, b in zip(drained, sync))
    print("  losses PS(): %s" % " ".join("%.6f" % x for x in sync))
    print("  losses async drained: %s: %s (largest relative gap %.3e) [%s]"
          % (" ".join("%.6f" % x for x in drained),
             "bit-equal" if equal else "NOT bit-equal", worst, card))
    if not equal:
        fail("phase 17 (a): drained async parts from PS() per step: the "
             "serial paths apply the same gradients through the same "
             "host Adam; no op should part them (losses %r vs %r)"
             % (drained, sync))
    runner = ps_runner(loss_fn, params, batch, strategy.PS(sync=False))
    dstep, store = runner.distributed_step, runner.distributed_step.ps_store
    if dstep._ps_pipe is None:
        fail("phase 17 (a): the undrained run is not on the pipeline")
    grp = next(iter(store._serve_groups.values()))
    max_lag = const.ENV.ADT_PS_MAX_LAG.val
    spans0 = span_ms(ASYNC_SPANS)
    losses, times, queued = [], [], []
    for i in range(ASYNC_WARMUP + ASYNC_STEPS):
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        queued.append(grp["service"].pending_grads())
    dstep.flush_ps()
    store.drain()
    launches = launch_counts()
    spans1 = span_ms(ASYNC_SPANS)
    applied = store.applied_total()
    lags = list(dstep.ps_read_lags)
    vals = grp["service"].fetch()
    opts = grp["service"].fetch_opt()
    values_b = sum(dstep.model_item.var_infos[n].byte_size
                   for n in store.var_names)
    del runner, dstep, store, grp
    adt_reset()
    check_launches("phase 17 (a)", launches, cfg.num_layers,
                   ASYNC_DRAINED + ASYNC_STEPS + ASYNC_WARMUP)
    if not all(x == x for x in losses) or not losses[-1] < losses[0]:
        fail("phase 17 (a): undrained losses not finite or not falling: %r"
             % losses)
    if applied != ASYNC_WARMUP + ASYNC_STEPS:
        fail("phase 17 (a): %d blobs applied over %d undrained steps"
             % (applied, ASYNC_WARMUP + ASYNC_STEPS))
    if max(queued) > max_lag:
        fail("phase 17 (a): the owner queue held %d blobs (ADT_PS_MAX_LAG "
             "%d)" % (max(queued), max_lag))
    if max(lags) > max_lag + 2 or min(lags) < 0:
        fail("phase 17 (a): reads lag %r applies (bound ADT_PS_MAX_LAG + 2 "
             "= %d)" % (lags, max_lag + 2))

    def per(name):
        n = spans1[name][1] - spans0[name][1]
        total = spans1[name][0] * spans1[name][1] - \
            spans0[name][0] * spans0[name][1]
        return total / max(n, 1), n
    p50 = statistics.median(times[ASYNC_WARMUP:])
    print("  undrained, %d steps: step p50 %.2f ms (min %.2f, max %.2f), "
          "%.0f tokens/s; losses %s; %d blobs applied; reads lag %s "
          "applies (bound ADT_PS_MAX_LAG + 2 = %d: the queue, the blob in "
          "the apply thread, the push in the pipeline); the owner queue "
          "held at most %d blobs after a step (ADT_PS_MAX_LAG %d)"
          % (ASYNC_STEPS, p50 * 1e3, min(times[ASYNC_WARMUP:]) * 1e3,
             max(times[ASYNC_WARMUP:]) * 1e3,
             BERT_BATCH * BERT_SEQ / p50,
             " ".join("%.4f" % x for x in losses), applied,
             sorted(set(lags)), max_lag + 2, max(queued), max_lag))
    apply_ms, n_apply = per("ps_service.apply")
    publish_ms, n_publish = per("ps_service.publish")
    print("  the owner loop: ps_service.apply %.2f ms a blob (%d), "
          "ps_service.publish %.2f ms (%d): %d B of values (%d B of "
          "variables) and %d B of optimizer state a publish; ps.pull "
          "%.2f ms, ps.push %.2f ms a step; each kernel %d launches a "
          "step [%s]"
          % (apply_ms, n_apply, publish_ms, n_publish, len(vals[1]),
             values_b, len(opts[1]), per("ps.pull")[0], per("ps.push")[0],
             cfg.num_layers, card))
    return launches


def async_child(rank, store, out_dir, port):
    """One process of phase 17 (b) (spawned): DLRM under
    PSLoadBalancing(sync=False), the chief 127.0.0.1 on rank 0 and
    localhost on rank 1, both on cuda:0. The gloo group exists but no
    step may use it: its collectives are counted."""
    import statistics
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, ASYNC_RANKS),
                            rank=rank, world_size=ASYNC_RANKS)
    os.environ["ADT_NUM_PROCESSES"] = str(ASYNC_RANKS)
    os.environ["ADT_COORDSVC_PORT"] = str(port)
    if rank:
        os.environ["ADT_WORKER"] = "localhost"
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    from autodist_tpu_torch.telemetry import spans as tel
    tel.configure("1")
    calls = count_collectives()
    _, loss_fn, params, batch = dlrm_setup()
    ad = adt.AutoDist(strategy_builder=strategy.PSLoadBalancing(sync=False),
                      resource_spec=ResourceSpec.from_dict(ASYNC_SPEC),
                      device="cuda:0")
    # Adam at 1e-4: each owner applies both processes' gradients, each
    # computed on values up to ADT_PS_MAX_LAG + 2 applies old, and at the
    # 1e-3 of phase 15 the losses rose (an H100 run, PERF.md §6 PR 12)
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-4),
                      params, batch)
    runner.init(params)
    dstep, ps = runner.distributed_step, runner.distributed_step.ps_store
    coord = CoordinationClient("127.0.0.1", port)
    coord.barrier("17b/built", ASYNC_RANKS)
    losses, times = [], []
    for i in range(ASYNC_MAX_STEPS):
        if i == DLRM_WARMUP:
            stats0, spans0 = dict(ps.stats), span_ms(ASYNC_SPANS)
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i + 1 >= DLRM_WARMUP + DLRM_STEPS and losses[-1] < losses[0]:
            break
    stats1, spans1 = dict(ps.stats), span_ms(ASYNC_SPANS)
    dstep.flush_ps()
    coord.barrier("17b/pushed", ASYNC_RANKS)
    ps.drain()
    coord.barrier("17b/drained", ASYNC_RANKS)

    def per(name):
        n = spans1[name][1] - spans0[name][1]
        return (spans1[name][0] * spans1[name][1]
                - spans0[name][0] * spans0[name][1]) / max(n, 1)
    pulls = stats1["pulls"] - stats0["pulls"]
    pushes = stats1["pushes"] - stats0["pushes"]
    out = {"rank": rank, "losses": losses,
           "p50_ms": 1e3 * statistics.median(times[DLRM_WARMUP:]),
           "min_ms": 1e3 * min(times[DLRM_WARMUP:]),
           "max_ms": 1e3 * max(times[DLRM_WARMUP:]),
           "applied": ps.applied_total(),
           "owned": [h for h, g in ps._serve_groups.items() if g["owned"]],
           "owned_vars": sorted({n for g in ps._serve_groups.values()
                                 if g["owned"] for n, _ in g["pairs"]}),
           "bget_bytes": (stats1["bytes_pulled"] - stats0["bytes_pulled"])
           / max(pulls, 1),
           "qpush_bytes": (stats1["bytes_pushed"] - stats0["bytes_pushed"])
           / max(pushes, 1),
           "apply_ms": per("ps_service.apply"),
           "publish_ms": per("ps_service.publish"),
           "pull_ms": per("ps.pull"), "push_ms": per("ps.push"),
           "dropped": ps.stats["dropped_pushes"],
           "wire_bytes": tel.counters().get("sync.wire_bytes", 0.0),
           "collectives": calls[0],
           "replicas": dstep.num_replicas}
    with open(os.path.join(out_dir, "async%d.json" % rank), "w") as f:
        json.dump(out, f)
    coord.barrier("17b/written", ASYNC_RANKS)
    coord.close()
    del runner, dstep, ps
    adt.reset()
    dist.destroy_process_group()


def stale_child(rank, store, out_dir, port):
    """One rank of phase 17 (c) (spawned): DLRM under
    Parallax(staleness=2) at N = 2 over gloo, paced by the coordination
    service; after each step, how far this rank was ahead of the slowest
    on the service."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, DP_RANKS),
                            rank=rank, world_size=DP_RANKS)
    os.environ["ADT_COORDSVC_PORT"] = str(port)
    os.environ["ADT_PS_MIRROR_CHECK_EVERY"] = "2"
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    from autodist_tpu_torch.telemetry import spans as tel
    tel.configure("1")
    _, loss_fn, params, batch = dlrm_setup()
    runner = sync_runner(loss_fn, params, batch,
                         strategy.Parallax(staleness=2))
    dstep = runner.distributed_step
    coord = CoordinationClient("127.0.0.1", port)
    losses, gaps = [], []
    for i in range(STALE_WARMUP + STALE_STEPS):
        if i == STALE_WARMUP:
            spans0 = span_ms(("runner.barrier",))
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        gaps.append(runner.step_stats()["steps"] - coord.min_step())
    spans1 = span_ms(("runner.barrier",))
    n = spans1["runner.barrier"][1] - spans0["runner.barrier"][1]
    barrier_ms = (spans1["runner.barrier"][0] * spans1["runner.barrier"][1]
                  - spans0["runner.barrier"][0]
                  * spans0["runner.barrier"][1]) / max(n, 1)
    dstep.flush_ps()
    out = {"rank": rank, "losses": losses, "gaps": gaps,
           "barrier_ms": barrier_ms, "barriers": n,
           "paced": runner._coord is not None,
           "staleness": dstep.metadata["staleness"],
           "digest": dstep.ps_store.mirror_digest(),
           "mirror_checks": tel.counters().get("ps.mirror_checks", 0.0)}
    with open(os.path.join(out_dir, "stale%d.json" % rank), "w") as f:
        json.dump(out, f)
    coord.close()
    del runner, dstep
    adt.reset()
    dist.destroy_process_group()


def spawn_pair(child, label, port):
    """Run ``child`` on two spawned processes with a gloo group; returns
    their JSON results in rank order."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(child, args=(os.path.join(tmp, "store"), tmp,
                                            port),
                               nprocs=2, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a process failed
            fail("%s: a process failed: %s" % (label,
                                                str(e).strip()[-2000:]))
        res = []
        for r in range(2):
            with open(os.path.join(tmp, "%s%d.json" % (
                    "async" if child is async_child else "stale", r))) as f:
                res.append(json.load(f))
    print("  two processes ran in %.1f s" % (time.perf_counter() - t0))
    return res


def dlrm_async_phase(card, port):
    """Phase 17 (b): DLRM default config under PSLoadBalancing(sync=False),
    two processes on cuda:0, two owner hosts."""
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    print("phase 17 (b): DLRM default config (batch %d) under "
          "PSLoadBalancing(sync=False), Adam 1e-4, two processes on "
          "cuda:0, owner hosts 127.0.0.1 and localhost, %d + %d steps "
          "each at least, on until its loss falls (at most %d) (run beside "
          "phases 16 and 17 (a))"
          % (PS_BATCH, DLRM_WARMUP, DLRM_STEPS, ASYNC_MAX_STEPS))
    res = spawn_pair(async_child, "phase 17 (b)", port)
    c = CoordinationClient("127.0.0.1", port)
    publish = {}
    for host in ("127.0.0.1", "localhost"):
        vals, opts = c.bget("ps:%s/vals" % host), c.bget("ps:%s/opt" % host)
        if vals is None or opts is None:
            fail("phase 17 (b): owner %s never published" % host)
        publish[host] = (vals[0], len(vals[1]), len(opts[1]))
        del vals, opts
    c.close()
    owned = [r["owned"] for r in res]
    if owned != [["127.0.0.1"], ["localhost"]]:
        fail("phase 17 (b): owners %r (want each process its own host)"
             % owned)
    if set(res[0]["owned_vars"]) & set(res[1]["owned_vars"]):
        fail("phase 17 (b): a variable has two owners: %r"
             % [r["owned_vars"] for r in res])
    for r, host in zip(res, ("127.0.0.1", "localhost")):
        version, vals_b, opt_b = publish[host]
        print("  process %d (owner %s of %s): losses %s; step p50 %.2f ms "
              "(min %.2f, max %.2f); %d blobs applied (published version "
              "%d); a publish: BPUT %d B of values + %d B of optimizer "
              "state; a pull: BGET %.0f B; a push: QPUSH %.0f B; "
              "ps_service.apply %.2f ms and publish %.2f ms a blob, "
              "ps.pull %.2f ms and ps.push %.2f ms a step; %d pushes "
              "dropped; sync.wire_bytes %d, collectives %d [%s]"
              % (r["rank"], host, ",".join(r["owned_vars"]),
                 " ".join("%.5f" % x for x in r["losses"]), r["p50_ms"],
                 r["min_ms"], r["max_ms"], r["applied"], version, vals_b,
                 opt_b, r["bget_bytes"], r["qpush_bytes"], r["apply_ms"],
                 r["publish_ms"], r["pull_ms"], r["push_ms"], r["dropped"],
                 r["wire_bytes"], r["collectives"], card))
    for r in res:
        if r["collectives"] or r["wire_bytes"] or r["replicas"] != 1:
            fail("phase 17 (b): process %d ran %d collectives (%d B of "
                 "sync.wire_bytes) at %d replicas" % (
                     r["rank"], r["collectives"], r["wire_bytes"],
                     r["replicas"]))
        if not r["losses"][-1] < r["losses"][0]:
            fail("phase 17 (b): process %d's loss did not fall: %r"
                 % (r["rank"], r["losses"]))


def dlrm_stale_phase(card, port):
    """Phase 17 (c): DLRM under Parallax(staleness=2) at N = 2 over
    gloo."""
    print("phase 17 (c): DLRM default config under Parallax(staleness=2) at "
          "N = %d on cuda:0 over gloo (global batch %d), paced by the "
          "coordination service, %d + %d steps (run beside (b))"
          % (DP_RANKS, PS_BATCH, STALE_WARMUP, STALE_STEPS))
    res = spawn_pair(stale_child, "phase 17 (c)", port)
    a, b = res
    gap = max(max(r["gaps"]) for r in res)
    if not (a["paced"] and b["paced"]) or a["staleness"] != 2:
        fail("phase 17 (c): the ranks were not paced (staleness %r)"
             % a["staleness"])
    if gap > 2 or min(min(r["gaps"]) for r in res) < 0:
        fail("phase 17 (c): a rank was %d steps ahead of the slowest "
             "(bound 2)" % gap)
    if a["losses"] != b["losses"] or a["digest"] != b["digest"]:
        fail("phase 17 (c): the ranks disagree (losses %r vs %r, digests "
             "%s vs %s)" % (a["losses"], b["losses"], a["digest"],
                            b["digest"]))
    if not all(x == x for x in a["losses"]):
        fail("phase 17 (c): a loss is not finite: %r" % a["losses"])
    print("  losses %s (both ranks); store digests equal %s (%d mirror "
          "checks a rank); runner.barrier %.3f / %.3f ms a step (%d "
          "spans a rank); largest step gap on the service %d (bound 2) "
          "[%s]" % (" ".join("%.5f" % x for x in a["losses"]),
                    a["digest"][:12], a["mirror_checks"], a["barrier_ms"],
                    b["barrier_ms"], a["barriers"], gap, card))


def async_pair_phase(card):
    """Phase 17 (b) and, beside it, (c): two processes each, on a
    coordination service of its own (a free port, stopped at the end)."""
    from autodist_tpu_torch.runtime.coordination import CoordinationServer
    t0 = time.perf_counter()
    srvs = [CoordinationServer(free_port()).start() for _ in range(2)]
    try:
        stale = Beside(dlrm_stale_phase, card, srvs[1].port)
        dlrm_async_phase(card, srvs[0].port)
        stale.result()
    finally:
        for srv in srvs:
            srv.stop()
    print("phase 17 (b)-(c): %.1f s" % (time.perf_counter() - t0))


def async_phase(card, pair):
    """Phase 17: the coordination service, async host PS served over it
    and bounded staleness across ranks: (a) here, then ``pair`` (a
    :class:`Beside` of :func:`async_pair_phase`, started before phase 16)
    joined. Returns (a)'s launches."""
    from autodist_tpu_torch.telemetry import spans as tel
    # the spans (ps_service.*, ps.*, runner.barrier) record while tracing
    # is on
    tel.configure("1")
    t0 = time.perf_counter()
    try:
        launches = bert_async_phase(card)
    finally:
        tel.configure(None)
    pair.result()
    print("phase 17: %.1f s" % (time.perf_counter() - t0))
    return launches


# ------------------------------------------------------------- phase 18


LAUNCH_WARMUP = 1
ASYNC_LAUNCH_STEPS = 3
EXTERNAL_STEPS = 3
# two nodes on one machine, one entry each on card 0: the chief
# 127.0.0.1 launches localhost's process, and both run on cuda:0
LAUNCH_SPEC = ("nodes:\n"
               "  - address: 127.0.0.1\n    chief: true\n    gpus: [0]\n"
               "  - address: localhost\n    gpus: [0]\n")

# The user script of phase 18: the chief runs it from the phase, and the
# chief relaunches it for its worker. argv: spec, out dir, mode, steps.
LAUNCH_SCRIPT = r'''
import functools, json, os, sys, time
import torch
import torch.distributed as dist
import chip_smoke as cs
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.telemetry import spans as tel

spec, outdir, mode, steps = (sys.argv[1], sys.argv[2], sys.argv[3],
                             int(sys.argv[4]))
worker = bool(os.environ.get("ADT_WORKER"))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tel.configure("1")   # the handoff's spans
if mode == "external" and worker:
    # the broadcast hands the strategy over: reading a file is a fault
    def no_file(*a, **kw):
        raise AssertionError("the worker read a strategy file")
    Strategy.deserialize = no_file
builder = {"external": strategy.PartitionedPS, "crash": strategy.AllReduce,
           "async": functools.partial(strategy.PSLoadBalancing,
                                      sync=False)}[mode]()
t0 = time.perf_counter()
ad = adt.AutoDist(resource_spec_file=spec, strategy_builder=builder)
construct_ms = 1e3 * (time.perf_counter() - t0)
if mode == "crash" and worker:
    os._exit(3)  # the supervised worker dies; the chief must fail fast
rank = dist.get_rank()
handed = []
build_or_load = ad._build_or_load_strategy
def capture(item):
    handed.append(build_or_load(item))
    return handed[-1]
ad._build_or_load_strategy = capture
from autodist_tpu_torch.models import ncf
loss_fn, params, batch, _ = ncf.make_train_setup(
    ncf.NCFConfig(), batch_size=cs.PS_BATCH, seed=0)
lr = 1e-4 if mode == "async" else 1e-3
runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=lr),
                  params, batch)
runner.init(params)
cs.reset_counts()
losses, times = [], []
for i in range(cs.ASYNC_MAX_STEPS if mode == "async" else steps):
    t = time.perf_counter()
    losses.append(float(runner.run(batch)["loss"]))
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t))
    # async: on past the steps until this process's loss has fallen
    if i + 1 >= steps and (mode != "async" or losses[-1] < losses[0]):
        break
launches = cs.launch_counts()
rec = tel.get_recorder()
out = {"rank": rank, "losses": losses, "times_ms": times,
       "construct_ms": construct_ms, "launches": launches,
       "world": dist.get_world_size(), "device": str(ad.device),
       "strategy_id": handed[0].id,
       "strategy_json": json.dumps(handed[0].to_dict(), sort_keys=True,
                                   indent=1),
       "strategy_wait_ms": [1e3 * d for d in
                            rec.durations_s("autodist.strategy_load")],
       "broadcast_ms": [1e3 * d for d in
                        rec.durations_s("server_starter.broadcast_bytes")]}
if mode == "async":
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    dstep = runner.distributed_step
    store = dstep.ps_store
    coord = CoordinationClient("127.0.0.1", adt.ENV.ADT_COORDSVC_PORT.val)
    # every push queued, then every owner queue drained, before the
    # chief reads what each owner published
    dstep.flush_ps()
    coord.barrier("18d/pushed", 2)
    store.drain()
    coord.barrier("18d/drained", 2)
    out["replicas"] = dstep.num_replicas
    out["applied"] = store.applied_total()
    out["owned"] = [h for h, g in store._serve_groups.items() if g["owned"]]
    out["published"] = {}
    for host in ("127.0.0.1", "localhost"):
        got = coord.bget("ps:%s/vals" % host)
        out["published"][host] = None if got is None else [got[0],
                                                           len(got[1])]
    coord.barrier("18d/read", 2)
    coord.close()
with open(os.path.join(outdir, "out_%d.json" % rank), "w") as f:
    json.dump(out, f)
'''


def job_pids(marker):
    """Every live process whose environment carries ``marker``
    (``NAME=value``)."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/environ" % entry, "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if marker.encode() in env:
            pids.append(int(entry))
    return pids


def kill_job(marker):
    import signal
    for pid in job_pids(marker):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def launch_env(tmp, marker, **extra):
    """The environment of one phase 18 job: free ports, its own working
    dir, the repository on the path, and the marker every process of the
    job inherits."""
    env = dict(os.environ)
    for k in ("ADT_DEBUG_REMOTE", "ADT_WORKER", "ADT_STRATEGY_ID",
              "ADT_EXTERNAL_LAUNCH", "ADT_NUM_PROCESSES", "ADT_PROCESS_ID",
              "ADT_DEVICE", "ADT_ELASTIC", "LOCAL_RANK"):
        env.pop(k, None)
    env.update({"ADT_COORDINATOR_ADDR": "127.0.0.1:%d" % free_port(),
                "ADT_COORDSVC_PORT": str(free_port()),
                "ADT_WORKING_DIR": os.path.join(tmp, "work"),
                "PYTHONPATH": HERE, "ADT_SMOKE_JOB": marker})
    env.update(extra)
    return env


def start_launched(tmp, mode, steps, script="user_script.py", **extra):
    """Start a user script (phase 18's, or ``script`` in ``tmp``) as the
    chief of a chief-launched job, ``extra`` added to its environment;
    :func:`finish_launched` waits for it."""
    import threading
    import uuid
    job = {"marker": uuid.uuid4().hex,
           "logs": [os.path.join(tmp, "chief.out"),
                    os.path.join(tmp, "chief.err")]}
    script, spec = os.path.join(tmp, script), os.path.join(tmp, "spec.yml")
    job["t0"] = time.perf_counter()
    # files, not pipes: a process the chief leaves behind would hold a
    # pipe open and hide the chief's own exit
    with open(job["logs"][0], "w") as out_f, \
            open(job["logs"][1], "w") as err_f:
        job["proc"] = subprocess.Popen(
            [sys.executable, script, spec, tmp, mode, str(steps)], cwd=tmp,
            env=launch_env(tmp, job["marker"], **extra), stdout=out_f,
            stderr=err_f, text=True, start_new_session=True)

    def stamp_exit():
        job["proc"].wait()
        job["end"] = time.perf_counter()
    threading.Thread(target=stamp_exit, daemon=True).start()
    return job


def finish_launched(job, timeout, label):
    """Wait for a job :func:`start_launched` started, at most ``timeout``
    s from its start; returns (exit code, stderr, seconds from its start
    to the chief's exit, the job's processes left). Whatever is left of
    the job is killed at the end."""
    import signal
    marker, proc = "ADT_SMOKE_JOB=" + job["marker"], job["proc"]
    try:
        proc.wait(timeout=max(0.0, job["t0"] + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        kill_job(marker)
        proc.wait()
        with open(job["logs"][1]) as f:
            fail("%s: the job outlived %d s: %s" % (label, timeout,
                                                   f.read()[-3000:]))
    finally:
        wall = job.get("end", time.perf_counter()) - job["t0"]
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        # a process the chief stopped on its way out may take a moment
        deadline = time.monotonic() + 5
        while job_pids(marker) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = job_pids(marker)
        kill_job(marker)
    with open(job["logs"][1]) as f:
        err = f.read()
    return proc.returncode, err, wall, left


def run_launched(tmp, mode, steps, timeout, label, script="user_script.py",
                 **extra):
    """:func:`start_launched`, then :func:`finish_launched`."""
    return finish_launched(start_launched(tmp, mode, steps, script, **extra),
                           timeout, label)


def read_outputs(tmp, n, label, log):
    res = []
    for r in range(n):
        path = os.path.join(tmp, "out_%d.json" % r)
        if not os.path.exists(path):
            fail("%s: rank %d wrote no result: %s" % (label, r, log[-3000:]))
        with open(path) as f:
            res.append(json.load(f))
        os.remove(path)
    return res


def start_external(tmp):
    """Start phase 18 (b)'s two processes together (``ADT_EXTERNAL_LAUNCH``)
    in ``tmp``; :func:`external_phase` waits for them."""
    import uuid
    job = {"marker": uuid.uuid4().hex, "tmp": tmp, "procs": [], "logs": []}
    job["sid"] = "smoke-external-%s" % job["marker"][:12]
    addr, svc = "127.0.0.1:%d" % free_port(), str(free_port())
    script, spec = os.path.join(tmp, "user_script.py"), os.path.join(
        tmp, "spec.yml")
    for r in range(2):
        extra = {"ADT_COORDINATOR_ADDR": addr, "ADT_COORDSVC_PORT": svc,
                 "ADT_NUM_PROCESSES": "2", "ADT_PROCESS_ID": str(r),
                 "ADT_EXTERNAL_LAUNCH": "1", "ADT_STRATEGY_ID": job["sid"],
                 "ADT_DEVICE": "cuda:0"}
        if r:
            extra["ADT_WORKER"] = "localhost"
            extra["ADT_WORKING_DIR"] = os.path.join(tmp, "worker_work")
        job["logs"].append(os.path.join(tmp, "external_%d.log" % r))
        with open(job["logs"][-1], "w") as log:
            job["procs"].append(subprocess.Popen(
                [sys.executable, script, spec, tmp, "external",
                 str(EXTERNAL_STEPS)], cwd=tmp,
                env=launch_env(tmp, job["marker"], **extra), stdout=log,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
    return job


def external_phase(card, job):
    """Phase 18 (b): NCF under PartitionedPS(), the two processes
    :func:`start_external` started: the strategy over
    ``broadcast_bytes``."""
    import signal
    print("phase 18 (b): NCF default config (batch %d) under "
          "PartitionedPS(), two processes started together on cuda:0 "
          "(ADT_EXTERNAL_LAUNCH: the strategy over broadcast_bytes), %d "
          "steps, run beside (d)" % (PS_BATCH, EXTERNAL_STEPS))
    tmp, sid, procs = job["tmp"], job["sid"], job["procs"]
    try:
        for p in procs:
            p.wait(timeout=180)
    except subprocess.TimeoutExpired:
        fail("phase 18 (b): the pair outlived 180 s")
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
        kill_job("ADT_SMOKE_JOB=" + job["marker"])
    logs = []
    for name in job["logs"]:
        with open(name) as f:
            logs.append(f.read())
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            fail("phase 18 (b): a process exited %d: %s" % (p.returncode,
                                                            log[-3000:]))
    a, b = read_outputs(tmp, 2, "phase 18 (b)", "\n".join(logs))
    with open(os.path.join(tmp, "work", "strategies", sid)) as f:
        written = f.read()
    if b["strategy_json"] != written or a["strategy_json"] != written:
        fail("phase 18 (b): the worker's strategy is not the chief's file")
    if os.path.exists(os.path.join(tmp, "worker_work", "strategies", sid)):
        fail("phase 18 (b): a strategy file exists on the worker's side")
    if a["losses"] != b["losses"] or not a["losses"][-1] < a["losses"][0]:
        fail("phase 18 (b): losses %r vs %r" % (a["losses"], b["losses"]))
    print("  the worker's strategy (%d B of JSON) byte-equal to the chief's "
          "file, no file read on the worker; broadcast_bytes %.2f ms on the "
          "chief, %.2f ms on the worker (its whole strategy load %.2f ms); "
          "losses %s (both ranks) [%s]"
          % (len(written), a["broadcast_ms"][0], b["broadcast_ms"][0],
             b["strategy_wait_ms"][0],
             " ".join("%.5f" % x for x in a["losses"]), card))


def launched_async_phase(card, tmp):
    """Phase 18 (d): NCF under PSLoadBalancing(sync=False), launched by
    the chief, the service started by Cluster.start only."""
    import statistics
    steps = LAUNCH_WARMUP + ASYNC_LAUNCH_STEPS
    print("phase 18 (d): NCF default config (batch %d) under "
          "PSLoadBalancing(sync=False), Adam 1e-4, launched by the chief "
          "(owner hosts 127.0.0.1 and localhost on cuda:0; the coordination "
          "service started by Cluster.start), %d + %d steps at least, on "
          "until each process's loss falls (at most %d)"
          % (PS_BATCH, LAUNCH_WARMUP, ASYNC_LAUNCH_STEPS, ASYNC_MAX_STEPS))
    rc, err, wall, left = run_launched(tmp, "async", steps, 240,
                                       "phase 18 (d)")
    if rc != 0 or left:
        fail("phase 18 (d): the chief exited %d, %d processes left: %s"
             % (rc, len(left), err[-3000:]))
    res = read_outputs(tmp, 2, "phase 18 (d)", err)
    published = res[0]["published"]
    for host in ("127.0.0.1", "localhost"):
        if published[host] is None:
            fail("phase 18 (d): owner %s never published" % host)
    for r in res:
        if r["replicas"] != 1 or not r["losses"][-1] < r["losses"][0]:
            fail("phase 18 (d): process %d at %d replicas, losses %r"
                 % (r["rank"], r["replicas"], r["losses"]))
        after = r["times_ms"][LAUNCH_WARMUP:]
        print("  process %d (owner of %s): losses %s; step p50 %.2f ms "
              "(min %.2f, max %.2f); %d blobs applied [%s]"
              % (r["rank"], ",".join(r["owned"]),
                 " ".join("%.5f" % x for x in r["losses"]),
                 statistics.median(after), min(after), max(after),
                 r["applied"], card))
    print("  published: %s; the job %.1f s"
          % (", ".join("%s version %d (%d B)" % (h, v[0], v[1])
                       for h, v in sorted(published.items())), wall))


def launch_phase(card):
    """Phase 18: launch and handoff; bert_base launched by the chief is
    phase 19 (a)'s first incarnation."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "user_script.py"), "w") as f:
            f.write(LAUNCH_SCRIPT)
        with open(os.path.join(tmp, "spec.yml"), "w") as f:
            f.write(LAUNCH_SPEC)
        # (b) runs beside (d), in a directory of its own: both are short
        # NCF jobs whose checks do not depend on the host's load
        btmp = os.path.join(tmp, "b")
        os.makedirs(btmp)
        for name in ("user_script.py", "spec.yml"):
            with open(os.path.join(tmp, name)) as src, \
                    open(os.path.join(btmp, name), "w") as dst:
                dst.write(src.read())
        external = start_external(btmp)
        launched_async_phase(card, tmp)
        external_phase(card, external)
    print("phase 18: %.1f s" % (time.perf_counter() - t0))


# ---------------------------------------------------------------- phase 19

# 19 (a): steps 0-4 (phase 10's fp32-wire steps); the save after step 2
ELASTIC_STEPS = DP_STEPS["fp32"]
ELASTIC_SAVE_AFTER = 2
# 19 (b): the watchdog's window. An NCF step beside phase 19's other jobs
# takes up to about 2 s and, on a slower shared host, more: a window of
# 6 s (the JAX deadlock test's) is missed by a live worker, whose budget
# is spent after its one relaunch, and the chief aborts the job
ELASTIC_HB_TIMEOUT_S = 15
ELASTIC_HANG_STEPS = 6      # 19 (b): the relaunched worker's steps
# 19 (b): the relaunched worker's first dispatch sleeps this long, past
# the watchdog's bring-up grace (2 x 15 s after the relaunch) and a
# heartbeat window, so that only its compile-grace mark keeps it alive
ELASTIC_SLOW_FIRST_S = 24
# 19 (b): the chief steps until the relaunched worker is done, at most
# this long from its start (the phase waits 300 s for the whole job)
ELASTIC_HANG_WAIT_S = 250

# The user script of phase 19: the chief runs it from the phase, and
# relaunches it for its worker (and re-execs it to restart the job).
# Each process appends its events to <out dir>/<mode>_<role>.jsonl, as
# the steps go: a process may die or be replaced at any point. argv: spec,
# out dir, mode ("sync" or "hang").
ELASTIC_SCRIPT = r"""
import functools, json, os, sys, time
T_START = time.time()
import torch
import torch.distributed as dist
import chip_smoke as cs
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.telemetry import spans as tel

spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
worker = os.environ.get("ADT_WORKER", "")
resumed = bool(os.environ.get("ADT_AUTO_RESUME"))
tel.configure("1")   # the handoff's spans
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
events = open(os.path.join(outdir, "%s_%s.jsonl"
                           % (mode, "worker" if worker else "chief")), "a")

def record(event, **kw):
    kw.update(event=event, t=time.time(), resumed=resumed,
              pid=os.getpid())
    events.write(json.dumps(kw) + "\n")
    events.flush()

record("start", t_start=T_START)
builder = strategy.AllReduce() if mode == "sync" else strategy.PS(sync=False)
t = time.perf_counter()
ad = adt.AutoDist(resource_spec_file=spec, strategy_builder=builder)
construct_ms = 1e3 * (time.perf_counter() - t)
handed = []
build_or_load = ad._build_or_load_strategy

def capture(item):
    handed.append(build_or_load(item))
    return handed[-1]
ad._build_or_load_strategy = capture
if mode == "sync":
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.models import bert
    torch.use_deterministic_algorithms(True)
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=cs.BERT_SEQ, batch_size=cs.BERT_BATCH, seed=0,
        attention="flash")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    t = time.perf_counter()
    runner.init(params)  # ADT_AUTO_RESUME restores on the re-exec'd run
    torch.cuda.synchronize()
    start = int(runner.state.step)
    record("init", ms=1e3 * (time.perf_counter() - t), step=start,
           rank=dist.get_rank(), world=dist.get_world_size(),
           device=str(ad.device), construct_ms=construct_ms,
           strategy_json=json.dumps(handed[0].to_dict(), sort_keys=True),
           strategy_wait_ms=[1e3 * d for d in tel.get_recorder().durations_s(
               "autodist.strategy_load")])
    saver = Saver(directory=os.environ["ADT_CKPT_DIR"])
    marker = os.path.join(outdir, "sync_died")
    cs.reset_counts()
    for i in range(start, cs.ELASTIC_STEPS):
        t = time.perf_counter()
        loss = float(runner.run(batch)["loss"])
        torch.cuda.synchronize()
        record("step", step=i, loss=loss, ms=1e3 * (time.perf_counter() - t),
               launches=cs.launch_counts(), rank=dist.get_rank())
        cs.reset_counts()
        if i == cs.ELASTIC_SAVE_AFTER:
            t = time.perf_counter()
            saver.save(runner)  # every rank calls it; rank 0 writes
            record("save", ms=1e3 * (time.perf_counter() - t),
                   rank=dist.get_rank())
            if worker and not os.path.exists(marker):
                open(marker, "w").close()
                record("death")
                os._exit(3)  # the first worker incarnation dies
    record("done", rank=dist.get_rank())
else:
    from autodist_tpu_torch.models import ncf
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    base_loss, params, batch, _ = ncf.make_train_setup(
        ncf.NCFConfig(), batch_size=cs.PS_BATCH, seed=0)
    slow = []

    def loss_fn(p, b):
        if slow:
            time.sleep(slow.pop())
        return base_loss(p, b)
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-4),
                      params, batch)
    runner.init(params)
    marker = os.path.join(outdir, "hang_once")
    if worker:
        restarted = os.path.exists(marker)
        if restarted:
            slow.append(cs.ELASTIC_SLOW_FIRST_S)
        for i in range(cs.ELASTIC_HANG_STEPS):
            record("dispatch", step=i, restarted=restarted)
            loss = float(runner.run(batch)["loss"])
            torch.cuda.synchronize()
            record("step", step=i, loss=loss, restarted=restarted)
            if i == 2 and not restarted:
                open(marker, "w").close()
                # the last heartbeat, then silence while alive
                c = CoordinationClient("127.0.0.1",
                                       adt.ENV.ADT_COORDSVC_PORT.val)
                c.heartbeat(worker)
                record("silent")
                time.sleep(3600)
        record("done", restarted=restarted)
        open(os.path.join(outdir, "hang_done"), "w").close()
    else:
        done = os.path.join(outdir, "hang_done")
        i = 0
        while time.time() < T_START + cs.ELASTIC_HANG_WAIT_S and \
                not os.path.exists(done):
            loss = float(runner.run(batch)["loss"])
            torch.cuda.synchronize()
            record("step", step=i, loss=loss)
            i += 1
            time.sleep(0.05)
        record("done", worker_done=os.path.exists(done))
"""


def read_events(tmp, mode, role):
    path = os.path.join(tmp, "%s_%s.jsonl" % (mode, role))
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def log_time(err, text):
    """The wall-clock time of the first log line of ``err`` holding
    ``text`` (the port's logging format starts each line with its local
    time to the millisecond)."""
    import datetime
    for line in err.splitlines():
        if text in line:
            stamp = " ".join(line.split()[:2])
            return datetime.datetime.strptime(
                stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()
    return None


def elastic_sync_phase(card, tmp, dp_losses):
    """Phase 19 (a): bert_base at full width under AllReduce(), launched by
    the chief on two processes of cuda:0 (the launch plane's checks: the
    relaunch, the join over gloo, the file handoff), sync-elastic: the
    worker dies after step 2's save, the chief re-execs and both ranks
    resume at step 3, every loss bit-equal to phase 10's uninterrupted
    fp32-wire run. Returns both ranks' launches over both incarnations."""
    import re
    import statistics
    print("phase 19 (a): bert_base bf16 (seq %d, global batch %d, flash) "
          "under AllReduce(), launched by the chief on 127.0.0.1 and "
          "localhost (gpus [0] each: two processes on cuda:0), file "
          "handoff, ADT_ELASTIC=1 ADT_ELASTIC_SYNC=1, deterministic mode, "
          "%d steps with a save after step %d; the worker's first "
          "incarnation exits 3 after that save"
          % (BERT_SEQ, BERT_BATCH, ELASTIC_STEPS, ELASTIC_SAVE_AFTER))
    rc, err, wall, left = run_launched(
        tmp, "sync", 0, 400, "phase 19 (a)", script="elastic_script.py",
        ADT_ELASTIC="1", ADT_ELASTIC_SYNC="1",
        ADT_CKPT_DIR=os.path.join(tmp, "ckpt_sync"))
    if rc != 0 or left:
        fail("phase 19 (a): the chief exited %d, %d processes left: %s"
             % (rc, len(left), err[-4000:]))
    if err.count("sync-elastic: re-exec") != 1 or \
            "restarting the WHOLE job" not in err:
        fail("phase 19 (a): the chief did not re-exec once: %s"
             % err[-4000:])
    if err.count("local_exec[localhost]") != 2:
        fail("phase 19 (a): the chief did not launch its worker once an "
             "incarnation")
    # the log holds every process's lines (the workers write to the
    # chief's stderr); the backend rule must pick gloo (one card)
    backend = re.findall(r"process group backend (\w+): (.*)", err)
    if len(backend) != 4 or {b for b, _ in backend} != {"gloo"}:
        fail("phase 19 (a): the backend lines %r (want gloo in each of the "
             "4 processes: one card)" % (backend,))
    chief, wk = read_events(tmp, "sync", "chief"), read_events(
        tmp, "sync", "worker")
    inits = {(e["resumed"], e["rank"]): e for e in chief + wk
             if e["event"] == "init"}
    for (again, rank), e in sorted(inits.items()):
        want = ELASTIC_SAVE_AFTER + 1 if again else 0
        if e["world"] != 2 or e["device"] != "cuda:0" or e["step"] != want:
            fail("phase 19 (a): %s rank %d at world %d on %s started at "
                 "step %d (want 2, cuda:0, %d)" % (
                     "resumed" if again else "first", rank, e["world"],
                     e["device"], e["step"], want))
        if e["strategy_json"] != inits[(again, 0)]["strategy_json"] or \
                bool(e["strategy_wait_ms"]) != bool(rank):
            fail("phase 19 (a): the %s worker did not load the chief's "
                 "strategy file" % ("resumed" if again else "first"))
    if sorted(inits) != [(False, 0), (False, 1), (True, 0), (True, 1)]:
        fail("phase 19 (a): the ranks that started: %r" % sorted(inits))
    steps = {}
    launches = {}
    for e in chief + wk:
        if e["event"] != "step":
            continue
        steps.setdefault((e["resumed"], e["rank"]), {})[e["step"]] = e
        check_launches("phase 19 (a) %s rank %d step %d" % (
            "resumed" if e["resumed"] else "first", e["rank"], e["step"]),
            e["launches"], BERT_LAYERS, 1)
        for name, by in e["launches"].items():
            for design, n in by.items():
                launches.setdefault(name, {})
                launches[name][design] = launches[name].get(design, 0) + n
    first = [sorted(steps.get((False, r), {})) for r in (0, 1)]
    again = [sorted(steps.get((True, r), {})) for r in (0, 1)]
    want_first = list(range(ELASTIC_SAVE_AFTER + 1))
    want_again = list(range(ELASTIC_SAVE_AFTER + 1, ELASTIC_STEPS))
    if first != [want_first] * 2 or again != [want_again] * 2:
        fail("phase 19 (a): steps run %r before and %r after the restart"
             % (first, again))
    by_rank = [[steps[(i > ELASTIC_SAVE_AFTER, r)][i]["loss"]
                for i in range(ELASTIC_STEPS)] for r in (0, 1)]
    if by_rank[0] != by_rank[1]:
        fail("phase 19 (a): the ranks' losses differ: %r" % (by_rank,))
    got = by_rank[0]
    # phase 10's fp32 wire is the same program, uninterrupted: two ranks
    # on cuda:0 over gloo, deterministic mode. Steps 0-2 hold the launch
    # plane to it, steps 3-4 the restore (which must be exact)
    want = list(dp_losses[:ELASTIC_STEPS])
    if got != want:
        part = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
        fail("phase 19 (a): losses %r part from phase 10's uninterrupted "
             "fp32-wire run %r at step %d: %s" % (
                 got, want, part,
                 "the restore from the checkpoint is not exact"
                 if part > ELASTIC_SAVE_AFTER else
                 "the launched job differs from the spawned one before "
                 "the restart"))
    death = next(e["t"] for e in wk if e["event"] == "death")
    execv = log_time(err, "sync-elastic: re-exec")
    resumed_first = steps[(True, 0)][ELASTIC_SAVE_AFTER + 1]
    save = next(e for e in chief if e["event"] == "save")
    started = min(e["t_start"] for e in chief if e["event"] == "start")
    t_first = [steps[(False, r)][i]["ms"] for r in (0, 1)
               for i in want_first]
    t_again = [steps[(True, 0)][i]["ms"] for i in want_again]
    print("  backend: gloo in all 4 processes (%s); AutoDist() on the chief "
          "(launch + join) %.1f ms, %.1f ms after the restart; the worker's "
          "strategy wait %.1f / %.1f ms [%s]"
          % (backend[0][1], inits[(False, 0)]["construct_ms"],
             inits[(True, 0)]["construct_ms"],
             inits[(False, 1)]["strategy_wait_ms"][0],
             inits[(True, 1)]["strategy_wait_ms"][0], card))
    print("  losses %s (both ranks, both incarnations), bit-equal to phase "
          "10's uninterrupted fp32-wire run; each kernel 12 launches a step "
          "a rank on mma.sync bf16 in both incarnations (%d rank-steps); "
          "the first incarnation's steps %s ms (ranks 0 and 1) [%s]"
          % (" ".join("%.6f" % x for x in got),
             sum(len(v) for v in steps.values()),
             " ".join("%.1f" % x for x in t_first), card))
    print("  the worker died %.2f s after the chief's start; the save %.1f "
          "ms (rank 0, in save()); the worker's death to the chief's execv "
          "%.2f s; the execv to the resumed job's first step %.2f s "
          "(launch, join, restore); the restore (Runner.init under "
          "ADT_AUTO_RESUME) %.1f ms; the whole recovery %.2f s; the "
          "resumed steps %s ms (p50 %.1f); the job %.1f s [%s]"
          % (death - started, save["ms"], execv - death,
             resumed_first["t"] - execv, inits[(True, 0)]["ms"],
             resumed_first["t"] - death,
             " ".join("%.1f" % x for x in t_again),
             statistics.median(t_again), wall, card))
    return launches, resumed_first["t"] - death


def start_hang(tmp):
    """Start phase 19 (b)'s job in ``tmp``; :func:`elastic_hang_phase`
    finishes it."""
    return start_launched(tmp, "hang", 0, script="elastic_script.py",
                          ADT_ELASTIC="1",
                          ADT_HEARTBEAT_TIMEOUT_S=str(ELASTIC_HB_TIMEOUT_S))


def elastic_hang_phase(card, tmp, job):
    """Phase 19 (b): NCF under PS(sync=False) launched by the chief; the
    worker's first incarnation goes silent at step 2, the watchdog kills
    it and the process watcher relaunches it."""
    print("phase 19 (b): NCF default config (batch %d) under PS(sync=False), "
          "Adam 1e-4, launched by the chief, ADT_ELASTIC=1 "
          "ADT_HEARTBEAT_TIMEOUT_S=%d: the worker's first incarnation stops "
          "heartbeating at step 2 and sleeps; the relaunched one's first "
          "dispatch lasts %d s more, %d steps (run beside (a) and phases 18 "
          "and 22)"
          % (PS_BATCH, ELASTIC_HB_TIMEOUT_S, ELASTIC_SLOW_FIRST_S,
             ELASTIC_HANG_STEPS))
    rc, err, wall, left = finish_launched(job, 300, "phase 19 (b)")
    if rc != 0 or left:
        fail("phase 19 (b): the chief exited %d, %d processes left: %s"
             % (rc, len(left), err[-4000:]))
    for text, n in (("killing it for an elastic restart", 1),
                    ("relaunching worker", 1)):
        if err.count(text) != n:
            fail("phase 19 (b): %r %d times in the log (want %d): %s"
                 % (text, err.count(text), n, err[-4000:]))
    if "inside its compile grace window" not in err:
        fail("phase 19 (b): the watchdog never read the relaunched "
             "worker's compile-grace mark: %s" % err[-4000:])
    chief, wk = read_events(tmp, "hang", "chief"), read_events(
        tmp, "hang", "worker")
    if not any(e["event"] == "done" and e["worker_done"] for e in chief):
        fail("phase 19 (b): the chief stopped stepping %d s after its start "
             "before the relaunched worker was done: %s"
             % (ELASTIC_HANG_WAIT_S, err[-4000:]))
    again = [e["loss"] for e in wk if e["event"] == "step" and e["restarted"]]
    mine = [e["loss"] for e in chief if e["event"] == "step"]
    if len(again) != ELASTIC_HANG_STEPS or not again[-1] < again[0] or \
            not mine[-1] < mine[0]:
        fail("phase 19 (b): the relaunched worker's losses %r, the chief's "
             "%r (both must fall)" % (again, mine))
    silent = next(e["t"] for e in wk if e["event"] == "silent")
    killed = log_time(err, "killing it for an elastic restart")
    dispatch = next(e["t"] for e in wk
                    if e["event"] == "dispatch" and e["restarted"])
    first = next(e["t"] for e in wk
                 if e["event"] == "step" and e["restarted"])
    print("  the last heartbeat to the kill %.2f s (window %d s); the kill "
          "to the new incarnation's first dispatch %.2f s, to its first "
          "step %.2f s (%d s of it the deliberate sleep); its losses %s; "
          "the chief's %d steps %.5f -> %.5f; the job %.1f s [%s]"
          % (killed - silent, ELASTIC_HB_TIMEOUT_S, dispatch - killed,
             first - killed, ELASTIC_SLOW_FIRST_S,
             " ".join("%.5f" % x for x in again), len(mine), mine[0],
             mine[-1], wall, card))


def start_fail_fast(tmp):
    """Start phase 19 (c)'s job in ``tmp``: a sync-elastic worker exits 3
    right after AutoDist(), before any checkpoint."""
    return start_launched(tmp, "crash", 1, ADT_ELASTIC="1",
                          ADT_ELASTIC_SYNC="1",
                          ADT_CKPT_DIR=os.path.join(tmp, "ckpt_none"))


def elastic_fail_fast_phase(card, job):
    """Phase 19 (c): nothing to restore, so the chief still fails fast
    (exit 1) and leaves no process."""
    print("phase 19 (c): the launched worker exits 3 right after "
          "AutoDist(), ADT_ELASTIC=1 ADT_ELASTIC_SYNC=1, no checkpoint "
          "(run beside (a) and (b)): the chief must abort the job")
    rc, err, wall, left = finish_launched(job, 90, "phase 19 (c)")
    if rc != 1 or "nothing to restore, failing fast" not in err or \
            "exited with code 3 — aborting job" not in err:
        fail("phase 19 (c): the chief exited %d: %s" % (rc, err[-3000:]))
    if left:
        fail("phase 19 (c): %d processes of the job were left" % len(left))
    print("  the chief exited 1 (\"nothing to restore\", \"aborting job\") "
          "%.1f s after its start; no process of the job left [%s]"
          % (wall, card))


def elastic_phase(card, dp_losses, beside=None):
    """Phase 19: supervised recovery; (b)'s and (c)'s jobs and
    ``beside(recovery)`` (phases 18 and 22) run beside (a), where
    ``recovery()`` waits for (a) and returns its whole-job recovery time.
    Returns (a)'s launches, that time (the death to the resumed first
    step, s) and what ``beside`` returned."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "user_script.py"), "w") as f:
            f.write(LAUNCH_SCRIPT)
        with open(os.path.join(tmp, "elastic_script.py"), "w") as f:
            f.write(ELASTIC_SCRIPT)
        with open(os.path.join(tmp, "spec.yml"), "w") as f:
            f.write(LAUNCH_SPEC)
        # (b)'s and (c)'s jobs and ``beside`` run beside (a), the jobs each
        # in a directory of its own: (c)'s two processes start and end
        # while (b)'s first incarnation starts, and (b), which waits out a
        # heartbeat window and a slow first dispatch, ends about when (a)
        # does
        btmp, ctmp = os.path.join(tmp, "b"), os.path.join(tmp, "c")
        for sub, names in ((btmp, ("elastic_script.py", "spec.yml")),
                           (ctmp, ("user_script.py", "spec.yml"))):
            os.makedirs(sub)
            for name in names:
                with open(os.path.join(tmp, name)) as src, \
                        open(os.path.join(sub, name), "w") as dst:
                    dst.write(src.read())
        fail_fast = start_fail_fast(ctmp)
        hang = start_hang(btmp)
        recovery, known = {}, threading.Event()

        def recovery_s():
            known.wait()
            return recovery.get("s")
        side = Beside(beside, recovery_s) if beside is not None else None
        try:
            launches, recovery["s"] = elastic_sync_phase(card, tmp,
                                                         dp_losses)
        finally:
            known.set()
        elastic_hang_phase(card, btmp, hang)
        elastic_fail_fast_phase(card, fail_fast)
        out = side.result() if side is not None else None
    print("phase 19: %.1f s" % (time.perf_counter() - t0))
    return launches, recovery["s"], out


# ------------------------------------------------------------- phase 20


TP_SEQ, TP_BATCH, TP_RANKS = 1024, 8, 2
# (a): warm-up and timed steps; (b): steps a rank, the first 3 held to
# (a)'s, the last 3 timed
TP_WARMUP, TP_TIMED, TP2_STEPS = 2, 5, 5
# phase 27 (a)'s ZeRO-sharded and partitioned variables whose Adam moments
# are held to phase 20 (b)'s after the same steps
OPT_CHECK = ("layer_0/ln1/scale", "layer_0/attn/bo", "layer_0/mlp/b2",
             "layer_11/ln2/bias", "final_ln/scale", "pos_embed")
TP_PARAMS = 185722880          # TPLMConfig.flagship()'s parameters
TP_SPEC_ONE = {"nodes": [{"address": "127.0.0.1", "chief": True,
                          "gpus": [0]}]}
# two ranks of one card: the index listed once a rank
TP_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                      "gpus": [0] * TP_RANKS}]}


def tp_setup(shapes=None):
    """tp_lm at ``TPLMConfig.flagship()``: (cfg, the JAX model's loss with
    the flash kernels in its ``attn_fn`` slot, the plain loss, params
    from seed 0, the seq-1024 batch of 8). ``shapes`` collects the q
    shapes the flash slot sees."""
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
    cfg = tp_lm.TPLMConfig.flagship()
    plain, params, batch, _ = tp_lm.make_train_setup(
        cfg, seq_len=TP_SEQ, batch_size=TP_BATCH, seed=0)
    flash = make_flash_attn_fn(causal=True)

    def attn(q, k, v):
        if shapes is not None:
            shapes.add(tuple(q.shape))
        return flash(q, k, v)
    return cfg, tp_lm.make_loss(cfg, attn_fn=attn), plain, params, batch


def tp_runner(tp, spec, loss_fn, params, batch):
    """``TensorParallel(tp, tp_rules())`` built and initialized on
    ``cuda:0`` through the public entry points, Adam 1e-3."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.TensorParallel(
        tp, tp_lm.tp_rules()), resource_spec=ResourceSpec.from_dict(spec),
        device="cuda:0")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner


def stored_bytes(runner):
    """(bytes this rank stores of the variables the plan shards over the
    model axis, bytes of all its params)."""
    mp = {n.var_name for n in runner.distributed_step.strategy.node_config
          if n.mp_axes}
    size = {n: t.numel() * t.element_size()
            for n, t in runner.state.params.items()}
    return sum(size[n] for n in mp), sum(size.values())


def tp_kernel_check(shape):
    """The three kernels at tp_lm's causal ``shape`` in bf16 vs their plain
    versions (2e-2; the backward's relative to the plain version's
    largest magnitude); returns each kernel's errors."""
    import torch
    from autodist_tpu_torch.ops import flash_attention as fa
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkdv": []}
    what = "bf16 [%d,%d,%d,%d] causal (mma.sync bf16)" % shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    with uncounted():
        out, lse = fa.flash_fwd(q, k, v, causal=True)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        errs["flash_fwd"].append(max(
            check_close("out " + what, out, ref, 2e-2),
            check_close("lse " + what, lse, ref_lse, 2e-2)))
        args = (q, k, v, do, lse, fa.flash_bwd_delta(out, do))
        dq = fa.flash_bwd_dq(*args, causal=True)
        dk, dv = fa.flash_bwd_dkdv(*args, causal=True)
        dq_ref = fa.flash_bwd_dq_reference(*args, causal=True)
        dk_ref, dv_ref = fa.flash_bwd_dkdv_reference(*args, causal=True)
        torch.cuda.synchronize()
    errs["flash_bwd_dq"].append(check_rel("dq " + what, dq, dq_ref, 2e-2))
    for g, r, grad in ((dk, dk_ref, "dk"), (dv, dv_ref, "dv")):
        errs["flash_bwd_dkdv"].append(check_rel(grad + " " + what, g, r,
                                                2e-2))
    return errs


def tp_flops_per_step(cfg, n_params):
    """Closed-form training FLOPs of one tp_lm step: 6 x tokens x the
    parameters outside ``pos_embed`` (a slice; the tied table counts once,
    as the head's matmul) plus the attention products, 12 x layers x seq
    x d_model a token (PaLM's count, which ignores the causal half)."""
    tokens = TP_BATCH * TP_SEQ
    dense = n_params - cfg.max_seq_len * cfg.d_model
    return 6 * tokens * dense + 12 * cfg.num_layers * TP_SEQ * \
        cfg.d_model * tokens


def tp_child(rank, store, out_dir):
    """One rank of phase 20 (b) (spawned): join the gloo group, train
    tp_lm flagship under ``TensorParallel(2)`` on cuda:0, save once,
    write this rank's results to ``out_dir``."""
    import statistics
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.telemetry import spans as tel
    shapes = set()
    cfg, loss_fn, _, params, batch = tp_setup(shapes)
    t0 = time.perf_counter()
    runner = tp_runner(TP_RANKS, TP_SPEC, loss_fn, params, batch)
    init_s = time.perf_counter() - t0
    del params
    # the build traces the loss on fake tensors over the whole params;
    # the steps' shapes are the ones to read
    shapes.clear()
    reset_counts()
    before = tel.counters()
    losses, times = [], []
    for _ in range(TP2_STEPS):
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    after = tel.counters()

    def per_step(key):
        return (after.get(key, 0.0) - before.get(key, 0.0)) / TP2_STEPS
    mp_b, all_b = stored_bytes(runner)
    stats = runner.step_stats()
    out = {"rank": rank, "losses": losses,
           "times_ms": [t * 1e3 for t in times],
           "p50_ms": statistics.median(times[-3:]) * 1e3,
           "launches": launches, "shapes": sorted(shapes),
           "init_s": init_s,
           "fwd_allreduces": per_step("tp.fwd_allreduces"),
           "fwd_allreduce_bytes": per_step("tp.fwd_allreduce_bytes"),
           "mp_bytes": mp_b, "param_bytes": all_b,
           "stats_param_bytes": stats["param_bytes"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    ckpt = os.path.join(out_dir, "ckpt")
    t0 = time.perf_counter()
    path = Saver(ckpt).save(runner)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    if path is not None:
        out["save_bytes"] = sum(
            os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    # phase 27 (a) holds its gathered Adam moments to these (a collective)
    opt = opt_leaves(runner)
    if rank == 0:
        torch.save(opt, os.path.join(out_dir, "opt.pt"))
    adt.reset()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def opt_leaves(runner):
    """The Adam moments of :data:`OPT_CHECK`'s variables, gathered whole
    (``gather_opt_state``, which every rank joins), in f32 on the CPU."""
    import torch
    dstep = runner.distributed_step
    opt = dstep.gather_opt_state(runner.state)
    return {slot: {n: opt[slot][n].detach().to("cpu", torch.float32)
                   for n in OPT_CHECK} for slot in ("mu", "nu")}


def tp_phase(card):
    """Phase 20: tp_lm flagship through TensorParallel, the flash kernels
    in its attention slot. Returns (each kernel's launches in (a), in (b)
    over both ranks, the kernels' records at the 16-head and the 8-head
    shape)."""
    import gc
    import math
    import tempfile
    import torch
    import torch.multiprocessing as mp
    import autodist_tpu_torch as adt
    print("phase 20: tp_lm flagship (bf16, seq %d, batch %d) through "
          "TensorParallel, flash through attn_fn: (a) tp 1, one process; "
          "(b) tp 2, %d processes of cuda:0 over gloo"
          % (TP_SEQ, TP_BATCH, TP_RANKS))
    shape16 = (TP_BATCH, TP_SEQ, 16, HEAD_DIM)
    shape8 = (TP_BATCH, TP_SEQ, 16 // TP_RANKS, HEAD_DIM)
    errs16, errs8 = tp_kernel_check(shape16), tp_kernel_check(shape8)
    rec16 = kernel_timing(card, errs16, shape16, True, None,
                          "[8,1024,16,64] causal")
    rec8 = kernel_timing(card, errs8, shape8, True, None,
                         "[8,1024,8,64] causal")
    cfg, loss_fn, plain, params, batch = tp_setup()
    n_params = sum(int(t.numel()) for t in params.values())
    if n_params != TP_PARAMS:
        fail("phase 20: tp_lm flagship has %d parameters (want %d)"
             % (n_params, TP_PARAMS))
    # the first loss through the flash slot vs the plain causal attention
    with uncounted(), torch.no_grad():
        dev = {n: t.to("cuda") for n, t in params.items()}
        feed = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
        first = (float(loss_fn(dev, feed)), float(plain(dev, feed)))
        del dev, feed
    torch.cuda.empty_cache()
    print("  first loss: flash %.6f, plain causal attention %.6f"
          % first)
    if not abs(first[0] - first[1]) <= 2e-2 * max(1.0, abs(first[1])):
        fail("phase 20: the first loss through flash %.6f is not within 2e-2"
             " of the plain attention's %.6f" % first)
    # (a) one process, TensorParallel(1)
    t0 = time.perf_counter()
    runner = tp_runner(1, TP_SPEC_ONE, loss_fn, params, batch)
    print("  (a) build + init %.1f s; %d parameters (random, seed 0)"
          % (time.perf_counter() - t0, n_params))
    losses = []
    times, launches_a = timed_steps(runner, batch, "phase 20 (a)",
                                    warmup=TP_WARMUP, steps=TP_TIMED,
                                    losses_out=losses)
    check_launches("phase 20 (a)", launches_a, cfg.num_layers,
                   TP_WARMUP + TP_TIMED)
    READINGS["tp_lm_a_p50_ms"] = report_steps(
        "(a) tp_lm flagship TensorParallel(1)", times, TP_BATCH * TP_SEQ,
        "tokens", tp_flops_per_step(cfg, n_params), card, launches_a)
    mp_a, all_a = stored_bytes(runner)
    with uncounted():
        profile_steps(runner, batch, "(a) tp_lm")
    del runner, params
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    # (b) two processes, TensorParallel(2), beside phase 21 (a)'s two
    t0 = time.perf_counter()
    shard = Beside(shard_spawn)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(tp_child, args=(os.path.join(tmp, "store"),
                                               tmp),
                               nprocs=TP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 20 (b): a rank failed: %s"
                 % (str(e).strip()[-2000:],))
        res = []
        for r in range(TP_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
        opt = torch.load(os.path.join(tmp, "opt.pt"))
    print("  (b) two ranks ran in %.1f s" % (time.perf_counter() - t0))
    launches_b = {}
    for r in res:
        label = "phase 20 (b) rank %d" % r["rank"]
        check_launches(label, r["launches"], cfg.num_layers, TP2_STEPS)
        for name, by in r["launches"].items():
            for design, n in by.items():
                launches_b.setdefault(name, {})
                launches_b[name][design] = launches_b[name].get(design,
                                                                0) + n
        if r["shapes"] != [list(shape8)]:
            fail("%s: the flash slot saw q shapes %r (want %r)"
                 % (label, r["shapes"], [list(shape8)]))
        if 2 * r["mp_bytes"] != mp_a or r["param_bytes"] != \
                r["stats_param_bytes"]:
            fail("%s: stores %d bytes of the model-parallel variables (a "
                 "single process: %d)" % (label, r["mp_bytes"], mp_a))
        want = 2 * cfg.num_layers + 5
        if r["fwd_allreduces"] != want:
            fail("%s: %.1f forward all-reduces a step (want %d)"
                 % (label, r["fwd_allreduces"], want))
        if not all(math.isfinite(x) for x in r["losses"]):
            fail("%s: a loss is not finite: %r" % (label, r["losses"]))
    if res[0]["losses"] != res[1]["losses"]:
        fail("phase 20 (b): the ranks' losses differ: %r vs %r"
             % (res[0]["losses"], res[1]["losses"]))
    for i, (got, want) in enumerate(zip(res[0]["losses"][:3], losses[:3])):
        if not abs(got - want) <= 2e-2 * max(1.0, abs(want)):
            fail("phase 20 (b): step %d loss %.6f is not within 2e-2 of "
                 "(a)'s %.6f" % (i, got, want))
    r0 = res[0]
    print("  (b) losses %s (both ranks; (a)'s first 3: %s, within 2e-2); "
          "flash q shape a rank %r"
          % (" ".join("%.4f" % x for x in r0["losses"]),
             " ".join("%.4f" % x for x in losses[:3]), r0["shapes"][0]))
    print("  (b) params a rank: %.1f MB of the model-parallel variables "
          "(a single process: %.1f MB, half: %s), %.1f MB in all (a single "
          "process: %.1f MB); peak %.2f GB a rank"
          % (r0["mp_bytes"] / 1e6, mp_a / 1e6, 2 * r0["mp_bytes"] == mp_a,
             r0["param_bytes"] / 1e6, all_a / 1e6, r0["peak_gb"]))
    print("  (b) %d forward all-reduces a step (2 x %d layers, the "
          "embedding's 2, the xent's 3), %.1f MB a step a rank; step p50 "
          "%.1f / %.1f ms (ranks 0 / 1, steps %s ms); build + init %.1f s "
          "[%s]"
          % (r0["fwd_allreduces"], cfg.num_layers,
             r0["fwd_allreduce_bytes"] / 1e6, r0["p50_ms"], res[1]["p50_ms"],
             " ".join("%.1f" % t for t in r0["times_ms"]), r0["init_s"],
             card))
    print("  (b) one save (whole params and Adam moments in the JAX layout, "
          "gathered over the model axis): %.1f ms on rank 0, %.1f MB [%s]"
          % (r0["save_ms"], r0["save_bytes"] / 1e6, card))
    return launches_a, launches_b, rec16, rec8, r0["save_ms"], shard, \
        (r0["losses"], opt)


# ------------------------------------------------------------- phase 21


SHARD_STEPS = 2              # 21 (a): steps before the save, and after
SENT_WARMUP, SENT_TIMED = 2, 6   # 21 (b): paired per-step steps
SENT_FUSE, SENT_SUPERSTEPS = 4, 3    # 21 (b): fused, after the capture
SENT_VAR = "encoder.layer_0.MultiHeadAttention_0.query.weight"
SCHED_STEPS = 2              # 21 (c): hier and ring steps at N = 4
HIER_RANKS = 4
# 21 (c): phase 19 (a)'s two loopback nodes, two ranks of cuda:0 each
HIER_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                        "gpus": [0, 0]},
                       {"address": "localhost", "gpus": [0, 0]}]}


class GatherCount:
    """Counts the all-gathers issued inside the block: every all-gather
    of the port goes through ``collectives._all_gather`` (a partitioned or
    model-parallel variable's gather among them) or
    ``torch.distributed.all_gather`` (the sync state's)."""

    def __enter__(self):
        import torch.distributed as dist
        from autodist_tpu_torch.parallel import collectives
        self.n = 0
        self._saved = (collectives._all_gather, dist.all_gather)

        def wrap(fn):
            def counted(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return counted
        collectives._all_gather = wrap(self._saved[0])
        dist.all_gather = wrap(self._saved[1])
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        from autodist_tpu_torch.parallel import collectives
        collectives._all_gather, dist.all_gather = self._saved
        return False


def dir_bytes(path, prefix=""):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.startswith(prefix))


def shard_child(rank, store, out_dir):
    """One rank of phase 21 (a) (spawned): tp_lm flagship under
    ``TensorParallel(2)`` on cuda:0 in deterministic mode; 2 steps, a
    ``ShardedSaver`` save (its ms, this rank's bytes, the all-gathers it
    issued), a gathered ``Saver`` save at the same step (phase 20 (b)'s
    kind of save, the reference), 2 more steps, then the sharded restore
    and the same 2 steps again."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver, ShardedSaver
    torch.use_deterministic_algorithms(True)
    cfg, loss_fn, _, params, batch = tp_setup()
    runner = tp_runner(TP_RANKS, TP_SPEC, loss_fn, params, batch)
    del params
    reset_counts()
    out = {"rank": rank}
    losses = [float(runner.run(batch)["loss"]) for _ in range(SHARD_STEPS)]
    torch.cuda.synchronize()
    sharded_dir = os.path.join(out_dir, "sharded")
    saver = ShardedSaver(sharded_dir)
    with GatherCount() as gathers:
        t0 = time.perf_counter()
        base = saver.save(runner)
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
    out["save_gathers"] = gathers.n
    out["save_bytes"] = dir_bytes(sharded_dir,
                                  "ckpt-%d.shard-p%d." % (SHARD_STEPS, rank))
    plain_dir = os.path.join(out_dir, "plain")
    with GatherCount() as gathers:
        t0 = time.perf_counter()
        Saver(plain_dir).save(runner)
        out["plain_save_ms"] = (time.perf_counter() - t0) * 1e3
    out["plain_gathers"] = gathers.n
    if rank == 0:
        out["plain_bytes"] = dir_bytes(plain_dir)
    losses += [float(runner.run(batch)["loss"])
               for _ in range(SHARD_STEPS)]
    t0 = time.perf_counter()
    _, step = saver.restore(runner, base)
    torch.cuda.synchronize()
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3
    out["restored_step"] = step
    out["resumed"] = [float(runner.run(batch)["loss"])
                      for _ in range(SHARD_STEPS)]
    out["losses"] = losses
    out["launches"] = launch_counts()
    out["base"] = base
    adt.reset()
    torch.use_deterministic_algorithms(False)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def shard_spawn():
    """Phase 21 (a)'s two ranks, run beside phase 20 (b)'s: returns (the
    directory of their checkpoints and results, the results, seconds)."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        mp.start_processes(shard_child, args=(os.path.join(tmp, "store"),
                                              tmp),
                           nprocs=TP_RANKS, start_method="spawn")
    except Exception as e:  # noqa: BLE001 — a rank failed
        fail("phase 21 (a): a rank failed: %s" % (str(e).strip()[-2000:],))
    res = []
    for r in range(TP_RANKS):
        with open(os.path.join(tmp, "rank%d.json" % r)) as f:
            res.append(json.load(f))
    return tmp, res, time.perf_counter() - t0


def sharded_phase(card, gathered_ms, spawned):
    """Phase 21 (a): tp_lm flagship's sharded checkpoint at tp 2 (two
    processes, ``spawned``: the :class:`Beside` of :func:`shard_spawn`),
    restored at tp 1 in this process and compared with the gathered
    save. Returns the two ranks' launches."""
    import gc
    import shutil
    import numpy as np
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import ShardedSaver
    print("phase 21 (a): tp_lm flagship (bf16, seq %d, batch %d) at tp 2 on "
          "%d processes of cuda:0 over gloo (run beside phase 20 (b)): %d "
          "steps, ShardedSaver.save, %d more; restored at tp 2 (the same %d "
          "steps again) and at tp 1 (one process)"
          % (TP_SEQ, TP_BATCH, TP_RANKS, SHARD_STEPS, SHARD_STEPS,
             SHARD_STEPS))
    tmp, res, seconds = spawned.result()
    try:
        print("  (a) two ranks ran in %.1f s" % seconds)
        cfg, loss_fn, _, params, batch = tp_setup()
        for r in res:
            label = "phase 21 (a) rank %d" % r["rank"]
            check_launches(label, r["launches"], cfg.num_layers,
                           3 * SHARD_STEPS)
            if r["save_gathers"] != 0:
                fail("%s: the sharded save issued %d all-gathers (want 0)"
                     % (label, r["save_gathers"]))
            if r["resumed"] != r["losses"][SHARD_STEPS:]:
                fail("%s: the steps after the tp 2 restore %r are not the "
                     "uninterrupted run's %r"
                     % (label, r["resumed"], r["losses"][SHARD_STEPS:]))
        if res[0]["losses"] != res[1]["losses"]:
            fail("phase 21 (a): the ranks' losses differ")
        # the tp 2 save restored at tp 1, one process
        runner = tp_runner(1, TP_SPEC_ONE, loss_fn, params, batch)
        del params
        sharded = os.path.join(tmp, "sharded")
        t1 = time.perf_counter()
        _, step = ShardedSaver(sharded).restore(runner)
        torch.cuda.synchronize()
        tp1_ms = (time.perf_counter() - t1) * 1e3
        base = os.path.join(tmp, "plain", "ckpt-%d" % SHARD_STEPS)
        with np.load(base + ".params.npz") as z:
            want_p = {k: z[k] for k in z.files}
        with np.load(base + ".opt.npz") as z:
            want_o = {k: z[k] for k in z.files}
        st = runner.state
        bad = [n for n, t in st.params.items()
               if not np.array_equal(t.cpu().numpy(), want_p[n])]
        for slot in ("mu", "nu"):
            bad += ["%s/%s" % (slot, n) for n, t in
                    st.opt_state[slot].items()
                    if not np.array_equal(t.cpu().numpy(),
                                          want_o["0/%s/%s" % (slot, n)])]
        if int(st.opt_state["count"]) != int(want_o["0/count"]):
            bad.append("count")
        if step != SHARD_STEPS or bad or len(st.params) != len(want_p):
            fail("phase 21 (a): the tp 1 restore of the sharded save is not "
                 "bit-equal to the gathered save at step %d: %r"
                 % (SHARD_STEPS, bad[:8]))
        del runner, st
        adt.reset()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = res
    launches = {}
    for r in res:
        for name, by in r["launches"].items():
            for design, n in by.items():
                launches.setdefault(name, {})
                launches[name][design] = launches[name].get(design, 0) + n
    print("  (a) losses %s, then restored at tp 2: %s (the uninterrupted "
          "run's, bit for bit, both ranks)"
          % (" ".join("%.4f" % x for x in r0["losses"]),
             " ".join("%.4f" % x for x in r0["resumed"])))
    print("  (a) ShardedSaver.save: %.1f / %.1f ms (ranks 0 / 1), %.1f / "
          "%.1f MB a rank (%.1f MB in all), %d / %d all-gathers; the "
          "gathered Saver.save at the same step: %.1f ms on rank 0, %.1f MB, "
          "%d all-gathers a rank; phase 20 (b)'s gathered save in this run "
          "%.1f ms [%s]"
          % (r0["save_ms"], r1["save_ms"], r0["save_bytes"] / 1e6,
             r1["save_bytes"] / 1e6,
             (r0["save_bytes"] + r1["save_bytes"]) / 1e6,
             r0["save_gathers"], r1["save_gathers"], r0["plain_save_ms"],
             r0["plain_bytes"] / 1e6, r0["plain_gathers"], gathered_ms,
             card))
    print("  (a) restore: at tp 2 %.1f / %.1f ms (ranks 0 / 1); at tp 1 "
          "(one process, slices assembled across the two files) %.1f ms, "
          "params and both Adam moments bit-equal to the gathered save at "
          "step %d [%s]"
          % (r0["restore_ms"], r1["restore_ms"], tp1_ms, SHARD_STEPS, card))
    return launches


def sentinel_runner(loss_fn, params, batch, sentinel, plan=None, ad=None):
    """bert_base built on cuda:0 with ``sentinel`` (a policy, True, or
    False) and, with ``plan``, ``ADT_GRAD_FAULT_PLAN`` in the environment
    for the build; by ``ad`` when given (one AutoDist builds several
    runners), else by a new ``AutoDist(AllReduce())``."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    if ad is None:
        adt.reset()
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    if plan:
        os.environ["ADT_GRAD_FAULT_PLAN"] = json.dumps({"faults": plan})
    try:
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-3),
                          params, batch, sentinel=sentinel)
    finally:
        os.environ.pop("ADT_GRAD_FAULT_PLAN", None)
    runner.init(params)
    return runner


def paired_p50(label, runners, step, n_warm, n_timed):
    """Steps of each runner in alternating order (A B, B A, ...), each
    ended by a sync; (each runner's p50 in ms over its timed steps, the
    dispatches and readbacks a step of each)."""
    import statistics
    import torch
    times = {k: [] for k in runners}
    names = list(runners)
    for i in range(n_warm + n_timed):
        for k in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            step(runners[k])
            torch.cuda.synchronize()
            if i >= n_warm:
                times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def sentinel_phase(card):
    """Phase 21 (b): the health sentinel on bert_base, one process: its
    cost per step and fused (armed and unarmed, paired), one NaN skipped,
    and a sustained fault rolled back twice with the LR halved. Returns
    each kernel's launches over the phase."""
    import gc
    import math
    import tempfile
    import numpy as np
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.runtime.sentinel import SentinelPolicy
    print("phase 21 (b): the health sentinel on bert_base (bf16, seq %d, "
          "batch %d, flash, AllReduce(), one process): per step and "
          "fit(fuse_steps=%d), armed vs unarmed; a NaN at step 3; a "
          "sustained NaN" % (BERT_SEQ, BERT_BATCH, SENT_FUSE))
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    launches = {}

    def add_launches():
        for name, by in launch_counts().items():
            for design, n in by.items():
                launches.setdefault(name, {})
                launches[name][design] = launches[name].get(design, 0) + n
    # per step, paired: two runners of one AutoDist
    from autodist_tpu_torch import strategy
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runners = {k: sentinel_runner(loss_fn, params, batch, k == "armed",
                                  ad=ad) for k in ("unarmed", "armed")}
    reset_counts()
    before = {k: (r.distributed_step.dispatches, r.readbacks)
              for k, r in runners.items()}
    p50 = paired_p50("per step", runners, lambda r: r.run(batch),
                     SENT_WARMUP, SENT_TIMED)
    steps = SENT_WARMUP + SENT_TIMED
    check_launches("phase 21 (b) per step", launch_counts(), cfg.num_layers,
                   2 * steps)
    add_launches()
    per = {k: ((r.distributed_step.dispatches - before[k][0]) / steps,
               (r.readbacks - before[k][1]) / steps)
           for k, r in runners.items()}
    if per["armed"] != per["unarmed"] or per["armed"] != (1.0, 1.0):
        fail("phase 21 (b): dispatches and readbacks a step %r (want the "
             "unarmed run's (1, 1))" % (per,))
    v = runners["armed"].step_stats()["sentinel"]
    if v["skips"] or v["last_grad_norm"] is None or not math.isfinite(
            v["last_grad_norm"]):
        fail("phase 21 (b): the clean armed run's sentinel stats %r" % (v,))
    # fused, paired (the capture first, untimed)
    stack = {k: np.stack([a] * SENT_FUSE) for k, a in batch.items()}
    for r in runners.values():
        r.run_superstep(stack, sync=True)
    reset_counts()
    before = {k: (r.distributed_step.dispatches, r.readbacks)
              for k, r in runners.items()}
    fused = paired_p50("fused", runners,
                       lambda r: r.run_superstep(stack, sync=True), 0,
                       SENT_SUPERSTEPS)
    check_launches("phase 21 (b) fused", launch_counts(), cfg.num_layers,
                   2 * SENT_FUSE * SENT_SUPERSTEPS)
    add_launches()
    per_f = {k: ((r.distributed_step.dispatches - before[k][0])
                 / SENT_SUPERSTEPS, (r.readbacks - before[k][1])
                 / SENT_SUPERSTEPS) for k, r in runners.items()}
    if per_f["armed"] != per_f["unarmed"] or per_f["armed"] != (1.0, 1.0):
        fail("phase 21 (b): fused dispatches and readbacks a superstep %r "
             "(want the unarmed run's (1, 1))" % (per_f,))
    warm = sum(r.distributed_step.warmup_microsteps
               for r in runners.values())
    print("  (b) per step: p50 %.2f ms armed vs %.2f unarmed (%+.1f%%), "
          "paired over %d steps each; fused k=%d: %.2f vs %.2f ms a "
          "superstep (%.2f vs %.2f a microstep, %+.1f%%); dispatches and "
          "readbacks a step %r, a superstep %r, both as unarmed; each "
          "kernel %d launches a step (the captures' %d warm-up microsteps "
          "aside) [%s]"
          % (p50["armed"], p50["unarmed"],
             100 * (p50["armed"] / p50["unarmed"] - 1), SENT_TIMED,
             SENT_FUSE, fused["armed"], fused["unarmed"],
             fused["armed"] / SENT_FUSE, fused["unarmed"] / SENT_FUSE,
             100 * (fused["armed"] / fused["unarmed"] - 1), per["armed"],
             per_f["armed"], cfg.num_layers, warm, card))
    for r in runners.values():
        r.close()
    del runners, ad
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    # a NaN at step 3: one skip, the update discarded
    runner = sentinel_runner(loss_fn, params, batch, True,
                             [{"var": SENT_VAR, "mode": "nan", "step": 3}])
    reset_counts()
    oks, losses = [], []
    for i in range(6):
        if i == 3:
            kept = {n: t.clone() for n, t in runner.state.params.items()}
        m = runner.run(batch)
        oks.append(int(m["sentinel"]["ok"]))
        losses.append(float(m["loss"]))
        if i == 3:
            moved = [n for n, t in runner.state.params.items()
                     if not torch.equal(t, kept[n])]
            del kept
    check_launches("phase 21 (b) NaN", launch_counts(), cfg.num_layers, 6)
    add_launches()
    stats = runner.step_stats()["sentinel"]
    if oks != [1, 1, 1, 0, 1, 1] or stats["skips"] != 1 or moved or \
            not all(math.isfinite(x) for x in losses[4:]):
        fail("phase 21 (b): a NaN at step 3 gave verdicts %r, %d skips, "
             "%d params moved by the skipped step, losses %r"
             % (oks, stats["skips"], len(moved), losses))
    print("  (b) NaN in %s's gradient at step 3: verdicts %s, 1 skip, the "
          "params after it bit-equal to those before it, losses %s"
          % (SENT_VAR, oks, " ".join("%.4f" % x for x in losses)))
    del runner
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    # a sustained NaN (steps 3-5): two rollbacks to the step-2 save, the
    # second halving the LR, then the widened budget skips through
    with tempfile.TemporaryDirectory() as ckdir:
        runner = sentinel_runner(
            loss_fn, params, batch,
            SentinelPolicy(max_skips_per_window=1, window_steps=50),
            [{"var": SENT_VAR, "mode": "nan", "step": 3, "until": 5}])
        saver = Saver(ckdir)
        runner.sentinel.attach_saver(saver)
        reset_counts()
        sen = runner.sentinel
        rollback_ms, steps_run, losses = [], 0, []
        for i in range(15):
            rb = sen.rollbacks
            m = runner.run(batch)
            steps_run += 1
            losses.append(float(m["loss"]))
            if sen.rollbacks > rb:
                rollback_ms.append(sen.last_rollback_ms)
            if i == 1:
                saver.save(runner)
        check_launches("phase 21 (b) sustained", launch_counts(),
                       cfg.num_layers, steps_run)
        add_launches()
        scale = float(runner.state.sync_state["sentinel"]["lr_scale"])
        if (sen.rollbacks, sen.lr_halvings, sen.lr_scale, scale) != \
                (2, 1, 0.5, 0.5) or runner.state.step != 8 or \
                not all(math.isfinite(x) for x in losses[-2:]):
            fail("phase 21 (b): the sustained fault gave %d rollbacks, %d LR "
                 "halvings, scale %r (state %r), step %r, losses %r"
                 % (sen.rollbacks, sen.lr_halvings, sen.lr_scale, scale,
                    runner.state.step, losses))
        print("  (b) sustained NaN at steps 3-5 (budget 1 skip): rollback "
              "#1 to the step-2 checkpoint in %.1f ms, rollback #2 in %.1f "
              "ms, then the LR halved (scale %.2f on the card and on the "
              "host), %d skips in all, the run at step %d with losses %s "
              "[%s]" % (rollback_ms[0], rollback_ms[1], scale, sen.skips,
                        runner.state.step,
                        " ".join("%.4f" % x for x in losses), card))
        del runner
        adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def pinned_builder(schedule):
    """``AllReduce()`` with every synchronizer pinned to ``schedule``: how
    a user picks an all-reduce schedule."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.strategy.base import StrategyBuilder

    class Pinned(StrategyBuilder):
        def build(self, model_item, resource_spec):
            plan = strategy.AllReduce().build(model_item, resource_spec)
            for node in plan.node_config:
                if node.synchronizer is not None:
                    node.synchronizer.schedule = schedule
            return plan
    return Pinned()


def schedule_child(rank, world, store, out_dir, runs):
    """One rank of phase 21 (c) (spawned): bert_base bf16 on cuda:0 over
    gloo under ``AllReduce()`` pinned to each (schedule, steps) of
    ``runs``, in deterministic mode; writes each run's losses, times,
    launches and whether the ranks' params are bit-equal."""
    import statistics
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.resource_spec import ResourceSpec
    torch.use_deterministic_algorithms(True)
    cfg = bert.BertConfig.base(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = bert.make_train_setup(
        cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
        attention="flash")
    spec = DP_SPEC if world == DP_RANKS else HIER_SPEC
    out = {"rank": rank}
    for schedule, steps in runs:
        adt.reset()
        ad = adt.AutoDist(strategy_builder=pinned_builder(schedule),
                          resource_spec=ResourceSpec.from_dict(spec),
                          device="cuda:0")
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-3),
                          params, batch)
        runner.init(params)
        dstep = runner.distributed_step
        reset_counts()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(runner.run(batch)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[schedule] = {
            "losses": losses, "times_ms": [t * 1e3 for t in times],
            "p50_ms": statistics.median(times) * 1e3,
            "launches": launch_counts(),
            "scheduled": sum(s._scheduled() for s in dstep.syncs.values()),
            "syncs": len(dstep.syncs),
            "host_groups": repr(dstep.host_groups),
            "params_equal": ranks_equal(runner.gather_params())}
        del runner, dstep
    adt.reset()
    torch.use_deterministic_algorithms(False)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spawn_ranks(label, child, world, *args):
    """Run ``child(rank, world, store, out_dir, *args)`` on ``world``
    spawned ranks; returns their results in rank order."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(child, args=(world, os.path.join(tmp, "store"),
                                            tmp) + args,
                               nprocs=world, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("%s: a rank failed: %s" % (label, str(e).strip()[-2000:]))
        res = []
        for r in range(world):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
    print("  %s: %d ranks ran in %.1f s" % (label, world,
                                            time.perf_counter() - t0))
    return res


def schedules_phase(card, dp_losses):
    """Phase 21 (c): the rhd schedule at N = 2 and the hierarchical one at
    N = 4 (two loopback nodes of two ranks) on bert_base over gloo.
    Returns each kernel's launches over every rank's steps."""
    print("phase 21 (c): all-reduce schedules on bert_base (bf16, seq %d, "
          "global batch %d, flash) over gloo on cuda:0: rhd at N = %d (%d "
          "steps), run beside hier and ring at N = %d on two loopback nodes "
          "(%d steps each), deterministic mode"
          % (BERT_SEQ, BERT_BATCH, DP_RANKS, DP_STEPS["fp32"], HIER_RANKS,
             SCHED_STEPS))
    # the rhd job runs beside the hier job (their readings are losses and
    # informational step times)
    two = Beside(spawn_ranks, "(c) rhd", schedule_child, DP_RANKS,
                 [("rhd", DP_STEPS["fp32"])])
    four = spawn_ranks("(c) hier", schedule_child, HIER_RANKS,
                       [("hier", SCHED_STEPS), ("ring", SCHED_STEPS)])
    two = two.result()
    launches = {}
    for res, runs in ((two, ("rhd",)), (four, ("hier", "ring"))):
        for sched in runs:
            for r in res:
                run = r[sched]
                label = "phase 21 (c) %s rank %d" % (sched, r["rank"])
                check_launches(label, run["launches"], BERT_LAYERS,
                               len(run["losses"]))
                if not run["params_equal"]:
                    fail("%s: the ranks' params are not bit-equal" % label)
                if run["losses"] != res[0][sched]["losses"]:
                    fail("%s: the ranks' losses differ" % label)
                if sched != "ring" and run["scheduled"] != run["syncs"]:
                    fail("%s: %d of %d synchronizers run the schedule"
                         % (label, run["scheduled"], run["syncs"]))
                for name, by in run["launches"].items():
                    for design, n in by.items():
                        launches.setdefault(name, {})
                        launches[name][design] = \
                            launches[name].get(design, 0) + n
    rhd = two[0]["rhd"]
    for got, want in zip(rhd["losses"], dp_losses):
        if not abs(got - want) <= 2e-2 * max(1.0, abs(want)):
            fail("phase 21 (c): rhd losses %r are not within 2e-2 of phase "
                 "10's fp32 wire %r" % (rhd["losses"], dp_losses))
    hier, ring = four[0]["hier"], four[0]["ring"]
    for got, want in zip(hier["losses"], ring["losses"]):
        if not abs(got - want) <= 2e-2 * max(1.0, abs(want)):
            fail("phase 21 (c): hier losses %r are not within 2e-2 of the "
                 "ring's %r" % (hier["losses"], ring["losses"]))
    print("  (c) rhd, N = %d: losses %s (phase 10's fp32 wire: %s; equal: "
          "%s), ranks bit-equal; step p50 %.1f / %.1f ms (ranks 0 / 1) "
          "[%s]"
          % (DP_RANKS, " ".join("%.4f" % x for x in rhd["losses"]),
             " ".join("%.4f" % x for x in dp_losses),
             rhd["losses"] == list(dp_losses), rhd["p50_ms"],
             two[1]["rhd"]["p50_ms"], card))
    print("  (c) hier, N = %d (%s): losses %s, ring %s, ranks bit-equal; "
          "step p50 hier %s ms, ring %s ms (ranks 0-3) [%s]"
          % (HIER_RANKS, hier["host_groups"],
             " ".join("%.4f" % x for x in hier["losses"]),
             " ".join("%.4f" % x for x in ring["losses"]),
             " / ".join("%.1f" % r["hier"]["p50_ms"] for r in four),
             " / ".join("%.1f" % r["ring"]["p50_ms"] for r in four), card))
    return launches


def health_phase(card, dp_losses, gathered_ms, shard):
    """Phase 21: sharded checkpoints of tp_lm, the health sentinel and the
    rhd and hierarchical schedules on bert_base; (c)'s ranks run beside
    (b), whose readings are deterministic counts and paired timings.
    Returns (a)'s, (b)'s and (c)'s launches."""
    sharded = sharded_phase(card, gathered_ms, shard)
    schedules = Beside(schedules_phase, card, dp_losses)
    return sharded, sentinel_phase(card), schedules.result()


# ------------------------------------------------------------- phase 22


INRUN_STEPS = DP_STEPS["fp32"]   # 5: phase 10's fp32-wire run's steps
INRUN_DIE_AFTER = 1              # the worker's first incarnation dies here
INRUN_ADMIT_WAIT_S = 120         # the chief's bound on the grow's wait

# The user script of phase 22: the chief runs it from the phase, and
# relaunches it for its worker (twice: at launch, and after the in-run
# shrink for grow-on-join). Each process appends its events to <out
# dir>/inrun_<role>.jsonl as the steps go. argv: spec, out dir.
INRUN_SCRIPT = r"""
import functools, hashlib, json, os, sys, time
T_START = time.time()
import torch
import torch.distributed as dist
import chip_smoke as cs
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.telemetry import spans as tel

spec, outdir = sys.argv[1], sys.argv[2]
worker = os.environ.get("ADT_WORKER", "")
died = os.path.join(outdir, "inrun_died")
joiner = bool(worker) and os.path.exists(died)
tel.configure("1")   # the reconfigure and broadcast spans
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
events = open(os.path.join(outdir, "inrun_%s.jsonl"
                           % ("worker" if worker else "chief")), "a")

def record(event, **kw):
    kw.update(event=event, t=time.time(), joiner=joiner, pid=os.getpid())
    events.write(json.dumps(kw) + "\n")
    events.flush()

def wait_epoch(m, bound):
    # the chief stays out of a step until the next epoch is published
    t = time.monotonic()
    while time.monotonic() - t < bound:
        info = m.peek(fresh=True)
        if info is not None and info[0] > m.epoch:
            return time.monotonic() - t
        time.sleep(0.05)
    return None

record("start", t_start=T_START)
ad = adt.AutoDist(resource_spec_file=spec,
                  strategy_builder=strategy.AllReduce())
from autodist_tpu_torch.models import bert
torch.use_deterministic_algorithms(True)
cfg = bert.BertConfig.base(dtype=torch.bfloat16)
loss_fn, params, batch, _ = bert.make_train_setup(
    cfg, seq_len=cs.BERT_SEQ, batch_size=cs.BERT_BATCH, seed=0,
    attention="flash")
runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                  params, batch)
t = time.perf_counter()
runner.init(params)  # a joiner takes the chief's state here
torch.cuda.synchronize()
start = int(runner.state.step)
rec = tel.get_recorder()
record("init", ms=1e3 * (time.perf_counter() - t), step=start,
       rank=runner.distributed_step.rank,
       world=runner.distributed_step.num_replicas, device=str(ad.device),
       broadcast_ms=[1e3 * d for d in rec.durations_s("elastic.broadcast")])
m = elastic.current()
cs.reset_counts()
for i in range(start, cs.INRUN_STEPS):
    if not worker and i == cs.INRUN_DIE_AFTER + 1:
        # out of the step's collective until the shrink epoch lands (the
        # JAX in-run test's pacing): the shrink then runs at the boundary
        record("shrink_wait", s=wait_epoch(m, 60))
    if not worker and i == cs.INRUN_DIE_AFTER + 2:
        record("admit_wait", s=wait_epoch(m, cs.INRUN_ADMIT_WAIT_S))
    t = time.perf_counter()
    loss = float(runner.run(batch)["loss"])
    torch.cuda.synchronize()
    dstep = runner.distributed_step
    record("step", step=i, loss=loss, ms=1e3 * (time.perf_counter() - t),
           launches=cs.launch_counts(), rank=dstep.rank,
           world=dstep.num_replicas, epoch=m.epoch)
    cs.reset_counts()
    if worker and not joiner and i == cs.INRUN_DIE_AFTER:
        open(died, "w").close()
        record("death")
        os._exit(3)  # the worker's first incarnation dies
full = runner.gather_params()
digest = hashlib.md5()
for name in sorted(full):
    digest.update(full[name].detach().float().cpu().numpy().tobytes())
c = tel.counters()
record("done", rank=runner.distributed_step.rank, digest=digest.hexdigest(),
       epoch=m.epoch, reconfigs=runner.step_stats()["elastic"]["reconfigs"],
       reconfigure_ms=[1e3 * d for d in rec.durations_s(
           "elastic.reconfigure")],
       broadcast_ms=[1e3 * d for d in rec.durations_s("elastic.broadcast")],
       broadcast_bytes=c.get("elastic.broadcast_bytes", 0.0))
"""


def inrun_phase(card, dp_losses, whole_job_s):
    """Phase 22: in-run shrink and grow. bert_base at full width under
    AllReduce(), launched by the chief on two processes of cuda:0 (phase
    19 (a)'s job), ADT_ELASTIC=2 ADT_ELASTIC_SYNC=1 ADT_ELASTIC_INRUN=1:
    steps 0-1 at N = 2; the worker's first incarnation exits 3; step 2
    at N = 1 after the in-run shrink; the chief waits (at most 120 s)
    until the relaunched worker is admitted; steps 3-4 at N = 2 after the
    grow. ``whole_job_s()`` gives phase 19 (a)'s whole-job recovery (s),
    printed beside the shrink's. Returns every rank-step's launches."""
    import tempfile
    print("phase 22: bert_base bf16 (seq %d, global batch %d, flash) under "
          "AllReduce(), launched by the chief on 127.0.0.1 and localhost "
          "(gpus [0] each: two processes on cuda:0), ADT_ELASTIC=2 "
          "ADT_ELASTIC_SYNC=1 ADT_ELASTIC_INRUN=1, deterministic mode, %d "
          "steps: the worker's first incarnation exits 3 after step %d, the "
          "job shrinks in-run to one process, then grows back when the "
          "relaunched worker is admitted (run beside phase 18 and phase 19's "
          "jobs)"
          % (BERT_SEQ, BERT_BATCH, INRUN_STEPS, INRUN_DIE_AFTER))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inrun_script.py"), "w") as f:
            f.write(INRUN_SCRIPT)
        with open(os.path.join(tmp, "spec.yml"), "w") as f:
            f.write(LAUNCH_SPEC)
        rc, err, wall, left = run_launched(
            tmp, "inrun", 0, 240, "phase 22", script="inrun_script.py",
            ADT_ELASTIC="2", ADT_ELASTIC_SYNC="1", ADT_ELASTIC_INRUN="1",
            ADT_ELASTIC_POLL_S="0.05",
            ADT_CKPT_DIR=os.path.join(tmp, "ckpt"))
        chief = read_events(tmp, "inrun", "chief")
        wk = read_events(tmp, "inrun", "worker")
    if rc != 0 or left:
        fail("phase 22: the chief exited %d, %d processes left: %s"
             % (rc, len(left), err[-4000:]))
    if "restarting the WHOLE job" in err:
        fail("phase 22: the chief restarted the whole job: %s" % err[-4000:])
    for text in ("published cluster epoch 2", "published cluster epoch 3",
                 "in-run elastic: admitted localhost"):
        if text not in err:
            fail("phase 22: %r not in the log: %s" % (text, err[-4000:]))
    steps = {}
    launches = {}
    for e in chief + wk:
        if e["event"] != "step":
            continue
        role = "chief" if e in chief else ("joiner" if e["joiner"]
                                           else "worker")
        steps.setdefault(role, {})[e["step"]] = e
        check_launches("phase 22 %s step %d (N = %d)" % (
            role, e["step"], e["world"]), e["launches"], BERT_LAYERS, 1)
        for name, by in e["launches"].items():
            for design, n in by.items():
                launches.setdefault(name, {})
                launches[name][design] = launches[name].get(design, 0) + n
    die = INRUN_DIE_AFTER
    want = {"chief": list(range(INRUN_STEPS)),
            "worker": list(range(die + 1)),
            "joiner": list(range(die + 2, INRUN_STEPS))}
    got = {r: sorted(steps.get(r, {})) for r in want}
    if got != want:
        fail("phase 22: the steps each process ran %r (want %r)"
             % (got, want))
    worlds = [steps["chief"][i]["world"] for i in range(INRUN_STEPS)]
    want_worlds = [2] * (die + 1) + [1] + [2] * (INRUN_STEPS - die - 2)
    if worlds != want_worlds:
        fail("phase 22: the chief's worlds %r (want %r)"
             % (worlds, want_worlds))
    losses = [steps["chief"][i]["loss"] for i in range(INRUN_STEPS)]
    for role, first in (("worker", 0), ("joiner", die + 2)):
        mine = [steps[role][i]["loss"] for i in want[role]]
        if mine != losses[first:first + len(mine)]:
            fail("phase 22: the %s's losses %r differ from the chief's %r"
                 % (role, mine, losses))
    if losses[:die + 1] != list(dp_losses[:die + 1]):
        fail("phase 22: steps 0-%d %r are not bit-equal to phase 10's "
             "uninterrupted fp32-wire run %r" % (die, losses, dp_losses))
    for i in range(die + 1, INRUN_STEPS):
        if not abs(losses[i] - dp_losses[i]) <= 2e-2 * max(
                1.0, abs(dp_losses[i])):
            fail("phase 22: step %d's loss %r is not within 2e-2 of phase "
                 "10's %r" % (i, losses[i], dp_losses[i]))
    done = {("chief" if e in chief else "joiner"): e
            for e in chief + wk if e["event"] == "done"}
    if sorted(done) != ["chief", "joiner"] or \
            done["chief"]["digest"] != done["joiner"]["digest"]:
        fail("phase 22: the ranks' params after the grow are not bit-equal "
             "(%r)" % ({r: e.get("digest") for r, e in done.items()},))
    ch = done["chief"]
    if ch["epoch"] != 3 or ch["reconfigs"] != 2 or \
            len(ch["reconfigure_ms"]) != 2 or done["joiner"]["epoch"] != 3:
        fail("phase 22: the chief ended at epoch %r after %r reconfigures "
             "(spans %r), the joiner at %r (want 3, 2, 2 spans, 3)"
             % (ch["epoch"], ch["reconfigs"], ch["reconfigure_ms"],
                done["joiner"]["epoch"]))
    death = next(e["t"] for e in wk if e["event"] == "death")
    shrunk = steps["chief"][die + 1]
    joined = next(e for e in wk if e["event"] == "init" and e["joiner"])
    jstart = next(e for e in wk if e["event"] == "start" and e["joiner"])
    admit = next(e for e in chief if e["event"] == "admit_wait")
    shrink_ms, grow_ms = ch["reconfigure_ms"]
    print("  losses %s (chief), steps 0-%d bit-equal to phase 10's "
          "uninterrupted fp32-wire run, steps %d-%d within 2e-2 of it "
          "(%s); the worker's and the joiner's losses equal the chief's; "
          "the ranks' params bit-equal after the grow (md5 %s); each kernel "
          "12 launches a rank-step on mma.sync bf16 at N = 1 and N = 2 (%d "
          "rank-steps) [%s]"
          % (" ".join("%.6f" % x for x in losses), die, die + 1,
             INRUN_STEPS - 1, " ".join("%.6f" % x for x in dp_losses),
             ch["digest"][:12], sum(len(v) for v in steps.values()), card))
    print("  shrink: the worker's death to the chief's first step at N = 1 "
          "%.2f s (the reconfigure %.1f ms of it, the step %.1f ms); phase "
          "19 (a)'s whole-job recovery in this run %s; grow: the relaunched "
          "worker started %.2f s after the death, the chief waited %.2f s "
          "for its admission, the reconfigure %.1f ms (of it the broadcast "
          "of %.1f MB of params and Adam moments to the joiner: %.1f ms on "
          "the joiner, %.1f ms on the chief, which waits there for the "
          "joiner's build); the steps at N = 1 and after the grow %s ms; "
          "the job %.1f s [%s]"
          % (shrunk["t"] - death, shrink_ms, shrunk["ms"],
             "%.2f s" % whole_job_s() if whole_job_s is not None else
             "not measured", jstart["t_start"] - death, admit["s"] or -1.0,
             grow_ms, ch["broadcast_bytes"] / 1e6,
             (joined["broadcast_ms"] or [0.0])[0],
             (ch["broadcast_ms"] or [0.0])[0],
             " ".join("%.1f" % steps["chief"][i]["ms"]
                      for i in range(die + 1, INRUN_STEPS)), wall, card))
    print("phase 22: %.1f s" % (time.perf_counter() - t0))
    return launches, {"shrink_ms": shrink_ms, "grow_ms": grow_ms,
                      "death_to_step_s": shrunk["t"] - death,
                      "broadcast_bytes": ch["broadcast_bytes"],
                      "broadcast_ms": (joined["broadcast_ms"] or [None])[0]}


# ------------------------------------------------------------- phase 23


PREEMPT_STEPS = DP_STEPS["fp32"] + 1  # 6; steps 0-4 held to phase 10's
PREEMPT_AFTER = 1          # the chief evicts its worker after this step
PREEMPT_DEADLINE_S = 60    # the SIGTERM's grace, then the SIGKILL
SKIP_LAYERS = 2            # (b): bert_base at 2 of its 12 layers
DRAIN_RETRY_S = 2.5        # (c): the shed requests' Retry-After

# The user script of phase 23 (a): the chief runs it from the phase and
# relaunches it for its worker. Each process appends its events to <out
# dir>/preempt_<role>.jsonl as the steps go. argv: spec, out dir.
PREEMPT_SCRIPT = r"""
import functools, json, os, sys, time
T_START = time.time()
import torch
import chip_smoke as cs
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.checkpoint import latest_checkpoint
from autodist_tpu_torch.runtime import elastic, faultinject, preemption
from autodist_tpu_torch.runtime.coordination import CoordinationClient
from autodist_tpu_torch.telemetry import blackbox
from autodist_tpu_torch.telemetry import spans as tel

spec, outdir = sys.argv[1], sys.argv[2]
worker = bool(os.environ.get("ADT_WORKER", ""))
role = "worker" if worker else "chief"
tel.configure("1")   # the rescue, handoff and reconfigure spans
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
events = open(os.path.join(outdir, "preempt_%s.jsonl" % role), "a")

def record(event, **kw):
    kw.update(event=event, t=time.time(), pid=os.getpid())
    events.write(json.dumps(kw) + "\n")
    events.flush()

def counters():
    c = tel.counters()
    return {k: c.get(k, 0.0) for k in (
        "elastic.step_reruns", "elastic.ckpt_fallbacks", "ckpt.fallback",
        "preempt.rescue_saves", "preempt.rescue_skips", "preempt.handoffs",
        "preempt.planned_shrinks")}

record("start", t_start=T_START)
ad = adt.AutoDist(resource_spec_file=spec,
                  strategy_builder=strategy.AllReduce())
from autodist_tpu_torch.models import bert
torch.use_deterministic_algorithms(True)
cfg = bert.BertConfig.base(dtype=torch.bfloat16)
loss_fn, params, batch, _ = bert.make_train_setup(
    cfg, seq_len=cs.BERT_SEQ, batch_size=cs.BERT_BATCH, seed=0,
    attention="flash")
runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                  params, batch)
runner.init(params)
torch.cuda.synchronize()
m = elastic.current()
rec = tel.get_recorder()
record("init")
cs.reset_counts()
try:
    for i in range(cs.PREEMPT_STEPS):
        t = time.perf_counter()
        loss = float(runner.run(batch)["loss"])
        torch.cuda.synchronize()
        dstep = runner.distributed_step
        record("step", step=i, loss=loss,
               ms=1e3 * (time.perf_counter() - t),
               launches=cs.launch_counts(), world=dstep.num_replicas,
               epoch=m.epoch)
        cs.reset_counts()
        if not worker and i == cs.PREEMPT_AFTER:
            path = os.path.join(outdir, "preempt_worker.jsonl")
            pid = None
            while pid is None:
                if os.path.exists(path):
                    with open(path) as f:
                        pid = next((json.loads(line)["pid"] for line in f
                                    if '"init"' in line), None)
                time.sleep(0.01)
            record("evict", worker_pid=pid)
            faultinject.deliver_preemption(pid, cs.PREEMPT_DEADLINE_S)
except preemption.PlannedDeparture as e:
    sig = preemption.signal_notice()
    record("departed", code=e.code, reason=e.reason,
           announced=sig.announced if sig is not None else None,
           counters=counters(), epoch=m.epoch,
           rescue_ms=[1e3 * d for d in rec.durations_s("preempt.rescue_save")],
           handoff_s=runner._preempt.last_handoff_s,
           dump=blackbox.dump("departure"))
    raise
c = CoordinationClient("127.0.0.1", int(os.environ["ADT_COORDSVC_PORT"]))
t = time.monotonic()   # the leaver stamps preempt/left as it exits
while not preemption.has_left(c, "localhost") and time.monotonic() - t < 60:
    time.sleep(0.05)
plan = preemption.read_plan(c, "localhost")
record("done", counters=counters(), epoch=m.epoch,
       left=preemption.has_left(c, "localhost"),
       rescue_step=plan["rescue_step"] if plan else None,
       committed=latest_checkpoint(os.environ["ADT_CKPT_DIR"])[0],
       reconfigs=runner.step_stats()["elastic"]["reconfigs"],
       reconfigure_ms=[1e3 * d for d in rec.durations_s(
           "elastic.reconfigure")],
       planned=[bool(e.args.get("planned")) for e in rec.events()
                if e.name == "elastic.reconfigure"],
       rescue_ms=[1e3 * d for d in rec.durations_s("preempt.rescue_save")])
c.close()
"""


def start_preempt(tmp):
    """Start phase 23 (a)'s job in ``tmp``; :func:`planned_departure_check`
    waits for it."""
    with open(os.path.join(tmp, "preempt_script.py"), "w") as f:
        f.write(PREEMPT_SCRIPT)
    with open(os.path.join(tmp, "spec.yml"), "w") as f:
        f.write(LAUNCH_SPEC)
    return start_launched(
        tmp, "preempt", 0, script="preempt_script.py", ADT_ELASTIC="1",
        ADT_ELASTIC_SYNC="1", ADT_ELASTIC_INRUN="1",
        ADT_ELASTIC_POLL_S="0.05", ADT_PREEMPT_POLL_S="0.05",
        ADT_PREEMPT_DEADLINE_S=str(PREEMPT_DEADLINE_S), ADT_BLACKBOX="1",
        ADT_BLACKBOX_DIR=os.path.join(tmp, "bb"),
        ADT_CKPT_DIR=os.path.join(tmp, "ckpt"))


def planned_departure_check(card, tmp, job, dp_losses, unplanned_ms):
    """Phase 23 (a)'s gates and readings, once its job has ended. Returns
    both ranks' launches."""
    from autodist_tpu_torch.telemetry import blackbox
    rc, err, wall, left = finish_launched(job, 300, "phase 23 (a)")
    chief = read_events(tmp, "preempt", "chief")
    wk = read_events(tmp, "preempt", "worker")
    if rc != 0 or left:
        fail("phase 23 (a): the chief exited %d, %d processes left: %s"
             % (rc, len(left), err[-4000:]))
    if "restarting the WHOLE job" in err:
        fail("phase 23 (a): the chief restarted the whole job: %s"
             % err[-4000:])
    for text in ("planned shrink for announced leaver localhost",
                 "announced leaver localhost exited with code 0 — planned "
                 "departure complete", "rescue checkpoint committed"):
        if text not in err:
            fail("phase 23 (a): %r not in the log: %s" % (text, err[-4000:]))
    gone = next((e for e in wk if e["event"] == "departed"), None)
    done = next((e for e in chief if e["event"] == "done"), None)
    if gone is None or done is None:
        fail("phase 23 (a): the worker's departure or the chief's end was "
             "not recorded: %s" % err[-4000:])
    if gone["code"] != 0 or gone["reason"] != "sigterm" or not done["left"]:
        fail("phase 23 (a): the worker left with code %r (%r), preempt/left "
             "%r (want 0, sigterm, True)"
             % (gone["code"], gone["reason"], done["left"]))
    # the survivors' epoch was published while the worker was alive
    shrink_t = log_time(err, "planned shrink for announced leaver")
    if shrink_t is None or shrink_t >= gone["t"]:
        fail("phase 23 (a): the survivors' epoch (%r) was not published "
             "before the worker's departure (%r)" % (shrink_t, gone["t"]))
    cc, wc = done["counters"], gone["counters"]
    r = done["rescue_step"]
    if cc["preempt.rescue_saves"] != 1 or wc["preempt.rescue_saves"] != 1 \
            or done["committed"] != r:
        fail("phase 23 (a): rescue saves %r / %r, plan step %r, newest "
             "committed checkpoint %r (want 1, 1 at the plan's step)"
             % (cc["preempt.rescue_saves"], wc["preempt.rescue_saves"], r,
                done["committed"]))
    for who, c in (("chief", cc), ("worker", wc)):
        if c["elastic.step_reruns"] or c["elastic.ckpt_fallbacks"] or \
                c["ckpt.fallback"]:
            fail("phase 23 (a): the %s re-ran or restored: %r" % (who, c))
    if done["planned"] != [True] or done["reconfigs"] != 1 or \
            done["epoch"] != 2:
        fail("phase 23 (a): the chief's reconfigures %r (planned %r), epoch "
             "%r (want one planned, epoch 2)"
             % (done["reconfigs"], done["planned"], done["epoch"]))
    dumps = [blackbox.load_dump(os.path.join(tmp, "bb", f))
             for f in sorted(os.listdir(os.path.join(tmp, "bb")))
             if f.endswith(".json")]
    sig = [d for d in dumps if d["pid"] == gone["pid"]
           and d["trigger"] == "fatal signal SIGTERM"]
    kinds = [e["kind"] for e in sig[0]["events"]] if sig else []
    if "preempt.notice" not in kinds or "signal" not in kinds or \
            kinds.index("preempt.notice") > kinds.index("signal"):
        fail("phase 23 (a): the worker's SIGTERM dump holds %r (want the "
             "notice before the signal)" % (kinds,))
    steps, launches = {}, {}
    for role, evs in (("chief", chief), ("worker", wk)):
        for e in evs:
            if e["event"] != "step":
                continue
            steps.setdefault(role, {})[e["step"]] = e
            check_launches("phase 23 (a) %s step %d (N = %d)" % (
                role, e["step"], e["world"]), e["launches"], BERT_LAYERS, 1)
            for name, by in e["launches"].items():
                for design, n in by.items():
                    launches.setdefault(name, {})
                    launches[name][design] = launches[name].get(design, 0) + n
    want = {"chief": list(range(PREEMPT_STEPS)), "worker": list(range(r))}
    got = {k: sorted(steps.get(k, {})) for k in want}
    if got != want:
        fail("phase 23 (a): the steps each process ran %r (want %r)"
             % (got, want))
    worlds = [steps["chief"][i]["world"] for i in range(PREEMPT_STEPS)]
    if worlds != [2] * r + [1] * (PREEMPT_STEPS - r) or r >= len(dp_losses):
        fail("phase 23 (a): the chief's worlds %r (plan step %r)"
             % (worlds, r))
    losses = [steps["chief"][i]["loss"] for i in range(PREEMPT_STEPS)]
    if [steps["worker"][i]["loss"] for i in range(r)] != losses[:r]:
        fail("phase 23 (a): the worker's losses differ from the chief's")
    if losses[:r] != list(dp_losses[:r]):
        fail("phase 23 (a): steps 0-%d %r are not bit-equal to phase 10's "
             "uninterrupted fp32-wire run %r" % (r - 1, losses, dp_losses))
    for i in range(r, len(dp_losses)):
        if not abs(losses[i] - dp_losses[i]) <= 1e-3 * abs(dp_losses[i]):
            fail("phase 23 (a): step %d's loss %r at N = 1 is not within "
                 "1e-3 of phase 10's %r" % (i, losses[i], dp_losses[i]))
    if not all(abs(x) < float("inf") for x in losses):
        fail("phase 23 (a): a loss is not finite: %r" % losses)
    evict = next(e for e in chief if e["event"] == "evict")
    first_one = steps["chief"][r]
    lost = (len([e for e in chief if e["event"] == "step"]) - PREEMPT_STEPS
            + int(cc["elastic.step_reruns"]))
    print("  losses %s (chief), steps 0-%d at N = 2 bit-equal to phase 10's "
          "uninterrupted fp32-wire run, steps %d-%d at N = 1 within 1e-3 of "
          "it (%s); the worker's equal the chief's; each kernel 12 launches "
          "a rank-step on mma.sync bf16 (%d rank-steps) [%s]"
          % (" ".join("%.6f" % x for x in losses), r - 1, r,
             len(dp_losses) - 1, " ".join("%.6f" % x for x in dp_losses),
             sum(len(v) for v in steps.values()), card))
    print("  the worker: SIGTERM %.3f s after the chief's step %d, exit 0 "
          "(PlannedDeparture, sigterm) %.2f s after its notice, preempt/left "
          "stamped, its SIGTERM dump holds the notice before the signal; the "
          "chief published epoch 2 %.2f s before the departure; both saved "
          "the rescue checkpoint at step %d (the chief %s ms, the worker %s "
          "ms: rank 0 writes); handoff %.1f ms [%s]"
          % (evict["t"] - steps["chief"][PREEMPT_AFTER]["t"], PREEMPT_AFTER,
             gone["t"] - gone["announced"], gone["t"] - shrink_t, r,
             " ".join("%.1f" % x for x in done["rescue_ms"]),
             " ".join("%.1f" % x for x in gone["rescue_ms"]),
             1e3 * (gone["handoff_s"] or 0.0), card))
    print("  the survivor's planned reconfigure %.1f ms (phase 22's unplanned "
          "shrink in this run: %s); the notice to the chief's first step at "
          "N = 1 %.2f s; steps lost %d (step re-runs %d, checkpoint "
          "fallbacks %d); the steps at N = 1 %s ms; the job %.1f s [%s]"
          % (done["reconfigure_ms"][0],
             "%.1f ms" % unplanned_ms if unplanned_ms is not None else
             "not measured", first_one["t"] - gone["announced"], lost,
             int(cc["elastic.step_reruns"]),
             int(cc["elastic.ckpt_fallbacks"]),
             " ".join("%.1f" % steps["chief"][i]["ms"]
                      for i in range(r, PREEMPT_STEPS)), wall, card))
    return launches


def rescue_skip_phase(card):
    """Phase 23 (b): one process of bert_base at 2 of its 12 layers, full
    width, a maintenance file whose grace is below the measured save's
    p99 x 1.5: the rescue save is skipped, no checkpoint directory is
    torn, and the run departs solo with exit code 0. Returns its
    launches."""
    import tempfile
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.checkpoint import integrity
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.runtime import preemption
    from autodist_tpu_torch.telemetry import spans as tel
    adt_reset()
    tmp = tempfile.mkdtemp()
    maint = os.path.join(tmp, "maintenance.json")
    os.environ["ADT_MAINTENANCE_FILE"] = maint
    try:
        cfg = bert.BertConfig.base(dtype=torch.bfloat16,
                                   num_layers=SKIP_LAYERS)
        loss_fn, params, batch, _ = bert.make_train_setup(
            cfg, seq_len=BERT_SEQ, batch_size=BERT_BATCH, seed=0,
            attention="flash")
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-3), params, batch)
        runner.init(params)
        reset_counts()
        runner.run(batch)
        ckpt = os.path.join(tmp, "ckpt")
        saver = Saver(directory=ckpt)
        saver.save(runner)   # the measured save the budget reads
        saver.wait()
        p99_s = tel.hist_quantile("ckpt.save_ms", 0.99) / 1e3
        grace = min(1.0, p99_s)
        with open(maint, "w") as f:
            json.dump({"deadline_s": grace, "reason": "maintenance"}, f)
        skips = tel.counters().get("preempt.rescue_skips", 0.0)
        steps = 1
        try:
            for _ in range(5):
                runner.run(batch)
                steps += 1
            fail("phase 23 (b): no departure within 5 steps of the notice")
        except preemption.PlannedDeparture as e:
            code, reason = e.code, e.reason
        torch.cuda.synchronize()
        launches = launch_counts()
        stats = runner.step_stats()["preempt"]
        scans = integrity.scan(ckpt)
    finally:
        os.environ.pop("ADT_MAINTENANCE_FILE", None)
    if code != 0 or reason != "maintenance" or \
            tel.counters().get("preempt.rescue_skips", 0.0) != skips + 1 \
            or stats["rescue_saves"] != 0 or stats["handoffs"] != 1:
        fail("phase 23 (b): exit %r (%r), rescue skips %r, saves %r, "
             "handoffs %r (want 0, maintenance, 1, 0, 1)"
             % (code, reason, tel.counters().get("preempt.rescue_skips"),
                stats["rescue_saves"], stats["handoffs"]))
    if [s.state for s in scans] != ["committed"] or \
            any(f.endswith(".tmp") for f in os.listdir(ckpt)):
        fail("phase 23 (b): the checkpoint directory holds %r (want the one "
             "committed save)" % sorted(os.listdir(ckpt)))
    check_launches("phase 23 (b)", launches, SKIP_LAYERS, steps)
    print("  (b) bert_base at %d layers: the save measured %.0f ms (p99), a "
          "maintenance file with %.2f s of grace: the rescue save skipped "
          "(x%.1f safety), no torn directory, exit 0 after %d steps, handoff "
          "%.1f ms [%s]"
          % (SKIP_LAYERS, 1e3 * p99_s, grace,
             preemption.RESCUE_SAFETY_FACTOR, steps,
             1e3 * stats["last_handoff_s"], card))
    adt_reset()
    return launches


def serve_drain_phase(card):
    """Phase 23 (c): phase 3's lm1b decode engine (full width, bf16, flash
    decode, 32 slots): 32 prompts in flight and 32 queued when
    ``preemption.drain_serving`` runs — the sequences in flight complete
    on the card, every queued one sheds with the typed Retry-After, and
    the shed count is returned. Returns flash_fwd's launches."""
    import numpy as np
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.runtime import preemption
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    from autodist_tpu_torch.serving.engine import ServingUnavailable
    adt_reset()
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    loss_fn, params, batch, _ = lm.make_train_setup(cfg, seq_len=64,
                                                    batch_size=8, seed=0)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    dcfg = DecodeConfig(slots=32, max_new_tokens=32, prefill_len=64)
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, "flash"), dcfg)
    engine.warmup()
    torch.cuda.synchronize()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, (1 + (i * 37) % 64,)).astype(
        np.int32) for i in range(2 * dcfg.slots)]
    hold, held = threading.Event(), threading.Event()
    step = engine._dispatch_step

    def held_step():
        held.set()
        hold.wait(timeout=60)
        return step()
    engine._dispatch_step = held_step
    reset_counts()
    t0 = time.perf_counter()
    in_flight = [engine.submit(p) for p in prompts[:dcfg.slots]]
    deadline = time.monotonic() + 120
    while len(engine.scheduler.live_slots()) < dcfg.slots and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    live = len(engine.scheduler.live_slots())
    queued = [engine.submit(p) for p in prompts[dcfg.slots:]]
    threading.Timer(0.2, hold.set).start()
    shed = preemption.drain_serving(retry_after_s=DRAIN_RETRY_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()["flash_fwd"]
    stats = engine.stats()
    results = [f.result(timeout=60) for f in in_flight]
    typed = 0
    for f in queued:
        try:
            f.result(timeout=1)
        except ServingUnavailable as e:
            typed += e.retry_after_s == DRAIN_RETRY_S
    try:
        engine.submit(prompts[0])
        late = None
    except ServingUnavailable as e:
        late = e.retry_after_s
    if live != dcfg.slots or shed != len(queued) or typed != len(queued) \
            or late != DRAIN_RETRY_S or stats["drained"] != dcfg.slots:
        fail("phase 23 (c): %d live at the drain, shed %r of %d (%d typed), "
             "a late submit's Retry-After %r, drained %r"
             % (live, shed, len(queued), typed, late, stats["drained"]))
    for r in results:
        toks = np.asarray(r["tokens"])
        if toks.shape != (32,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            fail("phase 23 (c): an in-flight result is wrong: %r" % (r,))
    want = {MAIN_DESIGN["flash_fwd"]: cfg.num_layers * stats["steps"]}
    if launches != want or stats["steps"] == 0:
        fail("phase 23 (c): flash_fwd launched %r over %d decode steps "
             "(want %r)" % (launches, stats["steps"], want))
    print("  (c) lm1b bf16 decode, %d slots: %d sequences in flight "
          "completed on the card (%d decode steps, flash_fwd %r), %d queued "
          "shed with ServingUnavailable(retry_after_s=%.1f), a submit after "
          "the drain shed the same; drain_serving returned %d; the drain "
          "%.2f s [%s]"
          % (dcfg.slots, len(results), stats["steps"], launches, len(queued),
             DRAIN_RETRY_S, shed, wall, card))
    adt_reset()
    return {"flash_fwd": launches}


def preempt_phase(card, dp_losses, unplanned_ms, beside=None):
    """Phase 23: the preemption plane. (a) runs beside (b), (c) and
    ``beside()`` (phase 21); returns (a)'s and (b)'s launches, (c)'s, and
    what ``beside`` returned."""
    import shutil
    import tempfile
    print("phase 23: the preemption plane — (a) bert_base bf16 (seq %d, "
          "global batch %d, flash) under AllReduce(), launched by the chief "
          "on 127.0.0.1 and localhost (two processes on cuda:0, gloo), "
          "ADT_ELASTIC_INRUN=1, deterministic mode, %d steps: the chief "
          "evicts the worker after step %d (SIGTERM, SIGKILL at %d s); (b) "
          "the rescue-skip branch; (c) the serving drain (run beside phase "
          "21)" % (BERT_SEQ, BERT_BATCH, PREEMPT_STEPS, PREEMPT_AFTER,
                   PREEMPT_DEADLINE_S))
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    job = start_preempt(tmp)
    try:
        skip_launches = rescue_skip_phase(card)
        drain_launches = serve_drain_phase(card)
        out = beside() if beside is not None else None
        launches = planned_departure_check(card, tmp, job, dp_losses,
                                           unplanned_ms)
    finally:
        kill_job("ADT_SMOKE_JOB=" + job["marker"])
        shutil.rmtree(tmp, ignore_errors=True)
    for name, by in skip_launches.items():
        for design, n in by.items():
            launches.setdefault(name, {})
            launches[name][design] = launches[name].get(design, 0) + n
    print("phase 23: %.1f s" % (time.perf_counter() - t0))
    return launches, drain_launches, out


# ------------------------------------------------------------- phase 24


PP_MICRO, PP_RANKS = 4, 2
PP_WARMUP, PP_TIMED = 2, 10          # (a)
PP2_WARMUP, PP2_TIMED = 2, 3         # (b), each schedule
PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")
PP_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                      "gpus": [0] * PP_RANKS}]}


def pp_model():
    """pipe_lm at ``TPLMConfig.flagship()``: (cfg, params from seed 0, the
    seq-1024 batch of 8)."""
    from autodist_tpu_torch.models import pipe_lm
    cfg = pipe_lm.TPLMConfig.flagship()
    _, params, batch, _ = pipe_lm.make_train_setup(
        cfg, seq_len=TP_SEQ, batch_size=TP_BATCH, seed=0)
    return cfg, params, batch


def pp_losses(cfg, schedule, pp, shapes=None):
    """pipe_lm's loss under ``schedule`` with ``PP_MICRO`` microbatches
    (the interleaved loss built for ``pp`` stages, V = 2): (the loss with
    the flash kernels in its ``attn_fn`` slot, the plain-attention loss).
    ``shapes`` collects the q shapes the flash slot sees."""
    from autodist_tpu_torch.models import pipe_lm
    from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
    flash = make_flash_attn_fn(causal=True)

    def attn(q, k, v):
        if shapes is not None:
            shapes.add(tuple(q.shape))
        return flash(q, k, v)
    kw = dict(n_microbatches=PP_MICRO, schedule=schedule, virtual_stages=2,
              pp_shards=pp if schedule == "interleaved" else 0)
    return pipe_lm.make_loss(cfg, attn_fn=attn, **kw), \
        pipe_lm.make_loss(cfg, **kw)


def pp_runner(pp, spec, schedule, loss_fn, params, batch):
    """``PipelineParallel(pp, pp_rules(), n_microbatches=PP_MICRO,
    schedule)`` built and initialized on ``cuda:0`` through the public
    entry points, Adam 1e-3, the loss's knobs declared in ``mp_meta``."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import pipe_lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.PipelineParallel(
        pp_shards=pp, n_microbatches=PP_MICRO, schedule=schedule,
        mp_rules=pipe_lm.pp_rules()),
        resource_spec=ResourceSpec.from_dict(spec), device="cuda:0")
    meta = {"pp_schedule": schedule, "pp_microbatches": PP_MICRO}
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch, mp_meta=meta)
    runner.init(params)
    return runner


def pp_launches(schedule, rank, layers):
    """Each kernel's launches a rank-step that ``schedule`` makes at
    ``PP_RANKS`` stages of ``PP_MICRO`` microbatches: every rank runs its
    layers' forward and backward once a microbatch; under 1F1B a rank
    that sends its activations on also runs each forward twice (its
    forward tick, then the backward tick's recompute), the last rank once
    (its forward output is never sent)."""
    per = layers // PP_RANKS * PP_MICRO
    fwd = 2 * per if (schedule == "1f1b" and rank < PP_RANKS - 1) else per
    return {"flash_fwd": fwd, "flash_bwd_dq": per, "flash_bwd_dkdv": per}


def first_loss_check(label, got, want):
    if not abs(got - want) <= 2e-2 * max(1.0, abs(want)):
        fail("%s: the first loss %.6f is not within 2e-2 of %.6f"
             % (label, got, want))


def pp_child(rank, store, out_dir, env):
    """One rank of phase 24 (b) (spawned): take the environment ``env``,
    join the gloo group, then for each schedule in turn: the same setup's
    unbound loss on the card, ``PipelineParallel(2)`` over pipe_lm
    flagship, 2 warm-up and 3 timed steps; write this rank's results to
    ``out_dir``."""
    # the smoke's environment when the phase began: the phases beside it
    # set variables of their own in this process's parent for a while (23
    # (b)'s maintenance file would make these ranks depart)
    os.environ.clear()
    os.environ.update(env)
    import statistics
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, PP_RANKS),
                            rank=rank, world_size=PP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.telemetry import spans as tel
    out = {"rank": rank, "schedules": {}}
    cfg, params, batch = pp_model()
    for schedule in PP_SCHEDULES:
        shapes = set()
        loss_fn, _ = pp_losses(cfg, schedule, PP_RANKS, shapes)
        with torch.no_grad(), uncounted():
            dev = {n: t.to("cuda") for n, t in params.items()}
            unbound = float(loss_fn(dev, {"tokens": torch.as_tensor(
                batch["tokens"], device="cuda")}))
            del dev
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = pp_runner(PP_RANKS, PP_SPEC, schedule, loss_fn, params,
                           batch)
        init_s = time.perf_counter() - t0
        shapes.clear()
        reset_counts()
        before = tel.counters()
        losses, times = [], []
        for _ in range(PP2_WARMUP + PP2_TIMED):
            t0 = time.perf_counter()
            losses.append(float(runner.run(batch)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = launch_counts()
        after = tel.counters()
        steps = PP2_WARMUP + PP2_TIMED
        out["schedules"][schedule] = {
            "unbound": unbound, "losses": losses,
            "times_ms": [t * 1e3 for t in times],
            "p50_ms": statistics.median(times[PP2_WARMUP:]) * 1e3,
            "launches": launches, "shapes": sorted(shapes),
            "init_s": init_s, "layers": cfg.num_layers,
            "p2p_sends": (after.get("pp.p2p_sends", 0.0)
                          - before.get("pp.p2p_sends", 0.0)) / steps,
            "p2p_bytes": (after.get("pp.p2p_bytes", 0.0)
                          - before.get("pp.p2p_bytes", 0.0)) / steps,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "local_wq": list(runner.state.params["blocks/attn/wq"].shape)}
        del runner
        adt.reset()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def pp_one_phase(card):
    """Phase 24 (a): the kernels' records at (b)'s microbatch shape, then
    pipe_lm flagship through ``PipelineParallel(1)`` in this process.
    Returns (the records, each kernel's launches by design over the
    steps)."""
    import gc
    import torch
    import autodist_tpu_torch as adt
    print("phase 24 (a): pipe_lm flagship (bf16, seq %d, batch %d) through "
          "PipelineParallel(pp_shards=1), flash through attn_fn, one "
          "process" % (TP_SEQ, TP_BATCH))
    records = pp_kernel_records(card)
    cfg, params, batch = pp_model()
    loss_fn, plain = pp_losses(cfg, "gpipe", 1)
    n_params = sum(int(t.numel()) for t in params.values())
    if n_params != TP_PARAMS:
        fail("phase 24: pipe_lm flagship has %d parameters (want %d)"
             % (n_params, TP_PARAMS))
    with uncounted(), torch.no_grad():
        dev = {n: t.to("cuda") for n, t in params.items()}
        feed = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
        first = (float(loss_fn(dev, feed)), float(plain(dev, feed)))
        del dev, feed
    torch.cuda.empty_cache()
    print("  first loss: flash %.6f, plain causal attention %.6f" % first)
    first_loss_check("phase 24 (a)", *first)
    t0 = time.perf_counter()
    runner = pp_runner(1, TP_SPEC_ONE, "gpipe", loss_fn, params, batch)
    print("  (a) build + init %.1f s; %d parameters (random, seed 0)"
          % (time.perf_counter() - t0, n_params))
    times, launches = timed_steps(runner, batch, "phase 24 (a)",
                                  warmup=PP_WARMUP, steps=PP_TIMED)
    check_launches("phase 24 (a)", launches, cfg.num_layers,
                   PP_WARMUP + PP_TIMED)
    p50 = report_steps("(a) pipe_lm flagship PipelineParallel(1)", times,
                       TP_BATCH * TP_SEQ, "tokens",
                       tp_flops_per_step(cfg, n_params), card, launches)
    tp = READINGS.get("tp_lm_a_p50_ms")
    if tp:
        print("  (a) step p50 %.2f ms against phase 20 (a)'s tp_lm %.2f ms "
              "(x %.3f) [%s]" % (p50, tp, p50 / tp, card))
    del runner, params
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return records, launches


def pp_two_phase(card, env):
    """Phase 24 (b): pipe_lm flagship through ``PipelineParallel(2)`` on
    two processes of ``cuda:0`` in the environment ``env``, the three
    schedules in turn. Returns {schedule: each kernel's launches by
    design over both ranks}."""
    import math
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(pp_child, args=(os.path.join(tmp, "store"),
                                               tmp, env),
                               nprocs=PP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 24 (b): a rank failed: %s"
                 % (str(e).strip()[-2000:],))
        res = []
        for r in range(PP_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
    print("phase 24 (b): pipe_lm flagship through PipelineParallel("
          "pp_shards=%d, n_microbatches=%d), %d processes of cuda:0 over "
          "gloo, beside phases 21 and 23: %.1f s"
          % (PP_RANKS, PP_MICRO, PP_RANKS, time.perf_counter() - t0))
    shape = [TP_BATCH // PP_MICRO, TP_SEQ, 16, HEAD_DIM]
    steps = PP2_WARMUP + PP2_TIMED
    out = {}
    for schedule in PP_SCHEDULES:
        label = "phase 24 (b) %s" % schedule
        runs = [r["schedules"][schedule] for r in res]
        if runs[0]["losses"] != runs[1]["losses"]:
            fail("%s: the ranks' losses differ: %r vs %r"
                 % (label, runs[0]["losses"], runs[1]["losses"]))
        for rank, run in enumerate(runs):
            first_loss_check("%s rank %d" % (label, rank),
                             run["losses"][0], run["unbound"])
            if not all(math.isfinite(x) for x in run["losses"]):
                fail("%s: a loss is not finite: %r" % (label, run["losses"]))
            want = pp_launches(schedule, rank, run["layers"])
            for name, n in want.items():
                got = run["launches"][name]
                if got != {MAIN_DESIGN[name]: n * steps}:
                    fail("%s rank %d: %s launched %r over %d steps (want "
                         "%d a step on %s)" % (label, rank, name, got,
                                               steps, n, MAIN_DESIGN[name]))
            if run["shapes"] != [shape]:
                fail("%s rank %d: the flash slot saw q shapes %r (want %r)"
                     % (label, rank, run["shapes"], [shape]))
        launches = {}
        for run in runs:
            for name, by in run["launches"].items():
                for design, n in by.items():
                    launches.setdefault(name, {})
                    launches[name][design] = launches[name].get(design,
                                                                0) + n
        out[schedule] = launches
        r0, r1 = runs
        print("  (b) %s: losses %s (both ranks; unbound on the card %.4f, "
              "within 2e-2); step p50 %.1f / %.1f ms (ranks 0 / 1, steps %s "
              "ms); pp.p2p_bytes a step %.1f / %.1f MB in %.0f / %.0f "
              "sends; peak memory %.2f / %.2f GB; launches a rank-step "
              "fwd/dq/dkdv %s / %s; build + init %.1f s; wq a rank %r [%s]"
              % (schedule, " ".join("%.4f" % x for x in r0["losses"]),
                 r0["unbound"], r0["p50_ms"], r1["p50_ms"],
                 " ".join("%.1f" % t for t in r0["times_ms"]),
                 r0["p2p_bytes"] / 1e6, r1["p2p_bytes"] / 1e6,
                 r0["p2p_sends"], r1["p2p_sends"], r0["peak_gb"],
                 r1["peak_gb"],
                 "/".join(str(pp_launches(schedule, 0, r0["layers"])[k])
                          for k in KERNEL_SOURCES),
                 "/".join(str(pp_launches(schedule, 1, r1["layers"])[k])
                          for k in KERNEL_SOURCES),
                 r0["init_s"], r0["local_wq"], card))
    peaks = {s: max(r["schedules"][s]["peak_gb"] for r in res)
             for s in PP_SCHEDULES}
    print("  (b) peak memory a rank: gpipe %.2f GB, 1f1b %.2f GB, "
          "interleaved %.2f GB (1f1b below gpipe: %s)"
          % (peaks["gpipe"], peaks["1f1b"], peaks["interleaved"],
             peaks["1f1b"] < peaks["gpipe"]))
    return out


def pp_kernel_records(card):
    """The three kernels at (b)'s microbatch shape [2, 1024, 16, 64]
    causal: held to their plain versions and timed."""
    shape = (TP_BATCH // PP_MICRO, TP_SEQ, 16, HEAD_DIM)
    return kernel_timing(card, tp_kernel_check(shape), shape, True, None,
                         "[2,1024,16,64] causal")


MOE_SEQ, MOE_BATCH = 256, 16
MOE_PARAMS, MOE_EXPERT_PARAMS = 70724608, 33603584   # MoEConfig()'s
MOE_WARMUP, MOE_TIMED = 2, 8         # (a)
SPEP_RANKS = 2
SPEP_WARMUP, SPEP_TIMED = 2, 3       # (b), (c): each part
SPEP_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                        "gpus": [0] * SPEP_RANKS}]}


def moe_model():
    """moe_lm at ``MoEConfig()``: (cfg, its loss, params from seed 0, the
    seq-256 batch of 16)."""
    from autodist_tpu_torch.models import moe_lm
    cfg = moe_lm.MoEConfig()
    loss_fn, params, batch, _ = moe_lm.make_train_setup(
        cfg, seq_len=MOE_SEQ, batch_size=MOE_BATCH, seed=0)
    return cfg, loss_fn, params, batch


def mp_runner(builder, spec, loss_fn, params, batch):
    """``builder`` built and initialized on ``cuda:0`` through the public
    entry points, Adam 1e-3."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(strategy_builder=builder,
                      resource_spec=ResourceSpec.from_dict(spec),
                      device="cuda:0")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner


def moe_runner(ep, spec, loss_fn, params, batch):
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import moe_lm
    return mp_runner(strategy.ExpertParallel(
        ep_shards=ep, mp_rules=moe_lm.ep_rules()), spec, loss_fn, params,
        batch)


def moe_flops_per_step(cfg, n_params):
    """Closed-form training FLOPs of one moe_lm step: 6 x tokens x the
    parameters a token uses (outside the two tables, one expert of each
    stack; the head included) plus the attention products, 12 x layers x
    seq x d_model a token. The dense dispatch also runs the capacity's
    empty slots; they are not counted."""
    tokens = MOE_BATCH * MOE_SEQ
    active = n_params - (cfg.vocab_size + cfg.max_seq_len) * cfg.d_model \
        - MOE_EXPERT_PARAMS * (cfg.num_experts - 1) // cfg.num_experts
    return 6 * tokens * active + 12 * cfg.num_layers * MOE_SEQ * \
        cfg.d_model * tokens


def no_kernel_launched(label, launches):
    """The path ran none of the three kernels (its attention and experts
    are plain PyTorch, as in the JAX package)."""
    if any(sum(by.values()) for by in launches.values()):
        fail("%s: the flash kernels launched on a path that has none: %r"
             % (label, launches))


def moe_one_phase(card):
    """Phase 25 (a): moe_lm at full width through ``ExpertParallel(1)`` in
    this process."""
    import gc
    import torch
    import autodist_tpu_torch as adt
    print("phase 25 (a): moe_lm MoEConfig() (f32, seq %d, batch %d, 8 "
          "experts, capacity factor 2) through ExpertParallel(ep_shards=1),"
          " one process" % (MOE_SEQ, MOE_BATCH))
    cfg, loss_fn, params, batch = moe_model()
    n_params = sum(int(t.numel()) for t in params.values())
    n_expert = sum(int(t.numel()) for n, t in params.items()
                   if "/moe/" in n and n.rsplit("/", 1)[1] in
                   ("w1", "b1", "w2", "b2"))
    if (n_params, n_expert) != (MOE_PARAMS, MOE_EXPERT_PARAMS):
        fail("phase 25 (a): moe_lm has %d parameters, %d expert-stacked "
             "(want %d, %d)" % (n_params, n_expert, MOE_PARAMS,
                                MOE_EXPERT_PARAMS))
    t0 = time.perf_counter()
    runner = moe_runner(1, TP_SPEC_ONE, loss_fn, params, batch)
    print("  (a) build + init %.1f s; %d parameters (random, seed 0), %d "
          "expert-stacked" % (time.perf_counter() - t0, n_params, n_expert))
    times, launches = timed_steps(runner, batch, "phase 25 (a)",
                                  warmup=MOE_WARMUP, steps=MOE_TIMED)
    no_kernel_launched("phase 25 (a)", launches)
    report_steps("(a) moe_lm ExpertParallel(1)", times, MOE_BATCH * MOE_SEQ,
                 "tokens", moe_flops_per_step(cfg, n_params), card,
                 "none")
    del runner, params
    adt.reset()
    gc.collect()
    torch.cuda.empty_cache()


def spep_steps(runner, batch, counters):
    """``SPEP_WARMUP`` + ``SPEP_TIMED`` steps on this rank: the losses,
    each step's ms, the timed steps' p50, ``counters`` a step, the peak
    memory and each kernel's launches."""
    import statistics
    import torch
    from autodist_tpu_torch.telemetry import spans as tel
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    before = tel.counters()
    losses, times = [], []
    for _ in range(SPEP_WARMUP + SPEP_TIMED):
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    after = tel.counters()
    steps = SPEP_WARMUP + SPEP_TIMED
    return {"losses": losses, "times_ms": [t * 1e3 for t in times],
            "p50_ms": statistics.median(times[SPEP_WARMUP:]) * 1e3,
            "per_step": {k: (after.get(k, 0.0) - before.get(k, 0.0)) / steps
                         for k in counters},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launch_counts()}


def spep_child(rank, store, out_dir, env):
    """One rank of phase 25 (b)-(c) (spawned): take the environment
    ``env``, join the gloo group; (b) moe_lm under ``ExpertParallel(2)``
    after the unbound loss of each rank's rows; (c) tp_lm flagship under
    ``TensorParallel(1, seq_shards=2)`` with ring, then Ulysses attention
    (rank 0 first computes the one-process plain-attention loss); write
    this rank's results to ``out_dir``."""
    os.environ.clear()
    os.environ.update(env)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, SPEP_RANKS),
                            rank=rank, world_size=SPEP_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import tp_lm
    out = {"rank": rank}
    # (b)
    _, loss_fn, params, batch = moe_model()
    rows = MOE_BATCH // SPEP_RANKS
    with torch.no_grad(), uncounted():
        dev = {n: t.to("cuda") for n, t in params.items()}
        out["moe_unbound"] = [float(loss_fn(dev, {"tokens": torch.as_tensor(
            batch["tokens"][r * rows:(r + 1) * rows], device="cuda")}))
            for r in range(SPEP_RANKS)]
        del dev
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runner = moe_runner(SPEP_RANKS, SPEP_SPEC, loss_fn, params, batch)
    init_s = time.perf_counter() - t0
    out["moe"] = dict(spep_steps(runner, batch, ("ep.a2a_bytes",
                                                 "ep.a2a_calls")),
                      init_s=init_s,
                      w1=list(runner.state.params["layer_0/moe/w1"].shape),
                      sparse=sorted(runner.distributed_step.sparse_wire))
    del runner, params
    adt.reset()
    torch.cuda.empty_cache()
    # (c)
    cfg = tp_lm.TPLMConfig.flagship()
    plain, params, batch, _ = tp_lm.make_train_setup(
        cfg, seq_len=TP_SEQ, batch_size=TP_BATCH, seed=0)
    tokens = {"tokens": batch["tokens"][:, :TP_SEQ]}
    if rank == 0:
        with torch.no_grad(), uncounted():
            dev = {n: t.to("cuda") for n, t in params.items()}
            # over tokens[:, :-1] -> tokens[:, 1:]: the S - 1 targets the
            # sequence-parallel loss keeps
            out["sp_plain"] = float(plain(dev, {"tokens": torch.as_tensor(
                tokens["tokens"], device="cuda")}))
            del dev
        torch.cuda.empty_cache()
    for attention in ("ring", "ulysses"):
        loss_fn = tp_lm.make_loss(cfg, attention=attention)
        t0 = time.perf_counter()
        runner = mp_runner(strategy.TensorParallel(
            1, tp_lm.tp_rules(), seq_shards=SPEP_RANKS,
            attention=attention), SPEP_SPEC, loss_fn, params, tokens)
        init_s = time.perf_counter() - t0
        out[attention] = dict(spep_steps(runner, tokens, (
            "sp.p2p_sends", "sp.p2p_bytes", "sp.a2a_calls",
            "sp.a2a_bytes")), init_s=init_s,
            mesh=dict(runner.distributed_step.mesh.axes))
        del runner
        adt.reset()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spep_phase(card, env):
    """Phase 25 (b)-(c): the two processes of ``spep_child`` on ``cuda:0``
    in the environment ``env``; the gates and the readings."""
    import math
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(spep_child, args=(os.path.join(tmp, "store"),
                                                 tmp, env),
                               nprocs=SPEP_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 25 (b)-(c): a rank failed: %s"
                 % (str(e).strip()[-2000:],))
        res = []
        for r in range(SPEP_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
    print("phase 25 (b)-(c): %d processes of cuda:0 over gloo, beside "
          "phases 11-12: %.1f s" % (SPEP_RANKS, time.perf_counter() - t0))
    for part in ("moe", "ring", "ulysses"):
        label = "phase 25 %s" % ("(b) moe_lm ep 2" if part == "moe"
                                 else "(c) tp_lm sp 2 " + part)
        runs = [r[part] for r in res]
        if runs[0]["losses"] != runs[1]["losses"]:
            fail("%s: the ranks' losses differ: %r vs %r"
                 % (label, runs[0]["losses"], runs[1]["losses"]))
        losses = runs[0]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail("%s: a loss is not finite: %r" % (label, losses))
        for rank, run in enumerate(runs):
            no_kernel_launched("%s rank %d" % (label, rank),
                               run["launches"])
        if part == "moe":
            want = sum(res[0]["moe_unbound"]) / SPEP_RANKS
            if not abs(losses[0] - want) <= 2e-5 * max(1.0, abs(want)):
                fail("%s: the first loss %.7f is not within 2e-5 of the "
                     "unbound losses' mean %.7f (%r)"
                     % (label, losses[0], want, res[0]["moe_unbound"]))
            for rank, run in enumerate(runs):
                if run["w1"] != [4, 512, 1024]:
                    fail("%s rank %d: layer_0/moe/w1 is %r a rank (want "
                         "[4, 512, 1024])" % (label, rank, run["w1"]))
            ref = "unbound mean %.6f (%s)" % (want, ", ".join(
                "%.6f" % x for x in res[0]["moe_unbound"]))
            moved = "ep.a2a_bytes a step %.2f / %.2f MB in %.0f calls" % (
                runs[0]["per_step"]["ep.a2a_bytes"] / 1e6,
                runs[1]["per_step"]["ep.a2a_bytes"] / 1e6,
                runs[0]["per_step"]["ep.a2a_calls"])
            extra = "; w1 a rank %r; the sparse wire: %s" % (
                runs[0]["w1"], runs[0]["sparse"] or "none")
        else:
            want = res[0]["sp_plain"]
            first_loss_check(label, losses[0], want)
            ref = "one-process plain attention %.6f" % want
            key = "sp.p2p_bytes" if part == "ring" else "sp.a2a_bytes"
            calls = "sp.p2p_sends" if part == "ring" else "sp.a2a_calls"
            moved = "%s a step %.2f / %.2f MB in %.0f calls" % (
                key, runs[0]["per_step"][key] / 1e6,
                runs[1]["per_step"][key] / 1e6, runs[0]["per_step"][calls])
            extra = "; mesh %r" % (runs[0]["mesh"],)
        print("  %s: losses %s (both ranks; %s); step p50 %.1f / %.1f ms "
              "(ranks 0 / 1, steps %s ms); %s; peak memory %.2f / %.2f GB;"
              " build + init %.1f s%s; no flash kernel launched [%s]"
              % (label, " ".join("%.4f" % x for x in losses), ref,
                 runs[0]["p50_ms"], runs[1]["p50_ms"],
                 " ".join("%.1f" % t for t in runs[0]["times_ms"]), moved,
                 runs[0]["peak_gb"], runs[1]["peak_gb"], runs[0]["init_s"],
                 extra, card))


# ------------------------------------------------------------- phase 26


SERVE_RANKS = 2
SERVE_PROMPTS = 64                 # (a): phase 3's prompts through 32 slots
SERVE_PARITY_LAYERS = 2            # (b): lm1b f32 at 2 of its 8 layers
MB_REQUESTS, MB_CLIENTS, MB_WAVE = 512, 4, 16     # (c)
MB_BUCKETS, MB_MAX_QUEUE = (2, 16, 64), 256
SERVE_DRAIN_RETRY_S = 2.5
SERVE_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                         "gpus": [0] * SERVE_RANKS}]}


def serve_prompts(cfg):
    """Phase 3's 64 prompts (lengths 1-64, seed 0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    lengths = [1 + (i * 37) % 64 for i in range(SERVE_PROMPTS)]
    lengths[0], lengths[1] = 1, 64
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lengths]


def serve_runner(cfg):
    """lm1b's runner under ``AllReduce()`` at SERVE_RANKS replicas of
    ``cuda:0`` (no optimizer: it serves)."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt_reset()
    loss_fn, params, batch, _ = lm.make_train_setup(cfg, seq_len=64,
                                                    batch_size=8, seed=0)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                      resource_spec=ResourceSpec.from_dict(SERVE_SPEC),
                      device="cuda:0")
    runner = ad.build(loss_fn, None, params, batch)
    runner.init(params)
    return runner


def serve_parity_part(rank, out):
    """(b): lm1b f32 at 2 layers, flash decode at N = 2 (8 slots, 4 a
    rank, phase 4's 8 prompts): the chief's tokens against greedy full
    recompute on the card."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models.layers import apply
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(lm.LMConfig.lm1b(),
                              num_layers=SERVE_PARITY_LAYERS)
    runner = serve_runner(cfg)
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, "flash"),
                          DecodeConfig(slots=8, max_new_tokens=8,
                                       prefill_len=64))
    engine.warmup()
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    steps0 = engine.stats_local["steps"]
    dist.barrier()
    if rank == 0:
        prompts = serve_prompts(cfg)[:8]
        res = [f.result(timeout=600)
               for f in [engine.submit(p) for p in prompts]]
        engine.close()
        got = [list(map(int, r["tokens"])) for r in res]
        params = runner.gather_params()
        model = lm.make_model(cfg)
        want = []
        with torch.inference_mode(), uncounted():
            for p, toks in zip(prompts, got):
                ids, seq = list(map(int, p)), []
                for _ in range(len(toks)):
                    logits = apply(model, params,
                                   torch.tensor([ids], device="cuda"))
                    seq.append(int(torch.argmax(logits[0, -1])))
                    ids.append(seq[-1])
                want.append(seq)
        out["parity"] = {"got": got, "want": want}
    else:
        engine.follow(timeout=600)
        engine.close()
    torch.cuda.synchronize()
    out["parity_launches"] = dict(fa.flash_fwd.launches_by_variant)
    out["parity_steps"] = engine.stats_local["steps"] - steps0
    out["parity_s"] = time.perf_counter() - t0
    adt_reset()


def serve_decode_part(rank, out, cfg, runner):
    """(a): the decode engine at N = 2 on ``runner`` (32 slots, 16 a
    rank): the chief submits phase 3's 64 prompts; each rank's flash_fwd
    launches over the run; the kernel held to its plain version at the
    rank's shape on each rank, and timed on the chief. Returns the
    engine (it serves on in (c)-(d) and drains there)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    t0 = time.perf_counter()
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, "flash"),
                          DecodeConfig(slots=32, max_new_tokens=32,
                                       prefill_len=64))
    engine.warmup()
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    steps0 = engine.stats_local["steps"]
    dist.barrier()
    if rank == 0:
        prompts = serve_prompts(cfg)
        t1 = time.perf_counter()
        results = [f.result(timeout=600)
                   for f in [engine.submit(p) for p in prompts]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        stats = engine.stats()
        out["decode"] = {
            "tokens": [list(map(int, r["tokens"])) for r in results],
            "prompt_lens": [int(r["prompt_len"]) for r in results],
            "wall": wall, "errors": stats["errors"],
            "completed": stats["completed"],
            "p50": stats["token_p50_ms"], "p99": stats["token_p99_ms"]}
    dist.barrier()       # the chief's steps are over on every rank
    torch.cuda.synchronize()
    out["launches"] = dict(fa.flash_fwd.launches_by_variant)
    out["steps"] = engine.stats_local["steps"] - steps0
    out["cache_slots"] = int(engine._dev_k.shape[0])
    # the kernel at this rank's shape [16, 1, 256, 16, 64], bf16
    with uncounted():
        q, k, v, cursor = decode_inputs(torch.bfloat16, seed=5,
                                        slots=engine._per)
        q_seg, kv_seg = segs_for(cursor)
        got_o, got_l = fa.flash_fwd(q[:, None], k[:, 3], v[:, 3], q_seg,
                                    kv_seg)
        ref_o, ref_l = fa.flash_fwd_reference(q[:, None], k[:, 3], v[:, 3],
                                              q_seg, kv_seg)
        torch.cuda.synchronize()
        out["kernel_err"] = max(
            check_close("rank %d decode out [%d,1,256,16,64] (bf16)"
                        % (rank, engine._per), got_o, ref_o, 2e-2),
            check_close("rank %d decode lse (bf16)" % rank, got_l, ref_l,
                        2e-2))
        del q, k, v
    dist.barrier()
    if rank == 0:
        out["record"] = decode_timing(card_line(), out["kernel_err"],
                                      slots=engine._per)
    dist.barrier()
    out["decode_s"] = time.perf_counter() - t0
    return engine


def mb_requests(cfg, n, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rng.randint(1, 65))
        toks = np.zeros(64, np.int32)
        toks[:length] = rng.randint(0, cfg.vocab_size, (length,))
        out.append({"tokens": toks, "length": np.int32(length)})
    return out


def serve_batcher_part(out, cfg, runner, engine, batcher):
    """(c) on the chief: four closed-loop clients send MB_REQUESTS
    requests in waves of MB_WAVE; each group's rows against the same
    program called directly on the same padded bucket (bit-equal); then
    one burst past ``max_queue`` behind a held dispatch (typed sheds with
    Retry-After, brownout entered)."""
    import numpy as np
    from autodist_tpu_torch.serving import ServingUnavailable
    from autodist_tpu_torch.serving.engine import stack_batches
    reqs = mb_requests(cfg, MB_REQUESTS, seed=7)
    groups = []
    real_run = engine.run_batch

    def recording(requests, to_host=True):
        fetched, n = real_run(requests, to_host)
        groups.append((list(requests), np.array(fetched["next_token"])))
        return fetched, n
    engine.run_batch = recording
    rows = [None] * len(reqs)
    errors = []

    def client(c):
        mine = list(range(c, len(reqs), MB_CLIENTS))
        try:
            for lo in range(0, len(mine), MB_WAVE):
                wave = mine[lo:lo + MB_WAVE]
                futs = [(i, batcher.submit(reqs[i])) for i in wave]
                for i, f in futs:
                    rows[i] = int(f.result(timeout=600)["next_token"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
    lat0 = dict(batcher.stats_local)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(MB_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats = batcher.stats()
    engine.run_batch = real_run
    # the same program, called directly on each group's padded bucket (the
    # follower runs its rows through the engine's loop)
    mismatched = 0
    plane = engine._plane
    for group, tokens in groups:
        bucket = engine.bucket_for(len(group))
        host = stack_batches(group, pad_to=bucket)
        with plane.lock:
            direct = plane.dispatch(
                "forward", {"host": host, "n": len(group), "bucket": bucket,
                            "refresh": False},
                lambda p: engine._program(
                    runner.state, engine._snapshot(False),
                    runner.remapper.remap_feed(p["host"])))
        direct = runner.remapper.remap_fetch(direct)["next_token"]
        mismatched += not np.array_equal(direct[:len(group)], tokens)
    out["batcher"] = {
        "errors": errors, "resolved": sum(r is not None for r in rows),
        "wall": wall, "groups": len(groups), "mismatched": mismatched,
        "requests": stats["requests"] - lat0["requests"],
        "batches": stats["batches"] - lat0["batches"],
        "fan_out": stats["fan_out"] - lat0["fan_out"],
        "p50": stats["p50_ms"], "p99": stats["p99_ms"],
        "queue_p50": stats["goodput"]["queue_p50_ms"],
        "dispatch_p50": stats["goodput"]["dispatch_p50_ms"]}
    # one burst past max_queue behind a held dispatch
    hold = threading.Event()

    def held(requests, to_host=True):
        hold.wait(timeout=120)
        return real_run(requests, to_host)
    engine.run_batch = held
    burst = mb_requests(cfg, MB_MAX_QUEUE + 32, seed=8)
    futures, sheds = [], []
    futures.append(batcher.submit(burst[0]))
    while batcher.queue_depth():
        time.sleep(0.005)
    time.sleep(0.05)               # the worker is inside the held dispatch
    half = MB_MAX_QUEUE // 2 + 8
    for r in burst[1:1 + half]:
        futures.append(batcher.submit(r))
    time.sleep(0.1)                # past brownout_sustain_s above the line
    for r in burst[1 + half:]:
        try:
            futures.append(batcher.submit(r))
        except ServingUnavailable as e:
            sheds.append(e.retry_after_s)
    brownout = batcher.stats()["brownout"]
    hold.set()
    resolved = 0
    for f in futures:
        f.result(timeout=600)
        resolved += 1
    engine.run_batch = real_run
    out["burst"] = {"sheds": sheds, "submitted": len(burst),
                    "resolved": resolved, "brownout": brownout}


def serve_autoscale_part(out, cfg, batcher, engine):
    """(d) on the chief: a FleetAutoscaler on the port's coordination
    service over the live batcher's signals, the phantom-peer ramp
    (roster [me, replica-b], pool [replica-c, replica-d]): bursts until a
    grow, then idle until a planned shrink. A synthetic per-batch service
    time is used only when the real forward drains every burst before the
    policy's sustain window."""
    from autodist_tpu_torch.runtime import elastic
    from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                         CoordinationServer)
    from autodist_tpu_torch.serving import (AutoscalePolicy,
                                            FleetAutoscaler,
                                            ServingUnavailable)
    from autodist_tpu_torch.telemetry import spans as tel
    server = CoordinationServer(port=free_port())
    server.start()
    client = CoordinationClient("127.0.0.1", server.port)
    me = "127.0.0.1"
    real_run = engine.run_batch
    try:
        elastic.publish_epoch(client, 1, [me, "replica-b"])
        policy = AutoscalePolicy(min_replicas=2, max_replicas=4,
                                 queue_high=8, queue_low=2, sustain_s=0.05,
                                 grow_cooldown_s=0.02,
                                 shrink_cooldown_s=0.02)
        scaler = FleetAutoscaler(client, policy, me,
                                 pool=["replica-c", "replica-d"],
                                 notice_deadline_s=60.0,
                                 max_queue=MB_MAX_QUEUE)
        fallback0 = tel.counters().get("ckpt.fallback", 0.0)
        reqs = mb_requests(cfg, 64, seed=9)
        futures, sheds = [], 0
        synthetic = False
        t0 = time.perf_counter()
        for attempt in ("real", "synthetic"):
            if attempt == "synthetic":
                synthetic = True

                def slow(requests, to_host=True):
                    time.sleep(0.015)
                    return real_run(requests, to_host)
                engine.run_batch = slow
            deadline = time.perf_counter() + 5.0
            while (scaler.stats()["grows"] < 1
                   and time.perf_counter() < deadline):
                for r in reqs:
                    try:
                        futures.append(batcher.submit(r))
                    except ServingUnavailable:
                        sheds += 1
                scaler.step()
                time.sleep(0.01)
            if scaler.stats()["grows"] >= 1:
                break
        for f in futures:
            f.result(timeout=600)
        engine.run_batch = real_run
        grow_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        deadline = time.perf_counter() + 10.0
        while (scaler.stats()["shrinks"] < 1
               and time.perf_counter() < deadline):
            scaler.step()
            time.sleep(0.02)
        st = scaler.stats()
        info = elastic.read_epoch(client)
        notice = None
        if info is not None:
            from autodist_tpu_torch.runtime import preemption
            left = [w for w in ("replica-b", "replica-c", "replica-d")
                    if w not in info[1]]
            notice = [getattr(preemption.read_notice(client, w), "reason",
                              None) for w in left]
        out["autoscale"] = {
            "grows": st["grows"], "shrinks": st["shrinks"],
            "holds": st["holds"], "refusals": st["refusals"],
            "decisions": st["decisions"], "epoch": info[0] if info else None,
            "roster": info[1] if info else None, "notices": notice,
            "fallback": tel.counters().get("ckpt.fallback", 0.0) - fallback0,
            "synthetic": synthetic, "sheds": sheds,
            "requests": len(futures), "grow_s": grow_s,
            "shrink_s": time.perf_counter() - t1}
    finally:
        engine.run_batch = real_run
        client.close()
        server.stop()


def serve_drain_part(out, cfg, decoder, batcher, engine):
    """The drain, on the chief, with both engines held at their next
    dispatch: 48 prompts on the decode engine (32 admitted, 16 queued)
    and 1 + 10 requests on the batcher (1 in flight, 10 queued); then
    ``preemption.drain_serving``: the held work is released, the in-flight
    work completes, every queued request sheds with the typed
    Retry-After, the count returned is the sheds, and both engines'
    followers leave their loops."""
    from autodist_tpu_torch.runtime import preemption
    from autodist_tpu_torch.serving import ServingUnavailable
    hold = threading.Event()
    step = decoder._dispatch_step
    real_run = engine.run_batch

    def held_step(warmup=False):
        hold.wait(timeout=120)
        return step(warmup)

    def held_run(requests, to_host=True):
        hold.wait(timeout=120)
        return real_run(requests, to_host)
    decoder._dispatch_step = held_step
    engine.run_batch = held_run
    prompts = serve_prompts(cfg)
    with decoder._cv:       # one admission takes the first 32
        dfuts = [decoder.submit(p) for p in prompts[:48]]
    deadline = time.monotonic() + 120
    while len(decoder.scheduler.live_slots()) < 32 and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    queued_decode = decoder.queue_depth()
    reqs = mb_requests(cfg, 11, seed=10)
    bfuts = [batcher.submit(reqs[0])]
    while batcher.queue_depth():
        time.sleep(0.005)
    time.sleep(0.05)        # the worker is inside the held dispatch
    bfuts += [batcher.submit(r) for r in reqs[1:]]
    queued_batcher = batcher.queue_depth()
    threading.Timer(0.2, hold.set).start()
    t0 = time.perf_counter()
    shed = preemption.drain_serving(retry_after_s=SERVE_DRAIN_RETRY_S)
    drain_s = time.perf_counter() - t0
    typed = done = 0
    for f in dfuts + bfuts:
        try:
            f.result(timeout=600)
            done += 1
        except ServingUnavailable as e:
            typed += e.retry_after_s == SERVE_DRAIN_RETRY_S
    out["drain"] = {"shed": shed, "typed": typed, "done": done,
                    "queued_decode": queued_decode,
                    "queued_batcher": queued_batcher, "drain_s": drain_s,
                    "stopped": [decoder._plane.stopped,
                                engine._plane.stopped]}


def serve_child(rank, store, out_dir, env):
    """One rank of phase 26 (spawned): take the environment ``env``, join
    the gloo group; (b), then (a), (c), (d) and the drain on one lm1b
    runner; write this rank's results to ``out_dir``."""
    os.environ.clear()
    os.environ.update(env)
    # what a rank prints comes out in the phase's block, rank by rank
    sys.stdout = open(os.path.join(out_dir, "stdout%d.txt" % rank), "w",
                      buffering=1)
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, SERVE_RANKS),
                            rank=rank, world_size=SERVE_RANKS)
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving import (InferenceEngine, MicroBatcher,
                                            ServingConfig)
    out = {"rank": rank}
    serve_parity_part(rank, out)
    t0 = time.perf_counter()
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    runner = serve_runner(cfg)
    out["runner_s"] = time.perf_counter() - t0
    decoder = serve_decode_part(rank, out, cfg, runner)
    t0 = time.perf_counter()
    prefill = lm.make_decode_setup(cfg).prefill_fn

    def serve_fn(p, batch):
        return {"next_token": prefill(p, batch)["next_token"]}
    engine = InferenceEngine(
        runner, serve_fn, {"tokens": np.zeros(64, np.int32),
                           "length": np.int32(1)},
        ServingConfig(buckets=MB_BUCKETS, max_delay_ms=2.0,
                      max_queue=MB_MAX_QUEUE, brownout_queue_frac=0.5,
                      brownout_sustain_s=0.05)).warmup()
    batcher = MicroBatcher(engine)
    if rank == 0:
        serve_batcher_part(out, cfg, runner, engine, batcher)
        out["batcher_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_autoscale_part(out, cfg, batcher, engine)
        out["autoscale_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_drain_part(out, cfg, decoder, batcher, engine)
        out["drain_s"] = time.perf_counter() - t0
    else:
        try:
            batcher.submit({"tokens": np.zeros(64, np.int32),
                            "length": np.int32(1)})
        except ValueError as e:
            out["follower_submit"] = str(e)
        out["followed"] = [engine.follow(timeout=900),
                           decoder.follow(timeout=900)]
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    adt_reset()
    dist.destroy_process_group()


def serve_phase(card, env, phase3_tokens):
    """Phase 26: the two processes of ``serve_child`` on ``cuda:0`` in the
    environment ``env``; the gates and the readings. Returns flash_fwd's
    launches by design in (a) (both ranks) and (b), and (a)'s record at
    the rank's shape."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(serve_child, args=(os.path.join(tmp, "store"),
                                                  tmp, env),
                               nprocs=SERVE_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 26: a rank failed: %s" % (str(e).strip()[-2000:],))
        res, printed = [], []
        for r in range(SERVE_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
            with open(os.path.join(tmp, "stdout%d.txt" % r)) as f:
                printed.append(f.read())
    total_s = time.perf_counter() - t0
    chief, follower = res
    layers = LAYERS
    # (b) parity
    par = chief["parity"]
    if par["got"] != par["want"]:
        fail("phase 26 (b): flash decode at N = 2 differs from greedy full "
             "recompute: %r vs %r" % (par["got"], par["want"]))
    for rank, r in enumerate(res):
        want = {"scalar f32": SERVE_PARITY_LAYERS * r["parity_steps"]}
        if r["parity_launches"] != want or r["parity_steps"] == 0:
            fail("phase 26 (b) rank %d: flash_fwd launched %r over %d steps "
                 "(want %r)" % (rank, r["parity_launches"],
                                r["parity_steps"], want))
    # (a) decode
    dec = chief["decode"]
    if dec["errors"] or dec["completed"] != SERVE_PROMPTS:
        fail("phase 26 (a): %d errors, %d of %d completed"
             % (dec["errors"], dec["completed"], SERVE_PROMPTS))
    lens = [1 + (i * 37) % 64 for i in range(SERVE_PROMPTS)]
    lens[0], lens[1] = 1, 64
    for toks, plen, want_len in zip(dec["tokens"], dec["prompt_lens"], lens):
        if len(toks) != 32 or min(toks) < 0 or max(toks) >= 793470 // 8 \
                or plen != want_len:
            fail("phase 26 (a): a result has the wrong shape or ids")
    if follower["steps"] != chief["steps"] or chief["steps"] == 0:
        fail("phase 26 (a): the ranks ran %d and %d decode steps"
             % (chief["steps"], follower["steps"]))
    for rank, r in enumerate(res):
        want = {MAIN_DESIGN["flash_fwd"]: layers * r["steps"]}
        if r["launches"] != want:
            fail("phase 26 (a) rank %d: flash_fwd launched %r over %d decode "
                 "steps (want %r)" % (rank, r["launches"], r["steps"], want))
        if r["cache_slots"] != 16:
            fail("phase 26 (a) rank %d holds %d slots (want 16)"
                 % (rank, r["cache_slots"]))
    same = sum(a == b for a, b in zip(dec["tokens"], phase3_tokens))
    generated = sum(len(t) for t in dec["tokens"])
    # (c) the micro-batcher
    mb, burst = chief["batcher"], chief["burst"]
    if mb["errors"] or mb["resolved"] != MB_REQUESTS or \
            mb["fan_out"] != MB_REQUESTS or mb["mismatched"]:
        fail("phase 26 (c): errors %r, %d of %d resolved, fan-out %d, %d of "
             "%d groups not bit-equal to the program called directly"
             % (mb["errors"], mb["resolved"], MB_REQUESTS, mb["fan_out"],
                mb["mismatched"], mb["groups"]))
    if not burst["sheds"] or any(h is None for h in burst["sheds"]) or \
            burst["resolved"] + len(burst["sheds"]) != burst["submitted"] \
            or burst["brownout"]["entries"] < 1:
        fail("phase 26 (c): the burst past max_queue %d: %d sheds (hints "
             "%r), %d resolved of %d, brownout %r"
             % (MB_MAX_QUEUE, len(burst["sheds"]), burst["sheds"][:4],
                burst["resolved"], burst["submitted"], burst["brownout"]))
    if "on a follower" not in follower.get("follower_submit", ""):
        fail("phase 26 (c): the follower's batcher took a request")
    # (d) the autoscaler
    auto = chief["autoscale"]
    if auto["grows"] < 1 or auto["shrinks"] < 1 or auto["fallback"] or \
            "autoscale-idle" not in (auto["notices"] or []) or \
            auto["roster"] != ["127.0.0.1", "replica-b"]:
        fail("phase 26 (d): %r" % (auto,))
    # the drain
    dr = chief["drain"]
    if (dr["queued_decode"], dr["queued_batcher"]) != (16, 10) or \
            dr["shed"] != dr["typed"] or dr["typed"] != 16 + 10 or \
            dr["done"] != 32 + 1 or not all(dr["stopped"]) \
            or follower["followed"] != [True, True]:
        fail("phase 26 drain: %r; the follower's loops ended: %r"
             % (dr, follower["followed"]))
    print("phase 26: serving at N = 2 — two processes of cuda:0 over gloo, "
          "one controller and one executor: %.1f s [%s]" % (total_s, card))
    for text in printed:
        sys.stdout.write(text)
    print("  (b) lm1b f32 at %d of its %d layers, flash decode, 8 slots (4 a "
          "rank): 8 prompts token for token equal to greedy full recompute "
          "on the card; flash_fwd %r / %r (ranks 0 / 1); %.1f s"
          % (SERVE_PARITY_LAYERS, layers, chief["parity_launches"],
             follower["parity_launches"], chief["parity_s"]))
    print("  (a) lm1b bf16 full width, 32 slots (16 a rank): %d prompts, %d "
          "tokens in %.3f s: %.1f tokens/s, %d decode steps, token p50 %.3f "
          "ms p99 %.3f ms; flash_fwd %r / %r (= %d x %d steps a rank); %d of "
          "%d sequences equal phase 3's; runner %.1f s, (a) %.1f s [%s]"
          % (SERVE_PROMPTS, generated, dec["wall"], generated / dec["wall"],
             chief["steps"], dec["p50"], dec["p99"], chief["launches"],
             follower["launches"], layers, chief["steps"], same,
             SERVE_PROMPTS, chief["runner_s"], chief["decode_s"], card))
    print("  (c) MicroBatcher over an InferenceEngine (prefill next_token, "
          "buckets %r): %d requests from %d clients in %.3f s: %.1f QPS, "
          "latency p50 %.3f ms p99 %.3f ms (serve.latency_ms), queue p50 "
          "%.3f ms, dispatch p50 %.3f ms, %d batches (fill %.2f); all %d "
          "groups bit-equal to the program called directly; a burst of %d "
          "past max_queue %d: %d typed sheds (Retry-After %.3f-%.3f s), "
          "brownout %r; %.1f s"
          % (MB_BUCKETS, MB_REQUESTS, MB_CLIENTS, mb["wall"],
             MB_REQUESTS / mb["wall"], mb["p50"], mb["p99"], mb["queue_p50"],
             mb["dispatch_p50"], mb["batches"],
             mb["fan_out"] / max(mb["batches"], 1), mb["groups"],
             burst["submitted"], MB_MAX_QUEUE, len(burst["sheds"]),
             min(burst["sheds"]), max(burst["sheds"]), burst["brownout"],
             chief["batcher_s"]))
    print("  (d) FleetAutoscaler (phantom peers): %d grow(s) in %.2f s, %d "
          "planned shrink(s) in %.2f s (notice reason %r), %d holds, %d "
          "decisions, final epoch %r roster %r, ckpt.fallback +%d, %d "
          "requests (%d shed); synthetic service time: %s; %.1f s"
          % (auto["grows"], auto["grow_s"], auto["shrinks"], auto["shrink_s"],
             auto["notices"], auto["holds"], auto["decisions"],
             auto["epoch"], auto["roster"], auto["fallback"],
             auto["requests"], auto["sheds"],
             "yes (15 ms a batch)" if auto["synthetic"] else "no",
             chief["autoscale_s"]))
    print("  drain_serving: %d queued decode prompts and %d queued batcher "
          "requests shed typed (Retry-After %.1f s), %d returned, %d "
          "in-flight completed, both engines' follower loops ended; %.2f s"
          % (dr["queued_decode"], dr["queued_batcher"], SERVE_DRAIN_RETRY_S,
             dr["shed"], dr["done"], dr["drain_s"]))
    record = chief["record"]
    launches = {}
    for r in res:
        for design, n in r["launches"].items():
            launches[design] = launches.get(design, 0) + n
    f32 = {}
    for r in res:
        for design, n in r["parity_launches"].items():
            f32[design] = f32.get(design, 0) + n
    return launches, f32, record


# ------------------------------------------------------------- phase 27


MESH_RANKS = 4                 # {data: 2, model: 2} on cuda:0
MESH_SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True,
                        "gpus": [0] * MESH_RANKS}]}
# the LayerNorms and the biases added after a reduce: ZeRO-sharded
MESH_ZERO = re.compile(r"(^|/)(ln1|ln2|final_ln)/(scale|bias)$|"
                       r"/attn/bo$|/mlp/b2$")
MESH_PART = {"pos_embed": "2,1"}
MESH_BUCKETS = (2, 8)
MESH_REQUESTS = 24             # (b): requests, in groups of 1-8
MESH_PROMPT = 256              # (b): tokens a request


def mesh_builder():
    """``TensorParallel(2, tp_rules())`` with its plan's nodes pinned as a
    user pins storage: the :data:`MESH_ZERO` variables on
    ``ZeroShardedSynchronizer``, ``pos_embed`` partitioned."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  StrategyBuilder, VarConfig,
                                                  ZeroShardedSynchronizer)

    class Pinned(StrategyBuilder):
        def build(self, model_item, resource_spec):
            plan = strategy.TensorParallel(2, tp_lm.tp_rules()).build(
                model_item, resource_spec)
            for node in plan.node_config:
                n = node.var_name
                if MESH_ZERO.search(n):
                    node.synchronizer = ZeroShardedSynchronizer()
                elif n in MESH_PART:
                    node.partitioner = MESH_PART[n]
                    node.part_configs = [
                        VarConfig(var_name="%s/part_%d" % (n, i),
                                  synchronizer=AllReduceSynchronizer())
                        for i in range(node.num_shards)]
            return plan
    return Pinned()


def mesh_serve_fn(cfg, attn_fn):
    """The last position's logits of tp_lm over the whole vocabulary:
    under the bound model axis each rank's vocab columns are put in place
    and summed over the axis."""
    import torch
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.parallel import mesh

    def serve(p, batch):
        logits = tp_lm.forward(p, torch.as_tensor(batch["tokens"]), cfg,
                               attn_fn=attn_fn)[:, -1]
        b = mesh.binding("model")
        if b is not None:
            v = logits.shape[-1]
            full = logits.new_zeros(logits.shape[0], v * b.size)
            full[:, b.index * v:(b.index + 1) * v] = logits
            logits = mesh.psum(full, "model")
        return {"logits": logits}
    return serve


def mesh_requests(cfg):
    import numpy as np
    rng = np.random.RandomState(27)
    return [{"tokens": rng.randint(0, cfg.vocab_size, (MESH_PROMPT,))
             .astype(np.int32)} for _ in range(MESH_REQUESTS)]


def mesh_child(rank, store, out_dir, env):
    """One rank of phase 27 (spawned): take the environment ``env``, join
    the gloo group, (a) train, (b) serve; write this rank's results to
    ``out_dir``."""
    os.environ.clear()
    os.environ.update(env)
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, MESH_RANKS),
                            rank=rank, world_size=MESH_RANKS)
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.serving import InferenceEngine, ServingConfig
    from autodist_tpu_torch.telemetry import spans as tel
    shapes = set()
    cfg, loss_fn, _, params, batch = tp_setup(shapes)
    t0 = time.perf_counter()
    runner = adt.AutoDist(strategy_builder=mesh_builder(),
                          resource_spec=ResourceSpec.from_dict(MESH_SPEC),
                          device="cuda:0").build(
        loss_fn, functools.partial(torch.optim.Adam, lr=1e-3), params, batch)
    runner.init(params)
    init_s = time.perf_counter() - t0
    del params
    dstep = runner.distributed_step
    shapes.clear()
    tel.reset()
    reset_counts()
    losses, times = [], []
    for _ in range(TP2_STEPS):
        t0 = time.perf_counter()
        losses.append(float(runner.run(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    counters = tel.counters()
    zero = runner.state.sync_state["zero"]
    opt = opt_leaves(runner)
    if rank == 0:
        torch.save(opt, os.path.join(out_dir, "opt.pt"))
    del opt
    out = {"rank": rank, "losses": losses,
           "times_ms": [t * 1e3 for t in times],
           "p50_ms": statistics.median(times[-3:]) * 1e3,
           "launches": launches, "shapes": sorted(shapes), "init_s": init_s,
           "coords": dict(dstep.mesh.coords),
           "zero": {n: [int(zero[n][slot]["v"].numel()) for slot in
                        ("mu", "nu")] for n in sorted(zero)},
           "zero_full": {n: int(dstep.model_item.var_infos[n].num_elements)
                         for n in sorted(zero)},
           "pos_embed": list(runner.state.params["pos_embed"].shape),
           "pos_embed_full": list(
               dstep.model_item.var_infos["pos_embed"].shape),
           "layers": cfg.num_layers, "vocab": cfg.vocab_size,
           "per_step": {k: counters.get(k, 0.0) / TP2_STEPS for k in (
               "zero.rs_bytes", "zero.ag_bytes", "tp.fwd_allreduces")},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    # (b): the trained state served by the same four ranks
    gathered = runner.gather_params()
    flash = make_flash_attn_fn(causal=True)
    serve_shapes = set()

    def attn(q, k, v):
        serve_shapes.add(tuple(q.shape))
        return flash(q, k, v)
    reqs = mesh_requests(cfg)
    engine = InferenceEngine(runner, mesh_serve_fn(cfg, attn), reqs[0],
                             ServingConfig(buckets=MESH_BUCKETS))
    reset_counts()
    if rank == 0:
        engine.warmup()
        rows, lat = [], []
        t_all = time.perf_counter()
        i, n = 0, 1
        while i < len(reqs):
            group = reqs[i:i + n]
            t0 = time.perf_counter()
            got, k = engine.run_batch(group)
            lat.append((time.perf_counter() - t0) * 1e3)
            rows.append(torch.as_tensor(got["logits"][:k]))
            i, n = i + len(group), n % MESH_BUCKETS[-1] + 1
        wall = time.perf_counter() - t_all
        engine.close()
        logits = torch.cat(rows)
        # the reference: tp_lm.forward on the gathered params, unbound, in
        # this process, with the plain attention
        ids = torch.as_tensor(np.stack([r["tokens"] for r in reqs]),
                              device="cuda")
        with uncounted(), torch.inference_mode():
            ref = torch.cat([tp_lm.forward(gathered, ids[j:j + 8], cfg)[
                :, -1].float().cpu() for j in range(0, len(reqs), 8)])
        err = max_err(logits, ref)
        out.update(serve_err=err, serve_scale=float(ref.abs().max()),
                   serve_rows=list(logits.shape), qps=len(reqs) / wall,
                   lat_p50_ms=float(np.percentile(lat, 50)),
                   lat_p99_ms=float(np.percentile(lat, 99)),
                   groups=len(lat))
    else:
        engine.follow(timeout=600)
    out["serve_launches"] = launch_counts()
    out["serve_batches"] = engine.stats["batches"]
    out["serve_shapes"] = sorted(serve_shapes)
    adt.reset()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def mesh_shapes():
    """A rank's flash q shapes in phase 27: (a) training, [4, 1024, 8, 64]
    (the data axis halves the batch, the model axis the heads); (b) each
    serving bucket, [1 or 4, 256, 8, 64]."""
    heads = 16 // 2
    train = (TP_BATCH // 2, TP_SEQ, heads, HEAD_DIM)
    serve = [(b // 2, MESH_PROMPT, heads, HEAD_DIM) for b in MESH_BUCKETS]
    return train, serve


def mesh_kernel_records(card):
    """The three kernels at phase 27's rank shapes, causal: held to their
    plain versions at (a)'s shape and at each of (b)'s, and timed at (a)'s
    and at (b)'s largest. Returns (the records at (a)'s, at (b)'s)."""
    train, serve = mesh_shapes()
    for shape in serve[:-1]:
        tp_kernel_check(shape)
    return (kernel_timing(card, tp_kernel_check(train), train, True, None,
                          "[%d,%d,%d,%d] causal" % train),
            kernel_timing(card, tp_kernel_check(serve[-1]), serve[-1], True,
                          None, "[%d,%d,%d,%d] causal" % serve[-1]))


def mesh_phase(card, env, tp2):
    """Phase 27: the four processes of ``mesh_child`` on ``cuda:0`` in the
    environment ``env``; (a)'s losses and gathered Adam moments held to
    phase 20 (b)'s (``tp2``: its losses, its moments). Returns each
    kernel's launches over the ranks in (a) and in (b)."""
    import math
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(mesh_child, args=(os.path.join(tmp, "store"),
                                                 tmp, env),
                               nprocs=MESH_RANKS, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank failed
            fail("phase 27: a rank failed: %s" % (str(e).strip()[-2000:],))
        res = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                res.append(json.load(f))
        import torch
        opt = torch.load(os.path.join(tmp, "opt.pt"))
    tp2_losses, tp2_opt = tp2
    print("phase 27: tp_lm flagship at {data: 2, model: 2}, %d processes of "
          "cuda:0 over gloo, beside phases 24 (a) and 25 (a): %.1f s"
          % (MESH_RANKS, time.perf_counter() - t0))
    layers = res[0]["layers"]
    shape_a, shapes_b = mesh_shapes()
    train, serve = {}, {}
    for r in res:
        label = "phase 27 (a) rank %d" % r["rank"]
        check_launches(label, r["launches"], layers, TP2_STEPS)
        if r["shapes"] != [list(shape_a)]:
            fail("%s: the flash slot saw q shapes %r (want %r)"
                 % (label, r["shapes"], [list(shape_a)]))
        if r["serve_shapes"] != [list(x) for x in shapes_b]:
            fail("phase 27 (b) rank %d: the flash slot saw q shapes %r "
                 "(want %r)" % (r["rank"], r["serve_shapes"],
                                [list(x) for x in shapes_b]))
        if r["losses"] != res[0]["losses"]:
            fail("phase 27 (a): the ranks' losses differ: %r vs %r"
                 % (r["losses"], res[0]["losses"]))
        if not all(math.isfinite(x) for x in r["losses"]):
            fail("%s: a loss is not finite: %r" % (label, r["losses"]))
        for n, (mu, nu) in r["zero"].items():
            half = -(-r["zero_full"][n] // 2)
            if mu != half or nu != half:
                fail("%s: stores %d / %d elements of %s's Adam moments "
                     "(want half: %d)" % (label, mu, nu, n, half))
        if len(r["zero"]) != 6 * layers + 2:
            fail("%s: %d ZeRO-sharded variables (want %d)"
                 % (label, len(r["zero"]), 6 * layers + 2))
        rows, width = r["pos_embed_full"]
        if r["pos_embed"] != [rows // 2, width]:
            fail("%s: stores pos_embed as %r (want half its rows)"
                 % (label, r["pos_embed"]))
        # the program's first call ran a bucket of 2 rows and so also ran
        # the example bucket once, to classify its outputs: one forward
        # more than the dispatches
        want = {MAIN_DESIGN["flash_fwd"]: layers * (r["serve_batches"] + 1)}
        if r["serve_launches"]["flash_fwd"] != want or any(
                r["serve_launches"][k] for k in ("flash_bwd_dq",
                                                 "flash_bwd_dkdv")):
            fail("phase 27 (b) rank %d: launched %r over %d dispatches "
                 "(want flash_fwd %r)" % (r["rank"], r["serve_launches"],
                                          r["serve_batches"], want))
        for into, counts in ((train, r["launches"]),
                             (serve, r["serve_launches"])):
            for name, by in counts.items():
                for design, n in by.items():
                    into.setdefault(name, {})
                    into[name][design] = into[name].get(design, 0) + n
    losses = res[0]["losses"]
    for i, (got, ref) in enumerate(zip(losses, tp2_losses)):
        if not abs(got - ref) <= 2e-2 * max(1.0, abs(ref)):
            fail("phase 27 (a): step %d loss %.6f is not within 2e-2 of "
                 "phase 20 (b)'s %.6f" % (i, got, ref))
    # a gradient scaled by 2 (a missing sum over the model axis, a mean
    # over the data axis alone) leaves Adam's steps and so the losses as
    # they are; the moments scale with it
    opt_err = {}
    for slot in ("mu", "nu"):
        for n in OPT_CHECK:
            got, want = opt[slot][n], tp2_opt[slot][n]
            scale = float(want.abs().max())
            if tuple(got.shape) != tuple(want.shape):
                fail("phase 27 (a): %s's %s has shape %r (phase 20 (b): %r)"
                     % (n, slot, tuple(got.shape), tuple(want.shape)))
            err = max_err(got, want)
            opt_err[slot] = max(opt_err.get(slot, 0.0), err / scale)
            if not scale > 0 or not err <= 2e-2 * scale:
                fail("phase 27 (a): %s's %s max err %.4e against phase 20 "
                     "(b)'s after %d steps (max|ref| %.4e; want 2e-2 of it)"
                     % (n, slot, err, TP2_STEPS, scale))
    r0, chief = res[0], res[0]
    if chief["serve_rows"] != [MESH_REQUESTS, chief["vocab"]]:
        fail("phase 27 (b): served logits of shape %r" % chief["serve_rows"])
    if not chief["serve_err"] <= 2e-2 * chief["serve_scale"]:
        fail("phase 27 (b): logits max err %.4e against tp_lm.forward on the "
             "gathered params (max|ref| %.4e)"
             % (chief["serve_err"], chief["serve_scale"]))
    print("  (a) losses %s (every rank; phase 20 (b): %s, within 2e-2); "
          "flash q shape a rank %r; the gathered Adam moments of %s after "
          "%d steps against phase 20 (b)'s: mu max err %.3e, nu %.3e of "
          "max|ref| (want 2e-2)"
          % (" ".join("%.4f" % x for x in losses),
             " ".join("%.4f" % x for x in tp2_losses), r0["shapes"],
             ", ".join(OPT_CHECK), TP2_STEPS, opt_err["mu"], opt_err["nu"]))
    print("  (a) each rank stores half of each of %d ZeRO-sharded variables' "
          "Adam moments and pos_embed as %r; step p50 %s ms (min %.1f, max "
          "%.1f, ranks 0-3, steps %s ms); peak %s GB a rank; a rank-step: "
          "zero.rs_bytes %.0f, zero.ag_bytes %.0f, tp.fwd_allreduces %.1f; "
          "build + init %.1f s [%s]"
          % (len(r0["zero"]), r0["pos_embed"],
             " / ".join("%.1f" % r["p50_ms"] for r in res),
             min(min(r["times_ms"]) for r in res),
             max(max(r["times_ms"]) for r in res),
             " ".join("%.1f" % t for t in r0["times_ms"]),
             " / ".join("%.2f" % r["peak_gb"] for r in res),
             r0["per_step"]["zero.rs_bytes"], r0["per_step"]["zero.ag_bytes"],
             r0["per_step"]["tp.fwd_allreduces"], r0["init_s"], card))
    print("  (b) %d requests of %d tokens in %d groups (buckets %r): %.1f "
          "QPS, latency p50 %.3f ms p99 %.3f ms; logits max err %.4e "
          "(max|ref| %.4e) against tp_lm.forward on the gathered params; "
          "flash_fwd %d a dispatch on each rank (%d dispatches and the "
          "first call's classifying forward), q shapes a rank %r [%s]"
          % (MESH_REQUESTS, MESH_PROMPT, chief["groups"], MESH_BUCKETS,
             chief["qps"], chief["lat_p50_ms"], chief["lat_p99_ms"],
             chief["serve_err"], chief["serve_scale"], layers,
             chief["serve_batches"], chief["serve_shapes"], card))
    return train, serve


def main():
    global T_SMOKE
    T_SMOKE = time.perf_counter()
    # the environment phase 26's ranks take (phase 23 (b) sets a knob in
    # this process meanwhile)
    env0 = dict(os.environ)
    if not os.path.isdir(os.path.join(HERE, "autodist_tpu_torch", "csrc")):
        fail("autodist_tpu_torch/ is not beside chip_smoke.py — run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print("device: %s | nvidia-smi: %s | torch %s cuda %s"
          % (kind, card, torch.__version__, torch.version.cuda), flush=True)

    # phase 1 — build every kernel of the path, all nvcc runs together
    from autodist_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    try:
        cuda_build.build()
    except RuntimeError as e:
        fail(str(e))
    print("phase 1: built %s in %.1f s" % (", ".join(cuda_build.KERNELS),
                                           time.perf_counter() - t0))
    if not cuda_build.build_logs:
        print("  (the libraries were built before this run: no ptxas report)")
    usage_of = {}
    for name, log in cuda_build.build_logs.items():
        for kernel, usage in ptxas_usage(log):
            usage_of[kernel] = usage
            print("  %s: %s: %s" % (name, kernel, usage))

    fwd_err = kernel_phase()
    bwd_errs = bwd_kernel_phase()
    bert_errs = bert_kernel_phase()

    # phase 3 — lm1b at full width, bf16, flash decode
    import numpy as np
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeConfig
    print("phase 3: lm1b full width (bf16) through AutoDist -> Runner -> "
          "DecodeEngine(decode_attn='flash')")
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    loss_fn, params, batch, _ = lm.make_train_setup(cfg, seq_len=64,
                                                    batch_size=8, seed=0)
    n_params = sum(int(p.numel()) for p in params.values())
    print("  %d parameters (random, seed 0), init %.1f s"
          % (n_params, time.perf_counter() - t0))
    rng = np.random.RandomState(0)
    lengths = [1 + (i * 37) % 64 for i in range(64)]
    lengths[0], lengths[1] = 1, 64
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lengths]
    dcfg = DecodeConfig(slots=32, max_new_tokens=32, prefill_len=64)
    results, stats, wall, launches, _ = serve(cfg, loss_fn, params, batch,
                                              "flash", dcfg, prompts,
                                              profile_prompts=prompts[:32])
    steps = stats["steps"]
    if stats["errors"] != 0 or stats["completed"] != len(prompts):
        fail("serving: %d errors, %d of %d completed"
             % (stats["errors"], stats["completed"], len(prompts)))
    for r, p in zip(results, prompts):
        toks = np.asarray(r["tokens"])
        if toks.shape != (32,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size or r["prompt_len"] != len(p):
            fail("serving: a result has the wrong shape or ids: %r" % (r,))
    want = {MAIN_DESIGN["flash_fwd"]: cfg.num_layers * steps}
    if launches != want or steps == 0:
        fail("flash_fwd launched %r over %d decode steps (want %r)"
             % (launches, steps, want))
    serve_launches = launches
    phase3_tokens = [list(map(int, r["tokens"])) for r in results]
    generated = sum(len(r["tokens"]) for r in results)
    print("  %d prompts, %d tokens in %.3f s: %.1f tokens/s, %d decode "
          "steps, token p50 %.3f ms p99 %.3f ms, flash_fwd launches %r "
          "(= %d x %d steps) [%s]"
          % (len(prompts), generated, wall, generated / wall, steps,
             stats["token_p50_ms"], stats["token_p99_ms"], launches,
             cfg.num_layers, steps, card))

    # phase 4 — f32 parity: flash vs reference decode vs greedy recompute
    print("phase 4: lm1b full width (f32): flash vs reference decode")
    cfg32 = lm.LMConfig.lm1b()
    prompts8 = prompts[:8]
    dcfg8 = DecodeConfig(slots=8, max_new_tokens=8, prefill_len=64)
    got = {}
    for attn in ("flash", "reference"):
        res, st, _, f32_launches, runner = serve(
            cfg32, loss_fn, params, batch, attn, dcfg8, prompts8)
        if st["errors"] != 0 or st["completed"] != len(prompts8):
            fail("parity %s: %d errors, %d completed"
                 % (attn, st["errors"], st["completed"]))
        if attn == "flash" and set(f32_launches) != {"scalar f32"}:
            fail("f32 flash decode ran the designs %r (want scalar f32)"
                 % (f32_launches,))
        got[attn] = [list(map(int, r["tokens"])) for r in res]
    if got["flash"] != got["reference"]:
        fail("flash and reference decode differ: %r vs %r"
             % (got["flash"], got["reference"]))
    from autodist_tpu_torch.models.layers import apply
    model32 = lm.make_model(cfg32)
    dev_params = runner.gather_params()
    with torch.inference_mode():
        for p, toks in zip(prompts8[:4], got["flash"][:4]):
            ids = list(map(int, p))
            want = []
            for _ in range(len(toks)):
                logits = apply(model32, dev_params,
                               torch.tensor([ids], device="cuda"))
                want.append(int(torch.argmax(logits[0, -1])))
                ids.append(want[-1])
            if want != toks:
                fail("decode diverged from greedy recompute: %r vs %r"
                     % (toks, want))
    print("  8 prompts: flash (scalar f32) == reference token for token; 4 "
          "checked against greedy full recompute")

    # the kernels' timings come after phase 3's timed serving, whose decode
    # tokens/s is bound by host dispatch, so that it runs first
    print("phase 2c: kernel timings at the decode, lm1b training and "
          "bert_base shapes")
    fwd_serve = decode_timing(card, fwd_err)
    train_records = kernel_timing(
        card, bwd_errs, (TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM), True,
        None, "[64,128,16,64] causal")
    bert_records = kernel_timing(
        card, bert_errs, (BERT_BATCH, BERT_SEQ, BERT_HEADS, HEAD_DIM), False,
        torch.ones((BERT_BATCH, BERT_SEQ), dtype=torch.int32, device="cuda"),
        "[128,128,12,64] all-ones mask")

    seconds = {}

    def timed_phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        print("(phase %s took %.1f s)" % (label, seconds[label]), flush=True)
        return out

    train_launches = timed_phase("5", train_phase, card)
    timed_phase("6", train_parity_phase)
    bert_launches = timed_phase("7", bert_train_phase, card)
    timed_phase("8", resnet_phase, card)
    timed_phase("9", bert_parity_phase)
    # phase 14 (a)-(c)'s two ranks run beside phase 10's (both read
    # losses and informational step times); joined in phase 14
    sync_ac = Beside(sync_phase, card)
    dp_launches, dp_losses = timed_phase("10", dp_phase, card)
    # phase 25 (b)-(c)'s two ranks run beside phases 11 and 12, and are
    # joined before phase 13, whose device trace of a replay counts
    # launches
    spep = Beside(spep_phase, card, dict(os.environ))
    resume_launches = timed_phase("11", resume_phase, card)
    timed_phase("12", cnn_phase, card)
    t = time.perf_counter()
    spep.result()
    seconds["25 (b)-(c) after 12"] = time.perf_counter() - t
    fused_launches, replay_per_microstep = timed_phase("13", fused_phase,
                                                       card)
    sync_launches, tier_launches, remat_launches = timed_phase(
        "14", sync_variants_phase, card, sync_ac)
    ps_launches, bert_ps_losses = timed_phase("15", ps_phase, card)
    # phase 17 (b)-(c)'s four processes run beside phases 16 and 17 (a)
    # (one process each)
    async_pair = Beside(async_pair_phase, card)
    carry_launches, carry_per_microstep, adamw_launches = timed_phase(
        "16", carry_phase, card, bert_ps_losses)
    async_launches = timed_phase("17", async_phase, card, async_pair)
    # phase 19 (a) beside 19 (b)'s and (c)'s jobs and phases 18 and 22
    def beside_19(whole_job_s):
        launched = Beside(launch_phase, card)
        try:
            return inrun_phase(card, dp_losses, whole_job_s)
        finally:
            launched.result()
    elastic_launches, whole_job_s, (inrun_launches, inrun) = timed_phase(
        "19 with 18 and 22", elastic_phase, card, dp_losses, beside_19)
    tp_a, tp_b, tp16, tp8, gathered_ms, shard, tp2 = timed_phase(
        "20", tp_phase, card)

    # phase 27's four processes start once phase 21 (a)'s two have ended,
    # and run beside phases 24 (a) and 25 (a) (one process each)
    def mesh_after_shard():
        shard.wait()
        return mesh_phase(card, env0, tp2)
    mesh27 = Beside(mesh_after_shard)
    pp2_records, pp1_launches = timed_phase("24 (a)", pp_one_phase, card)
    timed_phase("25 (a)", moe_one_phase, card)
    t = time.perf_counter()
    mesh_train, mesh_serve = mesh27.result()
    seconds["27 after 25 (a)"] = time.perf_counter() - t
    # its kernels at its rank shapes, with nothing beside
    mesh_a_rec, mesh_b_rec = timed_phase("27 kernels", mesh_kernel_records,
                                         card)
    # phase 24 (b)'s two processes run beside phases 21 and 23; phase 23
    # (a)'s two processes run beside its (b) and (c) and phase 21
    pp_two = Beside(pp_two_phase, card, dict(os.environ))
    preempt_launches, drain_launches, (
        shard_launches, sentinel_launches, sched_launches) = timed_phase(
            "21 with 23", preempt_phase, card, dp_losses,
            inrun["shrink_ms"],
            lambda: health_phase(card, dp_losses, gathered_ms, shard))
    t = time.perf_counter()
    pp2_launches = pp_two.result()
    seconds["24 (b) after 21 with 23"] = time.perf_counter() - t
    n2_launches, n2_f32_launches, n2_record = timed_phase(
        "26", serve_phase, card, env0, phase3_tokens)
    print("phases 5-27: %s s" % ", ".join(
        "%s %.1f" % kv for kv in seconds.items()))

    # flash_fwd runs on the three main paths, serving (decode), lm1b and
    # bert training, the backward kernels on the two training paths. Each
    # record's top-level numbers are its first path's, its max_abs_err the
    # largest over its paths; "by_path" gives each path's launches,
    # design, times and bound; "launches" and "design_launches" sum over
    # the paths
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "design")
    by_path = {"flash_fwd": {"serve": (serve_launches, fwd_serve)},
               "flash_bwd_dq": {}, "flash_bwd_dkdv": {}}
    for name, paths in by_path.items():
        paths["train"] = (train_launches[name], train_records[name])
        paths["bert"] = (bert_launches[name], bert_records[name])
        # phase 20: tp_lm flagship at tp 1 ([8, 1024, 16, 64] causal) and
        # at tp 2 (both ranks, [8, 1024, 8, 64] causal)
        paths["tp_lm"] = (tp_a[name], tp16[name])
        paths["tp_lm_tp2"] = (tp_b[name], tp8[name])
        # phase 24: pipe_lm flagship at pp 1 ([8, 1024, 16, 64] causal)
        # and at pp 2 under each schedule (both ranks, microbatches of 2:
        # [2, 1024, 16, 64] causal)
        paths["pipe_lm_pp1"] = (pp1_launches[name], tp16[name])
        for schedule in PP_SCHEDULES:
            paths["pipe_lm_pp2_" + schedule] = (
                pp2_launches[schedule][name], pp2_records[name])
        # phase 27 (a): tp_lm flagship at {data: 2, model: 2} with ZeRO
        # and a partitioned pos_embed, every rank ([4, 1024, 8, 64] causal)
        paths["tp_lm_mesh"] = (mesh_train.get(name, {}), mesh_a_rec[name])
    records = {}
    for name, paths in by_path.items():
        rec = dict(next(iter(paths.values()))[1], max_abs_err=max(
            r["max_abs_err"] for _, r in paths.values()))
        rec["by_path"] = {
            path: dict({"launches": sum(n.values()),
                        "design_launches": n.get(r["design"], 0)},
                       **{key: r[key] for key in keys})
            for path, (n, r) in paths.items()}
        # phase 10's bert_base steps, both ranks: launches only (its shape
        # per rank is [64, 128, 12, 64], not timed)
        dp = dp_launches.get(name, {})
        rec["by_path"]["bert_dp"] = {
            "launches": sum(dp.values()),
            "design_launches": dp.get(rec["design"], 0)}
        # phase 11's bert_base steps (run A's 4, run B's 2 after the
        # restore): launches only, at the bert path's shape
        resumed = resume_launches.get(name, {})
        rec["by_path"]["bert_resume"] = {
            "launches": sum(resumed.values()),
            "design_launches": resumed.get(rec["design"], 0)}
        # phase 13 (a)'s fused lm1b run: the graph's replays (counted by
        # the capture's recording, added at each replay) and the capture's
        # warm-up; a microstep's launches under replay from a device trace
        # of one more replay
        fused = fused_launches.get(name, {})
        rec["by_path"]["lm1b_fused"] = {
            "launches": sum(fused.values()),
            "design_launches": fused.get(rec["design"], 0),
            "launches_per_microstep_under_replay":
                replay_per_microstep[name]}
        # phase 14: (a)-(c)'s bert_base steps on both ranks, (d)'s lm1b
        # steps under the bf16 tier (an f32 config: the f32 design), and
        # (e)'s bert_base steps under remat (the forward kernel launches
        # again in the recomputed forward): launches only
        # phase 15 (d): bert_base under Parallax, the tables host-resident
        # phase 16 (d): bert_base under AdamW
        # phase 17 (a): bert_base under PS(sync=False), drained and not
        # phase 19 (a): bert_base launched by the chief, sync-elastic,
        # both ranks, both incarnations (the steps that completed)
        # phase 21: (a) tp_lm at tp 2, both ranks (the steps around the
        # sharded save and restore); (b) bert_base with the sentinel
        # armed and unarmed, per step and fused, and its fault runs; (c)
        # bert_base under the rhd and hierarchical schedules, every rank
        # phase 22: bert_base launched by the chief, in-run elastic: the
        # first worker's steps, the chief's at N = 1 and N = 2, the
        # joiner's
        # phase 23: (a) bert_base launched by the chief, the planned
        # departure: the worker's steps, the chief's at N = 2 and N = 1;
        # (b) bert_base at 2 layers, the rescue-skip branch
        for path, counts in (("bert_sync_variants", sync_launches),
                             ("lm1b_bf16_tier", tier_launches),
                             ("bert_remat", remat_launches),
                             ("bert_parallax", ps_launches),
                             ("bert_adamw", adamw_launches),
                             ("bert_async", async_launches),
                             ("bert_elastic", elastic_launches),
                             ("tp_lm_sharded", shard_launches),
                             ("bert_sentinel", sentinel_launches),
                             ("bert_schedules", sched_launches),
                             ("bert_inrun", inrun_launches),
                             ("bert_preempt", preempt_launches)):
            n = counts.get(name, {})
            rec["by_path"][path] = {
                "launches": sum(n.values()),
                "design_launches": n.get(rec["design"], 0),
                "designs": n}
        # phase 16 (c): bert_base under Parallax in fused supersteps, the
        # tables in the device carry: the replays and the capture's
        # warm-up, and a microstep's launches under replay from a device
        # trace of one more replay
        carried = carry_launches.get(name, {})
        rec["by_path"]["bert_parallax_fused"] = {
            "launches": sum(carried.values()),
            "design_launches": carried.get(rec["design"], 0),
            "launches_per_microstep_under_replay":
                carry_per_microstep[name]}
        if name == "flash_fwd":
            # phase 23 (c): lm1b decode under the serving drain
            n = drain_launches["flash_fwd"]
            rec["by_path"]["serve_drain"] = {
                "launches": sum(n.values()),
                "design_launches": n.get(rec["design"], 0), "designs": n}
            # phase 26 (a): lm1b bf16 decode at N = 2, both ranks, timed
            # at a rank's shape [16, 1, 256, 16, 64]; (b): f32 at 2
            # layers, both ranks (the scalar f32 design)
            rec["by_path"]["serve_n2"] = dict(
                {"launches": sum(n2_launches.values()),
                 "design_launches": n2_launches.get(rec["design"], 0)},
                **{key: n2_record[key] for key in keys})
            rec["by_path"]["serve_n2_f32"] = {
                "launches": sum(n2_f32_launches.values()),
                "design_launches": n2_f32_launches.get(rec["design"], 0),
                "designs": n2_f32_launches}
            # phase 27 (b): tp_lm flagship served at {data: 2, model: 2},
            # every rank's dispatches, timed at [4, 256, 8, 64] causal
            n = mesh_serve.get("flash_fwd", {})
            rec["by_path"]["tp_lm_mesh_serve"] = dict(
                {"launches": sum(n.values()),
                 "design_launches": n.get(rec["design"], 0), "designs": n},
                **{key: mesh_b_rec["flash_fwd"][key] for key in keys})
        rec["launches"] = sum(p["launches"] for p in rec["by_path"].values())
        rec["design_launches"] = sum(p["design_launches"]
                                     for p in rec["by_path"].values())
        # registers, static shared memory and spills of the design's
        # function (dK/dV's shared memory is dynamic: DkdvSmem)
        rec["ptxas"] = usage_of.get(DESIGN_FUNCTION[name], "not reported")
        records[name] = rec

    import autodist_tpu_torch as adt
    adt.reset()
    print("the whole smoke: %.1f s" % (time.perf_counter() - T_SMOKE))
    print("card: %s" % card_line())
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
