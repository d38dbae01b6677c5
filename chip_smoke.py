#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which asserts or raises (any failure exits nonzero):
  1. versions, device name and power limit;
  2. build the CUDA kernels from the sources in this checkout, one nvcc per
     source, all started together; print what ptxas reports per kernel and
     its tensor-core (HMMA) instruction count in the SASS (the bf16
     forward must have some, and no forward may spill);
  3. every kernel against its plain PyTorch version: the replay kernels at
     the reference shape (exact; the gather on unpadded and padded
     storage for random and off-contract indices in int32 and int64,
     batch 1, window 1, a partial last chunk, and an 83x83 frame, which
     takes its byte-wide kernel; the decode in both output layouts,
     standard and 2x2 space-to-depth, on unpadded and padded storage, and
     its any-shape kernel at shapes its fast one does not tile), the LSTM
     scan kernels at ragged small shapes and at the reference shape (T=55,
     B=128, H=512) in f32 and bf16 (tolerances at LSTM_TOL), and the f32
     reference shape again right after a new, smaller shape of the same
     kernels (LSTM_ORDER_SHAPE); CUDA-event
     times of kernel (timed alone, ``ms``, and back to back, ``b2b_ms``:
     20 launches enqueued behind a spin kernel, the gather on a fresh draw
     of indices each launch; the decode also right after a gather), plain
     version and the PyTorch library call, and the bound; cuDNN's nn.LSTM
     timed beside the port's LSTM layer as a yardstick; then the first
     conv timed in each input layout it could take
     (r2d2_tpu_torch/tools/conv_layouts.py);
  4. a small f32 learner step on the card against the same step on the
     CPU, on the default path and with network.pallas_lstm="on" and double
     DQN; one f32 step at the reference widths (B=128 x 40+10+5, 84x84x4,
     cnn 1024, LSTM 512, dueling) with every kernel on, card against the
     port's CPU step; then over a replay at the reference shape (bf16)
     filled by replay_add_many (capacity cut from 500,000 to 100,000
     steps): one CUDA graph of 4 learner steps against 4 eager steps from
     the same state and jitter, on the default and fused_double paths
     (the replayed graph's kernels counted by name in the profile), and
     the reference paths of r2d2_tpu_torch/tools/bench.py (default,
     double, fused_double, fused), each at 1 and at the resolved
     runtime.steps_per_dispatch, timed in turns. Host placement: the
     external-batch step on host-sampled batches, card against the CPU
     (small f32 on the default path and with pallas_lstm on and double
     DQN, one f32 step at the reference widths; rtol 1e-4), its one-step
     CUDA graph against eager steps (bf16, reference shape, 4 steps),
     and the host-placement Learner at the reference shape (bench's host
     path) with a block ingested after every step: seq-updates/s, the
     prefetch thread's sample and copy ms, busy and idle, launches per
     step (no gather; the decode and the LSTM kernels once a step),
     by count and by the profile's kernel names;
  5. the synchronous trainer through its entry point,
     r2d2_tpu_torch.tools.sync_train, at the
     same widths for three dispatches of the resolved steps per dispatch
     (the eager warm-up, the capture, a replay), on the default path, with
     --network.pallas_lstm=on --network.use_double=true, and on padded
     storage (--replay.pallas_exact_gather=on, the exact-read gather's);
     the kernel launch counts of these runs go into the ``kernels`` line
     (the gather's two rows: unpadded and padded storage; a graph replay
     adds the launches its capture counted), each run under the profiler,
     whose kernel names must show the same launches (a run whose trace
     lost events runs again, at most PROFILE_TRIES times); the host path's
     timed launches go beside them (``host_path_launches``);
  6. the orchestrated trainer through its entry point,
     r2d2_tpu_torch.cli.train, at the reference widths (capacity 100,000)
     for ORCH_SECONDS each: thread actors on the default configuration,
     then spawned process actors (the shm ring) with
     --network.pallas_lstm=on --network.use_double=true; a periodic
     checkpoint every ORCH_SAVE_INTERVAL steps, ORCH_KEEP kept. Each run:
     the learner trains on cuda with finite losses, the step-0 and the
     final checkpoints are written, a periodic one falls inside the timed
     window and the step-0 one is pruned, the reference's log lines are
     there, every actor has ended (children with exit code 0, which they
     give only if they never initialized CUDA) and every shm segment is
     unlinked; a window of PROFILE_DISPATCHES dispatches under the
     profiler (one dispatch of tracer warm-up before it; a spin kernel
     marks its end on the card and one more dispatch runs traced, so the
     tracer's records of the window's last kernels are in; a trace that
     lost events is taken again, at most PROFILE_TRIES times), whose
     kernel names must equal the wrappers' launch counts, dQ's included
     where an interval step falls inside (these go into the ``kernels``
     line as ``orchestrated_launches``); the records carry the default
     diagnostics' ``learning`` and ``replay_diag`` blocks in the JAX
     package's schema, with finite gradient norms, an ESS > 0, a
     never-sampled share in [0, 1] where evictions are reported and lane
     counts over the fleet's lanes (phase 8 checks its records alike).
     Printed: the learner's seq-updates/s over a window from a sync
     after the dispatch that ends the default diagnostics' first period
     (the graph of every pattern of their interval steps captured by then:
     dispatch 51 at K=4; before them, the second dispatch) to a sync
     END_MARGIN_S before the run's
     bound (publications and checkpoints inside, and the figure with the
     checkpoints taken out; the profiled window follows it, away from a
     checkpoint, and its trace's processing outlasts the run's bound),
     env steps/s, the warm-up's seconds, blocks ingested, publications
     and their host ms, each checkpoint's step and ms, the host seconds
     spent in each part of the loop, the host ms between dispatches
     (median, p90, max, stalls, and the stalls' and largest intervals'
     host ms by part), and the device's busy and idle share over the
     profiled window; then r2d2_tpu_torch.cli.evaluate --play on the
     final checkpoint, 2 rounds;
  7. a Learner at one step a dispatch runs it as a CUDA graph of one
     step: against eager single steps from the same seed and blocks
     (small f32, with and without the diagnostics, and the
     learnability configuration below in bf16 as it trains) for
     SINGLE_STEPS dispatches, losses and tree within phase 4's rtol
     1e-4; then
     learnability: r2d2_tpu_torch/tools/learnability.py's configuration
     and thresholds (those of tests/test_torch_learnability.py) through
     tools.sync_train with the learner on the card, one
     step a dispatch (K=1, the JAX test's collect ratio of 2 env steps a
     step), the collecting policy on one intra-op thread as a process
     actor's: every evaluation seed >= 2x random, the mean >= 3x.
  8. on-device acting (actor/anakin.py, runtime/anakin_loop.py): two
     small f32 acting segments on the card against the CPU from the same
     weights and draws (Fake with the constant stamp, Grid with "td"
     priorities; integer fields equal, float fields within ANAKIN_ATOL);
     at the reference widths (bf16, ANAKIN_LANES lanes, 120-step blocks,
     the ring write into a 100,000-step replay) one graph replay against
     one eager segment from the same carry and generator state, bit for
     bit, two replays drawing differently, and the segment's CUDA-event
     ms (the ring of 99,960 steps: 833 blocks of 120); then cli.train --actor.on_device=true (the Fake env, the CUDA
     "auto" path: K=4, pallas_lstm on) for ANAKIN_SECONDS: it trains on
     cuda with finite losses, starts no actor, process or thread, and
     every block comes from the acting graph; a window of
     PROFILE_DISPATCHES dispatches under the profiler as in phase 6, whose
     kernel names must equal the wrappers' launch counts (these go into
     the ``kernels`` line as ``anakin_launches``); printed: seq-updates/s
     over a synced window against the bench's fused K in this call, env
     steps/s while training, host ms between dispatches, busy and idle
     over the profiled window, peak GB and the warm-up; last, the
     gridworld learns under the fused loop on the card
     (tools/learnability.py grid_config with telemetry off, as phase 7
     runs; the JAX test's threshold).
  9. serving on the card (serve/, ops/quant_kernels.py): (a) int8_linear
     against its plain version at every dense shape of the quantized
     forward (torso 3136->1024, input projection 1030->2048, recurrent
     512->2048, head 512->512, outputs 512->6 and 512->1), M in
     QUANT_ROWS, bf16 and f32 activations (tolerances at QUANT_F32_RTOL,
     QUANT_BF16_ULP), timed at M=32 bf16 alone and back to back beside
     the bound (int8 weights, scales, x and y at 3.35 TB/s), the plain
     version and torch.matmul on the bf16 twin (the yardstick, alone and
     back to back); then back to back at every shape x QUANT_ROWS with
     bf16 x and at the recurrent product's M=64 with f32 x, each beside
     torch.matmul on the twin and torch._weight_int8pack_mm where the
     card's torch has a CUDA kernel for it (phase_quant_sweep); (b) the
     int8 forward at the reference widths, card (bf16 compute) against
     the port's CPU forward (f32): greedy agreement >= 0.99 outside the
     tie band, |dQ| <= 5% of the Q scale (JAX's tests/test_quant.py
     rule), f32-compute int8 card vs CPU within 1e-4, and the weight
     bytes a forward for f32 / bf16 / int8; (c) the PolicyServer at the
     reference widths, f32 (bf16 compute) and int8: every bucket's CUDA
     graph against the eager forward bit for bit, then SERVE_STEPS steps
     of 32 lanes served against the eager forward from the same states
     (actions and hidden equal; every dispatch a full bucket); (d)
     python -m r2d2_tpu_torch.cli.serve as a process, f32 and int8,
     loaded by socket clients (r2d2_tpu_torch/tools/serve_load.py
     processes) at SERVE_LANES lanes: requests/s, client p50/p99,
     dispatches/s, batch fill, the forward's CUDA-event ms per bucket, the
     record's serving and quant blocks; it exits 0 at --seconds; (e)
     cli.train --actor.inference=server (thread actors, int8 inference,
     Fake, capacity 100,000) for SERVED_TRAIN_SECONDS: trains on cuda with
     finite losses, every action served, a serving block in the record;
     seq-updates/s against the bench's default path at the resolved K in
     this call, env steps/s and the serving latency. The counts of (c),
     (d) and (e) go into the ``kernels`` line as ``serve_launches``
     (int8_linear's ``launches``);
 10. pipelined ingest, crash recovery and quantized on-device acting:
     (a) cli.train with thread actors on the CUDA "auto" path (capacity
     100,000) for INGEST_SECONDS at replay.ingest_batch_blocks 1 and then
     8: cuda, finite losses, every block an actor sent committed or still
     queued (the staged counters at zero); seq-updates/s over a synced
     window and its two halves against the bench's default at the
     resolved K in this call, host ms between dispatches (stalls by part),
     ms a commit and a staged batch, the staging queue's depth, and which
     K was faster beyond the halves' spread; (b) a learner at the
     reference widths fills, steps, saves, snapshots and steps again; one
     resumed from that checkpoint and snapshot holds the same replay and
     gives the same losses bit for bit (capture host ms, write s, payload
     bytes printed); then cli.train --runtime.auto_resume=true
     --runtime.snapshot_interval=SUPERVISED_SNAPSHOT_INTERVAL as a process,
     its child (learner.pid) SIGKILLed once the first snapshot is
     committed: the supervisor relaunches it, it restores the replay
     (restores 1, restored blocks > 0) and trains on cuda (the time from
     the kill to its first dispatch printed); (c) a small int8 acting
     segment on the card (its twin computing in f32) against the CPU's
     from the same weights and draws, and the bf16-compute twin's Q on
     the end states by 9b's rule; the int8 segment at the reference widths,
     graph against eager bit for bit, its CUDA-event ms beside phase 8's
     f32 one; cli.train --actor.on_device=true
     --network.inference_dtype=int8 for QUANT_TRAIN_SECONDS: trains on
     cuda, quant blocks with probes, and a profiled window whose kernel
     names equal the wrappers' counts, int8_linear's included (these go
     into the ``kernels`` line as ``anakin_quant_launches``, and into
     int8_linear's ``launches``).
 11. data parallel (parallel/, runtime/data_parallel.py; the card's
     machine has one GPU, so no figure here is a multi-GPU speed): (a) a
     one-rank NCCL world at the reference shape (bf16, every kernel of
     the single-DQN step, K=DP_K): the data-parallel step is one CUDA
     graph with the NCCL all-reduce captured in it, and equals its eager
     twin and make_multi_learner_step bit for bit over three dispatches
     from one seed, replay and jitter; seq-updates/s of the sharded and
     the unsharded dispatch in turns in this call; a profiled window of
     the sharded graph whose kernel names equal the wrappers' counts
     (``sharded_nccl_launches`` in the ``kernels`` line counts every
     sharded dispatch of this part); (b) two gloo ranks sharing the card
     against two CPU ranks on the same dp=2 step (small f32; rtol 1e-4),
     the card ranks bit-equal; (c) orchestrator.train with mesh.dp=2,
     both ranks on the card over gloo, for DP_SECONDS at the reference
     widths, with thread actors (--network.pallas_lstm=on
     --network.use_double=true: every kernel) and with on-device acting
     (64 lanes, 32 a shard): finite losses on cuda, each rank's launches
     those of its steps, equal steps, bit-equal train states
     across the ranks, blocks round-robined, the anakin block's dp 2 and
     imbalance 1.0, no rank left running (the launch counts of every rank
     of both runs go into the ``kernels`` line as ``sharded_launches``).
     The card's name and power limit are printed beside its numbers.
 12. multi-host lockstep training (parallel/multihost.py; one GPU here,
     so no figure is a multi-host or multi-GPU speed): (a) one controller,
     an NCCL world of one, at the reference shape (bf16, bench's "fused"
     path, K=MH_K): the lockstep core with the sharded step (one CUDA
     graph of K steps, the all-reduce inside) against its eager twin over
     three dispatches from the same blocks and jitter, bit for bit; the
     host-placement sharded external-batch step (one CUDA graph of the
     step, BatchMean's all-reduce inside) against its eager twin over
     MH_HOST_STEPS host-sampled batches, bit for bit; then
     train_multihost with thread actors for MH_SECONDS with the rank-0
     replay snapshot twin on: finite losses, launches those of its steps,
     seq-updates/s over a synced window beside bench "fused" K=4 of this
     call, the host ms of an iteration's all-reduce, the snapshot written
     and loaded into a fresh replay; (b) the scripted lockstep core
     (tools/mh_check.py) at the small f32 shape, two gloo ranks on the
     card against two CPU ranks (rtol 1e-4 at two steps), card ranks
     bit-equal; (c) two controllers, each its own interpreter from the
     port's launcher, sharing the card over gloo at the reference widths
     with thread actors, device placement on fused_double and host
     placement: after MH_RUN_S seconds of training SIGTERM to controller
     1, both exit 0 on the same iteration and step with bit-equal train
     states, each shard fed by its own actors, each controller's launches
     those of its steps, no process left; ms a step and global
     seq-updates/s printed as gloo staging through one host. Every
     launch of phase 12 on the card, all controllers, goes into the
     ``kernels`` line as ``multihost_launches``.
 13. tensor, dp x mp and sequence parallelism (parallel/tensor_parallel.py,
     sequence_parallel.py, dryrun.py; gloo ranks sharing the one card, so
     no figure is a scaling number): (a) the tensor-parallel host-batch
     step at the reference shape (bf16, fused scan, double DQN), dp=1 x
     mp=2, against the unsharded step on the card from the same weights
     and batches for TP_STEPS steps, within TP_REF_TOL (each leaf's
     update against the unsharded one's among them, which a negative
     control with the row's partial input gradients unsummed must
     exceed); the largest sharded leaf half a rank; ms a step, the
     largest differences, the control's and each rank's launches (K3,
     K4, K4 lean, K5) printed; (b) the scripted
     TP core (tools/dp_check.py rank_tp_external), small f32, dp=2 x mp=2:
     four card ranks against four CPU ranks (losses rtol 1e-5), the card
     ranks bit-equal; (c) the dp x mp device-replay step at the reference
     widths in f32 (replay DPMP_BLOCKS blocks a shard): dp=2 x mp=2
     against dp=2 x mp=1 from the same state and draws with JAX's bounds
     (losses rtol 2e-5, params rtol 1e-4 atol 1e-6, trees rtol 1e-5), the
     row's replay replicas bit-equal, K1 among its launches; (d)
     make_sp_lstm, 5 stages x 4 microbatches over T=55, B=128, H=512,
     f32, against the unsharded lean scan on the card within SP_ATOL, K4
     lean once a microbatch a stage; (e) replay snapshots under dp=2, two
     Learner ranks: the resumed learner's three losses equal the twin's
     bit for bit, next_shard adopted, capture ms, write s and bytes
     printed; (f) every run_tiny_* dryrun and the loopback multi-host
     dryrun on the card; (g) the trainer's mp wiring, two Learner ranks
     at dp=1 x mp=2 under each placement (host: rank 0 scatters each
     batch): steps, a publish (the full network gathered), a gathered
     checkpoint that a resumed pair restores bit for bit, the path's
     kernels launched alike on both ranks; device placement also the
     snapshot twin bit for bit. (a) to (g) run side by side (their
     times are taken under each other's load). The launches go
     into the ``kernels`` line as ``tp_launches`` (a, b, g),
     ``dpmp_launches`` (c) and ``sp_launches`` (d). 11b, 13a and 13c run
     with both diagnostics: 11b's reduced ``ld/`` and ``rd/`` values equal
     the CPU ranks' (histograms exact), the ``rd/shard_*`` views with the
     dp axis; 13a's dQ NaN (host placement); 13c's mp replicas
     bit-equal.
 14. the learning and replay diagnostics (telemetry/learning.py,
     telemetry/replaydiag.py) at the reference shape (bf16, the fused
     scan, K=DIAG_K, a replay of DIAG_BLOCKS rows with DIAG_FILL blocks
     written): (a) DIAG_DISPATCHES dispatches of the K-step graph with
     both (dQ every 5 steps, a tree snapshot every 3, so dQ falls at each
     offset of a dispatch) against the same graph without them (losses,
     params and tree bit-equal: they only read the training state) and
     against eager steps with them (every ``ld/`` and ``rd/`` value within
     the CPU tests' bounds, counts exact); dQ and the snapshots at the
     interval steps only; each dispatch's launches the graph's without
     them plus DQ_DECODES decodes and lean forwards a dQ step; one graph
     a pattern of interval steps captured, at its first dispatch
     (``GraphedSteps.variants``); (b)
     the cost: graphs with and without them at the default intervals in
     windows of DIAG_WINDOW_S (off, on, on, off): seq-updates/s and, from
     CUDA events around each dispatch, the ms of a plain dispatch, of
     one holding a snapshot and of one holding dQ; (c) nan_policy=halt:
     a small Learner on the card whose params are poisoned after clean
     dispatches writes one forensics dump at its next flush and raises,
     and raises again with no second dump. The ``kernels`` line's
     ``dq_launches_per_interval_step`` is (a)'s.
 15. the runtime telemetry (telemetry/core.py, spans.py, board.py,
     profiler.py, costmodel.py; tools/profile_step.py): (a)
     r2d2_tpu_torch.cli.profile at the reference shape, bench's "fused"
     path at K=TELE_K, PROFILE_STEPS steps over a full ring of bench's
     REF_CAPACITY steps (its tree depth and gather spread): the trace
     (graph replays' kernels one by one) names gather_windows, stack_frames, lstm_fwd and
     lstm_bwd, every hand kernel with launches a step equal to the
     wrappers' counts in the window; the device kernels' ms and launches
     a step, model FLOPs a step and their share of the card's bf16 peak
     at bench fused's rate of this call; (b) runtime.profile_at_step in a
     short on-device cli.train run writes one trace with device kernels;
     (c) the stage timers' cost through the Learner, telemetry on (spans
     drained) against off, diagnostics off in both, windows of
     TELE_WINDOW_S in TELE_ORDER: the median over the pairs. Phases 6, 8,
     9(e) and 12(c) check their records' ``stages`` (every stage their
     mode observes: thread and process actors, the latter through the
     board; ``actor/act_scan``; ``serve/*``; rank 1's host rows in
     ``telemetry_host1.jsonl``), the first record's ``costs`` block and
     that every span file parses.
 16. the resource, compile and alert planes, tracing and the roofline
     (telemetry/resources.py, compile.py, alerts.py, tracing.py,
     traceparse.py, scopes.py; tools/roofline.py). Phases 6, 8, 9(e),
     12(c) and 15(c)'s planes arm check their records' ``resources`` and
     ``alerts`` blocks (_check_health_records): the device entry names
     this card with bytes in use and a headroom in (0, 1), the buffers
     hold the train state, the replay ring (and the acting carry, the
     serving graphs) with the bytes their tensors hold, the compile
     sub-block counted the run's graph captures with no retrace after
     warm-up (the serving buckets' coverage complete in 9e), no crit
     alert fired, the alert stream written (rank 1's own in
     ``alerts_host1.jsonl``). (a) inside 15(b)'s run, whose headroom
     floors are forced to 0.999: ``hbm_headroom`` fires once and the one
     forensics dump holds the record's buffers; (b) a serving graph
     captured again at RETRACE_NEW buckets after ``mark_warm``: counted as
     retraces, ``retrace_storm`` fires once; (c) served training with
     tracing on, every exchange and block traced, TRACED_SECONDS: every
     hop of the serving block's ``trace`` sub-block seen, the ring
     accountant's slot mirrors stamped; (d) 15(a)'s capture attributed to
     components through an eager profile of the same step (>= 80% of its
     device time), the learner step's FLOPs counted on the card with the
     kernels on within 5% of model_flops_per_step, and the roofline table
     over them printed with the card's name and power limit; (e) the
     planes' cost on top of the stage timers (15c's third arm) and the
     component scopes' cost on the eager step. Phase 10(b) splits its
     launch-to-first-snapshot seconds by part from the killed child's
     spans (``startup/*``, the dispatches) and the snapshot's manifest;
     phase 13(a) takes its first step again in f32, its gradients before
     the clip held per leaf to C5_GRAD_REL (relative L2) against the
     unsharded f32 step's (ROADMAP C.5).
 17. the replay service (fleet/replay_service.py, fleet/service_main.py,
     replay/snapshot.py's service cut): (a) card = CPU at the tiny shape,
     two shards, both routes at priority exponent 1 and round robin at the
     configuration's (trees and importance weights within
     SERVICE_POW_RTOL there), a tier that turns: grouped adds at
     SERVICE_K on the card, on the CPU and sequential adds on the card,
     samples with injected draws, write-backs through the staleness
     guard (a stale add between one sample and its write-back): shards,
     spill pages (order, stored priorities), batches and the guard's
     counts equal; one shard with a cold tier samples exactly
     ``replay_sample``; (b) ``cli.train`` at the reference shape under the
     service (tools/service_probe.py's settings, SERVICE_SECONDS, the
     counts set to 0 just
     before): demotions and promotions, two ring turnovers, every record's
     ``replay_service`` block with its tiers and ingest, a ``trace`` block
     with all three hops, no crit alert, K1, K3, K4 and K5 launched
     (the ``kernels`` line's ``service_launches``); seq-updates/s beside
     bench default K=1 of this call, the hit rate, the write-backs'
     counts, blocks per commit, the hops' p50 and the service's host
     timings (lock waits and holds by operation) printed; (c) the
     standalone service's kill drill on the card (``run_kill_drill``),
     its children started while (a) runs: the producer survives, adds
     monotone, the loss within DRILL_INTERVAL and a window of groups,
     the restart's cut bit-equal to the snapshot's; the restore's
     seconds and the reconnects printed.
     The script's total time is printed beside its budget, BUDGET_S.

TF32 is off throughout, as in training (utils/device.configure_numerics).
The last line is {"ok": true, "device": {...}}. ``--profile`` adds a
torch.profiler breakdown of three reference-shape steps of each path (a
graphed cell: one dispatch),
names any kernel of the first conv's 4-channel fallback it finds, and
checks that no copy kernel (an index cast) runs right before the
gather.
"""

import concurrent.futures
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BUDGET_S = 1120.0                  # the whole script's share of 1,200 s
# H100 SXM dense peaks by input type: bf16 on the tensor cores, f32 off them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = {"replay_kernels": "r2d2_tpu_torch/csrc/replay_kernels.cu",
                  "lstm_kernels": "r2d2_tpu_torch/csrc/lstm_kernels.cu",
                  "quant_kernels": "r2d2_tpu_torch/csrc/quant_kernels.cu"}
# the gather is one kernel; its rows: unpadded storage (the row gather's,
# K1) and tile-padded storage (the exact-read gather's, K2)
REPLACES = {
    "gather_windows": "r2d2_tpu/ops/pallas_kernels.py:325",
    "gather_windows_padded": "r2d2_tpu/ops/pallas_kernels.py:372",
    "stack_frames": "r2d2_tpu/ops/pallas_kernels.py:194",
    "lstm_fwd": "r2d2_tpu/ops/pallas_lstm.py:194",
    "lstm_fwd_lean": "r2d2_tpu/ops/pallas_lstm.py:194",
    "lstm_bwd": "r2d2_tpu/ops/pallas_lstm.py:307",
    # no Pallas site: the dequantize-into-matmul XLA fuses in the JAX
    # package's quantized forward
    "int8_linear": "r2d2_tpu/models/network.py:526",
}
# LSTM kernels vs plain versions, (atol, rtol) on outputs compared in f32.
# Not exact: the products sum in another order. f32: that order alone,
# grown over 55 steps. bf16: an f32 difference that flips a rounding of a
# bf16 output is one bf16 ulp, < 2e-2 below magnitude 2.5 and 2^-7 relative
# above it.
LSTM_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
# dWh sums T*B products per entry: max error / max |reference|
DWH_REL = {"float32": 1e-3, "bfloat16": 2e-2}
LSTM_REF_SHAPE = (55, 128, 512)                          # T, B, H
# ragged edges of the two kernels' shared partition (batch tiles of f32 32
# rows, bf16 16; unit groups of f32 16, bf16 32): H not a multiple of a
# group (H=17, 18, 24, 40), rows too narrow for 16-byte loads (the element
# path; k padded to 16 in shared memory), B one row past a tile (B=33) or
# with a partial last tile (B=3, 70, 130), B=256 at H=512, where a block
# walks two batch tiles, B=300 at H=512, where a slot's last walked tile
# lies past the batch (bf16 19 tiles over 8 slots, f32 10 over 4), and
# H=544, past the 512 k whose bf16 Wh operands the forward keeps in
# registers (the largest H whose f32 forward fits); T kept small for the
# plain version
LSTM_SMALL_SHAPES = ((4, 3, 17), (5, 8, 18), (6, 70, 16), (3, 130, 24),
                     (4, 33, 17), (4, 33, 40), (3, 256, 512), (2, 300, 512),
                     (2, 24, 544))
# a shape whose f32 kernels need less shared memory than the reference
# shape's, at an H no earlier check uses: launched between two reference
# launches, it must not shrink the kernels' shared-memory limit
LSTM_ORDER_SHAPE = (3, 8, 32)
FUSED_ARGS = ["--network.pallas_lstm=on", "--network.use_double=true"]
REF_WINDOW = 16                    # steps a timed window; a multiple of K
GRAPH_K = 4                        # the graph-vs-eager phase's dispatch
GRAPH_PATHS = ("default", "fused_double")
PROFILE_TRIES = 3                  # traces of one graph replay (if empty)
                                   # or of a window (if short)
HOST_WINDOWS = 2                   # timed windows of the host path
REF_CPU_BLOCKS = 8                 # replay of the card-vs-CPU f32 step
# the device's kernel names -> the wrapper launch count each stands for
KERNEL_NAMES = {
    "gather_windows": re.compile(r"gather_windows_\w+_kernel"),
    "stack_frames": re.compile(r"stack_frames_\w*kernel"),
    "lstm_fwd": re.compile(r"lstm_fwd_kernel<[^>]*true>"),
    "lstm_fwd_lean": re.compile(r"lstm_fwd_kernel<[^>]*false>"),
    "lstm_bwd": re.compile(r"lstm_bwd_kernel"),
    "int8_linear": re.compile(r"int8_linear_kernel"),
}
PADDED_ARGS = ["--replay.pallas_exact_gather=on"]    # 84x84 stored as 96x128
ORCH_SECONDS = 40.0                # each orchestrated cli.train run
ORCH_SAVE_INTERVAL = 800          # learner steps between its checkpoints
ORCH_KEEP = 2                      # checkpoints it keeps
END_MARGIN_S = 7.0                 # its timed window ends this long before
                                   # ORCH_SECONDS, at a sync; the profiled
                                   # window follows
PROFILE_DISPATCHES = 16            # dispatches of its profiled window
ORCH_RUNS = (("thread", [], "thread actors, default"),
             ("process", FUSED_ARGS,
              "process actors, pallas_lstm on, double DQN"))
ORCH_LOG_LINES = (r"^buffer size: \d+$", r"^buffer update speed: .*/s$",
                  r"^number of environment steps: \d+$",
                  r"^number of training steps: \d+$",
                  r"^training speed: .*/s$", r"^loss: -?\d+\.\d{4}$")
# on-device acting (phase 8): the reference widths with 120-step episodes
# and blocks, ANAKIN_LANES lanes (actor.anakin_lanes' default), the
# capacity cut to 99,960 steps (833 blocks of 120: the multiple of 120
# nearest below phase 6's 100,000)
ANAKIN_LANES = 64
ANAKIN_CFG = {"actor.on_device": True, "replay.block_length": 120,
              "env.episode_len": 120, "replay.capacity": 99_960}
ANAKIN_ARGS = ["--actor.on_device=true", "--env.game_name=Fake",
               "--replay.capacity=99960", "--replay.block_length=120",
               "--env.episode_len=120", "--network.pallas_lstm=auto"]
ANAKIN_SECONDS = 22.0              # the fused trainer's run
# card vs CPU on small f32 segments: f32 sums in other orders on the card
ANAKIN_ATOL = 1e-5
# the learning diagnostics' dQ: three unrolls (the stored state, a zero
# state, the whole stored row), each its own decode and, with the fused
# scan, its own lean forward
DQ_DECODES = 3
BACK_TO_BACK = 20                  # launches enqueued ahead of the card
SPIN_CYCLES = 20_000_000           # ~10 ms: longer than enqueuing them
# cuDNN kernels of a 4-channel first conv's fallback (a layout conversion,
# an f32 implicit GEMM)
FALLBACK_KERNELS = re.compile(r"nhwcToNchw|nchwToNhwc|nhwc2nchw|nchw2nhwc"
                              r"|f32f32_f32f32", re.IGNORECASE)


def check(cond, what="") -> None:
    """Fail the phase (an assert would vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _timed(label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds printed as ``timing LABEL S s``
    (PERF.md's phase table)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        print(f"timing {label} {time.perf_counter() - t0:.1f} s", flush=True)


def _import_port():
    """The port, from the checkout this script sits in, or raise."""
    import r2d2_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(r2d2_tpu_torch.__file__).resolve().parent.parent != here:
        raise SystemExit("r2d2_tpu_torch is not beside chip_smoke.py")
    return r2d2_tpu_torch


def _reset_counts() -> None:
    from r2d2_tpu_torch.ops.launch_counts import reset_launch_counts
    reset_launch_counts()


def _counts() -> dict:
    from r2d2_tpu_torch.ops.launch_counts import launch_counts
    return launch_counts()


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` timed alone on the current stream (CUDA
    events; the host's time between the events counts where the card
    waits for it)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def b2b_ms(fn, launches: int = BACK_TO_BACK, repeats: int = 5) -> float:
    """Milliseconds per launch back to back: a spin kernel holds the card
    while the host enqueues ``fn(0) .. fn(launches - 1)``, one event pair
    around them, divided by ``launches``; the median of ``repeats``."""
    import torch
    fn(0)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_versions():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def _ptxas_lines(report: str):
    """One line per kernel from ``nvcc -Xptxas -v``: registers, stack,
    spills, static shared memory."""
    lines, name, props = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = _demangle(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, {props}, static "
                         f"smem {smem.group(1) if smem else 0} B")
            name = None
    return lines


def _demangle(name: str) -> str:
    tool = shutil.which("c++filt")
    if not tool:
        return name
    return subprocess.run([tool, name], capture_output=True, text=True,
                          check=True).stdout.strip()


def _tensor_core_counts(lib_path) -> dict:
    """Tensor-core instructions (HMMA) per kernel in a built library's SASS
    (cuobjdump beside nvcc), or {} where cuobjdump is missing or fails."""
    from r2d2_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    proc = subprocess.run([str(tool), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return {}
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1))
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def phase_build():
    """Every source at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    from r2d2_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name, force=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        seconds = dict(zip(KERNEL_SOURCES, pool.map(timed, KERNEL_SOURCES)))
    for name, s in seconds.items():
        print(f"build: {name}.cu {s:.2f} s", flush=True)
        lines = _ptxas_lines(_build.PTXAS_REPORT[name])
        check(lines, f"no ptxas report for {name}")
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
        counts = _tensor_core_counts(_build.build(name))
        if not counts:
            print(f"sass {name}: not read (no cuobjdump output)", flush=True)
        for kernel, n in counts.items():
            print(f"sass {name}: {kernel}: {n} HMMA", flush=True)
        # the forward's bf16 product runs on the tensor cores, and no
        # forward instantiation spills
        for kernel, n in counts.items():
            if "lstm_fwd_kernel<__nv_bfloat16" in kernel:
                check(n > 0, f"no HMMA in {kernel}")
        # every int8_linear instantiation runs on the tensor cores
        for kernel, n in counts.items():
            if "int8_linear_kernel" in kernel:
                check(n > 0, f"no HMMA in {kernel}")
        for line in lines:
            if "lstm_fwd_kernel" in line:
                check("spill stores 0 B, spill loads 0 B" in line, line)


def _ops_run_by(fn) -> set:
    """The names of the PyTorch operators that ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return {e.key for e in p.key_averages()}


def gather_checks(dev, rings, window):
    """gather_windows against its plain version, exact: random and
    off-contract indices in int32 and int64, batch 1, window 1, both, a
    window whose bytes leave a partial last chunk of the kernel's plan, and
    an 83x83 frame (not a multiple of 16 bytes: the byte-wide kernel).
    Returns the max difference."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def draw(n, row_len, batch, win):
        return (torch.randint(0, n, (batch,), generator=g, device=dev),
                torch.randint(0, row_len - win + 1, (batch,), generator=g,
                              device=dev))

    ring83 = torch.randint(0, 256, (40, 96, 83, 83), generator=g,
                           device=dev, dtype=torch.uint8)
    errs = []
    for label, ring in {**rings, "83x83": ring83}.items():
        n, row_len, hs, ws = ring.shape
        # a window whose bytes the plan's chunk does not divide
        partial = next(w for w in range(window - 1, 0, -1)
                       if (w * hs * ws) % rk.gather_plan(
                           128, w, hs * ws, sms).chunk)
        odd = (torch.tensor([-1, 3, n + 5, 0, -n - 9], device=dev),
               torch.tensor([-30, row_len, 5, -1000, 2], device=dev))
        cases = [("random", *draw(n, row_len, 128, window), window),
                 ("off-contract", *odd, window),
                 ("batch 1", *draw(n, row_len, 1, window), window),
                 ("window 1", *draw(n, row_len, 128, 1), 1),
                 ("batch 1, window 1", *draw(n, row_len, 1, 1), 1),
                 (f"window {partial}, partial last chunk",
                  *draw(n, row_len, 128, partial), partial)]
        for case, bi64, st64, win in cases:
            for dtypes in ((torch.int32, torch.int32),
                           (torch.int64, torch.int32),
                           (torch.int64, torch.int64)):
                bi, st = bi64.to(dtypes[0]), st64.to(dtypes[1])
                got = rk.gather_windows_cuda(ring, bi, st, win)
                want = rk.gather_windows_plain(ring, bi, st, win)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"gather_windows {label} {case} {dtypes} differs")
                errs.append((got.int() - want.int()).abs().max().item())
        print(f"gather_windows {label} {tuple(ring.shape)}: exact in "
              f"{len(cases)} cases x 3 index dtypes", flush=True)
    return float(max(errs))


def gather_timings(dev, ring, window, max_abs_err):
    """gather_windows at the reference shape with int64 block indices, as
    the sampler gives them: timed alone, back to back on a fresh draw of
    indices each launch, its plain version, and the faster of two PyTorch
    calls that compute the same (advanced indexing; index_select over a
    strided view of the ring)."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk
    g = torch.Generator(device=dev).manual_seed(2)
    n, row_len, hs, ws = ring.shape
    frame = hs * ws
    draws = [(torch.randint(0, n, (128,), generator=g, device=dev),
              torch.randint(0, row_len - window + 1, (128,), generator=g,
                            device=dev, dtype=torch.int32))
             for _ in range(BACK_TO_BACK)]
    block_idx, start = draws[0]
    check(not {"aten::to", "aten::_to_copy", "aten::copy_"}
          & _ops_run_by(lambda: rk.gather_rows(ring, block_idx, start,
                                               window)),
          "gather_rows casts its int64 indices")
    tidx = start.long()[:, None] + torch.arange(window, device=dev)[None, :]
    bi = block_idx[:, None]
    windows = ring.view(-1).as_strided((n * row_len - window + 1,
                                        window * frame), (frame, 1))
    rows = block_idx * row_len + start
    want = rk.gather_windows_plain(ring, block_idx, start, window)
    check(torch.equal(ring[bi, tidx], want)
          and torch.equal(torch.index_select(windows, 0, rows).view(
              want.shape), want), "library calls differ from the plain one")
    library = {"ring[bi, t]": cuda_ms(lambda: ring[bi, tidx]),
               "index_select": cuda_ms(
                   lambda: torch.index_select(windows, 0, rows))}
    r = dict(max_abs_err=max_abs_err,
             ms=cuda_ms(lambda: rk.gather_windows_cuda(ring, block_idx,
                                                       start, window)),
             b2b_ms=b2b_ms(lambda i: rk.gather_windows_cuda(
                 ring, *draws[i], window)),
             plain_ms=cuda_ms(lambda: rk.gather_windows_plain(
                 ring, block_idx, start, window)),
             library_ms=min(library.values()),
             bound_ms=2 * 128 * window * frame / HBM_BYTES_PER_S * 1e3,
             bound_by="bytes")
    print(f"gather_windows {tuple(ring.shape)}: alone {r['ms']:.4f} ms, "
          f"back to back {r['b2b_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({100 * r['bound_ms'] / r['b2b_ms']:.1f}% of it back to "
          f"back), library " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in library.items()),
          flush=True)
    check(r["b2b_ms"] < r["library_ms"],
          "gather_windows is slower than a PyTorch call")
    return r, draws


def replay_kernel_checks(dev):
    """Replay kernels vs plain versions at the reference shape, exact, and
    their times."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk

    g = torch.Generator(device=dev).manual_seed(0)
    n, row_len, h, w, batch, t, k = 250, 448, 84, 84, 128, 55, 4
    window = t + k - 1
    rings = {label: torch.randint(0, 256, (n, row_len, hs, ws), generator=g,
                                  device=dev, dtype=torch.uint8)
             for label, (hs, ws) in (("unpadded", (h, w)),
                                     ("padded", (96, 128)))}
    err = gather_checks(dev, rings, window)
    results, gathered, draws = {}, {}, {}
    for label, name in (("unpadded", "gather_windows"),
                        ("padded", "gather_windows_padded")):
        results[name], draws[label] = gather_timings(dev, rings[label],
                                                     window, err)
        gathered[label] = rk.gather_windows_cuda(
            rings[label], *draws[label][0], window)
    obs, obs_padded = gathered["unpadded"], gathered["padded"]
    # the decode right after a gather, back to back, as the step runs them
    ring, marks = rings["unpadded"], []

    def gather_then_decode(i):
        out = rk.gather_windows_cuda(ring, *draws["unpadded"][i], window)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rk.stack_frames_cuda(out, t, k, torch.bfloat16, h, w, True)
        b.record()
        marks.append((a, b))

    b2b_ms(gather_then_decode, repeats=1)
    after_gather = statistics.median(a.elapsed_time(b) for a, b in marks[1:])
    del rings, ring

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for s2d, layout in ((False, "standard"), (True, "space-to-depth")):
            shape = ((batch, t, h // 2, w // 2, 4 * k) if s2d
                     else (batch, t, h, w, k))
            for label, src in (("unpadded", obs), ("padded", obs_padded)):
                got = rk.stack_frames_cuda(src, t, k, dtype, h, w, s2d)
                want = rk.stack_frames_plain(src, t, k, dtype, h, w, s2d)
                torch.cuda.synchronize()
                check(got.shape == shape and got.dtype == dtype,
                      f"stack_frames {layout} {dtype} shape "
                      f"{tuple(got.shape)}")
                check(torch.equal(got, want),
                      f"stack_frames {layout} {dtype} {label}")
                errs.append((got.float() - want.float()).abs().max().item())
                print(f"stack_frames {layout} {dtype} {label}: exact",
                      flush=True)
    # shapes the kernel's 16-byte pieces do not tile (K=3, an odd width, a
    # misaligned view) take its any-shape kernel: exact all the same
    misaligned = obs[:5].flatten()[1:1 + 4 * window * h * w].view(
        4, window, h, w)
    odd_cases = [(obs[:4], 3, h, w, s2d, dtype)
                 for s2d in (False, True)
                 for dtype in (torch.float32, torch.bfloat16)]
    odd_cases += [(obs[:4], k, h, w - 1, False, torch.bfloat16),
                  (misaligned, k, h, w, True, torch.bfloat16)]
    for src, kk, hh, ww, s2d, dtype in odd_cases:
        got = rk.stack_frames_cuda(src, t, kk, dtype, hh, ww, s2d)
        want = rk.stack_frames_plain(src, t, kk, dtype, hh, ww, s2d)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"stack_frames K={kk} {hh}x{ww} "
              f"space_to_depth={s2d} {dtype}")
    print(f"stack_frames any-shape kernel ({len(odd_cases)} cases): exact",
          flush=True)
    out_bytes = batch * t * h * w * k * 2
    bound_ms = (obs.numel() + out_bytes) / HBM_BYTES_PER_S * 1e3
    # the main path decodes into the space-to-depth layout in bf16
    results["stack_frames"] = dict(
        max_abs_err=float(max(errs)),
        ms=cuda_ms(lambda: rk.stack_frames_cuda(obs, t, k, torch.bfloat16,
                                                h, w, True)),
        plain_ms=cuda_ms(lambda: rk.stack_frames_plain(obs, t, k,
                                                       torch.bfloat16, h, w,
                                                       True)),
        b2b_ms=b2b_ms(lambda i: rk.stack_frames_cuda(obs, t, k,
                                                      torch.bfloat16, h, w,
                                                      True)),
        b2b_after_gather_ms=after_gather, library_ms=None,
        bound_ms=bound_ms, bound_by="bytes")
    print(f"stack_frames bf16 space-to-depth: back to back "
          f"{results['stack_frames']['b2b_ms']:.4f} ms alone, "
          f"{after_gather:.4f} ms right after a gather", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for s2d, layout in ((False, "standard"), (True, "space-to-depth")):
            ms = cuda_ms(lambda: rk.stack_frames_cuda(obs, t, k, dtype, h, w,
                                                      s2d))
            bound = (obs.numel() + out_bytes // 2 * dtype.itemsize) \
                / HBM_BYTES_PER_S * 1e3
            print(f"stack_frames {layout} {dtype}: kernel {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f}% of it)",
                  flush=True)
    return results


def _lstm_inputs(dev, shape, dtype, seed):
    """xpb, wh, c0, h0 and the cotangents dhseq, dc_fin, dh_fin."""
    import torch
    steps, batch, hidden = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*dims, scale=1.0):
        return (torch.randn(dims, generator=g, device=dev) * scale).to(dtype)

    return (randn(steps, batch, 4 * hidden),
            randn(hidden, 4 * hidden, scale=hidden ** -0.5),
            randn(batch, hidden, scale=0.5), randn(batch, hidden, scale=0.5),
            randn(steps, batch, hidden), randn(batch, hidden),
            randn(batch, hidden))


def _max_err(name, got, want, dtype_name) -> float:
    """Max |got - want| in f32; raises past LSTM_TOL."""
    atol, rtol = LSTM_TOL[dtype_name]
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name} shape {tuple(got.shape)}")
    err = (got - want).abs()
    check(bool(got.isfinite().all()), f"{name} not finite")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{name} ({dtype_name}): max err {err.max().item():.3e}")
    return err.max().item()


def lstm_check(dev, shape, dtype):
    """The three LSTM kernels against their plain versions on one input.
    The backward takes the kernel forward's residuals on both sides, so it
    is compared alone. Returns the max error per kernel."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    dname = str(dtype).removeprefix("torch.")
    xpb, wh, c0, h0, dhseq, dcfin, dhfin = _lstm_inputs(dev, shape, dtype, 7)
    got = lk.lstm_fwd_cuda(xpb, wh, c0, h0, save_residuals=True)
    want = lk.lstm_fwd_plain(xpb, wh, c0, h0, save_residuals=True)
    errs = {"lstm_fwd": max(_max_err(f"lstm_fwd {n}", a, b, dname)
                            for n, a, b in zip(("hseq", "cseq", "acts"),
                                               got, want))}
    lean_h, lean_c = lk.lstm_fwd_cuda(xpb, wh, c0, h0, save_residuals=False)
    check(torch.equal(lean_h, got[0]) and torch.equal(lean_c, got[1][-1]),
          f"lean forward differs from the residual forward at {shape}")
    errs["lstm_fwd_lean"] = max(
        _max_err("lstm_fwd_lean hseq", lean_h, want[0], dname),
        _max_err("lstm_fwd_lean c_fin", lean_c, want[1][-1], dname))
    hseq, cseq, acts = got
    bgot = lk.lstm_bwd_cuda(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin,
                            dhfin)
    bwant = lk.lstm_bwd_plain(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin,
                              dhfin)
    torch.cuda.synchronize()
    check(bgot[0].dtype == dtype and bgot[1].dtype == torch.float32,
          "lstm_bwd output types")
    errs["lstm_bwd"] = max(_max_err(f"lstm_bwd {n}", a, b, dname)
                           for n, a, b in zip(("dxpb", "dc0", "dh0"),
                                              (bgot[0], bgot[2], bgot[3]),
                                              (bwant[0], bwant[2], bwant[3])))
    dwh_err = (bgot[1] - bwant[1]).abs().max().item()
    dwh_rel = dwh_err / bwant[1].abs().max().item()
    check(bool(bgot[1].isfinite().all()) and dwh_rel <= DWH_REL[dname],
          f"lstm_bwd dWh ({dname}) at {shape}: relative err {dwh_rel:.3e}")
    errs["lstm_bwd"] = max(errs["lstm_bwd"], dwh_err)
    print(f"lstm kernels {dname} T,B,H={shape}: max err fwd "
          f"{errs['lstm_fwd']:.3e}, lean {errs['lstm_fwd_lean']:.3e} (equal "
          f"to the residual forward), bwd {errs['lstm_bwd']:.3e}, dWh "
          f"relative {dwh_rel:.3e}", flush=True)
    return errs


def lstm_bounds(shape, dtype_name):
    """(bound_ms, bound_by) per LSTM kernel: the larger of the bytes each
    input read once and each output written once over the memory rate, and
    the two recurrent products' operations (the backward's are two) over
    the peak rate of the input type."""
    steps, batch, hidden = shape
    e = 4 if dtype_name == "float32" else 2
    gates, seq, carry = steps * batch * 4 * hidden, steps * batch * hidden, \
        batch * hidden
    wh = hidden * 4 * hidden
    product = 2 * steps * batch * hidden * 4 * hidden
    work = {
        "lstm_fwd": ((gates + wh + 2 * carry + 2 * seq + gates) * e, product),
        "lstm_fwd_lean": ((gates + wh + 2 * carry + seq + carry) * e,
                          product),
        # dhseq, acts, cseq, hseq, Wh, c0, h0, dc_fin, dh_fin in; dxpb in
        # the storage type, dWh, dc0 and dh0 in f32 out
        "lstm_bwd": ((3 * seq + gates + wh + 4 * carry + gates) * e
                     + (wh + 2 * carry) * 4, 2 * product),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def lstm_kernel_checks(dev):
    """LSTM kernels vs plain versions (ragged small shapes, then the
    reference shape, f32 and bf16; then LSTM_ORDER_SHAPE and the reference
    shape in f32) and their times in bf16, the main path's type; f32
    times printed beside."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    from r2d2_tpu_torch.utils.device import sm_count
    errs = {"lstm_fwd": 0.0, "lstm_fwd_lean": 0.0, "lstm_bwd": 0.0}
    for shape in (*LSTM_SMALL_SHAPES, LSTM_REF_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            for name, err in lstm_check(dev, shape, dtype).items():
                errs[name] = max(errs[name], err)
    # shared memory: the reference shape, a new smaller one, the reference
    # shape again (its launch setup cached), on the same instantiations
    sms = sm_count(dev)
    smem = [(lk.fwd_geometry(b, h, torch.float32, sms).smem,
             lk.bwd_geometry(b, h, torch.float32, sms).smem)
            for _, b, h in (LSTM_REF_SHAPE, LSTM_ORDER_SHAPE)]
    check(all(small < ref for ref, small in zip(*smem)), f"smem {smem}")
    for shape in (LSTM_ORDER_SHAPE, LSTM_REF_SHAPE):
        for name, err in lstm_check(dev, shape, torch.float32).items():
            errs[name] = max(errs[name], err)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        xpb, wh, c0, h0, dhseq, dcfin, dhfin = _lstm_inputs(
            dev, LSTM_REF_SHAPE, dtype, 7)
        hseq, cseq, acts = lk.lstm_fwd_cuda(xpb, wh, c0, h0)
        bwd_args = (wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin)
        times = {
            "lstm_fwd": (lambda: lk.lstm_fwd_cuda(xpb, wh, c0, h0),
                         lambda: lk.lstm_fwd_plain(xpb, wh, c0, h0)),
            "lstm_fwd_lean": (
                lambda: lk.lstm_fwd_cuda(xpb, wh, c0, h0, False),
                lambda: lk.lstm_fwd_plain(xpb, wh, c0, h0, False)),
            "lstm_bwd": (lambda: lk.lstm_bwd_cuda(*bwd_args),
                         lambda: lk.lstm_bwd_plain(*bwd_args)),
        }
        bounds = lstm_bounds(LSTM_REF_SHAPE, dname)
        for name, (kernel, plain) in times.items():
            r = dict(max_abs_err=errs[name], ms=cuda_ms(kernel),
                     b2b_ms=b2b_ms(lambda i: kernel()),
                     plain_ms=cuda_ms(plain, runs=10), library_ms=None,
                     bound_ms=bounds[name][0], bound_by=bounds[name][1])
            print(f"{name} {dname} T,B,H={LSTM_REF_SHAPE}: kernel "
                  f"{r['ms']:.4f} ms (back to back {r['b2b_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})",
                  flush=True)
            if dtype == torch.bfloat16:
                results[name] = r
    return results


def lstm_layer_yardstick(dev):
    """cuDNN's nn.LSTM against the port's LSTM layer (input projection by
    torch.matmul + the fused scan kernels), forward + backward, bf16, at
    the learner's widths. A yardstick only: the port never calls cuDNN's
    LSTM, and no single PyTorch call computes the scan alone."""
    import torch
    from r2d2_tpu_torch.ops.lstm_kernels import lstm_scan
    batch, steps, dim, hidden = 128, 55, 1042, 512
    g = torch.Generator(device=dev).manual_seed(11)

    def param(*dims, scale):
        return (torch.randn(dims, generator=g, device=dev) * scale).to(
            torch.bfloat16).requires_grad_(True)

    x = param(batch, steps, dim, scale=1.0)
    wi = param(dim, 4 * hidden, scale=dim ** -0.5)
    wh = param(hidden, 4 * hidden, scale=hidden ** -0.5)
    bias = param(4 * hidden, scale=0.1)
    zeros = torch.zeros(batch, hidden, device=dev, dtype=torch.bfloat16)
    dout = torch.randn(batch, steps, hidden, generator=g, device=dev).to(
        torch.bfloat16)

    def port():
        xpb = (x @ wi + bias).transpose(0, 1).contiguous()
        hseq, _ = lstm_scan(xpb, wh, zeros, zeros)
        torch.autograd.backward(hseq.transpose(0, 1), dout)

    cudnn = torch.nn.LSTM(dim, hidden, batch_first=True).to(dev,
                                                            torch.bfloat16)
    cudnn.flatten_parameters()

    def library():
        out, _ = cudnn(x, (zeros[None], zeros[None]))
        torch.autograd.backward(out, dout)

    port_ms, cudnn_ms = cuda_ms(port, runs=20), cuda_ms(library, runs=20)
    print(f"LSTM layer forward+backward (B={batch}, T={steps}, D={dim}, "
          f"H={hidden}, bf16), yardstick: port (matmul + lstm_fwd + "
          f"lstm_bwd) {port_ms:.4f} ms, cuDNN nn.LSTM {cudnn_ms:.4f} ms",
          flush=True)


def phase_conv_layouts(dev):
    """The first conv in each input layout it could take, bf16 and f32,
    forward + weight gradient at the reference frames
    (r2d2_tpu_torch/tools/conv_layouts.py)."""
    from r2d2_tpu_torch.tools import conv_layouts
    err = conv_layouts.check_layouts_agree(dev)
    conv_layouts.print_results(conv_layouts.measure(dev))
    print(f"conv layouts agree to {err:.3e} (f32)", flush=True)


def phase_kernels(dev):
    results = replay_kernel_checks(dev)
    results.update(lstm_kernel_checks(dev))
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms (back to back "
              f"{r['b2b_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})", flush=True)
    lstm_layer_yardstick(dev)
    return results


def _tiny_config():
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{
        "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "network.bf16": "off",
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 800, "replay.block_length": 20,
        "replay.batch_size": 8, "optim.lr": 1e-3})


def phase_small_step_vs_cpu(dev, overrides, label):
    """Two f32 learner steps at a small shape: card (kernels) vs CPU (plain
    versions) on the same replay, weights and jitter. Tolerance: rtol 1e-4
    on the loss and the tree (different conv/matmul algorithms and the LSTM
    kernels sum in other orders; TF32 is off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    from r2d2_tpu_torch.tools import bench
    cfg = _tiny_config().replace(**overrides)
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    rng = np.random.default_rng(1)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    uniforms = torch.rand((2, spec.batch_size),
                          generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in (torch.device("cpu"), dev):
        spec, rs = bench.filled_replay(cfg, device, blocks)
        ts, step = bench.build_learner_step(cfg, device, spec, eager=True)
        _reset_counts()
        losses = []
        for u in uniforms:
            ts, rs, m = step(ts, rs, u.to(device))
            losses.append(float(m["loss"]))
        runs[device.type] = (losses, rs.tree.cpu(), _counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4,
                               atol=1e-6)
    check(not any(runs["cpu"][2].values()), f"CPU launched {runs['cpu'][2]}")
    fused = overrides.get("network.pallas_lstm") == "on"
    double = overrides.get("network.use_double", False)
    steps = len(uniforms)
    want = {"gather_windows": steps, "stack_frames": steps,
            "lstm_fwd": steps if fused else 0,
            "lstm_fwd_lean": steps if fused and double else 0,
            "lstm_bwd": steps if fused else 0, "int8_linear": 0}
    check(runs["cuda"][2] == want, f"{label}: launches {runs['cuda'][2]}")
    print(f"small learner step ({label}), card vs CPU: losses "
          f"{runs['cuda'][0]} vs {runs['cpu'][0]}, launches "
          f"{runs['cuda'][2]}", flush=True)


def _want_launches(overrides: dict, steps: int, dq_steps: int = 0) -> dict:
    """Launches per kernel in ``steps`` learner steps of a path: one
    gather and one decode a step (one decode feeds every unroll), and with
    the fused scan its forward and backward, plus the lean forward of the
    double-DQN target unroll. ``dq_steps`` of them are the learning
    diagnostics' interval steps, whose dQ adds DQ_DECODES decodes and,
    with the fused scan, as many lean forwards."""
    double = bool(overrides.get("network.use_double", False))
    fused = overrides.get("network.pallas_lstm") == "on"
    return {"gather_windows": steps,
            "stack_frames": steps + DQ_DECODES * dq_steps,
            "lstm_fwd": steps if fused else 0,
            "lstm_fwd_lean": ((steps if double else 0)
                              + DQ_DECODES * dq_steps) if fused else 0,
            "lstm_bwd": steps if fused else 0, "int8_linear": 0}


def _dq_steps(first: int, last: int, interval: int = 0) -> int:
    """The learning diagnostics' interval steps among steps first+1 ..
    last (``interval``: the default telemetry.learning_interval)."""
    if not interval:
        from r2d2_tpu_torch.config import Config
        interval = Config().telemetry.learning_interval
    return last // interval - first // interval


def _profiled_kernel_counts(prof) -> dict:
    """Launches per kernel in a profile, read from the device's own kernel
    names (what a CUDA graph replay ran, which no wrapper counted)."""
    from r2d2_tpu_torch.tools import bench
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for event in bench.device_kernels(prof):
        for name, pattern in KERNEL_NAMES.items():
            if pattern.search(event.name):
                counts[name] += 1
    return counts


def _lost_events(seen: dict, want: dict) -> bool:
    """A trace that shows fewer of some kernel and more of none than were
    launched: it lost events (the tracer's, not the card's), and is taken
    again."""
    return seen != want and all(seen[k] <= want[k] for k in seen)


def _profile(dispatch, dispatches: int, steps: int) -> float:
    """torch.profiler over ``dispatches`` calls of ``dispatch()``: prints
    the top ops by device time and returns the device's busy ms per
    step."""
    from torch.autograd import DeviceType
    from r2d2_tpu_torch.tools import bench
    prof, _ = bench.profile_steps(dispatch, dispatches)
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=20),
          flush=True)
    # what cuDNN did with a 4-channel first conv: a layout conversion and
    # an f32 implicit GEMM
    fallback = [f"{e.key[:100]} {e.self_device_time_total / 1e3 / steps:.3f}"
                " ms" for e in events if e.device_type == DeviceType.CUDA
                and FALLBACK_KERNELS.search(e.key)]
    print(f"first-conv fallback kernels: {fallback or 'none'}", flush=True)
    # the sampler's int64 block indices reach the gather as they are: no
    # cast (a copy kernel) runs right before it
    kernels = bench.device_kernels(prof)
    before = {kernels[i - 1].name[:100] for i, e in enumerate(kernels)
              if i and "gather_windows" in e.name}
    print(f"kernels right before gather_windows: {sorted(before)}",
          flush=True)
    check(before and not any("copy" in name for name in before),
          f"a copy runs before gather_windows: {before}")
    return bench.device_busy_ms(prof) / steps


def phase_reference_replay(dev, blocks=None):
    """The reference configuration's replay, filled by replay_add_many
    with synthetic blocks (capacity cut from 500,000 to 100,000 steps),
    ``blocks`` when given (a refill of the same replay)."""
    import torch
    from r2d2_tpu_torch.tools import bench
    base = bench.reference_config()
    t0 = time.perf_counter()
    if blocks is None:
        blocks = bench.synthetic_blocks(base, base.num_blocks)
    spec, rs = bench.filled_replay(base, dev, blocks)
    torch.cuda.synchronize()
    print(f"reference replay: {spec.num_blocks} blocks, capacity "
          f"{bench.REF_CAPACITY} steps (cut from 500,000), ring "
          f"{spec.device_ring_bytes / 1e9:.2f} GB, filled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return base, spec, rs, blocks


def _clone_replay(rs):
    import dataclasses
    import torch
    return dataclasses.replace(rs, **{
        f.name: getattr(rs, f.name).clone() for f in dataclasses.fields(rs)
        if torch.is_tensor(getattr(rs, f.name))})


def phase_graph_vs_eager(dev, base, spec, rs):
    """One CUDA graph of GRAPH_K steps against GRAPH_K eager single steps
    at the reference shape (bf16), on GRAPH_PATHS: the same weights, each
    on its own copy of one replay, the same injected (K, B) jitter, three
    dispatches (the eager warm-up, the capture and its first replay, a
    second replay), then a fourth with each side drawing its jitter from
    its own generator. Losses and tree within rtol 1e-4: the two runs take
    the same kernels, but cuDNN's weight gradients and the LSTM backward's
    dWh sum in an order that may differ between runs. A fifth dispatch,
    a replay, runs under the profiler (a trace that lost events is taken
    again on the next replay, at most PROFILE_TRIES times): every kernel
    of the path ran GRAPH_K times in it, by the device's kernel names,
    and the launch counts that the graph adds per replay say the same."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    uniforms = torch.rand((3, GRAPH_K, spec.batch_size),
                          generator=torch.Generator().manual_seed(5)).to(dev)
    for label in GRAPH_PATHS:
        overrides = bench.PATHS[label]
        cfg = base.replace(**overrides)
        rs_graph, rs_eager = _clone_replay(rs), _clone_replay(rs)
        ts_graph, multi = bench.build_learner_step(cfg, dev, spec,
                                                   GRAPH_K)
        ts_eager, single = bench.build_learner_step(cfg, dev, spec,
                                                    eager=True)
        want = _want_launches(overrides, GRAPH_K)
        for d, u in enumerate(uniforms):
            _reset_counts()
            _, _, m = multi(ts_graph, rs_graph, u)
            counted = _counts()
            check(counted == want, f"graph {label} dispatch {d}: launches "
                  f"{counted}, want {want}")
            eager = torch.stack([single(ts_eager, rs_eager, u[k])[2]["loss"]
                                 for k in range(GRAPH_K)])
            got, ref = m["loss"].cpu().numpy(), eager.cpu().numpy()
            check(m["loss"].shape == (GRAPH_K,) and np.isfinite(got).all(),
                  f"graph {label}: losses {got}")
            np.testing.assert_allclose(got, ref, rtol=1e-4)
            np.testing.assert_allclose(rs_graph.tree.cpu().numpy(),
                                       rs_eager.tree.cpu().numpy(),
                                       rtol=1e-4, atol=1e-6)
            print(f"graph vs eager ({label}, K={GRAPH_K}) dispatch {d}: "
                  f"losses {got.tolist()} vs {ref.tolist()}, max rel "
                  f"{float(np.max(np.abs(got - ref) / np.abs(ref))):.3e}, "
                  f"launches {counted}", flush=True)
        # a fourth dispatch on each side's own generator (seeded alike and
        # not drawn from so far): the graph's K draws of B are the jitter
        # chain of K single steps
        _, _, m = multi(ts_graph, rs_graph)
        eager = torch.stack([single(ts_eager, rs_eager)[2]["loss"]
                             for _ in range(GRAPH_K)])
        np.testing.assert_allclose(m["loss"].cpu().numpy(),
                                   eager.cpu().numpy(), rtol=1e-4)
        check(multi.graph is not None and ts_graph.step == 4 * GRAPH_K
              and int(ts_graph.step_count) == 4 * GRAPH_K,
              f"graph {label}: step {ts_graph.step}")
        # one more replay under the profiler (a trace that lost events is
        # taken again, on the next replay)
        for _ in range(PROFILE_TRIES):
            _reset_counts()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                multi(ts_graph, rs_graph)
                torch.cuda.synchronize()
            seen = _profiled_kernel_counts(prof)
            check(_counts() == want, f"graph {label}: launches {_counts()}")
            if not _lost_events(seen, want):
                break
        check(seen == want, f"graph {label}: the profile shows {seen}, "
              f"want {want}")
        print(f"graph vs eager ({label}): the replayed graph ran every "
              f"kernel {GRAPH_K} times by the profile: {seen}", flush=True)
        del rs_graph, rs_eager, multi, single, ts_graph, ts_eager
        torch.cuda.empty_cache()


def phase_reference_vs_cpu(dev):
    """One f32 learner step at the reference widths (84x84x4, cnn_out
    1024, LSTM 512, dueling, B=128 x 55 steps) with every kernel on
    (network.pallas_lstm="on"): the card against the port's CPU step (the
    plain versions) on the same replay of REF_CPU_BLOCKS blocks, weights
    and jitter. rtol 1e-4 on the loss, the grad norm and the tree: cuDNN,
    cuBLAS and the LSTM kernels sum in other orders than the CPU (TF32 is
    off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**{
        "replay.capacity": REF_CPU_BLOCKS * 400, "network.bf16": "off",
        "network.pallas_lstm": "on"})
    blocks = bench.synthetic_blocks(cfg, cfg.num_blocks, seed=3)
    uniform = torch.rand(cfg.replay.batch_size,
                         generator=torch.Generator().manual_seed(4))
    runs = {}
    for device in (torch.device("cpu"), dev):
        spec, rs = bench.filled_replay(cfg, device, blocks)
        ts, step = bench.build_learner_step(cfg, device, spec, eager=True)
        _reset_counts()
        t0 = time.perf_counter()
        _, rs, m = step(ts, rs, uniform.to(device))
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        runs[device.type] = dict(
            loss=loss, grad_norm=norm, tree=rs.tree.cpu().numpy(),
            params={k: v.cpu() for k, v in ts.params.state_dict().items()},
            seconds=time.perf_counter() - t0, launches=_counts())
    cpu, card = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-4)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(card["tree"], cpu["tree"], rtol=1e-4,
                               atol=1e-6)
    check(card["launches"] == _want_launches(
        {"network.pallas_lstm": "on"}, 1), f"launches {card['launches']}")
    check(not any(cpu["launches"].values()), "the CPU step launched")
    param_err = max(float((card["params"][k] - v).abs().max())
                    for k, v in cpu["params"].items())
    tree_rel = float(np.max(np.abs(card["tree"] - cpu["tree"])
                            / np.maximum(np.abs(cpu["tree"]), 1e-30)))
    print(f"reference-shape f32 step, card vs CPU (B="
          f"{cfg.replay.batch_size}, {REF_CPU_BLOCKS} blocks): loss "
          f"{card['loss']!r} vs {cpu['loss']!r} (rel "
          f"{abs(card['loss'] - cpu['loss']) / abs(cpu['loss']):.3e}), "
          f"grad norm {card['grad_norm']!r} vs {cpu['grad_norm']!r}, tree "
          f"max rel {tree_rel:.3e}, "
          f"params after Adam max abs {param_err:.3e}; CPU step "
          f"{cpu['seconds']:.1f} s, card step {card['seconds']:.2f} s",
          flush=True)


def phase_reference_step(dev, base, spec, rs, resolved_k: int,
                         profile: bool):
    """tools/bench.py's PATHS (default, double, fused_double, fused =
    single DQN with every kernel on) over one filled replay, each at K=1
    and at the resolved K (one CUDA graph of K steps), every cell timed in
    two windows of REF_WINDOW steps, in turns (a b .. z z .. b a); the
    launch counts of each window checked."""
    import torch
    from r2d2_tpu_torch.tools import bench
    ks = sorted({1, resolved_k})
    cells = {}
    for label, overrides in bench.PATHS.items():
        if label == bench.HOST_PATH:
            continue                    # phase_host_learner drives it
        for k in ks:
            cell = bench.Cell(label, k, base.replace(**overrides), dev,
                              spec, rs)
            params = cell.ts.params
            check(params.compute_dtype == torch.bfloat16, "bf16 on CUDA")
            check(params.lstm.fused == (overrides.get("network.pallas_lstm")
                                        == "on"), f"{label}: LSTM path")
            cells[label, k] = cell
    torch.cuda.synchronize()
    for key in list(cells) + list(reversed(list(cells))):
        _reset_counts()
        cells[key].window(rs, REF_WINDOW)
        launches = _counts()
        want = _want_launches(bench.PATHS[key[0]], REF_WINDOW)
        check(launches == want, f"{key}: launches {launches}, want {want}")
    out = {}
    for (label, k), cell in cells.items():
        if profile:
            dispatches = max(1, 3 // k)
            cell.busy_ms = _profile(lambda: cell.dispatch(rs), dispatches,
                                    dispatches * k)
        r = cell.result(spec.batch_size)
        out[label, k] = r
        print(f"reference learner step {label} K={k}: " + json.dumps(r),
              flush=True)
    return out


def _want_host_launches(cfg, steps: int) -> dict:
    """Launches per kernel in ``steps`` external-batch steps: the host
    gathers the windows, so no gather; the rest as on the device path."""
    return {**_want_launches({
        "network.pallas_lstm": cfg.network.pallas_lstm,
        "network.use_double": cfg.network.use_double}, steps),
        "gather_windows": 0}


def _host_batches(cfg, blocks, count: int, seed: int):
    """``count`` batches that a host replay (native sum tree) of ``blocks``
    samples, numpy."""
    import torch
    from r2d2_tpu_torch.replay.host_replay import HostReplay
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    host = HostReplay(ReplaySpec.from_config(cfg, torch.device("cpu")),
                      seed=seed)
    for block in blocks:
        host.add(block)
    return [host.sample()[0] for _ in range(count)]


def _device_batch(batch, device):
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import SampleBatch
    return SampleBatch(**{f.name: torch.from_numpy(np.array(getattr(
        batch, f.name))).to(device) for f in dataclasses.fields(SampleBatch)})


def _external_step(cfg, device):
    """(train state from seed 0, make_external_batch_step) on ``device``:
    on CUDA a one-step CUDA graph, whose ``body`` is the eager step."""
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    ts = create_train_state(net, cfg.optim, 0, cfg.network.use_double)
    spec = ReplaySpec.from_config(cfg, torch.device(device))
    return ts, make_external_batch_step(net, spec, cfg.optim,
                                        cfg.network.use_double)


def _host_metrics(m) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in m.items()}


def phase_external_vs_cpu(dev, cfg, blocks, steps: int, label: str):
    """make_external_batch_step on the card (the eager warm-up, then the
    one-step graph) against the port's CPU step on the same host-sampled
    batches from the same weights, f32: loss, grad norm and priorities
    within rtol 1e-4 (priorities also atol 1e-6, as the tree is held in
    the device path's check); no gather launches, the decode and the LSTM
    kernels once a step."""
    import numpy as np
    import torch
    batches = _host_batches(cfg, blocks, steps, seed=2)
    runs = {}
    for device in (torch.device("cpu"), dev):
        ts, step = _external_step(cfg, device)
        _reset_counts()
        t0 = time.perf_counter()
        out = [_host_metrics(step(ts, _device_batch(b, device))[1])
               for b in batches]
        runs[device.type] = (out, _counts(), time.perf_counter() - t0)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        check(np.isfinite(got["loss"]) and got["priorities"].shape
              == (cfg.replay.batch_size,), f"{label}: {got}")
        for name in ("loss", "grad_norm", "mean_q"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4)
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-4, atol=1e-6)
    check(not any(runs["cpu"][1].values()), f"CPU launched {runs['cpu'][1]}")
    want_launches = _want_host_launches(cfg, steps)
    check(runs["cuda"][1] == want_launches,
          f"external {label}: launches {runs['cuda'][1]}, want "
          f"{want_launches}")
    rel = max(float(np.max(np.abs(a["priorities"] - b["priorities"])
                           / np.abs(b["priorities"])))
              for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    print(f"external-batch step ({label}), card vs CPU, {steps} step(s): "
          f"losses {[float(m['loss']) for m in runs['cuda'][0]]} vs "
          f"{[float(m['loss']) for m in runs['cpu'][0]]}, priorities max "
          f"rel {rel:.3e}, launches {runs['cuda'][1]}; CPU "
          f"{runs['cpu'][2]:.1f} s", flush=True)


def phase_external_graph_vs_eager(dev, base, blocks):
    """The external-batch step as one CUDA graph of one step against eager
    steps (the graph's own body) from the same weights on the same
    GRAPH_K host batches, at the reference shape in bf16 with the host
    path's settings: losses, grad norms and priorities within rtol 1e-4
    (priorities atol 1e-6). Then one more replay runs under the profiler:
    the kernels by their device names once each, no gather (a trace that
    lost events, the tracer's loss, is taken again, at most PROFILE_TRIES
    times)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    cfg = base.replace(**bench.PATHS[bench.HOST_PATH])
    batches = [_device_batch(b, dev)
               for b in _host_batches(cfg, blocks[:40], GRAPH_K, seed=4)]
    ts_graph, graphed = _external_step(cfg, dev)
    ts_eager, eager = _external_step(cfg, dev)
    counted = {}
    for i, batch in enumerate(batches):
        _reset_counts()
        _, m = graphed(ts_graph, batch)
        got = _host_metrics(m)
        counted = {k: counted.get(k, 0) + n for k, n in _counts().items()}
        want = _host_metrics(eager.body(ts_eager, batch))
        ts_eager.step += 1
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4)
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-4, atol=1e-6)
        rel = np.abs(got["priorities"] - want["priorities"]) / np.abs(
            want["priorities"])
        print(f"external graph vs eager, step {i}: loss {float(got['loss'])}"
              f" vs {float(want['loss'])}, priorities max rel "
              f"{float(rel.max()):.3e}", flush=True)
    check(graphed.graph is not None and ts_graph.step == GRAPH_K
          and int(ts_graph.step_count) == GRAPH_K, "external graph steps")
    check(counted == _want_host_launches(cfg, GRAPH_K),
          f"external graph: launches {counted}")
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // 20)     # the tracer first
            torch.cuda.synchronize()
            graphed(ts_graph, batches[-1])
            torch.cuda.synchronize()
        seen = _profiled_kernel_counts(prof)
        if not _lost_events(seen, _want_host_launches(cfg, 1)):
            break
    check(seen == _want_host_launches(cfg, 1),
          f"external graph: the profile shows {seen}")
    print(f"external graph vs eager ({GRAPH_K} steps, bf16 reference "
          f"shape): launches {counted}, one more replay's kernels by name "
          f"{seen}", flush=True)
    del batches, ts_graph, ts_eager, graphed, eager
    torch.cuda.empty_cache()


def _sample_alone_ms(host_replay, samples: int = 10) -> float:
    """Median ms of the host replay's sample into one preallocated batch
    with no other thread running: the gather's own pace."""
    import numpy as np
    from r2d2_tpu_torch.replay.host_replay import batch_layout
    from r2d2_tpu_torch.replay.structs import SampleBatch
    out = SampleBatch(**{name: np.zeros(shape, dtype) for name, (
        shape, dtype) in batch_layout(host_replay.spec).items()})
    times = []
    for _ in range(samples + 1):
        t0 = time.perf_counter()
        host_replay.sample(out=out)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_host_learner(dev, base, blocks) -> dict:
    """The host-placement Learner at the reference shape (tools/bench.py's
    host path: every kernel on, one step a dispatch) over a host ring of
    ``blocks``: 3 warm-up steps (the eager step, the capture, a replay),
    HOST_WINDOWS timed windows of REF_WINDOW steps with a block ingested
    after every step (so ``add`` races the prefetch thread's sample),
    each window's launch counts checked (no gather; the decode and the
    LSTM kernels once a step), then REF_WINDOW steps under the profiler,
    whose kernel names must say the same. Prints seq-updates/s, ms/step,
    the prefetch thread's sample and copy ms per batch, device busy and
    idle. Returns the timed windows' launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    cfg = base.replace(**bench.PATHS[bench.HOST_PATH])
    t0 = time.perf_counter()
    learner = bench.host_learner(cfg, dev, blocks)
    fill_s = time.perf_counter() - t0
    try:
        check(learner.replay_state is None
              and learner.host_replay._native is not None
              and learner.steps_per_dispatch == 1, "host placement")
        losses = [learner.step()["loss"] for _ in range(3)]
        torch.cuda.synchronize()
        for kept in learner.timings.values():
            kept.clear()
        ms, total, fresh = [], {}, 0
        for _ in range(HOST_WINDOWS):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REF_WINDOW):
                losses.append(learner.step()["loss"])
                learner.ingest(blocks[fresh % len(blocks)])
                fresh += 1
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / REF_WINDOW)
            counted = _counts()
            want = _want_host_launches(cfg, REF_WINDOW)
            check(counted == want, f"host path: launches {counted}, want "
                  f"{want}")
            total = {k: total.get(k, 0) + n for k, n in counted.items()}
        # a trace that lost events is taken again, on the next window
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(SPIN_CYCLES // 20)     # the tracer first
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(REF_WINDOW):
                    losses.append(learner.step()["loss"])
                torch.cuda.synchronize()
                profiled_ms = (time.perf_counter() - t0) * 1e3 / REF_WINDOW
            seen = _profiled_kernel_counts(prof)
            if not _lost_events(seen, _want_host_launches(cfg, REF_WINDOW)):
                break
        check(seen == _want_host_launches(cfg, REF_WINDOW),
              f"host path: the profile shows {seen}")
        values = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(values).all()), "host path: a loss is "
              "not finite")
        copies = sum(e.time_range.elapsed_us() for e in
                     bench.device_kernels(prof) if "HtoD" in e.name
                     ) / 1e3 / REF_WINDOW
        busy = bench.device_busy_ms(prof) / REF_WINDOW
        union = bench.device_union_ms(prof) / REF_WINDOW
        mean_ms = statistics.mean(ms)
        timings = learner.timings
        report = dict(
            path=bench.HOST_PATH, ms_per_step=ms,
            seq_updates_per_s=[cfg.replay.batch_size * 1e3 / x for x in ms],
            sample_ms=statistics.median(timings["sample_ms"]),
            h2d_ms=statistics.median(timings["h2d_ms"]),
            batches=len(timings["sample_ms"]),
            device_busy_ms_per_step=busy, device_union_ms_per_step=union,
            h2d_device_ms_per_step=copies, profiled_ms_per_step=profiled_ms,
            idle_share=1.0 - busy / mean_ms,
            idle_share_union=1.0 - union / mean_ms,
            launches_per_step={k: n / (HOST_WINDOWS * REF_WINDOW)
                               for k, n in total.items()},
            dropped_priority_updates=learner.dropped_priority_updates,
            host_ring_gb=learner.host_replay.obs.nbytes / 1e9,
            fill_s=fill_s)
    finally:
        learner.stop_background()
    check(not learner._bg_threads, "host path: a pipeline thread is left")
    report["sample_alone_ms"] = _sample_alone_ms(learner.host_replay)
    print(f"host-placement learner (reference shape): " + json.dumps(report),
          flush=True)
    pace = ("the host (its sample)" if report["sample_ms"]
            > report["device_union_ms_per_step"] else "the card")
    print(f"host path: sample {report['sample_ms']:.3f} ms a batch (alone,"
          f" no other thread running: {report['sample_alone_ms']:.3f}) "
          f"against {report['device_union_ms_per_step']:.3f} ms of device "
          f"time a step: {pace} sets the pace", flush=True)
    return total


def phase_cli(dev, extra, label, k):
    """tools.sync_train on the card for three dispatches of the resolved K
    (the eager warm-up, the capture, a replay), under the profiler: the
    launch counts (a graph replay's added from its capture) must be what
    the device ran, by its kernel names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import sync_train
    steps = 3 * k
    # a trace that lost events is taken again, on a run of its own
    for _ in range(PROFILE_TRIES):
        _reset_counts()
        torch.cuda.synchronize()
        # the device's events only: tracing the host's ops of a whole run
        # would cost more than the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = sync_train.main([
                "--env.game_name=Fake", "--replay.capacity=20000",
                "--replay.learning_starts=400",
                "--replay.max_env_steps_per_train_step=4",
                f"--max-steps={steps}", *extra])
            torch.cuda.synchronize()
        launches = _counts()
        seen = _profiled_kernel_counts(prof)
        if not _lost_events(seen, launches):
            break
    check(seen == {name: launches[name] for name in seen},
          f"sync_train {label}: the profile shows {seen}, counted "
          f"{launches}")
    check(summary["steps"] == steps
          and summary["device"].startswith("cuda"), summary["device"])
    check(len(summary["losses"]) == steps
          and all(math.isfinite(x) for x in summary["losses"]), summary)
    overrides = {"network.pallas_lstm": "on", "network.use_double": True} \
        if extra == FUSED_ARGS else {}
    want = _want_launches(overrides, steps)
    check(launches == want, f"sync_train {label}: launches {launches}")
    print(f"sync_train on the card ({label}): {steps} steps in dispatches "
          f"of {k}, launches {launches}, equal to the profile's kernel "
          "names", flush=True)
    return launches


def _time_calls(obj, name: str, seconds: dict) -> None:
    """Wrap ``obj.name`` to add each call's host seconds to
    ``seconds[name]`` (what the orchestrated loop spends where)."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def _raw_device_events(prof) -> list:
    """(name, start ns, end ns) of a profile's device events (no user
    annotations), in order of start, read from the tracer's own records:
    without the operator tree that ``prof.events()`` builds, which takes
    seconds for a window of the default path's kernels."""
    from torch.autograd import DeviceType
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation()),
                  key=lambda e: e[1])


# the kernel of torch.cuda._sleep, which marks a profiled window's end
END_MARK = "spin_kernel"


def _raw_kernel_counts(events) -> dict:
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for name, _, _ in events:
        for key, pattern in KERNEL_NAMES.items():
            if pattern.search(name):
                counts[key] += 1
    return counts


def _busy_ms(events) -> float:
    return sum(stop - start for _, start, stop in events) / 1e6


def _union_ms(events) -> float:
    """Device time with overlapping events counted once, ms."""
    total, end = 0, None
    for _, start, stop in events:       # in order of start
        if end is None or start >= end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e6


def _diag_period(k: int) -> int:
    """Dispatches of K steps in one period of the default diagnostics'
    intervals: by its end a run has captured the graph of every pattern
    of interval steps (50 at K=4)."""
    from r2d2_tpu_torch.config import Config
    t = Config().telemetry
    return math.lcm(k, t.learning_interval, t.replay_diag_interval) // k


def _interval_stats(state) -> dict:
    """Host ms between consecutive dispatches from the one after the timed
    window's start (the third dispatch unless ``start_at`` says) to its
    end: median, p90, max, and the
    seconds the intervals longer than 1.5x the median hold beyond it
    (stalls); and where the stalls' and the three largest intervals' host
    time went, by part of the loop (``wait``: none of the timed parts,
    chiefly the wait for the card)."""
    marks, parts = state["marks"], state["parts"]
    intervals = []
    for i in range(state.get("start_at", 2) + 1, state["end"][3] + 1):
        ms = (marks[i - 1] - marks[i - 2]) * 1e3
        spent = {name: (s - parts[i - 2].get(name, 0.0)) * 1e3
                 for name, s in parts[i - 1].items()}
        spent = {name: x for name, x in spent.items() if x > 0}
        spent["wait"] = ms - sum(spent.values())
        intervals.append((ms, i, spent))
    ms = sorted(x for x, _, _ in intervals)
    median = statistics.median(ms)
    stall_parts: dict = {}
    for x, _, spent in intervals:
        if x > 1.5 * median:
            for name, v in spent.items():
                stall_parts[name] = stall_parts.get(name, 0.0) + v
    largest = sorted(intervals, key=lambda t: t[0], reverse=True)[:3]
    return dict(dispatch_ms_median=median,
                dispatch_ms_p90=ms[int(0.9 * (len(ms) - 1))],
                dispatch_ms_max=ms[-1],
                stall_s=sum(x - median for x in ms if x > 1.5 * median) / 1e3,
                stalls=sum(1 for x in ms if x > 1.5 * median),
                stall_ms_by_part={k: round(v, 3)
                                  for k, v in sorted(stall_parts.items())},
                largest_intervals=[
                    dict(dispatch=i, ms=round(x, 3),
                         by_part={k: round(v, 3)
                                  for k, v in sorted(spent.items())})
                    for x, i, spent in largest])


def _orchestrated_report(summary, state, k, batch) -> dict:
    """The numbers of one orchestrated run, from its summary and what its
    dispatch hook recorded (host clock; the window from a sync after
    dispatch ``start_at``, the end of the diagnostics' first period, to a
    sync END_MARGIN_S before the run's bound)."""
    (t0, s0), (t1, s1, env1, _) = state["start"], state["end"]
    steps, seconds = s1 - s0, t1 - t0
    window = state["window"]
    window_ms, busy, union = window["ms"], window["busy"], window["union"]
    saves = state["saves"]
    inside = [x for x in saves
              if t0 <= x["t"] and x["t"] + x["ms"] / 1e3 <= t1]
    save_s = sum(x["ms"] for x in inside) / 1e3
    return dict(
        steps=summary["steps"], steps_per_dispatch=k,
        seq_updates_per_s=batch * steps / seconds,
        seq_updates_per_s_saves_out=batch * steps / (seconds - save_s),
        window_steps=steps, window_s=seconds,
        env_steps=summary["env_steps"],
        env_steps_per_s=summary["env_steps"] / summary["seconds"],
        # ingested while the learner trained (dispatch 2 to the window end)
        env_steps_per_s_training=(env1 - state["env_start"]) / (t1 - t0),
        run_s=summary["seconds"],
        warmup_s=state["warmup_s"],
        blocks_ingested=summary["blocks_ingested"],
        publishes=summary["publishes"],
        publish_host_ms=summary["publish_ms"],
        publish_write_ms=summary["publish_write_ms"],
        saves=[dict(index=x["index"], step=x["step"], ms=round(x["ms"], 3),
                    in_window=x in inside) for x in saves],
        saves_in_window=len(inside), save_s_in_window=save_s,
        step0_save_ms=summary["save_ms"][0],
        checkpoints=summary["checkpoints"],
        profiled_ms_per_dispatch=window_ms,
        device_busy_ms_per_dispatch=busy,
        device_union_ms_per_dispatch=union,
        idle_share=1.0 - busy / window_ms,
        idle_share_union=1.0 - union / window_ms,
        final_loss=summary["final_loss"],
        host_s={name: round(v, 3) for name, v in state["host_s"].items()},
        **_interval_stats(state))


def _record_saves(learner, state) -> None:
    """Wrap ``learner.save`` so each call records its index, the step,
    its start on the host clock and its ms in state["saves"]."""
    save = learner.save

    def recorded(index):
        t0 = time.perf_counter()
        try:
            return save(index)
        finally:
            state["saves"].append(dict(
                index=index, step=learner.training_steps, t=t0,
                ms=(time.perf_counter() - t0) * 1e3))

    learner.save = recorded


def _start_window(state, n):
    """Prepare the tracer over the next dispatch (its warm-up, kept out of
    the trace); record the PROFILE_DISPATCHES after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1,
                                     active=PROFILE_DISPATCHES, repeat=1))
    prof.__enter__()
    state["prof"] = prof
    state["window_start"] = n + 1


def _record_window(state, n, step=None):
    import torch
    torch.cuda.synchronize()
    state["prof"].step()
    _reset_counts()
    state["window_step0"] = step
    state["window_end"] = n + PROFILE_DISPATCHES
    state["window_t0"] = time.perf_counter()


def _close_window(state, n, step=None):
    """The window's last dispatch has run: take its time and counts, and
    mark its end on the card with a spin kernel. One more dispatch runs
    traced before the tracer stops, so that the tracer's records of the
    window's own last kernels are in. ``step``: the learner's step count
    (with the one at the record, the window's dQ steps)."""
    import torch
    torch.cuda.synchronize()
    state["window_synced"] = time.perf_counter()
    state["window_launches"] = _counts()
    state["window_dq"] = (0 if step is None else
                          _dq_steps(state["window_step0"], step))
    torch.cuda._sleep(1000)
    state["cooldown_end"] = n + 1


def _end_window(state, n):
    """Stop the tracer and read the device events before the end mark; a
    trace that holds none, or whose kernel names disagree with the
    wrappers' counts (the tracer has lost events), is taken again, up to
    PROFILE_TRIES windows; the last one taken is kept."""
    import torch
    torch.cuda.synchronize()
    prof = state.pop("prof")
    prof.__exit__(None, None, None)
    events = _raw_device_events(prof)
    del prof
    ends = [start for name, start, _ in events if END_MARK in name]
    if ends:
        events = [e for e in events if e[1] < ends[-1]]
    seen = _raw_kernel_counts(events)
    launches = state["window_launches"]
    state.setdefault("tries", []).append(seen)
    if (ends and events and seen == launches) \
            or len(state["tries"]) >= PROFILE_TRIES:
        state["window"] = dict(
            ms=(state["window_synced"] - state["window_t0"]) * 1e3
            / PROFILE_DISPATCHES,
            busy=_busy_ms(events) / PROFILE_DISPATCHES,
            union=_union_ms(events) / PROFILE_DISPATCHES,
            seen=seen, launches=launches, end_marked=bool(ends),
            dq_steps=state["window_dq"])
    else:
        _start_window(state, n)


def _advance_window(state, n, free: bool, step=None) -> None:
    """Drive the profiled window from a dispatch hook, after the timed
    window: start it where ``free`` (no checkpoint falls inside), then
    record, close and end it at the dispatches set for each. ``step``:
    the learner's step count after dispatch ``n``."""
    if "prof" in state:
        if n == state["window_start"]:
            _record_window(state, n, step)
        elif n == state.get("window_end"):
            _close_window(state, n, step)
        elif n == state.get("cooldown_end"):
            _end_window(state, n)
    elif "window" not in state and free:
        _start_window(state, n)


LEARNING_KEYS = {"td_abs", "td_abs_counts", "priority", "priority_counts",
                 "q_abs", "q_abs_counts", "grad_norm", "target_param_dist",
                 "delta_q", "sample_age", "replay_age", "nonfinite_steps"}


def _check_diag_records(records, label: str, lanes: int) -> dict:
    """The records of a run with the default diagnostics: ``learning``
    blocks with JAX's keys, finite gradient norms of every group and no
    non-finite step; ``replay_diag`` blocks with a tree snapshot whose
    ESS is > 0, a never-sampled share in [0, 1] wherever evictions are
    reported, and lane counts over the run's ``lanes`` lanes with no
    unknown stamp. Returns the newest of each sub-block, for the log."""
    learning = [r["learning"] for r in records if "learning" in r]
    replay = [r["replay_diag"] for r in records if "replay_diag" in r]
    check(learning and replay, f"{label}: records without the learning or "
          f"replay_diag block ({len(records)} records)")
    for block in learning:
        check(LEARNING_KEYS <= set(block), f"{label}: learning keys "
              f"{sorted(block)}")
        check(set(block["grad_norm"]) == {"global", "head", "lstm",
                                          "torso"}
              and all(math.isfinite(v["max"])
                      for v in block["grad_norm"].values()),
              f"{label}: grad norms {block['grad_norm']}")
        check(block["nonfinite_steps"] == 0, f"{label}: a non-finite step")
    trees = [b["tree"] for b in replay if "tree" in b]
    check(trees and all(t["ess"] > 0 for t in trees),
          f"{label}: tree snapshots {trees[-1:] or None}")
    for b in replay:
        ev = b.get("evictions")
        if ev and ev["evicted"]:
            check(0.0 <= ev["never_sampled_frac"] <= 1.0,
                  f"{label}: evictions {ev}")
    lane_blocks = [b["lanes"] for b in replay if "lanes" in b]
    check(lane_blocks and all(
        lb["total_lanes"] == lanes and lb["unknown_frac"] == 0.0
        and 1 <= lb["active_lanes"] <= lanes for lb in lane_blocks),
        f"{label}: lanes {lane_blocks[-1:] or None}")
    evictions = [b["evictions"] for b in replay if "evictions" in b]
    return {"learning": {k: learning[-1][k] for k in (
                "grad_norm", "target_param_dist", "delta_q", "sample_age",
                "nonfinite_steps")},
            "tree": trees[-1], "lanes": {k: v for k, v in lane_blocks[-1]
                                         .items() if k != "counts"},
            "evictions": evictions[-1] if evictions else None}


# the stages each mode must observe (telemetry/core.py STAGES); a stage's
# summary has exactly these fields
ORCH_STAGES = ("actor/env_step", "actor/forward", "actor/block_emit",
               "actor/queue_put", "ingest/ring_get", "ingest/commit",
               "learner/train_dispatch", "learner/device_sync",
               "weights/publish")
ANAKIN_STAGES = ("actor/act_scan", "ingest/commit", "learner/train_dispatch",
                 "learner/device_sync")
SERVE_STAGES = ("serve/enqueue", "serve/batch_wait", "serve/forward",
                "serve/reply")
HOST_ROW_STAGES = ("lockstep/dispatch", "lockstep/step", "ingest/commit",
                   "learner/train_dispatch", "weights/publish")
STAGE_FIELDS = {"count", "p50_ms", "p95_ms", "p99_ms"}
COST_COMPONENTS = {"torso", "lstm", "head", "sum_tree", "replay"}


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _check_stage_records(records, label: str, want, spans=(),
                         costs: bool = True) -> dict:
    """Records with the stage timers on: every one carries ``stages`` in
    JAX's summary fields, each stage of ``want`` was observed (counts
    summed over the records), the first carries the ``costs`` block
    (``costs``), and each span file of ``spans`` parses, a span a line.
    Returns the summed counts and the spans read a file."""
    check(records and all("stages" in r and "telemetry_dropped_spans" in r
                          for r in records),
          f"{label}: a record without the stages block")
    counts = {}
    for r in records:
        for name, summary in r["stages"].items():
            check(set(summary) == STAGE_FIELDS and summary["count"] > 0
                  and summary["p50_ms"] <= summary["p95_ms"]
                  <= summary["p99_ms"], f"{label}: stage {name} {summary}")
            counts[name] = counts.get(name, 0) + summary["count"]
    check(all(counts.get(name, 0) > 0 for name in want),
          f"{label}: stage counts {counts}, want every one of {want}")
    if costs:
        block = records[0].get("costs")
        check(block is not None and block["model_flops_per_step"] > 0
              and set(block["components"]) == COST_COMPONENTS
              and not any("costs" in r for r in records[1:]),
              f"{label}: the first record's costs block {block}")
    read = {}
    for path in spans:
        events = _read_jsonl(path)
        check(events and all({"name", "ts", "dur", "tid", "pid"} <= set(e)
                             and e["dur"] >= 0 for e in events),
              f"{label}: spans of {os.path.basename(path)}: "
              f"{len(events)} events")
        read[os.path.basename(path)] = len(events)
    return {"stage_counts": counts, "spans": read}


def _state_bytes(train_state=None, replay_state=None, carry=None) -> dict:
    """The bytes a run's buffers hold, summed here from their tensors
    (each counted once): what the records' ``buffers`` must name."""
    import dataclasses
    import torch

    def total(tensors) -> int:
        return sum({(t.data_ptr(), t.nbytes): t.nbytes
                    for t in tensors}.values())
    out = {}
    if train_state is not None:
        ts = train_state
        tensors = [*ts.params.parameters(), *ts.params.buffers(),
                   *ts.target_params.parameters(), ts.step_count]
        for state in ts.opt.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
        out["p0/train_state"] = total(tensors)
    if replay_state is not None:
        out["p0/replay_ring"] = total(
            t for t in vars(replay_state).values() if torch.is_tensor(t))
    if carry is not None:
        tensors = []
        for f in dataclasses.fields(carry):
            v = getattr(carry, f.name)
            if dataclasses.is_dataclass(v):
                tensors += [getattr(v, g.name) for g in dataclasses.fields(v)
                            if torch.is_tensor(getattr(v, g.name))]
            elif torch.is_tensor(v):
                tensors.append(v)
        out["p0/anakin_carry"] = total(tensors)
    return out


def _check_health_records(records, label: str, buffers=None,
                          alerts_path=None, captures: bool = True,
                          names=(), noisy=()) -> dict:
    """Records with the resources plane on (the default): every one
    carries ``resources`` and ``alerts``; its device entry names this
    card with bytes in use and a headroom in (0, 1); no crit alert fires;
    the newest record's buffers hold ``buffers`` ({name: bytes}) exactly
    and ``names`` at all; the compile sub-block counted the graphs the
    run captured (``captures``: gloo ranks run eagerly) with no retrace
    after warm-up; the alert stream exists. ``noisy``: crit rules whose
    firings a run's record cadence makes noise of (printed, not held).
    Returns what the run's records say."""
    import torch
    kind = torch.cuda.get_device_name(0)
    check(records and all("resources" in r and "alerts" in r
                          for r in records),
          f"{label}: a record without the resources or alerts block")
    fired = []
    for r in records:
        devs = r["resources"]["devices"]
        check(len(devs) == 1 and devs[0].get("kind") == kind
              and devs[0].get("bytes_in_use", 0) > 0
              and 0 < devs[0].get("headroom_frac", 0) < 1,
              f"{label}: the device entry {devs}")
        fired += r["alerts"]["fired"]
    crit = [a for a in fired
            if a["severity"] == "crit" and a["rule"] not in noisy]
    check(not crit, f"{label}: crit alerts fired: {crit}")
    last = records[-1]["resources"]
    for name, nbytes in (buffers or {}).items():
        check(last["buffers"].get(name) == nbytes,
              f"{label}: buffer {name} {last['buffers'].get(name)}, its "
              f"tensors hold {nbytes}")
    for name in names:
        check(last["buffers"].get(name, 0) > 0,
              f"{label}: no buffer {name} in {last['buffers']}")
    comp = last["compile"]
    compiles = sum(r["resources"]["compile"]["compiles"] for r in records)
    check(comp["retraces_total"] == 0 and comp["warm"]
          and (compiles > 0 or not captures),
          f"{label}: compile block {comp}, {compiles} captures counted")
    if alerts_path is not None:
        check(os.path.exists(alerts_path), f"{label}: no {alerts_path}")
    return {"headroom_min": min(r["resources"]["hbm_headroom_frac_min"]
                                for r in records),
            "bytes_in_use_last": last["devices"][0]["bytes_in_use"],
            "buffers": last["buffers"], "captures": compiles,
            "capture_s": comp["compile_time_s_total"],
            "late_captures": comp["late_compiles"],
            "aot": comp.get("aot"),
            "alerts_fired": sorted({a["rule"] for a in fired})}


def phase_orchestrated(dev, mode, extra, label, k, evaluate=False):
    """cli.train on the card for ORCH_SECONDS with ``mode`` actors at the
    reference widths (see the module docstring, phase 6). Returns (the
    profiled window's launch counts, the report)."""
    import tempfile
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.config import Config
    batch = Config().replay.batch_size
    state = {"calls": 0, "marks": [], "parts": [], "host_s": {},
             "saves": [], "start_at": _diag_period(k) + 1}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as save_dir:
        step0 = os.path.join(save_dir, "Fake0_player0")

        def hook(stack):
            state["calls"] += 1
            n = state["calls"]
            steps = stack.learner.training_steps
            state["marks"].append(time.perf_counter())
            state["parts"].append(dict(state["host_s"]))
            if n == 1:
                state["step0_written"] = os.path.exists(step0)
                state["warmup_s"] = time.perf_counter() - state["launched"]
                state["stack"] = stack
                learner = stack.learner
                for obj, name in ((learner, "drain"), (learner, "_step_fn"),
                                  (learner, "publish"), (learner, "save"),
                                  (learner, "flush_metrics"),
                                  (stack, "supervise")):
                    _time_calls(obj, name, state["host_s"])
                _record_saves(learner, state)
            if n == state["start_at"]:
                torch.cuda.synchronize()
                state["start"] = (time.perf_counter(), steps)
                state["env_start"] = stack.learner.env_steps
            elif "start" not in state:
                pass
            elif "end" not in state:
                if time.perf_counter() >= state["close"]:
                    # the window ends once the card has run every dispatch
                    torch.cuda.synchronize()
                    state["end"] = (time.perf_counter(), steps,
                                    stack.learner.env_steps, n)
            else:
                # after the timed window, with no checkpoint inside
                span = ((PROFILE_DISPATCHES + 2)
                        * stack.learner.steps_per_dispatch)
                _advance_window(state, n, steps // ORCH_SAVE_INTERVAL
                                == (steps + span) // ORCH_SAVE_INTERVAL,
                                steps)

        # the card's headroom is read as the records report it: the
        # earlier phases' cached blocks go back first
        torch.cuda.empty_cache()
        try:
            state["launched"] = time.perf_counter()
            state["close"] = state["launched"] + ORCH_SECONDS - END_MARGIN_S
            summary = train.main([
                "--env.game_name=Fake", "--replay.capacity=100000",
                f"--runtime.save_dir={save_dir}",
                f"--runtime.save_interval={ORCH_SAVE_INTERVAL}",
                f"--runtime.keep_checkpoints={ORCH_KEEP}",
                "--runtime.log_interval=10",
                f"--actor-mode={mode}", f"--max-seconds={ORCH_SECONDS}",
                *extra], dispatch_hook=hook)
        finally:
            if state.get("prof") is not None:
                state.pop("prof").__exit__(None, None, None)
        check("window" in state and "end" in state, f"cli.train {label}: "
              f"only {state['calls']} dispatches, fewer than the profiled "
              "window or too few to reach the timed window's end (timed "
              f"window ended at dispatch {state.get('end', (0,) * 4)[3]}, "
              f"traces taken {len(state.get('tries', []))}, window from "
              f"dispatch {state.get('window_start')})")
        steps = summary["steps"]
        check(summary["device"].startswith("cuda"), summary["device"])
        check(len(summary["losses"]) == steps
              and all(math.isfinite(x) for x in summary["losses"]),
              f"cli.train {label}: a loss is not finite")
        check(state["step0_written"], "no step-0 checkpoint")
        report = _orchestrated_report(summary, state, k, batch)
        # a periodic save inside the timed window, and the pruning it
        # causes: the step-0 checkpoint is gone, ORCH_KEEP are kept
        check(any(x["index"] >= 1 and x["in_window"]
                  for x in report["saves"]),
              f"cli.train {label}: no periodic checkpoint inside the timed "
              f"window: {report['saves']}")
        final = (f"Fake{steps // ORCH_SAVE_INTERVAL + 1}_player0"
                 if steps % ORCH_SAVE_INTERVAL else
                 f"Fake{steps // ORCH_SAVE_INTERVAL}_player0")
        check(final in summary["checkpoints"]
              and len(summary["checkpoints"]) == ORCH_KEEP
              and "Fake0_player0" not in summary["checkpoints"],
              f"checkpoints {summary['checkpoints']}, want {final} and "
              f"{ORCH_KEEP} kept, the step-0 one pruned")
        log = open(os.path.join(save_dir, "train_player0.log")).read()
        for line in ORCH_LOG_LINES:
            check(re.search(line, log, re.M), f"no log line {line!r}")
        records = [json.loads(x) for x in open(os.path.join(
            save_dir, "metrics_player0.jsonl")) if x.strip()]
        actor = Config().actor
        report["diagnostics"] = _check_diag_records(
            records, f"cli.train {label}",
            actor.num_actors * actor.envs_per_actor)
        # process actors' stages reach the record through the board
        span_files = [os.path.join(save_dir, "spans_player0.jsonl")]
        if mode == "process":
            span_files += [os.path.join(save_dir, f"spans_p0_a{i}.jsonl")
                           for i in range(actor.num_actors)]
        report["telemetry"] = _check_stage_records(
            records, f"cli.train {label}", ORCH_STAGES, span_files)
        learner = state["stack"].learner
        report["health"] = _check_health_records(
            records, f"cli.train {label}",
            _state_bytes(learner.train_state, learner.replay_state),
            os.path.join(save_dir, "alerts_player0.jsonl"))
        check(summary["actors_alive"] == 0, "an actor is still running")
        if mode == "process":
            check(summary["actor_exitcodes"] == [0, 0],
                  f"actor exit codes {summary['actor_exitcodes']}")
        left = [n for n in summary["shm_segments"]
                if os.path.exists(os.path.join("/dev/shm", n))]
        check(not left, f"shm segments left: {left}")
        launches = state["window"]["launches"]
        seen = state["window"]["seen"]
        if len(state["tries"]) > 1:
            print(f"cli.train {label}: profiled windows taken "
                  f"{len(state['tries'])} times; kernel names seen: "
                  f"{state['tries']}", flush=True)
        overrides = {"network.pallas_lstm": "on",
                     "network.use_double": True} if extra == FUSED_ARGS \
            else {}
        want = _want_launches(overrides, PROFILE_DISPATCHES * k,
                              state["window"]["dq_steps"])
        check(seen == launches == want, f"cli.train {label}: the profile "
              f"shows {seen}, counted {launches}, want {want}")
        report["launches"] = launches
        print(f"orchestrated cli.train ({label}): " + json.dumps(report),
              flush=True)
        if evaluate:
            from r2d2_tpu_torch.cli import evaluate as evaluate_cli
            ckpt = os.path.join(save_dir, final)
            t0 = time.perf_counter()
            result = evaluate_cli.main(["--play", ckpt, "--rounds", "2"])
            row = result["evaluations"][0]
            check(math.isfinite(row["mean_return"]) and row["step"] == steps,
                  f"evaluate: {row}")
            print(f"cli.evaluate --play {final} (2 rounds, on the CPU): "
                  f"mean return {row['mean_return']}, step {row['step']}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, report


def phase_single_step_graph(dev) -> dict:
    """Phase 7, first: a Learner at one step a dispatch on the card runs
    each dispatch as a CUDA graph of one step (``make_dispatch_step``'s
    ``multi``); from the same seed and blocks it gives an eager single
    step's losses and tree over SINGLE_STEPS dispatches (warm-up,
    capture, replays) within phase 4's rtol 1e-4 (cuDNN's weight
    gradients sum in an order that may differ between runs): at the
    small f32 shape with and without the diagnostics (a graph a pattern
    of interval steps), and at the learnability configuration as phase 7
    trains it (bf16, telemetry off; the synthetic blocks' 18 actions)."""
    import tempfile
    import numpy as np
    import torch
    from r2d2_tpu_torch.learner.train_step import make_learner_step
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.telemetry.learning import LearningDiag
    from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
    from r2d2_tpu_torch.tools import bench
    from r2d2_tpu_torch.tools import learnability as learn
    tiny = _tiny_config().replace(**{
        "runtime.steps_per_dispatch": 1,
        "telemetry.learning_interval": 3,
        "telemetry.replay_diag_interval": 2})
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_single_") as d:
        cases = (("small_telemetry_off",
                  tiny.replace(**{"telemetry.enabled": False})),
                 ("small_telemetry_on",
                  tiny.replace(**{"telemetry.enabled": True})),
                 ("learnability", learn.learn_config(d, **{
                     "runtime.steps_per_dispatch": 1,
                     "telemetry.enabled": False})))
        for label, cfg in cases:
            net = NetworkApply(bench.ACTION_DIM, cfg.network,
                               cfg.env.frame_stack, cfg.env.frame_height,
                               cfg.env.frame_width, dev)
            graphed, eager = Learner(cfg, net), Learner(cfg, net)
            eager._step_fn = make_learner_step(
                net, eager.spec, cfg.optim, cfg.network.use_double,
                diag=LearningDiag.from_config(cfg),
                rdiag=ReplayDiag.from_config(cfg))
            for block in bench.synthetic_blocks(cfg, cfg.num_blocks, seed=5):
                graphed.ingest(block)
                eager.ingest(block)
            got, want = [], []
            for _ in range(SINGLE_STEPS):
                got.append(graphed.step()["loss"].item())
                want.append(eager.step()["loss"].item())
            np.testing.assert_allclose(got, want, rtol=1e-4)
            np.testing.assert_allclose(
                graphed.replay_state.tree.cpu().numpy(),
                eager.replay_state.tree.cpu().numpy(), rtol=1e-4, atol=1e-6)
            multi = graphed._step_fn.multi
            diag_on = cfg.telemetry.enabled
            check(multi.graph is not None and len(multi.variants) >= 1
                  and (not diag_on or len(multi.variants) > 1),
                  f"7 {label}: graph variants {len(multi.variants)}")
            graphed.flush_metrics()
            eager.flush_metrics()
            report[label] = {
                "bf16": net.compute_dtype == torch.bfloat16,
                "variants": len(multi.variants),
                "max_rel": float(np.max(np.abs(np.subtract(got, want))
                                        / np.abs(want)))}
    print(f"7 one step a dispatch as a CUDA graph against eager single "
          f"steps, {SINGLE_STEPS} dispatches (rtol 1e-4): "
          + json.dumps(report), flush=True)
    return report


def phase_learnability(dev):
    """tools/learnability.py's configuration, budget and thresholds (those
    of the CPU test) through sync_train with the learner on the card,
    K=1."""
    import tempfile
    import torch
    from r2d2_tpu_torch.tools import learnability as learn
    with tempfile.TemporaryDirectory(prefix="chip_smoke_learn_") as d:
        # the diagnostics only read the training state (14a), so the
        # learning they would watch is the same without them
        cfg = learn.learn_config(d, **{"runtime.steps_per_dispatch": 1,
                                       "telemetry.enabled": False})
        # the collecting policy acts on the host CPU with one intra-op
        # thread, as a process actor does: on an 8-core H100 host, 8
        # threads took 7.7 ms an act of this small forward against 1.3 ms
        # on one, most of the phase's time; the configuration, the steps
        # and the thresholds are the same
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            result = learn.train_and_eval(cfg, dev)
        finally:
            torch.set_num_threads(threads)
        seconds = time.perf_counter() - t0
    check(result["training_steps"] >= learn.TRAIN_STEPS, result)
    learn.check_returns(result["returns"])
    print(f"learnability on the card (K=1, {learn.TRAIN_STEPS} steps, "
          f"{seconds:.1f} s): greedy returns {result['returns']} (random "
          "20, oracle 120; thresholds: each >= 40, mean >= 60)", flush=True)


def _anakin_parts(cfg, dev, lanes: int, seed: int, quant_probe_on=True,
                  compute_dtype=None):
    """The acting segment of ``cfg`` on ``dev``: (env, spec, module,
    act), the module's weights from ``seed`` (drawn on the CPU, so the
    same on every device). At a quantized inference dtype the module is
    the InferenceTwin of those weights' bundle (stamp 1), its twin
    computing in ``compute_dtype`` (the device's by default)."""
    from r2d2_tpu_torch.actor.anakin import AnakinAct
    from r2d2_tpu_torch.config import apex_epsilon
    from r2d2_tpu_torch.envs.factory import create_device_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    env = create_device_env(cfg.env, dev)
    net = NetworkApply(env.action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, dev)
    spec = ReplaySpec.from_config(cfg, dev)
    eps = [apex_epsilon(i, lanes, cfg.actor.base_eps, cfg.actor.eps_alpha)
           for i in range(lanes)]
    act = AnakinAct(env, net, spec, num_lanes=lanes, epsilons=eps,
                    gamma=cfg.optim.gamma, priority=cfg.actor.anakin_priority,
                    near_greedy_eps=cfg.actor.near_greedy_eps,
                    priority_eta=cfg.optim.priority_eta,
                    quant_probe_on=quant_probe_on)
    module = net.init(seed)
    if cfg.network.inference_dtype != "f32":
        from r2d2_tpu_torch.actor.policy import InferenceTwin
        from r2d2_tpu_torch.models.network import (QuantInference,
                                                   make_inference_bundle)
        bundle = make_inference_bundle(net, module, 1)
        module = InferenceTwin(net, bundle, dev)
        if compute_dtype is not None:
            module.quant = QuantInference(net, bundle["quant"], dev,
                                          compute_dtype)
    return env, spec, module, act


def _to(draws, dev):
    import dataclasses
    return dataclasses.replace(draws, **{
        f.name: getattr(draws, f.name).to(dev)
        for f in dataclasses.fields(draws)
        if getattr(draws, f.name) is not None})


def phase_anakin_vs_cpu(dev):
    """Phase 8, part 1: two small f32 acting segments (the second ends the
    episodes) on the card against the same segments on the CPU, from the
    same weights and the same draws (drawn on the CPU), on the Fake env
    with the constant stamp and the gridworld with "td" priorities:
    actions and the integer and uint8 fields equal; hidden, rewards and
    the td priorities (which carry Q) within ANAKIN_ATOL. No kernel
    wrapper launches."""
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.actor.anakin import init_act_carry
    for game, priority in (("Fake", 1.0), ("Grid", "td")):
        cfg = _tiny_config().replace(**{
            "env.game_name": game, "env.grid_size": 4,
            "env.episode_len": 40, "actor.on_device": True,
            "actor.anakin_lanes": 4, "actor.anakin_priority": priority})
        gen = torch.Generator().manual_seed(11)
        env, spec, _, act = _anakin_parts(cfg, torch.device("cpu"), 4, 0)
        reset = env.reset_draws(4, gen)
        draws = [act.draw(gen) for _ in range(2)]
        runs = []
        _reset_counts()
        for device in (torch.device("cpu"), dev):
            env, spec, module, act = _anakin_parts(cfg, device, 4, 0)
            carry = init_act_carry(env, spec, 4,
                                   reset_draws=reset.to(device))
            out = []
            for d in draws:
                carry, blocks, stats = act(module, carry, 1,
                                           draws=_to(d, device))
                out.append((blocks, carry.hidden, stats))
            runs.append(out)
        check(not any(_counts().values()), f"a wrapper launched: {_counts()}")
        worst = 0.0
        for (cb, ch, cs), (gb, gh, gs) in zip(*runs):
            for f in dataclasses.fields(cb):
                a = getattr(cb, f.name)
                b = getattr(gb, f.name).cpu()
                if a.is_floating_point():
                    err = float(torch.nan_to_num(a - b).abs().max())
                    worst = max(worst, err)
                    check(err <= ANAKIN_ATOL and torch.equal(a.isnan(),
                                                             b.isnan()),
                          f"{game} {f.name}: max abs {err}")
                else:
                    check(torch.equal(a, b), f"{game} {f.name} differs")
            err = float((ch - gh.cpu()).abs().max())
            worst = max(worst, err)
            check(err <= ANAKIN_ATOL, f"{game} carry hidden: {err}")
            check(int(cs["episodes"]) == int(gs["episodes"]), "episodes")
        print(f"on-device acting, small f32 segments ({game}, priority "
              f"{priority}), card vs CPU: actions and integer fields equal,"
              f" float fields max abs {worst:.3e}", flush=True)


def phase_anakin_graph(dev, mode: str = "f32"):
    """Phase 8, part 2 (and 10c at ``mode`` "int8"): the acting segment at
    the reference widths (bf16, ANAKIN_LANES lanes, block_length 120) with
    its ring write into a replay of 99,960 steps: one graph replay against
    one eager segment from the same carry and generator state (blocks,
    carry and the replay's rows bit-equal), two replays drawing
    differently, then the segment's CUDA-event ms, graphed and eager. At
    int8 the segment acts with the twin (``int8_linear``, launches counted
    per replay), as the fused loop builds it. Returns the graphed ms and
    the launches of one replay."""
    import dataclasses
    import torch
    from r2d2_tpu_torch.actor.anakin import (ActSegment, assign_,
                                             init_act_carry)
    from r2d2_tpu_torch.replay.device_replay import replay_init
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**ANAKIN_CFG,
                                 **{"network.inference_dtype": mode})
    env, spec, module, act = _anakin_parts(cfg, dev, ANAKIN_LANES, 0,
                                           quant_probe_on=False)
    check((module.quant.dtype if mode != "f32" else module.compute_dtype)
          == torch.bfloat16, "bf16 on CUDA")
    rs = replay_init(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    carry = init_act_carry(env, spec, ANAKIN_LANES, generator=gen)
    seg = ActSegment(act, module, carry, spec, rs, gen)
    _reset_counts()
    seg.run(1)                          # the eager warm-up
    seg.run(2)                          # the capture and its first replay
    check(seg.graph is not None and seg.replays == 1, "no acting graph")

    saved, gen_state, ptr = _clone_carry(carry), gen.get_state(), \
        rs.block_ptr

    def snapshot():
        """What one segment made: its blocks, the replay rows it wrote,
        its draws, the carry after it."""
        torch.cuda.synchronize()
        rows = torch.tensor([(ptr + i) % spec.num_blocks
                             for i in range(ANAKIN_LANES)], device=dev)
        return ([(f"block {f.name}", getattr(seg.blocks, f.name).clone())
                 for f in dataclasses.fields(seg.blocks)]
                + [(f"replay {n}", getattr(rs, n)[rows].clone())
                   for n in ("obs", "last_action", "hidden", "action",
                             "reward", "gamma", "seq_start",
                             "weight_version", "lane")]
                + [("draws", seg.draws.explore.clone())]
                + [(f"carry {n}", v.clone()) for n, v in _flat_carry(carry)])

    seg.run(3)
    graphed = snapshot()
    assign_(carry, saved)
    gen.set_state(gen_state)
    rs.block_ptr = ptr
    seg.run(3, eager=True)
    for (name, a), (_, b) in zip(graphed, snapshot()):
        if a.is_floating_point():
            a, b = a.nan_to_num(7.0), b.nan_to_num(7.0)
        check(torch.equal(a, b), f"graph vs eager: {name} differs")
    seg.run(4)
    first = seg.draws.explore.clone()
    seg.run(5)
    check(not torch.equal(first, seg.draws.explore),
          "two graph replays drew the same numbers")
    counted = _counts()
    if mode == "f32":
        check(not any(counted.values()), f"a wrapper launched: {counted}")
    else:
        # 6 calls (the eager warm-up, capture + replay, 3, its eager twin,
        # 4, 5): each counts what one segment launches
        per = seg.launches["int8_linear"]
        check(per > 0 and counted == {**dict.fromkeys(counted, 0),
                                      "int8_linear": 6 * per},
              f"int8 segment launches {counted}, {per} a replay")
        probe = seg.probe()
        check(0.0 <= probe["quant_dq"] < 1.0
              and 0.0 <= probe["quant_agree"] <= 1.0, f"probe {probe}")
    graphed = cuda_ms(lambda: seg.run(1), runs=20, warmup=2)
    eager = cuda_ms(lambda: seg.run(1, eager=True), runs=3, warmup=1)
    steps = ANAKIN_LANES * spec.block_length
    print(f"acting segment at the reference widths ({ANAKIN_LANES} lanes x "
          f"{spec.block_length} steps, bf16, ring write included, "
          f"inference dtype {mode}): graph = eager bit for bit (blocks, "
          f"carry, replay rows, draws); replays draw anew; graphed "
          f"{graphed:.3f} ms ({steps / graphed * 1e3:.1f} env steps/s), "
          f"eager {eager:.3f} ms; launches a replay {seg.launches}"
          + (f"; probe {probe}" if mode != "f32" else ""), flush=True)
    launches = dict(seg.launches)
    del seg, rs
    torch.cuda.empty_cache()
    return graphed, launches


def _flat_carry(carry):
    import dataclasses
    out = []
    for f in dataclasses.fields(carry):
        value = getattr(carry, f.name)
        if dataclasses.is_dataclass(value):
            out += [(f"{f.name}.{n}", v) for n, v in _flat_carry(value)]
        else:
            out.append((f.name, value))
    return out


def _clone_carry(carry):
    import dataclasses
    return dataclasses.replace(carry, **{
        f.name: (_clone_carry(getattr(carry, f.name))
                 if dataclasses.is_dataclass(getattr(carry, f.name))
                 else getattr(carry, f.name).clone())
        for f in dataclasses.fields(carry)})


def phase_anakin_train(dev, k, bench_fused: float, segment_ms: float,
                       extra=(), seconds: float = ANAKIN_SECONDS,
                       label: str = "f32"):
    """Phase 8, part 3 (10c with int8 ``extra``): cli.train
    --actor.on_device=true on the card for ``seconds`` at the reference
    widths (see the module docstring). Returns the profiled window's
    launch counts and the run's records."""
    import tempfile
    import threading
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.config import Config
    batch = Config().replay.batch_size
    state = {"calls": 0, "marks": [], "parts": [], "host_s": {}}
    threads = threading.active_count()

    def hook(stack):
        state["calls"] += 1
        n = state["calls"]
        steps = stack.learner.training_steps
        state["marks"].append(time.perf_counter())
        state["parts"].append(dict(state["host_s"]))
        if n == 1:
            state["warmup_s"] = time.perf_counter() - state["launched"]
            state["stack"] = stack
            for obj, name in ((stack.segment, "run"),
                              (stack.learner, "_step_fn"),
                              (stack.learner, "flush_metrics")):
                _time_calls(obj, name, state["host_s"])
        if n == 2:
            torch.cuda.synchronize()
            state["start"] = (time.perf_counter(), steps)
            state["env_start"] = stack.learner.env_steps
        elif "end" not in state:
            if n > 2 and time.perf_counter() >= state["close"]:
                torch.cuda.synchronize()
                state["end"] = (time.perf_counter(), steps,
                                stack.learner.env_steps, n)
        else:
            _advance_window(state, n, True, steps)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_anakin_") as d:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # what the run itself held at most, above what earlier phases left
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            state["launched"] = time.perf_counter()
            state["close"] = state["launched"] + seconds - END_MARGIN_S
            summary = train.main([
                *ANAKIN_ARGS, f"--runtime.save_dir={d}",
                "--runtime.save_interval=0", "--runtime.log_interval=5",
                f"--max-seconds={seconds}", *extra], dispatch_hook=hook)
        finally:
            if state.get("prof") is not None:
                state.pop("prof").__exit__(None, None, None)
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        log = open(os.path.join(d, "train_player0.log")).read()
        records = [json.loads(x) for x in open(os.path.join(
            d, "metrics_player0.jsonl")) if x.strip()]
        telemetry = _check_stage_records(
            records, f"cli.train on-device {label}", ANAKIN_STAGES,
            [os.path.join(d, "spans_player0.jsonl")])
        fused = state["stack"]
        health = _check_health_records(
            records, f"cli.train on-device {label}",
            _state_bytes(fused.learner.train_state,
                         fused.learner.replay_state, fused.segment.carry),
            os.path.join(d, "alerts_player0.jsonl"))
    check("window" in state and "end" in state, f"cli.train on-device: "
          f"only {state['calls']} dispatches")
    stack = state["stack"]
    seg = stack.segment
    steps = summary["steps"]
    check(summary["device"].startswith("cuda"), summary["device"])
    check(len(summary["losses"]) == steps
          and all(math.isfinite(x) for x in summary["losses"]),
          "cli.train on-device: a loss is not finite")
    check(summary["actor_exitcodes"] == [] and summary["actors_alive"] == 0
          and not stack.processes and not stack.threads
          and threading.active_count() == threads,
          "cli.train on-device started an actor, a process or a thread")
    check(seg.graph is not None and seg.replays == seg.calls - 1
          and summary["blocks_ingested"] == seg.calls * ANAKIN_LANES,
          f"the blocks were not written by the acting graph: {seg.calls} "
          f"segments, {seg.replays} replays, {summary['blocks_ingested']} "
          "blocks")
    for line in ORCH_LOG_LINES:
        check(re.search(line, log, re.M), f"no log line {line!r}")
    launches, seen = state["window"]["launches"], state["window"]["seen"]
    (t0, s0), (t1, s1, env1, _) = state["start"], state["end"]
    window = state["window"]
    rate = batch * (s1 - s0) / (t1 - t0)
    report = dict(
        steps=steps, steps_per_dispatch=k, lanes=ANAKIN_LANES,
        seq_updates_per_s=rate, bench_fused=bench_fused,
        of_bench=rate / bench_fused, window_steps=s1 - s0,
        window_s=t1 - t0, env_steps=summary["env_steps"],
        env_steps_per_s_training=(env1 - state["env_start"]) / (t1 - t0),
        segments=seg.calls, graph_replays=seg.replays,
        segment_ms_alone=segment_ms, warmup_s=state["warmup_s"],
        run_s=summary["seconds"],
        profiled_ms_per_dispatch=window["ms"],
        device_busy_ms_per_dispatch=window["busy"],
        device_union_ms_per_dispatch=window["union"],
        idle_share=1.0 - window["busy"] / window["ms"],
        idle_share_union=1.0 - window["union"] / window["ms"],
        peak_gb=peak_gb, final_loss=summary["final_loss"],
        host_s={name: round(v, 3) for name, v in state["host_s"].items()},
        launches=launches, **_interval_stats(state))
    report["diagnostics"] = _check_diag_records(
        records, f"cli.train on-device {label}", ANAKIN_LANES)
    report["telemetry"] = telemetry
    report["health"] = health
    if stack.twin_ms:
        report["twin_adoptions"] = len(stack.twin_ms)
        report["twin_ms_median"] = statistics.median(stack.twin_ms)
        report["twin_ms_max"] = max(stack.twin_ms)
    print(f"on-device cli.train (fused loop, Fake, 64 lanes, K={k}, "
          f"pallas_lstm on, inference dtype {label}): " + json.dumps(report),
          flush=True)
    want = _want_launches({"network.pallas_lstm": "on"},
                          PROFILE_DISPATCHES * k, window["dq_steps"])
    if label != "f32":
        check(launches["int8_linear"] > 0, "the int8 segment launched no "
              "int8_linear in the profiled window")
        want["int8_linear"] = launches["int8_linear"]
    check(seen == launches == want, f"cli.train on-device: the profile "
          f"shows {seen}, counted {launches}, want {want}")
    return launches, records


def phase_anakin_learnability(dev):
    """Phase 8, part 4: tools/learnability.py's gridworld configuration
    (tests/test_anakin.py's) through the fused loop on the card, one step
    a dispatch as in the JAX test on the CPU, telemetry off; the JAX
    test's threshold (check_grid_returns: the episodes before training
    against those of the last quarter of it)."""
    import tempfile
    from r2d2_tpu_torch.tools import learnability as learn
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as d:
        # telemetry off, as in phase 7: the diagnostics only read the
        # training state (14a) and the stage timers only the host clock,
        # so the learning is the same without them, while a record every
        # loop turn would aggregate both each step
        cfg = learn.grid_config(d, **{"runtime.steps_per_dispatch": 1,
                                      "telemetry.enabled": False})
        t0 = time.perf_counter()
        result = learn.grid_train(cfg, dev)
        seconds = time.perf_counter() - t0
    check(result["training_steps"] >= learn.GRID_TRAIN_STEPS, result)
    verdict = learn.check_grid_returns(result["intervals"],
                                       cfg.replay.learning_starts)
    print(f"gridworld learnability under the fused loop on the card "
          f"({learn.GRID_TRAIN_STEPS} steps, {seconds:.1f} s): early "
          f"{verdict['early']:.4f}, late {verdict['late']:.4f} (threshold: "
          "late >= max(3x early, early + 0.3), over "
          f"{len(result['intervals'])} records)", flush=True)


# ---------------------------------------------------------------------------
# phase 9: serving on the card (serve/, ops/quant_kernels.py)

# the quantized forward's dense layers at the reference widths (Fake: 6
# actions): name, K (in), N (out)
QUANT_SHAPES = (("torso.dense", 3136, 1024), ("lstm.input_proj", 1030, 2048),
                ("lstm.recurrent_kernel", 512, 2048),
                ("head.hidden", 512, 512), ("head.adv_out", 512, 6),
                ("head.val_out", 512, 1))
# M: each of the kernel's n8-tile instantiations (M 1-8, 9-16, 17-32,
# 33-64) and the serving buckets that reach them
QUANT_ROWS = (1, 3, 8, 16, 32, 64)
QUANT_MAIN = ("torso.dense", 32)   # the kernels line's case: bf16, M=32
# int8_linear vs its plain version: f32 sums in another order, so rtol
# 1e-5 scaled by sqrt(K) against the output's magnitude; a bf16 output
# may round the other way, one bf16 ulp (<= 2^-7 relative)
QUANT_F32_RTOL = 1e-5
QUANT_BF16_ULP = 2.0 ** -7
QUANT_SWEEP_REPEATS = 3            # windows a figure of 9a's sweep
SERVE_LANES = (1, 8, 32)
SERVE_LOAD_S = 4.0                 # each load window of cli.serve
SERVE_STEPS = 200                  # served-vs-eager steps of 32 lanes
SERVED_TRAIN_SECONDS = 12.0
SERVED_TRAIN_ARGS = ["--actor-mode=thread", "--actor.inference=server",
                     "--network.inference_dtype=int8",
                     "--env.game_name=Fake", "--replay.capacity=100000",
                     "--runtime.log_interval=5"]


def _quant_layer(k, n, g, dev):
    from r2d2_tpu_torch.models.network import quantize_leaf_int8
    from r2d2_tpu_torch.ops.quant_kernels import pad_int8_weight
    import torch
    w = torch.randn(n, k, generator=g) / math.sqrt(k)
    leaf = quantize_leaf_int8(w, axis=0)
    return (pad_int8_weight(leaf["q"]).to(dev),
            leaf["scale"].reshape(-1).to(dev),
            (torch.randn(n, generator=g) * 0.1).to(dev),
            (leaf["q"].float() * leaf["scale"]).to(dev, torch.bfloat16))


def phase_quant_kernel(dev) -> dict:
    """9a: int8_linear against its plain version at every dense shape of
    the quantized forward, M in QUANT_ROWS, bf16 and f32 activations; then
    times, bound and yardstick per shape at M=32, bf16."""
    import torch
    from r2d2_tpu_torch.ops import quant_kernels as qk
    g = torch.Generator().manual_seed(0)
    layers = {name: _quant_layer(k, n, g, dev) for name, k, n in QUANT_SHAPES}
    err = {"bfloat16": 0.0, "float32": 0.0}
    for name, k, n in QUANT_SHAPES:
        q, scale, bias, _ = layers[name]
        for m in QUANT_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, generator=g).to(dev, dt)
                got = qk.int8_linear(x, q, scale, bias, dt).float()
                want = qk.int8_linear_plain(x, q, scale, bias, dt).float()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                key = "bfloat16" if dt == torch.bfloat16 else "float32"
                err[key] = max(err[key], diff.max().item())
                if dt == torch.float32:
                    tol = QUANT_F32_RTOL * math.sqrt(k) * \
                        want.abs().max().item()
                    check(diff.max().item() <= tol,
                          f"int8_linear {name} M={m} f32: {diff.max()}")
                else:
                    check(bool((diff <= QUANT_BF16_ULP * want.abs()
                                + 1e-6).all()),
                          f"int8_linear {name} M={m} bf16: {diff.max()}")
    print(f"int8_linear matches its plain version at {len(QUANT_SHAPES)} "
          f"shapes x M {QUANT_ROWS} x (bf16, f32): max abs err bf16 "
          f"{err['bfloat16']:.3e}, f32 {err['float32']:.3e}", flush=True)
    rows = {}
    for name, k, n in QUANT_SHAPES:
        q, scale, bias, w16 = layers[name]
        m = QUANT_MAIN[1]
        xs = [torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
              for _ in range(BACK_TO_BACK)]
        nbytes = qk.int8_linear_bytes(m, n, k, 2, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * n * k / PEAK_FLOPS["bfloat16"] * 1e3
        rows[name] = dict(
            ms=cuda_ms(lambda: qk.int8_linear(xs[0], q, scale, bias)),
            b2b_ms=b2b_ms(lambda i: qk.int8_linear(xs[i], q, scale, bias)),
            plain_ms=cuda_ms(lambda: qk.int8_linear_plain(xs[0], q, scale,
                                                          bias), runs=10),
            library_ms=cuda_ms(lambda: torch.matmul(xs[0], w16.t())),
            library_b2b=b2b_ms(lambda i: torch.matmul(xs[i], w16.t())),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        r = rows[name]
        print(f"int8_linear {name} ({k}->{n}, M={m}, bf16): kernel "
              f"{r['ms']:.4f} ms (back to back {r['b2b_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, torch.matmul on the bf16 twin "
              f"{r['library_ms']:.4f} (back to back "
              f"{r['library_b2b']:.4f}), bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']})", flush=True)
    phase_quant_sweep(layers, g)
    main = dict(rows[QUANT_MAIN[0]])
    main["max_abs_err"] = err["bfloat16"]
    main["library_b2b_ms"] = main.pop("library_b2b")
    return main


def _int8pack_call(x, q_raw, scale):
    """torch._weight_int8pack_mm on the card (x . (q * scale)^T, scales in
    x's type), or None where this torch has no CUDA kernel for it."""
    import torch
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    s16 = scale.to(x.dtype)
    try:
        fn(x, q_raw, s16)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return lambda i, xs: fn(xs[i], q_raw, s16)


def phase_quant_sweep(layers, g) -> None:
    """9a's like-for-like times: int8_linear back to back at every
    QUANT_SHAPES row x QUANT_ROWS M with bf16 x (and f32 x for the
    recurrent product at M=64, the acting segment's case), each beside
    torch.matmul on the twin back to back and, where this torch has a CUDA
    kernel for it, torch._weight_int8pack_mm (neither call is the port's).
    QUANT_SWEEP_REPEATS windows a figure."""
    import torch
    from r2d2_tpu_torch.ops import quant_kernels as qk
    t0 = time.perf_counter()
    cases = [(name, k, n, m, torch.bfloat16) for name, k, n in QUANT_SHAPES
             for m in QUANT_ROWS]
    cases.append(("lstm.recurrent_kernel", 512, 2048, 64, torch.float32))
    pack_seen = False
    for name, k, n, m, dt in cases:
        q, scale, bias, w16 = layers[name]
        w = w16 if dt == torch.bfloat16 else w16.float()
        xs = [torch.randn(m, k, generator=g).to(q.device, dt)
              for _ in range(BACK_TO_BACK)]
        kern = b2b_ms(lambda i: qk.int8_linear(xs[i], q, scale, bias),
                      repeats=QUANT_SWEEP_REPEATS)
        mm = b2b_ms(lambda i: torch.matmul(xs[i], w.t()),
                    repeats=QUANT_SWEEP_REPEATS)
        pack = _int8pack_call(xs[0], q[:, :k].contiguous(), scale)
        pack_ms = (None if pack is None else
                   b2b_ms(lambda i: pack(i, xs), repeats=QUANT_SWEEP_REPEATS))
        pack_seen = pack_seen or pack is not None
        print(f"int8_linear back to back, {name} ({k}->{n}, M={m}, "
              f"{'bf16' if dt == torch.bfloat16 else 'f32'} x): kernel "
              f"{kern:.4f} ms, torch.matmul on the "
              f"{'bf16' if dt == torch.bfloat16 else 'f32'} twin {mm:.4f} "
              f"({mm / kern:.2f}x the kernel's), "
              + ("torch._weight_int8pack_mm: no CUDA kernel"
                 if pack is None else
                 f"torch._weight_int8pack_mm {pack_ms:.4f}"), flush=True)
    if not pack_seen:
        print(f"torch {torch.__version__} has no CUDA kernel for "
              f"torch._weight_int8pack_mm at these shapes", flush=True)
    print(f"int8_linear sweep {time.perf_counter() - t0:.2f} s", flush=True)


def _add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _reference_serving(dev, mode: str):
    """(cfg, card net, CPU net, CPU module) at the reference widths with
    inference dtype ``mode``, weights from a seed."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models.network import NetworkApply
    cfg = Config().replace(**{"network.inference_dtype": mode})
    h, w, s = 84, 84, 4
    net = NetworkApply(6, cfg.network, s, h, w, dev)
    cpu = NetworkApply(6, cfg.network, s, h, w, "cpu")
    return cfg, net, cpu, cpu.init(5)


def phase_quant_forward(dev) -> None:
    """9b: the int8 forward on the card (bf16 compute) against the port's
    CPU int8 forward (f32), by JAX's tests/test_quant.py rule; the card's
    f32-compute int8 forward against the CPU's at atol 1e-4; the weight
    bytes a forward streams per inference dtype."""
    import torch
    from r2d2_tpu_torch.models.network import (QuantInference,
                                               make_inference_bundle,
                                               param_tree_bytes)
    _, net, cpu, module = _reference_serving(dev, "int8")
    bundle = make_inference_bundle(cpu, module, 1)
    card = QuantInference(net, bundle["quant"], dev)
    card32 = QuantInference(net, bundle["quant"], dev, torch.float32)
    host = QuantInference(cpu, bundle["quant"], "cpu")
    check(card.dtype == torch.bfloat16 and host.dtype == torch.float32,
          "compute dtypes")
    g = torch.Generator().manual_seed(1)
    agree = total = 0
    dq_max = qscale = err32 = 0.0
    for _ in range(4):
        obs = torch.rand(64, 1, 84, 84, 4, generator=g)
        la = torch.nn.functional.one_hot(
            torch.randint(0, 6, (64, 1), generator=g), 6).float()
        hid = torch.randn(64, 2, 512, generator=g) * 0.1
        with torch.no_grad():
            q_cpu, _ = host(obs, la, hid)
            q_card, _ = card(obs.to(dev), la.to(dev), hid.to(dev))
            q_card32, h_card32 = card32(obs.to(dev), la.to(dev), hid.to(dev))
            _, h_cpu = host(obs, la, hid)
        q_cpu, q_card = q_cpu[:, 0], q_card[:, 0].cpu()
        err32 = max(err32, (q_card32[:, 0].cpu() - q_cpu).abs().max().item(),
                    (h_card32.cpu() - h_cpu).abs().max().item())
        dq = (q_card - q_cpu).abs().max().item()
        dq_max, qscale = max(dq_max, dq), max(qscale, q_cpu.abs().max().item())
        top2 = q_cpu.sort(dim=-1).values[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2.0 * dq
        same = q_card.argmax(-1) == q_cpu.argmax(-1)
        agree += int(same[clear].sum())
        total += int(clear.sum())
    print(f"int8 forward, card bf16 vs CPU f32 at the reference widths: "
          f"greedy agreement {agree}/{total} outside the tie band, max |dQ| "
          f"{dq_max:.3e} of Q scale {qscale:.3e}; card f32-compute vs CPU "
          f"{err32:.3e}", flush=True)
    check(total >= 128 and agree / total >= 0.99, f"agreement {agree}/{total}")
    check(dq_max <= 0.05 * max(qscale, 1e-3), f"|dQ| {dq_max} vs {qscale}")
    check(err32 <= 1e-4, f"f32-compute int8 card vs CPU {err32}")
    for mode in ("f32", "bf16", "int8"):
        _, _, cpu_m, mod_m = _reference_serving(dev, mode)
        twin = make_inference_bundle(cpu_m, mod_m, 0)
        tree = twin if mode == "f32" else twin["quant"]
        print(f"weight bytes a forward, {mode}: {param_tree_bytes(tree)}",
              flush=True)


def _serving_server(dev, mode: str, **kw):
    from r2d2_tpu_torch.serve import InprocEndpoint, PolicyServer
    cfg, net, _, module = _reference_serving(dev, mode)
    endpoint = InprocEndpoint()
    server = PolicyServer(cfg, net, module, endpoint=endpoint, **kw)
    return cfg, server, endpoint


def phase_serve_graphs(dev) -> dict:
    """9c: the PolicyServer at the reference widths, f32 (bf16 compute)
    and int8: each bucket's graph replay against the eager forward bit for
    bit, then SERVE_STEPS steps of 32 lanes served against the eager
    forward from the same states (actions and hidden equal). Returns the
    launches counted over the served steps."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.ops.launch_counts import captured_launches
    from r2d2_tpu_torch.serve import RemoteBatchedPolicy, StateCache
    launches = {}
    for mode in ("f32", "int8"):
        cfg, server, endpoint = _serving_server(dev, mode)
        g = np.random.default_rng(3)
        eager_ms = {}
        for b in server.buckets:
            obs = g.uniform(size=(b, 84, 84, 4)).astype(np.float32)
            la = g.integers(-1, 6, b)
            hid = (g.normal(size=(b, 2, 512)) * 0.1).astype(np.float32)
            got = server.graph_forward(b, obs, la, hid)
            args = (torch.from_numpy(obs).to(dev), torch.from_numpy(la).to(dev),
                    torch.from_numpy(hid).to(dev))
            want = [t.cpu().numpy() for t in server.eager_forward(*args)]
            for x, y, what in zip(got, want, ("actions", "q", "h")):
                check(np.array_equal(x, y),
                      f"{mode} bucket {b}: graph {what} != eager")
            with torch.cuda.stream(server.stream):
                eager_ms[b] = cuda_ms(lambda: server._eager(*args), runs=10)
        graph_ms = server.forward_ms_by_bucket()
        print(f"serve {mode}: every bucket's graph equals the eager forward "
              "bit for bit; forward ms by bucket, graph replay "
              f"{graph_ms}, eager {{"
              + ", ".join(f"{b}: {v:.4f}" for b, v in eager_ms.items())
              + "}", flush=True)
        # 32 lanes served vs the eager forward on the same states
        lanes = 32
        ref = StateCache(lanes, 1, (84, 84), 4, 512, action_dim=6)
        slots = [ref.lease(i)[0] for i in range(lanes)]
        server.forward_ms = {b: [0, 0.0] for b in server.buckets}
        server.start()
        policy = RemoteBatchedPolicy(endpoint.connect(), 6, [0.0] * lanes,
                                     list(range(lanes)), max_retry_s=15.0)
        frames = g.integers(0, 255, (8, lanes, 84, 84), np.uint8)
        reference = {}
        for i in range(lanes):
            policy.observe_reset_lane(i, frames[0, i])
            ref.reset_slot(slots[i], frames[0, i])
        _reset_counts()
        t0 = time.perf_counter()
        for t in range(SERVE_STEPS):
            actions, q, hidden = policy.act()
            stacked, last_action, h0 = ref.gather(slots)
            # the reference's launches (this thread's) are not the path's
            with captured_launches(server.stream) as compared:
                want = server.eager_forward(
                    torch.from_numpy(stacked).to(dev),
                    torch.from_numpy(last_action).to(dev),
                    torch.from_numpy(h0).to(dev))
            _add_counts(reference, compared)
            check(np.array_equal(actions, want[0].cpu().numpy())
                  and np.array_equal(hidden, want[2].cpu().numpy()),
                  f"serve {mode}: step {t} served != eager")
            for i in range(lanes):
                ref.write_hidden(slots[i], hidden[i])
                ref.observe(slots[i], frames[(t + 1) % 8, i], actions[i])
            policy.observe(frames[(t + 1) % 8], actions)
        seconds = time.perf_counter() - t0
        counted = {name: n - reference.get(name, 0)
                   for name, n in _counts().items()}
        block = server.stats.interval_block()
        policy.close()
        server.stop()
        check(block["batch"]["fill_mean"] == lanes,
              f"serve {mode}: fill {block['batch']}")
        if mode == "int8":
            check(counted["int8_linear"] > 0, "no int8_linear launch")
        _add_counts(launches, counted)
        print(f"serve {mode}: {SERVE_STEPS} steps of {lanes} lanes equal the "
              f"eager forward (actions, hidden); {seconds:.2f} s with the "
              f"checks, graph ms {server.forward_ms_by_bucket()[lanes]}, "
              f"launches {counted}", flush=True)
        del server
        torch.cuda.empty_cache()
    return launches


SERVE_CLIENT_START_S = 10.0        # client processes' start-up allowance


def _start_load(port: int, lanes: int, start_at: float) -> list:
    """Client processes (tools/serve_load.py) loading ``lanes`` lanes for
    SERVE_LOAD_S from wall-clock ``start_at``: up to 4 processes."""
    procs = max(1, min(4, lanes))
    per = lanes // procs
    return [subprocess.Popen(
        [sys.executable, "-m", "r2d2_tpu_torch.tools.serve_load",
         "--port", str(port), "--lanes", str(per),
         "--client-base", str(1000 * lanes + 100 * i), "--seed", str(i),
         "--seconds", str(SERVE_LOAD_S), "--start-at", str(start_at)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(procs)]


def _finish_load(lanes: int, running: list) -> dict:
    """The load's summed requests/s and the worst p50/p99."""
    outs = []
    for p in running:
        out, err = p.communicate(timeout=180)
        check(p.returncode == 0, f"serve_load failed: {err[-2000:]}")
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return {"lanes": lanes, "processes": len(running),
            "requests_per_s": sum(o["requests_per_s"] for o in outs),
            "p50_ms": max(o["p50_ms"] for o in outs),
            "p99_ms": max(o["p99_ms"] for o in outs),
            "timeouts": sum(o["timeouts"] for o in outs)}


def phase_serve_cli(dev) -> dict:
    """9d: python -m r2d2_tpu_torch.cli.serve on the card, f32 and int8,
    loaded by socket clients at SERVE_LANES lanes; it exits 0 at
    --seconds. Returns the servers' launch counts."""
    import tempfile
    launches = {}
    # every load's clients start together; their windows follow one
    # another, one second apart, after the start-up allowance
    seconds = SERVE_CLIENT_START_S + len(SERVE_LANES) * (
        SERVE_LOAD_S + 1.0) + 5.0
    for mode in ("f32", "int8"):
        save_dir = tempfile.mkdtemp(prefix=f"chip_smoke_serve_{mode}_")
        proc = subprocess.Popen(
            [sys.executable, "-m", "r2d2_tpu_torch.cli.serve",
             f"--seconds={seconds}", "--save-dir", save_dir,
             f"--network.inference_dtype={mode}",
             f"--runtime.log_interval={SERVE_LOAD_S}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            m = re.match(r"serving on ([\d.]+):(\d+) \(action_dim=(\d+)\)",
                         line)
            check(m, f"cli.serve printed {line!r}")
            port = int(m.group(2))
            t0 = time.time() + SERVE_CLIENT_START_S
            clients = [_start_load(port, lanes,
                                   t0 + i * (SERVE_LOAD_S + 1.0))
                       for i, lanes in enumerate(SERVE_LANES)]
            loads = [_finish_load(lanes, running)
                     for lanes, running in zip(SERVE_LANES, clients)]
            out, err = proc.communicate(timeout=seconds + 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                _, err = proc.communicate()
                print(f"cli.serve {mode} killed; its stderr:\n{err[-4000:]}",
                      flush=True)
        check(proc.returncode == 0, f"cli.serve {mode}: {err[-3000:]}")
        with open(os.path.join(save_dir, "serve_metrics.jsonl")) as f:
            records = [json.loads(x) for x in f if x.strip()]
        shutil.rmtree(save_dir, ignore_errors=True)
        final = records[-1]
        check(final["device"].startswith("cuda"), f"device {final['device']}")
        busiest = max((r for r in records if "serving" in r),
                      key=lambda r: r["serving"]["requests"])
        span = max(records[-1]["t"] - records[0]["t"], 1e-9)
        for row in loads:
            print(f"cli.serve {mode}, {row['lanes']} lanes in "
                  f"{row['processes']} processes: {row['requests_per_s']:.1f} "
                  f"requests/s, client p50 {row['p50_ms']:.3f} ms, p99 "
                  f"{row['p99_ms']:.3f} ms, timeouts {row['timeouts']}",
                  flush=True)
            check(row["timeouts"] == 0, f"timeouts under load: {row}")
        print(f"cli.serve {mode}: {final['batches']} dispatches "
              f"({final['batches'] / span:.1f}/s over the run), forward ms "
              f"by bucket {final['forward_ms_by_bucket']}; busiest record's "
              f"serving block {json.dumps(busiest['serving'])}"
              + (f"; quant {json.dumps(busiest['quant'])}"
                 if "quant" in busiest else ""), flush=True)
        if mode == "int8":
            check(final["launches"]["int8_linear"] > 0,
                  "cli.serve int8 launched no int8_linear")
        _add_counts(launches, final["launches"])
    return launches


def phase_served_train(dev, k, bench_default: float) -> dict:
    """9e: cli.train --actor.inference=server (thread actors, int8
    inference, Fake, capacity 100,000) for SERVED_TRAIN_SECONDS: trains on
    cuda with finite losses, every action served, the record has a serving
    block. Returns the launches of the run."""
    import tempfile
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.config import Config
    batch = Config().replay.batch_size
    marks = []

    stacks = []

    def hook(stack):
        if not stacks:
            stacks.append(stack)
        marks.append((time.perf_counter(), stack.learner.training_steps,
                      stack.learner.env_steps))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_served_") as d:
        _reset_counts()
        torch.cuda.empty_cache()
        summary = train.main(SERVED_TRAIN_ARGS + [
            f"--max-seconds={SERVED_TRAIN_SECONDS}",
            f"--runtime.save_dir={d}"], dispatch_hook=hook)
        torch.cuda.synchronize()
        counted = _counts()
        records = [json.loads(x) for x in open(os.path.join(
            d, "metrics_player0.jsonl")).read().split("\n") if x.strip()]
        telemetry = _check_stage_records(
            records, "served training", SERVE_STAGES + ORCH_STAGES[2:],
            [os.path.join(d, "spans_player0.jsonl")])
        learner = stacks[0].learner
        health = _check_health_records(
            records, "served training",
            _state_bytes(learner.train_state, learner.replay_state),
            os.path.join(d, "alerts_player0.jsonl"), names=("serve/graphs",))
        aot = [r["resources"]["compile"].get("aot") for r in records]
        check(all(a is not None and not a["missing"] for a in aot),
              f"served training: the serving buckets' coverage {aot[-1:]}")
    check(summary["device"].startswith("cuda"), "served training off cuda")
    check(summary["steps"] > 0 and all(math.isfinite(x)
                                        for x in summary["losses"]),
          "served training: no steps or a non-finite loss")
    served = summary["served"]
    check(served["rows"] >= summary["env_steps"] > 0,
          f"served rows {served['rows']} < env steps {summary['env_steps']}")
    blocks = [r["serving"] for r in records if "serving" in r]
    check(blocks, "no serving block in the records")
    check(counted["int8_linear"] > 0, "served training: no int8_linear")
    (t_a, s_a, e_a), (t_b, s_b, e_b) = marks[1], marks[-1]
    rate = batch * (s_b - s_a) / (t_b - t_a)
    print(f"served training (thread actors, int8, K={k}): "
          f"{rate:.2f} seq-updates/s over dispatches 2..{len(marks)} "
          f"({100 * rate / bench_default:.2f}% of the bench's default at "
          f"K={k} in this call, {bench_default:.2f}); env steps/s "
          f"{(e_b - e_a) / (t_b - t_a):.2f}; served rows {served['rows']} in "
          f"{served['batches']} dispatches, forward ms by bucket "
          f"{served['forward_ms_by_bucket']}; last serving latency "
          f"{blocks[-1]['latency']}, fill {blocks[-1]['batch']['fill_mean']}"
          f"; quant {records[-1].get('quant')}; launches {counted}; "
          f"telemetry {json.dumps(telemetry)}; resources and alerts "
          f"{json.dumps(health)}", flush=True)
    return counted


def phase_serving(dev, k, bench_default: float) -> dict:
    """Phase 9 (see the module docstring); returns the int8 kernel's
    timings and the serving paths' launch counts."""
    result = _timed("9a", phase_quant_kernel, dev)
    _timed("9b", phase_quant_forward, dev)
    serve = _timed("9c", phase_serve_graphs, dev)
    _add_counts(serve, _timed("9d", phase_serve_cli, dev))
    _add_counts(serve, _timed("9e", phase_served_train, dev, k,
                              bench_default))
    result["serve_launches"] = serve
    return result


# ---------------------------------------------------------------------------
# phase 10: pipelined ingest, crash recovery, quantized on-device acting

INGEST_SECONDS = 15.0              # each cli.train run of the ingest A/B
INGEST_KS = (1, 8)                 # replay.ingest_batch_blocks, in turn
INGEST_ARGS = ["--actor-mode=thread", "--env.game_name=Fake",
               "--replay.capacity=100000", "--runtime.save_interval=0",
               "--runtime.log_interval=5"]
RECOVERY_BLOCKS = 12               # reference-width blocks of the twin test
SUPERVISED_SECONDS = 55.0          # the supervised run's bound
SUPERVISED_SNAPSHOT_INTERVAL = 100  # learner steps between its snapshots
SUPERVISED_KILL_BY_S = 48.0        # its first snapshot must land by then
# its replay.learning_starts: training (and so the first snapshot) starts
# after two reference-width blocks instead of the default 1,000 env steps,
# which two thread actors took 15-20 s to fill on slower hosts
SUPERVISED_LEARNING_STARTS = 200
SUPERVISED_FLUSH_S = 0.5           # the child's span drain (the split)
SUPERVISED_GRACE_S = 1.2           # after the commit: the spans drain


def _process_start(pid: int) -> float:
    """A process's start on the wall clock, from /proc (Linux)."""
    with open(f"/proc/{pid}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _startup_split(spans, child_start: float, meta: dict) -> dict:
    """10b's seconds from the killed child's start to its first committed
    snapshot, by part: its spans (startup/stack, startup/actors,
    startup/fill, the dispatches) and the snapshot's manifest."""
    first = {}
    for e in spans:
        first.setdefault(e["name"], e)
    dispatches = [e for e in spans if e["name"] == "learner/train_dispatch"]
    check(all(n in first for n in ("startup/stack", "startup/actors",
                                   "startup/fill"))
          and len(dispatches) >= 2,
          f"10b: the child's spans {sorted(first)}, "
          f"{len(dispatches)} dispatches")
    stack, fill = first["startup/stack"], first["startup/fill"]
    d1, d2 = dispatches[0], dispatches[1]
    # the dispatch whose steps reached the snapshot's step
    at = next((e for e in dispatches
               if e["tags"]["step"] + e["tags"]["k"] >= meta["step"]),
              dispatches[-1])
    write_start = meta["written_at"] - meta["write_s"]
    parts = {
        "start_up_and_imports": stack["ts"] - child_start,
        "learner_build_and_kernel_load": stack["dur"],
        "actors_start": first["startup/actors"]["dur"],
        "fill_to_learning_starts": fill["dur"],
        "step0_checkpoint_and_first_drain": d1["ts"] - (fill["ts"]
                                                        + fill["dur"]),
        "first_eager_dispatch": d1["dur"],
        "to_the_first_captures": d2["ts"] - (d1["ts"] + d1["dur"]),
        "first_captures": d2["dur"],
        "steps_to_the_snapshot": (at["ts"] + at["dur"]
                                  - (d2["ts"] + d2["dur"])),
        "snapshot_capture_to_write": write_start - (at["ts"] + at["dur"]),
        "snapshot_write": meta["write_s"],
    }
    parts = {k: round(v, 3) for k, v in parts.items()}
    parts["total"] = round(meta["written_at"] - child_start, 3)
    parts["steps"] = meta["step"]
    return parts
QUANT_TRAIN_SECONDS = 13.0         # cli.train at int8 on-device acting
QUANT_TRAIN_ARGS = ["--network.inference_dtype=int8",
                    "--telemetry.quant_probe_interval=4"]


def _quantiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "median": round(statistics.median(xs), 4),
            "p90": round(xs[int(0.9 * (len(xs) - 1))], 4),
            "max": round(xs[-1], 4)}


def _ingest_run(dev, k_ingest: int, k: int, bench_default: float) -> dict:
    """One cli.train run of 10(a): thread actors, the CUDA "auto" path,
    ``replay.ingest_batch_blocks`` = ``k_ingest``. Checks cuda, finite
    losses, and that every block an actor sent is committed or still
    queued (the staged counters at zero); returns the report."""
    import tempfile
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.config import Config
    batch = Config().replay.batch_size
    state = {"calls": 0, "marks": [], "parts": [], "host_s": {},
             "steps": []}

    def hook(stack):
        state["calls"] += 1
        n = state["calls"]
        state["marks"].append(time.perf_counter())
        state["parts"].append(dict(state["host_s"]))
        steps = stack.learner.training_steps
        if n == 1:
            state["stack"] = stack
            state["warmup_s"] = time.perf_counter() - state["launched"]
            for obj, name in ((stack.learner, "drain"),
                              (stack.learner, "_step_fn"),
                              (stack.learner, "publish"),
                              (stack.learner, "flush_metrics"),
                              (stack, "supervise")):
                _time_calls(obj, name, state["host_s"])
        if n == 2:
            torch.cuda.synchronize()
            state["start"] = (time.perf_counter(), steps)
            state["mid_at"] = (state["start"][0] + state["close"]) / 2
        elif "start" in state and "end" not in state:
            now = time.perf_counter()
            if "mid" not in state and now >= state["mid_at"]:
                torch.cuda.synchronize()
                state["mid"] = (time.perf_counter(), steps)
            elif now >= state["close"]:
                torch.cuda.synchronize()
                state["end"] = (time.perf_counter(), steps,
                                stack.learner.env_steps, n)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as d:
        state["launched"] = time.perf_counter()
        state["close"] = state["launched"] + INGEST_SECONDS - 2.0
        summary = train.main(INGEST_ARGS + [
            f"--replay.ingest_batch_blocks={k_ingest}",
            f"--max-seconds={INGEST_SECONDS}", f"--runtime.save_dir={d}"],
            dispatch_hook=hook)
        records = [json.loads(x) for x in open(os.path.join(
            d, "metrics_player0.jsonl")) if x.strip()]
    label = f"ingest_batch_blocks={k_ingest}"
    check("mid" in state and "end" in state,
          f"cli.train {label}: {state['calls']} dispatches, too few")
    stack = state["stack"]
    learner = stack.learner
    check(summary["device"].startswith("cuda"), summary["device"])
    check(summary["steps"] > 0 and all(math.isfinite(x)
                                        for x in summary["losses"]),
          f"cli.train {label}: no steps or a non-finite loss")
    check(learner._ingest_k == k_ingest, f"K {learner._ingest_k}")
    sent = stack.queue._q.unfinished_tasks    # every put (no task_done)
    left = stack.queue.qsize()
    check(learner._staged_blocks == 0 and learner._staged_env_steps == 0
          and learner.ring.total_adds == sent - left
          == summary["blocks_ingested"],
          f"cli.train {label}: {learner.ring.total_adds} blocks committed, "
          f"{sent} sent, {left} left in the queue, staged "
          f"{learner._staged_blocks}")
    (t0, s0), (tm, sm) = state["start"], state["mid"]
    t1, s1, _, _ = state["end"]
    rate = batch * (s1 - s0) / (t1 - t0)
    halves = [batch * (sm - s0) / (tm - t0), batch * (s1 - sm) / (t1 - tm)]
    drains = [r["ingest_blocks_per_drain"] for r in records
              if r.get("ingest_blocks_per_drain")]
    report = dict(
        ingest_batch_blocks=k_ingest, steps_per_dispatch=k,
        seq_updates_per_s=rate, halves=halves,
        of_bench_default=rate / bench_default, bench_default=bench_default,
        window_s=t1 - t0, warmup_s=state["warmup_s"],
        blocks_committed=learner.ring.total_adds, blocks_left=left,
        env_steps=summary["env_steps"],
        host_s={n: round(v, 3) for n, v in state["host_s"].items()},
        commit_ms=_quantiles(learner.ingest_ms["commit"]),
        stage_ms=_quantiles(learner.ingest_ms["stage"]),
        blocks_per_drain=drains,
        queue_depth=[r["ingest"]["queue_depth"] for r in records
                     if "ingest" in r],
        drain_latency_ms=[r["ingest_drain_latency_ms"] for r in records
                          if r.get("ingest_drain_latency_ms")],
        **_interval_stats(state))
    print(f"ingest A/B, cli.train {label} (thread actors, K={k}): "
          + json.dumps(report), flush=True)
    return report


def phase_ingest(dev, k: int, bench_default: float) -> dict:
    """10(a): the per-block drain against the stager at K=8 in one call;
    returns {K: report} and prints which setting was faster beyond the
    spread of the halves of each run's window."""
    reports = {ki: _ingest_run(dev, ki, k, bench_default)
               for ki in INGEST_KS}
    one, eight = reports[INGEST_KS[0]], reports[INGEST_KS[1]]
    faster = (INGEST_KS[1] if min(eight["halves"]) > max(one["halves"])
              else INGEST_KS[0] if min(one["halves"]) > max(eight["halves"])
              else None)
    print(f"ingest A/B: K=1 {one['seq_updates_per_s']:.2f} seq-updates/s "
          f"(halves {one['halves']}), K=8 {eight['seq_updates_per_s']:.2f} "
          f"(halves {eight['halves']}); faster beyond the halves' spread: "
          f"{faster if faster is not None else 'neither'}", flush=True)
    return reports


def phase_recovery_learner(dev) -> dict:
    """10(b), part 1: a learner on the card at the reference widths
    (capacity 100,000, the CUDA "auto" K) fills its replay, takes a
    dispatch, saves, snapshots and takes another (its graph's capture and
    replay); a second learner resumed from that checkpoint and snapshot
    holds the same replay tensors and its first dispatch (eager) gives the
    same losses, bit for bit. Also printed: the per-block ingest's host ms
    with no actor thread beside it."""
    import tempfile
    import torch
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.snapshot import read_manifest
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.tools import bench
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as d:
        cfg = bench.reference_config(**{
            "runtime.save_dir": d, "runtime.save_interval": 0,
            "runtime.snapshot_interval": 10 ** 9})
        net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width, dev)
        first = Learner(cfg, net)
        ingest_ms = []
        for block in bench.synthetic_blocks(cfg, RECOVERY_BLOCKS, seed=9):
            t0 = time.perf_counter()
            first.ingest(block)
            ingest_ms.append((time.perf_counter() - t0) * 1e3)
        first.step()
        ckpt = first.save(1)
        torch.cuda.synchronize()
        first.snapshot_replay()
        capture_ms = first.snapshot_capture_ms[-1]
        check(first._snap_writer.drain(300.0), "the snapshot write hung")
        first._snap_writer.check()
        meta = read_manifest(d, 0)
        check(meta is not None and meta["total_adds"] == RECOVERY_BLOCKS,
              f"manifest {meta}")
        want = {n: t.clone() for n, t in vars(first.replay_state).items()
                if torch.is_tensor(t)}
        twin = first.step()["loss"].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = Learner(cfg.replace(**{"runtime.resume": ckpt}), net)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(resumed._restores == 1
              and resumed._restored_blocks == RECOVERY_BLOCKS,
              "the resumed learner restored no snapshot")
        for name, value in want.items():
            check(torch.equal(getattr(resumed.replay_state, name), value),
                  f"restored replay {name} differs")
        check(resumed.replay_state.block_ptr == first.replay_state.block_ptr
              and vars(resumed.ring) == vars(first.ring), "ring differs")
        got = resumed.step()["loss"]
        check(torch.equal(got, twin), f"resumed losses {got.tolist()} != "
              f"the twin's {twin.tolist()}")
        first.stop_background()
        resumed.stop_background()
    report = dict(capture_host_ms=capture_ms, write_s=meta["write_s"],
                  payload_bytes=meta["payload_bytes"], restore_s=restore_s,
                  losses=twin.tolist(),
                  # a per-block ingest's host ms with no actor thread
                  # beside it (10(a)'s runs have two)
                  ingest_host_ms_alone=_quantiles(ingest_ms[1:]))
    print("recovery, reference widths: the resumed learner's losses equal "
          "its twin's bit for bit, the replay tensors equal; "
          + json.dumps(report), flush=True)
    del first, resumed, want
    torch.cuda.empty_cache()
    return report


def phase_supervised_kill(dev) -> dict:
    """10(b), part 2: cli.train --runtime.auto_resume=true (thread actors,
    reference widths) as a process; once its first snapshot is committed
    the child (learner.pid) is SIGKILLed; the supervisor relaunches it from
    the newest checkpoint, it restores the replay and trains on cuda."""
    import signal
    import tempfile
    from r2d2_tpu_torch.replay.snapshot import read_manifest
    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervised_") as d:
        out_path = os.path.join(d, "stdout.txt")
        metrics = os.path.join(d, "metrics_player0.jsonl")
        t_launch = time.time()
        with open(out_path, "w") as out, \
                open(os.path.join(d, "stderr.txt"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "r2d2_tpu_torch.cli.train",
                 "--runtime.auto_resume=true",
                 f"--replay.learning_starts={SUPERVISED_LEARNING_STARTS}",
                 f"--runtime.snapshot_interval={SUPERVISED_SNAPSHOT_INTERVAL}",
                 "--runtime.save_interval=100000", "--runtime.log_interval=1",
                 f"--telemetry.flush_interval_s={SUPERVISED_FLUSH_S}",
                 "--actor-mode=thread", "--env.game_name=Fake",
                 "--replay.capacity=100000",
                 f"--max-seconds={SUPERVISED_SECONDS}",
                 f"--runtime.save_dir={d}"], stdout=out, stderr=err)
        try:
            meta = child_start = None
            while meta is None and time.time() - t_launch \
                    < SUPERVISED_KILL_BY_S and proc.poll() is None:
                time.sleep(0.2)
                if child_start is None and os.path.exists(
                        os.path.join(d, "learner.pid")):
                    child_start = _process_start(int(open(os.path.join(
                        d, "learner.pid")).read()))
                meta = read_manifest(d, 0)
            check(meta is not None, "no snapshot committed by "
                  f"{SUPERVISED_KILL_BY_S} s: "
                  + open(os.path.join(d, "stderr.txt")).read()[-3000:])
            child = int(open(os.path.join(d, "learner.pid")).read())
            check(child != proc.pid, "learner.pid names the supervisor")
            t_commit = time.time()
            # the spans of the snapshot's dispatches drain before the kill
            time.sleep(SUPERVISED_GRACE_S)
            os.kill(child, signal.SIGKILL)
            t_kill = time.time()
            first_dispatch = None
            while proc.poll() is None:
                time.sleep(0.2)
                if first_dispatch is None and os.path.exists(metrics):
                    for line in open(metrics):
                        r = json.loads(line) if line.strip() else {}
                        if (r.get("recovery", {}).get("restores") == 1
                                and r.get("training_speed", 0) > 0):
                            first_dispatch = time.time() - t_kill
                            break
            proc.wait(timeout=SUPERVISED_SECONDS + 120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        stdout = open(out_path).read().splitlines()
        stderr = open(os.path.join(d, "stderr.txt")).read()
        check(proc.returncode == 0, f"supervised cli.train exit "
              f"{proc.returncode}: {stderr[-3000:]}")
        summaries = [json.loads(x) for x in stdout if x.startswith("{")]
        check(summaries and summaries[-1] == {"supervised": True,
                                              "restarts": 1},
              f"supervisor summary {summaries[-1:]}")
        child_summary = [x for x in summaries if "steps" in x]
        check(len(child_summary) == 1
              and child_summary[0]["device"].startswith("cuda")
              and child_summary[0]["steps"] > 0
              and math.isfinite(child_summary[0]["final_loss"]),
              f"the relaunched child's summary {child_summary}")
        records = [json.loads(x) for x in open(metrics) if x.strip()]
        spans = [e for e in _read_jsonl(os.path.join(d, "spans_player0.jsonl"))
                 if e["ts"] < t_kill]
        split = _startup_split(spans, child_start, meta)
        restored = [r["recovery"] for r in records
                    if r.get("recovery", {}).get("restores") == 1]
        check(restored and restored[0]["restored_blocks"] > 0
              and restored[0]["supervisor"]["restarts"] == 1,
              f"no restore in the relaunched records: {records[-1:]}")
    report = dict(killed_after_s=t_kill - t_launch,
                  first_snapshot_seen_s=t_commit - t_launch,
                  launch_to_child_start_s=child_start - t_launch,
                  split_s=split,
                  first_snapshot=dict(step=meta["step"],
                                      payload_bytes=meta["payload_bytes"],
                                      write_s=meta["write_s"],
                                      total_adds=meta["total_adds"]),
                  restored_blocks=restored[0]["restored_blocks"],
                  first_dispatch_after_kill_s=first_dispatch,
                  relaunched_steps=child_summary[0]["steps"],
                  relaunched_snapshots=restored[-1]["snapshot"])
    print("supervised cli.train, child SIGKILLed after its first snapshot: "
          "relaunched, replay restored, trained on cuda; "
          + json.dumps(report), flush=True)
    return report


def phase_quant_segment_vs_cpu(dev) -> None:
    """10(c), part 1: a small int8 segment (gridworld, "td" priorities) on
    the card against the port's CPU int8 segment from the same weights
    and draws, the card's twin computing in f32 (the CPU's type): actions
    and integer fields equal, float fields within ANAKIN_ATOL. Then the
    card's bf16-compute twin on the CPU segment's end states, by phase
    9b's rule (greedy agreement outside the tie band, |dQ| within 5% of
    the Q scale)."""
    import dataclasses
    import torch
    from r2d2_tpu_torch.actor.anakin import _forward_inputs, init_act_carry
    cfg = _tiny_config().replace(**{
        "env.game_name": "Grid", "env.grid_size": 4, "env.episode_len": 40,
        "actor.on_device": True, "actor.anakin_lanes": 8,
        "actor.anakin_priority": "td", "network.inference_dtype": "int8"})
    gen = torch.Generator().manual_seed(12)
    env, spec, _, act = _anakin_parts(cfg, torch.device("cpu"), 8, 0)
    reset = env.reset_draws(8, gen)
    draws = [act.draw(gen) for _ in range(2)]
    runs = []
    _reset_counts()
    for device in (torch.device("cpu"), dev):
        env, spec, twin, act = _anakin_parts(cfg, device, 8, 0,
                                             compute_dtype=torch.float32)
        carry = init_act_carry(env, spec, 8, reset_draws=reset.to(device))
        out = []
        for dr in draws:
            carry, blocks, stats = act(twin, carry, 1, draws=_to(dr, device))
            out.append((blocks, carry.hidden, stats))
        runs.append(out)
    check(_counts()["int8_linear"] > 0, "the card's int8 segment launched "
          "no int8_linear")
    worst = 0.0
    for (cb, ch, cs), (gb, gh, gs) in zip(*runs):
        for f in dataclasses.fields(cb):
            a, b = getattr(cb, f.name), getattr(gb, f.name).cpu()
            if a.is_floating_point():
                err = float(torch.nan_to_num(a - b).abs().max())
                worst = max(worst, err)
                check(err <= ANAKIN_ATOL and torch.equal(a.isnan(),
                                                         b.isnan()),
                      f"int8 segment {f.name}: max abs {err}")
            else:
                check(torch.equal(a, b), f"int8 segment {f.name} differs")
        worst = max(worst, float((ch - gh.cpu()).abs().max()))
        check(abs(float(cs["quant_dq"]) - float(gs["quant_dq"])) <= 1e-4,
              "probe dq")
    # the bf16-compute twin (the fused loop's) against the CPU's Q
    _, _, twin16, _ = _anakin_parts(cfg, dev, 8, 0)
    _, _, twin_cpu, _ = _anakin_parts(cfg, torch.device("cpu"), 8, 0)
    agree = total = 0
    dq_max = qscale = 0.0
    for _, _, stats in runs[0]:
        state = stats["end_state"]
        obs, one_hot = _forward_inputs(state[0], state[1], act.action_dim)
        with torch.no_grad():
            q_cpu = twin_cpu.quant(obs, one_hot, state[2])[0][:, 0]
            q_card = twin16.quant(obs.to(dev), one_hot.to(dev),
                                  state[2].to(dev))[0][:, 0].float().cpu()
        dq = float((q_card - q_cpu).abs().max())
        dq_max, qscale = max(dq_max, dq), max(qscale,
                                              float(q_cpu.abs().max()))
        top2 = q_cpu.sort(dim=-1).values[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2.0 * dq
        agree += int((q_card.argmax(-1) == q_cpu.argmax(-1))[clear].sum())
        total += int(clear.sum())
    check(total == 0 or agree == total, f"agreement {agree}/{total}")
    check(dq_max <= 0.05 * max(qscale, 1e-3), f"|dQ| {dq_max} of {qscale}")
    print(f"int8 on-device acting, small segments (Grid, td, 8 lanes): "
          f"card (f32-compute twin) vs CPU: actions and integer fields "
          f"equal, float fields max abs {worst:.3e}; bf16-compute twin vs "
          f"CPU on the end states: greedy agreement {agree}/{total} outside "
          f"the tie band, max |dQ| {dq_max:.3e} of Q scale {qscale:.3e}",
          flush=True)


def phase_ingest_recovery_quant(dev, k: int, bench_default: float,
                                bench_fused: float, f32_segment_ms: float
                                ) -> dict:
    """Phase 10 (see the module docstring). Returns the int8 fused run's
    launch counts."""
    _timed("10a", phase_ingest, dev, k, bench_default)
    _timed("10b twin", phase_recovery_learner, dev)
    _timed("10b drill", phase_supervised_kill, dev)
    _timed("10c vs CPU", phase_quant_segment_vs_cpu, dev)
    int8_ms, _ = _timed("10c graph", phase_anakin_graph, dev, "int8")
    print(f"acting segment ms at the reference widths, this call: f32 "
          f"{f32_segment_ms:.3f} (phase 8), int8 {int8_ms:.3f} "
          f"({int8_ms / f32_segment_ms:.3f}x)", flush=True)
    launches, records = phase_anakin_train(
        dev, k, bench_fused, int8_ms, extra=QUANT_TRAIN_ARGS,
        seconds=QUANT_TRAIN_SECONDS, label="int8")
    quant = [r["quant"] for r in records if "quant" in r]
    check(quant and sum(q["probes"] for q in quant) > 0,
          f"no probe in the int8 run's quant blocks: {quant}")
    print(f"int8 fused loop quant blocks: {json.dumps(quant)}", flush=True)
    return launches


DP_K = 4                           # 11(a)'s steps a dispatch
DP_WINDOW = 64                     # steps a timed window of 11(a)
DP_WINDOWS = 2                     # rounds of turns (u, s, s, u)
DP_SECONDS = 24.0                  # each two-rank cli.train run of 11(c)


def _dp_check_case(dev_names, case):
    """tools/dp_check.py rank_steps on two gloo ranks on ``dev_names``."""
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    from r2d2_tpu_torch.tools import dp_check
    return run_ranks(dp_check.rank_steps, 2, case, devices=dev_names,
                     backend="gloo", timeout_s=300)


def phase_dp_nccl(dev, base, spec, rs) -> dict:
    """Phase 11(a): a one-rank NCCL world at the reference shape (bf16,
    bench's "fused" path: every kernel of the single-DQN step), K=DP_K.
    The data-parallel step (one CUDA graph with the all-reduce captured
    in it), its eager twin (the same body, the hook's NCCL all-reduce on
    the current stream) and make_multi_learner_step, from one seed, each
    on its own copy of one replay, with the same injected jitter: three
    dispatches (the graphs' eager warm-up, their capture, a replay), the
    losses, grad norms, params and tree bit-equal. Then seq-updates/s of
    the sharded and the unsharded dispatch in turns (DP_WINDOWS rounds of
    DP_WINDOW-step windows: unsharded, sharded, sharded, unsharded), and
    one profiled window of the sharded graph whose kernel names equal the
    wrappers' counts. Returns the sharded step's launch counts."""
    import torch
    from r2d2_tpu_torch.config import MeshConfig
    from r2d2_tpu_torch.learner.train_step import (_make_step_body,
                                                   create_train_state,
                                                   eager_steps,
                                                   make_multi_learner_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.parallel.mesh import (close_mesh, make_mesh,
                                              rendezvous)
    from r2d2_tpu_torch.parallel.sharded import (GradMean,
                                                 make_sharded_learner_step)
    from r2d2_tpu_torch.tools import bench
    cfg = base.replace(**bench.PATHS["fused"])
    use_double = cfg.network.use_double
    batch = spec.batch_size
    mesh = make_mesh(MeshConfig(dp=1), [dev], "nccl",
                     init_method=rendezvous())
    sharded_launches = dict.fromkeys(_counts(), 0)
    try:
        net = NetworkApply(bench.ACTION_DIM, cfg.network,
                           cfg.env.frame_stack, cfg.env.frame_height,
                           cfg.env.frame_width, dev)
        names = ("graph", "eager", "multi")
        states = {n: create_train_state(net, cfg.optim, 0, use_double)
                  for n in names}
        replays = {n: _clone_replay(rs) for n in names}
        reduce = GradMean(mesh)
        reduce.attach(states["eager"].params)
        steps = {
            "graph": make_sharded_learner_step(net, spec, cfg.optim,
                                               use_double, mesh, DP_K),
            "eager": eager_steps(_make_step_body(
                net, spec, cfg.optim, use_double, reduce=reduce), DP_K),
            "multi": make_multi_learner_step(net, spec, cfg.optim,
                                             use_double, DP_K)}
        check(steps["graph"].graphed, "NCCL: the sharded step is not a graph")

        def run(name, uniform=None):
            before = _counts()
            out = steps[name](states[name], replays[name], uniform)[2]
            if name == "graph":
                for k, n in _counts().items():
                    sharded_launches[k] += n - before[k]
            return out

        uniforms = torch.rand((3, DP_K, batch),
                              generator=torch.Generator().manual_seed(6)
                              ).to(dev)
        for d, u in enumerate(uniforms):
            out = {n: run(n, u) for n in names}
            for other in ("eager", "multi"):
                for metric in ("loss", "grad_norm", "mean_q"):
                    check(torch.equal(out["graph"][metric],
                                      out[other][metric]),
                          f"11a dispatch {d}: {metric} graph "
                          f"{out['graph'][metric].tolist()} vs {other} "
                          f"{out[other][metric].tolist()}")
                for (pn, p), q in zip(
                        states["graph"].params.named_parameters(),
                        states[other].params.parameters()):
                    check(torch.equal(p, q), f"11a dispatch {d}: param {pn}"
                          f" differs from {other}'s")
                check(torch.equal(replays["graph"].tree,
                                  replays[other].tree),
                      f"11a dispatch {d}: tree differs from {other}'s")
            print(f"11a dispatch {d}: sharded graph = its eager twin = "
                  f"make_multi_learner_step bit for bit; losses "
                  f"{out['graph']['loss'].tolist()}", flush=True)
        check(getattr(steps["graph"]._dispatch, "graph", None) is not None,
              "the sharded step captured no graph")
        rates = {"graph": [], "multi": []}
        for name in ["multi", "graph", "graph", "multi"] * DP_WINDOWS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_WINDOW // DP_K):
                run(name)
            torch.cuda.synchronize()
            rates[name].append(batch * DP_WINDOW
                               / (time.perf_counter() - t0))
        want = _want_launches(bench.PATHS["fused"], PROFILE_DISPATCHES
                              * DP_K)
        for _ in range(PROFILE_TRIES):
            before = _counts()
            prof, wall_ms = bench.profile_steps(lambda: run("graph"),
                                                PROFILE_DISPATCHES)
            counted = {k: n - before[k] for k, n in _counts().items()}
            seen = _profiled_kernel_counts(prof)
            if not _lost_events(seen, want):
                break
        check(seen == counted == want, f"11a: the profile shows {seen}, "
              f"counted {counted}, want {want}")
        nccl = sorted({e.name[:80] for e in bench.device_kernels(prof)
                       if "nccl" in e.name.lower()})
        busy = bench.device_busy_ms(prof)
        sharded = statistics.median(rates["graph"])
        unsharded = statistics.median(rates["multi"])
        report = {
            "k": DP_K, "path": "fused", "window_steps": DP_WINDOW,
            "sharded_seq_updates_per_s": rates["graph"],
            "unsharded_seq_updates_per_s": rates["multi"],
            "sharded_over_unsharded": sharded / unsharded,
            "profiled_ms_per_step": wall_ms / (PROFILE_DISPATCHES * DP_K),
            "device_busy_ms_per_step": busy / (PROFILE_DISPATCHES * DP_K),
            "nccl_kernels_seen": nccl, "launches": counted,
            "flat_grad_mb": reduce.flat.numel() * 4 / 1e6}
        print("11a one-rank NCCL data-parallel step at the reference shape "
              f"({_card()}): " + json.dumps(report), flush=True)
        del steps, states, replays, reduce
        torch.cuda.synchronize()
    finally:
        close_mesh()
    return sharded_launches


def _card() -> str:
    from r2d2_tpu_torch.tools import bench
    return bench.card_line()


def _diag_match(got: dict, want: dict, label: str,
                rtol: float = 1e-4, dq_rtol: float = 0.0) -> float:
    """ld/ and rd/ values of one dispatch against another run's (the
    CPU's, eager steps'): the same keys, counts (histograms, lane counts,
    the non-finite flag, the version extrema, stamps and indices) exact,
    NaN where the other's is, the rest within ``rtol`` (dQ within
    ``dq_rtol``, by default ``rtol``). Returns the largest relative
    difference."""
    import numpy as np
    check(got.keys() == want.keys(), f"{label}: diagnostic keys "
          f"{sorted(got.keys() ^ want.keys())}")
    worst = 0.0
    for key, w in want.items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(w, np.float64)
        if (key.endswith(("hist", "lane_counts", "nonfinite", "version_min",
                          "version_max", "batch_idxes", "weight_versions"))):
            check(np.array_equal(g, w), f"{label}: {key} {g} vs {w}")
            continue
        check(np.array_equal(np.isnan(g), np.isnan(w)),
              f"{label}: {key} NaN at other places: {g} vs {w}")
        ok = ~np.isnan(w)
        rel = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-12)
        if rel.size:
            worst = max(worst, float(rel.max()))
            bound = (dq_rtol or rtol) if "delta_q" in key else rtol
            check(float(rel.max()) <= bound,
                  f"{label}: {key} {g} vs {w}")
    return worst


def phase_dp_gloo_card_vs_cpu(dev) -> None:
    """Phase 11(b): two gloo ranks sharing the card against two CPU ranks
    on the same dp=2 computation (tools/dp_check.py rank_steps: the small
    f32 shape, two shards filled round-robin, the same weights and
    per-rank jitter, one dispatch of K=2, eager): the losses and each
    shard's tree within rtol 1e-4 (phase 4's card = CPU rule, over its
    two steps), the
    card ranks' train states bit-equal (the digest), every kernel of the
    path launched on the card ranks and none on the CPU's. Both
    diagnostics on (learning interval 2: dQ at the second step; a tree
    snapshot every step): the reduced ld/ and rd/ values equal the CPU
    ranks' (histograms, lane counts and version extrema exact, the rest
    within rtol 1e-3), the rd/shard_* views with their dp axis, equal
    on both card ranks; the dQ's decodes and lean forwards counted."""
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay import device_replay as tdr
    from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    from r2d2_tpu_torch.tools import dp_check
    cfg = _tiny_config().replace(**{"network.pallas_lstm": "on"})
    cpu = torch.device("cpu")
    spec = ReplaySpec.from_config(cfg, cpu)
    rng = np.random.default_rng(8)
    shards = []
    for s in range(2):
        state = tdr.replay_init(spec, cpu)
        tdr.replay_add_many(spec, state, stack_blocks(
            [make_synthetic_block(spec, rng) for _ in range(4)]))
        shards.append(dp_check.numpy_state(state))
    net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, cpu)
    params = {n: v.numpy() for n, v in net.init(0).state_dict().items()}
    k, dispatches = 2, 1        # two steps: phase 4's horizon
    case = {"spec": dataclasses.asdict(spec), "action_dim": 18,
            "network": dataclasses.asdict(cfg.network),
            "optim": dataclasses.asdict(cfg.optim), "params": params,
            "shards": shards, "k": k, "dispatches": dispatches,
            "jitter": rng.random((2, dispatches, k, spec.batch_size),
                                 dtype=np.float32),
            "diag": {"interval": 2, "dq_batch": 4},
            "rdiag": {"interval": 1, "lanes": 4}}
    t0 = time.perf_counter()
    # the two worlds at once: four spawned ranks, two rendezvous
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        card, cpu_runs = pool.map(lambda names: _dp_check_case(names, case),
                                  ([str(dev)] * 2, ["cpu"] * 2))
    check(card[0]["digest"] == card[1]["digest"],
          "11b: the card ranks' train states differ")
    check(not card[0]["graphed"], "11b: a gloo step claims a graph")
    worst = {"loss": 0.0, "grad_norm": 0.0, "tree": 0.0, "params": 0.0}
    for r in range(2):
        for d in range(dispatches):
            got, want = card[r]["trace"][d], cpu_runs[r]["trace"][d]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
            np.testing.assert_allclose(got["tree"], want["tree"], rtol=1e-4,
                                       atol=1e-6)
            for name in ("loss", "grad_norm"):
                worst[name] = max(worst[name], float(np.max(
                    np.abs(got[name] - want[name]) / np.abs(want[name]))))
            worst["tree"] = max(worst["tree"], float(np.max(
                np.abs(got["tree"] - want["tree"]))))
            worst["params"] = max(worst["params"], max(
                float(np.max(np.abs(v - want["params"][n])))
                for n, v in got["params"].items()))
        for d in range(dispatches):
            worst["diag"] = max(worst.get("diag", 0.0), _diag_match(
                card[r]["trace"][d]["diag"], cpu_runs[r]["trace"][d]["diag"],
                f"11b rank {r}", rtol=1e-3))
            check(card[r]["trace"][d]["diag"]["rd/shard_tree_moments"]
                  .shape == (k, 2, 5), "11b: rd/shard_* without the dp axis")
            for key, v in card[r]["trace"][d]["diag"].items():
                check(np.array_equal(v, card[0]["trace"][d]["diag"][key],
                                     equal_nan=True),
                      f"11b: {key} differs between the card ranks")
        want_launches = _want_launches({"network.pallas_lstm": "on"},
                                       k * dispatches,
                                       _dq_steps(0, k * dispatches, 2))
        check(card[r]["launches"] == want_launches,
              f"11b rank {r}: launches {card[r]['launches']}")
        check(not any(cpu_runs[r]["launches"].values()),
              "11b: a CPU rank launched a kernel")
    print(f"11b two gloo ranks on one card vs two CPU ranks (small f32, "
          f"K={k} x {dispatches}): losses max rel {worst['loss']:.3e}, "
          f"grad norms max rel {worst['grad_norm']:.3e}, tree max abs "
          f"{worst['tree']:.3e}, params max abs "
          f"{worst['params']:.3e}, diagnostics max rel "
          f"{worst['diag']:.3e}; card ranks bit-equal; "
          f"{time.perf_counter() - t0:.1f} s (spawn included)", flush=True)


def _dp_children() -> list:
    import multiprocessing as mp
    return [p for p in mp.active_children() if p.name.startswith("dp-rank")]


def phase_dp_loop(dev, label: str, args) -> dict:
    """Phase 11(c): orchestrator.train with mesh.dp=2, both ranks on the
    card over gloo (mesh_devices, mesh_backend), for DP_SECONDS at the
    reference widths: losses finite on cuda, both ranks at the same step
    with bit-equal train states, the blocks round-robined (actor-fed:
    shard counts differ by <= 1; on-device: equal), each rank's kernel
    launches those of its steps, an on-device run's anakin blocks with
    dp 2 and imbalance 1.0, and no rank process left. Returns the launch
    counts summed over the ranks."""
    import tempfile
    import torch
    from r2d2_tpu_torch.config import (Config, parse_overrides,
                                       resolve_pallas_lstm)
    from r2d2_tpu_torch.runtime import orchestrator
    records = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        cfg = parse_overrides(Config(), [
            "--env.game_name=Fake", "--replay.capacity=100000",
            "--mesh.dp=2", "--runtime.save_interval=0",
            "--runtime.log_interval=5", f"--runtime.save_dir={d}", *args])
        marks = []

        def hook(stack):
            # rank 0's dispatches, each ending on the host: gloo's
            # all-reduce on CUDA tensors waits for its copy back
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), stack.learner.training_steps))

        _reset_counts()
        t0 = time.perf_counter()
        stack = orchestrator.train(
            cfg, max_seconds=DP_SECONDS, actor_mode="thread", device=dev,
            log_fn=records.append, dispatch_hook=hook,
            mesh_devices=[dev, dev], mesh_backend="gloo")
        seconds = time.perf_counter() - t0
    learner = stack.learner
    losses = learner.losses
    reports = learner.shard_reports
    check(learner.device.type == "cuda" and losses
          and all(math.isfinite(x) for x in losses),
          f"11c {label}: no finite losses on cuda")
    check(len(reports) == 2 and reports[0]["steps"] == reports[1]["steps"]
          == learner.training_steps, f"11c {label}: steps {reports}")
    check(reports[0]["state_sha256"] == reports[1]["state_sha256"],
          f"11c {label}: the ranks' train states differ")
    blocks = [r["shard_blocks"] for r in reports]
    check(abs(blocks[0] - blocks[1]) <= (0 if cfg.actor.on_device else 1)
          and min(blocks) > 0, f"11c {label}: shard blocks {blocks}")
    check(not _dp_children(), f"11c {label}: a rank is still running")
    total = {k: sum(r["launches"][k] for r in reports)
             for k in reports[0]["launches"]}
    overrides = {"network.use_double": cfg.network.use_double,
                 "network.pallas_lstm": "on" if resolve_pallas_lstm(
                     cfg.network.pallas_lstm, dev) else "off"}
    for r in reports:
        check(r["launches"] == _want_launches(overrides, r["steps"],
                                              _dq_steps(0, r["steps"])),
              f"11c {label} rank {r['rank']}: launches {r['launches']} for "
              f"{r['steps']} steps")
    anakin = [x["anakin"] for x in records if x.get("anakin")]
    if cfg.actor.on_device:
        check(anakin and all(a["dp"] == 2 and a["shard_imbalance"] == 1.0
                             for a in anakin),
              f"11c {label}: anakin blocks {anakin}")
    check(len(marks) >= 3, f"11c {label}: {len(marks)} dispatches")
    (ta, sa), (tb, sb) = marks[1], marks[-1]
    report = {"steps": learner.training_steps, "run_s": seconds,
              "first_dispatch_s": marks[0][0] - t0,
              "window_s": tb - ta, "window_steps": sb - sa,
              "ms_per_step": (tb - ta) * 1e3 / (sb - sa),
              "global_seq_updates_per_s": (2 * cfg.replay.batch_size
                                           * (sb - sa) / (tb - ta)),
              "shard_blocks": blocks, "env_steps": learner.env_steps,
              "final_loss": losses[-1], "launches_all_ranks": total,
              "anakin": anakin[-1] if anakin else None}
    print(f"11c two Learner ranks on one card over gloo ({label}, "
          f"{_card()}): " + json.dumps(report), flush=True)
    return total


def phase_data_parallel(dev, ref_blocks) -> dict:
    """Phase 11 (see the module docstring), with 12(b)'s worlds run beside
    11(b)'s (both card = CPU checks of gloo ranks, no timing held): the
    reference replay refilled from the first phases' blocks
    (``ref_blocks``). Returns the launch counts of the sharded paths:
    "nccl" (11a's graphed step), "loop" (11c's runs, every rank), and
    12(b)'s card ranks' ("mh_card")."""
    import torch
    base, spec, rs, _ = phase_reference_replay(dev, ref_blocks)
    nccl = _timed("11a", phase_dp_nccl, dev, base, spec, rs)
    del rs
    torch.cuda.empty_cache()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gloo = pool.submit(_timed, "11b", phase_dp_gloo_card_vs_cpu, dev)
        mh_card = pool.submit(_timed, "12b", phase_mh_card_vs_cpu, dev)
        gloo.result()
        mh_card = mh_card.result()
    loop = dict.fromkeys(nccl, 0)
    for label, args in (("thread actors, pallas_lstm on, double DQN",
                         FUSED_ARGS),
                        ("on-device acting", ANAKIN_ARGS)):
        for k, n in _timed(f"11c {label}", phase_dp_loop, dev, label,
                           args).items():
            loop[k] += n
    return {"nccl": nccl, "loop": loop, "mh_card": mh_card}


MH_K = 4                           # 12(a)'s steps a dispatch
MH_SECONDS = 16.0                  # 12(a)'s one-controller run
MH_SNAPSHOT_INTERVAL = 512         # 12(a)'s replay snapshots (the twin)
MH_SYNC_EVERY = 8                  # 12(a): dispatches between synced marks
MH_HOST_STEPS = 3                  # 12(a): host-placement graph vs eager
MH_RUN_S = 24.0                    # each 12(c) run, from its first steps
MH_START_S = 150.0                 # 12(c): the controllers' start-up bound
MH_COLLECTIVE_S = 120.0            # 12(c): a collective's wait


def _mh_mesh(dev):
    from r2d2_tpu_torch.config import MeshConfig
    from r2d2_tpu_torch.parallel.mesh import init_distributed
    return init_distributed(MeshConfig(multihost=True), dev, "nccl")


def phase_mh_core_graph(dev) -> None:
    """Phase 12(a), first part: the lockstep core of one controller (an
    NCCL world of one) at the reference shape (bf16, bench's "fused"
    path, K=MH_K), fed the same four blocks and jitter twice: with the
    sharded step (one CUDA graph of K steps, the hook's all-reduce inside)
    and with its eager twin (the same body and hook, no graph). Three
    dispatches (the graph's eager warm-up, its capture, a replay): losses,
    grad norms, params and the shard's tree bit-equal, the gate and the
    counters equal."""
    import torch
    from r2d2_tpu_torch.learner.train_step import (_make_step_body,
                                                   create_train_state,
                                                   eager_steps)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.parallel.mesh import close_mesh
    from r2d2_tpu_torch.parallel.multihost import LockstepCore
    from r2d2_tpu_torch.parallel.sharded import (GradMean,
                                                 make_sharded_learner_step,
                                                 sharded_replay_init)
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**bench.PATHS["fused"])
    spec = ReplaySpec.from_config(cfg, dev)
    blocks = bench.synthetic_blocks(cfg, 4, seed=12)
    mesh = _mh_mesh(dev)
    try:
        net = NetworkApply(bench.ACTION_DIM, cfg.network,
                           cfg.env.frame_stack, cfg.env.frame_height,
                           cfg.env.frame_width, dev)
        use_double = cfg.network.use_double
        graph_step = make_sharded_learner_step(net, spec, cfg.optim,
                                               use_double, mesh, MH_K)
        check(graph_step.graphed, "12a: NCCL step is not a graph")
        reduce = GradMean(mesh)
        ts_eager = create_train_state(net, cfg.optim, 0, use_double)
        reduce.attach(ts_eager.params)
        cores = {
            "graph": LockstepCore(
                mesh, create_train_state(net, cfg.optim, 0, use_double),
                graph_step, MH_K, learning_starts=cfg.replay.learning_starts,
                ratio=0.0, rs=sharded_replay_init(spec, mesh), spec=spec),
            "eager": LockstepCore(
                mesh, ts_eager, eager_steps(_make_step_body(
                    net, spec, cfg.optim, use_double, reduce=reduce), MH_K),
                MH_K, learning_starts=cfg.replay.learning_starts, ratio=0.0,
                rs=sharded_replay_init(spec, mesh), spec=spec)}
        uniforms = torch.rand((5, MH_K, spec.batch_size),
                              generator=torch.Generator().manual_seed(12)
                              ).to(dev)
        script = blocks + [None]          # ready at the third block
        dispatches = 0
        for it, block in enumerate(script):
            out = {n: c.iterate(block, 0, uniforms[it])
                   for n, c in cores.items()}
            check(out["graph"]["info"] == out["eager"]["info"]
                  and out["graph"]["stepped"] == out["eager"]["stepped"],
                  f"12a iteration {it}: {out}")
            if not out["graph"]["stepped"]:
                continue
            dispatches += 1
            g, e = out["graph"]["metrics"], out["eager"]["metrics"]
            for metric in ("loss", "grad_norm", "mean_q"):
                check(torch.equal(g[metric], e[metric]),
                      f"12a dispatch {dispatches}: {metric} "
                      f"{g[metric].tolist()} vs {e[metric].tolist()}")
            for (pn, p), q in zip(
                    cores["graph"].ts.params.named_parameters(),
                    cores["eager"].ts.params.parameters()):
                check(torch.equal(p, q), f"12a: param {pn} differs")
            check(torch.equal(cores["graph"].rs.tree,
                              cores["eager"].rs.tree), "12a: tree differs")
        check(dispatches == 3, f"12a: {dispatches} dispatches")
        check(getattr(graph_step._dispatch, "graph", None) is not None,
              "12a: the sharded step captured no graph")
        print(f"12a lockstep core, one NCCL controller, reference shape, "
              f"fused K={MH_K}: {dispatches} dispatches graph = eager twin "
              f"bit for bit (losses {g['loss'].tolist()}), the K-step "
              f"graph captured whole with the all-reduce inside", flush=True)
        del cores, graph_step, reduce, ts_eager
        torch.cuda.synchronize()
    finally:
        close_mesh()


def phase_mh_host_graph(dev) -> dict:
    """Phase 12(a), host placement: one controller's sharded external-batch
    step (an NCCL world of one, the reference shape, bench's "host" path),
    one CUDA graph of the step with BatchMean's weighted all-reduce
    inside, against its eager twin (make_external_batch_step with the
    same hook, graphed=False) on the same MH_HOST_STEPS host-sampled
    batches (the graph's eager warm-up, its capture, a replay): losses,
    grad norms, mean Q, priorities and params bit-equal, each kernel of
    the host path launched once a step on each side. Returns the
    launches."""
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.parallel.mesh import close_mesh
    from r2d2_tpu_torch.parallel.sharded import (
        BatchMean, make_sharded_external_batch_step)
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**bench.PATHS[bench.HOST_PATH])
    spec = ReplaySpec.from_config(cfg, dev)
    batches = _host_batches(cfg, bench.synthetic_blocks(cfg, 4, seed=13),
                            MH_HOST_STEPS, seed=13)
    mesh = _mh_mesh(dev)
    try:
        net = NetworkApply(bench.ACTION_DIM, cfg.network,
                           cfg.env.frame_stack, cfg.env.frame_height,
                           cfg.env.frame_width, dev)
        use_double = cfg.network.use_double
        graph_step = make_sharded_external_batch_step(
            net, spec, cfg.optim, use_double, mesh)
        check(graph_step.graphed, "12a host: NCCL step is not a graph")
        reduce = BatchMean(mesh)
        ts = {name: create_train_state(net, cfg.optim, 0, use_double)
              for name in ("graph", "eager")}
        reduce.attach(ts["eager"].params)
        steps = {"graph": graph_step,
                 "eager": make_external_batch_step(
                     net, spec, cfg.optim, use_double, reduce=reduce,
                     graphed=False)}
        _reset_counts()
        for i, batch in enumerate(batches):
            m = {}
            for name, step in steps.items():
                ts[name], m[name] = step(ts[name], _device_batch(batch, dev))
            for metric in ("loss", "grad_norm", "mean_q", "priorities"):
                check(torch.equal(m["graph"][metric], m["eager"][metric]),
                      f"12a host step {i}: {metric} "
                      f"{m['graph'][metric].float().max().item()} vs "
                      f"{m['eager'][metric].float().max().item()}")
            for (pn, p), q in zip(ts["graph"].params.named_parameters(),
                                  ts["eager"].params.parameters()):
                check(torch.equal(p, q), f"12a host step {i}: param {pn} "
                      "differs")
        counted = _counts()
        want = {n: 2 * c for n, c in
                _want_host_launches(cfg, MH_HOST_STEPS).items()}
        check(counted == want, f"12a host: launches {counted}, want {want}")
        check(graph_step._step.graph is not None
              and ts["graph"].step == ts["eager"].step == MH_HOST_STEPS,
              "12a host: the sharded external step captured no graph")
        print(f"12a host placement, one NCCL controller, reference shape: "
              f"{MH_HOST_STEPS} sharded external-batch steps graph = eager "
              f"twin bit for bit (loss {m['graph']['loss'].item()}), the "
              f"step's graph captured with BatchMean's all-reduce inside",
              flush=True)
        del steps, graph_step, reduce, ts, m
        torch.cuda.synchronize()
    finally:
        close_mesh()
    return counted


def phase_mh_one_controller(dev, bench_fused: float) -> dict:
    """Phase 12(a), second part: train_multihost as a job of one
    controller on the card (NCCL world of one), reference widths, thread
    actors, bench's "fused" path, K=MH_K, replay snapshots every
    MH_SNAPSHOT_INTERVAL steps (the rank-0 twin), for MH_SECONDS:
    finite losses, launches those of its steps, seq-updates/s over a
    synced window (a sync every MH_SYNC_EVERY dispatches) beside bench
    ``fused`` K=4 of this call, the host ms of an iteration's all-reduce,
    and the twin's snapshot written and loaded into a fresh replay.
    Returns the run's launch counts."""
    import tempfile
    import torch
    from r2d2_tpu_torch.parallel.multihost import train_multihost
    from r2d2_tpu_torch.replay.device_replay import replay_init
    from r2d2_tpu_torch.replay.snapshot import load_snapshot, restore_plain
    from r2d2_tpu_torch.replay.structs import ReplaySpec, RingAccountant
    from r2d2_tpu_torch.tools import bench
    marks = []

    def hook(core):
        if not marks or (core.ts.step // MH_K) % MH_SYNC_EVERY == 0:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), core.ts.step))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as d:
        cfg = bench.reference_config(**bench.PATHS["fused"], **{
            "mesh.multihost": True, "runtime.steps_per_dispatch": MH_K,
            "runtime.snapshot_interval": MH_SNAPSHOT_INTERVAL,
            "runtime.save_interval": 0, "runtime.log_interval": 5.0,
            "runtime.save_dir": d})
        _reset_counts()
        t0 = time.perf_counter()
        out = train_multihost(cfg, max_seconds=MH_SECONDS,
                              actor_mode="thread", device=dev,
                              backend="nccl", dispatch_hook=hook)
        seconds = time.perf_counter() - t0
        counted = _counts()
        snap = load_snapshot(d, 0)
        check(snap is not None and snap["kind"] == "plain"
              and snap["step"] == out["step"],
              f"12a: the twin's snapshot {snap and snap.get('step')}")
        spec = ReplaySpec.from_config(cfg, dev)
        ring = RingAccountant(spec.num_blocks)
        restore_plain(spec, replay_init(spec, dev), ring, snap)
        check(ring.total_adds == out["shard_blocks"] > 0,
              f"12a: the snapshot holds {ring.total_adds} adds")
        del snap
    losses = out["losses"]
    check(out["graphed"] and losses and all(math.isfinite(x)
                                            for x in losses),
          "12a: no finite losses from the graphed step")
    want = _want_launches(bench.PATHS["fused"], out["step"],
                          _dq_steps(0, out["step"]))
    check(counted == want, f"12a: launches {counted}, want {want}")
    check(len(marks) >= 3, f"12a: {len(marks)} synced marks")
    (ta, sa), (tb, sb) = marks[1], marks[-1]
    rate = cfg.replay.batch_size * (sb - sa) / (tb - ta)
    coll = out["collective_ms"]
    report = {"k": MH_K, "steps": out["step"], "run_s": seconds,
              "window_steps": sb - sa, "window_s": tb - ta,
              "seq_updates_per_s": rate, "bench_fused_k4": bench_fused,
              "over_bench": rate / bench_fused,
              "iterations": out["iterations"],
              "collective_ms_median": statistics.median(coll),
              "collective_ms_p90": sorted(coll)[int(0.9 * (len(coll) - 1))],
              "shard_blocks": out["shard_blocks"],
              "snapshot_step": out["step"], "final_loss": losses[-1]}
    print(f"12a one controller (NCCL world of one, {_card()}): "
          + json.dumps(report), flush=True)
    return counted


def phase_mh_card_vs_cpu(dev) -> dict:
    """Phase 12(b): the scripted lockstep core (tools/mh_check.py
    rank_core: ingest, gate, one K=2 dispatch, stop) at the small f32
    shape with pallas_lstm on, two gloo ranks sharing the card against two
    CPU ranks on the same blocks, weights and jitter: every iteration's
    counters equal, losses and each shard's tree within rtol 1e-4 (phase
    4's rule, its two steps), the card ranks bit-equal, every kernel of
    the path launched on them and none on the CPU's. Returns the card
    ranks' launches."""
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    from r2d2_tpu_torch.tools import mh_check
    cfg = _tiny_config().replace(**{"network.pallas_lstm": "on"})
    cpu = torch.device("cpu")
    spec = ReplaySpec.from_config(cfg, cpu)
    rng = np.random.default_rng(12)
    pattern = [(0,), (1,), (0, 1), (0, 1)]       # ready at iteration 2
    arrivals = [[[make_synthetic_block(spec, rng)] if r in ranks else []
                 for r in range(2)] for ranks in pattern]
    stops = [[0, 0], [0, 0], [0, 0], [1, 0]]
    net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, cpu)
    k = 2
    case = {"spec": dataclasses.asdict(spec), "action_dim": 18,
            "network": dataclasses.asdict(cfg.network),
            "optim": dataclasses.asdict(cfg.optim),
            "params": {n: v.numpy()
                       for n, v in net.init(0).state_dict().items()},
            "k": k, "arrivals": arrivals, "stops": stops,
            "jitter": rng.random((2, 1, k, spec.batch_size),
                                 dtype=np.float32),
            "learning_starts": 60, "ratio": 0.0}
    t0 = time.perf_counter()

    def world(names):
        return run_ranks(mh_check.rank_core, 2, case, devices=names,
                         backend="gloo", timeout_s=300)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        card, cpu_runs = pool.map(world, ([str(dev)] * 2, ["cpu"] * 2))
    check(card[0]["digest"] == card[1]["digest"],
          "12b: the card ranks' train states differ")
    worst = {"loss": 0.0, "tree": 0.0}
    want = _want_launches({"network.pallas_lstm": "on"}, k)
    for r in range(2):
        got, ref = card[r], cpu_runs[r]
        check(got["stopped_at"] == ref["stopped_at"] == 3
              and len(got["dispatches"]) == len(ref["dispatches"]) == 1,
              f"12b rank {r}: stopped at {got['stopped_at']}, "
              f"{len(got['dispatches'])} dispatches")
        check([t["info"] for t in got["trace"]]
              == [t["info"] for t in ref["trace"]], f"12b rank {r}: info")
        g, c = got["dispatches"][0], ref["dispatches"][0]
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["tree"], c["tree"], rtol=1e-4,
                                   atol=1e-6)
        worst["loss"] = max(worst["loss"], float(np.max(
            np.abs(g["loss"] - c["loss"]) / np.abs(c["loss"]))))
        worst["tree"] = max(worst["tree"], float(np.max(
            np.abs(g["tree"] - c["tree"]))))
        check(got["launches"] == want, f"12b rank {r}: launches "
              f"{got['launches']}, want {want}")
        check(not any(ref["launches"].values()),
              "12b: a CPU rank launched a kernel")
    print(f"12b scripted lockstep core, two gloo ranks on one card vs two "
          f"CPU ranks (small f32, pallas_lstm on, K={k}): losses max rel "
          f"{worst['loss']:.3e}, tree max abs {worst['tree']:.3e}; card "
          f"ranks bit-equal, both stopped at iteration 3; "
          f"{time.perf_counter() - t0:.1f} s (spawn included)", flush=True)
    return {n: sum(card[r]["launches"][n] for r in range(2))
            for n in want}


def _mh_training_steps(save_dir: str) -> int:
    """Rank 0's newest logged learner steps (0 before its first record)."""
    path = os.path.join(save_dir, "metrics_player0.jsonl")
    try:
        with open(path) as f:
            lines = f.read().strip().splitlines()
    except OSError:
        return 0
    return json.loads(lines[-1])["training_steps"] if lines else 0


def phase_mh_loop(label: str, placement: str, overrides) -> dict:
    """Phase 12(c): two controllers, each its own interpreter started by
    the port's launcher (parallel/multihost.py ControllerProcesses), both
    on the card over gloo, reference widths, two thread actors each; once
    rank 0 has logged learner steps, MH_RUN_S seconds of training, then
    SIGTERM to controller 1. Both exit 0 on the same iteration at the same
    step with bit-equal train states (controller 1 names the signal),
    each shard took blocks from its own actors, each controller's launches
    those of its steps, no process left. Returns both controllers'
    launches."""
    import signal
    import tempfile
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.parallel.multihost import (ControllerProcesses,
                                                   demo_argv, read_digests)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as d:
        # a record a second: the first learner steps show within one
        argv_of = demo_argv(2, d, max_steps=0,
                            max_seconds=MH_START_S + 2 * MH_RUN_S,
                            placement=placement, device="cuda",
                            backend="gloo", reference=True, threads=2,
                            collective_timeout=MH_COLLECTIVE_S,
                            overrides=["--runtime.log_interval=1",
                                       *overrides])
        t0 = time.perf_counter()
        with ControllerProcesses(argv_of, 2) as ctl:
            while _mh_training_steps(d) == 0:
                check(all(p.poll() is None for p in ctl.procs),
                      f"12c {label}: a controller exited early "
                      f"{[p.poll() for p in ctl.procs]}")
                check(time.perf_counter() - t0 < MH_START_S,
                      f"12c {label}: no learner steps in {MH_START_S} s")
                time.sleep(0.5)
            t_train = time.perf_counter()
            while time.perf_counter() - t_train < MH_RUN_S:
                check(all(p.poll() is None for p in ctl.procs),
                      f"12c {label}: a controller exited mid-run")
                time.sleep(0.5)
            ctl.procs[1].send_signal(signal.SIGTERM)
            rcs = ctl.wait(time.monotonic() + 90.0)
        seconds = time.perf_counter() - t0
        check(rcs == [0, 0], f"12c {label}: exit codes {rcs}")
        check(all(p.poll() is not None for p in ctl.procs),
              f"12c {label}: a controller is still running")
        recs = read_digests(d, 2)
        # rank 0's stages ride its record, rank 1's its host rows
        telemetry = {
            "rank0": _check_stage_records(
                _read_jsonl(os.path.join(d, "metrics_player0.jsonl")),
                f"12c {label} rank 0", HOST_ROW_STAGES,
                [os.path.join(d, "spans_host0.jsonl")], costs=False),
            "rank1": _check_stage_records(
                _read_jsonl(os.path.join(d, "telemetry_host1.jsonl")),
                f"12c {label} rank 1's host rows", HOST_ROW_STAGES,
                [os.path.join(d, "spans_host1.jsonl")], costs=False)}
        # each controller its own resources and alerts: rank 0's on its
        # record, rank 1's on its host rows (firings to alerts_host1). The
        # records come every second (the start poll reads them): under
        # the lockstep's rate limiter a second can ingest nothing, which
        # the throughput-drop rules' median over 8 records flags
        ring = ("p0/replay_ring",) if placement == "device" else ()
        noisy = ("env_throughput_drop", "learner_throughput_drop")
        telemetry["health"] = {
            "rank0": _check_health_records(
                _read_jsonl(os.path.join(d, "metrics_player0.jsonl")),
                f"12c {label} rank 0", None,
                os.path.join(d, "alerts_player0.jsonl"), captures=False,
                names=("p0/train_state",) + ring, noisy=noisy),
            "rank1": _check_health_records(
                _read_jsonl(os.path.join(d, "telemetry_host1.jsonl")),
                f"12c {label} rank 1's host rows", None,
                os.path.join(d, "alerts_host1.jsonl"), captures=False,
                names=("p0/train_state",) + ring, noisy=noisy)}
    check(recs[0]["step"] == recs[1]["step"] > 0
          and recs[0]["iterations"] == recs[1]["iterations"]
          and recs[0]["digest"] == recs[1]["digest"],
          f"12c {label}: steps {[r['step'] for r in recs]}, iterations "
          f"{[r['iterations'] for r in recs]}, digests differ or not")
    check([r["stop_reason"] for r in recs] == ["", "signal"],
          f"12c {label}: stop reasons {[r['stop_reason'] for r in recs]}")
    check(all(r["shard_blocks"] > 0 for r in recs),
          f"12c {label}: shard blocks {[r['shard_blocks'] for r in recs]}")
    check(recs[0]["losses_finite"] and recs[0]["device"].startswith("cuda"),
          f"12c {label}: losses not finite on cuda")
    cfg = parse_overrides(Config(), list(overrides))
    for r in recs:
        want = (_want_host_launches(cfg, r["step"]) if placement == "host"
                else _want_launches({"network.use_double":
                                     cfg.network.use_double,
                                     "network.pallas_lstm": "on"},
                                    r["step"], _dq_steps(0, r["step"])))
        check(r["launches"] == want, f"12c {label} rank {r['rank']}: "
              f"launches {r['launches']}, want {want}")
    check(len(recs[0]["dispatch_marks"]) == 2,
          f"12c {label}: dispatch marks {recs[0]['dispatch_marks']}")
    (ta, sa), (tb, sb) = recs[0]["dispatch_marks"]
    batch = cfg.replay.batch_size * (2 if placement == "device" else 1)
    report = {"steps": recs[0]["step"], "run_s": seconds,
              "iterations": recs[0]["iterations"],
              "window_steps": sb - sa, "window_s": tb - ta,
              "ms_per_step": (tb - ta) * 1e3 / max(sb - sa, 1),
              "global_seq_updates_per_s": batch * (sb - sa) / (tb - ta),
              "global_batch": batch,
              "shard_blocks": [r["shard_blocks"] for r in recs],
              "local_env_steps": [r["local_env_steps"] for r in recs],
              "collective_ms_median": [r["collective_ms_median"]
                                       for r in recs],
              "telemetry": telemetry}
    print(f"12c two controllers sharing one card over gloo ({label}, "
          f"{_card()}; gloo staging through one host, not scaling): "
          + json.dumps(report), flush=True)
    return {n: sum(r["launches"][n] for r in recs)
            for n in recs[0]["launches"]}


def phase_multihost(dev, bench_fused: float, mh_card: dict) -> dict:
    """Phase 12 (see the module docstring; 12(b) ran beside 11(b), its
    card ranks' launches ``mh_card``). Returns the launch counts of every
    part, every controller."""
    total = dict.fromkeys(_counts(), 0)

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    _reset_counts()
    _timed("12a core graph", phase_mh_core_graph, dev)
    add(_counts())
    add(_timed("12a host graph", phase_mh_host_graph, dev))
    add(_timed("12a one controller", phase_mh_one_controller, dev,
               bench_fused))
    add(mh_card)
    add(_timed("12c device", phase_mh_loop,
               "device placement, fused_double", "device",
               ["--network.use_double=true", "--network.pallas_lstm=on"]))
    add(_timed("12c host", phase_mh_loop, "host placement, pallas_lstm on",
               "host", ["--network.pallas_lstm=on"]))
    return total


TP_STEPS = 3                       # 13(a), (b), (c): steps of each world
# 13(a) and (c): both diagnostics, dQ and the target distance at step 2,
# a tree snapshot every step
TP_DIAG = {"diag": {"interval": 2, "dq_batch": 16},
           "rdiag": {"interval": 1, "lanes": 4}}
TP_HOST_BLOCKS = 8                 # 13(a), (b): blocks of the host replay
# 13(a)'s tolerance (PERF.md's predictions): the TP step in bf16 against
# the unsharded one. Column-parallel layers may take other cuDNN/cuBLAS
# algorithms (another f32 sum order, a bf16 ulp of 2^-8 in an output now
# and then) and the partial input gradients are rounded to bf16 before
# their sum. Adam moves an element at most ~lr (1e-4) a step whatever its
# gradient, so a bound on the params alone would pass any backward: the
# backward is held by "update_rel", each leaf's update over the steps
# (final - initial params) against the unsharded update, relative in L2
# norm, the largest over the leaves. A negative control (the row's partial
# input gradients left unsummed, tools/dp_check.py rank_tp_external) must
# exceed it.
TP_REF_TOL = {"loss_rel": 2e-3, "params_abs": 1e-4, "update_rel": 3e-2,
              "priorities_rel": 5e-2, "priorities_abs": 1e-3}
DPMP_BLOCKS = 4                    # 13(c): blocks a shard (reduced depth)
SP_SHAPE = (5, 4, 55, 128, 512)    # 13(d): stages, microbatches, T, B, H
SP_ATOL = 2e-6                     # 13(d): f32, the fused scan's bound
SNAP_CAPACITY = 4000               # 13(e): 10 reference blocks a shard
# 13(a), ROADMAP C.5: the TP step's f32 gradients before the clip against
# the unsharded step's, each leaf's relative L2 distance
C5_GRAD_REL = 1e-5
PHASE13_TIMEOUT_S = 400.0          # a world's deadline


def _ranks(fn, dp, *args, devices, mp=1):
    """``fn(mesh, *args)`` on dp x mp gloo ranks on ``devices``."""
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    return run_ranks(fn, dp, *args, mp=mp, devices=devices, backend="gloo",
                     timeout_s=PHASE13_TIMEOUT_S)


def _sum_launches(outs) -> dict:
    return {k: sum(o["launches"][k] for o in outs) for k in _counts()}


def _tp_case(cfg, msw: int, **extra) -> dict:
    import dataclasses
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    return {"spec": dataclasses.asdict(spec), "action_dim": bench.ACTION_DIM,
            "network": dataclasses.asdict(cfg.network),
            "optim": dataclasses.asdict(cfg.optim), "init_seed": 0,
            "min_shard_width": msw, **extra}


def _check_half_features(outs, full: dict, label: str) -> str:
    """The largest sharded leaf (of ``full``: name -> full shape) holds
    half its features on every rank."""
    import math
    sharded = [n for n, s in outs[0]["shapes"].items()
               if tuple(s) != tuple(full[n])]
    check(sharded, f"{label}: no leaf sharded")
    largest = max(sharded, key=lambda n: math.prod(full[n]))
    for o in outs:
        check(2 * math.prod(o["shapes"][largest]) == math.prod(full[largest]),
              f"{label}: {largest} holds {o['shapes'][largest]} of "
              f"{tuple(full[largest])}")
    return f"{largest} {tuple(full[largest])} -> {outs[0]['shapes'][largest]}"


def _update_rel(final, init, want) -> tuple:
    """The largest relative L2 distance over the leaves between the update
    ``final - init`` and ``want - init``, and its leaf."""
    import numpy as np
    worst, leaf = 0.0, None
    for name in want:
        du = np.asarray(final[name], np.float64) - init[name]
        dw = np.asarray(want[name], np.float64) - init[name]
        ref = float(np.linalg.norm(dw))
        rel = float(np.linalg.norm(du - dw)) / max(ref, 1e-30)
        if rel > worst or leaf is None:
            worst, leaf = rel, name
    return worst, leaf


def _tp_f32_gradients(dev, cfg32, out: dict) -> dict:
    """13a's C.5 check (ROADMAP C.5): the unsharded f32 external step on
    the card from the same weights (seed 0) on the first of the same host
    batches, its gradients before the clip (``dp_check.pre_clip_gradients``)
    against the ranks' ``f32_grads`` (the TP step's, gathered over the
    row): each leaf's relative L2 distance held to C5_GRAD_REL."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec, SampleBatch
    from r2d2_tpu_torch.tools import bench, dp_check
    net = NetworkApply(bench.ACTION_DIM, cfg32.network,
                       cfg32.env.frame_stack, cfg32.env.frame_height,
                       cfg32.env.frame_width, dev)
    ts = create_train_state(net, cfg32.optim, 0, True)
    step = make_external_batch_step(net, ReplaySpec.from_config(cfg32, dev),
                                    cfg32.optim, True, graphed=False)
    spec = ReplaySpec.from_config(cfg32, torch.device("cpu"))
    fields = dp_check.host_batches(spec, TP_HOST_BLOCKS, TP_STEPS, 13)[0]
    taps: list = []
    with dp_check.pre_clip_gradients(taps):
        ts, m = step(ts, SampleBatch(**{n: torch.from_numpy(a).to(dev)
                                        for n, a in fields.items()}))
    want = {name: g.double().cpu().numpy() for (name, _), g in
            zip(ts.params.named_parameters(), taps[0])}
    got = out["f32_grads"]
    rel = {name: float(np.linalg.norm(got[name] - w))
           / max(float(np.linalg.norm(w)), 1e-30) for name, w in want.items()}
    worst = max(rel, key=rel.get)
    loss = float(m["loss"])
    report = {"loss_rel": abs(float(out["f32_grad_loss"]) - loss) / abs(loss),
              "grad_rel_max": rel[worst], "grad_rel_leaf": worst,
              "grad_rel_recurrent_kernel": rel["lstm.recurrent_kernel"],
              "grad_rel": rel, "bound": C5_GRAD_REL}
    check(rel[worst] <= C5_GRAD_REL,
          f"13a C.5: the TP step's f32 gradient of {worst} is {rel[worst]} "
          f"(relative L2) off the unsharded step's, bound {C5_GRAD_REL}")
    return report


def phase_tp_reference(dev) -> dict:
    """Phase 13(a): the tensor-parallel host-batch step at the reference
    shape (B=128, 55-step windows, 84x84x4, cnn 1024, LSTM 512, dueling,
    bf16, the fused scan with double DQN), dp=1 x mp=2: two gloo ranks
    sharing the card against the unsharded external step on the card in
    this process, from the same weights (seed 0) and host-sampled
    batches, TP_STEPS steps: losses, priorities, the final params and each
    leaf's update within TP_REF_TOL, the ranks' full params bit-equal, the
    largest sharded leaf half on each rank, each rank's launches those of
    its steps (K3, K4, K4 lean, K5; no gather: the host samples). The
    same ranks then repeat the steps with the row's partial input
    gradients unsummed (the negative control): its update distance must
    exceed the bound. Then the same ranks take the first step again in
    f32 (network.bf16 off, no diagnostics), their gradients before the
    clip gathered over the row and held per leaf to C5_GRAD_REL against
    the unsharded f32 step's (ROADMAP C.5: whether anything but rounding
    separates the two steps). Returns the ranks' launches (the bf16
    steps')."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec, SampleBatch
    from r2d2_tpu_torch.tools import bench, dp_check
    import dataclasses
    cfg = bench.reference_config(**{
        **bench.PATHS["fused_double"],
        "replay.capacity": TP_HOST_BLOCKS * 400})
    cfg32 = cfg.replace(**{"network.bf16": "off"})
    case = _tp_case(cfg, 32, light=True, control=True,
                    host_batches=(TP_HOST_BLOCKS, TP_STEPS, 13),
                    f32_grads=dataclasses.asdict(cfg32.network),
                    **TP_DIAG)
    t0 = time.perf_counter()
    outs = _ranks(dp_check.rank_tp_external, 1, case,
                  devices=[str(dev)] * 2, mp=2)
    world_s = time.perf_counter() - t0
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, dev)
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    ts = create_train_state(net, cfg.optim, 0, True)
    init = {n: p.double().cpu().numpy()
            for n, p in ts.params.state_dict().items()}
    step = make_external_batch_step(net, ReplaySpec.from_config(cfg, dev),
                                    cfg.optim, True, graphed=False)
    ref, ref_s = [], []
    for fields in dp_check.host_batches(spec, TP_HOST_BLOCKS, TP_STEPS, 13):
        batch = SampleBatch(**{n: torch.from_numpy(a).to(dev)
                               for n, a in fields.items()})
        t1 = time.perf_counter()
        ts, m = step(ts, batch)
        ref.append({k: v.float().cpu().numpy() for k, v in m.items()})
        ref_s.append(time.perf_counter() - t1)
    f32 = _tp_f32_gradients(dev, cfg32, outs[0])
    worst = {"loss_rel": 0.0, "priorities_abs": 0.0, "params_abs": 0.0}
    check(outs[0]["trace"][-1]["params_sha"]
          == outs[1]["trace"][-1]["params_sha"],
          "13a: the ranks' full params differ")
    for i, want in enumerate(ref):
        got = outs[0]["trace"][i]
        rel = abs(float(got["loss"]) - float(want["loss"])) / abs(
            float(want["loss"]))
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        check(rel <= TP_REF_TOL["loss_rel"], f"13a step {i}: loss "
              f"{float(got['loss'])} vs {float(want['loss'])}")
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=TP_REF_TOL["priorities_rel"],
                                   atol=TP_REF_TOL["priorities_abs"])
        worst["priorities_abs"] = max(worst["priorities_abs"], float(
            np.max(np.abs(got["priorities"] - want["priorities"]))))
    final = outs[0]["trace"][-1]["params"]
    want_final = {n: p.float().cpu().numpy()
                  for n, p in ts.params.state_dict().items()}
    for name, p in want_final.items():
        diff = float(np.max(np.abs(final[name] - p)))
        worst["params_abs"] = max(worst["params_abs"], diff)
        check(diff <= TP_REF_TOL["params_abs"],
              f"13a: param {name} off by {diff}")
    worst["update_rel"], worst["update_rel_leaf"] = _update_rel(
        final, init, want_final)
    check(worst["update_rel"] <= TP_REF_TOL["update_rel"],
          f"13a: the update of {worst['update_rel_leaf']} off by "
          f"{worst['update_rel']} (relative L2)")
    control = {}
    control["update_rel"], control["update_rel_leaf"] = _update_rel(
        outs[0]["control_params"], init, want_final)
    check(control["update_rel"] > TP_REF_TOL["update_rel"],
          f"13a: the negative control (partial input gradients unsummed) "
          f"passes the update bound: {control}")
    largest = _check_half_features(outs, dict(net.param_specs), "13a")
    for i, t in enumerate(outs[0]["trace"]):
        d = t["diag"]
        check(all(math.isnan(float(d[f"ld/delta_q_{n}"]))
                  for n in ("stored", "zero", "recomputed"))
              and math.isfinite(float(d["ld/target_dist"]))
              == ((i + 1) % TP_DIAG["diag"]["interval"] == 0)
              and math.isfinite(float(d["ld/grad_norm_torso"])),
              f"13a step {i}: host TP diagnostics {d}")
        for key, v in d.items():
            check(np.array_equal(v, outs[1]["trace"][i]["diag"][key],
                                 equal_nan=True),
                  f"13a step {i}: {key} differs between the ranks")
    want = _want_host_launches(cfg, TP_STEPS)
    for r, o in enumerate(outs):
        check(o["launches"] == want, f"13a rank {r}: launches "
              f"{o['launches']}, want {want}")
    ms = [1e3 * t["seconds"] for t in outs[0]["trace"]]
    print(f"13a tensor parallel, host placement, dp=1 x mp=2, reference "
          f"shape bf16 (fused scan, double DQN), two gloo ranks sharing "
          f"one card vs the unsharded step on the card, both beside 13b-g "
          f"({_card()}; gloo staging through one host, not a scaling "
          f"number): "
          + json.dumps({
              "tp_ms_per_step": ms,
              "unsharded_ms_per_step": [1e3 * s for s in ref_s],
              "losses_tp": [float(t["loss"]) for t in outs[0]["trace"]],
              "losses_unsharded": [float(m["loss"]) for m in ref],
              "max_diff": worst, "tolerance": TP_REF_TOL,
              "control_unsummed_input_grads": control,
              "f32_gradients_c5": f32,
              "largest_sharded_leaf": largest,
              "launches_per_rank": outs[0]["launches"],
              "world_s": world_s}), flush=True)
    return _sum_launches(outs)


def phase_tp_card_vs_cpu(dev) -> dict:
    """Phase 13(b): the scripted TP core (tools/dp_check.py
    rank_tp_external) at the small f32 shape with the fused scan and
    double DQN, dp=2 x mp=2, min_shard_width 8: four gloo ranks on the
    card against four CPU ranks on the same weights and host batches,
    TP_STEPS steps: losses rtol 1e-5, priorities rtol 1e-4 atol 1e-6,
    every card rank's full params bit-equal; the card ranks' launches
    those of their steps, none on the CPU's (the pattern of 12b). Returns
    the card ranks' launches."""
    import concurrent.futures
    import numpy as np
    from r2d2_tpu_torch.tools import dp_check
    cfg = _tiny_config().replace(**{"network.pallas_lstm": "on",
                                    "network.use_double": True})
    case = _tp_case(cfg, 8, host_batches=(10, TP_STEPS, 5))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        card, cpu = pool.map(
            lambda names: _ranks(dp_check.rank_tp_external, 2, case,
                                 devices=names, mp=2),
            ([str(dev)] * 4, ["cpu"] * 4))
    worst = 0.0
    want = _want_host_launches(cfg, TP_STEPS)
    for r in range(4):
        for i in range(TP_STEPS):
            g, c = card[r]["trace"][i], cpu[r]["trace"][i]
            np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["priorities"], c["priorities"],
                                       rtol=1e-4, atol=1e-6)
            worst = max(worst, float(abs(g["loss"] - c["loss"])
                                     / abs(c["loss"])))
            check(g["params_sha"] == card[0]["trace"][i]["params_sha"],
                  f"13b step {i}: card rank {r}'s params differ")
        check(card[r]["launches"] == want, f"13b rank {r}: launches "
              f"{card[r]['launches']}, want {want}")
        check(not any(cpu[r]["launches"].values()),
              "13b: a CPU rank launched a kernel")
    return {"report": f"13b scripted TP core, dp=2 x mp=2, four gloo ranks "
                      f"on one card vs four CPU ranks (small f32, fused "
                      f"scan, double DQN, {TP_STEPS} steps): losses max "
                      f"rel {worst:.3e}, card ranks bit-equal; "
                      f"{time.perf_counter() - t0:.1f} s",
            "launches": _sum_launches(card)}


def _dpmp_case(seed: int = 9):
    """13(c)'s case: the reference widths in f32 with the fused scan and
    double DQN, DPMP_BLOCKS blocks a shard round-robin (the port's CPU
    replay, numpy fields), seed-0 weights, the same jitter."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.device_replay import replay_add, replay_init
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench, dp_check
    cfg = bench.reference_config(**{
        **bench.PATHS["fused_double"], "network.bf16": "off",
        "replay.capacity": DPMP_BLOCKS * 400})
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    blocks = bench.synthetic_blocks(cfg, 2 * DPMP_BLOCKS, seed=seed)
    shards = []
    for d in range(2):
        rs = replay_init(spec, torch.device("cpu"))
        for block in blocks[d::2]:
            replay_add(spec, rs, block)
        state = dp_check.numpy_state(rs)
        state["block_ptr"] = int(state["block_ptr"])
        shards.append(state)
    jitter = np.random.default_rng(seed).random(
        (2, TP_STEPS, 1, spec.batch_size), dtype=np.float32)
    return cfg, _tp_case(cfg, 32, shards=shards, jitter=jitter, k=1,
                         dispatches=TP_STEPS, light=True, **TP_DIAG)


def _dpmp_compare(mp2, mp1, net) -> dict:
    """13(c)'s checks with JAX's bounds (tests/test_parallel.py)."""
    import numpy as np
    worst = {"loss_rel": 0.0, "params_abs": 0.0, "tree_rel": 0.0}
    for r, o in enumerate(mp2):
        base = mp1[r // 2]
        check(o["replay_digest"] == mp2[(r // 2) * 2]["replay_digest"],
              f"13c rank {r}: its dp row's replay replicas differ")
        check(o["trace"][-1]["params_sha"]
              == mp2[0]["trace"][-1]["params_sha"],
              f"13c rank {r}: full params differ")
        for i in range(TP_STEPS):
            g, w = o["trace"][i], base["trace"][i]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-5)
            np.testing.assert_allclose(g["tree"], w["tree"], rtol=1e-5)
            worst["loss_rel"] = max(worst["loss_rel"], float(np.max(
                np.abs(g["loss"] - w["loss"]) / np.abs(w["loss"]))))
            worst["tree_rel"] = max(worst["tree_rel"], float(np.max(
                np.abs(g["tree"] - w["tree"]) / np.maximum(
                    np.abs(w["tree"]), 1e-30))))
    got, want = mp2[0]["trace"][-1]["params"], mp1[0]["trace"][-1]["params"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        worst["params_abs"] = max(worst["params_abs"], float(np.max(
            np.abs(got[name] - want[name]))))
    worst["largest_sharded_leaf"] = _check_half_features(
        mp2, dict(net.param_specs), "13c")
    return worst


def phase_sp(dev) -> dict:
    """Phase 13(d): make_sp_lstm with SP_SHAPE (5 stages, 4 microbatches
    over T=55, B=128, H=512, f32) on five gloo ranks sharing the card,
    against the unsharded lean scan (K4 lean) on the card from the same
    seeded inputs: outputs and final carry within SP_ATOL on every stage;
    each stage launches K4 lean once a microbatch. The sp run's seconds
    (host clock) beside the unsharded scan's CUDA-event ms. Returns the
    stages' launches."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.ops.lstm_kernels import lstm_fwd
    from r2d2_tpu_torch.tools import dp_check
    stages, micro, steps, batch, hidden = SP_SHAPE
    inputs = (batch, steps, hidden, 21)
    t0 = time.perf_counter()
    outs = _ranks(dp_check.rank_sp_lstm, stages,
                  {"microbatches": micro, "sp_inputs": inputs},
                  devices=[str(dev)] * stages)
    world_s = time.perf_counter() - t0
    args = {k: v.to(dev) for k, v in dp_check.sp_inputs(*inputs).items()}
    xpb = (args["x_proj"] + args["bias"]).transpose(0, 1).contiguous()
    c0, h0 = args["carry0"][0].contiguous(), args["carry0"][1].contiguous()
    before = _counts()
    hseq, c_fin = lstm_fwd(xpb, args["w_rec"], c0, h0, save_residuals=False)
    check(_counts()["lstm_fwd_lean"] == before["lstm_fwd_lean"] + 1,
          "13d: the reference scan did not launch K4 lean")
    scan_ms = cuda_ms(lambda: lstm_fwd(xpb, args["w_rec"], c0, h0,
                                       save_residuals=False))
    want_out = hseq.transpose(0, 1).cpu().numpy()
    want_fin = torch.stack([c_fin, hseq[-1]]).cpu().numpy()
    err = 0.0
    for r, (out, fin, errors, _, launches) in enumerate(outs):
        err = max(err, float(np.max(np.abs(out - want_out))),
                  float(np.max(np.abs(fin - want_fin))))
        check(len(errors) == 2 and all("not divisible" in e for e in errors),
              f"13d stage {r}: {errors}")
        check(launches["lstm_fwd_lean"] == micro
              and launches["lstm_fwd"] == 0,
              f"13d stage {r}: launches {launches}")
    check(err <= SP_ATOL, f"13d: max abs err {err} > {SP_ATOL}")
    print(f"13d sequence parallel, S={stages} stages x M={micro} "
          f"microbatches, T={steps} B={batch} H={hidden} f32, five gloo "
          f"ranks on one card ({_card()}): max abs err vs the unsharded "
          f"lean scan {err:.3e} (bound {SP_ATOL}); K4 lean launches "
          f"{stages * micro} ({micro} a stage); sp run "
          f"{1e3 * max(o[3] for o in outs):.1f} ms host clock (the carry "
          f"through the host between stages; beside 13a-c and e-g) vs one "
          f"lean scan {scan_ms:.4f} ms (CUDA events); {world_s:.1f} s "
          "with spawn", flush=True)
    return _sum_launches([{"launches": o[4]} for o in outs])


def _learner_world(dev, dp: int, mp: int, args, steps: int = 2,
                   after: int = 3) -> list:
    """tools/dp_check.py rank_snapshot_twin on dp x mp Learner ranks
    sharing the card over gloo: the reference widths with the fused scan,
    SNAP_CAPACITY, the config flags ``args``, five round-robin blocks,
    ``steps`` steps, a publish, a checkpoint (and a snapshot when ``args``
    turn them on), one more block and ``after`` steps; a learner resumed
    from them takes the same block and ``after`` steps. Returns every
    rank's result."""
    import tempfile
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.tools import bench, dp_check
    with tempfile.TemporaryDirectory(prefix="chip_smoke_learner_") as d:
        cfg = parse_overrides(Config(), [
            "--env.game_name=Fake", f"--replay.capacity={SNAP_CAPACITY}",
            f"--mesh.dp={dp}", f"--mesh.mp={mp}",
            "--runtime.save_interval=0", "--runtime.steps_per_dispatch=1",
            "--network.pallas_lstm=on", f"--runtime.save_dir={d}", *args])
        blocks = bench.synthetic_blocks(cfg, 6, seed=31)
        return _ranks(dp_check.rank_snapshot_twin, dp, {
            "cfg": cfg.to_dict(), "action_dim": bench.ACTION_DIM,
            "blocks": blocks[:5], "extra_block": blocks[5], "steps": steps,
            "after": after, "cut": False}, devices=[str(dev)] * (dp * mp),
            mp=mp)


def phase_dp_snapshot(dev) -> str:
    """Phase 13(e): replay snapshots under dp=2, two Learner ranks on the
    card (``_learner_world``): a learner resumed from the checkpoint and
    the snapshot adopts next_shard (1), publishes what was published at
    the save, and its three losses equal the twin's bit for bit. Returns
    the report line."""
    t0 = time.perf_counter()
    out = _learner_world(dev, 2, 1, ["--runtime.snapshot_interval=100000"]
                         )[0]
    check(out["restores"] == 1 and out["next_shard"] == 1,
          f"13e: restores {out['restores']}, next_shard {out['next_shard']}")
    check(out["resumed"] == out["twin"] and all(
        math.isfinite(x) for x in out["twin"]),
        f"13e: resumed {out['resumed']} vs twin {out['twin']}")
    check(out["resumed_sha"] == out["published_sha"],
          "13e: the resumed learner's params differ from the saved ones")
    written = out["written"]
    return (f"13e replay snapshots under dp=2, two Learner ranks on one card "
            f"({_card()}): the resumed learner's next three losses "
            f"{out['resumed']} equal the twin's bit for bit, next_shard 1 "
            f"adopted; capture {out['capture_ms']:.3f} ms (host, both "
            f"shards through the host group), write {written['write_s']} s, "
            f"{written['payload_bytes']} bytes; "
            f"{time.perf_counter() - t0:.1f} s with spawn")


def phase_tp_learner(dev, placement: str) -> dict:
    """Phase 13(g): the trainer's tensor-parallel wiring, two Learner
    ranks at dp=1 x mp=2 on the card under ``placement``
    (``_learner_world``, one step before the save and two after it, one
    on host placement; host: rank 0's host replay, each batch scattered
    to the row; device: the replicated replay, the snapshot of one
    replica): every loss finite, the published network full while the
    ranks hold half of the largest sharded leaf, the gathered checkpoint
    restoring it bit for bit, both ranks launching the path's kernels (K1
    on device placement only) alike; device placement also the snapshot
    twin's losses bit-equal. Returns the report line and the ranks'
    launches."""
    t0 = time.perf_counter()
    device = placement == "device"
    outs = _learner_world(dev, 1, 2, (
        ["--runtime.snapshot_interval=100000"] if device
        else ["--replay.placement=host"]), steps=1, after=2 if device else 1)
    out, label = outs[0], f"13g {placement} placement"
    check(all(math.isfinite(x) for k in ("losses", "twin", "resumed")
              for x in out[k]), f"{label}: losses {out}")
    check(out["resumed_sha"] == out["published_sha"],
          f"{label}: the resumed learner's params differ from the saved "
          "ones")
    largest = _check_half_features(outs, out["full_shapes"], label)
    launches = [o["launches"] for o in outs]
    path = ["stack_frames", "lstm_fwd", "lstm_bwd"] + (
        ["gather_windows"] if device else [])
    check(launches[0] == launches[1]
          and all(launches[0][k] > 0 for k in path)
          and (device or launches[0]["gather_windows"] == 0),
          f"{label}: launches {launches}")
    if device:
        check(out["restores"] == 1 and out["resumed"] == out["twin"],
              f"{label}: restores {out['restores']}, resumed "
              f"{out['resumed']} vs twin {out['twin']}")
    after = len(out["twin"])
    return {"report": f"{label}, dp=1 x mp=2, two Learner ranks on one "
                      f"card ({_card()}; reference widths, fused scan; one "
                      f"step, a publish, a gathered checkpoint"
                      + (", a snapshot" if device else "")
                      + f", then {after} more; resumed: {after}): losses "
                      f"{out['losses'] + out['twin']}, resumed "
                      f"{out['resumed']}"
                      + (" (the twin's bit for bit)" if device else "")
                      + f"; {largest} a rank, published = restored; "
                      f"launches a rank {launches[0]}; "
                      f"{time.perf_counter() - t0:.1f} s with spawn",
            "launches": _sum_launches(outs)}


def dryrun_world(mesh, names) -> dict:
    """Phase 13(f)'s rank function: the dryruns ``names``
    (parallel/dryrun.py) one after another on this rank's world."""
    from r2d2_tpu_torch.parallel import dryrun
    return {name: getattr(dryrun, name)(mesh) for name in names}


def phase_dryruns(dev) -> str:
    """Phase 13(f): every run_tiny_* dryrun (parallel/dryrun.py) on gloo
    ranks sharing the card (each asserts its own replicas and a finite
    loss): the dp x mp ones and sp on a dp=2 x mp=2 world, the sharded
    and the fused-LSTM steps on a dp=2 world; and the loopback
    multi-host dryrun with two controller interpreters on the card over
    gloo; the three side by side. Returns the report line."""
    import concurrent.futures
    from r2d2_tpu_torch.parallel.multihost_dryrun import launch
    name = str(dev)
    worlds = ((("run_tiny_device_mp_step", "run_tiny_tp_step",
                "run_tiny_sp_step"), 2, 2),
              (("run_tiny_sharded_step", "run_tiny_plstm_step"), 2, 1))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(_ranks, dryrun_world, dp, names,
                            devices=[name] * dp * mp, mp=mp)
                for names, dp, mp in worlds]
        mh = pool.submit(launch, 2, "cuda", "gloo", PHASE13_TIMEOUT_S)
        outs = [job.result() for job in jobs]
        mh.result()
    results = {}
    for out in outs:
        for fn in out[0]:
            values = [rank[fn] for rank in out]
            check(len(set(values)) == 1 and math.isfinite(values[0]),
                  f"13f {fn}: {values}")
            results[fn] = values[0]
    return ("13f dryruns on the card: " + json.dumps(results)
            + "; multihost ok")


def _dpmp_diag_check(mp2, mp1) -> float:
    """13(c)'s diagnostics: every rank's ld/ and rd/ values bit-equal to
    its row's mp replica's (rank 0's to rank 1's: shard 0's view), the
    rd/shard_* views with the dp axis, the same on both rows, their tree
    sums within rtol 1e-5 of the dp x 1 step's (the trees' bound) and the
    lane counts equal;
    dQ and the target distance finite at the interval step only. Returns
    the largest relative difference of the rd/ sums."""
    import numpy as np
    worst = 0.0
    for i in range(TP_STEPS):
        row0 = mp2[0]["trace"][i]["diag"]
        on = (i + 1) % TP_DIAG["diag"]["interval"] == 0
        check(math.isfinite(float(row0["ld/delta_q_stored"])) == on
              and math.isfinite(float(row0["ld/target_dist"])) == on,
              f"13c step {i}: dQ {row0['ld/delta_q_stored']}")
        for r in range(4):
            mine = mp2[r]["trace"][i]["diag"]
            replica = mp2[r ^ 1]["trace"][i]["diag"]
            for key, v in mine.items():
                check(np.array_equal(v, replica[key], equal_nan=True),
                      f"13c step {i} rank {r}: {key} differs from its mp "
                      "replica's")
                if key.startswith("rd/"):
                    check(np.array_equal(v, row0[key], equal_nan=True),
                          f"13c step {i}: {key} differs between the rows")
        check(row0["rd/shard_tree_moments"].shape == (2, 5),
              f"13c: rd/shard_tree_moments "
              f"{row0['rd/shard_tree_moments'].shape}")
        other = mp1[0]["trace"][i]["diag"]
        g = row0["rd/shard_tree_moments"][:, 1:4].astype(np.float64)
        w = other["rd/shard_tree_moments"][:, 1:4].astype(np.float64)
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-12)
        worst = max(worst, float(rel.max()))
        check(float(rel.max()) <= 1e-5,
              f"13c step {i}: tree sums {g} vs dp x 1 {w}")
        check(np.array_equal(row0["rd/lane_counts"], other["rd/lane_counts"]),
              f"13c step {i}: lane counts differ from the dp x 1 step's")
    return worst


def phase_parallel_remainder(dev) -> dict:
    """Phase 13 (see the module docstring): 13(a) to 13(g) side by side.
    Returns the launch counts: "tp" (13a, 13b's card ranks and 13g's),
    "dpmp" (13c's mp=2 ranks), "sp" (13d's stages)."""
    import concurrent.futures
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.tools import bench, dp_check
    t0 = time.perf_counter()
    cfg, case = _dpmp_case()
    with concurrent.futures.ThreadPoolExecutor(9) as pool:
        jobs = {"a": pool.submit(_timed, "13a", phase_tp_reference, dev),
                "c2": pool.submit(_timed, "13c mp=2", _ranks,
                                  dp_check.rank_steps, 2, case,
                                  devices=[str(dev)] * 4, mp=2),
                "c": pool.submit(_timed, "13c mp=1", _ranks,
                                 dp_check.rank_steps, 2, case,
                                 devices=[str(dev)] * 2),
                "b": pool.submit(_timed, "13b", phase_tp_card_vs_cpu, dev),
                "d": pool.submit(_timed, "13d", phase_sp, dev),
                "e": pool.submit(_timed, "13e", phase_dp_snapshot, dev),
                "f": pool.submit(_timed, "13f", phase_dryruns, dev),
                "g_device": pool.submit(_timed, "13g device",
                                        phase_tp_learner, dev, "device"),
                "g_host": pool.submit(_timed, "13g host", phase_tp_learner,
                                      dev, "host")}
        done = {k: j.result() for k, j in jobs.items()}
    tp, mp2 = done["a"], done["c2"]
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, dev)
    worst = _dpmp_compare(mp2, done["c"], net)
    worst["diag_rd_rel"] = _dpmp_diag_check(mp2, done["c"])
    want = _want_launches({"network.pallas_lstm": "on",
                           "network.use_double": True}, TP_STEPS,
                          _dq_steps(0, TP_STEPS,
                                    TP_DIAG["diag"]["interval"]))
    for r, o in enumerate(mp2):
        check(o["launches"] == want, f"13c rank {r}: launches "
              f"{o['launches']}, want {want}")
    print(f"13c dp x mp device-replay step, dp=2 x mp=2 vs dp=2 x mp=1 "
          f"(reference widths f32, fused scan, double DQN, replay "
          f"{DPMP_BLOCKS} blocks a shard, {TP_STEPS} steps, the same "
          f"state and draws; gloo ranks sharing one card beside 13a, b, "
          f"d, e, f and g, {_card()}; not a scaling number): "
          + json.dumps({
              "mp2_ms_per_step": [1e3 * t["seconds"]
                                  for t in mp2[0]["trace"]],
              "mp1_ms_per_step": [1e3 * t["seconds"]
                                  for t in done["c"][0]["trace"]],
              "max_diff": worst, "bounds": "losses rtol 2e-5, params rtol "
              "1e-4 atol 1e-6, trees rtol 1e-5",
              "launches_per_rank": mp2[0]["launches"]}), flush=True)
    print(done["b"]["report"], flush=True)
    print(done["e"], flush=True)
    print(done["f"], flush=True)
    print(done["g_device"]["report"], flush=True)
    print(done["g_host"]["report"], flush=True)
    print(f"phase 13 {time.perf_counter() - t0:.1f} s", flush=True)
    tp_total = {k: tp[k] + sum(done[j]["launches"][k]
                               for j in ("b", "g_device", "g_host"))
                for k in tp}
    return {"tp": tp_total, "dpmp": _sum_launches(mp2), "sp": done["d"]}


# -- phase 14: the learning and replay diagnostics ---------------------------

DIAG_K = 4                         # 14(a), (b): steps a dispatch
DIAG_DISPATCHES = 6                # 14(a): dispatches of each run
# 14(a): dQ every 5 steps, a tree snapshot every 3: at K=4 the dQ steps
# fall at every offset of a dispatch (5, 10, 15, 20: offsets 0, 1, 2, 3)
# and some dispatches hold none
DIAG_INTERVALS = (5, 3)
DIAG_BLOCKS = 48                   # 14(a), (b): the replay's rows
DIAG_FILL = 60                     # blocks written: the ring wraps
DIAG_WINDOW_S = 3.0                # 14(b): each timed window
DIAG_WARM = 52                     # 14(b): dispatches before the windows
DQ_RTOL = 1e-4                     # dQ's bound (the CPU tests')


def _diag_setup(dev):
    """(cfg, net, spec, replay) at the reference widths, bench's "fused"
    path (bf16, the fused scan), DIAG_BLOCKS rows with DIAG_FILL blocks
    written (the eviction ledger holds the wrap)."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**{
        **bench.PATHS["fused"], "replay.capacity": DIAG_BLOCKS * 400})
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, dev)
    spec, rs = bench.filled_replay(
        cfg, dev, bench.synthetic_blocks(cfg, DIAG_FILL, seed=21))
    check(spec.replay_diag and rs.evict_stats is not None
          and float(rs.evict_stats[0]) == DIAG_FILL - DIAG_BLOCKS,
          "14: the replay holds no eviction ledger of its wrap")
    return cfg, net, spec, rs


def _dq_launches(n: int) -> dict:
    """The launches dQ adds to a dispatch with ``n`` dQ steps: DQ_DECODES
    decodes and lean forwards (the fused scan) each."""
    return {"stack_frames": DQ_DECODES * n, "lstm_fwd_lean": DQ_DECODES * n}


def phase_diag_graph(dev, setup) -> dict:
    """Phase 14(a): the K-step graph with both diagnostics at the
    reference shape (see the module docstring), on ``setup``
    (``_diag_setup``'s). Returns the report, with the dQ branch's
    launches per interval step, by kernel."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.learner.train_step import (_make_step_body,
                                                   create_train_state,
                                                   diag_intervals,
                                                   eager_steps,
                                                   make_multi_learner_step)
    from r2d2_tpu_torch.telemetry.learning import LearningDiag
    from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
    t0 = time.perf_counter()
    cfg, net, spec, rs0 = setup
    diag = LearningDiag(DIAG_INTERVALS[0], cfg.telemetry.learning_dq_batch)
    rdiag = ReplayDiag(DIAG_INTERVALS[1],
                       ReplayDiag.from_config(cfg).lanes)
    use_double = cfg.network.use_double
    uniform = torch.rand((DIAG_DISPATCHES, DIAG_K, spec.batch_size),
                         generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    steps = {
        "on": make_multi_learner_step(net, spec, cfg.optim, use_double,
                                      DIAG_K, diag=diag, rdiag=rdiag),
        "off": make_multi_learner_step(net, spec, cfg.optim, use_double,
                                       DIAG_K),
        "eager": eager_steps(_make_step_body(net, spec, cfg.optim,
                                             use_double, diag=diag,
                                             rdiag=rdiag),
                             DIAG_K, diag_intervals(diag, rdiag))}
    ts = {n: create_train_state(net, cfg.optim, 0, use_double)
          for n in steps}
    rs = {n: _clone_replay(rs0) for n in steps}
    out = {n: [] for n in steps}
    counts = {n: [] for n in steps}
    flags = []
    for d in range(DIAG_DISPATCHES):
        flags.append(steps["on"].flags(ts["on"].step))
        for n, step in steps.items():
            _reset_counts()
            ts[n], rs[n], m = step(ts[n], rs[n], uniform[d])
            torch.cuda.synchronize()
            counts[n].append(_counts())
            out[n].append({k: v.float().cpu().numpy() for k, v in m.items()})
    # the diagnostics change no training state: losses per dispatch, then
    # the params, target and tree after the run, bit for bit
    for d in range(DIAG_DISPATCHES):
        check(np.array_equal(out["on"][d]["loss"], out["off"][d]["loss"]),
              f"14a dispatch {d}: losses with the diagnostics differ")
    for (name, p), q in zip(ts["on"].params.named_parameters(),
                            ts["off"].params.parameters()):
        check(torch.equal(p, q), f"14a: param {name} differs")
    check(torch.equal(rs["on"].tree, rs["off"].tree), "14a: trees differ")
    # graph against eager on the card, every dispatch
    worst = 0.0
    for d in range(DIAG_DISPATCHES):
        diag_on = {k: v for k, v in out["on"][d].items()
                   if k.startswith(("ld/", "rd/"))}
        diag_eager = {k: v for k, v in out["eager"][d].items()
                      if k.startswith(("ld/", "rd/"))}
        worst = max(worst, _diag_match(diag_on, diag_eager,
                                       f"14a dispatch {d}", rtol=1e-5,
                                       dq_rtol=DQ_RTOL))
        dq_on = [f[0] for f in flags[d]]
        rd_on = [f[1] for f in flags[d]]
        dq = np.isfinite(out["on"][d]["ld/delta_q_stored"])
        rd = np.isfinite(out["on"][d]["rd/tree_moments"][:, 0])
        check(list(dq) == dq_on and list(rd) == rd_on,
              f"14a dispatch {d}: dQ at {dq}, snapshots at {rd}, interval "
              f"steps {flags[d]}")
        extra = _dq_launches(sum(dq_on))
        want = {k: c + extra.get(k, 0) for k, c in counts["off"][d].items()}
        check(counts["on"][d] == want, f"14a dispatch {d} {flags[d]}: "
              f"launches {counts['on'][d]}, want {want}")
    for name in ("sample_count", "evict_stats", "evict_life_hist"):
        check(torch.equal(getattr(rs["on"], name), getattr(rs["eager"], name)),
              f"14a: the graph's {name} differs from eager's")
    check(float(rs["on"].sample_count.sum())
          == DIAG_DISPATCHES * DIAG_K * spec.batch_size,
          "14a: the sample counts miss sampled sequences")
    variants = sorted(steps["on"].variants)
    check(variants == sorted(set(flags[1:])),
          f"14a: variants captured {variants}, patterns {set(flags[1:])}")
    dq_offsets = {tuple(f[0] for f in v).index(True) for v in variants
                  if any(f[0] for f in v)}
    check(dq_offsets == set(range(DIAG_K)),
          f"14a: dQ at offsets {dq_offsets} of the dispatches")
    dq_per_step = _dq_launches(1)
    report = {"variants_captured": len(variants),
              # a step: q = dQ, r = a tree snapshot, - = neither
              "variants": ["".join("q" * f[0] + "r" * f[1] or "-"
                                   for f in v) for v in variants],
              "dq_dispatches": sum(1 for f in flags if any(x[0] for x in f)),
              "diag_max_rel_graph_vs_eager": worst,
              "dq_launches_per_interval_step": dq_per_step,
              "launches_plain_dispatch": counts["on"][
                  next(d for d in range(1, DIAG_DISPATCHES)
                       if not any(f[0] for f in flags[d]))],
              "seconds": round(time.perf_counter() - t0, 1)}
    print(f"14a K={DIAG_K} graph with both diagnostics at the reference "
          f"shape (bf16, fused scan; learning interval 5, replay interval "
          f"3), {DIAG_DISPATCHES} dispatches against the same graph "
          f"without them (training state bit-equal) and eager steps (the "
          f"diagnostics within their bounds), {_card()}: "
          + json.dumps(report), flush=True)
    del steps, ts, rs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def phase_diag_cost(dev, setup) -> dict:
    """Phase 14(b): K=4 graphs at the reference shape with the default
    intervals (dQ every 200 steps, a tree snapshot every 50), with and
    without the diagnostics, in alternating windows of DIAG_WINDOW_S
    (off, on, on, off): seq-updates/s of each, and from CUDA events
    around every dispatch, the ms of a dispatch without them, of a plain
    one with them, of one holding a tree snapshot and of one holding a
    dQ step."""
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_multi_learner_step)
    from r2d2_tpu_torch.telemetry.learning import LearningDiag
    from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
    cfg, net, spec, rs0 = setup
    diag, rdiag = LearningDiag.from_config(cfg), ReplayDiag.from_config(cfg)
    use_double = cfg.network.use_double
    steps = {"on": make_multi_learner_step(net, spec, cfg.optim, use_double,
                                           DIAG_K, diag=diag, rdiag=rdiag),
             "off": make_multi_learner_step(net, spec, cfg.optim, use_double,
                                            DIAG_K)}
    ts = {n: create_train_state(net, cfg.optim, 0, use_double)
          for n in steps}
    rs = {n: _clone_replay(rs0) for n in steps}
    for n, step in steps.items():           # past every pattern's capture
        for _ in range(DIAG_WARM):
            ts[n], rs[n], _ = step(ts[n], rs[n])
    torch.cuda.synchronize()
    rates = {"on": [], "off": []}
    ms = {"off": [], "on": [], "on_snapshot": [], "on_dq": []}
    for n in ("off", "on", "on", "off"):
        events = []
        dispatches = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < DIAG_WINDOW_S:
            flags = steps["on"].flags(ts[n].step) if n == "on" else ()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ts[n], rs[n], _ = steps[n](ts[n], rs[n])
            end.record()
            key = ("on_dq" if any(f[0] for f in flags) else "on_snapshot"
                   if any(f[1] for f in flags) else n)
            events.append((start, end, key))
            dispatches += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rates[n].append(dispatches * DIAG_K * spec.batch_size / seconds)
        for start, end, key in events:
            ms[key].append(start.elapsed_time(end))
    check(ms["on_dq"] and ms["on_snapshot"],
          "14b: no dQ or snapshot dispatch in the windows")
    off, on = statistics.mean(rates["off"]), statistics.mean(rates["on"])
    report = {
        "seq_updates_per_s": {k: [round(x, 1) for x in v]
                              for k, v in rates.items()},
        "overhead": round(1.0 - on / off, 4),
        "ms_per_dispatch": {k: round(statistics.median(v), 4)
                            for k, v in ms.items()},
        "dispatches": {k: len(v) for k, v in ms.items()},
        "dq_dispatch_extra_ms": round(
            statistics.median(ms["on_dq"]) - statistics.median(ms["on"]), 4),
        "snapshot_dispatch_extra_ms": round(
            statistics.median(ms["on_snapshot"])
            - statistics.median(ms["on"]), 4)}
    print(f"14b the diagnostics' cost, K={DIAG_K} graphs at the reference "
          f"shape (bf16, fused scan, default intervals: dQ every 200 "
          f"steps, a tree snapshot every 50), windows of {DIAG_WINDOW_S} s "
          f"off, on, on, off, {_card()}: " + json.dumps(report), flush=True)
    del steps, ts, rs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def phase_diag_halt(dev) -> dict:
    """Phase 14(c): telemetry.nan_policy="halt" on the card: a Learner at
    the small shape (K=4 graphs); clean dispatches flush a learning block
    with no non-finite step; its params poisoned with a NaN, the next
    flush writes the one forensics dump and raises; after another
    poisoned dispatch the flush raises again without a second dump."""
    import tempfile
    import numpy as np
    import torch
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.tools import bench
    with tempfile.TemporaryDirectory(prefix="chip_smoke_halt_") as d:
        cfg = _tiny_config().replace(**{
            "runtime.save_dir": d, "runtime.save_interval": 0,
            "runtime.steps_per_dispatch": DIAG_K,
            "replay.learning_starts": 100, "telemetry.nan_policy": "halt"})
        net = NetworkApply(18, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width, dev)
        learner = Learner(cfg, net)
        for block in bench.synthetic_blocks(cfg, 10, seed=4):
            learner.ingest(block)
        for _ in range(3):
            learner.step()
        learner.flush_metrics()
        record = learner.metrics.log(1.0)
        check(record["learning"]["nonfinite_steps"] == 0
              and "replay_diag" in record,
              f"14c: the clean record {record.get('learning')}")
        with torch.no_grad():
            next(learner.train_state.params.parameters()).fill_(
                float("nan"))
        dump = os.path.join(d, "nan_dump_player0.json")
        raised = []
        for attempt in range(2):
            learner.step()
            try:
                learner.flush_metrics()
            except RuntimeError as e:
                raised.append(str(e))
            if attempt == 0:
                check(os.path.exists(dump), "14c: no forensics dump")
                written = json.load(open(dump))
                os.remove(dump)
        check(len(raised) == 2 and all("nan_policy=halt" in e
                                       for e in raised),
              f"14c: flushes raised {raised}")
        check(not os.path.exists(dump), "14c: a second dump was written")
        check(written["learning"]["nonfinite_steps"] > 0
              and written["nan_policy"] == "halt"
              and len(written["last_batch_idxes"]) == DIAG_K * 8,
              f"14c: dump {written}")
        learner.stop_background()
    report = {"dump_step": written["step"],
              "nonfinite_steps": written["learning"]["nonfinite_steps"],
              "raised": raised[0]}
    print(f"14c nan_policy=halt on the card ({_card()}): "
          + json.dumps(report), flush=True)
    return report


def phase_diagnostics(dev) -> dict:
    """Phase 14: 14(a), (b), (c) in turn."""
    import torch
    t0 = time.perf_counter()
    setup = _diag_setup(dev)
    graph = phase_diag_graph(dev, setup)
    cost = phase_diag_cost(dev, setup)
    del setup
    torch.cuda.empty_cache()
    phase_diag_halt(dev)
    print(f"phase 14 {time.perf_counter() - t0:.1f} s", flush=True)
    return {"graph": graph, "cost": cost}


SINGLE_STEPS = 8                   # 7: one-step graph vs eager dispatches
PROFILE_STEPS = 20                 # 15a: steps inside cli.profile's trace
TELE_CAPACITY = 6400               # 15c: 16 reference blocks
AT_STEP = 8                        # 15b: runtime.profile_at_step
AT_STEP_SECONDS = 5.0              # 15b: the short run's bound
TELE_K = 4                         # 15c: steps a dispatch
TELE_WINDOW_S = 1.0                # 15c: each timed window
# 15c's arms and 16e's: telemetry off; the stage timers and spans on;
# those and the resources, compile and alert planes (telemetry's default)
TELE_ORDER = ("off", "on", "planes", "planes", "on", "off") * 2
# 15b's short run: the on-device loop at the CPU tests' tiny shape
AT_STEP_ARGS = [
    "--env.game_name=Fake", "--env.frame_height=24", "--env.frame_width=24",
    "--env.frame_stack=2", "--network.hidden_dim=16",
    "--network.cnn_out_dim=32", "--network.conv_layers=8,4,2;16,3,1",
    "--sequence.burn_in_steps=4", "--sequence.learning_steps=5",
    "--sequence.forward_steps=3", "--replay.capacity=800",
    "--replay.block_length=20", "--replay.batch_size=8",
    "--replay.learning_starts=100", "--actor.on_device=true",
    "--actor.anakin_lanes=4", "--env.episode_len=40",
    # a 0.1 s capture window: at this shape the card runs ~100 steps a
    # second, ~30 MB of trace
    "--runtime.save_interval=0", "--runtime.log_interval=0.1",
    # 16a folded in: the headroom floors near 1 force hbm_headroom and the
    # forensics dump
    "--telemetry.resources_headroom_warn_frac=0.999",
    "--telemetry.alerts_hbm_headroom_frac=0.999"]


def phase_cli_profile(dev, bench_fused: float, out_dir: str) -> dict:
    """15(a): python -m r2d2_tpu_torch.cli.profile's entry point at the
    reference shape, bench's "fused" path at K=TELE_K, PROFILE_STEPS
    steps over a full ring of bench's REF_CAPACITY steps (cli.profile's
    default capacity; tools/profile_step.py repeats its distinct blocks
    to fill it): the trace names the hand kernels of the step with launches a
    step equal to the wrappers' counts in the traced window; prints the
    device kernels' table, model FLOPs a step and the share of the card's
    bf16 peak (telemetry/costmodel.py peak_spec) at bench fused's rate in
    this call. The capture stays in ``out_dir`` for 16d."""
    from r2d2_tpu_torch.cli import profile
    from r2d2_tpu_torch.telemetry import costmodel
    from r2d2_tpu_torch.tools import bench
    result = profile.main([
        "--steps", str(PROFILE_STEPS), "--out", out_dir, "--top", "12",
        "--network.pallas_lstm=on",
        f"--runtime.steps_per_dispatch={TELE_K}"])
    table = result["device_kernels"]
    check(result["steps"] == PROFILE_STEPS, f"15a: {result['steps']} steps")
    hand, counted = result["hand_kernels"], result["launches_per_step"]
    check(all(hand[n]["launches_per_step"] > 0 for n in (
        "gather_windows", "stack_frames", "lstm_fwd", "lstm_bwd"))
        and all(hand[n]["launches_per_step"] == counted[n] for n in hand),
        f"15a: the trace's hand kernels {hand}, counted {counted}")
    cfg = bench.reference_config()
    flops = costmodel.model_flops_per_step(cfg, bench.ACTION_DIM, False)
    peak = costmodel.peak_spec()
    steps_per_s = bench_fused / cfg.replay.batch_size
    top = sorted(((n, r) for n, r in table.items() if n != "total"),
                 key=lambda x: -x[1]["ms_per_step"])[:15]
    print(f"15a cli.profile, reference shape, fused K={TELE_K}, "
          f"{PROFILE_STEPS} steps ({_card()}): device ms a step "
          f"{table['total']['ms_per_step']:.4f}, launches a step "
          f"{table['total']['launches_per_step']:.2f}; top kernels:",
          flush=True)
    for name, row in top:
        print(f"  {row['ms_per_step']:8.4f} ms/step "
              f"{row['launches_per_step']:7.2f}/step  {name[:100]}",
              flush=True)
    share = flops * steps_per_s / peak["flops_bf16"]
    report = {"device_ms_per_step": table["total"]["ms_per_step"],
              "hand_kernels": hand, "model_flops_per_step": flops,
              "bench_fused_seq_updates_per_s": bench_fused,
              "model_tflops_per_s": flops * steps_per_s / 1e12,
              "peak": peak, "share_of_bf16_peak": share,
              "share_of_bf16_peak_at_device_time":
                  flops / (table["total"]["ms_per_step"] / 1e3)
                  / peak["flops_bf16"]}
    print("15a model FLOPs a step and the share of the bf16 peak: "
          + json.dumps(report), flush=True)
    return report


def phase_profile_at_step(dev) -> dict:
    """15(b): runtime.profile_at_step=AT_STEP in a short cli.train run
    (the on-device loop at the tiny shape): the capture starts once the
    learner reaches the step, stops after min(log_interval, 30) s and is
    written under {save_dir}/profile, a trace with the device's kernels;
    16(a) on its records (phase_headroom_alert)."""
    import glob
    import tempfile
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.tools.profile_step import summarize_trace
    with tempfile.TemporaryDirectory(prefix="chip_smoke_at_step_") as d:
        summary = train.main(AT_STEP_ARGS + [
            f"--runtime.save_dir={d}", f"--runtime.profile_at_step={AT_STEP}",
            f"--max-seconds={AT_STEP_SECONDS}"])
        traces = glob.glob(os.path.join(d, "profile", "*.pt.trace.json"))
        check(summary["steps"] > AT_STEP and len(traces) == 1,
              f"15b: {summary['steps']} steps, traces {traces}")
        planes = summarize_trace(os.path.join(d, "profile"), top=5)
        headroom = phase_headroom_alert(
            d, _read_jsonl(os.path.join(d, "metrics_player0.jsonl")))
        report = {"steps": summary["steps"], "headroom_alert": headroom,
                  "trace_mb": os.path.getsize(traces[0]) / 1e6,
                  "device_kernels_top": [(n, round(us / 1e3, 3), c)
                                         for n, us, c in
                                         planes.get("device", [])]}
    check(report["device_kernels_top"], f"15b: no device kernel in the "
          f"capture: {sorted(planes)}")
    print("15b runtime.profile_at_step capture: " + json.dumps(report),
          flush=True)
    return report


def phase_telemetry_cost(dev) -> dict:
    """15(c) and 16(e): the stage timers' and spans' cost, and the
    resources, compile and alert planes' cost on top of them, through the
    Learner at the reference shape, bench's "fused" path at K=TELE_K over
    a replay of TELE_CAPACITY steps: one Learner with telemetry.enabled=
    false ("off"), one with the stage timers and spans (a drain writing
    spans) and resources off ("on"), one with both and the planes
    ("planes": a HealthPlane on its metrics, ticked after every dispatch,
    an upper bound of the loops' supervision cadence), the learning and
    replay diagnostics off in all, in windows of TELE_WINDOW_S in
    TELE_ORDER; a window ends with the flush and the record, as the
    orchestrator's log boundary does. 15c's cost is the median over the
    (off, on) pairs of 1 - on / off, 16e's over the (on, planes) pairs of
    1 - planes / on."""
    import tempfile
    import torch
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.runtime.metrics import TrainMetrics
    from r2d2_tpu_torch.telemetry.core import Telemetry
    from r2d2_tpu_torch.telemetry.resources import HealthPlane
    from r2d2_tpu_torch.tools import bench
    base = bench.reference_config(**{
        **bench.PATHS["fused"], "replay.capacity": TELE_CAPACITY,
        "runtime.steps_per_dispatch": TELE_K, "runtime.save_interval": 0,
        "telemetry.learning_enabled": False,
        "telemetry.replay_diag_enabled": False})
    blocks = bench.synthetic_blocks(base, base.num_blocks, seed=31)
    arms = ("off", "on", "planes")
    learners = {}
    rates = {arm: [] for arm in arms}
    records = {arm: [] for arm in arms}
    plane = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tele_") as d:
        for arm in arms:
            cfg = base.replace(**{"telemetry.enabled": arm != "off",
                                  "telemetry.resources_enabled":
                                      arm == "planes",
                                  "runtime.save_dir": d})
            net = NetworkApply(bench.ACTION_DIM, cfg.network,
                               cfg.env.frame_stack, cfg.env.frame_height,
                               cfg.env.frame_width, dev)
            metrics = TrainMetrics(0, log_dir=None)
            tele = Telemetry.from_config(cfg, name=f"cost-{arm}")
            metrics.set_telemetry(tele)
            tele.start_drain(os.path.join(d, f"spans_{arm}.jsonl"))
            if arm == "planes":
                plane = HealthPlane(cfg, metrics, 0, devices=[dev])
            learner = Learner(cfg, net, metrics=metrics)
            for block in blocks:
                learner.ingest(block)
            for _ in range(3):          # eager, capture, replay
                learner.step()
            learner.flush_metrics()
            learner.metrics.log(1.0)
            learners[arm] = learner
        torch.cuda.synchronize()
        for arm in TELE_ORDER:
            learner = learners[arm]
            steps0 = learner.training_steps
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < TELE_WINDOW_S:
                learner.step()
                if arm == "planes":
                    plane.tick(learner.warm)
            learner.flush_metrics()     # the readback ends the window
            records[arm].append(learner.metrics.log(TELE_WINDOW_S))
            seconds = time.perf_counter() - t0
            rates[arm].append((learner.training_steps - steps0)
                              * base.replay.batch_size / seconds)
        for learner in learners.values():
            learner.metrics.telemetry.close()
            learner.stop_background()
        plane.close()
        on_spans = os.path.join(d, "spans_on.jsonl")
        telemetry = _check_stage_records(
            records["on"], "15c the on arm",
            ("learner/train_dispatch", "learner/device_sync"), [on_spans],
            costs=False)
        check(not os.path.exists(os.path.join(d, "spans_off.jsonl"))
              and not any("stages" in r or "costs" in r
                          for r in records["off"]),
              "15c: the off arm observed stages or wrote spans")
        check(not any("resources" in r or "alerts" in r
                      for r in records["on"] + records["off"])
              and all("resources" in r and "alerts" in r
                      for r in records["planes"]),
              "16e: the resources and alerts blocks in the wrong arms")
        planes = _check_health_records(
            records["planes"], "16e the planes arm",
            _state_bytes(learners["planes"].train_state,
                         learners["planes"].replay_state),
            os.path.join(d, "alerts_player0.jsonl"), captures=False)
    pairs = [1.0 - rates["on"][i] / rates["off"][i]
             for i in range(len(rates["on"]))]
    plane_pairs = [1.0 - rates["planes"][i] / rates["on"][i]
                   for i in range(len(rates["on"]))]
    report = {"seq_updates_per_s": {k: [round(x, 2) for x in v]
                                    for k, v in rates.items()},
              "pair_costs": [round(x, 5) for x in pairs],
              "median_cost": statistics.median(pairs),
              "planes_pair_costs": [round(x, 5) for x in plane_pairs],
              "planes_median_cost": statistics.median(plane_pairs),
              "windows_s": TELE_WINDOW_S,
              "stage_counts": telemetry["stage_counts"],
              "spans": telemetry["spans"], "planes": planes}
    print(f"15c the stage timers' cost, and 16e the resources, compile "
          f"and alert planes' on top of them, through the Learner, "
          f"reference shape, fused K={TELE_K}, diagnostics off, windows of "
          f"{TELE_WINDOW_S} s {' '.join(TELE_ORDER)} ({_card()}): "
          + json.dumps(report), flush=True)
    del learners
    torch.cuda.empty_cache()
    return report


def phase_telemetry(dev, bench_fused: float, profile_dir: str) -> dict:
    """Phase 15 (see the module docstring), with 16a inside 15b and 16e's
    planes arm inside 15c."""
    return {"profile": phase_cli_profile(dev, bench_fused, profile_dir),
            "at_step": phase_profile_at_step(dev),
            "cost": phase_telemetry_cost(dev)}


def phase_planes(dev, bench_fused: float, profile_dir: str) -> dict:
    """Phase 16 (see the module docstring): 16b, 16c, 16d and 16e's
    scopes; 16a and 16e's planes ran inside phase 15."""
    return {"retrace": phase_retrace(dev),
            "traced": phase_traced_serving(dev),
            "roofline": phase_roofline(dev, profile_dir, bench_fused),
            "scopes": phase_scope_cost(dev)}


# ---------------------------------------------------------------------------
# phase 16: the resource, compile and alert planes, tracing, the roofline

RETRACE_NEW = (3, 5, 6)            # 16b: captured after warm-up
TRACED_SECONDS = 6.0               # 16c: the traced served run
TRACED_ARGS = ["--actor-mode=thread", "--actor.inference=server",
               "--env.game_name=Fake", "--replay.capacity=100000",
               "--runtime.log_interval=4",
               "--telemetry.tracing_enabled=true",
               "--telemetry.trace_sample_every=1"]
MAP_CAPACITY = 6400                # 16d: the eager map's ring (16 blocks)
ROOFLINE_VARIANTS = ("learner_step",)     # 16d: counted on the card
SCOPE_WINDOWS = ("on", "off", "off", "on") * 2   # 16e: eager steps
SCOPE_STEPS = 16                   # 16e: eager steps a window


def phase_retrace(dev) -> dict:
    """16(b): a policy server at the reference widths captures its buckets
    under a compile monitor; after ``mark_warm`` a capture of the same
    forward at each of RETRACE_NEW buckets (a new shape) counts as a
    retrace; the resources block's compile sub-block carries them, and
    ``retrace_storm`` fires once on that record (alerts_retrace_storm =
    3, JAX's default) and not again on the next."""
    import torch
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.serve.server import _BucketGraph
    from r2d2_tpu_torch.telemetry.alerts import AlertEngine, default_rules
    from r2d2_tpu_torch.telemetry.compile import CompileMonitor
    from r2d2_tpu_torch.telemetry.resources import (BufferRegistry,
                                                    ResourceMonitor)
    tcfg = Config().telemetry
    mon = CompileMonitor().install()
    try:
        cfg, server, _ = _serving_server(
            dev, "f32", warmup=True)
        check(server.buckets == [1, 2, 4, 8, 16, 32],
              f"16b: buckets {server.buckets}")
        mon.mark_warm()
        with server._on_stream():
            for b in RETRACE_NEW:
                _BucketGraph(server, b)
        torch.cuda.synchronize()
        res = ResourceMonitor(devices=[dev], compile_monitor=mon,
                              registry=BufferRegistry())
        engine = AlertEngine(default_rules(tcfg))
        first = {"resources": res.block()}
        a1 = engine.evaluate(first)
        second = {"resources": res.block()}
        a2 = engine.evaluate(second)
    finally:
        mon.uninstall()
    comp = first["resources"]["compile"]
    check(comp["retraces_interval"] == len(RETRACE_NEW)
          and comp["retraces_total"] == len(RETRACE_NEW)
          and comp["late_compiles"] == 0
          and comp["last_retrace"]["fn"] == "serve_forward",
          f"16b: compile block {comp}")
    check([a["rule"] for a in a1["fired"]] == ["retrace_storm"]
          and a2["fired"] == [] and "retrace_storm" not in a2["active"],
          f"16b: alerts {a1}, then {a2}")
    report = {"compile": comp, "fired": a1["fired"],
              "storm_bound": tcfg.alerts_retrace_storm,
              "after": second["resources"]["compile"]["retraces_interval"]}
    print("16b a recapture at a new shape after warm-up (serving buckets "
          f"{list(RETRACE_NEW)} after {server.buckets}): "
          + json.dumps(report), flush=True)
    return report


def phase_headroom_alert(d: str, records) -> dict:
    """16(a), on 15b's run (forced floors of 0.999): ``hbm_headroom``
    fires once (edge semantics: one line in alerts_player0.jsonl, one
    record's fired list) and the one forensics dump holds the buffers
    the records name, with the same bytes."""
    lines = _read_jsonl(os.path.join(d, "alerts_player0.jsonl"))
    head = [x for x in lines if x["rule"] == "hbm_headroom"]
    fired = [a for r in records for a in r["alerts"]["fired"]
             if a["rule"] == "hbm_headroom"]
    check(len(head) == 1 and len(fired) == 1
          and head[0]["severity"] == "crit",
          f"16a: hbm_headroom lines {head}, fired {fired}")
    dump_path = os.path.join(d, "resource_dump_player0.json")
    check(os.path.exists(dump_path), "16a: no resource dump")
    dump = json.load(open(dump_path))
    buffers = records[-1]["resources"]["buffers"]
    check(dump["buffers"] and all(buffers.get(k) == v
                                  for k, v in dump["buffers"].items()
                                  if k != "p0/train_state"),
          f"16a: the dump's buffers {dump['buffers']}, the record's "
          f"{buffers}")
    check(all(k in buffers for k in dump["buffers"]),
          f"16a: dump buffers {sorted(dump['buffers'])} not in the record")
    report = {"fired": head[0], "dump_reason": dump["reason"],
              "dump_buffers": dump["buffers"],
              "record_buffers": buffers}
    print("16a a forced hbm_headroom firing (floors 0.999, 15b's run): "
          + json.dumps(report), flush=True)
    return report


def phase_traced_serving(dev) -> dict:
    """16(c): served training with telemetry.tracing_enabled and
    trace_sample_every=1 (thread actors, the in-process rung; f32
    inference) for TRACED_SECONDS: the records' serving blocks carry a
    trace sub-block with every hop's histogram non-empty, and the ring
    accountant's slot mirrors hold stamped slots (emission before
    commit)."""
    import tempfile
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.telemetry.tracing import SERVE_HOPS
    stacks = []

    def hook(stack):
        if not stacks:
            stacks.append(stack)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_traced_") as d:
        torch.cuda.empty_cache()
        summary = train.main(TRACED_ARGS + [
            f"--max-seconds={TRACED_SECONDS}", f"--runtime.save_dir={d}"],
            dispatch_hook=hook)
        records = _read_jsonl(os.path.join(d, "metrics_player0.jsonl"))
    check(summary["device"].startswith("cuda") and summary["steps"] > 0,
          f"16c: {summary['device']}, {summary['steps']} steps")
    traces = [r["serving"]["trace"] for r in records
              if "trace" in r.get("serving", {})]
    check(traces, "16c: no serving trace block")
    hops = {}
    for t in traces:
        for name, h in t["hops"].items():
            hops[name] = hops.get(name, 0) + h["count"]
    check(all(hops.get(name, 0) > 0 for name in SERVE_HOPS),
          f"16c: hop counts {hops}")
    ring = stacks[0].learner.ring
    stamped = [(t, i) for t, i in zip(ring.slot_trace, ring.slot_ingest_ms)
               if t >= 0]
    check(stamped and all(i >= 0 and (i - t) % 2 ** 31 < 600_000
                          for t, i in stamped),
          f"16c: {len(stamped)} stamped slots of {ring.total_adds} adds")
    report = {"steps": summary["steps"], "requests_traced":
              sum(t["requests"] for t in traces), "hop_counts": hops,
              "last_hops": traces[-1]["hops"],
              "stamped_slots": len(stamped),
              "emit_to_commit_ms_median": statistics.median(
                  (i - t) % 2 ** 31 for t, i in stamped)}
    print(f"16c traced served training ({_card()}): " + json.dumps(report),
          flush=True)
    return report


def phase_roofline(dev, trace_dir: str, bench_fused: float) -> dict:
    """16(d): 15a's capture (a graph replay of K=TELE_K steps) attributed
    to components through an eager profile of the same step factory
    (telemetry/traceparse.py: >= 80% of its device time); the learner
    step's FLOPs counted on the card with the kernels on (the flop
    counter plus their formulas) within 5% of model_flops_per_step; the
    roofline table (tools/roofline.py) over them at bench fused's step
    time in this call, with the card's name and power limit."""
    import tempfile
    import torch
    from r2d2_tpu_torch.telemetry import costmodel, traceparse
    from r2d2_tpu_torch.tools import bench, profile_step, roofline
    cfg = bench.reference_config(**{"network.pallas_lstm": "on",
                                    "runtime.steps_per_dispatch": TELE_K})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_map_") as d:
        profile_step.capture_step_trace(
            cfg.replace(**{"replay.capacity": MAP_CAPACITY}), 2, d,
            warmup=2, device=dev, eager=True)
        kmap = traceparse.kernel_components(d)
        eager = traceparse.attribute_trace(d)
    summary = traceparse.attribute_trace(trace_dir, kernel_map=kmap)
    summary["steps"] = profile_step.traced_step_count(trace_dir)
    check(eager["attributed_frac"] >= 0.8,
          f"16d: the eager step {eager['attributed_frac']} attributed")
    check(summary["attributed_frac"] >= 0.8,
          f"16d: 15a's capture {summary['attributed_frac']} attributed: "
          + traceparse.format_attribution(summary))
    # FLOPs do not depend on the ring's capacity: counted over the map's
    costs = costmodel.collect_cost_table(
        cfg.replace(**{"replay.capacity": MAP_CAPACITY}),
        variants=ROOFLINE_VARIANTS, device=dev, action_dim=bench.ACTION_DIM)
    torch.cuda.synchronize()
    kernel_flops = costs["programs"]["learner_step"]["kernel_flops"]
    check(kernel_flops.get("lstm_fwd", 0) > 0
          and kernel_flops.get("lstm_bwd", 0) > 0,
          f"16d: the LSTM kernels' formulas did not count: {kernel_flops}")
    step_ms = 1e3 * cfg.replay.batch_size / bench_fused
    report = roofline.build_report(cfg, "reference", step_ms,
                                   costmodel.peak_spec(),
                                   trace_summary=summary, costs=costs,
                                   device=dev)
    check(report["parity"]["within"],
          f"16d: FLOP parity {report['parity']}")
    print(f"16d component attribution of 15a's capture ({_card()}):\n"
          + traceparse.format_attribution(summary), flush=True)
    print(f"16d roofline, reference shape, fused K={TELE_K}, step time "
          f"from bench fused K={TELE_K} in this call ({_card()}):\n"
          + roofline.format_report(report), flush=True)
    out = {"attributed_frac": summary["attributed_frac"],
           "mapped_us": summary["mapped_us"],
           "eager_attributed_frac": eager["attributed_frac"],
           "parity": report["parity"],
           "components": report["learner_step"]["components"],
           "device_ms_by_component": {
               c: round(row["time_us"] / 1e3 / summary["steps"], 4)
               for c, row in summary["components"].items()}}
    print("16d roofline report: " + json.dumps(out), flush=True)
    return out


def phase_scope_cost(dev) -> dict:
    """16(e), second part: the component scopes on the eager path with no
    profiler running (each one a check of the profiler's state): the
    eager single step at the reference shape (fused path, diagnostics
    off) in windows of SCOPE_STEPS synced steps, the scopes as built
    against scopes.scope replaced by a null context, in SCOPE_WINDOWS
    order; the cost is the median over the pairs of 1 - on / off."""
    import contextlib
    import torch
    from r2d2_tpu_torch.telemetry import scopes
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**{**bench.PATHS["fused"],
                                    "replay.capacity": MAP_CAPACITY})
    blocks = bench.synthetic_blocks(cfg, 16, seed=41)
    spec, rs = bench.filled_replay(cfg, dev, blocks)
    ts, step = bench.build_learner_step(cfg, dev, spec, 1, eager=True)
    for _ in range(2):
        step(ts, rs)
    torch.cuda.synchronize()
    built = scopes.scope
    null = contextlib.nullcontext()
    rates = {"on": [], "off": []}
    try:
        for arm in SCOPE_WINDOWS:
            scopes.scope = built if arm == "on" else (lambda name: null)
            t0 = time.perf_counter()
            for _ in range(SCOPE_STEPS):
                step(ts, rs)
            torch.cuda.synchronize()
            rates[arm].append(SCOPE_STEPS / (time.perf_counter() - t0))
    finally:
        scopes.scope = built
    pairs = [1.0 - on / off for on, off in zip(rates["on"], rates["off"])]
    report = {"steps_per_s": rates, "pair_costs": pairs,
              "median_cost": statistics.median(pairs)}
    print(f"16e the component scopes' cost on the eager step ({_card()}): "
          + json.dumps(report), flush=True)
    del ts, rs
    torch.cuda.empty_cache()
    return report


# -- phase 17: the replay service ---------------------------------------------

SERVICE_SECONDS = 20.0             # 17b: the service-routed cli.train run
# 17b's ring (r2d2_tpu_torch/tools/service_probe.py service_args: two
# shards, training from 400 steps): a shard's rows sized from phase 6's
# blocks/s (its env steps/s over its env steps a block: the Fake env's
# episodes end blocks short) for SERVICE_TURNS turnovers in
# SERVICE_SECONDS at SERVICE_RATE_SHARE of that rate (start-up, the first
# blocks' 400 steps and the learner's share of the host: 17b's actors
# delivered 0.39-0.43 of phase 6's blocks/s in its window), held to >= 2
SERVICE_TURNS = 4
SERVICE_RATE_SHARE = 0.4
SERVICE_MAX_SHARD_BLOCKS = 16
SERVICE_SPILL = 3                  # 17a: a shard's tier (4-row rings turn)
SERVICE_K = 8                      # 17a: the grouped add's chunk
# 17a at the configuration's priority exponent: the card's f32 pow and the
# CPU's may round an ulp apart, in the trees and the importance weights
SERVICE_POW_RTOL = 1e-6
# 17c: the standalone service's drill at two shards (the tiny geometry of
# the JAX package's drill), snapshots every DRILL_INTERVAL adds, a window
# of 4 frames of 2 blocks
DRILL_OVERRIDES = {
    "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
    "network.hidden_dim": 16, "sequence.burn_in_steps": 4,
    "sequence.learning_steps": 5, "sequence.forward_steps": 3,
    "replay.capacity": 800, "replay.block_length": 20,
    "replay.batch_size": 8, "fleet.replay_shards": 2,
    "fleet.ingest_batch_blocks": 2, "fleet.spill_blocks": 4}
DRILL_INTERVAL = 8


def _service_equal(a, b, label: str, tree_rtol: float = 0.0) -> None:
    """Two services' shards equal: every state leaf (across devices; the
    sum tree within ``tree_rtol``, exactly at 0), the ring accountants,
    the spill pages (ids in LRU order, stored priorities, fields), the
    demotion tables, the guard's counters."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.snapshot import _LEAVES
    for name in ("stale_writebacks", "spilled_writebacks",
                 "stale_rows_dropped", "_rr_add", "_rr_sample"):
        check(getattr(a, name) == getattr(b, name),
              f"{label}: {name} {getattr(a, name)} vs {getattr(b, name)}")
    for i, (x, y) in enumerate(zip(a.shards, b.shards)):
        for name in _LEAVES:
            u, v = getattr(x.state, name), getattr(y.state, name)
            if name == "tree" and tree_rtol:
                same = torch.allclose(u.cpu(), v.cpu(), rtol=tree_rtol,
                                      atol=0)
            elif torch.is_tensor(u):
                same = torch.equal(u.cpu(), v.cpu())
            else:
                same = u == v
            check(same, f"{label}: shard {i} {name} differs")
        for name in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                     "slot_versions"):
            check(getattr(x.ring, name) == getattr(y.ring, name),
                  f"{label}: shard {i} ring.{name} differs")
        check(list(x.spill._pages) == list(y.spill._pages)
              and x.spill._prio == y.spill._prio
              and x._demote_ids == y._demote_ids,
              f"{label}: shard {i} spill pages or demotion table differ")
        for pid, (pb, pl, pv) in x.spill._pages.items():
            qb, ql, qv = y.spill._pages[pid]
            check((pl, pv) == (ql, qv) and all(
                np.array_equal(np.asarray(getattr(pb, f)),
                               np.asarray(getattr(qb, f)))
                for f in ("obs_row", "priority", "hidden", "action")),
                f"{label}: shard {i} page {pid} differs")


def _batch_equal(got, want, label: str) -> None:
    import torch
    from r2d2_tpu_torch.replay.structs import batch_fields
    for name, g in batch_fields(got).items():
        w = getattr(want, name)
        if name == "is_weights":
            # the importance weights' f32 pow: the card's powf and the
            # CPU's may round an ulp apart
            ok = torch.allclose(g.cpu(), w.cpu(), rtol=SERVICE_POW_RTOL,
                                atol=0)
        else:
            ok = torch.equal(g.cpu(), w.cpu())
        check(ok, f"{label}: sampled {name} differs")


def phase_service_vs_cpu(dev) -> dict:
    """17(a): card = CPU for the replay service (the tiny shape, 4-row
    shards), two shards, a tier of SERVICE_SPILL pages a shard, both
    routes at priority exponent 1 (the trees exact), then round robin at
    the configuration's exponent (the card's pow: the trees and the
    importance weights within SERVICE_POW_RTOL, the rest exact): 24
    stamped blocks in
    groups of SERVICE_K through ``add_blocks`` on the card, on the CPU, and
    block by block through ``add_block`` on the card; after each group
    three samples with the same injected draws (promotions inside), a
    group's first block added again between one sample and its write-back
    (the staleness guard, spilled rows), the write-backs (a leaf's
    priority a function of the leaf); the shards
    (rings, trees, spill pages in order with their stored priorities,
    demotion tables), the batches and the guard's counts equal. Then one
    shard with a cold tier samples exactly the plain ``replay_sample`` on
    the card. Returns the counts."""
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.fleet.replay_service import ReplayService
    from r2d2_tpu_torch.replay import device_replay as tdr
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    cpu = torch.device("cpu")
    base = dataclasses.replace(
        ReplaySpec.from_config(_tiny_config(), cpu), num_blocks=4,
        replay_diag=False)
    spec = dataclasses.replace(base, prio_exponent=1.0)
    rng = np.random.default_rng(17)
    blocks = []
    for k in range(24):
        blk = make_synthetic_block(spec, rng)
        blocks.append(dataclasses.replace(
            blk, lane=np.asarray(k % 3 if k % 4 != 3 else -1, np.int32),
            weight_version=np.asarray(k, np.int32)))
    report = {}
    runs = (("round_robin", spec, 0.0), ("lane", spec, 0.0),
            ("round_robin", base, SERVICE_POW_RTOL))
    for route, rspec, rtol in runs:
        label = (route if rspec is spec
                 else f"{route} exponent {rspec.prio_exponent}")
        kw = dict(spill_blocks=SERVICE_SPILL, route=route,
                  promote_per_sample=1)
        card = ReplayService(rspec, 2, dev, ingest_batch_blocks=SERVICE_K,
                             **kw)
        host = ReplayService(rspec, 2, cpu, ingest_batch_blocks=SERVICE_K,
                             **kw)
        seq = ReplayService(rspec, 2, dev, **kw)
        for i in range(0, len(blocks), SERVICE_K):
            group = blocks[i:i + SERVICE_K]
            routed = card.add_blocks(group)
            check(routed == host.add_blocks(group)
                  == [seq.add_block(b) for b in group],
                  f"17a {label}: routing differs")
            for s in range(3):
                u = torch.from_numpy(rng.random(spec.batch_size,
                                                dtype=np.float32))
                got = [svc.sample(uniform=u.to(svc.device))
                       for svc in (card, host, seq)]
                check(got[0][1:] == got[1][1:] == got[2][1:],
                      f"17a {label}: shard or token differs")
                _batch_equal(got[0][0], got[1][0], f"17a {label} card/CPU")
                _batch_equal(got[0][0], got[2][0],
                             f"17a {label} grouped/sequential")
                if s == 1:
                    for svc in (card, host, seq):
                        svc.add_block(group[0])
                # a leaf's new priority a function of the leaf: a batch's
                # repeated leaves write one value (which duplicate of a
                # scatter wins is unspecified on the card)
                td = 0.1 + 0.03 * (got[1][0].idxes % 97).float()
                for svc, (batch, shard, snap) in zip((card, host, seq), got):
                    svc.update_priorities(shard, batch.idxes,
                                          td.to(svc.device),
                                          adds_snapshot=snap)
            _service_equal(card, host, f"17a {label} card/CPU", rtol)
            _service_equal(card, seq, f"17a {label} grouped/sequential")
        check(sum(sh.spill.promotions for sh in card.shards) > 0
              and sum(sh.spill.demotions for sh in card.shards) > 0,
              f"17a {label}: the tier never turned")
        report[label] = {
            "adds": card.total_adds,
            "demotions": sum(sh.spill.demotions for sh in card.shards),
            "promotions": sum(sh.spill.promotions for sh in card.shards),
            "spilled_writebacks": card.spilled_writebacks,
            "stale_writebacks": card.stale_writebacks,
            "stale_rows_dropped": card.stale_rows_dropped,
            "ingest": card.interval_block()["ingest"]}
    cold = ReplayService(spec, 1, dev, spill_blocks=8, promote_per_sample=2)
    plain = tdr.replay_init(spec, dev)
    for blk in blocks[:3]:
        cold.add_block(blk)
        tdr.replay_add(spec, plain, blk)
    u = torch.from_numpy(rng.random(spec.batch_size, dtype=np.float32)).to(dev)
    batch, _, _ = cold.sample(uniform=u)
    check(cold.shards[0].spill.occupancy == 0, "17a: the cold tier spilled")
    want = tdr.replay_sample(spec, plain, uniform=u)
    for f in dataclasses.fields(batch):
        check(torch.equal(getattr(batch, f.name), getattr(want, f.name)),
              f"17a: the cold-tier sample's {f.name} is not replay_sample's")
    torch.cuda.synchronize()
    print(f"17a the replay service card = CPU ({_card()}): "
          + json.dumps(report), flush=True)
    return report


def phase_service_train(dev, bench_default_k1: float,
                        phase6: dict) -> tuple:
    """17(b): ``cli.train`` at the reference shape under the replay service
    (tools/service_probe.py ``train_under_service``: 2 shards, their rows
    sized from phase 6's thread run ``phase6`` (its report: blocks/s,
    SERVICE_TURNS), a tier of a shard's rows, grouped ingest at 8, spill
    prefetch, sample staging, every block traced, the tier stats; thread
    actors) for SERVICE_SECONDS, the counts set to 0 just before: the tier
    demotes and promotes, the ring turns over at least twice (blocks
    ingested over its rows), every record carries ``replay_service``
    (shards, spill with tiers and promotion latency, ingest) and a
    ``trace`` block has seen all three hops, no crit alert, and K1, K3, K4
    and K5 launched. Printed, not held: seq-updates/s over the run after
    the tool's WARM dispatches beside bench default K=1 of this call, the
    hit rate, stale and spilled write-backs, blocks
    per commit, the hops' p50, the service's host timings over the window
    (lock waits and holds by operation). Returns (launches, report)."""
    import tempfile
    import torch
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.telemetry.tracing import EXPERIENCE_HOPS
    from r2d2_tpu_torch.tools import service_probe as probe
    blocks_per_s = (phase6["env_steps_per_s_training"]
                    * phase6["blocks_ingested"] / phase6["env_steps"])
    shard_blocks = int(min(SERVICE_MAX_SHARD_BLOCKS, max(2, (
        SERVICE_RATE_SHARE * blocks_per_s * SERVICE_SECONDS
        / (SERVICE_TURNS * probe.SHARDS)))))
    ring_rows = probe.SHARDS * shard_blocks
    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as d:
        torch.cuda.empty_cache()
        _reset_counts()
        summary, service, marks, timings, records = \
            probe.train_under_service(shard_blocks, SERVICE_SECONDS, d)
        launches = _counts()
    check(service is not None, "17b: no dispatch reached the hook")
    check(summary["device"].startswith("cuda") and summary["steps"] > 0
          and all(math.isfinite(x) for x in summary["losses"]),
          f"17b: {summary['device']}, {summary['steps']} steps")
    demotions = sum(s.spill.demotions for s in service.shards)
    promotions = sum(s.spill.promotions for s in service.shards)
    check(demotions > 0 and promotions > 0,
          f"17b: demotions {demotions}, promotions {promotions}")
    turnovers = summary["blocks_ingested"] / ring_rows
    check(turnovers >= 2, f"17b: the ring turned over {turnovers} times")
    check(records and all(
        {"shards", "spill", "ingest"} <= set(r.get("replay_service", {}))
        and {"tiers", "promotion_latency"} <= set(
            r["replay_service"]["spill"]) for r in records),
        "17b: a record without its replay_service block")
    traces = [r["trace"] for r in records if "trace" in r]
    hops = {name: sum(t.get("hops", {}).get(name, {}).get("count", 0)
                      for t in traces) for name in EXPERIENCE_HOPS}
    check(traces and all(n > 0 for n in hops.values()),
          f"17b: trace hops {hops}")
    crit = [a for r in records for a in r["alerts"]["fired"]
            if a["severity"] == "crit"]
    check(not crit, f"17b: crit alerts {crit}")
    check(all(launches[n] > 0 for n in ("gather_windows", "stack_frames",
                                         "lstm_fwd", "lstm_bwd")),
          f"17b: launches {launches}")
    rate = probe.window_rate(marks, Config().replay.batch_size)
    check(rate is not None, f"17b: {len(marks)} dispatches")
    last = records[-1]["replay_service"]
    ingest = [r["replay_service"]["ingest"] for r in records]
    blocks = sum(i["blocks"] for i in ingest)
    commits = sum(i["dispatches"] for i in ingest)
    report = {
        "steps": summary["steps"], "env_steps": summary["env_steps"],
        "seq_updates_per_s": rate,
        "share_of_bench_default_k1": rate / bench_default_k1,
        "bench_default_k1": bench_default_k1,
        "shard_blocks": shard_blocks, "ring_turnovers": turnovers,
        "phase6_blocks_per_s": blocks_per_s,
        "turnover_s_at_phase6_rate": ring_rows / blocks_per_s,
        "demotions": demotions, "promotions": promotions,
        "hit_rate": last["spill"]["hit_rate"],
        "stale_writebacks": service.stale_writebacks,
        "spilled_writebacks": service.spilled_writebacks,
        "stale_rows_dropped": service.stale_rows_dropped,
        "blocks_per_commit": blocks / commits if commits else None,
        "hop_p50_ms": {name: traces[-1].get("hops", {}).get(name, {})
                       .get("p50_ms") for name in EXPERIENCE_HOPS},
        "e2e_p50_ms": traces[-1].get("e2e_experience_latency", {})
        .get("p50_ms"),
        "promotion_latency": last["spill"]["promotion_latency"],
        "tiers": last["spill"]["tiers"], "host_timings": timings,
        "launches": launches}
    print(f"17b service-routed cli.train, reference shape ({_card()}): "
          + json.dumps(report), flush=True)
    return launches, report


def phase_service_drill(dev) -> dict:
    """17(c): ``python -m r2d2_tpu_torch.fleet.service_main`` on the card
    at two shards (fleet/service_main.py ``run_kill_drill``): SIGKILLed
    mid-ingest and restarted; held: the producer survives (reconnects,
    replays its tail, every sent block acked), committed adds are
    monotone, the loss within DRILL_INTERVAL + window x group, the
    restart's cut bit-equal to the snapshot's. Printed: the restore's
    seconds and the reconnects."""
    from r2d2_tpu_torch.fleet.service_main import run_kill_drill
    report = run_kill_drill(DRILL_OVERRIDES, device=str(dev),
                            interval=DRILL_INTERVAL, timeout_s=90.0)
    check(all(report["verdict"].values()), f"17c: drill {report}")
    print(f"17c the standalone replay service's kill drill ({_card()}): "
          + json.dumps(report), flush=True)
    return report


def phase_replay_service(dev, bench_default_k1: float,
                         phase6: dict) -> dict:
    """Phase 17: (c)'s children start while (a) runs, then (b) alone.
    Returns (b)'s launches."""
    import concurrent.futures
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        drill = pool.submit(_timed, "17c", phase_service_drill, dev)
        _timed("17a", phase_service_vs_cpu, dev)
        drill.result()
    launches, _ = _timed("17b", phase_service_train, dev, bench_default_k1,
                         phase6)
    print(f"phase 17 {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from r2d2_tpu_torch.config import RuntimeConfig
    from r2d2_tpu_torch.tools import bench
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    dev = torch.device("cuda", 0)
    resolved_k = RuntimeConfig().resolved_steps_per_dispatch(dev)

    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"{phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_versions()
    phase_build()
    done("build")
    timings = phase_kernels(dev)
    phase_conv_layouts(dev)
    done("kernels")
    phase_small_step_vs_cpu(dev, {}, "default")
    phase_small_step_vs_cpu(dev, {"network.pallas_lstm": "on",
                                  "network.use_double": True},
                            "pallas_lstm on, double DQN")
    phase_reference_vs_cpu(dev)
    small = _tiny_config()
    small_blocks = bench.synthetic_blocks(small, small.num_blocks, seed=1)
    phase_external_vs_cpu(dev, small, small_blocks, 2, "default")
    fused_small = small.replace(**{"network.pallas_lstm": "on",
                                   "network.use_double": True})
    phase_external_vs_cpu(dev, fused_small, small_blocks, 2,
                          "pallas_lstm on, double DQN")
    ref_f32 = bench.reference_config(**{
        "replay.capacity": REF_CPU_BLOCKS * 400, "network.bf16": "off",
        "network.pallas_lstm": "on"})
    phase_external_vs_cpu(dev, ref_f32, bench.synthetic_blocks(
        ref_f32, REF_CPU_BLOCKS, seed=3), 1, "reference widths, f32")
    done("card vs CPU")
    base, spec, rs, blocks = phase_reference_replay(dev)
    phase_graph_vs_eager(dev, base, spec, rs)
    phase_external_graph_vs_eager(dev, base, blocks)
    done("graph vs eager")
    reference = phase_reference_step(dev, base, spec, rs, resolved_k,
                                     "--profile" in argv)
    done("reference paths")
    del rs
    torch.cuda.empty_cache()
    host_launches = phase_host_learner(dev, base, blocks)
    ref_blocks = blocks             # phase 11 refills its replay with them
    del blocks
    done("host path")
    launches = phase_cli(dev, [], "default", resolved_k)
    launches.update({name: n for name, n in
                     phase_cli(dev, FUSED_ARGS, "pallas_lstm on, double DQN",
                               resolved_k).items()
                     if name.startswith("lstm")})
    launches["gather_windows_padded"] = phase_cli(
        dev, PADDED_ARGS, "padded storage", resolved_k)["gather_windows"]
    done("sync_train")
    orchestrated, orch_reports = {}, []
    for i, (mode, extra, label) in enumerate(ORCH_RUNS):
        counted, orch_report = phase_orchestrated(
            dev, mode, extra, label, resolved_k,
            evaluate=i == len(ORCH_RUNS) - 1)
        orch_reports.append(orch_report)
        for name, n in counted.items():
            orchestrated[name] = max(orchestrated.get(name, 0), n)
    done("cli.train")
    phase_single_step_graph(dev)
    phase_learnability(dev)
    done("learnability")
    phase_anakin_vs_cpu(dev)
    segment_ms, _ = phase_anakin_graph(dev)
    anakin, _ = phase_anakin_train(
        dev, resolved_k,
        reference["fused", resolved_k]["median_seq_updates_per_s"],
        segment_ms)
    phase_anakin_learnability(dev)
    done("on-device acting")
    serving = phase_serving(dev, resolved_k,
                            reference["default", resolved_k]
                            ["median_seq_updates_per_s"])
    serve_launches = serving["serve_launches"]
    done("serving")
    anakin_quant = phase_ingest_recovery_quant(
        dev, resolved_k,
        reference["default", resolved_k]["median_seq_updates_per_s"],
        reference["fused", resolved_k]["median_seq_updates_per_s"],
        segment_ms)
    done("ingest, recovery, quantized on-device acting")
    sharded = phase_data_parallel(dev, ref_blocks)
    del ref_blocks
    done("data parallel")
    multihost = phase_multihost(
        dev, reference["fused", resolved_k]["median_seq_updates_per_s"],
        sharded["mh_card"])
    done("multi-host")
    parallel = phase_parallel_remainder(dev)
    done("tensor, dp x mp and sequence parallel")
    diagnostics = phase_diagnostics(dev)
    dq = diagnostics["graph"]["dq_launches_per_interval_step"]
    done("learning and replay diagnostics")
    bench_fused = reference["fused", resolved_k]["median_seq_updates_per_s"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as prof:
        phase_telemetry(dev, bench_fused, prof)
        done("telemetry")
        phase_planes(dev, bench_fused, prof)
    done("resources, compile, alerts, tracing, roofline")
    service = phase_replay_service(
        dev, reference["default", 1]["median_seq_updates_per_s"],
        orch_reports[0])
    done("replay service")

    source = {name: KERNEL_SOURCES["lstm_kernels" if name.startswith("lstm")
                                   else "replay_kernels"] for name in timings}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    b2b_ms=r["b2b_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    host_path_launches=host_launches.get(
                        name.replace("_padded", ""), 0),
                    orchestrated_launches=(0 if name.endswith("_padded")
                                           else orchestrated[name]),
                    anakin_launches=(0 if name.endswith("_padded")
                                     else anakin[name]),
                    serve_launches=(0 if name.endswith("_padded")
                                    else serve_launches[name]),
                    anakin_quant_launches=(0 if name.endswith("_padded")
                                           else anakin_quant[name]),
                    sharded_launches=(0 if name.endswith("_padded")
                                      else sharded["loop"][name]),
                    sharded_nccl_launches=(0 if name.endswith("_padded")
                                           else sharded["nccl"][name]),
                    multihost_launches=(0 if name.endswith("_padded")
                                        else multihost[name]),
                    tp_launches=(0 if name.endswith("_padded")
                                 else parallel["tp"][name]),
                    dpmp_launches=(0 if name.endswith("_padded")
                                   else parallel["dpmp"][name]),
                    sp_launches=(0 if name.endswith("_padded")
                                 else parallel["sp"][name]),
                    dq_launches_per_interval_step=(
                        0 if name.endswith("_padded") else dq.get(name, 0)),
                    service_launches=(0 if name.endswith("_padded")
                                      else service[name]))
               for name, r in timings.items()]
    kernels.append(dict(
        name="int8_linear", route="cuda", source=KERNEL_SOURCES["quant_kernels"],
        replaces=REPLACES["int8_linear"],
        launches=(serve_launches["int8_linear"]
                  + anakin_quant["int8_linear"]),
        max_abs_err=serving["max_abs_err"], ms=serving["ms"],
        b2b_ms=serving["b2b_ms"], plain_ms=serving["plain_ms"],
        bound_ms=serving["bound_ms"], bound_by=serving["bound_by"],
        library_ms=serving["library_ms"],
        library_b2b_ms=serving["library_b2b_ms"], host_path_launches=0,
        orchestrated_launches=0, anakin_launches=0,
        serve_launches=serve_launches["int8_linear"],
        anakin_quant_launches=anakin_quant["int8_linear"],
        sharded_launches=sharded["loop"]["int8_linear"],
        sharded_nccl_launches=sharded["nccl"]["int8_linear"],
        multihost_launches=multihost["int8_linear"],
        tp_launches=parallel["tp"]["int8_linear"],
        dpmp_launches=parallel["dpmp"]["int8_linear"],
        sp_launches=parallel["sp"]["int8_linear"],
        dq_launches_per_interval_step=0,
        service_launches=service["int8_linear"]))
    check(all(multihost[name] > 0 for name in (
        "gather_windows", "stack_frames", "lstm_fwd", "lstm_bwd")),
        f"phase 12 launched {multihost}")
    scan = ("stack_frames", "lstm_fwd", "lstm_fwd_lean", "lstm_bwd")
    check(all(parallel["tp"][n] > 0 for n in scan)
          and all(parallel["dpmp"][n] > 0 for n in scan + ("gather_windows",))
          and parallel["sp"]["lstm_fwd_lean"] > 0,
          f"phase 13 launched {parallel}")
    check(all(service[name] > 0 for name in (
        "gather_windows", "stack_frames", "lstm_fwd", "lstm_bwd")),
        f"phase 17 launched {service}")
    print(json.dumps({"kernels": kernels}), flush=True)
    total = time.perf_counter() - t0
    print(f"chip_smoke total {total:.1f} s (budget {BUDGET_S:.0f} s: "
          f"{'within' if total <= BUDGET_S else 'OVER'})", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
