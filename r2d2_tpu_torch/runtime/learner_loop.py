"""The learner: the train state, the replay, block ingestion with its rate
limiter, the training gate, one dispatch of learner steps per call, weight
publication, checkpoints and replay snapshots at interval boundaries, and
the metrics flush: the JAX package's ``Learner``.

Stage timers and spans (telemetry/core.py; on by default, off with
``telemetry.enabled=false``) are observed at the JAX package's points:
``ingest/ring_get``, ``ingest/stage`` and ``ingest/commit`` around
ingestion, ``learner/sample`` and ``learner/priority_writeback`` in the
host-placement threads, ``learner/train_dispatch`` around a dispatch's
launch, ``weights/publish``, ``recovery/snapshot_capture`` and
``learner/device_sync`` around the flush's one readback. They read the
host clock around host work and add no synchronisation; nothing is
observed inside a captured graph. The first flush attaches the one-shot
``costs`` block (telemetry/costmodel.py) with ``telemetry.costmodel_enabled``.

The learning and replay diagnostics (telemetry/learning.py,
telemetry/replaydiag.py; ``telemetry.enabled`` with
``telemetry.learning_enabled`` / ``telemetry.replay_diag_enabled``, on by
default) go into every step this learner builds: single, K-step graph,
host placement, tensor parallel, dp and dp x mp. Each dispatch's ``ld/``
and ``rd/`` values wait on the device until ``flush_metrics``, which
builds the record's ``learning`` and ``replay_diag`` blocks (host
placement: the host replay's readings for the tree and the evictions)
and applies ``telemetry.nan_policy``: under "halt" the error leaves the
flush, at the log boundary; a data-parallel run's followers then stop
through rank 0's stop command, as on any error of rank 0's loop.

Ingestion under device placement is per block (``replay.ingest_batch_blocks``
= 1: ``drain`` pops and ring-writes each block on the main thread) or
pipelined (K > 1): a stager thread pops what the feeder holds, rounded
down to a power of two up to K, into one of three pinned staging slots
(the shm ring copies straight from its slots), adds the blocks to the
staged counters, starts the slot's copy to the card on a stream of its
own and queues the batch (depth 2). ``drain`` commits queued batches on
the main thread, between dispatches: the current stream waits for the
copy's event, one ``replay_add_many`` writes the K blocks into the
replay's own tensors (the learner's CUDA graph keeps its addresses), an
event marks the commit, and the slot goes back to the stager, whose next
copy into it waits for that event. Staged blocks count toward the rate
limiter's budget, so the stager stops popping once collection is ahead.

Under ``replay.placement="device"`` the replay lives on the device and a
dispatch is ``runtime.steps_per_dispatch`` fused learner steps (one CUDA
graph of K steps on the card). Under "host" the replay is a
``HostReplay`` in host memory and a dispatch is one external-batch step
(one CUDA graph of one step on the card), fed by two threads:

* the prefetch thread samples, gathers into pinned staging memory, copies
  the batch to the card on a stream of its own and keeps
  ``runtime.prefetch_batches`` device batches queued, each with the event
  that ends its copy, which the step's stream waits on;
* the write-back thread takes each step's priorities, copied back to the
  host after the step, and applies them through the host replay's
  staleness guard. A full write-back queue drops the update and counts it
  in the metrics (``dropped_priority_updates``).

On the card a dispatch returns before the device has run it; the host
stays at most ``MAX_AHEAD`` dispatches ahead (an event a dispatch), so a
time bound ends with a short device tail and the step counter tells the
truth. Losses stay on the device until ``flush_metrics`` (one sync per
log interval) moves them to the metrics and to ``losses``.

Data parallel (``mesh.dp`` > 1, device placement; a ``Mesh`` from
parallel/mesh.py): each rank's learner holds one replay shard and a replica
of the train state, and the ranks run in lockstep by construction. Rank 0
decides everything (what to ingest, when to step, save and stop) and
announces each action to its followers with one small control message on
the host group (``command``) before the action's collectives; a follower
runs ``follow()``, which issues the same collectives in the same order.
Blocks go round-robin over the shards (``make_sharded_replay_add`` per
block, ``make_sharded_replay_add_many`` a staged batch, whose broadcast
the main thread issues at commit time); the gate also waits for a block in
every shard. Publication, checkpoints, metrics and the log are rank 0's:
the params are replicated bit-equal, so nothing is lost. A checkpoint
holds every rank's sampling generator state. No thread but the main one
issues a collective. Host placement takes no dp path at mesh.mp = 1, as
in the JAX package.

Tensor parallel (``mesh.mp`` > 1, parallel/tensor_parallel.py): the
ranks form a dp x mp grid and each holds feature shards of the train
state. Under device placement each dp row's ranks hold replicas of that
row's replay shard and run the dp x mp step. Under host placement rank 0
keeps the host replay and its prefetch and write-back threads; each step
it scatters every dp row its rows of the batch (``place_batch``, on the
main thread), the followers take theirs on its command, and the
priorities come back whole to rank 0. Publication and checkpoints gather
the full state over dp row 0 (``full_params``, ``save``), its followers
joining on rank 0's command.

The replay service (``fleet.replay_shards`` >= 1, device placement, no
mesh; fleet/replay_service.py): the blocks go to a ``ReplayService`` of
that many shards on the learner's device (per block, or with
``fleet.ingest_batch_blocks`` > 1 the drain's blocks as one grouped
``add_blocks``), the gate waits for a block in every shard, and a
dispatch is one external-batch step (one CUDA graph of one step on the
card) on a batch the service samples from its next shard with the
learner's service generator, its priorities written back to that shard
through the staleness guard. ``runtime.steps_per_dispatch`` is ignored
with the JAX package's warning. With ``fleet.sample_staging`` a prefetch
thread samples the next batch (its ready event ordering the gather before
the step's input copy; it alone reads the indices to the host) and a
write-back thread applies the priorities grouped by shard; both start
after the step's graph is captured (the third dispatch), the first two
dispatches taking the synchronous path, so no sample runs on another
thread during a capture. With ``telemetry.tracing_enabled`` the sampled
slots' lineage stamps feed an ``ExperienceTrace`` and the record's
``trace`` block. ``sample_jitter`` (tests) injects the descent's draws.

Crash recovery (``runtime.snapshot_interval`` > 0, device placement): at
each interval boundary the learner captures the replay between dispatches
(replay/snapshot.py: copies into pinned memory on the learner's stream,
no host sync) with its env-step counter and its sampling generator's
state, and a writer thread serializes it beside the checkpoints. Under a
mesh every dp row's shard is captured on its own rank (one replica a row),
sent to rank 0 over the host group, and written as one snapshot in the
JAX package's layout with the round-robin ``next_shard`` and every row's
generator state. A learner built with ``runtime.resume`` and
``runtime.restore_replay`` loads the newest committed snapshot before its
first dispatch (each rank its own shard), so it samples what its
uninterrupted twin would. Under the replay service the cut is the
service's (every shard, its spill pages and cursors) with the service
generator's state.
"""

import contextlib
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                               make_dispatch_step,
                                               make_external_batch_step)
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.ops.launch_counts import launch_counts
from r2d2_tpu_torch.parallel.sharded import (gather_objects,
                                             make_sharded_learner_step,
                                             make_sharded_replay_add_many,
                                             own_blocks, shard_seed,
                                             sharded_replay_init,
                                             state_digest)
from r2d2_tpu_torch.parallel.tensor_parallel import (
    gather_train_state, make_tp_external_batch_step, place_train_state)
from r2d2_tpu_torch.replay.device_replay import (WRITTEN, replay_add,
                                                 replay_add_many, replay_init)
from r2d2_tpu_torch.replay.host_replay import HostReplay, batch_layout
from r2d2_tpu_torch.replay.snapshot import (SnapshotWriter, capture_plain,
                                            capture_sharded, load_snapshot,
                                            restore_plain, shard_leaves)
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           SampleBatch, batch_fields,
                                           block_trace, empty_block_np,
                                           stack_blocks,
                                           torch_dtype)
from r2d2_tpu_torch.runtime.checkpoint import (apply_restore,
                                               prune_checkpoints,
                                               save_checkpoint)
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.runtime.supervisor import RESTARTS_ENV
from r2d2_tpu_torch.telemetry.costmodel import costs_block
from r2d2_tpu_torch.telemetry.learning import LearningAggregator, LearningDiag
from r2d2_tpu_torch.telemetry.replaydiag import (ReplayDiag,
                                                 ReplayDiagAggregator)
from r2d2_tpu_torch.telemetry.resources import (clear_player_buffers,
                                                pytree_nbytes,
                                                register_buffer)
from r2d2_tpu_torch.telemetry.tracing import (ExperienceTrace, now_ms,
                                              tracing_on)
from r2d2_tpu_torch.utils.device import configure_numerics

WRITEBACK_QUEUE = 64        # steps of priorities waiting for the host tree
TIMINGS_KEPT = 4096         # per-batch sample and copy times kept
LOSSES_KEPT = 100_000       # flushed per-step losses kept in ``losses``
MAX_AHEAD = 2               # dispatches the host may run ahead of the card
INGEST_QUEUE = 2            # staged batches waiting for their commit
# rank 0's commands to its followers (data parallel): (op, a, b)
OP_ADD = 1                  # a blocks starting at shard b
OP_STEP = 2                 # one dispatch
OP_SAVE = 3                 # gather the sampling generators (rank 0 saves)
OP_STOP = 4                 # gather the final reports and leave
OP_SNAP = 5                 # send this dp row's replay shard to rank 0
OP_GATHER = 6               # dp row 0 gathers the full params (mp > 1)
OP_USER = 16                # and up: a caller's handlers (the fused loop)


class _BatchPlacer:
    """Host batches to the card, off the step's stream: the host replay
    gathers into one of two pinned staging batches, a stream of its own
    copies that to new device tensors, and an event marks the end of the
    copy. A staging batch is gathered into again only once its last copy
    is done; that copy's time is read then."""

    STAGING = 2

    def __init__(self, spec: ReplaySpec, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = []
        for _ in range(self.STAGING):
            pinned = {name: torch.empty(shape, dtype=torch_dtype(dtype),
                                        pin_memory=True)
                      for name, (shape, dtype) in batch_layout(spec).items()}
            arrays = SampleBatch(**{name: t.numpy()
                                    for name, t in pinned.items()})
            self.slots.append([pinned, arrays, None])  # + (start, end) events
        self.next_slot = 0

    def place(self, host_replay: HostReplay, timings: dict):
        """(device batch, host idxes, adds snapshot, ready event)."""
        slot = self.slots[self.next_slot]
        self.next_slot = (self.next_slot + 1) % self.STAGING
        pinned, arrays, events = slot
        if events is not None:
            events[1].synchronize()
            timings["h2d_ms"].append(events[0].elapsed_time(events[1]))
        t0 = time.perf_counter()
        batch, snapshot = host_replay.sample(out=arrays)
        timings["sample_ms"].append((time.perf_counter() - t0) * 1e3)
        idxes = batch.idxes.copy()      # the staging batch is reused
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            device_batch = SampleBatch(**{
                name: t.to(self.device, non_blocking=True)
                for name, t in pinned.items()})
            end.record()
        slot[2] = (start, end)
        return device_batch, idxes, snapshot, end


def _ingest_stamp(trace_ms: int) -> int:
    """The commit's wall ms for a traced block (-1 for an untraced one)."""
    return now_ms() if trace_ms >= 0 else -1


class _IngestStaging:
    """The stager's slots: INGEST_QUEUE + 1 of them (the queue's batches
    and the one being filled), each K blocks of host buffers (pinned on
    CUDA) and, on CUDA, K blocks of device buffers for the written fields,
    allocated once. A slot's device buffers are written by its copy on
    ``stream`` after the event of its last commit, and its host buffers
    refilled only after its last copy has read them."""

    def __init__(self, spec: ReplaySpec, k: int, device: torch.device,
                 tracing: bool = False):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.free: queue.Queue = queue.Queue()
        proto = empty_block_np(spec)
        self.device_bytes = 0
        for _ in range(INGEST_QUEUE + 1):
            host = {name: torch.empty((k,) + a.shape,
                                      dtype=torch_dtype(a.dtype),
                                      pin_memory=self.cuda)
                    for name, a in proto.items()}
            arrays = {name: t.numpy() for name, t in host.items()}
            if tracing:
                # the blocks' lineage stamps: host-side, never copied
                arrays["trace_ms"] = np.full((k,), -1, np.int32)
            slot = _Slot(
                arrays=arrays, host=host,
                dev=({name: torch.empty_like(host[name], device=device)
                      for name in WRITTEN} if self.cuda else None))
            if slot.dev is not None:
                self.device_bytes += sum(t.nbytes for t in slot.dev.values())
            self.free.put(slot)

    def blocks(self, slot: "_Slot", k: int) -> Block:
        """The slot's first ``k`` blocks as the commit reads them: device
        tensors for the written fields (on the CPU, the host buffers)."""
        src = slot.dev if self.cuda else slot.host
        fields = {name: a[:k] for name, a in slot.arrays.items()
                  if name != "trace_ms"}
        fields.update({name: src[name][:k] for name in WRITTEN})
        return Block(**fields)


class _Slot:
    def __init__(self, arrays, host, dev):
        self.arrays = arrays        # numpy views of ``host``
        self.host = host
        self.dev = dev
        self.copied: Optional[torch.cuda.Event] = None
        self.consumed: Optional[torch.cuda.Event] = None


class Learner:
    def __init__(self, cfg: Config, net: NetworkApply,
                 seed: Optional[int] = None, *, player_idx: int = 0,
                 metrics: Optional[TrainMetrics] = None, mesh=None):
        """``seed``: runtime.seed by default, offset by 1000 a player.
        ``metrics``: an in-memory ``TrainMetrics`` by default (no files).
        ``runtime.resume``/``pretrain`` load here, before any step is
        captured. ``mesh``: this rank's ``parallel.mesh.Mesh`` of a
        data-parallel run (device placement) or a tensor-parallel one
        (``mesh.mp`` > 1, either placement); rank 0 drives, the others
        ``follow()``; None = one device."""
        configure_numerics()
        self.cfg = cfg
        self.net = net
        self.player_idx = player_idx
        self.device = net.device
        self.spec = ReplaySpec.from_config(cfg, self.device)
        host = cfg.replay.placement == "host"
        if mesh is not None and host and mesh.mp == 1:
            raise ValueError("replay.placement='host' takes no data-parallel"
                             " path at mesh.mp=1: build the Learner without "
                             "a mesh")
        if mesh is None and (cfg.mesh.mp > 1
                             or (cfg.mesh.dp > 1 and not host)):
            raise ValueError(
                f"mesh.dp={cfg.mesh.dp} x mesh.mp={cfg.mesh.mp}: a data- or "
                "tensor-parallel Learner needs its rank's Mesh "
                "(parallel/mesh.py make_mesh; cli.train --mesh.dp=N "
                "--mesh.mp=M starts the ranks)")
        self.mesh = mesh
        self._tp = mesh is not None and mesh.mp > 1
        self.host_mode = host
        seed = (cfg.runtime.seed if seed is None else seed) \
            + 1000 * player_idx
        use_double = cfg.network.use_double
        self.train_state = create_train_state(net, cfg.optim, seed,
                                              use_double)
        rank = 0
        if mesh is not None:
            rank = mesh.rank
            # a dp row's replicas draw alike
            self.train_state.generator.manual_seed(shard_seed(
                seed + 1, mesh.dp_rank))
        resumed_env_steps = apply_restore(cfg.runtime, self.train_state,
                                          rank=rank)
        self.metrics = metrics or TrainMetrics(player_idx, log_dir=None)
        self._costs_attached = False
        # the learning and replay diagnostics: the steps' specs, and the
        # host aggregators of their per-dispatch values (rank 0's)
        diag = LearningDiag.from_config(cfg)
        rdiag = ReplayDiag.from_config(cfg)
        self._learning_agg = (LearningAggregator(
            player_idx, cfg.runtime.save_dir, cfg.telemetry.nan_policy,
            cfg.optim.lr) if diag is not None else None)
        self._replay_agg = (ReplayDiagAggregator(rdiag.lanes)
                            if rdiag is not None else None)
        # wired by the orchestrator beside ``publish``: () -> the weight
        # service's publication count, the clock of the sample ages
        # (None: the ages are not reported)
        self.weight_version_fn: Optional[Callable[[], int]] = None
        # wired by the orchestrator: publish(params module)
        self.publish: Optional[Callable] = None
        self.host_replay: Optional[HostReplay] = None
        # tensor parallel: rank 0's scatter of a host batch (host
        # placement) and the full network publication gathers into
        self._place_batch: Optional[Callable] = None
        self._full_view: Optional[torch.nn.Module] = None
        self.service = None
        self._exp_trace: Optional[ExperienceTrace] = None
        if host:
            if cfg.runtime.steps_per_dispatch > 1:
                logging.getLogger(__name__).warning(
                    "replay.placement='host': ignoring "
                    "runtime.steps_per_dispatch=%d (host mode trains one "
                    "host-sampled batch per step)",
                    cfg.runtime.steps_per_dispatch)
            self.steps_per_dispatch = 1
            self.replay_state = None
            if mesh is None or mesh.leader:
                self.host_replay = HostReplay(self.spec, seed=seed)
                self.ring = self.host_replay.ring
            else:
                self.ring = RingAccountant(self.spec.num_blocks)
            if self._tp:
                self._step_fn, place_state, self._place_batch = \
                    make_tp_external_batch_step(net, self.spec, cfg.optim,
                                                use_double, mesh, diag=diag,
                                                rdiag=rdiag)
                self.train_state = place_state(self.train_state)
            else:
                self._step_fn = make_external_batch_step(
                    net, self.spec, cfg.optim, use_double, diag=diag,
                    rdiag=rdiag)
            self._prefetch_q: queue.Queue = queue.Queue(
                maxsize=max(1, cfg.runtime.prefetch_batches))
            self._writeback_q: queue.Queue = queue.Queue(
                maxsize=WRITEBACK_QUEUE)
            self._bg_stop = threading.Event()
            self._bg_threads: List[threading.Thread] = []
            self._bg_error: Optional[BaseException] = None
            # per batch, in the prefetch thread: the sample's host ms and
            # (on CUDA) its copy's device ms
            self.timings = {"sample_ms": deque(maxlen=TIMINGS_KEPT),
                            "h2d_ms": deque(maxlen=TIMINGS_KEPT)}
        elif cfg.fleet.replay_shards >= 1:
            self._init_service(cfg, net, seed, diag, rdiag)
        elif mesh is not None:
            if self._tp:
                self.train_state = place_train_state(
                    self.train_state, net, cfg.optim, mesh)
            self.replay_state = sharded_replay_init(self.spec, mesh)
            # rank 0 accounts for every shard: dp rings of num_blocks
            self.ring = RingAccountant(self.spec.num_blocks * mesh.dp)
            self.steps_per_dispatch = \
                cfg.runtime.resolved_steps_per_dispatch(self.device)
            self._step_fn = make_sharded_learner_step(
                net, self.spec, cfg.optim, use_double, mesh,
                self.steps_per_dispatch, diag=diag, rdiag=rdiag)
            self._sharded_add_many = make_sharded_replay_add_many(self.spec,
                                                                  mesh)
        else:
            self.replay_state = replay_init(self.spec, self.device)
            self.ring = RingAccountant(self.spec.num_blocks)
            self.steps_per_dispatch = \
                cfg.runtime.resolved_steps_per_dispatch(self.device)
            self._step_fn = make_dispatch_step(
                net, self.spec, cfg.optim, use_double,
                self.steps_per_dispatch, diag=diag, rdiag=rdiag)
        self.env_steps = resumed_env_steps
        # data parallel: the shard the next block goes to (rank 0), the
        # blocks written into this rank's shard, the final reports of every
        # rank (rank 0, after the stop) and whether a collective failed
        self._next_shard = 0
        self.shard_blocks = 0
        self.shard_reports: Optional[List[dict]] = None
        self._mesh_failed = False
        self._followers_released = False
        # pipelined ingestion (device placement, K > 1): the stager thread,
        # its slots and queue, and what it has popped but not committed
        # (the service commits its own groups: fleet.ingest_batch_blocks)
        self._ingest_k = (1 if host or self.service is not None else min(
            cfg.replay.resolved_ingest_batch_blocks(self.device),
            self.spec.num_blocks))
        self.metrics.set_ingest_batching(self._ingest_k)
        self._stager: Optional[threading.Thread] = None
        self._staging: Optional[_IngestStaging] = None
        self._ingest_stop = threading.Event()
        self._ingest_q: queue.Queue = queue.Queue(maxsize=INGEST_QUEUE)
        self._ingest_error: Optional[BaseException] = None
        # false once a stop gave up committing: a parked stager then drops
        # its batch instead of waiting for a commit
        self._stager_may_put = True
        self._staged_env_steps = 0
        self._staged_blocks = 0
        self._staged_lock = threading.Lock()
        # host ms a staged batch (stager) and a commit (main thread)
        self.ingest_ms = {"stage": deque(maxlen=TIMINGS_KEPT),
                          "commit": deque(maxlen=TIMINGS_KEPT)}
        # crash recovery: the snapshot writer, and what the record reports
        self._snap_writer: Optional[SnapshotWriter] = None
        self._restores = 0
        self._restored_blocks = 0
        # host ms of each capture (the record reports the newest)
        self.snapshot_capture_ms: deque = deque(maxlen=TIMINGS_KEPT)
        # adds committed at the newest snapshot: what a crash would lose
        self._snap_adds = 0
        if not host:
            if cfg.runtime.snapshot_interval > 0 and (mesh is None
                                                      or mesh.leader):
                self._snap_writer = SnapshotWriter(cfg.runtime.save_dir,
                                                   player_idx)
            if cfg.runtime.resume and cfg.runtime.restore_replay:
                self._restore_replay_snapshot()
        self._last_saved_step = self.train_state.step
        # the rate limiter's budget counts from this process's start: a
        # resumed run restores large counters over an empty ring
        self._ratio_env_base = self.env_steps
        self._ratio_step_base = self.train_state.step
        self._pause_started: Optional[float] = None
        # per dispatch: a device scalar (K = 1) or a (K,) tensor; no sync
        self._pending_losses: List[torch.Tensor] = []
        self._flushed_losses: deque = deque(maxlen=LOSSES_KEPT)
        self._in_flight: deque = deque()
        # host milliseconds of the newest publish calls and saves
        self.publish_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.save_ms: deque = deque(maxlen=TIMINGS_KEPT)
        # buffer attribution for the resources block (names re-registered
        # by a rebuilt Learner; the previous incarnation's cleared first)
        self._resources_on = (cfg.telemetry.enabled
                              and cfg.telemetry.resources_enabled)
        if self._resources_on:
            clear_player_buffers(player_idx)
            register_buffer(f"p{player_idx}/train_state",
                            pytree_nbytes(self.train_state))
            if self.replay_state is not None:
                register_buffer(f"p{player_idx}/replay_ring",
                                pytree_nbytes(self.replay_state))
            if self.service is not None:
                register_buffer(f"p{player_idx}/replay_service",
                                self.service.device_bytes)

    def _init_service(self, cfg: Config, net: NetworkApply, seed: int,
                      diag, rdiag) -> None:
        """The replay service's learner (the module docstring): the
        service, its generator (seeded ``seed`` + 777), the external step
        over a shard's spec, the trace and the staging threads' state."""
        from r2d2_tpu_torch.fleet.replay_service import build_service
        if cfg.runtime.steps_per_dispatch > 1:
            logging.getLogger(__name__).warning(
                "fleet.replay_shards: ignoring runtime.steps_per_dispatch=%d"
                " (the service-routed learner trains one service-sampled "
                "batch per step)", cfg.runtime.steps_per_dispatch)
        self.service = build_service(cfg, self.device)
        self.ring = self.service
        self.replay_state = None
        self.steps_per_dispatch = 1
        self._step_fn = make_external_batch_step(
            net, self.service.spec, cfg.optim, cfg.network.use_double,
            diag=diag, rdiag=rdiag)
        self._service_gen = torch.Generator(
            device=self.device).manual_seed(seed + 777)
        # tests: () -> the next sample's (B,) jitter, in sample order
        self.sample_jitter: Optional[Callable[[], torch.Tensor]] = None
        if tracing_on(cfg):
            self._exp_trace = ExperienceTrace(cfg.telemetry.trace_sample_every)
            self.metrics.set_tracing(self._exp_trace.interval_block)
        self._svc_staging = cfg.fleet.sample_staging
        self._svc_prefetch_q: queue.Queue = queue.Queue(maxsize=2)
        self._svc_writeback_q: queue.Queue = queue.Queue(
            maxsize=WRITEBACK_QUEUE)
        self._svc_stop = threading.Event()
        self._svc_threads: List[threading.Thread] = []
        self._svc_error: Optional[BaseException] = None

    def _restore_replay_snapshot(self) -> None:
        """Load the newest committed replay snapshot beside the
        checkpoint: the replay's tensors (copied in place), the ring
        accountant, the sampling generator and the env-step counter (the
        later of the checkpoint's and the snapshot's). Under a mesh: this
        rank's dp shard, its row's generator and the round-robin
        ``next_shard``. No snapshot: the checkpoint alone is restored."""
        snap = load_snapshot(self.cfg.runtime.save_dir, self.player_idx)
        if snap is None:
            return
        gen = self.train_state.generator
        if self.service is not None:
            self.service.restore_state(snap)
            gen = self._service_gen
            state = snap["extra"].get("service_generator_state")
        elif self.mesh is None:
            restore_plain(self.spec, self.replay_state, self.ring, snap)
            state = snap["extra"].get("generator_state")
        else:
            restore_plain(self.spec, self.replay_state, self.ring, snap,
                          shard=self.mesh.dp_rank, dp=self.mesh.dp)
            self._next_shard = int(snap["extra"].get("next_shard", 0))
            states = snap["extra"].get("generator_states")
            state = None if states is None else states[self.mesh.dp_rank]
        if state is not None:
            state = torch.tensor(state, dtype=torch.uint8)
            if state.numel() == gen.get_state().numel():
                gen.set_state(state)
            else:
                logging.getLogger(__name__).warning(
                    "the replay snapshot's sampling generator state was "
                    "saved on another device type; keeping the "
                    "checkpoint's")
        self._restores = 1
        self._restored_blocks = sum(s["ring"]["total_adds"]
                                    for s in snap["shards"])
        self._snap_adds = self.ring.total_adds
        env_steps = snap["extra"].get("env_steps")
        if env_steps is not None:
            self.env_steps = max(self.env_steps, int(env_steps))
        self.metrics.set_buffer_size(self.ring.buffer_steps)

    @property
    def dropped_priority_updates(self) -> int:
        return self.metrics.dropped_priority_updates

    @property
    def losses(self) -> List[float]:
        """Every step's loss (the newest LOSSES_KEPT), flushed first."""
        self._flush_losses()
        return list(self._flushed_losses)

    @property
    def tele(self):
        """The process's Telemetry, read through the metrics each time:
        the caller may attach it after this Learner was built."""
        return self.metrics.telemetry

    # -- ingestion --

    def ingest(self, block: Block) -> None:
        """Ring-write one actor block. Its lineage stamp (``trace_ms``,
        tracing on) goes into the ring accountant's mirrors with the
        commit's wall ms, never to the device."""
        learning = int(np.asarray(block.learning_steps).sum())
        stamp = block_trace(block)
        trace = -1 if stamp is None else int(np.asarray(stamp))
        if self.host_replay is not None:
            self.host_replay.add(block, trace_ms=trace,
                                 ingest_ms=_ingest_stamp(trace))
        elif self.service is not None:
            # routed; the shard's accountant and the spill tier's demotion
            # of what the write overwrote advance inside the service
            self.service.add_block(block)
        elif self.mesh is not None:
            self._add_to_shards(stack_blocks([block]), 1)
            self.ring.advance(learning, int(np.asarray(block.weight_version)),
                              trace, _ingest_stamp(trace))
        else:
            replay_add(self.spec, self.replay_state, block)
            self.ring.advance(learning, int(np.asarray(block.weight_version)),
                              trace, _ingest_stamp(trace))
        self.env_steps += learning
        ret = float(np.asarray(block.sum_reward))
        self.metrics.on_block(learning, None if np.isnan(ret) else ret)
        self.metrics.set_buffer_size(self.ring.buffer_steps)

    @property
    def ingestion_paused(self) -> bool:
        """Rate limiter (replay.max_env_steps_per_train_step): true once
        collection is ahead of learning by the budget; blocks left in the
        bounded queue then park the actors. Staged blocks count as
        collected, in the budget and in the gate alike: they commit at the
        next drain whatever happens. Never true while the training gate is
        closed: only ingestion can open it."""
        ratio = self.cfg.replay.max_env_steps_per_train_step
        if ratio <= 0:
            return False
        with self._staged_lock:
            staged_steps = self._staged_env_steps
            staged_blocks = self._staged_blocks
        if not self._gate_open(staged_blocks, staged_steps):
            return False
        budget = (self.cfg.replay.learning_starts + ratio * max(
            self.train_state.step - self._ratio_step_base, 1))
        return (self.env_steps + staged_steps
                - self._ratio_env_base) >= budget

    def _note_pause(self, paused: bool) -> None:
        if paused:
            if self._pause_started is None:
                self._pause_started = time.time()
        elif self._pause_started is not None:
            self.metrics.on_ingest_pause(time.time() - self._pause_started)
            self._pause_started = None

    def drain(self, queue, max_items: Optional[int] = None) -> int:
        """Move up to ``max_items`` (replay.drain_max_blocks) blocks from
        the feeder queue into the replay, unless the rate limiter pauses
        ingestion. Pipelined (K > 1): commit up to replay.drain_max_blocks
        of what the stager has staged, starting it on the first call.
        Returns the blocks ingested."""
        if self._ingest_k > 1:
            return self._drain_pipelined(queue)
        if max_items is None:
            max_items = self.cfg.replay.drain_max_blocks
        paused = self.ingestion_paused
        self._note_pause(paused)
        if paused:
            return 0
        t0 = time.time()
        blocks = queue.drain(max_items)
        t_get = time.time()
        grouped = (self.service is not None and self.service.ingest_k > 1)
        if grouped and len(blocks) > 1:
            self._ingest_group(blocks)
        else:
            for blk in blocks:
                self.ingest(blk)
        if grouped:
            # the producer-side depth this drain left (ingest_backlog)
            self.service.note_backlog(queue.qsize())
        if blocks:
            t1 = time.time()
            self.metrics.on_ingest_drain(len(blocks), t1 - t0)
            tele = self.tele
            tele.observe("ingest/ring_get", t_get - t0)
            tele.observe("ingest/commit", t1 - t_get)
            tele.record_span("ingest/commit", t0, t1,
                             {"blocks": len(blocks)})
        return len(blocks)

    def _ingest_group(self, blocks: List[Block]) -> None:
        """The drain's blocks as one grouped service commit, with the
        per-block accounting ``ingest`` does."""
        self.service.add_blocks(blocks)
        for block in blocks:
            learning = int(np.asarray(block.learning_steps).sum())
            self.env_steps += learning
            ret = float(np.asarray(block.sum_reward))
            self.metrics.on_block(learning, None if np.isnan(ret) else ret)
        self.metrics.set_buffer_size(self.ring.buffer_steps)

    # -- pipelined ingestion: the stager thread and the commit --

    def _drain_pipelined(self, feeder) -> int:
        if self._ingest_error is not None:
            raise RuntimeError("ingest stager thread died"
                               ) from self._ingest_error
        if self._stager is None or not self._stager.is_alive():
            self._start_stager(feeder)
        committed = 0
        # the per-drain cap of the per-block path: a producer ahead of the
        # learner cannot keep this loop from training
        while committed < self.cfg.replay.drain_max_blocks:
            try:
                item = self._ingest_q.get_nowait()
            except queue.Empty:
                break
            committed += self._commit_staged(*item)
        self.metrics.set_ingest_queue_depth(self._ingest_q.qsize())
        return committed

    def _commit_staged(self, slot: _Slot, k: int, metas, t_pop: float
                       ) -> int:
        """One replay_add_many of a staged batch on the current stream,
        after its copy; then the ring, env-step, metric and staged-counter
        accounting the per-block path does block by block."""
        t_commit = time.time()
        t0 = time.perf_counter()
        staging = self._staging
        if staging.cuda:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(slot.copied)
        if self.mesh is not None:
            self._add_to_shards(staging.blocks(slot, k), k)
        else:
            replay_add_many(self.spec, self.replay_state,
                            staging.blocks(slot, k))
        if staging.cuda:
            slot.consumed = torch.cuda.Event()
            slot.consumed.record(current)
        staging.free.put(slot)
        total = 0
        for learning, ret, wv, trace in metas:
            self.ring.advance(learning, wv, trace, _ingest_stamp(trace))
            self.metrics.on_block(learning, ret)
            total += learning
        self.env_steps += total
        with self._staged_lock:
            self._staged_env_steps -= total
            self._staged_blocks -= k
        self.metrics.set_buffer_size(self.ring.buffer_steps)
        ms = (time.perf_counter() - t0) * 1e3
        self.ingest_ms["commit"].append(ms)
        self.metrics.on_ingest_commit(ms)
        now = time.time()
        self.metrics.on_ingest_drain(k, now - t_pop)
        self.tele.observe("ingest/commit", now - t_commit)
        self.tele.record_span("ingest/commit", t_commit, now, {"blocks": k})
        return k

    def _stage(self, feeder, want: int) -> bool:
        """Pop up to ``want`` blocks into a free slot, count them as
        staged, start their copy and queue the batch. False if the feeder
        was empty or the stager is stopping."""
        staging = self._staging
        while True:
            try:
                slot = staging.free.get(timeout=0.2)
                break
            except queue.Empty:
                if self._ingest_stop.is_set():
                    return False
        t_pop = time.time()
        t0 = time.perf_counter()
        if slot.copied is not None:
            slot.copied.synchronize()    # its last copy has read the rows
        stacked, k = feeder.drain_stacked(want, out=slot.arrays)
        if k == 0:
            staging.free.put(slot)
            return False
        self.tele.observe("ingest/ring_get", time.time() - t_pop)
        learning = stacked.learning_steps.sum(axis=1).astype(np.int64)
        rets = stacked.sum_reward
        wvs = stacked.weight_version
        traces = block_trace(stacked)
        metas = [(int(learning[i]),
                  None if np.isnan(rets[i]) else float(rets[i]),
                  int(wvs[i]), -1 if traces is None else int(traces[i]))
                 for i in range(k)]
        with self._staged_lock:
            self._staged_env_steps += int(learning.sum())
            self._staged_blocks += k
        if staging.cuda:
            with torch.cuda.stream(staging.stream):
                if slot.consumed is not None:
                    staging.stream.wait_event(slot.consumed)
                for name in WRITTEN:
                    slot.dev[name][:k].copy_(slot.host[name][:k],
                                             non_blocking=True)
                slot.copied = torch.cuda.Event()
                slot.copied.record(staging.stream)
        ms = (time.perf_counter() - t0) * 1e3
        self.ingest_ms["stage"].append(ms)
        self.metrics.on_ingest_stage(ms)
        now = time.time()
        self.tele.observe("ingest/stage", now - t_pop)
        self.tele.record_span("ingest/stage", t_pop, now, {"blocks": k})
        # a full queue is back-pressure, not staging work: untimed
        while True:
            try:
                self._ingest_q.put((slot, k, metas, t_pop), timeout=0.2)
                return True
            except queue.Full:
                if self._ingest_stop.is_set() and not self._stager_may_put:
                    return True

    def _start_stager(self, feeder) -> None:
        if self._staging is None:
            self._staging = _IngestStaging(self.spec, self._ingest_k,
                                           self.device,
                                           tracing=tracing_on(self.cfg))
            if self._resources_on:
                register_buffer(f"p{self.player_idx}/ingest_staging",
                                self._staging.device_bytes)
        self._ingest_stop.clear()
        self._stager_may_put = True

        def stage_loop():
            try:
                while not self._ingest_stop.is_set():
                    paused = self.ingestion_paused
                    self._note_pause(paused)
                    if paused:
                        time.sleep(0.002)
                        continue
                    # what is queued now, rounded down to a power of two:
                    # batches grow under load on their own, while a full
                    # staging queue lets the feeder accumulate
                    avail = feeder.qsize()
                    if avail == 0:
                        time.sleep(0.001)
                        continue
                    want = self._ingest_k
                    if 0 < avail < want:
                        want = 1 << (avail.bit_length() - 1)
                    if not self._stage(feeder, want):
                        time.sleep(0.001)
            except BaseException as e:      # raised by _drain_pipelined
                self._ingest_error = e

        self._stager = threading.Thread(
            target=stage_loop, daemon=True,
            name=f"learner-ingest-stager-p{self.player_idx}")
        self._stager.start()

    def _stop_stager(self, join_timeout: float) -> List[str]:
        """Stop the stager and commit every batch it staged, so each
        popped block lands; returns the name of a stager still running."""
        if self._stager is None:
            return []
        self._ingest_stop.set()
        deadline = time.monotonic() + join_timeout
        try:
            while True:
                while True:
                    try:
                        item = self._ingest_q.get_nowait()
                    except queue.Empty:
                        break
                    self._commit_staged(*item)
                if not self._stager.is_alive() \
                        or time.monotonic() >= deadline:
                    break
                self._stager.join(timeout=0.05)
        except Exception:
            logging.getLogger(__name__).exception(
                "committing the staged batches at shutdown failed")
        if self._stager.is_alive():
            self._stager_may_put = False
            return [self._stager.name]
        self._stager = None
        return []

    def _gate_open(self, extra_blocks: int = 0, extra_steps: int = 0
                   ) -> bool:
        """The training gate's condition, shared by ``ready`` (committed
        blocks) and the rate limiter (committed and staged)."""
        if (self.mesh is not None and not self.host_mode
                and self.ring.total_adds + extra_blocks < self.mesh.dp):
            return False
        if self.service is not None and not self.service.all_shards_nonempty:
            # a block in every shard first (an empty tree's weights are NaN)
            return False
        return (self.ring.buffer_steps + extra_steps
                >= self.cfg.replay.learning_starts)

    @property
    def ready(self) -> bool:
        """Training gate: replay.learning_starts buffered learning steps;
        under a data-parallel mesh also a block in every shard (sampling
        an empty shard's tree gives NaN importance weights)."""
        return self._gate_open()

    @property
    def warm(self) -> bool:
        """Two dispatches taken in this process: the eager warm-up and
        the one that captures the step's graph (the compile telemetry's
        end of warm-up)."""
        return (self.train_state.step - self._ratio_step_base
                >= 2 * self.steps_per_dispatch)

    # -- data parallel: rank 0's commands and the followers' loop --

    def command(self, op: int, a: int = 0, b: int = 0) -> None:
        """Rank 0: announce an action to the followers, ahead of its
        collectives."""
        if self._mesh_failed:
            raise RuntimeError("a collective of this data-parallel run "
                               "failed earlier")
        msg = torch.tensor([op, a, b], dtype=torch.int64)
        try:
            dist.broadcast(msg, src=0, group=self.mesh.ctrl_group)
        except Exception:
            self._mesh_failed = True
            raise

    def _add_to_shards(self, blocks: Block, k: int) -> None:
        """Rank 0: K stacked blocks round-robin over the shards from
        ``_next_shard``, announced first."""
        self.command(OP_ADD, k, self._next_shard)
        self._shard_add(blocks, k, self._next_shard)
        self._next_shard = (self._next_shard + k) % self.mesh.dp

    def _shard_add(self, blocks: Optional[Block], k: int, start: int
                   ) -> None:
        try:
            self._sharded_add_many(self.replay_state, blocks, start, k)
        except Exception:
            self._mesh_failed = True
            raise
        self.shard_blocks += len(own_blocks(k, start, self.mesh))

    def _report(self) -> dict:
        """This rank's part of the final reports."""
        return {"rank": self.mesh.rank, "device": str(self.device),
                "steps": self.train_state.step,
                "shard_blocks": self.shard_blocks,
                "state_sha256": state_digest(self.train_state),
                "launches": launch_counts()}

    def release_followers(self) -> None:
        """Rank 0: the stop, once; every rank's final report is gathered
        into ``shard_reports``. Skipped after a failed collective (the
        launcher kills the followers then)."""
        if (self.mesh is None or not self.mesh.leader
                or self._followers_released or self._mesh_failed):
            return
        self._followers_released = True
        self.command(OP_STOP)
        self.shard_reports = gather_objects(self._report(), self.mesh)

    def follow(self, handlers: Optional[dict] = None) -> int:
        """A follower's loop: run rank 0's commands, issuing the same
        collectives in the same order, until its stop. ``handlers``: the
        caller's ops (>= OP_USER) as ``op -> fn(a, b)``. Returns the
        learner steps taken."""
        if self.mesh is None or self.mesh.leader:
            raise ValueError("follow() is a follower rank's loop")
        handlers = handlers or {}
        msg = torch.zeros(3, dtype=torch.int64)
        while True:
            dist.broadcast(msg, src=0, group=self.mesh.ctrl_group)
            op, a, b = msg.tolist()
            if op == OP_ADD:
                self._shard_add(None, a, b)
            elif op == OP_STEP:
                self._dispatch()
            elif op == OP_SAVE:
                gather_objects(self.train_state.generator.get_state(),
                               self.mesh)
                if self._tp and self.mesh.dp_rank == 0:
                    gather_train_state(self.train_state, self.net,
                                       self.cfg.optim)
            elif op == OP_SNAP:
                self._capture_shards()
            elif op == OP_GATHER:
                if self.mesh.dp_rank == 0:
                    self._gather_params()
            elif op == OP_STOP:
                self.shard_reports = gather_objects(self._report(),
                                                    self.mesh)
                return self.train_state.step
            elif op in handlers:
                handlers[op](a, b)
            else:
                raise RuntimeError(f"unknown command {op} from rank 0")

    @property
    def training_steps(self) -> int:
        return self.train_state.step

    def full_params(self) -> torch.nn.Module:
        """The online network as one unsharded module, what publication
        and the policy server take (rank 0). Under ``mesh.mp`` > 1 dp row
        0 gathers the shards into a module of its own (the same one every
        call), its followers joining on command."""
        if not self._tp:
            return self.train_state.params
        self.command(OP_GATHER)
        return self._gather_params()

    def _gather_params(self) -> torch.nn.Module:
        full = self.train_state.params.full_state_dict()
        if self._full_view is None:
            self._full_view = self.net.build().requires_grad_(False)
        with torch.no_grad():
            for name, p in self._full_view.named_parameters():
                p.copy_(full[name])
        return self._full_view

    # -- training --

    def step(self, uniform: Optional[torch.Tensor] = None) -> dict:
        """One dispatch: ``steps_per_dispatch`` learner steps
        (``training_steps`` advances by that many). ``uniform``: the
        jitter, (B,) for one step a dispatch, else (K, B); none under host
        placement, whose host replay draws its own. Publishes and saves
        when an interval boundary falls inside the dispatch."""
        prev = self.train_state.step
        if self.mesh is not None:
            self.command(OP_STEP)
        metrics = self._dispatch(uniform)
        self._pending_losses.append(metrics["loss"])
        for agg in (self._learning_agg, self._replay_agg):
            if agg is not None:
                agg.on_dispatch(metrics)
        step = self.train_state.step
        rt = self.cfg.runtime
        if (self.publish is not None
                and step // rt.weight_publish_interval
                > prev // rt.weight_publish_interval):
            t0 = time.perf_counter()
            self.publish(self.full_params())
            seconds = time.perf_counter() - t0
            self.publish_ms.append(seconds * 1e3)
            self.tele.observe("weights/publish", seconds)
        if rt.save_interval and (step // rt.save_interval
                                 > prev // rt.save_interval):
            self.save(step // rt.save_interval)
        if (self._snap_writer is not None
                and step // rt.snapshot_interval
                > prev // rt.snapshot_interval):
            self.snapshot_replay()
        return metrics

    def _dispatch(self, uniform: Optional[torch.Tensor] = None) -> dict:
        """One dispatch of learner steps, at most MAX_AHEAD ahead of the
        card. ``learner/train_dispatch`` times its launch, before the wait
        that keeps the host within MAX_AHEAD."""
        prev = self.train_state.step
        t0 = time.time()
        if self.host_mode:
            if uniform is not None:
                raise ValueError("host placement samples on the host: no "
                                 "jitter to inject")
            if self.host_replay is not None:
                metrics = self._host_step_once()
            else:       # a tensor-parallel follower: rank 0's rows
                self.train_state, metrics = self._step_fn(
                    self.train_state, self._place_batch(None))
        elif self.service is not None:
            metrics = self._service_step_once(uniform)
        else:
            try:
                self.train_state, self.replay_state, metrics = \
                    self._step_fn(self.train_state, self.replay_state,
                                  uniform)
            except Exception:
                self._mesh_failed = self.mesh is not None
                raise
        t1 = time.time()
        tele = self.tele
        tele.observe("learner/train_dispatch", t1 - t0)
        tele.record_span("learner/train_dispatch", t0, t1,
                         {"k": self.steps_per_dispatch, "step": prev})
        if self.device.type == "cuda":
            done = torch.cuda.Event(blocking=True)
            done.record()
            self._in_flight.append(done)
            while len(self._in_flight) > MAX_AHEAD:
                self._in_flight.popleft().synchronize()
        return metrics

    # -- crash recovery --

    def _capture_replay(self) -> dict:
        """A cut of the replay at the commit boundary between dispatches,
        with the env-step counter and the sampling generator's state (the
        checkpoint's generator state is older: the cut's is what the next
        dispatch draws from). Under a mesh (rank 0): every dp row's shard
        and generator, and the round-robin ``next_shard``."""
        if self.service is not None:
            extra = {"env_steps": int(self.env_steps),
                     "service_generator_state":
                         self._service_gen.get_state().tolist()}
            return self.service.snapshot_state(self.train_state.step, extra)
        if self.mesh is None:
            extra = {"env_steps": int(self.env_steps),
                     "generator_state":
                         self.train_state.generator.get_state().tolist()}
            return capture_plain(self.spec, self.replay_state, self.ring,
                                 self.train_state.step, extra)
        self.command(OP_SNAP)
        shards, states = self._capture_shards()
        extra = {"env_steps": int(self.env_steps),
                 "next_shard": int(self._next_shard),
                 "generator_states": states}
        return capture_sharded(self.spec, shards, self.ring,
                               self.train_state.step, extra)

    def _capture_shards(self):
        """Every rank: its shard's leaves to host memory; the first rank of
        each dp row (one replica a row) sends them to rank 0 over the host
        group. Rank 0 returns every row's leaves and generator state in dp
        order (the followers None)."""
        mesh = self.mesh
        states = gather_objects(
            self.train_state.generator.get_state().tolist(), mesh)
        states = [states[d * mesh.mp] for d in range(mesh.dp)]
        if mesh.mp_rank != 0:
            return None, None
        mine = shard_leaves(self.replay_state)
        if not mesh.leader:
            for leaf in mine.values():
                dist.send(torch.from_numpy(np.atleast_1d(leaf)), dst=0,
                          group=mesh.ctrl_group)
            return None, None
        shards = [mine]
        for d in range(1, mesh.dp):
            got = {}
            for name, leaf in mine.items():
                buf = torch.from_numpy(np.empty_like(np.atleast_1d(leaf)))
                dist.recv(buf, src=d * mesh.mp, group=mesh.ctrl_group)
                got[name] = buf.numpy().reshape(np.shape(leaf))
            shards.append(got)
        return shards, states

    def snapshot_replay(self) -> None:
        """Capture one snapshot and hand it to the writer thread; the loop
        pays the capture's host time (on the card: the launch of the
        copies into pinned memory)."""
        if self._snap_writer is None:
            return
        t0 = time.perf_counter()
        snap = self._capture_replay()
        seconds = time.perf_counter() - t0
        self.snapshot_capture_ms.append(seconds * 1e3)
        self.tele.observe("recovery/snapshot_capture", seconds)
        self._snap_writer.submit(snap)
        self._snap_adds = self.ring.total_adds

    def recovery_block(self) -> Optional[dict]:
        """The record's ``recovery`` block (JAX's keys), None with the
        plane off. ``lost_blocks_est``: adds committed since the newest
        snapshot, what a crash now would cost."""
        if self._snap_writer is None:
            return None
        w = self._snap_writer
        meta = w.last_meta
        return {
            "snapshot": {
                "count": w.count,
                "dropped": w.dropped,
                "age_s": (round(time.time() - meta["written_at"], 3)
                          if meta else None),
                "bytes": meta["payload_bytes"] if meta else None,
                "write_s": meta["write_s"] if meta else None,
                "capture_s": (round(self.snapshot_capture_ms[-1] / 1e3, 6)
                              if self.snapshot_capture_ms else 0.0),
                "step": meta["step"] if meta else None,
            },
            "restores": self._restores,
            "restored_blocks": self._restored_blocks,
            "lost_blocks_est": max(0, self.ring.total_adds
                                   - self._snap_adds),
            "supervisor": {"restarts": int(os.environ.get(
                RESTARTS_ENV, "0"))},
        }

    def flush_metrics(self) -> None:
        """Move the dispatches' device losses to the host (one sync for
        all of them) and feed the metrics' training counters; with the
        diagnostics on, build the record's ``learning`` and
        ``replay_diag`` blocks from the dispatches' values. A non-finite
        step under ``telemetry.nan_policy="halt"`` raises here, after its
        one forensics dump. The first call attaches the one-shot ``costs``
        block."""
        if (not self._costs_attached and self.cfg.telemetry.enabled
                and self.cfg.telemetry.costmodel_enabled):
            self._costs_attached = True
            # the resolved compute dtype: the byte counts are this run's
            self.metrics.set_costs(costs_block(
                self.cfg, self.net.action_dim,
                act_bytes=2 if self.net.config.bf16 else 4,
                device=self.device))
        self._flush_losses()
        if self._resources_on:
            # the optimizer's state exists after the first step
            register_buffer(f"p{self.player_idx}/train_state",
                            pytree_nbytes(self.train_state))
            graphs = getattr(self._step_fn, "multi", self._step_fn)
            pool = getattr(graphs, "pool_bytes", 0)
            if pool:
                register_buffer(f"p{self.player_idx}/train_step_graphs",
                                pool)
        if self._learning_agg is not None:
            pub = (int(self.weight_version_fn())
                   if self.weight_version_fn is not None else None)
            self.metrics.set_learning(self._learning_agg.flush(
                self.train_state.step, publish_count=pub,
                occupancy_versions=self.ring.live_versions()))
        if self._replay_agg is not None:
            # host placement: the host replay's readings stand in for the
            # tree snapshot and the evictions the step cannot take
            host_stats = (self.host_replay.diag_raw()
                          if self.host_replay is not None else None)
            self.metrics.set_replay_diag(
                self._replay_agg.flush(host_stats=host_stats))

    def _flush_losses(self) -> None:
        if not self._pending_losses:
            return
        n = len(self._pending_losses)
        t0 = time.time()
        values = torch.cat([x.reshape(-1).float()
                            for x in self._pending_losses]).tolist()
        t1 = time.time()
        self.tele.observe("learner/device_sync", t1 - t0)
        self.tele.record_span("learner/device_sync", t0, t1, {"losses": n})
        self._pending_losses.clear()
        for loss in values:
            self.metrics.on_train_step(loss)
        self._flushed_losses.extend(values)

    def save(self, index: int) -> str:
        """Checkpoint ``index`` of this player, then prune to
        runtime.keep_checkpoints."""
        t0 = time.perf_counter()
        rt = self.cfg.runtime
        generators = None
        ts = self.train_state
        if self.mesh is not None:
            self.command(OP_SAVE)
            generators = gather_objects(
                self.train_state.generator.get_state(), self.mesh)
            if self._tp:
                ts = gather_train_state(ts, self.net, self.cfg.optim)
        self._last_saved_step = self.train_state.step
        path = save_checkpoint(rt.save_dir, self.cfg.env.game_name, index,
                               self.player_idx, ts, self.env_steps,
                               config_json=self.cfg.to_json(),
                               generators=generators)
        prune_checkpoints(rt.save_dir, self.cfg.env.game_name,
                          self.player_idx, rt.keep_checkpoints)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        return path

    def save_final(self) -> Optional[str]:
        """The checkpoint of a clean stop, one index past the current
        periodic slot so it sorts newest; a no-op without save_interval or
        when the current step is already saved. With snapshots on, a
        replay snapshot is written beside it, synchronously."""
        rt = self.cfg.runtime
        if (not rt.save_interval
                or self.train_state.step <= self._last_saved_step):
            return None
        path = self.save(self.train_state.step // rt.save_interval + 1)
        if self._snap_writer is not None:
            self._snap_writer.write_now(self._capture_replay())
            self._snap_adds = self.ring.total_adds
        return path

    def run(self, queue, should_stop: Callable[[], bool],
            max_steps: Optional[int] = None,
            on_dispatch: Optional[Callable[[], None]] = None) -> int:
        """Drain and train until should_stop() or ``max_steps`` learner
        steps (optim.training_steps by default), with the step-0
        checkpoint first; ``on_dispatch()`` after every dispatch (the
        orchestrator's logging and supervision)."""
        max_steps = max_steps or self.cfg.optim.training_steps
        if self.cfg.runtime.save_interval:
            self.save(0)
        while not should_stop() and self.train_state.step < max_steps:
            self.drain(queue)
            if self.ready:
                self.step()
                if on_dispatch is not None:
                    on_dispatch()
            else:
                time.sleep(0.05)
        self.flush_metrics()
        return self.train_state.step

    # -- host placement: the prefetch and write-back threads --

    def _prefetch(self) -> None:
        try:
            cuda = self.device.type == "cuda"
            placer = _BatchPlacer(self.spec, self.device) if cuda else None
            while not self._bg_stop.is_set():
                t_sample = time.perf_counter()
                if cuda:
                    with torch.cuda.device(self.device):
                        item = placer.place(self.host_replay, self.timings)
                else:
                    t0 = time.perf_counter()
                    batch, snapshot = self.host_replay.sample()
                    self.timings["sample_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
                    item = (SampleBatch(**{
                        name: torch.from_numpy(a)
                        for name, a in batch_fields(batch).items()}),
                        batch.idxes, snapshot, None)
                self.tele.observe("learner/sample",
                                  time.perf_counter() - t_sample)
                while not self._bg_stop.is_set():
                    try:
                        self._prefetch_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:          # surfaced by _host_step_once
            self._bg_error = e

    def _writeback(self) -> None:
        try:
            while not self._bg_stop.is_set():
                try:
                    idxes, priorities, ready, snapshot = \
                        self._writeback_q.get(timeout=0.5)
                except queue.Empty:
                    continue
                t0 = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                self.host_replay.update_priorities(
                    idxes, priorities.numpy(), snapshot)
                self.tele.observe("learner/priority_writeback",
                                  time.perf_counter() - t0)
                self._writeback_q.task_done()
        except Exception as e:          # surfaced by _host_step_once
            self._bg_error = e

    def _start_background(self) -> None:
        self._bg_stop.clear()
        for fn, name in ((self._prefetch, "prefetch"),
                         (self._writeback, "priority-writeback")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"learner-{name}")
            t.start()
            self._bg_threads.append(t)

    def stop_background(self, join_timeout: float = 10.0) -> None:
        """Stop the learner's threads: the snapshot writer after what is
        waiting has been written; the ingest stager, committing what it
        staged; the host-placement threads, draining the prefetch queue so
        a thread parked in a full-queue put sees the stop. Each is joined
        within ``join_timeout`` seconds; any still running is warned
        about."""
        stuck = []
        if self._snap_writer is not None:
            self._snap_writer.stop(join_timeout)
        stuck += self._stop_stager(join_timeout)
        self.release_followers()
        if self.service is not None:
            stuck += self._stop_service_threads(join_timeout)
        if self.host_replay is None:       # no prefetch or write-back
            if stuck:
                logging.getLogger(__name__).warning(
                    "learner background threads did not exit within "
                    "%.1fs: %s", join_timeout, stuck)
            return
        self._bg_stop.set()
        for t in self._bg_threads:
            deadline = time.monotonic() + join_timeout
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    self._prefetch_q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
            if t.is_alive():
                stuck.append(t.name)
        self._bg_threads = [t for t in self._bg_threads if t.is_alive()]
        if stuck:
            logging.getLogger(__name__).warning(
                "learner background threads did not exit within %.1fs: %s",
                join_timeout, stuck)

    def _host_step_once(self) -> dict:
        if not self._bg_threads:
            self._start_background()
        while True:
            # fail loudly instead of hanging if a pipeline thread died
            if self._bg_error is not None:
                raise RuntimeError("host-replay pipeline thread died"
                                   ) from self._bg_error
            try:
                batch, idxes, snapshot, ready = self._prefetch_q.get(
                    timeout=2.0)
                break
            except queue.Empty:
                if not all(t.is_alive() for t in self._bg_threads):
                    raise RuntimeError(
                        "host-replay pipeline threads exited without error")
        cuda = self.device.type == "cuda"
        if cuda:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
        if self._place_batch is not None:
            # tensor parallel: each dp row's rows to its ranks
            self.train_state, metrics = self._step_fn(
                self.train_state, self._place_batch(batch))
        else:
            self.train_state, metrics = self._step_fn(self.train_state,
                                                      batch)
        priorities = metrics.pop("priorities")
        done = None
        if cuda:
            # the batch came from the copy stream's memory: keep it from
            # reuse until this stream has read it
            for t in batch_fields(batch).values():
                t.record_stream(current)
            priorities = priorities.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record(current)
        try:
            self._writeback_q.put_nowait((idxes, priorities, done, snapshot))
        except queue.Full:
            self.metrics.on_dropped_priority_update()
        return metrics

    # -- the replay service: the synchronous and the staged step --

    def _service_sample(self, uniform: Optional[torch.Tensor] = None):
        """One sample of the service with this learner's generator (or the
        injected jitter): (batch, shard, adds snapshot, host idxes or
        None, trace token). The indices are read to the host only for the
        trace (and by the staged path's prefetch thread, its caller)."""
        if uniform is None and self.sample_jitter is not None:
            uniform = self.sample_jitter()
        t0 = time.perf_counter()
        batch, shard, snapshot = self.service.sample(self._service_gen,
                                                     uniform)
        self.tele.observe("learner/sample", time.perf_counter() - t0)
        idxes, token = None, None
        if self._exp_trace is not None:
            idxes = batch.idxes.cpu().numpy()
            token = self._exp_trace.on_sample(
                self.service.trace_lookup(shard, idxes))
        return batch, shard, snapshot, idxes, token

    def _service_step_once(self, uniform: Optional[torch.Tensor] = None
                           ) -> dict:
        """Sample the service's next shard, train the external step on the
        batch, write its priorities back to that shard through the
        staleness guard (on the device, no host read while no add came
        between). Staged once the step's graph is captured."""
        if self._svc_staging and self.warm:
            if uniform is not None:
                raise ValueError("the staged service step samples on its "
                                 "prefetch thread: inject draws through "
                                 "sample_jitter")
            return self._service_step_staged()
        batch, shard, snapshot, _, token = self._service_sample(uniform)
        self.train_state, metrics = self._step_fn(self.train_state, batch)
        if self._exp_trace is not None:
            self._exp_trace.on_train(token)
        t0 = time.perf_counter()
        self.service.update_priorities(shard, batch.idxes,
                                       metrics.pop("priorities"),
                                       adds_snapshot=snapshot)
        self.tele.observe("learner/priority_writeback",
                          time.perf_counter() - t0)
        return metrics

    def _svc_prefetch(self) -> None:
        """The staged path's prefetch thread: samples, marks the sample's
        end with an event on the service's stream, reads the indices to
        the host here, and queues the batch."""
        try:
            cuda = self.device.type == "cuda"
            while not self._svc_stop.is_set():
                with (torch.cuda.device(self.device) if cuda
                      else contextlib.nullcontext()):
                    batch, shard, snapshot, idxes, token = \
                        self._service_sample()
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(self.service.stream)
                    if idxes is None:
                        idxes = batch.idxes.cpu().numpy()
                item = (batch, shard, snapshot, idxes, token, ready)
                while not self._svc_stop.is_set():
                    try:
                        self._svc_prefetch_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:      # raised by _service_step_staged
            self._svc_error = e

    def _svc_writeback(self) -> None:
        """The staged path's write-back thread: whatever is queued, grouped
        by shard, one ``update_priorities_group`` a shard, each entry with
        its own staleness guard."""
        try:
            while not self._svc_stop.is_set():
                try:
                    entries = [self._svc_writeback_q.get(timeout=0.5)]
                except queue.Empty:
                    continue
                while True:
                    try:
                        entries.append(self._svc_writeback_q.get_nowait())
                    except queue.Empty:
                        break
                groups: dict = {}
                for shard, idxes, prios, done, snapshot in entries:
                    if done is not None:
                        done.synchronize()
                    groups.setdefault(shard, []).append(
                        (idxes, prios.numpy(), snapshot))
                t0 = time.perf_counter()
                for shard, group in groups.items():
                    self.service.update_priorities_group(shard, group)
                self.tele.observe("learner/priority_writeback",
                                  time.perf_counter() - t0)
                for _ in entries:
                    self._svc_writeback_q.task_done()
        except BaseException as e:      # raised by _service_step_staged
            self._svc_error = e

    def _service_step_staged(self) -> dict:
        if not self._svc_threads:
            self._svc_stop.clear()
            for fn, name in ((self._svc_prefetch, "svc-prefetch"),
                             (self._svc_writeback, "svc-writeback")):
                t = threading.Thread(
                    target=fn, daemon=True,
                    name=f"learner-{name}-p{self.player_idx}")
                t.start()
                self._svc_threads.append(t)
        while True:
            if self._svc_error is not None:
                raise RuntimeError("service stager thread died"
                                   ) from self._svc_error
            try:
                batch, shard, snapshot, idxes, token, ready = \
                    self._svc_prefetch_q.get(timeout=2.0)
                break
            except queue.Empty:
                if not all(t.is_alive() for t in self._svc_threads):
                    raise RuntimeError(
                        "service stager threads exited without error")
        cuda = self.device.type == "cuda"
        if cuda:
            # the gather before the step's input copy, without a host sync
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            if current != self.service.stream:
                for t in batch_fields(batch).values():
                    t.record_stream(current)
        self.train_state, metrics = self._step_fn(self.train_state, batch)
        if self._exp_trace is not None:
            self._exp_trace.on_train(token)
        priorities = metrics.pop("priorities")
        done = None
        if cuda:
            priorities = priorities.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        try:
            self._svc_writeback_q.put_nowait((shard, idxes, priorities,
                                              done, snapshot))
        except queue.Full:
            self.metrics.on_dropped_priority_update()
        return metrics

    def _stop_service_threads(self, join_timeout: float) -> List[str]:
        """Stop the staged path's threads (draining the prefetch queue so
        a parked put sees the stop) and the service's prefetch thread;
        the names of threads still running."""
        stuck = []
        self._svc_stop.set()
        for t in self._svc_threads:
            deadline = time.monotonic() + join_timeout
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    self._svc_prefetch_q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
            if t.is_alive():
                stuck.append(t.name)
        self._svc_threads = [t for t in self._svc_threads if t.is_alive()]
        self.service.close()
        return stuck
