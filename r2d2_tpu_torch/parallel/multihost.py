"""Rank-aware multi-controller training, the JAX package's
``parallel/multihost.py`` over ``torch.distributed``.

JAX runs one controller process a host over its local chips and
``jax.distributed`` stitches the hosts into one mesh. Here a controller is
one process on one card: a JAX host with d chips and n actors becomes d
controllers with n/d actors each. Controller r is rank r of a process
group joined over ``tcp://{mesh.coordinator_address}``
(``parallel/mesh.py init_distributed``), and owns dp row r.

Design, as in the JAX package:

  * **Each controller owns its actors** (the Ape-X epsilon ladder over the
    global actor index ``rank * n_local + i``), its block queue, its
    weight store and its replay shard. Blocks feed only the controller's
    own shard: no experience crosses controllers. The gradient all-reduce
    inside the sharded step (``parallel/sharded.py``) is the only
    collective on the learner's tensors.
  * **Lockstep by construction.** Every loop iteration each controller
    writes at most one block into its own shard (``make_lockstep_ingest``)
    and joins one all-reduce of host integers (buffered steps, a filled
    shard, env steps, a stop flag) over the host group; every branch after
    it reads only its sums, which every controller holds alike, so every
    controller takes the same branch and enters the same collectives in
    the same order. Host-local timing (queue depth, sleeps, signals)
    changes what an iteration carries, never the order of collectives.
  * **Stop consensus**: a controller's stop (signal, deadline) enters the
    next all-reduce; any controller's stop is everyone's on the same
    iteration, so none is left waiting in a collective its peers left.
  * **Rank 0 de-duplicates side effects**: checkpoints (with every rank's
    sampling generator, gathered), the metrics log and pruning. The
    params are replicated bit-equal, so nothing is lost.
  * **The learning diagnostics** (telemetry/learning.py) go into the
    sharded step, reduced over the controllers as the dp step reduces
    them; rank 0 aggregates them into its record's ``learning`` block.
    Under ``telemetry.nan_policy="halt"`` a non-finite step found at rank
    0's flush sets the stop flag, so every controller leaves the loop on
    the same iteration through the stop consensus, and rank 0 raises the
    error after the unwind (the final checkpoint and snapshot first). The
    replay diagnostics' ring state rides the shards as in the JAX
    package, whose lockstep step carries the learning pillar only.

Device placement trains ``runtime.steps_per_dispatch`` steps a dispatch
(one CUDA graph with the all-reduce inside under NCCL; eager under gloo,
which stages through the host). Host placement keeps one ``HostReplay``
a controller (seed ``runtime.seed + 7919 * rank``), samples its
``batch_size / dp`` rows and runs the sharded external-batch step, with
``make_lockstep_consensus`` in place of the ingest; priorities go back to
the controller's own tree.

Refused, each naming its item: ``mesh.mp > 1`` under multihost (ROADMAP
A.4: a controller drives one card, so tensor parallelism across
controllers needs the JAX package's GSPMD lockstep ingest and a
controller that drives mp ranks; ``mesh.mp`` runs on one host through
``cli.train``), on-device acting and served actors under multihost
(Config; on-device acting with mp > 1 and ``serve.servers > 1`` are
refused everywhere), and the fleet and multiplayer planes and the
telemetry beyond the stage timers, spans and diagnostics, which the
port's config does not have (A.6, A.9, A.7).

Telemetry (telemetry/core.py): each controller has its own ``Telemetry``
(its actors' board under process actors) and drains its spans to
``{save_dir}/spans_host{rank}.jsonl``. It observes ``lockstep/dispatch``
(the iteration's all-reduce), ``lockstep/step`` (one whole iteration),
``ingest/commit``, the ``learner/*`` stages and ``weights/publish``.
Rank 0's summary is its record's ``stages`` block; every other rank
appends a row ``{t, rank, stages, telemetry_dropped_spans}`` a log
interval to ``{save_dir}/telemetry_host{rank}.jsonl``. The JAX rows'
``fleet``, ``resources`` and ``alerts`` parts come with the fleet plane.

Demo and validation, every controller its own interpreter on a loopback
coordinator, parameter digests compared across controllers:

    python -m r2d2_tpu_torch.parallel.multihost --device=cpu
    python -m r2d2_tpu_torch.parallel.multihost --backend=gloo \\
        --reference                    # two controllers sharing one card

The controllers run on CUDA unless ``--device=cpu``; without a card the
launcher raises before it starts any.
"""

import logging
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           SampleBatch, batch_fields)
from r2d2_tpu_torch.runtime.learner_loop import MAX_AHEAD, TIMINGS_KEPT
from r2d2_tpu_torch.runtime.orchestrator import ActorPool, start_span_drain
from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY, Telemetry
from r2d2_tpu_torch.telemetry.resources import (HealthPlane,
                                                clear_player_buffers,
                                                pytree_nbytes,
                                                register_buffer)

# the stop flag's local reasons, for the summary
STOP_NONE, STOP_SIGNAL, STOP_DEADLINE = "", "signal", "deadline"
STOP_HALT = "nan_halt"          # telemetry.nan_policy="halt" at rank 0


class LocalActorFleet(ActorPool):
    """One controller's actors: the orchestrator's pool over this
    controller's share of the fleet (``actor_base = rank * n_local`` of
    ``total_actors = nprocs * n_local``), with its supervision.

    Restarts are local to the controller (they touch no collective state,
    so lockstep is unaffected) and never raise into the lockstep loop: a
    controller that left the loop mid-collective would leave every peer
    waiting until the collective timeout, the failure the stop consensus
    exists to prevent. A failed respawn is logged and retried at the next
    supervision tick."""

    def _respawn(self, i: int):
        try:
            return super()._respawn(i)
        except Exception:
            logging.getLogger(__name__).exception(
                "actor %d respawn failed; will retry next supervision tick",
                i)
            return None


def owned_dp_rows(mesh) -> List[int]:
    """The dp rows whose device lives in this process: one controller a
    card, so its own rank's."""
    return [mesh.rank]


def _allreduce_ints(values, mesh, timings: Optional[deque] = None
                    ) -> List[int]:
    """The sums over every controller of a few host integers (one gloo
    all-reduce on the host group); its host ms go to ``timings``."""
    t0 = time.perf_counter()
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, group=mesh.ctrl_group)
    out = t.tolist()
    if timings is not None:
        timings.append((time.perf_counter() - t0) * 1e3)
    return out


class LockstepIngest:
    """``ingest(state, cum_env, block, stop) -> (state, cum_env, info)``,
    the JAX package's ``make_lockstep_ingest`` (its mp == 1 path): this
    controller's ``block``, if any (None: a no-op iteration), ring-written
    into its own shard (``replay_add``; ``state`` is updated in place),
    its learning steps added to ``cum_env`` (this row's cumulative env
    steps), then one all-reduce of ``[buffer_steps, buffer_steps > 0,
    cum_env, stop]``. ``info`` holds the sums under JAX's keys:
    ``buffer_steps`` (live steps in every shard), ``filled_shards``
    (shards holding data, the ready gate's), ``env_steps`` and ``stop``
    (> 0: some controller asked to stop). The buffered steps come from
    ``ring``, the host accountant of the shard, so an iteration reads
    nothing back from the device."""

    def __init__(self, spec: ReplaySpec, mesh):
        self.spec = spec
        self.mesh = mesh
        self.ring = RingAccountant(spec.num_blocks)
        self.collective_ms: deque = deque(maxlen=TIMINGS_KEPT)

    def __call__(self, state, cum_env: int, block: Optional[Block],
                 stop: int):
        from r2d2_tpu_torch.replay.device_replay import replay_add
        if block is not None:
            replay_add(self.spec, state, block)
            learning = int(np.asarray(block.learning_steps).sum())
            self.ring.advance(learning, int(np.asarray(block.weight_version)))
            cum_env += learning
        mine = self.ring.buffer_steps
        sums = _allreduce_ints([mine, mine > 0, cum_env, stop], self.mesh,
                               self.collective_ms)
        info = {"buffer_steps": sums[0], "filled_shards": sums[1],
                "env_steps": sums[2], "stop": sums[3]}
        return state, cum_env, info


def make_lockstep_ingest(spec: ReplaySpec, mesh) -> LockstepIngest:
    """One call a loop iteration: this controller's conditional shard write
    and the global counters with the stop consensus (``LockstepIngest``).
    ``mesh.mp > 1`` under multihost (the JAX package's GSPMD ingest,
    ``_make_gspmd_lockstep_ingest``, and its ``owned_dp_rows`` rule) is
    refused by Config, naming ROADMAP item A.4: a controller here drives
    one card. What else stays refused: on-device acting with mp > 1, and
    ``serve.servers > 1`` (A.6)."""
    return LockstepIngest(spec, mesh)


def make_lockstep_consensus(mesh):
    """The host-placement twin of the lockstep ingest's counters:
    ``consense(buffer_steps, env_steps, ready, stop_flag) -> info``, one
    all-reduce of this controller's four values, whose sums every
    controller reads alike (``info``: ``buffer_steps``, ``env_steps``,
    ``ready_procs``, ``stop``). ``consense.collective_ms``: the host ms
    of each all-reduce."""
    timings: deque = deque(maxlen=TIMINGS_KEPT)

    def consense(buffer_steps: int, env_steps: int, ready: bool,
                 stop_flag: int) -> dict:
        out = _allreduce_ints([buffer_steps, env_steps, bool(ready),
                               stop_flag], mesh, timings)
        return {"buffer_steps": out[0], "env_steps": out[1],
                "ready_procs": out[2], "stop": out[3]}

    consense.collective_ms = timings
    return consense


class HostFeed:
    """Each iteration's ingest operands from this controller's blocks. The
    JAX package's feed builds global arrays, zero rows but for the
    controller's round-robin target row; here a controller owns one row
    and writes its own shard, so the operands are the drained block
    itself (None: a no-op iteration) and the stop flag."""

    def __init__(self, spec: ReplaySpec, mesh):
        self.spec = spec
        self.local_rows = owned_dp_rows(mesh)

    def build(self, block: Optional[Block], stop_flag: int):
        """(block, stop) for the lockstep ingest."""
        return block, int(stop_flag)


class LockstepCore:
    """One iteration of the lockstep loop, shared by ``train_multihost``
    and the scripted checks (tools/mh_check.py): ingest (or, under host
    placement, the host add and the consensus), the ready gate, the
    replay-ratio limiter and one dispatch, in the JAX loop's order
    (``multihost.py:1140-1271``). Every decision after the all-reduce
    reads only its sums.

    Device placement: ``rs`` this controller's shard, ``step_fn`` the
    sharded learner step, K steps a dispatch. Host placement:
    ``host_replay`` and ``step_fn`` the sharded external-batch step, one
    step a dispatch, the priorities written back to ``host_replay``."""

    def __init__(self, mesh, ts, step_fn, k: int, *, learning_starts: int,
                 ratio: float, rs=None, spec: Optional[ReplaySpec] = None,
                 host_replay=None, local_batch: Optional[int] = None,
                 telemetry=None):
        self.mesh = mesh
        self.tele = telemetry if telemetry is not None else NULL_TELEMETRY
        self.ts = ts
        self.step_fn = step_fn
        self.k = k
        self.learning_starts = learning_starts
        self.ratio = ratio
        self.host_mode = host_replay is not None
        self.rs = rs
        self.host_replay = host_replay
        self.local_batch = local_batch
        if self.host_mode:
            self.consense = make_lockstep_consensus(mesh)
            self.env_local = 0
        else:
            self.ingest = make_lockstep_ingest(spec, mesh)
            self.feed = HostFeed(spec, mesh)
            self.cum_env = 0
        self.step_base = ts.step       # the limiter counts from here
        self.paused = False
        self.info = {"buffer_steps": 0, "env_steps": 0, "stop": 0}
        self.blocks_in = 0             # blocks this controller ingested
        self._in_flight: deque = deque()

    @property
    def collective_ms(self) -> deque:
        """Host ms of each iteration's all-reduce."""
        return (self.consense.collective_ms if self.host_mode
                else self.ingest.collective_ms)

    @property
    def ring(self) -> RingAccountant:
        return (self.host_replay.ring if self.host_mode
                else self.ingest.ring)

    def _dispatch(self, uniform: Optional[torch.Tensor]) -> dict:
        tele = self.tele
        if self.host_mode:
            if uniform is not None:
                raise ValueError("host placement samples on the host: no "
                                 "jitter to inject")
            t0 = time.perf_counter()
            batch_np, snapshot = self.host_replay.sample(self.local_batch)
            device = self.ts.step_count.device
            batch = SampleBatch(**{
                name: torch.from_numpy(np.array(a)).to(device)
                for name, a in batch_fields(batch_np).items()})
            t1 = time.perf_counter()
            tele.observe("learner/sample", t1 - t0)
            self.ts, m = self.step_fn(self.ts, batch)
            t0 = time.perf_counter()
            tele.observe("learner/train_dispatch", t0 - t1)
            prios = m.pop("priorities").detach().cpu().numpy()
            if len(prios) != len(batch_np.idxes):
                raise RuntimeError(
                    f"priority write-back shape drift: {len(prios)} local "
                    f"priorities for {len(batch_np.idxes)} sampled idxes")
            self.host_replay.update_priorities(batch_np.idxes, prios,
                                               snapshot)
            tele.observe("learner/priority_writeback",
                         time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            self.ts, self.rs, m = self.step_fn(self.ts, self.rs, uniform)
            tele.observe("learner/train_dispatch", time.perf_counter() - t0)
        if self.ts.step_count.is_cuda:
            done = torch.cuda.Event(blocking=True)
            done.record()
            self._in_flight.append(done)
            while len(self._in_flight) > MAX_AHEAD:
                self._in_flight.popleft().synchronize()
        return m

    def iterate(self, block: Optional[Block], local_stop: int,
                uniform: Optional[torch.Tensor] = None) -> dict:
        """One iteration with ``block`` (None: nothing drained; the caller
        drains nothing while ``paused``) and this controller's stop flag.
        ``uniform``: a dispatch's injected jitter (checks). Returns
        {"info", "stop", "ready", "stepped", "metrics"}."""
        t0 = time.perf_counter()
        if self.host_mode:
            if block is not None:
                self.host_replay.add(block)
                self.env_local += int(np.sum(np.asarray(
                    block.learning_steps)))
            n = len(self.host_replay)
            info = self.consense(n, self.env_local, n > 0, local_stop)
        else:
            args = self.feed.build(block, local_stop)
            self.rs, self.cum_env, info = self.ingest(self.rs, self.cum_env,
                                                      *args)
        t_coll = time.perf_counter() - t0
        self.tele.observe("lockstep/dispatch", t_coll)
        if block is not None:
            # only real ingests: the no-op iterations would swamp it
            self.tele.observe("ingest/commit", t_coll)
            self.blocks_in += 1
        self.info = info
        out = {"info": info, "stop": info["stop"] > 0, "ready": False,
               "stepped": False, "metrics": None}
        if out["stop"]:
            return out
        # every decision below reads the all-reduce's sums only
        if self.host_mode:
            ready = (info["ready_procs"] == self.mesh.num_processes
                     and info["buffer_steps"] >= self.learning_starts)
        else:
            ready = (info["filled_shards"] == self.mesh.dp
                     and info["buffer_steps"] >= self.learning_starts)
        self.paused = bool(
            ready and self.ratio > 0
            and info["env_steps"] >= self.learning_starts
            + self.ratio * max(self.ts.step - self.step_base, 1))
        out["ready"] = ready
        if ready:
            out["metrics"] = self._dispatch(uniform)
            out["stepped"] = True
        return out


def host_row_path(save_dir: str, rank: int) -> str:
    return os.path.join(save_dir or ".", f"telemetry_host{rank}.jsonl")


def write_host_row(path: str, rank: int, tele, t_start: float,
                   health=None) -> None:
    """A rank > 0's row of a log interval, the JAX package's host row
    without its fleet part; with the resources plane (``health``) its
    ``resources`` block and the rank's own alert pass (firings to
    ``alerts_host{rank}.jsonl``)."""
    import json
    row = {"t": round(time.time() - t_start, 3), "rank": rank,
           "stages": tele.interval_summary(),
           "telemetry_dropped_spans": tele.spans.dropped}
    if health is not None:
        health.annotate(row)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def _install_stop_signals(stop) -> dict:
    """SIGTERM/SIGINT set ``stop``, which reaches the next all-reduce: the
    signalled controller keeps iterating until every controller stops on
    the same iteration. Returns the handlers replaced."""
    prev = {}
    if threading.current_thread() is not threading.main_thread():
        return prev

    def _on_signal(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass
    return prev


def snapshot_twin_on(rt, rank: int, nprocs: int, dp: int,
                     host_mode: bool) -> bool:
    """Whether controller ``rank`` keeps the crash-recovery twin: replay
    snapshots where rank 0's shard is the whole replay (one controller,
    device placement). Asked for in a wider job, it warns in the JAX
    package's words and skips them: the job relies on checkpoint
    resume."""
    if rt.snapshot_interval <= 0 or rank != 0 or host_mode:
        return False
    if nprocs > 1 or dp > 1:
        logging.getLogger(__name__).warning(
            "runtime.snapshot_interval=%d: the rank-0 replay snapshot "
            "twin needs a rank-0-addressable ring (nprocs=1, dp=1; got "
            "nprocs=%d dp=%d) — replay snapshots are skipped, "
            "checkpoint resume still works", rt.snapshot_interval,
            nprocs, dp)
        return False
    return True


def train_multihost(cfg: Config, *, max_training_steps: Optional[int] = None,
                    max_seconds: Optional[float] = None,
                    actor_mode: str = "thread",
                    log_fn: Optional[Callable[[dict], None]] = None,
                    device=None, backend: Optional[str] = None,
                    timeout_s: Optional[float] = None,
                    dispatch_hook: Optional[Callable] = None) -> dict:
    """The rank-aware ``train()``: run this same function in every
    controller of the job. ``device``: this controller's card (None =
    CUDA; raises without one) or "cpu"; ``backend``: the process group's
    (NCCL on CUDA and gloo on the CPU by default; gloo lets controllers
    share a card); ``timeout_s``: how long a collective may wait (the
    mesh's default when None); ``dispatch_hook(core)``: called after
    every dispatch with the ``LockstepCore``. Blocks until done; returns
    this controller's summary ({step, env_steps, buffer_steps,
    train_state, digest, ...})."""
    from r2d2_tpu_torch.parallel.mesh import (COLLECTIVE_TIMEOUT_S,
                                              close_mesh, init_distributed)
    from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

    if actor_mode not in ("thread", "process"):
        raise ValueError(f"actor_mode must be 'thread' or 'process', got "
                         f"{actor_mode!r}")
    if not cfg.mesh.multihost:
        raise ValueError("train_multihost runs a mesh.multihost job")
    device = resolve_device(device)
    configure_numerics()
    mesh = init_distributed(cfg.mesh, device, backend,
                            timeout_s=timeout_s or COLLECTIVE_TIMEOUT_S)
    try:
        return _train_controller(cfg, mesh, max_training_steps, max_seconds,
                                 actor_mode, log_fn, dispatch_hook)
    finally:
        close_mesh()


def _train_controller(cfg: Config, mesh, max_training_steps, max_seconds,
                      actor_mode: str, log_fn, dispatch_hook) -> dict:
    import multiprocessing as mp

    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.learner.train_step import create_train_state
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.ops.launch_counts import launch_counts
    from r2d2_tpu_torch.parallel.sharded import (
        gather_objects, make_sharded_external_batch_step,
        make_sharded_learner_step, shard_seed, sharded_replay_init,
        state_digest)
    from r2d2_tpu_torch.replay.host_replay import HostReplay
    from r2d2_tpu_torch.runtime.checkpoint import (apply_restore,
                                                   prune_checkpoints,
                                                   save_checkpoint)
    from r2d2_tpu_torch.runtime.metrics import TrainMetrics
    from r2d2_tpu_torch.runtime.weights import (SnapshotPublisher,
                                                make_publish_preparer)
    from r2d2_tpu_torch.telemetry.learning import (LearningAggregator,
                                                   LearningDiag)

    rank, nprocs = mesh.process_id, mesh.num_processes
    device = mesh.device
    host_mode = cfg.replay.placement == "host"
    spec = ReplaySpec.from_config(cfg, device)
    probe = create_env(cfg.env, seed=cfg.runtime.seed)
    action_dim = probe.action_space.n
    probe.close()
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    use_double = cfg.network.use_double
    # quantized inference: the probe's aggregator for this controller's
    # thread actors (process children act probe-free)
    quant_stats = None
    if cfg.network.inference_dtype != "f32":
        from r2d2_tpu_torch.telemetry import QuantStats
        quant_stats = QuantStats(cfg.network.inference_dtype,
                                 cfg.telemetry.quant_probe_interval)
    # the same seed everywhere: the same initial params (the sharded
    # step's first call broadcasts rank 0's anyway); each rank its own
    # sampling generator
    ts = create_train_state(net, cfg.optim, cfg.runtime.seed, use_double)
    ts.generator.manual_seed(shard_seed(cfg.runtime.seed + 1, rank))
    # every rank restores the same checkpoint (a shared filesystem), with
    # its own sampling generator
    resumed_env = apply_restore(cfg.runtime, ts, rank=rank)
    dp = mesh.dp
    rt = cfg.runtime
    diag = LearningDiag.from_config(cfg)
    # this controller's stage timers and spans (host-local, no collective)
    tele = Telemetry.from_config(cfg, name=f"learner-h{rank}")
    if host_mode:
        if rt.steps_per_dispatch > 1:
            logging.getLogger(__name__).warning(
                "runtime.steps_per_dispatch=%d is ignored under "
                "replay.placement='host' (host sampling is per-step)",
                rt.steps_per_dispatch)
        step_fn = make_sharded_external_batch_step(net, spec, cfg.optim,
                                                   use_double, mesh,
                                                   diag=diag)
        core = LockstepCore(
            mesh, ts, step_fn, 1,
            learning_starts=cfg.replay.learning_starts,
            ratio=cfg.replay.max_env_steps_per_train_step,
            host_replay=HostReplay(spec, seed=rt.seed + 7919 * rank),
            local_batch=step_fn.local_batch, telemetry=tele)
    else:
        k = rt.resolved_steps_per_dispatch(device)
        step_fn = make_sharded_learner_step(net, spec, cfg.optim, use_double,
                                            mesh, k, diag=diag)
        core = LockstepCore(
            mesh, ts, step_fn, k,
            learning_starts=cfg.replay.learning_starts,
            ratio=cfg.replay.max_env_steps_per_train_step,
            rs=sharded_replay_init(spec, mesh), spec=spec, telemetry=tele)

    snap_writer = None
    if snapshot_twin_on(rt, rank, nprocs, dp, host_mode):
        from r2d2_tpu_torch.replay.snapshot import (SnapshotWriter,
                                                    load_snapshot,
                                                    restore_plain)
        snap_writer = SnapshotWriter(rt.save_dir or ".", 0)
        if rt.resume and rt.restore_replay:
            snap = load_snapshot(rt.save_dir or ".", 0)
            if snap is not None and snap.get("kind") == "plain":
                restore_plain(spec, core.rs, core.ring, snap)
                logging.getLogger(__name__).warning(
                    "rank-0 twin restored %d replay block(s) from the "
                    "step-%s snapshot", core.ring.total_adds,
                    snap.get("step"))

    # -- this controller's actors: its share of the fleet --
    n_local = cfg.actor.num_actors
    prep = make_publish_preparer(net)
    initial = prep(ts.params, 1) if prep is not None else ts.params
    stop = (mp.get_context("spawn").Event() if actor_mode == "process"
            else threading.Event())
    fleet = LocalActorFleet(cfg, net, actor_base=rank * n_local,
                            total_actors=nprocs * n_local,
                            quant_stats=quant_stats, telemetry=tele)
    prev_handlers = _install_stop_signals(stop)
    snapshots = metrics = learn_agg = None
    # a halt of telemetry.nan_policy, raised after every controller left
    halt_error: List[BaseException] = []
    stop_reason = STOP_NONE
    t_start = time.time()
    host_rows = None
    health = None
    try:
        start_span_drain(tele, rt.save_dir, f"spans_host{rank}.jsonl",
                         [f"spans_p0_a{rank * n_local + i}.jsonl"
                          for i in range(n_local)], bool(rt.resume))
        if rank != 0 and tele.enabled:
            host_rows = host_row_path(rt.save_dir, rank)
            os.makedirs(os.path.dirname(host_rows), exist_ok=True)
            if not rt.resume:
                open(host_rows, "w").close()
        if actor_mode == "process":
            fleet.open_processes(stop, initial, spec)
        else:
            fleet.open_threads(stop, initial)
        publish, publish_count = fleet.publication()
        snapshots = SnapshotPublisher(publish, ts.params, net=net,
                                      publish_count=publish_count)
        fleet.spawn_actors()
        queue = fleet.queue
        if rank == 0:
            metrics = TrainMetrics(0, rt.save_dir, resume=bool(rt.resume))
            metrics.set_telemetry(tele)     # stages ride rank 0's record
            if quant_stats is not None:
                metrics.set_quant(quant_stats.interval_block)
            if diag is not None:
                learn_agg = LearningAggregator(0, rt.save_dir,
                                               cfg.telemetry.nan_policy,
                                               cfg.optim.lr)
        # this controller's resources and alerts (host-local): rank 0's
        # ride its record, a rank > 0's its host rows
        if cfg.telemetry.enabled and cfg.telemetry.resources_enabled:
            clear_player_buffers(0)
            register_buffer("p0/train_state", pytree_nbytes(core.ts))
            if not host_mode:
                register_buffer("p0/replay_ring", pytree_nbytes(core.rs))
            health = HealthPlane(
                cfg, metrics, 0, board=fleet.tele_board, devices=[device],
                alerts_name=(None if rank == 0
                             else f"alerts_host{rank}.jsonl"))

        max_steps = max_training_steps or cfg.optim.training_steps
        deadline = time.time() + max_seconds if max_seconds else None
        last_ckpt_step = core.ts.step
        pending_losses: List[torch.Tensor] = []
        flushed: List[float] = []
        last_log = last_supervise = time.time()
        iterations = dispatches = 0
        # (seconds since the start, step) at the end of the first and of
        # the newest dispatch, on the host's clock
        marks: List[tuple] = []

        def flush_losses():
            if pending_losses:
                t0 = time.perf_counter()
                values = torch.cat([x.reshape(-1).float()
                                    for x in pending_losses]).tolist()
                tele.observe("learner/device_sync", time.perf_counter() - t0)
                pending_losses.clear()
                for loss in values:
                    metrics.on_train_step(loss)
                flushed.extend(values)
            if learn_agg is None:
                return
            occupancy = (core.host_replay.ring.live_versions()
                         if host_mode else None)
            try:
                metrics.set_learning(learn_agg.flush(
                    core.ts.step, publish_count=publish_count(),
                    occupancy_versions=occupancy))
            except RuntimeError as e:
                if "nan_policy=halt" not in str(e):
                    raise
                # raising here would leave the other controllers in a
                # collective: the stop flag reaches them through the next
                # all-reduce instead, and the error is raised after
                halt_error.append(e)
                stop.set()

        def gather_generators():
            # a collective: every controller reaches each save together
            if host_mode:
                return None
            return gather_objects(core.ts.generator.get_state(), mesh)

        def save(index: int) -> None:
            generators = gather_generators()
            if rank != 0:
                return
            save_checkpoint(rt.save_dir, cfg.env.game_name, index, 0,
                            core.ts, resumed_env + core.info["env_steps"],
                            config_json=cfg.to_json(), generators=generators)
            prune_checkpoints(rt.save_dir, cfg.env.game_name, 0,
                              rt.keep_checkpoints)

        def capture():
            from r2d2_tpu_torch.replay.snapshot import capture_plain
            return capture_plain(spec, core.rs, core.ring, core.ts.step)

        while core.ts.step < max_steps:
            t_iter = time.perf_counter()
            iterations += 1
            local_stop = 0
            if stop.is_set():
                local_stop, stop_reason = 1, stop_reason or (
                    STOP_HALT if halt_error else STOP_SIGNAL)
            elif deadline is not None and time.time() > deadline:
                local_stop, stop_reason = 1, stop_reason or STOP_DEADLINE
            block = None
            if not core.paused:
                drained = queue.drain(1)
                block = drained[0] if drained else None
            out = core.iterate(block, local_stop)
            if metrics is not None and block is not None:
                ret = float(np.asarray(block.sum_reward))
                metrics.on_block(0, None if np.isnan(ret) else ret)
            if out["stop"]:
                break
            if out["stepped"]:
                dispatches += 1
                step = core.ts.step
                mark = (time.time() - t_start, step)
                marks[1 if marks else 0:] = [mark]
                if dispatch_hook is not None:
                    dispatch_hook(core)
                prev = step - core.k
                if metrics is not None:
                    pending_losses.append(out["metrics"]["loss"])
                if learn_agg is not None:
                    learn_agg.on_dispatch(out["metrics"])

                def boundary(iv, step=step, prev=prev):
                    return iv and step // iv > prev // iv

                if boundary(rt.weight_publish_interval):
                    t0 = time.perf_counter()
                    snapshots(core.ts.params)
                    tele.observe("weights/publish",
                                 time.perf_counter() - t0)
                if boundary(rt.save_interval):
                    save(step // rt.save_interval)
                    last_ckpt_step = step
                if snap_writer is not None and boundary(
                        rt.snapshot_interval):
                    snap_writer.submit(capture())
            else:
                time.sleep(0.01)
            now = time.time()
            if now - last_supervise >= rt.supervise_interval_s:
                fleet.supervise()
                last_supervise = now
                if health is not None:
                    # the optimizer's state exists after the first step
                    register_buffer("p0/train_state", pytree_nbytes(core.ts))
                    health.tick(dispatches >= 2)
            if now - last_log >= rt.log_interval and metrics is not None:
                flush_losses()
                metrics.env_steps = resumed_env + core.info["env_steps"]
                metrics.set_buffer_size(core.info["buffer_steps"])
                metrics.set_actor_health(fleet.health.snapshot())
                record = metrics.log(now - last_log)
                if log_fn:
                    log_fn({"rank": rank, **record})
                last_log = now
            elif now - last_log >= rt.log_interval and host_rows:
                # a rank without the metrics: one stage row an interval
                write_host_row(host_rows, rank, tele, t_start, health)
                last_log = now
            tele.observe("lockstep/step", time.perf_counter() - t_iter)
        if metrics is not None:
            flush_losses()
        if host_rows:
            # the last interval's row, however short the run
            write_host_row(host_rows, rank, tele, t_start, health)
        # the final checkpoint of a clean stop (every controller left the
        # loop on the same iteration, so the gather below is entered by all)
        if rt.save_interval and core.ts.step > last_ckpt_step:
            save(core.ts.step // rt.save_interval + 1)
        if snap_writer is not None:
            snap_writer.write_now(capture())
        if snapshots is not None:
            snapshots.flush()
        if halt_error:
            raise halt_error[0]
    finally:
        stop.set()
        if snap_writer is not None:
            snap_writer.stop()
        for sig, handler in prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        if snapshots is not None:
            snapshots.close()
        fleet.close()
        tele.close()
        if health is not None:
            health.close()
        if metrics is not None:
            metrics.close()

    ts = core.ts
    return {"rank": rank, "step": ts.step,
            "env_steps": resumed_env + core.info["env_steps"],
            "buffer_steps": core.info["buffer_steps"],
            "iterations": iterations, "dispatches": dispatches,
            "shard_blocks": core.blocks_in,
            "local_env_steps": (core.env_local if host_mode
                                else core.cum_env),
            "stop_reason": stop_reason, "device": str(device),
            "graphed": step_fn.graphed,
            "digest": state_digest(ts), "launches": launch_counts(),
            "losses": flushed if metrics is not None else None,
            "collective_ms": list(core.collective_ms),
            "dispatch_marks": marks,
            "actor_exitcodes": [getattr(w, "exitcode", None)
                                for w in fleet.processes or fleet.threads],
            "train_state": ts}


# ---------------------------------------------------------------------------
# Loopback demo and validation: N controller processes on one machine, the
# Fake env, the whole rank-aware loop end to end (the tests and
# chip_smoke.py run it).

def _demo_config(save_dir: str) -> Config:
    return Config().replace(**{
        "env.game_name": "Fake",
        "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 800, "replay.block_length": 20,
        "replay.batch_size": 4, "replay.learning_starts": 60,
        "actor.num_actors": 1,
        "runtime.save_dir": save_dir, "runtime.save_interval": 4,
        "runtime.log_interval": 2.0, "runtime.weight_publish_interval": 2,
        "runtime.steps_per_dispatch": 2,
        "mesh.multihost": True,
    })


def _reference_config(save_dir: str) -> Config:
    """The reference widths (84x84x4, LSTM 512, batch 128) with a replay a
    controller sized for several on one card."""
    return Config().replace(**{
        "env.game_name": "Fake", "replay.capacity": 100_000,
        "runtime.save_dir": save_dir, "runtime.save_interval": 0,
        "runtime.log_interval": 5.0, "mesh.multihost": True})


def digest_path(save_dir: str, process_id: int) -> str:
    return os.path.join(save_dir, f"params_digest_r{process_id}.json")


def _demo_worker(args) -> None:
    """One controller of the demo: train, then write its summary (step,
    digest, shard blocks, launches) beside the checkpoints."""
    import json

    from r2d2_tpu_torch.config import parse_overrides
    torch.set_num_threads(max(1, args.threads))
    base = (_reference_config(args.save_dir) if args.reference
            else _demo_config(args.save_dir))
    cfg = parse_overrides(base.replace(**{
        "mesh.coordinator_address": args.coordinator,
        "mesh.num_processes": args.num_processes,
        "mesh.process_id": args.process_id,
        "mesh.dp": args.num_processes,
        "actor.num_actors": args.num_actors,
        "replay.placement": args.placement,
        **({"runtime.resume": args.resume} if args.resume else {}),
    }), args.overrides)
    device = args.device
    if device.startswith("cuda") and ":" not in device and \
            args.backend != "gloo":
        device = f"cuda:{args.process_id}"
    out = train_multihost(cfg, max_training_steps=args.max_steps or None,
                          max_seconds=args.max_seconds or None,
                          actor_mode=args.actor_mode, device=device,
                          backend=args.backend or None,
                          timeout_s=args.collective_timeout or None)
    os.makedirs(args.save_dir, exist_ok=True)
    record = {k: v for k, v in out.items()
              if k not in ("train_state", "losses", "collective_ms")}
    coll = out["collective_ms"]
    record["collective_ms_median"] = (float(np.median(coll)) if coll
                                      else None)
    record["losses_finite"] = (None if out["losses"] is None else
                               bool(np.all(np.isfinite(out["losses"]))))
    record["n_losses"] = (None if out["losses"] is None
                          else len(out["losses"]))
    with open(digest_path(args.save_dir, args.process_id), "w") as f:
        json.dump(record, f)
    print(f"[controller {args.process_id}] multihost train ok: "
          f"step={out['step']} env_steps={out['env_steps']} "
          f"sha256={out['digest'][:16]}", flush=True)


class ControllerProcesses:
    """The controllers of a loopback job, each its own interpreter
    (``python -m MODULE --process-id=r``, this module by default), as a
    second host's would be; a context manager that kills every survivor
    on exit, whatever ends the block."""

    def __init__(self, argv_of: Callable[[int, str], List[str]],
                 num_processes: int,
                 module: str = "r2d2_tpu_torch.parallel.multihost"):
        import subprocess
        import sys

        from r2d2_tpu_torch.parallel.mesh import pick_coordinator
        coordinator = pick_coordinator()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in child_env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", module, *argv_of(pid, coordinator)],
            env=child_env)
            for pid in range(num_processes)]

    def __enter__(self) -> "ControllerProcesses":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()

    def wait(self, deadline: float) -> List[Optional[int]]:
        """Exit codes by the shared ``deadline`` (time.monotonic); None =
        still running."""
        import subprocess
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=max(0.1,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        return rcs

    def wait_any_failure(self, deadline: float) -> List[Optional[int]]:
        """Wait until every controller exits, one fails or the deadline
        passes; the exit codes so far (None = running)."""
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in self.procs]
            if all(rc is not None for rc in rcs) or any(
                    rc not in (None, 0) for rc in rcs):
                return rcs
            time.sleep(0.1)
        return [p.poll() for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10.0)
            except Exception:
                pass


def demo_argv(num_processes: int, save_dir: str, *, max_steps: int = 8,
              max_seconds: float = 0.0, resume: str = "",
              actor_mode: str = "thread", num_actors: int = 1,
              placement: str = "device", device: str = "cuda",
              backend: str = "", reference: bool = False,
              collective_timeout: float = 0.0, threads: int = 1,
              overrides=()) -> Callable[[int, str], List[str]]:
    """``argv_of(process_id, coordinator)`` for ``ControllerProcesses``."""
    def argv_of(pid: int, coordinator: str) -> List[str]:
        argv = [f"--process-id={pid}", f"--num-processes={num_processes}",
                f"--coordinator={coordinator}", f"--save-dir={save_dir}",
                f"--max-steps={max_steps}", f"--max-seconds={max_seconds}",
                f"--resume={resume}", f"--actor-mode={actor_mode}",
                f"--num-actors={num_actors}", f"--placement={placement}",
                f"--device={device}", f"--backend={backend}",
                f"--collective-timeout={collective_timeout}",
                f"--threads={threads}"]
        if reference:
            argv.append("--reference")
        return argv + ["--"] + list(overrides)
    return argv_of


def read_digests(save_dir: str, num_processes: int) -> List[dict]:
    import json
    out = []
    for pid in range(num_processes):
        with open(digest_path(save_dir, pid)) as f:
            out.append(json.load(f))
    return out


def launch_demo(num_processes: int = 2, save_dir: Optional[str] = None,
                max_steps: int = 8, timeout: float = 300.0, **kw) -> list:
    """Run the loopback controllers (``demo_argv``'s options in ``kw``),
    one deadline for all of them, survivors killed on every exit path; then
    assert every controller stopped at the same step with a bit-equal train
    state. ``save_dir`` None: a new directory under the temporary one
    (``TMPDIR``), printed. Returns the per-rank records."""
    import glob
    import tempfile
    from r2d2_tpu_torch.utils.device import resolve_device
    resolve_device(kw.get("device", "cuda"))
    if save_dir is None:
        save_dir = tempfile.mkdtemp(prefix="r2d2_torch_multihost_")
        print(f"multihost train demo: save dir {save_dir}", flush=True)
    for stale in glob.glob(os.path.join(save_dir, "params_digest_r*.json")):
        os.remove(stale)
    with ControllerProcesses(demo_argv(num_processes, save_dir,
                                       max_steps=max_steps, **kw),
                             num_processes) as ctl:
        rcs = ctl.wait_any_failure(time.monotonic() + timeout)
    if any(rc != 0 for rc in rcs):
        raise SystemExit(
            f"multihost train demo failed: controller rcs={rcs} (None = "
            f"still running after {timeout:.0f}s or at a peer's failure, "
            "and killed)")
    digests = read_digests(save_dir, num_processes)
    core = [{k: d[k] for k in ("step", "digest")} for d in digests]
    if any(c != core[0] for c in core[1:]):
        raise SystemExit(f"multihost train demo: train states DIVERGED "
                         f"across controllers: {core}")
    print(f"multihost train demo: {num_processes} controllers ok, train "
          f"states bit-equal at step {core[0]['step']}", flush=True)
    return digests


def main(argv=None) -> None:
    import argparse
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = []
    if "--" in argv:
        cut = argv.index("--")
        argv, overrides = argv[:cut], argv[cut + 1:]
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--save-dir", default=None,
                   help="checkpoints and digests (the launcher's default: a "
                        "new temporary directory; a controller needs it)")
    p.add_argument("--max-steps", type=int, default=8)
    p.add_argument("--max-seconds", type=float, default=0.0)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--resume", default="")
    p.add_argument("--actor-mode", choices=("thread", "process"),
                   default="thread")
    p.add_argument("--num-actors", type=int, default=1,
                   help="actors a controller")
    p.add_argument("--placement", choices=("device", "host"),
                   default="device")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default, raises without one; controller "
                        "r on cuda:r, every controller on the current card "
                        "with gloo), cuda:N or cpu")
    p.add_argument("--backend", default="",
                   help="nccl or gloo (gloo puts several controllers on one"
                        " card); default: nccl on CUDA, gloo on the CPU")
    p.add_argument("--reference", action="store_true",
                   help="the reference widths instead of the tiny shape")
    p.add_argument("--collective-timeout", type=float, default=0.0,
                   help="seconds a collective may wait (0: the default)")
    p.add_argument("--threads", type=int, default=1,
                   help="intra-op threads a controller")
    args = p.parse_args(argv)
    args.overrides = overrides
    if args.process_id is not None and args.save_dir is None:
        p.error("--save-dir is required with --process-id: every "
                "controller of a job writes to the same one")
    if args.process_id is None:
        launch_demo(args.num_processes, args.save_dir, args.max_steps,
                    args.timeout, max_seconds=args.max_seconds,
                    resume=args.resume, actor_mode=args.actor_mode,
                    num_actors=args.num_actors, placement=args.placement,
                    device=args.device, backend=args.backend,
                    reference=args.reference,
                    collective_timeout=args.collective_timeout,
                    threads=args.threads, overrides=overrides)
    else:
        _demo_worker(args)


if __name__ == "__main__":
    main()
