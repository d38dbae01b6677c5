"""The fused act+train loop of on-device acting, the counterpart of the JAX
package's ``runtime/anakin_loop.py``.

The orchestrator (runtime/orchestrator.py) runs actors on host CPUs,
blocks crossing a queue, weights crossing a weight service. With
``actor.on_device`` this loop replaces all of it with one thread
alternating on the card:

    act segment  ``block_length`` steps of ``actor.anakin_lanes`` device
                 envs through the learner's own network, block assembly
                 and the ring write into the device replay, one CUDA
                 graph (actor/anakin.py ``ActSegment``);
    train        the learner's dispatch, exactly as the orchestrator
                 dispatches it (the same ``Learner``).

Weights are read by reference: the segment's forward reads the learner's
parameters, which its dispatch updates in place, so acting is never more
than one dispatch stale. Blocks are stamped with a pseudo publish count
that advances every ``runtime.weight_publish_interval`` learner steps,
the clock a weight service would have ticked.

At a quantized ``network.inference_dtype`` the segment acts with the
publish-time twin (an ``InferenceTwin``), rebuilt from the learner's
weights only when the pseudo publish count ticks and adopted into the
storage the segment's graph reads (``load_``, every address kept), on the
loop's stream between the learner's dispatch and the next segment. Every
``telemetry.quant_probe_interval``-th segment the probe runs after it,
outside the graph; the record gains a ``quant`` block.

With ``mesh.dp`` > 1 every rank runs this loop's acting and learning on
its own device (runtime/data_parallel.py starts the ranks): rank s acts
its lane group (lanes ``[s*lps, (s+1)*lps)`` of the global epsilon ladder,
parallel/sharded.py ``make_sharded_anakin_act``) and writes straight into
its replay shard, with no separate commit; the learner's step is the
data-parallel one. Rank 0 decides when to act, train, save and stop and
announces each to the followers (``Learner.command``); the record's
``anakin`` block carries the per-shard stats, gathered to rank 0.

Host work is bookkeeping at segment cadence (N blocks, N * L env steps at
a time): ring accounting, the rate limiter, the metrics, checkpoints and
replay snapshots (``runtime.snapshot_interval``, the ``recovery`` block).
Episode counts and returns are summed on the card and read at log time.
The loop is single-threaded, so given its seeds it is deterministic on
the CPU; the collect:learn interleave is set by
``actor.anakin_scans_per_train`` and the rate limiter.

Telemetry: the loop's own ``Telemetry`` observes ``actor/act_scan`` (a
segment's launch, with a span) and ``ingest/commit`` (the host's commit of
the segment's blocks: the ring write itself is in the segment's graph),
beside the learner's stages; spans drain to
``{save_dir}/spans_player0.jsonl``, and the profiler's capture triggers
(telemetry/profiler.py) ride the loop as in the orchestrator's.
"""

import logging
import os
import time
from typing import Callable, Optional

import torch

from r2d2_tpu_torch.actor.anakin import ActSegment
from r2d2_tpu_torch.actor.policy import InferenceTwin
from r2d2_tpu_torch.config import Config, apex_epsilon
from r2d2_tpu_torch.envs.factory import create_device_env
from r2d2_tpu_torch.models.network import (NetworkApply,
                                           make_inference_bundle)
from r2d2_tpu_torch.parallel.mesh import Mesh
from r2d2_tpu_torch.parallel.sharded import (gather_objects,
                                             init_sharded_act_carry,
                                             make_sharded_anakin_act,
                                             shard_seed)
from r2d2_tpu_torch.telemetry.core import Telemetry
from r2d2_tpu_torch.telemetry.profiler import CaptureTriggers
from r2d2_tpu_torch.telemetry.quant import QuantStats
from r2d2_tpu_torch.telemetry.resources import (HealthPlane, pytree_nbytes,
                                                register_buffer)
from r2d2_tpu_torch.runtime.data_parallel import data_parallel
from r2d2_tpu_torch.runtime.learner_loop import OP_USER, Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

OP_ACT = OP_USER            # rank 0's command: a segments at version b
OP_STATS = OP_USER + 1      # gather every shard's stats to rank 0


class AnakinStack:
    """What the callers of ``orchestrator.train`` read of its PlayerStack,
    for the on-device path: the learner, the metrics and the acting
    segment (its carry, draws and newest blocks). No actor, weight service
    or shared-memory segment exists."""

    def __init__(self, cfg: Config, learner: Learner, metrics: TrainMetrics,
                 segment: ActSegment):
        self.cfg = cfg
        self.player_idx = 0
        self.learner = learner
        self.metrics = metrics
        self.segment = segment
        # quantized acting: the twin's adoptions (host ms each, the
        # rebuild and the copy into the segment's storage) and the probe
        self.twin_ms: list = []
        self.quant_stats = None
        self.snapshots = None
        self.processes: list = []
        self.threads: list = []
        self.segment_names: list = []

    def close(self) -> None:
        self.learner.stop_background()
        self.metrics.telemetry.close()
        self.metrics.close()


class _FusedParts:
    """What every rank of the fused loop builds on its device: the env,
    the network, the learner (data-parallel with a mesh), this rank's
    acting segment over its replay shard and, at a quantized inference
    dtype, the twin the segment acts with."""

    def __init__(self, cfg: Config, device: torch.device,
                 mesh: Optional[Mesh], metrics: Optional[TrainMetrics]):
        num_lanes = cfg.actor.anakin_lanes
        self.env = env = create_device_env(cfg.env, device)
        self.net = net = NetworkApply(env.action_dim, cfg.network,
                                      cfg.env.frame_stack,
                                      cfg.env.frame_height,
                                      cfg.env.frame_width, device)
        self.learner = learner = Learner(cfg, net, metrics=metrics,
                                         mesh=mesh)
        spec = learner.spec
        # the ladder spans the global lane count whatever the mesh: dp
        # changes where lanes run, never the exploration schedule
        epsilons = [apex_epsilon(i, num_lanes, cfg.actor.base_eps,
                                 cfg.actor.eps_alpha)
                    for i in range(num_lanes)]
        one = mesh or Mesh(dp=1, rank=0, device=device, backend="")
        act = make_sharded_anakin_act(
            env, net, spec, mesh=one, num_lanes=num_lanes,
            epsilons=epsilons, gamma=cfg.optim.gamma,
            priority=cfg.actor.anakin_priority,
            near_greedy_eps=cfg.actor.near_greedy_eps,
            priority_eta=cfg.optim.priority_eta, quant_probe_on=False)
        generator = torch.Generator(device=device).manual_seed(
            shard_seed(cfg.runtime.seed + 17, one.rank))
        carry = init_sharded_act_carry(env, spec, num_lanes, one,
                                       generator=generator)
        self.quant = cfg.network.inference_dtype != "f32"
        self.twin, self.adopted = None, 1
        self.twin_ms: list = []
        self.quant_stats: Optional[QuantStats] = None
        if self.quant:
            # the publication at stamp 1, as a weight service starts
            with torch.no_grad():
                self.twin = InferenceTwin(net, make_inference_bundle(
                    net, learner.train_state.params, 1), device)
        self.segment = ActSegment(
            act, self.twin if self.quant else learner.train_state.params,
            carry, spec, learner.replay_state, generator)

    def act(self, wv: int) -> None:
        """One segment at pseudo publish count ``wv``: the twin rebuilt
        from the learner's weights when the count has ticked, into the
        storage the graph reads (its copies queue on this stream behind
        the learner's dispatch), then the segment."""
        if self.quant and self.adopted != wv:
            t0 = time.perf_counter()
            with torch.no_grad():
                self.twin.load_(make_inference_bundle(
                    self.net, self.learner.train_state.params, wv))
            self.twin_ms.append((time.perf_counter() - t0) * 1e3)
            self.adopted = wv
            if self.quant_stats is not None:
                self.quant_stats.on_stamp(wv)
        self.segment.run(wv)
        self.learner.shard_blocks += self.segment.act.num_lanes


def follow_anakin(cfg: Config, mesh: Mesh) -> None:
    """A follower rank of the fused loop: its parts, then rank 0's
    commands (act, gather the stats, and the learner's own) until the
    stop."""
    parts = _FusedParts(cfg, mesh.device, mesh, None)

    def act(n: int, wv: int) -> None:
        for _ in range(n):
            parts.act(wv)

    try:
        parts.learner.follow({
            OP_ACT: act,
            OP_STATS: lambda a, b: gather_objects(
                parts.segment.take_stats(), mesh)})
    finally:
        parts.learner.stop_background()


def run_anakin_train(cfg: Config, *, max_training_steps: Optional[int] = None,
                     max_seconds: Optional[float] = None, device=None,
                     log_fn: Optional[Callable[[dict], None]] = None,
                     dispatch_hook: Optional[Callable[[AnakinStack], None]]
                     = None, mesh_devices=None, mesh_backend=None
                     ) -> AnakinStack:
    """Run the fused loop until ``max_training_steps`` learner steps
    (optim.training_steps) or ``max_seconds``; returns the stack, closed,
    its learner holding the final state: the contract of
    ``orchestrator.train``, which delegates here when ``actor.on_device``
    is set. ``device``: CUDA by default (raises without one).
    ``dispatch_hook`` is called after every learner dispatch with the
    stack. ``mesh.dp`` > 1: this process is rank 0 of the ranks
    runtime/data_parallel.py starts (``mesh_devices``/``mesh_backend`` as
    ``data_parallel`` takes them)."""
    if not cfg.actor.on_device:
        raise ValueError("run_anakin_train requires actor.on_device=True")
    device = resolve_device(device)
    configure_numerics()
    with data_parallel(cfg, device, mesh_devices, mesh_backend) as mesh:
        return _lead(cfg, mesh.device if mesh else device, mesh,
                     max_training_steps, max_seconds, log_fn, dispatch_hook)


def _lead(cfg: Config, device: torch.device, mesh: Optional[Mesh],
          max_training_steps, max_seconds, log_fn, dispatch_hook
          ) -> AnakinStack:
    """Rank 0's loop (the only rank's on one device)."""
    num_lanes = cfg.actor.anakin_lanes
    dp = mesh.dp if mesh is not None else 1
    metrics = TrainMetrics(0, cfg.runtime.save_dir,
                           resume=bool(cfg.runtime.resume))
    telemetry = Telemetry.from_config(cfg, name="anakin-p0")
    metrics.set_telemetry(telemetry)
    if telemetry.enabled:
        telemetry.start_drain(
            os.path.join(cfg.runtime.save_dir or ".", "spans_player0.jsonl"),
            append=bool(cfg.runtime.resume))
    parts = _FusedParts(cfg, device, mesh, metrics)
    learner, segment = parts.learner, parts.segment
    if cfg.runtime.snapshot_interval > 0:
        metrics.set_recovery(learner.recovery_block)
    seg_steps = learner.spec.block_length  # learning steps a lane-block
    pub_interval = max(cfg.runtime.weight_publish_interval, 1)

    def publish_count() -> int:
        # the by-reference publication clock: what a weight service would
        # have counted with a publish every weight_publish_interval steps
        # (1 = the initial weights)
        return 1 + learner.training_steps // pub_interval

    learner.weight_version_fn = publish_count

    probe_interval = cfg.telemetry.quant_probe_interval
    quant_stats = None
    if parts.quant:
        quant_stats = parts.quant_stats = QuantStats(
            cfg.network.inference_dtype, probe_interval)
        quant_stats.on_stamp(1)
        metrics.set_quant(quant_stats.interval_block)
    stack = AnakinStack(cfg, learner, metrics, segment)
    stack.quant_stats = quant_stats
    # the resources block and the alert engine; the lane carry is this
    # loop's own device buffer (no actor fleet, so no board gauges)
    health = HealthPlane.from_config(cfg, metrics, 0, devices=[device])
    if health is not None:
        register_buffer("p0/anakin_carry", pytree_nbytes(segment.carry))
    stack.twin_ms = parts.twin_ms
    segments_since_flush = 0
    segments = 0

    def act_segment() -> None:
        nonlocal segments_since_flush, segments
        t0 = time.time()
        wv = publish_count()
        if mesh is not None:
            learner.command(OP_ACT, 1, wv)
        parts.act(wv)
        t1 = time.time()
        telemetry.observe("actor/act_scan", t1 - t0)
        telemetry.record_span("actor/act_scan", t0, t1,
                              {"lanes": num_lanes, "steps": seg_steps,
                               "shards": dp})
        segments += 1
        if (parts.quant and probe_interval > 0
                and segments % probe_interval == 0):
            probe = segment.probe()
            quant_stats.on_probe(probe["quant_dq"], probe["quant_agree"],
                                 lanes=num_lanes // dp)
        t_commit = time.time()
        for _ in range(num_lanes):
            learner.ring.advance(seg_steps, wv)
            metrics.on_block(seg_steps, None)
        learner.env_steps += num_lanes * seg_steps
        metrics.set_buffer_size(learner.ring.buffer_steps)
        t2 = time.time()
        telemetry.observe("ingest/commit", t2 - t_commit)
        metrics.on_ingest_drain(num_lanes, t2 - t0)
        segments_since_flush += 1

    def flush_stats() -> None:
        nonlocal segments_since_flush
        if not segments_since_flush:
            return
        stats = segment.take_stats()
        shards = [stats]
        if mesh is not None:
            learner.command(OP_STATS)
            shards = gather_objects(stats, mesh)
        reported = [int(s["reported_episodes"]) for s in shards]
        returns = [s["reported_return_sum"] for s in shards]
        metrics.on_episodes(sum(reported), sum(returns))
        env_steps = [int(s["env_steps"]) for s in shards]
        lo = min(env_steps)
        metrics.set_anakin({
            "dp": dp, "lanes_per_shard": num_lanes // dp,
            "shard_env_steps": env_steps,
            "shard_episodes": [int(s["episodes"]) for s in shards],
            "shard_reported_episodes": reported,
            "shard_return_sum": [round(r, 4) for r in returns],
            "shard_imbalance": (round(max(env_steps) / lo, 4) if lo > 0
                                else None),
        })
        segments_since_flush = 0

    start = time.time()
    deadline = start + max_seconds if max_seconds else None
    max_steps = max_training_steps or cfg.optim.training_steps
    last_log = start
    final_error = None
    triggers = CaptureTriggers(cfg.runtime)
    try:
        triggers.install()
        triggers.start_first_interval()
        if cfg.runtime.save_interval:
            learner.save(0)
        while ((deadline is None or time.time() < deadline)
               and learner.training_steps < max_steps):
            if learner.ingestion_paused:
                # the rate limiter: collection is ahead of the budget;
                # only train until it reopens (it is never closed while
                # the training gate is: only acting can open that)
                learner._note_pause(True)
            else:
                learner._note_pause(False)
                scans = (cfg.actor.anakin_scans_per_train
                         if learner.ready else 1)
                for _ in range(scans):
                    act_segment()
            if learner.ready and learner.training_steps < max_steps:
                learner.step()
                if dispatch_hook is not None:
                    dispatch_hook(stack)
            now = time.time()
            triggers.poll(now, learner.training_steps)
            if health is not None:
                health.tick(learner.warm)
            if now - last_log >= cfg.runtime.log_interval:
                learner.flush_metrics()
                flush_stats()
                record = metrics.log(now - last_log)
                if log_fn:
                    log_fn({"player": 0, **record})
                last_log = now
        learner.flush_metrics()
        flush_stats()
    finally:
        triggers.uninstall()    # stop a running capture, restore SIGUSR2
        try:
            if cfg.runtime.save_interval:
                learner.save_final()
        except Exception as e:
            logging.getLogger(__name__).exception("final checkpoint failed")
            final_error = e
        stack.close()
        if health is not None:
            health.close()
    if final_error is not None:
        raise RuntimeError("the final checkpoint or replay snapshot failed"
                           ) from final_error
    return stack
