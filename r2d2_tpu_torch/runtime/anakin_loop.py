"""The fused act+train loop of on-device acting, the counterpart of the JAX
package's ``runtime/anakin_loop.py`` at one device (``mesh.dp`` = 1).

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

Host work is bookkeeping at segment cadence (N blocks, N * L env steps at
a time): ring accounting, the rate limiter, the metrics, checkpoints.
Episode counts and returns are summed on the card and read at log time.
The loop is single-threaded, so given its seeds it is deterministic on
the CPU; the collect:learn interleave is set by
``actor.anakin_scans_per_train`` and the rate limiter.
"""

import logging
import time
from typing import Callable, Optional

import torch

from r2d2_tpu_torch.actor.anakin import ActSegment, AnakinAct, init_act_carry
from r2d2_tpu_torch.config import Config, apex_epsilon
from r2d2_tpu_torch.envs.factory import create_device_env
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.runtime.metrics import TrainMetrics
from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device


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
        self.snapshots = None
        self.processes: list = []
        self.threads: list = []
        self.segment_names: list = []

    def close(self) -> None:
        self.learner.stop_background()
        self.metrics.close()


def run_anakin_train(cfg: Config, *, max_training_steps: Optional[int] = None,
                     max_seconds: Optional[float] = None, device=None,
                     log_fn: Optional[Callable[[dict], None]] = None,
                     dispatch_hook: Optional[Callable[[AnakinStack], None]]
                     = None) -> AnakinStack:
    """Run the fused loop until ``max_training_steps`` learner steps
    (optim.training_steps) or ``max_seconds``; returns the stack, closed,
    its learner holding the final state: the contract of
    ``orchestrator.train``, which delegates here when ``actor.on_device``
    is set. ``device``: CUDA by default (raises without one).
    ``dispatch_hook`` is called after every learner dispatch with the
    stack."""
    if not cfg.actor.on_device:
        raise ValueError("run_anakin_train requires actor.on_device=True")
    device = resolve_device(device)
    configure_numerics()
    num_lanes = cfg.actor.anakin_lanes
    env = create_device_env(cfg.env, device)
    net = NetworkApply(env.action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    metrics = TrainMetrics(0, cfg.runtime.save_dir,
                           resume=bool(cfg.runtime.resume))
    learner = Learner(cfg, net, metrics=metrics)
    spec = learner.spec
    seg_steps = spec.block_length          # learning steps a lane-block
    pub_interval = max(cfg.runtime.weight_publish_interval, 1)

    def publish_count() -> int:
        # the by-reference publication clock: what a weight service would
        # have counted with a publish every weight_publish_interval steps
        # (1 = the initial weights)
        return 1 + learner.training_steps // pub_interval

    epsilons = [apex_epsilon(i, num_lanes, cfg.actor.base_eps,
                             cfg.actor.eps_alpha) for i in range(num_lanes)]
    act = AnakinAct(env, net, spec, num_lanes=num_lanes, epsilons=epsilons,
                    gamma=cfg.optim.gamma,
                    priority=cfg.actor.anakin_priority,
                    near_greedy_eps=cfg.actor.near_greedy_eps,
                    priority_eta=cfg.optim.priority_eta)
    generator = torch.Generator(device=device).manual_seed(
        cfg.runtime.seed + 17)
    carry = init_act_carry(env, spec, num_lanes, generator=generator)
    segment = ActSegment(act, learner.train_state.params, carry, spec,
                         learner.replay_state, generator)
    stack = AnakinStack(cfg, learner, metrics, segment)
    segments_since_flush = 0

    def act_segment() -> None:
        nonlocal segments_since_flush
        t0 = time.time()
        wv = publish_count()
        stack.segment.run(wv)
        for _ in range(num_lanes):
            learner.ring.advance(seg_steps, wv)
            metrics.on_block(seg_steps, None)
        learner.env_steps += num_lanes * seg_steps
        metrics.set_buffer_size(learner.ring.buffer_steps)
        metrics.on_ingest_drain(num_lanes, time.time() - t0)
        segments_since_flush += 1

    def flush_stats() -> None:
        nonlocal segments_since_flush
        if not segments_since_flush:
            return
        stats = segment.take_stats()
        reported = int(stats["reported_episodes"])
        metrics.on_episodes(reported, stats["reported_return_sum"])
        env_steps = segments_since_flush * num_lanes * seg_steps
        metrics.set_anakin({
            "dp": 1, "lanes_per_shard": num_lanes,
            "shard_env_steps": [env_steps],
            "shard_episodes": [int(stats["episodes"])],
            "shard_reported_episodes": [reported],
            "shard_return_sum": [round(stats["reported_return_sum"], 4)],
            "shard_imbalance": 1.0,
        })
        segments_since_flush = 0

    start = time.time()
    deadline = start + max_seconds if max_seconds else None
    max_steps = max_training_steps or cfg.optim.training_steps
    last_log = start
    try:
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
        try:
            if cfg.runtime.save_interval:
                learner.save_final()
        except Exception:
            logging.getLogger(__name__).exception("final checkpoint failed")
        stack.close()
    return stack
