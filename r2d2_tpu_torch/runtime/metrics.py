"""Training metrics and logging, the JAX package's ``TrainMetrics``: the
reference's log lines in
``train_player{p}.log`` (the key strings its plot script matches) and one
JSON record per log interval in ``metrics_player{p}.jsonl`` with the
record's core keys (throughput, ingestion, worker health, dropped
priority updates) and, from the on-device acting loop, its ``anakin``
block; with the policy server a ``serving`` block, at a quantized
inference dtype a ``quant`` block (the JAX package's keys), with the
ingest stager (``replay.ingest_batch_blocks`` > 1) an ``ingest`` block,
with replay snapshots a ``recovery`` block, and with the diagnostics (on
by default; ``telemetry.enabled=false`` turns both off) a ``learning``
block (|TD|, priority and |Q| histograms with their counts, gradient
norms by group, the target distance and dQ, sample and occupancy ages,
non-finite steps; telemetry/learning.py) and a ``replay_diag`` block
(the sum tree's health, the eviction ledger with the never-sampled
share, the sampled lanes; telemetry/replaydiag.py), in the JAX package's
schema. With telemetry on (``telemetry.enabled``, the default) every
record carries ``stages`` ({stage: {count, p50_ms, p95_ms, p99_ms}} for
each stage observed in the interval, process actors' through the board;
telemetry/core.py) and ``telemetry_dropped_spans``, and the first one the
one-shot ``costs`` block (telemetry/costmodel.py). With
``telemetry.resources_enabled`` (on by default) every record carries a
``resources`` block (devices, host, buffer owners, the compile sub-block;
telemetry/resources.py) and, with ``telemetry.alerts_enabled``, an
``alerts`` block, the rule engine's pass over the assembled record
(telemetry/alerts.py; firings to ``alerts_player{p}.jsonl``). Without
them the record is what it was.

``log_dir=None`` keeps everything in memory: no file is written (what a
bare ``Learner`` gets).
"""

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

import numpy as np


class TrainMetrics:
    def __init__(self, player_idx: int = 0, log_dir: Optional[str] = ".",
                 resume: bool = False):
        self.player_idx = player_idx
        self.logger = logging.getLogger(f"r2d2_tpu_torch.player_{player_idx}"
                                        f".{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.handlers = []
        self._jsonl_path = None
        if log_dir is not None:
            os.makedirs(log_dir or ".", exist_ok=True)
            path = os.path.join(log_dir or ".",
                                f"train_player{player_idx}.log")
            # a resumed run appends; a fresh one truncates both files
            handler = logging.FileHandler(path, "a" if resume else "w")
            handler.setFormatter(logging.Formatter("%(message)s"))
            self.logger.handlers = [handler]
            self._jsonl_path = os.path.join(
                log_dir or ".", f"metrics_player{player_idx}.jsonl")
            if not resume:
                open(self._jsonl_path, "w").close()
        self._start = time.time()

        self.buffer_size = 0
        self.env_steps = 0
        self.last_env_steps = 0
        self.num_episodes = 0
        self.episode_reward = 0.0
        self.training_steps = 0
        self.last_training_steps = 0
        self.sum_loss = 0.0
        self.dropped_priority_updates = 0
        self._next_drop_warn = 1

        # ingestion, per interval (reset at each log) and cumulative
        self._ingest_lock = threading.Lock()
        self.ingest_blocks_total = 0
        self._ingest_drains = 0
        self._ingest_blocks = 0
        self._ingest_latency_sum = 0.0
        self._ingest_pause_time = 0.0
        # the latest supervision snapshot (WorkerHealth.snapshot)
        self._actor_health = {}
        self._anakin: Optional[dict] = None
        self._learning: Optional[dict] = None
        self._replay_diag: Optional[dict] = None
        # interval-block providers: called once a record, None = none
        self._serving: Optional[Callable[[], Optional[dict]]] = None
        self._quant: Optional[Callable[[], dict]] = None
        self._recovery: Optional[Callable[[], Optional[dict]]] = None
        self._replay_service: Optional[Callable[[], Optional[dict]]] = None
        self._tracing: Optional[Callable[[], Optional[dict]]] = None
        self._costs: Optional[dict] = None
        self._resources: Optional[Callable[[], dict]] = None
        self._sentinel = None
        # the process's Telemetry (set_telemetry): its interval summary is
        # the record's stages block; NULL keeps a bare construction
        # working with no branch at the call sites
        from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY
        self.telemetry = NULL_TELEMETRY
        # the ingest stager's block (set_ingest_batching): K, the staging
        # queue's depth, and per interval its batches and host ms
        self._ingest_k = 1
        self.ingest_queue_depth = 0
        self._stage_batches = 0
        self._stage_ms = 0.0
        self._commit_batches = 0
        self._commit_ms = 0.0

    # -- feed points --

    def on_block(self, learning_steps: int,
                 episode_return: Optional[float]) -> None:
        """Per ingested block."""
        self.env_steps += learning_steps
        if episode_return is not None and not np.isnan(episode_return):
            self.episode_reward += float(episode_return)
            self.num_episodes += 1

    def on_episodes(self, count: int, return_sum: float) -> None:
        """Episodes whose returns were summed on the device (on-device
        acting reads them at log time, not block by block)."""
        self.num_episodes += int(count)
        self.episode_reward += float(return_sum)

    def set_anakin(self, block: Optional[dict]) -> None:
        """The interval's on-device acting block (env steps, episodes,
        reported episodes and their return sum, in the JAX package's keys
        at dp=1; runtime/anakin_loop.py flush_stats); emitted once as the
        record's "anakin" key, None = none this interval."""
        self._anakin = block

    def set_learning(self, block: Optional[dict]) -> None:
        """The interval's learning-diagnostics block; emitted once as the
        record's "learning" key, None = none this interval."""
        self._learning = block

    def set_replay_diag(self, block: Optional[dict]) -> None:
        """The interval's replay-diagnostics block; emitted once as the
        record's "replay_diag" key, None = none this interval."""
        self._replay_diag = block

    def set_telemetry(self, telemetry) -> None:
        """The process's Telemetry: log() then emits its interval summary
        as the ``stages`` block (fleet-wide when an actor board is
        attached to it)."""
        self.telemetry = telemetry

    def set_costs(self, block: Optional[dict]) -> None:
        """The one-shot cost-model block: emitted on one record, then
        cleared; None = none."""
        self._costs = block

    def set_serving(self, provider: Callable[[], Optional[dict]]) -> None:
        """The policy server's ``serving`` block provider (consumes its
        interval; a None block is left out of the record)."""
        self._serving = provider

    def set_quant(self, provider: Callable[[], dict]) -> None:
        """The quantized forward's ``quant`` block provider."""
        self._quant = provider

    def set_recovery(self, provider: Callable[[], Optional[dict]]) -> None:
        """The crash-recovery block provider (``Learner.recovery_block``;
        a None block is left out of the record)."""
        self._recovery = provider

    def set_replay_service(self, provider: Callable[[], Optional[dict]]
                           ) -> None:
        """The replay service's ``replay_service`` block provider (its
        shards, spill tier, grouped ingest and socket rung; consumes the
        interval; a None block is left out)."""
        self._replay_service = provider

    def set_tracing(self, provider: Callable[[], Optional[dict]]) -> None:
        """The experience trace's ``trace`` block provider
        (``ExperienceTrace.interval_block``; an interval that traced
        nothing gives None, left out)."""
        self._tracing = provider

    def set_resources(self, provider: Callable[[], dict]) -> None:
        """The ResourceMonitor's ``block`` (consumes the compile
        interval): every record then carries a ``resources`` block."""
        self._resources = provider

    def set_sentinel(self, engine) -> None:
        """The alert engine: log() evaluates its rules on the assembled
        record, after every other block, and the record carries the
        ``alerts`` block; firings append to the engine's jsonl."""
        self._sentinel = engine

    def set_ingest_batching(self, k: int) -> None:
        """The stager's batch size: K > 1 adds the ``ingest`` block."""
        self._ingest_k = int(k)

    def set_ingest_queue_depth(self, depth: int) -> None:
        """Staged batches waiting for their commit."""
        self.ingest_queue_depth = int(depth)

    def on_ingest_stage(self, ms: float) -> None:
        """One staged batch: the stager's host ms (pop, stack into pinned
        memory, launch of the copy)."""
        with self._ingest_lock:
            self._stage_batches += 1
            self._stage_ms += float(ms)

    def on_ingest_commit(self, ms: float) -> None:
        """One committed batch: the main thread's host ms for it."""
        with self._ingest_lock:
            self._commit_batches += 1
            self._commit_ms += float(ms)

    def on_train_step(self, loss: float) -> None:
        """Per learner step."""
        self.training_steps += 1
        self.sum_loss += float(loss)

    def set_buffer_size(self, size: int) -> None:
        self.buffer_size = int(size)

    def on_ingest_drain(self, blocks: int, latency: float) -> None:
        """Once per non-empty drain: ``blocks`` entered the replay in
        ``latency`` seconds from the first pop to the last write."""
        with self._ingest_lock:
            self._ingest_drains += 1
            self._ingest_blocks += blocks
            self.ingest_blocks_total += blocks
            self._ingest_latency_sum += latency

    def on_ingest_pause(self, seconds: float) -> None:
        """Rate-limiter pause time."""
        with self._ingest_lock:
            self._ingest_pause_time += seconds

    def set_actor_health(self, snapshot: dict) -> None:
        self._actor_health = dict(snapshot)

    def on_dropped_priority_update(self) -> None:
        """A priority write-back dropped on a full write-back queue (host
        placement): counted, and warned at the first drop and each 10x
        after, since it degrades prioritized sampling toward uniform."""
        self.dropped_priority_updates += 1
        if self.dropped_priority_updates >= self._next_drop_warn:
            logging.getLogger(__name__).warning(
                "player %d: %d priority write-back batch(es) dropped under "
                "write-back queue backpressure; prioritized sampling is "
                "degrading toward uniform", self.player_idx,
                self.dropped_priority_updates)
            self._next_drop_warn *= 10

    # -- emission (the reference's key strings) --

    def log(self, log_interval: float) -> dict:
        self.logger.info(f"buffer size: {self.buffer_size}")
        buffer_speed = (self.env_steps - self.last_env_steps) / log_interval
        self.logger.info(f"buffer update speed: {buffer_speed}/s")
        self.logger.info(f"number of environment steps: {self.env_steps}")
        avg_return = None
        if self.num_episodes != 0:
            avg_return = self.episode_reward / self.num_episodes
            self.logger.info(f"average episode return: {avg_return:.4f}")
            self.episode_reward = 0.0
            self.num_episodes = 0
        self.logger.info(f"number of training steps: {self.training_steps}")
        train_speed = ((self.training_steps - self.last_training_steps)
                       / log_interval)
        self.logger.info(f"training speed: {train_speed}/s")
        mean_loss = None
        if self.training_steps != self.last_training_steps:
            mean_loss = self.sum_loss / (self.training_steps
                                         - self.last_training_steps)
            self.logger.info(f"loss: {mean_loss:.4f}")
            self.last_training_steps = self.training_steps
            self.sum_loss = 0.0
        self.last_env_steps = self.env_steps
        for handler in self.logger.handlers:
            handler.flush()

        record = {
            "t": time.time() - self._start,
            "buffer_size": self.buffer_size,
            "buffer_speed": buffer_speed,
            "env_steps": self.env_steps,
            "avg_episode_return": avg_return,
            "training_steps": self.training_steps,
            "training_speed": train_speed,
            "loss": mean_loss,
            "dropped_priority_updates": self.dropped_priority_updates,
            "actor_restarts": 0,
            "actor_hangs_detected": 0,
            "actor_breaker_trips": 0,
            "actor_parked_slots": 0,
            "shm_slots_recovered": 0,
            "ingest_stall_dumps": 0,
            "heartbeat_age_max_s": None,
        }
        record.update(self._actor_health)
        with self._ingest_lock:
            record.update({
                "ingest_blocks_total": self.ingest_blocks_total,
                "ingest_drains": self._ingest_drains,
                "ingest_blocks_per_drain": (
                    round(self._ingest_blocks / self._ingest_drains, 2)
                    if self._ingest_drains else None),
                "ingest_drain_latency_ms": (
                    round(1e3 * self._ingest_latency_sum
                          / self._ingest_drains, 3)
                    if self._ingest_drains else None),
                "ingest_pause_time": round(self._ingest_pause_time, 3),
            })
            if self._ingest_k > 1:
                record["ingest"] = {
                    "batch_blocks": self._ingest_k,
                    "queue_depth": self.ingest_queue_depth,
                    "staged_batches": self._stage_batches,
                    "stage_ms": (round(self._stage_ms / self._stage_batches,
                                       3) if self._stage_batches else None),
                    "committed_batches": self._commit_batches,
                    "commit_ms": (round(self._commit_ms
                                        / self._commit_batches, 3)
                                  if self._commit_batches else None),
                }
            self._ingest_drains = 0
            self._ingest_blocks = 0
            self._ingest_latency_sum = 0.0
            self._ingest_pause_time = 0.0
            self._stage_batches = self._commit_batches = 0
            self._stage_ms = self._commit_ms = 0.0
        if self._anakin is not None:
            record["anakin"] = self._anakin
            self._anakin = None
        if self._learning is not None:
            record["learning"] = self._learning
            self._learning = None
        if self._replay_diag is not None:
            record["replay_diag"] = self._replay_diag
            self._replay_diag = None
        if self._costs is not None:
            record["costs"] = self._costs
            self._costs = None
        if self.telemetry.enabled:
            record["stages"] = self.telemetry.interval_summary()
            record["telemetry_dropped_spans"] = self.telemetry.spans.dropped
        if self._serving is not None:
            block = self._serving()
            if block is not None:
                record["serving"] = block
        if self._quant is not None:
            record["quant"] = self._quant()
        if self._replay_service is not None:
            block = self._replay_service()
            if block is not None:
                record["replay_service"] = block
        if self._recovery is not None:
            block = self._recovery()
            if block is not None:
                record["recovery"] = block
        if self._tracing is not None:
            block = self._tracing()
            if block is not None:
                record["trace"] = block
        if self._resources is not None:
            record["resources"] = self._resources()
        if self._sentinel is not None:
            record["alerts"] = self._sentinel.evaluate(record)
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record

    def close(self) -> None:
        """Close the log file's handler."""
        for handler in self.logger.handlers:
            handler.close()
        self.logger.handlers = []
