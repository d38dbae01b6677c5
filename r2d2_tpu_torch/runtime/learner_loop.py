"""A minimal learner: the train state, the replay, block ingestion, the
training gate, and one dispatch of learner steps per call. The counterpart
of the JAX package's ``Learner`` without its telemetry, checkpoints or
services.

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
  in ``dropped_priority_updates``.
"""

import logging
import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                               make_external_batch_step,
                                               make_learner_step,
                                               make_multi_learner_step)
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay.device_replay import replay_add, replay_init
from r2d2_tpu_torch.replay.host_replay import HostReplay, batch_layout
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           SampleBatch, batch_fields)
from r2d2_tpu_torch.utils.device import configure_numerics

WRITEBACK_QUEUE = 64        # steps of priorities waiting for the host tree
TIMINGS_KEPT = 4096         # per-batch sample and copy times kept
_TORCH_DTYPES = {np.uint8: torch.uint8, np.int32: torch.int32,
                 np.float32: torch.float32}


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
            pinned = {name: torch.empty(shape, dtype=_TORCH_DTYPES[dtype],
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


class Learner:
    def __init__(self, cfg: Config, net: NetworkApply, seed: int = 0):
        configure_numerics()
        self.cfg = cfg
        self.net = net
        self.device = net.device
        self.spec = ReplaySpec.from_config(cfg, self.device)
        use_double = cfg.network.use_double
        self.train_state = create_train_state(net, cfg.optim, seed,
                                              use_double)
        self.host_replay: Optional[HostReplay] = None
        if cfg.replay.placement == "host":
            if cfg.runtime.steps_per_dispatch > 1:
                logging.getLogger(__name__).warning(
                    "replay.placement='host': ignoring "
                    "runtime.steps_per_dispatch=%d (host mode trains one "
                    "host-sampled batch per step)",
                    cfg.runtime.steps_per_dispatch)
            self.steps_per_dispatch = 1
            self.replay_state = None
            self.host_replay = HostReplay(self.spec, seed=seed)
            self.ring = self.host_replay.ring
            self._step_fn = make_external_batch_step(net, self.spec,
                                                     cfg.optim, use_double)
            self._prefetch_q: queue.Queue = queue.Queue(
                maxsize=max(1, cfg.runtime.prefetch_batches))
            self._writeback_q: queue.Queue = queue.Queue(
                maxsize=WRITEBACK_QUEUE)
            self._bg_stop = threading.Event()
            self._bg_threads: List[threading.Thread] = []
            self._bg_error: Optional[BaseException] = None
            self.dropped_priority_updates = 0
            # per batch, in the prefetch thread: the sample's host ms and
            # (on CUDA) its copy's device ms
            self.timings = {"sample_ms": deque(maxlen=TIMINGS_KEPT),
                            "h2d_ms": deque(maxlen=TIMINGS_KEPT)}
        else:
            self.replay_state = replay_init(self.spec, self.device)
            self.ring = RingAccountant(self.spec.num_blocks)
            self.steps_per_dispatch = \
                cfg.runtime.resolved_steps_per_dispatch(self.device)
            if self.steps_per_dispatch > 1:
                self._step_fn = make_multi_learner_step(
                    net, self.spec, cfg.optim, use_double,
                    self.steps_per_dispatch)
            else:
                self._step_fn = make_learner_step(net, self.spec, cfg.optim,
                                                  use_double)
        self.env_steps = 0
        # per dispatch: a device scalar (K = 1) or a (K,) tensor; no sync
        self.losses: List[torch.Tensor] = []

    def ingest(self, block: Block) -> None:
        """Ring-write one actor block."""
        learning = int(np.asarray(block.learning_steps).sum())
        if self.host_replay is not None:
            self.host_replay.add(block)     # advances the shared accountant
        else:
            replay_add(self.spec, self.replay_state, block)
            self.ring.advance(learning, int(np.asarray(block.weight_version)))
        self.env_steps += learning

    @property
    def ready(self) -> bool:
        """Training gate: replay.learning_starts buffered learning steps."""
        return self.ring.buffer_steps >= self.cfg.replay.learning_starts

    @property
    def training_steps(self) -> int:
        return self.train_state.step

    def step(self, uniform: Optional[torch.Tensor] = None) -> dict:
        """One dispatch: ``steps_per_dispatch`` learner steps
        (``training_steps`` advances by that many). ``uniform``: the
        jitter, (B,) for one step a dispatch, else (K, B); none under host
        placement, whose host replay draws its own."""
        if self.host_replay is not None:
            if uniform is not None:
                raise ValueError("host placement samples on the host: no "
                                 "jitter to inject")
            metrics = self._host_step_once()
        else:
            self.train_state, self.replay_state, metrics = self._step_fn(
                self.train_state, self.replay_state, uniform)
        self.losses.append(metrics["loss"])
        return metrics

    # -- host placement: the prefetch and write-back threads --

    def _prefetch(self) -> None:
        try:
            cuda = self.device.type == "cuda"
            placer = _BatchPlacer(self.spec, self.device) if cuda else None
            while not self._bg_stop.is_set():
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
                if ready is not None:
                    ready.synchronize()
                self.host_replay.update_priorities(
                    idxes, priorities.numpy(), snapshot)
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
        """Stop the host-placement threads: drain the prefetch queue so a
        thread parked in a full-queue put sees the stop, join each within
        ``join_timeout`` seconds, and warn about any still running. A
        no-op under device placement."""
        if self.host_replay is None:
            return
        self._bg_stop.set()
        stuck = []
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
        self.train_state, metrics = self._step_fn(self.train_state, batch)
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
            self.dropped_priority_updates += 1
        return metrics
