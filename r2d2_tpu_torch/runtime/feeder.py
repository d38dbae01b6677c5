"""Experience transport (actors -> learner) and worker health, the JAX
package's ``runtime/feeder.py``.

``BlockQueue`` is a bounded queue of fixed-shape ``Block`` records: the
native shared-memory ring (``shm_feeder.ShmBlockRing``) or a
``multiprocessing`` queue for process actors, a ``queue.Queue`` for thread
actors. Bounded, so a learner that falls behind (or a rate limiter that
pauses ingestion) parks the actors instead of filling host memory.

The health side: per-slot heartbeats in shared memory, the hang watchdog,
per-slot restart backoff and the crash-loop breaker (``WorkerHealth``),
one supervision scan for threads and processes alike
(``supervise_workers``), the learner's ingest stall detector, and the
schedule of shm-ring slot reclamation after a producer died.
"""

import json
import logging
import multiprocessing as mp
import queue as queue_mod
import time
from collections import deque
from multiprocessing import shared_memory
from typing import Callable, List, Optional

import numpy as np

from r2d2_tpu_torch.replay.structs import Block


def put_patient(q, block: Block, should_stop, poll: float = 0.5,
                beat: Optional[Callable[[], None]] = None) -> bool:
    """Blocking put that waits out any back-pressure but honors the stop
    signal; False iff stopped before the block was accepted. ``beat``
    (the worker's heartbeat touch) runs once a poll, so a producer parked
    by back-pressure still reads as alive to the hang watchdog.
    Module-level because process actors receive the raw queue, not the
    ``BlockQueue``."""
    while not should_stop():
        if beat is not None:
            beat()
        try:
            q.put(block, timeout=poll)
            return True
        except queue_mod.Full:
            continue
    return False


class HeartbeatBoard:
    """Per-slot worker liveness: an (n_slots, 2) float64 table
    [progress_count, last_beat_unix_ts] in one shared-memory segment, so
    thread and process workers publish through the same object. Picklable:
    the handle crosses the spawn boundary by name and the child attaches
    lazily; the creating process owns the segment and unlinks it on
    close()."""

    def __init__(self, n_slots: int, _attach_name: Optional[str] = None):
        self.n_slots = n_slots
        self._owner = _attach_name is None
        self._shm = None
        self._arr = None
        if self._owner:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=n_slots * 2 * 8)
            self._bind()
            self._arr[:, 0] = 0.0
            self._arr[:, 1] = time.time()
        else:
            self._name = _attach_name

    def __getstate__(self):
        return {"n_slots": self.n_slots, "name": self.name}

    def __setstate__(self, state):
        self.__init__(state["n_slots"], _attach_name=state["name"])

    @property
    def name(self) -> str:
        return self._shm.name if self._shm is not None else self._name

    def _bind(self) -> None:
        self._arr = np.ndarray((self.n_slots, 2), np.float64, self._shm.buf)

    def _ensure(self) -> np.ndarray:
        if self._shm is None:
            from r2d2_tpu_torch.runtime.weights import untrack_attached_shm
            self._shm = shared_memory.SharedMemory(name=self._name)
            untrack_attached_shm(self._shm)
            self._bind()
        return self._arr

    def beat(self, slot: int) -> None:
        """Progress heartbeat: one row store per block emit."""
        arr = self._ensure()
        arr[slot] = (arr[slot, 0] + 1.0, time.time())

    def touch(self, slot: int) -> None:
        """Liveness without progress (a parked producer)."""
        self._ensure()[slot, 1] = time.time()

    def reset_slot(self, slot: int) -> None:
        """A fresh incarnation starts its own grace clock."""
        self._ensure()[slot] = (0.0, time.time())

    def count(self, slot: int) -> int:
        return int(self._ensure()[slot, 0])

    def age(self, slot: int, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        return max(0.0, now - float(self._ensure()[slot, 1]))

    def ages(self, now: Optional[float] = None) -> np.ndarray:
        now = time.time() if now is None else now
        return np.maximum(now - self._ensure()[:, 1], 0.0)

    def close(self) -> None:
        if self._shm is None:
            return
        self._arr = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        self._shm = None


class WorkerHealth:
    """Per-slot health policy over a HeartbeatBoard: hang detection,
    exponential restart backoff, and the crash-loop breaker.

    Backoff: a slot's first failure respawns at once; each further
    failure inside ``restart_window_s`` doubles the wait, starting at
    ``backoff_base_s`` for the second (the k-th waits ``backoff_base_s *
    2^(k-2)``, capped at ``backoff_max_s``). Breaker: after
    ``max_restarts_per_window`` failures inside the window the slot is
    parked (no more respawns; training continues degraded, and the trip
    is logged and counted)."""

    def __init__(self, n_slots: int, board: Optional[HeartbeatBoard] = None,
                 hang_timeout_s: float = 0.0,
                 hang_spawn_grace_s: float = 300.0,
                 backoff_base_s: float = 1.0, backoff_max_s: float = 60.0,
                 max_restarts_per_window: int = 0,
                 restart_window_s: float = 300.0):
        self.board = board
        self.hang_timeout_s = hang_timeout_s
        self.hang_spawn_grace_s = hang_spawn_grace_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.max_restarts_per_window = max_restarts_per_window
        self.restart_window_s = restart_window_s
        self._windows = [deque() for _ in range(n_slots)]  # failure times
        self._next_allowed = [0.0] * n_slots
        self._parked = [False] * n_slots
        self.restarts = 0
        self.hangs_detected = 0
        self.breaker_trips = 0
        self.ring_slots_recovered = 0

    @classmethod
    def from_runtime(cls, n_slots: int, board: Optional[HeartbeatBoard],
                     rt) -> "WorkerHealth":
        """From a RuntimeConfig's health fields."""
        return cls(n_slots, board,
                   hang_timeout_s=rt.hang_timeout_s,
                   hang_spawn_grace_s=rt.hang_spawn_grace_s,
                   backoff_base_s=rt.restart_backoff_base_s,
                   backoff_max_s=rt.restart_backoff_max_s,
                   max_restarts_per_window=rt.max_restarts_per_window,
                   restart_window_s=rt.restart_window_s)

    def check_hung(self, slot: int, now: float) -> bool:
        """True when the slot's heartbeat is stale: hang_timeout_s after
        any beat, hang_spawn_grace_s (if longer) before the first."""
        if self.board is None or self.hang_timeout_s <= 0:
            return False
        timeout = self.hang_timeout_s
        if self.board.count(slot) == 0:
            timeout = max(timeout, self.hang_spawn_grace_s)
        return self.board.age(slot, now) > timeout

    def on_failure(self, slot: int, now: float, hung: bool = False) -> None:
        """Record one failure (death or hang): advances the backoff ladder
        and may trip the breaker."""
        log = logging.getLogger(__name__)
        if hung:
            self.hangs_detected += 1
            log.warning(
                "worker slot %d HUNG (alive, heartbeat %.1fs stale): "
                "killing and routing through respawn", slot,
                self.board.age(slot, now) if self.board is not None else -1.0)
        win = self._windows[slot]
        cutoff = now - self.restart_window_s
        while win and win[0] < cutoff:
            win.popleft()
        prior = len(win)
        win.append(now)
        if (self.max_restarts_per_window > 0
                and prior + 1 > self.max_restarts_per_window):
            self._parked[slot] = True
            self.breaker_trips += 1
            log.warning(
                "circuit breaker TRIPPED: worker slot %d failed %d times "
                "within %.0fs; slot parked, training continues degraded",
                slot, prior + 1, self.restart_window_s)
            return
        delay = 0.0 if prior == 0 else min(
            self.backoff_base_s * 2.0 ** (prior - 1), self.backoff_max_s)
        self._next_allowed[slot] = now + delay
        if delay:
            log.warning(
                "worker slot %d failed %d time(s) in the last %.0fs: "
                "respawn backed off %.1fs", slot, prior + 1,
                self.restart_window_s, delay)

    def is_parked(self, slot: int) -> bool:
        return self._parked[slot]

    def respawn_due(self, slot: int, now: float) -> bool:
        return not self._parked[slot] and now >= self._next_allowed[slot]

    def on_spawn(self, slot: int) -> None:
        self.restarts += 1

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Supervision counters for the periodic TrainMetrics record."""
        age_max = None
        if self.board is not None:
            ages = self.board.ages(now)
            if len(ages):
                age_max = round(float(ages.max()), 1)
        return {
            "actor_restarts": self.restarts,
            "actor_hangs_detected": self.hangs_detected,
            "actor_breaker_trips": self.breaker_trips,
            "actor_parked_slots": int(sum(self._parked)),
            "shm_slots_recovered": self.ring_slots_recovered,
            "heartbeat_age_max_s": age_max,
        }


def kill_worker(w) -> None:
    """Clear a hung worker. A process: terminate, a short join, then
    kill. A thread cannot be killed: set its per-spawn cancel event (its
    should_stop honors it if it ever wakes) and abandon it."""
    cancel = getattr(w, "health_cancel", None)
    if cancel is not None:
        cancel.set()
    if hasattr(w, "terminate"):
        w.terminate()
        w.join(timeout=1.0)
        if w.is_alive() and hasattr(w, "kill"):
            w.kill()
            w.join(timeout=1.0)


class IngestStallDetector:
    """Fires once per stall episode when no block arrives for
    ``timeout_s`` while workers are alive and the rate limiter is not
    pausing on purpose, logging a diagnostic dump instead of starving
    silently. Re-arms when blocks flow again."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._last_total: Optional[int] = None
        self._last_change: Optional[float] = None
        self._fired = False
        self._was_paused = False
        self.dumps = 0

    def check(self, blocks_total: int, workers_alive: int,
              limiter_paused: bool, now: Optional[float] = None,
              diagnostics: Optional[Callable[[], dict]] = None) -> bool:
        if self.timeout_s <= 0:
            return False
        now = time.time() if now is None else now
        if self._last_total is None or blocks_total != self._last_total:
            self._last_total = blocks_total
            self._last_change = now
            self._fired = False
            return False
        if limiter_paused:
            # a deliberate pause is no stall; the clock restarts after it
            self._was_paused = True
            self._last_change = now
            return False
        if self._was_paused:
            self._was_paused = False
            self._last_change = now
            return False
        if (self._fired or workers_alive == 0
                or now - self._last_change < self.timeout_s):
            return False
        self._fired = True
        self.dumps += 1
        info = diagnostics() if diagnostics is not None else {}
        logging.getLogger(__name__).warning(
            "ingestion STALLED: zero blocks for %.1fs with %d worker(s) up; "
            "diagnostics: %s", now - self._last_change, workers_alive,
            json.dumps(info, default=str))
        return True


class RingRecoveryScheduler:
    """Schedules ``BlockQueue.recover_stalled`` after actor-process deaths.
    A producer that died between reserve and commit wedges a ring slot;
    reclamation runs after the slot's grace (``recover_stalled`` leaves a
    fresh reservation alone) but is not deferred by further deaths, and
    re-arms when a death lands inside a pass's grace window."""

    def __init__(self, grace: float = 6.0):
        self._grace = grace
        self._after: Optional[float] = None
        self._last_death = 0.0

    def on_death(self) -> None:
        self._last_death = time.time()
        if self._after is None:
            self._after = self._last_death + self._grace

    def tick(self, queue) -> int:
        """Run a due pass against ``queue``; returns the slots freed."""
        if self._after is None or time.time() < self._after:
            return 0
        freed = queue.recover_stalled()
        self._after = (self._last_death + self._grace
                       if self._last_death + self._grace > time.time()
                       else None)
        if freed:
            logging.getLogger(__name__).warning(
                "recovered %d shm ring slot(s) wedged by crashed actor(s)",
                freed)
        return freed


def supervise_workers(workers, seen_dead: set, respawn=None,
                      ring: Optional[RingRecoveryScheduler] = None,
                      health: Optional[WorkerHealth] = None) -> int:
    """One health scan over a list of threads or processes. A worker has
    failed when it is dead, or (with ``health``) alive with a stale
    heartbeat, in which case it is killed. Each newly failed worker
    notifies ``ring`` (shm slot reclamation) and feeds ``health``. With
    ``respawn``, a failed worker is replaced by ``respawn(i)`` once its
    backoff elapsed and its slot is not parked (None: retry next scan).
    ``seen_dead`` counts each corpse once. Returns the number respawned."""
    restarted = 0
    now = time.time()
    for i, w in enumerate(workers):
        if health is not None and health.is_parked(i):
            continue
        if w not in seen_dead:
            if w.is_alive():
                if health is None or not health.check_hung(i, now):
                    continue
                hung = True
                kill_worker(w)
            else:
                hung = False
            seen_dead.add(w)
            if ring is not None:
                ring.on_death()
            if health is not None:
                health.on_failure(i, now, hung=hung)
        if respawn is None:
            continue
        if health is not None and not health.respawn_due(i, now):
            continue
        new = respawn(i)
        if new is not None:
            workers[i] = new
            seen_dead.discard(w)
            if health is not None:
                health.on_spawn(i)
            restarted += 1
    return restarted


class BlockQueue:
    """The block queue of every actor mode: the native shm ring
    (``shm_spec`` given) or a ``multiprocessing`` queue for process
    actors, a ``queue.Queue`` for thread actors. The ring's build failing
    raises: ``shm_spec=None`` is the only way to the multiprocessing
    queue. close() unlinks the ring (owner side)."""

    def __init__(self, maxsize: int = 64, use_mp: bool = True,
                 ctx: Optional[mp.context.BaseContext] = None,
                 shm_spec=None):
        if use_mp and shm_spec is not None:
            from r2d2_tpu_torch.runtime.shm_feeder import ShmBlockRing
            self._q = ShmBlockRing(shm_spec, maxsize)
        elif use_mp:
            self._q = (ctx or mp.get_context("spawn")).Queue(maxsize=maxsize)
        else:
            self._q = queue_mod.Queue(maxsize=maxsize)

    def put(self, block: Block, timeout: Optional[float] = None) -> None:
        self._q.put(block, timeout=timeout)

    def put_patient(self, block: Block, should_stop, poll: float = 0.5,
                    beat: Optional[Callable[[], None]] = None) -> bool:
        return put_patient(self._q, block, should_stop, poll, beat=beat)

    def drain(self, max_items: int = 16) -> List[Block]:
        """Non-blocking pop of up to ``max_items`` blocks."""
        out = []
        for _ in range(max_items):
            try:
                out.append(self._q.get_nowait())
            except queue_mod.Empty:
                break
        return out

    def qsize(self) -> int:
        """Best-effort depth; -1 when the backend cannot say."""
        try:
            return int(self._q.qsize())
        except (NotImplementedError, OSError):
            return -1

    def get(self, timeout: Optional[float] = None) -> Block:
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        closer = getattr(self._q, "close", None)
        if closer is not None:
            closer()

    def recover_stalled(self) -> int:
        """Free ring slots wedged by a crashed producer (shm ring only)."""
        fn = getattr(self._q, "recover_stalled", None)
        return fn() if fn is not None else 0
