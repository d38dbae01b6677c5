"""The shared-memory telemetry board, the JAX package's
``telemetry/board.py``: how process actors' stage timers reach the
learner's record without riding the experience queue.

Each actor slot owns one row of a ``multiprocessing.shared_memory`` table
of cumulative histogram counts, (n_slots, n_stages * NBUCKETS) int64, and
publishes by overwriting its row on the telemetry flush cadence (the drain
thread of core.py; one vectorized store, off the acting loop). The learner
reads the whole table once a log interval and differences it against the
previous read, so each interval's percentiles cover that interval's
fleet-wide observations. The handle pickles by name into spawned children
(the ``HeartbeatBoard`` lifecycle, runtime/feeder.py): the creating
process owns the segment and unlinks it on close.

A read racing a publish may see a row half written: counts are cumulative
and monotonic a slot, so the torn buckets show in the next interval's
delta instead of being lost. A respawned actor starts its row from zero
(``reset_slot``); the reader takes a decrease anywhere in a row as such a
reset and counts the fresh row whole.

Two gauge columns a slot follow the table, [rss_bytes, cpu_ms], in the
JAX package's layout; the port's actors do not publish them yet (the
resource sampler is not ported), so they read zero.
"""

from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from r2d2_tpu_torch.telemetry.histogram import NBUCKETS

N_GAUGES = 2


class TelemetryBoard:
    def __init__(self, n_slots: int, n_stages: Optional[int] = None,
                 _attach_name: Optional[str] = None):
        if n_stages is None:
            from r2d2_tpu_torch.telemetry.core import STAGES
            n_stages = len(STAGES)
        self.n_slots = n_slots
        self.n_stages = n_stages
        self._owner = _attach_name is None
        self._shm = None
        self._arr = None
        self._gauges = None
        self._final = None     # the table at close, for post-mortem reads
        self._prev = None      # owner side: the previous read (take_deltas)
        if self._owner:
            self._shm = shared_memory.SharedMemory(
                create=True,
                size=n_slots * (n_stages * NBUCKETS + N_GAUGES) * 8)
            self._name = self._shm.name     # still named once closed
            self._bind()
            self._arr[:] = 0
            self._gauges[:] = 0
        else:
            self._name = _attach_name

    def __getstate__(self):
        return {"n_slots": self.n_slots, "n_stages": self.n_stages,
                "name": self.name}

    def __setstate__(self, state):
        self.__init__(state["n_slots"], state["n_stages"],
                      _attach_name=state["name"])

    @property
    def name(self) -> str:
        return self._name

    def _bind(self) -> None:
        self._arr = np.ndarray((self.n_slots, self.n_stages * NBUCKETS),
                               np.int64, self._shm.buf)
        self._gauges = np.ndarray(
            (self.n_slots, N_GAUGES), np.int64, self._shm.buf,
            offset=self.n_slots * self.n_stages * NBUCKETS * 8)

    def _ensure(self) -> np.ndarray:
        if self._shm is None:
            if self._final is not None:
                return self._final
            from r2d2_tpu_torch.runtime.weights import untrack_attached_shm
            self._shm = shared_memory.SharedMemory(name=self._name)
            untrack_attached_shm(self._shm)
            self._bind()
        return self._arr

    def publish(self, slot: int, counts: np.ndarray) -> None:
        """Overwrite ``slot``'s row with the worker's cumulative
        (n_stages, NBUCKETS) counts: one vectorized store."""
        self._ensure()[slot] = counts.reshape(-1)

    def read(self) -> np.ndarray:
        """The whole table, (n_slots, n_stages, NBUCKETS)."""
        return (self._ensure().copy()
                .reshape(self.n_slots, self.n_stages, NBUCKETS))

    def publish_gauges(self, slot: int, rss_bytes: int, cpu_ms: int) -> None:
        self._ensure()
        self._gauges[slot, 0] = int(rss_bytes)
        self._gauges[slot, 1] = int(cpu_ms)

    def read_gauges(self) -> Optional[np.ndarray]:
        """The gauge table, (n_slots, N_GAUGES); None once closed."""
        if self._shm is None and self._final is not None:
            return None
        self._ensure()
        return self._gauges.copy()

    def reset_slot(self, slot: int) -> None:
        """A fresh incarnation (an actor's respawn) starts from zero."""
        self._ensure()[slot] = 0
        self._gauges[slot] = 0

    def take_deltas(self) -> np.ndarray:
        """Owner side: the counts observed fleet-wide since the previous
        call, summed over the slots, (n_stages, NBUCKETS). A slot whose
        counts decreased anywhere was reset: its row counts whole."""
        cur = self.read()
        if self._prev is None:
            delta = cur
        else:
            delta = cur - self._prev
            reset = (delta < 0).any(axis=(1, 2))
            delta[reset] = cur[reset]
        self._prev = cur
        return delta.sum(axis=0)

    def close(self) -> None:
        if self._shm is None:
            return
        self._final = self._arr.copy()
        self._arr = None
        self._gauges = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        self._shm = None
