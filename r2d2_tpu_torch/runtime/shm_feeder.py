"""Native shared-memory experience transport, the JAX package's
``runtime/shm_feeder.py``: ``ShmBlockRing`` is a lock-free MPMC ring
(``native/shm_ring.cc``, Vyukov per-slot sequences) over one
``multiprocessing.shared_memory`` segment. A fixed-shape Block crosses the
process boundary with one memcpy per side (fields stream straight into
the reserved slot), where a ``multiprocessing.Queue`` pickles the
multi-MB record through a pipe.

It has the ``mp.Queue`` surface the feeder uses (put/get/get_nowait
raising ``queue.Full``/``queue.Empty``), so ``put_patient`` and
``BlockQueue`` work unchanged. Picklable: spawned actor processes receive
the handle and attach to the segment by name on first use.
"""

import ctypes
import queue as queue_mod
import time
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.replay.structs import Block, ReplaySpec, empty_block_np


def block_layout(spec: ReplaySpec) -> List[Tuple[str, tuple, np.dtype]]:
    """(field, shape, dtype) in serialization order, from the one record
    definition (empty_block_np)."""
    return [(k, v.shape, v.dtype) for k, v in empty_block_np(spec).items()]


@dataclass
class _Field:
    name: str
    shape: tuple
    dtype: np.dtype
    offset: int
    nbytes: int


class ShmBlockRing:
    """Bounded MPMC block queue in shared memory. The creating process
    owns the segment (``close()`` unlinks it); unpickled copies attach on
    first use and only close their mapping."""

    def __init__(self, spec: ReplaySpec, maxsize: int = 64,
                 _attach_name: Optional[str] = None):
        self.spec = spec
        self.capacity = maxsize
        self._fields: List[_Field] = []
        off = 0
        for name, shape, dtype in block_layout(spec):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self._fields.append(_Field(name, shape, dtype, off, nbytes))
            off += nbytes
        self.slot_bytes = off
        self._owner = _attach_name is None
        self._shm = None
        self._base = 0
        if self._owner:
            from r2d2_tpu_torch.native import ring_lib
            lib = ring_lib()
            size = int(lib.ring_required_bytes(self.capacity,
                                               self.slot_bytes))
            self._shm = shared_memory.SharedMemory(create=True, size=size)
            self._bind()
            lib.ring_init(self._base, self.capacity, self.slot_bytes)
        else:
            self._name = _attach_name

    def __getstate__(self):
        return {"spec": self.spec, "capacity": self.capacity,
                "name": self.name}

    def __setstate__(self, state):
        self.__init__(state["spec"], state["capacity"],
                      _attach_name=state["name"])

    @property
    def name(self) -> str:
        return self._shm.name if self._shm is not None else self._name

    def _bind(self) -> None:
        # the export pins the buffer's address; dropped before close()
        self._cbuf = ctypes.c_char.from_buffer(self._shm.buf)
        self._base = ctypes.addressof(self._cbuf)

    def _ensure(self):
        if self._shm is None:
            from r2d2_tpu_torch.runtime.weights import untrack_attached_shm
            self._shm = shared_memory.SharedMemory(name=self._name)
            untrack_attached_shm(self._shm)
            self._bind()
        from r2d2_tpu_torch.native import ring_lib
        return ring_lib()

    def _slot_view(self, lib, pos: int) -> np.ndarray:
        off = int(lib.ring_payload_offset(self._base, pos))
        return np.ndarray((self.slot_bytes,), np.uint8, self._shm.buf, off)

    def put(self, block: Block, timeout: Optional[float] = None) -> None:
        lib = self._ensure()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pos = int(lib.ring_reserve_push(self._base))
            if pos >= 0:
                break
            if deadline is None or time.monotonic() >= deadline:
                raise queue_mod.Full
            time.sleep(0.001)
        slot = self._slot_view(lib, pos)
        for f in self._fields:
            src = np.ascontiguousarray(getattr(block, f.name), f.dtype)
            slot[f.offset:f.offset + f.nbytes] = src.view(np.uint8).reshape(-1)
        lib.ring_commit_push(self._base, pos)

    def get_nowait(self) -> Block:
        lib = self._ensure()
        pos = int(lib.ring_reserve_pop(self._base))
        if pos < 0:
            raise queue_mod.Empty
        slot = self._slot_view(lib, pos)
        out = {}
        for f in self._fields:
            raw = slot[f.offset:f.offset + f.nbytes]
            out[f.name] = raw.view(f.dtype).reshape(f.shape).copy()
        lib.ring_commit_pop(self._base, pos)
        return Block(**out)

    def get(self, timeout: Optional[float] = None) -> Block:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get_nowait()
            except queue_mod.Empty:
                if deadline is None or time.monotonic() >= deadline:
                    raise
                time.sleep(0.001)

    def qsize(self) -> int:
        return int(self._ensure().ring_size(self._base))

    def recover_stalled(self, stale_ms: int = 5000) -> int:
        """Free head slots wedged by a producer that died between reserve
        and commit (shm_ring.cc). Call after reaping a dead actor process:
        the grace protects a live writer, whose memcpy takes milliseconds.
        Returns the slots freed."""
        lib = self._ensure()
        return int(lib.ring_recover_stalled(self._base, stale_ms))

    def close(self) -> None:
        if self._shm is None:
            return
        self._base = 0
        self._cbuf = None   # release the export before close()
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        self._shm = None
