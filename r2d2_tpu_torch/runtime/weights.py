"""Weight service: learner -> actors parameter distribution, the JAX
package's ``runtime/weights.py`` for modules.

The payload is one f32 vector: the parameters in ``module.parameters()``
order. ``WeightPublisher`` writes it into a POSIX shared-memory segment
behind a seqlock header, one writer (the learner) and many readers (actor
processes); ``InProcWeightStore`` is the thread-mode twin.

Layout: [u64 version][u64 crc32][f32 payload...]. The version is odd while
a write is in flight; a reader accepts a copy only if it saw the same even
version before and after it.

* x86 (TSO): stores retire in program order and loads are not reordered
  with other loads, so that check alone rules out a torn copy. The crc
  word is written once as 0.
* weakly ordered hosts (ARM, POWER): CPython emits no fences, so every
  publish also stores ``crc32(payload) ^ version`` and every read checks
  the copy against it at the version it saw: a torn copy and a stale one
  (the new version visible before the new payload) both fail and are
  retried. The choice is made from ``platform.machine()`` at import, the
  same in writer and readers.

``SnapshotPublisher`` is the learner's publish hook: it snapshots the
parameters into a flat device buffer on the step's stream, copies that to
pinned host memory on a stream of its own, and a thread of its own waits
for the copy and hands the host vector to the store or the segment, so a
publication does not stall the card's queue.
"""

import multiprocessing
import platform
import queue
import threading
import time
import zlib
from multiprocessing import shared_memory
from typing import List, Optional

import numpy as np
import torch

_TSO_MACHINES = ("x86_64", "amd64", "i386", "i686", "x86")
_NEEDS_CHECKSUM = platform.machine().lower() not in _TSO_MACHINES
_HEADER_BYTES = 16                      # u64 version + u64 crc32
PUBLISH_WAIT_S = 60.0   # the longest a publish waits for a free slot


def untrack_attached_shm(shm: shared_memory.SharedMemory) -> None:
    """De-register an attached segment from this process's resource
    tracker: on Python < 3.13 attaching registers it too, and a tracker of
    the attaching process's own would unlink the owner's live segment when
    that process exits. A multiprocessing child shares its parent's
    tracker, where the registration is the owner's own: left alone there.
    Shared by the weight subscriber, the heartbeat board and the shm block
    ring."""
    if multiprocessing.parent_process() is not None:
        return
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def flat_parameters(params) -> np.ndarray:
    """A module's parameters (a new array), or a flat vector, as one f32
    host vector."""
    if isinstance(params, torch.nn.Module):
        return torch.cat([p.detach().reshape(-1).float().cpu()
                          for p in params.parameters()]).numpy()
    return np.asarray(params, np.float32)


def load_parameters(module: torch.nn.Module, params, copy: bool = True
                    ) -> None:
    """Load ``params`` (a module, or a flat f32 vector in
    ``parameters()`` order) into ``module``. ``copy=False`` makes the
    module's parameters views of a given vector instead of copying it."""
    targets = list(module.parameters())
    with torch.no_grad():
        if isinstance(params, torch.nn.Module):
            sources = list(params.parameters())
            if len(sources) != len(targets):
                raise ValueError("the two modules have different parameters")
            for dst, src in zip(targets, sources):
                dst.copy_(src.detach())
            return
        flat = torch.as_tensor(params)
        total = sum(p.numel() for p in targets)
        if flat.dtype != torch.float32 or tuple(flat.shape) != (total,):
            raise ValueError(f"expected a ({total},) float32 vector; got "
                             f"{tuple(flat.shape)} {flat.dtype}")
        if copy:
            torch.nn.utils.vector_to_parameters(flat.clone(), targets)
        else:
            torch.nn.utils.vector_to_parameters(flat, targets)


class WeightPublisher:
    """Learner-side writer. Owns (creates and unlinks) the segment."""

    def __init__(self, params, name: Optional[str] = None):
        flat = flat_parameters(params)
        self.num_weights = flat.shape[0]
        self.shm = shared_memory.SharedMemory(
            create=True, size=_HEADER_BYTES + 4 * self.num_weights, name=name)
        self.name = self.shm.name
        self._version = np.ndarray((1,), np.uint64, self.shm.buf, 0)
        self._crc = np.ndarray((1,), np.uint64, self.shm.buf, 8)
        self._payload = np.ndarray((self.num_weights,), np.float32,
                                   self.shm.buf, _HEADER_BYTES)
        self._version[0] = 0
        self._crc[0] = 0
        self.publish(flat)

    def publish(self, params) -> None:
        flat = flat_parameters(params)
        v = int(self._version[0])
        self._version[0] = v + 1       # odd: write in flight
        if _NEEDS_CHECKSUM:
            # the final even version is bound into the crc
            self._crc[0] = zlib.crc32(flat) ^ ((v + 2) & 0xFFFFFFFF)
        self._payload[:] = flat
        self._version[0] = v + 2       # even: stable

    @property
    def publish_count(self) -> int:
        """Publications so far (two seqlock versions each): the clock of
        the blocks' weight_version stamps."""
        return int(self._version[0]) // 2

    def close(self) -> None:
        self.shm.close()
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class WeightSubscriber:
    """Actor-side reader. ``template``: a module, a flat vector, or the
    number of weights."""

    def __init__(self, name: str, template):
        self.num_weights = (int(template) if isinstance(template, int)
                            else flat_parameters(template).shape[0])
        self.shm = shared_memory.SharedMemory(name=name)
        untrack_attached_shm(self.shm)
        self._version = np.ndarray((1,), np.uint64, self.shm.buf, 0)
        self._crc = np.ndarray((1,), np.uint64, self.shm.buf, 8)
        self._payload = np.ndarray((self.num_weights,), np.float32,
                                   self.shm.buf, _HEADER_BYTES)
        self.last_version = 0

    def poll(self) -> Optional[np.ndarray]:
        """A fresh copy of the published vector, or None if unchanged or
        a write is in flight."""
        v1 = int(self._version[0])
        if v1 == self.last_version or v1 % 2 == 1:
            return None
        for _ in range(64):             # seqlock retry loop
            buf = self._payload.copy()
            crc = int(self._crc[0])
            v2 = int(self._version[0])
            if v1 == v2 and v2 % 2 == 0 and (
                    not _NEEDS_CHECKSUM
                    or (zlib.crc32(buf) ^ (v2 & 0xFFFFFFFF)) == crc):
                self.last_version = v2
                return buf
            v1 = int(self._version[0])
        return None

    @property
    def publish_count(self) -> int:
        """The publication this reader last adopted (0 = none yet)."""
        return self.last_version // 2

    def close(self) -> None:
        self.shm.close()


class InProcWeightStore:
    """Thread-mode store: one process, no segment; the same poll()
    contract. Holds a copy of each published vector; readers copy it into
    their own modules."""

    def __init__(self, params):
        self._lock = threading.Lock()
        self._params = np.array(flat_parameters(params), copy=True)
        self._version = 1
        self._reader_versions = {}

    def publish(self, params) -> None:
        flat = np.array(flat_parameters(params), copy=True)
        with self._lock:
            self._params = flat
            self._version += 1

    @property
    def publish_count(self) -> int:
        """Publications so far; the construction counts as the first."""
        with self._lock:
            return self._version

    def reader_version(self, reader_id=0) -> int:
        """The publication reader ``reader_id`` last adopted (1 before its
        first poll: thread actors start from the construction's)."""
        with self._lock:
            return self._reader_versions.get(reader_id, 1)

    def poll(self, reader_id=0) -> Optional[np.ndarray]:
        with self._lock:
            if self._reader_versions.get(reader_id) == self._version:
                return None
            self._reader_versions[reader_id] = self._version
            return self._params

    def current(self, reader_id=None) -> np.ndarray:
        """The current vector without the poll's gate, what a (re)spawned
        thread actor starts from; with ``reader_id``, marked adopted."""
        with self._lock:
            if reader_id is not None:
                self._reader_versions[reader_id] = self._version
            return self._params


class _Slot:
    def __init__(self, params: List[torch.Tensor], device: torch.device):
        total = sum(p.numel() for p in params)
        cuda = device.type == "cuda"
        self.host = torch.empty(total, dtype=torch.float32, pin_memory=cuda)
        # the device snapshot (CUDA) or the host vector itself (CPU)
        self.flat = (torch.empty(total, dtype=torch.float32, device=device)
                     if cuda else self.host)
        self.views, offset = [], 0
        for p in params:
            self.views.append(self.flat[offset:offset + p.numel()]
                              .view_as(p))
            offset += p.numel()
        self.free = threading.Event()
        self.free.set()


class SnapshotPublisher:
    """``publish(module)`` hook that costs the step's stream one
    device-to-device copy. Three slots: a slot is snapshotted into again
    only once the publisher thread has written it out. (With two, a
    learner that runs two dispatches ahead of the card and publishes once
    a dispatch waits for the write of the publication before last, which
    starts only when the card reaches it.) On CUDA the snapshot is
    a multi-tensor copy into the slot's flat device buffer on the current
    stream; a copy stream of its own moves it to pinned host memory behind
    an event, which the thread waits on before calling ``publish`` (the
    store's or the segment's) with the host vector. On the CPU the
    snapshot is the host copy itself. Counts: ``requested`` and
    ``publishes`` (written out), and the host milliseconds the writer
    thread spent (``write_ms``)."""

    SLOTS = 3

    def __init__(self, publish, module: torch.nn.Module):
        self._publish = publish
        params = list(module.parameters())
        self.device = params[0].device
        self._slots = [_Slot(params, self.device) for _ in range(self.SLOTS)]
        self._next = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self.requested = 0
        self.publishes = 0
        self.write_ms = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="weight-publisher")
        self._thread.start()

    def _wait(self, event: threading.Event) -> None:
        deadline = time.monotonic() + PUBLISH_WAIT_S
        while not event.wait(0.5):
            if self._error is not None:
                raise RuntimeError("the weight publisher thread died"
                                   ) from self._error
            if not self._thread.is_alive() or time.monotonic() > deadline:
                raise RuntimeError("the weight publisher thread stalled")

    def __call__(self, module: torch.nn.Module) -> None:
        if self._error is not None:
            raise RuntimeError("the weight publisher thread died"
                               ) from self._error
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.SLOTS
        self._wait(slot.free)
        slot.free.clear()
        params = [p.detach() for p in module.parameters()]
        done = None
        if self._stream is not None:
            torch._foreach_copy_(slot.views, params)
            snapped = torch.cuda.Event()
            snapped.record()
            self._stream.wait_event(snapped)
            with torch.cuda.stream(self._stream):
                slot.host.copy_(slot.flat, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
        else:
            torch._foreach_copy_(slot.views, params)
        self._q.put((slot, done))
        self.requested += 1

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                slot, done = item
                if done is not None:
                    done.synchronize()
                t0 = time.perf_counter()
                self._publish(slot.host.numpy())
                self.write_ms += (time.perf_counter() - t0) * 1e3
                self.publishes += 1
                slot.free.set()
        except BaseException as e:      # raised by the next publish
            self._error = e

    def flush(self) -> None:
        """Wait until every requested publication is written out."""
        for slot in self._slots:
            self._wait(slot.free)

    def close(self) -> None:
        """Write out what is queued and stop the thread (bounded)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=PUBLISH_WAIT_S)
