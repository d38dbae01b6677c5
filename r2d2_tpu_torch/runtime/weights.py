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
parameters into a flat device buffer on the step's stream; a thread of its
own copies that to pinned host memory on a stream of its own, waits for
the copy and hands the host vector to the store or the segment, so a
publication does not stall the card's queue.

At ``network.inference_dtype`` "bf16" or "int8" the payload is the
inference bundle as one flat f32 vector, [f32 weights | quantized twin |
stamp] (models/network.py ``bundle_to_flat``; int8 values are exact in
f32): the publisher's thread quantizes the snapshot on the card, on its
copy stream, so the twin is built once a publication and neither the
learner's stream nor its thread pays for it; the stamp is the
publication the bundle rides in (``publish_count + 1``).
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
    if isinstance(params, torch.Tensor):
        return params.detach().float().cpu().numpy()
    return np.asarray(params, np.float32)


def make_publish_preparer(net):
    """The publish-time quantizer: None at inference_dtype "f32" (the
    weights are the payload), else ``prepare(params, stamp)`` -> the
    bundle's flat payload (f32 tensor on params' device), built once a
    publication."""
    if net.config.inference_dtype == "f32":
        return None
    from r2d2_tpu_torch.models.network import (bundle_to_flat,
                                               make_inference_bundle)

    def prepare(params, stamp: int) -> torch.Tensor:
        with torch.no_grad():
            return bundle_to_flat(net, make_inference_bundle(net, params,
                                                             stamp))

    return prepare


def wrap_publish(publish, preparer, publish_count_fn):
    """``publish(params)`` that publishes the bundle stamped
    ``publish_count_fn() + 1``; ``publish`` itself when ``preparer`` is
    None."""
    if preparer is None:
        return publish

    def publish_bundle(params):
        publish(preparer(params, publish_count_fn() + 1))

    return publish_bundle


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
    number of weights. ``untrack=False``: a reader in the segment owner's
    own process (the policy server's), whose registration is the
    owner's."""

    def __init__(self, name: str, template, untrack: bool = True):
        self.num_weights = (int(template) if isinstance(template, int)
                            else flat_parameters(template).shape[0])
        self.shm = shared_memory.SharedMemory(name=name)
        if untrack:
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
    def __init__(self, params: List[torch.Tensor], device: torch.device,
                 total: int):
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
    stream, then an event; the publisher's thread has a copy stream of its
    own wait on that event and move the slot to pinned host memory, waits
    for the copy and calls ``publish`` (the store's or the segment's) with
    the host vector. On the CPU the snapshot is the host copy itself. With
    ``net`` at a quantized inference dtype the slot holds the bundle: the
    publisher's thread builds the twin from the snapshot (on the copy
    stream on CUDA, before the copy; its launches cost the learner's
    thread nothing) and stamps it ``publish_count() + 1`` before the
    write. Counts: ``requested`` and
    ``publishes`` (written out), and the host milliseconds the writer
    thread spent (``write_ms``)."""

    SLOTS = 3

    def __init__(self, publish, module: torch.nn.Module, net=None,
                 publish_count=None):
        self._publish = publish
        params = list(module.parameters())
        self.device = params[0].device
        self._net = (net if net is not None
                     and net.config.inference_dtype != "f32" else None)
        self._publish_count = publish_count
        self._num_params = sum(p.numel() for p in params)
        total = self._num_params
        if self._net is not None:
            from r2d2_tpu_torch.models.network import bundle_size
            total = bundle_size(self._net)
            if publish_count is None:
                raise ValueError("a quantized payload needs publish_count "
                                 "for its stamp")
        self._slots = [_Slot(params, self.device, total)
                       for _ in range(self.SLOTS)]
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
        torch._foreach_copy_(slot.views,
                             [p.detach() for p in module.parameters()])
        snapped = None
        if self._stream is not None:
            snapped = torch.cuda.Event()
            snapped.record()
        self._q.put((slot, snapped))
        self.requested += 1

    def _quantize(self, slot: _Slot) -> None:
        """The bundle's twin section from the slot's snapshot (no-op at
        "f32")."""
        if self._net is None:
            return
        from r2d2_tpu_torch.models.network import (named_params,
                                                   quantize_params,
                                                   twin_to_flat)
        n = self._num_params
        with torch.no_grad():
            quant = quantize_params(named_params(self._net, slot.flat[:n]),
                                    self._net.config.inference_dtype)
            slot.flat[n:-1].copy_(twin_to_flat(self._net, quant))

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                slot, snapped = item
                if snapped is not None:
                    # behind the snapshot, on the copy stream: the twin
                    # and the copy to pinned memory, launched from this
                    # thread, not the learner's
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(snapped)
                        self._quantize(slot)
                        slot.host.copy_(slot.flat, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    done.synchronize()
                else:
                    self._quantize(slot)
                if self._net is not None:
                    slot.host[-1] = float(self._publish_count() + 1)
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
