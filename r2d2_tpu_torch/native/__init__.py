"""ctypes bindings of the port's host-side native code: the host
replay's sum tree (``sum_tree.cc``) and the shared-memory block ring
(``shm_ring.cc``).

Each library builds with g++ into ``build/`` on first use
(``ops/_build.py``), never on import. A build that fails raises:
``HostReplay(use_native=False)`` is the only way to the numpy twin, and
``runtime.shm_transport=false`` the only way around the ring.
"""

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sum_tree.cc"
RING_SOURCE = Path(__file__).resolve().parent / "shm_ring.cc"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.st_create.argtypes = [ctypes.c_int64]
    lib.st_create.restype = ctypes.c_void_p
    lib.st_destroy.argtypes = [ctypes.c_void_p]
    lib.st_destroy.restype = None
    lib.st_num_layers.argtypes = [ctypes.c_void_p]
    lib.st_num_layers.restype = ctypes.c_int64
    lib.st_total.argtypes = [ctypes.c_void_p]
    lib.st_total.restype = ctypes.c_double
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.st_update.argtypes = [ctypes.c_void_p, ctypes.c_double, dptr, iptr,
                              ctypes.c_int64]
    lib.st_update.restype = None
    lib.st_sample.argtypes = [ctypes.c_void_p, ctypes.c_double,
                              ctypes.c_int64, dptr, iptr, dptr]
    lib.st_sample.restype = None
    return lib


def ring_lib() -> ctypes.CDLL:
    """The shm MPMC ring's library, built on first use."""
    from r2d2_tpu_torch.ops import _build
    lib = _build.load_host(RING_SOURCE)
    if not getattr(lib, "_ring_declared", False):
        u64, vp = ctypes.c_uint64, ctypes.c_void_p
        lib.ring_required_bytes.argtypes = [u64, u64]
        lib.ring_required_bytes.restype = u64
        lib.ring_init.argtypes = [vp, u64, u64]
        lib.ring_init.restype = None
        lib.ring_size.argtypes = [vp]
        lib.ring_size.restype = u64
        lib.ring_recover_stalled.argtypes = [vp, u64]
        lib.ring_recover_stalled.restype = u64
        lib.ring_reserve_push.argtypes = [vp]
        lib.ring_reserve_push.restype = ctypes.c_int64
        lib.ring_commit_push.argtypes = [vp, ctypes.c_int64]
        lib.ring_commit_push.restype = None
        lib.ring_reserve_pop.argtypes = [vp]
        lib.ring_reserve_pop.restype = ctypes.c_int64
        lib.ring_commit_pop.argtypes = [vp, ctypes.c_int64]
        lib.ring_commit_pop.restype = None
        lib.ring_payload_offset.argtypes = [vp, ctypes.c_int64]
        lib.ring_payload_offset.restype = u64
        lib._ring_declared = True
    return lib


class NativeSumTree:
    """The numpy twin's API (``ops/sum_tree.py``) over the C++ tree. Not
    thread-safe: the host replay calls it under its lock."""

    def __init__(self, capacity: int):
        from r2d2_tpu_torch.ops import _build
        self._lib = _declare(_build.load_host(SOURCE))
        self._handle = self._lib.st_create(capacity)
        self.capacity = capacity
        self.num_layers = int(self._lib.st_num_layers(self._handle))

    def update(self, alpha: float, td_errors: np.ndarray,
               idxes: np.ndarray) -> None:
        td = np.ascontiguousarray(td_errors, np.float64)
        ix = np.ascontiguousarray(idxes, np.int64)
        if td.shape != ix.shape or td.ndim != 1:
            raise ValueError(f"td_errors {td.shape} and idxes {ix.shape} "
                             "must be equal 1-D shapes")
        if ix.size and (ix.min() < 0 or ix.max() >= self.capacity):
            raise IndexError(f"leaf index out of [0, {self.capacity})")
        self._lib.st_update(self._handle, float(alpha), td, ix, len(ix))

    def sample(self, beta: float, n: int, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` stratified draws; the jitter is ``rng.uniform(0, 1, n)``
        (the numpy twin draws ``uniform(0, interval, n)`` instead)."""
        jitter = np.ascontiguousarray(rng.uniform(0.0, 1.0, n), np.float64)
        out_idx = np.empty(n, np.int64)
        out_w = np.empty(n, np.float64)
        self._lib.st_sample(self._handle, float(beta), n, jitter, out_idx,
                            out_w)
        return out_idx, out_w

    @property
    def total(self) -> float:
        return float(self._lib.st_total(self._handle))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.st_destroy(handle)
            self._handle = None
