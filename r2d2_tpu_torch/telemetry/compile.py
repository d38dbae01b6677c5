"""Compile telemetry, the JAX package's ``telemetry/compile.py`` for the
port: capture counts and wall time, and retrace detection after warm-up.

The port has no XLA. What stands for a compile is work of the same kind:
done once before steady state, slow, and a hazard when it happens again
mid-run.

  * A CUDA-graph capture: the learner's K-step dispatch
    (learner/train_step.py ``GraphedSteps``), the on-device acting segment
    (actor/anakin.py ``ActSegment``) and every serving bucket
    (serve/server.py ``_BucketGraph``). Each capture site wraps the
    capture in :func:`compile_event` with its name and a shape signature.
  * A kernel library's build and load (ops/_build.py ``load``): the nvcc
    build of a ``csrc/*.cu`` source, or a host source's g++ build, the
    first time a process loads it.

Retrace = a capture after :meth:`CompileMonitor.mark_warm` of a name seen
before with a different signature: the "same function, new shapes" event
that stalls a loop. It is counted per interval (the ``retrace_storm``
rule reads ``retraces_interval``) and the newest one is kept with its
signature. A first capture of a new name after warm-up counts as a
``late_compile``, not a retrace.

One monitor a process is active at a time (events are process-wide):
``install`` displaces the previous one, ``uninstall`` releases the slot.
"""

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

_ACTIVE: Optional["CompileMonitor"] = None
_INSTALL_LOCK = threading.RLock()


def active_monitor() -> Optional["CompileMonitor"]:
    """The process's installed monitor, or None. A loop installs one only
    when none is active, so a process running several stacks keeps the
    first's."""
    return _ACTIVE


@contextmanager
def compile_event(name: str, signature: str) -> Iterator[None]:
    """Time the enclosed capture or build and report it to the active
    monitor (nothing when none is installed). A capture that raises is
    not counted: nothing was made."""
    t0 = time.perf_counter()
    yield
    mon = _ACTIVE
    if mon is not None:
        mon.on_compile(name, signature, time.perf_counter() - t0)


class CompileMonitor:
    """Per-process capture/build tracker. Counters are cumulative; the
    record block reads per-interval deltas through
    :meth:`interval_summary`."""

    MAX_RETRACE_LOG = 32      # retained retrace events (newest kept)

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_time_s = 0.0
        self.retraces = 0
        self.late_compiles = 0
        self.warm = False
        self._signatures: Dict[str, set] = {}
        self._retrace_log: List[dict] = []
        self._prev = (0, 0.0, 0, 0)    # interval take baseline

    def on_compile(self, name: str, signature: str, seconds: float) -> None:
        """One capture or build of ``name`` at ``signature``."""
        with self._lock:
            self.compiles += 1
            self.compile_time_s += float(seconds)
            seen = self._signatures.setdefault(name, set())
            if self.warm and not seen:
                self.late_compiles += 1
            if self.warm and seen and signature not in seen:
                self.retraces += 1
                self._retrace_log.append(
                    {"fn": name, "avals": signature[:400], "t": time.time()})
                del self._retrace_log[:-self.MAX_RETRACE_LOG]
            seen.add(signature)

    # -- lifecycle --

    def install(self) -> "CompileMonitor":
        global _ACTIVE
        with _INSTALL_LOCK:
            _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def mark_warm(self) -> None:
        """Declare warm-up over: every name captured so far is baseline;
        a later capture of a known name at a new signature is a retrace.
        Idempotent: the loops call it once training has started."""
        with self._lock:
            self.warm = True

    # -- reads --

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "compiles_total": self.compiles,
                "compile_time_s_total": round(self.compile_time_s, 3),
                "retraces_total": self.retraces,
                "late_compiles": self.late_compiles,
                "warm": self.warm,
            }
            if self._retrace_log:
                out["last_retrace"] = dict(self._retrace_log[-1])
            return out

    def interval_summary(self) -> Dict[str, Any]:
        """totals() plus per-interval deltas (consumes the interval): the
        record's ``resources.compile`` block."""
        with self._lock:
            cur = (self.compiles, self.compile_time_s, self.retraces,
                   self.late_compiles)
            pc, pt, pr, pl = self._prev
            self._prev = cur
            out = {
                "compiles": cur[0] - pc,
                "compile_time_s": round(cur[1] - pt, 3),
                "retraces_interval": cur[2] - pr,
                "late_compiles_interval": cur[3] - pl,
                "compiles_total": cur[0],
                "compile_time_s_total": round(cur[1], 3),
                "retraces_total": cur[2],
                "late_compiles": cur[3],
                "warm": self.warm,
            }
            if self._retrace_log:
                out["last_retrace"] = dict(self._retrace_log[-1])
            return out

    def functions_seen(self) -> Dict[str, int]:
        """{name: distinct signatures} — the tracked universe."""
        with self._lock:
            return {k: len(v) for k, v in self._signatures.items()}


def aot_coverage(expected: List[int], compiled: List[int]) -> dict:
    """Pre-capture coverage (the serving buckets): which sizes have a
    graph made at start and which would be made lazily mid-run; a
    non-empty ``missing`` list is the regression signal."""
    expected = sorted(set(int(x) for x in expected))
    compiled = sorted(set(int(x) for x in compiled))
    return {"expected": expected, "compiled": compiled,
            "missing": [s for s in expected if s not in compiled],
            "extra": [s for s in compiled if s not in expected]}
