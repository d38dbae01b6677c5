"""The span tracer, the JAX package's ``telemetry/spans.py``: every
pipeline stage worth seeing on a timeline records one ``(name, t_start,
t_end, tags)`` event, in wall-clock unix seconds.

The hot path takes no lock: each thread appends to its own bounded
``deque`` (``append`` is atomic under the GIL; ``maxlen`` makes it a
ring, so when a drain falls behind the oldest events fall off, counted in
``dropped``). The Telemetry drain thread (core.py) pops the events
periodically and appends them to a JSONL file; ``chrome_trace_events``
turns them into Chrome-trace events that Perfetto shows beside a
``torch.profiler`` capture.

Spans are for block-level events (emits, drains, dispatches: a few to a
few hundred a second), not per env step: per-step timing goes to the
histograms (core.py), one integer increment each.
"""

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional


class SpanTracer:
    def __init__(self, ring_size: int = 4096, enabled: bool = True):
        self.ring_size = ring_size
        self.enabled = enabled
        self._local = threading.local()
        self._rings: List = []          # (thread, deque)
        self._register_lock = threading.Lock()   # registration only
        self.dropped = 0                # approximate: a racy increment

    def _ring(self):
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = deque(maxlen=self.ring_size)
            self._local.ring = ring
            with self._register_lock:
                self._rings.append((threading.current_thread(), ring))
        return ring

    def record(self, name: str, t_start: float, t_end: float,
               tags: Optional[Dict] = None) -> None:
        """Record one finished span."""
        if not self.enabled:
            return
        ring = self._ring()
        if len(ring) >= self.ring_size:
            self.dropped += 1
        ring.append((name, t_start, t_end, tags))

    @contextmanager
    def span(self, name: str, **tags):
        """Time a block as one span; no clock read when disabled."""
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.record(name, t0, time.time(), tags or None)

    def drain(self) -> List[dict]:
        """Pop every buffered event of every thread's ring, sorted by
        start. Writers go on appending meanwhile: ``popleft`` and
        ``append`` never touch the same end. The drained ring of a dead
        thread is forgotten, so respawned workers do not pile rings up."""
        out = []
        with self._register_lock:
            rings = list(self._rings)
        dead = []
        for thread, ring in rings:
            for _ in range(len(ring)):
                try:
                    name, t0, t1, tags = ring.popleft()
                except IndexError:
                    break
                ev = {"name": name, "ts": t0, "dur": t1 - t0,
                      "tid": thread.name}
                if tags:
                    ev["tags"] = tags
                out.append(ev)
            if not thread.is_alive() and not ring:
                dead.append((thread, ring))
        if dead:
            with self._register_lock:
                for entry in dead:
                    try:
                        self._rings.remove(entry)
                    except ValueError:
                        pass
        out.sort(key=lambda e: e["ts"])
        return out


def chrome_trace_events(events: List[dict], pid: str,
                        pid_index: int = 0) -> List[dict]:
    """Drained span events (the JSONL schema above) as Chrome-trace 'X'
    events, plus the process and thread name metadata Perfetto labels its
    tracks with; times in microseconds."""
    tids: Dict[str, int] = {}
    out = [{"ph": "M", "name": "process_name", "pid": pid_index,
            "args": {"name": pid}}]
    for ev in events:
        tid = tids.setdefault(ev.get("tid", "main"), len(tids))
        out.append({"ph": "X", "name": ev["name"], "pid": pid_index,
                    "tid": tid, "ts": round(ev["ts"] * 1e6, 1),
                    "dur": round(ev["dur"] * 1e6, 1),
                    "args": ev.get("tags") or {}})
    for name, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": pid_index,
                    "tid": tid, "args": {"name": name}})
    return out
