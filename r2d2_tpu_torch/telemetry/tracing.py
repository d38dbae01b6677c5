"""Cross-plane tracing, the JAX package's ``telemetry/tracing.py``:
per-hop wall-clock stamps on two causal paths, both behind
``telemetry.tracing_enabled`` (off by default; off, records, request
pickles, shm ring layouts and blocks are byte-identical to an untraced
run):

  * **Serving requests** — every Nth exchange
    (``telemetry.trace_sample_every``) attaches a ``trace`` dict to its
    ``Request`` objects: ``{"id", "t_submit_wall", "t_send_wall",
    "t_recv_wall"}``. The dict rides the in-process and TCP rungs as an
    attribute (absent on untraced requests) and two gated f64 fields of
    the shm request layout (serve/transport.py ``request_layout``). The
    server decomposes the round trip into route / transit / queue_wait /
    forward / reply hops (``ServeTrace``, the ``serving`` record block's
    ``trace`` sub-block).

  * **Experience blocks** — every Nth emitted block carries
    ``Block.trace_ms`` (None on untraced runs; a gated int32 field of the
    shm block ring). The learner strips it before any device commit and
    mirrors it into the ring accountant's ``slot_trace`` /
    ``slot_ingest_ms`` (and the replay snapshot). ``ExperienceTrace``
    turns looked-up stamps into the end-to-end env-step -> gradient
    latency and its hops; its consumer is the replay service's sample
    path.

Timestamps are wall-clock milliseconds mod 2^31 stored as int32 (-1 =
untraced); hop latencies difference mod 2^31, so the ~24-day wrap cannot
produce negative hops.
"""

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, bucket_index,
                                                summarize)

# Untraced sentinel for int32 stamp fields (slot mirrors, shm fields,
# Block.trace_ms when a run traces only a sampled fraction).
UNTRACED = -1
_WRAP = 2 ** 31


def tracing_on(cfg) -> bool:
    """The switch: ``telemetry.tracing_enabled`` under
    ``telemetry.enabled``."""
    return cfg.telemetry.enabled and cfg.telemetry.tracing_enabled


def now_ms() -> int:
    """Wall-clock milliseconds mod 2^31 (int32-safe; see module doc)."""
    return int(time.time() * 1e3) % _WRAP


def hop_ms(start_ms: int, end_ms: int) -> Optional[float]:
    """Latency between two mod-2^31 stamps; None when either side is
    untraced. The mod-difference keeps a wrap mid-hop non-negative."""
    if start_ms < 0 or end_ms < 0:
        return None
    return float((end_ms - start_ms) % _WRAP)


def new_request_trace(req_id: int) -> dict:
    """The serving-side trace payload attached to a sampled Request."""
    return {"id": int(req_id), "t_submit_wall": time.time()}


class _Hist:
    """One hop's thread-safe 64-bucket log histogram (ms-domain values
    observed as seconds into the shared layout, so ``summarize`` reports
    the usual p50/p95/p99 in ms)."""

    __slots__ = ("_lock", "counts")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = np.zeros(NBUCKETS, np.int64)

    def observe_ms(self, ms: float) -> None:
        i = bucket_index(ms / 1e3)
        with self._lock:
            self.counts[i] += 1

    def take(self) -> np.ndarray:
        with self._lock:
            out = self.counts.copy()
            self.counts[:] = 0
        return out


# Experience-path hops, in pipeline order. ``e2e`` is emit->train — the
# acceptance criterion's env-step->gradient latency.
EXPERIENCE_HOPS = ("emit_to_ingest", "ingest_to_sample", "sample_to_train")
# Serving-path hops: client submit->send (client-side routing/queueing),
# send->server receive (wire transit), receive->dispatch (micro-batch
# fill wait), the jitted forward, and the reply scatter+send.
SERVE_HOPS = ("route", "transit", "queue_wait", "forward", "reply")


class ExperienceTrace:
    """Learner-side aggregator for the experience lineage path. Fed at
    sample time with the (emit_ms, ingest_ms) pairs the service looked
    up for the drawn batch, and at train-consumption time with the
    sample tokens; consumed once per record by ``interval_block``."""

    def __init__(self, sample_every: int = 1):
        self.sample_every = max(int(sample_every), 1)
        self._hops = {name: _Hist() for name in EXPERIENCE_HOPS}
        self._e2e = _Hist()
        self._lock = threading.Lock()
        self._sampled = 0

    def on_sample(self, pairs: Sequence[Tuple[int, int]]
                  ) -> Optional[List[int]]:
        """Record emit->ingest and ingest->sample for every traced row
        of one sampled batch; returns the emit stamps as the token the
        train-consumption hook closes out (None when nothing was
        traced, so untraced batches cost one truthiness check)."""
        if not pairs:
            return None
        sample_ms = now_ms()
        emits: List[int] = []
        for emit_ms, ingest_ms in pairs:
            d = hop_ms(emit_ms, ingest_ms)
            if d is not None:
                self._hops["emit_to_ingest"].observe_ms(d)
            d = hop_ms(ingest_ms, sample_ms)
            if d is not None:
                self._hops["ingest_to_sample"].observe_ms(d)
            if emit_ms >= 0:
                emits.append(int(emit_ms))
        with self._lock:
            self._sampled += len(pairs)
        return [sample_ms] + emits if emits else None

    def on_train(self, token: Optional[List[int]]) -> None:
        """Close out one batch's traced rows at train consumption:
        sample->train for the batch, emit->train (e2e) per row."""
        if not token:
            return
        train_ms = now_ms()
        sample_ms, emits = token[0], token[1:]
        d = hop_ms(sample_ms, train_ms)
        if d is not None:
            self._hops["sample_to_train"].observe_ms(d)
        for emit_ms in emits:
            d = hop_ms(emit_ms, train_ms)
            if d is not None:
                self._e2e.observe_ms(d)

    def interval_block(self) -> Optional[dict]:
        """The periodic record's ``trace`` block; consumes the interval
        (the TrainMetrics provider contract). None when the interval
        traced nothing — the key is then omitted."""
        e2e = summarize(self._e2e.take())
        hops = {}
        for name in EXPERIENCE_HOPS:
            s = summarize(self._hops[name].take())
            if s is not None:
                hops[name] = s
        with self._lock:
            sampled = self._sampled
            self._sampled = 0
        if e2e is None and not hops and sampled == 0:
            return None
        block: dict = {"sampled": sampled}
        if e2e is not None:
            block["e2e_experience_latency"] = e2e
        if hops:
            block["hops"] = hops
        return block


class ServeTrace:
    """Server-side aggregator for the serving request path. Attached to
    ``ServingStats`` (``stats.trace``) when tracing is on; the serving
    record block then carries a ``trace`` sub-block — absent it, the
    block is byte-identical to the untraced schema."""

    def __init__(self):
        self._hops = {name: _Hist() for name in SERVE_HOPS}
        self._lock = threading.Lock()
        self._requests = 0

    def on_request(self, trace: dict, queue_wait_s: float) -> None:
        """Per traced request at dispatch: client-side route hop
        (submit->send), wire transit (send->receive), and the
        micro-batch fill wait (receive->dispatch, measured on the
        server's monotonic clock — exact, no cross-process skew)."""
        t_submit = trace.get("t_submit_wall")
        t_send = trace.get("t_send_wall")
        t_recv = trace.get("t_recv_wall")
        if t_submit is not None and t_send is not None:
            self._hops["route"].observe_ms(max(t_send - t_submit, 0.0) * 1e3)
        start = t_send if t_send is not None else t_submit
        if start is not None and t_recv is not None:
            self._hops["transit"].observe_ms(max(t_recv - start, 0.0) * 1e3)
        self._hops["queue_wait"].observe_ms(max(queue_wait_s, 0.0) * 1e3)
        with self._lock:
            self._requests += 1

    def on_batch(self, forward_s: float, reply_s: float) -> None:
        """Per dispatched batch containing >= 1 traced request."""
        self._hops["forward"].observe_ms(max(forward_s, 0.0) * 1e3)
        self._hops["reply"].observe_ms(max(reply_s, 0.0) * 1e3)

    def interval_block(self) -> Optional[dict]:
        hops = {}
        for name in SERVE_HOPS:
            s = summarize(self._hops[name].take())
            if s is not None:
                hops[name] = s
        with self._lock:
            requests = self._requests
            self._requests = 0
        if not hops and requests == 0:
            return None
        return {"requests": requests, "hops": hops}


def proc_header(plane: str, lease: Optional[int] = None) -> dict:
    """Process-identity header + clock anchor for a per-process metrics
    row (``cli.serve``'s records): the wall/monotonic pair lets a merge of
    several processes' streams align them without assuming a shared
    monotonic clock."""
    import os
    head = {"plane": plane, "pid": os.getpid(),
            "clock_anchor": {"wall": time.time(),
                             "mono": time.monotonic()}}
    if lease is not None:
        head["lease"] = int(lease)
    return head
