"""Stage timers, spans and their publication, the JAX package's
``telemetry/core.py``: one ``Telemetry`` a process. The learner process
shares one across its threads (stager, prefetch, write-back, thread
actors, the policy server, the main loop); each spawned actor process
builds its own, bound to its slot of the ``TelemetryBoard``.

``telemetry.enabled=false`` makes every entry point a no-op after one
attribute check, and ``NULL_TELEMETRY`` serves code that was given no
telemetry, so instrumented code never branches on None.

The timers read the host clock around host-side work only: a dispatch's
time is the host's launch cost, never the device's (no synchronisation is
added for them), and ``learner/device_sync`` times the one readback that
the metrics flush already does.
"""

import json
import os
import threading
from typing import Dict, Optional

import numpy as np

from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, bucket_index,
                                                summarize)
from r2d2_tpu_torch.telemetry.spans import SpanTracer

# The pipeline stages: one fixed, ordered list shared by the local timers,
# the board's layout and the record, so counts merge elementwise
# everywhere. Process actors publish the actor stages through the board;
# thread actors and the learner observe into the process's own timers.
STAGES = (
    "actor/env_step",             # env.step a tick
    "actor/forward",              # the policy's forward a tick
    "actor/block_emit",           # the whole block sink call (queue wait in)
    "actor/queue_put",            # inside put_patient (back-pressure)
    "actor/weight_sync",          # weight poll + update_params
    "actor/act_scan",             # on-device acting: one segment's launch
    "ingest/ring_get",            # feeder drain: shm ring pop / queue get
    "ingest/stage",               # stager: pop + stack + copy launch
    "ingest/commit",              # replay_add / add_many commit
    "learner/sample",             # host placement: prefetch sample + copy
    "learner/train_dispatch",     # one dispatch's launch (host side)
    "learner/device_sync",        # the metrics flush's device readback
    "learner/priority_writeback",  # host placement: priority update
    "weights/publish",            # learner -> weight service publication
    "lockstep/dispatch",          # multi-host: the iteration's all-reduce
    "lockstep/step",              # multi-host: one whole iteration
    "serve/enqueue",              # serving: request arrival -> dispatch
    "serve/batch_wait",           # serving: the oldest request's wait
    "serve/forward",              # serving: one micro-batch's forward
    "serve/reply",                # serving: state scatter + replies
    "recovery/snapshot_capture",  # a replay snapshot's cut (host side)
)
STAGE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(STAGES)}


class StageTimers:
    """A process's cumulative histogram matrix, (len(STAGES), NBUCKETS)
    int64. ``observe`` is the hot entry: one bucket index and one locked
    increment. The lock is shared by every thread that observes (stager,
    write-back, actors, server, main loop); at stage cadence it is
    uncontended in practice."""

    def __init__(self):
        self._lock = threading.Lock()
        self._m = np.zeros((len(STAGES), NBUCKETS), np.int64)
        self._prev = np.zeros_like(self._m)

    def observe(self, stage: str, seconds: float) -> None:
        row = STAGE_INDEX[stage]          # a misspelt stage raises
        col = bucket_index(seconds)
        with self._lock:
            self._m[row, col] += 1

    def cumulative(self) -> np.ndarray:
        with self._lock:
            return self._m.copy()

    def take(self) -> np.ndarray:
        """Counts observed since the previous take(): (stages, buckets)."""
        with self._lock:
            cur = self._m.copy()
        delta = cur - self._prev
        self._prev = cur
        return delta


def summarize_matrix(matrix: np.ndarray) -> Dict[str, Dict[str, float]]:
    """{stage: {count, p50_ms, p95_ms, p99_ms}} for each stage with
    observations."""
    out = {}
    for i, name in enumerate(STAGES):
        s = summarize(matrix[i])
        if s is not None:
            out[name] = s
    return out


class Telemetry:
    """One a process. A worker process passes ``board`` and ``slot``, its
    publication target; the owner side instead folds a board into
    ``interval_summary`` through ``attach_board``."""

    def __init__(self, enabled: bool = True, ring_size: int = 4096,
                 flush_interval_s: float = 5.0, spans: bool = True,
                 name: str = "main", board=None, slot: Optional[int] = None,
                 resource_gauges: bool = False):
        self.enabled = enabled
        self.name = name
        self.flush_interval_s = flush_interval_s
        self.timers = StageTimers()
        self.spans = SpanTracer(ring_size, enabled=enabled and spans)
        self._board = board
        self._slot = slot
        # worker side, with the resources plane: this process's RSS and
        # cumulative CPU into the board's gauge columns at each flush
        self._resource_gauges = resource_gauges
        self._agg_board = None
        self._spans_path: Optional[str] = None
        self._drain_stop: Optional[threading.Event] = None
        self._drain_thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, cfg, name: str = "main", board=None,
                    slot: Optional[int] = None) -> "Telemetry":
        t = cfg.telemetry
        return cls(enabled=t.enabled, ring_size=t.ring_size,
                   flush_interval_s=t.flush_interval_s, spans=t.spans,
                   name=name, board=board, slot=slot,
                   resource_gauges=t.resources_enabled)

    # -- the hot entries --

    def observe(self, stage: str, seconds: float) -> None:
        if self.enabled:
            self.timers.observe(stage, seconds)

    def record_span(self, name: str, t_start: float, t_end: float,
                    tags: Optional[dict] = None) -> None:
        self.spans.record(name, t_start, t_end, tags)

    def span(self, name: str, **tags):
        return self.spans.span(name, **tags)

    # -- publication and aggregation --

    def attach_board(self, board) -> None:
        """Owner side: fold this board's interval deltas into
        ``interval_summary`` (the learner aggregating its process actors)."""
        self._agg_board = board

    def flush(self) -> None:
        """Publish the cumulative counts to the board (worker side) and
        append the drained spans to the spans file, where either is set."""
        if not self.enabled:
            return
        if self._board is not None and self._slot is not None:
            self._board.publish(self._slot, self.timers.cumulative())
            if self._resource_gauges:
                from r2d2_tpu_torch.telemetry.resources import host_usage
                usage = host_usage()
                self._board.publish_gauges(self._slot,
                                           usage["rss_bytes"] or 0,
                                           int(usage["cpu_s"] * 1e3))
        if self._spans_path:
            events = self.spans.drain()
            if events:
                with open(self._spans_path, "a") as f:
                    for ev in events:
                        ev["pid"] = self.name
                        f.write(json.dumps(ev) + "\n")

    def interval_summary(self) -> Dict[str, Dict[str, float]]:
        """The record's ``stages`` block: local observations since the
        previous call merged with the attached board's deltas. Consumes
        the interval: once a log boundary."""
        if not self.enabled:
            return {}
        matrix = self.timers.take()
        if self._agg_board is not None:
            matrix = matrix + self._agg_board.take_deltas()
        return summarize_matrix(matrix)

    # -- the drain thread --

    def start_drain(self, spans_path: Optional[str] = None,
                    append: bool = False) -> None:
        """Every ``flush_interval_s``, flush() on a thread of its own.
        ``append=False`` truncates ``spans_path`` first (a fresh run);
        ``append=True`` keeps it (a respawned actor or a resumed run keeps
        the history a post-mortem reads)."""
        if not self.enabled or self._drain_thread is not None:
            return
        if spans_path and self.spans.enabled:
            os.makedirs(os.path.dirname(spans_path) or ".", exist_ok=True)
            if not append:
                open(spans_path, "w").close()
            self._spans_path = spans_path
        self._drain_stop = threading.Event()

        def loop():
            while not self._drain_stop.wait(self.flush_interval_s):
                try:
                    self.flush()
                except (OSError, ValueError):
                    # a board or file torn down at shutdown; close()'s
                    # final flush is best effort too
                    pass

        self._drain_thread = threading.Thread(
            target=loop, daemon=True, name=f"telemetry-drain-{self.name}")
        self._drain_thread.start()

    def close(self) -> None:
        if self._drain_stop is not None:
            self._drain_stop.set()
            self._drain_thread.join(timeout=2.0)
            self._drain_thread = None
            self._drain_stop = None
        try:
            self.flush()
        except (OSError, ValueError):
            pass


NULL_TELEMETRY = Telemetry(enabled=False, spans=False, name="null")
