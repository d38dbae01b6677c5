"""Resource observability, the JAX package's ``telemetry/resources.py``:
the machine side of the telemetry.

  * :func:`device_memory_stats` — the one device-memory reader. On a CUDA
    device it reads the caching allocator (``torch.cuda.memory_stats``)
    and the card's free and total memory (``torch.cuda.mem_get_info``),
    which count the allocator's reserve and other processes; a failed
    read raises. On the CPU it returns ``{}``, as the JAX package's does
    on a backend that reports nothing. The device replay's capacity guard
    reads through it.
  * :class:`BufferRegistry` — owners register their device-buffer
    footprints (the train state, the replay ring, the ingest staging
    window, the acting carry, the CUDA-graph pools and serving buffers),
    so a memory report names owners instead of one total.
  * :class:`ResourceMonitor` — the periodic sampler behind
    ``telemetry.resources_enabled``: per-device memory with a host-side
    peak and the headroom, this process's RSS/CPU, process actors' RSS/CPU
    from the :class:`TelemetryBoard` gauges, the buffer table, and the
    compile sub-block. It makes the record's ``resources`` block and the
    one-shot ``resource_dump_player{p}.json`` written by the first sample
    whose headroom falls below ``telemetry.resources_headroom_warn_frac``.
  * :class:`HealthPlane` — the monitor, the compile monitor and the alert
    engine wired into one ``TrainMetrics`` (what every loop installs).

``headroom_frac`` is free / total of the card, so it is the headroom a
new allocation meets; ``bytes_in_use`` is what the allocator has handed
out (``allocated_bytes.all.current``).
"""

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# The byte counters a device entry carries (JAX's names; ``bytes_limit``
# is the card's total memory, ``largest_alloc_size`` the largest block
# the allocator has handed out)
SUMMARY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "largest_alloc_size")
# the port's additions: the allocator's reserve and the card's free bytes
EXTRA_KEYS = ("bytes_reserved", "bytes_free")


def device_memory_stats(device=None, keys=None) -> Dict[str, int]:
    """Int-valued memory counters of ``device`` (default: CUDA device 0,
    or the CPU without CUDA); ``{}`` on the CPU. ``keys`` filters to a
    subset (e.g. :data:`SUMMARY_KEYS`). On CUDA a failed read raises."""
    import torch
    if device is None:
        device = (torch.device("cuda", 0) if torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    stats = {
        "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
        "largest_alloc_size": raw.get("requested_bytes.all.peak", 0),
        "bytes_reserved": raw.get("reserved_bytes.all.current", 0),
        "bytes_free": free,
    }
    return {k: int(v) for k, v in stats.items()
            if keys is None or k in keys}


def pytree_nbytes(tree) -> int:
    """Bytes of every tensor reachable from ``tree`` (tensors, modules'
    parameters and buffers, an optimizer's state, dataclasses, dicts,
    lists and tuples), each tensor counted once: the number an owner
    registers for its buffers."""
    import torch
    seen = set()
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, torch.Tensor):
            key = (node.data_ptr(), node.nbytes, str(node.device))
            if key not in seen:
                seen.add(key)
                total += int(node.nbytes)
        elif isinstance(node, torch.nn.Module):
            stack.extend(node.parameters())
            stack.extend(node.buffers())
        elif isinstance(node, torch.optim.Optimizer):
            stack.extend(node.state.values())
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            stack.extend(getattr(node, f.name)
                         for f in dataclasses.fields(node))
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return total


def host_usage() -> Dict[str, Any]:
    """This process's host footprint: RSS bytes (``/proc/self/statm``,
    the peak from getrusage where /proc is absent), cumulative CPU
    seconds (user + system) and live threads."""
    rss = None
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        import resource
        import sys
        scale = 1 if sys.platform == "darwin" else 1024
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    t = os.times()
    return {"rss_bytes": rss, "cpu_s": t.user + t.system,
            "threads": threading.active_count()}


class BufferRegistry:
    """Named device-buffer footprints, registered by their owners.
    Re-registering a name overwrites; names are ``p{player}/component``
    (``serve/...`` for the policy server)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, int] = {}

    def register(self, name: str, nbytes: int) -> None:
        with self._lock:
            self._entries[name] = int(nbytes)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def clear_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._entries if k.startswith(prefix)]:
                del self._entries[k]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._entries)

    def total(self) -> int:
        with self._lock:
            return sum(self._entries.values())


# The process's registry, as the JAX package keeps it: owners (the
# Learner, the stager, the acting loop, the server) register at
# construction without a handle threaded through every signature; a
# ResourceMonitor reads it unless given its own.
BUFFERS = BufferRegistry()


def register_buffer(name: str, nbytes: int) -> None:
    BUFFERS.register(name, nbytes)


def clear_player_buffers(player_idx: int) -> None:
    """Drop every ``p{player}/`` registration before a rebuilt stack
    registers its own (components the new stack lacks would otherwise
    stay in its blocks)."""
    BUFFERS.clear_prefix(f"p{player_idx}/")


def _device_entry(device, stats: Dict[str, int]) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "id": int(device.index or 0),
        "platform": "gpu" if device.type == "cuda" else device.type}
    if device.type == "cuda":
        import torch
        entry["kind"] = torch.cuda.get_device_name(device)
    for k in SUMMARY_KEYS + EXTRA_KEYS:
        if k in stats:
            entry[k] = stats[k]
    return entry


class ResourceMonitor:
    """Periodic resource sampler and the record's ``resources`` block.

    ``maybe_sample`` runs on the supervision cadence (a time check);
    ``block()`` once a log interval builds the record's entry from the
    newest sample. ``devices``: the torch devices this process uses
    (default: CUDA device 0, or the CPU). ``stats_fn`` replaces the
    device reader (tests)."""

    def __init__(self, player_idx: int = 0, save_dir: str = ".",
                 interval_s: float = 10.0,
                 headroom_warn_frac: float = 0.05,
                 registry: Optional[BufferRegistry] = None,
                 board=None,
                 compile_monitor=None,
                 aot_coverage_fn: Optional[Callable[[], Optional[dict]]]
                 = None,
                 stats_fn: Optional[Callable[[Any], Dict[str, int]]] = None,
                 devices: Optional[Sequence] = None):
        import torch
        self.player_idx = player_idx
        self.save_dir = save_dir or "."
        self.interval_s = interval_s
        self.headroom_warn_frac = headroom_warn_frac
        self.registry = registry if registry is not None else BUFFERS
        self._board = board
        self.compile_monitor = compile_monitor
        self._aot_fn = aot_coverage_fn
        self._stats_fn = stats_fn or device_memory_stats
        if devices is None:
            devices = [torch.device("cuda", 0) if torch.cuda.is_available()
                       else torch.device("cpu")]
        self.devices = [torch.device(d) for d in devices]
        self.dumped = False                  # one-shot forensics latch
        self._last_sample_t: Optional[float] = None
        self._devices: List[dict] = []
        self._peak_seen: Dict[int, int] = {}   # host-side running peak
        self._host: Dict[str, Any] = {}
        self._prev_host_cpu: Optional[tuple] = None   # (t, cpu_s)
        self._host_cpu_pct: Optional[float] = None
        self._actor_prev: Optional[np.ndarray] = None  # (slots, 2) gauges
        self._actor_prev_t: Optional[float] = None
        self._actors: Optional[dict] = None

    def attach_board(self, board) -> None:
        """Process actors' board, made after the monitor: their RSS/CPU
        gauges join the block from the next sample."""
        self._board = board

    # -- sampling --

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if (self._last_sample_t is not None
                and now - self._last_sample_t < self.interval_s):
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._last_sample_t = now
        devs = []
        for d in self.devices:
            stats = self._stats_fn(d)
            entry = _device_entry(d, stats)
            in_use, limit = entry.get("bytes_in_use"), entry.get("bytes_limit")
            if in_use is not None:
                # host-side running peak: survives a reset of the
                # allocator's own peak
                prev = self._peak_seen.get(entry["id"], 0)
                self._peak_seen[entry["id"]] = max(prev, in_use)
                entry["peak_seen"] = self._peak_seen[entry["id"]]
            if limit:
                free = entry.get("bytes_free")
                if free is not None:
                    entry["headroom_frac"] = round(free / limit, 4)
                elif in_use is not None:
                    entry["headroom_frac"] = round(1.0 - in_use / limit, 4)
            devs.append(entry)
        self._devices = devs
        host = host_usage()
        if self._prev_host_cpu is not None:
            pt, pc = self._prev_host_cpu
            dt = now - pt
            if dt > 0:
                self._host_cpu_pct = round(
                    100.0 * (host["cpu_s"] - pc) / dt, 1)
        self._prev_host_cpu = (now, host["cpu_s"])
        self._host = host
        self._sample_actors(now)
        self._check_headroom()

    def _sample_actors(self, now: float) -> None:
        board = self._board
        if board is None:
            return
        g = board.read_gauges()
        if g is None:
            return
        rss = [int(x) for x in g[:, 0]]
        cpu_ms = g[:, 1].astype(np.float64)
        cpu_pct: List[Optional[float]] = [None] * len(rss)
        if self._actor_prev is not None and self._actor_prev_t is not None:
            dt = now - self._actor_prev_t
            if dt > 0:
                delta = (cpu_ms - self._actor_prev[:, 1]) / 1e3
                # a respawned slot restarts its cumulative counter: a
                # negative delta reads as the fresh value
                delta = np.where(delta < 0, cpu_ms / 1e3, delta)
                cpu_pct = [round(100.0 * float(d) / dt, 1) for d in delta]
        self._actor_prev = g.astype(np.float64)
        self._actor_prev_t = now
        self._actors = {"rss_bytes": rss, "cpu_pct": cpu_pct}

    def _check_headroom(self) -> None:
        """The first sample under the headroom floor writes one dump with
        the attribution picture (what an out-of-memory kill destroys)."""
        if self.dumped or self.headroom_warn_frac <= 0:
            return
        low = [d for d in self._devices
               if d.get("headroom_frac") is not None
               and d["headroom_frac"] < self.headroom_warn_frac]
        if low:
            self.dump(reason=f"device headroom below "
                             f"{self.headroom_warn_frac:.0%}: "
                             + ", ".join(f"dev{d['id']}="
                                         f"{d['headroom_frac']:.1%}"
                                         for d in low))

    @property
    def dump_path(self) -> str:
        return os.path.join(self.save_dir,
                            f"resource_dump_player{self.player_idx}.json")

    def dump(self, reason: str = "requested") -> Optional[str]:
        """One-shot forensics dump (idempotent, like the NaN dump)."""
        if self.dumped:
            return None
        self.dumped = True
        record = {"time": time.time(), "reason": reason,
                  **self.block(consume_compile=False)}
        try:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(self.dump_path, "w") as f:
                json.dump(record, f, indent=2)
        except OSError:
            logging.getLogger(__name__).exception(
                "failed writing resource forensics dump")
            return None
        logging.getLogger(__name__).warning(
            "player %d: resource forensics dumped to %s (%s)",
            self.player_idx, self.dump_path, reason)
        return self.dump_path

    # -- the record block --

    def block(self, consume_compile: bool = True) -> dict:
        """The periodic record's ``resources`` entry from the newest sample
        (sampling first if none was taken). The compile sub-block consumes
        the CompileMonitor's interval: call once a log boundary."""
        if self._last_sample_t is None:
            self.sample()
        headrooms = [d["headroom_frac"] for d in self._devices
                     if d.get("headroom_frac") is not None]
        out: Dict[str, Any] = {
            "devices": self._devices,
            "hbm_headroom_frac_min": min(headrooms) if headrooms else None,
            "host": {"rss_bytes": self._host.get("rss_bytes"),
                     "cpu_pct": self._host_cpu_pct,
                     "threads": self._host.get("threads")},
            "buffers": self.registry.snapshot(),
            "buffers_total": self.registry.total(),
        }
        if self._actors is not None:
            out["actor_slots"] = self._actors
        if self.compile_monitor is not None:
            comp = (self.compile_monitor.interval_summary()
                    if consume_compile
                    else self.compile_monitor.totals())
            aot = self._aot_fn() if self._aot_fn is not None else None
            if aot is not None:
                comp["aot"] = aot
            out["compile"] = comp
        return out


class HealthPlane:
    """The resource sampler, the compile monitor and the alert engine of
    one metrics stream, wired as the JAX package's loops wire them. With a
    ``TrainMetrics`` the ``resources`` block provider and the engine are
    attached to it (``set_resources`` / ``set_sentinel``); a stream of rows
    without one (a multi-host rank > 0) passes each row to
    :meth:`annotate`. Firings go to ``{save_dir}/{alerts_name}``
    (``alerts_player{p}.jsonl`` by default). Built only with
    ``telemetry.enabled`` and ``telemetry.resources_enabled``
    (``from_config`` returns None otherwise, and the records are what
    they were). The compile monitor is installed only when none is
    active in the process (the first stack owns it). ``tick()`` rides the
    loop's supervision cadence; ``close()`` releases the compile
    monitor."""

    def __init__(self, cfg, metrics=None, player_idx: int = 0, *,
                 board=None, aot_coverage_fn=None, devices=None,
                 alerts_name: Optional[str] = None):
        from r2d2_tpu_torch.telemetry.alerts import AlertEngine, default_rules
        from r2d2_tpu_torch.telemetry.compile import (CompileMonitor,
                                                      active_monitor)
        tcfg = cfg.telemetry
        save_dir = cfg.runtime.save_dir or "."
        self.compile_monitor = None
        if tcfg.compile_enabled and active_monitor() is None:
            self.compile_monitor = CompileMonitor().install()
        try:
            self.resources = ResourceMonitor(
                player_idx, save_dir, interval_s=tcfg.resources_interval_s,
                headroom_warn_frac=tcfg.resources_headroom_warn_frac,
                board=board, compile_monitor=self.compile_monitor,
                aot_coverage_fn=aot_coverage_fn, devices=devices)
            self.engine = None
            if tcfg.alerts_enabled:
                self.engine = AlertEngine(
                    default_rules(tcfg),
                    jsonl_path=os.path.join(
                        save_dir,
                        alerts_name or f"alerts_player{player_idx}.jsonl"),
                    resume=bool(cfg.runtime.resume))
            if metrics is not None:
                metrics.set_resources(self.resources.block)
                if self.engine is not None:
                    metrics.set_sentinel(self.engine)
        except BaseException:
            self.close()
            raise

    @classmethod
    def from_config(cls, cfg, metrics=None, player_idx: int = 0, **kw
                    ) -> Optional["HealthPlane"]:
        if not (cfg.telemetry.enabled and cfg.telemetry.resources_enabled):
            return None
        return cls(cfg, metrics, player_idx, **kw)

    def tick(self, training_started: bool) -> None:
        """Sample when due; once training has started, end the warm-up
        (the train step's graphs are captured by then: a later capture
        of a known name at a new shape is a retrace)."""
        self.resources.maybe_sample()
        if training_started and self.compile_monitor is not None:
            self.compile_monitor.mark_warm()

    def annotate(self, row: dict) -> dict:
        """A row without a TrainMetrics: its ``resources`` block, then
        the alert pass over the row (``alerts``), as ``TrainMetrics.log``
        adds them."""
        row["resources"] = self.resources.block()
        if self.engine is not None:
            row["alerts"] = self.engine.evaluate(row)
        return row

    def close(self) -> None:
        if self.compile_monitor is not None:
            self.compile_monitor.uninstall()
