"""Profile the learner step, the JAX package's ``tools/profile_step.py``
over ``torch.profiler``: a trace of N learner steps over a replay of
synthetic blocks filling the configured ring (SYNTHETIC_BLOCKS distinct
blocks written over and over: the ring's size, its sum tree's depth and
the gathers' spread are bench's, without generating every block; no
actors, no envs: the learner alone, as ``tools/bench.py`` times it), then the device time attributed
per CUDA kernel, ms a step and launches a step, with the port's hand
kernels named.

    python -m r2d2_tpu_torch.cli.profile --steps 20 --out DIR
    python -m r2d2_tpu_torch.cli.profile --summarize DIR

A dispatch is ``runtime.steps_per_dispatch`` steps (one CUDA graph of K
steps on the card); the profiler shows a graph replay's kernels one by
one. The trace (``*.pt.trace.json``, Chrome-trace format) goes to DIR with
``profile_meta.json``: the steps traced, K, the batch, and the kernel
wrappers' launches in the traced window (``ops/launch_counts.py``), which
the trace's kernel counts must equal. On the CPU the trace holds only
host operators; the summary reports the planes the trace has.
"""

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PlaneSummary = List[Tuple[str, float, int]]   # (name, total_us, count)

# the device's kernel names of the port's hand kernels -> the wrapper
# each stands for (csrc/*.cu)
HAND_KERNELS = {
    "gather_windows": re.compile(r"gather_windows_\w+_kernel"),
    "stack_frames": re.compile(r"stack_frames_\w*kernel"),
    "lstm_fwd": re.compile(r"lstm_fwd_kernel<[^>]*true>"),
    "lstm_fwd_lean": re.compile(r"lstm_fwd_kernel<[^>]*false>"),
    "lstm_bwd": re.compile(r"lstm_bwd_kernel"),
    "int8_linear": re.compile(r"int8_linear_kernel"),
}
# trace categories by plane
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PLANES = {"kernel": "device", "gpu_memcpy": "device",
          "gpu_memset": "device", "cpu_op": "host operators",
          "cuda_runtime": "cuda runtime", "cuda_driver": "cuda runtime"}
META = "profile_meta.json"
SYNTHETIC_BLOCKS = 16          # distinct blocks, repeated to fill the ring


def capture_step_trace(cfg, steps: int, out_dir: str, warmup: int = 3,
                       device=None, eager: bool = False) -> str:
    """Run ``steps`` learner steps (whole dispatches: at least ``steps``)
    of ``cfg`` on ``device`` (CUDA by default) under a profiler capture
    into ``out_dir``, after ``warmup`` dispatches outside it (on the card:
    the eager warm-up, the capture, a replay). ``eager``: the eager single
    step of the same factory instead, one step a dispatch (its kernels
    launch inside the component scopes: telemetry/traceparse.py's map of a
    graph replay's kernels). Returns ``out_dir``."""
    import torch
    from r2d2_tpu_torch.ops.launch_counts import launch_counts
    from r2d2_tpu_torch.telemetry.profiler import trace
    from r2d2_tpu_torch.tools import bench
    from r2d2_tpu_torch.utils.device import (configure_numerics,
                                             resolve_device)
    configure_numerics()
    device = resolve_device(device)
    distinct = bench.synthetic_blocks(cfg, min(cfg.num_blocks,
                                               SYNTHETIC_BLOCKS))
    blocks = [distinct[i % len(distinct)] for i in range(cfg.num_blocks)]
    spec, rs = bench.filled_replay(cfg, device, blocks)
    k = 1 if eager else cfg.runtime.resolved_steps_per_dispatch(device)
    ts, step = bench.build_learner_step(cfg, device, spec, k, eager=eager)
    cuda = device.type == "cuda"

    def dispatch():
        return step(ts, rs)[2]["loss"]

    for _ in range(warmup):
        dispatch()
    if cuda:
        torch.cuda.synchronize(device)
    dispatches = -(-max(1, steps) // k)
    os.makedirs(out_dir, exist_ok=True)
    for stale in _traces(out_dir):
        os.remove(stale)
    before = launch_counts()
    with trace(out_dir):
        for _ in range(dispatches):
            loss = dispatch()
        if cuda:
            # inside the capture: the window's last kernels must be in it
            torch.cuda.synchronize(device)
        else:
            loss.sum().item()
    after = launch_counts()
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump({"steps": dispatches * k, "steps_per_dispatch": k,
                   "batch_size": spec.batch_size, "device": str(device),
                   "launches": {name: after[name] - before[name]
                                for name in after}}, f)
    return out_dir


def read_meta(trace_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(trace_dir, META)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def traced_step_count(trace_dir: str) -> Optional[int]:
    """The steps ``capture_step_trace`` recorded, or None for a trace
    captured elsewhere."""
    meta = read_meta(trace_dir)
    try:
        return int(meta["steps"])
    except (TypeError, KeyError, ValueError):
        return None


def _traces(trace_dir: str) -> List[str]:
    return [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
            for p in glob.glob(os.path.join(trace_dir, "**", pattern),
                               recursive=True)]


def load_trace_events(trace_dir: str) -> list:
    """The events of the newest trace under ``trace_dir``."""
    paths = sorted(_traces(trace_dir), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(
            f"no *.pt.trace.json under {trace_dir!r}: did the capture run?")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize_trace(trace_dir: str, top: int = 25
                    ) -> Dict[str, PlaneSummary]:
    """The newest trace under ``trace_dir``, by plane (summarize_events)."""
    return summarize_events(load_trace_events(trace_dir), top)


def summarize_events(events: list, top: int = 25
                     ) -> Dict[str, PlaneSummary]:
    """A trace's events per plane (device kernels and copies, host
    operators, CUDA runtime calls): each event name's total duration and
    count, the ``top`` largest. Host operators nest, so their totals
    overlap; device events of one stream do not."""
    totals: Dict[str, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(lambda: [0.0, 0]))
    for e in events:
        if e.get("ph") != "X":
            continue
        plane = PLANES.get(e.get("cat"))
        if plane is None:
            continue
        t = totals[plane][e["name"]]
        t[0] += float(e.get("dur", 0.0))
        t[1] += 1
    out: Dict[str, PlaneSummary] = {}
    for plane, names in totals.items():
        rows = sorted(((n, d, int(c)) for n, (d, c) in names.items()),
                      key=lambda r: -r[1])
        out[plane] = rows[:top]
    return out


def device_kernel_table(events: list, steps: int) -> Dict[str, dict]:
    """Every device kernel and copy of a trace's events: ms a step and
    launches a step, and the device ms a step of all of them under
    "total"."""
    table: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            row = table[e["name"]]
            row[0] += float(e.get("dur", 0.0))
            row[1] += 1
    steps = max(steps, 1)
    out = {name: {"ms_per_step": us / 1e3 / steps,
                  "launches_per_step": n / steps}
           for name, (us, n) in table.items()}
    out["total"] = {"ms_per_step": sum(v[0] for v in table.values())
                    / 1e3 / steps,
                    "launches_per_step": sum(v[1] for v in table.values())
                    / steps}
    return out


def hand_kernels(table: Dict[str, dict]) -> Dict[str, dict]:
    """The port's hand kernels in a ``device_kernel_table``, by wrapper
    name: ms a step and launches a step (0 for one the step did not
    run)."""
    out = {name: {"ms_per_step": 0.0, "launches_per_step": 0.0}
           for name in HAND_KERNELS}
    for kernel, row in table.items():
        for name, pattern in HAND_KERNELS.items():
            if pattern.search(kernel):
                out[name]["ms_per_step"] += row["ms_per_step"]
                out[name]["launches_per_step"] += row["launches_per_step"]
    return out


def format_summary(summary: Dict[str, PlaneSummary], steps: int,
                   hand: Optional[Dict[str, dict]] = None) -> str:
    lines = []
    for plane, rows in sorted(summary.items()):
        lines.append(f"== {plane} (top {len(rows)} by total time; host "
                     "operators nest, so theirs overlap) ==")
        for name, us, count in rows:
            lines.append(f"  {us / 1e3:10.3f} ms  x{count:<6d} "
                         f"{us / 1e3 / max(steps, 1):8.4f} ms/step  "
                         f"{count / max(steps, 1):8.2f}/step  {name[:90]}")
    if hand is not None:
        lines.append("== the port's hand kernels ==")
        for name, row in hand.items():
            lines.append(f"  {name:16s} {row['ms_per_step']:8.4f} ms/step  "
                         f"{row['launches_per_step']:6.2f} launches/step")
    return "\n".join(lines)
