"""Chrome-trace -> component device-time attribution, the JAX package's
``telemetry/traceparse.py`` over ``torch.profiler`` traces (what
``telemetry/profiler.py`` and ``tools/profile_step.py`` write).

The component scopes (telemetry/scopes.py: ``record_function`` ranges in
models/network.py, learner/train_step.py, ops/sum_tree.py,
actor/anakin.py and replay/device_replay.py) name the host ranges a
kernel is launched from. A kernel event maps to the operator that
launched it (its ``External id``, else its runtime call's
``correlation``), the operator to the innermost scope range around it on
its thread, and a backward operator (autograd's ``evaluate_function``
ranges, which run outside the forward's scopes) to the scope of the
forward operator with the same ``Sequence number``. A kernel launched
outside any operator (a hand kernel through ctypes) takes the innermost
scope around its launch. Components follow
the JAX package's ``COMPONENT_TOKENS``: torso / lstm / head / sum_tree /
replay / obs_decode / loss / optimizer / emit_blocks / env_step /
act_forward; whatever matches nothing is reported as ``unattributed``,
never dropped (the bar: >= 80% of a learner-step capture's device time
attributed).

A CUDA graph's replay launches its kernels from one ``cudaGraphLaunch``,
outside every scope. ``kernel_components`` takes a map from an eager
profile of the same step factory (the graph replays the same kernels):
kernel name -> device time by component; ``attribute_trace`` then splits
an unscoped kernel's time in the eager profile's proportions for that
name (``mapped_us`` says how much). A trace without device events (the
CPU) attributes the top-level host operators instead (``host_fallback``).

    python -m r2d2_tpu_torch.telemetry.traceparse --trace DIR_OR_FILE
    python -m r2d2_tpu_torch.telemetry.traceparse --trace T --map EAGER_T
"""

import bisect
import glob
import gzip
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

# (token, component), matched in order against a scope's name: the most
# specific first (the network scopes nest inside act_forward and loss)
COMPONENT_TOKENS: Tuple[Tuple[str, str], ...] = (
    ("torso", "torso"),
    ("lstm", "lstm"),
    ("head", "head"),
    ("sum_tree", "sum_tree"),
    ("emit_blocks", "emit_blocks"),
    ("env_step", "env_step"),
    ("env_reset", "env_step"),
    ("obs_decode", "obs_decode"),
    ("stack_frames", "obs_decode"),
    ("replay_sample", "replay"),
    ("replay_add", "replay"),
    ("optimizer", "optimizer"),
    ("loss", "loss"),
    ("act_forward", "act_forward"),
)

UNATTRIBUTED = "unattributed"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCOPE_CATS = ("user_annotation",)
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


def component_of(text: str) -> Optional[str]:
    """First component whose token appears in ``text``."""
    for token, comp in COMPONENT_TOKENS:
        if token in text:
            return comp
    return None


def load_trace_events(path: str) -> List[dict]:
    """Trace events from a Chrome-trace ``.json``/``.json.gz`` file, or
    the newest ``*.trace.json(.gz)`` under a capture directory."""
    if os.path.isdir(path):
        candidates = sorted(
            (p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(path, "**", pattern),
                                recursive=True)),
            key=os.path.getmtime)
        if not candidates:
            raise FileNotFoundError(
                f"no *.trace.json(.gz) under {path!r}: did the capture run?")
        path = candidates[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


class _Intervals:
    """Complete events of one thread, sorted by start: the innermost one
    containing a time point (ranges on a thread nest)."""

    def __init__(self, items: List[Tuple[float, float, Any]]):
        items.sort(key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in items]
        self.items = items

    def innermost(self, t: float) -> Any:
        i = bisect.bisect_right(self.starts, t)
        best = None
        # walk back over ranges starting at or before t; the latest start
        # that still contains t is the innermost
        for j in range(i - 1, -1, -1):
            start, end, payload = self.items[j]
            if end >= t:
                best = payload
                break
        return best


def _top_level(thread_ops: List[dict]) -> List[dict]:
    """The operators of one thread that no other operator encloses."""
    out, end = [], float("-inf")
    for e in sorted(thread_ops, key=lambda e: (float(e["ts"]),
                                               -float(e.get("dur", 0.0)))):
        ts = float(e["ts"])
        if ts >= end:
            out.append(e)
            end = ts + float(e.get("dur", 0.0))
    return out


def _x_events(events: Iterable[dict]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and float(e.get("dur", 0.0)) >= 0]


def _by_thread(events: Iterable[dict]) -> Dict[tuple, List[dict]]:
    out: Dict[tuple, List[dict]] = defaultdict(list)
    for e in events:
        out[(e.get("pid"), e.get("tid"))].append(e)
    return out


def _op_components(events: List[dict]):
    """Each host operator's component (keyed by ``id(event)``), the
    per-thread operator intervals and the per-thread scope intervals."""
    scopes = defaultdict(list)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for e in events:
        if e.get("cat") in SCOPE_CATS:
            comp = component_of(str(e.get("name", "")))
            if comp is not None:
                ts = float(e["ts"])
                scopes[(e.get("pid"), e.get("tid"))].append(
                    (ts, ts + float(e.get("dur", 0.0)), comp))
    scope_iv = {k: _Intervals(v) for k, v in scopes.items()}
    comp: Dict[int, Optional[str]] = {}
    # forward operators: the scope around them; their sequence numbers
    # carry it to the backward ranges
    seq_comp: Dict[int, str] = {}
    for e in ops:
        iv = scope_iv.get((e.get("pid"), e.get("tid")))
        c = iv.innermost(float(e["ts"])) if iv is not None else None
        comp[id(e)] = c
        seq = (e.get("args") or {}).get("Sequence number")
        name = str(e.get("name", ""))
        if (c is not None and seq is not None
                and not name.startswith(BACKWARD_PREFIX)):
            seq_comp.setdefault(int(seq), c)
    # backward ranges, and every operator inside one, take their forward
    # operator's component
    back = defaultdict(list)
    for e in ops:
        name = str(e.get("name", ""))
        seq = (e.get("args") or {}).get("Sequence number")
        if name.startswith(BACKWARD_PREFIX) and seq is not None:
            c = seq_comp.get(int(seq))
            if c is not None:
                ts = float(e["ts"])
                back[(e.get("pid"), e.get("tid"))].append(
                    (ts, ts + float(e.get("dur", 0.0)), c))
    back_iv = {k: _Intervals(v) for k, v in back.items()}
    for e in ops:
        iv = back_iv.get((e.get("pid"), e.get("tid")))
        if iv is not None:
            c = iv.innermost(float(e["ts"]))
            if c is not None:
                comp[id(e)] = c
    op_iv = {k: _Intervals([(float(e["ts"]),
                             float(e["ts"]) + float(e.get("dur", 0.0)), e)
                            for e in v])
             for k, v in _by_thread(ops).items()}
    return comp, op_iv, scope_iv


def _device_components(events: List[dict]) -> List[Tuple[dict,
                                                          Optional[str]]]:
    """(device event, component or None) for every kernel and copy. A
    kernel launched outside any operator (a hand kernel through ctypes)
    takes the innermost scope around its launch."""
    comp, op_iv, scope_iv = _op_components(events)
    by_ext, scope_ext = {}, {}
    for e in events:
        ext = (e.get("args") or {}).get("External id")
        if ext is None:
            continue
        if e.get("cat") == "cpu_op":
            by_ext.setdefault(ext, e)
        elif e.get("cat") in SCOPE_CATS:
            c = component_of(str(e.get("name", "")))
            if c is not None:
                scope_ext.setdefault(ext, c)
    runtime = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args") or {}
        ext = args.get("External id")
        op, c = by_ext.get(ext), scope_ext.get(ext)
        if op is not None:
            c = comp.get(id(op))
        elif c is None:
            # the runtime call that launched it, and the operator (else
            # the scope) around that call on its thread
            call = runtime.get(args.get("correlation"))
            if call is not None:
                key, ts = (call.get("pid"), call.get("tid")), float(call["ts"])
                if key in op_iv:
                    op = op_iv[key].innermost(ts)
                    c = comp.get(id(op)) if op is not None else None
                if c is None and key in scope_iv:
                    c = scope_iv[key].innermost(ts)
        out.append((e, c))
    return out


def kernel_components(events_or_path) -> Dict[str, Dict[str, float]]:
    """An eager profile's map: device event name -> {component: us}
    (scoped events only): what ``attribute_trace`` splits a graph
    replay's unscoped kernels by."""
    events = (load_trace_events(events_or_path)
              if isinstance(events_or_path, str) else list(events_or_path))
    table: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for e, comp in _device_components(_x_events(events)):
        if comp is not None:
            table[str(e.get("name", "?"))][comp] += float(e.get("dur", 0.0))
    return {name: dict(comps) for name, comps in table.items()}


def attribute_trace(events_or_path, kernel_map: Optional[dict] = None,
                    top_ops: int = 8) -> Dict[str, Any]:
    """Map a capture's device events (kernels, copies, memsets) to
    components. Returns per-component device time, share and top events;
    ``unattributed`` is a component row like any other (its share is the
    attribution gap). ``kernel_map``: ``kernel_components`` of an eager
    profile, for events no scope reaches (a graph replay's); their time
    is split by the map's proportions and counted in ``mapped_us``.
    ``host_fallback``: the trace has no device events (the CPU), so the
    top-level host operators are attributed instead."""
    events = _x_events(load_trace_events(events_or_path)
                       if isinstance(events_or_path, str)
                       else events_or_path)
    rows = _device_components(events)
    host_fallback = not rows
    if host_fallback:
        comp, _, _ = _op_components(events)
        rows = [(e, comp.get(id(e)))
                for thread_ops in _by_thread(
                    e for e in events if e.get("cat") == "cpu_op").values()
                for e in _top_level(thread_ops)]
    comp_us: Dict[str, float] = defaultdict(float)
    comp_ops: Dict[str, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(lambda: [0.0, 0]))
    total = mapped = 0.0
    for e, comp in rows:
        dur = float(e.get("dur", 0.0))
        if dur <= 0:
            continue
        name = str(e.get("name", "?"))
        total += dur
        shares = {comp: 1.0} if comp is not None else None
        if shares is None and kernel_map and name in kernel_map:
            weights = kernel_map[name]
            whole = sum(weights.values())
            if whole > 0:
                shares = {c: w / whole for c, w in weights.items()}
                mapped += dur
        for c, share in (shares or {UNATTRIBUTED: 1.0}).items():
            comp_us[c] += dur * share
            row = comp_ops[c][name]
            row[0] += dur * share
            row[1] += share
    components = {}
    for c, us in sorted(comp_us.items(), key=lambda kv: -kv[1]):
        ops = sorted(((n, d, cnt) for n, (d, cnt) in comp_ops[c].items()),
                     key=lambda r: -r[1])[:top_ops]
        components[c] = {
            "time_us": round(us, 3),
            "share": round(us / total, 6) if total else 0.0,
            "ops": [{"name": n, "time_us": round(d, 3),
                     "count": round(cnt, 3)} for n, d, cnt in ops],
        }
    unattributed = comp_us.get(UNATTRIBUTED, 0.0)
    return {
        "schema": 1,
        "total_us": round(total, 3),
        "attributed_frac": (round((total - unattributed) / total, 6)
                            if total else 0.0),
        "unattributed_us": round(unattributed, 3),
        "mapped_us": round(mapped, 3),
        "host_fallback": bool(host_fallback),
        "components": components,
    }


def format_attribution(summary: Dict[str, Any]) -> str:
    lines = [f"{'component':<14}{'time ms':>12}{'share':>9}"]
    for comp, row in summary["components"].items():
        lines.append(f"{comp:<14}{row['time_us'] / 1e3:>12.3f}"
                     f"{100 * row['share']:>8.1f}%")
    lines.append(f"attributed: {100 * summary['attributed_frac']:.1f}% of "
                 f"{summary['total_us'] / 1e3:.3f} ms "
                 + ("host operator time  [no device events]"
                    if summary["host_fallback"] else "device time")
                 + (f" ({summary['mapped_us'] / 1e3:.3f} ms through the "
                    "eager map)" if summary.get("mapped_us") else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", required=True,
                   help="capture dir or a *.trace.json(.gz) file")
    p.add_argument("--map", default="",
                   help="an eager capture of the same step: its kernels' "
                        "components attribute a graph replay's")
    p.add_argument("--out", default="",
                   help="write the attribution summary JSON here")
    p.add_argument("--top", type=int, default=8,
                   help="events kept per component")
    args = p.parse_args(argv)
    kmap = kernel_components(args.map) if args.map else None
    summary = attribute_trace(args.trace, kernel_map=kmap, top_ops=args.top)
    print(format_attribution(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
