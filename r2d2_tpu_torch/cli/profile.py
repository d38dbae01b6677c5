"""Profile the learner step and print its time per operation and per CUDA
kernel (tools/profile_step.py).

    python -m r2d2_tpu_torch.cli.profile --steps 20 --out DIR [overrides]
    python -m r2d2_tpu_torch.cli.profile --summarize DIR   # read a trace

The step runs on the card unless ``--device=cpu``; the configuration is
the reference shape (``Config()``) with the replay's capacity cut to
``tools/bench.py``'s (100,000 steps, a full ring) unless
``--replay.capacity`` is given, and any
``--section.field=value`` override. Prints the summary by plane, the
port's hand kernels (ms a step, launches a step), and last one JSON line:
``{"steps", "trace_dir", "device_ms_per_step", "hand_kernels",
"launches_per_step"}`` (the wrappers' launches a step in the traced
window, where the capture recorded them); ``main`` also returns every
device kernel's ms and launches a step under ``device_kernels``.
"""

import argparse
import json
import sys


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20,
                   help="learner steps inside the trace")
    p.add_argument("--out", default="profile",
                   help="the trace's directory")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without one) or cpu")
    p.add_argument("--summarize", default=None, metavar="TRACE_DIR",
                   help="read an existing trace instead of capturing one")
    args, overrides = p.parse_known_args(argv)

    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.tools.bench import REF_CAPACITY
    from r2d2_tpu_torch.tools.profile_step import (
        capture_step_trace, device_kernel_table, format_summary,
        hand_kernels, load_trace_events, read_meta, summarize_events,
        traced_step_count)

    trace_dir = args.summarize
    if trace_dir is not None and overrides:
        p.error(f"unrecognized arguments with --summarize: {overrides} "
                "(overrides apply to a capture)")
    if trace_dir is None:
        cfg = parse_overrides(Config(), overrides)
        if not any(o.startswith("--replay.capacity=") for o in overrides):
            cfg = cfg.replace(**{"replay.capacity":
                                 min(cfg.replay.capacity, REF_CAPACITY)})
        trace_dir = capture_step_trace(cfg, args.steps, args.out,
                                       device=args.device)
        print(f"trace written to {trace_dir}", file=sys.stderr)
    steps = traced_step_count(trace_dir)
    if steps is None:
        steps = args.steps
        print(f"warning: no profile_meta.json in {trace_dir}; per-step "
              f"figures assume --steps={steps}", file=sys.stderr)
    events = load_trace_events(trace_dir)
    table = device_kernel_table(events, steps)
    hand = hand_kernels(table)
    print(format_summary(summarize_events(events, top=args.top), steps,
                         hand), flush=True)
    meta = read_meta(trace_dir) or {}
    result = {
        "steps": steps, "trace_dir": trace_dir,
        "device_ms_per_step": table["total"]["ms_per_step"],
        "device_kernels": table,
        "hand_kernels": hand,
        "launches_per_step": ({name: n / steps for name, n in
                               meta["launches"].items()}
                              if "launches" in meta else None)}
    print(json.dumps({k: v for k, v in result.items()
                      if k != "device_kernels"}), flush=True)
    return result


if __name__ == "__main__":
    main()
