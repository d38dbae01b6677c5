"""Roofline report, the JAX package's ``tools/roofline.py`` for the port:
the analytic component costs, the FLOPs the programs execute (the flop
counter with the hand kernels' formulas, telemetry/costmodel.py
``collect_cost_table``), ``peak_spec``'s row for the card and a measured
step time, joined into one table.

Per component (torso / lstm / head / sum_tree / replay): FLOPs, bytes,
arithmetic intensity, the bound class against the card's ridge point,
the time it would take at the peak, and with a step time its share of the
peak. Given a component attribution of a profiled step
(telemetry/traceparse.py), each component also gets its measured device
ms a step and the fraction of it that the peak-rate time is
(``roofline_frac``: 1 = at the bound; the rows far below 1 are the
"farthest from the bound" list). The learner step's counted FLOPs are
checked against ``model_flops_per_step`` (the JAX package's 5% bar).

    python -m r2d2_tpu_torch.tools.roofline                 # the card
    python -m r2d2_tpu_torch.tools.roofline --device=cpu --preset gate
    python -m r2d2_tpu_torch.tools.roofline --trace DIR --map EAGER_DIR \\
        --trace-steps 20 --out roofline.json

On the card the default preset is the reference configuration (bench's
100,000-step ring) and the step is timed there; on the CPU the peaks are
a nominal placeholder (flagged, never quoted) and the gate preset's
tiny shape is used.
"""

import json
import sys
import time
from typing import Any, Dict, Optional

from r2d2_tpu_torch.telemetry.costmodel import (analytic_component_costs,
                                                collect_cost_table,
                                                gate_config, peak_spec)

ROOFLINE_VARIANTS = ("learner_step", "anakin_act", "replay_add_many",
                     "replay_sample")
PARITY_RTOL = 0.05


def _preset_config(preset: str, device):
    if preset == "auto":
        preset = "reference" if device.type == "cuda" else "gate"
    if preset == "reference":
        from r2d2_tpu_torch.tools.bench import reference_config
        return reference_config(**{"env.game_name": "Fake",
                                   "env.episode_len": 400}), "reference"
    if preset == "gate":
        return gate_config(), "gate"
    raise SystemExit(f"unknown preset {preset!r} (auto|gate|reference)")


def measure_step_time_ms(cfg, device, n_timed: int = 20) -> float:
    """The Learner's dispatch of ``runtime.steps_per_dispatch`` steps
    (one CUDA graph on the card) over a replay of synthetic blocks: ms a
    step over ``n_timed`` dispatches after three warm-up ones, synced."""
    import torch

    from r2d2_tpu_torch.tools import bench
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    blocks = bench.synthetic_blocks(cfg, min(cfg.num_blocks, 16))
    spec, rs = bench.filled_replay(cfg, device, blocks)
    k = cfg.runtime.resolved_steps_per_dispatch(device)
    ts, step = bench.build_learner_step(cfg, device, spec, k)
    cuda = device.type == "cuda"
    for _ in range(3):
        step(ts, rs)
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        loss = step(ts, rs)[2]["loss"]
    if cuda:
        torch.cuda.synchronize(device)
    else:
        loss.sum().item()
    return 1e3 * (time.perf_counter() - t0) / (n_timed * k)


def build_report(cfg, preset: str, step_time_ms: Optional[float],
                 peak: Dict[str, Any],
                 trace_summary: Optional[dict] = None,
                 costs: Optional[dict] = None, device=None,
                 action_dim: Optional[int] = None) -> Dict[str, Any]:
    """The joined report, pure given its inputs. ``costs``: a
    ``collect_cost_table`` of the roofline's variants (counted here on
    ``device`` when None). ``trace_summary``: ``traceparse``'s attribution
    of a profiled step, with ``steps`` (the steps it spans) added by the
    caller."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    if costs is None:
        costs = collect_cost_table(cfg, variants=ROOFLINE_VARIANTS,
                                   device=device, action_dim=action_dim)
    action_dim = costs["action_dim"]
    programs = costs["programs"]
    # the resolved compute dtype picks both the peak row and the
    # analytic activation byte size
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    bf16 = bool(net.config.bf16)
    analytic = analytic_component_costs(cfg, action_dim,
                                        act_bytes=2 if bf16 else 4,
                                        device=device)
    peak_flops = float(peak["flops_bf16" if bf16 else "flops_f32"])
    bw_bytes = float(peak["hbm_gbps"]) * 1e9
    ridge = peak_flops / bw_bytes            # FLOPs/byte at the knee

    step_s = step_time_ms / 1e3 if step_time_ms else None
    trace_comps = (trace_summary or {}).get("components") or {}
    trace_steps = (trace_summary or {}).get("steps")
    comp_rows: Dict[str, Any] = {}
    total_flops = analytic["total_flops"]
    for name, c in analytic["components"].items():
        ai = c["flops"] / c["bytes"] if c["bytes"] else 0.0
        row = {
            "flops": c["flops"],
            "bytes": c["bytes"],
            "arithmetic_intensity": round(ai, 4),
            "bound": "compute" if ai >= ridge else "memory",
            "share_of_flops": round(c["flops"] / total_flops, 6)
            if total_flops else 0.0,
            "time_at_peak_ms": round(1e3 * max(
                c["flops"] / peak_flops, c["bytes"] / bw_bytes), 6),
        }
        if step_s:
            row["pct_of_peak"] = round(
                100.0 * c["flops"] / (step_s * peak_flops), 4)
        if name in trace_comps:
            row["device_time_share"] = trace_comps[name].get("share")
            if trace_steps:
                dev_ms = trace_comps[name]["time_us"] / 1e3 / trace_steps
                row["device_ms"] = round(dev_ms, 6)
                row["roofline_frac"] = (round(row["time_at_peak_ms"]
                                              / dev_ms, 6)
                                        if dev_ms > 0 else None)
        comp_rows[name] = row

    lstep = programs.get("learner_step", {})
    counted = lstep.get("flops")
    mfps = analytic["model_flops_per_step"]
    ratio = counted / mfps if counted and mfps else None
    parity = {"counted_flops": counted, "model_flops_per_step": mfps,
              "ratio": round(ratio, 6) if ratio is not None else None,
              "within": (abs(ratio - 1.0) <= PARITY_RTOL
                         if ratio is not None else None)}

    serial = dict(analytic["serial_chain"])
    serial["floor_at_peak_ms"] = round(1e3 * serial["flops"] / peak_flops, 6)
    if step_s:
        serial["implied_tau_us_upper"] = round(
            1e6 * step_s / serial["iterations"], 3)

    report = {
        "schema": 1,
        "preset": preset,
        "device": costs["device"],
        "peak": peak,
        "compute_dtype": "bf16" if bf16 else "f32",
        "ridge_flops_per_byte": round(ridge, 4),
        "shape": costs["shape"],
        "action_dim": action_dim,
        "learner_step": {
            "measured_ms": step_time_ms,
            "counted": lstep,
            "total_flops_analytic": total_flops,
            "pct_of_peak_total": (round(
                100.0 * total_flops / (step_s * peak_flops), 4)
                if step_s else None),
            "components": comp_rows,
            "serial_chain": serial,
        },
        "parity": parity,
        "anakin_act": None,
        "programs": programs,
    }
    act = programs.get("anakin_act")
    if act:
        seg_steps = cfg.actor.anakin_lanes * cfg.replay.block_length
        report["anakin_act"] = {
            "counted": act,
            "env_steps_per_segment": seg_steps,
            "flops_per_env_step": (round(act["flops"] / seg_steps, 1)
                                   if act.get("flops") else None),
        }
    if trace_summary is not None:
        report["trace_attribution"] = {
            "attributed_frac": trace_summary.get("attributed_frac"),
            "total_us": trace_summary.get("total_us"),
            "steps": trace_steps,
        }
    return report


def format_report(report: Dict[str, Any]) -> str:
    ls = report["learner_step"]
    peak = report["peak"]
    dtype = report["compute_dtype"]
    nominal = (" [NOMINAL peaks: no card, do not quote]"
               if peak.get("nominal") else "")
    lines = [
        f"roofline @ {peak.get('device_kind')} ({dtype} peak "
        f"{peak['flops_bf16' if dtype == 'bf16' else 'flops_f32'] / 1e12:.1f}"
        f" TFLOP/s, {peak['hbm_gbps']:.0f} GB/s, ridge "
        f"{report['ridge_flops_per_byte']:.1f} FLOP/B){nominal}"]
    mm = ls["measured_ms"]
    lines.append(
        f"learner step: {ls['total_flops_analytic'] / 1e9:.3f} GFLOP "
        + (f"measured {mm:.3f} ms -> {ls['pct_of_peak_total']:.2f}% of peak"
           if mm else "(no measured step time)"))
    lines.append(f"{'component':<10}{'GFLOP':>10}{'MB':>10}{'AI':>9}"
                 f"{'bound':>9}{'%flops':>8}{'%peak':>8}{'peak ms':>10}"
                 f"{'dev ms':>10}{'frac':>8}")
    for name, r in ls["components"].items():
        pct = r.get("pct_of_peak")
        dev = r.get("device_ms")
        frac = r.get("roofline_frac")
        lines.append(
            f"{name:<10}{r['flops'] / 1e9:>10.4f}{r['bytes'] / 2**20:>10.2f}"
            f"{r['arithmetic_intensity']:>9.1f}{r['bound']:>9}"
            f"{100 * r['share_of_flops']:>7.1f}%"
            + (f"{pct:>7.2f}%" if pct is not None else f"{'-':>8}")
            + f"{r['time_at_peak_ms']:>10.4f}"
            + (f"{dev:>10.4f}" if dev is not None else f"{'-':>10}")
            + (f"{frac:>8.4f}" if frac is not None else f"{'-':>8}"))
    sc = ls["serial_chain"]
    lines.append(
        f"serial chain: {sc['iterations']} dependent iterations, "
        f"{100 * sc['share_of_total']:.1f}% of FLOPs, floor at peak "
        f"{sc['floor_at_peak_ms']:.4f} ms"
        + (f", implied tau <= {sc['implied_tau_us_upper']:.1f} us/iter"
           if "implied_tau_us_upper" in sc else ""))
    par = report["parity"]
    if par["ratio"] is not None:
        lines.append(
            f"parity: counted {par['counted_flops'] / 1e9:.3f} GFLOP vs "
            f"model_flops_per_step {par['model_flops_per_step'] / 1e9:.3f} "
            f"GFLOP (ratio {par['ratio']:.4f}, within "
            f"{100 * PARITY_RTOL:.0f}%: {par['within']})")
    act = report.get("anakin_act")
    if act:
        fpes = act["flops_per_env_step"]
        lines.append(
            f"anakin act: {act['counted'].get('flops', 0) / 1e9:.4f} "
            "GFLOP / segment = "
            + (f"{fpes:.0f}" if fpes is not None else "-")
            + f" FLOP/env-step ({act['env_steps_per_segment']} "
              "steps/segment)")
    ta = report.get("trace_attribution")
    if ta:
        lines.append(f"trace attribution: "
                     f"{100 * (ta.get('attributed_frac') or 0):.1f}% of "
                     f"{(ta.get('total_us') or 0) / 1e3:.2f} ms device time "
                     "mapped to components")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="auto",
                   help="auto (reference on the card, gate on the CPU) | "
                        "gate | reference")
    p.add_argument("--device", default=None,
                   help='"cuda" (default; raises without one) or "cpu"')
    p.add_argument("--out", default="",
                   help="write the report JSON here")
    p.add_argument("--step-time-ms", type=float, default=None,
                   help="use this step time instead of measuring")
    p.add_argument("--no-measure", action="store_true",
                   help="skip the step timing (%%-of-peak omitted)")
    p.add_argument("--trace", default="",
                   help="a profiled step's capture (tools/profile_step.py)")
    p.add_argument("--map", default="",
                   help="an eager capture of the same step: attributes a "
                        "graph replay's kernels")
    p.add_argument("--trace-steps", type=int, default=None,
                   help="steps the --trace capture spans (default: its "
                        "profile_meta.json)")
    args = p.parse_args(argv)

    from r2d2_tpu_torch.telemetry import traceparse
    from r2d2_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    cfg, preset = _preset_config(args.preset, device)
    peak = peak_spec("cpu" if device.type != "cuda" else None)
    step_ms = args.step_time_ms
    if step_ms is None and not args.no_measure:
        print("measuring the learner step ...", file=sys.stderr)
        step_ms = measure_step_time_ms(cfg, device)
    trace_summary = None
    if args.trace:
        kmap = (traceparse.kernel_components(args.map) if args.map
                else None)
        trace_summary = traceparse.attribute_trace(args.trace,
                                                   kernel_map=kmap)
        steps = args.trace_steps
        if steps is None:
            from r2d2_tpu_torch.tools.profile_step import traced_step_count
            steps = traced_step_count(args.trace)
        trace_summary["steps"] = steps
    report = build_report(cfg, preset, step_ms, peak,
                          trace_summary=trace_summary, device=device)
    print(format_report(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
