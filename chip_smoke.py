#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which asserts or raises (any failure exits nonzero):
  1. versions, device name and power limit;
  2. build the CUDA kernels from the sources in this checkout;
  3. every kernel against its plain PyTorch version at the reference shape
     (exact), with CUDA-event times of kernel, plain version and the
     PyTorch library call, and the bandwidth bound;
  4. a small learner step on the card against the same step on the CPU,
     then the learner step at the reference shape (B=128, T=40+10+5,
     84x84x4, cnn 1024, LSTM 512, dueling, bf16) over a replay filled by
     replay_add_many (capacity cut from 500,000 to 100,000 steps);
  5. the trainer through its entry point, r2d2_tpu_torch.cli.train, at the
     same widths for a few learner steps; the kernel launch counts of this
     run go into the ``kernels`` line.

The last line is {"ok": true, "device": {...}}. ``--profile`` adds a
torch.profiler breakdown of three reference-shape steps.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
REF_CAPACITY = 100_000             # down from 500,000 to fit the smoke's time
KERNEL_SOURCE = "r2d2_tpu_torch/csrc/replay_kernels.cu"


def check(cond, what="") -> None:
    """Fail the phase (an assert would vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _import_port():
    """The port, from the checkout this script sits in, or raise."""
    import r2d2_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(r2d2_tpu_torch.__file__).resolve().parent.parent != here:
        raise SystemExit("r2d2_tpu_torch is not beside chip_smoke.py")
    return r2d2_tpu_torch


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_versions():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def phase_build():
    from r2d2_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build("replay_kernels", force=True)
    print(f"build: replay_kernels.cu {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_kernels(dev):
    """Kernel vs plain version at the reference shape, exact."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk

    g = torch.Generator(device=dev).manual_seed(0)
    n, row_len, h, w, batch, t, k = 250, 448, 84, 84, 128, 55, 4
    window = t + k - 1
    block_idx = torch.randint(0, n, (batch,), generator=g, device=dev,
                              dtype=torch.int32)
    start = torch.randint(0, row_len - window + 1, (batch,), generator=g,
                          device=dev, dtype=torch.int32)
    tidx = start.long()[:, None] + torch.arange(window, device=dev)[None, :]
    results = {}

    rings = {label: torch.randint(0, 256, (n, row_len, hs, ws), generator=g,
                                  device=dev, dtype=torch.uint8)
             for label, (hs, ws) in (("unpadded", (h, w)),
                                     ("padded", (96, 128)))}
    gathered, errs = {}, []
    # off-contract indices too: negative ones count from the end, then clamp
    odd_idx = torch.tensor([-1, 3, n + 5, 0], dtype=torch.int32, device=dev)
    odd_start = torch.tensor([-30, row_len, 5, -1000], dtype=torch.int32,
                             device=dev)
    for label, ring in rings.items():
        for bi, st in ((block_idx, start), (odd_idx, odd_start)):
            got = rk.gather_windows_cuda(ring, bi, st, window)
            want = rk.gather_windows_plain(ring, bi, st, window)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"gather_windows {label} differs")
            errs.append((got.int() - want.int()).abs().max().item())
        gathered[label] = rk.gather_windows_cuda(ring, block_idx, start,
                                                 window)
        print(f"gather_windows {label} {tuple(ring.shape)}: exact",
              flush=True)
    ring, bi = rings["unpadded"], block_idx.long()[:, None]
    results["gather_windows"] = dict(
        max_abs_err=float(max(errs)),
        ms=cuda_ms(lambda: rk.gather_windows_cuda(ring, block_idx, start,
                                                  window)),
        plain_ms=cuda_ms(lambda: rk.gather_windows_plain(ring, block_idx,
                                                         start, window)),
        library_ms=cuda_ms(lambda: ring[bi, tidx]),
        bound_ms=2 * batch * window * h * w / HBM_BYTES_PER_S * 1e3)
    obs, obs_padded = gathered["unpadded"], gathered["padded"]
    del rings, ring

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, src in (("unpadded", obs), ("padded", obs_padded)):
            got = rk.stack_frames_cuda(src, t, k, dtype, h, w)
            want = rk.stack_frames_plain(src, t, k, dtype, h, w)
            torch.cuda.synchronize()
            check(got.shape == (batch, t, h, w, k) and got.dtype == dtype,
                  f"stack_frames {dtype} shape {tuple(got.shape)}")
            check(torch.equal(got, want), f"stack_frames {dtype} {label}")
            errs.append((got.float() - want.float()).abs().max().item())
            print(f"stack_frames {dtype} {label}: exact", flush=True)
    out_bytes = batch * t * h * w * k * 2
    results["stack_frames"] = dict(
        max_abs_err=float(max(errs)),
        ms=cuda_ms(lambda: rk.stack_frames_cuda(obs, t, k, torch.bfloat16)),
        plain_ms=cuda_ms(lambda: rk.stack_frames_plain(obs, t, k,
                                                       torch.bfloat16)),
        library_ms=None,
        bound_ms=(obs.numel() + out_bytes) / HBM_BYTES_PER_S * 1e3)
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms'] * 1e3:.1f} us", flush=True)
    return results


def _tiny_config():
    from r2d2_tpu_torch.config import Config
    return Config().replace(**{
        "env.frame_height": 24, "env.frame_width": 24, "env.frame_stack": 2,
        "network.hidden_dim": 16, "network.cnn_out_dim": 32,
        "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
        "network.bf16": "off",
        "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
        "sequence.forward_steps": 3,
        "replay.capacity": 800, "replay.block_length": 20,
        "replay.batch_size": 8, "optim.lr": 1e-3})


def _filled_learner_parts(cfg, device, action_dim, blocks, seed=0):
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_learner_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.device_replay import (replay_add_many,
                                                     replay_init)
    from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    spec = ReplaySpec.from_config(cfg, device)
    rs = replay_init(spec, device)
    for i in range(0, len(blocks), 25):
        replay_add_many(spec, rs, stack_blocks(blocks[i:i + 25]))
    ts = create_train_state(net, cfg.optim, seed, cfg.network.use_double)
    return ts, rs, make_learner_step(net, spec, cfg.optim,
                                     cfg.network.use_double), spec


def phase_small_step_vs_cpu(dev):
    """Two f32 learner steps at a small shape: card (kernels) vs CPU (plain
    versions) on the same replay, weights and jitter. Tolerance: rtol 1e-4
    on the loss and the tree (different conv/matmul algorithms sum in other
    orders; TF32 is off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    cfg = _tiny_config()
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    rng = np.random.default_rng(1)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    uniforms = torch.rand((2, spec.batch_size),
                          generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in (torch.device("cpu"), dev):
        ts, rs, step, _ = _filled_learner_parts(cfg, device, 18, blocks)
        losses = []
        for u in uniforms:
            ts, rs, m = step(ts, rs, u.to(device))
            losses.append(float(m["loss"]))
        runs[device.type] = (losses, rs.tree.cpu())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4,
                               atol=1e-6)
    print(f"small learner step, card vs CPU: losses {runs['cuda'][0]} vs "
          f"{runs['cpu'][0]}", flush=True)


def phase_reference_step(dev, profile: bool):
    import numpy as np
    import torch
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.ops import replay_kernels as rk
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block

    cfg = Config().replace(**{"replay.capacity": REF_CAPACITY})
    spec = ReplaySpec.from_config(cfg, dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    ts, rs, step, spec = _filled_learner_parts(cfg, dev, 18, blocks)
    del blocks
    torch.cuda.synchronize()
    check(ts.params.compute_dtype == torch.bfloat16, "bf16 on CUDA")
    print(f"reference replay: {spec.num_blocks} blocks, capacity "
          f"{REF_CAPACITY} steps (cut from 500,000), ring "
          f"{spec.device_ring_bytes / 1e9:.2f} GB, filled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for _ in range(3):
        ts, rs, m = step(ts, rs)
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    steps, losses = 20, []
    t0 = time.perf_counter()
    for _ in range(steps):
        ts, rs, m = step(ts, rs)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), losses)
    check(rk.LAUNCHES["gather_windows"] == steps, rk.LAUNCHES)
    # one decode per step feeds every unroll of the step
    check(rk.LAUNCHES["stack_frames"] == steps, rk.LAUNCHES)
    ms = dt / steps * 1e3
    out = {"step_ms": ms, "seq_updates_per_s": spec.batch_size * steps / dt,
           "steps": steps, "peak_mem_gb":
           torch.cuda.max_memory_allocated(dev) / 1e9,
           "loss_first": losses[0], "loss_last": losses[-1]}
    print("reference learner step: " + json.dumps(out), flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                ts, rs, m = step(ts, rs)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=25), flush=True)
    return out


def phase_cli(dev):
    import torch
    from r2d2_tpu_torch.cli import train
    from r2d2_tpu_torch.ops import replay_kernels as rk
    steps = 5
    rk.reset_launch_counts()
    summary = train.main([
        "--env.game_name=Fake", "--replay.capacity=20000",
        "--replay.learning_starts=400",
        "--replay.max_env_steps_per_train_step=4", f"--max-steps={steps}"])
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    check(summary["steps"] == steps
          and summary["device"].startswith("cuda"), summary["device"])
    check(all(math.isfinite(x) for x in summary["losses"]), summary)
    check(launches["gather_windows"] == steps, launches)
    check(launches["stack_frames"] == steps, launches)
    print(f"cli.train on the card: {steps} steps, launches {launches}",
          flush=True)
    return launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_versions()
    phase_build()
    timings = phase_kernels(dev)
    phase_small_step_vs_cpu(dev)
    phase_reference_step(dev, "--profile" in argv)
    launches = phase_cli(dev)

    replaces = {"gather_windows": "r2d2_tpu/ops/pallas_kernels.py:372",
                "stack_frames": "r2d2_tpu/ops/pallas_kernels.py:194"}
    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=r["library_ms"])
               for name, r in timings.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
