#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which asserts or raises (any failure exits nonzero):
  1. versions, device name and power limit;
  2. build the CUDA kernels from the sources in this checkout, one nvcc per
     source, all started together; print what ptxas reports per kernel and
     its tensor-core (HMMA) instruction count in the SASS (the bf16
     forward must have some, and no forward may spill);
  3. every kernel against its plain PyTorch version: the replay kernels at
     the reference shape (exact; the gather on unpadded and padded
     storage for random and off-contract indices in int32 and int64,
     batch 1, window 1, a partial last chunk, and an 83x83 frame, which
     takes its byte-wide kernel; the decode in both output layouts,
     standard and 2x2 space-to-depth, on unpadded and padded storage, and
     its any-shape kernel at shapes its fast one does not tile), the LSTM
     scan kernels at ragged small shapes and at the reference shape (T=55,
     B=128, H=512) in f32 and bf16 (tolerances at LSTM_TOL); CUDA-event
     times of kernel (timed alone, ``ms``, and back to back, ``b2b_ms``:
     20 launches enqueued behind a spin kernel, the gather on a fresh draw
     of indices each launch; the decode also right after a gather), plain
     version and the PyTorch library call, and the bound; cuDNN's nn.LSTM
     timed beside the port's LSTM layer as a yardstick; then the first
     conv timed in each input layout it could take
     (r2d2_tpu_torch/tools/conv_layouts.py);
  4. a small f32 learner step on the card against the same step on the
     CPU, on the default path and with network.pallas_lstm="on" and double
     DQN; then the learner step at the reference shape (B=128,
     T=40+10+5, 84x84x4, cnn 1024, LSTM 512, dueling, bf16) over a replay
     filled by replay_add_many (capacity cut from 500,000 to 100,000
     steps), on the default path, with double DQN, and with the fused LSTM
     scan and double DQN, timed in turns;
  5. the trainer through its entry point, r2d2_tpu_torch.cli.train, at the
     same widths for a few learner steps, on the default path, with
     --network.pallas_lstm=on --network.use_double=true, and on padded
     storage (--replay.pallas_exact_gather=on, the exact-read gather's);
     the kernel launch counts of these runs go into the ``kernels`` line
     (the gather's two rows: unpadded and padded storage).

TF32 is off throughout, as in training (utils/device.configure_numerics).
The last line is {"ok": true, "device": {...}}. ``--profile`` adds a
torch.profiler breakdown of three reference-shape steps of each path,
names any kernel of the first conv's 4-channel fallback it finds, and
checks that no copy kernel (an index cast) runs right before the
gather.
"""

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM dense peaks by input type: bf16 on the tensor cores, f32 off them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REF_CAPACITY = 100_000             # down from 500,000 to fit the smoke's time
KERNEL_SOURCES = {"replay_kernels": "r2d2_tpu_torch/csrc/replay_kernels.cu",
                  "lstm_kernels": "r2d2_tpu_torch/csrc/lstm_kernels.cu"}
# the gather is one kernel; its rows: unpadded storage (the row gather's,
# K1) and tile-padded storage (the exact-read gather's, K2)
REPLACES = {
    "gather_windows": "r2d2_tpu/ops/pallas_kernels.py:325",
    "gather_windows_padded": "r2d2_tpu/ops/pallas_kernels.py:372",
    "stack_frames": "r2d2_tpu/ops/pallas_kernels.py:194",
    "lstm_fwd": "r2d2_tpu/ops/pallas_lstm.py:194",
    "lstm_fwd_lean": "r2d2_tpu/ops/pallas_lstm.py:194",
    "lstm_bwd": "r2d2_tpu/ops/pallas_lstm.py:307",
}
# LSTM kernels vs plain versions, (atol, rtol) on outputs compared in f32.
# Not exact: the products sum in another order. f32: that order alone,
# grown over 55 steps. bf16: an f32 difference that flips a rounding of a
# bf16 output is one bf16 ulp, < 2e-2 below magnitude 2.5 and 2^-7 relative
# above it.
LSTM_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
# dWh sums T*B products per entry: max error / max |reference|
DWH_REL = {"float32": 1e-3, "bfloat16": 2e-2}
LSTM_REF_SHAPE = (55, 128, 512)                          # T, B, H
# ragged edges of the two kernels' shared partition (batch tiles of f32 32
# rows, bf16 16; unit groups of f32 16, bf16 32): H not a multiple of a
# group (H=17, 18, 24, 40), rows too narrow for 16-byte loads (the element
# path; k padded to 16 in shared memory), B one row past a tile (B=33) or
# with a partial last tile (B=3, 70, 130), B=256 at H=512, where a block
# walks two batch tiles, B=300 at H=512, where a slot's last walked tile
# lies past the batch (bf16 19 tiles over 8 slots, f32 10 over 4), and
# H=544, past the 512 k whose bf16 Wh operands the forward keeps in
# registers (the largest H whose f32 forward fits); T kept small for the
# plain version
LSTM_SMALL_SHAPES = ((4, 3, 17), (5, 8, 18), (6, 70, 16), (3, 130, 24),
                     (4, 33, 17), (4, 33, 40), (3, 256, 512), (2, 300, 512),
                     (2, 24, 544))
FUSED_ARGS = ["--network.pallas_lstm=on", "--network.use_double=true"]
PADDED_ARGS = ["--replay.pallas_exact_gather=on"]    # 84x84 stored as 96x128
BACK_TO_BACK = 20                  # launches enqueued ahead of the card
SPIN_CYCLES = 20_000_000           # ~10 ms: longer than enqueuing them
# cuDNN kernels of a 4-channel first conv's fallback (a layout conversion,
# an f32 implicit GEMM)
FALLBACK_KERNELS = re.compile(r"nhwcToNchw|nchwToNhwc|nhwc2nchw|nchw2nhwc"
                              r"|f32f32_f32f32", re.IGNORECASE)


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


def _reset_counts() -> None:
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    from r2d2_tpu_torch.ops import replay_kernels as rk
    rk.reset_launch_counts()
    lk.reset_launch_counts()


def _counts() -> dict:
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    from r2d2_tpu_torch.ops import replay_kernels as rk
    return {**rk.LAUNCHES, **lk.LAUNCHES}


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` timed alone on the current stream (CUDA
    events; the host's time between the events counts where the card
    waits for it)."""
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


def b2b_ms(fn, launches: int = BACK_TO_BACK, repeats: int = 5) -> float:
    """Milliseconds per launch back to back: a spin kernel holds the card
    while the host enqueues ``fn(0) .. fn(launches - 1)``, one event pair
    around them, divided by ``launches``; the median of ``repeats``."""
    import torch
    fn(0)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_versions():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def _ptxas_lines(report: str):
    """One line per kernel from ``nvcc -Xptxas -v``: registers, stack,
    spills, static shared memory."""
    lines, name, props = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = _demangle(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, {props}, static "
                         f"smem {smem.group(1) if smem else 0} B")
            name = None
    return lines


def _demangle(name: str) -> str:
    tool = shutil.which("c++filt")
    if not tool:
        return name
    return subprocess.run([tool, name], capture_output=True, text=True,
                          check=True).stdout.strip()


def _tensor_core_counts(lib_path) -> dict:
    """Tensor-core instructions (HMMA) per kernel in a built library's SASS
    (cuobjdump beside nvcc), or {} where cuobjdump is missing or fails."""
    from r2d2_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    proc = subprocess.run([str(tool), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return {}
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1))
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def phase_build():
    """Every source at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    from r2d2_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name, force=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        seconds = dict(zip(KERNEL_SOURCES, pool.map(timed, KERNEL_SOURCES)))
    for name, s in seconds.items():
        print(f"build: {name}.cu {s:.2f} s", flush=True)
        lines = _ptxas_lines(_build.PTXAS_REPORT[name])
        check(lines, f"no ptxas report for {name}")
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
        counts = _tensor_core_counts(_build.build(name))
        if not counts:
            print(f"sass {name}: not read (no cuobjdump output)", flush=True)
        for kernel, n in counts.items():
            print(f"sass {name}: {kernel}: {n} HMMA", flush=True)
        # the forward's bf16 product runs on the tensor cores, and no
        # forward instantiation spills
        for kernel, n in counts.items():
            if "lstm_fwd_kernel<__nv_bfloat16" in kernel:
                check(n > 0, f"no HMMA in {kernel}")
        for line in lines:
            if "lstm_fwd_kernel" in line:
                check("spill stores 0 B, spill loads 0 B" in line, line)


def _ops_run_by(fn) -> set:
    """The names of the PyTorch operators that ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return {e.key for e in p.key_averages()}


def gather_checks(dev, rings, window):
    """gather_windows against its plain version, exact: random and
    off-contract indices in int32 and int64, batch 1, window 1, both, a
    window whose bytes leave a partial last chunk of the kernel's plan, and
    an 83x83 frame (not a multiple of 16 bytes: the byte-wide kernel).
    Returns the max difference."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def draw(n, row_len, batch, win):
        return (torch.randint(0, n, (batch,), generator=g, device=dev),
                torch.randint(0, row_len - win + 1, (batch,), generator=g,
                              device=dev))

    ring83 = torch.randint(0, 256, (40, 96, 83, 83), generator=g,
                           device=dev, dtype=torch.uint8)
    errs = []
    for label, ring in {**rings, "83x83": ring83}.items():
        n, row_len, hs, ws = ring.shape
        # a window whose bytes the plan's chunk does not divide
        partial = next(w for w in range(window - 1, 0, -1)
                       if (w * hs * ws) % rk.gather_plan(
                           128, w, hs * ws, sms).chunk)
        odd = (torch.tensor([-1, 3, n + 5, 0, -n - 9], device=dev),
               torch.tensor([-30, row_len, 5, -1000, 2], device=dev))
        cases = [("random", *draw(n, row_len, 128, window), window),
                 ("off-contract", *odd, window),
                 ("batch 1", *draw(n, row_len, 1, window), window),
                 ("window 1", *draw(n, row_len, 128, 1), 1),
                 ("batch 1, window 1", *draw(n, row_len, 1, 1), 1),
                 (f"window {partial}, partial last chunk",
                  *draw(n, row_len, 128, partial), partial)]
        for case, bi64, st64, win in cases:
            for dtypes in ((torch.int32, torch.int32),
                           (torch.int64, torch.int32),
                           (torch.int64, torch.int64)):
                bi, st = bi64.to(dtypes[0]), st64.to(dtypes[1])
                got = rk.gather_windows_cuda(ring, bi, st, win)
                want = rk.gather_windows_plain(ring, bi, st, win)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"gather_windows {label} {case} {dtypes} differs")
                errs.append((got.int() - want.int()).abs().max().item())
        print(f"gather_windows {label} {tuple(ring.shape)}: exact in "
              f"{len(cases)} cases x 3 index dtypes", flush=True)
    return float(max(errs))


def gather_timings(dev, ring, window, max_abs_err):
    """gather_windows at the reference shape with int64 block indices, as
    the sampler gives them: timed alone, back to back on a fresh draw of
    indices each launch, its plain version, and the faster of two PyTorch
    calls that compute the same (advanced indexing; index_select over a
    strided view of the ring)."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk
    g = torch.Generator(device=dev).manual_seed(2)
    n, row_len, hs, ws = ring.shape
    frame = hs * ws
    draws = [(torch.randint(0, n, (128,), generator=g, device=dev),
              torch.randint(0, row_len - window + 1, (128,), generator=g,
                            device=dev, dtype=torch.int32))
             for _ in range(BACK_TO_BACK)]
    block_idx, start = draws[0]
    check(not {"aten::to", "aten::_to_copy", "aten::copy_"}
          & _ops_run_by(lambda: rk.gather_rows(ring, block_idx, start,
                                               window)),
          "gather_rows casts its int64 indices")
    tidx = start.long()[:, None] + torch.arange(window, device=dev)[None, :]
    bi = block_idx[:, None]
    windows = ring.view(-1).as_strided((n * row_len - window + 1,
                                        window * frame), (frame, 1))
    rows = block_idx * row_len + start
    want = rk.gather_windows_plain(ring, block_idx, start, window)
    check(torch.equal(ring[bi, tidx], want)
          and torch.equal(torch.index_select(windows, 0, rows).view(
              want.shape), want), "library calls differ from the plain one")
    library = {"ring[bi, t]": cuda_ms(lambda: ring[bi, tidx]),
               "index_select": cuda_ms(
                   lambda: torch.index_select(windows, 0, rows))}
    r = dict(max_abs_err=max_abs_err,
             ms=cuda_ms(lambda: rk.gather_windows_cuda(ring, block_idx,
                                                       start, window)),
             b2b_ms=b2b_ms(lambda i: rk.gather_windows_cuda(
                 ring, *draws[i], window)),
             plain_ms=cuda_ms(lambda: rk.gather_windows_plain(
                 ring, block_idx, start, window)),
             library_ms=min(library.values()),
             bound_ms=2 * 128 * window * frame / HBM_BYTES_PER_S * 1e3,
             bound_by="bytes")
    print(f"gather_windows {tuple(ring.shape)}: alone {r['ms']:.4f} ms, "
          f"back to back {r['b2b_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({100 * r['bound_ms'] / r['b2b_ms']:.1f}% of it back to "
          f"back), library " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in library.items()),
          flush=True)
    check(r["b2b_ms"] < r["library_ms"],
          "gather_windows is slower than a PyTorch call")
    return r, draws


def replay_kernel_checks(dev):
    """Replay kernels vs plain versions at the reference shape, exact, and
    their times."""
    import torch
    from r2d2_tpu_torch.ops import replay_kernels as rk

    g = torch.Generator(device=dev).manual_seed(0)
    n, row_len, h, w, batch, t, k = 250, 448, 84, 84, 128, 55, 4
    window = t + k - 1
    rings = {label: torch.randint(0, 256, (n, row_len, hs, ws), generator=g,
                                  device=dev, dtype=torch.uint8)
             for label, (hs, ws) in (("unpadded", (h, w)),
                                     ("padded", (96, 128)))}
    err = gather_checks(dev, rings, window)
    results, gathered, draws = {}, {}, {}
    for label, name in (("unpadded", "gather_windows"),
                        ("padded", "gather_windows_padded")):
        results[name], draws[label] = gather_timings(dev, rings[label],
                                                     window, err)
        gathered[label] = rk.gather_windows_cuda(
            rings[label], *draws[label][0], window)
    obs, obs_padded = gathered["unpadded"], gathered["padded"]
    # the decode right after a gather, back to back, as the step runs them
    ring, marks = rings["unpadded"], []

    def gather_then_decode(i):
        out = rk.gather_windows_cuda(ring, *draws["unpadded"][i], window)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rk.stack_frames_cuda(out, t, k, torch.bfloat16, h, w, True)
        b.record()
        marks.append((a, b))

    b2b_ms(gather_then_decode, repeats=1)
    after_gather = statistics.median(a.elapsed_time(b) for a, b in marks[1:])
    del rings, ring

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for s2d, layout in ((False, "standard"), (True, "space-to-depth")):
            shape = ((batch, t, h // 2, w // 2, 4 * k) if s2d
                     else (batch, t, h, w, k))
            for label, src in (("unpadded", obs), ("padded", obs_padded)):
                got = rk.stack_frames_cuda(src, t, k, dtype, h, w, s2d)
                want = rk.stack_frames_plain(src, t, k, dtype, h, w, s2d)
                torch.cuda.synchronize()
                check(got.shape == shape and got.dtype == dtype,
                      f"stack_frames {layout} {dtype} shape "
                      f"{tuple(got.shape)}")
                check(torch.equal(got, want),
                      f"stack_frames {layout} {dtype} {label}")
                errs.append((got.float() - want.float()).abs().max().item())
                print(f"stack_frames {layout} {dtype} {label}: exact",
                      flush=True)
    # shapes the kernel's 16-byte pieces do not tile (K=3, an odd width, a
    # misaligned view) take its any-shape kernel: exact all the same
    misaligned = obs[:5].flatten()[1:1 + 4 * window * h * w].view(
        4, window, h, w)
    odd_cases = [(obs[:4], 3, h, w, s2d, dtype)
                 for s2d in (False, True)
                 for dtype in (torch.float32, torch.bfloat16)]
    odd_cases += [(obs[:4], k, h, w - 1, False, torch.bfloat16),
                  (misaligned, k, h, w, True, torch.bfloat16)]
    for src, kk, hh, ww, s2d, dtype in odd_cases:
        got = rk.stack_frames_cuda(src, t, kk, dtype, hh, ww, s2d)
        want = rk.stack_frames_plain(src, t, kk, dtype, hh, ww, s2d)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"stack_frames K={kk} {hh}x{ww} "
              f"space_to_depth={s2d} {dtype}")
    print(f"stack_frames any-shape kernel ({len(odd_cases)} cases): exact",
          flush=True)
    out_bytes = batch * t * h * w * k * 2
    bound_ms = (obs.numel() + out_bytes) / HBM_BYTES_PER_S * 1e3
    # the main path decodes into the space-to-depth layout in bf16
    results["stack_frames"] = dict(
        max_abs_err=float(max(errs)),
        ms=cuda_ms(lambda: rk.stack_frames_cuda(obs, t, k, torch.bfloat16,
                                                h, w, True)),
        plain_ms=cuda_ms(lambda: rk.stack_frames_plain(obs, t, k,
                                                       torch.bfloat16, h, w,
                                                       True)),
        b2b_ms=b2b_ms(lambda i: rk.stack_frames_cuda(obs, t, k,
                                                      torch.bfloat16, h, w,
                                                      True)),
        b2b_after_gather_ms=after_gather, library_ms=None,
        bound_ms=bound_ms, bound_by="bytes")
    print(f"stack_frames bf16 space-to-depth: back to back "
          f"{results['stack_frames']['b2b_ms']:.4f} ms alone, "
          f"{after_gather:.4f} ms right after a gather", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for s2d, layout in ((False, "standard"), (True, "space-to-depth")):
            ms = cuda_ms(lambda: rk.stack_frames_cuda(obs, t, k, dtype, h, w,
                                                      s2d))
            bound = (obs.numel() + out_bytes // 2 * dtype.itemsize) \
                / HBM_BYTES_PER_S * 1e3
            print(f"stack_frames {layout} {dtype}: kernel {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f}% of it)",
                  flush=True)
    return results


def _lstm_inputs(dev, shape, dtype, seed):
    """xpb, wh, c0, h0 and the cotangents dhseq, dc_fin, dh_fin."""
    import torch
    steps, batch, hidden = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*dims, scale=1.0):
        return (torch.randn(dims, generator=g, device=dev) * scale).to(dtype)

    return (randn(steps, batch, 4 * hidden),
            randn(hidden, 4 * hidden, scale=hidden ** -0.5),
            randn(batch, hidden, scale=0.5), randn(batch, hidden, scale=0.5),
            randn(steps, batch, hidden), randn(batch, hidden),
            randn(batch, hidden))


def _max_err(name, got, want, dtype_name) -> float:
    """Max |got - want| in f32; raises past LSTM_TOL."""
    atol, rtol = LSTM_TOL[dtype_name]
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name} shape {tuple(got.shape)}")
    err = (got - want).abs()
    check(bool(got.isfinite().all()), f"{name} not finite")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{name} ({dtype_name}): max err {err.max().item():.3e}")
    return err.max().item()


def lstm_check(dev, shape, dtype):
    """The three LSTM kernels against their plain versions on one input.
    The backward takes the kernel forward's residuals on both sides, so it
    is compared alone. Returns the max error per kernel."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    dname = str(dtype).removeprefix("torch.")
    xpb, wh, c0, h0, dhseq, dcfin, dhfin = _lstm_inputs(dev, shape, dtype, 7)
    got = lk.lstm_fwd_cuda(xpb, wh, c0, h0, save_residuals=True)
    want = lk.lstm_fwd_plain(xpb, wh, c0, h0, save_residuals=True)
    errs = {"lstm_fwd": max(_max_err(f"lstm_fwd {n}", a, b, dname)
                            for n, a, b in zip(("hseq", "cseq", "acts"),
                                               got, want))}
    lean_h, lean_c = lk.lstm_fwd_cuda(xpb, wh, c0, h0, save_residuals=False)
    check(torch.equal(lean_h, got[0]) and torch.equal(lean_c, got[1][-1]),
          f"lean forward differs from the residual forward at {shape}")
    errs["lstm_fwd_lean"] = max(
        _max_err("lstm_fwd_lean hseq", lean_h, want[0], dname),
        _max_err("lstm_fwd_lean c_fin", lean_c, want[1][-1], dname))
    hseq, cseq, acts = got
    bgot = lk.lstm_bwd_cuda(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin,
                            dhfin)
    bwant = lk.lstm_bwd_plain(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin,
                              dhfin)
    torch.cuda.synchronize()
    check(bgot[0].dtype == dtype and bgot[1].dtype == torch.float32,
          "lstm_bwd output types")
    errs["lstm_bwd"] = max(_max_err(f"lstm_bwd {n}", a, b, dname)
                           for n, a, b in zip(("dxpb", "dc0", "dh0"),
                                              (bgot[0], bgot[2], bgot[3]),
                                              (bwant[0], bwant[2], bwant[3])))
    dwh_err = (bgot[1] - bwant[1]).abs().max().item()
    dwh_rel = dwh_err / bwant[1].abs().max().item()
    check(bool(bgot[1].isfinite().all()) and dwh_rel <= DWH_REL[dname],
          f"lstm_bwd dWh ({dname}) at {shape}: relative err {dwh_rel:.3e}")
    errs["lstm_bwd"] = max(errs["lstm_bwd"], dwh_err)
    print(f"lstm kernels {dname} T,B,H={shape}: max err fwd "
          f"{errs['lstm_fwd']:.3e}, lean {errs['lstm_fwd_lean']:.3e} (equal "
          f"to the residual forward), bwd {errs['lstm_bwd']:.3e}, dWh "
          f"relative {dwh_rel:.3e}", flush=True)
    return errs


def lstm_bounds(shape, dtype_name):
    """(bound_ms, bound_by) per LSTM kernel: the larger of the bytes each
    input read once and each output written once over the memory rate, and
    the two recurrent products' operations (the backward's are two) over
    the peak rate of the input type."""
    steps, batch, hidden = shape
    e = 4 if dtype_name == "float32" else 2
    gates, seq, carry = steps * batch * 4 * hidden, steps * batch * hidden, \
        batch * hidden
    wh = hidden * 4 * hidden
    product = 2 * steps * batch * hidden * 4 * hidden
    work = {
        "lstm_fwd": ((gates + wh + 2 * carry + 2 * seq + gates) * e, product),
        "lstm_fwd_lean": ((gates + wh + 2 * carry + seq + carry) * e,
                          product),
        # dhseq, acts, cseq, hseq, Wh, c0, h0, dc_fin, dh_fin in; dxpb in
        # the storage type, dWh, dc0 and dh0 in f32 out
        "lstm_bwd": ((3 * seq + gates + wh + 4 * carry + gates) * e
                     + (wh + 2 * carry) * 4, 2 * product),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def lstm_kernel_checks(dev):
    """LSTM kernels vs plain versions (ragged small shapes, then the
    reference shape, f32 and bf16) and their times in bf16, the main
    path's type; f32 times printed beside."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    errs = {"lstm_fwd": 0.0, "lstm_fwd_lean": 0.0, "lstm_bwd": 0.0}
    for shape in (*LSTM_SMALL_SHAPES, LSTM_REF_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            for name, err in lstm_check(dev, shape, dtype).items():
                errs[name] = max(errs[name], err)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        xpb, wh, c0, h0, dhseq, dcfin, dhfin = _lstm_inputs(
            dev, LSTM_REF_SHAPE, dtype, 7)
        hseq, cseq, acts = lk.lstm_fwd_cuda(xpb, wh, c0, h0)
        bwd_args = (wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin)
        times = {
            "lstm_fwd": (lambda: lk.lstm_fwd_cuda(xpb, wh, c0, h0),
                         lambda: lk.lstm_fwd_plain(xpb, wh, c0, h0)),
            "lstm_fwd_lean": (
                lambda: lk.lstm_fwd_cuda(xpb, wh, c0, h0, False),
                lambda: lk.lstm_fwd_plain(xpb, wh, c0, h0, False)),
            "lstm_bwd": (lambda: lk.lstm_bwd_cuda(*bwd_args),
                         lambda: lk.lstm_bwd_plain(*bwd_args)),
        }
        bounds = lstm_bounds(LSTM_REF_SHAPE, dname)
        for name, (kernel, plain) in times.items():
            r = dict(max_abs_err=errs[name], ms=cuda_ms(kernel),
                     b2b_ms=b2b_ms(lambda i: kernel()),
                     plain_ms=cuda_ms(plain, runs=10), library_ms=None,
                     bound_ms=bounds[name][0], bound_by=bounds[name][1])
            print(f"{name} {dname} T,B,H={LSTM_REF_SHAPE}: kernel "
                  f"{r['ms']:.4f} ms (back to back {r['b2b_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})",
                  flush=True)
            if dtype == torch.bfloat16:
                results[name] = r
    return results


def lstm_layer_yardstick(dev):
    """cuDNN's nn.LSTM against the port's LSTM layer (input projection by
    torch.matmul + the fused scan kernels), forward + backward, bf16, at
    the learner's widths. A yardstick only: the port never calls cuDNN's
    LSTM, and no single PyTorch call computes the scan alone."""
    import torch
    from r2d2_tpu_torch.ops.lstm_kernels import lstm_scan
    batch, steps, dim, hidden = 128, 55, 1042, 512
    g = torch.Generator(device=dev).manual_seed(11)

    def param(*dims, scale):
        return (torch.randn(dims, generator=g, device=dev) * scale).to(
            torch.bfloat16).requires_grad_(True)

    x = param(batch, steps, dim, scale=1.0)
    wi = param(dim, 4 * hidden, scale=dim ** -0.5)
    wh = param(hidden, 4 * hidden, scale=hidden ** -0.5)
    bias = param(4 * hidden, scale=0.1)
    zeros = torch.zeros(batch, hidden, device=dev, dtype=torch.bfloat16)
    dout = torch.randn(batch, steps, hidden, generator=g, device=dev).to(
        torch.bfloat16)

    def port():
        xpb = (x @ wi + bias).transpose(0, 1).contiguous()
        hseq, _ = lstm_scan(xpb, wh, zeros, zeros)
        torch.autograd.backward(hseq.transpose(0, 1), dout)

    cudnn = torch.nn.LSTM(dim, hidden, batch_first=True).to(dev,
                                                            torch.bfloat16)
    cudnn.flatten_parameters()

    def library():
        out, _ = cudnn(x, (zeros[None], zeros[None]))
        torch.autograd.backward(out, dout)

    port_ms, cudnn_ms = cuda_ms(port, runs=20), cuda_ms(library, runs=20)
    print(f"LSTM layer forward+backward (B={batch}, T={steps}, D={dim}, "
          f"H={hidden}, bf16), yardstick: port (matmul + lstm_fwd + "
          f"lstm_bwd) {port_ms:.4f} ms, cuDNN nn.LSTM {cudnn_ms:.4f} ms",
          flush=True)


def phase_conv_layouts(dev):
    """The first conv in each input layout it could take, bf16 and f32,
    forward + weight gradient at the reference frames
    (r2d2_tpu_torch/tools/conv_layouts.py)."""
    from r2d2_tpu_torch.tools import conv_layouts
    err = conv_layouts.check_layouts_agree(dev)
    conv_layouts.print_results(conv_layouts.measure(dev))
    print(f"conv layouts agree to {err:.3e} (f32)", flush=True)


def phase_kernels(dev):
    results = replay_kernel_checks(dev)
    results.update(lstm_kernel_checks(dev))
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms (back to back "
              f"{r['b2b_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})", flush=True)
    lstm_layer_yardstick(dev)
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


def _filled_replay(cfg, device, blocks):
    from r2d2_tpu_torch.replay.device_replay import (replay_add_many,
                                                     replay_init)
    from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
    spec = ReplaySpec.from_config(cfg, device)
    rs = replay_init(spec, device)
    for i in range(0, len(blocks), 25):
        replay_add_many(spec, rs, stack_blocks(blocks[i:i + 25]))
    return spec, rs


def _learner(cfg, device, spec, action_dim, seed=0):
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_learner_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    net = NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    ts = create_train_state(net, cfg.optim, seed, cfg.network.use_double)
    return ts, make_learner_step(net, spec, cfg.optim, cfg.network.use_double)


def phase_small_step_vs_cpu(dev, overrides, label):
    """Two f32 learner steps at a small shape: card (kernels) vs CPU (plain
    versions) on the same replay, weights and jitter. Tolerance: rtol 1e-4
    on the loss and the tree (different conv/matmul algorithms and the LSTM
    kernels sum in other orders; TF32 is off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    cfg = _tiny_config().replace(**overrides)
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    rng = np.random.default_rng(1)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    uniforms = torch.rand((2, spec.batch_size),
                          generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in (torch.device("cpu"), dev):
        spec, rs = _filled_replay(cfg, device, blocks)
        ts, step = _learner(cfg, device, spec, 18)
        _reset_counts()
        losses = []
        for u in uniforms:
            ts, rs, m = step(ts, rs, u.to(device))
            losses.append(float(m["loss"]))
        runs[device.type] = (losses, rs.tree.cpu(), _counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4,
                               atol=1e-6)
    check(not any(runs["cpu"][2].values()), f"CPU launched {runs['cpu'][2]}")
    fused = overrides.get("network.pallas_lstm") == "on"
    double = overrides.get("network.use_double", False)
    steps = len(uniforms)
    want = {"gather_windows": steps, "stack_frames": steps,
            "lstm_fwd": steps if fused else 0,
            "lstm_fwd_lean": steps if fused and double else 0,
            "lstm_bwd": steps if fused else 0}
    check(runs["cuda"][2] == want, f"{label}: launches {runs['cuda'][2]}")
    print(f"small learner step ({label}), card vs CPU: losses "
          f"{runs['cuda'][0]} vs {runs['cpu'][0]}, launches "
          f"{runs['cuda'][2]}", flush=True)


REF_PATHS = {   # label: overrides of the reference configuration
    "default": {},
    "double": {"network.use_double": True},
    "fused_double": {"network.use_double": True,
                     "network.pallas_lstm": "on"},
}


def _profile(step, ts, rs) -> float:
    """torch.profiler over 3 steps: prints the top ops by device time and
    returns the device's busy ms per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            ts, rs, _ = step(ts, rs)
        torch.cuda.synchronize()
    events = p.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=20),
          flush=True)
    # what cuDNN did with a 4-channel first conv: a layout conversion and
    # an f32 implicit GEMM
    fallback = [f"{e.key[:100]} {e.self_device_time_total / 3e3:.3f} ms"
                for e in events if e.device_type == DeviceType.CUDA
                and FALLBACK_KERNELS.search(e.key)]
    print(f"first-conv fallback kernels: {fallback or 'none'}", flush=True)
    # the sampler's int64 block indices reach the gather as they are: no
    # cast (a copy kernel) runs right before it
    kernels = sorted((e for e in p.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    before = {kernels[i - 1].name[:100] for i, e in enumerate(kernels)
              if i and "gather_windows" in e.name}
    print(f"kernels right before gather_windows: {sorted(before)}",
          flush=True)
    check(before and not any("copy" in name for name in before),
          f"a copy runs before gather_windows: {before}")
    # the device's own events only (operator rows repeat their kernels)
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 3e3


def phase_reference_step(dev, profile: bool):
    """The three REF_PATHS over one filled replay, each timed in two
    windows of 10 steps, in turns (a b c c b a)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block

    base = Config().replace(**{"replay.capacity": REF_CAPACITY})
    spec = ReplaySpec.from_config(base, dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    spec, rs = _filled_replay(base, dev, blocks)
    del blocks
    torch.cuda.synchronize()
    print(f"reference replay: {spec.num_blocks} blocks, capacity "
          f"{REF_CAPACITY} steps (cut from 500,000), ring "
          f"{spec.device_ring_bytes / 1e9:.2f} GB, filled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    learners = {}
    for label, overrides in REF_PATHS.items():
        ts, step = _learner(base.replace(**overrides), dev, spec, 18)
        check(ts.params.compute_dtype == torch.bfloat16, "bf16 on CUDA")
        check(ts.params.lstm.fused == ("network.pallas_lstm" in overrides),
              f"{label}: LSTM path")
        for _ in range(3):
            ts, rs, m = step(ts, rs)
        learners[label] = [ts, step]
    torch.cuda.synchronize()

    window, out = 10, {label: {"step_ms": [], "losses": [], "peak_mem_gb": 0.0}
                       for label in REF_PATHS}
    order = list(REF_PATHS) + list(reversed(REF_PATHS))
    for label in order:
        ts, step = learners[label]
        overrides = REF_PATHS[label]
        _reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        t0 = time.perf_counter()
        for _ in range(window):
            ts, rs, m = step(ts, rs)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _counts()
        fused = "network.pallas_lstm" in overrides
        want = {"gather_windows": window, "stack_frames": window,
                "lstm_fwd": window if fused else 0,
                "lstm_fwd_lean": window if fused else 0,
                "lstm_bwd": window if fused else 0}
        # one decode per step feeds every unroll of the step
        check(launches == want, f"{label}: launches {launches}")
        r = out[label]
        r["step_ms"].append(dt / window * 1e3)
        r["losses"] += [float(x) for x in losses]
        r["peak_mem_gb"] = max(r["peak_mem_gb"],
                               torch.cuda.max_memory_allocated(dev) / 1e9)
        learners[label][0] = ts
    for label, r in out.items():
        losses = r.pop("losses")
        check(all(math.isfinite(x) for x in losses), f"{label}: {losses}")
        r.update(steps=len(losses), loss_first=losses[0],
                 loss_last=losses[-1],
                 seq_updates_per_s=[spec.batch_size * 1e3 / ms
                                    for ms in r["step_ms"]])
        print(f"reference learner step {label}: " + json.dumps(r),
              flush=True)
    if profile:
        # busy time under the profiler against the unprofiled step time
        # (the profiler slows the host, not the device)
        for label, (ts, step) in learners.items():
            busy = _profile(step, ts, rs)
            step_ms = statistics.mean(out[label]["step_ms"])
            print(f"profile {label}: device busy {busy:.3f} ms/step, idle "
                  f"share {max(0.0, 1 - busy / step_ms):.3f} of the timed "
                  f"{step_ms:.3f} ms/step", flush=True)
    return out


def phase_cli(dev, extra, label):
    import torch
    from r2d2_tpu_torch.cli import train
    steps = 5
    _reset_counts()
    summary = train.main([
        "--env.game_name=Fake", "--replay.capacity=20000",
        "--replay.learning_starts=400",
        "--replay.max_env_steps_per_train_step=4", f"--max-steps={steps}",
        *extra])
    torch.cuda.synchronize()
    launches = _counts()
    check(summary["steps"] == steps
          and summary["device"].startswith("cuda"), summary["device"])
    check(all(math.isfinite(x) for x in summary["losses"]), summary)
    fused = "--network.pallas_lstm=on" in extra
    want = {"gather_windows": steps, "stack_frames": steps,
            "lstm_fwd": steps if fused else 0,
            "lstm_fwd_lean": steps if fused else 0,
            "lstm_bwd": steps if fused else 0}
    check(launches == want, f"cli.train {label}: launches {launches}")
    print(f"cli.train on the card ({label}): {steps} steps, launches "
          f"{launches}", flush=True)
    return launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    dev = torch.device("cuda", 0)

    phase_versions()
    phase_build()
    timings = phase_kernels(dev)
    phase_conv_layouts(dev)
    phase_small_step_vs_cpu(dev, {}, "default")
    phase_small_step_vs_cpu(dev, {"network.pallas_lstm": "on",
                                  "network.use_double": True},
                            "pallas_lstm on, double DQN")
    phase_reference_step(dev, "--profile" in argv)
    launches = phase_cli(dev, [], "default")
    launches.update({name: n for name, n in
                     phase_cli(dev, FUSED_ARGS, "pallas_lstm on, double DQN")
                     .items() if name.startswith("lstm")})
    launches["gather_windows_padded"] = phase_cli(
        dev, PADDED_ARGS, "padded storage")["gather_windows"]

    source = {name: KERNEL_SOURCES["lstm_kernels" if name.startswith("lstm")
                                   else "replay_kernels"] for name in timings}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    b2b_ms=r["b2b_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])
               for name, r in timings.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
