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
     B=128, H=512) in f32 and bf16 (tolerances at LSTM_TOL), and the f32
     reference shape again right after a new, smaller shape of the same
     kernels (LSTM_ORDER_SHAPE); CUDA-event
     times of kernel (timed alone, ``ms``, and back to back, ``b2b_ms``:
     20 launches enqueued behind a spin kernel, the gather on a fresh draw
     of indices each launch; the decode also right after a gather), plain
     version and the PyTorch library call, and the bound; cuDNN's nn.LSTM
     timed beside the port's LSTM layer as a yardstick; then the first
     conv timed in each input layout it could take
     (r2d2_tpu_torch/tools/conv_layouts.py);
  4. a small f32 learner step on the card against the same step on the
     CPU, on the default path and with network.pallas_lstm="on" and double
     DQN; one f32 step at the reference widths (B=128 x 40+10+5, 84x84x4,
     cnn 1024, LSTM 512, dueling) with every kernel on, card against the
     port's CPU step; then over a replay at the reference shape (bf16)
     filled by replay_add_many (capacity cut from 500,000 to 100,000
     steps): one CUDA graph of 4 learner steps against 4 eager steps from
     the same state and jitter, on the default and fused_double paths
     (the replayed graph's kernels counted by name in the profile), and
     the reference paths of r2d2_tpu_torch/tools/bench.py (default,
     double, fused_double, fused), each at 1 and at the resolved
     runtime.steps_per_dispatch, timed in turns. Host placement: the
     external-batch step on host-sampled batches, card against the CPU
     (small f32 on the default path and with pallas_lstm on and double
     DQN, one f32 step at the reference widths; rtol 1e-4), its one-step
     CUDA graph against eager steps (bf16, reference shape, 4 steps),
     and the host-placement Learner at the reference shape (bench's host
     path) with a block ingested after every step: seq-updates/s, the
     prefetch thread's sample and copy ms, busy and idle, launches per
     step (no gather; the decode and the LSTM kernels once a step),
     by count and by the profile's kernel names;
  5. the trainer through its entry point, r2d2_tpu_torch.cli.train, at the
     same widths for three dispatches of the resolved steps per dispatch
     (the eager warm-up, the capture, a replay), on the default path, with
     --network.pallas_lstm=on --network.use_double=true, and on padded
     storage (--replay.pallas_exact_gather=on, the exact-read gather's);
     the kernel launch counts of these runs go into the ``kernels`` line
     (the gather's two rows: unpadded and padded storage; a graph replay
     adds the launches its capture counted), each run under the profiler,
     whose kernel names must show the same launches; the host path's
     timed launches go beside them (``host_path_launches``).

TF32 is off throughout, as in training (utils/device.configure_numerics).
The last line is {"ok": true, "device": {...}}. ``--profile`` adds a
torch.profiler breakdown of three reference-shape steps of each path (a
graphed cell: one dispatch),
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
# a shape whose f32 kernels need less shared memory than the reference
# shape's, at an H no earlier check uses: launched between two reference
# launches, it must not shrink the kernels' shared-memory limit
LSTM_ORDER_SHAPE = (3, 8, 32)
FUSED_ARGS = ["--network.pallas_lstm=on", "--network.use_double=true"]
REF_WINDOW = 16                    # steps a timed window; a multiple of K
GRAPH_K = 4                        # the graph-vs-eager phase's dispatch
GRAPH_PATHS = ("default", "fused_double")
HOST_WINDOWS = 2                   # timed windows of the host path
REF_CPU_BLOCKS = 8                 # replay of the card-vs-CPU f32 step
# the device's kernel names -> the wrapper launch count each stands for
KERNEL_NAMES = {
    "gather_windows": re.compile(r"gather_windows_\w+_kernel"),
    "stack_frames": re.compile(r"stack_frames_\w*kernel"),
    "lstm_fwd": re.compile(r"lstm_fwd_kernel<[^>]*true>"),
    "lstm_fwd_lean": re.compile(r"lstm_fwd_kernel<[^>]*false>"),
    "lstm_bwd": re.compile(r"lstm_bwd_kernel"),
}
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
    from r2d2_tpu_torch.ops.launch_counts import reset_launch_counts
    reset_launch_counts()


def _counts() -> dict:
    from r2d2_tpu_torch.ops.launch_counts import launch_counts
    return launch_counts()


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
    reference shape, f32 and bf16; then LSTM_ORDER_SHAPE and the reference
    shape in f32) and their times in bf16, the main path's type; f32
    times printed beside."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk
    from r2d2_tpu_torch.utils.device import sm_count
    errs = {"lstm_fwd": 0.0, "lstm_fwd_lean": 0.0, "lstm_bwd": 0.0}
    for shape in (*LSTM_SMALL_SHAPES, LSTM_REF_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            for name, err in lstm_check(dev, shape, dtype).items():
                errs[name] = max(errs[name], err)
    # shared memory: the reference shape, a new smaller one, the reference
    # shape again (its launch setup cached), on the same instantiations
    sms = sm_count(dev)
    smem = [(lk.fwd_geometry(b, h, torch.float32, sms).smem,
             lk.bwd_geometry(b, h, torch.float32, sms).smem)
            for _, b, h in (LSTM_REF_SHAPE, LSTM_ORDER_SHAPE)]
    check(all(small < ref for ref, small in zip(*smem)), f"smem {smem}")
    for shape in (LSTM_ORDER_SHAPE, LSTM_REF_SHAPE):
        for name, err in lstm_check(dev, shape, torch.float32).items():
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


def phase_small_step_vs_cpu(dev, overrides, label):
    """Two f32 learner steps at a small shape: card (kernels) vs CPU (plain
    versions) on the same replay, weights and jitter. Tolerance: rtol 1e-4
    on the loss and the tree (different conv/matmul algorithms and the LSTM
    kernels sum in other orders; TF32 is off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.replay.synthetic import make_synthetic_block
    from r2d2_tpu_torch.tools import bench
    cfg = _tiny_config().replace(**overrides)
    spec = ReplaySpec.from_config(cfg, torch.device("cpu"))
    rng = np.random.default_rng(1)
    blocks = [make_synthetic_block(spec, rng) for _ in range(spec.num_blocks)]
    uniforms = torch.rand((2, spec.batch_size),
                          generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in (torch.device("cpu"), dev):
        spec, rs = bench.filled_replay(cfg, device, blocks)
        ts, step = bench.build_learner_step(cfg, device, spec)
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


def _want_launches(overrides: dict, steps: int) -> dict:
    """Launches per kernel in ``steps`` learner steps of a path: one
    gather and one decode a step (one decode feeds every unroll), and with
    the fused scan its forward and backward, plus the lean forward of the
    double-DQN target unroll."""
    double = bool(overrides.get("network.use_double", False))
    fused = overrides.get("network.pallas_lstm") == "on"
    return {"gather_windows": steps, "stack_frames": steps,
            "lstm_fwd": steps if fused else 0,
            "lstm_fwd_lean": steps if fused and double else 0,
            "lstm_bwd": steps if fused else 0}


def _profiled_kernel_counts(prof) -> dict:
    """Launches per kernel in a profile, read from the device's own kernel
    names (what a CUDA graph replay ran, which no wrapper counted)."""
    from r2d2_tpu_torch.tools import bench
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for event in bench.device_kernels(prof):
        for name, pattern in KERNEL_NAMES.items():
            if pattern.search(event.name):
                counts[name] += 1
    return counts


def _profile(dispatch, dispatches: int, steps: int) -> float:
    """torch.profiler over ``dispatches`` calls of ``dispatch()``: prints
    the top ops by device time and returns the device's busy ms per
    step."""
    from torch.autograd import DeviceType
    from r2d2_tpu_torch.tools import bench
    prof, _ = bench.profile_steps(dispatch, dispatches)
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=20),
          flush=True)
    # what cuDNN did with a 4-channel first conv: a layout conversion and
    # an f32 implicit GEMM
    fallback = [f"{e.key[:100]} {e.self_device_time_total / 1e3 / steps:.3f}"
                " ms" for e in events if e.device_type == DeviceType.CUDA
                and FALLBACK_KERNELS.search(e.key)]
    print(f"first-conv fallback kernels: {fallback or 'none'}", flush=True)
    # the sampler's int64 block indices reach the gather as they are: no
    # cast (a copy kernel) runs right before it
    kernels = bench.device_kernels(prof)
    before = {kernels[i - 1].name[:100] for i, e in enumerate(kernels)
              if i and "gather_windows" in e.name}
    print(f"kernels right before gather_windows: {sorted(before)}",
          flush=True)
    check(before and not any("copy" in name for name in before),
          f"a copy runs before gather_windows: {before}")
    return bench.device_busy_ms(prof) / steps


def phase_reference_replay(dev):
    """The reference configuration's replay, filled by replay_add_many
    with synthetic blocks (capacity cut from 500,000 to 100,000 steps)."""
    import torch
    from r2d2_tpu_torch.tools import bench
    base = bench.reference_config()
    t0 = time.perf_counter()
    blocks = bench.synthetic_blocks(base, base.num_blocks)
    spec, rs = bench.filled_replay(base, dev, blocks)
    torch.cuda.synchronize()
    print(f"reference replay: {spec.num_blocks} blocks, capacity "
          f"{bench.REF_CAPACITY} steps (cut from 500,000), ring "
          f"{spec.device_ring_bytes / 1e9:.2f} GB, filled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return base, spec, rs, blocks


def _clone_replay(rs):
    import dataclasses
    import torch
    return dataclasses.replace(rs, **{
        f.name: getattr(rs, f.name).clone() for f in dataclasses.fields(rs)
        if torch.is_tensor(getattr(rs, f.name))})


def phase_graph_vs_eager(dev, base, spec, rs):
    """One CUDA graph of GRAPH_K steps against GRAPH_K eager single steps
    at the reference shape (bf16), on GRAPH_PATHS: the same weights, each
    on its own copy of one replay, the same injected (K, B) jitter, three
    dispatches (the eager warm-up, the capture and its first replay, a
    second replay), then a fourth with each side drawing its jitter from
    its own generator. Losses and tree within rtol 1e-4: the two runs take
    the same kernels, but cuDNN's weight gradients and the LSTM backward's
    dWh sum in an order that may differ between runs. The second replay
    runs under the profiler: every kernel of the path ran GRAPH_K times in
    it, by the device's kernel names, and the launch counts that the
    graph adds per replay say the same."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    uniforms = torch.rand((3, GRAPH_K, spec.batch_size),
                          generator=torch.Generator().manual_seed(5)).to(dev)
    for label in GRAPH_PATHS:
        overrides = bench.PATHS[label]
        cfg = base.replace(**overrides)
        rs_graph, rs_eager = _clone_replay(rs), _clone_replay(rs)
        ts_graph, multi = bench.build_learner_step(cfg, dev, spec,
                                                   GRAPH_K)
        ts_eager, single = bench.build_learner_step(cfg, dev, spec)
        want = _want_launches(overrides, GRAPH_K)
        for d, u in enumerate(uniforms):
            _reset_counts()
            if d == 2:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _, _, m = multi(ts_graph, rs_graph, u)
                    torch.cuda.synchronize()
                seen = _profiled_kernel_counts(prof)
                check(seen == want, f"graph {label}: the profile shows "
                      f"{seen}, want {want}")
            else:
                _, _, m = multi(ts_graph, rs_graph, u)
            counted = _counts()
            check(counted == want, f"graph {label} dispatch {d}: launches "
                  f"{counted}, want {want}")
            eager = torch.stack([single(ts_eager, rs_eager, u[k])[2]["loss"]
                                 for k in range(GRAPH_K)])
            got, ref = m["loss"].cpu().numpy(), eager.cpu().numpy()
            check(m["loss"].shape == (GRAPH_K,) and np.isfinite(got).all(),
                  f"graph {label}: losses {got}")
            np.testing.assert_allclose(got, ref, rtol=1e-4)
            np.testing.assert_allclose(rs_graph.tree.cpu().numpy(),
                                       rs_eager.tree.cpu().numpy(),
                                       rtol=1e-4, atol=1e-6)
            print(f"graph vs eager ({label}, K={GRAPH_K}) dispatch {d}: "
                  f"losses {got.tolist()} vs {ref.tolist()}, max rel "
                  f"{float(np.max(np.abs(got - ref) / np.abs(ref))):.3e}, "
                  f"launches {counted}", flush=True)
        # a fourth dispatch on each side's own generator (seeded alike and
        # not drawn from so far): the graph's K draws of B are the jitter
        # chain of K single steps
        _, _, m = multi(ts_graph, rs_graph)
        eager = torch.stack([single(ts_eager, rs_eager)[2]["loss"]
                             for _ in range(GRAPH_K)])
        np.testing.assert_allclose(m["loss"].cpu().numpy(),
                                   eager.cpu().numpy(), rtol=1e-4)
        check(multi.graph is not None and ts_graph.step == 4 * GRAPH_K
              and int(ts_graph.step_count) == 4 * GRAPH_K,
              f"graph {label}: step {ts_graph.step}")
        print(f"graph vs eager ({label}): the replayed graph ran every "
              f"kernel {GRAPH_K} times by the profile: {seen}", flush=True)
        del rs_graph, rs_eager, multi, single, ts_graph, ts_eager
        torch.cuda.empty_cache()


def phase_reference_vs_cpu(dev):
    """One f32 learner step at the reference widths (84x84x4, cnn_out
    1024, LSTM 512, dueling, B=128 x 55 steps) with every kernel on
    (network.pallas_lstm="on"): the card against the port's CPU step (the
    plain versions) on the same replay of REF_CPU_BLOCKS blocks, weights
    and jitter. rtol 1e-4 on the loss, the grad norm and the tree: cuDNN,
    cuBLAS and the LSTM kernels sum in other orders than the CPU (TF32 is
    off)."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.tools import bench
    cfg = bench.reference_config(**{
        "replay.capacity": REF_CPU_BLOCKS * 400, "network.bf16": "off",
        "network.pallas_lstm": "on"})
    blocks = bench.synthetic_blocks(cfg, cfg.num_blocks, seed=3)
    uniform = torch.rand(cfg.replay.batch_size,
                         generator=torch.Generator().manual_seed(4))
    runs = {}
    for device in (torch.device("cpu"), dev):
        spec, rs = bench.filled_replay(cfg, device, blocks)
        ts, step = bench.build_learner_step(cfg, device, spec)
        _reset_counts()
        t0 = time.perf_counter()
        _, rs, m = step(ts, rs, uniform.to(device))
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        runs[device.type] = dict(
            loss=loss, grad_norm=norm, tree=rs.tree.cpu().numpy(),
            params={k: v.cpu() for k, v in ts.params.state_dict().items()},
            seconds=time.perf_counter() - t0, launches=_counts())
    cpu, card = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-4)
    np.testing.assert_allclose(card["grad_norm"], cpu["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(card["tree"], cpu["tree"], rtol=1e-4,
                               atol=1e-6)
    check(card["launches"] == _want_launches(
        {"network.pallas_lstm": "on"}, 1), f"launches {card['launches']}")
    check(not any(cpu["launches"].values()), "the CPU step launched")
    param_err = max(float((card["params"][k] - v).abs().max())
                    for k, v in cpu["params"].items())
    tree_rel = float(np.max(np.abs(card["tree"] - cpu["tree"])
                            / np.maximum(np.abs(cpu["tree"]), 1e-30)))
    print(f"reference-shape f32 step, card vs CPU (B="
          f"{cfg.replay.batch_size}, {REF_CPU_BLOCKS} blocks): loss "
          f"{card['loss']!r} vs {cpu['loss']!r} (rel "
          f"{abs(card['loss'] - cpu['loss']) / abs(cpu['loss']):.3e}), "
          f"grad norm {card['grad_norm']!r} vs {cpu['grad_norm']!r}, tree "
          f"max rel {tree_rel:.3e}, "
          f"params after Adam max abs {param_err:.3e}; CPU step "
          f"{cpu['seconds']:.1f} s, card step {card['seconds']:.2f} s",
          flush=True)


def phase_reference_step(dev, base, spec, rs, resolved_k: int,
                         profile: bool):
    """tools/bench.py's PATHS (default, double, fused_double, fused =
    single DQN with every kernel on) over one filled replay, each at K=1
    and at the resolved K (one CUDA graph of K steps), every cell timed in
    two windows of REF_WINDOW steps, in turns (a b .. z z .. b a); the
    launch counts of each window checked."""
    import torch
    from r2d2_tpu_torch.tools import bench
    ks = sorted({1, resolved_k})
    cells = {}
    for label, overrides in bench.PATHS.items():
        if label == bench.HOST_PATH:
            continue                    # phase_host_learner drives it
        for k in ks:
            cell = bench.Cell(label, k, base.replace(**overrides), dev,
                              spec, rs)
            params = cell.ts.params
            check(params.compute_dtype == torch.bfloat16, "bf16 on CUDA")
            check(params.lstm.fused == (overrides.get("network.pallas_lstm")
                                        == "on"), f"{label}: LSTM path")
            cells[label, k] = cell
    torch.cuda.synchronize()
    for key in list(cells) + list(reversed(list(cells))):
        _reset_counts()
        cells[key].window(rs, REF_WINDOW)
        launches = _counts()
        want = _want_launches(bench.PATHS[key[0]], REF_WINDOW)
        check(launches == want, f"{key}: launches {launches}, want {want}")
    out = {}
    for (label, k), cell in cells.items():
        if profile:
            dispatches = max(1, 3 // k)
            cell.busy_ms = _profile(lambda: cell.dispatch(rs), dispatches,
                                    dispatches * k)
        r = cell.result(spec.batch_size)
        out[label, k] = r
        print(f"reference learner step {label} K={k}: " + json.dumps(r),
              flush=True)
    return out


def _want_host_launches(cfg, steps: int) -> dict:
    """Launches per kernel in ``steps`` external-batch steps: the host
    gathers the windows, so no gather; the rest as on the device path."""
    return {**_want_launches({
        "network.pallas_lstm": cfg.network.pallas_lstm,
        "network.use_double": cfg.network.use_double}, steps),
        "gather_windows": 0}


def _host_batches(cfg, blocks, count: int, seed: int):
    """``count`` batches that a host replay (native sum tree) of ``blocks``
    samples, numpy."""
    import torch
    from r2d2_tpu_torch.replay.host_replay import HostReplay
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    host = HostReplay(ReplaySpec.from_config(cfg, torch.device("cpu")),
                      seed=seed)
    for block in blocks:
        host.add(block)
    return [host.sample()[0] for _ in range(count)]


def _device_batch(batch, device):
    import dataclasses
    import numpy as np
    import torch
    from r2d2_tpu_torch.replay.structs import SampleBatch
    return SampleBatch(**{f.name: torch.from_numpy(np.array(getattr(
        batch, f.name))).to(device) for f in dataclasses.fields(SampleBatch)})


def _external_step(cfg, device):
    """(train state from seed 0, make_external_batch_step) on ``device``:
    on CUDA a one-step CUDA graph, whose ``body`` is the eager step."""
    import torch
    from r2d2_tpu_torch.learner.train_step import (create_train_state,
                                                   make_external_batch_step)
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.replay.structs import ReplaySpec
    from r2d2_tpu_torch.tools import bench
    net = NetworkApply(bench.ACTION_DIM, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    ts = create_train_state(net, cfg.optim, 0, cfg.network.use_double)
    spec = ReplaySpec.from_config(cfg, torch.device(device))
    return ts, make_external_batch_step(net, spec, cfg.optim,
                                        cfg.network.use_double)


def _host_metrics(m) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in m.items()}


def phase_external_vs_cpu(dev, cfg, blocks, steps: int, label: str):
    """make_external_batch_step on the card (the eager warm-up, then the
    one-step graph) against the port's CPU step on the same host-sampled
    batches from the same weights, f32: loss, grad norm and priorities
    within rtol 1e-4 (priorities also atol 1e-6, as the tree is held in
    the device path's check); no gather launches, the decode and the LSTM
    kernels once a step."""
    import numpy as np
    import torch
    batches = _host_batches(cfg, blocks, steps, seed=2)
    runs = {}
    for device in (torch.device("cpu"), dev):
        ts, step = _external_step(cfg, device)
        _reset_counts()
        t0 = time.perf_counter()
        out = [_host_metrics(step(ts, _device_batch(b, device))[1])
               for b in batches]
        runs[device.type] = (out, _counts(), time.perf_counter() - t0)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        check(np.isfinite(got["loss"]) and got["priorities"].shape
              == (cfg.replay.batch_size,), f"{label}: {got}")
        for name in ("loss", "grad_norm", "mean_q"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4)
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-4, atol=1e-6)
    check(not any(runs["cpu"][1].values()), f"CPU launched {runs['cpu'][1]}")
    want_launches = _want_host_launches(cfg, steps)
    check(runs["cuda"][1] == want_launches,
          f"external {label}: launches {runs['cuda'][1]}, want "
          f"{want_launches}")
    rel = max(float(np.max(np.abs(a["priorities"] - b["priorities"])
                           / np.abs(b["priorities"])))
              for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    print(f"external-batch step ({label}), card vs CPU, {steps} step(s): "
          f"losses {[float(m['loss']) for m in runs['cuda'][0]]} vs "
          f"{[float(m['loss']) for m in runs['cpu'][0]]}, priorities max "
          f"rel {rel:.3e}, launches {runs['cuda'][1]}; CPU "
          f"{runs['cpu'][2]:.1f} s", flush=True)


def phase_external_graph_vs_eager(dev, base, blocks):
    """The external-batch step as one CUDA graph of one step against eager
    steps (the graph's own body) from the same weights on the same
    GRAPH_K host batches, at the reference shape in bf16 with the host
    path's settings: losses, grad norms and priorities within rtol 1e-4
    (priorities atol 1e-6). The last replay runs under the profiler: the
    kernels by their device names once each, no gather."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    cfg = base.replace(**bench.PATHS[bench.HOST_PATH])
    batches = [_device_batch(b, dev)
               for b in _host_batches(cfg, blocks[:40], GRAPH_K, seed=4)]
    ts_graph, graphed = _external_step(cfg, dev)
    ts_eager, eager = _external_step(cfg, dev)
    counted = {}
    for i, batch in enumerate(batches):
        _reset_counts()
        if i == len(batches) - 1:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, m = graphed(ts_graph, batch)
                torch.cuda.synchronize()
            seen = _profiled_kernel_counts(prof)
            check(seen == _want_host_launches(cfg, 1),
                  f"external graph: the profile shows {seen}")
        else:
            _, m = graphed(ts_graph, batch)
        got = _host_metrics(m)
        counted = {k: counted.get(k, 0) + n for k, n in _counts().items()}
        want = _host_metrics(eager.body(ts_eager, batch))
        ts_eager.step += 1
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4)
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   rtol=1e-4, atol=1e-6)
        rel = np.abs(got["priorities"] - want["priorities"]) / np.abs(
            want["priorities"])
        print(f"external graph vs eager, step {i}: loss {float(got['loss'])}"
              f" vs {float(want['loss'])}, priorities max rel "
              f"{float(rel.max()):.3e}", flush=True)
    check(graphed.graph is not None and ts_graph.step == GRAPH_K
          and int(ts_graph.step_count) == GRAPH_K, "external graph steps")
    check(counted == _want_host_launches(cfg, GRAPH_K),
          f"external graph: launches {counted}")
    print(f"external graph vs eager ({GRAPH_K} steps, bf16 reference "
          f"shape): launches {counted}, the last replay's kernels by name "
          f"{seen}", flush=True)
    del batches, ts_graph, ts_eager, graphed, eager
    torch.cuda.empty_cache()


def _sample_alone_ms(host_replay, samples: int = 10) -> float:
    """Median ms of the host replay's sample into one preallocated batch
    with no other thread running: the gather's own pace."""
    import numpy as np
    from r2d2_tpu_torch.replay.host_replay import batch_layout
    from r2d2_tpu_torch.replay.structs import SampleBatch
    out = SampleBatch(**{name: np.zeros(shape, dtype) for name, (
        shape, dtype) in batch_layout(host_replay.spec).items()})
    times = []
    for _ in range(samples + 1):
        t0 = time.perf_counter()
        host_replay.sample(out=out)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_host_learner(dev, base, blocks) -> dict:
    """The host-placement Learner at the reference shape (tools/bench.py's
    host path: every kernel on, one step a dispatch) over a host ring of
    ``blocks``: 3 warm-up steps (the eager step, the capture, a replay),
    HOST_WINDOWS timed windows of REF_WINDOW steps with a block ingested
    after every step (so ``add`` races the prefetch thread's sample),
    each window's launch counts checked (no gather; the decode and the
    LSTM kernels once a step), then REF_WINDOW steps under the profiler,
    whose kernel names must say the same. Prints seq-updates/s, ms/step,
    the prefetch thread's sample and copy ms per batch, device busy and
    idle. Returns the timed windows' launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.tools import bench
    cfg = base.replace(**bench.PATHS[bench.HOST_PATH])
    t0 = time.perf_counter()
    learner = bench.host_learner(cfg, dev, blocks)
    fill_s = time.perf_counter() - t0
    try:
        check(learner.replay_state is None
              and learner.host_replay._native is not None
              and learner.steps_per_dispatch == 1, "host placement")
        losses = [learner.step()["loss"] for _ in range(3)]
        torch.cuda.synchronize()
        for kept in learner.timings.values():
            kept.clear()
        ms, total, fresh = [], {}, 0
        for _ in range(HOST_WINDOWS):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REF_WINDOW):
                losses.append(learner.step()["loss"])
                learner.ingest(blocks[fresh % len(blocks)])
                fresh += 1
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / REF_WINDOW)
            counted = _counts()
            want = _want_host_launches(cfg, REF_WINDOW)
            check(counted == want, f"host path: launches {counted}, want "
                  f"{want}")
            total = {k: total.get(k, 0) + n for k, n in counted.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REF_WINDOW):
                losses.append(learner.step()["loss"])
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3 / REF_WINDOW
        seen = _profiled_kernel_counts(prof)
        check(seen == _want_host_launches(cfg, REF_WINDOW),
              f"host path: the profile shows {seen}")
        values = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(values).all()), "host path: a loss is "
              "not finite")
        copies = sum(e.time_range.elapsed_us() for e in
                     bench.device_kernels(prof) if "HtoD" in e.name
                     ) / 1e3 / REF_WINDOW
        busy = bench.device_busy_ms(prof) / REF_WINDOW
        union = bench.device_union_ms(prof) / REF_WINDOW
        mean_ms = statistics.mean(ms)
        timings = learner.timings
        report = dict(
            path=bench.HOST_PATH, ms_per_step=ms,
            seq_updates_per_s=[cfg.replay.batch_size * 1e3 / x for x in ms],
            sample_ms=statistics.median(timings["sample_ms"]),
            h2d_ms=statistics.median(timings["h2d_ms"]),
            batches=len(timings["sample_ms"]),
            device_busy_ms_per_step=busy, device_union_ms_per_step=union,
            h2d_device_ms_per_step=copies, profiled_ms_per_step=profiled_ms,
            idle_share=1.0 - busy / mean_ms,
            idle_share_union=1.0 - union / mean_ms,
            launches_per_step={k: n / (HOST_WINDOWS * REF_WINDOW)
                               for k, n in total.items()},
            dropped_priority_updates=learner.dropped_priority_updates,
            host_ring_gb=learner.host_replay.obs.nbytes / 1e9,
            fill_s=fill_s)
    finally:
        learner.stop_background()
    check(not learner._bg_threads, "host path: a pipeline thread is left")
    report["sample_alone_ms"] = _sample_alone_ms(learner.host_replay)
    print(f"host-placement learner (reference shape): " + json.dumps(report),
          flush=True)
    pace = ("the host (its sample)" if report["sample_ms"]
            > report["device_union_ms_per_step"] else "the card")
    print(f"host path: sample {report['sample_ms']:.3f} ms a batch (alone,"
          f" no other thread running: {report['sample_alone_ms']:.3f}) "
          f"against {report['device_union_ms_per_step']:.3f} ms of device "
          f"time a step: {pace} sets the pace", flush=True)
    return total


def phase_cli(dev, extra, label, k):
    """cli.train on the card for three dispatches of the resolved K (the
    eager warm-up, the capture, a replay), under the profiler: the launch
    counts (a graph replay's added from its capture) must be what the
    device ran, by its kernel names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from r2d2_tpu_torch.cli import train
    steps = 3 * k
    _reset_counts()
    torch.cuda.synchronize()
    # the device's events only: tracing the host's ops of a whole run
    # would cost more than the run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = train.main([
            "--env.game_name=Fake", "--replay.capacity=20000",
            "--replay.learning_starts=400",
            "--replay.max_env_steps_per_train_step=4",
            f"--max-steps={steps}", *extra])
        torch.cuda.synchronize()
    launches = _counts()
    seen = _profiled_kernel_counts(prof)
    check(seen == {name: launches[name] for name in seen},
          f"cli.train {label}: the profile shows {seen}, counted "
          f"{launches}")
    check(summary["steps"] == steps
          and summary["device"].startswith("cuda"), summary["device"])
    check(len(summary["losses"]) == steps
          and all(math.isfinite(x) for x in summary["losses"]), summary)
    overrides = {"network.pallas_lstm": "on", "network.use_double": True} \
        if extra == FUSED_ARGS else {}
    want = _want_launches(overrides, steps)
    check(launches == want, f"cli.train {label}: launches {launches}")
    print(f"cli.train on the card ({label}): {steps} steps in dispatches "
          f"of {k}, launches {launches}, equal to the profile's kernel "
          "names", flush=True)
    return launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from r2d2_tpu_torch.config import RuntimeConfig
    from r2d2_tpu_torch.tools import bench
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    dev = torch.device("cuda", 0)
    resolved_k = RuntimeConfig().resolved_steps_per_dispatch(dev)

    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"{phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_versions()
    phase_build()
    done("build")
    timings = phase_kernels(dev)
    phase_conv_layouts(dev)
    done("kernels")
    phase_small_step_vs_cpu(dev, {}, "default")
    phase_small_step_vs_cpu(dev, {"network.pallas_lstm": "on",
                                  "network.use_double": True},
                            "pallas_lstm on, double DQN")
    phase_reference_vs_cpu(dev)
    small = _tiny_config()
    small_blocks = bench.synthetic_blocks(small, small.num_blocks, seed=1)
    phase_external_vs_cpu(dev, small, small_blocks, 2, "default")
    fused_small = small.replace(**{"network.pallas_lstm": "on",
                                   "network.use_double": True})
    phase_external_vs_cpu(dev, fused_small, small_blocks, 2,
                          "pallas_lstm on, double DQN")
    ref_f32 = bench.reference_config(**{
        "replay.capacity": REF_CPU_BLOCKS * 400, "network.bf16": "off",
        "network.pallas_lstm": "on"})
    phase_external_vs_cpu(dev, ref_f32, bench.synthetic_blocks(
        ref_f32, REF_CPU_BLOCKS, seed=3), 1, "reference widths, f32")
    done("card vs CPU")
    base, spec, rs, blocks = phase_reference_replay(dev)
    phase_graph_vs_eager(dev, base, spec, rs)
    phase_external_graph_vs_eager(dev, base, blocks)
    done("graph vs eager")
    phase_reference_step(dev, base, spec, rs, resolved_k,
                         "--profile" in argv)
    done("reference paths")
    del rs
    torch.cuda.empty_cache()
    host_launches = phase_host_learner(dev, base, blocks)
    del blocks
    done("host path")
    launches = phase_cli(dev, [], "default", resolved_k)
    launches.update({name: n for name, n in
                     phase_cli(dev, FUSED_ARGS, "pallas_lstm on, double DQN",
                               resolved_k).items()
                     if name.startswith("lstm")})
    launches["gather_windows_padded"] = phase_cli(
        dev, PADDED_ARGS, "padded storage", resolved_k)["gather_windows"]
    done("cli.train")

    source = {name: KERNEL_SOURCES["lstm_kernels" if name.startswith("lstm")
                                   else "replay_kernels"] for name in timings}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    b2b_ms=r["b2b_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    host_path_launches=host_launches.get(
                        name.replace("_padded", ""), 0))
               for name, r in timings.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
