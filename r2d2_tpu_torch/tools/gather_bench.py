"""The window gather on the card, back to back, beside an older kernel.

    python -m r2d2_tpu_torch.tools.gather_bench [--baseline SOURCE]
                                                [--repeats 5]

At the reference shape (B=128 windows of 58 frames from a ring of 250 rows
x 448 frames, 84x84 unpadded and 96x128 padded storage), the port's
``gather_windows``:
- checked against ``gather_windows_plain`` (exact) on int64 block
  indices, the sampler's dtype;
- timed back to back: a spin kernel holds the card while the host
  enqueues 20 launches, each on a fresh draw of (block_idx, start) so that
  no launch finds its ring bytes left in L2 by the one before; one CUDA
  event pair around the 20, divided by 20; the median of ``--repeats``;
- with the decode (``stack_frames``, bf16 space-to-depth, the main path's)
  right after each gather: events around each decode of the same 20-pair
  queue.
``--baseline`` names another ``replay_kernels.cu`` (an older checkout's)
whose ``gather_windows`` has the int32-only C interface (ring, block_idx,
start, out, batch, num_rows, row_len, frame_bytes, window, vec16, stream);
it is built beside the port's kernels under ``build/`` and timed the same
way on int32 copies of the draws, the two in turns (a b b a, twice).
Beside each, the host microseconds a call takes to enqueue (``host_us``:
wrapper and launch, with the card held busy). Prints one JSON line per
kernel and storage. Needs a CUDA card.
"""

import argparse
import ctypes
import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time

N_ROWS, ROW_LEN, BATCH, T, K = 250, 448, 128, 55, 4
WINDOW = T + K - 1
BACK_TO_BACK = 20
SPIN_CYCLES = 20_000_000       # ~10 ms: longer than enqueuing 20 launches
def _baseline_library(source: str):
    """Build an older replay_kernels.cu beside the port's kernels."""
    from pathlib import Path
    from r2d2_tpu_torch.ops import _build
    text = Path(source).read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libreplay_kernels_baseline-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), source], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.gather_windows.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int64] * 5 + [ctypes.c_int, ctypes.c_void_p]
    cdll.gather_windows.restype = ctypes.c_int
    return cdll


def _baseline_gather(cdll, ring, bi32, st32, window):
    import torch
    num_rows, row_len, h, w = ring.shape
    out = torch.empty((bi32.shape[0], window, h, w), dtype=torch.uint8,
                      device=ring.device)
    err = cdll.gather_windows(
        ring.data_ptr(), bi32.data_ptr(), st32.data_ptr(), out.data_ptr(),
        bi32.shape[0], num_rows, row_len, h * w, window,
        int(h * w % 16 == 0), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline gather_windows: CUDA error {err}")
    return out


def back_to_back_ms(gather, draws, ring, decode=None):
    """(gather ms, decode-after-gather ms or None) per launch: 20 gathers
    (each followed by a decode when ``decode``) enqueued behind a spin
    kernel, one event pair around them; the decode's own events around
    each decode."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    marks = []
    start.record()
    for bi, st in draws:
        out = gather(ring, bi, st, WINDOW)
        if decode is not None:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            decode(out)
            b.record()
            marks.append((a, b))
    end.record()
    end.synchronize()
    total = start.elapsed_time(end) / len(draws)
    if decode is None:
        return total, None
    dec = sum(a.elapsed_time(b) for a, b in marks) / len(draws)
    return total - dec, dec


def host_us(gather, draws, ring) -> float:
    """Host microseconds a call takes to enqueue (wrapper and launch): the
    host clock around the 20 calls behind a spin kernel, so that no call
    waits for the card; the median of 5."""
    import torch
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for bi, st in draws:
            gather(ring, bi, st, WINDOW)
        times.append((time.perf_counter() - t0) / len(draws) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", default=None,
                        help="an older replay_kernels.cu to time beside")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 2
    from r2d2_tpu_torch.ops import replay_kernels as rk
    from r2d2_tpu_torch.utils.device import configure_numerics
    configure_numerics()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    draws = [(torch.randint(0, N_ROWS, (BATCH,), generator=g, device=dev),
              torch.randint(0, ROW_LEN - WINDOW + 1, (BATCH,), generator=g,
                            device=dev, dtype=torch.int32))
             for _ in range(BACK_TO_BACK)]
    draws32 = [(bi.int(), st) for bi, st in draws]
    baseline = _baseline_library(args.baseline) if args.baseline else None
    names = ["gather_windows"] + (["baseline"] if baseline else [])
    uses = {"gather_windows": draws, "baseline": draws32}

    def gather_of(name):
        if name == "baseline":
            return functools.partial(_baseline_gather, baseline)
        return rk.gather_windows_cuda

    def decode(out):
        return rk.stack_frames_cuda(out, T, K, torch.bfloat16, 84, 84, True)

    for storage, (hs, ws) in (("unpadded", (84, 84)),
                              ("padded", (96, 128))):
        ring = torch.randint(0, 256, (N_ROWS, ROW_LEN, hs, ws), generator=g,
                             device=dev, dtype=torch.uint8)
        bound_ms = 2 * BATCH * WINDOW * hs * ws / 3.35e12 * 1e3
        runs = {name: {"ms": [], "decode_after_ms": []} for name in names}
        for name in names:
            bi, st = draws[0]
            want = rk.gather_windows_plain(ring, bi, st, WINDOW)
            if name == "baseline":
                got = _baseline_gather(baseline, ring, *draws32[0], WINDOW)
            else:
                got = rk.gather_windows_cuda(ring, bi, st, WINDOW)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} {storage}: differs from plain")
        order = names + names[::-1]
        for name in order * 2:
            gather, use = gather_of(name), uses[name]
            for _ in range(args.repeats):
                ms, _ = back_to_back_ms(gather, use, ring)
                runs[name]["ms"].append(ms)
            for _ in range(args.repeats):
                _, dec = back_to_back_ms(gather, use, ring, decode)
                runs[name]["decode_after_ms"].append(dec)
        host = {name: host_us(gather_of(name), uses[name], ring)
                for name in names}
        for name, r in runs.items():
            print(json.dumps({
                "kernel": name, "storage": storage, "device": smi,
                "b2b_ms": statistics.median(r["ms"]),
                "b2b_ms_min": min(r["ms"]), "bound_ms": bound_ms,
                "decode_after_gather_ms": statistics.median(
                    r["decode_after_ms"]),
                "host_us": host[name]}), flush=True)
        del ring
    return 0


if __name__ == "__main__":
    sys.exit(main())
