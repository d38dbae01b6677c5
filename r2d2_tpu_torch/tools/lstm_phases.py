"""Where a step of the LSTM scan kernels goes: per-phase device time.

    python -m r2d2_tpu_torch.tools.lstm_phases [--steps 55 --batch 128
                                               --hidden 512]

Builds a copy of ``csrc/lstm_kernels.cu`` in which thread 0 of every block
reads the device's ns clock (``%globaltimer``) at the phase boundaries of
each time step and sums the spans, runs the residual forward, the lean
forward and the backward once in bf16 and in f32, and prints one JSON line
per kernel with the mean and max over blocks of each phase, in us per time
step. Forward phases: the wait at the batch-tile slot's barrier, staging
the tile's rows of h_{t-1} into shared memory, the product, then the gate
math, the stores of h_t, the arrive and the residual stores. Backward phases, per time step: gate
grads + arriving at the batch-tile group's barrier, the wait (with the grid
barrier before dWh), the dh product; and the dWh product after the scan,
timed once and divided by T like the rest. Beside the phases, each
kernel's device time per launch, built from the unmodified source, over 20
launches back to back between two CUDA events (``device_ms``: no host gap
between launches, unlike one launch timed alone). The kernels that
the port runs are built from the unmodified source; this copy is built
beside them under ``build/`` and is used by nothing else. Needs a CUDA
card.
"""

import argparse
import ctypes
import json
import subprocess
import sys

STAMP = "{{ unsigned long long x_ = now_ns(); ph[{i}] += x_ - tp; tp = x_; }}\n"
SAVE = ("  if (threadIdx.x == 0) for (int i = 0; i < 4; ++i) "
        "g_phase[blockIdx.x][i] = ph[i];\n")
START = "  unsigned long long ph[4] = {0, 0, 0, 0}, tp = now_ns();\n"
PHASES = {"fwd": ("wait", "stage", "product", "epilogue_stores_arrive"),
          "bwd": ("gate_grads_arrive", "wait", "dh", "dwh_tail")}
MAX_BLOCKS = 4096
BACK_TO_BACK = 20

# (anchor in csrc/lstm_kernels.cu, text that replaces it)
EDITS = (
    ("namespace {\n",
     f"__device__ unsigned long long g_phase[{MAX_BLOCKS}][4];\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\nnamespace {\n"),
    # forward: wait, stage h_{t-1} rows, product, then the gate math, the
    # stores and the arrive to the end of the step (per tile where a block
    # walks several: a tile's epilogue then counts into the next one's stage)
    ("  for (int t = 0; t < steps; ++t) {\n    if (t > 0) {\n",
     START + "  for (int t = 0; t < steps; ++t) {\n    if (t > 0) {\n"),
    ("(unsigned int)t * groups);\n    }\n",
     "(unsigned int)t * groups);\n    }\n" + STAMP.format(i=0)),
    ("h_s, stride);\n      float pre[2][4];\n",
     "h_s, stride);\n" + STAMP.format(i=1) + "      float pre[2][4];\n"),
    ("      fwd_product<T>(h_s, w_s, stride, kp, wreg, red_s, pre);\n",
     "      fwd_product<T>(h_s, w_s, stride, kp, wreg, red_s, pre);\n"
     + STAMP.format(i=2)),
    ("  }  // next forward step\n",
     STAMP.format(i=3) + "  }  // next forward step\n" + SAVE),
    # backward
    ("  for (int t = steps - 1; t >= 0; --t) {\n",
     START + "  for (int t = steps - 1; t >= 0; --t) {\n"),
    ("    grid_arrive(barrier + slot);\n",
     "    grid_arrive(barrier + slot);\n" + STAMP.format(i=0)),
    ("(steps - t) * groups);\n",
     "(steps - t) * groups);\n" + STAMP.format(i=1)),
    ("  }  // next step\n", STAMP.format(i=2) + "  }  // next step\n"),
    ("  grid_wait(barrier + slots, gridDim.x);\n",
     "  grid_wait(barrier + slots, gridDim.x);\n" + STAMP.format(i=1)),
    ("  }  // dWh tiles\n}\n",
     "  }  // dWh tiles\n" + STAMP.format(i=3) + SAVE + "}\n"),
)


def instrumented_source(source: str) -> str:
    """The kernel source with the phase clocks; raises if the kernel no
    longer has the anchors they go in at."""
    for anchor, text in EDITS:
        if source.count(anchor) != 1:
            raise ValueError("lstm_kernels.cu changed: anchor "
                             f"{anchor!r} found {source.count(anchor)} times")
        source = source.replace(anchor, text)
    return source + ('\nextern "C" int read_phases(void* out) {\n'
                     "  return (int)cudaMemcpyFromSymbol(out, g_phase, "
                     "sizeof(g_phase));\n}\n")


def _library():
    from r2d2_tpu_torch.ops import _build, lstm_kernels
    src = _build.BUILD_DIR / "lstm_phases.cu"
    lib_path = _build.BUILD_DIR / "liblstm_phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source(
        (_build.CSRC / "lstm_kernels.cu").read_text()))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in lstm_kernels._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_phases.argtypes = [ctypes.c_void_p]
    lib.read_phases.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    import numpy as np
    import torch
    from r2d2_tpu_torch.ops import lstm_kernels as lk

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=55)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--hidden", type=int, default=512)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for geometry in (lk.fwd_geometry, lk.bwd_geometry):
            if geometry(args.batch, args.hidden, dtype,
                        sms).blocks > MAX_BLOCKS:
                raise SystemExit(f"more than {MAX_BLOCKS} blocks")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib, kept, port = _library(), lk._lib, lk._library()
    g = torch.Generator(device=dev).manual_seed(7)
    steps, batch, hidden = args.steps, args.batch, args.hidden
    try:
        for dtype in (torch.bfloat16, torch.float32):
            def randn(*dims, scale=1.0):
                return (torch.randn(dims, generator=g, device=dev)
                        * scale).to(dtype)
            xpb = randn(steps, batch, 4 * hidden)
            wh = randn(hidden, 4 * hidden, scale=hidden ** -0.5)
            c0, h0 = randn(batch, hidden, scale=0.5), randn(batch, hidden,
                                                            scale=0.5)
            res = lk.lstm_fwd_cuda(xpb, wh, c0, h0)
            cts = (randn(steps, batch, hidden), randn(batch, hidden),
                   randn(batch, hidden))
            runs = {"lstm_fwd": lambda: lk.lstm_fwd_cuda(xpb, wh, c0, h0),
                    "lstm_fwd_lean": lambda: lk.lstm_fwd_cuda(
                        xpb, wh, c0, h0, save_residuals=False),
                    "lstm_bwd": lambda: lk.lstm_bwd_cuda(wh, c0, h0, *res,
                                                         *cts)}
            for name, run in runs.items():
                lk._lib = port
                run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(BACK_TO_BACK):
                    run()
                end.record()
                end.synchronize()
                device_ms = start.elapsed_time(end) / BACK_TO_BACK
                lk._lib = lib
                run()
                torch.cuda.synchronize()
                buf = np.zeros((MAX_BLOCKS, 4), dtype=np.uint64)
                if lib.read_phases(buf.ctypes.data) != 0:
                    raise RuntimeError("reading the phase clocks failed")
                kind = "bwd" if name == "lstm_bwd" else "fwd"
                geometry = (lk.bwd_geometry if kind == "bwd"
                            else lk.fwd_geometry)
                blocks = geometry(batch, hidden, dtype, sms).blocks
                us = buf[:blocks].astype(np.float64) / 1e3 / steps
                keys = PHASES[kind]
                print(json.dumps({
                    "kernel": name, "dtype": str(dtype).split(".")[-1],
                    "T_B_H": [steps, batch, hidden], "card": smi,
                    "device_ms": round(device_ms, 4),
                    "us_per_step_mean": dict(zip(keys, us.mean(0).round(3)
                                                 .tolist())),
                    "us_per_step_max": dict(zip(keys, us.max(0).round(3)
                                                .tolist()))}), flush=True)
    finally:
        lk._lib = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
