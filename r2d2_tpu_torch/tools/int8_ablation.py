"""Where ``int8_linear``'s time goes: the kernel with a part taken out, and
at other launch geometries, back to back beside ``torch.matmul``.

    python -m r2d2_tpu_torch.tools.int8_ablation [--rows 32,64]
                                                 [--repeats 5]

Builds copies of ``csrc/quant_kernels.cu`` under ``build/`` (used by
nothing else), each with some of ``EDITS``:
- ``kernel``: the source as it is;
- ``no_stage``: the bf16 route stages no x (the products read whatever
  shared memory holds: a time, not a result);
- ``no_mma``: each tensor-core product replaced by an integer fold of its
  operands, so the weight loads, their widening and the B-fragment loads
  from shared memory stay;
- ``no_stage_no_mma``: both;
- ``w8s8``: blocks of 8 channel tiles (``kMaxWarps`` 8) in clusters of 8;
- ``w4s16`` and ``w8s16``: clusters of 16 blocks (``kMaxSplit`` 16, the
  non-portable size allowed) of 4 and 8 channel tiles.
At the quantized forward's dense layers (``chip_smoke.py`` 9a's, bf16 x;
the recurrent product also with f32 x) and each M of ``--rows``, every
copy is timed as ``chip_smoke.py`` times a kernel back to back (a spin
kernel holds the card while 20 launches are enqueued; one CUDA event pair
around them; the median of ``--repeats``), the ablations at the port's
plan and the others at their own geometry (fewer slices where K has fewer
64-k chunks), beside ``torch.matmul`` on the bf16 (f32) twin. Prints one
JSON line per layer, M and x type: microseconds per launch, and for the
copies that compute the product, the max abs error against the plain
version. Needs a CUDA card.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

BACK_TO_BACK = 20
SPIN_CYCLES = 20_000_000       # ~10 ms: longer than enqueuing 20 launches
LAYERS = (("torso.dense", 3136, 1024), ("lstm.input_proj", 1030, 2048),
          ("lstm.recurrent_kernel", 512, 2048), ("head.hidden", 512, 512))

_STAGE = """      unsigned char* xsb = reinterpret_cast<unsigned char*>(xs);
      if (xbytes == 16) {
        stage_rows<2, 16>(xb, xsb, ldx, M, K, kRows, k0, width);
      } else if (xbytes == 4) {
        stage_rows<2, 4>(xb, xsb, ldx, M, K, kRows, k0, width);
      } else {
        stage_rows_b16(static_cast<const __nv_bfloat16*>(xv), xs, ldx, M, K,
                       kRows, k0, width);
      }
      cp_async_wait_all();
"""
_MMA = """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
"""
_ATTR = ("        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "kMaxSmem);\n")
# name -> (anchor in csrc/quant_kernels.cu, text that replaces it)
EDITS = {
    "no_stage": (_STAGE, "      (void)xb;\n"),
    "no_mma": (_MMA, "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] "
                     "^ b0 ^ b1);\n"),
    "w8": ("constexpr int kMaxWarps = 4;", "constexpr int kMaxWarps = 8;"),
    "s16_split": ("constexpr int kMaxSplit = 8;",
                  "constexpr int kMaxSplit = 16;"),
    "s16_attr": (_ATTR, _ATTR + "    cudaFuncSetAttribute(kernel, "
                 "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"),
}
# copy -> (edits, channel tiles a block, K slices; None: the port's plan)
COPIES = {
    "kernel": ((), None),
    "no_stage": (("no_stage",), None),
    "no_mma": (("no_mma",), None),
    "no_stage_no_mma": (("no_stage", "no_mma"), None),
    "w8s8": (("w8",), (8, 8)),
    "w4s16": (("s16_split", "s16_attr"), (4, 16)),
    "w8s16": (("w8", "s16_split", "s16_attr"), (8, 16)),
}
ABLATED = ("no_stage", "no_mma", "no_stage_no_mma")


def edited_source(source: str, edits) -> str:
    """The kernel source with ``edits`` (names of EDITS); raises if the
    kernel no longer has an anchor."""
    for name in edits:
        anchor, text = EDITS[name]
        if source.count(anchor) != 1:
            raise ValueError(f"quant_kernels.cu changed: anchor of {name} "
                             f"found {source.count(anchor)} times")
        source = source.replace(anchor, text)
    return source


def _build_copy(name: str):
    from r2d2_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"int8_ablation_{name}.cu"
    lib_path = _build.BUILD_DIR / f"libint8_ablation_{name}.so"
    src.write_text(edited_source((_build.CSRC / "quant_kernels.cu")
                                 .read_text(), COPIES[name][0]))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.int8_linear.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.int8_linear.restype = ctypes.c_int
    return lib


def geometry(m, n, k, sms, x_f32, tiles_split):
    """(channel tiles a block, K slices, channel blocks, chunks a round):
    the port's plan, or the given tiles and slices with the most chunks a
    round that fit."""
    from r2d2_tpu_torch.ops import quant_kernels as qk
    plan = qk.int8_linear_plan(m, n, k, sms, x_f32)
    if tiles_split is None:
        return plan.warps, *plan.grid, plan.chunks
    warps, split = tiles_split
    total = -(-k // qk.CHUNK)
    split = min(split, total)
    chunks = min(qk.MAX_CHUNKS, -(-total // split))
    while chunks > 1 and qk._smem_bytes(plan.rows, warps, split, chunks,
                                        x_f32) > qk.MAX_SMEM:
        chunks -= 1
    return warps, split, -(-n // (16 * warps)), chunks


def b2b_us(fn, repeats: int) -> float:
    import torch
    fn(0)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(BACK_TO_BACK):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / BACK_TO_BACK)
    return statistics.median(times)


def main(argv=None) -> int:
    import torch
    from r2d2_tpu_torch.models.network import quantize_leaf_int8
    from r2d2_tpu_torch.ops import quant_kernels as qk
    from r2d2_tpu_torch.utils.device import sm_count, stream_handle

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", default="32,64")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = sm_count(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(COPIES)) as pool:
        libs = dict(zip(COPIES, pool.map(_build_copy, COPIES)))
    g = torch.Generator().manual_seed(0)
    cases = [(layer, m, torch.bfloat16) for layer in LAYERS
             for m in map(int, args.rows.split(","))]
    cases.append((LAYERS[2], 64, torch.float32))
    for (name, k, n), m, dt in cases:
        # a trained layer's scale, as chip_smoke.py 9a makes its layers
        leaf = quantize_leaf_int8(torch.randn(n, k, generator=g) / k ** 0.5,
                                  axis=0)
        q = qk.pad_int8_weight(leaf["q"]).to(dev)
        scale = leaf["scale"].reshape(-1).to(dev)
        bias = (torch.randn(n, generator=g) * 0.1).to(dev)
        twin = (leaf["q"].float() * leaf["scale"]).to(dev, dt)
        xs = [torch.randn(m, k, generator=g).to(dev, dt)
              for _ in range(BACK_TO_BACK)]
        y = torch.empty((m, n), dtype=dt, device=dev)
        want = qk.int8_linear_plain(xs[0], q, scale, bias, dt).float()
        us, err = {}, {}
        for copy, (_, tiles_split) in COPIES.items():
            geo = geometry(m, n, k, sms, dt == torch.float32, tiles_split)

            def launch(i, lib=libs[copy], geo=geo):
                code = lib.int8_linear(
                    xs[i].data_ptr(), int(dt == torch.bfloat16),
                    q.data_ptr(), q.shape[1], scale.data_ptr(),
                    bias.data_ptr(), y.data_ptr(), int(dt == torch.bfloat16),
                    m, n, k, *geo, stream_handle(dev))
                if code != 0:
                    raise RuntimeError(f"{copy}: CUDA error {code}")
            us[copy] = round(b2b_us(launch, args.repeats), 3)
            if copy not in ABLATED:
                launch(0)
                err[copy] = (y.float() - want).abs().max().item()
        us["torch.matmul"] = round(b2b_us(
            lambda i: torch.matmul(xs[i], twin.t()), args.repeats), 3)
        print(json.dumps({"layer": name, "K_N": [k, n], "M": m,
                          "x": str(dt).split(".")[-1], "card": smi,
                          "plan": list(geometry(m, n, k, sms,
                                                dt == torch.float32, None)),
                          "us": us, "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
