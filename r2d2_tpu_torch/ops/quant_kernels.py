"""The quantized forward's int8 weight-only dense product.

One hand-written CUDA kernel (``csrc/quant_kernels.cu``) with its plain
PyTorch version beside it:

* ``int8_linear`` — y = (x . q^T) * scale + bias for x (M, K) bf16 or f32,
  q (N, Kq) int8 in ``nn.Linear``'s (out, in) layout, scale (N,) f32 per
  output channel; the sum in f32, the scale and bias in the epilogue. No
  Pallas site: it is the dequantize-into-the-matmul that the JAX package's
  ``quantized_inference_apply`` (r2d2_tpu/models/network.py) leaves to
  XLA's fusion, so that the weights cross memory as int8. Bound by bytes
  (~1 us for the torso dense), so the kernel is laid out to have every SM
  reading at once: the weights, widened exactly to bf16 in registers, are
  operand A of tensor-core products (``mma.sync`` m16n8k16, x as operand
  B, 8 rows of x a tile); K is split over a thread-block cluster whose
  blocks add their partial sums in rank order (deterministic, one launch);
  x is staged once a K slice by asynchronous copies. f32 x goes through
  the same products as three bf16 terms (``split_bf16x3``), which keeps
  f32's accuracy. ``int8_linear_plan`` is the launch geometry; the source
  file says the rest.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches (plain calls do not count).
The kernel reads weight rows 16 bytes at a time, so the quantized forward
keeps its int8 weights padded to a multiple of 16 columns
(``pad_int8_weight``); the pad is never read into the sum.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from r2d2_tpu_torch.ops.launch_counts import count_launch
from r2d2_tpu_torch.utils.device import sm_count, stream_handle

LAUNCHES = {"int8_linear": 0}
MAX_ROWS = 64                # rows (M) one launch takes
# the kernel's constants (csrc/quant_kernels.cu)
CHUNK = 64                   # k a warp covers a step: 4 lanes x 16
MAX_CHUNKS = 8               # chunks of a round a warp holds in registers
MAX_WARPS = 4                # m16 channel tiles (a warp each) a block
MAX_SPLIT = 8                # K slices: the portable cluster size
MAX_SMEM = 160 * 1024
_ROW_PAD, _RAW_PAD, _PART_PAD = 8, 4, 4
_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    global _lib
    if _lib is None:
        from r2d2_tpu_torch.ops import _build
        lib = _build.load("quant_kernels")
        lib.int8_linear.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.int8_linear.restype = ctypes.c_int
        _lib = lib
    return _lib


def pad_int8_weight(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 -> (N, Kq) int8 with Kq the next multiple of 16, zeros
    in the new columns, contiguous."""
    n, k = q.shape
    kq = -(-k // 16) * 16
    out = torch.zeros((n, kq), dtype=torch.int8, device=q.device)
    out[:, :k] = q
    return out


class Int8Plan(NamedTuple):
    """The kernel's launch geometry for one (M, N, K, x type)."""
    rows: int              # x rows a block holds: 8 x NT, NT in 1, 2, 4, 8
    warps: int             # m16 channel tiles a block, a warp each
    split: int             # K slices, the blocks of a cluster (1: none)
    chunks: int            # 64-k chunks a round stages (a warp's weights
                           # in registers, all loaded before the products;
                           # a slice of more chunks takes more rounds)
    grid: Tuple[int, int]  # (split, channel blocks)
    smem: int              # the block's shared memory (the kernel's own
                           # formula, estimated here to choose chunks)

    def slice_chunks(self, s: int, k: int) -> Tuple[int, int]:
        """The chunks [lo, hi) of K slice ``s`` (the kernel's formula)."""
        total = -(-k // CHUNK)
        return s * total // self.split, (s + 1) * total // self.split


def _smem_bytes(rows: int, warps: int, split: int, chunks: int,
                x_f32: bool) -> int:
    """The block's shared memory, as csrc/quant_kernels.cu int8_smem_bytes
    lays it out: the staged x (f32: three bf16 planes and the raw rows),
    then the partial sums when K is split. Only the choice of chunks reads
    it; the C entry computes its own and refuses a plan above MAX_SMEM."""
    width = chunks * CHUNK
    nbytes = (3 if x_f32 else 1) * rows * (width + _ROW_PAD) * 2
    if x_f32:
        nbytes += rows * (width + _RAW_PAD) * 4
    if split > 1:
        nbytes += rows * (warps * 16 + _PART_PAD) * 4
    return nbytes


@functools.lru_cache(maxsize=None)
def int8_linear_plan(m: int, n: int, k: int, num_sms: int,
                     x_f32: bool = False) -> Int8Plan:
    """The geometry of one launch of M <= MAX_ROWS rows on a card with
    ``num_sms`` multiprocessors. The product is over within a few
    microseconds, so the plan fills the SMs: of blocks of 4, 2 or 1 warps
    (channel tiles of 64, 32 or 16), it takes the one whose channel blocks
    x K slices (at most MAX_SPLIT, one chunk at least a slice) occupy the
    most SMs, on a tie the one with fewer channels past N, then the wider
    (fewer blocks stage the same x). A round holds up to MAX_CHUNKS chunks,
    fewer where shared memory would pass MAX_SMEM."""
    if not 1 <= m <= MAX_ROWS or n < 1 or k < 1 or num_sms < 1:
        raise ValueError(f"int8_linear_plan: no plan for M={m}, N={n}, "
                         f"K={k} on {num_sms} SMs")
    rows = 8
    while rows < m:
        rows *= 2
    total = -(-k // CHUNK)
    n16 = -(-n // 16)
    best = None
    for warps in (4, 2, 1):
        if warps > n16 and warps > 1:
            continue
        blocks = -(-n16 // warps)
        split = max(1, min(MAX_SPLIT, total, num_sms // blocks))
        key = (min(blocks * split, num_sms), n - blocks * 16 * warps, warps)
        if best is None or key > best[0]:
            best = (key, warps, split, blocks)
    _, warps, split, blocks = best
    per_slice = -(-total // split)
    chunks = min(MAX_CHUNKS, per_slice)
    while chunks > 1 and _smem_bytes(rows, warps, split, chunks,
                                     x_f32) > MAX_SMEM:
        chunks -= 1
    return Int8Plan(rows, warps, split, chunks, (split, blocks),
                    _smem_bytes(rows, warps, split, chunks, x_f32))


def split_bf16x3(x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x as three bf16 terms, the kernel's f32 route: hi = bf16(x), mid
    = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest. For
    |x| >= 2^-110 (and 0) hi + mid + lo is x exactly: each residual keeps
    at most 16 then 8 significant bits, and lo's last bit stays within
    bf16's range. q is exact in bf16, so the three tensor-core products
    summed in f32 are the f32 product up to the order of the sum."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def int8_linear_flops(m: int, n: int, k: int) -> float:
    """FLOPs of one launch as the flop counter counts the plain version:
    the (m, k) x (k, n) product."""
    return 2.0 * m * n * k


def int8_linear_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version, the kernel's arithmetic: the int8 weights widened to
    f32, the sum of x * q in f32, times the channel's scale, plus the bias,
    cast to ``out_dtype`` (default: x's)."""
    k = x.shape[1]
    acc = x.float() @ q[:, :k].float().t()
    y = acc * scale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


def _check_args(x, q, scale, bias, out_dtype) -> None:
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and q {tuple(q.shape)} must "
                         "be 2-D")
    m, k = x.shape
    n, kq = q.shape
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8; got {q.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16; got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16; got {out_dtype}")
    if kq < k:
        raise ValueError(f"q has {kq} columns for x's {k}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be ({n},) f32; got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n,)):
        raise ValueError(f"bias must be ({n},) f32; got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if m < 1:
        raise ValueError("x has no rows")


def int8_linear_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel on CUDA tensors. ``q`` must be contiguous with a multiple
    of 16 columns (``pad_int8_weight``); x is made contiguous; more than
    MAX_ROWS rows launch once per MAX_ROWS."""
    out_dtype = out_dtype or x.dtype
    _check_args(x, q, scale, bias, out_dtype)
    tensors = (x, q, scale) + (() if bias is None else (bias,))
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("int8_linear_cuda needs every tensor on one CUDA "
                         "device")
    if not q.is_contiguous() or q.shape[1] % 16 or q.data_ptr() % 16:
        raise ValueError("q must be contiguous, 16-byte aligned, with a "
                         "multiple of 16 columns (pad_int8_weight)")
    if not scale.is_contiguous() or (bias is not None
                                     and not bias.is_contiguous()):
        raise ValueError("scale and bias must be contiguous")
    x = x.contiguous()
    m, k = x.shape
    n = q.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _library()
    stream = stream_handle(x.device)
    sms = sm_count(x.device)
    x_f32 = x.dtype == torch.float32
    for r0 in range(0, m, MAX_ROWS):
        rows = min(MAX_ROWS, m - r0)
        plan = int8_linear_plan(rows, n, k, sms, x_f32)
        err = lib.int8_linear(
            x[r0:].data_ptr(), int(not x_f32), q.data_ptr(), q.shape[1],
            scale.data_ptr(), None if bias is None else bias.data_ptr(),
            y[r0:].data_ptr(), int(out_dtype == torch.bfloat16), rows, n, k,
            plan.warps, *plan.grid, plan.chunks, stream)
        if err != 0:
            raise RuntimeError(f"int8_linear launch failed with CUDA error "
                               f"{err}")
        count_launch(LAUNCHES, "int8_linear", x.device,
                     int8_linear_flops(rows, n, k))
    return y


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = (x . q^T) * scale + bias: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if x.device.type == "cuda":
        return int8_linear_cuda(x, q, scale, bias, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_linear: no route for device {x.device}")
    return int8_linear_plain(x, q, scale, bias, out_dtype)


def int8_linear_bytes(m: int, n: int, k: int, x_bytes: int,
                      y_bytes: int) -> int:
    """Bytes the product must move: the int8 weights, the f32 scales and
    biases, x and y, each once."""
    return n * k + 8 * n + m * k * x_bytes + m * n * y_bytes
