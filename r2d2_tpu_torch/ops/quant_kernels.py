"""The quantized forward's int8 weight-only dense product.

One hand-written CUDA kernel (``csrc/quant_kernels.cu``) with its plain
PyTorch version beside it:

* ``int8_linear`` — y = (x . q^T) * scale + bias for x (M, K) bf16 or f32,
  q (N, Kq) int8 in ``nn.Linear``'s (out, in) layout, scale (N,) f32 per
  output channel; the sum in f32, the scale and bias in the epilogue. No
  Pallas site: it is the dequantize-into-the-matmul that the JAX package's
  ``quantized_inference_apply`` (r2d2_tpu/models/network.py) leaves to
  XLA's fusion, so that the weights cross memory as int8. Bound by bytes;
  the source file says what the design does about it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches (plain calls do not count).
The kernel reads weight rows 16 bytes at a time, so the quantized forward
keeps its int8 weights padded to a multiple of 16 columns
(``pad_int8_weight``); the pad is never read into the sum.
"""

import ctypes
from typing import Optional

import torch

from r2d2_tpu_torch.ops.launch_counts import count_launch
from r2d2_tpu_torch.utils.device import stream_handle

LAUNCHES = {"int8_linear": 0}
MAX_ROWS = 64                # rows (M) one launch takes
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
            + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
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
    for r0 in range(0, m, MAX_ROWS):
        rows = min(MAX_ROWS, m - r0)
        err = lib.int8_linear(
            x[r0:].data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            q.shape[1], scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y[r0:].data_ptr(),
            int(out_dtype == torch.bfloat16), rows, n, k, stream)
        if err != 0:
            raise RuntimeError(f"int8_linear launch failed with CUDA error "
                               f"{err}")
        count_launch(LAUNCHES, "int8_linear", x.device)
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
