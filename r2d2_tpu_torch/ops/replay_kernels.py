"""The learner's replay data path: window gather and uint8 frame decode.

Two hand-written CUDA kernels (``csrc/replay_kernels.cu``) with their plain
PyTorch versions beside them:

* ``gather_windows_cuda`` — out[i] = ring[block_idx[i], start[i]:start[i]+W];
  replaces the TPU kernels ``gather_rows_pallas`` and
  ``gather_rows_exact_pallas`` (r2d2_tpu/ops/pallas_kernels.py);
* ``stack_frames_cuda`` — out[b,t,h,w,k] = obs[b,t+k,h,w] / 255 in the compute
  dtype, or the same frames in the 2x2 space-to-depth layout the first conv
  takes (``space_to_depth=True``); replaces ``stack_frames_pallas`` (same
  file).

Both are bound by bytes; the source file says what each design does about
it. The dispatch functions ``gather_rows`` and ``stack_frames`` take the
plain version only for a tensor on the CPU; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts kernel launches (plain calls do not
count), so a run can show that its main path went through the kernels.
"""

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from r2d2_tpu_torch.ops.indexing import (frame_stack_indices,
                                         space_to_depth_2x2)
from r2d2_tpu_torch.utils.device import sm_count, stream_handle

LAUNCHES = {"gather_windows": 0, "stack_frames": 0}

_INV255 = 1.0 / 255.0
_SIGNATURES = {
    "gather_windows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int64] * 8 + [ctypes.c_void_p],
    "stack_frames": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int] + [ctypes.c_int64] * 8 + [ctypes.c_void_p],
}
_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    global _lib
    if _lib is None:
        from r2d2_tpu_torch.ops import _build
        lib = _build.load("replay_kernels")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


# ---------------------------------------------------------------------------
# window gather


def gather_windows_plain(ring: torch.Tensor, block_idx: torch.Tensor,
                         start: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version: ring (N, R, Hs, Ws) uint8 -> (B, window, Hs, Ws).
    Off-contract indices follow lax.dynamic_slice / jnp indexing in the JAX
    reference: a negative index counts from the end, then clamps."""
    num_rows, row_len = ring.shape[:2]
    bi, st = block_idx.long(), start.long()
    bi = torch.where(bi < 0, bi + num_rows, bi).clamp(0, num_rows - 1)
    st = torch.where(st < 0, st + row_len, st).clamp(0, row_len - window)
    t = st[:, None] + torch.arange(window, device=ring.device)[None, :]
    return ring[bi[:, None], t]


# The gather kernel's work partition (csrc/replay_kernels.cu gather_windows):
# bulk copies, one CTA of one copying thread a multiprocessor through 12
# shared-memory stages of up to 16 KB (16,384 x 12 = 196,608 bytes with the
# item table, within a block's 227 KB); frames that are not a multiple of 16
# bytes, the byte-wide kernel, four CTAs of 256 threads a multiprocessor.
BULK_PARTITION = {"ctas_per_sm": 1, "max_chunk": 16384}
BYTES_PARTITION = {"ctas_per_sm": 4, "max_chunk": 32768}
_GATHER_MIN_CHUNK = 1024     # smaller items only where the grid needs them
_GATHER_ITEM_COST = 256      # an item's fixed cost, in bytes moved
_INDEX_TYPES = (torch.int32, torch.int64)


@dataclass(frozen=True)
class GatherPlan:
    """Work items of one gather. Item k is bytes [c * chunk, c * chunk +
    chunk) of sample k % batch's window, c = k // batch (the last chunk of a
    window shorter); CTA g of ``grid`` walks items [g * per_cta, (g + 1) *
    per_cta), the same chunk of neighbouring samples."""
    batch: int
    window_bytes: int
    chunk: int
    per_cta: int
    grid: int

    @property
    def chunks_per_sample(self) -> int:
        return -(-self.window_bytes // self.chunk)

    @property
    def items(self) -> int:
        return self.batch * self.chunks_per_sample

    def item(self, k: int) -> Tuple[int, int, int]:
        """(sample, byte offset in its window, byte count) of item k."""
        offset = (k // self.batch) * self.chunk
        return (k % self.batch, offset,
                min(self.chunk, self.window_bytes - offset))

    def walk(self, cta: int) -> List[Tuple[int, int, int]]:
        """The items CTA ``cta`` copies, in its order."""
        first = cta * self.per_cta
        return [self.item(k)
                for k in range(first, min(first + self.per_cta, self.items))]


@functools.lru_cache(maxsize=64)
def gather_plan(batch: int, window: int, frame_bytes: int, num_sms: int,
                ctas_per_sm: int = BULK_PARTITION["ctas_per_sm"],
                max_chunk: int = BULK_PARTITION["max_chunk"]) -> GatherPlan:
    """The gather's work partition on a card with ``num_sms``
    multiprocessors: a chunk (a multiple of 16 bytes, at most ``max_chunk``)
    and a persistent grid of at most ``ctas_per_sm`` CTAs a multiprocessor,
    each with at least one item. Of the chunk counts per window from the
    fewest that fit ``max_chunk`` up to chunks of _GATHER_MIN_CHUNK, it
    takes the one whose busiest CTA moves the fewest bytes, an item's fixed
    cost counted; the fewest chunks on a tie."""
    if min(batch, window, frame_bytes, num_sms, ctas_per_sm) < 1 \
            or max_chunk < 16:
        raise ValueError("gather_plan needs positive sizes")
    window_bytes = window * frame_bytes
    slots = num_sms * ctas_per_sm
    fewest = -(-window_bytes // (max_chunk // 16 * 16))
    most = max(fewest, window_bytes // _GATHER_MIN_CHUNK)
    best = None
    for n in range(fewest, most + 1):
        chunk = -(-window_bytes // (16 * n)) * 16
        items = batch * -(-window_bytes // chunk)
        per_cta = -(-items // min(items, slots))
        cost = per_cta * (chunk + _GATHER_ITEM_COST)
        if best is None or cost < best[0]:
            best = (cost, GatherPlan(batch, window_bytes, chunk, per_cta,
                                     -(-items // per_cta)))
    return best[1]


def _index(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An index vector as the kernel reads it: int32 or int64 on the ring's
    device, as given (the sampler's own dtype); anything else converted."""
    if t.device != device or t.dtype not in _INDEX_TYPES:
        t = t.to(device, torch.int64)
    return t.contiguous()


def gather_windows_cuda(ring: torch.Tensor, block_idx: torch.Tensor,
                        start: torch.Tensor, window: int) -> torch.Tensor:
    """CUDA kernel launch (see csrc/replay_kernels.cu gather_windows)."""
    if not (ring.is_cuda and ring.dtype == torch.uint8 and ring.dim() == 4):
        raise ValueError("gather_windows takes a 4-D uint8 CUDA ring")
    if not ring.is_contiguous() or ring.data_ptr() % 16:
        raise ValueError("gather_windows needs a contiguous, 16-byte "
                         "aligned ring")
    num_rows, row_len, height, width = ring.shape
    if not 0 < window <= row_len:
        raise ValueError(f"window {window} does not fit rows of {row_len}")
    if block_idx.dim() != 1 or block_idx.shape != start.shape:
        raise ValueError("block_idx and start must be vectors of one length")
    device = ring.device
    block_idx, start = _index(block_idx, device), _index(start, device)
    batch = block_idx.shape[0]
    out = torch.empty((batch, window, height, width), dtype=torch.uint8,
                      device=device)
    if out.numel() == 0:
        return out
    frame_bytes = height * width
    partition = BULK_PARTITION if frame_bytes % 16 == 0 else BYTES_PARTITION
    plan = gather_plan(batch, window, frame_bytes, sm_count(device),
                       partition["ctas_per_sm"], partition["max_chunk"])
    _check(_library().gather_windows(
        ring.data_ptr(), block_idx.data_ptr(),
        int(block_idx.dtype == torch.int64), start.data_ptr(),
        int(start.dtype == torch.int64), out.data_ptr(), batch, num_rows,
        row_len, frame_bytes, window, plan.chunk, plan.per_cta, plan.grid,
        stream_handle(device)), "gather_windows")
    LAUNCHES["gather_windows"] += 1
    return out


def gather_rows(ring: torch.Tensor, block_idx: torch.Tensor,
                start: torch.Tensor, window: int) -> torch.Tensor:
    """Dispatch: the kernel for a CUDA ring, the plain version for a CPU
    one. Works on unpadded and tile-padded storage alike."""
    if ring.device.type == "cpu":
        return gather_windows_plain(ring, block_idx, start, window)
    return gather_windows_cuda(ring, block_idx, start, window)


# ---------------------------------------------------------------------------
# frame decode


def stack_frames_plain(obs: torch.Tensor, seq_window: int, frame_stack: int,
                       out_dtype: torch.dtype = torch.float32,
                       out_height: Optional[int] = None,
                       out_width: Optional[int] = None,
                       space_to_depth: bool = False) -> torch.Tensor:
    """Plain version: obs (B, >=T+K-1, Hs, Ws) uint8 -> (B, T, H, W, K), or
    with ``space_to_depth`` (B, T, H/2, W/2, 4K), ``space_to_depth_2x2`` of
    each (b, t). Scales by f32(1/255) in f32 and rounds once into
    ``out_dtype`` — the kernel's arithmetic, so the two agree exactly (the
    JAX reference divides by 255, which may differ by one f32 ulp)."""
    out_height = obs.shape[2] if out_height is None else out_height
    out_width = obs.shape[3] if out_width is None else out_width
    fsi = frame_stack_indices(seq_window, frame_stack, device=obs.device)
    stacked = obs[:, :, :out_height, :out_width][:, fsi]    # (B,T,K,H,W)
    out = (stacked.permute(0, 1, 3, 4, 2).float() * _INV255).to(out_dtype)
    if space_to_depth:
        batch = out.shape[0]
        out = space_to_depth_2x2(out.flatten(0, 1)).unflatten(
            0, (batch, seq_window))
    return out.contiguous()


def stack_frames_cuda(obs: torch.Tensor, seq_window: int, frame_stack: int,
                      out_dtype: torch.dtype = torch.float32,
                      out_height: Optional[int] = None,
                      out_width: Optional[int] = None,
                      space_to_depth: bool = False) -> torch.Tensor:
    """CUDA kernel launch (see csrc/replay_kernels.cu stack_frames)."""
    if not (obs.is_cuda and obs.dtype == torch.uint8 and obs.dim() == 4):
        raise ValueError("stack_frames takes a 4-D uint8 CUDA tensor")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stack_frames emits float32 or bfloat16, not "
                         f"{out_dtype}")
    obs = obs.contiguous()
    batch, row_len, stored_h, stored_w = obs.shape
    out_height = stored_h if out_height is None else out_height
    out_width = stored_w if out_width is None else out_width
    if row_len < seq_window + frame_stack - 1:
        raise ValueError(f"rows of {row_len} frames are shorter than the "
                         f"{seq_window}+{frame_stack}-1 window")
    if out_height > stored_h or out_width > stored_w:
        raise ValueError("out_height/out_width exceed the stored frame")
    if frame_stack < 1:
        raise ValueError(f"frame_stack must be >= 1, got {frame_stack}")
    if space_to_depth:
        if out_height % 2 or out_width % 2:
            raise ValueError("the space-to-depth layout needs an even frame, "
                             f"got {out_height}x{out_width}")
        shape = (batch, seq_window, out_height // 2, out_width // 2,
                 4 * frame_stack)
    else:
        shape = (batch, seq_window, out_height, out_width, frame_stack)
    out = torch.empty(shape, dtype=out_dtype, device=obs.device)
    if out.numel() == 0:
        return out
    _check(_library().stack_frames(
        obs.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        int(space_to_depth), batch, seq_window, frame_stack, row_len,
        stored_h, stored_w, out_height, out_width, stream_handle(obs.device)),
        "stack_frames")
    LAUNCHES["stack_frames"] += 1
    return out


def stack_frames(obs: torch.Tensor, seq_window: int, frame_stack: int,
                 out_dtype: torch.dtype = torch.float32,
                 out_height: Optional[int] = None,
                 out_width: Optional[int] = None,
                 space_to_depth: bool = False) -> torch.Tensor:
    """Dispatch: the kernel for a CUDA tensor, the plain version for a CPU
    one. The optim.pallas_decode_layout values "planar" and "nhwc" both
    land here: the output is (B, T, H, W, K) either way, or the
    space-to-depth layout the network asks for."""
    if obs.device.type == "cpu":
        return stack_frames_plain(obs, seq_window, frame_stack, out_dtype,
                                  out_height, out_width, space_to_depth)
    return stack_frames_cuda(obs, seq_window, frame_stack, out_dtype,
                             out_height, out_width, space_to_depth)
