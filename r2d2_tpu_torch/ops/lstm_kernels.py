"""The fused LSTM time scan: residual forward, lean forward and reverse-time
backward, the counterpart of the JAX package's ``ops/pallas_lstm.py``.

Two hand-written CUDA kernels (``csrc/lstm_kernels.cu``) with their plain
PyTorch versions beside them:

* ``lstm_fwd_cuda`` — the forward scan; with ``save_residuals`` it writes
  hseq, cseq and the post-activation gates (replaces ``_fwd_call`` /
  ``_fwd_kernel``), without it hseq and c_fin only (``_fwd_kernel_lean``);
* ``lstm_bwd_cuda`` — the backward in reverse time: dxpb, dWh (f32), dc0
  and dh0 (f32) (replaces ``_bwd_call`` / ``_bwd_kernel``).

Layout is the JAX package's: ``xpb`` (T, B, 4H) with the bias folded in,
``wh`` (H, 4H), ``c0``/``h0`` (B, H), gate order i, f, g, o; all four share
one type, which is the storage and the compute type (cd). Arithmetic is the
kernels', not the Python scan's: the product is cd(h) @ Wh summed in f32,
gate math and carries are f32, and each output is rounded once to the
storage type. Under bf16 that differs from ``lstm_scan_reference``, which
carries bf16.

``lstm_scan`` is the dispatch: under autograd it runs ``LSTMScan`` (the
residual forward, then the backward kernel), otherwise the lean forward,
as the JAX custom_vjp's primal does. A CUDA tensor launches the kernel or
raises; only CPU tensors take the plain versions. ``LAUNCHES`` counts
kernel launches (plain calls do not count). ``fwd_geometry`` and
``bwd_geometry`` are the kernels' grids and shared memory for a shape,
which the wrappers pass to them; each is computed once per (batch,
hidden, dtype, SM count), as the C side caches each kernel's occupancy
query, so that a launch does no per-call setup and can be captured in a
CUDA graph.
"""

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from r2d2_tpu_torch.ops.launch_counts import count_launch
from r2d2_tpu_torch.utils.device import sm_count, stream_handle

LAUNCHES = {"lstm_fwd": 0, "lstm_fwd_lean": 0, "lstm_bwd": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {
    "lstm_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "lstm_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}
_lib = None

# The kernels' partition and shared memory, as csrc/lstm_kernels.cu
# (ScanTile, FwdSmem, BwdSmem and the constants above them) lays them out.
# (rows of a batch tile, units of a group), the same for both kernels
SCAN_TILE = {torch.bfloat16: (16, 32), torch.float32: (32, 16)}
BWD_STAGES = {torch.bfloat16: 8, torch.float32: 3}   # dx slices per warp
_FWD_K = 16                         # the forward's k padded to a multiple
_BWD_WARPS, _BWD_DH_K = 8, 16       # warps of a block, k of a dx slice
_BWD_TAIL = (128, 32, 4)            # dWh tile side; rows per slice; slices
SMEM_LIMIT = 232_448                # dynamic shared memory of a block, H100


class ScanGeometry(NamedTuple):
    """Block ``slot * groups + group`` owns hidden units ``[units * group,
    units * group + units)`` of the batch tiles (``rows`` rows each)
    ``slot, slot + slots, ...``, at most ``tiles_per_block`` of them; the
    blocks of a slot share barrier counter ``slot`` (``counters`` in all:
    the backward adds one for the whole grid)."""
    rows: int
    units: int
    groups: int
    slots: int
    tiles_per_block: int
    blocks: int
    smem: int
    counters: int


def _partition(name: str, batch: int, hidden: int, dtype: torch.dtype,
               sms: int):
    """(element bytes, values per 16-byte chunk, rows, units, groups, slots,
    tiles per block): as many batch-tile slots as the grid can hold at one
    block per multiprocessor, every block resident (the barriers need
    it)."""
    if dtype not in SCAN_TILE:
        raise ValueError(f"{name} takes float32 or bfloat16, not {dtype}")
    esize = torch.empty((), dtype=dtype).element_size()
    rows, units = SCAN_TILE[dtype]
    tiles = -(-batch // rows)
    groups = -(-hidden // units)
    if groups > sms:
        raise ValueError(f"{name}: H={hidden} needs {groups} unit groups, "
                         f"more than the card's {sms} multiprocessors")
    slots = min(tiles, sms // groups)
    return esize, 16 // esize, rows, units, groups, slots, -(-tiles // slots)


def _fits(name: str, batch: int, hidden: int, dtype: torch.dtype,
          smem: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: B={batch}, H={hidden} in {dtype} needs "
                         f"{smem} bytes of shared memory, above {SMEM_LIMIT}")


@functools.lru_cache(maxsize=None)
def fwd_geometry(batch: int, hidden: int, dtype: torch.dtype,
                 sms: int) -> ScanGeometry:
    """The forward kernel's grid for a (batch, hidden) problem on a card
    with ``sms`` multiprocessors. Shared memory: the block's Wh share (4 x
    units columns of H padded to 16, bf16 + a 16-byte chunk), one staged
    tile of h rows (H padded to 16, + a chunk), the f32 c carries of its
    tiles, f32 only the exchange of the two k halves' partial sums (8 x
    256 f32), and a tile's xpb values of a step (4 x rows x units). Raises
    where that does not fit a block or the unit groups outnumber the
    multiprocessors."""
    esize, chunk, rows, units, groups, slots, per_block = _partition(
        "lstm_fwd", batch, hidden, dtype, sms)
    kp = -(-hidden // _FWD_K) * _FWD_K
    bf16 = dtype == torch.bfloat16
    smem = (4 * units * (kp + chunk if bf16 else kp) * esize
            + rows * (kp + chunk) * esize + per_block * rows * units * 4
            + (0 if bf16 else 8 * 256 * 4) + 4 * rows * units * esize)
    _fits("lstm_fwd", batch, hidden, dtype, smem)
    return ScanGeometry(rows, units, groups, slots, per_block,
                        slots * groups, smem, slots)


@functools.lru_cache(maxsize=None)
def bwd_geometry(batch: int, hidden: int, dtype: torch.dtype,
                 sms: int) -> ScanGeometry:
    """The backward kernel's grid for a (batch, hidden) problem on a card
    with ``sms`` multiprocessors. Raises if Wh rows, carries and staging do
    not fit a block's shared memory or the unit groups outnumber the
    multiprocessors."""
    esize, chunk, rows, units, groups, slots, per_block = _partition(
        "lstm_bwd", batch, hidden, dtype, sms)
    stages = BWD_STAGES[dtype]
    kp = -(-4 * hidden // _BWD_DH_K) * _BWD_DH_K
    pairs = rows * units
    steps_bytes = (units * (kp + chunk) * esize
                   + _BWD_WARPS * stages * rows * (_BWD_DH_K + chunk) * esize
                   + _BWD_WARPS * pairs * 4 + 2 * per_block * pairs * 4)
    tile, tk, tail_stages = _BWD_TAIL
    tail_bytes = tail_stages * tk * 2 * (tile + chunk) * esize
    smem = max(steps_bytes, tail_bytes)
    _fits("lstm_bwd", batch, hidden, dtype, smem)
    return ScanGeometry(rows, units, groups, slots, per_block,
                        slots * groups, smem, slots + 1)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    global _lib
    if _lib is None:
        from r2d2_tpu_torch.ops import _build
        lib = _build.load("lstm_kernels")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _gates(t: torch.Tensor):
    return t.chunk(4, dim=-1)


# ---------------------------------------------------------------------------
# plain versions


def lstm_scan_reference(xpb: torch.Tensor, wh: torch.Tensor,
                        c0: torch.Tensor, h0: torch.Tensor):
    """Twin of the JAX scan oracle: carries in the input type, as the Python
    scan of ``models/network.py`` does. Returns (hseq, (c_fin, h_fin))."""
    c, h, hs = c0, h0, []
    for xp in xpb:
        i, f, g, o = _gates(xp + h @ wh)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), (c, h)


def lstm_fwd_plain(xpb: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                   h0: torch.Tensor, save_residuals: bool = True):
    """The forward kernel's arithmetic step by step. Returns (hseq, cseq,
    acts) with ``save_residuals``, else (hseq, c_fin), in xpb's type."""
    cd, out = wh.dtype, xpb.dtype
    w = wh.float()
    c, h = c0.float(), h0.float()
    hseq, cseq, acts = [], [], []
    for xp in xpb:
        # the sum of a bf16 product in f32: a bare bf16 @ would round it
        i, f, g, o = _gates(xp.float() + h.to(cd).float() @ w)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        hseq.append(h.to(out))
        if save_residuals:
            cseq.append(c.to(out))
            acts.append(torch.cat([i, f, g, o], dim=-1).to(out))
    if save_residuals:
        return torch.stack(hseq), torch.stack(cseq), torch.stack(acts)
    return torch.stack(hseq), c.to(out)


def lstm_fwd_flops(steps: int, batch: int, hidden: int) -> float:
    """The forward's FLOPs as the flop counter counts its plain version:
    one (B, H) x (H, 4H) product a step."""
    return 2.0 * steps * batch * hidden * 4 * hidden


def lstm_bwd_flops(steps: int, batch: int, hidden: int) -> float:
    """The backward's: dh = dgates . Wh^T and dWh += h^T . dgates a step."""
    return 2.0 * lstm_fwd_flops(steps, batch, hidden)


def lstm_bwd_plain(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin):
    """The backward kernel's arithmetic step by step, t = T-1 .. 0. Returns
    dxpb (dhseq's type), dWh, dc0, dh0 (f32)."""
    cd, out = wh.dtype, dhseq.dtype
    steps = acts.shape[0]
    w = wh.float()
    dh, dc = dhfin.float(), dcfin.float()
    dwh = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    dxpb = torch.empty(acts.shape, dtype=out, device=acts.device)
    for t in reversed(range(steps)):
        i, f, g, o = _gates(acts[t].float())
        c_prev = (cseq[t - 1] if t > 0 else c0).float()
        h_prev = (hseq[t - 1] if t > 0 else h0).float()
        dh_total = dhseq[t].float() + dh
        tc = torch.tanh(cseq[t].float())
        d_o = dh_total * tc
        dcc = dc + dh_total * o * (1.0 - tc * tc)
        di, dg, df = dcc * g, dcc * i, dcc * c_prev
        dxpb[t] = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                             dg * (1.0 - g * g), d_o * o * (1.0 - o)],
                            dim=-1).to(out)
        dx = dxpb[t].to(cd).float()
        dh = dx @ w.T
        dwh += h_prev.to(cd).float().T @ dx
        dc = dcc * f
    return dxpb, dwh, dc, dh


# ---------------------------------------------------------------------------
# kernel launches


def _check_inputs(name: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if first.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, not "
                         f"{first.dtype}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: every input must be a {first.dtype} "
                             f"tensor on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")


def _shapes(xpb: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
            h0: torch.Tensor) -> Tuple[int, int, int]:
    if xpb.dim() != 3 or xpb.shape[-1] % 4:
        raise ValueError(f"xpb must be (T, B, 4H); got {tuple(xpb.shape)}")
    steps, batch, gdim = xpb.shape
    hidden = gdim // 4
    if tuple(wh.shape) != (hidden, gdim):
        raise ValueError(f"wh must be ({hidden}, {gdim}); got "
                         f"{tuple(wh.shape)}")
    for name, t in (("c0", c0), ("h0", h0)):
        if tuple(t.shape) != (batch, hidden):
            raise ValueError(f"{name} must be ({batch}, {hidden}); got "
                             f"{tuple(t.shape)}")
    if min(steps, batch, hidden) < 1:
        raise ValueError("lstm kernels need T, B and H >= 1")
    return steps, batch, hidden


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def lstm_fwd_cuda(xpb: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
                  h0: torch.Tensor, save_residuals: bool = True):
    """CUDA kernel launch (csrc/lstm_kernels.cu lstm_fwd); the same returns
    as ``lstm_fwd_plain``."""
    _check_inputs("lstm_fwd", xpb, wh, c0, h0)
    steps, batch, hidden = _shapes(xpb, wh, c0, h0)
    dev, dtype = xpb.device, xpb.dtype
    hseq = torch.empty((steps, batch, hidden), dtype=dtype, device=dev)
    geo = fwd_geometry(batch, hidden, dtype, sm_count(dev))
    # zeroed per call: under graph capture the fill is a node of the
    # graph, so every replay starts its barriers from zero
    barrier = torch.zeros(geo.counters, dtype=torch.int32, device=dev)
    if save_residuals:
        cseq = torch.empty_like(hseq)
        acts = torch.empty_like(xpb)
        ptrs = (cseq.data_ptr(), acts.data_ptr(), None)
    else:
        cfin = torch.empty((batch, hidden), dtype=dtype, device=dev)
        ptrs = (None, None, cfin.data_ptr())
    _raise_on(_library().lstm_fwd(
        xpb.data_ptr(), wh.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        hseq.data_ptr(), *ptrs, barrier.data_ptr(), steps, batch, hidden,
        geo.slots, geo.smem, int(dtype == torch.bfloat16),
        int(save_residuals),
        stream_handle(dev)), "lstm_fwd")
    flops = lstm_fwd_flops(steps, batch, hidden)
    if save_residuals:
        count_launch(LAUNCHES, "lstm_fwd", dev, flops)
        return hseq, cseq, acts
    count_launch(LAUNCHES, "lstm_fwd_lean", dev, flops)
    return hseq, cfin


def lstm_bwd_cuda(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin):
    """CUDA kernel launch (csrc/lstm_kernels.cu lstm_bwd); the same returns
    as ``lstm_bwd_plain``."""
    _check_inputs("lstm_bwd", acts, wh, c0, h0, hseq, cseq, dhseq, dcfin,
                  dhfin)
    steps, batch, hidden = _shapes(acts, wh, c0, h0)
    seq, carry = (steps, batch, hidden), (batch, hidden)
    for name, t, want in (("hseq", hseq, seq), ("cseq", cseq, seq),
                          ("dhseq", dhseq, seq), ("dcfin", dcfin, carry),
                          ("dhfin", dhfin, carry)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}; got {tuple(t.shape)}")
    dev, dtype = acts.device, acts.dtype
    dxpb = torch.empty_like(acts)
    dwh = torch.empty((hidden, 4 * hidden), dtype=torch.float32, device=dev)
    dc0 = torch.empty((batch, hidden), dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(dc0)
    geo = bwd_geometry(batch, hidden, dtype, sm_count(dev))
    barrier = torch.zeros(geo.counters, dtype=torch.int32, device=dev)
    _raise_on(_library().lstm_bwd(
        dhseq.data_ptr(), acts.data_ptr(), cseq.data_ptr(), hseq.data_ptr(),
        wh.data_ptr(), c0.data_ptr(), h0.data_ptr(), dcfin.data_ptr(),
        dhfin.data_ptr(), dxpb.data_ptr(), dwh.data_ptr(), dc0.data_ptr(),
        dh0.data_ptr(), barrier.data_ptr(), steps, batch, hidden, geo.slots,
        geo.smem, int(dtype == torch.bfloat16),
        stream_handle(dev)), "lstm_bwd")
    count_launch(LAUNCHES, "lstm_bwd", dev,
                 lstm_bwd_flops(steps, batch, hidden))
    return dxpb, dwh, dc0, dh0


# ---------------------------------------------------------------------------
# dispatch and autograd


def lstm_fwd(xpb, wh, c0, h0, save_residuals: bool = True):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if xpb.device.type == "cpu":
        return lstm_fwd_plain(xpb, wh, c0, h0, save_residuals)
    return lstm_fwd_cuda(xpb, wh, c0, h0, save_residuals)


def lstm_bwd(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin):
    if acts.device.type == "cpu":
        return lstm_bwd_plain(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin,
                              dhfin)
    return lstm_bwd_cuda(wh, c0, h0, hseq, cseq, acts, dhseq, dcfin, dhfin)


class LSTMScan(torch.autograd.Function):
    """Residual forward, backward kernel. Outputs (hseq, c_fin, h_fin); the
    final carries are their own tensors so that their cotangents reach the
    backward in f32 arithmetic, as the JAX custom_vjp's do."""

    @staticmethod
    def forward(ctx, xpb, wh, c0, h0):
        hseq, cseq, acts = lstm_fwd(xpb, wh, c0, h0, save_residuals=True)
        ctx.save_for_backward(wh, c0, h0, hseq, cseq, acts)
        return hseq, cseq[-1].clone(), hseq[-1].clone()

    @staticmethod
    def backward(ctx, dhseq, dcfin, dhfin):
        wh, c0, h0, hseq, cseq, acts = ctx.saved_tensors
        dxpb, dwh, dc0, dh0 = lstm_bwd(
            wh, c0, h0, hseq, cseq, acts, dhseq.contiguous(),
            dcfin.contiguous(), dhfin.contiguous())
        return dxpb, dwh.to(wh.dtype), dc0.to(c0.dtype), dh0.to(h0.dtype)


def lstm_scan(xpb: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
              h0: torch.Tensor):
    """Fused LSTM scan: (hseq (T, B, H), (c_fin, h_fin)). Differentiable
    through the backward kernel when autograd records; the lean forward
    otherwise."""
    xpb, wh, c0, h0 = (t.contiguous() for t in (xpb, wh, c0, h0))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xpb, wh, c0, h0)):
        hseq, c_fin, h_fin = LSTMScan.apply(xpb, wh, c0, h0)
        return hseq, (c_fin, h_fin)
    hseq, c_fin = lstm_fwd(xpb, wh, c0, h0, save_residuals=False)
    return hseq, (c_fin, hseq[-1])
