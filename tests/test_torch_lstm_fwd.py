"""The forward LSTM kernel's design on the CPU (``ops/lstm_kernels.py``):
``fwd_geometry``, the grid and shared memory the wrapper launches it with;
the column order of a block's Wh share and the pairs each thread owns, as
``csrc/lstm_kernels.cu`` lays them out; and a PyTorch model of the
partition, in which each batch-tile slot runs a scan of its own from its
rows of h_{t-1} alone, against ``lstm_fwd_plain`` and the JAX Pallas forward
kernel (interpret mode).

The kernel itself runs only on the card; chip_smoke.py holds it against
``lstm_fwd_plain`` there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.pallas_lstm import _fwd_call
from r2d2_tpu_torch.ops import lstm_kernels as lk

pytestmark = pytest.mark.torch_port

SMS = 132                                   # H100 SXM multiprocessors
THREADS = 256                               # threads of a block
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# as tests/test_torch_lstm.py holds the plain forward to the Pallas one
TOL = {"float32": dict(atol=2e-6, rtol=2e-6),
       "bfloat16": dict(atol=2.0 ** -7, rtol=2.0 ** -7)}


def _column(unit: int, gate: int) -> int:
    """bf16: the column of (unit, gate) in a block's Wh share, as the
    kernel's fwd_column: (i, f) and (g, o) pairs interleaved so that an mma
    lane holds one unit's four gates."""
    return unit // 4 * 16 + gate // 2 * 8 + unit % 4 * 2 + gate % 2


def _w_index(unit: int, gate: int, k: int, kp: int) -> int:
    """f32: where value k of (unit, gate) lies in the Wh share, as the
    kernel's fwd_w_index: [gate][k / 4][unit][4]."""
    return ((gate * (kp // 4) + k // 4) * 16 + unit) * 4 + k % 4


def _share_order(units: int, dtype: torch.dtype):
    """(unit, gate) of a block's Wh share in the kernel's order: bf16 by
    column, f32 gate-major."""
    pairs = [(u, g) for g in range(4) for u in range(units)]
    if dtype == torch.bfloat16:
        return sorted(pairs, key=lambda ug: _column(*ug))
    return pairs


def _pair(tid: int, p: int, dtype: torch.dtype):
    """(row, unit within the group) of pair p of thread ``tid``, as the
    kernel's fwd_row/fwd_pair_unit."""
    lane, warp = tid % 32, tid // 32
    if dtype == torch.bfloat16:
        return lane // 4 + 8 * p, warp * 4 + lane % 4
    return tid % 128 // 16 + 8 * (2 * (tid // 128) + p), tid % 16


@pytest.mark.parametrize("batch", [1, 3, 33, 128, 130, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fwd_geometry_owns_every_pair_once(batch, dtype):
    """At 132 multiprocessors, for H in {16, 17, 24, 512}: the grid is
    resident at one block per multiprocessor, its shared memory fits a
    block, every (row, unit) belongs to exactly one block under the
    kernel's mapping, and there is one barrier counter per slot."""
    for hidden in (16, 17, 24, 512):
        geo = lk.fwd_geometry(batch, hidden, dtype, SMS)
        assert (geo.rows, geo.units) == lk.SCAN_TILE[dtype]
        assert geo.blocks == geo.slots * geo.groups <= SMS
        assert geo.smem <= lk.SMEM_LIMIT == 232_448
        assert geo.counters == geo.slots
        ntiles = -(-batch // geo.rows)
        assert geo.groups == -(-hidden // geo.units)
        assert geo.tiles_per_block == -(-ntiles // geo.slots)
        owner = np.zeros((batch, hidden), dtype=np.int64)
        for block in range(geo.blocks):
            slot, group = divmod(block, geo.groups)
            units = slice(group * geo.units, (group + 1) * geo.units)
            for j in range(geo.tiles_per_block):
                tile = slot + j * geo.slots
                owner[tile * geo.rows:(tile + 1) * geo.rows, units] += 1
        assert (owner == 1).all(), (batch, hidden)
        # the backward runs the same partition over the same grid
        assert lk.bwd_geometry(batch, hidden, dtype, SMS)[:6] == geo[:6]


def test_fwd_geometry_at_the_reference_shape():
    """T, B, H = 55, 128, 512, as csrc/lstm_kernels.cu's ScanTile and
    FwdSmem lay it out. bf16: 16-row tiles x 32-unit groups, 8 slots of 16
    groups, one tile per block, 128 blocks; Wh columns 128 x (512 + 8) x
    2 B, one tile of h 16 x (512 + 8) x 2 B, the c carries 512 x 4 B, a
    tile's xpb 4 x 512 x 2 B. f32: 32 x 16, 4 slots of 32 groups; Wh 64 x
    512 x 4 B, h 32 x (512 + 4) x 4 B, the same carries, the k halves'
    exchange 8 x 256 x 4 B and xpb 4 x 512 x 4 B."""
    bf16 = lk.fwd_geometry(128, 512, torch.bfloat16, SMS)
    assert (bf16.rows, bf16.units, bf16.groups, bf16.slots,
            bf16.tiles_per_block, bf16.blocks, bf16.counters) == (
                16, 32, 16, 8, 1, 128, 8)
    assert bf16.smem == (128 + 16) * 520 * 2 + 512 * 4 + 4 * 512 * 2 == 155_904
    f32 = lk.fwd_geometry(128, 512, torch.float32, SMS)
    assert (f32.rows, f32.units, f32.groups, f32.slots, f32.blocks) == (
        32, 16, 32, 4, 128)
    assert f32.smem == (64 * 512 + 32 * 516 + 512 + 8 * 256 + 4 * 512) * 4 \
        == 215_552
    # B=256 walks two tiles per block on the same 128 blocks, one more
    # carry tile each
    b256 = lk.fwd_geometry(256, 512, torch.bfloat16, SMS)
    assert b256[3:7] == (8, 2, 128, 155_904 + 512 * 4)
    # B=300: 19 tiles over 8 slots; slot 3's third tile (19) is past the
    # batch
    b300 = lk.fwd_geometry(300, 512, torch.bfloat16, SMS)
    assert (b300.slots, b300.tiles_per_block) == (8, 3)
    assert 3 + 2 * b300.slots >= -(-300 // 16)


def test_fwd_geometry_refuses_what_does_not_fit():
    """More unit groups than multiprocessors, more shared memory than a
    block has, or another type,
    raise instead of launching a grid that cannot be resident. H=1024 does
    not fit in either type (its Wh columns alone: bf16 128 x 1032 x 2 B,
    f32 64 x 1024 x 4 B)."""
    with pytest.raises(ValueError, match="unit groups"):
        lk.fwd_geometry(128, 32 * 133, torch.bfloat16, SMS)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="shared memory"):
            lk.fwd_geometry(128, 1024, dtype, SMS)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lk.fwd_geometry(128, 512, torch.float16, SMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fwd_columns_and_pairs(dtype):
    """The Wh share holds each (unit, gate) once; the threads' two pairs
    cover the tile's rows x units once; and a thread's pair finds its four
    gates where the product leaves them. bf16: in accumulators 2q, 2q+1 of
    n tiles 2w and 2w+1 (rows lane/4, lane/4 + 8). f32: thread (k half, row
    quad, unit) reads the unit's gates as 16 consecutive 16-byte chunks
    across the warp, and the two threads of a (row quad, unit) keep
    different rows."""
    rows, units = lk.SCAN_TILE[dtype]
    pairs = [_pair(tid, p, dtype) for tid in range(THREADS) for p in (0, 1)]
    assert sorted(pairs) == [(r, u) for r in range(rows)
                             for u in range(units)]
    if dtype == torch.bfloat16:
        assert sorted(_column(u, g) for u in range(units)
                      for g in range(4)) == list(range(4 * units))
    else:
        kp = 48
        index = [_w_index(u, g, k, kp) for u in range(units)
                 for g in range(4) for k in range(kp)]
        assert sorted(index) == list(range(4 * units * kp))
    for tid in range(THREADS):
        lane, warp = tid % 32, tid // 32
        for p in (0, 1):
            row, unit = _pair(tid, p, dtype)
            if dtype == torch.bfloat16:
                # accumulator e of n tile nt: column warp*16 + nt*8 + 2q + e
                assert [warp * 16 + nt * 8 + 2 * (lane % 4) + e
                        for nt in (0, 1) for e in (0, 1)] == [
                            _column(unit, g) for g in range(4)]
            else:
                assert unit == tid % 16 == lane % 16
                assert row % 8 == tid % 128 // 16
                assert row // 8 == 2 * (tid // 128) + p
                for g in range(4):
                    assert _w_index(unit, g, 20, kp) == (
                        _w_index(0, g, 20, kp) + 4 * unit)


def _partition_forward(xpb, wh, c0, h0, geo):
    """The forward kernel's partition step by step: each batch-tile slot
    runs a scan of its own (the per-slot barrier), in which each (tile,
    group) block puts the pre-activations of its rows and units together
    from its rows of cd(h_{t-1}) . Wh and its Wh columns in the kernel's
    column order; f32 sums and carries, outputs rounded once. The slot
    reads h_{t-1} and its carries from planes in which every row it does
    not own is NaN, and its pre-activations start as NaN, so a block that
    needed another slot's rows, or a pair no block wrote, would show. (The
    product and the gate math run over the whole plane, as
    ``lstm_fwd_plain`` runs them: an entry depends on its own row alone,
    and CPU sums and vector paths keep the plain version's order.) Returns
    (hseq, cseq, acts, c_fin)."""
    steps, batch, gdim = xpb.shape
    hidden = gdim // 4
    cd, out = wh.dtype, xpb.dtype
    w = wh.float()
    nan = float("nan")
    hseq = torch.full((steps, batch, hidden), nan, dtype=out)
    cseq, acts = torch.full_like(hseq, nan), torch.full_like(xpb, nan)
    c_fin = torch.full((batch, hidden), nan, dtype=out)
    for slot in range(geo.slots):
        tiles = [slice(tile * geo.rows, min(batch, (tile + 1) * geo.rows))
                 for tile in range(slot, slot + geo.tiles_per_block
                                   * geo.slots, geo.slots)
                 if tile * geo.rows < batch]
        hprev = torch.full_like(h0, nan)
        c = torch.full((batch, hidden), nan)
        for r in tiles:
            hprev[r], c[r] = h0[r], c0[r].float()
        for t in range(steps):
            if t > 0:
                hprev = hseq[t - 1]
            prod = hprev.to(cd).float() @ w
            pre = torch.full((batch, gdim), nan)
            for r in tiles:
                for group in range(geo.groups):
                    u0 = group * geo.units
                    idx = torch.tensor([
                        g * hidden + u0 + u
                        for u, g in _share_order(geo.units, cd)
                        if u0 + u < hidden])
                    pre[r, idx] = xpb[t, r][:, idx].float() + prod[r][:, idx]
            i, f, g, o = pre.chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c = f * c + i * g
            h = o * torch.tanh(c)
            gates = torch.cat([i, f, g, o], dim=-1)
            for r in tiles:
                hseq[t, r] = h[r].to(out)
                cseq[t, r] = c[r].to(out)
                acts[t, r] = gates[r].to(out)
        for r in tiles:
            c_fin[r] = c[r].to(out)
    return hseq, cseq, acts, c_fin


@pytest.mark.parametrize("sms", [3, 4, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partition_model_matches_plain_and_pallas(rng, dtype, sms):
    """T, B, H = 5, 40, 40 on grids of 3, 4 and 64 multiprocessors: one
    slot walking every tile, two slots (bf16: slot 1's second tile lies
    past the batch) and a slot per tile. f32: equal to ``lstm_fwd_plain``
    exactly (the same products, each summed over k in one order); both
    types: the JAX Pallas forward in interpret mode within TOL, and the
    lean outputs are the residual ones."""
    jdt, tdt = DTYPES[dtype]
    steps, batch, hidden = 5, 40, 40
    arrays = [a.astype(np.float32) for a in (
        rng.standard_normal((steps, batch, 4 * hidden)),
        rng.standard_normal((hidden, 4 * hidden)) * 0.3,
        rng.standard_normal((batch, hidden)),
        rng.standard_normal((batch, hidden)))]
    targs = [torch.from_numpy(a).to(tdt) for a in arrays]
    geo = lk.fwd_geometry(batch, hidden, tdt, sms)
    got = _partition_forward(*targs, geo)
    for t in got:
        assert not t.isnan().any()
    if dtype == "float32":
        want = lk.lstm_fwd_plain(*targs, save_residuals=True)
        for g, w in zip(got[:3], want):
            assert torch.equal(g, w)
    want = _fwd_call(*[jnp.asarray(a, jdt) for a in arrays], True, 1)
    for name, g, w in zip(("hseq", "cseq", "acts"), got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   err_msg=name, **TOL[dtype])
    assert torch.equal(got[3], got[1][-1])
