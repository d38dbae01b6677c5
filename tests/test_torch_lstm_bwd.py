"""The backward LSTM kernel's design on the CPU (``ops/lstm_kernels.py``):
dWh as one product after the scan, which the kernel computes instead of a
per-step update, against the step-by-step plain backward and the JAX Pallas
kernel (interpret mode); and ``bwd_geometry``, the grid and shared memory
the wrapper launches it with.

The kernel itself runs only on the card; chip_smoke.py holds it against
``lstm_bwd_plain`` there."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.pallas_lstm import lstm_scan_pallas
from r2d2_tpu_torch.ops import lstm_kernels as lk

pytestmark = pytest.mark.torch_port

T, B, H = 12, 8, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMS = 132                                   # H100 SXM multiprocessors


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dwh_after_scan(h0, hseq, dxpb, cd):
    """dWh as the kernel computes it once the scan is done: one product over
    the T*B rows, h_prev = [h0; hseq[:-1]], both operands through cd."""
    hidden = h0.shape[-1]
    hprev = torch.cat([h0[None], hseq[:-1]]).reshape(-1, hidden)
    return (hprev.to(cd).float().T
            @ dxpb.reshape(-1, 4 * hidden).to(cd).float())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dwh_is_one_product_after_the_scan(rng, dtype):
    """The premise of taking dWh off the serial chain: the sum over steps
    of cd(h_prev_t)^T cd(dxpb_t), taken as one product after the scan,
    equals the step-by-step dWh of ``lstm_bwd_plain`` (f32: within 1e-5 of
    max |dWh|, the two sum the same products in other orders) and the JAX
    Pallas kernel's (within chip_smoke's DWH_REL of max |dWh|: the two
    forwards round bf16 outputs apart by an ulp at most)."""
    jdt, tdt = DTYPES[dtype]
    arrays = [a.astype(np.float32) for a in (
        rng.standard_normal((T, B, 4 * H)), rng.standard_normal((H, 4 * H))
        * 0.3, rng.standard_normal((B, H)), rng.standard_normal((B, H)))]
    w = rng.standard_normal((T, B, H)).astype(np.float32)
    carry_w = (1.3, 0.7)

    def jloss(wh):
        args = [jnp.asarray(a, jdt) for a in arrays]
        hs, (c, h) = lstm_scan_pallas(args[0], wh, args[2], args[3],
                                      interpret=True)
        f32 = jnp.float32
        return (jnp.sum(hs.astype(f32) * w) + jnp.sum(c.astype(f32)
                                                      * carry_w[0])
                + jnp.sum(h.astype(f32) * carry_w[1]))

    want_jax = np.asarray(jax.grad(jloss)(jnp.asarray(arrays[1], jdt))
                          ).astype(np.float32)
    xpb, wh, c0, h0 = (torch.from_numpy(a).to(tdt) for a in arrays)
    hseq, cseq, acts = lk.lstm_fwd_plain(xpb, wh, c0, h0)
    dhseq = torch.from_numpy(w).to(tdt)
    dcfin = torch.full((B, H), carry_w[0]).to(tdt)
    dhfin = torch.full((B, H), carry_w[1]).to(tdt)
    dxpb, dwh, _, _ = lk.lstm_bwd_plain(wh, c0, h0, hseq, cseq, acts, dhseq,
                                        dcfin, dhfin)
    got = _dwh_after_scan(h0, hseq, dxpb, wh.dtype)
    assert got.dtype == torch.float32 and got.shape == (H, 4 * H)
    scale = dwh.abs().max().item()
    assert (got - dwh).abs().max().item() <= 1e-5 * scale
    rel = _chip_smoke().DWH_REL[dtype]
    assert np.abs(got.numpy() - want_jax).max() <= rel * scale


@pytest.mark.parametrize("batch", [1, 3, 33, 128, 130, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_bwd_geometry_owns_every_pair_once(batch, dtype):
    """At 132 multiprocessors, for H in {16, 17, 24, 512}: the grid is
    resident at one block per multiprocessor, its shared memory fits a
    block, every (row, unit) belongs to exactly one block under the
    kernel's mapping, and there is one barrier counter per slot plus the
    grid's."""
    for hidden in (16, 17, 24, 512):
        geo = lk.bwd_geometry(batch, hidden, dtype, SMS)
        assert (geo.rows, geo.units) == lk.SCAN_TILE[dtype]
        assert geo.blocks == geo.slots * geo.groups <= SMS
        assert geo.smem <= lk.SMEM_LIMIT == 232_448
        assert geo.counters == geo.slots + 1
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


def test_bwd_geometry_at_the_reference_shape():
    """T, B, H = 55, 128, 512, as csrc/lstm_kernels.cu's BwdTile and BwdSmem
    lay it out. bf16: 16-row tiles x 32-unit groups, 8 slots of 16 groups,
    one tile per block, 128 blocks; Wh rows 32 x (2048 + 8) x 2 B, 8 warps
    x 8 slices of 16 x (16 + 8) x 2 B, partial sums 8 x 512 x 4 B, two
    carries 512 x 4 B. f32: 32 x 16, 4 slots of 32 groups; 16 x (2048 + 4)
    x 4, 8 x 3 x 32 x (16 + 4) x 4, the same sums and carries."""
    bf16 = lk.bwd_geometry(128, 512, torch.bfloat16, SMS)
    assert (bf16.rows, bf16.units, bf16.groups, bf16.slots,
            bf16.tiles_per_block, bf16.blocks, bf16.counters) == (
                16, 32, 16, 8, 1, 128, 9)
    sums_carries = 8 * 512 * 4 + 2 * 512 * 4
    assert bf16.smem == 32 * 2056 * 2 + 8 * 8 * 16 * 24 * 2 + sums_carries
    f32 = lk.bwd_geometry(128, 512, torch.float32, SMS)
    assert (f32.groups, f32.slots, f32.blocks) == (32, 4, 128)
    assert f32.smem == 16 * 2052 * 4 + 8 * 3 * 32 * 20 * 4 + sums_carries
    # B=256 walks two tiles per block on the same 128 blocks
    assert lk.bwd_geometry(256, 512, torch.bfloat16, SMS)[3:6] == (8, 2, 128)


def test_bwd_geometry_refuses_what_does_not_fit():
    """More unit groups than multiprocessors, or more shared memory than a
    block has, raise instead of launching a grid that cannot be resident."""
    with pytest.raises(ValueError, match="unit groups"):
        lk.bwd_geometry(128, 32 * 133, torch.bfloat16, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        lk.bwd_geometry(128, 1024, torch.float32, SMS)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lk.bwd_geometry(128, 512, torch.float16, SMS)
