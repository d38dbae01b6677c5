"""The gather kernel's work partition (ops/replay_kernels.py gather_plan)
and the gather's plain version on the sampler's int64 indices.

The kernel walks the plan's items on the card; chip_smoke.py holds it
against ``gather_windows_plain`` there (exact). Here: the items cover every
byte of every window exactly once, their chunk suits bulk copies, and the
plain version matches the JAX package's Pallas gathers (interpret mode)
with int64 indices as well."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.pallas_kernels import (gather_rows_exact_pallas,
                                         gather_rows_pallas)
from r2d2_tpu_torch.ops import replay_kernels as rk

pytestmark = pytest.mark.torch_port

# (batch, window, frame bytes, multiprocessors, CTAs a multiprocessor,
#  largest chunk)
PLAN_CASES = {
    "reference unpadded": (128, 58, 84 * 84, 132, 1, 16384),
    "reference padded": (128, 58, 96 * 128, 132, 1, 16384),
    "two CTAs a multiprocessor": (128, 58, 84 * 84, 132, 2, 12288),
    "large chunks": (128, 58, 96 * 128, 132, 1, 49152),
    "window 1": (128, 1, 84 * 84, 132, 1, 24576),
    "batch 1": (1, 58, 84 * 84, 132, 1, 24576),
    "batch 1, window 1": (1, 1, 84 * 84, 132, 1, 24576),
    "partial last chunk": (5, 3, 84 * 84, 8, 1, 16384),
    "byte path 83x83": (128, 58, 83 * 83, 132, 4, 32768),
    "byte path, tiny frame": (3, 2, 5, 4, 2, 32768),
    "more CTAs than items": (2, 3, 48, 132, 1, 24576),
}


def _covered(plan):
    """How many items cover each byte of each window."""
    hits = np.zeros((plan.batch, plan.window_bytes), np.int32)
    for cta in range(plan.grid):
        for sample, offset, count in plan.walk(cta):
            assert count > 0
            hits[sample, offset:offset + count] += 1
    return hits


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_covers_each_byte_once(case):
    batch, window, frame, sms, ctas, max_chunk = PLAN_CASES[case]
    plan = rk.gather_plan(batch, window, frame, sms, ctas, max_chunk)
    assert plan.batch == batch and plan.window_bytes == window * frame
    assert (_covered(plan) == 1).all()
    assert sum(len(plan.walk(c)) for c in range(plan.grid)) == plan.items


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_chunk_and_grid_fit_the_kernel(case):
    """The chunk is a multiple of 16 (so every item of a window whose frame
    bytes are one is a legal bulk copy) and fits a stage buffer; the grid
    is persistent: at most ``ctas`` a multiprocessor, and no CTA idle."""
    batch, window, frame, sms, ctas, max_chunk = PLAN_CASES[case]
    plan = rk.gather_plan(batch, window, frame, sms, ctas, max_chunk)
    assert plan.chunk % 16 == 0 and 16 <= plan.chunk <= max_chunk
    assert 1 <= plan.grid <= min(sms * ctas, plan.items)
    assert all(plan.walk(c) for c in range(plan.grid))
    assert (plan.grid - 1) * plan.per_cta < plan.items \
        <= plan.grid * plan.per_cta
    if frame % 16 == 0:
        assert all(offset % 16 == 0 and count % 16 == 0
                   for c in range(plan.grid)
                   for _, offset, count in plan.walk(c))
    last = plan.window_bytes - (plan.chunks_per_sample - 1) * plan.chunk
    assert 0 < last <= plan.chunk
    if case == "partial last chunk":
        assert last < plan.chunk


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_plan_balances_the_reference_shape(padded):
    """At the reference shape every CTA moves within 2% of the mean bytes,
    and a CTA walks items of many samples (interleaved, not one window)."""
    frame = 96 * 128 if padded else 84 * 84
    plan = rk.gather_plan(128, 58, frame, 132)
    loads = [sum(n for _, _, n in plan.walk(c)) for c in range(plan.grid)]
    assert max(loads) <= 1.02 * np.mean(loads)
    assert len({s for s, _, _ in plan.walk(0)}) == len(plan.walk(0)) > 8


def test_plan_refuses_empty_sizes():
    with pytest.raises(ValueError):
        rk.gather_plan(0, 58, 7056, 132)
    with pytest.raises(ValueError):
        rk.gather_plan(128, 58, 7056, 132, 1, 8)


def test_c_entry_takes_the_bound_arguments():
    """The wrapper's ctypes argument list matches gather_windows's C
    signature in csrc/replay_kernels.cu."""
    src = (Path(rk.__file__).resolve().parent.parent / "csrc"
           / "replay_kernels.cu").read_text()
    m = re.search(r'extern "C" int gather_windows\(([^)]*)\)', src)
    assert m is not None
    assert len(m.group(1).split(",")) == len(rk._SIGNATURES["gather_windows"])


def _ring(rng, hs, ws, n=6, row_len=30):
    return rng.integers(0, 256, (n, row_len, hs, ws)).astype(np.uint8)


@pytest.mark.parametrize("index_dtypes", [(np.int64, np.int32),
                                          (np.int64, np.int64),
                                          (np.int32, np.int64)],
                         ids=["bi64", "both64", "st64"])
@pytest.mark.parametrize("layout", ["unpadded", "padded"])
def test_gather_plain_matches_pallas_on_int64(rng, layout, index_dtypes):
    """The plain version on int64 indices (the sampler's block index) vs
    the row gather (K1, unpadded) and the exact-read gather (K2, padded
    32x128 tiles) in interpret mode, which take int32: exact uint8."""
    hs, ws = (12, 16) if layout == "unpadded" else (32, 128)
    ring = _ring(rng, hs, ws)
    window = 9
    bi = np.array([0, 3, 3, 5, 2, 0, 1], np.int64)
    st = np.array([0, 5, 13, 30 - window, 1, 21, 7], np.int64)
    pallas = gather_rows_pallas if layout == "unpadded" else \
        gather_rows_exact_pallas
    want = np.asarray(pallas(jnp.asarray(ring), jnp.asarray(bi, jnp.int32),
                             jnp.asarray(st, jnp.int32), window, True))
    got = rk.gather_windows_plain(
        torch.from_numpy(ring), torch.from_numpy(bi.astype(index_dtypes[0])),
        torch.from_numpy(st.astype(index_dtypes[1])), window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [1, 9])
def test_cpu_dispatch_takes_int64_to_plain(rng, window):
    """A CPU ring takes the plain version whatever the index dtype, and
    launches nothing; int64 and int32 indices give the same windows."""
    rk.reset_launch_counts()
    ring = torch.from_numpy(_ring(rng, 12, 12))
    bi = torch.tensor([1, 4, 0], dtype=torch.int64)
    st = torch.tensor([2, 10, 30 - window], dtype=torch.int32)
    got = rk.gather_rows(ring, bi, st, window)
    assert torch.equal(got, rk.gather_rows(ring, bi.int(), st, window))
    assert torch.equal(got, rk.gather_windows_plain(ring, bi, st.long(),
                                                    window))
    assert rk.LAUNCHES == {"gather_windows": 0, "stack_frames": 0}


def test_cuda_gather_refuses_a_cpu_ring_with_int64_indices(rng):
    ring = torch.from_numpy(_ring(rng, 12, 12))
    idx = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        rk.gather_windows_cuda(ring, idx, idx, 4)
    assert rk.LAUNCHES["gather_windows"] == 0
