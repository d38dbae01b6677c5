"""The replay kernels' plain PyTorch versions against the JAX package's
Pallas kernels run in interpret mode, and the CPU dispatch rule.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there (exact)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from r2d2_tpu.ops.pallas_kernels import (gather_rows_exact_pallas,
                                         gather_rows_pallas,
                                         stack_frames_pallas,
                                         stack_frames_reference)
from r2d2_tpu_torch.config import check_kernel_setting
from r2d2_tpu_torch.ops import replay_kernels as rk

pytestmark = pytest.mark.torch_port


def _ring(rng, hs, ws, n=6, row_len=30):
    return rng.integers(0, 256, (n, row_len, hs, ws)).astype(np.uint8)


@pytest.mark.parametrize("layout", ["unpadded", "padded"])
def test_gather_plain_matches_pallas(rng, layout):
    """Unpadded storage against the row gather (K1), padded (32x128-tile)
    storage against the exact-read async-copy gather (K2): exact uint8,
    including repeated rows and windows at both row edges."""
    hs, ws = (12, 16) if layout == "unpadded" else (32, 128)
    ring = _ring(rng, hs, ws)
    window = 9
    bi = np.array([0, 3, 3, 5, 2, 0], np.int32)
    st = np.array([0, 5, 13, 30 - window, 1, 21], np.int32)
    pallas = gather_rows_pallas if layout == "unpadded" else \
        gather_rows_exact_pallas
    want = np.asarray(pallas(jnp.asarray(ring), jnp.asarray(bi),
                             jnp.asarray(st), window, True))
    got = rk.gather_windows_plain(torch.from_numpy(ring),
                                  torch.from_numpy(bi),
                                  torch.from_numpy(st), window).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_gather_plain_clamps_like_dynamic_slice(rng):
    """Off-contract indices: negative ones count from the end, then starts
    clamp to [0, row_len - window], as lax.dynamic_slice does; the kernel
    does the same."""
    from r2d2_tpu.ops.pallas_kernels import gather_rows_reference
    ring = _ring(rng, 8, 8)
    bi = np.array([1, 2, -1, 4], np.int32)
    st = np.array([-3, 27, -40, 100], np.int32)
    want = np.asarray(gather_rows_reference(jnp.asarray(ring),
                                            jnp.asarray(bi),
                                            jnp.asarray(st), 7))
    got = rk.gather_windows_plain(torch.from_numpy(ring), torch.from_numpy(bi),
                                  torch.from_numpy(st), 7).numpy()
    np.testing.assert_array_equal(got, want)


B, T, K, H, W = 2, 5, 4, 12, 12


def _obs(rng, pad):
    obs = rng.integers(0, 256, (B, T + K - 1 + 2, H, W)).astype(np.uint8)
    if pad:
        obs = np.pad(obs, ((0, 0), (0, 0), (0, 20), (0, 116)))   # 32x128
    return obs


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["planar", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas(rng, dtype, nhwc, pad):
    """Plain decode vs stack_frames_pallas(interpret=True) in both TPU
    layouts and both pad strips. Exact, in f32 and bf16: both multiply by
    f32(1/255) and round once (tighter than the one-ulp bound the JAX
    reference's divide needs, below)."""
    obs = _obs(rng, pad)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(stack_frames_pallas(
        jnp.asarray(obs), T, K, True, jdt, H, nhwc, W)).astype(np.float32)
    got = rk.stack_frames_plain(torch.from_numpy(obs), T, K, tdt, H, W)
    assert got.shape == (B, T, H, W, K) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_jax_reference(rng, dtype):
    """The JAX reference divides by 255 where the kernels multiply by
    f32(1/255): at most one ulp apart in f32, rounding to the same bf16."""
    obs = _obs(rng, False)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(stack_frames_reference(jnp.asarray(obs), T, K, jdt))
    got = rk.stack_frames_plain(torch.from_numpy(obs), T, K, tdt)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=2.0 ** -8)


def test_cpu_tensors_dispatch_to_plain(rng):
    """CPU tensors take the plain versions and launch nothing."""
    rk.reset_launch_counts()
    ring = torch.from_numpy(_ring(rng, 12, 12))
    bi = torch.tensor([1, 4], dtype=torch.int32)
    st = torch.tensor([2, 10], dtype=torch.int32)
    got = rk.gather_rows(ring, bi, st, T + K - 1)
    assert torch.equal(got, rk.gather_windows_plain(ring, bi, st, T + K - 1))
    dec = rk.stack_frames(got, T, K, torch.bfloat16)
    assert torch.equal(dec, rk.stack_frames_plain(got, T, K, torch.bfloat16))
    assert rk.LAUNCHES == {"gather_windows": 0, "stack_frames": 0}


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    ring = torch.from_numpy(_ring(rng, 12, 12))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        rk.gather_windows_cuda(ring, idx, idx, 4)
    with pytest.raises(ValueError):
        rk.stack_frames_cuda(ring, 4, 2)
    assert rk.LAUNCHES == {"gather_windows": 0, "stack_frames": 0}


def test_kernel_knobs_must_match_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    check_kernel_setting("auto", cpu, "x")
    check_kernel_setting("auto", cuda, "x")
    check_kernel_setting("off", cpu, "x")
    check_kernel_setting("on", cuda, "x")
    with pytest.raises(ValueError):
        check_kernel_setting("on", cpu, "x")
    with pytest.raises(ValueError):
        check_kernel_setting("off", cuda, "x")


def test_bf16_plain_rounds_once_from_f32(rng):
    """bf16 output = f32 normalize rounded once (round-to-nearest-even),
    as ml_dtypes casts it."""
    obs = torch.from_numpy(_obs(rng, False))
    f32 = rk.stack_frames_plain(obs, T, K, torch.float32).numpy()
    bf = rk.stack_frames_plain(obs, T, K, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        bf, f32.astype(ml_dtypes.bfloat16).astype(np.float32))
