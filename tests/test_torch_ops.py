"""PyTorch port vs the JAX package: value rescaling, index math, mixed
priorities, n-step returns and the sum tree, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.ops import indexing as jidx
from r2d2_tpu.ops import priority as jprio
from r2d2_tpu.ops import returns as jret
from r2d2_tpu.ops import sum_tree as jtree
from r2d2_tpu.ops import value as jval
from r2d2_tpu_torch.ops import indexing as tidx
from r2d2_tpu_torch.ops import priority as tprio
from r2d2_tpu_torch.ops import returns as tret
from r2d2_tpu_torch.ops import sum_tree as ttree
from r2d2_tpu_torch.ops import value as tval

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("name", ["value_rescale", "inverse_value_rescale"])
def test_value_rescale_matches_jax(rng, name):
    x = (rng.normal(size=(64, 7)) * 30).astype(np.float32)
    want = np.asarray(getattr(jval, name)(jnp.asarray(x), 1e-2))
    got = getattr(tval, name)(torch.from_numpy(x), 1e-2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _seq_meta(rng, batch=16, burn_max=4, learn_max=5, fwd_max=3):
    burn = rng.integers(0, burn_max + 1, batch).astype(np.int32)
    learn = rng.integers(1, learn_max + 1, batch).astype(np.int32)
    fwd = rng.integers(1, fwd_max + 1, batch).astype(np.int32)
    return burn, learn, fwd


def test_indexing_matches_jax(rng):
    burn, learn, fwd = _seq_meta(rng)
    tb, tl, tf = (torch.from_numpy(x) for x in (burn, learn, fwd))
    np.testing.assert_array_equal(
        tidx.frame_stack_indices(12, 4).numpy(),
        np.asarray(jidx.frame_stack_indices(12, 4)))
    np.testing.assert_array_equal(
        tidx.online_q_positions(tb, 5).numpy(),
        np.asarray(jidx.online_q_positions(burn, 5)))
    np.testing.assert_array_equal(
        tidx.target_q_positions(tb, tl, tf, 5, 3).numpy(),
        np.asarray(jidx.target_q_positions(burn, learn, fwd, 5, 3)))
    np.testing.assert_array_equal(
        tidx.learning_step_mask(tl, 5).numpy(),
        np.asarray(jidx.learning_step_mask(learn, 5)))


def test_mixed_priority_matches_jax(rng):
    td = np.abs(rng.normal(size=(16, 5))).astype(np.float32)
    mask = (rng.uniform(size=(16, 5)) < 0.7).astype(np.float32)
    mask[3] = 0.0                       # a sequence with no valid step -> 0
    want = np.asarray(jprio.mixed_td_errors_masked(jnp.asarray(td),
                                                   jnp.asarray(mask), 0.9))
    got = tprio.mixed_td_errors_masked(torch.from_numpy(td),
                                       torch.from_numpy(mask), 0.9).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[3] == 0.0

    steps = np.array([3, 5, 1, 4], np.int32)
    flat = np.abs(rng.normal(size=steps.sum())).astype(np.float32)
    np.testing.assert_allclose(
        tprio.mixed_td_errors_ragged(flat, steps, 0.9),
        jprio.mixed_td_errors_ragged(flat, steps, 0.9), atol=1e-6)


@pytest.mark.parametrize("bootstrap", [True, False])
def test_returns_match_jax(rng, bootstrap):
    size, n, gamma = 17, 5, 0.97
    rewards = rng.normal(size=size).astype(np.float32)
    np.testing.assert_allclose(tret.n_step_return(rewards, gamma, n),
                               jret.n_step_return(rewards, gamma, n),
                               atol=1e-6)
    gam = tret.n_step_gamma(size, gamma, n, bootstrap)
    np.testing.assert_allclose(gam, jret.n_step_gamma(size, gamma, n,
                                                      bootstrap), atol=1e-6)
    q = rng.normal(size=(size + 1, 6)).astype(np.float32)
    actions = rng.integers(0, 6, size).astype(np.int32)
    ret = tret.n_step_return(rewards, gamma, n)
    np.testing.assert_allclose(
        tret.initial_priorities(q, actions, ret, gam, n),
        jret.initial_priorities(q, actions, ret, gam, n), atol=1e-6)


LAYERS = 8                              # 128 leaves


def _leaves(rng, count=100):
    """Duplicate-free leaf indices (duplicates make the winner of the
    scatter unspecified in both frameworks) and nonnegative TD errors,
    some of them 0 (empty slots)."""
    idx = rng.permutation(2 ** (LAYERS - 1))[:count].astype(np.int32)
    td = rng.uniform(0.0, 3.0, count).astype(np.float32)
    td[::7] = 0.0
    return idx, td


def _jax_tree(idx, td, alpha):
    return jtree.tree_update(LAYERS, jnp.zeros(2 ** LAYERS - 1, jnp.float32),
                             alpha, jnp.asarray(td), jnp.asarray(idx))


@pytest.mark.parametrize("alpha", [1.0, 0.9])
def test_tree_update_matches_jax(rng, alpha):
    """alpha=1: leaves are exact, so the whole f32 tree must be bit-equal
    (same sums in the same order). alpha=0.9: XLA's and PyTorch's f32 pow
    may round one ulp apart, so leaves and sums agree to rtol 1e-6."""
    idx, td = _leaves(rng)
    want = np.asarray(_jax_tree(idx, td, alpha))
    got = ttree.tree_update(LAYERS, torch.zeros(2 ** LAYERS - 1), alpha,
                            torch.from_numpy(td),
                            torch.from_numpy(idx)).numpy()
    if alpha == 1.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_tree_update_second_write_rebuilds_parents(rng):
    """A later update of some leaves re-sums only their ancestors, bit-equal
    to JAX at alpha=1."""
    idx, td = _leaves(rng)
    j = _jax_tree(idx, td, 1.0)
    t = ttree.tree_update(LAYERS, torch.zeros(2 ** LAYERS - 1), 1.0,
                          torch.from_numpy(td), torch.from_numpy(idx))
    idx2 = idx[:30]
    td2 = rng.uniform(0.0, 5.0, 30).astype(np.float32)
    j = jtree.tree_update(LAYERS, j, 1.0, jnp.asarray(td2), jnp.asarray(idx2))
    ttree.tree_update(LAYERS, t, 1.0, torch.from_numpy(td2),
                      torch.from_numpy(idx2))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("num_samples", [8, 32])
def test_tree_sample_with_injected_jitter_matches_jax(rng, num_samples):
    idx, td = _leaves(rng)
    tree = _jax_tree(idx, td, 0.9)
    key = jax.random.PRNGKey(7)
    want_idx, want_w = jtree.tree_sample(LAYERS, tree, 0.6, num_samples, key)
    jitter = jax.random.uniform(key, (num_samples,), dtype=jnp.float32,
                                minval=0.0, maxval=1.0)
    got_idx, got_w = ttree.tree_sample(
        LAYERS, torch.from_numpy(np.array(tree)), 0.6, num_samples,
        uniform=torch.from_numpy(np.asarray(jitter)))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    # never a zero-priority leaf
    assert np.all(np.asarray(tree)[got_idx.numpy() + 2 ** (LAYERS - 1) - 1] > 0)


def test_tree_sample_never_enters_zero_mass_subtree():
    """f32 sums can leave a parent larger than its children's sum. Here
    node 2 holds 1.0 over children 0.5 + 0.0, so the top stratum (prefix in
    [1.5, 2)) reaches node 2 with more mass left than its left child: the
    descent must stay out of the empty right leaf, as the JAX tree_sample
    does."""
    tree = np.array([2.0, 1.0, 1.0, 0.6, 0.4, 0.5, 0.0], np.float32)
    key = jax.random.PRNGKey(11)
    want_idx, want_w = jtree.tree_sample(3, jnp.asarray(tree), 0.6, 4, key)
    jitter = np.array(jax.random.uniform(key, (4,), dtype=jnp.float32))
    got_idx, got_w = ttree.tree_sample(3, torch.from_numpy(tree), 0.6, 4,
                                       uniform=torch.from_numpy(jitter))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_idx[3] == 2 and np.all(np.isfinite(got_w.numpy()))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)


def test_tree_sample_generator_is_reproducible(rng):
    idx, td = _leaves(rng)
    tree = torch.from_numpy(np.asarray(_jax_tree(idx, td, 0.9)))
    a = ttree.tree_sample(LAYERS, tree, 0.6, 16,
                          generator=torch.Generator().manual_seed(3))
    b = ttree.tree_sample(LAYERS, tree, 0.6, 16,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_numpy_tree_twins_match_jax(rng):
    idx, td = _leaves(rng)
    tree_j = np.zeros(2 ** LAYERS - 1)
    tree_t = np.zeros(2 ** LAYERS - 1)
    jtree.tree_update_np(LAYERS, tree_j, 0.9, td, idx)
    ttree.tree_update_np(LAYERS, tree_t, 0.9, td, idx)
    np.testing.assert_array_equal(tree_t, tree_j)
    sj = jtree.tree_sample_np(LAYERS, tree_j, 0.6, 16,
                              np.random.default_rng(5))
    st = ttree.tree_sample_np(LAYERS, tree_t, 0.6, 16,
                              np.random.default_rng(5))
    np.testing.assert_array_equal(st[0], sj[0])
    np.testing.assert_array_equal(st[1], sj[1])
    assert ttree.tree_num_layers(100) == jtree.tree_num_layers(100)
