"""The port's device replay against the JAX package's: ring writes with
wrap, prioritized sampling with injected jitter, priority write-back, the
state converter, and the actor-side block assembler."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.actor.local_buffer import LocalBuffer as JLocalBuffer
from r2d2_tpu.replay import device_replay as jdr
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu.replay.structs import ReplaySpec as JReplaySpec
from r2d2_tpu_torch.actor.local_buffer import LocalBuffer
from r2d2_tpu_torch.models.convert import replay_state_from_jax
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.structs import ReplaySpec, stack_blocks
from r2d2_tpu_torch.replay.synthetic import make_synthetic_block

pytestmark = pytest.mark.torch_port

# the tiny test shape: 24x24 frames, stack 2, seq 4+5+3, 20-step blocks
SPEC = dict(num_blocks=8, seqs_per_block=4, block_length=20, burn_in=4,
            learning=5, forward=3, frame_stack=2, frame_height=24,
            frame_width=24, hidden_dim=16, batch_size=8, prio_exponent=0.9,
            is_exponent=0.6)


def specs(exact_gather=False, **kw):
    """(JAX spec, port spec) for the same shapes and storage layout."""
    base = {**SPEC, **kw}
    return (JReplaySpec(**base, pallas_gather=False, exact_gather=exact_gather),
            ReplaySpec(**base, exact_gather=exact_gather))


def synthetic_blocks(spec, count, seed=0):
    rng = np.random.default_rng(seed)
    return [make_synthetic_block(spec, rng) for _ in range(count)]


def jax_stack(blocks):
    return JBlock(**dataclasses.asdict(stack_blocks(blocks)))


def jax_filled(jspec, blocks, group=3):
    state = jdr.replay_init(jspec)
    for i in range(0, len(blocks), group):
        state = jdr.replay_add_many(jspec, state, jax_stack(blocks[i:i + group]))
    return state


def torch_filled(spec, blocks, group=3):
    state = tdr.replay_init(spec, "cpu")
    for i in range(0, len(blocks), group):
        tdr.replay_add_many(spec, state, stack_blocks(blocks[i:i + group]))
    return state


def to_numpy_state(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


FIELDS = ("tree", "obs", "last_action", "hidden", "action", "reward", "gamma",
          "burn_in_steps", "learning_steps", "forward_steps", "seq_start",
          "weight_version", "lane")


@pytest.mark.parametrize("exact_gather", [False, True],
                         ids=["unpadded", "padded"])
def test_replay_add_many_with_wrap_matches_jax(exact_gather):
    """13 blocks into an 8-row ring in groups of 3 (the ring wraps inside
    a group): every ReplayState field equal to JAX's. The tree is compared
    at rtol 1e-6 (XLA's and PyTorch's f32 pow may round one ulp apart)."""
    jspec, spec = specs(exact_gather)
    blocks = synthetic_blocks(spec, 13)
    jstate = to_numpy_state(jax_filled(jspec, blocks))
    state = torch_filled(spec, blocks)
    assert state.block_ptr == int(jstate.block_ptr) == 13 % 8
    assert state.obs.shape[2:] == (spec.stored_frame_height,
                                   spec.stored_frame_width)
    for name in FIELDS:
        got = getattr(state, name).numpy()
        want = getattr(jstate, name)
        if name == "tree":
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(tdr.replay_size(state)) == int(jdr.replay_size(jstate))
    assert spec.device_ring_bytes <= jspec.device_ring_bytes


@pytest.mark.parametrize("exact_gather", [False, True],
                         ids=["unpadded", "padded"])
def test_replay_sample_with_injected_jitter_matches_jax(exact_gather):
    """A JAX replay state carried across with the converter samples the
    same SampleBatch as JAX given JAX's jitter draws."""
    jspec, spec = specs(exact_gather)
    blocks = synthetic_blocks(spec, 11, seed=1)
    jstate = jax_filled(jspec, blocks)
    key = jax.random.PRNGKey(4)
    want = jax.tree_util.tree_map(np.asarray,
                                  jdr.replay_sample(jspec, jstate, key))
    jitter = np.asarray(jax.random.uniform(key, (spec.batch_size,),
                                           dtype=jnp.float32))
    state = replay_state_from_jax(to_numpy_state(jstate), spec, "cpu")
    got = tdr.replay_sample(spec, state, uniform=torch.from_numpy(jitter))
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), getattr(want, f.name)
        if f.name == "is_weights":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_replay_update_priorities_matches_jax():
    jspec, spec = specs()
    blocks = synthetic_blocks(spec, 8, seed=2)
    jstate = jax_filled(jspec, blocks)
    state = replay_state_from_jax(to_numpy_state(jstate), spec, "cpu")
    idx = np.random.default_rng(0).permutation(spec.num_sequences)[:10]
    td = np.random.default_rng(1).uniform(0, 2, 10).astype(np.float32)
    want = np.asarray(jdr.replay_update_priorities(
        jspec, jstate, jnp.asarray(idx, jnp.int32), jnp.asarray(td)).tree)
    tdr.replay_update_priorities(spec, state, torch.from_numpy(idx),
                                 torch.from_numpy(td))
    np.testing.assert_allclose(state.tree.numpy(), want, rtol=1e-6)


def test_converter_refuses_other_storage_layout():
    jspec, _ = specs(exact_gather=True)
    _, spec = specs(exact_gather=False)
    jstate = to_numpy_state(jdr.replay_init(jspec))
    with pytest.raises(ValueError):
        replay_state_from_jax(jstate, spec, "cpu")


def test_replay_add_many_refuses_aliasing_rows():
    _, spec = specs()
    state = tdr.replay_init(spec, "cpu")
    with pytest.raises(ValueError):
        tdr.replay_add_many(spec, state,
                            stack_blocks(synthetic_blocks(spec, 9)))


@pytest.mark.parametrize("bootstrap", [True, False])
def test_local_buffer_matches_jax(bootstrap):
    """Two blocks of one episode (the second with carried burn-in), built
    by both assemblers from the same transitions: equal fields."""
    jspec, spec = specs()
    action_dim = 4
    rng = np.random.default_rng(3)
    jlb = JLocalBuffer(jspec, action_dim, 0.9)
    tlb = LocalBuffer(spec, action_dim, 0.9)
    first = rng.integers(0, 255, (24, 24)).astype(np.uint8)
    jlb.reset(first)
    tlb.reset(first)
    for size in (20, 13):
        for t in range(size):
            args = (t % action_dim, float(rng.normal()),
                    rng.integers(0, 255, (24, 24)).astype(np.uint8),
                    rng.normal(size=action_dim).astype(np.float32),
                    rng.normal(size=(2, 16)).astype(np.float32))
            jlb.add(*args)
            tlb.add(*args)
        last_q = (rng.normal(size=action_dim).astype(np.float32)
                  if bootstrap else None)
        jblk, tblk = jlb.finish(last_q), tlb.finish(last_q)
        for f in dataclasses.fields(tblk):
            np.testing.assert_array_equal(
                np.asarray(getattr(tblk, f.name)),
                np.asarray(getattr(jblk, f.name)), err_msg=f.name)
