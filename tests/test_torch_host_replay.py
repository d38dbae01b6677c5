"""The port's host replay against the JAX package's: the same blocks and
seed give bit-equal samples under the native sum tree and the numpy twin,
the port's native tree against JAX's and the numpy twin, the staleness
guard's drops, the ring accountant, the host ring's bytes against the
port's device replay, and a native build that fails."""

import dataclasses

import numpy as np
import pytest

from r2d2_tpu.ops.sum_tree import tree_init_np as j_tree_init_np
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu.replay.structs import RingAccountant as JRingAccountant
from r2d2_tpu_torch import native
from r2d2_tpu_torch.ops import _build
from r2d2_tpu_torch.ops.sum_tree import (tree_init_np, tree_sample_np,
                                         tree_update_np)
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.host_replay import HostReplay, batch_layout
from r2d2_tpu_torch.replay.structs import RingAccountant, SampleBatch
from tests.test_torch_replay import specs, synthetic_blocks

pytestmark = pytest.mark.torch_port


def _filled(spec, jspec, blocks, use_native, seed=3):
    port = HostReplay(spec, seed=seed, use_native=use_native)
    ref = JHostReplay(jspec, seed=seed, use_native=use_native)
    if use_native:
        assert ref._native is not None, "the JAX native tree did not load"
    for block in blocks:
        port.add(block)
        ref.add(block)
    return port, ref


def _assert_batches_equal(got, want):
    for f in dataclasses.fields(SampleBatch):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy_twin", "native"])
def test_host_replay_samples_bit_equal_to_jax(use_native):
    """13 blocks into an 8-row ring (it wraps), then three rounds of
    sample -> priority write-back -> one more block: every field of every
    sample (idxes, IS weights, windows, metadata) bit-equal to JAX's, and
    the same sizes. A sample into preallocated arrays (``out``) is the
    same sample."""
    jspec, spec = specs()
    blocks = synthetic_blocks(spec, 16, seed=2)
    port, ref = _filled(spec, jspec, blocks[:13], use_native)
    twin, _ = _filled(spec, jspec, blocks[:13], use_native)
    rng = np.random.default_rng(7)
    for i in range(3):
        got, snapshot = port.sample()
        want, jsnapshot = ref.sample()
        out = SampleBatch(**{name: np.full(shape, 99, dtype) for name, (
            shape, dtype) in batch_layout(spec).items()})
        into, _ = twin.sample(out=out)
        assert into is out and snapshot == jsnapshot == 13 + i
        _assert_batches_equal(got, want)
        _assert_batches_equal(into, want)
        td = rng.uniform(0.0, 3.0, spec.batch_size)
        for replay in (port, ref, twin):
            replay.update_priorities(got.idxes, td, snapshot)
            replay.add(blocks[13 + i])
        assert len(port) == len(ref) == len(twin)
    if not use_native:
        np.testing.assert_array_equal(port.tree, ref.tree)


def test_native_sum_tree_matches_jax_and_numpy_twin(rng):
    """The port's C++ tree against JAX's and the numpy twin: totals after
    updates (some to zero) within 1e-12, the same samples and weights as
    JAX's tree for the same jitter stream, and the numpy descent run on
    that jitter; alpha = 0 leaves a zero TD at priority 0."""
    # imported here, not at collection: the JAX package builds its tree
    # with make when the module is imported
    from r2d2_tpu.native import NativeSumTree as JNativeSumTree
    cap = 100
    tree_native = native.NativeSumTree(cap)
    ref = JNativeSumTree(cap)
    layers, tree = tree_init_np(cap)
    assert (layers, tree.shape) == (j_tree_init_np(cap)[0],
                                    j_tree_init_np(cap)[1].shape)
    assert tree_native.num_layers == ref.num_layers == layers
    for _ in range(5):
        n = 17
        idx = rng.choice(cap, n, replace=False).astype(np.int64)
        td = rng.uniform(0, 3, n)
        td[rng.random(n) < 0.2] = 0.0
        tree_native.update(0.9, td, idx)
        ref.update(0.9, td, idx)
        tree_update_np(layers, tree, 0.9, td, idx)
        assert tree_native.total == ref.total
        assert tree_native.total == pytest.approx(tree[0], rel=1e-12)
    idx_c, w_c = tree_native.sample(0.6, 32, np.random.default_rng(123))
    idx_j, w_j = ref.sample(0.6, 32, np.random.default_rng(123))
    np.testing.assert_array_equal(idx_c, idx_j)
    np.testing.assert_array_equal(w_c, w_j)
    # the numpy descent on the native jitter, uniform(0, 1) per stratum
    jitter = np.random.default_rng(123).uniform(0.0, 1.0, 32)
    interval = tree[0] / 32
    prefix = np.minimum((np.arange(32) + jitter) * interval,
                        tree[0] * (1 - 1e-12))
    node = np.zeros(32, np.int64)
    for _ in range(layers - 1):
        left, right = tree[2 * node + 1], tree[2 * node + 2]
        go_left = (prefix < left) | (right <= 0.0)
        node = np.where(go_left, 2 * node + 1, 2 * node + 2)
        prefix = np.where(go_left, np.minimum(prefix, left * (1 - 1e-12)),
                          prefix - left)
    np.testing.assert_array_equal(idx_c, node - (2 ** (layers - 1) - 1))
    p = tree[node]
    np.testing.assert_allclose(w_c, (p / p.min()) ** -0.6, rtol=1e-12)
    # the twin draws uniform(0, interval) itself: its own stream
    idx_np, _ = tree_sample_np(layers, tree, 0.6, 32,
                               np.random.default_rng(123))
    assert idx_np.shape == (32,)
    zero = native.NativeSumTree(8)
    zero.update(0.0, np.array([0.0, 2.0]), np.array([0, 1], np.int64))
    assert zero.total == pytest.approx(1.0)


def test_native_sum_tree_refuses_bad_leaves():
    tree = native.NativeSumTree(8)
    with pytest.raises(IndexError):
        tree.update(0.9, np.array([1.0]), np.array([8], np.int64))
    with pytest.raises(ValueError):
        tree.update(0.9, np.array([1.0, 2.0]), np.array([1], np.int64))


@pytest.mark.parametrize("adds", [0, 1, 3, 4, 5, 7, 8, 9])
def test_staleness_guard_drops_what_jax_drops(adds):
    """Three blocks, a sample, then ``adds`` more blocks (pointer from 3:
    the stale range unwrapped for adds <= 4, wrapped past the ring's end
    for 5-7, the whole ring for >= 8, where the pointer is back at 3
    after exactly 8), then the stale write-back: the port's tree equals
    JAX's, whatever each dropped."""
    jspec, spec = specs()
    blocks = synthetic_blocks(spec, 3 + adds, seed=4)
    port, ref = _filled(spec, jspec, blocks[:3], use_native=False)
    batch, snapshot = port.sample()
    _, jsnapshot = ref.sample()
    for block in blocks[3:]:
        port.add(block)
        ref.add(block)
    assert port.ring.stale_adds(snapshot) == adds
    before = port.tree.copy()
    td = np.full(spec.batch_size, 99.0)
    port.update_priorities(batch.idxes, td, snapshot)
    ref.update_priorities(batch.idxes, td, jsnapshot)
    np.testing.assert_array_equal(port.tree, ref.tree)
    if adds >= spec.num_blocks:
        np.testing.assert_array_equal(port.tree, before)


def test_staleness_guard_partial_wrap_and_full_lap():
    """JAX's two cases: six adds past a sample taken at pointer 3 wrap over
    block 0, whose leaves keep the new block's priorities; a full lap
    (the pointer back at its sampled value) drops every update."""
    _, spec = specs()
    host = HostReplay(spec, seed=0, use_native=False)
    blocks = synthetic_blocks(spec, 3 + 6 + spec.num_blocks, seed=6)
    for block in blocks[:3]:
        host.add(block)
    assert len(host) == 3 * spec.block_length
    batch, snapshot = host.sample()
    assert snapshot == 3
    for block in blocks[3:9]:
        host.add(block)
    leaf0 = 2 ** host.tree_layers // 2 - 1
    before = host.tree[leaf0:leaf0 + spec.seqs_per_block].copy()
    host.update_priorities(batch.idxes, np.full(spec.batch_size, 99.0),
                           snapshot)
    np.testing.assert_array_equal(
        host.tree[leaf0:leaf0 + spec.seqs_per_block], before)

    batch, snapshot = host.sample()
    for block in blocks[9:]:
        host.add(block)
    assert host.ring.ptr == 9 % spec.num_blocks
    before = host.tree.copy()
    host.update_priorities(batch.idxes, np.full(spec.batch_size, 99.0),
                           snapshot)
    np.testing.assert_array_equal(host.tree, before)


def test_ring_accountant_matches_jax():
    """total_adds never wraps, stale_adds counts adds since a snapshot,
    advance returns the slot and stamps its weight version, and
    live_versions lists the stamps of slots that hold data, as JAX's."""
    port, ref = RingAccountant(3), JRingAccountant(3)
    for i, (steps, version) in enumerate([(5, 0), (0, 1), (5, 2), (5, 3),
                                          (5, -1)]):
        assert port.advance(steps, version) == ref.advance(steps, version)
        for name in ("ptr", "total_adds", "slot_steps", "buffer_steps",
                     "slot_versions"):
            assert getattr(port, name) == getattr(ref, name), name
        assert port.live_versions() == ref.live_versions()
        assert port.stale_adds(2) == ref.stale_adds(2) == i + 1 - 2
    assert port.advance(7) == 2 and port.slot_versions[2] == -1


@pytest.mark.parametrize("exact_gather", [False, True],
                         ids=["unpadded", "padded"])
def test_host_ring_stores_the_device_replays_bytes(exact_gather):
    """The host ring holds what the port's device replay holds for the
    same blocks: frames (unpadded on the host; the device ring's true
    frame in the corner of its padded storage), actions, rewards and the
    sequence metadata."""
    _, spec = specs(exact_gather=exact_gather)
    blocks = synthetic_blocks(spec, 11, seed=8)
    state = tdr.replay_init(spec, "cpu")
    host = HostReplay(spec, use_native=False)
    for block in blocks:
        tdr.replay_add(spec, state, block)
        host.add(block)
    assert host.obs.shape[2:] == (spec.frame_height, spec.frame_width)
    np.testing.assert_array_equal(
        state.obs[:, :, :spec.frame_height, :spec.frame_width].numpy(),
        host.obs)
    for name in ("last_action", "hidden", "action", "reward", "gamma",
                 "burn_in_steps", "learning_steps", "forward_steps",
                 "seq_start", "weight_version", "lane"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      getattr(host, name), err_msg=name)
    assert host.ring.ptr == state.block_ptr


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A sum tree source that does not compile raises from the build, from
    NativeSumTree and from HostReplay (no quiet numpy fallback); the numpy
    twin is there only when asked for."""
    broken = tmp_path / "sum_tree.cc"
    broken.write_text('extern "C" { int st_create( }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for sum_tree.cc"):
        _build.load_host(broken)
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed"):
        native.NativeSumTree(8)
    _, spec = specs()
    with pytest.raises(RuntimeError, match="failed"):
        HostReplay(spec, use_native=True)
    assert HostReplay(spec, use_native=False)._native is None
