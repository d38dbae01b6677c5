"""The port's shared-memory block ring (runtime/shm_feeder.py over its own
native/shm_ring.cc), the cases of the JAX package's test_shm_feeder.py:
every field round-trips, FIFO and capacity, many producers, a slot wedged
by a dead producer recovered, a pickled handle attached; the slot layout
is byte-compatible with the JAX package's ring; BlockQueue's transports
(a failed build raises, shm_transport off is the only way to a
multiprocessing queue)."""

import dataclasses
import multiprocessing as mp
import pickle
import queue as queue_mod
import threading

import numpy as np
import pytest

from r2d2_tpu_torch.replay.structs import ReplaySpec
from r2d2_tpu_torch.runtime.feeder import BlockQueue
from r2d2_tpu_torch.runtime.shm_feeder import ShmBlockRing
from tests.test_torch_replay import SPEC, synthetic_blocks

pytestmark = pytest.mark.torch_port


@pytest.fixture
def spec():
    return ReplaySpec(**SPEC)


def blocks_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)


def test_roundtrip_preserves_every_field(spec):
    ring = ShmBlockRing(spec, maxsize=4)
    try:
        for i, blk in enumerate(synthetic_blocks(spec, 3, seed=0)):
            blk.weight_version = np.asarray(i + 7, np.int32)
            blk.lane = np.asarray(i, np.int32)
            ring.put(blk, timeout=1.0)
            blocks_equal(blk, ring.get_nowait())
    finally:
        ring.close()


def test_fifo_capacity_and_empty(spec):
    blocks = synthetic_blocks(spec, 4, seed=1)
    ring = ShmBlockRing(spec, maxsize=3)
    try:
        for blk in blocks[:3]:
            ring.put(blk, timeout=1.0)
        with pytest.raises(queue_mod.Full):
            ring.put(blocks[3], timeout=0.05)
        assert ring.qsize() == 3
        for blk in blocks[:3]:
            blocks_equal(blk, ring.get(timeout=1.0))
        with pytest.raises(queue_mod.Empty):
            ring.get_nowait()
    finally:
        ring.close()


def test_multi_producer_all_blocks_arrive(spec):
    """4 producer threads x 8 blocks through a 4-slot ring: each block
    arrives once (told apart by its first reward)."""
    all_blocks = synthetic_blocks(spec, 32, seed=2)
    for i, blk in enumerate(all_blocks):
        blk.reward[0, 0] = float(i)
    ring = ShmBlockRing(spec, maxsize=4)
    try:
        def producer(chunk):
            for blk in chunk:
                ring.put(blk, timeout=30.0)

        threads = [threading.Thread(target=producer,
                                    args=(all_blocks[i * 8:(i + 1) * 8],))
                   for i in range(4)]
        for t in threads:
            t.start()
        seen = {int(ring.get(timeout=30.0).reward[0, 0]) for _ in range(32)}
        for t in threads:
            t.join(timeout=5.0)
            assert not t.is_alive()
        assert seen == set(range(32))
    finally:
        ring.close()


def test_recover_stalled_frees_wedged_slot(spec):
    """A producer dying between reserve and commit does not wedge the ring:
    recover_stalled skips the stale head slot; a fresh reservation is left
    alone under a grace."""
    blocks = synthetic_blocks(spec, 2, seed=4)
    ring = ShmBlockRing(spec, maxsize=2)
    try:
        lib = ring._ensure()
        assert int(lib.ring_reserve_push(ring._base)) == 0
        ring.put(blocks[0], timeout=1.0)
        with pytest.raises(queue_mod.Empty):
            ring.get_nowait()
        assert ring.recover_stalled(stale_ms=0) == 1
        blocks_equal(blocks[0], ring.get(timeout=1.0))
        ring.put(blocks[1], timeout=1.0)
        blocks_equal(blocks[1], ring.get_nowait())
        assert int(lib.ring_reserve_push(ring._base)) >= 0
        assert ring.recover_stalled(stale_ms=60_000) == 0
    finally:
        ring.close()


def test_pickled_handle_attaches_to_same_ring(spec):
    blk = synthetic_blocks(spec, 1, seed=3)[0]
    ring = ShmBlockRing(spec, maxsize=2)
    try:
        handle = pickle.loads(pickle.dumps(ring))
        assert handle.name == ring.name
        handle.put(blk, timeout=1.0)
        blocks_equal(blk, ring.get(timeout=1.0))
        handle.close()          # not the owner: no unlink
        ring.put(blk, timeout=1.0)
        blocks_equal(blk, ring.get_nowait())
    finally:
        ring.close()


def test_slot_layout_matches_the_jax_ring(spec):
    """A block put through the port's ring comes out of the JAX package's
    ring attached to the same segment: the same slot bytes."""
    pytest.importorskip("r2d2_tpu.native")
    from r2d2_tpu.replay.structs import ReplaySpec as JReplaySpec
    from r2d2_tpu.runtime.shm_feeder import ShmBlockRing as JShmBlockRing
    jspec = JReplaySpec(**SPEC, pallas_gather=False, exact_gather=False)
    blk = synthetic_blocks(spec, 1, seed=8)[0]
    ring = ShmBlockRing(spec, maxsize=2)
    try:
        theirs = JShmBlockRing(jspec, 2, _attach_name=ring.name)
        assert theirs.slot_bytes == ring.slot_bytes
        ring.put(blk, timeout=1.0)
        got = theirs.get(timeout=1.0)
        for f in dataclasses.fields(blk):
            np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                          np.asarray(getattr(blk, f.name)))
        theirs.close()
    finally:
        ring.close()


def test_block_queue_transports(spec, monkeypatch):
    """shm_spec given: the native ring, and a failed build raises instead
    of falling back; shm_spec None: a multiprocessing queue."""
    q = BlockQueue(maxsize=2, use_mp=True, shm_spec=spec)
    assert isinstance(q._q, ShmBlockRing)
    q.close()
    plain = BlockQueue(maxsize=2, use_mp=True,
                       ctx=mp.get_context("spawn"), shm_spec=None)
    assert not isinstance(plain._q, ShmBlockRing)
    blk = synthetic_blocks(spec, 1, seed=9)[0]
    plain.put(blk, timeout=5.0)
    blocks_equal(blk, plain.get(timeout=5.0))
    plain.close()

    import r2d2_tpu_torch.native as native

    def broken():
        raise RuntimeError("g++ failed for shm_ring.cc")

    monkeypatch.setattr(native, "ring_lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BlockQueue(maxsize=2, use_mp=True, shm_spec=spec)
