"""The port's replay service against the JAX package's on the CPU: the
same blocks and the same injected draws through both services give the
same shards (ring rows, trees, ring accountants, spill pages in LRU order
with their stored priorities, demotion tables), the same samples, the
same write-back decisions and the same record block. Round robin equals
per-shard adds, one shard is the plain replay, a cold spill tier leaves
the sample alone, demotion and promotion round-trip a block, the tier
carries capacity past the ring and counts its thrash, lanes route by
provenance, the accountant facade sums the shards, the staleness guard
drops or reroutes stale rows, the prefetch heap pops by priority, and a
grouped add equals sequential adds through a wrap and a mid-group
demotion.

The spec's priority exponent is 1, so the trees compare exactly (at 0.9
XLA's and PyTorch's f32 pow round an ulp apart, tests/test_torch_replay.py);
the importance weights' pow is held at rtol 1e-6, every other value
exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.fleet import replay_service as jrs
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu_torch.fleet.replay_service import (ReplayService, SpillTier,
                                                 block_from_fields)
from r2d2_tpu_torch.replay import device_replay as tdr
from tests.test_torch_replay import FIELDS, specs, synthetic_blocks

pytestmark = pytest.mark.torch_port

B = 8           # the spec's batch


def make_specs(**kw):
    return specs(**{"num_blocks": 4, "prio_exponent": 1.0, **kw})


def jblock(blk, **kw) -> JBlock:
    return JBlock(**{**dataclasses.asdict(blk), **kw})


def pblock(blk, **kw):
    return dataclasses.replace(blk, **{k: np.asarray(v, np.int32)
                                       for k, v in kw.items()})


def jitter(seed: int):
    """A JAX key and its descent's draws, as replay_sample takes them."""
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (B,), dtype=np.float32))
    return key, torch.from_numpy(u.copy())


def services(n, **kw):
    jspec, spec = make_specs()
    return (jrs.ReplayService(jspec, n, **kw),
            ReplayService(spec, n, "cpu", **kw), spec)


def assert_state_equal(got, want, err=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{err} {name}")
    assert got.block_ptr == int(np.asarray(want.block_ptr)), err


def assert_page_equal(got, want, err=""):
    (gb, gl, gv), (wb, wl, wv) = got, want
    assert (gl, gv) == (wl, wv), err
    for f in dataclasses.fields(gb):
        np.testing.assert_array_equal(np.asarray(getattr(gb, f.name)),
                                      np.asarray(getattr(wb, f.name)),
                                      err_msg=f"{err} {f.name}")


def assert_shard_equal(got, want, err=""):
    """Port shard == JAX shard: state, ring accountant, spill tier (page
    ids in LRU order, pages, stored priorities, counters), resident
    pages and the demotion table."""
    assert_state_equal(got.state, want.state, err)
    for name in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                 "slot_versions", "slot_trace", "slot_ingest_ms"):
        assert getattr(got.ring, name) == getattr(want.ring, name), \
            f"{err} ring.{name}"
    gs, ws = got.spill, want.spill
    assert list(gs._pages) == list(ws._pages), err
    assert gs._prio == ws._prio, err
    for pid in ws._pages:
        assert_page_equal(gs._pages[pid], ws._pages[pid], f"{err} page {pid}")
    for name in ("demotions", "promotions", "evictions", "writebacks",
                 "_next_id", "_interval"):
        assert getattr(gs, name) == getattr(ws, name), f"{err} spill.{name}"
    assert got._demote_ids == want._demote_ids, err
    for g, w in zip(got._resident, want._resident):
        assert (g is None) == (w is None), err
        if g is not None:
            assert_page_equal(g, w, f"{err} resident")


def assert_services_equal(svc, jsvc):
    for name in ("_rr_add", "_rr_sample", "stale_writebacks",
                 "spilled_writebacks", "stale_rows_dropped"):
        assert getattr(svc, name) == getattr(jsvc, name), name
    for i, (got, want) in enumerate(zip(svc.shards, jsvc.shards)):
        assert_shard_equal(got, want, f"shard {i}")


def assert_batch_equal(got, want):
    for f in dataclasses.fields(got):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        if f.name == "is_weights":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def feed(jsvc, svc, blocks, **stamp):
    """The same blocks into both services one by one; the routed
    shards."""
    out = []
    for k, blk in enumerate(blocks):
        kw = {name: fn(k) for name, fn in stamp.items()}
        a = jsvc.add_block(jblock(blk, **kw))
        b = svc.add_block(pblock(blk, **kw))
        assert a == b
        out.append(b)
    return out


def test_round_robin_service_is_per_shard_replay_add():
    """Two shards fed round robin hold what per-shard ``replay_add``
    builds, and what JAX's service holds."""
    jsvc, svc, spec = services(2, route="round_robin")
    blocks = synthetic_blocks(spec, 6)
    assert feed(jsvc, svc, blocks) == [0, 1, 0, 1, 0, 1]
    refs = [tdr.replay_init(spec, "cpu") for _ in range(2)]
    for k, blk in enumerate(blocks):
        tdr.replay_add(spec, refs[k % 2], blk)
    for shard, ref in zip(svc.shards, refs):
        for name in FIELDS:
            assert torch.equal(getattr(shard.state, name),
                               getattr(ref, name)), name
    assert_services_equal(svc, jsvc)


def test_single_shard_service_is_the_plain_replay():
    """One shard, no spill: the plain ring, sampling included, and JAX's
    service's sample under the same key."""
    jsvc, svc, spec = services(1)
    blocks = synthetic_blocks(spec, 3, seed=1)
    feed(jsvc, svc, blocks)
    ref = tdr.replay_init(spec, "cpu")
    for blk in blocks:
        tdr.replay_add(spec, ref, blk)
    key, u = jitter(7)
    batch, shard, snapshot = svc.sample(uniform=u)
    jbatch, jshard, jsnap = jsvc.sample(key)
    assert (shard, snapshot) == (jshard, jsnap) == (0, 3)
    assert_batch_equal(batch, jbatch)
    want = tdr.replay_sample(spec, ref, uniform=u)
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(batch, f.name), getattr(want, f.name))


def test_cold_spill_sample_is_replay_sample():
    """A tier with nothing spilled: promotion leaves the ring alone and the
    sample is ``replay_sample``'s, and JAX's."""
    jsvc, svc, spec = services(1, spill_blocks=8, promote_per_sample=2)
    blocks = synthetic_blocks(spec, 3, seed=2)
    feed(jsvc, svc, blocks)
    assert svc.shards[0].spill.occupancy == 0
    ref = tdr.replay_init(spec, "cpu")
    for blk in blocks:
        tdr.replay_add(spec, ref, blk)
    key, u = jitter(3)
    batch, _, _ = svc.sample(uniform=u)
    assert_batch_equal(batch, jsvc.sample(key)[0])
    want = tdr.replay_sample(spec, ref, uniform=u)
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(batch, f.name), getattr(want, f.name))
    assert_services_equal(svc, jsvc)


def test_spill_demote_promote_round_trip():
    """Blocks overwritten in a 2-row ring spill; a promotion writes the
    LRU page back bit for bit (demoting what it overwrites), as in JAX."""
    jspec, spec = make_specs(num_blocks=2)
    jsvc = jrs.ReplayService(jspec, 1, spill_blocks=8, promote_per_sample=0)
    svc = ReplayService(spec, 1, "cpu", spill_blocks=8, promote_per_sample=0)
    blocks = synthetic_blocks(spec, 4, seed=3)
    feed(jsvc, svc, blocks)
    shard = svc.shards[0]
    assert shard.spill.occupancy == 2 and shard.spill.demotions == 2
    assert shard.promote(1) == jsvc.shards[0].promote(1) == 1
    slot = (shard.ring.ptr - 1) % spec.num_blocks
    np.testing.assert_array_equal(shard.state.obs[slot].numpy(),
                                  blocks[0].obs_row)
    np.testing.assert_array_equal(shard.state.action[slot].numpy(),
                                  blocks[0].action)
    assert shard.spill.promotions == 1 and shard.spill.occupancy == 2
    assert_services_equal(svc, jsvc)


def test_spill_capacity_scales_past_the_device_ring():
    """4 ring rows + 8 spill pages hold 12 live blocks (>= 2x the ring)."""
    jsvc, svc, spec = services(1, spill_blocks=8)
    feed(jsvc, svc, synthetic_blocks(spec, 12, seed=4))
    assert svc.device_ring_blocks == 4
    assert svc.live_blocks == jsvc.live_blocks == 12
    assert svc.device_bytes == spec.device_ring_bytes
    assert_services_equal(svc, jsvc)


def test_spill_thrash_and_interval_accounting():
    """An undersized tier evicts unpromoted pages: thrash 0.75, reset on
    read, hit rate 0; the record block equals JAX's, twice."""
    jspec, spec = make_specs(num_blocks=2)
    jsvc = jrs.ReplayService(jspec, 1, spill_blocks=1, promote_per_sample=0)
    svc = ReplayService(spec, 1, "cpu", spill_blocks=1, promote_per_sample=0)
    feed(jsvc, svc, synthetic_blocks(spec, 6, seed=5))
    block = svc.interval_block()
    assert block == jsvc.interval_block()
    assert block["spill"]["demotions"] == 4
    assert block["spill"]["evictions"] == 3
    assert block["spill"]["thrash_frac"] == pytest.approx(0.75)
    assert block["spill"]["occupancy"] == 1
    assert block["spill"]["hit_rate"] == 0.0
    block2 = svc.interval_block()
    assert block2 == jsvc.interval_block()
    assert block2["spill"]["demotions"] == 0
    assert block2["spill"]["thrash_frac"] is None


def test_lane_routing_provenance():
    """route="lane": a stamped block lands in shard lane % N; unstamped
    ones (-1) fall back to round robin, as in JAX."""
    jsvc, svc, spec = services(2, route="lane")
    blocks = synthetic_blocks(spec, 6, seed=6)
    routed = feed(jsvc, svc, blocks[:4], lane=lambda k: k)
    assert routed == [0, 1, 0, 1]
    for shard in svc.shards:
        lanes = shard.state.lane.numpy()
        live = lanes[lanes >= 0]
        assert live.size and np.all(live % 2 == shard.index)
    assert set(feed(jsvc, svc, blocks[4:])) == {0, 1}
    assert_services_equal(svc, jsvc)


def test_accountant_facade():
    """The Learner's ring contract over the shards: the gate waits for
    every shard, buffer steps and adds are summed, versions listed."""
    jsvc, svc, spec = services(2)
    blocks = synthetic_blocks(spec, 4, seed=7)
    assert not svc.all_shards_nonempty
    feed(jsvc, svc, blocks[:1], weight_version=lambda k: 3)
    assert not svc.all_shards_nonempty and not jsvc.all_shards_nonempty
    feed(jsvc, svc, blocks[1:])
    assert svc.all_shards_nonempty
    assert svc.total_adds == jsvc.total_adds == 4
    assert svc.buffer_steps == jsvc.buffer_steps == sum(
        int(b.learning_steps.sum()) for b in blocks)
    assert svc.live_versions() == jsvc.live_versions()
    assert 3 in svc.live_versions()
    with pytest.raises(RuntimeError, match="empty service"):
        ReplayService(spec, 1, "cpu").sample(uniform=jitter(0)[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_stale_writeback_guard(seed):
    """An add lands between a sample and its write-back: a batch that
    sampled the overwritten row is dropped whole (no spill tier), a
    disjoint one lands; both services decide alike under the same draws,
    and an unguarded write-back still lands."""
    jsvc, svc, spec = services(1, promote_per_sample=0)
    blocks = synthetic_blocks(spec, 6, seed=8)
    feed(jsvc, svc, blocks[:4])
    key, u = jitter(seed)
    batch, shard, snap = svc.sample(uniform=u)
    jbatch, jshard, jsnap = jsvc.sample(key)
    assert_batch_equal(batch, jbatch)
    feed(jsvc, svc, blocks[4:5])
    tds = np.linspace(0.5, 2.0, B).astype(np.float32)
    tree_before = svc.shards[0].state.tree.clone()
    svc.update_priorities(shard, batch.idxes, torch.from_numpy(tds),
                          adds_snapshot=snap)
    jsvc.update_priorities(jshard, jbatch.idxes, tds, adds_snapshot=jsnap)
    rows = batch.idxes.numpy() // spec.seqs_per_block
    if 0 in rows:
        assert svc.stale_writebacks == 1
        assert torch.equal(svc.shards[0].state.tree, tree_before)
    else:
        assert svc.stale_writebacks == 0
        assert not torch.equal(svc.shards[0].state.tree, tree_before)
    assert_services_equal(svc, jsvc)
    key, u = jitter(seed + 10)
    batch2, shard2, _ = svc.sample(uniform=u)
    jbatch2, jshard2, _ = jsvc.sample(key)
    svc.update_priorities(shard2, batch2.idxes, torch.from_numpy(tds))
    jsvc.update_priorities(jshard2, jbatch2.idxes, tds)
    assert_services_equal(svc, jsvc)


def test_stale_writeback_routes_to_spilled_pages():
    """With the tier on, a stale row's |TD| goes into its demoted page's
    stored priorities; the fresh rows land through the padded update,
    as if applied alone; JAX routes alike."""
    jsvc, svc, spec = services(1, spill_blocks=4, promote_per_sample=0)
    _, ref, _ = services(1, spill_blocks=4, promote_per_sample=0)
    blocks = synthetic_blocks(spec, 6, seed=9)
    feed(jsvc, svc, blocks[:4])
    for blk in blocks[:4]:
        ref.add_block(blk)
    snap = svc.shards[0].ring.total_adds
    feed(jsvc, svc, blocks[4:])          # rows 0 and 1 overwritten, demoted
    for blk in blocks[4:]:
        ref.add_block(blk)
    spb = spec.seqs_per_block
    idxes = np.asarray([0 * spb + 2, 1 * spb + 1, 2 * spb, 3 * spb + 3],
                       np.int32)
    tds = np.asarray([5.0, 7.0, 1.5, 2.5], np.float32)
    svc.update_priorities(0, idxes, tds, adds_snapshot=snap)
    jsvc.update_priorities(0, idxes, tds, adds_snapshot=snap)
    assert svc.spilled_writebacks == 2 and svc.stale_rows_dropped == 0
    assert svc.stale_writebacks == 0
    for slot, seq, td in ((0, 2, 5.0), (1, 1, 7.0)):
        pid = svc.shards[0]._demote_ids[slot]
        page = svc.shards[0].spill._pages[pid][0]
        assert float(page.priority[seq]) == td
        assert svc.shards[0].spill._prio[pid] >= td
    ref.shards[0].update_priorities(idxes[2:], tds[2:])
    assert torch.equal(svc.shards[0].state.tree, ref.shards[0].state.tree)
    assert svc.shards[0].spill.writebacks == 2
    assert_services_equal(svc, jsvc)


def test_stale_writeback_whole_drop_without_spill():
    jsvc, svc, spec = services(1, promote_per_sample=0)
    blocks = synthetic_blocks(spec, 5, seed=10)
    feed(jsvc, svc, blocks[:4])
    snap = svc.shards[0].ring.total_adds
    feed(jsvc, svc, blocks[4:])
    spb = spec.seqs_per_block
    idxes = np.asarray([0, 2 * spb], np.int32)
    tds = np.asarray([9.0, 9.0], np.float32)
    tree_before = svc.shards[0].state.tree.clone()
    svc.update_priorities(0, idxes, tds, adds_snapshot=snap)
    jsvc.update_priorities(0, idxes, tds, adds_snapshot=snap)
    assert svc.stale_writebacks == 1 and svc.spilled_writebacks == 0
    assert torch.equal(svc.shards[0].state.tree, tree_before)
    assert_services_equal(svc, jsvc)


def test_promote_best_order_and_writeback_reorder():
    """The prefetch heap pops pages by stored priority, a write-back
    reorders it (the stale entry skipped), eviction stays LRU; JAX's
    tier pops the same pages in the same order."""
    _, spec = make_specs()
    blocks = synthetic_blocks(spec, 4, seed=11)
    tier, jtier = SpillTier(4), jrs.SpillTier(4)
    pids = []
    for blk, p in zip(blocks, [1.0, 5.0, 3.0, 2.0]):
        prio = np.full_like(blk.priority, p)
        pids.append(tier.demote(dataclasses.replace(blk, priority=prio),
                                5, -1))
        assert jtier.demote(jblock(blk, priority=prio), 5, -1) == pids[-1]
    assert pids == [1, 2, 3, 4]
    assert float(np.max(tier.promote_best()[0].priority)) == 5.0
    jtier.promote_best()
    assert tier.write_back(pids[0], 0, 9.0) and jtier.write_back(pids[0], 0,
                                                                 9.0)
    order, jorder = [], []
    while True:
        page, jpage = tier.promote_best(), jtier.promote_best()
        assert (page is None) == (jpage is None)
        if page is None:
            break
        order.append(float(np.max(page[0].priority)))
        jorder.append(float(np.max(np.asarray(jpage[0].priority))))
    assert order == jorder == [9.0, 3.0, 2.0]
    assert not tier.write_back(pids[1], 0, 1.0)
    small = SpillTier(1)
    for blk, p in zip(blocks[:2], (8.0, 2.0)):
        small.demote(dataclasses.replace(
            blk, priority=np.full_like(blk.priority, p)), 5, -1)
    assert small.evictions == 1
    assert float(np.max(small.promote_best()[0].priority)) == 2.0
    assert small.promote_best() is None
    assert tier.hit_rate == jtier.hit_rate


@pytest.mark.parametrize("spill", [0, 3])
@pytest.mark.parametrize("route", ["round_robin", "lane"])
def test_grouped_ingest_equals_sequential_adds(spill, route):
    """add_blocks at ingest_batch_blocks=4: 11 blocks through a 4-row ring
    (it wraps inside a group, demoting mid-group) equal 11 sequential
    add_block calls bit for bit — routing, rows, stamps, accountant, spill
    order, demotion table — and JAX's grouped service."""
    jspec, spec = make_specs()
    blocks = synthetic_blocks(spec, 11, seed=12)
    stamped = []
    for k, blk in enumerate(blocks):
        lane = k % 3 if (route == "lane" and k % 4 != 3) else -1
        stamped.append(pblock(blk, lane=lane, weight_version=k))
    kw = dict(spill_blocks=spill, route=route)
    svc = ReplayService(spec, 2, "cpu", ingest_batch_blocks=4, **kw)
    ref = ReplayService(spec, 2, "cpu", **kw)
    jsvc = jrs.ReplayService(jspec, 2, ingest_batch_blocks=4, **kw)
    routed = svc.add_blocks(stamped)
    assert routed == [ref.add_block(b) for b in stamped]
    assert routed == jsvc.add_blocks([jblock(b) for b in stamped])
    for got, want in zip(svc.shards, ref.shards):
        for name in FIELDS:
            assert torch.equal(getattr(got.state, name),
                               getattr(want.state, name)), name
        assert got.ring.slot_steps == want.ring.slot_steps
        assert got.ring.slot_versions == want.ring.slot_versions
        assert list(got.spill._pages) == list(want.spill._pages)
        assert got._demote_ids == want._demote_ids
    assert_services_equal(svc, jsvc)
    iv, jiv = svc.interval_block(), jsvc.interval_block()
    assert iv["ingest"]["blocks"] == 11 and iv["ingest"]["dispatches"] < 11
    for key in ("stage_ms", "commit_ms"):
        iv["ingest"].pop(key)
        jiv["ingest"].pop(key)
    assert iv == jiv
    assert "ingest" not in ref.interval_block()


def test_grouped_ingest_chunk_plan():
    """11 blocks into one 8-row shard at group 4: chunks 4+4+2+1, the
    sizes JAX compiles ahead; the backlog gauge."""
    jspec, spec = make_specs(num_blocks=8)
    svc = ReplayService(spec, 1, "cpu", ingest_batch_blocks=4)
    jsvc = jrs.ReplayService(jspec, 1, ingest_batch_blocks=4)
    assert svc.chunk_sizes() == jsvc.aot_chunk_coverage()["expected"] == [
        2, 4]
    svc.add_blocks(synthetic_blocks(spec, 11, seed=13))
    iv = svc.interval_block()["ingest"]
    assert iv["blocks"] == 11 and iv["dispatches"] == 4
    assert iv["blocks_per_dispatch"] == round(11 / 4, 2)
    svc.note_backlog(100)
    assert svc.interval_block()["ingest"]["backlog"] == 100
    svc.note_backlog(-1)
    assert svc.interval_block()["ingest"]["backlog"] == 0


def test_interval_block_equals_jax_over_a_sequence():
    """Adds, samples with promotion, write-backs (stale and fresh) and
    grouped adds on two shards with a small tier and the tier stats on:
    each interval's block equals JAX's, but for its host timings."""
    kw = dict(spill_blocks=2, promote_per_sample=1, ingest_batch_blocks=4,
              tier_stats=True)
    jsvc, svc, spec = services(2, **kw)
    blocks = synthetic_blocks(spec, 24, seed=14)

    def strip(block):
        block["ingest"].pop("stage_ms")
        block["ingest"].pop("commit_ms")
        lat = block["spill"]["promotion_latency"]
        if lat is not None:
            block["spill"]["promotion_latency"] = lat["count"]
        return block

    for i in range(0, 24, 6):
        group = blocks[i:i + 6]
        svc.add_blocks(group)
        jsvc.add_blocks([jblock(b) for b in group])
        for s in range(3):
            key, u = jitter(100 * i + s)
            batch, shard, snap = svc.sample(uniform=u)
            jbatch, jshard, jsnap = jsvc.sample(key)
            assert_batch_equal(batch, jbatch)
            if s == 1:
                svc.add_block(group[0])
                jsvc.add_block(jblock(group[0]))
            tds = np.linspace(0.1, 3.0, B).astype(np.float32)
            svc.update_priorities(shard, batch.idxes, torch.from_numpy(tds),
                                  adds_snapshot=snap)
            jsvc.update_priorities(jshard, jbatch.idxes, tds,
                                   adds_snapshot=jsnap)
        svc.note_backlog(i)
        jsvc.note_backlog(i)
        assert strip(svc.interval_block()) == strip(jsvc.interval_block())
    assert_services_equal(svc, jsvc)
    assert svc.shards[0].spill.promotions > 0


def test_spill_prefetch_moves_promotion_off_the_sample():
    """spill_prefetch: the sample promotes nothing (it is replay_sample's);
    the write-back kicks the background pass, which promotes the page of
    the highest stored priority, as JAX's does."""
    jsvc, svc, spec = services(1, spill_blocks=4, promote_per_sample=1,
                               spill_prefetch=True)
    try:
        feed(jsvc, svc, synthetic_blocks(spec, 6, seed=15))
        assert svc.shards[0].spill.occupancy == 2
        ref = tdr.replay_init(spec, "cpu")
        for name in FIELDS:
            getattr(ref, name).copy_(getattr(svc.shards[0].state, name))
        key, u = jitter(3)
        batch, shard, _ = svc.sample(uniform=u)
        jbatch, _, _ = jsvc.sample(key)
        assert svc.shards[0].spill.occupancy == 2
        want = tdr.replay_sample(spec, ref, uniform=u)
        for f in dataclasses.fields(batch):
            assert torch.equal(getattr(batch, f.name), getattr(want, f.name))
        best = max(svc.shards[0].spill._prio.values())
        zeros = np.zeros(B, np.float32)
        svc.update_priorities(shard, batch.idxes, torch.from_numpy(zeros))
        jsvc.update_priorities(shard, jbatch.idxes, zeros)
        assert svc.drain_prefetch(timeout=30.0)
        jsvc.drain_prefetch(timeout=30.0)
        assert svc.shards[0].spill.promotions == 1
        assert svc.shards[0].spill.occupancy == 2
        assert best not in svc.shards[0].spill._prio.values()
        assert_services_equal(svc, jsvc)
        block = svc.interval_block()
        assert block["spill"]["prefetch"] is True
        assert block["spill"]["prefetch_promotions"] == 1
    finally:
        svc.close()
        jsvc.close()
    assert svc._prefetch_thread is None


def test_default_knobs_keep_the_record_schema():
    """Off defaults: add_blocks is the sequential loop, and the block
    carries neither the ingest sub-block nor the prefetch or tier keys."""
    jsvc, svc, spec = services(2)
    blocks = synthetic_blocks(spec, 3, seed=16)
    assert svc.add_blocks(blocks) == jsvc.add_blocks(
        [jblock(b) for b in blocks])
    block = svc.interval_block()
    assert block == jsvc.interval_block()
    assert "ingest" not in block and "prefetch" not in block["spill"]
    assert "tiers" not in block["spill"]


def test_pages_keep_the_lineage_stamp():
    """A traced block's stamp rides its spill page and comes back with
    the promotion into the ring accountant's mirror."""
    jspec, spec = make_specs(num_blocks=2)
    svc = ReplayService(spec, 1, "cpu", spill_blocks=4, promote_per_sample=0)
    blocks = synthetic_blocks(spec, 3, seed=17)
    fields = {f.name: getattr(blocks[0], f.name)
              for f in dataclasses.fields(blocks[0])}
    traced = block_from_fields({**fields, "trace_ms": np.int32(1234)})
    svc.add_block(traced)
    for blk in blocks[1:]:
        svc.add_block(blk)
    shard = svc.shards[0]
    assert shard.ring.slot_trace[0] == -1
    page = next(iter(shard.spill._pages.values()))[0]
    assert int(page.trace_ms) == 1234
    shard.promote(1)
    assert shard.ring.slot_trace[(shard.ring.ptr - 1) % 2] == 1234


def test_service_refuses_bad_arguments():
    _, spec = make_specs()
    with pytest.raises(ValueError, match="num_shards"):
        ReplayService(spec, 0, "cpu")
    with pytest.raises(ValueError, match="route"):
        ReplayService(spec, 1, "cpu", route="hash")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; a machine with a card builds on it")
def test_service_without_a_device_asks_for_the_card():
    """No device means the card, as every entry point of the port: without
    one the constructor raises instead of building its shards on the CPU."""
    _, spec = make_specs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplayService(spec, 1)
    assert ReplayService(spec, 1, "cpu").device == torch.device("cpu")
