"""The port's replay diagnostics (r2d2_tpu_torch/telemetry/replaydiag.py,
the eviction ledger of replay/device_replay.py ``write_rows``, the host
replay's twin and the snapshot's diagnostic leaves) against the JAX
package's ``telemetry/replaydiag.py`` on the same numpy-seeded inputs: the
bucketize-scatter, the tree moments, the ledger over a wrapping ring (and
against K sequential adds), ``HostReplay.diag_raw``, the aggregator's
blocks, the kill switch, snapshots at dp=1 and dp=2, and the dp=2 x mp=2
and host tensor-parallel steps' diagnostics (the port's ranks as gloo
processes, ``tools/dp_check.py``). The learning diagnostics, the fused
steps and the dp=2 step are tests/test_torch_learning_diag.py's."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.replay import device_replay as jdr
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu.telemetry.histogram import value_counts as j_value_counts
from r2d2_tpu.telemetry.replaydiag import \
    ReplayDiagAggregator as JReplayDiagAggregator
from r2d2_tpu.telemetry.replaydiag import \
    tree_health_moments as j_tree_health_moments
from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.ops.sum_tree import tree_update
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.host_replay import HostReplay
from r2d2_tpu_torch.replay.snapshot import (capture_plain, capture_sharded,
                                            load_snapshot, restore_plain,
                                            shard_leaves, write_snapshot)
from r2d2_tpu_torch.replay.structs import (DIAG_LEAVES, RingAccountant,
                                           stack_blocks)
from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, value_counts,
                                                value_counts_np)
from r2d2_tpu_torch.telemetry.replaydiag import (ReplayDiag,
                                                 ReplayDiagAggregator,
                                                 tree_health_moments)
from tests.test_torch_replay import (jax_filled, jax_stack, specs,
                                     synthetic_blocks, to_numpy_state)

pytestmark = pytest.mark.torch_port

# the layout's bucket edges: 10 ** (-6 + i / 8)
EDGES = 10.0 ** (-6.0 + np.arange(NBUCKETS + 1) / 8.0)


def stamped_blocks(spec, count, seed=0, lanes=4):
    """Synthetic blocks with weight versions (some -1, unknown) and
    lanes."""
    blocks = synthetic_blocks(spec, count, seed=seed)
    for i, blk in enumerate(blocks):
        blk.weight_version = np.asarray(-1 if i % 5 == 4 else 1 + i // 2,
                                        np.int32)
        blk.lane = np.asarray(i % lanes, np.int32)
    return blocks


# -- the bucketize-scatter ----------------------------------------------------


def test_bucketize_scatter_matches_jax_and_numpy(rng):
    """value_counts on tensors against JAX's value_counts and the numpy
    twin: log-uniform magnitudes of both signs over 1e-8 .. 1e3, zeros,
    infinities and NaN (the top bucket), with and without a mask; counts
    equal. One exception, stated: an entry within 1e-6 relative of a
    bucket edge may land in the neighbouring bucket under one of the
    three log10s, so such entries are left out of the input."""
    x = (10.0 ** rng.uniform(-8, 3, 4000)) * rng.choice([-1.0, 1.0], 4000)
    x = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 1e5]]
                       ).astype(np.float32)
    ax = np.abs(x.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        near = np.min(np.abs(ax[:, None] / EDGES[None, :] - 1.0), axis=1)
    x = x[~(near < 1e-6)]
    mask = rng.random(x.shape[0]) < 0.7
    for m in (None, mask):
        got = value_counts(torch.from_numpy(x), None if m is None
                           else torch.from_numpy(m))
        assert got.dtype == torch.int32 and got.shape == (NBUCKETS,)
        want = np.asarray(j_value_counts(
            jnp.asarray(x), None if m is None else jnp.asarray(m)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), value_counts_np(x, m))
    assert got.numpy()[-1] >= 3           # +-inf and NaN in the top bucket


def test_bucketize_scatter_midpoints_and_2d_mask():
    """Every bucket's geometric midpoint lands in its bucket; a (B, L)
    input with a (B, L) mask counts the masked entries only."""
    mids = (10.0 ** (-6.0 + (np.arange(NBUCKETS) + 0.5) / 8.0)).astype(
        np.float32)
    got = value_counts(torch.from_numpy(mids)).numpy()
    np.testing.assert_array_equal(got, np.ones(NBUCKETS, np.int32))
    x = torch.from_numpy(np.tile(mids[:10], (3, 1)))
    mask = torch.zeros(3, 10)
    mask[1, 2:5] = 1
    got = value_counts(x, mask).numpy()
    assert got.sum() == 3 and list(np.nonzero(got)[0]) == [2, 3, 4]


# -- the tree moments ---------------------------------------------------------


def test_tree_moments_match_jax(rng):
    """tree_health_moments on a tree written by the port's tree_update
    (zero leaves, ties at the max, a spread of priorities) against JAX's
    on the same array: active and count-at-max exact, sum p rtol 1e-6,
    sum p^2 rtol 1e-5, the leaf histogram exact."""
    layers = 9
    tree = torch.zeros(2 ** layers - 1)
    n = 2 ** (layers - 1)
    td = (10.0 ** rng.uniform(-3, 1, n)).astype(np.float32)
    td[rng.random(n) < 0.2] = 0.0
    td[:7] = td.max()
    tree_update(layers, tree, 0.9, torch.from_numpy(td),
                torch.arange(n))
    moments, hist = tree_health_moments(tree, layers)
    jm, jh = j_tree_health_moments(jnp.asarray(tree.numpy()), layers)
    jm = np.asarray(jm)
    m = moments.numpy()
    assert m[0] == jm[0] and m[4] == jm[4] and m[3] == jm[3]
    np.testing.assert_allclose(m[1], jm[1], rtol=1e-6)
    np.testing.assert_allclose(m[2], jm[2], rtol=1e-5)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert m[4] >= 7


# -- the eviction ledger ------------------------------------------------------


def _diag_leaves(state):
    return {name: np.asarray(getattr(state, name)) for name in DIAG_LEAVES}


def test_eviction_ledger_matches_jax_and_sequential_adds():
    """replay_add_many of 5 blocks over a full 8-block ring (the pointer
    wraps) after some rows were sampled: the port's ledger against JAX's
    (counts, birth stamps, the add counter, evicted / never-sampled /
    lifetime / age sums and the lifetime histogram exact, the final
    priority sum rtol 1e-6) and against 5 sequential adds (bit-equal)."""
    jspec, spec = specs(num_blocks=8, replay_diag=True)
    blocks = stamped_blocks(spec, 13, seed=3)
    jstate = jax_filled(jspec, blocks[:8])
    port = tdr.replay_init(spec, "cpu")
    for i in range(0, 8, 3):
        tdr.replay_add_many(spec, port, stack_blocks(blocks[i:min(i + 3, 8)]))
    counts = np.array([2, 0, 5, 1, 0, 0, 3, 0], np.int32)
    jstate = jstate.replace(sample_count=jnp.asarray(counts))
    port.sample_count.copy_(torch.from_numpy(counts))
    seq = tdr.replay_init(spec, "cpu")
    for name, value in vars(port).items():
        if torch.is_tensor(value):
            getattr(seq, name).copy_(value)
    seq.block_ptr = port.block_ptr
    jstate = jdr.replay_add_many(jspec, jstate, jax_stack(blocks[8:]))
    tdr.replay_add_many(spec, port, stack_blocks(blocks[8:]))
    for blk in blocks[8:]:
        tdr.replay_add(spec, seq, blk)
    want = _diag_leaves(to_numpy_state(jstate))
    got = _diag_leaves(port)
    for name in ("sample_count", "added_at", "add_count", "evict_life_hist"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["evict_stats"][:4],
                                  want["evict_stats"][:4])
    np.testing.assert_allclose(got["evict_stats"][4], want["evict_stats"][4],
                               rtol=1e-6)
    assert list(got["evict_stats"][:3]) == [5, 2, 8]
    for name, value in _diag_leaves(seq).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("use_native", [False, True])
def test_host_replay_twin_matches_jax(use_native):
    """The host replay's twin against JAX's ``HostReplay.diag_raw`` on the
    same blocks and seed (their samples are bit-equal): after a wrap with
    sampled rows, the tree moments (active and at-max exact, sums rtol
    1e-12), the leaf histogram and the eviction ledger exact; the second
    reading is a fresh (zero) ledger."""
    jspec, spec = specs(num_blocks=8, replay_diag=True)
    blocks = stamped_blocks(spec, 12, seed=4)
    port = HostReplay(spec, seed=5, use_native=use_native)
    ref = JHostReplay(jspec, seed=5, use_native=use_native)
    for blk in blocks[:8]:
        port.add(blk)
        ref.add(blk)
    for _ in range(3):
        port.sample()
        ref.sample()
    np.testing.assert_array_equal(port.sample_count, ref.sample_count)
    for blk in blocks[8:]:
        port.add(blk)
        ref.add(blk)
    got, want = port.diag_raw(), ref.diag_raw()
    m, jm = got["tree_moments"], want["tree_moments"]
    assert m[0] == jm[0] and m[4] == jm[4]
    np.testing.assert_allclose(m, jm, rtol=1e-12)
    for name in ("leaf_hist", "evict_stats", "evict_life_hist"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["evict_stats"][0] == 4
    assert port.diag_raw()["evict_stats"][0] == 0
    assert HostReplay(specs(num_blocks=8)[1], use_native=False
                      ).diag_raw() is None


# -- the kill switch and snapshots --------------------------------------------


def test_kill_switch_allocates_nothing_and_step_is_unchanged():
    """With the pillar off the ring holds no diagnostic leaf and its bytes
    are the old count; a step with both diagnostics on trains bit-equal
    to the step without them (losses, params, tree), so they only read
    the training state."""
    from r2d2_tpu_torch.learner.train_step import make_learner_step
    from r2d2_tpu_torch.telemetry.learning import LearningDiag
    from tests.test_torch_multi_step import _port_state
    _, off = specs(num_blocks=10)
    _, on = specs(num_blocks=10, replay_diag=True)
    assert all(getattr(tdr.replay_init(off, "cpu"), n) is None
               for n in DIAG_LEAVES)
    assert on.device_ring_bytes - off.device_ring_bytes == (
        2 * 10 + 1 + 5 + 64) * 4
    blocks = stamped_blocks(on, 10, seed=5)
    runs = []
    for spec, diag in ((off, None), (on, LearningDiag(interval=2,
                                                      dq_batch=4))):
        jstate = jax_filled(specs(num_blocks=10)[0], blocks)
        net, optim, ts, _ = _port_state(spec, to_numpy_state(jstate),
                                        _init_params(spec), True)
        rs = tdr.replay_init(spec, "cpu")
        tdr.replay_add_many(spec, rs, stack_blocks(blocks))
        step = make_learner_step(net, spec, optim, True, diag=diag,
                                 rdiag=(None if diag is None
                                        else ReplayDiag(interval=1, lanes=4)))
        g = torch.Generator().manual_seed(3)
        trace = []
        for _ in range(3):
            ts, rs, m = step(ts, rs, torch.rand(8, generator=g))
            trace.append((m, {n: p.clone() for n, p in
                              ts.params.state_dict().items()},
                          rs.tree.clone()))
        runs.append(trace)
    for (m0, p0, t0), (m1, p1, t1) in zip(*runs):
        assert not any(k.startswith(("ld/", "rd/")) for k in m0)
        assert any(k.startswith("ld/") for k in m1)
        assert any(k.startswith("rd/") for k in m1)
        assert torch.equal(m0["loss"], m1["loss"])
        assert all(torch.equal(p0[n], p1[n]) for n in p0)
        assert torch.equal(t0, t1)


def _init_params(spec):
    from r2d2_tpu_torch.config import NetworkConfig
    from r2d2_tpu_torch.models.network import NetworkApply
    from tests.test_torch_train_step import A, TINY
    net = NetworkApply(A, NetworkConfig(use_double=True, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    return net.init(0).state_dict()


def _filled_state(spec, blocks, sampled):
    state = tdr.replay_init(spec, "cpu")
    tdr.replay_add_many(spec, state, stack_blocks(blocks))
    if state.sample_count is not None:
        state.sample_count[:len(sampled)] += torch.tensor(sampled,
                                                          dtype=torch.int32)
    return state


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "off"])
def test_snapshot_restores_diag_leaves_bit_for_bit(tmp_path, diag):
    """A dp=1 snapshot (written and loaded) restores every leaf, the five
    diagnostic ones included, bit for bit into a fresh replay; with the
    pillar off the snapshot holds none of them and restores into a
    replay without them; a snapshot of one kind refuses the other's
    replay (its spec differs)."""
    _, spec = specs(num_blocks=8, replay_diag=diag)
    blocks = stamped_blocks(spec, 11, seed=6)
    state = _filled_state(spec, blocks[:8], [1, 0, 2])
    tdr.replay_add_many(spec, state, stack_blocks(blocks[8:]))
    ring = RingAccountant(spec.num_blocks)
    for blk in blocks:
        ring.advance(int(np.sum(blk.learning_steps)), int(blk.weight_version))
    write_snapshot(capture_plain(spec, state, ring, 7), str(tmp_path), 0)
    snap = load_snapshot(str(tmp_path), 0)
    assert set(DIAG_LEAVES) <= set(snap["shards"][0]["state"]) or not diag
    if not diag:
        assert not set(DIAG_LEAVES) & set(snap["shards"][0]["state"])
    fresh = tdr.replay_init(spec, "cpu")
    restore_plain(spec, fresh, RingAccountant(spec.num_blocks), snap)
    for name, value in vars(state).items():
        got = getattr(fresh, name)
        if value is None:
            assert got is None, name
        elif torch.is_tensor(value):
            assert torch.equal(got, value), name
        else:
            assert got == value, name
    _, other = specs(num_blocks=8, replay_diag=not diag)
    with pytest.raises(ValueError, match="spec mismatch"):
        restore_plain(other, tdr.replay_init(other, "cpu"),
                      RingAccountant(8), snap)


def test_sharded_snapshot_restores_each_shards_diag_leaves(tmp_path):
    """A dp=2 cut (two shards with their diagnostic leaves, stacked on a
    leading dp axis) restores each shard's leaves bit for bit."""
    _, spec = specs(num_blocks=8, replay_diag=True)
    blocks = stamped_blocks(spec, 14, seed=7)
    shards = [_filled_state(spec, blocks[:7], [3, 1]),
              _filled_state(spec, blocks[7:], [0, 4, 2])]
    ring = RingAccountant(2 * spec.num_blocks)
    snap = capture_sharded(spec, [shard_leaves(s) for s in shards], ring, 9)
    write_snapshot(snap, str(tmp_path), 0)
    snap = load_snapshot(str(tmp_path), 0)
    assert snap["shards"][0]["state"]["add_count"].shape == (2,)
    for d, want in enumerate(shards):
        fresh = tdr.replay_init(spec, "cpu")
        restore_plain(spec, fresh, RingAccountant(2 * spec.num_blocks), snap,
                      shard=d, dp=2)
        for name in DIAG_LEAVES + ("tree", "obs", "lane"):
            assert torch.equal(getattr(fresh, name), getattr(want, name)), \
                (d, name)
        assert fresh.block_ptr == want.block_ptr


# -- the aggregator -----------------------------------------------------------


def _rd_dispatches(rng, k=3, lanes=4, shards=None):
    """Per-dispatch rd/ dicts as a K-step dispatch returns them: NaN
    moments off interval, one interval step per dispatch."""
    out = []
    lead = () if shards is None else (shards,)
    for d in range(3):
        moments = np.full((k,) + lead + (5,), np.nan, np.float32)
        ev = np.full((k,) + lead + (5,), np.nan, np.float32)
        hist = np.zeros((k,) + lead + (NBUCKETS,), np.int32)
        life = np.zeros((k,) + lead + (NBUCKETS,), np.int32)
        on = d % k
        active = rng.integers(10, 40, lead or None)
        s1 = rng.uniform(5, 20, lead or None)
        moments[on] = np.stack([active, s1, s1 * s1 / 7, s1 / 3,
                                np.ones_like(s1)], axis=-1)
        ev[on] = np.stack([np.full_like(s1, 4), np.full_like(s1, 1),
                           np.full_like(s1, 9), np.full_like(s1, 30),
                           s1 / 10], axis=-1)
        hist[on] = rng.integers(0, 5, lead + (NBUCKETS,))
        life[on] = rng.integers(0, 2, lead + (NBUCKETS,))
        prefix = "rd/" if shards is None else "rd/shard_"
        out.append({f"{prefix}tree_moments": moments,
                    f"{prefix}leaf_hist": hist,
                    f"{prefix}evict_stats": ev,
                    f"{prefix}evict_life_hist": life,
                    "rd/lane_counts": rng.integers(0, 6, (k, lanes + 1)
                                                   ).astype(np.int32)})
    return out


@pytest.mark.parametrize("kind", ["plain", "shards", "host"])
def test_aggregator_blocks_equal_jax(rng, kind):
    """The same dispatch dicts (numpy, K=3 stacked; per-shard for the dp
    step; with the host replay's readings for host placement) into both
    packages' ReplayDiagAggregator give equal replay_diag blocks over two
    flushes (the eviction totals accumulate across them)."""
    port, ref = ReplayDiagAggregator(4), JReplayDiagAggregator(4)
    for flush in range(2):
        disp = _rd_dispatches(rng, shards=2 if kind == "shards" else None)
        host = None
        if kind == "host":
            host = {"tree_moments": np.array([20.0, 8.0, 5.0, 1.5, 2.0]),
                    "leaf_hist": rng.integers(0, 4, NBUCKETS),
                    "evict_stats": np.array([3.0, 1.0, 4.0, 24.0, 0.5]),
                    "evict_life_hist": rng.integers(0, 2, NBUCKETS)}
        for d in disp:
            port.on_dispatch({k: torch.from_numpy(v) for k, v in d.items()})
            ref.on_dispatch(d)
        got, want = port.flush(host_stats=host), ref.flush(host_stats=host)
        assert got == want
        assert "evictions" in got and "lanes" in got
        assert ("shards" in got) == (kind == "shards")
    assert port.flush() is None


# -- the config ---------------------------------------------------------------


def test_replay_diag_config_fields_and_gating():
    """The fields round-trip through JSON and the CLI, the interval is
    checked in JAX's words, and the one gating rule needs both switches;
    the lanes are the on-device loop's or the global actor ladder's."""
    cfg = parse_overrides(Config(), ["--telemetry.replay_diag_interval=7"])
    again = Config.from_json(cfg.to_json())
    assert again.telemetry.replay_diag_interval == 7
    assert again.telemetry.replay_diag_enabled
    rd = ReplayDiag.from_config(again)
    assert rd.interval == 7 and rd.lanes == (cfg.actor.num_actors
                                             * cfg.actor.envs_per_actor)
    assert ReplayDiag.from_config(cfg.replace(**{
        "actor.on_device": True, "replay.block_length": 40,
        "env.episode_len": 400})).lanes == cfg.actor.anakin_lanes
    for key in ("telemetry.enabled", "telemetry.replay_diag_enabled"):
        off = cfg.replace(**{key: False})
        assert ReplayDiag.from_config(off) is None
        from r2d2_tpu_torch.replay.structs import ReplaySpec
        assert not ReplaySpec.from_config(off, "cpu").replay_diag
    with pytest.raises(ValueError, match="replay_diag_interval"):
        cfg.replace(**{"telemetry.replay_diag_interval": 0})
    assert not parse_overrides(
        cfg, ["--telemetry.alerts_enabled=false"]).telemetry.alerts_enabled
    # the replay service's tier stats are taken; the fleet plane's
    # telemetry waits for A.6's second part
    assert parse_overrides(cfg, ["--telemetry.replay_tiers_enabled=true"]
                           ).telemetry.replay_tiers_enabled
    with pytest.raises(SystemExit, match="A.6"):
        parse_overrides(cfg, ["--telemetry.fleet_enabled=true"])


# -- the tensor-parallel steps ------------------------------------------------


def test_dpmp_step_diagnostics_match_jax(tmp_path):
    """The dp=2 x mp=2 device-replay step with both diagnostics against
    JAX's GSPMD step on a dp=2 x mp=2 mesh (three steps, the same
    shards, weights and draws; learning interval 2, replay interval 1):
    rank 0's ld/ values are shard 0's view with the global loss and
    gradients as JAX's (histograms, stamps and indices exact, the global
    and group grad norms and the target distance rtol 1e-5, dQ rtol
    1e-4); the rd/shard_* views carry the dp axis and equal JAX's
    (moments rtol 1e-5 but the counts exact, histograms exact), the lane
    counts summed; the mp replicas of a row bit-equal."""
    from tests.test_torch_learning_diag import (assert_ld_equal,
                                                assert_rd_equal)
    from tests.test_torch_tensor_parallel import DP, MP, _case
    spec, shards, init, jitter, trace = _jax_dpmp_diag_run()
    case = _case(spec, init, shards=shards, jitter=jitter, k=1, dispatches=3,
                 diag={"interval": 2, "dq_batch": 4},
                 rdiag={"interval": 1, "lanes": 4})
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    from r2d2_tpu_torch.tools import dp_check
    out = run_ranks(dp_check.rank_steps, DP, case, mp=MP,
                    rendezvous_dir=str(tmp_path))
    for i, want in enumerate(trace):
        got = out[0]["trace"][i]["diag"]
        assert_ld_equal({k: v[None] for k, v in got.items()},
                        {k: v[None] for k, v in want.items()}, raw=True)
        assert_rd_equal(got, want)
        assert got["rd/shard_tree_moments"].shape == (DP, 5)
        for rank in out[1:]:
            other = rank["trace"][i]["diag"]
            for key in got:
                if key.startswith("rd/"):
                    np.testing.assert_array_equal(other[key], got[key])
        for rank in range(MP):
            for key, value in out[rank]["trace"][i]["diag"].items():
                np.testing.assert_array_equal(value, got[key], err_msg=key)


def _jax_dpmp_diag_run():
    """JAX's dp=2 x mp=2 GSPMD step with LearningDiag(2, 4) and
    ReplayDiag(1, 4) from stamped shards: the shards (with their
    diagnostic leaves), the weights, the draws and each step's ld/ and
    rd/ values."""
    from r2d2_tpu.config import MeshConfig as JMeshConfig
    from r2d2_tpu.config import NetworkConfig as JNetworkConfig
    from r2d2_tpu.config import OptimConfig as JOptimConfig
    from r2d2_tpu.learner.train_step import create_train_state as j_create
    from r2d2_tpu.models.network import NetworkApply as JNetworkApply
    from r2d2_tpu.parallel import make_mesh as j_make_mesh
    from r2d2_tpu.parallel import (make_sharded_learner_step as j_step,
                                   make_sharded_replay_add as j_add,
                                   sharded_replay_init as j_init)
    from r2d2_tpu.parallel.tensor_parallel import state_shardings as jss
    from r2d2_tpu.replay.structs import Block as JBlock
    from r2d2_tpu.telemetry.learning import LearningDiag as JLD
    from r2d2_tpu.telemetry.replaydiag import ReplayDiag as JRD
    from tests.test_torch_tensor_parallel import DP, MP, MSW
    from tests.test_torch_train_step import A, OPTIM, TINY, _flat
    jspec, spec = specs(num_blocks=6, batch_size=8, replay_diag=True)
    mesh = j_make_mesh(JMeshConfig(dp=DP, mp=MP))
    state = j_init(jspec, mesh)
    add = j_add(jspec, mesh)
    for i, block in enumerate(stamped_blocks(spec, 3 * DP + 2, seed=7)):
        state = add(state, JBlock(**dataclasses.asdict(block)), i % DP)
    shards = [jax.tree_util.tree_map(lambda x: np.asarray(x)[s],
                                     dataclasses.asdict(state))
              for s in range(DP)]
    for shard in shards:
        shard["block_ptr"] = int(shard["block_ptr"])
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = {n: v.numpy() for n, v in _flat(ts.params).items()}
    ts = jax.device_put(ts, jss(ts, mesh, min_shard_width=MSW))
    step = j_step(jnet, jspec, optim, True, mesh, diag=JLD(2, 4),
                  rdiag=JRD(1, 4))
    jitter = np.zeros((DP, 3, 1, spec.batch_size), np.float32)
    trace = []
    for d in range(3):
        _, base = jax.random.split(ts.key)
        for s in range(DP):
            jitter[s, d, 0] = np.asarray(jax.random.uniform(
                jax.random.fold_in(base, s), (spec.batch_size,),
                jnp.float32))
        ts, state, m = step(ts, state)
        trace.append({k: np.asarray(v) for k, v in m.items()
                      if k.startswith(("ld/", "rd/"))})
    return spec, shards, init, jitter, trace


def test_host_tp_step_diagnostics_match_jax(tmp_path):
    """The host-batch TP step (dp=1 x mp=2) with both diagnostics against
    JAX's make_tp_external_batch_step with them, over two host batches
    (learning interval 2): histograms, stamps and lane counts exact, the
    group norms (each element counted once over the row) and the target
    distance rtol 1e-5, dQ NaN on every step (host placement), as in
    JAX; both ranks' values bit-equal."""
    from r2d2_tpu.config import MeshConfig as JMeshConfig
    from r2d2_tpu.config import NetworkConfig as JNetworkConfig
    from r2d2_tpu.config import OptimConfig as JOptimConfig
    from r2d2_tpu.learner.train_step import create_train_state as j_create
    from r2d2_tpu.models.network import NetworkApply as JNetworkApply
    from r2d2_tpu.parallel import make_mesh as j_make_mesh
    from r2d2_tpu.parallel.tensor_parallel import \
        make_tp_external_batch_step as j_tp_step
    from r2d2_tpu.telemetry.learning import LearningDiag as JLD
    from r2d2_tpu.telemetry.replaydiag import ReplayDiag as JRD
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    from r2d2_tpu_torch.replay.structs import SampleBatch
    from r2d2_tpu_torch.tools import dp_check
    from tests.test_torch_learning_diag import (assert_ld_equal,
                                                assert_rd_equal)
    from tests.test_torch_tensor_parallel import MSW, _case
    from tests.test_torch_train_step import A, OPTIM, TINY, _flat
    jspec, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(jspec, seed=11, use_native=False)
    for block in stamped_blocks(spec, 10, seed=5):
        host.add(block)
    batches = [host.sample()[0] for _ in range(2)]
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts0 = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = {n: v.numpy() for n, v in _flat(ts0.params).items()}
    step, place_state, place_batch = j_tp_step(
        jnet, jspec, optim, True, j_make_mesh(JMeshConfig(dp=1, mp=2)),
        min_shard_width=MSW, diag=JLD(2, 4), rdiag=JRD(1, 4))
    ts = place_state(ts0)
    want = []
    for batch in batches:
        ts, m = step(ts, place_batch(batch))
        want.append({k: np.asarray(v) for k, v in m.items()
                     if k.startswith(("ld/", "rd/"))})
    case = _case(spec, init, diag={"interval": 2, "dq_batch": 4},
                 rdiag={"interval": 1, "lanes": 4}, batches=[
                     {f.name: np.array(getattr(b, f.name))
                      for f in dataclasses.fields(SampleBatch)}
                     for b in batches])
    out = run_ranks(dp_check.rank_tp_external, 1, case, mp=2,
                    rendezvous_dir=str(tmp_path))
    for i, exp in enumerate(want):
        got = out[0]["trace"][i]["diag"]
        assert_ld_equal({k: v[None] for k, v in got.items()},
                        {k: v[None] for k, v in exp.items()}, raw=True)
        assert_rd_equal(got, exp)
        assert math.isnan(float(got["ld/delta_q_stored"]))
        assert math.isfinite(float(got["ld/target_dist"])) == (i == 1)
        for key, value in out[1]["trace"][i]["diag"].items():
            np.testing.assert_array_equal(value, got[key], err_msg=key)
