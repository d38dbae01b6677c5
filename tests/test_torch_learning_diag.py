"""The port's learning diagnostics (r2d2_tpu_torch/telemetry/learning.py)
fused into its learner steps, against the JAX package's
``telemetry/learning.py`` and its step factories on the same numpy-seeded
inputs, converted weights and injected draws: a K=3 dispatch and the
single step at interval steps and off them (with the replay diagnostics
of the same steps), the external-batch step, the dp=2 step (the port's
ranks as gloo processes, ``tools/dp_check.py``), the aggregators' blocks,
the NaN forensics and ``nan_policy``, the config, and the records of a
``cli.train`` run with the diagnostics on and off.

The bounds: histograms, stamps, indices and version stats exact; the
global and group gradient norms and the target distance rtol 1e-5; dQ
rtol 1e-4; the dp step's averaged stats rtol 1e-6."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import \
    make_external_batch_step as j_external
from r2d2_tpu.learner.train_step import make_learner_step as j_step
from r2d2_tpu.learner.train_step import make_multi_learner_step as j_multi
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu.telemetry.learning import \
    LearningAggregator as JLearningAggregator
from r2d2_tpu.telemetry.learning import LearningDiag as JLD
from r2d2_tpu.telemetry.replaydiag import ReplayDiag as JRD
from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.learner.train_step import (GraphedSteps,
                                               diag_intervals,
                                               make_external_batch_step,
                                               make_learner_step,
                                               make_multi_learner_step)
from r2d2_tpu_torch.replay.structs import SampleBatch, batch_fields
from r2d2_tpu_torch.telemetry.histogram import NBUCKETS
from r2d2_tpu_torch.telemetry.learning import (LearningAggregator,
                                               LearningDiag)
from r2d2_tpu_torch.telemetry.replaydiag import ReplayDiag
from tests.test_torch_multi_step import _port_state
from tests.test_torch_replay import (jax_filled, specs, to_numpy_state)
from tests.test_torch_replay_diag import stamped_blocks
from tests.test_torch_train import TINY_ARGS
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

K = 3
INTERVAL, DQ_BATCH = 2, 4          # interval steps 2, 4, 6
RD_INTERVAL, LANES = 3, 4
HISTS = ("ld/td_hist", "ld/prio_hist", "ld/q_hist")
VERSIONS = ("ld/version_min", "ld/version_max", "ld/version_mean",
            "ld/unknown_frac")
DQS = ("ld/delta_q_stored", "ld/delta_q_zero", "ld/delta_q_recomputed")


def _close(got, want, rtol, key):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=key)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, err_msg=key)


def assert_ld_equal(got: dict, want: dict, raw: bool,
                    mean_rtol: float = 0.0) -> None:
    """The ld/ values of steps stacked on a leading axis against JAX's,
    within the module docstring's bounds (``mean_rtol``: the version mean
    and unknown share of the dp step, averaged in another order)."""
    want = {k: v for k, v in want.items() if k.startswith("ld/")}
    got = {k: v for k, v in got.items() if k.startswith("ld/")}
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for key in HISTS + ("ld/nonfinite", "ld/version_min", "ld/version_max"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("ld/version_mean", "ld/unknown_frac"):
        _close(got[key], want[key], mean_rtol or 1e-7, key)
    for key in got:
        if key.startswith("ld/grad_norm") or key == "ld/target_dist":
            _close(got[key], want[key], 1e-5, key)
    for key in DQS:
        _close(got[key], want[key], 1e-4, key)
    if raw:
        for key in ("ld/weight_versions", "ld/batch_idxes"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def assert_rd_equal(got: dict, want: dict) -> None:
    """The rd/ values against JAX's: counts exact (the moments' active and
    at-max counts, the histograms, the evicted / never-sampled /
    lifetime / age sums, the lanes), the moments' sums and max rtol 1e-5,
    the final priority sum rtol 1e-6."""
    want = {k: v for k, v in want.items() if k.startswith("rd/")}
    got = {k: v for k, v in got.items() if k.startswith("rd/")}
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for key, w in want.items():
        g = got[key]
        if key.endswith("tree_moments"):
            np.testing.assert_array_equal(g[..., [0, 4]], w[..., [0, 4]],
                                          err_msg=key)
            _close(g[..., 1:4], w[..., 1:4], 1e-5, key)
        elif key.endswith("evict_stats"):
            np.testing.assert_array_equal(g[..., :4], w[..., :4],
                                          err_msg=key)
            _close(g[..., 4], w[..., 4], 1e-6, key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _jax_net(use_double):
    return JNetworkApply(A, JNetworkConfig(use_double=use_double, **TINY),
                         2, 24, 24)


def _jax_run(use_double: bool, k: int, dispatches: int, rdiag: bool = True):
    """The JAX step (k = 1: ``make_learner_step``, else the K-step
    dispatch) with LearningDiag(2, 4) and ReplayDiag(3, 4) from a replay
    of 12 stamped blocks over a 10-block ring (so the ledger holds
    evictions): the start state, the weights, and per dispatch its (k, B)
    jitter, its ld/ and rd/ values and the replay's diagnostic leaves
    after it."""
    jspec, spec = specs(num_blocks=10, batch_size=8, replay_diag=True)
    jstate = jax_filled(jspec, stamped_blocks(spec, 12, seed=5, lanes=LANES))
    start = to_numpy_state(jstate)
    jnet = _jax_net(use_double)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = _flat(ts.params)
    kw = dict(diag=JLD(INTERVAL, DQ_BATCH),
              rdiag=JRD(RD_INTERVAL, LANES) if rdiag else None)
    step = (j_step(jnet, jspec, optim, use_double, **kw) if k == 1
            else j_multi(jnet, jspec, optim, use_double, k, **kw))
    trace = []
    for _ in range(dispatches):
        key, jitter = ts.key, []
        for _ in range(k):
            key, base = jax.random.split(key)
            jitter.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(base, 0), (spec.batch_size,),
                jnp.float32)))
        ts, jstate, m = step(ts, jstate)
        values = {key: np.asarray(v) for key, v in m.items()
                  if key.startswith(("ld/", "rd/"))}
        if k == 1:
            values = {key: v[None] for key, v in values.items()}
        trace.append(dict(jitter=np.stack(jitter), diag=values,
                          sample_count=np.asarray(jstate.sample_count),
                          evict_stats=np.asarray(jstate.evict_stats)))
    return spec, start, init, trace


@pytest.fixture(scope="module")
def multi_run():
    return _jax_run(True, K, 2)


def _port_values(m: dict, k: int) -> dict:
    out = {key: v.numpy() for key, v in m.items()
           if key.startswith(("ld/", "rd/"))}
    return out if k > 1 else {key: v[None] for key, v in out.items()}


def test_k_step_dispatch_diagnostics_match_jax(multi_run):
    """Two K=3 dispatches (interval steps 2, 4 and 6: one inside the first
    dispatch, two inside the second; tree snapshots at steps 3 and 6)
    against JAX's ``make_multi_learner_step`` with both diagnostics: every
    ld/ and rd/ value within the module's bounds, NaN dQ and target
    distance exactly off interval, and the replay's sample counts and
    ledger after each dispatch exact (the priority sum rtol 1e-6)."""
    spec, start, init, trace = multi_run
    net, optim, ts, rs = _port_state(spec, start, init, True)
    multi = make_multi_learner_step(net, spec, optim, True, K,
                                    diag=LearningDiag(INTERVAL, DQ_BATCH),
                                    rdiag=ReplayDiag(RD_INTERVAL, LANES))
    for d, want in enumerate(trace):
        ts, rs, m = multi(ts, rs, torch.from_numpy(want["jitter"].copy()))
        got = _port_values(m, K)
        assert_ld_equal(got, want["diag"], raw=True)
        assert_rd_equal(got, want["diag"])
        on = [(d * K + i + 1) % INTERVAL == 0 for i in range(K)]
        assert list(np.isfinite(got["ld/delta_q_stored"])) == on
        assert list(np.isfinite(got["ld/target_dist"])) == on
        np.testing.assert_array_equal(rs.sample_count.numpy(),
                                      want["sample_count"])
        np.testing.assert_array_equal(rs.evict_stats.numpy()[:4],
                                      want["evict_stats"][:4])
    assert got["ld/weight_versions"].shape == (K, spec.batch_size)
    assert got["ld/td_hist"].shape == (K, NBUCKETS)


def test_single_step_diagnostics_match_jax():
    """Two single steps (step 1 off interval, step 2 on) without double
    DQN, where the target distance is the drift from the initial weights
    (JAX's frozen target), against JAX's ``make_learner_step`` with the
    learning diagnostics: every ld/ value within the bounds."""
    spec, start, init, trace = _jax_run(False, 1, 2, rdiag=False)
    net, optim, ts, rs = _port_state(spec, start, init, False)
    step = make_learner_step(net, spec, optim, False,
                             diag=LearningDiag(INTERVAL, DQ_BATCH))
    for d, want in enumerate(trace):
        ts, rs, m = step(ts, rs, torch.from_numpy(want["jitter"][0].copy()))
        got = _port_values(m, 1)
        assert not any(key.startswith("rd/") for key in got)
        assert_ld_equal(got, want["diag"], raw=True)
    assert float(got["ld/target_dist"][0]) > 0


def test_external_step_diagnostics_match_jax():
    """The external-batch step (host placement) with both diagnostics
    against JAX's on the same host-sampled batches, interval 1: the ld/
    values within the bounds with dQ NaN (no stored rows on the device)
    and the target distance on every step; the lane counts exact."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(jspec, seed=11, use_native=False)
    for block in stamped_blocks(spec, 10, seed=5, lanes=LANES):
        host.add(block)
    batches = [host.sample()[0] for _ in range(2)]
    jnet = _jax_net(True)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    jts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = _flat(jts.params)
    jstep = j_external(jnet, jspec, optim, True, diag=JLD(1, DQ_BATCH),
                       rdiag=JRD(1, LANES))
    net, poptim, ts, _ = _port_state(
        spec, to_numpy_state(jax_filled(jspec, [])), init, True)
    step = make_external_batch_step(net, spec, poptim, True,
                                    diag=LearningDiag(1, DQ_BATCH),
                                    rdiag=ReplayDiag(1, LANES))
    for batch in batches:
        jts, jm = jstep(jts, batch)
        want = {k: np.asarray(v)[None] for k, v in jm.items()
                if k.startswith(("ld/", "rd/"))}
        ts, m = step(ts, SampleBatch(**{
            name: torch.from_numpy(np.array(a))
            for name, a in batch_fields(batch).items()}))
        got = _port_values(m, 1)
        assert_ld_equal(got, want, raw=True)
        assert_rd_equal(got, want)
        assert math.isnan(float(got["ld/delta_q_zero"][0]))
        assert math.isfinite(float(got["ld/target_dist"][0]))


def test_dp2_step_diagnostics_match_jax(tmp_path):
    """The dp=2 step with both diagnostics (two gloo ranks, K=3, two
    dispatches) against JAX's manual dp step on a dp=2 mesh of fake
    devices, the same shards, weights and per-shard draws: the reduced
    ld/ values (histograms summed, version min / max exact, the averaged
    stats rtol 1e-6, dQ and the target distance averaged, the group
    norms of the averaged gradients; no per-sequence vectors) and the
    rd/shard_* views with their dp axis and the summed lane counts, on
    both ranks alike."""
    from r2d2_tpu.config import MeshConfig as JMeshConfig
    from r2d2_tpu.parallel import make_mesh as j_make_mesh
    from r2d2_tpu.parallel import (make_sharded_learner_step as j_sharded,
                                   make_sharded_replay_add as j_add,
                                   sharded_replay_init as j_init)
    from r2d2_tpu.replay.structs import Block as JBlock
    from r2d2_tpu_torch.parallel.mesh import run_ranks
    from r2d2_tpu_torch.tools import dp_check
    dp = 2
    jspec, spec = specs(num_blocks=6, batch_size=8, replay_diag=True)
    mesh = j_make_mesh(JMeshConfig(dp=dp))
    state = j_init(jspec, mesh)
    add = j_add(jspec, mesh)
    for i, block in enumerate(stamped_blocks(spec, 14, seed=7,
                                             lanes=LANES)):
        state = add(state, JBlock(**dataclasses.asdict(block)), i % dp)
    shards = [jax.tree_util.tree_map(lambda x: np.asarray(x)[s],
                                     dataclasses.asdict(state))
              for s in range(dp)]
    for shard in shards:
        shard["block_ptr"] = int(shard["block_ptr"])
    jnet = _jax_net(True)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = {n: v.numpy() for n, v in _flat(ts.params).items()}
    step = j_sharded(jnet, jspec, optim, True, mesh, steps_per_dispatch=K,
                     diag=JLD(INTERVAL, DQ_BATCH),
                     rdiag=JRD(RD_INTERVAL, LANES))
    jitter = np.zeros((dp, 2, K, spec.batch_size), np.float32)
    trace = []
    for d in range(2):
        key = ts.key
        for k in range(K):
            key, base = jax.random.split(key)
            for s in range(dp):
                jitter[s, d, k] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(base, s), (spec.batch_size,),
                    jnp.float32))
        ts, state, m = step(ts, state)
        trace.append({k: np.asarray(v) for k, v in m.items()
                      if k.startswith(("ld/", "rd/"))})
    case = {"spec": dataclasses.asdict(spec), "action_dim": A,
            "network": {"use_double": True, **TINY}, "optim": OPTIM,
            "params": init, "shards": shards, "jitter": jitter, "k": K,
            "dispatches": 2, "diag": {"interval": INTERVAL,
                                      "dq_batch": DQ_BATCH},
            "rdiag": {"interval": RD_INTERVAL, "lanes": LANES}}
    out = run_ranks(dp_check.rank_steps, dp, case,
                    rendezvous_dir=str(tmp_path))
    for d, want in enumerate(trace):
        got = out[0]["trace"][d]["diag"]
        assert "ld/batch_idxes" not in got
        assert_ld_equal(got, want, raw=False, mean_rtol=1e-6)
        assert_rd_equal(got, want)
        assert got["rd/shard_evict_stats"].shape == (K, dp, 5)
        for key, value in out[1]["trace"][d]["diag"].items():
            np.testing.assert_array_equal(value, got[key], err_msg=key)


def test_graph_flags_mark_each_steps_interval_work():
    """The CUDA graph wrapper's patterns of interval steps (no card
    needed): at K=4 with the default intervals (dQ every 200 steps, a
    snapshot every 50) one period of 50 dispatches holds four patterns,
    none, a snapshot at offset 1 or 3, and dQ with a snapshot at offset 3;
    with dQ every 5 and a snapshot every 3, dQ falls at every offset;
    without diagnostics every step's flags are off."""
    none = ((False, False),) * 4
    g = GraphedSteps(None, 4, 8, intervals=diag_intervals(
        LearningDiag(200, 16), ReplayDiag(50, 4)))
    assert {g.flags(4 * d) for d in range(50)} == {
        none, (none[0], (False, True)) + none[2:],
        none[:3] + ((False, True),), none[:3] + ((True, True),)}
    assert g.flags(196)[3] == (True, True) and g.flags(48)[1] == (False, True)
    g = GraphedSteps(None, 4, 8, intervals=diag_intervals(
        LearningDiag(5, 16), ReplayDiag(3, 4)))
    patterns = {g.flags(4 * d) for d in range(15)}
    assert {p.index(f) for p in patterns for f in p if f[0]} == {0, 1, 2, 3}
    assert GraphedSteps(None, 4, 8).flags(196) == none
    assert diag_intervals(None, None) is None


# -- the aggregator, the forensics --------------------------------------------


def _ld_dispatches(rng, k=3, raw=True, nonfinite_at=None):
    out = []
    for d in range(4):
        v = {f"ld/{n}_hist": rng.integers(0, 4, (k, NBUCKETS)).astype(
            np.int32) for n in ("td", "prio", "q")}
        for name in ("grad_norm", "grad_norm_head", "grad_norm_lstm",
                     "grad_norm_torso"):
            v[f"ld/{name}"] = rng.uniform(0.1, 2, k).astype(np.float32)
        v["ld/nonfinite"] = np.zeros(k, np.int32)
        if nonfinite_at == d:
            v["ld/nonfinite"][1] = 1
        nan = np.full(k, np.nan, np.float32)
        for key in ("ld/target_dist",) + DQS:
            v[key] = nan.copy()
            v[key][d % k] = rng.uniform(0, 1)
        versions = rng.integers(-1, 9, (k, 8)).astype(np.int32)
        known = versions >= 0
        v["ld/version_min"] = np.where(known, versions, 2 ** 30).min(
            1).astype(np.float32)
        v["ld/version_max"] = np.where(known, versions, -1).max(1).astype(
            np.float32)
        v["ld/version_mean"] = ((versions * known).sum(1)
                                / np.maximum(known.sum(1), 1)
                                ).astype(np.float32)
        v["ld/unknown_frac"] = (1 - known.mean(1)).astype(np.float32)
        if raw:
            v["ld/weight_versions"] = versions
            v["ld/batch_idxes"] = rng.integers(0, 40, (k, 8)).astype(
                np.int32)
        out.append(v)
    return out


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "reduced"])
def test_aggregator_blocks_equal_jax(tmp_path, rng, raw):
    """The same dispatch dicts (K=3 stacked; with the raw stamps, or the
    dp step's reduced stats) into both packages' LearningAggregator give
    equal learning blocks, with the publication clock and the ring's
    occupancy stamps."""
    port = LearningAggregator(0, str(tmp_path / "p"), "warn", 1e-3)
    ref = JLearningAggregator(0, str(tmp_path / "j"), "warn", 1e-3)
    for d in _ld_dispatches(rng, raw=raw):
        port.on_dispatch({k: torch.from_numpy(v) for k, v in d.items()})
        ref.on_dispatch(d)
    occupancy = [3, -1, 5, 8, 8, 1]
    got = port.flush(40, publish_count=9, occupancy_versions=occupancy)
    want = ref.flush(40, publish_count=9, occupancy_versions=occupancy)
    assert got == want
    assert set(got) >= {"td_abs", "grad_norm", "delta_q", "sample_age",
                        "replay_age", "nonfinite_steps"}
    assert port.flush(41) is None


def test_nan_dump_fires_once_and_halt_raises(tmp_path, rng, caplog):
    """A non-finite step: "warn" writes one dump (JAX's fields: step,
    histograms, the last batch's indices and stamps) and goes on, a
    second one writes none; "halt" writes its dump and raises in JAX's
    words."""
    agg = LearningAggregator(0, str(tmp_path), "warn", 1e-3)
    for d in _ld_dispatches(rng, nonfinite_at=1):
        agg.on_dispatch(d)
    block = agg.flush(12, publish_count=3)
    assert block["nonfinite_steps"] == 1
    dump = json.loads((tmp_path / "nan_dump_player0.json").read_text())
    assert dump["step"] == 12 and dump["nan_policy"] == "warn"
    assert len(dump["last_batch_idxes"]) == K * 8
    assert set(dump["histograms"]) == {"td_abs_counts", "priority_counts",
                                       "q_abs_counts"}
    (tmp_path / "nan_dump_player0.json").unlink()
    for d in _ld_dispatches(rng, nonfinite_at=2):
        agg.on_dispatch(d)
    agg.flush(20)
    assert not (tmp_path / "nan_dump_player0.json").exists()
    halt = LearningAggregator(1, str(tmp_path), "halt", 1e-3)
    for d in _ld_dispatches(rng, nonfinite_at=0):
        halt.on_dispatch(d)
    with pytest.raises(RuntimeError, match="nan_policy=halt"):
        halt.flush(5)
    assert (tmp_path / "nan_dump_player1.json").exists()


def test_learner_halts_at_the_flush_after_a_poisoned_step(tmp_path):
    """A CPU Learner with nan_policy="halt": clean dispatches flush a
    learning block with no non-finite step; after its params are
    poisoned with a NaN, the next flush writes one dump and raises; with
    "warn" the same flush reports the step and training goes on."""
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from tests.test_torch_orchestrator import tiny_config
    for policy in ("halt", "warn"):
        cfg = tiny_config(tmp_path / policy, **{
            "telemetry.nan_policy": policy, "replay.learning_starts": 40})
        net = NetworkApply(A, cfg.network, cfg.env.frame_stack,
                           cfg.env.frame_height, cfg.env.frame_width, "cpu")
        learner = Learner(cfg, net)
        for blk in stamped_blocks(learner.spec, 4, seed=2):
            blk.action = np.asarray(blk.action) % A
            learner.ingest(blk)
        learner.step()
        learner.flush_metrics()
        record = learner.metrics.log(1.0)
        assert record["learning"]["nonfinite_steps"] == 0
        assert "replay_diag" in record
        with torch.no_grad():
            next(learner.train_state.params.parameters()).fill_(
                float("nan"))
        learner.step()
        dump = tmp_path / policy / "nan_dump_player0.json"
        if policy == "halt":
            with pytest.raises(RuntimeError, match="nan_policy=halt"):
                learner.flush_metrics()
        else:
            learner.flush_metrics()
            assert learner.metrics.log(1.0)["learning"][
                "nonfinite_steps"] == 1
        assert dump.exists()


# -- the config and the records ----------------------------------------------


def test_learning_config_fields_checks_and_gating():
    """JAX's fields and defaults, round-tripped through JSON and the CLI;
    the checks in JAX's words; the gating rule; the other JAX telemetry
    fields refused naming ROADMAP A.7."""
    t = Config().telemetry
    assert (t.enabled, t.learning_enabled, t.learning_interval,
            t.learning_dq_batch, t.nan_policy) == (True, True, 200, 16,
                                                   "warn")
    cfg = parse_overrides(Config(), ["--telemetry.learning_interval=9",
                                     "--telemetry.nan_policy=halt"])
    again = Config.from_json(cfg.to_json())
    assert LearningDiag.from_config(again) == LearningDiag(9, 16)
    assert again.telemetry.nan_policy == "halt"
    for key in ("telemetry.enabled", "telemetry.learning_enabled"):
        assert LearningDiag.from_config(cfg.replace(**{key: False})) is None
    for key, value, word in (("learning_interval", 0, "learning_interval"),
                             ("learning_dq_batch", 0, "learning_dq_batch"),
                             ("nan_policy", "stop", "nan_policy")):
        with pytest.raises(ValueError, match=word):
            cfg.replace(**{f"telemetry.{key}": value})
    for name in ("alerts_enabled", "resources_enabled", "tracing_enabled",
                 "compile_enabled", "replay_tiers_enabled"):
        assert parse_overrides(cfg, [f"--telemetry.{name}=1"])
    for name in ("fleet_enabled", "fleet_host_row_max_bytes"):
        with pytest.raises(SystemExit, match="A.6"):
            parse_overrides(cfg, [f"--telemetry.{name}=1"])


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_cli_train_records_carry_the_blocks(tmp_path, enabled):
    """``cli.train --device=cpu`` on Fake (thread actors, the tiny shape,
    a 10-block ring that wraps, no rate limit, short intervals): its
    records carry ``learning`` and ``replay_diag`` in JAX's schema
    (finite grad norms, a dQ, an ESS > 0, evictions with a never-sampled
    share in [0, 1], lanes that cover the ladder); with
    ``--telemetry.enabled=false`` none carries either."""
    from r2d2_tpu_torch.cli import train
    args = TINY_ARGS + [
        "--device=cpu", "--actor-mode=thread", "--max-steps=12",
        f"--runtime.save_dir={tmp_path}", "--runtime.log_interval=0.2",
        "--runtime.save_interval=0", "--actor.num_actors=2",
        "--runtime.steps_per_dispatch=1", "--replay.capacity=200",
        "--replay.max_env_steps_per_train_step=0",
        "--telemetry.learning_interval=4",
        "--telemetry.replay_diag_interval=2",
        f"--telemetry.enabled={str(enabled).lower()}"]
    train.main(args)
    records = [json.loads(line) for line in
               (tmp_path / "metrics_player0.jsonl").read_text().splitlines()]
    assert records
    learning = [r["learning"] for r in records if "learning" in r]
    replay = [r["replay_diag"] for r in records if "replay_diag" in r]
    if not enabled:
        assert not learning and not replay
        return
    assert learning and replay
    block = learning[-1]
    assert set(block) >= {"td_abs", "td_abs_counts", "priority", "q_abs",
                          "grad_norm", "target_param_dist", "delta_q",
                          "sample_age", "replay_age", "nonfinite_steps"}
    assert set(block["grad_norm"]) == {"global", "head", "lstm", "torso"}
    assert all(math.isfinite(v["max"]) for v in block["grad_norm"].values())
    assert any(b["delta_q"] is not None for b in learning)
    tree = [r["tree"] for r in replay if "tree" in r]
    assert tree and tree[-1]["ess"] > 0
    evictions = [r["evictions"] for r in replay if "evictions" in r][-1]
    assert evictions["evicted"] > 0
    assert 0.0 <= evictions["never_sampled_frac"] <= 1.0
    lanes = [r["lanes"] for r in replay if "lanes" in r][-1]
    assert lanes["total_lanes"] == 2 and lanes["active_lanes"] >= 1
