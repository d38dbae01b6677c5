"""The port's service-routed Learner (``fleet.replay_shards`` = 2, the
spill tier on) against the JAX package's on the CPU: the same weights
(models/convert.py), the same blocks and the same descent draws (JAX's
service key chain, injected through ``sample_jitter``), three steps
synchronously and staged: losses at rtol 1e-5, the params at atol 1e-5
(f32), the written-back priorities at rtol 2e-5, the service's shards
equal after the synchronous run. The record's ``replay_service`` and
``trace`` blocks carry JAX's keys; a service snapshot captured, written,
loaded and restored into a resumed learner steps as the uninterrupted
one; the ``fleet`` section round-trips, is checked in JAX's words, and
the fields of A.6's second part are refused naming it. Every wait on a
thread is bounded."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu.runtime.learner_loop import Learner as JLearner
from r2d2_tpu_torch.config import Config, parse_overrides
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay.snapshot import load_snapshot, read_manifest
from r2d2_tpu_torch.replay.structs import with_trace
from r2d2_tpu_torch.runtime.learner_loop import Learner
from r2d2_tpu_torch.telemetry.tracing import now_ms
from tests.test_torch_replay import synthetic_blocks

pytestmark = pytest.mark.torch_port

A = 18              # synthetic blocks draw actions in [0, 18)
STEPS = 3
BLOCKS = 12         # 6 a shard over 4 rows: each shard's ring wraps
WAIT = 60.0

OVERRIDES = {
    "env.game_name": "Fake",
    "env.frame_height": 12, "env.frame_width": 12, "env.frame_stack": 2,
    "network.hidden_dim": 8, "network.cnn_out_dim": 16,
    "network.conv_layers": ((4, 3, 2),),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3,
    "replay.capacity": 160, "replay.block_length": 20,
    "replay.batch_size": 4, "replay.learning_starts": 40,
    "runtime.save_interval": 0, "runtime.steps_per_dispatch": 1,
    "fleet.replay_shards": 2, "fleet.spill_blocks": 4,
    "telemetry.tracing_enabled": True, "telemetry.trace_sample_every": 1,
}


def wait_until(cond, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"not within {timeout} s"
        time.sleep(0.01)


def record_writebacks(service, out: list) -> None:
    """Wrap a service's write-backs (single and grouped) to keep each
    batch's priorities, in order."""
    single = service.update_priorities
    group = service.update_priorities_group

    def one(shard, idxes, td, adds_snapshot=None):
        out.append(np.array(td.cpu() if torch.is_tensor(td) else td))
        return single(shard, idxes, td, adds_snapshot=adds_snapshot)

    def many(shard, entries):
        out.extend(np.asarray(td) for _, td, _ in entries)
        return group(shard, entries)

    service.update_priorities = one
    service.update_priorities_group = many


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's service-routed learner, three synchronous steps: its initial
    params, the blocks, the draws, the losses, the written-back
    priorities, the final params and shards, its blocks' keys."""
    d = tmp_path_factory.mktemp("jax_service")
    jcfg = JConfig().replace(**OVERRIDES, **{"runtime.save_dir": str(d)})
    jl = JLearner(jcfg, JNetworkApply(A, jcfg.network, 2, 12, 12))
    try:
        params0 = jax.tree_util.tree_map(np.asarray, jl.train_state.params)
        spec_blocks = synthetic_blocks(jl.spec, BLOCKS, seed=3)
        stamp = now_ms()
        for blk in spec_blocks:
            jl.ingest(JBlock(**dataclasses.asdict(blk),
                             trace_ms=np.asarray(stamp, np.int32)))
        assert jl.ready
        key = jl._service_key
        draws = []
        for _ in range(STEPS):
            key, sub = jax.random.split(key)
            draws.append(np.array(jax.random.uniform(
                sub, (jcfg.replay.batch_size,), dtype=np.float32)))
        prios: list = []
        record_writebacks(jl.service, prios)
        losses = [float(jl.step()["loss"]) for _ in range(STEPS)]
        yield {
            "params0": params0, "blocks": spec_blocks, "stamp": stamp,
            "draws": draws, "losses": losses, "prios": prios,
            "params": params_from_flax(jax.tree_util.tree_map(
                np.asarray, jl.train_state.params)),
            "shards": jl.service.shards,
            "service_block": jl.service.interval_block(),
            "trace_block": jl._exp_trace.interval_block(),
        }
    finally:
        jl.stop_background()


def port_learner(tmp_path, params0=None, **extra) -> Learner:
    cfg = Config().replace(**{**OVERRIDES, "runtime.save_dir": str(tmp_path),
                              **extra})
    learner = Learner(cfg, NetworkApply(A, cfg.network, 2, 12, 12, "cpu"))
    if params0 is not None:
        state = params_from_flax(params0)
        ts = learner.train_state
        ts.params.load_state_dict(state)
        ts.target_params.load_state_dict(state)
    return learner


def keys_of(block) -> dict:
    """A record block's key tree (leaves as None)."""
    if isinstance(block, dict):
        return {k: keys_of(v) for k, v in block.items()}
    return None


@pytest.mark.parametrize("staging", [False, True], ids=["sync", "staged"])
def test_service_learner_matches_jax(tmp_path, jax_run, staging):
    """Three steps from JAX's weights on JAX's blocks and draws: losses,
    params and written-back priorities as JAX's; the synchronous run's
    shards (ring rows, trees, spill pages and demotion tables) exactly
    JAX's; the staged run's third step sampled on the prefetch thread and
    written back on the write-back thread."""
    learner = port_learner(tmp_path, jax_run["params0"],
                           **{"fleet.sample_staging": staging})
    try:
        assert learner.service is not None and learner.steps_per_dispatch == 1
        for blk in jax_run["blocks"]:
            learner.ingest(with_trace(dataclasses.replace(blk),
                                      np.asarray(jax_run["stamp"], np.int32)))
        assert learner.ready
        draws = iter(torch.from_numpy(d) for d in jax_run["draws"])
        learner.sample_jitter = lambda: next(draws)
        prios: list = []
        record_writebacks(learner.service, prios)
        losses = []
        for _ in range(STEPS):
            m = learner.step()
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
        if staging:
            assert len(learner._svc_threads) == 2
            wait_until(lambda: learner._svc_writeback_q.unfinished_tasks == 0
                       and len(prios) >= STEPS)
        for got, want in zip(prios[:STEPS], jax_run["prios"]):
            np.testing.assert_allclose(got, want, rtol=2e-5)
        for name, p in learner.train_state.params.state_dict().items():
            np.testing.assert_allclose(p.numpy(),
                                       jax_run["params"][name].numpy(),
                                       atol=1e-5, err_msg=name)
        assert keys_of(learner.service.interval_block()) == keys_of(
            jax_run["service_block"])
        assert keys_of(learner._exp_trace.interval_block()) == keys_of(
            jax_run["trace_block"])
        shards = learner.service.shards
        assert sum(s.spill.demotions for s in shards) > 0
        if not staging:
            from tests.test_torch_replay_service import assert_shard_equal
            for i, (got, want) in enumerate(zip(shards, jax_run["shards"])):
                want_tree = np.asarray(want.state.tree)
                np.testing.assert_allclose(got.state.tree.numpy(), want_tree,
                                           rtol=2e-5, err_msg=f"shard {i}")
                # the tree at rtol 2e-5 (the priorities'), the commit's
                # wall stamps are each run's own: the rest exactly
                got.state.tree = torch.from_numpy(want_tree.copy())
                got.ring.slot_ingest_ms = want.ring.slot_ingest_ms
                assert_shard_equal(got, want, f"shard {i}")
    finally:
        learner.stop_background(join_timeout=WAIT)
    assert not learner._svc_threads


def test_service_record_blocks_in_cli_train(tmp_path):
    """cli.train on the CPU under the service with every plane on (spill,
    grouped ingest, prefetch, staging, tracing, tiers): every record
    carries ``replay_service`` with its tiers and ingest and a ``trace``
    block once steps ran; no crit alert."""
    import json

    from r2d2_tpu_torch.cli import train
    from tests.test_torch_train import TINY_ARGS
    summary = train.main(TINY_ARGS + [
        "--device=cpu", "--max-steps=16", "--actor-mode=thread",
        "--fleet.replay_shards=2", "--fleet.spill_blocks=8",
        "--fleet.ingest_batch_blocks=4", "--fleet.spill_prefetch=true",
        "--fleet.sample_staging=true", "--telemetry.tracing_enabled=true",
        "--telemetry.trace_sample_every=1",
        "--telemetry.replay_tiers_enabled=true",
        "--runtime.log_interval=0.2",
        f"--runtime.save_dir={tmp_path}"])
    assert summary["steps"] >= 16
    records = [json.loads(line) for line in
               open(tmp_path / "metrics_player0.jsonl")]
    assert records and all("replay_service" in r for r in records)
    last = records[-1]["replay_service"]
    assert {"shards", "spill", "ingest"} <= set(last)
    assert {"tiers", "promotion_latency", "prefetch"} <= set(last["spill"])
    assert last["shards"]["n"] == 2
    assert any("trace" in r for r in records)
    for r in records:
        assert all(a["severity"] != "crit" for a in r["alerts"]["fired"])
    assert "p0/replay_service" in records[-1]["resources"]["buffers"]


def test_service_snapshot_resume_equals_the_uninterrupted_run(tmp_path):
    """Checkpoint, then a service snapshot (every shard, its spill pages
    and cursors, the service generator's state) written and committed;
    a learner resumed from both holds the same shards and takes the same
    next steps as the one that went on."""
    from tests.test_torch_replay_service import assert_shard_equal
    extra = {"runtime.snapshot_interval": 1000, "runtime.save_interval": 1}
    lr = port_learner(tmp_path, **extra)
    try:
        for blk in synthetic_blocks(lr.spec, BLOCKS, seed=4):
            lr.ingest(blk)
        lr.step()
        ckpt = lr.save(1)
        lr.snapshot_replay()
        assert lr._snap_writer.drain(WAIT) and lr._snap_writer.count == 1
        adds = lr.ring.total_adds       # the blocks and the promotions
        assert adds > BLOCKS
        man = read_manifest(str(tmp_path), 0)
        assert man["kind"] == "service" and man["total_adds"] == adds
        assert all(s["spill"]["occupancy"] > 0 for s in man["shards"])
        assert load_snapshot(str(tmp_path), 0)["route"] == "round_robin"
        twin = [lr.step()["loss"].item() for _ in range(2)]
        resumed = port_learner(tmp_path, **extra,
                               **{"runtime.resume": ckpt})
        try:
            assert resumed._restores == 1
            assert resumed._restored_blocks == adds
            losses = [resumed.step()["loss"].item() for _ in range(2)]
            assert losses == twin
            # the interval counters are the record's, not the cut's
            resumed.service.interval_block()
            lr.service.interval_block()
            for got, want in zip(resumed.service.shards, lr.service.shards):
                assert_shard_equal(got, want)
        finally:
            resumed.stop_background(join_timeout=WAIT)
    finally:
        lr.stop_background(join_timeout=WAIT)


def test_fleet_config_round_trip_and_checks():
    """The replay plane's fields with JAX's defaults, round-tripped; its
    checks in JAX's words; JAX's other fleet fields refused naming A.6's
    second part."""
    from r2d2_tpu.config import FleetConfig as JFleet
    from r2d2_tpu_torch.config import FleetConfig
    for f in dataclasses.fields(FleetConfig):
        assert getattr(FleetConfig(), f.name) == getattr(JFleet(), f.name)
    assert not Config().fleet.active
    cfg = parse_overrides(Config(), [
        "--fleet.replay_shards=2", "--fleet.spill_blocks=10",
        "--fleet.ingest_batch_blocks=8", "--fleet.spill_prefetch=true",
        "--fleet.sample_staging=true", "--fleet.service_transport=socket",
        "--fleet.socket_window=4", "--fleet.replay_route=lane",
        "--replay.capacity=8000", "--actor.num_actors=2"])
    assert cfg.fleet.active and cfg.fleet.socket_window == 4
    assert Config.from_json(cfg.to_json()).fleet == cfg.fleet
    base = {"replay.capacity": 8000}
    for over, match in (
            ({"fleet.replay_shards": 3}, "divide num_blocks"),
            ({"fleet.replay_shards": 2, "replay.placement": "host"},
             "placement"),
            ({"fleet.replay_shards": 2, "mesh.dp": 2}, "1x1 mesh"),
            ({"fleet.replay_shards": 2, "actor.on_device": True,
              "replay.block_length": 120, "replay.capacity": 12000,
              "env.episode_len": 240}, "host actor fleet"),
            ({"fleet.replay_shards": 4, "fleet.replay_route": "lane",
              "actor.num_actors": 2}, "lanes"),
            ({"fleet.spill_blocks": 4}, "spill_blocks requires"),
            ({"fleet.replay_shards": 2, "fleet.replay_route": "hash"},
             "replay_route"),
            ({"fleet.service_transport": "socket"}, "service_transport"),
            ({"fleet.ingest_batch_blocks": 0}, "ingest_batch_blocks"),
            ({"fleet.ingest_batch_blocks": 4}, "requires"),
            ({"fleet.socket_window": 2}, "socket_window"),
            ({"fleet.replay_shards": 2, "fleet.spill_prefetch": True},
             "spill_prefetch"),
            ({"fleet.sample_staging": True}, "sample_staging")):
        with pytest.raises(ValueError, match=match):
            Config().replace(**{**base, **over})
        with pytest.raises(ValueError):
            JConfig().replace(**{**base, **over})
    for name, value in (("fanout_degree", 2), ("elastic", "true"),
                        ("max_slots", 4), ("lease_transport", "socket"),
                        ("promotion_canary_frac", 0.5)):
        with pytest.raises(SystemExit, match="A.6, second part"):
            parse_overrides(Config(), [f"--fleet.{name}={value}"])
        with pytest.raises(ValueError, match="A.6, second part"):
            Config().replace(**{f"fleet.{name}": value})


def test_service_learner_ignores_steps_per_dispatch(tmp_path, caplog):
    """steps_per_dispatch > 1 under the service: one step a dispatch, with
    JAX's warning; the gate waits for a block in every shard."""
    import logging
    with caplog.at_level(logging.WARNING):
        learner = port_learner(tmp_path,
                               **{"runtime.steps_per_dispatch": 4})
    try:
        assert learner.steps_per_dispatch == 1
        assert "ignoring runtime.steps_per_dispatch=4" in caplog.text
        blocks = synthetic_blocks(learner.spec, 3, seed=5)
        for blk in blocks[:2]:
            learner.ingest(dataclasses.replace(blk, learning_steps=(
                blk.learning_steps * 5)))
        # 2 blocks round robin fill both shards
        assert learner.service.all_shards_nonempty and learner.ready
    finally:
        learner.stop_background(join_timeout=WAIT)
