"""The port's multi-host lockstep path (r2d2_tpu_torch/parallel/multihost.py)
against the JAX package's ``parallel/multihost.py``: the JAX side in one
process over conftest's fake CPU devices, the port's controllers as two
gloo CPU ranks (``run_ranks``, a ``file://`` rendezvous under
``tmp_path``) running ``tools/mh_check.py``'s checks.

The lockstep ingest equals JAX's ``make_lockstep_ingest`` over a script
of iterations (every shard field, ``cum_env`` and ``info``); the consensus
equals JAX's in a world of one and sums two ranks' values; the scripted
lockstep core (ingest, gate, K=2 dispatch, the limiter, stop) follows
JAX's loop order with JAX's per-shard jitter injected; the sharded
external-batch step equals JAX's external step on the concatenated batch;
the actor fleet's supervision, the mesh and the config. The trainer's
runs are tests/test_torch_multihost_loop.py's."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from r2d2_tpu.config import MeshConfig as JMeshConfig
from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import (
    make_external_batch_step as j_external_step)
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.parallel import make_mesh as j_make_mesh
from r2d2_tpu.parallel import (make_sharded_learner_step as j_sharded_step,
                               sharded_replay_init as j_sharded_init)
from r2d2_tpu.parallel.multihost import (
    make_lockstep_consensus as j_consensus,
    make_lockstep_ingest as j_ingest)
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu.replay.structs import empty_block_np as j_empty_block
from r2d2_tpu_torch.config import Config, MeshConfig, parse_overrides
from r2d2_tpu_torch.parallel.mesh import (close_mesh, init_distributed,
                                          make_mesh, rendezvous, run_ranks)
from r2d2_tpu_torch.parallel.multihost import (HostFeed, LocalActorFleet,
                                               make_lockstep_consensus,
                                               owned_dp_rows)
from r2d2_tpu_torch.replay.structs import SampleBatch
from r2d2_tpu_torch.tools import mh_check
from tests.test_torch_replay import specs, synthetic_blocks
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

DP = 2
K = 2                 # steps a dispatch of the scripted core
LEARNING_STARTS = 60  # three 20-step blocks
RATIO = 10.0          # the limiter pauses once 20 env steps a step ahead


def _stamped(spec, count, seed):
    """Synthetic blocks with distinct weight versions and lanes."""
    blocks = synthetic_blocks(spec, count, seed=seed)
    return [dataclasses.replace(b, weight_version=np.int32(10 + i),
                                lane=np.int32(i))
            for i, b in enumerate(blocks)]


def _jax_rows(jspec, mesh, blocks):
    """JAX's ingest operands from one block (or None) a dp row."""
    sharding = NamedSharding(mesh, P("dp"))
    stacked = {}
    for name, zero in j_empty_block(jspec).items():
        rows = np.broadcast_to(zero[None], (len(blocks),) + zero.shape).copy()
        for r, b in enumerate(blocks):
            if b is not None:
                rows[r] = np.asarray(getattr(b, name))
        stacked[name] = jax.device_put(rows, sharding)
    valid = np.array([b is not None for b in blocks], np.int32)
    return JBlock(**stacked), jax.device_put(valid, sharding)


def _script(spec, pattern, stop_at, stop_rank, seed):
    """Arrivals (a list of blocks a rank an iteration) and stop flags from
    ``pattern``: per iteration the ranks a block arrives at."""
    blocks = iter(_stamped(spec, sum(len(p) for p in pattern), seed))
    arrivals = [[[next(blocks)] if r in ranks else [] for r in range(DP)]
                for ranks in pattern]
    stops = [[int(it == stop_at and r == stop_rank) for r in range(DP)]
             for it in range(len(pattern))]
    return arrivals, stops


# blocks on one rank, on both, on neither; then a stop on rank 1
INGEST_PATTERN = [(0,), (1,), (0, 1), (), (0, 1), (0,), (), (1,), (0, 1),
                  (0,)]


def test_lockstep_ingest_matches_jax(tmp_path):
    """Ten iterations at dp=2 over a 4-block ring (rank 0's wraps): every
    iteration's ``info`` and each rank's ``cum_env`` exactly JAX's; each
    rank's shard at the end equals JAX's slice, every field exactly and
    the tree at rtol 1e-6 (f32 pow may round one ulp apart, the rule of
    tests/test_torch_parallel.py's adds)."""
    jspec, spec = specs(num_blocks=4)
    arrivals, stops = _script(spec, INGEST_PATTERN, 9, 1, seed=4)
    mesh = j_make_mesh(JMeshConfig(dp=DP))
    sharding = NamedSharding(mesh, P("dp"))
    ingest = j_ingest(jspec, mesh)
    state = j_sharded_init(jspec, mesh)
    cum = jax.device_put(np.zeros((DP,), np.int32), sharding)
    want = []
    for it in range(len(arrivals)):
        blocks = [a[0] if a else None for a in arrivals[it]]
        rows, valid = _jax_rows(jspec, mesh, blocks)
        stop = jax.device_put(np.array(stops[it], np.int32), sharding)
        state, cum, info = ingest(state, cum, rows, valid, stop)
        want.append({"info": {k: int(v) for k, v in
                              jax.device_get(info).items()},
                     "cum_env": np.asarray(cum).tolist()})
    assert want[-1]["info"]["stop"] == 1
    out = run_ranks(mh_check.rank_ingest, DP,
                    {"spec": dataclasses.asdict(spec), "arrivals": arrivals,
                     "stops": stops}, rendezvous_dir=str(tmp_path))
    for r, rank in enumerate(out):
        for it, (got, exp) in enumerate(zip(rank["trace"], want)):
            assert got["info"] == exp["info"], f"rank {r} iteration {it}"
            assert got["cum_env"] == exp["cum_env"][r]
        for name, value in rank["state"].items():
            expect = np.asarray(getattr(state, name))[r]
            if name == "tree":
                np.testing.assert_allclose(value, expect, rtol=1e-6)
            else:
                np.testing.assert_array_equal(value, expect, err_msg=name)
        assert rank["ring_steps"] == int(np.asarray(
            state.learning_steps)[r].sum())


def test_lockstep_consensus_world_of_one_and_two(tmp_path):
    """A world of one: the same dict as JAX's single-process ``consense``
    on the same values. Two ranks: the sums of both ranks' values under the
    same keys."""
    values = (140, 260, True, 0)
    want = j_consensus(j_make_mesh(JMeshConfig(dp=1)))(*values)
    mesh = make_mesh(MeshConfig(dp=1), ["cpu"], "gloo",
                     init_method=rendezvous(str(tmp_path)))
    try:
        assert owned_dp_rows(mesh) == [0]
        got = make_lockstep_consensus(mesh)(*values)
    finally:
        close_mesh()
    assert got == want
    assert sorted(got) == ["buffer_steps", "env_steps", "ready_procs",
                           "stop"]
    per_rank = [(40, 100, True, 0), (0, 60, False, 1)]
    out = run_ranks(mh_check.rank_consensus, DP, {"values": per_rank},
                    rendezvous_dir=str(tmp_path))
    assert out[0] == out[1] == {"buffer_steps": 40, "env_steps": 160,
                                "ready_procs": 1, "stop": 1}


def test_host_feed_round_robin_over_one_row():
    """A controller owns one dp row, its rank's: the feed's operands are
    the drained block itself (None: a no-op iteration) and the stop
    flag."""
    from r2d2_tpu_torch.parallel.mesh import Mesh
    _, spec = specs()
    mesh = Mesh(dp=2, rank=1, device=torch.device("cpu"), backend="gloo")
    feed = HostFeed(spec, mesh)
    assert feed.local_rows == [1]
    assert feed.build(None, 0) == (None, 0)
    block = synthetic_blocks(spec, 1)[0]
    got, stop = feed.build(block, True)
    assert got is block and stop == 1


# the core's script: fill one shard, then the other, train (the limiter
# pausing the drain for two dispatches), then a stop on rank 1 after three
# dispatches: six steps, tests/test_torch_parallel.py's horizon
CORE_PATTERN = [(0,), (), (1,), (0, 1), (0, 1), (0, 1), (0, 1)]
CORE_STOP = 6


def _jax_core_run(spec, jspec, arrivals, stops):
    """JAX's loop order (multihost.py:1140-1221) over the script: ingest,
    the stop, the gate, the limiter and the sharded K-step dispatch, with
    every shard's jitter drawn as the step draws it."""
    mesh = j_make_mesh(JMeshConfig(dp=DP))
    sharding = NamedSharding(mesh, P("dp"))
    ingest = j_ingest(jspec, mesh)
    rs = j_sharded_init(jspec, mesh)
    cum = jax.device_put(np.zeros((DP,), np.int32), sharding)
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init_params = {n: v.numpy() for n, v in _flat(ts.params).items()}
    step = j_sharded_step(jnet, jspec, optim, True, mesh,
                          steps_per_dispatch=K)
    queues = [[] for _ in range(DP)]
    paused, step_count, stopped_at = False, 0, None
    jitter = [[] for _ in range(DP)]
    trace, dispatches = [], []
    for it in range(len(arrivals)):
        blocks = []
        for r in range(DP):
            queues[r] += arrivals[it][r]
            blocks.append(queues[r].pop(0) if not paused and queues[r]
                          else None)
        rows, valid = _jax_rows(jspec, mesh, blocks)
        stop = jax.device_put(np.array(stops[it], np.int32), sharding)
        rs, cum, info = ingest(rs, cum, rows, valid, stop)
        info = {k: int(v) for k, v in jax.device_get(info).items()}
        if info["stop"] > 0:
            trace.append({"info": info, "stepped": False, "paused": paused})
            stopped_at = it
            break
        ready = (info["filled_shards"] == DP
                 and info["buffer_steps"] >= LEARNING_STARTS)
        paused = bool(ready and info["env_steps"] >= LEARNING_STARTS
                      + RATIO * max(step_count, 1))
        if ready:
            key = ts.key
            draws = np.zeros((DP, K, spec.batch_size), np.float32)
            for k in range(K):
                key, base = jax.random.split(key)
                for s in range(DP):
                    draws[s, k] = np.asarray(jax.random.uniform(
                        jax.random.fold_in(base, s), (spec.batch_size,),
                        jnp.float32))
            for s in range(DP):
                jitter[s].append(draws[s])
            ts, rs, m = step(ts, rs)
            step_count += K
            dispatches.append(dict(loss=np.asarray(m["loss"]),
                                   params=_flat(ts.params),
                                   target=_flat(ts.target_params),
                                   tree=np.asarray(rs.tree)))
        trace.append({"info": info, "stepped": ready, "paused": paused})
    return init_params, jitter, trace, dispatches, stopped_at, step_count


def test_scripted_lockstep_core_matches_jax(tmp_path):
    """The lockstep core on two gloo ranks over a 7-iteration script, JAX's
    per-shard jitter injected: every iteration's info, gate, limiter and
    dispatch as JAX's loop takes them; per dispatch the losses rtol 1e-5,
    params and target atol 1e-5, each shard's tree rtol 1e-5 after the
    first dispatch and 1e-4 later (tests/test_torch_multi_step.py's rule);
    both ranks bit-equal and stopped on the same iteration."""
    jspec, spec = specs(num_blocks=6, batch_size=8)
    arrivals, stops = _script(spec, CORE_PATTERN, CORE_STOP, 1, seed=9)
    init_params, jitter, want, dispatches, stopped_at, steps = \
        _jax_core_run(spec, jspec, arrivals, stops)
    assert stopped_at == CORE_STOP and len(dispatches) == 3
    assert any(t["paused"] for t in want), "the script never pauses"
    case = {"spec": dataclasses.asdict(spec), "action_dim": A,
            "network": {"use_double": True, **TINY}, "optim": OPTIM,
            "params": init_params, "k": K, "arrivals": arrivals,
            "stops": stops, "jitter": [np.stack(j) for j in jitter],
            "learning_starts": LEARNING_STARTS, "ratio": RATIO}
    out = run_ranks(mh_check.rank_core, DP, case,
                    rendezvous_dir=str(tmp_path))
    assert out[0]["digest"] == out[1]["digest"]
    for r, rank in enumerate(out):
        assert rank["stopped_at"] == stopped_at and rank["step"] == steps
        assert not rank["graphed"]
        assert [(t["info"], t["stepped"], t["paused"])
                for t in rank["trace"]] == [
            (t["info"], t["stepped"], t["paused"]) for t in want]
        assert len(rank["dispatches"]) == len(dispatches)
        for d, (got, exp) in enumerate(zip(rank["dispatches"], dispatches)):
            np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
            for name in ("params", "target"):
                for key, value in got[name].items():
                    np.testing.assert_allclose(
                        value, exp[name][key].numpy(), atol=1e-5,
                        err_msg=f"dispatch {d} {name}.{key}")
            np.testing.assert_allclose(got["tree"], exp["tree"][r],
                                       rtol=1e-5 if d == 0 else 1e-4,
                                       atol=1e-7)
    for d in range(len(dispatches)):
        for name in ("params", "target"):
            for key, value in out[0]["dispatches"][d][name].items():
                assert np.array_equal(value,
                                      out[1]["dispatches"][d][name][key])


EXTERNAL_STEPS = 3
# rows whose sequences end early (an episode end), more on rank 0's half:
# the global mean then weights the halves unequally
PARTIAL = {1: 2, 2: 3, 6: 1}


def test_sharded_external_step_matches_jax(tmp_path):
    """Host placement's step at dp=2, each rank on its half of every batch,
    against JAX's ``make_external_batch_step`` on the whole batch, some
    sequences cut short so the halves hold unequal learning steps: per
    step the loss rtol 1e-5, params and target atol 1e-5, the priorities
    of both halves rtol 2e-5 (tests/test_torch_external_step.py's limit
    and its reason) with atol 1e-6: a sequence cut to one learning step
    has the priority |target - Q| of that one step, Q near 1 and the
    difference near 0.01, where the ulps of Q (1.2e-7) that the halves'
    smaller matmuls round differently are 4e-5 of the priority; the ranks
    bit-equal."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(jspec, seed=11, use_native=False)
    for block in synthetic_blocks(spec, 10, seed=5):
        host.add(block)
    batches = []
    for _ in range(EXTERNAL_STEPS):
        batch = host.sample()[0]
        learning = np.array(batch.learning_steps)
        for row, n in PARTIAL.items():
            learning[row] = n
        batches.append(dataclasses.replace(batch, learning_steps=learning))
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = {n: v.numpy() for n, v in _flat(ts.params).items()}
    step = j_external_step(jnet, jspec, optim, True)
    want = []
    for batch in batches:
        ts, m = step(ts, batch)
        want.append(dict(loss=float(m["loss"]),
                         priorities=np.asarray(m["priorities"]),
                         params=_flat(ts.params),
                         target=_flat(ts.target_params)))
    case = {"spec": dataclasses.asdict(spec), "action_dim": A,
            "network": {"use_double": True, **TINY}, "optim": OPTIM,
            "params": init,
            "batches": [{f.name: np.array(getattr(b, f.name))
                         for f in dataclasses.fields(SampleBatch)}
                        for b in batches]}
    out = run_ranks(mh_check.rank_external, DP, case,
                    rendezvous_dir=str(tmp_path))
    assert out[0]["digest"] == out[1]["digest"]
    for i, exp in enumerate(want):
        got = [rank["trace"][i] for rank in out]
        for g in got:
            np.testing.assert_allclose(g["loss"], exp["loss"], rtol=1e-5)
            for name in ("params", "target"):
                for key, value in g[name].items():
                    np.testing.assert_allclose(
                        value, exp[name][key].numpy(), atol=1e-5,
                        err_msg=f"step {i} {name}.{key}")
        np.testing.assert_allclose(
            np.concatenate([g["priorities"] for g in got]),
            exp["priorities"], rtol=2e-5, atol=1e-6)


def test_local_actor_fleet_supervision():
    """The controller's supervision (LocalActorFleet, the orchestrator's
    pool), as JAX's test: restarts dead threads, never lets a failing
    spawn escape into the lockstep loop, and honors the off-switch and
    the stop event. Actor i of controller r is the fleet's global actor
    r * n_local + i."""

    def make_spawn(fail_on=()):
        def spawn(i):
            if i in fail_on:
                raise RuntimeError("env creation failed")
            t = threading.Thread(target=lambda: None)
            t.start()
            return t
        return spawn

    def fleet_of(n, restart):
        cfg = Config().replace(**{
            "actor.num_actors": n, "runtime.restart_dead_actors": restart,
            "runtime.restart_backoff_base_s": 0.0})
        fleet = LocalActorFleet(cfg, None, actor_base=n, total_actors=2 * n)
        stop = threading.Event()
        fleet.open_threads(stop, torch.nn.Linear(2, 2))
        fleet._spawn_thread_actor = make_spawn()
        fleet.spawn_actors()
        return fleet, stop

    fleet, stop = fleet_of(3, True)
    assert (fleet.actor_base, fleet.total_actors) == (3, 6)
    for t in fleet.threads:
        t.join()
    assert fleet.supervise() == 3           # all finished -> all restarted

    # a failing respawn is swallowed (logged), the others still restart
    fleet._spawn_thread_actor = make_spawn(fail_on={1})
    for t in fleet.threads:
        t.join()
    assert fleet.supervise() == 2

    # stop set -> no restarts; off-switch -> no restarts
    stop.set()
    assert fleet.supervise() == 0
    fleet2, stop2 = fleet_of(1, False)
    fleet2.threads[0].join()
    assert fleet2.supervise() == 0
    stop2.set()
    fleet.close()
    fleet2.close()


def test_multihost_config_fields_and_refusals():
    """The four mesh fields parse with JAX's defaults and round-trip; dp is
    the controller count; the combinations left out are refused, each
    naming its item (mesh.mp > 1 across controllers ROADMAP A.4), and the
    fleet, telemetry and multiplayer knobs stay unknown fields."""
    from r2d2_tpu.config import MeshConfig as J
    assert (MeshConfig().multihost, MeshConfig().coordinator_address,
            MeshConfig().num_processes, MeshConfig().process_id) == (
        J().multihost, J().coordinator_address, J().num_processes,
        J().process_id)
    args = ["--mesh.multihost=true", "--mesh.coordinator_address=h:1234",
            "--mesh.num_processes=4", "--mesh.process_id=3", "--mesh.dp=4"]
    cfg = parse_overrides(Config(), args)
    assert (cfg.mesh.multihost, cfg.mesh.coordinator_address,
            cfg.mesh.num_processes, cfg.mesh.process_id) == (
        True, "h:1234", 4, 3)
    assert Config.from_json(cfg.to_json()).mesh == cfg.mesh
    assert parse_overrides(Config(), args[:-1] + ["--mesh.dp=-1"])
    # snapshots are the loop's own rule under multihost (a warning)
    assert parse_overrides(Config(), args + [
        "--runtime.snapshot_interval=10"]).runtime.snapshot_interval == 10
    for extra, match in (
            (["--mesh.dp=2"], "num_processes"),
            (["--mesh.process_id=4"], "process_id"),
            (["--mesh.mp=2"], "mp=2 with mesh.multihost.*A.4"),
            (["--actor.on_device=true", "--replay.block_length=120",
              "--replay.capacity=120000"], "on_device.*multihost"),
            (["--actor.inference=server"], "server.*A.6")):
        with pytest.raises(ValueError, match=match):
            parse_overrides(Config(), args + extra)
    for arg in ("--fleet.fanout_degree=2",
                "--telemetry.fleet_enabled=true",
                "--multiplayer.player_id=0"):
        with pytest.raises(SystemExit, match="unknown"):
            parse_overrides(Config(), args + [arg])
    # the replay service is refused under multihost in JAX's words (its
    # 1x1-mesh check comes before the single-controller one)
    with pytest.raises(ValueError, match="1x1 mesh only"):
        parse_overrides(Config(), args + ["--fleet.replay_shards=2",
                                          "--replay.capacity=100000"])


def test_init_distributed_refusals():
    """A controller given a card it does not have raises; a job of several
    needs its coordinator; a non-multihost mesh is not a controller's."""
    with pytest.raises(ValueError, match="multihost"):
        init_distributed(MeshConfig(), "cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(MeshConfig(multihost=True, num_processes=2, dp=2),
                         "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="finds no CUDA device"):
            init_distributed(MeshConfig(multihost=True), "cuda:0")
    assert not torch.distributed.is_initialized()


def test_nan_halt_stops_both_controllers_through_the_consensus(tmp_path):
    """Two loopback controllers on the CPU with
    ``--telemetry.nan_policy=halt`` and a learning rate so large (1e30)
    that the second step's loss is not finite: rank 0's flush writes one
    forensics dump and sets the stop flag, both controllers leave the
    loop on the same iteration (controller 1 through the stop consensus,
    exit 0 with its summary; the checkpoint of that step, which both
    join, is written) and controller 0 then raises (a nonzero exit, no
    summary)."""
    import json
    import os
    import time

    from r2d2_tpu_torch.parallel.multihost import (ControllerProcesses,
                                                   demo_argv, digest_path)
    save_dir = str(tmp_path / "mh_halt")
    argv_of = demo_argv(2, save_dir, max_steps=100_000, max_seconds=120.0,
                        device="cpu", collective_timeout=60.0,
                        overrides=["--telemetry.nan_policy=halt",
                                   "--optim.lr=1e30",
                                   "--runtime.log_interval=0.5"])
    with ControllerProcesses(argv_of, 2) as ctl:
        rcs = ctl.wait(time.monotonic() + 150.0)
    assert rcs[0] not in (None, 0) and rcs[1] == 0
    dump = json.loads(open(os.path.join(save_dir,
                                        "nan_dump_player0.json")).read())
    assert dump["nan_policy"] == "halt"
    assert dump["learning"]["nonfinite_steps"] > 0
    assert not os.path.exists(digest_path(save_dir, 0))
    with open(digest_path(save_dir, 1)) as f:
        follower = json.load(f)
    assert follower["stop_reason"] == ""
    assert follower["step"] < 100_000
    step = follower["step"]          # the demo saves every 4 steps
    final = os.path.join(save_dir,
                         f"Fake{step // 4 + (1 if step % 4 else 0)}_player0")
    assert os.path.exists(final)
