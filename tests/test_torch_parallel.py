"""The port's data-parallel path (r2d2_tpu_torch/parallel/) against the JAX
package's ``parallel/sharded.py``: the JAX side on conftest's fake CPU
devices, the port's ranks as gloo processes (``run_ranks``, a ``file://``
rendezvous under ``tmp_path``) running ``tools/dp_check.py``'s checks.

The sharded step equals JAX's ``make_sharded_learner_step`` at dp 2 and 4
(K=3, two dispatches, JAX's per-shard jitter injected) with params
bit-equal across ranks; the sharded ingest equals per-block adds and
JAX's; the mesh, the config and checkpoints. The trainer's dp runs are
tests/test_torch_parallel_loop.py's."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import MeshConfig as JMeshConfig
from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.parallel import make_mesh as j_make_mesh
from r2d2_tpu.parallel import (make_sharded_learner_step as j_sharded_step,
                               make_sharded_replay_add as j_sharded_add,
                               make_sharded_replay_add_many as j_add_many,
                               sharded_replay_init as j_sharded_init)
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu_torch.config import Config, MeshConfig, parse_overrides
from r2d2_tpu_torch.learner.train_step import create_train_state
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.parallel.mesh import make_mesh, run_ranks
from r2d2_tpu_torch.replay.structs import stack_blocks
from r2d2_tpu_torch.runtime.checkpoint import (resume_training_state,
                                               save_checkpoint)
from r2d2_tpu_torch.runtime.data_parallel import data_parallel, resolved_dp
from r2d2_tpu_torch.tools import dp_check
from tests.test_torch_replay import specs, synthetic_blocks
from tests.test_torch_train import TINY_ARGS
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

K = 3             # steps a dispatch; target syncs at steps 2, 4, 6
DISPATCHES = 2
BLOCKS_PER_SHARD = 3


def _jax_sharded_run(dp: int):
    """JAX's sharded step on a dp-wide mesh of fake CPU devices, replay
    filled round-robin: per dispatch, every shard's (K, B) jitter (shard s
    draws ``uniform(fold_in(base, s), (B,))`` from the step's key chain),
    the losses, grad norms, params, target and every shard's tree."""
    jspec, spec = specs(num_blocks=6, batch_size=8)
    mesh = j_make_mesh(JMeshConfig(dp=dp))
    blocks = synthetic_blocks(spec, BLOCKS_PER_SHARD * dp, seed=7)
    state = j_sharded_init(jspec, mesh)
    add = j_sharded_add(jspec, mesh)
    for i, block in enumerate(blocks):
        state = add(state, JBlock(**dataclasses.asdict(block)), i % dp)
    shards = [jax.tree_util.tree_map(lambda x: np.asarray(x)[s],
                                     dataclasses.asdict(state))
              for s in range(dp)]
    for shard in shards:
        shard["block_ptr"] = int(shard["block_ptr"])
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init_params = {n: v.numpy() for n, v in _flat(ts.params).items()}
    step = j_sharded_step(jnet, jspec, optim, True, mesh,
                          steps_per_dispatch=K)
    jitter = np.zeros((dp, DISPATCHES, K, spec.batch_size), np.float32)
    trace = []
    for d in range(DISPATCHES):
        key = ts.key
        for k in range(K):
            key, base = jax.random.split(key)
            for s in range(dp):
                jitter[s, d, k] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(base, s), (spec.batch_size,),
                    jnp.float32))
        ts, state, m = step(ts, state)
        trace.append(dict(loss=np.asarray(m["loss"]),
                          grad_norm=np.asarray(m["grad_norm"]),
                          params=_flat(ts.params),
                          target=_flat(ts.target_params),
                          tree=np.asarray(state.tree)))
    return spec, shards, init_params, jitter, trace


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_step_matches_jax(dp, tmp_path):
    """dp gloo ranks from JAX's replay shards, weights and per-shard jitter:
    per dispatch the losses (mean over shards) rtol 1e-5, grad norms rtol
    1e-4, params and target atol 1e-5, every shard's tree rtol 1e-5 after
    the first dispatch and 1e-4 after the second (tests/
    test_torch_multi_step.py's rule); the ranks' params, target and
    optimizer state bit-equal (the digest)."""
    spec, shards, init_params, jitter, trace = _jax_sharded_run(dp)
    case = {"spec": dataclasses.asdict(spec), "action_dim": A,
            "network": {"use_double": True, **TINY}, "optim": OPTIM,
            "params": init_params, "shards": shards, "jitter": jitter,
            "k": K, "dispatches": DISPATCHES}
    out = run_ranks(dp_check.rank_steps, dp, case,
                    rendezvous_dir=str(tmp_path))
    assert len({r["digest"] for r in out}) == 1
    assert all(r["step"] == K * DISPATCHES and not r["graphed"] for r in out)
    assert out[0]["buffer_steps"] == (BLOCKS_PER_SHARD * dp
                                      * spec.seqs_per_block * spec.learning)
    for s, rank in enumerate(out):
        for d, want in enumerate(trace):
            got = rank["trace"][d]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
            for name in ("params", "target"):
                for key, value in got[name].items():
                    np.testing.assert_allclose(
                        value, want[name][key].numpy(), atol=1e-5,
                        err_msg=f"{name}.{key}")
            np.testing.assert_allclose(got["tree"], want["tree"][s],
                                       rtol=1e-5 if d == 0 else 1e-4,
                                       atol=1e-7)
    for d in range(DISPATCHES):
        for name in ("params", "target"):
            for key, value in out[0]["trace"][d][name].items():
                for other in out[1:]:
                    assert np.array_equal(value, other["trace"][d][name][key])


def test_sharded_add_many_equals_per_block_adds(tmp_path):
    """Five blocks over three shards from every start shard: one
    add_many equals five per-block adds on every rank, every field
    exactly (the ring pointers too), and JAX's make_sharded_replay_add_many
    (the tree at rtol 1e-6: f32 pow may round one ulp apart)."""
    dp = 3
    jspec, spec = specs(num_blocks=4)
    blocks = synthetic_blocks(spec, 5, seed=3)
    mesh = j_make_mesh(JMeshConfig(dp=dp))
    add_many = j_add_many(jspec, mesh)
    jblocks = JBlock(**dataclasses.asdict(stack_blocks(blocks)))
    out = run_ranks(dp_check.rank_adds, dp,
                    {"spec": dataclasses.asdict(spec), "blocks": blocks,
                     "starts": list(range(dp))}, rendezvous_dir=str(tmp_path))
    for start in range(dp):
        want = add_many(j_sharded_init(jspec, mesh), jblocks, start)
        for s, rank in enumerate(r[start] for r in out):
            for name, value in rank["batch"].items():
                np.testing.assert_array_equal(value, rank["single"][name],
                                              err_msg=name)
                expect = np.asarray(getattr(want, name))[s]
                if name == "tree":
                    np.testing.assert_allclose(value, expect, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(value, expect,
                                                  err_msg=name)
            owned = sum(1 for i in range(5) if (start + i) % dp == s)
            assert int(rank["batch"]["block_ptr"]) == owned


def test_make_mesh_refuses_more_ranks_than_devices():
    """As JAX's make_mesh: dp beyond the devices raises, before any
    process group is joined; NCCL refuses two ranks on one GPU."""
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh(MeshConfig(dp=3), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(MeshConfig(dp=2), devices=[])
    with pytest.raises(ValueError, match="NCCL needs one GPU"):
        make_mesh(MeshConfig(dp=2), devices=["cuda:0", "cuda:0"],
                  backend="nccl")


def test_mesh_config_roundtrip_and_refusals():
    """--mesh.dp parses and round-trips with JAX's meaning of -1; mp > 1
    and snapshots under dp > 1 are settings (tensor parallelism and the
    sharded snapshots are ported); the multi-host fields parse and what
    they leave out is refused naming its item, mp > 1 there naming
    ROADMAP A.4; host placement at mp 1 and dp 1 / -1 on one device take
    the unsharded path, host placement at mp 2 a dp x mp mesh."""
    cfg = parse_overrides(Config(), ["--mesh.dp=2"])
    assert cfg.mesh == MeshConfig(dp=2, mp=1)
    assert Config.from_dict(json.loads(cfg.to_json())).mesh.dp == 2
    assert MeshConfig(dp=-1).resolved_dp(8) == 8
    assert MeshConfig(dp=-1).resolved_dp(1) == 1
    assert JMeshConfig(dp=-1).resolved_dp(8) == 8
    assert parse_overrides(Config(), ["--mesh.mp=2"]).mesh == MeshConfig(
        dp=1, mp=2)
    assert MeshConfig(dp=-1, mp=2).resolved_dp(8) == 4
    assert parse_overrides(Config(), [
        "--mesh.dp=2", "--runtime.snapshot_interval=10"
    ]).runtime.snapshot_interval == 10
    # the multi-host fields parse (parallel/multihost.py); what it leaves
    # out is refused naming its item
    mh = ["--mesh.multihost=true", "--mesh.coordinator_address=x:1",
          "--mesh.num_processes=2", "--mesh.process_id=1", "--mesh.dp=2"]
    parsed = parse_overrides(Config(), mh)
    assert parsed.mesh == MeshConfig(dp=2, multihost=True,
                                     coordinator_address="x:1",
                                     num_processes=2, process_id=1)
    for extra, match in ((["--mesh.mp=2"], "multihost.*A.4"),
                         (["--actor.inference=server"], "A.6")):
        with pytest.raises(ValueError, match=match):
            parse_overrides(Config(), mh + extra)
    cpu = torch.device("cpu")
    host = cfg.replace(**{"replay.placement": "host"})
    assert resolved_dp(host, [cpu, cpu]) == 1
    assert resolved_dp(host.replace(**{"mesh.mp": 2}), [cpu] * 4) == 2
    for dp in (1, -1):
        one = Config().replace(**{"mesh.dp": dp})
        with data_parallel(one, cpu) as mesh:
            assert mesh is None
    with pytest.raises(ValueError, match="resolved mesh.dp"):
        resolved_dp(Config().replace(**{
            "mesh.dp": -1, "actor.on_device": True,
            "actor.anakin_lanes": 9, "replay.block_length": 120,
            "replay.capacity": 120_000}), [cpu] * 2)


def test_learner_needs_its_mesh_for_dp():
    """A dp > 1 Learner without its rank's Mesh raises, naming how ranks
    start."""
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    cfg = parse_overrides(Config(), TINY_ARGS + ["--mesh.dp=2"])
    net = NetworkApply(6, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        Learner(cfg, net)


def test_checkpoint_keeps_every_ranks_generator(tmp_path):
    """Rank 0 writes the replicated state with every rank's sampling
    generator; on resume each rank takes its own, and a rank the
    checkpoint has none for keeps its own."""
    cfg = parse_overrides(Config(), TINY_ARGS)
    net = NetworkApply(6, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, "cpu")
    ts = create_train_state(net, cfg.optim, 0, False)
    states = [torch.Generator().manual_seed(100 + r).get_state()
              for r in range(2)]
    path = save_checkpoint(str(tmp_path), "Fake", 1, 0, ts, 5,
                           generators=states)
    for rank in (0, 1):
        other = create_train_state(net, cfg.optim, 9, False)
        assert resume_training_state(path, other, rank) == 5
        assert torch.equal(other.generator.get_state(), states[rank])
    mine = create_train_state(net, cfg.optim, 9, False)
    before = mine.generator.get_state()
    resume_training_state(path, mine, 2)
    assert torch.equal(mine.generator.get_state(), before)
