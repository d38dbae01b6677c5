"""The port's tensor parallelism (r2d2_tpu_torch/parallel/tensor_parallel.py
and the dp x mp step of parallel/sharded.py) against the JAX package's
``parallel/tensor_parallel.py`` and ``_make_gspmd_learner_step``: the JAX
side on conftest's fake CPU devices (a dp=2 x mp=2 mesh), the port's
ranks as gloo processes (``run_ranks``) running ``tools/dp_check.py``.

The sharding rule gives JAX's sharded leaves and shard shapes under
models/convert.py; the host-batch TP step and the dp x mp device-replay
step hold JAX's over three steps; the mp replicas agree bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from r2d2_tpu.config import MeshConfig as JMeshConfig
from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.parallel import make_mesh as j_make_mesh
from r2d2_tpu.parallel import (make_sharded_learner_step as j_sharded_step,
                               make_sharded_replay_add as j_sharded_add,
                               sharded_replay_init as j_sharded_init)
from r2d2_tpu.parallel.tensor_parallel import (
    leaf_partition_spec as j_leaf_spec,
    make_tp_external_batch_step as j_tp_step,
    state_shardings as j_state_shardings)
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu.replay.structs import Block as JBlock
from r2d2_tpu_torch.config import MeshConfig, NetworkConfig
from r2d2_tpu_torch.models import convert
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.parallel.mesh import Mesh, make_mesh, run_ranks
from r2d2_tpu_torch.parallel.tensor_parallel import (TPNetwork,
                                                     leaf_partition_spec,
                                                     state_shardings)
from r2d2_tpu_torch.replay.structs import SampleBatch
from r2d2_tpu_torch.tools import dp_check
from tests.test_torch_replay import specs, synthetic_blocks
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

DP, MP = 2, 2
MSW = 8            # the tiny network's 4H = 64 and cnn 32 shard at mp 2
STEPS = 3
# rows cut short (an episode end), unequal over the dp halves
PARTIAL = {1: 2, 2: 3, 6: 1}


def _spec_entries(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("shape", [(), (5,), (7, 64), (3, 3, 4, 32),
                                   (3, 3, 4, 30), (16, 64), (16, 4),
                                   (1024, 2048), (2048,)])
@pytest.mark.parametrize("mp,msw", [(1, 32), (2, 32), (2, 8), (4, 8)])
def test_leaf_partition_spec_is_jax(shape, mp, msw):
    """The rule on one leaf's shape: JAX's PartitionSpec, entry for
    entry."""
    assert leaf_partition_spec(shape, mp, msw) == _spec_entries(
        j_leaf_spec(shape, mp, msw))


def _jax_shardings(jnet, optim, msw):
    """JAX's state_shardings over the params of a dp=1 x mp=2 mesh, by the
    port's names (convert's walk), as PartitionSpecs and shapes."""
    mesh = j_make_mesh(JMeshConfig(dp=1, mp=MP))
    ts = jax.eval_shape(lambda: j_create(jax.random.PRNGKey(0), jnet,
                                         optim))
    shard = j_state_shardings(ts, mesh, msw)
    specs_by_name = convert._walk(
        jax.tree_util.tree_map(lambda s: s.spec, shard.params),
        lambda x, kind: x)
    shapes = convert._walk(
        jax.tree_util.tree_map(lambda x: x.shape, ts.params),
        lambda x, kind: x)
    # Adam's moments follow their params in JAX's tree too
    mu = ts.opt_state[1][0].mu
    mu_specs = convert._walk(jax.tree_util.tree_map(
        lambda s: s.spec, shard.opt_state[1][0].mu), lambda x, kind: x)
    assert jax.tree_util.tree_structure(mu) == jax.tree_util.tree_structure(
        ts.params)
    assert mu_specs == specs_by_name
    return specs_by_name, shapes


@pytest.mark.parametrize("widths", ["tiny", "reference"])
def test_state_shardings_match_jax(widths):
    """At mp=2 the port shards exactly JAX's leaves, each along the port
    dim of the flax leaf's trailing axis, and a rank's shard has the flax
    shard's shape converted (tiny widths with min_shard_width=8, the
    reference widths with JAX's default 32: shapes only)."""
    if widths == "tiny":
        cfg, hw, stack, msw = dict(use_double=True, **TINY), (24, 24), 2, MSW
    else:
        cfg, hw, stack, msw = {}, (84, 84), 4, 32
    jnet = JNetworkApply(A, JNetworkConfig(**cfg), stack, *hw)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    jspecs, jshapes = _jax_shardings(jnet, optim, msw)
    net = NetworkApply(A, NetworkConfig(**cfg), stack, *hw, "cpu")
    dims = state_shardings(net, MP, msw)
    assert list(dims) == [n for n, _ in net.param_specs]
    assert set(dims) == set(jspecs)
    want = {n for n, s in jspecs.items() if s != P()}
    assert {n for n, d in dims.items() if d is not None} == want
    assert want, "no leaf sharded"
    if widths == "reference":   # the narrow first conv stays replicated
        assert "torso.convs.0.weight" not in want
        assert "torso.convs.1.weight" in want and "head.adv_out.weight" \
            not in want
    # a rank's shard: the flax shard's shape in the port's layout
    mesh = Mesh(dp=1, rank=1, device=torch.device("cpu"), backend="gloo",
                mp=MP)
    tp = TPNetwork(net, mesh, msw)
    for name, p in tp.named_parameters():
        shape = list(jshapes[name])
        if name in want:
            shape[-1] //= MP
        kind = convert.leaf_kind(name)
        port = {"conv": lambda s: (s[3], s[2], s[0], s[1]),
                "dense": lambda s: (s[1], s[0]),
                "plain": tuple}[kind](shape)
        assert tuple(p.shape) == tuple(port), name


def test_make_mesh_refuses_a_grid_larger_than_the_devices():
    """JAX's words: dp x mp needs dp*mp devices."""
    with pytest.raises(ValueError, match="mesh.dp=2 x mesh.mp=2 needs 4 "
                                         "devices but only 2"):
        make_mesh(MeshConfig(dp=2, mp=2), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        j_make_mesh(JMeshConfig(dp=2, mp=2), max_devices=2)


def _case(spec, init, **extra):
    return {"spec": dataclasses.asdict(spec), "action_dim": A,
            "network": {"use_double": True, **TINY}, "optim": OPTIM,
            "params": init, "min_shard_width": MSW, **extra}


def test_tp_external_step_matches_jax(tmp_path):
    """The host-batch TP step at dp=2 x mp=2 against JAX's
    ``make_tp_external_batch_step`` on a dp=2 x mp=2 mesh, from converted
    weights, over three host-sampled batches with some sequences cut
    short (the dp halves then hold unequal learning steps): per step the
    loss rtol 1e-5, params and target atol 1e-5, the whole batch's
    priorities on every rank rtol 2e-5 atol 1e-6
    (tests/test_torch_multihost.py's limits and their reason); the full
    params bit-equal on every rank; the largest sharded leaf holds half
    its features a rank."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(jspec, seed=11, use_native=False)
    for block in synthetic_blocks(spec, 10, seed=5):
        host.add(block)
    batches = []
    for _ in range(STEPS):
        batch = host.sample()[0]
        learning = np.array(batch.learning_steps)
        for row, n in PARTIAL.items():
            learning[row] = n
        batches.append(dataclasses.replace(batch, learning_steps=learning))
    jnet = JNetworkApply(A, JNetworkConfig(use_double=True, **TINY),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts0 = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = {n: v.numpy() for n, v in _flat(ts0.params).items()}
    step, place_state, place_batch = j_tp_step(
        jnet, jspec, optim, True, j_make_mesh(JMeshConfig(dp=DP, mp=MP)),
        min_shard_width=MSW)
    ts = place_state(ts0)
    want = []
    for batch in batches:
        ts, m = step(ts, place_batch(batch))
        want.append(dict(loss=float(m["loss"]),
                         priorities=np.asarray(m["priorities"]),
                         params=_flat(ts.params),
                         target=_flat(ts.target_params)))
    case = _case(spec, init, batches=[
        {f.name: np.array(getattr(b, f.name))
         for f in dataclasses.fields(SampleBatch)} for b in batches])
    out = run_ranks(dp_check.rank_tp_external, DP, case, mp=MP,
                    rendezvous_dir=str(tmp_path))
    for i, exp in enumerate(want):
        for rank in out:
            got = rank["trace"][i]
            np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["priorities"], exp["priorities"],
                                       rtol=2e-5, atol=1e-6)
            for name in ("params", "target"):
                for key, value in got[name].items():
                    np.testing.assert_allclose(
                        value, exp[name][key].numpy(), atol=1e-5,
                        err_msg=f"step {i} {name}.{key}")
                    assert np.array_equal(
                        value, out[0]["trace"][i][name][key])
    full = dict(NetworkApply(A, NetworkConfig(use_double=True, **TINY),
                             spec.frame_stack, spec.frame_height,
                             spec.frame_width, "cpu").param_specs)
    sharded = {n for n, s in out[0]["shapes"].items()
               if tuple(s) != tuple(full[n])}
    largest = max(sharded, key=lambda n: np.prod(full[n]))
    for rank in out:
        shape = rank["shapes"][largest]
        assert np.prod(shape) * MP == np.prod(full[largest])


def _jax_dpmp_run(mp: int):
    """JAX's sharded step on a dp=2 x mp mesh of fake CPU devices, its
    params feature-sharded by state_shardings at mp > 1: the shards, the
    initial weights, every shard's jitter (``fold_in(base, s)``) and, per
    step, the loss, the params, target and trees."""
    from r2d2_tpu.parallel.tensor_parallel import state_shardings as jss
    jspec, spec = specs(num_blocks=6, batch_size=8)
    mesh = j_make_mesh(JMeshConfig(dp=DP, mp=mp))
    blocks = synthetic_blocks(spec, 3 * DP, seed=7)
    state = j_sharded_init(jspec, mesh)
    add = j_sharded_add(jspec, mesh)
    for i, block in enumerate(blocks):
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
    if mp > 1:
        ts = jax.device_put(ts, jss(ts, mesh, min_shard_width=MSW))
    step = j_sharded_step(jnet, jspec, optim, True, mesh)
    jitter = np.zeros((DP, STEPS, 1, spec.batch_size), np.float32)
    trace = []
    for d in range(STEPS):
        _, base = jax.random.split(ts.key)
        for s in range(DP):
            jitter[s, d, 0] = np.asarray(jax.random.uniform(
                jax.random.fold_in(base, s), (spec.batch_size,),
                jnp.float32))
        ts, state, m = step(ts, state)
        trace.append(dict(loss=float(m["loss"]), params=_flat(ts.params),
                          target=_flat(ts.target_params),
                          tree=np.asarray(state.tree)))
    return spec, shards, init, jitter, trace


def test_dpmp_device_step_matches_jax(tmp_path):
    """The dp=2 x mp=2 device-replay step against JAX's
    ``make_sharded_learner_step`` on a dp=2 x mp=2 mesh (its GSPMD
    formulation), the same shards, weights and injected per-shard draws,
    three steps, with JAX's own bounds (tests/test_parallel.py: losses
    rtol 2e-5, params rtol 1e-4 atol 1e-6, trees rtol 1e-5); each dp
    row's mp replicas bit-equal (replay and full params), each rank
    holding shards of the wide leaves."""
    spec, shards, init, jitter, trace = _jax_dpmp_run(MP)
    case = _case(spec, init, shards=shards, jitter=jitter, k=1,
                 dispatches=STEPS)
    out = run_ranks(dp_check.rank_steps, DP, case, mp=MP,
                    rendezvous_dir=str(tmp_path))
    assert all(r["step"] == STEPS and not r["graphed"] for r in out)
    for rank, got in enumerate(out):
        d = rank // MP
        assert got["replay_digest"] == out[d * MP]["replay_digest"]
        for i, want in enumerate(trace):
            g = got["trace"][i]
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=2e-5)
            for name in ("params", "target"):
                for key, value in g[name].items():
                    np.testing.assert_allclose(
                        value, want[name][key].numpy(), rtol=1e-4,
                        atol=1e-6, err_msg=f"step {i} {name}.{key}")
                    assert np.array_equal(
                        value, out[0]["trace"][i][name][key])
            np.testing.assert_allclose(g["tree"], want["tree"][d],
                                       rtol=1e-5)
    assert out[0]["replay_digest"] != out[MP]["replay_digest"]
    assert out[0]["shapes"]["lstm.recurrent_kernel"] == (16, 32)


def test_tp_gradients_before_the_clip_equal_the_unsharded_steps(tmp_path):
    """ROADMAP C.5 on the CPU: the TP host-batch step at dp=1 x mp=2 (two
    gloo ranks), its f32 gradients taken before the clip and gathered
    over the row (``rank_tp_external``'s ``f32_grads``), against the
    unsharded external step's from the same weights on the same batch:
    each leaf within relative L2 1e-5, the loss at rtol 1e-5."""
    from r2d2_tpu_torch.config import OptimConfig
    from r2d2_tpu_torch.learner.train_step import make_external_batch_step
    from r2d2_tpu_torch.replay.host_replay import HostReplay
    from r2d2_tpu_torch.replay.structs import batch_fields
    import types
    _, spec = specs(num_blocks=10, batch_size=8)
    host = HostReplay(spec, seed=11)
    for block in synthetic_blocks(spec, 10, seed=5):
        host.add(block)
    fields = {n: np.array(a) for n, a in
              batch_fields(host.sample()[0]).items()}
    net = NetworkApply(A, NetworkConfig(use_double=True, **TINY),
                       spec.frame_stack, spec.frame_height,
                       spec.frame_width, "cpu")
    init = {n: p.detach().numpy() for n, p in net.init(3).state_dict()
            .items()}
    case = _case(spec, init, batches=[fields],
                 f32_grads={"use_double": True, **TINY})
    out = run_ranks(dp_check.rank_tp_external, 1, case, mp=2,
                    rendezvous_dir=str(tmp_path))
    got = out[0]["f32_grads"]
    rank = types.SimpleNamespace(device=torch.device("cpu"), dp_rank=0)
    _, net, optim, ts = dp_check._network(case, rank)
    step = make_external_batch_step(net, spec, OptimConfig(**OPTIM), True,
                                    graphed=False)
    taps: list = []
    with dp_check.pre_clip_gradients(taps):
        ts, m = step(ts, SampleBatch(**{n: torch.from_numpy(a)
                                        for n, a in fields.items()}))
    assert len(taps) == 1
    np.testing.assert_allclose(out[0]["f32_grad_loss"], float(m["loss"]),
                               rtol=1e-5)
    for (name, _), g in zip(ts.params.named_parameters(), taps[0]):
        want = g.double().numpy()
        rel = (np.linalg.norm(got[name] - want)
               / max(np.linalg.norm(want), 1e-30))
        assert rel <= 1e-5, (name, rel)
