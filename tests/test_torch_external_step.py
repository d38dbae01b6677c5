"""The port's external-batch step (host placement) against the JAX
package's ``make_external_batch_step`` on the same host-sampled batches and
converted weights (f32; ``network.pallas_lstm`` off, and on with the JAX
fused LSTM kernels in interpret mode), against the port's own fused step
on a batch that ``replay_sample`` drew, and the CUDA graph wrapper's batch
input."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import (
    make_external_batch_step as j_external_step)
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.replay.host_replay import HostReplay as JHostReplay
from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import (GraphedSteps, TrainState,
                                               _state_tensors,
                                               make_external_batch_step,
                                               make_learner_step,
                                               make_optimizer)
from r2d2_tpu_torch.models.convert import replay_state_from_jax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.ops.sum_tree import tree_update
from r2d2_tpu_torch.replay.device_replay import replay_sample
from r2d2_tpu_torch.replay.structs import SampleBatch
from tests.test_torch_replay import (jax_filled, specs, synthetic_blocks,
                                     to_numpy_state)
from tests.test_torch_train_step import A, OPTIM, TINY, _flat

pytestmark = pytest.mark.torch_port

STEPS = 3         # OPTIM syncs the target every 2 steps: at step 2


def torch_batch(batch) -> SampleBatch:
    """A host batch (numpy leaves) as CPU tensors."""
    return SampleBatch(**{f.name: torch.from_numpy(np.array(
        getattr(batch, f.name))) for f in dataclasses.fields(SampleBatch)})


def _port_state(net, params, use_double, optim):
    online = net.build()
    online.load_state_dict(params)
    target = online
    if use_double:
        target = net.build()
        target.load_state_dict(params)
    return TrainState(params=online, target_params=target,
                      opt=make_optimizer(optim, online), step=0,
                      generator=torch.Generator())


def _jax_external_run(use_double, pallas_lstm):
    """STEPS JAX external steps on host batches: the batches, the initial
    params, and per step the loss, priorities, params and target."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(jspec, seed=11, use_native=False)
    for block in synthetic_blocks(spec, 10, seed=5):
        host.add(block)
    batches = [host.sample()[0] for _ in range(STEPS)]
    jnet = JNetworkApply(A, JNetworkConfig(
        use_double=use_double, pallas_lstm=pallas_lstm,
        pallas_lstm_interpret=pallas_lstm == "on", **TINY),
        spec.frame_stack, spec.frame_height, spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init = _flat(ts.params)
    step = j_external_step(jnet, jspec, optim, use_double)
    trace = []
    for batch in batches:
        ts, m = step(ts, batch)
        trace.append(dict(loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          priorities=np.asarray(m["priorities"]),
                          params=_flat(ts.params),
                          target=_flat(ts.target_params)))
    return spec, batches, init, trace


CASES = [(d, p) for p in ("off", "on") for d in (False, True)]


@pytest.fixture(scope="module")
def jax_external_runs():
    return {case: _jax_external_run(*case) for case in CASES}


@pytest.mark.parametrize("use_double,pallas_lstm", CASES,
                         ids=[f"{'double' if d else 'single'}-lstm_{p}"
                              for d, p in CASES])
def test_external_step_matches_jax(jax_external_runs, use_double,
                                   pallas_lstm):
    """Per step: loss rtol 1e-5, priorities rtol 2e-5, grad norm rtol 1e-4,
    params after Adam atol 1e-5; with double DQN the target atol 1e-5 and
    its sync schedule: the initial weights after step 1, the online
    weights after step 2.

    Priorities at 2e-5, not 1e-5: with the same weights and batch the Q
    values agree to 1.8e-7, but XLA compiles the inverse value rescale
    h^-1 with other f32 roundings (it folds 1 + eps, multiplies by
    1/(2 eps)), and the cancellation in sqrt(1 + 4 eps (|x| + 1 + eps)) - 1
    grows a one-ulp difference about fifty-fold: the double-DQN step 3
    differs by 1.14e-5 relative (ROADMAP.md section C)."""
    spec, batches, init, trace = jax_external_runs[use_double, pallas_lstm]
    net = NetworkApply(A, NetworkConfig(use_double=use_double,
                                        pallas_lstm=pallas_lstm, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    optim = OptimConfig(**OPTIM)
    ts = _port_state(net, init, use_double, optim)
    step = make_external_batch_step(net, spec, optim, use_double)
    for i, batch in enumerate(batches):
        given = torch_batch(batch)
        ts, m = step(ts, given)
        want = trace[i]
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                                   rtol=1e-4)
        assert m["priorities"].shape == (spec.batch_size,)
        np.testing.assert_allclose(m["priorities"].numpy(),
                                   want["priorities"], rtol=2e-5)
        for name, value in ts.params.state_dict().items():
            np.testing.assert_allclose(value.numpy(),
                                       want["params"][name].numpy(),
                                       atol=1e-5, err_msg=name)
        if use_double:
            for name, value in ts.target_params.state_dict().items():
                np.testing.assert_allclose(value.numpy(),
                                           want["target"][name].numpy(),
                                           atol=1e-5, err_msg=name)
            # after step 1 the initial weights, after step 2 (a sync) the
            # online ones, after step 3 still step 2's
            online = ts.params.state_dict()
            if i < 2:
                for name, value in ts.target_params.state_dict().items():
                    assert torch.equal(value, (init if i == 0
                                               else online)[name]), name
        # the batch is not consumed
        _assert_same(given, torch_batch(batch))
    assert ts.step == STEPS and int(ts.step_count) == STEPS


def _assert_same(a: SampleBatch, b: SampleBatch) -> None:
    for f in dataclasses.fields(SampleBatch):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("use_double", [False, True])
def test_external_step_equals_fused_step_bit_for_bit(use_double):
    """Three steps: the fused step samples from its replay with injected
    jitter; the external step trains on the batch ``replay_sample`` draws
    with the same jitter from a twin replay, whose tree then takes the
    external step's priorities. Loss, grad norm, params, target and tree
    are bit-equal."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    start = to_numpy_state(jax_filled(jspec, synthetic_blocks(spec, 10,
                                                              seed=5)))
    jnet = JNetworkApply(A, JNetworkConfig(**TINY), spec.frame_stack,
                         spec.frame_height, spec.frame_width)
    init = _flat(j_create(jax.random.PRNGKey(0), jnet,
                          JOptimConfig(**OPTIM)).params)
    net = NetworkApply(A, NetworkConfig(use_double=use_double, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    optim = OptimConfig(**OPTIM)
    ts_fused = _port_state(net, init, use_double, optim)
    ts_ext = _port_state(net, init, use_double, optim)
    rs_fused = replay_state_from_jax(start, spec, "cpu")
    rs_ext = replay_state_from_jax(start, spec, "cpu")
    fused = make_learner_step(net, spec, optim, use_double)
    external = make_external_batch_step(net, spec, optim, use_double)
    gen = torch.Generator().manual_seed(9)
    for _ in range(STEPS):
        uniform = torch.rand(spec.batch_size, generator=gen)
        ts_fused, rs_fused, m_fused = fused(ts_fused, rs_fused, uniform)
        batch = replay_sample(spec, rs_ext, uniform=uniform)
        ts_ext, m_ext = external(ts_ext, batch)
        tree_update(spec.tree_layers, rs_ext.tree, spec.prio_exponent,
                    m_ext["priorities"], batch.idxes)
        for name in ("loss", "grad_norm", "mean_abs_td", "mean_q"):
            assert torch.equal(m_fused[name], m_ext[name]), name
        assert torch.equal(rs_fused.tree, rs_ext.tree)
    for a, b in ((ts_fused.params, ts_ext.params),
                 (ts_fused.target_params, ts_ext.target_params)):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
    assert ts_fused.step == ts_ext.step == STEPS


def test_graph_batch_input_refuses_moved_or_different_batches():
    """The graph wrapper's batch input: one step a dispatch only; the
    first call makes a static batch of the given one's fields, which the
    address check covers (a moved static tensor raises, naming it), and a
    batch of another shape or type is refused rather than broadcast."""
    with pytest.raises(ValueError, match="one step"):
        GraphedSteps(body=None, steps=2, batch_size=8, batch_input=True)
    _, spec = specs(num_blocks=10, batch_size=8)
    host = JHostReplay(specs(num_blocks=10, batch_size=8)[0], seed=1,
                       use_native=False)
    for block in synthetic_blocks(spec, 4, seed=2):
        host.add(block)
    batch = torch_batch(host.sample()[0])
    net = NetworkApply(A, NetworkConfig(**TINY), spec.frame_stack,
                       spec.frame_height, spec.frame_width, "cpu")
    optim = OptimConfig(**OPTIM)
    ts = _port_state(net, net.init(0).state_dict(), False, optim)
    graph = GraphedSteps(body=None, steps=1, batch_size=8, batch_input=True)
    graph._fill_batch(batch)
    _assert_same(graph.batch, batch)
    assert graph.batch.obs.data_ptr() != batch.obs.data_ptr()
    graph.addresses = {n: t.data_ptr() for n, t in
                       _state_tensors(ts, None) + graph._inputs()}
    assert {"step_count", "batch.obs", "batch.is_weights",
            "batch.idxes"} <= graph.addresses.keys()
    graph._check_addresses(ts, None)
    graph.batch.obs = graph.batch.obs.clone()
    with pytest.raises(RuntimeError, match="batch.obs"):
        graph._check_addresses(ts, None)
    short = dataclasses.replace(batch, reward=batch.reward[:, :1])
    with pytest.raises(ValueError, match="differs"):
        graph._fill_batch(short)
    with pytest.raises(ValueError, match="differs"):
        graph._fill_batch(dataclasses.replace(batch,
                                              lane=batch.lane.long()))
