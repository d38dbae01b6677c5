"""The port's learner step against the JAX package's ``make_learner_step``
on the same carried-over replay state, weights and sampling jitter (f32,
the JAX plain path ``pallas_*="off"``, which the JAX tests hold equal to its
kernel path; and with ``network.pallas_lstm="on"`` on both sides, the JAX
fused LSTM kernels in interpret mode), and the optimizer pieces against
optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import make_learner_step as j_step
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import (TrainState,
                                               clip_by_global_norm_,
                                               make_learner_step,
                                               make_optimizer, _decode_inputs)
from r2d2_tpu_torch.models.convert import (params_from_flax,
                                           replay_state_from_jax)
from r2d2_tpu_torch.models.network import NetworkApply
from tests.test_torch_replay import (jax_filled, specs, synthetic_blocks,
                                     to_numpy_state)

pytestmark = pytest.mark.torch_port

A = 18            # synthetic blocks draw actions in [0, 18)
TINY = dict(hidden_dim=16, cnn_out_dim=32,
            conv_layers=((8, 4, 2), (16, 3, 1)), bf16="off")
OPTIM = dict(lr=1e-3, target_net_update_interval=2)
STEPS = 3


def _flat(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _jax_run(use_double, pallas_lstm="off"):
    """STEPS JAX learner steps; per step: the jitter drawn, the loss, the
    params and the tree after it."""
    jspec, spec = specs(num_blocks=10, batch_size=8)
    blocks = synthetic_blocks(spec, 10, seed=5)
    jstate = jax_filled(jspec, blocks)
    start = to_numpy_state(jstate)
    jnet = JNetworkApply(A, JNetworkConfig(
        use_double=use_double, pallas_lstm=pallas_lstm,
        pallas_lstm_interpret=pallas_lstm == "on", **TINY),
        spec.frame_stack, spec.frame_height, spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off", **OPTIM)
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init_params = _flat(ts.params)
    step = j_step(jnet, jspec, optim, use_double)
    trace = []
    for _ in range(STEPS):
        _, base = jax.random.split(ts.key)
        jitter = np.asarray(jax.random.uniform(
            jax.random.fold_in(base, 0), (spec.batch_size,), jnp.float32))
        ts, jstate, m = step(ts, jstate)
        trace.append(dict(jitter=jitter, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          params=_flat(ts.params),
                          target=_flat(ts.target_params),
                          tree=np.asarray(jstate.tree)))
    return spec, start, init_params, trace


@pytest.fixture(scope="module")
def jax_runs():
    return {d: _jax_run(d) for d in (False, True)}


@pytest.fixture(scope="module")
def jax_fused_runs():
    return {d: _jax_run(d, pallas_lstm="on") for d in (False, True)}


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("use_double", [False, True])
def test_learner_step_matches_jax(jax_runs, use_double, steps):
    """Loss rtol 1e-5 per step, params after Adam atol 1e-5, priorities
    written into the tree rtol 1e-5; with double DQN the hard target sync
    at step 2 is checked too."""
    _check_steps(jax_runs[use_double], use_double, steps, "off")


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("use_double", [False, True])
def test_learner_step_fused_lstm_matches_jax(jax_fused_runs, use_double,
                                             steps):
    """network.pallas_lstm="on" on both sides: the port's fused scan (its
    plain versions on the CPU; the lean forward on the double-DQN target
    unroll) against the JAX step through the Pallas LSTM kernels in
    interpret mode, at the same tolerances."""
    _check_steps(jax_fused_runs[use_double], use_double, steps, "on")


def _check_steps(run, use_double, steps, pallas_lstm):
    spec, start, init_params, trace = run
    net = NetworkApply(A, NetworkConfig(use_double=use_double,
                                        pallas_lstm=pallas_lstm, **TINY),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    assert net.build().lstm.fused is (pallas_lstm == "on")
    optim = OptimConfig(**OPTIM)
    online = net.build()
    online.load_state_dict(init_params)
    target = online
    if use_double:
        target = net.build()
        target.load_state_dict(init_params)
    ts = TrainState(params=online, target_params=target,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator())
    rs = replay_state_from_jax(start, spec, "cpu")
    step = make_learner_step(net, spec, optim, use_double)
    for i in range(steps):
        ts, rs, m = step(ts, rs, torch.from_numpy(trace[i]["jitter"].copy()))
        np.testing.assert_allclose(float(m["loss"]), trace[i]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   trace[i]["grad_norm"], rtol=1e-4)
    want = trace[steps - 1]
    for name, value in ts.params.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want["params"][name].numpy(),
                                   atol=1e-5, err_msg=name)
    if use_double:
        for name, value in ts.target_params.state_dict().items():
            np.testing.assert_allclose(value.numpy(),
                                       want["target"][name].numpy(),
                                       atol=1e-5, err_msg=name)
    np.testing.assert_allclose(rs.tree.numpy(), want["tree"], rtol=1e-5,
                               atol=1e-7)
    assert ts.step == steps


@pytest.mark.parametrize("scale", [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(rng, scale):
    """optax scales by max/norm only when norm >= max, as g / norm * max
    (torch's clip_grad_norm_ divides by norm + 1e-6 instead)."""
    grads = [(rng.normal(size=s) * scale).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 5))]
    tx = optax.clip_by_global_norm(40.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(tg, 40.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for g, w in zip(tg, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_adam_matches_optax_step_for_step(rng):
    """torch.optim.Adam with eps outside the sqrt = optax.adam, five steps."""
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) * 10 ** -i
             for i in range(5)]
    tx = optax.adam(1e-3, eps=1e-3)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=1e-3, eps=1e-3)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-7, rtol=1e-6)


def test_decode_one_hot_of_null_action_is_zero():
    """jax.nn.one_hot(-1) is a zero row; F.one_hot raises on -1, so the
    port masks it."""
    _, spec = specs()
    net = NetworkApply(4, NetworkConfig(**TINY), spec.frame_stack,
                       spec.frame_height, spec.frame_width, "cpu")

    class Batch:
        obs = torch.zeros((2, spec.seq_window + spec.frame_stack - 1,
                           spec.frame_height, spec.frame_width),
                          dtype=torch.uint8)
        last_action = torch.tensor([[-1] * spec.seq_window,
                                    [3] * spec.seq_window], dtype=torch.int32)

    stacked, one_hot = _decode_inputs(net, spec, Batch)
    want = np.asarray(jax.nn.one_hot(np.asarray(Batch.last_action), 4))
    np.testing.assert_array_equal(one_hot.numpy(), want)
    # the tiny network's (8, 4, 2) first conv on 24x24 frames takes the
    # space-to-depth input, and the decode emits it
    assert net.input_layout == "space_to_depth"
    assert stacked.shape == (2, spec.seq_window, spec.frame_height // 2,
                             spec.frame_width // 2, 4 * spec.frame_stack)
