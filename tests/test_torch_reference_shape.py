"""One f32 learner step of the port at the reference shape against the JAX
package's ``make_learner_step`` on the CPU: B=128 sequences of 40+10+5
steps, 84x84x4 frames, Nature convs, cnn_out 1024, LSTM 512, dueling,
over a replay of a few blocks (the same state on both sides), the same
weights and the same injected jitter. The port runs its Python LSTM loop
and, with ``network.pallas_lstm="on"``, the fused scan's plain versions,
both against the JAX step on its scan (``pallas_lstm="off"``; the JAX
tests hold that scan equal to its Pallas kernel, which at H=512 in
interpret mode would take too long here). Slow: not in tier 1.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_reference_shape.py \
        -m slow
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.config import OptimConfig as JOptimConfig
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import make_learner_step as j_step
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu_torch.config import NetworkConfig, OptimConfig
from r2d2_tpu_torch.learner.train_step import (TrainState, make_learner_step,
                                               make_optimizer)
from r2d2_tpu_torch.models.convert import replay_state_from_jax
from r2d2_tpu_torch.models.network import NetworkApply
from tests.test_torch_replay import (jax_filled, specs, synthetic_blocks,
                                     to_numpy_state)
from tests.test_torch_train_step import A, _flat

pytestmark = [pytest.mark.torch_port, pytest.mark.slow]

BLOCKS = 4        # 160 sequences of 400-step blocks behind B=128
REFERENCE = dict(num_blocks=BLOCKS, seqs_per_block=40, block_length=400,
                 burn_in=40, learning=10, forward=5, frame_stack=4,
                 frame_height=84, frame_width=84, hidden_dim=512,
                 batch_size=128)


@pytest.fixture(scope="module")
def jax_reference_step():
    """One JAX step at the reference shape: the start state, the weights,
    the jitter drawn, and the loss, grad norm, params and tree after it."""
    jspec, spec = specs(**REFERENCE)
    jstate = jax_filled(jspec, synthetic_blocks(spec, BLOCKS, seed=7))
    start = to_numpy_state(jstate)
    jnet = JNetworkApply(A, JNetworkConfig(bf16="off", pallas_lstm="off"),
                         spec.frame_stack, spec.frame_height,
                         spec.frame_width)
    optim = JOptimConfig(pallas_obs_decode="off")
    ts = j_create(jax.random.PRNGKey(0), jnet, optim)
    init_params = _flat(ts.params)
    _, base = jax.random.split(ts.key)
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(base, 0),
                                           (spec.batch_size,), jnp.float32))
    ts, jstate, m = j_step(jnet, jspec, optim, False)(ts, jstate)
    return spec, start, init_params, dict(
        jitter=jitter, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
        params=_flat(ts.params), tree=np.asarray(jstate.tree))


@pytest.mark.parametrize("pallas_lstm", ["off", "on"])
def test_reference_shape_step_matches_jax(jax_reference_step, pallas_lstm):
    """Loss rtol 1e-5 and params after Adam atol 1e-5 (the tiny-shape
    tolerances), grad norm rtol 1e-4, tree rtol 1e-5 atol 1e-7."""
    spec, start, init_params, want = jax_reference_step
    net = NetworkApply(A, NetworkConfig(bf16="off", pallas_lstm=pallas_lstm),
                       spec.frame_stack, spec.frame_height, spec.frame_width,
                       "cpu")
    optim = OptimConfig()
    online = net.build()
    online.load_state_dict(init_params)
    ts = TrainState(params=online, target_params=online,
                    opt=make_optimizer(optim, online), step=0,
                    generator=torch.Generator())
    rs = replay_state_from_jax(start, spec, "cpu")
    ts, rs, m = make_learner_step(net, spec, optim, False)(
        ts, rs, torch.from_numpy(want["jitter"].copy()))
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=1e-4)
    for name, value in ts.params.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want["params"][name].numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(rs.tree.numpy(), want["tree"], rtol=1e-5,
                               atol=1e-7)
