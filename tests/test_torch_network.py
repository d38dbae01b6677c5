"""The port's network with weights converted from the JAX package gives the
same Q-values and packed hidden state as ``NetworkApply.apply`` (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.models.network import ConvTorso as JConvTorso
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu_torch.config import NetworkConfig
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply

pytestmark = pytest.mark.torch_port

A, STACK, HW = 6, 2, 24
TINY = dict(hidden_dim=16, cnn_out_dim=32,
            conv_layers=((8, 4, 2), (16, 3, 1)), bf16="off")


def _nets(use_dueling=True, seed=0):
    jnet = JNetworkApply(A, JNetworkConfig(use_dueling=use_dueling, **TINY),
                         STACK, HW, HW)
    params = jnet.init(jax.random.PRNGKey(seed))
    net = NetworkApply(A, NetworkConfig(use_dueling=use_dueling, **TINY),
                       STACK, HW, HW, device="cpu")
    module = net.build()
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net, module


def _inputs(rng, batch, seq):
    obs = rng.uniform(size=(batch, seq, HW, HW, STACK)).astype(np.float32)
    actions = rng.integers(-1, A, (batch, seq))
    la = np.zeros((batch, seq, A), np.float32)
    la[actions >= 0, actions[actions >= 0]] = 1.0
    hidden = rng.normal(size=(batch, 2, TINY["hidden_dim"])).astype(np.float32)
    return obs, la, hidden


@pytest.mark.parametrize("use_dueling", [True, False])
@pytest.mark.parametrize("seq", [1, 12])
def test_converted_network_matches_jax(rng, seq, use_dueling):
    """T=1 (the actor's step) and T=seq_window (the learner's unroll),
    dueling on and off: atol 1e-5 (f32; conv and matmul sums run in
    other orders in the two frameworks)."""
    jnet, params, _, module = _nets(use_dueling)
    obs, la, hidden = _inputs(rng, 5, seq)
    want_q, want_h = jnet.apply(params, jnp.asarray(obs), jnp.asarray(la),
                                jnp.asarray(hidden))
    with torch.no_grad():
        got_q, got_h = module(torch.from_numpy(obs), torch.from_numpy(la),
                              torch.from_numpy(hidden))
    assert got_q.dtype == torch.float32 and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)


def test_torso_flatten_order_matches_flax(rng):
    """flax flattens the last conv output in (h, w, c) order; the port
    flattens from the NHWC view, so the converted Dense kernel needs no
    row permutation. A (c, h, w) flatten (plain NCHW .reshape) gives other
    features on a 9x9x16 conv output — the regression this guards."""
    _, params, net, module = _nets()
    obs = rng.uniform(size=(3, HW, HW, STACK)).astype(np.float32)
    torso = JConvTorso(TINY["cnn_out_dim"], TINY["conv_layers"], jnp.float32)
    want = np.asarray(torso.apply({"params": params["params"]["torso"]},
                                  jnp.asarray(obs)))
    with torch.no_grad():
        got = module.torso(torch.from_numpy(obs), torch.float32).numpy()
        x = torch.from_numpy(obs).permute(0, 3, 1, 2)
        for conv in module.torso.convs:
            x = torch.relu(conv(x))
        assert x.shape[2:] == (9, 9)
        wrong = module.torso.dense(x.reshape(3, -1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(wrong - want).max() > 1e-2


def test_init_matches_flax_scheme():
    """The port's own init: lecun-normal kernels, zero biases, per-gate
    orthogonal recurrent blocks; the same seed gives the same weights."""
    net = NetworkApply(A, NetworkConfig(**TINY), STACK, HW, HW, device="cpu")
    a, b = net.init(3), net.init(3)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.lstm.recurrent_kernel.detach()
    hidden = w.shape[0]
    for g in range(4):
        block = w[:, g * hidden:(g + 1) * hidden]
        torch.testing.assert_close(block.T @ block, torch.eye(hidden),
                                   atol=1e-5, rtol=0)
    assert torch.count_nonzero(a.lstm.bias) == 0
    dense = a.torso.dense.weight.detach()
    std = (1.0 / dense.shape[1]) ** 0.5
    assert abs(dense.std().item() - std) < 0.2 * std
    assert dense.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6


def test_bf16_policy_resolves_per_device():
    """bf16 "auto" is f32 on the CPU; pallas_lstm "on" builds the fused
    scan and "auto" resolves off on every device."""
    cfg = NetworkConfig(**{**TINY, "bf16": "auto"})
    assert NetworkApply(A, cfg, STACK, HW, HW, "cpu").compute_dtype == \
        torch.float32
    for setting, fused in (("on", True), ("auto", False)):
        net = NetworkApply(A, NetworkConfig(**{**TINY, "pallas_lstm": setting}),
                           STACK, HW, HW, "cpu")
        assert net.config.pallas_lstm is fused
        assert net.build().lstm.fused is fused
