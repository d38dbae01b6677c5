"""The first conv on the 2x2 space-to-depth input: the port's
``space_to_depth_2x2``, its decode into that layout, the weight
re-indexing and the network on that route, each against the JAX package
on the CPU (f32; exact unless a test says otherwise)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from r2d2_tpu.config import NetworkConfig as JNetworkConfig
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.models.network import \
    convert_params_space_to_depth as j_convert_s2d
from r2d2_tpu.models.network import space_to_depth_2x2 as j_s2d
from r2d2_tpu.ops.pallas_kernels import stack_frames_pallas
from r2d2_tpu_torch.config import Config, NetworkConfig
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import (SPACE_TO_DEPTH, STANDARD,
                                           NetworkApply,
                                           conv_weight_space_to_depth,
                                           convert_params_space_to_depth,
                                           input_layout)
from r2d2_tpu_torch.ops import replay_kernels as rk
from r2d2_tpu_torch.ops.indexing import space_to_depth_2x2
from r2d2_tpu_torch.tools.conv_layouts import check_layouts_agree

pytestmark = pytest.mark.torch_port

A, STACK, HW = 6, 2, 24
TINY = dict(hidden_dim=16, cnn_out_dim=32,
            conv_layers=((8, 4, 2), (16, 3, 1)), bf16="off")


def _jax_params(space_to_depth="off", seed=0):
    jnet = JNetworkApply(A, JNetworkConfig(space_to_depth=space_to_depth,
                                           **TINY), STACK, HW, HW)
    return jnet, jnet.init(jax.random.PRNGKey(seed))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, batch, seq):
    obs = rng.uniform(size=(batch, seq, HW, HW, STACK)).astype(np.float32)
    actions = rng.integers(-1, A, (batch, seq))
    la = np.zeros((batch, seq, A), np.float32)
    la[actions >= 0, actions[actions >= 0]] = 1.0
    hidden = rng.normal(size=(batch, 2, TINY["hidden_dim"])).astype(np.float32)
    return obs, la, hidden


def _s2d_obs(obs: np.ndarray) -> torch.Tensor:
    """(B, T, H, W, K) -> (B, T, H/2, W/2, 4K), as the decode emits it."""
    x = torch.from_numpy(obs)
    return space_to_depth_2x2(x.flatten(0, 1)).unflatten(0, x.shape[:2])


@pytest.mark.parametrize("shape", [(3, 24, 24, 2), (2, 84, 84, 4),
                                   (1, 6, 10, 3)])
def test_space_to_depth_2x2_matches_jax(rng, shape):
    x = rng.uniform(size=shape).astype(np.float32)
    want = np.asarray(j_s2d(jnp.asarray(x)))
    got = space_to_depth_2x2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


B, T, K, H, W = 2, 5, 4, 12, 12


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_space_to_depth_matches_pallas(rng, dtype, pad):
    """stack_frames_plain(space_to_depth=True) = JAX space_to_depth_2x2 of
    stack_frames_pallas(interpret=True) for each (b, t): exact, on
    unpadded and on 32x128-padded storage."""
    obs = rng.integers(0, 256, (B, T + K - 1 + 2, H, W)).astype(np.uint8)
    if pad:
        obs = np.pad(obs, ((0, 0), (0, 0), (0, 20), (0, 116)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    std = stack_frames_pallas(jnp.asarray(obs), T, K, True, jdt, H,
                              out_width=W)
    want = np.asarray(j_s2d(std.reshape(B * T, H, W, K))).reshape(
        B, T, H // 2, W // 2, 4 * K).astype(np.float32)
    got = rk.stack_frames_plain(torch.from_numpy(obs), T, K, tdt, H, W,
                                space_to_depth=True)
    assert got.shape == (B, T, H // 2, W // 2, 4 * K) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_decode_space_to_depth_cpu_dispatch(rng):
    """A CPU tensor takes the plain version in both layouts, launches
    nothing, and the bf16 output is the f32 one rounded once."""
    rk.reset_launch_counts()
    obs = torch.from_numpy(
        rng.integers(0, 256, (B, T + K - 1, H, W)).astype(np.uint8))
    f32 = rk.stack_frames(obs, T, K, torch.float32, space_to_depth=True)
    bf = rk.stack_frames(obs, T, K, torch.bfloat16, space_to_depth=True)
    assert torch.equal(f32, rk.stack_frames_plain(obs, T, K, torch.float32,
                                                  space_to_depth=True))
    np.testing.assert_array_equal(
        bf.float().numpy(),
        f32.numpy().astype(ml_dtypes.bfloat16).astype(np.float32))
    assert rk.LAUNCHES == {"gather_windows": 0, "stack_frames": 0}


def test_cuda_decode_refuses_odd_space_to_depth(rng):
    obs = torch.from_numpy(rng.integers(0, 256, (1, 6, 7, 8))
                           .astype(np.uint8))
    with pytest.raises(ValueError):
        rk.stack_frames_cuda(obs, 3, 2, space_to_depth=True)
    assert rk.LAUNCHES["stack_frames"] == 0


def test_weight_reindex_matches_jax_conversion():
    """conv_weight_space_to_depth on the OIHW weight = JAX's (2k, 2k, C, O)
    -> (k, k, 4C, O) re-indexing after HWIO -> OIHW (the tiny first conv:
    8 filters, k = 2); the state-dict migration changes that entry only."""
    _, params = _jax_params()
    standard = params_from_flax(_np(params))
    converted = params_from_flax(_np(j_convert_s2d(params, STACK)))
    w = standard["torso.convs.0.weight"]
    assert tuple(w.shape) == (8, STACK, 4, 4)
    got = conv_weight_space_to_depth(w)
    assert tuple(got.shape) == (8, 4 * STACK, 2, 2)
    assert torch.equal(got, converted["torso.convs.0.weight"])
    migrated = convert_params_space_to_depth(standard, STACK)
    assert migrated.keys() == converted.keys()
    for name, value in migrated.items():
        assert torch.equal(value, converted[name]), name
    with pytest.raises(ValueError, match="already"):
        convert_params_space_to_depth(migrated, STACK)


def _port_net(space_to_depth="off", params=None):
    net = NetworkApply(A, NetworkConfig(space_to_depth=space_to_depth,
                                        **TINY), STACK, HW, HW, "cpu")
    module = net.build()
    if params is not None:
        module.load_state_dict(params_from_flax(_np(params)))
    return net, module


@pytest.mark.parametrize("layout", [STANDARD, SPACE_TO_DEPTH])
@pytest.mark.parametrize("seq", [1, 12])
def test_space_to_depth_route_matches_jax(rng, seq, layout):
    """The port's network on the space-to-depth route (standard-layout
    parameters) against JAX's R2D2Network with space_to_depth off and the
    same converted params: atol 1e-5 (f32; the conv sums run in another
    order), from standard-layout input and from the decode's layout."""
    jnet, params = _jax_params()
    net, module = _port_net(params=params)
    assert net.input_layout == module.input_layout == SPACE_TO_DEPTH
    obs, la, hidden = _inputs(rng, 4, seq)
    want_q, want_h = jnet.apply(params, jnp.asarray(obs), jnp.asarray(la),
                                jnp.asarray(hidden))
    x = torch.from_numpy(obs) if layout == STANDARD else _s2d_obs(obs)
    with torch.no_grad():
        got_q, got_h = module(x, torch.from_numpy(la),
                              torch.from_numpy(hidden), layout)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)


def test_standard_and_space_to_depth_input_give_the_same_q(rng):
    """Standard input is rearranged into the same tensor the decode
    emits, so the two give bit-equal Q."""
    _, params = _jax_params(seed=2)
    _, module = _port_net(params=params)
    obs, la, hidden = _inputs(rng, 3, 7)
    args = (torch.from_numpy(la), torch.from_numpy(hidden))
    with torch.no_grad():
        q_std, h_std = module(torch.from_numpy(obs), *args, STANDARD)
        q_s2d, h_s2d = module(_s2d_obs(obs), *args, SPACE_TO_DEPTH)
    assert torch.equal(q_std, q_s2d) and torch.equal(h_std, h_s2d)


def test_space_to_depth_gradient_lands_on_the_standard_weight(rng):
    """The torso re-indexes the weight inside autograd: the first conv's
    gradient equals that of the standard conv (atol 1e-5) and keeps the
    standard (O, C, 4, 4) shape."""
    _, module = _port_net()
    obs = torch.from_numpy(rng.uniform(size=(3, HW, HW, STACK))
                           .astype(np.float32))
    torso = module.torso
    torso(obs, torch.float32).square().sum().backward()
    got = torso.convs[0].weight.grad.clone()
    torso.zero_grad()
    x = obs.permute(0, 3, 1, 2)
    for conv in torso.convs:
        x = torch.relu(conv(x))
    torso.dense(x.permute(0, 2, 3, 1).reshape(3, -1)).square().sum() \
        .backward()
    want = torso.convs[0].weight.grad
    assert got.shape == (8, STACK, 4, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_route_choice():
    """Space-to-depth where layer 0's kernel and stride and the frame are
    even (the tiny 4/2 conv on 24x24, the reference 8/4 conv on 84x84); the
    standard layout otherwise, whose torso refuses the
    space-to-depth input."""
    ref = Config()
    assert input_layout(ref.network.conv_layers, ref.env.frame_height,
                        ref.env.frame_width) == SPACE_TO_DEPTH
    assert input_layout(TINY["conv_layers"], HW, HW) == SPACE_TO_DEPTH
    assert input_layout(((8, 3, 2),), HW, HW) == STANDARD
    assert input_layout(((8, 4, 3),), HW, HW) == STANDARD
    assert input_layout(((8, 4, 2),), 25, 24) == STANDARD
    odd = dict(TINY, conv_layers=((8, 3, 2), (16, 3, 1)))
    net = NetworkApply(A, NetworkConfig(**odd), STACK, HW, HW, "cpu")
    assert net.input_layout == STANDARD
    module = net.build()
    assert module.input_layout == STANDARD
    with pytest.raises(ValueError, match="standard layout"):
        module.torso(torch.zeros(2, HW // 2, HW // 2, 4 * STACK),
                     torch.float32, SPACE_TO_DEPTH)


@pytest.mark.parametrize("seq", [1, 12])
def test_space_to_depth_params_match_jax(rng, seq):
    """network.space_to_depth="on": the first conv's parameters held as
    (O, 4C, 2, 2), converted from JAX's (2, 2, 4C, O) flax kernel; Q and
    hidden equal JAX's space_to_depth network at atol 1e-5 (f32), from
    both input layouts."""
    jnet, params = _jax_params("on")
    net, module = _port_net("on", params)
    assert net.config.space_to_depth is True
    assert tuple(module.torso.convs[0].weight.shape) == (8, 4 * STACK, 2, 2)
    obs, la, hidden = _inputs(rng, 4, seq)
    want_q, want_h = jnet.apply(params, jnp.asarray(obs), jnp.asarray(la),
                                jnp.asarray(hidden))
    args = (torch.from_numpy(la), torch.from_numpy(hidden))
    with torch.no_grad():
        for x, layout in ((torch.from_numpy(obs), STANDARD),
                          (_s2d_obs(obs), SPACE_TO_DEPTH)):
            got_q, got_h = module(x, *args, layout)
            np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                                       atol=1e-5)
            np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                       atol=1e-5)


def test_space_to_depth_migration_keeps_q(rng):
    """A standard state dict migrated by convert_params_space_to_depth
    into a network.space_to_depth="on" module gives the same Q (atol
    1e-6: the same conv, its weight re-indexed once instead of per call)."""
    _, params = _jax_params(seed=4)
    _, standard = _port_net(params=params)
    _, s2d = _port_net("on")
    s2d.load_state_dict(convert_params_space_to_depth(standard.state_dict(),
                                                      STACK))
    obs, la, hidden = _inputs(rng, 2, 5)
    args = (torch.from_numpy(obs), torch.from_numpy(la),
            torch.from_numpy(hidden))
    with torch.no_grad():
        np.testing.assert_allclose(s2d(*args)[0].numpy(),
                                   standard(*args)[0].numpy(), atol=1e-6)


def test_space_to_depth_setting_is_explicit():
    """"auto" is refused (the setting changes the parameter layout, as in
    the JAX package), and "on" needs an even first conv and frame."""
    with pytest.raises(ValueError, match="'auto' is not allowed"):
        NetworkApply(A, NetworkConfig(space_to_depth="auto", **TINY), STACK,
                     HW, HW, "cpu")
    odd = dict(TINY, conv_layers=((8, 3, 2), (16, 3, 1)))
    with pytest.raises(ValueError, match="even"):
        NetworkApply(A, NetworkConfig(space_to_depth="on", **odd), STACK,
                     HW, HW, "cpu")
    assert NetworkApply(A, NetworkConfig(space_to_depth="off", **TINY),
                        STACK, HW, HW, "cpu").config.space_to_depth is False


def test_conv_layouts_tool_layouts_agree():
    """The four first-conv layouts that tools/conv_layouts.py times compute
    the same f32 conv (here on the CPU; the tool raises past 1e-4)."""
    assert check_layouts_agree(torch.device("cpu"), frames=2) <= 1e-5
