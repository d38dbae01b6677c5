"""The port's on-device acting path (actor/anakin.py, runtime/anakin_loop.py)
against the JAX package's: ``emit_blocks`` against JAX's and against the
port's LocalBuffer on the same transition streams; the act core against
JAX's ``make_act_core`` with the draws JAX's key splits give injected;
one segment's ring write against the same blocks added one at a time;
the report filter; the config knobs; the orchestrator's routing; the
fused loop on the CPU; and the slice as a whole (one act segment, its
ring write and one learner step against JAX's same three dispatches).
All f32 on the CPU, at tests/test_anakin.py's small shape."""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.actor import anakin as janakin
from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.envs.factory import create_jax_env
from r2d2_tpu.envs.jax_env import JaxGridWorld
from r2d2_tpu.learner.train_step import create_train_state as j_create
from r2d2_tpu.learner.train_step import make_learner_step as j_step
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.replay import device_replay as jdr
from r2d2_tpu.replay.structs import ReplaySpec as JReplaySpec
from r2d2_tpu_torch.actor.anakin import (ActSegment, AnakinAct,
                                         SegmentDraws, emit_blocks,
                                         init_act_carry, make_act_core)
from r2d2_tpu_torch.actor.local_buffer import LocalBuffer
from r2d2_tpu_torch.config import Config, apex_epsilon, parse_overrides
from r2d2_tpu_torch.envs.factory import create_device_env
from r2d2_tpu_torch.learner.train_step import (TrainState, make_learner_step,
                                               make_optimizer)
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.replay import device_replay as tdr
from r2d2_tpu_torch.replay.structs import Block, ReplaySpec
from r2d2_tpu_torch.runtime import anakin_loop, orchestrator
from r2d2_tpu_torch.tools import learnability

pytestmark = pytest.mark.torch_port

SMALL = {
    "env.game_name": "Fake",
    "env.frame_height": 12, "env.frame_width": 12, "env.frame_stack": 2,
    "env.episode_len": 40,
    "network.hidden_dim": 16, "network.cnn_out_dim": 32,
    "network.conv_layers": ((8, 4, 2),), "network.bf16": "off",
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3,
    "replay.capacity": 800, "replay.block_length": 20,
    "replay.batch_size": 8, "replay.learning_starts": 100,
    "actor.on_device": True, "actor.anakin_lanes": 3,
    "runtime.save_interval": 0,
}
# the JAX side's plain (non-Pallas) paths on the CPU
JAX_PLAIN = {"replay.pallas_sample_gather": "off",
             "optim.pallas_obs_decode": "off"}
INT_FIELDS = ("obs_row", "last_action_row", "action", "burn_in_steps",
              "learning_steps", "forward_steps", "seq_start", "num_sequences",
              "weight_version", "lane")


def small_cfg(**overrides) -> Config:
    """tests/test_anakin.py's small_cfg, f32."""
    return Config().replace(**{**SMALL, **overrides})


def jax_cfg(**overrides) -> JConfig:
    return JConfig().replace(**{**SMALL, **JAX_PLAIN, **overrides})


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_blocks(got: Block, want, *, priority_rtol=1e-5, priority_atol=0.0,
                 hidden_atol=0.0, skip=()) -> None:
    """Every field of two stacked blocks: int and uint8 fields exact,
    reward atol 2e-5, gamma atol 2e-6, the priority at the given
    tolerance, hidden and sum_reward allclose."""
    for f in dataclasses.fields(Block):
        if f.name in skip:
            continue
        a, b = _np(getattr(got, f.name)), _np(getattr(want, f.name))
        if f.name in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "reward":
            np.testing.assert_allclose(a, b, atol=2e-5, err_msg=f.name)
        elif f.name == "gamma":
            np.testing.assert_allclose(a, b, atol=2e-6, err_msg=f.name)
        elif f.name == "priority":
            np.testing.assert_allclose(a, b, rtol=priority_rtol,
                                       atol=priority_atol, err_msg=f.name)
        elif f.name == "hidden":
            np.testing.assert_allclose(a, b, atol=hidden_atol,
                                       err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f.name)


def _lane(blocks: Block, i: int) -> Block:
    """Block ``i`` of a stack, as numpy."""
    return Block(**{f.name: _np(getattr(blocks, f.name))[i]
                    for f in dataclasses.fields(Block)})


# ---- emit_blocks against JAX's and the LocalBuffer ----------------------


def _drive_parity(overrides: dict, n_segments: int, ep_blocks: int,
                  td_priority: bool, num_lanes: int = 2, seed: int = 0):
    """The same synthetic transition streams into the port's LocalBuffer
    (add/finish per lane), the port's emit_blocks and JAX's, tails
    carried; tests/test_anakin.py's ``_drive_parity``. Returns, per
    segment, (host blocks per lane, port blocks, JAX blocks)."""
    spec = ReplaySpec.from_config(small_cfg(**overrides), "cpu")
    jspec = JReplaySpec.from_config(jax_cfg(**overrides))
    rng = np.random.default_rng(seed)
    n, l_seg = num_lanes, spec.block_length
    h = w = spec.frame_height
    a_dim, hid, gamma = 6, spec.hidden_dim, 0.997
    priority = "td" if td_priority else 1.0
    lbs = [LocalBuffer(spec, a_dim, gamma) for _ in range(n)]
    init_obs = rng.integers(0, 255, (n, h, w)).astype(np.uint8)
    for i in range(n):
        lbs[i].reset(init_obs[i])
    stack, b = spec.frame_stack, spec.burn_in
    tails = [np.zeros((n, stack + b, h, w), np.uint8),
             np.full((n, b + 1), -1, np.int32),
             np.zeros((n, b + 1, 2, hid), np.float32),
             np.zeros((n,), np.int32)]
    tails[0][:, b:] = np.repeat(init_obs[:, None], stack, axis=1)
    jtails = [jnp.asarray(x) for x in tails]
    ttails = [torch.from_numpy(x.copy()) for x in tails]
    ep_ret = np.zeros((n,), np.float32)
    out = []
    for seg in range(n_segments):
        obs = rng.integers(0, 255, (n, l_seg, h, w)).astype(np.uint8)
        actions = rng.integers(0, a_dim, (n, l_seg)).astype(np.int32)
        rewards = rng.normal(size=(n, l_seg)).astype(np.float32)
        hiddens = rng.normal(size=(n, l_seg, 2, hid)).astype(np.float32)
        terminal = np.full((n,), ((seg + 1) % ep_blocks) == 0)
        reset_obs = rng.integers(0, 255, (n, h, w)).astype(np.uint8)
        ep_ret = ep_ret + rewards.sum(axis=1)
        qs = rng.normal(size=(n, l_seg, a_dim)).astype(np.float32)
        q_boot = np.where(terminal[:, None], 0.0, rng.normal(
            size=(n, a_dim))).astype(np.float32)
        host = []
        for i in range(n):
            for t in range(l_seg):
                lbs[i].add(int(actions[i, t]), float(rewards[i, t]),
                           obs[i, t], qs[i, t] if td_priority
                           else np.zeros(a_dim, np.float32), hiddens[i, t])
            if terminal[i]:
                host.append(lbs[i].finish(None))
                lbs[i].reset(reset_obs[i])
            else:
                host.append(lbs[i].finish(
                    q_boot[i] if td_priority else np.zeros(a_dim,
                                                           np.float32)))
        args = (obs, actions, rewards, hiddens, terminal, ep_ret,
                np.ones(n, bool), reset_obs)
        jblocks, jtails = janakin.emit_blocks(
            jspec, gamma, priority, *jtails, *[jnp.asarray(x) for x in args],
            seg + 100, q_seg=jnp.asarray(qs), q_boot=jnp.asarray(q_boot),
            lanes=jnp.arange(n, dtype=jnp.int32))
        tblocks, ttails = emit_blocks(
            spec, gamma, priority, *ttails,
            *[torch.from_numpy(np.array(x)) for x in args], seg + 100,
            q_seg=torch.from_numpy(qs), q_boot=torch.from_numpy(q_boot),
            lanes=torch.arange(n, dtype=torch.int32))
        for got, want in zip(ttails, jtails):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        out.append((host, tblocks, jax.tree_util.tree_map(np.asarray,
                                                          jblocks)))
        ep_ret = np.where(terminal, 0.0, ep_ret).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["constant", "burn_in_0", "td"])
def test_emit_blocks_matches_jax_and_local_buffer(case):
    """Every field of every block, across segments with burn-in carry and
    episode resets (episodes of two blocks), against JAX's emit_blocks
    (exact for int and uint8 fields, reward atol 2e-5, gamma atol 2e-6,
    priority rtol 1e-5) and the port's LocalBuffer block for block (the
    constant stamp aside; "td" priorities at the JAX test's 2e-4/1e-4,
    the host computing its returns in f64)."""
    overrides = ({"sequence.burn_in_steps": 0} if case == "burn_in_0"
                 else {})
    td = case == "td"
    for host, tblocks, jblocks in _drive_parity(overrides, 4, 2, td):
        check_blocks(tblocks, jblocks)
        for i, hb in enumerate(host):
            lane = _lane(tblocks, i)
            check_blocks(lane, hb, skip=("weight_version", "lane")
                         + (() if td else ("priority",)),
                         priority_rtol=1e-4, priority_atol=2e-4)
            assert int(lane.weight_version) >= 100 and int(lane.lane) == i
    if td:
        prios = np.concatenate([_np(t.priority).ravel()
                                for _, t, _ in _drive_parity({}, 2, 2, td)])
        assert np.unique(np.round(prios, 5)).size > 1


# ---- the act core against JAX's make_act_core ---------------------------


def _jax_segment_draws(jenv, key, n, length, action_dim):
    """The draws of one segment of JAX's core from the carry's key:
    ``k_seg, k_run = split(key)``, the reset from ``split(k_seg, n)``,
    then per step ``key, k_eps, k_expl, k_env = split(key, 4)``. Returns
    the port's SegmentDraws and the key the JAX carry holds after it."""
    grid = isinstance(jenv, JaxGridWorld)
    cell = jax.vmap(lambda k: jax.random.randint(k, (2,), 0, jenv.size,
                                                 jnp.int32)) if grid else None
    k_seg, key = jax.random.split(key)
    explore, random_action, cells = [], [], []
    for _ in range(length):
        key, k_eps, k_expl, k_env = jax.random.split(key, 4)
        explore.append(np.asarray(jax.random.uniform(k_eps, (n,))))
        random_action.append(np.asarray(jax.random.randint(
            k_expl, (n,), 0, action_dim, jnp.int32)))
        if grid:
            cells.append(np.asarray(cell(jax.random.split(k_env, n))))
    draws = SegmentDraws(
        torch.from_numpy(np.stack(explore)),
        torch.from_numpy(np.stack(random_action)),
        torch.from_numpy(np.stack(cells)) if grid else None,
        _jax_reset_draws(jenv, jax.random.split(k_seg, n)))
    return draws, key


def _jax_reset_draws(jenv, keys):
    """What the port's env reset takes for JAX's per-lane reset keys: the
    Fake env's schedules, the gridworld's raw (agent, goal) cells."""
    if isinstance(jenv, JaxGridWorld):
        def one(key):
            kp, kg = jax.random.split(key)
            return jnp.stack([
                jax.random.randint(kp, (2,), 0, jenv.size, jnp.int32),
                jax.random.randint(kg, (2,), 0, jenv.size, jnp.int32)])
        return torch.from_numpy(np.array(jax.vmap(one)(keys)))
    state, _ = jax.vmap(jenv.reset)(keys)
    return torch.from_numpy(np.array(state["schedule"]))


def _port_net(cfg: Config, action_dim: int) -> NetworkApply:
    return NetworkApply(action_dim, cfg.network, cfg.env.frame_stack,
                        cfg.env.frame_height, cfg.env.frame_width, "cpu")


def _jax_net(jcfg: JConfig, action_dim: int) -> JNetworkApply:
    return JNetworkApply(action_dim, jcfg.network, jcfg.env.frame_stack,
                         jcfg.env.frame_height, jcfg.env.frame_width)


def _module_from(net: NetworkApply, jparams):
    module = net.build()
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return module


def _check_carry(got, want) -> None:
    """The port's ActCarry against JAX's: hidden atol 1e-5, the rest
    exact (ep_return at f32 rtol 1e-6)."""
    for key, value in want.env_state.items():
        np.testing.assert_array_equal(_np(getattr(got.env_state, key)),
                                      np.asarray(value), err_msg=key)
    for name in ("cur_stack", "last_action", "tail_frames", "tail_la",
                 "burn0"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("hidden", "tail_hidden"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(_np(got.ep_return),
                               np.asarray(want.ep_return), rtol=1e-6)


@pytest.mark.parametrize("game", ["Fake", "Grid"])
def test_act_core_matches_jax_with_injected_draws(game, priority="td"):
    """Three segments of three lanes (episodes of two segments, so the
    third starts after a reset) from the same weights, with the draws of
    JAX's key splits injected: the carry (hidden atol 1e-5), every block
    field (hidden atol 1e-5; the "td" priorities, which carry the
    Q-values, rtol/atol 1e-5; the rest as in emit_blocks) and the stats
    equal JAX's; actions equal. The constant stamp's act runs in the
    whole-slice test below."""
    over = {"env.game_name": game, "env.grid_size": 4}
    cfg, jcfg = small_cfg(**over), jax_cfg(**over)
    n, wv = 3, 7
    jenv = create_jax_env(jcfg.env)
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    jspec = JReplaySpec.from_config(jcfg)
    jnet, net = _jax_net(jcfg, env.action_dim), _port_net(cfg,
                                                          env.action_dim)
    jparams = jnet.init(jax.random.PRNGKey(0))
    module = _module_from(net, jparams)
    eps = [apex_epsilon(i, n, 0.4, 7.0) for i in range(n)]
    jcore = jax.jit(janakin.make_act_core(
        jenv, jnet, jspec, num_lanes=n, gamma=0.997, priority=priority))
    core = make_act_core(env, net, spec, gamma=0.997, priority=priority)
    report = [e <= 0.02 for e in eps]

    key = jax.random.PRNGKey(1)
    jcarry = janakin.init_act_carry(jenv, jspec, n, key)
    k_env, _ = jax.random.split(key)
    carry = init_act_carry(env, spec, n, reset_draws=_jax_reset_draws(
        jenv, jax.random.split(k_env, n)))
    _check_carry(carry, jcarry)
    for seg in range(3):
        draws, next_key = _jax_segment_draws(jenv, jcarry.key, n,
                                             spec.block_length,
                                             env.action_dim)
        jcarry, jblocks, jstats = jcore(
            jparams, jcarry, np.int32(wv), jnp.asarray(eps, jnp.float32),
            jnp.asarray(report), jnp.arange(n, dtype=jnp.int32))
        np.testing.assert_array_equal(np.asarray(jcarry.key),
                                      np.asarray(next_key))
        carry, blocks, stats = core(
            module, carry, torch.tensor(wv), torch.tensor(eps),
            torch.tensor(report), torch.arange(n, dtype=torch.int32), draws)
        _check_carry(carry, jcarry)
        check_blocks(blocks, jax.tree_util.tree_map(np.asarray, jblocks),
                     priority_rtol=1e-5, priority_atol=1e-5,
                     hidden_atol=1e-5)
        for name, value in jstats.items():
            np.testing.assert_allclose(float(stats[name]), float(value),
                                       rtol=1e-6, err_msg=name)
        assert int(stats["episodes"]) == (n if seg == 1 else 0)


def test_int8_act_core_matches_jax_with_injected_draws():
    """At network.inference_dtype int8, every forward of the segment (the
    step forwards and the "td" bootstrap) runs the publish-time twin:
    three segments of three lanes from the same weights and JAX's draws,
    the port's core (the twin an InferenceTwin of the same bundle) against
    JAX's ``make_act_core`` on the bundle. The carry (hidden atol 1e-5),
    every block field (hidden atol 1e-5; the "td" priorities rtol/atol
    1e-5; the rest as in emit_blocks), the stats (rtol 1e-6), and the
    probe's max |dQ| within 1e-5 and its greedy agreement exactly JAX's
    (tests/test_torch_quant.py's probe rule)."""
    from r2d2_tpu.models.network import make_inference_bundle as j_bundle
    from r2d2_tpu_torch.actor.policy import InferenceTwin
    from r2d2_tpu_torch.models.network import make_inference_bundle
    over = {"network.inference_dtype": "int8"}
    cfg, jcfg = small_cfg(**over), jax_cfg(**over)
    n, wv = 3, 7
    jenv = create_jax_env(jcfg.env)
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    jspec = JReplaySpec.from_config(jcfg)
    jnet, net = _jax_net(jcfg, env.action_dim), _port_net(cfg,
                                                          env.action_dim)
    jparams = jnet.init(jax.random.PRNGKey(0))
    twin = InferenceTwin(net, make_inference_bundle(
        net, _module_from(net, jparams).state_dict(), 1), "cpu")
    eps = [apex_epsilon(i, n, 0.4, 7.0) for i in range(n)]
    jcore = jax.jit(janakin.make_act_core(
        jenv, jnet, jspec, num_lanes=n, gamma=0.997, priority="td"))
    core = make_act_core(env, net, spec, gamma=0.997, priority="td")
    report = [e <= 0.02 for e in eps]
    jbundle = j_bundle(jnet, jparams, 1)

    key = jax.random.PRNGKey(1)
    jcarry = janakin.init_act_carry(jenv, jspec, n, key)
    k_env, _ = jax.random.split(key)
    carry = init_act_carry(env, spec, n, reset_draws=_jax_reset_draws(
        jenv, jax.random.split(k_env, n)))
    for seg in range(3):
        draws, _ = _jax_segment_draws(jenv, jcarry.key, n,
                                      spec.block_length, env.action_dim)
        jcarry, jblocks, jstats = jcore(
            jbundle, jcarry, np.int32(wv), jnp.asarray(eps, jnp.float32),
            jnp.asarray(report), jnp.arange(n, dtype=jnp.int32))
        carry, blocks, stats = core(
            twin, carry, torch.tensor(wv), torch.tensor(eps),
            torch.tensor(report), torch.arange(n, dtype=torch.int32), draws)
        _check_carry(carry, jcarry)
        check_blocks(blocks, jax.tree_util.tree_map(np.asarray, jblocks),
                     priority_rtol=1e-5, priority_atol=1e-5,
                     hidden_atol=1e-5)
        assert set(jstats) == set(stats) - {"end_state"}
        for name in ("episodes", "reported_episodes",
                     "reported_return_sum"):
            np.testing.assert_allclose(float(stats[name]),
                                       float(jstats[name]), rtol=1e-6,
                                       err_msg=name)
        assert abs(float(stats["quant_dq"])
                   - float(jstats["quant_dq"])) <= 1e-5
        assert float(stats["quant_agree"]) == float(jstats["quant_agree"])


def test_int8_act_segment_probes_outside_its_graph_and_adopts_in_place():
    """The quantized ActSegment: its core carries no probe (the graph's),
    ``probe()`` after a run equals the in-core probe of the same segment
    (eager twin, the same carry and draws), and a new twin adopted with
    ``load_`` keeps every address the segment reads."""
    from r2d2_tpu_torch.actor.policy import InferenceTwin
    from r2d2_tpu_torch.models.network import make_inference_bundle
    cfg = small_cfg(**{"network.inference_dtype": "int8"})
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    net = _port_net(cfg, env.action_dim)
    module = net.init(0)
    twin = InferenceTwin(net, make_inference_bundle(net, module, 1), "cpu")
    kw = dict(num_lanes=3, epsilons=[0.4, 0.1, 0.01], gamma=0.997,
              priority="td", near_greedy_eps=0.02)
    act = AnakinAct(env, net, spec, quant_probe_on=False, **kw)
    probing = AnakinAct(env, net, spec, **kw)
    gen = torch.Generator().manual_seed(3)
    carry = init_act_carry(env, spec, 3, generator=gen)
    twin_carry = dataclasses.replace(carry, **{
        f.name: getattr(carry, f.name).clone()
        for f in dataclasses.fields(carry) if f.name != "env_state"})
    twin_carry.env_state = dataclasses.replace(carry.env_state, **{
        f.name: getattr(carry.env_state, f.name).clone()
        for f in dataclasses.fields(carry.env_state)})
    seg = ActSegment(act, twin, carry, spec, tdr.replay_init(spec, "cpu"),
                     gen)
    draws = act.draw(torch.Generator().manual_seed(4))
    _, _, stats = probing(twin, twin_carry, 1, draws=draws)
    seg.act.draw = lambda generator: draws
    seg.run(1)
    assert "quant_dq" not in act.core(
        twin, twin_carry, torch.tensor(1), act.eps, act.report, act.lanes,
        draws)[2]
    probe = seg.probe()
    assert np.isfinite(probe["quant_dq"])
    assert probe["quant_dq"] == float(stats["quant_dq"])
    assert probe["quant_agree"] == float(stats["quant_agree"])
    before = seg._read()
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.01)
    twin.load_(make_inference_bundle(net, module, 2))
    assert seg._read() == before and twin.stamp == 2


def test_int8_fused_loop_trains_with_a_quant_block(tmp_path):
    """cli.train --actor.on_device=true --network.inference_dtype=int8 on
    the CPU: it trains, the twin is re-adopted as the pseudo publish count
    ticks (the quant block's publish stamp advances), the probe runs every
    telemetry.quant_probe_interval-th segment."""
    cfg = small_cfg(**{
        "network.inference_dtype": "int8",
        "telemetry.quant_probe_interval": 2,
        "replay.capacity": 400, "replay.learning_starts": 60,
        "actor.anakin_lanes": 2, "env.episode_len": 20,
        "replay.block_length": 10, "replay.batch_size": 4,
        "runtime.save_dir": str(tmp_path), "runtime.log_interval": 0.0,
        "runtime.weight_publish_interval": 2,
    })
    records = []
    stack = orchestrator.train(cfg, max_training_steps=8, max_seconds=120,
                               device="cpu", log_fn=records.append)
    lr = stack.learner
    assert lr.training_steps >= 8 and all(np.isfinite(lr.losses))
    quant = [r["quant"] for r in records]
    assert quant and all(q["dtype"] == "int8" for q in quant)
    assert sum(q["probes"] for q in quant) == stack.segment.calls // 2 >= 2
    assert stack.twin_ms and max(q["publish_stamp"] for q in quant) >= 2
    assert all(q["dq_max"] is None or q["dq_max"] < 1.0 for q in quant)


# ---- the ring write, the report filter ----------------------------------


def _act(cfg: Config, n: int, seed: int = 1):
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    net = _port_net(cfg, env.action_dim)
    eps = [apex_epsilon(i, n, cfg.actor.base_eps, cfg.actor.eps_alpha)
           for i in range(n)]
    act = AnakinAct(env, net, spec, num_lanes=n, epsilons=eps,
                    gamma=cfg.optim.gamma, priority=cfg.actor.anakin_priority,
                    near_greedy_eps=cfg.actor.near_greedy_eps)
    gen = torch.Generator().manual_seed(seed)
    return env, spec, net.init(0), act, gen


def test_act_segment_ring_write_equals_adds_one_at_a_time():
    """Two segments of three lanes into a five-row ring (the second
    wraps): the replay state equals six replay_add calls of the same
    blocks, the host pointer advances, and the static carry moves on."""
    cfg = small_cfg(**{"replay.capacity": 100})
    n = 3
    env, spec, module, act, gen = _act(cfg, n)
    carry = init_act_carry(env, spec, n, generator=gen)
    rs = tdr.replay_init(spec, "cpu")
    seg = ActSegment(act, module, carry, spec, rs, gen)
    want = tdr.replay_init(spec, "cpu")
    stack0 = carry.cur_stack.clone()
    for wv in (3, 4):
        seg.run(wv)
        for i in range(n):
            tdr.replay_add(spec, want, _lane(seg.blocks, i))
        assert (_np(seg.blocks.weight_version) == wv).all()
    assert seg.carry is carry and not torch.equal(carry.cur_stack, stack0)
    assert rs.block_ptr == want.block_ptr == 6 % spec.num_blocks
    for name, value in vars(want).items():
        got = getattr(rs, name)
        if torch.is_tensor(value):
            assert torch.equal(got, value), name
    stats = seg.take_stats()
    assert stats["episodes"] == n and seg.take_stats()["episodes"] == 0
    assert seg.graph is None and seg.calls == 2


def test_act_segment_draws_anew_and_reproduces_from_a_seed():
    """Each segment draws from the generator anew; the same seed gives
    the same blocks."""
    cfg = small_cfg()
    runs = []
    for _ in range(2):
        env, spec, module, act, gen = _act(cfg, 3, seed=5)
        carry = init_act_carry(env, spec, 3, generator=gen)
        seg = ActSegment(act, module, carry, spec,
                         tdr.replay_init(spec, "cpu"), gen)
        seg.run(1)
        first = (seg.draws.explore.clone(), seg.blocks.obs_row.clone())
        seg.run(1)
        assert not torch.equal(seg.draws.explore, first[0])
        runs.append(first[1])
    assert torch.equal(runs[0], runs[1])


def test_act_near_greedy_report_filter():
    """Only lanes at eps <= near_greedy_eps report episode returns, and
    the stats sum exactly those lanes."""
    cfg = small_cfg()
    n = 4
    env, spec, module, act, gen = _act(cfg, n)
    reporting = int(act.report.sum())
    assert 0 < reporting < n            # the ladder straddles the threshold
    carry = init_act_carry(env, spec, n, generator=gen)
    carry, _, _ = act(module, carry, 1, generator=gen)       # mid-episode
    carry, blocks, stats = act(module, carry, 1, generator=gen)
    assert int(stats["episodes"]) == n
    assert int(stats["reported_episodes"]) == reporting
    sr = _np(blocks.sum_reward)
    assert np.isfinite(sr).sum() == reporting
    np.testing.assert_allclose(float(stats["reported_return_sum"]),
                               float(np.nansum(sr)), rtol=1e-5)
    # a fresh episode: zero hidden, no last action, the reset frame stacked
    assert (carry.hidden == 0).all() and (carry.last_action == -1).all()
    assert (carry.burn0 == 0).all()
    torch.testing.assert_close(carry.tail_frames[:, spec.burn_in:],
                               carry.cur_stack, rtol=0, atol=0)


# ---- config, routing, the loop ------------------------------------------


def test_config_knobs_roundtrip_and_cli():
    cfg = small_cfg(**{"actor.anakin_lanes": 5,
                       "actor.anakin_scans_per_train": 2,
                       "actor.anakin_priority": 0.5, "env.grid_size": 4})
    again = Config.from_dict(json.loads(cfg.to_json()))
    assert again == cfg and again.actor.anakin_priority == 0.5
    assert Config.from_dict(json.loads(small_cfg(**{
        "actor.anakin_priority": "td"}).to_json())).actor.anakin_priority \
        == "td"
    # a config written before these knobs loads with the defaults
    d = Config().to_dict()
    for key in ("on_device", "anakin_lanes", "anakin_scans_per_train",
                "anakin_priority"):
        d["actor"].pop(key)
    d["env"].pop("grid_size")
    old = Config.from_dict(d)
    assert old.actor.on_device is False and old.actor.anakin_lanes == 64
    assert old.env.grid_size == 6 and old.actor.anakin_priority == 1.0
    parsed = parse_overrides(Config(), [
        "--actor.on_device=true", "--actor.anakin_priority=td",
        "--replay.block_length=120", "--replay.capacity=120000",
        "--env.grid_size=5"])
    assert parsed.actor.on_device and parsed.actor.anakin_priority == "td"
    assert parse_overrides(Config(), ["--actor.anakin_priority=0.5"]
                           ).actor.anakin_priority == 0.5
    # knobs of parts the port does not have stay unknown fields
    for arg in ("--multiplayer.enabled=true", "--actor.fault_spec=x"):
        with pytest.raises(SystemExit):
            parse_overrides(Config(), [arg])
    # multihost is a field now: on-device acting under it is refused, as
    # the JAX package refuses it
    with pytest.raises(ValueError, match="single-controller only"):
        parse_overrides(Config(), [
            "--actor.on_device=true", "--replay.block_length=120",
            "--replay.capacity=120000", "--mesh.multihost=true"])
    # a quantized forward on the device is accepted (the twin acts)
    for dtype in ("int8", "bf16"):
        quant = parse_overrides(Config(), [
            "--actor.on_device=true", "--replay.block_length=120",
            "--replay.capacity=120000",
            f"--network.inference_dtype={dtype}"])
        assert quant.actor.on_device
        assert quant.network.inference_dtype == dtype


def test_config_validates_on_device_preconditions():
    """The JAX package's rules, where the port has them."""
    for bad, match in ((("env.episode_len", 30), "multiple of"),
                       (("actor.anakin_lanes", 41), "num_blocks"),
                       (("replay.placement", "host"), "placement"),
                       (("actor.anakin_priority", 0.0), "anakin_priority"),
                       (("actor.anakin_priority", "tdx"), "anakin_priority"),
                       (("actor.anakin_scans_per_train", 0),
                        "anakin_scans_per_train"),
                       (("actor.anakin_lanes", 0), "anakin_lanes"),
                       (("env.grid_size", 13), "grid_size"),
                       (("env.grid_size", 1), "grid_size")):
        with pytest.raises(ValueError, match=match):
            small_cfg(**{bad[0]: bad[1]})
        with pytest.raises(ValueError, match=match):
            jax_cfg(**{bad[0]: bad[1]})
    # the on-device preconditions do not bind while it is off
    off = small_cfg(**{"actor.on_device": False, "env.episode_len": 30,
                       "actor.anakin_lanes": 41,
                       "replay.placement": "host"})
    assert not off.actor.on_device


def test_on_device_routes_before_any_actor_or_env(monkeypatch):
    """actor.on_device delegates in orchestrator.train before the env
    probe (or any actor, queue or weight service); off, the delegation
    never fires and the host-actor path starts with its probe."""
    sentinel = object()
    called = {}

    def fake_run(cfg, **kw):
        called.update(cfg=cfg, **kw)
        return sentinel

    class ProbeReached(Exception):
        pass

    def probe(*args, **kwargs):
        raise ProbeReached

    monkeypatch.setattr(anakin_loop, "run_anakin_train", fake_run)
    monkeypatch.setattr(orchestrator, "create_env", probe)
    assert orchestrator.train(small_cfg(), max_training_steps=1,
                              device="cpu") is sentinel
    assert called["cfg"].actor.on_device and called["device"] == "cpu"

    def boom(cfg, **kw):
        raise AssertionError("anakin loop reached with on_device=False")

    monkeypatch.setattr(anakin_loop, "run_anakin_train", boom)
    with pytest.raises(ProbeReached):
        orchestrator.train(small_cfg(**{"actor.on_device": False}),
                           max_training_steps=1, device="cpu")


@pytest.mark.parametrize("game,priority", [("Fake", 1.0), ("Grid", "td")])
def test_anakin_loop_trains_end_to_end(tmp_path, game, priority):
    """The fused loop through orchestrator.train on the CPU: acting
    segments fill the device replay, the gate opens, steps train, records
    carry the anakin block, checkpoints are written, and no thread or
    process is started (tests/test_anakin.py's shape)."""
    cfg = small_cfg(**{
        "env.game_name": game, "env.grid_size": 4,
        "actor.anakin_priority": priority,
        "replay.capacity": 400, "replay.learning_starts": 60,
        "actor.anakin_lanes": 2, "env.episode_len": 20,
        "replay.block_length": 10, "replay.batch_size": 4,
        "runtime.save_dir": str(tmp_path), "runtime.log_interval": 0.0,
        "runtime.save_interval": 4,
    })
    threads = threading.active_count()
    records = []
    stack = orchestrator.train(cfg, max_training_steps=6, max_seconds=120,
                               device="cpu", log_fn=records.append)
    assert threading.active_count() == threads
    assert stack.processes == [] and stack.threads == []
    lr = stack.learner
    assert lr.training_steps >= 6 and lr.env_steps >= 60
    assert lr.ring.buffer_steps > 0
    assert stack.metrics.ingest_blocks_total == stack.segment.calls * 2
    assert stack.segment.graph is None      # eager on the CPU
    assert lr.replay_state.block_ptr == lr.ring.ptr
    assert records and records[-1]["buffer_size"] > 0
    anakin = [r["anakin"] for r in records if "anakin" in r]
    assert anakin and anakin[0]["lanes_per_shard"] == 2
    assert all(np.isfinite(lr.losses))
    assert (tmp_path / f"{game}0_player0").exists()


def test_anakin_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        anakin_loop.run_anakin_train(small_cfg(), max_training_steps=1)
    with pytest.raises(ValueError, match="on_device"):
        anakin_loop.run_anakin_train(small_cfg(**{"actor.on_device": False}),
                                     device="cpu")


# ---- the slice as a whole ------------------------------------------------


def test_act_ring_write_and_learner_step_match_jax():
    """From JAX's weights (models/convert.py) and the draws of its keys:
    one act segment of three lanes, its ring write (the port's device
    blocks straight into replay_add_many) and one learner step with JAX's
    jitter, against JAX's act, replay_add_many and learner step: the
    replay state equal (the tree rtol 2e-5), the loss rtol 1e-5, the
    params after Adam atol 1e-5, the tree after the write-back rtol
    2e-5."""
    cfg, jcfg = small_cfg(), jax_cfg()
    n = 3
    jenv = create_jax_env(jcfg.env)
    env = create_device_env(cfg.env, "cpu")
    spec = ReplaySpec.from_config(cfg, "cpu")
    jspec = JReplaySpec.from_config(jcfg)
    jnet, net = _jax_net(jcfg, 6), _port_net(cfg, 6)
    jts = j_create(jax.random.PRNGKey(0), jnet, jcfg.optim)
    module = _module_from(net, jts.params)
    eps = [apex_epsilon(i, n, 0.4, 7.0) for i in range(n)]
    jact = janakin.make_anakin_act(
        jenv, jnet, jspec, num_lanes=n, epsilons=eps, gamma=cfg.optim.gamma,
        priority=1.0, near_greedy_eps=0.02)
    key = jax.random.PRNGKey(3)
    jcarry = janakin.init_act_carry(jenv, jspec, n, key)
    k_env, _ = jax.random.split(key)
    reset = _jax_reset_draws(jenv, jax.random.split(k_env, n))
    draws, _ = _jax_segment_draws(jenv, jcarry.key, n, spec.block_length, 6)
    jcarry, jblocks, _ = jact(jts.params, jcarry, np.int32(1))
    jstate = jdr.replay_add_many(jspec, jdr.replay_init(jspec), jblocks)
    jwritten = jax.tree_util.tree_map(np.asarray, jstate)
    _, base = jax.random.split(jts.key)
    jitter = np.asarray(jax.random.uniform(
        jax.random.fold_in(base, 0), (spec.batch_size,), jnp.float32))
    jts, jstate2, jm = j_step(jnet, jspec, jcfg.optim, False)(jts, jstate)

    act = AnakinAct(env, net, spec, num_lanes=n, epsilons=eps,
                    gamma=cfg.optim.gamma, priority=1.0, near_greedy_eps=0.02)
    carry = init_act_carry(env, spec, n, reset_draws=reset)
    carry, blocks, _ = act(module, carry, 1, draws=draws)
    rs = tdr.replay_add_many(spec, tdr.replay_init(spec, "cpu"), blocks)
    for name, value in vars(rs).items():
        want = getattr(jwritten, name)
        if name == "tree":
            np.testing.assert_allclose(_np(value), want, rtol=2e-5)
        elif not torch.is_tensor(value):
            assert value == int(want), name
        elif value.is_floating_point():
            np.testing.assert_allclose(_np(value), want, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(_np(value), want, err_msg=name)
    ts = TrainState(params=module, target_params=module,
                    opt=make_optimizer(cfg.optim, module), step=0,
                    generator=torch.Generator())
    ts, rs, m = make_learner_step(net, spec, cfg.optim, False)(
        ts, rs, torch.from_numpy(jitter.copy()))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jts.params))
    for name, value in ts.params.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(rs.tree.numpy(), np.asarray(jstate2.tree),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.slow
def test_grid_learnability_under_the_fused_loop(tmp_path):
    """The gridworld learns under the port's fused loop on the CPU, with
    the JAX test's configuration and threshold, early over the episodes
    before training and late over those of its last quarter
    (tools/learnability.py grid_config, check_grid_returns)."""
    cfg = learnability.grid_config(str(tmp_path))
    result = learnability.grid_train(cfg, device="cpu")
    assert result["training_steps"] >= learnability.GRID_TRAIN_STEPS
    learnability.check_grid_returns(result["intervals"],
                                    cfg.replay.learning_starts)
