"""The port's on-device envs (envs/device_env.py) against the JAX
package's jitted envs (envs/jax_env.py) and the host Fake env, step for
step with the same actions and, for the gridworld, the draws that JAX's
keys give; the factory's routing of the on-device ids; and the host
adapter under the vector env."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2d2_tpu.envs.jax_env import JaxFakeEnv, JaxGridWorld
from r2d2_tpu_torch.config import EnvConfig
from r2d2_tpu_torch.envs.device_env import (DeviceFakeEnv, DeviceGridWorld,
                                            HostDeviceEnv, is_grid_id)
from r2d2_tpu_torch.envs.factory import create_device_env, create_env
from r2d2_tpu_torch.envs.fake import FakeR2D2Env
from r2d2_tpu_torch.envs.vector import make_vector_env

pytestmark = pytest.mark.torch_port


def test_device_fake_env_matches_jax_and_host_step_for_step():
    """Two lanes driven with the host envs' schedules and the same
    actions: obs, reward and done equal the host FakeR2D2Env's and
    JaxFakeEnv's exactly, for a whole episode and the terminal frame."""
    length, seeds = 30, (7, 8)
    hosts = [FakeR2D2Env(height=24, width=24, episode_len=length, seed=s)
             for s in seeds]
    jenv = JaxFakeEnv(episode_len=length, height=24, width=24)
    denv = DeviceFakeEnv(episode_len=length, height=24, width=24)
    schedules = np.stack([h._schedule for h in hosts])
    jstate = jax.vmap(jenv.state_from_schedule)(jnp.asarray(schedules))
    state = denv.state_from_schedule(schedules)
    jstep = jax.jit(jax.vmap(jenv.step))

    obs = denv.obs(state).numpy()
    for i, h in enumerate(hosts):
        np.testing.assert_array_equal(obs[i], h.reset())
    np.testing.assert_array_equal(obs, np.asarray(
        jax.vmap(jenv._obs)(jstate["schedule"], jstate["t"])))
    rng = np.random.default_rng(0)
    for t in range(length):
        a = rng.integers(6, size=2)
        state, o, r, d = denv.step(state, torch.from_numpy(a))
        jstate, jo, jr, jd = jstep(jstate, jnp.asarray(a, jnp.int32),
                                   jax.random.split(jax.random.PRNGKey(t), 2))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo),
                                      err_msg=f"t={t}")
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        for i, h in enumerate(hosts):
            ho, hr, hd, _ = h.step(int(a[i]))
            np.testing.assert_array_equal(o[i].numpy(), ho)
            assert float(r[i]) == hr and bool(d[i]) == hd
    assert d.all()          # the fixed-length episode ends at episode_len
    # reset takes its schedule draws as they are
    state, obs = denv.reset(torch.from_numpy(schedules))
    np.testing.assert_array_equal(obs.numpy()[0], hosts[0].reset())


def _grid_reset_draws(keys, size):
    """The raw (agent, goal) cells JaxGridWorld.reset draws from each
    lane's key, before its nudge."""
    def one(key):
        kp, kg = jax.random.split(key)
        return jnp.stack([jax.random.randint(kp, (2,), 0, size, jnp.int32),
                          jax.random.randint(kg, (2,), 0, size, jnp.int32)])
    return torch.from_numpy(np.array(jax.vmap(one)(keys)))


def test_device_grid_matches_jax_with_injected_draws():
    """64 lanes of a 4x4 grid on 16x16 frames for two episodes, with the
    cells JAX's keys draw injected and random actions: states, obs,
    rewards and done equal JaxGridWorld's exactly. The run has goal hits,
    respawn draws that land on the goal (nudged off), resets whose goal
    draw is the agent's cell (nudged off) and moves clipped at the
    edges."""
    size, length, n = 4, 10, 64
    jenv = JaxGridWorld(size=size, episode_len=length, height=16, width=16)
    denv = DeviceGridWorld(size=size, episode_len=length, height=16,
                           width=16)
    jreset, jstep = jax.jit(jax.vmap(jenv.reset)), jax.jit(
        jax.vmap(jenv.step))
    randint = jax.jit(jax.vmap(
        lambda k: jax.random.randint(k, (2,), 0, size, jnp.int32)))
    rng = np.random.default_rng(1)
    seen = dict(hits=0, respawn_clash=0, reset_clash=0, clipped=0)
    for episode in range(2):
        keys = jax.random.split(jax.random.PRNGKey(10 + episode), n)
        jstate, jobs = jreset(keys)
        draws = _grid_reset_draws(keys, size)
        seen["reset_clash"] += int((draws[:, 0] == draws[:, 1]).all(-1).sum())
        state, obs = denv.reset(draws)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(state.goal.numpy(),
                                      np.asarray(jstate["goal"]))
        np.testing.assert_array_equal(state.pos.numpy(),
                                      np.asarray(jstate["pos"]))
        for t in range(length):
            a = rng.integers(5, size=n)
            keys = jax.random.split(jax.random.PRNGKey(100 * episode + t), n)
            cells = torch.from_numpy(np.array(randint(keys)))
            goal = state.goal.clone()
            moved = state.pos + torch.tensor(
                [[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]])[a]
            seen["clipped"] += int(((moved < 0) | (moved >= size))
                                   .any(-1).sum())
            state, obs, reward, done = denv.step(state, torch.from_numpy(a),
                                                 cells)
            jstate, jobs, jr, jd = jstep(jstate, jnp.asarray(a, jnp.int32),
                                         keys)
            hit = reward > 0
            seen["hits"] += int(hit.sum())
            seen["respawn_clash"] += int(
                (hit & (cells == goal).all(-1)).sum())
            np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs),
                                          err_msg=f"ep {episode} t={t}")
            np.testing.assert_array_equal(state.pos.numpy(),
                                          np.asarray(jstate["pos"]))
            np.testing.assert_array_equal(reward.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(done.numpy(), np.asarray(jd))
            # the agent never sits on the goal after a step
            assert not (state.pos == state.goal).all(-1).any()
        assert done.all()
    assert all(v > 0 for v in seen.values()), seen


def test_factory_routes_the_device_env_ids():
    """"Grid", "JaxGrid*" and "JaxFake" go to the host adapter over the
    device envs, plain "Fake" keeps the host numpy env; the device
    factory resolves "Fake" too, and refuses an engine id. "GridWorld" is
    not a grid id (it routes to gymnasium, not installed here)."""
    cfg = EnvConfig(game_name="Grid", frame_height=12, frame_width=12,
                    grid_size=4, episode_len=40)
    for name, action_dim in (("Grid", 5), ("JaxGrid7", 5), ("JaxFake", 6)):
        env = create_env(dataclasses.replace(cfg, game_name=name), seed=0)
        assert isinstance(env, HostDeviceEnv) and env.action_space.n == \
            action_dim, name
        obs = env.reset()
        assert obs.shape == (12, 12) and obs.dtype == np.uint8
        obs2, r, d, info = env.step(1)
        assert obs2.shape == (12, 12) and isinstance(r, float) and not d
        env.close()
    assert isinstance(create_env(dataclasses.replace(cfg, game_name="Fake")),
                      FakeR2D2Env)
    grid = create_device_env(cfg, "cpu")
    assert isinstance(grid, DeviceGridWorld) and grid.size == 4
    assert grid.episode_len == 40 and grid.height == 12
    assert isinstance(create_device_env(
        dataclasses.replace(cfg, game_name="Fake"), "cpu"), DeviceFakeEnv)
    with pytest.raises(ValueError, match="no on-device implementation"):
        create_device_env(dataclasses.replace(cfg, game_name="Vizdoom"),
                          "cpu")
    assert is_grid_id("Grid") and is_grid_id("JaxGrid")
    assert not is_grid_id("GridWorld")
    with pytest.raises(ImportError, match="gymnasium"):
        create_env(dataclasses.replace(cfg, game_name="GridWorld"))


def test_host_device_env_under_the_vector_env():
    """Three grid lanes through envs/vector.py: the done step reports the
    terminal frame, the episode's steps and return, and the auto-reset
    frame; seeds give each lane its own stream, the same seed the same
    one."""
    cfg = EnvConfig(game_name="Grid", frame_height=12, frame_width=12,
                    grid_size=4, episode_len=6)
    vec = make_vector_env(cfg, 3, seed=5)
    again = make_vector_env(cfg, 3, seed=5)
    first = vec.reset()
    np.testing.assert_array_equal(first, again.reset())
    assert first.shape == (3, 12, 12)
    assert len({first[i].tobytes() for i in range(3)}) > 1
    for t in range(6):
        obs, rewards, dones, infos = vec.step(np.array([1, 3, 4]))
        o2, r2, _, _ = again.step(np.array([1, 3, 4]))
        np.testing.assert_array_equal(obs, o2)
        np.testing.assert_array_equal(rewards, r2)
    assert dones.all()
    for info in infos:
        assert info["episode_steps"] == 6
        assert info["reset_obs"].shape == (12, 12)
    vec.close()
    again.close()
