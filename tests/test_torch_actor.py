"""The port's acting side against the JAX package's on the CPU: the
shared acting forward and both policies on converted weights (f32, atol
1e-5; actions equal wherever the Q gap exceeds 1e-5, epsilon draws from
the same numpy streams), the Ape-X epsilon ladders, the vector env and
the wrappers (bit-equal), the actor loops' blocks against JAX's, and the
vector loop at one lane against the scalar loop."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from r2d2_tpu.actor.policy import ActorPolicy as JActorPolicy
from r2d2_tpu.actor.policy import BatchedActorPolicy as JBatchedActorPolicy
from r2d2_tpu.actor.policy import make_forward_fn as j_make_forward_fn
from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.config import apex_epsilon as j_apex_epsilon
from r2d2_tpu.config import vector_lane_epsilons as j_lane_epsilons
from r2d2_tpu.envs import wrappers as jwrappers
from r2d2_tpu.envs.fake import FakeR2D2Env as JFakeEnv
from r2d2_tpu.envs.vector import make_vector_env as j_make_vector_env
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu.runtime.actor_loop import run_actor as j_run_actor
from r2d2_tpu_torch.actor.policy import (ActorPolicy, BatchedActorPolicy,
                                         make_forward_fn)
from r2d2_tpu_torch.config import (ActorConfig, Config, apex_epsilon,
                                   vector_lane_epsilons)
from r2d2_tpu_torch.envs import wrappers
from r2d2_tpu_torch.envs.factory import create_env
from r2d2_tpu_torch.envs.fake import FakeR2D2Env
from r2d2_tpu_torch.envs.vector import SyncVectorEnv, make_vector_env
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.actor_loop import run_actor, run_vector_actor
from r2d2_tpu_torch.runtime.weights import flat_parameters

pytestmark = pytest.mark.torch_port

A = 6
SMALL = {
    "env.game_name": "Fake", "env.frame_height": 24, "env.frame_width": 24,
    "env.frame_stack": 2, "network.hidden_dim": 16,
    "network.cnn_out_dim": 32, "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3, "replay.capacity": 800,
    "replay.block_length": 20, "replay.batch_size": 8,
    "replay.learning_starts": 100, "actor.actor_update_interval": 50}
EXACT_FIELDS = {"action", "last_action_row", "obs_row", "seq_start",
                "burn_in_steps", "learning_steps", "forward_steps",
                "num_sequences", "lane", "weight_version"}
GAP = 1e-5


def nets(seed: int = 0):
    """(JAX cfg, JAX net, JAX params, port cfg, port net, port module)
    with the same weights."""
    jcfg = JConfig().replace(**SMALL)
    cfg = Config().replace(**SMALL)
    jnet = JNetworkApply(A, jcfg.network, 2, 24, 24)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    module = net.build()
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jcfg, jnet, jparams, cfg, net, module


def assert_greedy_equal(got, want, q) -> None:
    """Equal actions wherever the top two Q-values are GAP apart."""
    top2 = np.sort(np.asarray(q), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    assert clear.any()
    np.testing.assert_array_equal(np.asarray(got)[clear],
                                  np.asarray(want)[clear])


@pytest.mark.parametrize("lanes", [1, 5])
def test_forward_fn_matches_jax(rng, lanes):
    """The (N, 1) acting forward on converted weights: Q and hidden within
    atol 1e-5, greedy actions equal; last action -1 is a zero one-hot."""
    _, jnet, jparams, _, net, module = nets()
    obs = rng.uniform(size=(lanes, 24, 24, 2)).astype(np.float32)
    la = rng.integers(-1, A, lanes).astype(np.int32)
    hidden = rng.normal(size=(lanes, 2, 16)).astype(np.float32)
    ja, jq, jh = j_make_forward_fn(jnet)(jparams, obs, la, hidden)
    ta, tq, th = make_forward_fn(net)(module, obs, la, hidden)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    assert_greedy_equal(ta.numpy(), ja, jq)


@pytest.mark.parametrize("batched", [False, True])
def test_policies_act_like_jax(batched):
    """Both policies on a Fake env stream at epsilon 0.3 (scalar) or the
    lane ladder (batched): the same epsilon draws (numpy streams of the
    same seeds), Q and hidden within 1e-5, actions equal where the greedy
    choice is clear; the envs step on JAX's actions. A flat host snapshot
    of the weights acts like the module it was taken from."""
    _, jnet, jparams, _, net, module = nets()
    lanes = 3 if batched else 1
    envs = [FakeR2D2Env(height=24, width=24, seed=5 + i)
            for i in range(lanes)]
    if batched:
        eps = [0.3, 0.05, 0.6]
        jpol = JBatchedActorPolicy(jnet, jparams, eps, seeds=[1, 2, 3])
        pols = [BatchedActorPolicy(net, params, eps, seeds=[1, 2, 3])
                for params in (module, flat_parameters(module))]
        for p in [jpol] + pols:
            for i, env in enumerate(envs):
                p.observe_reset_lane(i, FakeR2D2Env(
                    height=24, width=24, seed=5 + i).reset())
    else:
        jpol = JActorPolicy(jnet, jparams, 0.3, seed=4)
        pols = [ActorPolicy(net, params, 0.3, seed=4)
                for params in (module, flat_parameters(module))]
        for p in [jpol] + pols:
            p.observe_reset(FakeR2D2Env(height=24, width=24, seed=5).reset())
    for env in envs:
        env.reset()
    for _ in range(40):
        ja, jq, jh = jpol.act()
        for pol in pols:
            ta, tq, th = pol.act()
            np.testing.assert_allclose(tq, np.asarray(jq), atol=1e-5)
            np.testing.assert_allclose(th, np.asarray(jh), atol=1e-5)
            assert_greedy_equal(np.atleast_1d(ta), np.atleast_1d(ja),
                                np.atleast_2d(jq))
        if batched:
            obs = np.stack([env.step(int(a))[0] for env, a in zip(envs, ja)])
        else:
            obs = envs[0].step(int(ja))[0]
        for p in [jpol] + pols:
            p.observe(obs, ja)
    np.testing.assert_allclose(pols[0].bootstrap_q(), np.asarray(
        jpol.bootstrap_q()), atol=1e-5)


def test_epsilon_ladders_match_jax():
    for n in (1, 2, 5, 16):
        for i in range(n):
            for base, alpha in ((0.4, 7.0), (0.1, 3.0)):
                assert apex_epsilon(i, n, base, alpha) == \
                    j_apex_epsilon(i, n, base, alpha)
    from r2d2_tpu.config import ActorConfig as JActorConfig
    for actors, k in ((1, 1), (2, 4), (4, 3)):
        ours = ActorConfig(num_actors=actors, envs_per_actor=k)
        theirs = JActorConfig(num_actors=actors, envs_per_actor=k)
        for idx in range(actors):
            assert vector_lane_epsilons(idx, ours) == \
                j_lane_epsilons(idx, theirs)
        assert vector_lane_epsilons(0, ours, total_actors=actors + 2) == \
            j_lane_epsilons(0, theirs, total_actors=actors + 2)
    with pytest.raises(ValueError, match="outside the fleet"):
        vector_lane_epsilons(2, ActorConfig(num_actors=2))


def test_vector_env_and_wrappers_match_jax(rng):
    """make_vector_env over the Fake env (per-lane seeds, auto-reset,
    episode accounting) and the wrappers on an RGB engine stand-in:
    bit-equal to the JAX package's."""
    jcfg = JConfig().replace(**{**SMALL, "env.episode_len": 7})
    cfg = Config().replace(**{**SMALL, "env.episode_len": 7})
    ours = make_vector_env(cfg.env, 3, seed=11)
    theirs = j_make_vector_env(jcfg.env, 3, seed=11)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    for _ in range(16):
        actions = rng.integers(0, A, 3)
        a, b = ours.step(actions), theirs.step(actions)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        for ia, ib in zip(a[3], b[3]):
            assert ia.keys() == ib.keys()
            for key in ia:
                np.testing.assert_array_equal(ia[key], ib[key])
        np.testing.assert_array_equal(ours.episode_steps, theirs.episode_steps)
    assert isinstance(ours, SyncVectorEnv)

    class Rgb:
        """An engine stand-in: RGB frames of 50x40, rewards in [-3, 3]."""
        action_space = FakeR2D2Env().action_space

        def __init__(self):
            self.rng = np.random.default_rng(3)

        def reset(self):
            return self.rng.integers(0, 256, (50, 40, 3)).astype(np.uint8)

        def step(self, action):
            return (self.reset(), float(self.rng.uniform(-3, 3)), False, {})

        def close(self):
            pass

    def stack(mod):
        env = mod.ClipReward(mod.WarpFrame(Rgb(), 24, 24))
        return mod.NoopReset(env, noop_max=5, seed=2)

    ours, theirs = stack(wrappers), stack(jwrappers)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    for action in range(8):
        a, b = ours.step(action % A), theirs.step(action % A)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:3] == b[1:3] and -1.0 <= a[1] <= 1.0
    assert isinstance(ours.unwrapped, Rgb)


def test_create_env_names_missing_engines():
    """Engines that are not installed raise and name themselves; the
    on-device ids resolve to the host adapter over the device envs, and
    the device factory names what it cannot build."""
    from r2d2_tpu_torch.envs.device_env import HostDeviceEnv
    from r2d2_tpu_torch.envs.factory import create_device_env
    cfg = Config()
    assert isinstance(create_env(cfg.env, seed=1), FakeR2D2Env)
    for game, engine in (("Vizdoom", "ViZDoom"), ("ALE/Boxing", "gymnasium")):
        bad = dataclasses.replace(cfg.env, game_name=game)
        with pytest.raises((ImportError, ValueError), match=engine):
            create_env(bad)
    assert isinstance(create_env(dataclasses.replace(cfg.env,
                                                     game_name="Grid")),
                      HostDeviceEnv)
    with pytest.raises(ValueError, match="on-device"):
        create_device_env(dataclasses.replace(cfg.env, game_name="Vizdoom"),
                          "cpu")


def _blocks_equal(got, want, atol=1e-5):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in dataclasses.fields(a):
            x = np.asarray(getattr(a, f.name))
            y = np.asarray(getattr(b, f.name))
            if f.name in EXACT_FIELDS:
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                np.testing.assert_allclose(x, y, atol=atol, rtol=0,
                                           equal_nan=True, err_msg=f.name)


def test_run_actor_blocks_match_jax():
    """The scalar loop, greedy, on the same env seed and converted
    weights: the same blocks as the JAX package's run_actor (integer
    fields bit-equal, Q-derived fields and hiddens within 1e-5)."""
    jcfg, jnet, jparams, cfg, net, module = nets()
    jblocks, blocks = [], []
    j_run_actor(jcfg, JFakeEnv(height=24, width=24, seed=7),
                JActorPolicy(jnet, jparams, 0.0, seed=7), jblocks.append,
                lambda: None, lambda: False, max_env_steps=100)
    run_actor(cfg, FakeR2D2Env(height=24, width=24, seed=7),
              ActorPolicy(net, module, 0.0, seed=7), blocks.append,
              lambda: None, lambda: False, max_env_steps=100)
    _blocks_equal(blocks, [dataclasses.replace(b) for b in jblocks])


def test_run_vector_actor_one_lane_matches_run_actor():
    """At one lane the vector loop emits the scalar loop's blocks (same
    seed, greedy)."""
    *_, cfg, net, module = nets()
    scalar, vector = [], []
    assert run_actor(cfg, FakeR2D2Env(height=24, width=24, seed=7),
                     ActorPolicy(net, module, 0.0, seed=7), scalar.append,
                     lambda: None, lambda: False, max_env_steps=100) == 100
    venv = SyncVectorEnv([FakeR2D2Env(height=24, width=24, seed=7)])
    assert run_vector_actor(cfg, venv,
                            BatchedActorPolicy(net, module, [0.0], seeds=[7]),
                            vector.append, lambda: None, lambda: False,
                            max_env_steps=100) == 100
    assert len(scalar) == 5
    _blocks_equal(vector, scalar, atol=3e-6)


def test_policy_weight_intake():
    """A policy takes a module or a flat snapshot in parameters() order;
    copy_updates=False adopts the snapshot's storage, a wrong length
    raises."""
    *_, net, module = nets()
    other = nets(seed=3)[-1]
    policy = ActorPolicy(net, module, 0.0, copy_updates=False)
    flat = flat_parameters(other)
    policy.update_params(flat)
    np.testing.assert_array_equal(flat_parameters(policy.module), flat)
    first = next(policy.module.parameters())
    assert first.data_ptr() == torch.from_numpy(flat).data_ptr()
    copying = ActorPolicy(net, module, 0.0)
    copying.update_params(flat)
    assert next(copying.module.parameters()).data_ptr() != \
        torch.from_numpy(flat).data_ptr()
    with pytest.raises(ValueError, match="float32 vector"):
        policy.update_params(flat[:-1])


@pytest.mark.parametrize("lanes", [1, 2])
def test_actor_profile_accounts_for_the_tick(lanes):
    """tools/actor_profile.py runs one actor loop and splits its tick into
    parts that add up to the wall time; blocks cross the shm ring; the
    forward's operators are listed; the intra-op thread count is
    restored."""
    from r2d2_tpu_torch.tools.actor_profile import profile_actor
    threads = torch.get_num_threads()
    cfg = Config().replace(**{**SMALL, "actor.envs_per_actor": lanes})
    result = profile_actor(cfg, seconds=1.0, threads=1, ops=5)
    assert torch.get_num_threads() == threads
    assert result["ticks"] > 0 and result["blocks"] > 0
    assert result["env_steps"] == result["ticks"] * lanes
    parts = result["parts_ms_per_tick"]
    assert {"act", "env", "observe", "buffer_add", "send"} <= set(parts)
    assert sum(parts.values()) == pytest.approx(result["ms_per_tick"])
    assert parts["rest"] >= 0
    assert 0 < len(result["forward_ops"]) <= 5
