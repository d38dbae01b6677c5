"""The port's evaluation CLI on the CPU: a port checkpoint made from
converted JAX weights scores the return the JAX package's
``rollout_episode`` gives with those weights on the Fake env (greedy, and
at runtime.test_epsilon from the same numpy streams); the sweep and
``--play`` print their rows and a JSON line."""

import json

import jax
import numpy as np
import pytest

from r2d2_tpu.actor.policy import ActorPolicy as JActorPolicy
from r2d2_tpu.cli.evaluate import rollout_episode as j_rollout_episode
from r2d2_tpu.config import Config as JConfig
from r2d2_tpu.envs.factory import create_env as j_create_env
from r2d2_tpu.models.network import NetworkApply as JNetworkApply
from r2d2_tpu_torch.cli import evaluate
from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.learner.train_step import create_train_state
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import NetworkApply
from r2d2_tpu_torch.runtime.checkpoint import save_checkpoint

pytestmark = pytest.mark.torch_port

A = 6
SMALL = {
    "env.game_name": "Fake", "env.frame_height": 24, "env.frame_width": 24,
    "env.frame_stack": 2, "env.episode_len": 40, "network.hidden_dim": 16,
    "network.cnn_out_dim": 32, "network.conv_layers": ((8, 4, 2), (16, 3, 1)),
    "sequence.burn_in_steps": 4, "sequence.learning_steps": 5,
    "sequence.forward_steps": 3, "replay.capacity": 800,
    "replay.block_length": 20}


def _checkpoint(tmp_path, eps: float, index: int = 3, seed: int = 0):
    """(port cfg, checkpoint path, JAX cfg, JAX net, JAX params)."""
    over = {**SMALL, "runtime.save_dir": str(tmp_path),
            "runtime.test_epsilon": eps}
    jcfg, cfg = JConfig().replace(**over), Config().replace(**over)
    jnet = JNetworkApply(A, jcfg.network, 2, 24, 24)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    net = NetworkApply(A, cfg.network, 2, 24, 24, "cpu")
    ts = create_train_state(net, cfg.optim, 0, False)
    ts.params.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    ts.step = 40 * index
    path = save_checkpoint(str(tmp_path), "Fake", index, 0, ts, 77 * index,
                           config_json=cfg.to_json())
    return cfg, path, jcfg, jnet, jparams


@pytest.mark.parametrize("eps", [0.0, 0.3])
def test_evaluate_checkpoint_matches_jax_rollout(tmp_path, eps):
    cfg, path, jcfg, jnet, jparams = _checkpoint(tmp_path, eps)
    rounds, seed = 3, 5
    mean, step, env_steps = evaluate.evaluate_checkpoint(cfg, path, rounds,
                                                         seed=seed)
    env = j_create_env(jcfg.env, seed=seed)
    policy = JActorPolicy(jnet, jparams, eps, seed=seed)
    want = [j_rollout_episode(env, policy) for _ in range(rounds)]
    assert mean == pytest.approx(float(np.mean(want)), abs=0)
    assert (step, env_steps) == (120, 231)


def test_sweep_and_play_print_rows_and_json(tmp_path, capsys):
    """The sweep scores every checkpoint in save_dir in index order;
    --play scores one (greedy: the same return every round); both end in
    a JSON line."""
    cfg, first, *_ = _checkpoint(tmp_path, 0.0, index=1)
    _checkpoint(tmp_path, 0.0, index=4, seed=1)
    args = [f"--runtime.save_dir={tmp_path}", "--env.game_name=Fake",
            "--runtime.test_epsilon=0", "--rounds", "1"]
    out = evaluate.main(args)
    rows = out["evaluations"]
    assert [r["index"] for r in rows] == [1, 4]
    assert [r["step"] for r in rows] == [40, 160]
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("checkpoint 1: step=40")
    assert json.loads(printed[-1]) == out
    played = evaluate.main(["--play", first, "--rounds", "2",
                            "--runtime.test_epsilon=0"])
    assert len(played["evaluations"]) == 1
    assert played["evaluations"][0]["mean_return"] == rows[0]["mean_return"]
    with pytest.raises(SystemExit, match="no checkpoints"):
        evaluate.main([f"--runtime.save_dir={tmp_path / 'none'}"])
