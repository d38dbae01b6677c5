"""Evaluation CLI of the PyTorch port, the JAX package's
``cli/evaluate.py`` for one player.

  * sweep (default): every saved checkpoint ``{game}{k}_player{p}`` under
    ``runtime.save_dir``, ``--rounds`` episodes each at epsilon =
    runtime.test_epsilon; prints one row a checkpoint and a JSON line.
  * ``--play CKPT``: one checkpoint, ``--rounds`` episodes.

    python -m r2d2_tpu_torch.cli.evaluate --env.game_name=Fake --rounds 5
    python -m r2d2_tpu_torch.cli.evaluate --play models/Fake3_player0

Evaluation acts on the CPU, as actors do. The Config saved beside a
checkpoint supplies the network, env and sequence sections, so the
trained network is rebuilt exactly.
"""

import argparse
import dataclasses
import json
import sys
from typing import Tuple

import numpy as np


def rollout_episode(env, policy, max_steps: int = 100_000) -> float:
    """One episode's summed reward under ``policy``'s epsilon."""
    obs = env.reset()
    policy.observe_reset(obs)
    total = 0.0
    for _ in range(max_steps):
        action, _, _ = policy.act()
        obs, reward, done, _ = env.step(action)
        policy.observe(obs, action)
        total += float(reward)
        if done:
            break
    return total


def evaluate_checkpoint(cfg, ckpt_path: str, rounds: int, *,
                        seed: int = 0) -> Tuple[float, int, int]:
    """(mean return over ``rounds`` episodes, training steps, env steps)
    of one checkpoint."""
    from r2d2_tpu_torch.actor.policy import ActorPolicy
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.checkpoint import (load_checkpoint_config,
                                                   restore_checkpoint)

    stored = load_checkpoint_config(ckpt_path)
    if stored is not None:
        cfg = dataclasses.replace(cfg, env=stored.env, network=stored.network,
                                  sequence=stored.sequence)
    restored = restore_checkpoint(ckpt_path)
    env = create_env(cfg.env, seed=seed)
    try:
        net = NetworkApply(env.action_space.n, cfg.network,
                           cfg.env.frame_stack, cfg.env.frame_height,
                           cfg.env.frame_width, "cpu")
        module = net.build()
        module.load_state_dict(restored["params"])
        policy = ActorPolicy(net, module, cfg.runtime.test_epsilon, seed=seed)
        returns = [rollout_episode(env, policy) for _ in range(rounds)]
    finally:
        env.close()
    return (float(np.mean(returns)), int(restored["step"]),
            int(restored["env_steps"]))


def main(argv=None) -> dict:
    from r2d2_tpu_torch.config import Config, parse_overrides
    from r2d2_tpu_torch.runtime.checkpoint import list_checkpoints

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--play", default=None, help="one checkpoint to play")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--player", type=int, default=0)
    args, overrides = p.parse_known_args(argv)
    cfg = parse_overrides(Config(), overrides)

    if args.play is not None:
        ckpts = [(None, args.play)]
    else:
        ckpts = list_checkpoints(cfg.runtime.save_dir, cfg.env.game_name,
                                 args.player)
        if not ckpts:
            raise SystemExit(
                f"no checkpoints for game={cfg.env.game_name!r} "
                f"player={args.player} under {cfg.runtime.save_dir!r}")
    rows = []
    for i, (idx, path) in enumerate(ckpts):
        mean_ret, step, env_steps = evaluate_checkpoint(
            cfg, path, args.rounds, seed=i)
        rows.append({"checkpoint": path, "index": idx, "step": step,
                     "env_steps": env_steps, "mean_return": mean_ret,
                     "rounds": args.rounds})
        label = path if idx is None else f"checkpoint {idx}"
        print(f"{label}: step={step} env_steps={env_steps} "
              f"mean_return={mean_ret:.2f} over {args.rounds} rounds",
              flush=True)
    result = {"evaluations": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
