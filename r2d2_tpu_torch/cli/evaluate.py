"""Evaluation CLI of the PyTorch port, the JAX package's
``cli/evaluate.py`` for one player.

  * sweep (default): every saved checkpoint ``{game}{k}_player{p}`` under
    ``runtime.save_dir``, ``--rounds`` episodes each at epsilon =
    runtime.test_epsilon; prints one row a checkpoint and a JSON line.
  * ``--play CKPT``: one checkpoint, ``--rounds`` episodes.

    python -m r2d2_tpu_torch.cli.evaluate --env.game_name=Fake --rounds 5
    python -m r2d2_tpu_torch.cli.evaluate --play models/Fake3_player0
    python -m r2d2_tpu_torch.cli.evaluate --play models/Fake3_player0 \
        --serve --serve-clients 4

Evaluation acts on the CPU, as actors do. ``--serve`` evaluates as a
service instead (the JAX package's ``_serve_rollouts``): one in-process
policy server on the card (``--device=cpu`` puts it on the CPU; without a
card it raises) and ``--serve-clients`` evaluator threads as its
``RemotePolicy`` clients, splitting the rounds. The Config saved beside a
checkpoint supplies the network, env and sequence sections, so the
trained network is rebuilt exactly.
"""

import argparse
import dataclasses
import json
import sys
from typing import List, Tuple

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


def serve_rollouts(cfg, net, params, first_env, rounds: int, clients: int,
                   seed: int, device=None) -> List[float]:
    """Evaluation as a service: one in-process policy server on
    ``device`` and ``clients`` concurrent thin clients splitting the
    rounds (client 0 uses ``first_env``, the others fresh envs seeded
    ``seed + i``). Returns the episodes' returns."""
    import threading

    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.serve import InprocEndpoint, PolicyServer, RemotePolicy

    endpoint = InprocEndpoint()
    server = PolicyServer(cfg, net, params, endpoint=endpoint,
                          device=device).start()
    clients = min(clients, max(rounds, 1))
    shares = [rounds // clients + (1 if i < rounds % clients else 0)
              for i in range(clients)]
    returns: List[float] = []
    errors: list = []
    lock = threading.Lock()

    def run(i: int, share: int) -> None:
        env = policy = None
        try:
            env = first_env if i == 0 else create_env(cfg.env,
                                                      seed=seed + i)
            policy = RemotePolicy(endpoint.connect(), net.action_dim,
                                  cfg.runtime.test_epsilon, seed=seed + i,
                                  client_id=i,
                                  timeout_s=cfg.serve.request_timeout_s,
                                  max_retry_s=cfg.serve.max_retry_s)
            got = [rollout_episode(env, policy) for _ in range(share)]
            with lock:
                returns.extend(got)
        except BaseException as e:     # raised below
            errors.append(e)
        finally:
            if policy is not None:
                policy.close()
            if env is not None and i > 0:
                env.close()

    threads = [threading.Thread(target=run, args=(i, share), daemon=True)
               for i, share in enumerate(shares) if share > 0]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    if errors:
        raise errors[0]
    return returns


def evaluate_checkpoint(cfg, ckpt_path: str, rounds: int, *,
                        seed: int = 0, serve_clients: int = 0,
                        device=None) -> Tuple[float, int, int]:
    """(mean return over ``rounds`` episodes, training steps, env steps)
    of one checkpoint; ``serve_clients`` > 0 evaluates through a policy
    server on ``device`` (``serve_rollouts``)."""
    from r2d2_tpu_torch.actor.policy import ActorPolicy
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.checkpoint import (load_checkpoint_config,
                                                   restore_checkpoint)

    stored = load_checkpoint_config(ckpt_path)
    if stored is not None:
        # the stored architecture, with this run's inference dtype
        network = dataclasses.replace(
            stored.network, inference_dtype=cfg.network.inference_dtype)
        cfg = dataclasses.replace(cfg, env=stored.env, network=network,
                                  sequence=stored.sequence)
    restored = restore_checkpoint(ckpt_path)
    env = create_env(cfg.env, seed=seed)
    try:
        net = NetworkApply(env.action_space.n, cfg.network,
                           cfg.env.frame_stack, cfg.env.frame_height,
                           cfg.env.frame_width, "cpu")
        module = net.build()
        module.load_state_dict(restored["params"])
        if serve_clients > 0:
            returns = serve_rollouts(cfg, net, module, env, rounds,
                                     serve_clients, seed, device)
        else:
            policy = ActorPolicy(net, module, cfg.runtime.test_epsilon,
                                 seed=seed)
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
    p.add_argument("--serve", action="store_true",
                   help="evaluate through a policy server on --device")
    p.add_argument("--serve-clients", type=int, default=1,
                   help="evaluator threads as the server's clients")
    p.add_argument("--device", default=None,
                   help='the server\'s device with --serve: "cuda" '
                        '(default; raises without one) or "cpu"')
    args, overrides = p.parse_known_args(argv)
    cfg = parse_overrides(Config(), overrides)
    device = None
    if args.serve:
        from r2d2_tpu_torch.utils.device import (configure_numerics,
                                                 resolve_device)
        device = resolve_device(args.device)
        configure_numerics()

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
            cfg, path, args.rounds, seed=i,
            serve_clients=max(args.serve_clients, 1) if args.serve else 0,
            device=device)
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
