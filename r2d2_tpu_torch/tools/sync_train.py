"""Synchronous collect:learn training: exactly
``replay.max_env_steps_per_train_step`` env steps per ``learner.step()``
call (one dispatch of ``runtime.steps_per_dispatch`` learner steps, as in
the JAX package's sync_train), one thread, seeds pinned, so the same run
twice gives the same losses. The measurement instrument beside the
orchestrated trainer (``cli.train``): the learnability tests run on it.

    python -m r2d2_tpu_torch.tools.sync_train --env.game_name=Fake \
        --max-steps=100
    python -m r2d2_tpu_torch.tools.sync_train --env.game_name=Fake \
        --max-steps=5 --device=cpu --env.frame_height=24 ...

Extra (non-config) flags:
    --max-steps=N       learner steps to take (default optim.training_steps)
    --device=NAME       "cuda" (default; raises if there is none) or "cpu"
    --seed=N            env, weights and sampling seed (default 0)
    --collect-eps=E     epsilon of the collecting policy (default 0.4)

The collect:learn ratio is ``replay.max_env_steps_per_train_step`` env
steps per dispatch (values below 1 run one env step per dispatch). Each
log line holds a dispatch's losses.
"""

import json
import math
import sys

from r2d2_tpu_torch.config import Config

FLUSH_STEPS = 1000      # learner steps between flushes of device metrics


def sync_train(cfg: Config, train_steps: int, collect_eps: float,
               seed: int = 0, param_refresh_interval: int = 10,
               device=None, log_fn=None):
    """Train until ``train_steps`` learner steps are taken (a multiple of
    the dispatch's K past it at most) on ``device`` (CUDA by default).
    Returns ``(net, learner)``."""
    from r2d2_tpu_torch.actor.local_buffer import LocalBuffer
    from r2d2_tpu_torch.actor.policy import ActorPolicy
    from r2d2_tpu_torch.envs.factory import create_env
    from r2d2_tpu_torch.models.network import NetworkApply
    from r2d2_tpu_torch.runtime.learner_loop import Learner
    from r2d2_tpu_torch.utils.device import configure_numerics, resolve_device

    configure_numerics()
    device = resolve_device(device)
    ratio = int(cfg.replay.max_env_steps_per_train_step)
    if ratio < 1:
        raise ValueError(
            "sync_train needs replay.max_env_steps_per_train_step >= 1 "
            f"(got {cfg.replay.max_env_steps_per_train_step})")
    if cfg.replay.placement != "device":
        raise ValueError(
            "sync_train requires replay.placement='device': the host "
            "placement's async prefetch/write-back threads sample "
            "concurrently with ingestion, which breaks the "
            "bit-reproducibility this loop exists to provide")
    env = create_env(cfg.env, seed=seed)
    net = NetworkApply(env.action_space.n, cfg.network, cfg.env.frame_stack,
                       cfg.env.frame_height, cfg.env.frame_width, device)
    learner = Learner(cfg, net, seed=seed)
    policy = ActorPolicy(net, learner.train_state.params, collect_eps,
                         seed=seed)
    lb = LocalBuffer(learner.spec, policy.action_dim, cfg.optim.gamma,
                     cfg.optim.priority_eta)

    obs = env.reset()
    policy.observe_reset(obs)
    lb.reset(obs)

    def collect_one():
        nonlocal obs
        action, q, hidden = policy.act()
        next_obs, reward, done, _ = env.step(action)
        policy.observe(next_obs, action)
        lb.add(action, reward, next_obs, q, hidden)
        if done:
            learner.ingest(lb.finish(None))
            obs = env.reset()
            policy.observe_reset(obs)
            lb.reset(obs)
        elif len(lb) == learner.spec.block_length:
            learner.ingest(lb.finish(policy.bootstrap_q()))

    try:
        while not learner.ready:
            collect_one()
        while learner.training_steps < train_steps:
            for _ in range(ratio):
                collect_one()
            metrics = learner.step()
            if log_fn is not None:
                log_fn(learner.training_steps, metrics)
            if learner.training_steps % param_refresh_interval == 0:
                policy.update_params(learner.train_state.params)
            if (learner.training_steps % FLUSH_STEPS
                    < learner.steps_per_dispatch):
                # the losses and the diagnostics' values held on the device
                learner.flush_metrics()
    finally:
        env.close()
    return net, learner


def greedy_return(net, params, env_cfg, seed: int,
                  max_steps: int = 100_000) -> float:
    """One greedy (epsilon 0) episode's summed reward; deterministic given
    the seed."""
    from r2d2_tpu_torch.actor.policy import ActorPolicy
    from r2d2_tpu_torch.envs.factory import create_env
    env = create_env(env_cfg, seed=seed)
    policy = ActorPolicy(net, params, epsilon=0.0, seed=seed)
    obs = env.reset()
    policy.observe_reset(obs)
    total, done, steps = 0.0, False, 0
    while not done and steps < max_steps:
        action, _, _ = policy.act()
        obs, reward, done, _ = env.step(action)
        policy.observe(obs, action)
        total += reward
        steps += 1
    env.close()
    return total


def main(argv=None) -> dict:
    from r2d2_tpu_torch.config import parse_overrides

    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"max-steps": None, "device": None, "seed": "0",
             "collect-eps": "0.4"}
    rest = []
    for arg in argv:
        name, _, value = arg[2:].partition("=")
        if arg.startswith("--") and name in flags:
            flags[name] = value
        else:
            rest.append(arg)
    cfg = parse_overrides(Config(), rest)
    if cfg.replay.max_env_steps_per_train_step < 1:
        cfg = cfg.replace(**{"replay.max_env_steps_per_train_step": 1})
    max_steps = (int(flags["max-steps"]) if flags["max-steps"]
                 else cfg.optim.training_steps)

    def log(step, metrics):
        print(json.dumps({"step": step, "loss": metrics["loss"].tolist()}),
              flush=True)

    net, learner = sync_train(cfg, max_steps, float(flags["collect-eps"]),
                              seed=int(flags["seed"]),
                              device=flags["device"], log_fn=log)
    losses = learner.losses
    summary = {"steps": learner.training_steps,
               "env_steps": learner.env_steps,
               "device": str(net.device),
               "final_loss": losses[-1] if losses else math.nan}
    print(json.dumps(summary), flush=True)
    summary["losses"] = losses
    return summary


if __name__ == "__main__":
    main()
