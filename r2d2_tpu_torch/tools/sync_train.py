"""Synchronous collect:learn training: exactly
``replay.max_env_steps_per_train_step`` env steps per ``learner.step()``
call (one dispatch of ``runtime.steps_per_dispatch`` learner steps, as in
the JAX package's sync_train), one thread, seeds pinned, so the same run
twice gives the same losses."""

from r2d2_tpu_torch.config import Config


def sync_train(cfg: Config, train_steps: int, collect_eps: float,
               seed: int = 0, param_refresh_interval: int = 10,
               device=None, log_fn=None):
    """Train until ``train_steps`` learner steps are taken (a multiple of
    the dispatch's K past it at most) on ``device`` (CUDA by default).
    Returns ``(net, learner)``."""
    from r2d2_tpu_torch.actor.local_buffer import LocalBuffer
    from r2d2_tpu_torch.actor.policy import ActorPolicy
    from r2d2_tpu_torch.envs.fake import FakeR2D2Env
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
    if not cfg.env.env_id.startswith("Fake"):
        raise ValueError(f"env {cfg.env.env_id!r}: the port has only the "
                         "Fake environment so far")
    env = FakeR2D2Env(height=cfg.env.frame_height, width=cfg.env.frame_width,
                      episode_len=cfg.env.episode_len, seed=seed)
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
    return net, learner

