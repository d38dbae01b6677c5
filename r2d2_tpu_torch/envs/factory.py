"""Environment factory: resolves an env id to a backend and applies
WarpFrame to engine frames, as the JAX package's ``envs/factory.py`` does
(reward clipping is off there by default and has no setting here).

  * "Fake*"       the hermetic deterministic env (tests, benchmarks);
  * "Vizdoom*"    the ViZDoom engine, which the port has no binding for;
  * anything else gymnasium (ALE Atari ids such as "ALE/Boxing-v5").

An engine that is not installed raises and names itself; nothing falls
back to another env.
"""

from r2d2_tpu_torch.envs.fake import FakeR2D2Env
from r2d2_tpu_torch.envs.wrappers import GymnasiumAdapter, WarpFrame


def create_env(cfg, *, name: str = "", seed: int = 0):
    """Build and wrap one environment instance; ``cfg`` is an EnvConfig.
    The Fake env records ``name`` among its wiring."""
    env_id = cfg.env_id
    if env_id.startswith("Fake"):
        return FakeR2D2Env(height=cfg.frame_height, width=cfg.frame_width,
                           episode_len=cfg.episode_len, seed=seed,
                           wiring=dict(name=name))
    elif env_id.startswith("Vizdoom"):
        raise ImportError(
            f"env id {env_id!r} needs the ViZDoom engine (the vizdoom "
            "package), which is not installed; use the Fake env")
    elif env_id.startswith(("JaxFake", "JaxGrid", "Grid")):
        raise ValueError(
            f"env id {env_id!r} names an on-device env, which the port does "
            "not have yet; use the Fake env")
    else:
        try:
            import gymnasium
        except ImportError as e:
            raise ImportError(
                f"env id {env_id!r} needs gymnasium and the ALE (Atari) "
                "engine, which are not installed; use the Fake env") from e
        try:
            inner = gymnasium.make(env_id)
        except gymnasium.error.Error as e:
            raise ImportError(
                f"env id {env_id!r}: gymnasium has no such env; an Atari id "
                "needs the ALE engine (ale_py), which is not installed") from e
        return WarpFrame(GymnasiumAdapter(inner, seed=seed),
                         cfg.frame_height, cfg.frame_width)
