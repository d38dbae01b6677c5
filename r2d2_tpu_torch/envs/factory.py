"""Environment factory: resolves an env id to a backend and applies
WarpFrame to engine frames, as the JAX package's ``envs/factory.py`` does
(reward clipping is off there by default and has no setting here).

  * "Fake*"       the hermetic deterministic env (tests, benchmarks);
  * "JaxFake*",
    "Grid",
    "JaxGrid*"    the on-device envs (envs/device_env.py) behind the host
                  adapter, so their dynamics run under the host actor
                  loops too; ``create_device_env`` resolves the same kinds,
                  and "Fake" too, to the batched env of the on-device
                  acting path (actor.on_device, runtime/anakin_loop.py);
  * "Vizdoom*"    the ViZDoom engine, which the port has no binding for;
  * anything else gymnasium (ALE Atari ids such as "ALE/Boxing-v5").

An engine that is not installed raises and names itself; nothing falls
back to another env.
"""

import torch

from r2d2_tpu_torch.envs.device_env import (DeviceFakeEnv, DeviceGridWorld,
                                            HostDeviceEnv, is_grid_id)
from r2d2_tpu_torch.envs.fake import FakeR2D2Env
from r2d2_tpu_torch.envs.wrappers import GymnasiumAdapter, WarpFrame


def create_device_env(cfg, device):
    """The batched env of ``cfg`` (an EnvConfig) on ``device`` for the
    on-device acting path. Plain "Fake" resolves too: DeviceFakeEnv is
    its twin, so turning actor.on_device on needs no env rename."""
    device = torch.device(device)
    if cfg.env_id.startswith(("JaxFake", "Fake")):
        return DeviceFakeEnv(episode_len=cfg.episode_len,
                             height=cfg.frame_height, width=cfg.frame_width,
                             device=device)
    if is_grid_id(cfg.game_name):
        return DeviceGridWorld(size=cfg.grid_size,
                               episode_len=cfg.episode_len,
                               height=cfg.frame_height,
                               width=cfg.frame_width, device=device)
    raise ValueError(
        f"env id {cfg.env_id!r} has no on-device implementation: the "
        "on-device acting path (actor.on_device) supports the "
        "'Fake'/'JaxFake' and 'Grid'/'JaxGrid' kinds; engine-backed envs "
        "must use the host actors")


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
    elif env_id.startswith("JaxFake") or is_grid_id(cfg.game_name):
        return HostDeviceEnv(create_device_env(cfg, "cpu"), seed=seed)
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
