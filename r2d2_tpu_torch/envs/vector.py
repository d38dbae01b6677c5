"""Synchronous vector environment: N per-lane envs behind one batched API.

The reference steps every env in its own Ray actor with batch-size-1
inference (worker.py:528-547); Podracer-class systems
(arxiv 2104.06272) instead drive many envs per worker so ONE jitted policy
call serves N lanes. This wrapper supplies the env side of that design:
``step`` takes an (N,) action vector and returns stacked (N, ...) arrays.

Semantics chosen to keep the per-lane experience stream IDENTICAL to the
scalar actor loop (runtime/actor_loop.py run_actor):

  * ``step`` returns each lane's TRUE next observation — including the
    terminal one on episode end, which the LocalBuffer records — never the
    auto-reset frame.
  * Auto-reset: a done lane is reset inside the same ``step`` call, and the
    new episode's initial observation rides in ``infos[lane]["reset_obs"]``
    (alongside the closed episode's accounting), so the caller restarts the
    lane without a second env round-trip. ``auto_reset=False`` leaves the
    lane to an explicit ``reset_lane`` (the actor loop's episode-truncation
    path uses ``reset_lane`` either way).
  * Per-lane episode accounting (steps, return) lives here, emitted on the
    done step — the vectorized twin of the scalar loop's episode counters.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class SyncVectorEnv:
    """Drive N envs in lockstep; lane i is ``envs[i]``. OWNS the lane envs:
    ``close()`` closes every one (the vector actor loop closes the wrapper
    in its finally, exactly like the scalar loop owns its single env)."""

    def __init__(self, envs: Sequence, auto_reset: bool = True):
        if not envs:
            raise ValueError("SyncVectorEnv needs at least one lane env")
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.action_space = self.envs[0].action_space
        self.auto_reset = auto_reset
        self._episode_steps = np.zeros(self.num_envs, np.int64)
        self._episode_returns = np.zeros(self.num_envs, np.float64)

    @property
    def episode_steps(self) -> np.ndarray:
        """Per-lane steps into the CURRENT episode — the single source of
        episode accounting (the vector actor loop reads this for its
        max_episode_steps truncation; treat as read-only)."""
        return self._episode_steps

    def reset(self) -> np.ndarray:
        """Reset every lane; returns stacked (N, H, W) initial obs."""
        obs = [self.reset_lane(i) for i in range(self.num_envs)]
        return np.stack(obs)

    def reset_lane(self, lane: int) -> np.ndarray:
        """Reset one lane (explicit restart — the truncation path)."""
        self._episode_steps[lane] = 0
        self._episode_returns[lane] = 0.0
        return np.asarray(self.envs[lane].reset())

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     List[dict]]:
        """Step all lanes. Returns (obs (N, H, W), rewards (N,) f32,
        dones (N,) bool, infos). Done lanes report the terminal obs in the
        stacked array; with auto_reset their info carries ``reset_obs``,
        ``episode_steps``, and ``episode_return``."""
        actions = np.asarray(actions)
        if actions.shape != (self.num_envs,):
            raise ValueError(
                f"expected ({self.num_envs},) actions, got {actions.shape}")
        obs_rows = []
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        infos: List[dict] = []
        for i, env in enumerate(self.envs):
            obs, reward, done, info = env.step(int(actions[i]))
            info = dict(info)
            self._episode_steps[i] += 1
            self._episode_returns[i] += float(reward)
            if done:
                info["episode_steps"] = int(self._episode_steps[i])
                info["episode_return"] = float(self._episode_returns[i])
                if self.auto_reset:
                    # reset_lane zeroes the accounting — read it out first
                    info["reset_obs"] = self.reset_lane(i)
            obs_rows.append(np.asarray(obs))
            rewards[i] = reward
            dones[i] = done
            infos.append(info)
        return np.stack(obs_rows), rewards, dones, infos

    def close(self) -> None:
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass


def make_vector_env(env_cfg, num_envs: int, *, seed: int = 0,
                    auto_reset: bool = True,
                    env_factory: Optional[Callable] = None,
                    **env_kwargs) -> SyncVectorEnv:
    """Factory-integrated construction: N ``create_env`` lanes with
    consecutive per-lane seeds (seed + lane), wrapped. ``env_kwargs`` pass
    through to every lane (multiplayer wiring is rejected upstream —
    Config validates envs_per_actor == 1 there)."""
    if env_factory is None:
        from r2d2_tpu_torch.envs.factory import create_env
        env_factory = create_env
    envs = []
    try:
        for lane in range(num_envs):
            envs.append(env_factory(env_cfg, seed=seed + lane, **env_kwargs))
    except Exception:
        for env in envs:
            try:
                env.close()
            except Exception:
                pass
        raise
    return SyncVectorEnv(envs, auto_reset=auto_reset)
