"""Deterministic fake environment for hermetic tests and benchmarks.

The reference has no test backend at all — multi-process behavior is only
exercised live against the ViZDoom engine (SURVEY.md §4). This environment
replaces it: fully deterministic given (seed, actions), pure numpy, with a
*learnable* reward so end-to-end training tests can assert loss decrease and
return improvement.

Dynamics: the observation encodes a target action as a block pattern;
choosing the target yields +1, anything else 0. Episodes run a fixed number
of steps. The target follows a seeded periodic schedule, so a recurrent
policy can do strictly better than a reactive one (the next target is a
function of history, part of it shown only transiently).
"""

from typing import Tuple

import numpy as np


class _DiscreteSpace:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self._rng = np.random.default_rng(seed)

    def sample(self) -> int:
        return int(self._rng.integers(self.n))


class FakeR2D2Env:
    def __init__(self, action_dim: int = 6, episode_len: int = 120,
                 height: int = 84, width: int = 84, seed: int = 0,
                 wiring: dict = None):
        self.action_space = _DiscreteSpace(action_dim, seed)
        self.episode_len = episode_len
        self.h, self.w = height, width
        self.seed = seed
        # multiplayer host/join args the factory resolved for this env —
        # a real engine would dial these sockets (vizdoom_env.py); the
        # fake records them so wiring is assertable hermetically
        self.multiplayer_wiring = dict(wiring or {})
        self._schedule = np.random.default_rng(seed).integers(
            action_dim, size=episode_len + 1)
        self.t = 0

    @property
    def unwrapped(self):
        """gym conformance: the innermost env is this env."""
        return self

    def _obs(self) -> np.ndarray:
        """84x84 uint8 frame encoding the current target action as a bright
        column band; deterministic in (seed, t)."""
        target = int(self._schedule[self.t])
        frame = np.full((self.h, self.w), 32, np.uint8)
        band = self.w // self.action_space.n
        frame[:, target * band : (target + 1) * band] = 224
        # time texture so consecutive frames differ (exercises frame stacking)
        frame[self.t % self.h, :] = 128
        return frame

    def reset(self) -> np.ndarray:
        self.t = 0
        return self._obs()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        reward = 1.0 if int(action) == int(self._schedule[self.t]) else 0.0
        self.t += 1
        done = self.t >= self.episode_len
        return self._obs(), reward, done, {}

    def close(self) -> None:
        pass
