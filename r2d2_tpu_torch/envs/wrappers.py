"""Atari-style preprocessing wrappers (ref environment.py:10-79)
plus a gymnasium-API adapter, torch/cv2-optional.

WarpFrame: RGB→grayscale + resize to 84x84. Uses cv2 when present (same C++
path as the reference, environment.py:71-75); otherwise a numpy fallback
(ITU-R 601 luma + area resampling) so the wrapper stack is importable
everywhere.
"""

import functools
from typing import Any

import numpy as np

try:  # pragma: no cover - exercised only when cv2 is installed
    import cv2
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return frame
    if _HAS_CV2:
        return cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    return (frame @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) row-normalized coverage weights for 1-D area
    resampling: output cell i averages the source interval
    [i*s, (i+1)*s), s = n_src/n_dst, with fractional edge coverage —
    the pixel-area relation cv2's INTER_AREA computes for downscaling."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src), np.float64)
    for i in range(n_dst):
        a, b = i * scale, (i + 1) * scale
        for k in range(int(np.floor(a)), min(int(np.ceil(b)), n_src)):
            w[i, k] = min(k + 1.0, b) - max(float(k), a)
    return w / w.sum(axis=1, keepdims=True)


_warned_fallback = False


def _resize(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    if frame.shape == (height, width):
        return frame
    if _HAS_CV2:
        return cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)
    # numpy fallback: exact area resample (separable coverage-weighted
    # average, fractional ratios included — real Atari is 210x160 -> 84x84,
    # ratios 2.5 and 1.9). Matches cv2's INTER_AREA up to fixed-point
    # rounding (+-1 gray level, tested vs cv2 in CI); warn once anyway so a
    # cv2-less deployment knows its observations are not bit-identical to
    # the reference preprocessing (ref environment.py:71-75).
    global _warned_fallback
    if not _warned_fallback:
        import warnings
        warnings.warn(
            "cv2 is not installed: WarpFrame is using the numpy area-"
            f"resample fallback for {frame.shape} -> ({height}, {width}). "
            "It matches cv2 INTER_AREA only up to rounding (+-1 gray "
            "level) — install opencv-python for the reference's exact "
            "preprocessing.")
        _warned_fallback = True
    wy = _area_weights(frame.shape[0], height)
    wx = _area_weights(frame.shape[1], width)
    out = wy @ frame.astype(np.float64) @ wx.T
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


class Wrapper:
    def __init__(self, env: Any):
        self.env = env

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def unwrapped(self):
        """Innermost env (the gym surface tests/tools use to reach
        backend-specific attributes through the wrapper stack)."""
        inner = self.env
        return inner.unwrapped if hasattr(inner, "unwrapped") else inner

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()


class GymnasiumAdapter(Wrapper):
    """gymnasium 5-tuple API → the reference's 4-tuple protocol.

    ``seed`` (optional) is forwarded to the FIRST gymnasium reset — how
    gymnasium seeds an env — so per-lane vector-env seeds (vector.py)
    reach the ALE backends; later resets continue the seeded stream."""

    def __init__(self, env, seed=None):
        super().__init__(env)
        self._pending_seed = seed

    def reset(self):
        if self._pending_seed is not None:
            out = self.env.reset(seed=int(self._pending_seed))
            self._pending_seed = None
        else:
            out = self.env.reset()
        return out[0] if isinstance(out, tuple) else out

    def step(self, action):
        out = self.env.step(action)
        if len(out) == 5:
            obs, reward, terminated, truncated, info = out
            return obs, reward, terminated or truncated, info
        return out


class WarpFrame(Wrapper):
    """Grayscale + resize (ref environment.py:48-79)."""

    def __init__(self, env, height: int = 84, width: int = 84):
        super().__init__(env)
        self.height, self.width = height, width

    def _warp(self, obs: np.ndarray) -> np.ndarray:
        return _resize(_to_gray(np.asarray(obs)), self.height, self.width)

    def reset(self):
        return self._warp(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return self._warp(obs), reward, done, info


class ClipReward(Wrapper):
    """Clip rewards to [-1, 1], training-time only (ref environment.py:39-45;
    actors/eval construct with clip_rewards=False, ref worker.py:507)."""

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return obs, float(np.clip(reward, -1.0, 1.0)), done, info


class NoopReset(Wrapper):
    """Random no-op burn after reset (ref environment.py:10-37; present but
    disabled in the reference factory, environment.py:90-91)."""

    def __init__(self, env, noop_max: int = 30, noop_action: int = 0, seed: int = 0):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = noop_action
        self.rng = np.random.default_rng(seed)

    def reset(self):
        obs = self.env.reset()
        for _ in range(int(self.rng.integers(1, self.noop_max + 1))):
            obs, _, done, _ = self.env.step(self.noop_action)
            if done:
                obs = self.env.reset()
        return obs
