"""n-step return math for the actor-side block assembler (plain numpy: it
runs on the host over one block at a time)."""

import numpy as np


def n_step_return(rewards: np.ndarray, gamma: float, n: int) -> np.ndarray:
    """out[t] = sum_{i<n} gamma^i * rewards[t+i], rewards past the block
    end counted as 0."""
    rewards = np.asarray(rewards, dtype=np.float64)
    size = rewards.shape[0]
    padded = np.concatenate([rewards, np.zeros(n - 1, dtype=np.float64)])
    kernel = gamma ** np.arange(n - 1, -1, -1, dtype=np.float64)
    return np.convolve(padded, kernel, "valid").astype(np.float32)[:size]


def n_step_gamma(size: int, gamma: float, n: int, bootstrap: bool) -> np.ndarray:
    """Per-step discount on the bootstrap value: gamma^n, with the last
    min(size, n) steps shortened to gamma^m (block continues) or 0 (the
    episode ended)."""
    max_forward = min(size, n)
    out = np.full(size, gamma**n, dtype=np.float32)
    if bootstrap:
        tail = gamma ** np.arange(max_forward, 0, -1, dtype=np.float64)
    else:
        tail = np.zeros(max_forward, dtype=np.float64)
    out[size - max_forward:] = tail
    return out


def initial_priorities(q_values: np.ndarray, actions: np.ndarray,
                       n_step_rewards: np.ndarray, n_step_gammas: np.ndarray,
                       n: int) -> np.ndarray:
    """Per-step |TD| from the actor's own Q-values (one extra bootstrap
    row), seeding replay priorities when a block is added."""
    size = actions.shape[0]
    max_forward = min(size, n)
    max_q = q_values[max_forward: size + 1].max(axis=1)
    max_q = np.pad(max_q, (0, max_forward - 1), "edge")
    chosen_q = q_values[np.arange(size), actions]
    return np.abs(n_step_rewards + n_step_gammas * max_q - chosen_q).astype(np.float32)
