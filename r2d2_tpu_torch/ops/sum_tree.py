"""Prioritized-replay sum tree as whole-tensor operations on the device.

Layout: one 1-D float32 tensor of 2**num_layers - 1 nodes; node 0 holds the
total mass, leaves occupy [2**(L-1) - 1, 2**L - 1). ``tree_update`` is a
leaf scatter plus a bottom-up parent rebuild; ``tree_sample`` a stratified
root-to-leaf descent of the whole batch in lockstep. The numpy twins are the
host replay's tree when it is not asked for the native one
(``native/sum_tree.cc``), and the test oracle.

Duplicate leaves: if ``idxes`` names one leaf twice with different
priorities, which write lands is unspecified (``index_put_`` without
accumulate, like ``.at[].set`` in JAX). Parents are rebuilt from whatever
landed, so the tree stays consistent either way.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.telemetry import scopes


def tree_num_layers(capacity: int) -> int:
    """Smallest L with 2**(L-1) >= capacity leaves."""
    num_layers = 1
    while capacity > 2 ** (num_layers - 1):
        num_layers += 1
    return num_layers


def tree_update(num_layers: int, tree: torch.Tensor, prio_exponent: float,
                td_errors: torch.Tensor, idxes: torch.Tensor) -> torch.Tensor:
    """Write p = |td|**alpha at the given leaves (p = 0 for td = 0, so
    alpha = 0 still leaves empty slots unsamplable) and rebuild ancestor
    sums. Updates ``tree`` in place and returns it."""
    with scopes.scope("sum_tree_update"):
        td_errors = td_errors.to(tree.dtype)
        priorities = torch.where(td_errors != 0.0,
                                 td_errors.abs() ** prio_exponent,
                                 torch.zeros_like(td_errors))
        node = idxes.long() + (2 ** (num_layers - 1) - 1)
        tree[node] = priorities
        for _ in range(num_layers - 1):
            node = (node - 1) // 2
            tree[node] = tree[2 * node + 1] + tree[2 * node + 2]
        return tree


def tree_sample(num_layers: int, tree: torch.Tensor, is_exponent: float,
                num_samples: int, generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified proportional sampling: one draw per equal-mass stratum.
    Returns (leaf indices int64, is_weights = (p / min p) ** -beta).

    ``uniform``: the (num_samples,) jitter draws in [0, 1); drawn from
    ``generator`` when None (tests inject the JAX package's draws)."""
    with scopes.scope("sum_tree_sample"):
        if uniform is None:
            uniform = torch.rand(num_samples, generator=generator,
                                 device=tree.device, dtype=tree.dtype)
        p_sum = tree[0]
        interval = p_sum / num_samples
        prefixsums = (torch.arange(num_samples, device=tree.device,
                                   dtype=tree.dtype)
                      + uniform.to(tree.dtype)) * interval
        # f32 rounding can push the top stratum to p_sum (or past a subtree
        # total mid-descent) and walk into a zero-priority padding leaf: clamp
        # below the total, and never enter a zero-mass right subtree
        prefixsums = torch.minimum(prefixsums, p_sum * (1.0 - 1e-6))
        node = torch.zeros(num_samples, dtype=torch.int64, device=tree.device)
        for _ in range(num_layers - 1):
            left_sum = tree[node * 2 + 1]
            right_sum = tree[node * 2 + 2]
            go_left = (prefixsums < left_sum) | (right_sum <= 0.0)
            node = torch.where(go_left, node * 2 + 1, node * 2 + 2)
            prefixsums = torch.where(
                go_left, torch.minimum(prefixsums, left_sum * (1.0 - 1e-6)),
                prefixsums - left_sum)
        priorities = tree[node]
        is_weights = torch.pow(priorities / priorities.min(), -is_exponent)
        return node - (2 ** (num_layers - 1) - 1), is_weights


# ---------------------------------------------------------------------------
# numpy twins


def tree_init_np(capacity: int) -> Tuple[int, np.ndarray]:
    """(num_layers, a zeroed float64 tree) for ``capacity`` leaves."""
    num_layers = tree_num_layers(capacity)
    return num_layers, np.zeros(2 ** num_layers - 1, dtype=np.float64)


def tree_update_np(num_layers: int, tree: np.ndarray, prio_exponent: float,
                   td_errors: np.ndarray, idxes: np.ndarray) -> None:
    priorities = np.where(td_errors != 0.0, np.abs(td_errors) ** prio_exponent, 0.0)
    node = np.asarray(idxes, dtype=np.int64) + 2 ** (num_layers - 1) - 1
    tree[node] = priorities
    for _ in range(num_layers - 1):
        node = np.unique((node - 1) // 2)
        tree[node] = tree[2 * node + 1] + tree[2 * node + 2]


def tree_sample_np(num_layers: int, tree: np.ndarray, is_exponent: float,
                   num_samples: int, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    p_sum = tree[0]
    interval = p_sum / num_samples
    prefixsums = (np.arange(num_samples, dtype=np.float64) * interval
                  + rng.uniform(0, interval, num_samples))
    prefixsums = np.minimum(prefixsums, p_sum * (1.0 - 1e-12))
    node = np.zeros(num_samples, dtype=np.int64)
    for _ in range(num_layers - 1):
        left_sum = tree[node * 2 + 1]
        right_sum = tree[node * 2 + 2]
        go_left = (prefixsums < left_sum) | (right_sum <= 0.0)
        node = np.where(go_left, node * 2 + 1, node * 2 + 2)
        prefixsums = np.where(
            go_left, np.minimum(prefixsums, left_sum * (1.0 - 1e-12)),
            prefixsums - left_sum)
    priorities = tree[node]
    is_weights = np.power(priorities / priorities.min(), -is_exponent)
    return node - (2 ** (num_layers - 1) - 1), is_weights
