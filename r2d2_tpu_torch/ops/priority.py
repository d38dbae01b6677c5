"""Per-sequence replay priority from per-step TD errors:
p = eta * max + (1 - eta) * mean over each sequence's learning steps."""

import numpy as np
import torch


def mixed_td_errors_masked(td_errors: torch.Tensor, mask: torch.Tensor,
                           eta: float = 0.9) -> torch.Tensor:
    """td_errors: (B, L) abs TD errors; mask: (B, L) 1.0 on real learning
    steps. Returns (B,) mixed priorities; 0 for a sequence with no step."""
    mask = mask.to(td_errors.dtype)
    neg_inf = torch.full_like(td_errors, -torch.inf)
    masked_max = torch.where(mask > 0, td_errors, neg_inf).amax(dim=1)
    total = mask.sum(dim=1)
    masked_mean = (td_errors * mask).sum(dim=1) / total.clamp(min=1.0)
    mixed = eta * masked_max + (1.0 - eta) * masked_mean
    return torch.where(total > 0, mixed, torch.zeros_like(mixed))


def mixed_td_errors_ragged(td_errors: np.ndarray, learning_steps: np.ndarray,
                           eta: float = 0.9) -> np.ndarray:
    """Ragged numpy layout: td_errors is the flat concatenation of each
    sequence's learning-step errors."""
    out = np.empty(learning_steps.shape, dtype=np.float32)
    start = 0
    for i, steps in enumerate(learning_steps):
        seg = td_errors[start: start + steps]
        out[i] = eta * seg.max() + (1.0 - eta) * seg.mean()
        start += steps
    return out
