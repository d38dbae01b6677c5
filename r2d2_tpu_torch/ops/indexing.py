"""Static-shape index math for ragged sequences: every sequence unrolls the
full fixed window, and gather indices plus validity masks take the place of
per-sequence slicing (see the JAX package's ops/indexing.py)."""

import torch


def frame_stack_indices(seq_len: int, frame_stack: int,
                        device=None) -> torch.Tensor:
    """(seq_len, frame_stack): stacked observation t is frames [t, t+stack)."""
    t = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(frame_stack, device=device)[None, :]
    return t + j


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel index (dh*2 + dw)*C + c
    (the JAX package's models/network.py space_to_depth_2x2)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def online_q_positions(burn_in_steps: torch.Tensor,
                       learning_max: int) -> torch.Tensor:
    """(B, learning_max): learning step j sits at burn_in + j."""
    j = torch.arange(learning_max, dtype=torch.int64,
                     device=burn_in_steps.device)[None, :]
    return burn_in_steps.long()[:, None] + j


def target_q_positions(burn_in_steps: torch.Tensor,
                       learning_steps: torch.Tensor,
                       forward_steps: torch.Tensor,
                       learning_max: int, forward_max: int) -> torch.Tensor:
    """(B, learning_max): the bootstrap output for learning step j sits at
    burn_in + forward_max + j, clamped to the last valid output
    burn_in + learning + forward - 1."""
    burn_in = burn_in_steps.long()[:, None]
    j = torch.arange(learning_max, dtype=torch.int64,
                     device=burn_in_steps.device)[None, :]
    last_valid = (burn_in + learning_steps.long()[:, None]
                  + forward_steps.long()[:, None] - 1)
    return torch.minimum(burn_in + forward_max + j, last_valid)


def learning_step_mask(learning_steps: torch.Tensor,
                       learning_max: int) -> torch.Tensor:
    """(B, learning_max) float32: 1.0 where step j < learning_steps[b]."""
    j = torch.arange(learning_max, device=learning_steps.device)[None, :]
    return (j < learning_steps.long()[:, None]).float()
