"""Invertible value rescaling (Pohlen et al. 2018) for the n-step target:
target = h(r + gamma^n * h^-1(Q'))."""

import torch


def value_rescale(value: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x"""
    return torch.sign(value) * (torch.sqrt(value.abs() + 1.0) - 1.0) + eps * value


def inverse_value_rescale(value: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """h^-1(x) = sign(x) * ((((sqrt(1 + 4*eps*(|x| + 1 + eps)) - 1) / (2*eps))^2) - 1)"""
    temp = (torch.sqrt(1.0 + 4.0 * eps * (value.abs() + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return torch.sign(value) * (torch.square(temp) - 1.0)
