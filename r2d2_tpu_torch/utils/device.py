"""Device selection and numerics: the port runs on CUDA unless the caller
asks for the CPU. There is no silent fallback — asking for CUDA where there
is none raises. ``configure_numerics`` is the one place that sets how f32
computes on the card."""

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means "cuda". A CUDA device that is not there raises."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device=cpu) "
            "to run on the CPU")
    return device


def configure_numerics() -> None:
    """f32 means f32, as the JAX CPU reference computes it: no TF32 in
    matmuls or cuDNN convolutions (PyTorch's default lets cuDNN use it).
    Both flags are process-wide; every entry point calls this before it
    builds a network."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
