"""Device selection and numerics: the port runs on CUDA unless the caller
asks for the CPU. There is no silent fallback — asking for CUDA where there
is none raises. ``configure_numerics`` is the one place that sets how f32
computes on the card."""

from typing import Dict, Optional, Union

import torch

_SM_COUNT: Dict[int, int] = {}


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


def sm_count(device: torch.device) -> int:
    """The card's multiprocessor count, queried once per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    count = _SM_COUNT.get(index)
    if count is None:
        count = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNT[index] = count
    return count


def stream_handle(device: torch.device) -> int:
    """The handle of the device's current stream (the raw getter, without
    the Stream object ``torch.cuda.current_stream`` builds); under graph
    capture, the capturing stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)
