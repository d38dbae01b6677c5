"""Device selection: the port runs on CUDA unless the caller asks for the
CPU. There is no silent fallback — asking for CUDA where there is none
raises."""

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
