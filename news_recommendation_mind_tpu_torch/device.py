"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a torch.device, raising when it names CUDA and there is
    no usable card: the port never falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev
