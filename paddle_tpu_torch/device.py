"""Device resolution shared by every entry point of the port.

The port runs on the GPU. A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; a caller that says nothing on a
machine without CUDA gets an error, never a quiet CPU run."""

from typing import Dict, Optional, Union

import torch

__all__ = ["resolve", "sm_count"]

_SMS: Dict[int, int] = {}


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA
    device and raises when CUDA is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def sm_count(device: torch.device) -> int:
    """The CUDA device's SM count, cached (a property query on every
    launch would cost host time on the decode path)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]
