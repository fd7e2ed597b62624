"""The device a run uses.

A run names its device explicitly. The CLI always asks for CUDA; nothing on
the main path falls back to the CPU. Tests pass device="cpu" to run(), where
every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """`device` as a torch.device; None means CUDA. Raises
    DeviceUnavailableError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA is not available (torch.cuda.is_available() is False): "
            "meshclust_tpu_torch runs on an NVIDIA GPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
