"""The device the port runs on.

The port runs on a CUDA card.  resolve_device() defaults to it and
raises when there is none: the CPU is used only when a caller passes
torch.device("cpu") (or "cpu") explicitly, and then every kernel
wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """torch.device for `device` (default "cuda"); raises when a CUDA
    device is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "usearch12_tpu_torch needs a CUDA device and none is "
                "available (pass device=torch.device('cpu') to run the "
                "plain PyTorch versions of the kernels)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_info(index: Optional[int] = None) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    if index is not None:
        cmd.insert(1, f"--id={index}")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip()
