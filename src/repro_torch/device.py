"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: with no
card and no ``device="cpu"`` they raise, never carry on on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
