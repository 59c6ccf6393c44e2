"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: with no
card and no ``device="cpu"`` they raise, never carry on on the CPU.
``"meta"`` (PyTorch's placeholder device, which allocates nothing) is
taken only when it is named: the launch layer plans on it.
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
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         "(or 'meta' to plan)")
    return dev


def canonical_device(device) -> torch.device:
    """``device`` resolved as :func:`resolve_device` does, with its index:
    ``"cuda"`` is the current card, so ``"cuda"`` and ``"cuda:0"`` compare
    equal on a one-card host."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
