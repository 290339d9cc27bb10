"""Where the global models put their arrays: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch

# the multi-device layer the sharded paths wait for
MULTI_DEVICE_ITEM = "ROADMAP Queue 1 A item 5"


def resolve(device, who: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the card (device='cuda'), and torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU in the input's dtype"
        )
    return dev


def as_tensor(a, device, who: str) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device``: float32 on
    the card, its own float dtype on the CPU."""
    if isinstance(a, torch.Tensor):
        return a
    dev = resolve(device, who)
    arr = np.asarray(a)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dev, torch.float32) if dev.type == "cuda" else t
