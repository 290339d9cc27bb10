"""Hand-written CUDA kernels for Hopper, their build helper, wrappers and
plain PyTorch versions.

Every wrapper dispatches the same way: a tensor on the CPU goes to the
plain version, a CUDA float32 tensor launches the kernel, anything else
raises.  :data:`LAUNCHES` counts kernel launches by name, one per launch,
and nothing else.
"""

from __future__ import annotations

import collections
import ctypes

import torch

__all__ = ["LAUNCHES"]

LAUNCHES: collections.Counter = collections.Counter()


def on_kernel(*ts: torch.Tensor) -> bool:
    """True for CUDA float32 (kernel), False for CPU (plain); raises else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(t.dtype != torch.float32 for t in ts):
        raise TypeError(
            f"the CUDA kernel takes float32 tensors on a CUDA device, got "
            f"{[t.dtype for t in ts]} on {dev}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    return True


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.sdt_error_string(rc).decode()} ({rc})")
