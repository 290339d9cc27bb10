"""Order-isomorphic integer keys for floats.

Port of ``_to_ordered_int`` / ``_from_ordered_int`` in
``skdownscale_tpu/ops/pallas/sort_kernel.py``: a float maps to a signed
integer of its width (int32 for float32, int64 for float64) whose signed
order is the total order

    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.

Sign-clear floats keep their bits (already ascending as signed ints);
sign-set floats map to ``~bits ^ MSB``, which reverses their internal order
and places them below every non-negative key.  Sorting the keys and mapping
back is a bitwise-exact float sort in that order.
"""

from __future__ import annotations

import torch

__all__ = ["to_ordered_int", "from_ordered_int", "KEY_DTYPE"]

KEY_DTYPE = {torch.float32: torch.int32, torch.float64: torch.int64}


def _key_dtype(dtype: torch.dtype) -> torch.dtype:
    try:
        return KEY_DTYPE[dtype]
    except KeyError:
        raise TypeError(f"ordered keys need float32 or float64, got {dtype}") from None


def to_ordered_int(x: torch.Tensor) -> torch.Tensor:
    itype = _key_dtype(x.dtype)
    msb = torch.iinfo(itype).min
    bits = x.contiguous().view(itype)
    return torch.where(bits >= 0, bits, torch.bitwise_not(bits) ^ msb)


def from_ordered_int(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if KEY_DTYPE.get(dtype) != k.dtype:
        raise TypeError(f"keys of {k.dtype} do not map to {dtype}")
    msb = torch.iinfo(k.dtype).min
    bits = torch.where(k >= 0, k, torch.bitwise_not(k ^ msb))
    return bits.view(dtype)
