"""The yardstick of the kernels' roofline shares: the card's published
peaks, a kernel's least time, the shapes of the launches a traced window
made, and the share of the least time the window reached.

Each ``roofline/<kernel>.py`` names the functions of the kernel in
``skdownscale_tpu_torch/csrc`` (:data:`NAMES`), the program's one-launch
functions of the kernel, each with the shape its arguments give
(:data:`LAUNCH`: ``(module, function) -> shape(*args)``), and its
operations and compulsory bytes for one launch (``cost(**shape)``): each
input byte read once, each output byte written once, for these inputs.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

# NVIDIA H100 SXM data sheet, dense, at the card's full 700 W: HBM3 bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time the card could take for ``n_ops`` float32 operations
    and ``n_bytes`` of compulsory traffic: the larger of the two."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


@contextlib.contextmanager
def recording(kernels, shapes: dict):
    """While open, each launch that the program makes of one of ``kernels``
    appends its shape to ``shapes[kernel]``: the program's one-launch
    functions are wrapped where the kernels' wrappers look them up.  A
    function the program no longer has is left out, and that kernel's share
    goes silent."""
    from .. import catalog

    with contextlib.ExitStack() as stack:
        for kernel in kernels:
            for (module_name, fn_name), shape in catalog.roofline(kernel).LAUNCH.items():
                module = importlib.import_module(module_name)
                real = getattr(module, fn_name, None)
                if real is None:
                    continue

                @functools.wraps(real)
                def launch(*args, _real=real, _shape=shape, _into=shapes.setdefault(kernel, [])):
                    _into.append(_shape(*args))
                    return _real(*args)

                stack.enter_context(_patched(module, fn_name, launch))
        yield shapes


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def share(ctx, kernel: str) -> float | None:
    """The kernel's roofline share in the traced window, in %: the bound of
    every launch the window recorded over the device time of the kernel's
    functions.  None where the window recorded no launch of it or timed
    none of its functions."""
    from .. import catalog

    mod = catalog.roofline(kernel)
    shapes = (ctx.launch_shapes or {}).get(kernel, [])
    device_s = sum(s for name, s in (ctx.kernel_s or {}).items() if name in mod.NAMES)
    if not shapes or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*mod.cost(**s)) for s in shapes) / device_s
