"""Host-side sliding-window plan for overlapping fit groups.

Host copy of ``skdownscale_tpu/models/slide.py``.  The daily-NASA-NEX
predict consults an ordered run of overlapping +/-15-day DOY fit windows
(ref ``bcsd.py:51-53,69-79``: day-of-month keys looked up in the day-of-year
table select DOYs 1..31); adjacent windows differ by one leaving and one
entering day-bucket (about ``n_years`` rows each).  :func:`build_slide_plan`
derives those per-step member diffs as set differences of the
``PaddedGroups`` rows, and the slide kernel K5
(:mod:`..kernels.slide_sort`) turns them into one sorted-window slide
instead of one sort per window.

The widths ``Lto`` and ``Wp`` are rounded to multiples of 8, the TPU
kernel's sublane tile.  The rounding is kept so that the plan stays bitwise
the JAX package's; the port's kernel writes rows ``Lto`` wide too, so the
flat output and :func:`consulted_groups` keep the JAX package's layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.timeindex import PaddedGroups

__all__ = ["SlidePlan", "build_slide_plan", "consulted_groups"]


class SlidePlan(NamedTuple):
    """Step tables for the sliding sorted window (all host numpy, -1 pads).

    ``consulted[i]`` is the fit row whose sorted values land in output row
    ``i``; ``w0_idx`` lists window 0's members padded to the state width
    ``Wp``; ``add_idx``/``rem_idx`` (n_windows-1, BW) list the members
    entering/leaving at each step.  Every row lists its members in
    ascending order, then its -1 pads.
    """

    consulted: np.ndarray  # (n_windows,) int32 fit-row ids, ascending
    w0_idx: np.ndarray  # (Wp,) int32 time indices, -1 padded
    add_idx: np.ndarray  # (S, BW) int32
    rem_idx: np.ndarray  # (S, BW) int32
    Lt: int  # true window width (= fit.indices.shape[1])

    @property
    def Lto(self) -> int:
        """Output row width: ``Lt`` rounded up to a multiple of 8."""
        return -(-self.Lt // 8) * 8

    def __hash__(self):
        return hash(
            (
                self.consulted.tobytes(),
                self.w0_idx.tobytes(),
                self.add_idx.tobytes(),
                self.rem_idx.tobytes(),
                self.Lt,
            )
        )

    def __eq__(self, other):
        if not isinstance(other, SlidePlan):
            return NotImplemented
        return hash(self) == hash(other)


def _pad_row(vals, width):
    out = np.full(width, -1, np.int32)
    out[: len(vals)] = np.sort(np.asarray(list(vals), np.int64)).astype(np.int32)
    return out


def build_slide_plan(
    fit: PaddedGroups, t2f: np.ndarray, *, max_bucket: int = 48
) -> SlidePlan | None:
    """Build a :class:`SlidePlan` for the consulted windows, or ``None``.

    ``t2f`` maps transform groups to fit rows (``_match_keys`` output).
    Returns ``None`` unless every adjacent pair of consulted windows (fit
    rows in ascending order) differs by at most ``max_bucket`` members on
    each side, and there is more than one window to share work between.
    """
    consulted = np.unique(np.asarray(t2f, np.int64))
    if len(consulted) < 2:
        return None
    Lt = int(fit.indices.shape[1])
    members = [set(fit.indices[g, : int(fit.counts[g])].tolist()) for g in consulted]
    adds, rems = [], []
    bw = 0
    for prev, cur in zip(members[:-1], members[1:]):
        a, r = cur - prev, prev - cur
        bw = max(bw, len(a), len(r))
        if bw > max_bucket:
            return None
        adds.append(a)
        rems.append(r)
    BW = max(8, -(-bw // 8) * 8)
    Wp = -(-(Lt + BW) // 8) * 8
    if len(members[0]) > Wp - BW:  # pragma: no cover - Lt bounds real counts
        return None
    return SlidePlan(
        consulted=consulted.astype(np.int32),
        w0_idx=_pad_row(members[0], Wp),
        add_idx=np.stack([_pad_row(a, BW) for a in adds]),
        rem_idx=np.stack([_pad_row(r, BW) for r in rems]),
        Lt=Lt,
    )


def consulted_groups(fit: PaddedGroups, plan: SlidePlan) -> PaddedGroups:
    """The fit groups restricted to the plan's consulted rows, re-keyed so
    that row ``i`` matches output row ``i`` of the slide kernel.

    Rows are widened from ``Lt`` to ``Lto`` so downstream group tables
    stride exactly over the kernel's flat output; the extra slots are masked
    padding."""
    rows = plan.consulted.astype(np.int64)
    pad = plan.Lto - plan.Lt
    idx = np.pad(fit.indices[rows], ((0, 0), (0, pad)))
    mask = np.pad(fit.mask[rows], ((0, 0), (0, pad)))
    return PaddedGroups(
        indices=idx,
        mask=mask,
        counts=fit.counts[rows],
        keys=fit.keys[rows],
    )
