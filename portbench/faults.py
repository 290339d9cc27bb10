"""Faults planted in the program underneath the timed path, for the check
that decides ``correct`` to catch (the tests at small sizes; ``control.py``
at a cell's own size):

``unchanged``
    the step returns its state unchanged: the quantile map's transform
    returns its input, MBCn's rotation rounds return the margins;
``half``
    half of the batch left out: the second half of the cells' outputs is
    never written (zeros);
``altered``
    an answer altered where it is produced: the first cell's corrected
    series is off by 0.5 (K, or the variable's unit);
``shuffled``
    the days of a quarter of the cells put out of order (reversed in
    time), as a bad unsort or reorder on some rows would: every value is
    kept, so a check of margins alone cannot see it.

The cells run on one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("unchanged", "half", "altered", "shuffled")


def _spoil(out, fault):
    out = out.clone()
    if fault == "half":
        out[out.shape[0] // 2:] = 0.0
    elif fault == "shuffled":
        q = out.shape[0] // 4
        out[:q] = out[:q].flip(1)
    else:
        out[0] += 0.5
    return out


@contextlib.contextmanager
def planted(system: str, fault: str):
    """The program with ``fault`` planted in ``system``'s timed path."""
    if fault not in FAULTS:
        raise ValueError(f"no fault named {fault!r}")
    if system == "quantile_mapper":
        from skdownscale_tpu_torch.models import quantile as target

        real = target.qm_transform

        def broken(state, x, **kw):
            return x.clone() if fault == "unchanged" else _spoil(real(state, x, **kw), fault)

        with mock.patch.object(target, "qm_transform", broken):
            yield
    elif system == "mbcn":
        from skdownscale_tpu_torch.models import mbc as target

        if fault == "unchanged":
            def broken(y_obs, mh_rows, mf_rows, *rest):
                return mh_rows.transpose(-1, -2), mf_rows.transpose(-1, -2)

            with mock.patch.object(target, "mbcn_iterate", broken):
                yield
        else:
            real = target.mbcn_reorder

            def broken(margin_rows, z_fin):
                return _spoil(real(margin_rows, z_fin), fault)

            with mock.patch.object(target, "mbcn_reorder", broken):
                yield
    else:
        raise ValueError(f"no faults for the system {system!r}")
