"""The benchmark's cells at sizes a CPU test holds: every cell of
``workloads/`` with its traffic mix cut to a few cells and a few years,
the days, variables and distributions kept.

A limit that depends on the size is set anew for the small size, by the
rule the cells' limits follow (above the largest sound reading, below the
least reading of the control, nearer the control): MBCn's ``rank_gap``
reads 1.2e-8 to 1.1e-4 for the program in float32 on the CPU over 8 seeds
at 8 cells x 1,461 days (a median over only 24 series swings more than
over 6,144), and 1.32e-3 to 1.36e-3 for the TF32 control on 2; its limit
here is 5e-4.  ``rank_gap_max`` reads up to 8.5e-4 for the program (8
seeds) and 3.3e-3 for the bfloat16 margins (2; the TF32 control 1.7e-3,
which ``rank_gap`` catches); its limit here is 2e-3.  The quantile map's
limits hold at both sizes."""

from __future__ import annotations

import copy

from portbench import catalog

SMALL_CELLS = 8
# the last day of each field's record at the small size
SMALL_END = {"1950-01-01": "1953-12-31", "1981-01-01": "1984-12-31", "2071-01-01": "2074-12-31"}
SMALL_LIMITS = {"rank_gap": 5e-4, "rank_gap_max": 2e-3}


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(catalog.cell(name))
    traffic = cell["traffic"]
    traffic["cells"] = SMALL_CELLS
    for spec in traffic["fields"].values():
        spec["end"] = SMALL_END[spec["start"]]
    cell["limits"].update((k, v) for k, v in SMALL_LIMITS.items() if k in cell["limits"])
    return cell
