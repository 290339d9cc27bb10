"""``QuantileMapper(detrend=True)`` driven through the program's batch-native
entries, and judged against the plain reference.

A job is ``models.batched.batched_fit`` on the input set's ``fit`` field
then ``batched_transform`` of its ``transform`` field: the entries that the
grid runner and the store pipeline call on a pass of valid cells already on
the card.  Its output is ``(cells, days)``.

The check works the reference (:mod:`portbench.reference.quantile_mapper`)
out in float64 on the same device, in blocks of cells, from the same two
fields, and compares every value of each output kept from the window:

``mean_gap_K``
    the worst cell's mean ``|output - reference|`` (K);
``max_gap_K``
    the widest single ``|output - reference|`` (K).

A NaN in an output counts as an infinite gap.
"""

from __future__ import annotations

import torch

from ..reference import quantile_mapper as ref

FIELDS = ("fit", "transform")
NUMBERS = ("mean_gap_K", "max_gap_K")
# the reference in the program's place, a step below the configuration's
# float32 (bfloat16: the path has no matrix product for TF32 to reach)
CONTROLS = ("bf16",)
# float64 elements of one block of the reference: 48M (384 MB an array)
BLOCK_ELEMENTS = 48 * 2**20


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import skdownscale_tpu_torch as sdt
        from skdownscale_tpu_torch.models import batched

        self.batched = batched
        self.model = sdt.QuantileMapper(detrend=True, qt_kwargs=dict(config["qt_kwargs"]))

    def run(self, inp: dict, span) -> tuple:
        with span("qm.fit"):
            state = self.batched.batched_fit(self.model, None, inp["fit"][..., None], None)
        with span("qm.transform"):
            out = self.batched.batched_transform(self.model, state, None, inp["transform"][..., None], None)
        return (out,)

    def control(self, inp: dict, kind: str) -> tuple:
        """The reference in the program's place, in bfloat16 (``"bf16"``)."""
        dtype = {"bf16": torch.bfloat16}[kind]
        fit, x = inp["fit"], inp["transform"]
        rows = max(1, BLOCK_ELEMENTS // max(x.shape[1], fit.shape[1]))
        return (torch.cat([ref.qm_detrend(fit[lo:lo + rows], x[lo:lo + rows], dtype=dtype).float()
                           for lo in range(0, x.shape[0], rows)]),)

    def check(self, inp: dict, outputs: list) -> list[dict]:
        """The numbers of :data:`NUMBERS` of each output in ``outputs``
        (each a job's tuple on this input set)."""
        fit, x = inp["fit"], inp["transform"]
        rows = max(1, BLOCK_ELEMENTS // max(x.shape[1], fit.shape[1]))
        numbers = [dict.fromkeys(NUMBERS, 0.0) for _ in outputs]
        for lo in range(0, x.shape[0], rows):
            want = ref.qm_detrend(fit[lo:lo + rows], x[lo:lo + rows])
            for (out,), got in zip(outputs, numbers):
                gap = (out[lo:lo + rows].double() - want).abs().nan_to_num(nan=float("inf"))
                got["mean_gap_K"] = max(got["mean_gap_K"], gap.mean(dim=1).max().item())
                got["max_gap_K"] = max(got["max_gap_K"], gap.max().item())
            del want
        return numbers
