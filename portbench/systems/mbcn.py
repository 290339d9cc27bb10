"""MBCn driven through the program's batch-native ``models.mbc.mbcn_correct``
on one chunk of cells already on the card, and judged against the plain
reference.

A job is one ``mbcn_correct(obs, hist, fut, rotations, kinds=...)`` call:
the chunk that ``mbcn_grid(cell_chunk_size=...)`` issues.  Its outputs are
the corrected hist and fut blocks, ``(cells, days, variables)`` each.  The
rotation stack is drawn from the seed by the reference's copy of the
algorithm, and both sides get the same stack.

The check works the reference (:mod:`portbench.reference.mbcn`) out in
float64 on the same device, in blocks of cells, and compares every
(cell, variable) series of both outputs of each job kept from the window:

``rank_gap``
    the median over the series of ``1 - Spearman`` between the output's
    ranks in time and the reference's (the larger of the hist and fut
    medians): the dependence structure that the rotations build.  In
    float32 the twenty rounds drift chaotically from float64 (a near-tie
    swaps two ranks, the next rotation spreads the swap), so a single
    series swings from seed to seed; the median over thousands does not;
``rank_gap_max``
    the largest ``1 - Spearman`` over the series of both outputs: a fault
    that puts the days of a few series out of order (a bad unsort or
    reorder on some rows) keeps every margin and leaves the median alone,
    and shows here;
``margin_gap``
    the largest ``|sorted output - sorted reference|`` of a series: each
    output series must be a permutation of its QDM margin.

A NaN in an output counts as an infinite gap and a rank far off.
"""

from __future__ import annotations

import torch

from .. import generator
from ..reference import mbcn as ref

FIELDS = ("obs", "hist", "fut")
NUMBERS = ("rank_gap", "rank_gap_max", "margin_gap")
# the reference in the program's place with one stage a step below the
# configuration's precision
CONTROLS = ("tf32", "bf16_margins")
# float64 (cell, day, variable) elements of one block of the reference
BLOCK_ELEMENTS = 64 * 2**20


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from skdownscale_tpu_torch.models import mbc

        self.mbc = mbc
        self.config = config
        d = int(config["variables"])
        self.kinds = (config["kind"],) * d
        self.rotations_host = ref.rotations(d, int(config["n_iterations"]), generator.system_seed(seed))
        self.rotations = torch.as_tensor(self.rotations_host, dtype=torch.float32, device=device)

    def run(self, inp: dict, span) -> tuple:
        with span("mbcn.correct"):
            return self.mbc.mbcn_correct(
                inp["obs"], inp["hist"], inp["fut"], self.rotations, kinds=self.kinds,
                extrapolate=self.config["extrapolate"], n_endpoints=int(self.config["n_endpoints"]),
            )

    def control(self, inp: dict, kind: str) -> tuple:
        """The reference in the program's place, one stage a step below the
        configuration's precision: ``"tf32"`` (the rotation products'
        operands in TF32) or ``"bf16_margins"`` (the QDM margins in
        bfloat16)."""
        kw = {"tf32": dict(dtype=torch.float32, tf32=True),
              "bf16_margins": dict(dtype=torch.float32, margin_dtype=torch.bfloat16)}[kind]
        return self._blocks(inp, lambda o, h, f: ref.mbcn(o, h, f, self.rotations_host, **kw))

    def _blocks(self, inp, fn):
        C = inp["hist"].shape[0]
        step = self._rows(inp)
        parts = [fn(*(inp[k][lo:lo + step] for k in FIELDS)) for lo in range(0, C, step)]
        return tuple(torch.cat([p[i].float() for p in parts]) for i in range(2))

    def _rows(self, inp):
        C, n, d = inp["hist"].shape
        return max(1, BLOCK_ELEMENTS // (d * max(n, inp["obs"].shape[1], inp["fut"].shape[1])))

    def check(self, inp: dict, outputs: list) -> list[dict]:
        """The numbers of :data:`NUMBERS` of each output in ``outputs``
        (each a job's ``(hist, fut)`` on this input set)."""
        C = inp["hist"].shape[0]
        step = self._rows(inp)
        gaps = [([], []) for _ in outputs]  # 1 - Spearman of each series: hist, fut
        margin = [0.0 for _ in outputs]
        for lo in range(0, C, step):
            wants = ref.mbcn(*(inp[k][lo:lo + step] for k in FIELDS), self.rotations_host)
            for j, outs in enumerate(outputs):
                for i, want in enumerate(wants):
                    got = outs[i][lo:lo + step].double()
                    gaps[j][i].append(spearman_gap(got, want))
                    sg = (torch.sort(got, dim=1).values - torch.sort(want, dim=1).values).abs()
                    margin[j] = max(margin[j], sg.nan_to_num(nan=float("inf")).max().item())
            del wants
        return [{"rank_gap": max(torch.cat(g).median().item() for g in gaps[j]),
                 "rank_gap_max": max(torch.cat(g).max().item() for g in gaps[j]), "margin_gap": margin[j]}
                for j in range(len(outputs))]


def ranks(a: torch.Tensor) -> torch.Tensor:
    """Ranks in time (dim 1) of each series, ties in time order; NaN last."""
    return torch.argsort(torch.argsort(a.nan_to_num(nan=float("inf")), dim=1, stable=True), dim=1, stable=True)


def spearman_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``1 - Spearman`` of each (cell, variable) series, flattened; a
    series with a NaN reads 2 (the most a rank correlation can be off)."""
    T = got.shape[1]
    diff = (ranks(got) - ranks(want)).double()
    rho = 1.0 - 6.0 * (diff * diff).sum(dim=1) / (T * (T * T - 1.0))
    gap = 1.0 - rho
    return torch.where(torch.isnan(got).any(dim=1), torch.full_like(gap, 2.0), gap).reshape(-1)
