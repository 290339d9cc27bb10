"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--out readings.jsonl]

For each seed: the cell's input sets, one job of the program on each (the
timed path's call, as a window runs it), and the check's numbers for its
outputs, the larger of the sets' (as a run judges every set).  For the
first ``--control-seeds`` seeds also: each control of the cell's system
(the plain reference in the program's place, one step below the
configuration's precision), the program with its TF32 switch on where the
system has a TF32 control (a matrix product for TF32 to reach), and the
program with each fault of ``faults.py`` planted.
One JSON line a reading; the last line sums them up: for each variant and
number, the least and largest reading over the seeds.  The benchmark's own
runs do not run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell: dict, seeds, control_seeds: int, device: str, emit):
    """Every reading of the cell on ``seeds`` (see the module's text)."""
    import torch

    from portbench import catalog, faults, generator

    config = cell["config"]
    traffic = cell["traffic"]
    module = catalog.system(config["system"])
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def off(name):
        return contextlib.nullcontext()

    for i, seed in enumerate(seeds):
        system = module.System(config, traffic, seed, device)
        sets = generator.inputs(traffic, seed, device)
        system.run(sets[0], off)  # warm-up
        sync()
        variants = [("program", lambda inp: system.run(inp, off))]
        if i < control_seeds:
            variants += [(f"control:{k}", lambda inp, k=k: system.control(inp, k)) for k in module.CONTROLS]
            if "tf32" in module.CONTROLS:
                variants.append(("program_tf32", lambda inp: with_tf32(lambda: system.run(inp, off))))
            for fault in faults.FAULTS:
                def planted(inp, fault=fault):
                    with faults.planted(config["system"], fault):
                        return system.run(inp, off)
                variants.append((f"fault:{fault}", planted))
        for what, make in variants:
            numbers, made, checked = {}, 0.0, 0.0
            for inp in sets:  # every input set, as a run judges them
                t0 = time.perf_counter()
                out = make(inp)
                sync()
                t1 = time.perf_counter()
                got = system.check(inp, [out])[0]
                numbers = {n: max(numbers.get(n, v), v) for n, v in got.items()}
                made, checked = made + t1 - t0, checked + time.perf_counter() - t1
                del out
            emit({"cell": cell["name"], "seed": seed, "what": what, **numbers, "seconds": made,
                  "check_seconds": checked})
        del sets, system


def with_tf32(fn):
    import torch

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def summary(lines: list) -> dict:
    out = {}
    for line in lines:
        for k, v in line.items():
            if k in ("cell", "seed", "what", "seconds", "check_seconds"):
                continue
            lo, hi = out.setdefault(line["what"], {}).get(k, (float("inf"), float("-inf")))
            out[line["what"]][k] = (min(lo, v), max(hi, v))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import skdownscale_tpu_torch  # noqa: F401  (the program; switches TF32 off)
    from portbench import catalog, harness

    cell = catalog.cell(args.workload)
    if args.device.startswith("cuda"):
        print(f"card: {harness.card_line()}", flush=True)
        harness.build_libraries(cell["config"]["kernels"])
    lines = []
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        lines.append(line)
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    try:
        readings(cell, args.seeds, args.control_seeds, args.device, emit)
    finally:
        if sink:
            sink.close()
    print(json.dumps({"cell": cell["name"], "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
