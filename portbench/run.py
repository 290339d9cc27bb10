"""Run one cell of the benchmark of ``skdownscale_tpu_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the card's name and power limit, then,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with
``--trace 1`` ``breakdown``) and last ``check``, each number compared with
its limit; the same numbers are the last lines of standard error.  Exits
with another code than 0, and prints no result, where there is no card or
fewer cards than the cell asks for, where the program is not beside this
folder, and where JAX or the JAX package is loaded once the window has
closed.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import skdownscale_tpu_torch  # noqa: F401  (the program under test, beside this folder)
    from portbench import catalog, harness

    cell = catalog.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         started=STARTED, log=lambda s: print(s, file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the process that prints the result", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
