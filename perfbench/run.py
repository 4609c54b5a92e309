"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (data, exact neighbours, the index,
the warm-up) counts as ``setup_s``; the window then runs for ``--seconds``;
the judge holds every answer of the window against the plain reference.
The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2; with ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` loaded once the window has closed, with 3.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the program's artifact cache (the index graph): one fixed directory in
# the checkout, which the program reads when it is first imported
os.environ["REPRO_CACHE"] = str(ROOT / ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        floor = " (at least)" if c.get("at_least") else ""
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}{floor}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
