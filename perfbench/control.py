"""The control: the plain reference computed in bfloat16, put in the
program's place, must come out as not correct; and the planted faults that
only the recall floor can catch.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 20]
    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 --fault ef_half

For each seed it makes the cell's data and exact neighbours as a run does,
and answers the queries a run's window answers (every evaluation query for
a closed loop; the schedule's picks over ``--seconds`` for an open one):
with the exact search in bfloat16 (``ref/exact.py::control_topk``), or,
with ``--fault``, with the program's own search at the traffic's
parameters (``sound``) or with its beam width halved (``ef_half``), whose
answers keep exact distances and lose neighbours.  It holds the answers
against the reference with the run's judge and the configuration's limits,
and prints one JSON line a seed.  The benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["REPRO_CACHE"] = str(ROOT / ".cache")


def program_answers(cell, inputs, qidx, fault: str, device):
    """The program's answers to ``qidx`` at the traffic's parameters, or
    with ``ef_half`` at half its beam width."""
    import dataclasses

    from perfbench import harness

    index = harness.build_index(cell.config, inputs, device)
    params = harness.search_params(cell.traffic)
    if fault == "ef_half":
        params = dataclasses.replace(params, ef=params.ef // 2)
    res = index.searcher("local", params, device=device)(inputs.queries[qidx])
    return res.ids, res.dists


def control_numbers(cell, seed: int, seconds: float, device,
                    fault: str | None = None) -> dict:
    import gc

    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.gen import arrivals
    from perfbench.ref import exact, judge

    inputs = harness.make_inputs(cell.config, seed, device)
    k = int(cell.traffic["params"]["k"])
    if cell.traffic["loop"] == "open":
        qidx = arrivals.schedule(cell.traffic, seed, seconds, len(inputs.queries))[1]
    else:
        qidx = np.arange(len(inputs.queries))
    if fault is None:
        rows = torch.from_numpy(inputs.rows).to(device)
        queries = torch.from_numpy(inputs.queries).to(device)
        ids, dists = exact.control_topk(
            rows, queries[torch.as_tensor(qidx, device=device)], k, inputs.metric)
        ids, dists = ids.numpy(), dists.numpy()
    else:
        ids, dists = program_answers(cell, inputs, qidx, fault, device)
        ids, dists = np.asarray(ids)[:, :k], np.asarray(dists)[:, :k]
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows = torch.from_numpy(inputs.rows).to(device)
        queries = torch.from_numpy(inputs.queries).to(device)
    gt = harness.exact_gt(cell.config, rows, queries, inputs.metric)
    numbers = judge.judge(rows, queries, qidx, ids, dists, inputs.metric,
                          gt=gt, k=k)
    correct, checks = judge.verdict(numbers, cell.config["limits"])
    return dict(seed=seed, fault=fault or "bfloat16", answers=len(qidx),
                correct=correct, **{n: c["value"] for n, c in checks.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", choices=("sound", "ef_half"), default=None,
                    help="answer with the program (sound or broken) instead "
                         "of the bfloat16 reference")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(cell, seed, args.seconds, torch.device(args.device),
                              fault=args.fault)
        out["s"] = time.perf_counter() - t
        print(json.dumps({"control": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
