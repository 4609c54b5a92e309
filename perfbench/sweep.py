"""The knee sweep of an open-loop cell: the highest rate the serving path
sustains, found once on the card.

    python3 perfbench/sweep.py --workload sift-128-euclidean.poisson-packed \
        --seed 7 --seconds 10 --rates 150 200 250 300 350 400

One set-up (data, index, ``Server.start()`` with the traffic file's serving
lattice), then for each rate an open loop of ``--seconds`` with the traffic
file's arrivals at that rate.  Before the server starts it times the full
bucket (the largest batch bucket) of the traffic's search 20 times; with
``--limit-factor f`` the latency limit (the requests' deadline) is ``f``
times that service time's median, rounded up to 10 ms.  A line a rate:
p50 / p95 / p99 latency from due time, the failed share, the generator's
lateness, the queue left when the last request went out, and the backlog's
growth (mean latency of the last third of requests over the first third).
The last line names the knee, the highest rate below the first that fails
(a p95 over the limit or over 1.5 times the lowest rate's p95, where
queueing starts to add to the batches' own time; a request failed; or a
backlog that grows: growth 1.5 or more), and 0.8 of the knee.  The serving
path's pace is the host's, which differs from machine to machine: the
cell's rate is 0.8 of the lowest knee of the sweeps kept in ``PERF.md``.
"""
import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["REPRO_CACHE"] = str(ROOT / ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-factor", type=float, default=None,
                    help="latency limit as a multiple of the full bucket's "
                         "service time (default: the traffic file's limit)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.gen import arrivals, openloop

    dev = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    traffic = dict(cell.traffic)
    inputs = harness.make_inputs(cell.config, args.seed, dev)
    index = harness.build_index(cell.config, inputs, dev)
    scfg = harness.serve_config(traffic)
    params = dataclasses.replace(harness.search_params(traffic), k=scfg.k_max)
    run = index.searcher("local", params, device=dev)
    full = inputs.queries[: scfg.batch_max]
    run(full), run(full)
    ms = []
    for _ in range(20):
        t = time.perf_counter()
        run(full)
        ms.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"service_ms": {"bucket": scfg.batch_max,
                                     "p50": float(np.median(ms)),
                                     "min": min(ms), "max": max(ms)}}), flush=True)
    if args.limit_factor is not None:
        traffic["latency_limit_ms"] = 10 * math.ceil(
            args.limit_factor * float(np.median(ms)) / 10)
        scfg = harness.serve_config(traffic)
    srv = harness._program()["Server"](index, scfg).start()
    p = traffic["params"]
    submit = lambda q: srv.submit(q, k=p["k"], ef=p["ef"], storage=p["storage"])
    limit = float(traffic["latency_limit_ms"])
    knee, held, base = None, True, None
    try:
        for rate in sorted(args.rates):
            tr = dict(traffic, rate_per_s=rate)
            due, picks = arrivals.schedule(tr, args.seed, args.seconds,
                                           len(inputs.queries))
            rec = openloop.new_record(due, picks, time.perf_counter() + 0.05, p["k"])
            openloop.send(rec, submit, inputs.queries, answer=harness.served_answer)
            depth = len(srv.queue)
            openloop.wait_all(rec, time.perf_counter() + 60)
            ok = rec.ok
            lat = rec.latency_s * 1e3
            lat_l = np.where(ok, lat, np.maximum(np.nan_to_num(lat, nan=limit), limit))
            third = max(1, len(lat) // 3)
            late = rec.lateness_s * 1e3
            row = {"rate": rate, "requests": len(lat), "limit_ms": limit,
                   "p50_ms": float(np.percentile(lat_l, 50)),
                   "p95_ms": float(np.percentile(lat_l, 95)),
                   "p99_ms": float(np.percentile(lat_l, 99)),
                   "failed_share": float(1 - ok.mean()),
                   "lateness_p95_ms": float(np.nanpercentile(late, 95)),
                   "lateness_max_ms": float(np.nanmax(late)),
                   "queue_at_last_send": depth,
                   "backlog_growth": float(np.nanmean(lat[-third:])
                                           / np.nanmean(lat[:third]))}
            base = row["p95_ms"] if base is None else base
            print(json.dumps(row), flush=True)
            if (row["p95_ms"] <= min(limit, 1.5 * base) and row["failed_share"] == 0
                    and row["backlog_growth"] < 1.5):
                knee = rate if held else knee
            else:
                held = False
    finally:
        srv.stop()
    print(json.dumps({"knee": knee, "rate": None if knee is None else math.floor(0.8 * knee),
                      "limit_ms": limit, "card": harness.card_name(dev),
                      "power": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
