"""One run of one cell: set-up, the measured window, the judge, the result.

The cell's entry in ``BENCHMARK.json`` names a configuration (its file is
the entry's ``file``), a traffic mix (``traffic/<name>.json``) and, through
the metrics that list it, the readers to call (``metrics/<metric>.py``).
Nothing here belongs to one cell, so a cell, a configuration, a traffic mix
or a metric is added as a file and an entry, never by an edit.

Set-up makes the data on the device from the seed and the index
(``Index.build``; its graph cached in the checkout by configuration, see
:func:`graph_key`), and warms the traffic's own shapes.  A closed loop then sends every query, in a
fresh seeded order, to ``Index.searcher("local", params)`` call after call
until the window ends; an open loop sends single queries through
``serve.Server.submit`` at the schedule's due times.  Once the window has
closed and the peak memory is read, the program is freed, the reference
works out the exact top-``gt_k`` of every evaluation query, and the judge
holds every answer of the window against it.

With ``trace`` the run also records a slice of the window with
``torch.profiler`` (the first calls of a closed loop, the last seconds of an
open one) and the program's serving spans, and reports the per-layer
metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

from perfbench.gen import arrivals, openloop
from perfbench.gen.data import make_vectors
from perfbench.ref import exact, judge as judge_mod
from perfbench.yard import intervals

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
WAIT_AFTER_CLOSE_S = 60.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# -- the cell, from BENCHMARK.json and the files it names ----------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def load_cell(name: str, bench: Path | None = None) -> Cell:
    spec = json.loads((bench or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The reader module of ``metric`` (``metrics/<metric>.py``)."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


# -- what the readers read --------------------------------------------------

@dataclasses.dataclass
class Trace:
    """A profiled slice: device and host events as (name, start_ns, end_ns)
    on the profiler's clock, and the slice's bounds on it."""
    device: list
    host: list
    lo: int
    hi: int

    @property
    def device_intervals(self) -> list:
        return [(s, e) for _, s, e in self.device]


@dataclasses.dataclass
class Context:
    """Everything a metric's reader may read from one run."""
    cell: Cell
    device: torch.device
    setup_s: float
    window_s: float                # the measured window's wall time
    loop: str                      # "closed" | "open"
    calls: list = dataclasses.field(default_factory=list)   # closed loop
    record: openloop.OpenLoopRecord | None = None            # open loop
    latency_limit_ms: float | None = None
    peak_bytes: int = 0            # allocated peak over the window
    recall_at: dict = dataclasses.field(default_factory=dict)
    trace: Trace | None = None     # the profiled slice (trace runs)
    traced_queries: int = 0        # queries answered in the profiled slice
    slice: list | None = None      # open loop: the profiled slice, perf_counter s
    counters: dict = dataclasses.field(default_factory=dict)   # over the slice
    spans: list = dataclasses.field(default_factory=list)      # program spans
    layout_bits: int | None = None # the storage's Dfloat field bits a row
    dim: int = 0
    metric: str = "l2"
    storage: str = "f32"


# -- set-up ----------------------------------------------------------------

def _program():
    """The port's modules the harness drives (imported on first use)."""
    from repro_torch import obs
    from repro_torch.data.synthetic import VecDB
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.serve import ServeConfig, Server
    return dict(obs=obs, VecDB=VecDB, Index=Index, IndexSpec=IndexSpec,
                SearchParams=SearchParams, ServeConfig=ServeConfig,
                Server=Server)


@dataclasses.dataclass
class Inputs:
    rows: np.ndarray      # raw float32 rows (host)
    queries: np.ndarray   # evaluation queries (host)
    train: np.ndarray     # held-out queries (host)
    metric: str


def make_inputs(config: dict, seed: int, device) -> Inputs:
    data = dict(config["data"], name=config["name"])
    v = make_vectors(data, seed, device)
    out = Inputs(rows=v.rows.cpu().numpy(), queries=v.queries.cpu().numpy(),
                 train=v.train.cpu().numpy(), metric=v.metric)
    del v
    return out


def exact_gt(config: dict, rows: torch.Tensor, queries: torch.Tensor,
             metric: str) -> np.ndarray:
    """The reference's exact top-``gt_k`` ids of every evaluation query."""
    k = int(config["data"]["gt_k"])
    return exact.topk(rows, queries, k, metric).cpu().numpy()


def graph_key(config: dict) -> str:
    """The graph cache's key: the configuration's name and a digest of its
    data and index parameters, and never the seed.  A seed only turns the
    configuration's one data set by a rotation (``gen/data.py``), and the
    graph is built on the rows in the index's own PCA basis, where every
    rotation gives the same rows up to each axis's sign: one graph serves
    every seed, so only a checkout's first run of a configuration builds it."""
    digest = hashlib.sha256(json.dumps(
        [config["data"], config["index"]], sort_keys=True).encode()).hexdigest()
    return f"perfbench-{config['name']}-{digest[:16]}"


def build_index(config: dict, inputs: Inputs, device):
    p = _program()
    db = p["VecDB"](name=config["name"], vectors=inputs.rows,
                    queries=inputs.queries, train_queries=inputs.train,
                    metric=inputs.metric, gt=None)
    spec = p["IndexSpec"].for_db(db, **config["index"])
    return p["Index"].build(db, spec, device=device, cache_key=graph_key(config))


def search_params(traffic: dict):
    return _program()["SearchParams"](**traffic["params"])


def serve_config(traffic: dict):
    p = traffic["params"]
    storage = p.get("storage", "f32")
    return _program()["ServeConfig"](
        **traffic["serve"], k_max=p["k"], expand=p.get("expand", 4),
        storages=(storage,), use_dfloat=p.get("use_dfloat", True) or storage != "f32",
        use_fee=p.get("use_fee", True), slo_ms=float(traffic["latency_limit_ms"]),
        degrade=False)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the profiled slice ---------------------------------------------------------

@contextmanager
def profiled(device, out: dict):
    """Profile the block; ``out["trace"]`` then holds its :class:`Trace`,
    bounded by the ``bench.window`` annotation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            yield
        sync(device)
    out["trace"] = parse_trace(prof)


def parse_trace(prof) -> Trace:
    evs = prof.profiler.kineto_results.events()
    dev, host, lo, hi = [], [], None, None
    for e in evs:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith("bench.") and not e.is_user_annotation():
                dev.append((name, s, t))
        else:
            host.append((name, s, t))
            if name == "bench.window":
                lo, hi = s, t
    if lo is None:
        lo = min((s for _, s, _ in host), default=0)
        hi = max((t for _, _, t in host), default=0)
    return Trace(device=dev, host=host, lo=lo, hi=hi)


def annotate(name: str, on: bool):
    if not on:
        return nullcontext
    from torch.profiler import record_function
    return lambda: record_function(name)


# -- the windows ------------------------------------------------------------

def closed_loop(search, inputs: Inputs, cell: Cell, seed: int, seconds: float,
                trace: bool, device, counters, out: dict) -> list:
    """Back-to-back calls of every query in a fresh seeded order until the
    window ends; returns ``[(order, ids, dists, t_start, t_done)]``.  With
    ``trace`` the window's first ``trace.calls`` calls are profiled."""
    orders = arrivals.permutations(seed, len(inputs.queries))
    span = annotate("bench.search.run", trace)

    def call(order):
        ts = time.perf_counter()
        with span():
            res = search(inputs.queries[order])
        return order, res.ids, res.dists, ts, time.perf_counter()

    calls = []
    t0 = time.perf_counter()
    if trace:
        n_traced = int(cell.traffic.get("trace", {}).get("calls", 3))
        before = counters()
        with profiled(device, out):
            for _ in range(n_traced):
                calls.append(call(next(orders)))
        out["counters"] = {k: v - before[k] for k, v in counters().items()}
        out["traced_queries"] = n_traced * len(inputs.queries)
    while not calls or time.perf_counter() - t0 < seconds:
        calls.append(call(next(orders)))
    return calls


def served_answer(resp):
    """A served ``Response``'s ``(ids, dists)``; None for shed or timeout."""
    return (resp.ids, resp.dists) if resp.status == "ok" else None


def open_loop(server, inputs: Inputs, cell: Cell, seed: int, seconds: float,
              trace: bool, device, out: dict) -> openloop.OpenLoopRecord:
    """Single-query requests at the schedule's due times.  With ``trace``
    the last ``trace.seconds`` of sends, and the serving that follows until
    every reply is in, are profiled."""
    due, picks = arrivals.schedule(cell.traffic, seed, seconds,
                                   len(inputs.queries))
    p = cell.traffic["params"]
    k = int(p["k"])
    submit = lambda q: server.submit(q, k=k, ef=p["ef"],
                                     storage=p.get("storage", "f32"))
    t_slice = seconds - float(cell.traffic.get("trace", {}).get("seconds", 1.0))
    cut = int(np.searchsorted(due, t_slice)) if trace else len(due)
    rec = openloop.new_record(due, picks, time.perf_counter() + 0.05, k)
    openloop.send(rec, submit, inputs.queries, 0, cut, answer=served_answer)
    if trace:
        out["slice"] = [time.perf_counter(), None]
        with profiled(device, out):
            openloop.send(rec, submit, inputs.queries, cut, answer=served_answer,
                          sleep_span=annotate("bench.gen.sleep", True),
                          submit_span=annotate("bench.serve.submit", True))
            openloop.wait_all(rec, time.perf_counter() + WAIT_AFTER_CLOSE_S)
        out["slice"][1] = time.perf_counter()
        done = rec.done
        out["traced_queries"] = int(((done >= out["slice"][0])
                                     & (done <= out["slice"][1])).sum())
    return rec


# -- the run ----------------------------------------------------------------

class gc_pauses:
    """Times the collector's full (oldest-generation) collections while
    registered in ``gc.callbacks``: each stops every thread of the server."""

    def __init__(self):
        self.ms, self._t = [], None
        gc.callbacks.append(self.record)

    def record(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms.append((time.perf_counter() - self._t) * 1e3)


def card_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float | None = None,
             patch=None) -> dict:
    """One run; returns the result line's object.  ``patch(index, program)``
    (tests only) may break the timed path after the index is built."""
    t_start = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic, config = cell.traffic, cell.config
    loop = traffic["loop"]
    p = _program()

    t = time.perf_counter()
    inputs = make_inputs(config, seed, device)
    log(f"data: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    index = build_index(config, inputs, device)
    log(f"index build: {time.perf_counter() - t:.2f} s {json.dumps(index.timings)}")
    log("dfloat layout (start, dims, exp, man, bias): "
        f"{[dataclasses.astuple(s) for s in index.dfloat_cfg.segments]}")
    if patch is not None:
        patch(index, p)

    reg = p["obs"].default_registry()
    names = ("search.queries", "search.hops", "search.lanes_evaluated",
             "search.dims_touched", "search.dims_possible")
    counters = lambda: {k: reg.counter(k).value for k in names}
    server = search = None
    if loop == "closed":
        search = index.searcher("local", search_params(traffic), device=device)
        for _ in range(2):                       # builds, loads, then steady
            search(inputs.queries)
    elif loop == "open":
        server = p["Server"](index, serve_config(traffic)).start()
    else:
        raise ValueError(f"unknown loop {loop!r}")
    if trace:
        with profiled(device, {}):   # the profiler's own start-up
            torch.ones(1, device=device).add_(1)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.2f} s")

    out: dict = {}
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        p["obs"].enable_tracing(capacity=1 << 21)
        p["obs"].tracer.clear()
    c_w = counters()
    pauses = gc_pauses()
    t_w = time.perf_counter()
    try:
        if loop == "closed":
            calls = closed_loop(search, inputs, cell, seed, seconds, trace,
                                device, counters, out)
            rec = None
            window_s = calls[-1][4] - t_w
        else:
            rec = open_loop(server, inputs, cell, seed, seconds, trace, device, out)
            calls = []
            n_left = openloop.wait_all(rec, time.perf_counter() + WAIT_AFTER_CLOSE_S)
            window_s = float(np.nanmax(rec.done) - t_w) if len(rec.due) else seconds
        sync(device)
        c_end = counters()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        gc.callbacks.remove(pauses.record)
        if server is not None:
            server.stop()
    log(f"full collections in the window: {len(pauses.ms)}, "
        f"ms {[round(x, 1) for x in pauses.ms]}")
    spans = p["obs"].tracer.spans() if trace else []
    p["obs"].disable_tracing()
    layout_bits = (index.dfloat_cfg.total_bits()
                   if traffic["params"].get("storage", "f32") != "f32" else None)
    dim = index.dim
    del search, server, index
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the judge, after the window, with the program's state freed
    k = int(traffic["params"]["k"])
    if loop == "closed":
        qidx = np.concatenate([c[0] for c in calls])
        ids = np.concatenate([np.asarray(c[1])[:, :k] for c in calls])
        dists = np.concatenate([np.asarray(c[2])[:, :k] for c in calls])
        attempted, failed, missing = len(qidx), 0, 0
    else:
        qidx, ids, dists = rec.picks[rec.ok], rec.ids[rec.ok], rec.dists[rec.ok]
        attempted = len(rec.due)
        missing = int(np.isnan(rec.done).sum())
        failed = attempted - int(rec.ok.sum())
        if rec.errors:
            log(f"{len(rec.errors)} requests raised; the first: {rec.errors[0]}")
    t = time.perf_counter()
    rows_d = torch.from_numpy(inputs.rows).to(device)
    q_d = torch.from_numpy(inputs.queries).to(device)
    gt = exact_gt(config, rows_d, q_d, inputs.metric)
    numbers = judge_mod.judge(rows_d, q_d, qidx, ids, dists, inputs.metric,
                              n_missing=missing, gt=gt, k=k)
    del rows_d, q_d
    correct, checks = judge_mod.verdict(numbers, config["limits"])
    log(f"reference and judge: {time.perf_counter() - t:.2f} s")

    ctx = Context(cell=cell, device=device, setup_s=setup_s, window_s=window_s,
                  loop=loop, calls=calls, record=rec,
                  latency_limit_ms=traffic.get("latency_limit_ms"),
                  peak_bytes=peak, trace=out.get("trace"),
                  traced_queries=out.get("traced_queries", 0),
                  counters=out.get("counters", {}), spans=spans,
                  layout_bits=layout_bits, dim=dim, metric=inputs.metric,
                  storage=traffic["params"].get("storage", "f32"))
    ctx.recall_at[k] = numbers[f"recall_at_{k}"]
    if loop == "open":
        ctx.slice = out.get("slice")
        lat = rec.latency_s * 1e3
        late = rec.lateness_s * 1e3
        log("open loop: " + json.dumps({
            "requests": attempted, "served": int(rec.ok.sum()), "failed": failed,
            "unresolved": missing,
            "lateness_ms": {q: float(np.nanpercentile(late, q)) for q in (50, 95, 99, 100)},
            "latency_ms": {q: float(np.nanpercentile(lat, q)) for q in (50, 95, 99)}}))
    else:
        ms = [1e3 * (c[4] - c[3]) for c in calls]
        c = {k: v - c_w[k] for k, v in c_end.items()}
        nq = max(c["search.queries"], 1)
        cut = [len(calls) * i // 3 for i in range(4)]
        thirds = [sum(len(c[0]) for c in calls[a:b]) / (calls[b - 1][4] - calls[a][3])
                  for a, b in zip(cut, cut[1:]) if b > a]
        log(f"closed loop: {len(calls)} calls of {len(calls[0][0])} queries, "
            f"call ms p50 {np.median(ms):.2f} min {min(ms):.2f} max {max(ms):.2f}, "
            f"qps by thirds of the window {[round(x, 1) for x in thirds]}, "
            f"hops a query {c['search.hops'] / nq:.3f}, "
            f"lanes a query {c['search.lanes_evaluated'] / nq:.2f}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card_name(device), "count": cell.chips,
           "memory_peak_bytes": int(max(peak, setup_peak))}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        tr = ctx.trace
        dev["busy_s"] = intervals.busy(tr.device_intervals, tr.lo, tr.hi) / 1e9
        dev["window_s"] = (tr.hi - tr.lo) / 1e9
        result["breakdown"] = breakdown(tr)
    log(f"card: {power_limit()}")
    result["checks"] = checks
    return result


# host events that name no work of the program: the benchmark's spans, the
# CUDA runtime and driver calls, the profiler's own buffers
HOST_PLUMBING = ("bench.", "cuda", "cu", "Activity Buffer", "Buffer Flush")


def breakdown(tr: Trace) -> dict:
    """The traced slice's costliest device operations and its longest idle
    gaps, each gap named by the benchmark span it fell in and the host
    operation (not a runtime call) that started last before it."""
    by = {}
    for name, s, e in tr.device:
        by[name] = by.get(name, 0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    bench = [(n, s, e) for n, s, e in tr.host
             if n.startswith("bench.") and n != "bench.window"]
    inner = sorted((s, n) for n, s, _ in tr.host if not n.startswith(HOST_PLUMBING))
    starts = [s for s, _ in inner]
    gaps = []
    for s, e in intervals.gaps(tr.device_intervals, tr.lo, tr.hi)[:10]:
        mid = (s + e) // 2
        span = max((b for b in bench if b[1] <= mid < b[2]), key=lambda b: b[1],
                   default=("bench.window", 0, 0))[0]
        i = bisect.bisect_right(starts, s) - 1
        op = inner[i][1] if i >= 0 else "nothing"
        gaps.append([f"{span} after {op}"[:120], (e - s) / 1e9])
    return {"device_ops": [[n[:120], v / 1e9] for n, v in ops], "idle_gaps": gaps}
