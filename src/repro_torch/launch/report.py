"""Render the dry-run table from the records of ``launch/dryrun.py``.

The JAX package's ``launch/report.py`` on the port.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.report [--markdown] [--dir DIR]

One row a cell: its status on the 16 x 16 and the 2 x 16 x 16 mesh, and
from the 16 x 16 record the per-rank state of the meta pass (``stateGB``:
weights, optimizer state or cache blocks), ``analytic_memory``'s total
and whether it fits the card (``fitGB``), the collectives' bytes a rank
hands in a step (``collGB``), its FLOPs (``TFLOP``) and the pass's seconds.
The reference follows the table with a roofline section from
``benchmarks/roofline.py``; the ``benchmarks/`` folder is not ported, so
the port prints the table only.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR

HEADER = ("arch", "shape", "16x16", "2x16x16", "stateGB", "fitGB", "collGB", "TFLOP", "pass_s")


def load(mesh: str, dry_dir: Path = DRYRUN_DIR) -> dict:
    recs = {}
    for f in sorted(Path(dry_dir).glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def _status(r) -> str:
    if not r:
        return "-"
    if r.get("skipped"):
        return "SKIP"
    return "OK" if r.get("ok") else "FAIL"


def _row(key, s, m) -> list:
    state = s.get("state") or {}
    total = state.get("total_bytes", sum(v for v in state.values() if isinstance(v, int)))
    ana = s.get("analytic_memory") or {}
    fit = "" if not ana else f"{ana['total_gb']}{'' if ana['fits_hbm'] else '!'}"
    coll = (s.get("collectives") or {}).get("total_bytes")
    ok = s.get("ok")
    return [key[0], key[1], _status(s), _status(m),
            f"{total / 2**30:.3f}" if ok and total else "-", fit,
            f"{coll / 2**30:.3f}" if ok and coll is not None else "-",
            f"{s['flops'] / 1e12:.3f}" if ok and s.get("flops") else "-",
            str(s.get("pass_s", ""))]


def dryrun_table(markdown: bool = False, dry_dir: Path = DRYRUN_DIR) -> str:
    """The table (``fitGB`` ends in ``!`` where the total does not fit the
    card's memory)."""
    single, multi = load("single", dry_dir), load("multi", dry_dir)
    rows = [_row(key, single[key], multi.get(key, {})) for key in sorted(single)]
    if markdown:
        lines = ["| " + " | ".join(HEADER) + " |", "|" + "---|" * len(HEADER)]
        return "\n".join(lines + ["| " + " | ".join(r) + " |" for r in rows])
    widths = [22, 12, 7, 8, 8, 8, 8, 8, 7]
    fmt = lambda r: " ".join(f"{c:{'<' if i < 2 else '>'}{w}s}"
                             for i, (c, w) in enumerate(zip(r, widths)))
    return "\n".join([fmt(list(HEADER))] + [fmt(r) for r in rows])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--dir", default=str(DRYRUN_DIR), help="the dry run's records")
    args = ap.parse_args(argv)
    print("== Dry-run table ==")
    print(dryrun_table(args.markdown, Path(args.dir)))
    print()
    print("(the reference's roofline section reads benchmarks/roofline.py, which the "
          "port does not carry: table only)")
    return 0


if __name__ == "__main__":
    main()
