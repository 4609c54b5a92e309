"""What the benchmark imports: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), and the reference nothing of the program."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_closure_leaves_jax_and_the_jax_package_out():
    mods = _modules(
        "import runpy, sys\n"
        "sys.argv = ['run.py']\n"
        "runpy.run_path('perfbench/run.py', run_name='not_main')\n"
        "from perfbench import harness, control, sweep\n"
        "harness._program()\n"
        "import json as j\n"
        "spec = j.load(open('BENCHMARK.json'))\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])\n")
    top = {m.split(".")[0] for m in mods}
    assert "repro_torch" in top and "perfbench" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    mods = _modules("import perfbench.ref.exact, perfbench.ref.judge, "
                    "perfbench.gen.data, perfbench.gen.arrivals, "
                    "perfbench.gen.openloop, perfbench.yard.intervals, "
                    "perfbench.yard.launches, perfbench.yard.fee_bytes, "
                    "perfbench.yard.peaks")
    top = {m.split(".")[0] for m in mods}
    assert not top & (FORBIDDEN | {"repro_torch"}), sorted(top & (FORBIDDEN | {"repro_torch"}))


def test_no_benchmark_source_names_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, (path, line)


def test_run_refuses_a_result_with_jax_loaded(monkeypatch, capsys):
    """Past the window, a process holding a module named ``jax`` (or
    ``repro``) prints no result and exits non-zero."""
    import types

    import torch

    from perfbench import harness, run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    for name in ("jax", "repro"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert run.main(["--workload", "sift-128-euclidean.batch-packed",
                         "--seed", "1", "--seconds", "1"]) == 3
        assert capsys.readouterr().out == ""
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "sift-128-euclidean.batch-packed",
                     "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
