"""The benchmark's command loads no module whose top-level name, compared
whole, is jax, jaxlib, flax or concrete_tpu (concrete_tpu_torch, the
program, is allowed), and reads nothing of benchmarks/ or bench.py: every
module of portbench/ and the program's paths that a run takes are loaded in
a fresh process, which then lists what it holds."""

import json
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

SCRIPT = r'''
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import pathlib, tempfile
from portbench import harness, sweep, control, readers, yardstick, tracing
from portbench import run as run_module
import test_portbench_harness as t
tmp = pathlib.Path(tempfile.mkdtemp())
for i, (cell, loop) in enumerate([("tiny_bool.tiny_mix", "open"),
                                  ("tiny_int4.tiny_mix", "closed")]):
    root, bench = t.tiny_root(tmp / str(i), loop)
    for m in bench["end_to_end"] + bench["per_layer"]:
        harness.load_reader(m["name"], root / "portbench")
    for trace in (False, True):
        out = harness.run(bench, harness.find_cell(bench, cell, root), 3,
                          0.3, trace, "cpu", time.perf_counter(),
                          log=lambda *a: None)
        assert out["correct"], out
print(json.dumps({{"loaded": harness.forbidden_modules(),
                  "port": "concrete_tpu_torch" in sys.modules}}))
'''


def test_no_jax_in_the_process():
    code = SCRIPT.format(root=str(ROOT), tests=str(Path(__file__).parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and out["port"]


def test_forbidden_names_compared_whole(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "concrete_tpu_torch_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_sources_name_no_jax_and_no_old_benchmark():
    words = ("import jax", "from jax", "import concrete_tpu\n",
             "from concrete_tpu import", "from concrete_tpu.", "benchmarks/",
             "bench.py", "BENCH_")
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not [w for w in words if w in text], path
