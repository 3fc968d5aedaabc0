"""The port must run where JAX is absent: importing every module of
concrete_tpu_torch (parallel/ and examples/ included), chip_smoke.py and the
kernel sweeps (tools/k*_sweep.py) loads neither jax nor concrete_tpu, and
has no side effect: nothing printed, no process started, no process group
joined."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import contextlib, importlib, io, multiprocessing, pkgutil, sys
import torch.distributed as dist
import concrete_tpu_torch
names = [m.name for m in pkgutil.walk_packages(concrete_tpu_torch.__path__,
                                               prefix="concrete_tpu_torch.")]
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    for name in names:
        importlib.import_module(name)
assert not printed.getvalue(), printed.getvalue()
assert not multiprocessing.active_children()
assert not dist.is_initialized()
import chip_smoke
import importlib.util, pathlib
for path in sorted(pathlib.Path("tools").glob("k*_sweep.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "concrete_tpu" or m.startswith("concrete_tpu."))
print(len(names), bad)
assert len(names) >= 61, names
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
