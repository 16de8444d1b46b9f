"""The port stands alone: importing every module of vec_ode_tpu_torch
loads neither jax nor the JAX package, and builds no kernel; neither the
package nor the scripts that drive it on a card (chip_smoke.py,
tools/profile_solve.py) import them."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vec_ode_tpu_torch"

# the modules of the adjoint and generic exponential paths, beside the
# earlier ones
MODULES = ["diff", "ops.adjoint", "ops.expm", "ops.dense_chains", "ops.cplx", "ops.expmv",
           "ops.fused_rk", "ops.fused_loop", "exp.protocol", "exp.leaves",
           "exp.dense_fast", "exp.magnus", "exp.cfm", "exp.split_solvers",
           "exp.modulated", "models.quantum", "parallel.ensemble", "convert"]

PROBE = f"MODULES = {MODULES!r}" + """
import importlib, pkgutil, sys
import vec_ode_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               "vec_ode_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in MODULES:
    assert "vec_ode_tpu_torch." + name in names, name
from vec_ode_tpu_torch.ops import _build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vec_ode_tpu"))
print("BAD", bad, "LOADED", sorted(_build._loaded))
sys.exit(1 if bad or _build._loaded else 0)
"""


def test_import_loads_no_jax_and_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vec_ode_tpu)\b"
                         r"(?!_torch)", re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 10
    for name in MODULES:
        assert PKG / (name.replace(".", "/") + ".py") in sources, name
    sources += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_solve.py"]
    for path in sources:
        assert not pattern.search(path.read_text()), path
