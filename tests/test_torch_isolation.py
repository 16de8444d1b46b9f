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
# earlier ones, and those of the front door (rk, api, the models, the
# splits); NAMES, what the order-6 / CFM modulated path, the events and
# dense output, the black-box front door (auto_modulated, ChebForm),
# quadrature, the front door and the rest of the adjoint (basis gradients,
# the dense adjoint, K8's term groups, the kernels' operators, fit_loop)
# added to them
NAMES = {"exp": ["MagnusModulated6", "CFMModulated", "CFM4Modulated",
                 "CfmTable"],
         "models": ["Lindblad"],
         "ops.expmv": ["CfmTable", "identity_rows", "n_rows", "n_nodes",
                       "ChebForm", "MAX_KP"],
         "ops.adjoint": ["ROW_MAX_KP", "row_plan", "kernel_row_plan",
                         "bwd_group", "BWD_GROUP_TERMS", "sweep_fwd_op",
                         "sweep_bwd_op", "row_op"],
         "diff": ["make_adjoint_basis_solver", "make_adjoint_dense_solver",
                  "adjoint_solve_dense", "FitResult", "make_fit_loop",
                  "fit_loop"],
         "events": ["Event", "EventConfig", "LinearObservable",
                    "QuadraticObservable", "KernelEvents", "event_step"],
         "dense": ["integrate_interp", "hermite_from_endpoints"],
         "ops.fused_loop": ["EventCarry", "DenseCarry", "loop_solution"],
         "exp.auto": ["auto_modulated"],
         "quad": ["gauss_legendre", "fixed_quad", "trapezoid",
                  "averaged_operator"],
         "": ["auto_modulated", "ChebForm", "quad", "solve_ivp",
              "solve_linear", "RungeKutta", "rk_step", "TABLEAUS"],
         "rk": ["rk_step", "rk_step_stages", "RungeKutta"],
         "api": ["solve_ivp", "solve_linear"],
         "lc": ["axpy", "zeros_like", "norm_max", "norm_rms", "vdot"],
         "models.linear": ["stable_dense_matrix", "LinearConstant",
                           "DecayDiag"],
         "models.nonlinear": ["VanDerPol", "LotkaVolterra", "Brusselator"],
         "models.chains": ["TightBindingChain"],
         "exp.splits": ["CommutativeSplit", "StrangSplit",
                        "SemiComplexO4Split", "TripleJumpSplit",
                        "RKNR4Split"],
         "tableaus": ["RKN_O4_A", "TJ_O4_B", "SEMI_COMPLEX_O4_B"],
         # the last single-device modules: the declared drive, the
         # compensated tier, traced norms, compact ensembles, checkpoints
         # and config
         "ops.forms": ["CoeffForm", "ChebForm", "FORMS"],
         "ops.fused_rk": ["cos_drive", "kernel_drive", "KernelDrive"],
         "comp": ["two_sum", "update", "zero_lo", "chain_increment"],
         "lc": ["TracedNorm", "try_trace_norm"],
         "parallel": ["ensemble_solve_compact", "step_efficiency",
                      "cost_sorted_permutation", "inverse_permutation",
                      "ensemble_mesh", "shard_batch", "local_rows",
                      "solve_linear_state_sharded",
                      "ensemble_solve_state_sharded", "mesh_2d"],
         "utils.checkpointing": ["save_state", "load_state"],
         "config": ["warn_on_fallback", "_warn_fallback"],
         "ops.cplx": ["cplx", "cexpm_apply"],
         "exp.leaves": ["cp_embed"],
         # the last modules: sharded ensembles over a DeviceMesh, state
         # sharding, and the examples
         "parallel.ensemble": ["ensemble_mesh", "shard_batch"],
         "parallel.state_parallel": ["local_rows",
                                     "solve_linear_state_sharded",
                                     "ensemble_solve_state_sharded",
                                     "mesh_2d"],
         "examples": ["device_arg"]}
EXAMPLES = ["ensemble_sweep", "blackbox_fast_path", "hamiltonian_learning",
            "impact_events", "lindblad_open_system", "pulse_control",
            "threshold_events_kernel"]
NAMES.update({"examples." + name: ["main"] for name in EXAMPLES})
MODULES = ["exp.auto", "quad", "events", "dense", "diff", "ops.adjoint",
           "ops.expm", "ops.dense_chains", "ops.cplx", "ops.expmv",
           "ops.fused_rk", "ops.fused_loop", "exp.protocol", "exp.leaves",
           "exp.dense_fast", "exp.magnus", "exp.cfm", "exp.split_solvers",
           "exp.modulated", "models.quantum", "parallel.ensemble", "convert",
           "rk", "api", "models.linear", "models.nonlinear", "models.chains",
           "exp.splits", "ops.forms", "comp", "config",
           "utils.checkpointing", "parallel.state_parallel",
           "parallel._mesh"] + ["examples." + n for n in EXAMPLES]

PROBE = f"MODULES = {MODULES!r}; NAMES = {NAMES!r}" + """
import importlib, pkgutil, sys
import vec_ode_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               "vec_ode_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in MODULES:
    assert "vec_ode_tpu_torch." + name in names, name
for mod, attrs in NAMES.items():
    for attr in attrs:
        getattr(importlib.import_module(("vec_ode_tpu_torch." + mod)
                                        .rstrip(".")), attr)
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


# the entry points of the ranks that the mesh tests (tests/torch_mesh_ranks
# .py) and chip_smoke.py (its spawned ranks re-import it) launch
RANKS_PROBE = """
import sys
sys.path[:0] = ["tests", "."]
import torch_mesh_ranks, chip_smoke
assert callable(chip_smoke.mesh_rank)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vec_ode_tpu"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_rank_entry_points_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", RANKS_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vec_ode_tpu)\b"
                         r"(?!_torch)", re.M)
    sources = sorted(PKG.rglob("*.py"))
    assert len(sources) >= 10
    for name in MODULES:
        assert PKG / (name.replace(".", "/") + ".py") in sources, name
    sources += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_solve.py",
                ROOT / "tools" / "compare_parent.py",
                ROOT / "tools" / "k9_breakdown.py",
                ROOT / "tools" / "k6_breakdown.py",
                ROOT / "tools" / "rk_breakdown.py",
                ROOT / "tools" / "parent_bits.py",
                ROOT / "tests" / "torch_mesh_ranks.py"]
    for path in sources:
        assert not pattern.search(path.read_text()), path
