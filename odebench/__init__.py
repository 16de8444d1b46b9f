"""The benchmark of the PyTorch / CUDA port (``vec_ode_tpu_torch``).

    python3 -m odebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the configurations, the
cells (one configuration under one traffic mix), the end-to-end metrics
and the per-layer metrics. Everything here is found by name from it:

* ``configs/<config>.json``: a configuration's sizes, tolerances and the
  names of its system (``systems/<system>.py``, which builds the port's
  call) and plain reference (``references/<reference>.py``);
* ``workloads/<cell>.json``: a cell's traffic parameters, read by
  ``traffic.py`` and the system, and the limits of its output check;
* ``metrics/<metric>.py``: a per-layer metric's reader;
* ``counts/<kernel>.py``: a kernel's operation and byte count.

Adding one of them is adding a file and an entry in ``BENCHMARK.json``.
Nothing here imports ``jax`` or the JAX package ``vec_ode_tpu``; the
references import nothing of the port either.
"""
