"""The JAX package's seven example scripts (``examples/*.py``) on the
port, one module each under the same name, each with the script's own
problem size and check:

    python -m vec_ode_tpu_torch.examples.<name> [--device cpu]

``main(device="cuda")`` runs one; importing a module runs nothing.
``ensemble_sweep --mesh`` shards its ensemble over ``ensemble_mesh()``
under ``torchrun --nproc-per-node=N``.
"""

import argparse


def device_arg(doc: str, argv=None, **flags) -> argparse.Namespace:
    """The examples' command line: ``--device`` (default cuda) and the
    boolean ``flags`` ({name: help})."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for name, help_ in flags.items():
        p.add_argument(f"--{name}", action="store_true", help=help_)
    return p.parse_args(argv)
