"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) joins a configuration
(``configs[].file``) and a traffic mix (``workloads/<cell>.json``). The
cell reports every end-to-end metric without a ``workloads`` key or that
lists it; a per-layer metric with a ``workloads`` key is read in the cells
it lists, one without in every cell that reports the metric it moves.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics;
    KeyError if the manifest has no such cell."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=json.loads((root / conf["file"]).read_text()),
                mix=json.loads((HERE / "workloads" / f"{name}.json")
                               .read_text()),
                end_to_end=e2e, per_layer=layer)


def module(kind: str, name: str):
    """``odebench/<kind>/<name>.py``: a system, a reference, a metric's
    reader or a kernel's count (a name may hold ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"{__package__}.{kind}.{re.sub(r'[.-]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
