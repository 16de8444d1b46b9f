"""The manifest against the benchmark's contract, and what the harness
imports (CPU; no card needed)."""

from __future__ import annotations

import ast
import json
import pathlib
import re

import pytest

from odebench import manifest

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vec_ode_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def imported_tops(path: pathlib.Path) -> set:
    """Top-level names a file imports (absolute imports only)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    found = imported_tops(path) & FORBIDDEN
    assert not found, f"{path.name} imports {found}"


def test_top_level_names_compared_whole(monkeypatch):
    import sys
    import types

    from odebench.run import loaded_forbidden

    before = loaded_forbidden()
    monkeypatch.setitem(sys.modules, "vec_ode_tpu_torch.fake",
                        types.ModuleType("fake"))
    monkeypatch.setitem(sys.modules, "jaxfake", types.ModuleType("jaxfake"))
    assert loaded_forbidden() == before
    monkeypatch.setitem(sys.modules, "vec_ode_tpu.fake",
                        types.ModuleType("fake"))
    assert "vec_ode_tpu" in loaded_forbidden()


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "vec_ode_tpu_torch" not in tops and not tops & FORBIDDEN
    rel = [n for n in ast.walk(ast.parse(path.read_text()))
           if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert not rel, "a reference imports the harness"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["odebench"]
    assert all("/" not in w or w.startswith("odebench")
               for w in BENCH["command"][1:])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(
            w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"].startswith("odebench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    c = manifest.cell(BENCH, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", ()):
            assert m["moves"] in {x["name"] for x in
                                  manifest.cell(BENCH, w).end_to_end}


def test_every_config_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_check_time_fits():
    n = 24
    runs = 2 + 14 * n
    total = runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
