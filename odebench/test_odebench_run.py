"""A whole run of each cell at a size the CPU holds, with the card's look
skipped: sound runs are correct, the TF32 control and planted faults are
not; a run with no card prints no result (CPU)."""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from odebench import manifest
from odebench.references import driven_dense as ref
from odebench.run import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 11


def small(name):
    cell = manifest.cell(manifest.load(), name)
    cell.mix = dict(cell.mix, batch=16, pool_batches=2, check_calls=2,
                    warmup_calls=1)
    return cell


def run_small(name, wrap=None, trace=False):
    line, checks = run_cell(small(name), SEED, 0.2, trace, "cpu", wrap=wrap)
    return line


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run_small(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in
                                    manifest.cell(manifest.load(),
                                                  name).end_to_end}
    assert {m.split(".")[0] for m in line["metrics"]} == {
        "traj_per_s", "solve_ms_p95", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails(name):
    cell = small(name)
    system = manifest.module("systems", cell.config["system"]).build(
        cell.config, cell.mix, SEED, "cpu")
    kept = [(i, None) for i in range(2)]
    got = ref.check_numbers(system, kept, control=True)["max_err"]
    assert got > 10 * cell.mix["limits"]["max_err"], got


def replace_outputs(system, fix):
    call = system.call

    def broken(i):
        sol = call(i)
        return fix(sol, system.pool[system.batch_of(i)])

    system.call = broken


def unchanged(sol, y0):
    """A step that returns its state unchanged: every state stays y0."""
    n = sol.ys.re.shape[1]
    ys = type(y0)(y0.re[:, None].expand(-1, n, -1).clone(),
                  y0.im[:, None].expand(-1, n, -1).clone())
    return dataclasses.replace(sol, y_final=y0, ys=ys)


def half_left_out(sol, y0):
    """Half of the batch left out: its rows never leave their inputs."""
    h = y0.re.shape[0] // 2
    y = type(y0)(torch.cat([sol.y_final.re[:h], y0.re[h:]]),
                 torch.cat([sol.y_final.im[:h], y0.im[h:]]))
    ys = type(y0)(sol.ys.re.clone(), sol.ys.im.clone())
    ys.re[h:, 1:] = y0.re[h:, None]
    ys.im[h:, 1:] = y0.im[h:, None]
    return dataclasses.replace(sol, y_final=y, ys=ys)


def answer_altered(sol, y0):
    """One trajectory's answer swapped for another's where it is made."""
    re, im = sol.y_final.re.clone(), sol.y_final.im.clone()
    re[3], im[3] = sol.y_final.re[4], sol.y_final.im[4]
    return dataclasses.replace(sol, y_final=type(y0)(re, im))


def status_lost(sol, y0):
    """One trajectory reported as not done."""
    status = sol.status.clone()
    status[5] = 0
    return dataclasses.replace(sol, status=status)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered,
                                   status_lost], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(name, fault):
    line = run_small(name, wrap=lambda s: replace_outputs(s, fault))
    assert not line["correct"], line["checks"]


def test_traced_run_on_cpu_reads_counters():
    line = run_small("magnus4-16k-loop", trace=True)
    assert line["correct"]
    assert "reject_pct" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "breakdown" in line


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run(
        [sys.executable, "-m", "odebench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_nothing_but_the_benchmark_is_not_enough(tmp_path):
    shutil.copytree(ROOT / "odebench", tmp_path / "odebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "odebench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a kernel count
    added as new files (and entries in BENCHMARK.json) run without an edit
    to any file the benchmark has."""
    shutil.copytree(ROOT / "odebench", tmp_path / "odebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "odebench"
    conf = json.loads((new / "configs" / "driven64-magnus4.json").read_text())
    conf.update(name="driven8-magnus4", d=8)
    (new / "configs" / "driven8-magnus4.json").write_text(json.dumps(conf))
    mix = json.loads((new / "workloads" / "magnus4-16k-loop.json").read_text())
    mix.update(batch=8, pool_batches=1, check_calls=1, warmup_calls=1)
    (new / "workloads" / "magnus4-8d-tiny.json").write_text(json.dumps(mix))
    (new / "counts" / "calls_only.py").write_text(
        "def per_call():\n    return 1.0\n")
    (new / "metrics" / "calls.py").write_text(
        "from ..counts import load\n\n\ndef read(run):\n"
        "    return load('calls_only').per_call() * run.n_calls\n")
    bench["configs"].append(dict(bench["configs"][1], name="driven8-magnus4",
                                 file="odebench/configs/driven8-magnus4.json"))
    bench["workloads"].append({"name": "magnus4-8d-tiny",
                               "config": "driven8-magnus4",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "traj_per_s",
                               "workloads": ["magnus4-8d-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json\n"
        "from odebench import manifest\n"
        "from odebench.run import run_cell\n"
        "cell = manifest.cell(manifest.load(), 'magnus4-8d-tiny')\n"
        "line, _ = run_cell(cell, 5, 0.1, True, 'cpu')\n"
        "print(json.dumps(line))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["calls"]["value"] >= 1
    assert line["correct"], line["checks"]
    for path in (ROOT / "odebench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT / "odebench")
            assert (new / rel).read_bytes() == path.read_bytes()
