"""Where the time of one main-path solve goes on a CUDA card.

    python -m tools.profile_solve [--path main|generic-rk] [--out DIR]

Run from the repository root, on a machine with one CUDA card and nvcc.
It builds the kernels, warms up, and times five plain solves of
chip_smoke.py's main path (16 384 trajectories of the 64-dim complex
driven system, adaptive RKF45, f32, through
``vec_ode_tpu_torch.parallel.ensemble_solve``; with ``--path
generic-rk`` the same states through the generic vmapped RKF45 ensemble
over ``DrivenDense.rhs_pair``, which runs no hand kernel and needs no
build), then runs one more solve under ``torch.profiler`` and prints,
each on a line with the card's name and power limit:

* the host wall time of the profiled solve and its driver iterations;
* device busy time: the union of the intervals of every device activity
  (kernels, copies, fills); the device span from the first activity's
  start to the last one's end; and the idle share of each;
* device kernels launched, in all and per driver iteration, with the
  runtime's kernel-launch calls, the host syncs and the aten operators
  (outermost ones, and all levels) that issued them;
* the device kernels by total time;
* on the generic path, the GEMM kernels a stage (six stages an
  iteration) and the other kernels an iteration.

The full operator table, a Chrome trace and a JSON summary go to DIR
(default ``build/profile``).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from vec_ode_tpu_torch.ops import fused_rk

K1_NAME = "fused_rk_step_kernel"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def host_wall_ms(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def summarize(prof, wall_ms: float, n_iters: int, k1_launches: int) -> dict:
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit("profile_solve: the trace holds no device activity")
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    aten = [e for e in host if e.name.startswith("aten::")]
    outer = [e for e in aten
             if e.cpu_parent is None
             or not e.cpu_parent.name.startswith("aten::")]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = busy_us(spans) / 1e3
    span = (max(s[1] for s in spans) - min(s[0] for s in spans)) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    k1 = [v for n, v in by_name.items() if K1_NAME in n]
    return {
        "wall_ms": wall_ms, "n_iters": n_iters, "k1_launches": k1_launches,
        "device_busy_ms": busy, "device_span_ms": span,
        "idle_share_of_wall": 1 - busy / wall_ms,
        "idle_share_of_span": 1 - busy / span,
        "device_activities": len(dev), "device_kernels": len(kernels),
        "kernel_launch_calls": sum(e.name in LAUNCH_CALLS for e in host),
        "host_syncs": sum(e.name in SYNC_CALLS for e in host),
        "aten_ops_outermost": len(outer), "aten_ops_all_levels": len(aten),
        "k1_ms": sum(v[1] for v in k1), "k1_count": sum(v[0] for v in k1),
        "kernels_by_time": sorted(
            ([n, c, ms] for n, (c, ms) in by_name.items()),
            key=lambda r: -r[2]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("main", "generic-rk"),
                    default="main", help="the solve to profile")
    ap.add_argument("--out", default="build/profile",
                    help="directory for the table, trace and summary")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    card = chip_smoke.device_phase()
    generic = args.path == "generic-rk"
    if not generic:
        chip_smoke.build_phase(card)
    st, y0 = chip_smoke.main_inputs()
    if generic:
        chip_smoke.check_ieee_products()
        model = chip_smoke.DrivenDense.make(d=chip_smoke.DIM, seed=0)

        def run():
            return chip_smoke.generic_rk_solve(model, y0)
    else:
        def run():
            return chip_smoke.solve(st, y0)
    for _ in range(2):
        run()
    walls = [host_wall_ms(run) for _ in range(5)]
    print(f"[profile] unprofiled solves, host wall: median "
          f"{statistics.median(walls):.3f} ms of "
          f"{[round(w, 3) for w in walls]} ({card})", flush=True)

    before = fused_rk.fused_rk_step.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    s = summarize(prof, wall_ms, int(sol.n_iters.max()),
                  fused_rk.fused_rk_step.launches - before)
    it = s["n_iters"]
    print(f"[profile] profiled solve: host wall {s['wall_ms']:.3f} ms, "
          f"{it} driver iterations, {s['k1_launches']} K1 launches; device "
          f"busy {s['device_busy_ms']:.3f} ms, span "
          f"{s['device_span_ms']:.3f} ms; idle {s['idle_share_of_wall']:.1%}"
          f" of the wall, {s['idle_share_of_span']:.1%} of the span "
          f"({card})", flush=True)
    print(f"[profile] per driver iteration: "
          f"{s['device_kernels'] / it:.1f} device kernels "
          f"({s['device_kernels']} in all; {s['device_activities']} device "
          f"activities with copies and fills), "
          f"{s['kernel_launch_calls'] / it:.1f} kernel-launch calls, "
          f"{s['host_syncs'] / it:.2f} host syncs, "
          f"{s['aten_ops_outermost'] / it:.1f} outermost aten ops, "
          f"{s['aten_ops_all_levels'] / it:.1f} aten ops at all levels "
          f"({card})", flush=True)
    print(f"[profile] K1 {s['k1_ms']:.3f} ms in {s['k1_count']} launches "
          f"({s['k1_ms'] / max(s['k1_count'], 1):.4f} ms each), "
          f"{s['k1_ms'] / s['device_busy_ms']:.1%} of device busy time "
          f"({card})", flush=True)
    if generic:
        stages = it * chip_smoke.RKF45.stages
        gemm = sum(c for n, c, _ in s["kernels_by_time"]
                   if "gemm" in n.lower())
        print(f"[profile] generic path: {gemm} GEMM kernels, "
              f"{gemm / stages:.2f} a stage over {stages} stages; "
              f"{(s['device_kernels'] - gemm) / it:.1f} other kernels an "
              f"iteration ({card})", flush=True)
        s["gemm_kernels"], s["stages"] = gemm, stages
    for name, count, ms in s["kernels_by_time"][:12]:
        print(f"[profile]   {ms:9.3f} ms {count:6d}x  {name[:110]}",
              flush=True)

    (out / "key_averages.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=80))
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "summary.json").write_text(json.dumps(
        dict(s, card=card, unprofiled_wall_ms=walls), indent=1))
    print(f"[profile] wrote {out}/key_averages.txt, trace.json, summary.json",
          flush=True)


if __name__ == "__main__":
    main()
