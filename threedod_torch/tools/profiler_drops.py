"""Which K3 kernels a ``torch.profiler`` session loses, and after what.

``chip_smoke.py`` times K3 on the 12 inputs GroundingDINO hands it in one
800x800 forward with ``device_ms_each``: one profiler session runs each
input's launch 20 times, and the kernels are split into groups where the
card idled. This tool runs such sessions in fresh processes, one a
scenario, and reads each session's chrome trace: every ``cudaLaunchKernel``
is matched by its correlation id with the kernel it launched, so a launch
whose kernel the trace lost is seen, with its place in the session.

Scenarios, each in its own process after the kernels are built, the model's
K3 inputs captured and one throw-away session (as ``chip_smoke.py``'s earlier
phases leave a process):
  none  two sessions (f32 and bf16 inputs, as phase 12), then the same again
  weak  two sessions, ``chip_smoke.py`` phase 15 (the weak path), two sessions
  idle  two sessions, the host idle as long as phase 15 took, two sessions

Prints one line a session and last one JSON line with every session's
counts. Run on a CUDA card from the repository root:
    python3 -m threedod_torch.tools.profiler_drops
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ITERS = 20  # launches of each input a session, as in chip_smoke.py phase 12
T0 = time.monotonic()


def _ranges(idx: list) -> str:
    """[0, 1, 2, 5] -> "0-2,5"."""
    out, start = [], None
    for i, v in enumerate(idx):
        if start is None:
            start = v
        if i + 1 == len(idx) or idx[i + 1] != v + 1:
            out.append(f"{start}-{v}" if v != start else f"{v}")
            start = None
    return ",".join(out)


def session(torch, fns, label: str) -> dict:
    """One session as ``chip_smoke.device_ms_each`` runs it (no leading
    group): the launches, the K3 kernels kept, the launches whose kernel
    was lost, the kernel-minus-launch times and the groups by idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name))["traceEvents"]
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    kernels = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel"}
    k3 = sorted((e for e in kernels.values() if "ms_deform" in e["name"]), key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches) if e["args"].get("correlation") not in kernels]
    lags = sorted(kernels[e["args"]["correlation"]]["ts"] - e["ts"]
                  for e in launches if e["args"].get("correlation") in kernels)
    groups, end = [], None
    for e in k3:
        if end is None or e["ts"] - end > 10000.0:
            groups.append(0)
        groups[-1] += 1
        end = e["ts"] + e["dur"]
    t_first = launches[0]["ts"] if launches else 0.0
    row = dict(
        label=label, process_age_s=round(time.monotonic() - T0, 1), launches=len(launches), k3_kept=len(k3),
        expected=len(fns) * ITERS, lost=_ranges(lost),
        lost_at_ms=[round((launches[i]["ts"] - t_first) / 1e3, 3) for i in lost[:3] + lost[-1:]] if lost else [],
        lag_us=dict(min=lags[0], median=lags[len(lags) // 2], max=lags[-1]) if lags else None,
        groups=groups)
    print(f"[profiler-drops] {json.dumps(row)}", flush=True)
    return row


def scenario(name: str, idle_s: float) -> list:
    import torch

    from threedod_torch import gdino_infer
    from threedod_torch.ops import ms_deform

    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    dev = torch.device("cuda", 0)
    model = gdino_infer.load_model(dev, seed=0)
    captured = smoke["capture_k3_inputs"](torch, model, gdino_infer.random_images(1, 800, seed=0), dev)
    del model

    def fns(dtype):
        return [lambda v=v.to(dtype), s=s, loc=loc, w=w.to(dtype): ms_deform.ms_deform_sample_cuda(v, s, loc, w)
                for v, s, loc, w in captured]

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CUDA]):  # the throw-away session of chip_smoke.py
            for fn in fns(torch.float32):
                fn()
            torch.cuda.synchronize()
        rows = [session(torch, fns(dt), f"{name} before, {str(dt)[6:]}") for dt in (torch.float32, torch.bfloat16)]
    t0 = time.perf_counter()
    if name == "weak":
        smoke["phase_weak_synth"](torch, dev)
    elif name == "idle":
        time.sleep(idle_s)
    work_s = time.perf_counter() - t0
    with torch.no_grad():
        rows += [session(torch, fns(dt), f"{name} after, {str(dt)[6:]}") for dt in (torch.float32, torch.bfloat16)]
    for r in rows:
        r["work_s"] = round(work_s, 1)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", help=argparse.SUPPRESS)  # a scenario in this process
    ap.add_argument("--idle-s", type=float, default=30.0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print("[profiler-drops-rows] " + json.dumps(scenario(args.run, args.idle_s)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the profiler check needs a CUDA card")
    from threedod_torch.ops import _build

    names = ("ms_deform_sample", "roi_align_fwd", "roi_align_bwd", "jpeg_decode")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source, all started together
        list(pool.map(_build.build, names))
    rows, idle_s = [], 30.0
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("none", "weak", "idle"):
        proc = subprocess.run([sys.executable, "-m", "threedod_torch.tools.profiler_drops", "--run", name,
                               "--idle-s", str(idle_s)], cwd=ROOT, env=env, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("[profiler-drops] ") or line.startswith("[weak-synth] phase took"):
                print(line, flush=True)
            if line.startswith("[profiler-drops-rows] "):
                got = json.loads(line.split(" ", 1)[1])
                rows += got
                if name == "weak":
                    idle_s = got[0]["work_s"]
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            raise SystemExit(f"scenario {name} exited with {proc.returncode}")
    print(json.dumps({"profiler_drops": rows}), flush=True)


if __name__ == "__main__":
    main()
