"""Where a training step's time goes, on a CUDA device.

    python -m threedod_torch.train.profile [--steps 3] [--batch-size 8]

Runs the full-width bf16 training step of ``threedod_torch.train`` (DLA34-FPN,
512x672, 512 sampled ROIs an image, seeded weights and batch) under
``torch.profiler`` and prints, per step: the host and device time of every
stage the code marks with ``record_function``, the device's busy share of the
wall time, the kernels that take most device time, and the time inside the
two ROIAlign kernels. Also prints the step's wall time without the profiler.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..data.batch import synthetic_train_batch
from .entry import build_trainer, train_config

STAGES = ("forward", "trunk+fpn", "rpn", "rpn/label+sample", "rpn/proposals", "roi_heads", "roi/label+sample",
          "roi/pool", "backward", "guard", "update")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("threedod_torch.train.profile runs on a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = train_config(batch_size=args.batch_size)
    trainer = build_trainer(cfg, dev, seed=0)
    batch = synthetic_train_batch(cfg, args.batch_size, seed=3).to(dev)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"untraced: {wall_ms:.3f} ms/step, {args.batch_size * 1e3 / wall_ms:.2f} images/s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"traced: {traced_ms:.3f} ms/step", flush=True)
    report(prof.events(), args.steps, traced_ms)
    print(json.dumps({"wall_ms": wall_ms, "traced_ms": traced_ms,
                      "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}))


def report(events, n: int, traced_ms: float) -> None:
    """Per step: each stage's host span, device span and the kernel time
    inside that device span; then the busiest kernels.

    A stage's device span is the profiler's device-side copy of its
    ``record_function`` range (first to last kernel launched inside it). The
    backward's kernels are launched from autograd's own thread, outside any
    range, so its device span is the gap between the end of ``forward``'s and
    the start of ``guard``'s: the stream runs in order."""
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != cuda}
    spans = [e for e in events if e.device_type == cuda and e.name in host_names]  # device copies of ranges
    kernels = sorted((e for e in events if e.device_type == cuda and e.name not in host_names),
                     key=lambda e: e.time_range.start)

    def kernel_ms(lo, hi):
        return sum(k.time_range.end - k.time_range.start for k in kernels if lo <= k.time_range.start < hi) / 1e3

    def stage_spans(name):
        return sorted(((e.time_range.start, e.time_range.end) for e in spans if e.name == name))

    fwd, guard = stage_spans("forward"), stage_spans("guard")
    print("stage | host ms/step | device span ms/step | kernel ms/step")
    for name in STAGES:
        host = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type != cuda and e.name == name) / n / 1e3
        if name == "backward" and len(fwd) == len(guard) == n:
            dev_spans = [(f[1], g[0]) for f, g in zip(fwd, guard)]
        else:
            dev_spans = stage_spans(name)
        span = sum(hi - lo for lo, hi in dev_spans) / n / 1e3
        busy = sum(kernel_ms(lo, hi) for lo, hi in dev_spans) / n
        print(f"{name} | {host:.3f} | {span:.3f} | {busy:.3f}")
    busy_ms = sum(k.time_range.end - k.time_range.start for k in kernels) / n / 1e3
    print(f"device busy {busy_ms:.3f} ms/step in {len(kernels) / n:.0f} kernels and copies: "
          f"busy share {busy_ms / traced_ms:.3f} of the traced step", flush=True)
    by_kernel = {}
    for k in kernels:
        t, c = by_kernel.get(k.name, (0.0, 0))
        by_kernel[k.name] = (t + k.time_range.end - k.time_range.start, c + 1)
    print("kernel | device ms/step | launches/step")
    for name, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"{name[:100]} | {t / n / 1e3:.3f} | {c / n:.1f}")
    for name, (t, c) in by_kernel.items():
        if "roi_align" in name:
            print(f"ROIAlign kernel {name.split('(')[0]}: {t / n / 1e3:.4f} ms/step, {c / n:.1f} launches/step")


if __name__ == "__main__":
    main()
