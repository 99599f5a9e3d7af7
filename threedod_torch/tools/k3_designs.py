"""K3's design trial: the committed deformable-sampling kernel beside
variants of it, timed in turns on one card.

Each design is ``ops/csrc/ms_deform_sample.cu`` with a few lines replaced
(each replaced text must occur in the source as often as the design says, so
a design that no longer applies fails at once) and, for some, other values of
``ms_deform``'s plan constants (``STAGE_BYTES``, ``VECTORS_A_LANE``). Every
design is built by its own nvcc into ``build/threedod_torch/k3_designs/``, all
started together. Then, in each of ``--rounds`` rounds (every other round in
reverse order), each design's library takes the place of the committed one
and runs on ``chip_smoke.py`` phase 6's uniform inputs and on the 12 inputs
the seeded GroundingDINO hands K3 in one 800x800 bf16 forward, in bf16 and
f32: every output is held against the plain version, and the kernel's device
time is read by ``torch.profiler`` (``chip_smoke.py``'s K3 helpers). Prints
the registers and spills of every design's kernels, one line a design and
round, and last one JSON line: the least device time of each design by input
over the rounds.

Run on a CUDA card from the repository root:
    python3 -m threedod_torch.tools.k3_designs [--rounds 2]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import runpy
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "threedod_torch" / "ops" / "csrc" / "ms_deform_sample.cu"
OUT_DIR = ROOT / "build" / "threedod_torch" / "k3_designs"

PF = "constexpr int PF = 2;"
THREADS = "constexpr int STAGED_THREADS = sizeof(T) == 2 && VB == 16 ? 768 : 1024;"
VECTORS = "vectors != (variant == SPLIT ? 2 : 1)"
FOLDED = """    for (int p = 0; p < PF; ++p) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float wt = aw[p0 + p] * tw[4 * p + t];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float v[VE];
          V::unpack(raw[4 * p + t][n], v);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[n * VE + e] += wt * v[e];
        }
      }
    }"""
# a sample's four taps summed first, then weighted by the sample's weight
UNFOLDED = """    for (int p = 0; p < PF; ++p) {
      float s[NV * VE];
#pragma unroll
      for (int e = 0; e < NV * VE; ++e) s[e] = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float v[VE];
          V::unpack(raw[4 * p + t][n], v);
#pragma unroll
          for (int e = 0; e < VE; ++e) s[n * VE + e] += tw[4 * p + t] * v[e];
        }
      }
#pragma unroll
      for (int e = 0; e < NV * VE; ++e) acc[e] += aw[p0 + p] * s[e];
    }"""


def _threads(n: int):
    return (THREADS, f"constexpr int STAGED_THREADS = {n};", 1)


def _pf(n: int):
    return (PF, f"constexpr int PF = {n};", 1)


SPLIT_ONE = [("ms_deform_split<T, VB, 2><<<", "ms_deform_split<T, VB, 1><<<", 1), (VECTORS, "vectors != 1", 1)]
STAGED_TWO = [("ms_deform_staged<T, VB, 1>", "ms_deform_staged<T, VB, 2>", 2),
              (VECTORS, "vectors != (variant == GENERIC ? 1 : 2)", 1)]
NOT_FOLDED = [(FOLDED, UNFOLDED, 1)]
BUDGET_227K = 232448

# name -> (source replacements (old, new, occurrences), ms_deform constants)
DESIGNS = {
    "committed": ([], {}),
    "not folded (tap weights times the sample weight after the sum)": (NOT_FOLDED, {}),
    "PF 1: 4 taps in flight": ([_pf(1)], {}),
    "PF 4: 16 taps in flight": ([_pf(4)], {}),
    "staged 1024 threads in every instantiation": ([_threads(1024)], {}),
    "staged 768 threads in every instantiation": ([_threads(768)], {}),
    "staged 512 threads": ([_threads(512)], {}),
    "staged 2 vectors a lane": (STAGED_TWO, {"VECTORS_A_LANE": {"generic": 1, "staged": 2, "split": 2}}),
    "split 1 vector a lane": (SPLIT_ONE, {"VECTORS_A_LANE": {"generic": 1, "staged": 1, "split": 1}}),
    "staging budget 227 KB (levels 1 to 3 in bf16)": ([], {"STAGE_BYTES": BUDGET_227K}),
    "nothing staged": ([], {"STAGE_BYTES": 0}),
    "512 threads, PF 4, split 1 vector a lane, not folded, 227 KB": (
        [_threads(512), _pf(4), *SPLIT_ONE, *NOT_FOLDED],
        {"STAGE_BYTES": BUDGET_227K, "VECTORS_A_LANE": {"generic": 1, "staged": 1, "split": 1}}),
}


def design_source(replacements) -> str:
    """The committed source with ``replacements`` made; raises if a replaced
    text does not occur as often as expected."""
    src = SOURCE.read_text()
    for old, new, count in replacements:
        if src.count(old) != count:
            raise ValueError(f"{old[:60]!r} occurs {src.count(old)} times in {SOURCE.name}, not {count}")
        src = src.replace(old, new)
    return src


def _build_design(index: int, replacements):
    from threedod_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"design{index}.cu"
    src.write_text(design_source(replacements))
    lib = OUT_DIR / f"libdesign{index}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on design {index}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def _entry(lib_path: Path, argtypes):
    """(library, entry point) of a design, declared as ``ms_deform._kernel``
    declares the committed one."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.threedod_ms_deform_sample
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.threedod_cuda_error_string.argtypes = [ctypes.c_int]
    lib.threedod_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    from threedod_torch import gdino_infer
    from threedod_torch.ops import ms_deform

    if not torch.cuda.is_available():
        raise SystemExit("the design trial needs a CUDA card")
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(len(DESIGNS)) as pool:
        built = list(pool.map(_build_design, range(len(DESIGNS)), [r for r, _ in DESIGNS.values()]))
    for name, (_, log) in zip(DESIGNS, built):
        for line in smoke["build_report"](log):
            print(f"[K3-designs] {name}: {line}", flush=True)

    model = gdino_infer.load_model(dev, seed=0)
    captured = smoke["capture_k3_inputs"](torch, model, gdino_infer.random_images(1, 800, seed=0), dev)
    del model
    value32, uniform = smoke["_k3_uniform_inputs"](torch, dev)
    cases, labels = [], []
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for lq, (loc, w) in uniform.items():
            labels.append(f"{dtype_name} Lq={lq} uniform")
            cases.append((labels[-1], value32.to(dtype), smoke["GDINO_LEVELS"], loc, w.to(dtype)))
        for i, (value, shapes, loc, w) in enumerate(captured):
            part = "encoder" if loc.shape[1] == smoke["GDINO_S"] else "decoder"
            labels.append(f"{dtype_name} model {part}")
            cases.append((f"{dtype_name} model launch {i} ({part})", value.to(dtype), shapes, loc, w.to(dtype)))

    kernel = ms_deform._kernel
    argtypes = kernel()[1].argtypes
    saved = {k: getattr(ms_deform, k) for k in ("STAGE_BYTES", "VECTORS_A_LANE")}
    best = {}
    order = list(range(len(DESIGNS)))
    try:
        for rnd in range(args.rounds):
            for i in order if rnd % 2 == 0 else order[::-1]:
                name, (_, consts) = list(DESIGNS.items())[i]
                entry = _entry(built[i][0], argtypes)
                ms_deform._kernel = lambda entry=entry: entry
                for k, v in {**saved, **consts}.items():
                    setattr(ms_deform, k, v)
                ms_deform._cached_plan.cache_clear()
                with torch.no_grad():
                    rows = smoke["_k3_measure"](torch, ms_deform, cases, 20, 1)
                times = {}
                for label, row in zip(labels, rows):
                    times[label] = times.get(label, 0.0) + row["kernel_ms"]
                print(f"[K3-designs] round {rnd + 1} {name}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + " ms", flush=True)
                mine = best.setdefault(name, {})
                for k, v in times.items():
                    mine[k] = min(v, mine.get(k, v))
    finally:
        ms_deform._kernel = kernel
        for k, v in saved.items():
            setattr(ms_deform, k, v)
        ms_deform._cached_plan.cache_clear()
    print(json.dumps({"k3_designs": best}), flush=True)


if __name__ == "__main__":
    main()
