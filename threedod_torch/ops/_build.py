"""Build of the port's CUDA kernels: nvcc into a shared library with a plain
C interface, loaded with ctypes.

Builds at first use, from the sources under ``csrc/``, into
``build/threedod_torch/`` at the repository root (a directory git ignores).
The library's file name carries a hash of its source, of every header under
``csrc/`` (any source may include one) and of the flags, so an edited file is
rebuilt and an unchanged one is loaded as it is. No source links a library.
Importing this module builds nothing. ``library``, ``launch_args`` and ``check_launch`` are
the wrappers' common ctypes plumbing: every library exports its entry points,
each returning the CUDA error as an int, and ``threedod_cuda_error_string``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "threedod_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest(src: Path, flags: list) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless an identical build exists.

    Returns (library path, nvcc's output, seconds spent compiling)."""
    src = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"lib{name}_{_digest(src, NVCC_FLAGS)}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, log, seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    lib, _, _ = build(name)
    return ctypes.CDLL(str(lib))


def library(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``fn`` and its error
    string function declared."""
    lib = load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    lib.threedod_cuda_error_string.argtypes = [ctypes.c_int]
    lib.threedod_cuda_error_string.restype = ctypes.c_char_p
    return lib


def card_sms(device: torch.device) -> int:
    """The streaming multiprocessors of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_args(t: torch.Tensor):
    """(is_bf16, device index, current stream) for a launch on ``t``'s device."""
    return int(t.dtype == torch.bfloat16), t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {lib.threedod_cuda_error_string(err).decode()}")
