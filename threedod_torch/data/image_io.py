"""Image and asset reading of the data path (counterpart of
``threedod/data/native_io.py``).

``imread_rgb(path, device)`` gives (H, W, 3) uint8 RGB on ``device``. On a
CUDA device the JPEG is decoded there by nvJPEG (``ops/csrc/nvjpeg_decode.cu``,
built at first use and linked to the CUDA toolkit's ``libnvjpeg``); a
failure raises, and nothing falls back to another decoder. On the CPU, the
tests' device, Pillow decodes, imported inside that branch only: the card
path needs no Pillow. nvJPEG's chroma upsampling may differ from libjpeg's
(Pillow's) by a level or two near edges; ``chip_smoke.py`` prints the
difference on the fixture.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _nvjpeg() -> ctypes.CDLL:
    lib = _build.library("nvjpeg_decode", "threedod_jpeg_decode", [_P, ctypes.c_size_t, _P, _I, _I, _P])
    lib.threedod_jpeg_size.argtypes = [_P, ctypes.c_size_t, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.threedod_jpeg_size.restype = _I
    return lib


def decode_jpeg_cuda(data: bytes, device: torch.device) -> torch.Tensor:
    """A JPEG's bytes -> (H, W, 3) uint8 RGB on the CUDA ``device``, by nvJPEG."""
    lib = _nvjpeg()
    index = device.index if device.index is not None else torch.cuda.current_device()
    h, w = _I(), _I()
    _build.check_launch(lib, "nvJPEG size", lib.threedod_jpeg_size(data, len(data), index, ctypes.byref(h),
                                                                   ctypes.byref(w)))
    out = torch.empty((h.value, w.value, 3), dtype=torch.uint8, device=torch.device("cuda", index))
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check_launch(lib, "nvJPEG decode", lib.threedod_jpeg_decode(data, len(data), out.data_ptr(), w.value,
                                                                       index, stream))
    return out


def imread_rgb(path: str, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the image at ``path``, on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not path.lower().endswith((".jpg", ".jpeg")):
            raise ValueError(f"the card decodes JPEG files only, not {path}")
        with open(path, "rb") as f:
            return decode_jpeg_cuda(f.read(), device)
    if device.type != "cpu":
        raise ValueError(f"images are decoded on a CUDA device or the CPU, not on {device}")
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding an image on the CPU needs Pillow, which is not installed") from e
    with Image.open(path) as im:
        return torch.from_numpy(np.asarray(im.convert("RGB")).copy())


def npz_load(path: str, key: str) -> np.ndarray:
    """One array out of an ``.npz`` archive, by key."""
    with np.load(path) as z:
        return z[key]
