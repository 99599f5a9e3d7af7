"""Image and asset reading of the data path (counterpart of
``threedod/data/native_io.py``).

``imread_rgb(path, device)`` gives (H, W, 3) uint8 RGB on ``device``, the
pixels libjpeg (Pillow) decodes with its defaults. On a CUDA device the JPEG
is decoded by the port's own decoder (``ops/jpeg.py``: Huffman decoding on
the host, libjpeg's islow IDCT, fancy upsampling and colour conversion in
kernels of ``ops/csrc/jpeg_decode.cu``), which equals libjpeg bit for bit on
baseline files (``chip_smoke.py`` wants 0 levels of difference against Pillow
on every fixture JPEG); any other file raises with its path, and nothing
falls back to another decoder. On the CPU, the tests' device, Pillow decodes,
imported inside ``imread_rgb``. ``image_hw`` reads a JPEG's size from its
frame header (``ops/jpeg.frame_hw``), on every device and without Pillow; any
other file raises with its path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import jpeg


def imread_rgb(path: str, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the image at ``path``, on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not path.lower().endswith((".jpg", ".jpeg")):
            raise ValueError(f"the card decodes JPEG files only, not {path}")
        with open(path, "rb") as f:
            data = f.read()
        try:
            return jpeg.decode_jpeg(data, device)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
    if device.type != "cpu":
        raise ValueError(f"images are decoded on a CUDA device or the CPU, not on {device}")
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding an image on the CPU needs Pillow, which is not installed") from e
    with Image.open(path) as im:
        return torch.from_numpy(np.asarray(im.convert("RGB")).copy())


def image_hw(path: str) -> tuple:
    """(height, width) of the JPEG at ``path`` from its frame header, without
    decoding it; any other file raises ``ValueError`` with its path."""
    with open(path, "rb") as f:
        try:
            return jpeg.frame_hw(f)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e


def npz_load(path: str, key: str) -> np.ndarray:
    """One array out of an ``.npz`` archive, by key."""
    with np.load(path) as z:
        return z[key]
