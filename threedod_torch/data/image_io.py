"""Image and asset reading of the data path (counterpart of
``threedod/data/native_io.py``).

``imread_rgb(path, device)`` gives (H, W, 3) uint8 RGB on ``device``, the
pixels Pillow's ``convert("RGB")`` gives. On a CUDA device the port's own
decoders run, chosen by the file's first bytes: a JPEG by ``ops/jpeg.py``
(entropy decoding on the host: Huffman or arithmetic coding, sequential or
progressive, and lossless files' samples, damaged data recovered as
libjpeg-turbo recovers it; the islow IDCT with the arithmetic of
libjpeg-turbo's SIMD code, block smoothing of incomplete progressions,
upsampling and colour conversion in kernels of ``ops/csrc/jpeg_decode.cu``,
a lossless file through the colour kernel alone; equal to Pillow bit for bit
on 8-bit files of 1 (gray), 3 (YCbCr or RGB) or 4 (CMYK or YCCK) components
at any integer sampling ratio), a PNG by ``ops/png.py`` (chunks, CRCs and
zlib on the host, the row filters, the samples and the colour conversion in
the kernel of ``ops/csrc/png_decode.cu``; every colour type at every bit
depth, interlaced or not). ``chip_smoke.py`` wants 0 levels of difference
against Pillow. Any other file raises with its path and the reason: among
JPEGs, those Pillow refuses too (lossless arithmetic-coded and hierarchical
files, other precisions than 8 bits, lossless YCbCr or YCCK, a file that
ends without a marker, one that libjpeg's errors stop); nothing falls back
to another decoder. On the CPU, the tests' device, Pillow decodes, imported
inside ``imread_rgb``.
``image_hw`` reads the size from a JPEG's frame header or a PNG's IHDR, on
every device and without Pillow; any other file raises with its path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import jpeg, png

JPEG_SOI = b"\xff\xd8"


def imread_rgb(path: str, device: torch.device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the image at ``path``, on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        with open(path, "rb") as f:
            data = f.read()
        try:
            if data.startswith(png.SIGNATURE):
                return png.decode_png(data, device)
            if data.startswith(JPEG_SOI):
                return jpeg.decode_jpeg(data, device)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        raise ValueError(f"the card decodes JPEG and PNG files only, and {path} is neither")
    if device.type != "cpu":
        raise ValueError(f"images are decoded on a CUDA device or the CPU, not on {device}")
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding an image on the CPU needs Pillow, which is not installed") from e
    with Image.open(path) as im:
        return torch.from_numpy(np.asarray(im.convert("RGB")).copy())


def image_hw(path: str) -> tuple:
    """(height, width) of the JPEG or PNG at ``path`` from its frame header
    or IHDR, without decoding it; any other file raises ``ValueError`` with
    its path."""
    with open(path, "rb") as f:
        try:
            if f.read(len(png.SIGNATURE)) == png.SIGNATURE:
                f.seek(0)
                return png.png_hw(f)
            f.seek(0)
            return jpeg.frame_hw(f)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e


def npz_load(path: str, key: str) -> np.ndarray:
    """One array out of an ``.npz`` archive, by key."""
    with np.load(path) as z:
        return z[key]
