"""RGB PNG files with ``zlib`` alone (the JAX tools save their drawings as
JPEG through Pillow, which the card's machine does not promise; the port
writes the same stems with ``.png``).

``write_png`` writes an 8-bit RGB, non-interlaced file whose rows all carry
filter type 0 (``ops/png.encode_png``); ``read_png`` reads any PNG back to
RGB on the host with the plain version of the card's decoder
(``ops/png.decode_png`` on the CPU), so a drawing can be checked without
Pillow.
"""
from __future__ import annotations

import numpy as np

from ..ops import png


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a (H, W, 3) uint8 image to ``path``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes a (H, W, 3) uint8 image, not {image.dtype} {image.shape}")
    with open(path, "wb") as f:
        f.write(png.encode_png(image, 2, 0, level=level))


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB image of the PNG file at ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return png.decode_png(data, "cpu").numpy()
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
