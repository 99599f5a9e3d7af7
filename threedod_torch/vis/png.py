"""RGB PNG files with ``zlib`` alone (the JAX tools save their drawings as
JPEG through Pillow, which the card's machine does not promise; the port
writes the same stems with ``.png``).

``write_png`` writes an 8-bit RGB, non-interlaced file whose rows all carry
filter type 0; ``read_png`` reads such a file back (any other PNG raises), so
a drawing can be checked without Pillow.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write a (H, W, 3) uint8 image to ``path``."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes a (H, W, 3) uint8 image, not {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8 bits, RGB, deflate, filter 0, no interlace
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 image of a file ``write_png`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNG files are read, not {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than type 0 are not read")
    return rows[:, 1:].reshape(h, w, 3).copy()
