"""The card's PNG decoder, equal to Pillow's ``convert("RGB")`` (PNG is
lossless, so equal means every sample).

``decode_png(data, device)`` takes the bytes of an 8-bit, non-interlaced PNG
of any colour type (gray, gray + alpha, palette, RGB, RGBA) and returns
(H, W, 3) uint8 RGB on ``device``:

1. on the host, ``parse`` walks the chunks, checks every CRC, reads IHDR and
   PLTE, and ``inflate`` inflates the IDAT data with the stdlib ``zlib`` into
   the filtered scanlines, (H, 1 + W bpp) bytes, each row's filter type
   first;
2. on the card, ``csrc/png_decode.cu``'s kernel undoes the five row filters
   (None, Sub, Up, Average, Paeth) and converts to RGB as Pillow does: gray
   to three equal channels, alpha dropped, a palette index looked up (an
   index past the palette is black, as in Pillow).

Interlaced files, other bit depths and anything that is not a PNG raise
``ValueError`` and say why; nothing falls back to another decoder. On a CPU
tensor the wrapper runs the plain version (``unfilter_reference`` and
``to_rgb_reference``, integer numpy on the host), which ``chip_smoke.py``
holds the kernel against on the same bytes. Every launch adds one to
``LAUNCHES``. ``encode_png`` writes such files with a chosen filter a row
(the forward filters in numpy, then ``zlib``), for the tests and the card's
checks; ``png_hw`` reads an image's size from IHDR without decoding it.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import _build

LAUNCHES = 0
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


class Png(NamedTuple):
    width: int
    height: int
    color_type: int
    palette: np.ndarray    # uint8 (256, 3): PLTE's entries, then black
    idat: bytes            # the IDAT chunks' data, concatenated

    @property
    def bpp(self) -> int:
        return CHANNELS[self.color_type]


# ---------------------------------------------------------------------------
# the host part: chunks, CRCs, header, inflate
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _ihdr(body: bytes) -> tuple:
    if len(body) != 13:
        raise ValueError(f"IHDR has {len(body)} bytes, not 13")
    w, h, depth, color, compression, filt, interlace = struct.unpack(">IIBBBBB", body)
    if color not in CHANNELS:
        raise ValueError(f"colour type {color} is not a PNG colour type")
    if depth != 8:
        raise ValueError(f"{depth}-bit samples: only 8-bit PNG files are decoded")
    if interlace:
        raise ValueError("an interlaced (Adam7) PNG: only non-interlaced files are decoded")
    if compression or filt:
        raise ValueError(f"compression method {compression}, filter method {filt}: only 0 and 0 exist")
    if not w or not h:
        raise ValueError(f"an empty {w}x{h} image")
    return w, h, color


def parse(data: bytes) -> Png:
    """The header, palette and IDAT data of a PNG file's bytes; a file the
    decoder does not take raises ``ValueError``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    pos, header, palette, idat = len(SIGNATURE), None, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("the file ends before its IEND chunk")
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"the {kind!r} chunk runs past the end of the file")
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        if header is None and kind != b"IHDR":
            raise ValueError(f"the first chunk is {kind!r}, not IHDR")
        if kind == b"IHDR":
            header = _ihdr(body)
        elif kind == b"PLTE":
            if n % 3 or n > 768:
                raise ValueError(f"a PLTE chunk of {n} bytes")
            palette = np.zeros((256, 3), np.uint8)
            palette[:n // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, color = header
    if color == 3 and palette is None:
        raise ValueError("a palette image without a PLTE chunk")
    if not idat:
        raise ValueError("no IDAT chunk")
    return Png(w, h, color, palette if palette is not None else np.zeros((256, 3), np.uint8), b"".join(idat))


def inflate(png: Png) -> np.ndarray:
    """The filtered scanlines, uint8 (H, 1 + W bpp), inflated on the host;
    a size or filter type out of place raises ``ValueError``."""
    try:
        raw = zlib.decompress(png.idat)
    except zlib.error as e:
        raise ValueError(f"the IDAT data does not inflate: {e}") from e
    n = png.height * (1 + png.width * png.bpp)
    if len(raw) < n:
        raise ValueError(f"the IDAT data inflates to {len(raw)} bytes, fewer than the {n} of the image")
    rows = np.frombuffer(raw, np.uint8, n).reshape(png.height, 1 + png.width * png.bpp)
    if int(rows[:, 0].max()) > 4:
        raise ValueError(f"filter type {int(rows[:, 0].max())} in a row: the filter types are 0 to 4")
    return rows


def png_hw(f) -> tuple:
    """(height, width) from the IHDR chunk of the PNG file open in binary
    ``f``, without decoding anything; another file raises ``ValueError``."""
    head = f.read(len(SIGNATURE) + 8 + 13 + 4)
    if not head.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    if len(head) < 33 or head[12:16] != b"IHDR":
        raise ValueError("no IHDR chunk at the start of the file")
    body = head[16:29]
    if struct.unpack(">I", head[29:33])[0] != zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF:
        raise ValueError("bad CRC in the b'IHDR' chunk")
    w, h, _ = _ihdr(body)
    return h, w


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG specification 9.4) on int32 arrays."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_reference(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W bpp) uint8 filtered scanlines -> (H, W bpp) uint8 samples,
    in numpy on the host.

    A pixel needs its left, upper and upper-left neighbours done, so the
    rows go in a wavefront as the kernel's do: at step s row r undoes pixel
    s - r, every row at once. The pixels are stored skewed, pixel (r, x) at
    ``sk[x + r + 2, r + 1]`` (zeros above and beside the image), so a step
    reads and writes one contiguous stretch."""
    filtered = np.asarray(filtered)
    h, n = filtered.shape
    w = (n - 1) // bpp
    ftype = filtered[:, 0].astype(np.int32)
    if not ftype.any():
        return filtered[:, 1:].copy()
    data = filtered[:, 1:].reshape(h, w, bpp).astype(np.int32)
    skewed = np.zeros((w + h - 1, h, bpp), np.int32)  # [step, row]: the filtered pixel row r undoes at step s
    sk = np.zeros((w + h + 1, h + 1, bpp), np.int32)  # [column, row + 1]: contiguous a step
    rows = np.arange(h)
    for x in range(w):
        skewed[x + rows, rows] = data[:, x]
    kinds = [(ftype == k)[:, None] for k in range(1, 5)]
    for s in range(w + h - 1):
        r0, r1 = max(0, s - w + 1), min(h, s + 1)
        a, b, c = sk[s + 1, r0 + 1:r1 + 1], sk[s + 1, r0:r1], sk[s, r0:r1]
        sub, up, avg, paeth = (k[r0:r1] for k in kinds)
        pred = np.where(sub, a, np.where(up, b, np.where(avg, (a + b) >> 1, np.where(paeth, _paeth(a, b, c), 0))))
        sk[s + 2, r0 + 1:r1 + 1] = (skewed[s, r0:r1] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for x in range(w):
        out[:, x] = sk[x + rows + 2, rows + 1]
    return out.reshape(h, w * bpp)


def to_rgb_reference(samples: np.ndarray, color_type: int, palette: np.ndarray) -> np.ndarray:
    """(H, W bpp) uint8 samples -> (H, W, 3) uint8 RGB, as Pillow's
    ``convert("RGB")``; ``palette`` is (256, 3) uint8."""
    px = samples.reshape(samples.shape[0], -1, CHANNELS[color_type])
    if color_type in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    if color_type == 3:
        return palette[px[..., 0]]
    return np.ascontiguousarray(px[..., :3])


def decode_reference(filtered: np.ndarray, png: Png) -> torch.Tensor:
    """Both plain versions on the host: filtered scanlines -> (H, W, 3)
    uint8 RGB on the CPU."""
    return torch.from_numpy(to_rgb_reference(unfilter_reference(filtered, png.bpp), png.color_type, png.palette))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library("png_decode", "threedod_png_unfilter_rgb", [p, i, i, i, i, p, p, p, p])


def unfilter_rgb_cuda(filtered: torch.Tensor, png: Png) -> torch.Tensor:
    """The kernel on CUDA filtered scanlines (H, 1 + W bpp) uint8 ->
    (H, W, 3) uint8 RGB on the same card."""
    global LAUNCHES
    if not filtered.is_cuda:
        raise ValueError(f"the PNG kernel runs on a CUDA device, not on {filtered.device}")
    h, w, bpp = png.height, png.width, png.bpp
    if filtered.dtype != torch.uint8 or tuple(filtered.shape) != (h, 1 + w * bpp) or not filtered.is_contiguous():
        raise ValueError(f"filtered scanlines must be contiguous uint8 ({h}, {1 + w * bpp}), got {filtered.dtype} "
                         f"{tuple(filtered.shape)}")
    dev = filtered.device
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    carry = torch.empty(w * bpp, dtype=torch.uint8, device=dev)  # a band's last row, for the next band
    palette = torch.from_numpy(png.palette).to(dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check_launch(lib, "PNG unfilter", lib.threedod_png_unfilter_rgb(
        filtered.data_ptr(), h, w, bpp, png.color_type, palette.data_ptr(), carry.data_ptr(), out.data_ptr(),
        stream))
    LAUNCHES += 1
    return out


def decode_png(data: bytes, device: Union[str, torch.device]) -> torch.Tensor:
    """A PNG file's bytes -> (H, W, 3) uint8 RGB on ``device``: the kernel
    on a CUDA device, the plain versions on the CPU; raises ``ValueError``
    for a file the decoder does not take."""
    device = torch.device(device)
    png = parse(data)
    filtered = inflate(png)
    if device.type == "cuda":
        return unfilter_rgb_cuda(torch.from_numpy(filtered.copy()).to(device), png)
    if device.type != "cpu":
        raise ValueError(f"PNG files are decoded on a CUDA device or the CPU, not on {device}")
    return decode_reference(filtered, png)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def filter_rows(samples: np.ndarray, bpp: int, filters: Union[int, Sequence[int]]) -> np.ndarray:
    """The forward filters: (H, W bpp) uint8 samples and a filter type a row
    (or one for all) -> (H, 1 + W bpp) uint8 filtered scanlines."""
    h, n = samples.shape
    ftype = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    x = samples.astype(np.int32)
    up = np.concatenate([np.zeros((1, n), np.int32), x[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int32), x[:, :-bpp]], axis=1)
    upleft = np.concatenate([np.zeros((h, bpp), np.int32), up[:, :-bpp]], axis=1)
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])[ftype, np.arange(h)]
    return np.concatenate([ftype[:, None], ((x - pred) & 255).astype(np.uint8)], axis=1)


def encode_png(pixels: np.ndarray, color_type: int, filters: Union[int, Sequence[int]] = 0,
               palette: Optional[np.ndarray] = None, level: int = 6) -> bytes:
    """An 8-bit non-interlaced PNG file of (H, W, channels) uint8 ``pixels``
    (palette indices for colour type 3, with ``palette`` (N, 3) uint8), each
    row under the filter type ``filters`` gives it."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    if pixels.dtype != np.uint8 or c != CHANNELS[color_type]:
        raise ValueError(f"colour type {color_type} takes (H, W, {CHANNELS[color_type]}) uint8, got "
                         f"{pixels.dtype} {pixels.shape}")
    rows = filter_rows(pixels.reshape(h, w * c), c, filters)
    plte = _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if color_type == 3 else b""
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)) + plte
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
