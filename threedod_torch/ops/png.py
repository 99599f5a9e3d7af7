"""The card's PNG decoder, equal to Pillow's ``convert("RGB")`` (PNG is
lossless, so equal means every sample).

``decode_png(data, device)`` takes the bytes of a PNG of any colour type
(gray, gray + alpha, palette, RGB, RGBA) at any bit depth the colour type
allows (1, 2, 4, 8 or 16), interlaced (Adam7) or not, and returns (H, W, 3)
uint8 RGB on ``device``:

1. on the host, ``parse`` walks the chunks, checks every CRC, reads IHDR and
   PLTE, and ``inflate`` inflates the IDAT data with the stdlib ``zlib`` into
   the filtered scanlines of each plane: the whole image, or each of Adam7's
   seven passes that has pixels, (h, 1 + row bytes), each row's filter type
   first; ``layout`` lays the planes out for the kernel;
2. on the card, ``csrc/png_decode.cu``'s kernel undoes the five row filters
   (None, Sub, Up, Average, Paeth) of every plane in one launch, unpacks the
   samples, converts to RGB as Pillow does and scatters each pass's pixels
   to their places in the image.

Pillow's conversions, which ``to_rgb_reference`` and the kernel follow: gray
to three equal channels (1-bit samples times 255, 2-bit times 85, 4-bit
times 17; 16-bit gray opens as ``I;16`` and is clamped at 255, not shifted);
alpha dropped; a palette index looked up (an index past the palette is
black); 16-bit RGB, RGBA and gray + alpha keep each sample's high byte.

Anything that is not a PNG of these kinds raises ``ValueError`` and says why;
nothing falls back to another decoder. On a CPU tensor the wrapper runs the
plain version (``unfilter_reference``, ``unpack_reference`` and
``to_rgb_reference``, integer numpy on the host), which ``chip_smoke.py``
holds the kernel against on the same bytes. Every launch adds one to
``LAUNCHES``. ``encode_png`` writes such files at any depth, interlaced or
not, with a chosen filter a row (the forward filters in numpy, then
``zlib``), for the tests and the card's checks; ``png_hw`` reads an image's
size from IHDR without decoding it.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import _build

LAUNCHES = 0
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # PNG specification 11.2.2
# Adam7's passes: (x0, y0, dx, dy), the first pixel and the steps between pixels
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the kernel's conversions (png_decode.cu's Mode)
MODE_GRAY, MODE_GRAY_SCALED, MODE_GRAY16, MODE_PALETTE, MODE_CHANNEL = range(5)
ROWS = 32  # rows of a band: a warp, a row a lane


class Pass(NamedTuple):
    """A plane of the image: all of it, or one Adam7 pass."""
    x0: int
    y0: int
    dx: int
    dy: int
    width: int     # pixels of a row
    height: int    # rows


class Png(NamedTuple):
    width: int
    height: int
    color_type: int
    depth: int
    interlace: int
    palette: np.ndarray    # uint8 (256, 3): PLTE's entries, then black
    idat: bytes            # the IDAT chunks' data, concatenated

    @property
    def channels(self) -> int:
        return CHANNELS[self.color_type]

    @property
    def bpp(self) -> int:
        """Bytes of the filters' unit: a pixel's bytes, or 1 below 8 bits."""
        return max(1, self.channels * self.depth // 8)

    def row_bytes(self, width: int) -> int:
        return -(-width * self.channels * self.depth // 8)

    def passes(self) -> List[Pass]:
        """The planes that have pixels, in the stream's order."""
        if not self.interlace:
            return [Pass(0, 0, 1, 1, self.width, self.height)]
        out = []
        for x0, y0, dx, dy in ADAM7:
            w, h = -(-(self.width - x0) // dx), -(-(self.height - y0) // dy)
            if w > 0 and h > 0:  # a pass with no pixels has no rows and no filter bytes
                out.append(Pass(x0, y0, dx, dy, w, h))
        return out

    @property
    def mode(self) -> int:
        if self.color_type == 3:
            return MODE_PALETTE
        if self.color_type in (2, 6):
            return MODE_CHANNEL
        if self.color_type == 0 and self.depth == 16:
            return MODE_GRAY16
        return MODE_GRAY_SCALED if self.depth < 8 else MODE_GRAY

    def kernel_channels(self) -> List[tuple]:
        """The bytes of a filter unit the conversion reads, each a plane of
        the kernel: [(first byte in the unit, bytes, RGB byte it fills)]. The
        filters never mix a pixel's bytes, so the others (alpha, the low bytes
        of 16-bit samples) are not decoded; 16-bit gray's clamp reads both of
        its bytes."""
        if self.color_type in (2, 6):
            step = self.depth // 8
            return [(k * step, 1, k) for k in range(3)]
        return [(0, 2 if self.mode == MODE_GRAY16 else 1, 0)]


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
    if depth not in DEPTHS[color]:
        raise ValueError(f"{depth}-bit samples in a {COLOR_NAMES[color]} image: that colour type has "
                         f"{', '.join(map(str, DEPTHS[color]))} bits only")
    if interlace > 1:
        raise ValueError(f"interlace method {interlace}: only 0 (none) and 1 (Adam7) exist")
    if compression or filt:
        raise ValueError(f"compression method {compression}, filter method {filt}: only 0 and 0 exist")
    if not w or not h:
        raise ValueError(f"an empty {w}x{h} image")
    return w, h, color, depth, interlace


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
    w, h, color, depth, interlace = header
    if color == 3 and palette is None:
        raise ValueError("a palette image without a PLTE chunk")
    if not idat:
        raise ValueError("no IDAT chunk")
    return Png(w, h, color, depth, interlace, palette if palette is not None else np.zeros((256, 3), np.uint8),
               b"".join(idat))


def inflate(png: Png) -> List[np.ndarray]:
    """The filtered scanlines of each plane (``png.passes()``), uint8 (h, 1 +
    row bytes), inflated on the host; a size or filter type out of place
    raises ``ValueError``."""
    try:
        raw = zlib.decompress(png.idat)
    except zlib.error as e:
        raise ValueError(f"the IDAT data does not inflate: {e}") from e
    planes, pos = [], 0
    for p in png.passes():
        n = p.height * (1 + png.row_bytes(p.width))
        planes.append((pos, n, p))
        pos += n
    if len(raw) < pos:
        raise ValueError(f"the IDAT data inflates to {len(raw)} bytes, fewer than the {pos} of the image")
    out = [np.frombuffer(raw, np.uint8, n, start).reshape(p.height, -1) for start, n, p in planes]
    worst = max(int(rows[:, 0].max()) for rows in out)
    if worst > 4:
        raise ValueError(f"filter type {worst} in a row: the filter types are 0 to 4")
    return out


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
    w, h = _ihdr(body)[:2]
    return h, w


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG specification 9.4) on int32 arrays."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_reference(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + n) uint8 filtered scanlines -> (H, n) uint8 bytes, in numpy on
    the host; ``bpp`` is the filters' unit (``Png.bpp``).

    A unit needs its left, upper and upper-left neighbours done, so the rows
    go in a wavefront as the kernel's do: at step s row r undoes unit s - r,
    every row at once. The units are stored skewed, unit (r, x) at
    ``sk[x + r + 2, r + 1]`` (zeros above and beside the image), so a step
    reads and writes one contiguous stretch."""
    filtered = np.asarray(filtered)
    h, n = filtered.shape
    w = (n - 1) // bpp
    ftype = filtered[:, 0].astype(np.int32)
    if not ftype.any():
        return filtered[:, 1:].copy()
    data = filtered[:, 1:].reshape(h, w, bpp).astype(np.int32)
    skewed = np.zeros((w + h - 1, h, bpp), np.int32)  # [step, row]: the filtered unit row r undoes at step s
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


def unpack_reference(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, row bytes) uint8 unfiltered bytes -> (h, width, channels) samples:
    uint8 at 1 to 8 bits (packed samples MSB first, each row padded to a
    byte), uint16 from big-endian pairs at 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8 | pairs[..., 1]).reshape(h, width, channels)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(h, -1)[:, :width * channels].reshape(h, width, channels).astype(np.uint8)


def to_rgb_reference(samples: np.ndarray, color_type: int, depth: int, palette: np.ndarray) -> np.ndarray:
    """(h, w, channels) samples -> (h, w, 3) uint8 RGB, as Pillow's
    ``convert("RGB")``; ``palette`` is (256, 3) uint8."""
    if color_type == 3:
        return palette[samples[..., 0]]
    if color_type in (0, 4):
        gray = samples[..., 0].astype(np.int32)
        if depth == 16:
            gray = np.minimum(gray, 255) if color_type == 0 else gray >> 8  # I;16's clamp; LA;16B's high byte
        elif depth < 8:
            gray = gray * (255 // ((1 << depth) - 1))
        return np.repeat(gray.astype(np.uint8)[..., None], 3, axis=-1)
    rgb = samples[..., :3]
    return np.ascontiguousarray((rgb >> 8 if depth == 16 else rgb).astype(np.uint8))


def decode_reference(planes: Sequence[np.ndarray], png: Png) -> torch.Tensor:
    """The plain versions on the host: each plane's filtered scanlines
    (``inflate``) -> (H, W, 3) uint8 RGB on the CPU, each pass's pixels at
    their places."""
    out = np.zeros((png.height, png.width, 3), np.uint8)
    for filtered, p in zip(planes, png.passes()):
        samples = unpack_reference(unfilter_reference(filtered, png.bpp), p.width, png.channels, png.depth)
        out[p.y0::p.dy, p.x0::p.dx] = to_rgb_reference(samples, png.color_type, png.depth, png.palette)
    return torch.from_numpy(out)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

TABLE_FIELDS = ("in_offset", "ftype_offset", "carry_offset", "carry_stride", "pitch", "units", "height", "width",
                "x0", "y0", "dx", "dy", "first_band", "channel")
GROUP = 16  # units a lane's step group covers (png_decode.cu's GROUP)


class Layout(NamedTuple):
    """The kernel's input, made on the host: ``buf`` holds each channel
    plane's rows, then every row's filter type, then the palette (768
    bytes); ``table`` a row of ``TABLE_FIELDS`` a channel plane."""
    buf: np.ndarray        # uint8
    table: np.ndarray      # int64 (channel planes, len(TABLE_FIELDS))
    unit: int              # bytes of the kernel's unit: 2 for 16-bit gray, else 1
    palette_offset: int
    carry_words: int       # uint64 words of the bands' carry rows, the band ticket first
    bands: int


def layout(png: Png, planes: Sequence[np.ndarray]) -> Layout:
    """The kernel's input: each plane (``png.passes()``) split into the
    channels the conversion reads (``Png.kernel_channels``), each channel's
    rows skewed. A band of 32 rows of a channel is a warp, lane t the band's
    row t, and at step s lane t undoes unit s - t. Row r's unit x is stored
    at byte (x + r % 32) unit of the row, so a lane's step group g reads the
    row's bytes [16 g unit, 16 (g + 1) unit), one or two 16-byte vectors at
    the same place on every lane; the bytes before a row's first unit are
    zeros, which makes the units left of the image zero. A row is
    ceil((units + 31) / 16) groups long. The filter types follow all rows,
    a byte a row of each plane. The carry rows (a band's last row, read by
    the next band of its channel) have a uint64 word a unit, tagged in the
    high half, after two words of which the first counts the bands taken."""
    bpp = png.bpp
    blocks, table, pos, carry, bands = [], [], 0, 2, 0
    ftype_rows = []
    for filtered, p in zip(planes, png.passes()):
        units = (filtered.shape[1] - 1) // bpp
        groups = -(-(units + ROWS - 1) // GROUP)
        data = filtered[:, 1:].reshape(p.height, units, bpp)
        for first, unit, channel in png.kernel_channels():
            pitch = groups * GROUP * unit
            skewed = np.zeros((p.height, pitch), np.uint8)
            chan = data[:, :, first:first + unit].reshape(p.height, units * unit)
            for t in range(min(ROWS, p.height)):
                skewed[t::ROWS, t * unit:(t + units) * unit] = chan[t::ROWS]
            n_bands = -(-p.height // ROWS)
            stride = groups * GROUP  # whole groups: lane 0 loads a group's words by 16 bytes
            table.append([pos, len(ftype_rows), carry, stride, pitch, units, p.height, p.width, p.x0, p.y0, p.dx,
                          p.dy, bands, channel])
            blocks.append(skewed.reshape(-1))
            pos += skewed.size
            carry += (n_bands - 1) * stride
            bands += n_bands
        ftype_rows.append(filtered[:, 0])
    starts = np.cumsum([0] + [len(f) for f in ftype_rows])
    for row in table:  # the filter types' offset: the plane's index -> its first row's byte
        row[1] = pos + int(starts[row[1]])
    blocks.extend(ftype_rows)
    pos += int(starts[-1])
    blocks.append(np.zeros(-pos % 16, np.uint8))
    palette_offset = pos + (-pos % 16)
    blocks.append(png.palette.reshape(-1))
    unit = 2 if png.mode == MODE_GRAY16 else 1
    return Layout(np.concatenate(blocks), np.asarray(table, np.int64), unit, palette_offset, carry, bands)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = _build.library("png_decode", "threedod_png_decode", [p, p, i, i, i, i, p, p, i64, p, i, p])
    lib.threedod_png_step_latency.argtypes = [i, i, i, p, p]
    lib.threedod_png_step_latency.restype = i
    return lib


def unfilter_rgb_cuda(buf: torch.Tensor, lay: Layout, png: Png) -> torch.Tensor:
    """The kernel on ``layout``'s bytes copied to a card (uint8, 1-D,
    contiguous) -> (H, W, 3) uint8 RGB on the same card."""
    global LAUNCHES
    if not buf.is_cuda:
        raise ValueError(f"the PNG kernel runs on a CUDA device, not on {buf.device}")
    if buf.dtype != torch.uint8 or tuple(buf.shape) != lay.buf.shape or not buf.is_contiguous():
        raise ValueError(f"the kernel's input must be contiguous uint8 {lay.buf.shape}, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    dev = buf.device
    out = torch.empty((png.height, png.width, 3), dtype=torch.uint8, device=dev)
    carry = torch.empty(lay.carry_words, dtype=torch.int64, device=dev)
    table = np.ascontiguousarray(lay.table)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check_launch(lib, "PNG decode", lib.threedod_png_decode(
        buf.data_ptr(), table.ctypes.data, len(table), lay.unit, png.mode, png.depth,
        buf.data_ptr() + lay.palette_offset, carry.data_ptr(), lay.carry_words, out.data_ptr(), png.width, stream))
    LAUNCHES += 1
    return out


ROW_FILTERS, HOP_FILTERS = (1, 3, 4), (2, 3, 4)  # filters with a left, with an upper dependence


def step_latency_ns(device: torch.device, steps: int = 1 << 18) -> dict:
    """The card's time for one step of each filter's dependence chain:
    {"row": {filter: ns}, "hop": {filter: ns}}. One warp runs ``steps``
    steps, each on the last: along a row (Sub, Average, Paeth; the left unit
    in a register) or down a column (Up, Average, Paeth; the upper unit by a
    shuffle from the lane above); CUDA events around a launch, divided by
    the steps, the least of three after one that warms up."""
    lib = _lib()
    sink = torch.empty(32, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    out = {"row": {}, "hop": {}}
    for hop, filters in ((0, ROW_FILTERS), (1, HOP_FILTERS)):
        for f in filters:
            times = []
            for _ in range(4):  # the first launch warms up
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(stream)
                _build.check_launch(lib, "PNG step latency", lib.threedod_png_step_latency(
                    steps, f, hop, sink.data_ptr(), stream.cuda_stream))
                end.record(stream)
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e6 / steps)
            out["hop" if hop else "row"][f] = min(times[1:])
    return out


def dependence_path_ns(filter_types: Sequence[int], units: int, latency: dict) -> float:
    """The longest path through a plane's dependence graph: ``units`` units
    a row, the rows' ``filter_types``, each unit waiting for the units its
    filter reads (None: none; Sub: the left; Up: the upper; Average: both;
    Paeth: the left, upper and upper-left) and then taking one step of its
    filter's chain, ``latency["row"][f]`` ns after its left unit and
    ``latency["hop"][f]`` ns after one of the row above
    (``step_latency_ns``). A plane of Paeth rows is W row steps and H - 1
    hops."""
    x = np.arange(units, dtype=np.float64)
    prev, longest = None, 0.0  # the first row's upper units are constants
    for f in filter_types:
        f = int(f)
        if f == 0 or (f == 2 and prev is None):
            cur = np.zeros(units)
        elif f == 2:
            cur = prev + latency["hop"][2]
        else:
            t = latency["row"][f]
            start = np.full(units, t)  # the left unit of the row's first is a constant
            if f != 1 and prev is not None:
                upper = prev if f == 3 else np.maximum(prev, np.concatenate([[0.0], prev[:-1]]))
                start = np.maximum(start, upper + latency["hop"][f])
            cur = x * t + np.maximum.accumulate(start - x * t)
        longest = max(longest, float(cur.max()))
        prev = cur
    return longest


def decode_png(data: bytes, device: Union[str, torch.device]) -> torch.Tensor:
    """A PNG file's bytes -> (H, W, 3) uint8 RGB on ``device``: the kernel
    on a CUDA device, the plain versions on the CPU; raises ``ValueError``
    for a file the decoder does not take."""
    device = torch.device(device)
    png = parse(data)
    planes = inflate(png)
    if device.type == "cuda":
        lay = layout(png, planes)
        return unfilter_rgb_cuda(torch.from_numpy(lay.buf).to(device), lay, png)
    if device.type != "cpu":
        raise ValueError(f"PNG files are decoded on a CUDA device or the CPU, not on {device}")
    return decode_reference(planes, png)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def filter_rows(samples: np.ndarray, bpp: int, filters: Union[int, Sequence[int]]) -> np.ndarray:
    """The forward filters: (H, n) uint8 bytes and a filter type a row (or
    one for all) -> (H, 1 + n) uint8 filtered scanlines."""
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


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, channels) samples -> (h, row bytes) uint8 as a PNG stores them:
    16-bit samples big-endian, samples below 8 bits packed MSB first, each
    row padded to a byte with zero bits."""
    h, w, c = samples.shape
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    if depth == 16:
        s = samples.reshape(h, w * c).astype(np.uint16)
        return np.stack([s >> 8, s & 255], -1).reshape(h, 2 * w * c).astype(np.uint8)
    per = 8 // depth
    s = samples.reshape(h, w * c).astype(np.uint8)
    s = np.concatenate([s, np.zeros((h, -(w * c) % per), np.uint8)], 1).reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(s << shifts, axis=2).astype(np.uint8)


def encode_png(pixels: np.ndarray, color_type: int, filters: Union[int, Sequence[int]] = 0,
               palette: Optional[np.ndarray] = None, level: int = 6, bit_depth: int = 8,
               interlace: bool = False) -> bytes:
    """A PNG file of (H, W, channels) ``pixels`` (uint8 below 16 bits, each
    sample below 2 ** ``bit_depth``; uint16 at 16; palette indices for colour
    type 3, with ``palette`` (N, 3) uint8), Adam7-interlaced where
    ``interlace``; each row under the filter type ``filters`` gives it (one
    for all, or one a row of the stream: every pass's rows in turn)."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    if pixels.dtype != dtype or c != CHANNELS[color_type] or bit_depth not in DEPTHS[color_type]:
        raise ValueError(f"colour type {color_type} at {bit_depth} bits takes (H, W, {CHANNELS[color_type]}) "
                         f"{np.dtype(dtype).name} and depths {DEPTHS[color_type]}, got {pixels.dtype} {pixels.shape}")
    if bit_depth < 8 and int(pixels.max()) >> bit_depth:
        raise ValueError(f"a sample of {int(pixels.max())} does not fit {bit_depth} bits")
    png = Png(w, h, color_type, bit_depth, int(interlace), np.zeros((256, 3), np.uint8), b"")
    passes = png.passes()
    ftypes = np.broadcast_to(np.asarray(filters, np.uint8), (sum(p.height for p in passes),))
    stream, row = [], 0
    for p in passes:
        rows = pack_rows(pixels[p.y0::p.dy, p.x0::p.dx], bit_depth)
        stream.append(filter_rows(rows, png.bpp, ftypes[row:row + p.height]).reshape(-1))
        row += p.height
    plte = _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if color_type == 3 else b""
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, int(interlace))
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + plte
            + _chunk(b"IDAT", zlib.compress(np.concatenate(stream).tobytes(), level)) + _chunk(b"IEND", b""))
