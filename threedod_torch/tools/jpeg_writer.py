"""A baseline JPEG writer in numpy, for the decoder's tests and
``chip_smoke.py``: it writes the files Pillow cannot (YCCK, sampling factors
of 3 and 4, an MCU of any shape, R, G, B component IDs without a marker,
one scan per component), from quantized DCT coefficients that the caller
gives, so what a decoder must return is known without any encoder's
rounding.

    blocks = random_blocks(np.random.RandomState(0), 61, 45, [(4, 1), (1, 1), (1, 1)])
    data = encode_jpeg(61, 45, blocks, [(4, 1), (1, 1), (1, 1)], jfif=True)

``encode_jpeg`` writes SOI, an optional JFIF APP0 and Adobe APP14 (with its
transform byte), Annex K's two 8-bit quantization tables (the first
component uses table 0, the others table 1), a SOF0 frame of 1 to 4 components with the
given sampling factors and IDs, the four Huffman tables of the JPEG
standard's Annex K (K.3 to K.6; luminance for the first component,
chrominance for the others), an optional restart interval, and either one
interleaved scan or one scan per component, then EOI. ``blocks`` holds each
component's coefficients as (blocks_h, blocks_w, 64) in natural order over
the MCU-padded block grid (``block_grid``), as ``jpeg.Coefficients`` stores
them; a one-component scan codes only the component's own
ceil(width / 8) x ceil(height / 8) blocks. DC differences need at most 11
bits and AC values at most 10, as Annex K's tables hold.

``image_blocks`` makes such coefficients from pixels (JFIF's RGB -> YCbCr,
box-filter downsampling, a float DCT, rounding), to rewrite a real image at
another sampling.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# zig-zag index -> natural (row-major) index (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])

# Annex K.1 and K.2: the luminance and chrominance quantization tables (natural order)
QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
    51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121,
    120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
QUANT_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
                        + [47, 66] + [99] * 38)
QUANT = (QUANT_LUMA, QUANT_CHROMA)  # the first component's table, the others'

# Annex K.3 to K.6: (code counts by length 1 to 16, symbols) of the DC and AC
# tables for luminance and chrominance
_AC_LUMA_VALUES = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALUES = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a353637"
    "38393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3"
    "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(_AC_LUMA_VALUES)),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(_AC_CHROMA_VALUES)),
}


def _codes(counts: Sequence[int], values: Sequence[int]) -> dict:
    """symbol -> (code, length) of a canonical Huffman table (Annex C)."""
    table, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            table[values[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return table


def block_grid(width: int, height: int, factors: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """(blocks_h, blocks_w) of each component's MCU-padded block grid."""
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcus_w, mcus_h = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    return [(mcus_h * v, mcus_w * h) for h, v in factors]


def component_size(width: int, height: int, factors: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """(height, width) of each component's own samples, ceil(H v / vmax) x
    ceil(W h / hmax)."""
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    return [(-(-height * v // vmax), -(-width * h // hmax)) for h, v in factors]


def seeded_samples(rng: np.random.RandomState, width: int, height: int, n: int) -> np.ndarray:
    """(H, W, n) uint8 samples from ``rng``: per component a random field of
    4 x 4 cells over the whole 0 to 255 range plus noise of 24 levels, so
    the blocks hold edges and fine detail."""
    cells = rng.randint(0, 256, (-(-height // 4), -(-width // 4), n)).astype(np.float64)
    field = cells.repeat(4, 0).repeat(4, 1)[:height, :width]
    return np.clip(field + rng.normal(0, 24, field.shape), 0, 255).astype(np.uint8)


def random_blocks(rng: np.random.RandomState, width: int, height: int,
                  factors: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Seeded coefficients of ``seeded_samples`` at ``factors`` with Annex
    K's tables (``image_blocks``). Coefficients of real content keep the
    inverse DCT's output near 0 to 255; libjpeg-turbo's SIMD IDCT saturates
    far outside it where its C code (and the port) wraps, so arbitrary
    coefficients would be decoded differently by the two."""
    return image_blocks(seeded_samples(rng, width, height, len(factors)), factors)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr in float64, (H, W, 3)."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return np.stack([y, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b, 128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)


def image_blocks(samples: np.ndarray, factors: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Quantized coefficients of an (H, W, n) image of n components' samples
    (0 to 255) at ``factors``: each component averaged over its (hmax / h)
    x (vmax / v) cells (a fractional ratio is refused), its plane extended
    by its edge to the block grid, the DCT of each block in float64, divided
    by the table ``encode_jpeg`` gives the component (``QUANT``) and
    rounded."""
    height, width = samples.shape[:2]
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    x = np.arange(8)
    dct = np.sqrt(np.where(x == 0, 1, 2) / 8)[:, None] * np.cos((2 * x[None] + 1) * x[:, None] * np.pi / 16)
    out = []
    for k, ((h, v), (bh, bw)) in enumerate(zip(factors, block_grid(width, height, factors))):
        if hmax % h or vmax % v:
            raise ValueError(f"a fractional sampling ratio {hmax}/{h} x {vmax}/{v}")
        fx, fy = hmax // h, vmax // v
        p = samples[..., k].astype(np.float64)
        p = np.pad(p, ((0, -height % fy), (0, -width % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))
        p = np.pad(p, ((0, 8 * bh - p.shape[0]), (0, 8 * bw - p.shape[1])), mode="edge") - 128
        tiles = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ tiles @ dct.T
        q = QUANT[min(k, 1)].astype(np.float64).reshape(8, 8)
        out.append(np.round(coef / q).astype(np.int16).reshape(bh, bw, 64))
    return out


class _Bits:
    """Entropy-coded bytes: bits most significant first, 0xFF stuffed with
    0x00, the last byte padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(bits: _Bits, v: int, size: int) -> None:
    bits.put(v if v >= 0 else v + (1 << size) - 1, size)


def _encode_block(bits: _Bits, zz: list, pred: int, dc: dict, ac: dict) -> int:
    """One block (64 ints, zig-zag order) after DC prediction ``pred``;
    returns the block's DC value, the next prediction."""
    diff = zz[0] - pred
    size = abs(diff).bit_length()
    if size > 11:
        raise ValueError(f"a DC difference of {diff} needs more than 11 bits")
    bits.put(*dc[size])
    _magnitude(bits, diff, size)
    run = 0
    for k in range(1, 64):
        v = zz[k]
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        size = abs(v).bit_length()
        if size > 10:
            raise ValueError(f"an AC value of {v} needs more than 10 bits")
        bits.put(*ac[(run << 4) | size])
        _magnitude(bits, v, size)
        run = 0
    if run:
        bits.put(*ac[0x00])  # EOB
    return zz[0]


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(width: int, height: int, blocks: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                ids: Optional[Sequence[int]] = None, jfif: bool = False, adobe: Optional[int] = None,
                restart: int = 0, interleaved: bool = True) -> bytes:
    """A baseline JPEG of ``blocks`` (see the module's docstring), with
    Annex K's quantization tables (``QUANT``). ``ids``: the components'
    IDs, 1 to n by default; ``adobe``: an Adobe APP14 marker with
    this transform (0 none or CMYK, 1 YCbCr, 2 YCCK); ``restart``: a restart
    marker every that many MCUs (blocks, in a one-component scan)."""
    n = len(factors)
    if not 1 <= n <= 4 or len(blocks) != n:
        raise ValueError(f"{n} components with {len(blocks)} block arrays: 1 to 4 are written")
    grid = block_grid(width, height, factors)
    for b, (bh, bw) in zip(blocks, grid):
        if b.shape != (bh, bw, 64):
            raise ValueError(f"a component's blocks are {b.shape}, its grid is {(bh, bw, 64)}")
    ids = list(range(1, n + 1)) if ids is None else list(ids)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += _segment(0xDB, b"".join(bytes([t]) + bytes(np.asarray(q, np.uint8)[NATURAL_ORDER]) for t, q in
                                   enumerate(QUANT)))
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([n]) + b"".join(
        bytes([ids[k], (h << 4) | v, min(k, 1)]) for k, (h, v) in enumerate(factors)))
    out += _segment(0xC4, b"".join(bytes([tc << 4 | th]) + bytes(HUFFMAN[name][0]) + bytes(HUFFMAN[name][1])
                                   for tc, th, name in ((0, 0, "dc_luma"), (1, 0, "ac_luma"), (0, 1, "dc_chroma"),
                                                        (1, 1, "ac_chroma"))))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    tables = [(_codes(*HUFFMAN["dc_luma"]), _codes(*HUFFMAN["ac_luma"])),
              (_codes(*HUFFMAN["dc_chroma"]), _codes(*HUFFMAN["ac_chroma"]))]
    zigzag = [b.reshape(-1, 64)[:, NATURAL_ORDER].astype(np.int64).tolist() for b in blocks]
    sizes = component_size(width, height, factors)
    scans = [list(range(n))] if interleaved and n > 1 else [[k] for k in range(n)]
    for scan in scans:
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[k], min(k, 1) * 0x11]) for k in scan)
                        + bytes([0, 63, 0]))
        if len(scan) == 1:  # the component's own blocks, one an MCU
            k = scan[0]
            (ch, cw), bw = sizes[k], grid[k][1]
            units = [[(k, y * bw + x)] for y in range(-(-ch // 8)) for x in range(-(-cw // 8))]
        else:
            mcus_h, mcus_w = grid[0][0] // factors[0][1], grid[0][1] // factors[0][0]
            units = [[(k, (my * v + by) * grid[k][1] + mx * h + bx) for k in scan for by in range(factors[k][1])
                      for bx in range(factors[k][0]) for h, v in [factors[k]]]
                     for my in range(mcus_h) for mx in range(mcus_w)]
        bits, pred = _Bits(), [0] * n
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
                pred = [0] * n
            for k, i in unit:
                dc, ac = tables[min(k, 1)]
                pred[k] = _encode_block(bits, zigzag[k][i], pred[k], dc, ac)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")
