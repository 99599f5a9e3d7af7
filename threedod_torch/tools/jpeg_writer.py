"""A JPEG writer in numpy, for the decoder's tests and ``chip_smoke.py``: it
writes the files Pillow cannot (YCCK, sampling factors of 3 and 4, an MCU of
any shape, R, G, B component IDs without a marker, one scan per component,
arithmetic coding, lossless frames), from quantized DCT coefficients or
samples that the caller gives, so what a decoder must return is known
without any encoder's rounding.

    blocks = random_blocks(np.random.RandomState(0), 61, 45, [(4, 1), (1, 1), (1, 1)])
    data = encode_jpeg(61, 45, blocks, [(4, 1), (1, 1), (1, 1)], jfif=True)

``encode_jpeg`` writes SOI, an optional JFIF APP0 and Adobe APP14 (with its
transform byte), Annex K's two 8-bit quantization tables (the first
component uses table 0, the others table 1), a frame of 1 to 4 components
with the given sampling factors and IDs, an optional restart interval, and
either one interleaved scan or one scan per component, then EOI. Huffman
coding (SOF0) uses the four tables of the JPEG standard's Annex K (K.3 to
K.6; luminance for the first component, chrominance for the others): DC
differences need at most 11 bits and AC values at most 10. Arithmetic coding
(``arithmetic=True``; a port of libjpeg's jcarith.c, T.81 Annexes D, F.1.4
and G.1.3) writes SOF9, or SOF10 with a progressive scan script
(``progression`` gives libjpeg's), with an optional DAC segment. ``blocks``
holds each component's coefficients as (blocks_h, blocks_w, 64) in natural
order over the MCU-padded block grid (``block_grid``), as
``jpeg.Coefficients`` stores them; a one-component scan codes only the
component's own ceil(width / 8) x ceil(height / 8) blocks.

``transcode_arithmetic`` makes a Huffman file arithmetic-coded with its own
scans, as ``jpegtran -arithmetic`` does; ``scans``, ``without_scans`` and
``incomplete`` cut a progressive file's scans, leaving an incomplete
progression. ``encode_lossless`` writes a lossless file (SOF3,
Huffman-coded; T.81 Annex H as libjpeg's jclossls.c and jclhuff.c code it)
of each component's samples with any predictor and point transform. ``image_blocks`` makes coefficients from pixels (JFIF's
RGB -> YCbCr, box-filter downsampling, a float DCT, rounding), to rewrite a
real image at another sampling.
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


def _scan_units(scan: Sequence[int], factors, sizes, grid) -> list:
    """The units of a scan in coding order, each a list of (component,
    block index in its grid): the component's own blocks one a unit in a
    one-component scan, else the MCUs of the interleaved components."""
    if len(scan) == 1:
        k = scan[0]
        (ch, cw), bw = sizes[k], grid[k][1]
        return [[(k, y * bw + x)] for y in range(-(-ch // 8)) for x in range(-(-cw // 8))]
    mcus_h, mcus_w = grid[0][0] // factors[0][1], grid[0][1] // factors[0][0]
    return [[(k, (my * v + by) * grid[k][1] + mx * h + bx) for k in scan for h, v in [factors[k]]
             for by in range(v) for bx in range(h)] for my in range(mcus_h) for mx in range(mcus_w)]


def _frame(marker: int, width: int, height: int, factors, ids, precision: int = 8) -> bytes:
    return _segment(marker, bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([len(factors)]) + b"".join(bytes([ids[k], (h << 4) | v, min(k, 1)])
                                                       for k, (h, v) in enumerate(factors)))


def _dac_segment(dac: dict) -> bytes:
    return _segment(0xCC, b"".join(bytes([tc << 4 | tb, value]) for (tc, tb), value in sorted(dac.items())))


def _app_markers(jfif: bool, adobe: Optional[int]) -> bytes:
    out = b""
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    return out


def encode_jpeg(width: int, height: int, blocks: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                ids: Optional[Sequence[int]] = None, jfif: bool = False, adobe: Optional[int] = None,
                restart: int = 0, interleaved: bool = True, arithmetic: bool = False,
                scans: Optional[Sequence[tuple]] = None, dac: Optional[dict] = None,
                quant: Optional[Sequence[np.ndarray]] = None) -> bytes:
    """A JPEG of ``blocks`` (see the module's docstring), with Annex K's
    quantization tables (``QUANT``) or the two of ``quant`` (natural order,
    1 to 255; the first component's, the others'). ``ids``: the components'
    IDs, 1 to n by default; ``adobe``: an Adobe APP14 marker with this transform (0 none or
    CMYK, 1 YCbCr, 2 YCCK); ``restart``: a restart marker every that many
    MCUs (blocks, in a one-component scan). Huffman-coded (SOF0, Annex K's
    tables) unless ``arithmetic``: then SOF9, or SOF10 with ``scans``, a
    progressive scan script of (components, Ss, Se, Ah, Al) tuples
    (``progression`` gives libjpeg's), coded by ``_ArithEncoder``; ``dac``:
    a DAC segment of {(class, table): value} (class 0: DC, value L + 16 U;
    class 1: AC, value Kx), else T.81's defaults L 0, U 1, Kx 5."""
    n = len(factors)
    if not 1 <= n <= 4 or len(blocks) != n:
        raise ValueError(f"{n} components with {len(blocks)} block arrays: 1 to 4 are written")
    if (scans is not None or dac is not None) and not arithmetic:
        raise ValueError("scan scripts and DAC segments are written for arithmetic coding only")
    grid = block_grid(width, height, factors)
    for b, (bh, bw) in zip(blocks, grid):
        if b.shape != (bh, bw, 64):
            raise ValueError(f"a component's blocks are {b.shape}, its grid is {(bh, bw, 64)}")
    ids = list(range(1, n + 1)) if ids is None else list(ids)
    out = bytearray(b"\xff\xd8") + _app_markers(jfif, adobe)
    out += _segment(0xDB, b"".join(bytes([t]) + bytes(np.asarray(q, np.uint8)[NATURAL_ORDER]) for t, q in
                                   enumerate(QUANT if quant is None else quant)))
    out += _frame(0xC0 if not arithmetic else 0xCA if scans is not None else 0xC9, width, height, factors, ids)
    if not arithmetic:
        out += _segment(0xC4, b"".join(bytes([tc << 4 | th]) + bytes(HUFFMAN[name][0]) + bytes(HUFFMAN[name][1])
                                       for tc, th, name in ((0, 0, "dc_luma"), (1, 0, "ac_luma"),
                                                            (0, 1, "dc_chroma"), (1, 1, "ac_chroma"))))
    if dac:
        out += _dac_segment(dac)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    zigzag = [b.reshape(-1, 64)[:, NATURAL_ORDER].astype(np.int64).tolist() for b in blocks]
    sizes = component_size(width, height, factors)
    progressive = scans is not None
    if scans is None:
        scans = [(tuple(range(n)), 0, 63, 0, 0)] if interleaved and n > 1 else [((k,), 0, 63, 0, 0) for k in range(n)]
    conditioning = _Conditioning(dac)
    tables = [(min(k, 1), min(k, 1)) for k in range(n)]  # (DC, AC) table of each component: 0 the first's, 1 others
    for comps, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[k], min(k, 1) * 0x11]) for k in comps)
                        + bytes([ss, se, (ah << 4) | al]))
        units = _scan_units(comps, factors, sizes, grid)
        if arithmetic:
            out += _arith_scan(zigzag, units, comps, tables, (ss, se, ah, al), restart, conditioning, progressive)
        else:
            out += _huffman_scan(zigzag, units, n, restart)
    return bytes(out + b"\xff\xd9")


def _huffman_scan(zigzag, units, n: int, restart: int) -> bytes:
    tables = [(_codes(*HUFFMAN["dc_luma"]), _codes(*HUFFMAN["ac_luma"])),
              (_codes(*HUFFMAN["dc_chroma"]), _codes(*HUFFMAN["ac_chroma"]))]
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
    return bytes(bits.out)


def scans(data: bytes) -> List[tuple]:
    """(start, end, component IDs, Ss, Se, Ah, Al) of each scan of a JPEG:
    the bytes of its SOS segment and its entropy-coded data."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            ns = data[pos + 4]
            ss, se, ahal = data[pos + 5 + 2 * ns:pos + 8 + 2 * ns]
            while not (data[end] == 0xFF and data[end + 1] != 0 and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            out.append((pos, end, tuple(data[pos + 5:pos + 5 + 2 * ns:2]), ss, se, ahal >> 4, ahal & 15))
        pos = end
    return out


def without_scans(data: bytes, drop: Sequence[int]) -> bytes:
    """A progressive JPEG without the scans numbered ``drop`` (``scans``'
    order): an incomplete progression, if they sent bits that no later scan
    sends."""
    out, pos = bytearray(), 0
    for start, end, *_ in (s for k, s in enumerate(scans(data)) if k in set(drop)):
        out += data[pos:start]
        pos = end
    return bytes(out + data[pos:])


def incomplete(data: bytes, cut: str) -> bytes:
    """A progressive JPEG cut to an incomplete progression, which libjpeg
    smooths: ``dc_only`` without its AC scans, ``no_ac_refinement`` without
    its AC refinements, ``first_refinement`` without the first component's
    last AC refinement."""
    found = scans(data)
    if cut == "dc_only":
        drop = [k for k, s in enumerate(found) if s[3] > 0]
    elif cut == "no_ac_refinement":
        drop = [k for k, s in enumerate(found) if s[3] > 0 and s[5] > 0]
    elif cut == "first_refinement":
        drop = [max(k for k, s in enumerate(found) if s[2] == found[0][2][:1] and s[3] > 0 and s[5] > 0)]
    else:
        raise ValueError(f"unknown cut {cut!r}")
    return without_scans(data, drop)


def progression(n: int) -> List[tuple]:
    """libjpeg's ``jpeg_simple_progression`` scan script for n components:
    its YCbCr script for 3, its all-purpose one otherwise; each scan
    (components, Ss, Se, Ah, Al). Every coefficient bit is sent."""
    every = tuple(range(n))
    if n == 3:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    return ([(every, 0, 0, 0, 1)] + [((k,), 1, 5, 0, 2) for k in every] + [((k,), 6, 63, 0, 2) for k in every]
            + [((k,), 1, 63, 2, 1) for k in every] + [(every, 0, 0, 1, 0)] + [((k,), 1, 63, 1, 0) for k in every])


# ---------------------------------------------------------------------------
# arithmetic coding (T.81 Annexes D, F.1.4 and G.1.3; libjpeg's jcarith.c)
# ---------------------------------------------------------------------------

# T.81 Table D.2 as jaricom.c's jpeg_aritab holds it: per state, (Qe,
# Next_Index_LPS, Next_Index_MPS, Switch_MPS); state 113 is the fixed
# probability 0.5 (T.851) that codes the AC signs and the refinement bits
ARITH_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
# per state: Qe, the next state (with the MPS switch in bit 7) after an LPS, after an MPS
_QE = [q for q, _, _, _ in ARITH_TABLE]
_NEXT_LPS = [(switch << 7) | lps for _, lps, _, switch in ARITH_TABLE]
_NEXT_MPS = [mps for _, _, mps, _ in ARITH_TABLE]
FIXED_STATE = 113


class _ArithEncoder:
    """jcarith.c's QM coder: the C and A registers, the byte held back for
    a carry (``buffer``), the stacked 0xFF bytes (``sc``) and the held-back
    zero bytes (``zc``, dropped at the end of a segment). A statistics bin
    is one int: its state index, and the MPS in bit 7."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _carry_out(self) -> None:
        """The held byte plus the carry out, and the stacked 0xFF bytes
        become zeros."""
        if self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def _flush_held(self) -> None:
        """The held byte and the stacked 0xFF bytes, which no carry reaches
        any more."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: list, i: int, val: int) -> None:
        """arith_encode: the decision ``val`` in bin ``st[i]``."""
        sv = st[i]
        qe = _QE[sv & 0x7F]
        a = self.a - qe
        if val != sv >> 7:  # the less probable symbol
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ _NEXT_LPS[sv & 0x7F]
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:  # conditional exchange
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ _NEXT_MPS[sv & 0x7F]
        c, ct = self.c, self.ct
        while True:  # renormalization and byte output (D.1.6)
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    self._carry_out()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_held()
                    self.buffer = temp
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self) -> None:
        """finish_pass (D.1.8): the C value with the most trailing zero
        bits in the interval, its last bytes only where not zero."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        c = temp + 0x8000 if temp < self.c else temp
        c <<= self.ct
        if c & 0xF8000000:
            self._carry_out()
        else:
            self._flush_held()
        if c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if c & mask:
                    self.out.append((c >> shift) & 0xFF)
                    if self.out[-1] == 0xFF:
                        self.out.append(0)


class _Conditioning:
    """The DAC values of each arithmetic table: DC (L, U), AC Kx."""

    def __init__(self, dac: Optional[dict]):
        self.dc = {t: (0, 1) for t in range(16)}
        self.ac = {t: 5 for t in range(16)}
        for (tc, tb), value in (dac or {}).items():
            if tc == 0:
                self.dc[tb] = (value & 15, value >> 4)
            else:
                self.ac[tb] = value


def _arith_magnitude(enc: _ArithEncoder, st: list, i: int, x1: int, x2: int, v: int) -> int:
    """F.1.4.3 (Figures F.8 and F.9) for a value whose magnitude less one is
    ``v``: the first category decision in bin ``i``, the next ones from X1
    on (DC: 20; AC: the same bin as the first), then X2 (DC: 21; AC: 189 or
    217) and up; the magnitude's bits below the category's top bit in the
    bins 14 above; returns that top bit, m."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m, i, v2 = 1, x1, v >> 1
        while v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = x2 if i == x1 else i + 1
            v2 >>= 1
    enc.encode(st, i, 0)
    bit = m >> 1
    while bit:
        enc.encode(st, i + 14, 1 if bit & v else 0)
        bit >>= 1
    return m


def _arith_dc(enc: _ArithEncoder, st: list, ctx: int, diff: int, lu: Tuple[int, int]) -> int:
    """One DC difference (F.1.4.1) in the statistics ``st`` from context
    ``ctx``; returns the next context (F.1.4.4.1.2)."""
    if diff == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    negative = diff < 0
    enc.encode(st, ctx + 1, int(negative))
    m = _arith_magnitude(enc, st, ctx + 2 + negative, 20, 21, abs(diff) - 1)
    if m < (1 << lu[0]) >> 1:
        return 0
    return (12 if m > (1 << lu[1]) >> 1 else 4) + 4 * negative


def _arith_ac(enc: _ArithEncoder, st: list, fixed: list, zz: list, ss: int, se: int, al: int, kx: int) -> None:
    """A block's band Ss..Se (zig-zag ``zz``) after the point transform by
    ``al`` (a division rounded towards 0), F.1.4.2."""
    vals = [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz[ss:se + 1]]
    ke = max((ss + j for j, v in enumerate(vals) if v), default=ss - 1)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)  # not the end of the block
        while vals[k - ss] == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        v = vals[k - ss]
        enc.encode(st, i + 1, 1)
        enc.encode(fixed, 0, int(v < 0))
        _arith_magnitude(enc, st, i + 2, i + 2, 189 if k <= kx else 217, abs(v) - 1)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc: _ArithEncoder, st: list, fixed: list, zz: list, ss: int, se: int, ah: int,
                     al: int) -> None:
    """A block's band Ss..Se refined from bit ``ah`` to bit ``al`` (G.1.3.3):
    a correction bit for each coefficient known nonzero, a sign for each
    newly nonzero one, an end-of-block decision only past the last
    coefficient the earlier scans made nonzero."""
    band = zz[ss:se + 1]
    ke = max((ss + j for j, v in enumerate(band) if abs(v) >> al), default=ss - 1)
    kex = max((ss + j for j, v in enumerate(band[:ke - ss + 1]) if abs(v) >> ah), default=ss - 1)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            c = zz[k]
            v = abs(c) >> al
            if v:
                if v >> 1:  # known nonzero: its correction bit
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, int(c < 0))
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_scan(zigzag, units, comps, tables, params, restart: int, cond: _Conditioning,
                progressive: bool) -> bytes:
    """One scan's arithmetic-coded data (jcarith.c encode_mcu and, where
    ``progressive``, encode_mcu_DC_first / _AC_first / _DC_refine /
    _AC_refine), with a restart marker every ``restart`` units; each
    restart resets the statistics, the DC predictions and contexts, and the
    coder."""
    ss, se, ah, al = params
    out = bytearray()
    enc = _ArithEncoder(out)
    fixed = [FIXED_STATE]
    dc_first, ac = ss == 0 and ah == 0, not progressive or ss > 0

    def fresh():
        dc = {tables[k][0]: [0] * 64 for k in comps} if dc_first else {}
        acs = {tables[k][1]: [0] * 256 for k in comps} if ac else {}
        return dc, acs, {k: 0 for k in comps}, {k: 0 for k in comps}

    dc_stats, ac_stats, pred, ctx = fresh()
    for u, unit in enumerate(units):
        if restart and u and u % restart == 0:
            enc.finish()
            out += bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
            enc.reset()
            dc_stats, ac_stats, pred, ctx = fresh()
        for k, b in unit:
            zz = zigzag[k][b]
            td, ta = tables[k]
            if not progressive:
                ctx[k] = _arith_dc(enc, dc_stats[td], ctx[k], zz[0] - pred[k], cond.dc[td])
                pred[k] = zz[0]
                _arith_ac(enc, ac_stats[ta], fixed, zz, 1, 63, 0, cond.ac[ta])
            elif ss == 0 and ah == 0:
                value = zz[0] >> al
                ctx[k] = _arith_dc(enc, dc_stats[td], ctx[k], value - pred[k], cond.dc[td])
                pred[k] = value
            elif ss == 0:
                enc.encode(fixed, 0, (zz[0] >> al) & 1)
            elif ah == 0:
                _arith_ac(enc, ac_stats[ta], fixed, zz, ss, se, al, cond.ac[ta])
            else:
                _arith_ac_refine(enc, ac_stats[ta], fixed, zz, ss, se, ah, al)
    enc.finish()
    return bytes(out)


def transcode_arithmetic(data: bytes, blocks: Sequence[np.ndarray], dac: Optional[dict] = None,
                         restart: Optional[int] = None) -> bytes:
    """What ``jpegtran -arithmetic`` makes of a Huffman-coded JPEG: every
    segment kept but the Huffman tables, the frame made SOF9 (from SOF0 or
    SOF1) or SOF10 (from SOF2), and each scan, with its own header, coded
    arithmetically from ``blocks``, the file's decoded coefficients (each
    component's (blocks_h, blocks_w, 64) grid in natural order, as
    ``jpeg.Coefficients.blocks`` gives them). ``dac``: a DAC segment before
    the first scan (as ``encode_jpeg``'s); ``restart``: a restart interval
    in place of the file's own DRI segments."""
    zigzag = [b.reshape(-1, 64)[:, NATURAL_ORDER].astype(np.int64).tolist() for b in blocks]
    out, pos = bytearray(b"\xff\xd8"), 2
    interval, progressive, first_scan, ids = 0, False, True, []
    cond = _Conditioning(dac)
    while True:
        while data[pos + 1] == 0xFF:  # fill bytes
            pos += 1
        m = data[pos + 1]
        if m == 0xD9:
            return bytes(out + b"\xff\xd9")
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:end]
        if m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            width, height = int.from_bytes(seg[3:5], "big"), int.from_bytes(seg[1:3], "big")
            ids = list(seg[6:6 + 3 * seg[5]:3])
            factors = [(hv >> 4, hv & 15) for hv in seg[7:6 + 3 * seg[5]:3]]
            grid, sizes = block_grid(width, height, factors), component_size(width, height, factors)
            out += _segment(0xCA if progressive else 0xC9, seg)
        elif m == 0xDD:
            interval = int.from_bytes(seg, "big")
            if restart is None:
                out += data[pos:end]
        elif m == 0xDA:
            if first_scan:
                if restart is not None:
                    interval = restart
                    out += _segment(0xDD, restart.to_bytes(2, "big"))
                if dac:
                    out += _dac_segment(dac)
                first_scan = False
            ns = seg[0]
            comps = [ids.index(cid) for cid in seg[1:1 + 2 * ns:2]]
            tables = {k: (t >> 4, t & 15) for k, t in zip(comps, seg[2:2 + 2 * ns:2])}
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            out += data[pos:end]
            out += _arith_scan(zigzag, _scan_units(comps, factors, sizes, grid), comps, tables,
                               (ss, se, ahal >> 4, ahal & 15), interval, cond, progressive)
            end = data.index(b"\xff", end)  # past the Huffman-coded data and its restart markers
            while data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end = data.index(b"\xff", end + 2)
        elif m != 0xC4:
            out += data[pos:end]
        pos = end


# ---------------------------------------------------------------------------
# lossless frames (T.81 Annex H; libjpeg's jclossls.c and jclhuff.c)
# ---------------------------------------------------------------------------

# a DC-class Huffman table with all 17 difference categories (0 to 16)
LOSSLESS_HUFFMAN = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], list(range(17)))


def _predict(x: np.ndarray, predictor: int, first_rows: np.ndarray, initial: int) -> np.ndarray:
    """H.1.2.1's prediction of every sample of a plane (int64): the first
    row of the scan and of each restart interval (``first_rows``) from the
    left, its first sample ``initial``; every other row's first sample from
    above, the others by ``predictor`` (1 to 7) of Ra (left), Rb (above)
    and Rc (above left)."""
    pred = np.zeros_like(x)
    ra, rb, rc = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    pred[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                    7: (ra + rb) >> 1}[predictor]
    pred[1:, 0] = x[:-1, 0]
    pred[first_rows, 1:] = x[first_rows, :-1]
    pred[first_rows, 0] = initial
    return pred


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of ``lengths`` bits (most significant first) one after another,
    the last byte padded with 1 bits, 0xFF stuffed with 0x00."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    bits = np.ones(int(ends[-1]) + (-int(ends[-1]) % 8) if len(ends) else 0, np.uint8)
    for b in range(int(lengths.max()) if len(lengths) else 0):
        sel = lengths > b
        bits[starts[sel] + b] = (values[sel] >> (lengths[sel] - 1 - b)) & 1
    data = np.packbits(bits)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def encode_lossless(width: int, height: int, planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                    predictor: int = 1, pt: int = 0, ids: Optional[Sequence[int]] = None, jfif: bool = False,
                    adobe: Optional[int] = None, restart: int = 0, interleaved: bool = True, precision: int = 8,
                    diffs: Optional[Sequence[np.ndarray]] = None) -> bytes:
    """A lossless JPEG (SOF3, Huffman-coded) of ``planes``, each
    component's samples at its own size (``component_size``), with
    ``predictor`` (Ss, 1 to 7) and the point transform ``pt`` (Al: each
    sample shifted right by it) in one interleaved scan or one scan a
    component, one DC table of the 17 categories (``LOSSLESS_HUFFMAN``),
    a restart marker every ``restart`` MCUs (samples, in a one-component
    scan). The first row of a scan and of each restart interval is
    predicted from the left, its first sample by 2^(P - Pt - 1); a
    difference is taken modulo 2^16, category 16 (32768) has no extra
    bits. An interleaved MCU's samples past a component's edge code a
    difference of 0. ``diffs``: each component's differences to code as
    they are, in place of those of ``planes``."""
    n = len(factors)
    ids = list(range(1, n + 1)) if ids is None else list(ids)
    sizes = component_size(width, height, factors)
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcus_w, mcus_h = -(-width // hmax), -(-height // vmax)
    code = _codes(*LOSSLESS_HUFFMAN)
    code_of = np.array([code[s][0] for s in range(17)], np.int64)
    length_of = np.array([code[s][1] for s in range(17)], np.int64)
    out = bytearray(b"\xff\xd8") + _app_markers(jfif, adobe)
    out += _frame(0xC3, width, height, factors, ids, precision)
    out += _segment(0xC4, bytes([0]) + bytes(LOSSLESS_HUFFMAN[0]) + bytes(LOSSLESS_HUFFMAN[1]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    scans = [list(range(n))] if interleaved and n > 1 else [[k] for k in range(n)]
    for scan in scans:
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[k], 0]) for k in scan)
                        + bytes([predictor, 0, pt]))
        if len(scan) == 1:  # the MCU is one sample, the MCU row one row of the component
            shape = {scan[0]: (1, 1)}
            units_w, units_h = sizes[scan[0]][1], sizes[scan[0]][0]
        else:
            shape = {k: (factors[k][1], factors[k][0]) for k in scan}
            units_w, units_h = mcus_w, mcus_h
        per_mcu = []
        for k in scan:
            (ch, cw), (bv, bh) = sizes[k], shape[k]
            rows = np.arange(ch) // bv  # each sample row's MCU row
            starts = np.zeros(ch, bool)
            starts[0] = True
            if restart:
                starts |= (rows * units_w % restart == 0) & (np.arange(ch) % bv == 0)
            if diffs is None:
                x = np.asarray(planes[k], np.int64) >> pt
                d = (x - _predict(x, predictor, starts, 1 << (precision - pt - 1))) & 0xFFFF
            else:
                d = np.asarray(diffs[k], np.int64) & 0xFFFF
            d = np.where(d > 32768, d - 65536, d)  # -32767 to 32768
            padded = np.zeros((units_h * bv, units_w * bh), np.int64)
            padded[:ch, :cw] = d
            per_mcu.append(padded.reshape(units_h, bv, units_w, bh).transpose(0, 2, 1, 3).reshape(units_h, units_w,
                                                                                                    bv * bh))
        d = np.concatenate(per_mcu, -1).reshape(units_h * units_w, -1)
        size = np.frexp(np.abs(d))[1].astype(np.int64)  # the bit length: 16 only for 32768
        extra = np.where(size == 16, 0, np.where(d >= 0, d, d + (1 << size) - 1))
        extra_len = np.where(size == 16, 0, size)
        values, lengths = (code_of[size] << extra_len) | extra, length_of[size] + extra_len
        step = restart or len(d)
        for r, first in enumerate(range(0, len(d), step)):
            if r:
                out += bytes([0xFF, 0xD0 + (r - 1) % 8])
            out += _pack_bits(values[first:first + step].reshape(-1), lengths[first:first + step].reshape(-1))
    return bytes(out + b"\xff\xd9")
