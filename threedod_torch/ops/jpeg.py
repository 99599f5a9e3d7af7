"""The card's JPEG decoder, bit-equal to libjpeg(-turbo) with its defaults
(islow IDCT, "fancy" upsampling) and to Pillow's ``convert("RGB")``, as
Pillow and the JAX package's native loader decode.

``decode_jpeg(data, device)`` takes a JPEG's bytes (8-bit samples; 1, 3 or 4
components at any integer sampling ratio of factors 1 to 4): sequential or
progressive, Huffman- or arithmetic-coded (SOF0, SOF1, SOF2, SOF9, SOF10), or
lossless (SOF3, Huffman-coded); and returns (H, W, 3) uint8 RGB on the CUDA
``device``:

1. on the host, ``csrc/jpeg_entropy.cuh`` reads the markers and decodes the
   entropy-coded data of every scan: a DCT file's into each component's
   quantized DCT coefficients (``decode_coefficients``; a progressive file's
   DC and AC bands and their refinements, libjpeg's jdphuff.c and
   jdarith.c), a lossless file's into each component's samples
   (``decode_samples``; libjpeg's jdlhuff.c and jdlossls.c: the differences
   added to each sample's prediction); and decides the colour space of the
   samples as libjpeg does (``space``: a JFIF marker, then an Adobe
   marker's transform, then the component IDs; a lossless file's 3
   components without a marker are RGB);
2. on the card, a DCT file's coefficients go through ``csrc/jpeg_decode.cu``'s
   IDCT kernel, which dequantizes and runs libjpeg's islow IDCT (jidctint.c:
   integer, 13 fraction bits, 2 more bits between the passes) with the
   arithmetic of libjpeg-turbo's SIMD code, which Pillow runs: 16-bit lanes
   that wrap, saturation after each pass (``idct_islow_reference``), into
   each component's plane; a lossless file's samples are its planes, and
   launch no IDCT;
3. its colour kernel upsamples each component by the largest factors over
   its own (jdsample.c, the method ``jinit_upsampler`` picks:
   ``upsample_method``; a lossless file is upsampled by replication only,
   libjpeg's fancy upsampling needing DCT blocks) and converts to RGB:
   YCbCr by jdcolor.c's ``ycc_rgb_convert``, RGB as it is, grayscale to
   three equal channels, and CMYK and YCCK (jdcolor.c ``ycck_cmyk_convert``)
   as Pillow does, which inverts the samples (its ``CMYK;I`` unpacking:
   Adobe's convention) and applies its ``cmyk2rgb``.

A progressive file that leaves bits of its first 9 AC coefficients unknown
at its end (an incomplete progression) is smoothed as libjpeg-turbo 3.1
(Pillow 12.1's) smooths it: the host hands each component's known bits
(``Coefficients.smooth``) with the coefficients, and the IDCT kernel's
smoothing instance estimates the unknown low-frequency coefficients of a
copy of each block from the 5x5 stored DCs around it (jdcoefct.c
``decompress_smooth_data``; ``smooth_reference``) before its IDCT.

Damaged entropy-coded data decodes as libjpeg-turbo 3.1 decodes it, with
its warnings (``csrc/jpeg_entropy.cuh``): zeros past a marker met inside a
scan, bad Huffman codes read as 0, runs past a block's or a band's end,
restart markers missing or out of order (``jpeg_resync_to_restart``), bad
arithmetic codes, scans out of progression order; and where the last scan
ran out of data, libjpeg smooths the iMCU rows past it by the bits known
before that scan (``Coefficients.smooth_prev``). Any other file raises and
says why, each where Pillow raises too: libjpeg's errors in the data (a
progressive DC past 32 bits, a bad Huffman table, a reserved or repeated
marker), a file that ends without a marker (Pillow: "image file is
truncated"), lossless arithmetic coding, hierarchical frames, samples of
other than 8 bits, 2 components, sampling factors above 4, a fractional
sampling ratio, an MCU of more than 10 blocks, a lossless file in YCbCr or
YCCK, which libjpeg does not convert; nothing falls back to another decoder.
``frame_hw`` reads an image's size from its frame header in Python, without
decoding anything and without the library. Every launch
adds one to ``LAUNCHES_IDCT`` (and a smoothing one to
``LAUNCHES_IDCT_SMOOTH``) or ``LAUNCHES_COLOR``. Beside each kernel is its
plain version in integer tensor operations (``smooth_reference``,
``idct_islow_reference``, ``color_reference``), which the tests hold
against loop transliterations of libjpeg and Pillow, and ``chip_smoke.py``
holds the kernels against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import _build

LAUNCHES_IDCT = 0         # both instances of the IDCT kernel
LAUNCHES_IDCT_SMOOTH = 0  # the smoothing instance alone
LAUNCHES_COLOR = 0
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CONST_BITS, PASS1_BITS = 13, 2
# jidctint.c's FIX(x) constants at CONST_BITS = 13
FIX = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433, f0_765366865=6270, f0_899976223=7373,
           f1_175875602=9633, f1_501321110=12299, f1_847759065=15137, f1_961570560=16069, f2_053119869=16819,
           f2_562915447=20995, f3_072711026=25172)
MAX_COMPONENTS = 4
SAVED_COEFS = 10  # jdcoefct.c: block smoothing estimates zig-zag places 0 to 9
_HEADER_INTS = 4 + 8 * MAX_COMPONENTS + 1  # the last: 1 for a lossless file
# libjpeg's J_COLOR_SPACE values for the colour space of a file's samples
# (``csrc/jpeg_entropy.cuh`` color_space)
GRAYSCALE, RGB, YCBCR, CMYK, YCCK = 1, 2, 3, 4, 5
# jdsample.c's upsampling methods, by their index in the colour kernel
# (``replicate`` is int_upsample, and h2v1_upsample and h2v2_upsample)
METHODS = ("fullsize", "h2v1", "h1v2", "h2v2", "replicate")


class Component(NamedTuple):
    h: int                 # sampling factors
    v: int
    blocks_w: int          # the stored block grid (the MCU-padded area)
    blocks_h: int
    width: int             # the component's own samples
    height: int
    offset: int            # first coefficient in the flat coefficient array


class Coefficients(NamedTuple):
    """A DCT file, decoded on the host."""
    width: int
    height: int
    components: List[Component]
    coef: np.ndarray       # int16, every component's (blocks_h, blocks_w, 64) blocks, natural order, flat
    quant: np.ndarray      # uint16 (components, 64), natural order
    space: int             # the samples' colour space: GRAYSCALE, RGB, YCBCR, CMYK or YCCK
    # int32 (components, SAVED_COEFS): each component's coef_bits of zig-zag
    # places 0 to 9 (the lowest bit known, -1 none) where libjpeg smooths the
    # file's blocks (a progressive file that leaves bits of them unknown), else None
    smooth: Optional[np.ndarray] = None
    # where the last scan ran out of data: the coef_bits before each
    # component's last scan, as jdcoefct.c smoothing_ok latches them (-1 for
    # a file of one scan), and the last iMCU row an MCU of that scan began
    # with data left (jdmaster.c last_good_iMCU_row); decompress_smooth_data
    # smooths the iMCU rows below it by ``smooth_prev``
    smooth_prev: Optional[np.ndarray] = None
    last_good_row: Optional[int] = None

    def blocks(self) -> List[np.ndarray]:
        """Each component's (blocks_h, blocks_w, 64) coefficients."""
        return [self.coef[k.offset:k.offset + 64 * k.blocks_w * k.blocks_h].reshape(k.blocks_h, k.blocks_w, 64)
                for k in self.components]


class Samples(NamedTuple):
    """A lossless file, decoded on the host: each component's samples at its
    own size (its ``Component``'s blocks_w and blocks_h are its width and
    height, its offset that of its first sample)."""
    width: int
    height: int
    components: List[Component]
    samples: np.ndarray    # uint8, every component's (height, width) samples, flat
    space: int             # GRAYSCALE, RGB or CMYK: libjpeg converts no lossless YCbCr or YCCK


Decoded = Union[Coefficients, Samples]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fix(x: float) -> int:
    """libjpeg's FIX(x) at SCALEBITS: x in 16-bit fixed point, rounded half up."""
    return int(x * (1 << SCALEBITS) + 0.5)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """x as a 16-bit lane holds it: wrapped to -32768..32767."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(v: List[torch.Tensor]) -> List[torch.Tensor]:
    """One pass of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm and
    jidctint-sse2.asm, the same arithmetic) on eight int64 tensors of int16
    values (one a position), before the pass's descale. jidctint.c's
    butterfly with its products regrouped into pairs (pmaddwd: in2 and in6,
    in7 and in1, in5 and in3, z3 and z4, exact in 32 bits); the sums in0 +
    in4, in0 - in4, z3 = in7 + in3 and z4 = in5 + in1 are formed in 16-bit
    lanes (paddw) and wrap. No 32-bit sum here can overflow for int16
    inputs (the largest, out2, stays under 2^31 - 2^17)."""
    f = FIX
    tmp0 = _wrap16(v[0] + v[4]) << CONST_BITS
    tmp1 = _wrap16(v[0] - v[4]) << CONST_BITS
    tmp3 = v[2] * (f["f0_541196100"] + f["f0_765366865"]) + v[6] * f["f0_541196100"]
    tmp2 = v[2] * f["f0_541196100"] + v[6] * (f["f0_541196100"] - f["f1_847759065"])
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(v[7] + v[3]), _wrap16(v[5] + v[1])
    z3, z4 = (z3 * (f["f1_175875602"] - f["f1_961570560"]) + z4 * f["f1_175875602"],
              z3 * f["f1_175875602"] + z4 * (f["f1_175875602"] - f["f0_390180644"]))
    t0 = v[7] * (f["f0_298631336"] - f["f0_899976223"]) - v[1] * f["f0_899976223"] + z3
    t1 = v[5] * (f["f2_053119869"] - f["f2_562915447"]) - v[3] * f["f2_562915447"] + z4
    t2 = v[3] * (f["f3_072711026"] - f["f2_562915447"]) - v[5] * f["f2_562915447"] + z3
    t3 = v[1] * (f["f1_501321110"] - f["f0_899976223"]) - v[7] * f["f0_899976223"] + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """The SIMD IDCT's output stage on the descaled pass-2 values: packed to
    int16 and then to int8 with saturation (packssdw, packsswb), plus 128
    (paddb): x clamped to -128..127, + 128. (jidctint.c's C code indexes a
    table with x & 1023 instead, which wraps far out of range.)"""
    return x.clamp(-128, 127) + 128


def idct_islow_reference(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(N, 64) int16 coefficients (natural order) and (N, 64) or (64,)
    quantization values -> (N, 8, 8) uint8 samples, as libjpeg-turbo's SIMD
    islow IDCT gives them (simd/x86_64/jidctint-avx2.asm; its -sse2.asm twin
    computes the same), which Pillow and the JAX package's native reader run
    on x86-64. Pinned against Pillow 12.1 (libjpeg-turbo 3.1.3) on a CPU with
    AVX2 and AVX-512F by impulse files: DC-only blocks over DC q of -2047 q
    to 2047 q at q 1 to 255, one AC coefficient at each of the 63 places,
    random pairs and triples (``tests/test_torch_jpeg_damage.py``). It
    differs from jidctint.c's C code only out of range:
      * the dequantized product is a 16-bit lane's (pmullw): it wraps;
      * pass 1 runs ``_idct_1d`` along each column and descales by 11 bits
        into int16 with saturation (packssdw);
      * a block whose raw coefficient rows 1 to 7 are all zero (the test is
        on the coefficients, not the products) skips it: each column is
        its dequantized DC shifted left by 2 in a 16-bit lane (psllw), which
        wraps where the full pass saturates;
      * pass 2 runs ``_idct_1d`` along each row of the int16 workspace,
        descales by 18 bits and ends in ``range_limit``'s saturation."""
    c = coef.to(torch.int64)
    x = _wrap16(c * quant.to(torch.int64)).reshape(-1, 8, 8)               # [n, row, column]
    cols = _idct_1d([x[:, k, :] for k in range(8)])                        # pass 1 along each column
    ws = torch.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], 1).clamp(-32768, 32767)
    dc_only = (c.reshape(-1, 8, 8)[:, 1:, :] == 0).flatten(1).all(1)
    ws = torch.where(dc_only[:, None, None], _wrap16(x[:, :1, :] << PASS1_BITS).expand_as(ws), ws)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])                       # pass 2 along each row
    out = torch.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows], 2)
    return range_limit(out).to(torch.uint8)


def _window_weights(sums: dict) -> np.ndarray:
    """(SAVED_COEFS, 25) weights from {place: {DC index 1 to 25: weight}}."""
    out = np.zeros((SAVED_COEFS, 25), np.int64)
    for place, terms in sums.items():
        for j, w in terms.items():
            out[place, j - 1] = w
    return out


# jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): the weights
# of the 5x5 window of stored DCs around a block (rows r - 2 to r + 2, columns
# c - 2 to c + 2, row by row: DC01 to DC25) in the estimate of each zig-zag
# place 0 to 9. SMOOTH_DC_ONLY where no AC scan reached the component (every
# estimate, the DC replaced); SMOOTH_AC otherwise (places 1 to 5 only).
SMOOTH_AC = _window_weights({
    1: {11: -7, 12: 50, 14: -50, 15: 7}, 2: {3: -7, 8: 50, 18: -50, 23: 7},
    3: {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
    4: {2: -1, 4: 1, 6: -1, 7: 10, 9: -10, 10: 1, 16: 1, 17: -10, 19: 10, 20: -1, 22: 1, 24: -1},
    5: {11: -1, 12: 13, 13: -24, 14: 13, 15: -1}})
SMOOTH_DC_ONLY = _window_weights({
    0: {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8, 12: 42, 13: 152, 14: 42,
        15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2},
    1: {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3, 16: -3, 17: 13,
        19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1},
    2: {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13, 18: -38, 19: -13,
        20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1},
    3: {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1},
    4: {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    5: {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2},
    6: {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}, 7: {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    8: {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}, 9: {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1}})
# zig-zag places 0 to 9 in natural order: DC, AC01, AC10, AC20, AC11, AC02, AC03, AC12, AC21, AC30
SMOOTH_NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)


def smooth_window(component: Component, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, 5) and (cols, 5) indices of the 5x5 window of stored blocks
    around each of a component's own ceil(height / 8) x ceil(width / 8)
    blocks, as decompress_smooth_data reads them: columns c - 2 to c + 2 and
    rows r - 2 to r + 1 clamped to the component's own blocks; row r + 2 read
    where it lies in the stored (MCU-padded) grid while r's iMCU row (r // v)
    is not the last, and in the component's own rows where it is; else it is
    row r + 1, clamped."""
    rows, cols = -(-component.height // 8), -(-component.width // 8)
    r = torch.arange(rows, device=device)
    limit = torch.where(r // component.v < component.blocks_h // component.v - 1, component.blocks_h, rows)
    below = (r + 1).clamp(max=rows - 1)
    window_rows = torch.stack([(r - 2).clamp(min=0), (r - 1).clamp(min=0), r, below,
                               torch.where(r + 2 < limit, r + 2, below)], 1)
    window_cols = (torch.arange(cols, device=device)[:, None] + torch.arange(-2, 3, device=device)).clamp(0, cols - 1)
    return window_rows, window_cols


def smooth_reference(blocks: torch.Tensor, quant: torch.Tensor, coef_bits, component: Component,
                     prev_bits=None, last_good_row: Optional[int] = None) -> torch.Tensor:
    """libjpeg's block smoothing (jdcoefct.c decompress_smooth_data) of one
    component: its stored (blocks_h, blocks_w, 64) int16 coefficients
    (natural order), its (64,) quantization values and its coef_bits of
    zig-zag places 0 to 9 -> the smoothed copy, in int64 tensor operations.
    Each of the component's own blocks gets, at zig-zag place k, the
    estimate Q00 sum(w DC) from ``SMOOTH_DC_ONLY`` where no AC scan reached
    the component (coef_bits 1 to 9 all -1; then the DC too, always
    replaced), else from ``SMOOTH_AC``, over the stored DCs of
    ``smooth_window`` (never smoothed ones): the magnitude ((Qk << 7) +
    |num|) // (Qk << 8), clamped to (1 << Al) - 1 where Al = coef_bits[k] >
    0, the sign of num put back, truncated to int16; an AC estimate replaces
    a stored 0 where Al is not 0. The padding blocks are left as they are.
    Rows of blocks in iMCU rows (row // v) past ``last_good_row`` are
    smoothed by ``prev_bits`` instead (``Coefficients.smooth_prev``), where
    both are given."""
    out = _smooth(blocks, quant, coef_bits, component)
    if prev_bits is None or last_good_row is None:
        return out
    rows = -(-component.height // 8)
    stale = torch.arange(rows, device=blocks.device) // component.v > last_good_row
    if bool(stale.any()):
        out[:rows][stale] = _smooth(blocks, quant, prev_bits, component)[:rows][stale]
    return out


def _smooth(blocks: torch.Tensor, quant: torch.Tensor, coef_bits, component: Component) -> torch.Tensor:
    """``smooth_reference`` by one set of coef_bits."""
    dev = blocks.device
    rows_i, cols_i = smooth_window(component, dev)
    rows, cols = len(rows_i), len(cols_i)
    bits = torch.from_numpy(np.asarray(coef_bits, np.int64)).to(dev)
    dc_only = bool((np.asarray(coef_bits)[1:] == -1).all())
    weights = torch.from_numpy(SMOOTH_DC_ONLY if dc_only else SMOOTH_AC).to(dev)
    places = torch.tensor(SMOOTH_NATURAL, device=dev)
    q = quant.to(torch.int64)[places]
    dc = blocks[..., 0].to(torch.int64)
    window = dc[rows_i[:, None, :, None], cols_i[None, :, None, :]].reshape(rows, cols, 1, 25)
    num = (window * weights).sum(-1) * q[0]                                  # (rows, cols, 10)
    mag = torch.div((q << 7) + num.abs(), q << 8, rounding_mode="floor")
    clamped = (bits > 0) & (places != 0)  # an AC estimate's; the DC is not clamped
    mag = torch.where(clamped, torch.minimum(mag, (1 << bits.clamp(min=0)) - 1), mag)
    est = torch.where(num < 0, -mag, mag)
    est = ((est + 32768) & 0xFFFF) - 32768                                   # (JCOEF) pred
    stored = blocks[:rows, :cols][..., places].to(torch.int64)
    apply = (weights != 0).any(1) & (bits != 0) & (stored == 0)
    if dc_only:
        apply[..., 0] = True
    out = blocks.clone()
    out[:rows, :cols, places] = torch.where(apply, est, stored).to(blocks.dtype)
    return out


def planes_reference(c: Decoded) -> List[torch.Tensor]:
    """Each component's plane, (height, width) uint8, from the plain IDCT
    (a lossless file: its samples), each component's blocks through
    ``smooth_reference`` first where ``c.smooth`` is set."""
    if isinstance(c, Samples):
        return [torch.from_numpy(p.copy()) for p in sample_planes(c)]
    out = []
    for k, (comp, blocks) in enumerate(zip(c.components, c.blocks())):
        quant = torch.from_numpy(c.quant[k].astype(np.int64))
        blocks = torch.from_numpy(blocks)
        if c.smooth is not None:
            prev = None if c.smooth_prev is None else c.smooth_prev[k]
            blocks = smooth_reference(blocks, quant, c.smooth[k], comp, prev, c.last_good_row)
        n = comp.blocks_w * comp.blocks_h
        px = idct_islow_reference(blocks.reshape(n, 64), quant)
        plane = px.reshape(comp.blocks_h, comp.blocks_w, 8, 8).permute(0, 2, 1, 3)
        out.append(plane.reshape(comp.blocks_h * 8, comp.blocks_w * 8)[:comp.height, :comp.width].contiguous())
    return out


def sample_planes(c: Samples) -> List[np.ndarray]:
    """Each component's (height, width) samples of a lossless file."""
    return [c.samples[k.offset:k.offset + k.width * k.height].reshape(k.height, k.width) for k in c.components]


def upsampling(c: Decoded) -> List[Tuple[int, int]]:
    """(h_expand, v_expand) of each component: the largest sampling factors
    over its own. A ratio that is not an integer raises, as libjpeg does
    (jdsample.c JERR_FRACT_SAMPLE_NOTIMPL)."""
    hmax, vmax = max(k.h for k in c.components), max(k.v for k in c.components)
    if any(hmax % k.h or vmax % k.v for k in c.components):
        raise ValueError(f"a fractional sampling ratio ({[(k.h, k.v) for k in c.components]}; jdsample.c "
                         f"JERR_FRACT_SAMPLE_NOTIMPL)")
    return [(hmax // k.h, vmax // k.v) for k in c.components]


def fancy_upsampling(c: Decoded) -> bool:
    """Whether libjpeg upsamples ``c``'s planes by its fancy filters:
    jdsample.c's ``do_fancy`` wants DCT blocks (``min_DCT_scaled_size`` above
    1), so a lossless file's planes are replicated."""
    return not isinstance(c, Samples)


def upsample_method(hexp: int, vexp: int, width: int, fancy: bool = True) -> str:
    """The method jdsample.c ``jinit_upsampler`` picks for a plane ``width``
    samples wide expanded by (hexp, vexp): with fancy upsampling, h1v2
    fancy, and h2v1 and h2v2 fancy only for planes wider than 2;
    replication otherwise and for every other ratio."""
    if (hexp, vexp) == (1, 1):
        return "fullsize"
    if not fancy:
        return "replicate"
    if (hexp, vexp) == (1, 2):
        return "h1v2"
    if (hexp, vexp) in ((2, 1), (2, 2)) and width > 2:
        return "h2v1" if vexp == 1 else "h2v2"
    return "replicate"


def _clamped(n: int, shift: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) + shift).clamp(0, n - 1)


def upsample_reference(c: torch.Tensor, hexp: int, vexp: int, fancy: bool = True) -> torch.Tensor:
    """libjpeg's upsampling of one plane by (hexp, vexp), int32 (vexp ch,
    hexp cw), by ``upsample_method``'s pick: jdsample.c
    ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``, ``h2v2_fancy_upsample``
    (edge rows and columns repeated) or ``int_upsample``."""
    method = upsample_method(hexp, vexp, c.shape[1], fancy)
    c = c.to(torch.int32)
    if method == "fullsize":
        return c
    if method == "replicate":
        return c.repeat_interleave(vexp, 0).repeat_interleave(hexp, 1)
    ch, cw = c.shape
    if vexp == 2:
        # column sums of the nearer row (x3) and the next-nearer one: the row
        # above for an even output row, the row below for an odd one
        rows = torch.stack([3 * c + c[_clamped(ch, -1, c.device)], 3 * c + c[_clamped(ch, 1, c.device)]], 1)
        s = rows.reshape(2 * ch, cw)
        if method == "h1v2":
            bias = torch.tensor([1, 2], dtype=torch.int32, device=c.device).repeat(ch).unsqueeze(1)
            return (s + bias) >> 2
        bias_even, bias_odd, shift = 8, 7, 4
    else:
        s, bias_even, bias_odd, shift = c, 1, 2, 2
    left, right = s[:, _clamped(cw, -1, c.device)], s[:, _clamped(cw, 1, c.device)]
    even = (3 * s + left + bias_even) >> shift
    odd = (3 * s + right + bias_odd) >> shift
    return torch.stack([even, odd], -1).reshape(s.shape[0], 2 * cw)


def ycc_to_rgb_reference(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c's ``ycc_rgb_convert`` on full-size planes, in int32 with
    its tables' arithmetic: (H, W, 3) uint8."""
    luma = y.to(torch.int32)
    b, r = cb.to(torch.int32) - 128, cr.to(torch.int32) - 128
    red = luma + ((_fix(1.40200) * r + ONE_HALF) >> SCALEBITS)
    green = luma + ((-_fix(0.34414) * b + ONE_HALF + -_fix(0.71414) * r) >> SCALEBITS)
    blue = luma + ((_fix(1.77200) * b + ONE_HALF) >> SCALEBITS)
    return torch.stack([red, green, blue], -1).clamp(0, 255).to(torch.uint8)


def cmyk_to_rgb_reference(cmyk: torch.Tensor) -> torch.Tensor:
    """Pillow's RGB of libjpeg's CMYK output, (H, W, 4) -> (H, W, 3) uint8:
    its ``CMYK;I`` unpacking inverts every sample (Adobe's convention), then
    ``cmyk2rgb`` (Convert.c) gives nk - MULDIV255(c, nk) with nk = 255 - k,
    MULDIV255(a, b) = (((a b + 128) >> 8) + a b + 128) >> 8."""
    inv = 255 - cmyk.to(torch.int32)
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).clamp(0, 255).to(torch.uint8)


def convert_reference(planes: List[torch.Tensor], space: int) -> torch.Tensor:
    """The colour step on full-size planes (one a component): (H, W, 3) uint8
    RGB as Pillow's ``convert("RGB")`` gives it from libjpeg's output."""
    if space == GRAYSCALE:
        return planes[0].to(torch.uint8).unsqueeze(-1).expand(*planes[0].shape, 3).contiguous()
    if space == RGB:  # jdcolor.c rgb_rgb_convert
        return torch.stack(planes, -1).to(torch.uint8)
    if space == YCBCR:
        return ycc_to_rgb_reference(*planes)
    if space == CMYK:
        return cmyk_to_rgb_reference(torch.stack(planes, -1))
    if space == YCCK:  # jdcolor.c ycck_cmyk_convert: 255 minus each YCbCr -> RGB value, K as it is
        cmy = 255 - ycc_to_rgb_reference(*planes[:3]).to(torch.int32)
        return cmyk_to_rgb_reference(torch.cat([cmy, planes[3].to(torch.int32).unsqueeze(-1)], -1))
    raise ValueError(f"unknown colour space {space}")


def color_reference(planes: List[torch.Tensor], c: Decoded) -> torch.Tensor:
    """The plain version of the colour kernel: each component's plane (its
    own (height, width)) through ``upsample_reference`` by ``upsampling(c)``
    (fancy or not by ``fancy_upsampling(c)``), cropped to the image, then
    ``convert_reference`` in ``c.space``."""
    fancy = fancy_upsampling(c)
    full = [upsample_reference(p, hexp, vexp, fancy)[:c.height, :c.width]
            for p, (hexp, vexp) in zip(planes, upsampling(c))]
    return convert_reference(full, c.space)


def decode_reference(c: Decoded) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on the CPU from a file decoded on the host
    (coefficients or lossless samples): the plain versions of the kernels."""
    return color_reference(planes_reference(c), c)


# ---------------------------------------------------------------------------
# the frame header alone
# ---------------------------------------------------------------------------

# baseline, extended sequential, progressive and lossless Huffman frames, and
# sequential and progressive arithmetic-coded ones
SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
SOF_OTHER = (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF)  # hierarchical frames, lossless arithmetic-coded ones


def frame_hw(f) -> Tuple[int, int]:
    """(height, width) from the SOF0, SOF1, SOF2, SOF3, SOF9 or SOF10
    segment of the JPEG file open in binary ``f``, walking the markers from
    SOI and seeking past every other segment. Another file, another frame
    type or a scan before the frame header raises ``ValueError``."""
    if f.read(2) != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    while True:
        b = f.read(1)
        if b != b"\xff":
            raise ValueError("no frame header before the end of the file" if not b else "a marker was expected")
        m = f.read(1)
        while m == b"\xff":  # fill bytes
            m = f.read(1)
        if not m:
            raise ValueError("no frame header before the end of the file")
        m = m[0]
        if m == 0x01 or 0xD0 <= m <= 0xD8:  # segments without a length
            continue
        if m in (0xD9, 0xDA):
            raise ValueError("no frame header before the first scan")
        if m in SOF_OTHER:
            raise ValueError(f"SOF{m - 0xC0} frames are not read (SOF0 to SOF3, SOF9 and SOF10 only)")
        n = int.from_bytes(f.read(2), "big")
        if m in SOF_READ:
            body = f.read(5)
            if len(body) < 5:
                raise ValueError("a truncated frame header")
            return int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big")
        if n < 2:
            raise ValueError(f"segment 0xFF{m:02X} has length {n}")
        f.seek(n - 2, 1)


# ---------------------------------------------------------------------------
# the host decoder and the kernels
# ---------------------------------------------------------------------------

def declare_host(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the host decoder's entry points (``csrc/jpeg_entropy.cuh``)
    on a loaded library: the card's, or a host compiler's build of the
    header alone."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.threedod_jpeg_header.argtypes = [p, i64, p]
    lib.threedod_jpeg_header.restype = i
    lib.threedod_jpeg_coefficients.argtypes = [p, i64, p, i64, p, p]
    lib.threedod_jpeg_coefficients.restype = i
    lib.threedod_jpeg_samples.argtypes = [p, i64, p, i64]
    lib.threedod_jpeg_samples.restype = i
    lib.threedod_jpeg_error.argtypes = []
    lib.threedod_jpeg_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = declare_host(_build.library("jpeg_decode", "threedod_jpeg_color", [p, p, i, i, p, i, i, p]))
    lib.threedod_jpeg_idct.argtypes = [p, p, i, p, p, p, p]
    lib.threedod_jpeg_idct.restype = i
    return lib


def _header(data: bytes, lib: ctypes.CDLL) -> Tuple[int, int, List[Component], int, bool]:
    """(width, height, components, colour space, lossless) from the host
    decoder's ``threedod_jpeg_header``."""
    header = np.zeros(_HEADER_INTS, np.int64)
    if lib.threedod_jpeg_header(data, len(data), header.ctypes.data):
        raise ValueError(lib.threedod_jpeg_error().decode())
    width, height, n, space = (int(v) for v in header[:4])
    comps = [Component(*(int(v) for v in header[4 + 8 * k:4 + 8 * k + 7])) for k in range(n)]
    return width, height, comps, space, bool(header[-1])


def decode_coefficients(data: bytes, lib: Optional[ctypes.CDLL] = None) -> Coefficients:
    """A DCT file's quantized DCT coefficients and quantization tables,
    decoded on the host by ``csrc/jpeg_entropy.cuh`` (the card's library, or
    ``lib`` where given: a build with ``declare_host``); a file outside the
    decoded subset, or a lossless one, raises ``ValueError`` with the
    decoder's reason."""
    lib = _lib() if lib is None else lib
    width, height, comps, space, _ = _header(data, lib)
    total = comps[-1].offset + 64 * comps[-1].blocks_w * comps[-1].blocks_h
    coef = np.zeros(total, np.int16)
    quant = np.zeros((len(comps), 64), np.uint16)
    # would_smooth, the last good iMCU row, each component's coef_bits, then those before its last scan
    bits = np.zeros(2 + 2 * SAVED_COEFS * len(comps), np.int32)
    if lib.threedod_jpeg_coefficients(data, len(data), coef.ctypes.data, total, quant.ctypes.data, bits.ctypes.data):
        raise ValueError(lib.threedod_jpeg_error().decode())
    if not bits[0]:
        return Coefficients(width, height, comps, coef, quant, space)
    latest, prev = bits[2:].reshape(2, len(comps), SAVED_COEFS)
    if int(bits[1]) >= max((-(-k.height // 8) - 1) // k.v for k in comps):  # no iMCU row past it
        return Coefficients(width, height, comps, coef, quant, space, latest)
    return Coefficients(width, height, comps, coef, quant, space, latest, prev, int(bits[1]))


def decode_samples(data: bytes, lib: Optional[ctypes.CDLL] = None) -> Samples:
    """A lossless file's samples, decoded on the host by
    ``csrc/jpeg_entropy.cuh`` (``lib`` as ``decode_coefficients``'s); a file
    outside the decoded subset, or a DCT one, raises ``ValueError`` with the
    decoder's reason."""
    lib = _lib() if lib is None else lib
    width, height, comps, space, _ = _header(data, lib)
    samples = np.zeros(comps[-1].offset + comps[-1].width * comps[-1].height, np.uint8)
    if lib.threedod_jpeg_samples(data, len(data), samples.ctypes.data, len(samples)):
        raise ValueError(lib.threedod_jpeg_error().decode())
    return Samples(width, height, comps, samples, space)


def decode_host(data: bytes, lib: Optional[ctypes.CDLL] = None) -> Decoded:
    """The host's half of the decode of any file the decoder takes: a DCT
    file's ``Coefficients`` or a lossless file's ``Samples``."""
    lib = _lib() if lib is None else lib
    return decode_samples(data, lib) if _header(data, lib)[4] else decode_coefficients(data, lib)


def idct_cuda(c: Coefficients, device: torch.device) -> List[torch.Tensor]:
    """The IDCT kernel: each component's plane on ``device``, uint8 of the
    stored block grid's size (blocks_h 8, blocks_w 8); the component's own
    samples are its top-left (height, width). Its smoothing instance runs
    where ``c.smooth`` is set (``smooth_reference`` before the IDCT), the
    plain one elsewhere."""
    global LAUNCHES_IDCT, LAUNCHES_IDCT_SMOOTH
    if torch.device(device).type != "cuda":
        raise ValueError(f"the IDCT kernel runs on a CUDA device, not on {device}")
    coef = torch.from_numpy(c.coef).to(device)
    quant = torch.from_numpy(c.quant.astype(np.int32)).to(device)
    planes = [torch.empty((comp.blocks_h * 8, comp.blocks_w * 8), dtype=torch.uint8, device=device)
              for comp in c.components]
    table = np.zeros((MAX_COMPONENTS, 4), np.int64)  # offset in blocks, blocks_w, blocks_h, plane pitch
    ptrs = (ctypes.c_void_p * MAX_COMPONENTS)()
    for k, (comp, plane) in enumerate(zip(c.components, planes)):
        table[k] = (comp.offset // 64, comp.blocks_w, comp.blocks_h, plane.stride(0))
        ptrs[k] = plane.data_ptr()
    # per component: own rows and columns of blocks, v, DC-only, coef_bits of
    # places 0 to 9, the last good iMCU row, and DC-only and coef_bits past it
    smooth = None
    if c.smooth is not None:
        smooth = np.zeros((MAX_COMPONENTS, 6 + 2 * SAVED_COEFS), np.int64)
        prev = c.smooth if c.smooth_prev is None else c.smooth_prev
        last_good = (1 << 30) if c.last_good_row is None else c.last_good_row
        for k, (comp, bits, old) in enumerate(zip(c.components, c.smooth, prev)):
            smooth[k] = (-(-comp.height // 8), -(-comp.width // 8), comp.v, int((bits[1:] == -1).all()), *bits,
                         last_good, int((old[1:] == -1).all()), *old)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check_launch(lib, "JPEG IDCT", lib.threedod_jpeg_idct(
        coef.data_ptr(), quant.data_ptr(), len(planes), table.ctypes.data, ctypes.addressof(ptrs),
        None if smooth is None else smooth.ctypes.data, stream))
    LAUNCHES_IDCT += 1
    LAUNCHES_IDCT_SMOOTH += smooth is not None
    return planes


def _plane_ok(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{what} must be a 2-D uint8 plane with unit column stride, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def color_cuda(planes: List[torch.Tensor], c: Decoded) -> torch.Tensor:
    """The colour kernel on each component's CUDA plane, of its own (height,
    width) (views into padded planes are fine: each plane's row stride is
    passed), laid out and in the colour space as ``c`` says; (H, W, 3) uint8
    on the same card."""
    global LAUNCHES_COLOR
    if not planes[0].is_cuda:
        raise ValueError(f"the colour kernel runs on a CUDA device, not on {planes[0].device}")
    if len(planes) != len(c.components):
        raise ValueError(f"{len(planes)} planes for {len(c.components)} components")
    table = np.zeros((MAX_COMPONENTS, 6), np.int64)  # pitch, width, height, h_expand, v_expand, method
    ptrs = (ctypes.c_void_p * MAX_COMPONENTS)()
    fancy = fancy_upsampling(c)
    for k, (t, comp, (hexp, vexp)) in enumerate(zip(planes, c.components, upsampling(c))):
        _plane_ok(t, f"plane {k}")
        if t.device != planes[0].device or tuple(t.shape) != (comp.height, comp.width):
            raise ValueError(f"plane {k} must be ({comp.height}, {comp.width}) on {planes[0].device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        table[k] = (t.stride(0), comp.width, comp.height, hexp, vexp,
                    METHODS.index(upsample_method(hexp, vexp, comp.width, fancy)))
        ptrs[k] = t.data_ptr()
    out = torch.empty((c.height, c.width, 3), dtype=torch.uint8, device=planes[0].device)
    lib = _lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check_launch(lib, "JPEG colour", lib.threedod_jpeg_color(
        table.ctypes.data, ctypes.addressof(ptrs), len(planes), c.space, out.data_ptr(), c.height, c.width, stream))
    LAUNCHES_COLOR += 1
    return out


def planes_cuda(c: Decoded, device: torch.device) -> List[torch.Tensor]:
    """Each component's (height, width) plane on the card: views of the
    IDCT kernel's padded planes, or of a lossless file's samples copied to
    the card (no kernel)."""
    if isinstance(c, Samples):
        if torch.device(device).type != "cuda":
            raise ValueError(f"the card's planes are on a CUDA device, not on {device}")
        flat = torch.from_numpy(c.samples).to(device)
        return [flat[k.offset:k.offset + k.width * k.height].view(k.height, k.width) for k in c.components]
    return [p[:comp.height, :comp.width] for p, comp in zip(idct_cuda(c, device), c.components)]


def decode_jpeg(data: bytes, device: torch.device) -> torch.Tensor:
    """A JPEG's bytes -> (H, W, 3) uint8 RGB on the CUDA ``device``, Pillow's
    ``convert("RGB")`` pixels; raises ``ValueError`` for a file the decoder
    does not take."""
    c = decode_host(data)
    return color_cuda(planes_cuda(c, device), c)
