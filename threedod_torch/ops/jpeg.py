"""The card's JPEG decoder, bit-equal to libjpeg(-turbo) with its defaults
(islow IDCT, "fancy" upsampling), as Pillow and the JAX package's native
loader decode.

``decode_jpeg(data, device)`` takes a sequential or progressive JPEG's bytes
(8-bit samples, Huffman coding, 1 or 3 components, 4:4:4, 4:2:2 or 4:2:0)
and returns (H, W, 3) uint8 RGB on the CUDA ``device``:

1. on the host, ``csrc/jpeg_entropy.cuh`` reads the markers and decodes the
   Huffman-coded data of every scan into each component's quantized DCT
   coefficients (``decode_coefficients``; a progressive file's DC and AC
   bands and their refinements, libjpeg's jdphuff.c);
2. on the card, ``csrc/jpeg_decode.cu``'s IDCT kernel dequantizes and runs
   libjpeg's ``jpeg_idct_islow`` (jidctint.c: integer, 13 fraction bits, 2
   more bits between the passes, the range limit of ``prepare_range_limit_table``)
   into each component's plane;
3. its colour kernel upsamples the chroma (jdsample.c ``h2v1`` / ``h2v2``
   ``_fancy_upsample``) and converts to RGB (jdcolor.c ``ycc_rgb_convert``).

Any other file raises and says why (arithmetic coding, lossless frames,
12-bit samples, CMYK, other samplings, and a progressive file whose first 9
AC coefficients are never fully sent: libjpeg smooths those blocks, which
is not reproduced); nothing falls back to another decoder.
``frame_hw`` reads an image's size from its frame header in Python, without
decoding anything and without the library.
Every launch adds one to ``LAUNCHES_IDCT`` or ``LAUNCHES_COLOR``. Beside each
kernel is its plain version in integer tensor operations
(``idct_islow_reference``, ``ycc_to_rgb_reference``), which the tests hold
against loop transliterations of libjpeg and ``chip_smoke.py`` holds the
kernels against on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

LAUNCHES_IDCT = 0
LAUNCHES_COLOR = 0
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CONST_BITS, PASS1_BITS = 13, 2
# jidctint.c's FIX(x) constants at CONST_BITS = 13
FIX = dict(f0_298631336=2446, f0_390180644=3196, f0_541196100=4433, f0_765366865=6270, f0_899976223=7373,
           f1_175875602=9633, f1_501321110=12299, f1_847759065=15137, f1_961570560=16069, f2_053119869=16819,
           f2_562915447=20995, f3_072711026=25172)
MAX_COMPONENTS = 3
_HEADER_INTS = 3 + 8 * MAX_COMPONENTS


class Component(NamedTuple):
    h: int                 # sampling factors
    v: int
    blocks_w: int          # the stored block grid (the MCU-padded area)
    blocks_h: int
    width: int             # the component's own samples
    height: int
    offset: int            # first coefficient in the flat coefficient array


class Coefficients(NamedTuple):
    width: int
    height: int
    components: List[Component]
    coef: np.ndarray       # int16, every component's (blocks_h, blocks_w, 64) blocks, natural order, flat
    quant: np.ndarray      # uint16 (components, 64), natural order


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fix(x: float) -> int:
    """libjpeg's FIX(x) at SCALEBITS: x in 16-bit fixed point, rounded half up."""
    return int(x * (1 << SCALEBITS) + 0.5)


def _idct_1d(v: List[torch.Tensor]) -> List[torch.Tensor]:
    """One pass of jpeg_idct_islow on eight int64 tensors (one a position),
    before the pass's descale."""
    f = FIX
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * f["f0_541196100"]
    tmp2 = z1 + z3 * -f["f1_847759065"]
    tmp3 = z1 + z2 * f["f0_765366865"]
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1_175875602"]
    t0, t1 = t0 * f["f0_298631336"], t1 * f["f2_053119869"]
    t2, t3 = t2 * f["f3_072711026"], t3 * f["f1_501321110"]
    z1, z2 = z1 * -f["f0_899976223"], z2 * -f["f2_562915447"]
    z3, z4 = z3 * -f["f1_961570560"] + z5, z4 * -f["f0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range limit, indexed with x & 1023: x + 128 for
    0..127, 255 for 128..511, 0 for 512..895, x - 896 for 896..1023."""
    i = x & 1023
    return torch.where(i < 128, i + 128, torch.where(i < 512, 255, torch.where(i < 896, 0, i - 896)))


def idct_islow_reference(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(N, 64) int16 coefficients (natural order) and (N, 64) or (64,)
    quantization values -> (N, 8, 8) uint8 samples, jpeg_idct_islow's. The
    all-zero-AC shortcuts of the C code give the same values as the full
    butterfly, so there are none here."""
    x = (coef.to(torch.int64) * quant.to(torch.int64)).reshape(-1, 8, 8)  # [n, row, column]
    cols = _idct_1d([x[:, k, :] for k in range(8)])                       # pass 1 along each column
    ws = torch.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], 1)  # [n, row, column]
    rows = _idct_1d([ws[:, :, k] for k in range(8)])                       # pass 2 along each row
    out = torch.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows], 2)
    return range_limit(out).to(torch.uint8)


def planes_reference(c: Coefficients) -> List[torch.Tensor]:
    """Each component's plane, (height, width) uint8, from the plain IDCT."""
    out = []
    coef = torch.from_numpy(c.coef)
    for k, comp in enumerate(c.components):
        n = comp.blocks_w * comp.blocks_h
        blocks = idct_islow_reference(coef[comp.offset:comp.offset + 64 * n].reshape(n, 64),
                                      torch.from_numpy(c.quant[k].astype(np.int64)))
        plane = blocks.reshape(comp.blocks_h, comp.blocks_w, 8, 8).permute(0, 2, 1, 3)
        out.append(plane.reshape(comp.blocks_h * 8, comp.blocks_w * 8)[:comp.height, :comp.width].contiguous())
    return out


def sampling(y_shape, c_shape) -> Tuple[int, int]:
    """(hf, vf): how many luma columns and rows a chroma sample covers, read
    from the planes' sizes; raises for any sampling but 4:4:4, 4:2:2, 4:2:0."""
    (h, w), (ch, cw) = y_shape, c_shape
    for hf, vf in ((1, 1), (2, 1), (2, 2)):
        if cw == -(-w // hf) and ch == -(-h // vf):
            if hf == 2 and cw <= 2:
                break  # libjpeg upsamples planes this narrow by replication
            return hf, vf
    raise ValueError(f"chroma planes of {ch}x{cw} under a {h}x{w} luma plane: only 4:4:4, 4:2:2 and 4:2:0 "
                     f"with chroma wider than 2 columns are decoded")


def _clamped(n: int, shift: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) + shift).clamp(0, n - 1)


def upsample_reference(c: torch.Tensor, hf: int, vf: int) -> torch.Tensor:
    """libjpeg's fancy upsampling of one chroma plane (jdsample.c
    ``h2v1_fancy_upsample``, ``h2v2_fancy_upsample``), int32 (vf ch, hf cw)."""
    c = c.to(torch.int32)
    if hf == 1:
        return c
    ch, cw = c.shape
    if vf == 2:
        # column sums of the nearer row (x3) and the next-nearer one: the row
        # above for an even output row, the row below for an odd one
        rows = torch.stack([3 * c + c[_clamped(ch, -1, c.device)], 3 * c + c[_clamped(ch, 1, c.device)]], 1)
        s = rows.reshape(2 * ch, cw)
        bias_even, bias_odd, shift = 8, 7, 4
    else:
        s, bias_even, bias_odd, shift = c, 1, 2, 2
    left, right = s[:, _clamped(cw, -1, c.device)], s[:, _clamped(cw, 1, c.device)]
    even = (3 * s + left + bias_even) >> shift
    odd = (3 * s + right + bias_odd) >> shift
    return torch.stack([even, odd], -1).reshape(s.shape[0], 2 * cw)


def ycc_to_rgb_reference(y: torch.Tensor, cb: Optional[torch.Tensor], cr: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of the colour kernel: ``upsample_reference`` then
    jdcolor.c's ``ycc_rgb_convert`` in int32, cropped to the luma plane's
    size; a grayscale plane (``cb`` and ``cr`` None) to three equal channels."""
    h, w = y.shape
    if cb is None:
        return y.unsqueeze(-1).expand(h, w, 3).contiguous()
    hf, vf = sampling((h, w), tuple(cb.shape))
    luma = y.to(torch.int32)
    b = upsample_reference(cb, hf, vf)[:h, :w] - 128
    r = upsample_reference(cr, hf, vf)[:h, :w] - 128
    red = luma + ((_fix(1.40200) * r + ONE_HALF) >> SCALEBITS)
    green = luma + ((-_fix(0.34414) * b + ONE_HALF + -_fix(0.71414) * r) >> SCALEBITS)
    blue = luma + ((_fix(1.77200) * b + ONE_HALF) >> SCALEBITS)
    return torch.stack([red, green, blue], -1).clamp(0, 255).to(torch.uint8)


def decode_reference(c: Coefficients) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on the CPU from decoded coefficients: the plain
    versions of both kernels."""
    planes = planes_reference(c)
    return ycc_to_rgb_reference(planes[0], *(planes[1:] if len(planes) == 3 else (None, None)))


# ---------------------------------------------------------------------------
# the frame header alone
# ---------------------------------------------------------------------------

SOF_READ = (0xC0, 0xC1, 0xC2)  # baseline, extended sequential, progressive Huffman frames
SOF_OTHER = (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)


def frame_hw(f) -> Tuple[int, int]:
    """(height, width) from the SOF0, SOF1 or SOF2 segment of the JPEG file
    open in binary ``f``, walking the markers from SOI and seeking past every
    other segment. Another file, another frame type or a scan before the
    frame header raises ``ValueError``."""
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
            raise ValueError(f"SOF{m - 0xC0} frames are not read (SOF0, SOF1 and SOF2 only)")
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
    lib.threedod_jpeg_coefficients.argtypes = [p, i64, p, i64, p]
    lib.threedod_jpeg_coefficients.restype = i
    lib.threedod_jpeg_error.argtypes = []
    lib.threedod_jpeg_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = declare_host(_build.library("jpeg_decode", "threedod_jpeg_ycc_rgb", [p, i, p, p, i, i, i, i, i, p, i, i, p]))
    lib.threedod_jpeg_idct.argtypes = [p, p, i, p, p, p]
    lib.threedod_jpeg_idct.restype = i
    return lib


def decode_coefficients(data: bytes, lib: Optional[ctypes.CDLL] = None) -> Coefficients:
    """The file's quantized DCT coefficients and quantization tables, decoded
    on the host by ``csrc/jpeg_entropy.cuh`` (the card's library, or ``lib``
    where given: a build with ``declare_host``); a file outside the decoded
    subset raises ``ValueError`` with the decoder's reason."""
    lib = _lib() if lib is None else lib
    header = np.zeros(_HEADER_INTS, np.int64)
    if lib.threedod_jpeg_header(data, len(data), header.ctypes.data):
        raise ValueError(lib.threedod_jpeg_error().decode())
    width, height, n = (int(v) for v in header[:3])
    comps = [Component(*(int(v) for v in header[3 + 8 * k:3 + 8 * k + 7])) for k in range(n)]
    total = comps[-1].offset + 64 * comps[-1].blocks_w * comps[-1].blocks_h
    coef = np.zeros(total, np.int16)
    quant = np.zeros((n, 64), np.uint16)
    if lib.threedod_jpeg_coefficients(data, len(data), coef.ctypes.data, total, quant.ctypes.data):
        raise ValueError(lib.threedod_jpeg_error().decode())
    return Coefficients(width, height, comps, coef, quant)


def idct_cuda(c: Coefficients, device: torch.device) -> List[torch.Tensor]:
    """The IDCT kernel: each component's plane on ``device``, uint8 of the
    stored block grid's size (blocks_h 8, blocks_w 8); the component's own
    samples are its top-left (height, width)."""
    global LAUNCHES_IDCT
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
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check_launch(lib, "JPEG IDCT", lib.threedod_jpeg_idct(
        coef.data_ptr(), quant.data_ptr(), len(planes), table.ctypes.data, ctypes.addressof(ptrs), stream))
    LAUNCHES_IDCT += 1
    return planes


def _plane_ok(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{what} must be a 2-D uint8 plane with unit column stride, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def ycc_to_rgb_cuda(y: torch.Tensor, cb: Optional[torch.Tensor], cr: Optional[torch.Tensor]) -> torch.Tensor:
    """The colour kernel on CUDA planes (views into padded planes are fine:
    each plane's row stride is passed); (H, W, 3) uint8 on the same card."""
    global LAUNCHES_COLOR
    if not y.is_cuda:
        raise ValueError(f"the colour kernel runs on a CUDA device, not on {y.device}")
    _plane_ok(y, "y")
    h, w = y.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    cb_ptr = cr_ptr = None
    c_pitch = cw = ch = 0
    hf = vf = 1
    if cb is not None:
        for t, what in ((cb, "cb"), (cr, "cr")):
            _plane_ok(t, what)
            if t.device != y.device or tuple(t.shape) != tuple(cb.shape) or t.stride(0) != cb.stride(0):
                raise ValueError("cb and cr must be planes of one size and pitch on y's card")
        hf, vf = sampling((h, w), tuple(cb.shape))
        cb_ptr, cr_ptr, c_pitch = cb.data_ptr(), cr.data_ptr(), cb.stride(0)
        ch, cw = cb.shape
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _build.check_launch(lib, "JPEG colour", lib.threedod_jpeg_ycc_rgb(
        y.data_ptr(), y.stride(0), cb_ptr, cr_ptr, c_pitch, cw, ch, hf, vf, out.data_ptr(), h, w, stream))
    LAUNCHES_COLOR += 1
    return out


def planes_cuda(c: Coefficients, device: torch.device) -> List[torch.Tensor]:
    """Each component's (height, width) plane on the card (views of the
    IDCT kernel's padded planes)."""
    return [p[:comp.height, :comp.width] for p, comp in zip(idct_cuda(c, device), c.components)]


def decode_jpeg(data: bytes, device: torch.device) -> torch.Tensor:
    """A sequential or progressive JPEG's bytes -> (H, W, 3) uint8 RGB on the CUDA
    ``device``, libjpeg's pixels; raises ``ValueError`` for a file the
    decoder does not take."""
    planes = planes_cuda(decode_coefficients(data), device)
    return ycc_to_rgb_cuda(*planes) if len(planes) == 3 else ycc_to_rgb_cuda(planes[0], None, None)
