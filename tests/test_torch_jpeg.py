"""The plain versions of the card's JPEG decoder (``threedod_torch/ops/
jpeg.py``) against loop transliterations of libjpeg(-turbo)'s C code, and the
whole plain chain against Pillow (libjpeg) on fixture JPEGs.

* ``idct_islow_reference`` vs libjpeg-turbo's SIMD islow IDCT
  (``jsimd_idct_islow_avx2``, jidctint-avx2.asm: its 16-bit products and
  sums, its block-wide all-zero-AC shortcut, the saturating packs of each
  pass and the output), which Pillow runs, on random blocks and quantization
  tables, sparse as real files are and dense enough to saturate and wrap;
* ``upsample_reference`` vs ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``,
  ``h2v2_fancy_upsample`` (jdsample.c, with jdmainct.c's repeated edge rows)
  and ``int_upsample`` on random planes of odd and even sizes, every edge
  column and row included;
* the colour step vs ``ycc_rgb_convert`` (jdcolor.c's tables) after each
  upsampling, and a grayscale plane to three equal channels;
  ``upsample_method`` picks replication for planes 2 columns wide or less,
  and a fractional sampling ratio raises;
* a baseline JPEG's Huffman data decoded here in Python (a loop over the
  bits, the test's own), then the plain IDCT, upsampling and colour: equal to
  Pillow's RGB on fixture JPEGs and on files Pillow writes with other
  samplings, restart markers and odd sizes.
The card's kernels and the host decoder in ``csrc/`` are held against these
plain versions by the ``gpu`` test here and by ``chip_smoke.py``.

``data/image_io.image_hw`` reads the frame header (``jpeg.frame_hw``): the
size equals Pillow's on all 88 fixture JPEGs and on files Pillow writes
progressive, with EXIF or with other samplings; a PNG's is its IHDR's; a
lossless arithmetic-coded frame (SOF11) or a file that ends before its frame
header raises with the file's path.

The host decoder itself (``csrc/jpeg_entropy.cuh``), built here by the host's
C++ compiler into a library with the card library's host entry points:
* its coefficients equal the Python decoder's on fixture and Pillow-written
  baseline files;
* progressive files (SOF2) that Pillow writes at 4:4:4, 4:2:2 and 4:2:0 with
  restart markers and in gray, at 1x1, 17x9, 37x53 and 61x45, through the
  plain IDCT and colour chain: Pillow's RGB, 0 levels (and
  ``imread_rgb(path, "cpu")`` and ``image_hw``); and whole 640x480 fixture
  images re-saved progressive, with and without restart markers (EOB runs of
  hundreds of blocks, or cut by each interval), one with seeded noise;
* incomplete progressions: without the DC refinement scan libjpeg does not
  smooth and the decode equals Pillow; without an AC refinement of the first
  9 coefficients libjpeg smooths the blocks, and so does the plain chain
  (``test_torch_jpeg_smooth.py`` holds the smoothing itself, on files where
  it moves pixels); a scan out of order and a file cut inside its first
  scan decode as Pillow's (``test_torch_jpeg_damage.py`` holds damaged
  files); lossless arithmetic coding, hierarchical frames,
  a lossless file in YCbCr, 12-bit samples, 2 components, sampling factors
  above 4, a fractional sampling ratio and an MCU of more than 10 blocks
  raise ``ValueError`` with the reason.
Colour spaces (RGB-coded, CMYK, YCCK) and every sampling ratio:
``test_torch_jpeg_colour.py``; arithmetic coding and lossless frames:
``test_torch_jpeg_entropy.py``.
"""
from __future__ import annotations

import ctypes
import io
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from threedod_torch.ops import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "datasets", "synth", "images")
CSRC = os.path.join(ROOT, "threedod_torch", "ops", "csrc")

# ---------------------------------------------------------------------------
# loop transliterations of libjpeg
# ---------------------------------------------------------------------------


def _wrap16(x):
    """x in a 16-bit lane (vpaddw, vpmullw, vpsllw)."""
    return (x + 32768) % 65536 - 32768


def _saturate(x, lo, hi):
    return min(max(x, lo), hi)


def RANGE_LIMIT(x):
    """jidctint-avx2.asm's output stage: vpackssdw, vpacksswb, vpaddb 128."""
    return _saturate(_saturate(x, -32768, 32767), -128, 127) + 128


def idct_islow_loop(coef, quant):
    """jsimd_idct_islow_avx2 (libjpeg-turbo's jidctint-avx2.asm) for one
    block (64 ints, natural order): vpmullw's 16-bit products; where the
    coefficient rows 1 to 7 are all zero, each column its product's DC
    shifted left by 2 in 16 bits (vpsllw), else ``_dodct`` on each column,
    descaled by 11 bits and packed with saturation (vpackssdw); then
    ``_dodct`` on each row, descaled by 18 bits, and the output stage."""
    CB, P1 = 13, 2
    z = [_wrap16(coef[i] * quant[i]) for i in range(64)]
    ws = [0] * 64
    if all(v == 0 for v in coef[8:]):
        for i in range(64):
            ws[i] = _wrap16(z[i % 8] << P1)
    else:
        for c in range(8):
            out = _dodct([z[8 * k + c] for k in range(8)])
            for k in range(8):
                ws[8 * k + c] = _saturate((out[k] + (1 << (CB - P1 - 1))) >> (CB - P1), -32768, 32767)
    block = [0] * 64
    for r in range(8):
        out = _dodct(ws[8 * r:8 * r + 8])
        for k in range(8):
            block[8 * r + k] = RANGE_LIMIT((out[k] + (1 << (CB + P1 + 2))) >> (CB + P1 + 3))
    return block


def _dodct(v):
    """jidctint-avx2.asm's dodct on one column or row: the products in the
    pairs vpmaddwd forms ((in2, in6), (in7, in1), (in5, in3), (z3, z4)), the
    sums in0 + in4, in0 - in4, z3 = in7 + in3 and z4 = in5 + in1 in 16 bits
    (vpaddw)."""
    F = jpeg.FIX
    f054, f076, f184 = F["f0_541196100"], F["f0_765366865"], F["f1_847759065"]
    f029, f089, f117 = F["f0_298631336"], F["f0_899976223"], F["f1_175875602"]
    f150, f196, f205 = F["f1_501321110"], F["f1_961570560"], F["f2_053119869"]
    f256, f307, f039 = F["f2_562915447"], F["f3_072711026"], F["f0_390180644"]
    tmp3 = v[2] * (f054 + f076) + v[6] * f054
    tmp2 = v[2] * f054 + v[6] * (f054 - f184)
    tmp0 = _wrap16(v[0] + v[4]) << 13
    tmp1 = _wrap16(v[0] - v[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(v[7] + v[3]), _wrap16(v[5] + v[1])
    z3, z4 = z3 * (f117 - f196) + z4 * f117, z3 * f117 + z4 * (f117 - f039)
    o0 = v[7] * (f029 - f089) + v[1] * -f089 + z3
    o1 = v[5] * (f205 - f256) + v[3] * -f256 + z4
    o2 = v[5] * -f256 + v[3] * (f307 - f256) + z3
    o3 = v[7] * -f089 + v[1] * (f150 - f089) + z4
    return [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0, tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]


def h2v1_fancy_loop(plane):
    out = []
    for row in plane.tolist():
        o = [row[0], (row[0] * 3 + row[1] + 2) >> 2]
        for j in range(1, len(row) - 1):
            v = row[j] * 3
            o += [(v + row[j - 1] + 1) >> 2, (v + row[j + 1] + 2) >> 2]
        o += [(row[-1] * 3 + row[-2] + 1) >> 2, row[-1]]
        out.append(o)
    return np.asarray(out)


def h2v2_fancy_loop(plane):
    rows = plane.tolist()
    n = len(rows)
    ctx = [rows[0]] + rows + [rows[-1]]  # jdmainct.c repeats the first and the last row
    out = []
    for i in range(n):
        for v in (0, 1):
            near, far = ctx[i + 1], ctx[i] if v == 0 else ctx[i + 2]
            s = [3 * a + b for a, b in zip(near, far)]
            o = [(s[0] * 4 + 8) >> 4, (s[0] * 3 + s[1] + 7) >> 4]
            for j in range(1, len(s) - 1):
                o += [(s[j] * 3 + s[j - 1] + 8) >> 4, (s[j] * 3 + s[j + 1] + 7) >> 4]
            o += [(s[-1] * 3 + s[-2] + 8) >> 4, (s[-1] * 4 + 7) >> 4]
            out.append(o)
    return np.asarray(out)


def h1v2_fancy_loop(plane):
    rows = plane.tolist()
    ctx = [rows[0]] + rows + [rows[-1]]
    out = []
    for i in range(len(rows)):
        out.append([(3 * a + b + 1) >> 2 for a, b in zip(ctx[i + 1], ctx[i])])
        out.append([(3 * a + b + 2) >> 2 for a, b in zip(ctx[i + 1], ctx[i + 2])])
    return np.asarray(out)


def int_upsample_loop(plane, hexp, vexp):
    out = []
    for row in plane.tolist():
        wide = [v for v in row for _ in range(hexp)]
        out += [wide] * vexp
    return np.asarray(out)


def ycc_rgb_loop(y, cb, cr):
    """jdcolor.c build_ycc_rgb_table + ycc_rgb_convert, full-size planes."""
    SB, HALF = 16, 1 << 15

    def fix(x):
        return int(x * (1 << SB) + 0.5)

    cr_r, cb_b, cr_g, cb_g = [], [], [], []
    for i in range(256):
        x = i - 128
        cr_r.append((fix(1.40200) * x + HALF) >> SB)
        cb_b.append((fix(1.77200) * x + HALF) >> SB)
        cr_g.append(-fix(0.71414) * x)
        cb_g.append(-fix(0.34414) * x + HALF)
    lim = lambda v: min(max(v, 0), 255)  # noqa: E731  (range_limit)
    h, w = y.shape
    out = np.zeros((h, w, 3), np.int64)
    for r in range(h):
        for c in range(w):
            yy, b, rr = int(y[r, c]), int(cb[r, c]), int(cr[r, c])
            out[r, c] = (lim(yy + cr_r[rr]), lim(yy + ((cb_g[b] + cr_g[rr]) >> SB)), lim(yy + cb_b[b]))
    return out


# ---------------------------------------------------------------------------
# a baseline JPEG's Huffman data, decoded in Python
# ---------------------------------------------------------------------------

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,
          7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
          46, 53, 60, 61, 54, 47, 55, 62, 63]


def coefficients_python(data: bytes) -> jpeg.Coefficients:
    """Markers and Huffman data of a baseline JPEG -> ``jpeg.Coefficients``."""
    pos, quant, dc, ac, comps, restart = 2, {}, {}, {}, [], 0
    jfif, adobe, space = False, None, None
    while True:
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        length = (data[pos] << 8) | data[pos + 1]
        seg, nxt = data[pos + 2:pos + length], pos + length
        if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                q = np.zeros(64, np.int64)
                for k in range(64):
                    q[ZIGZAG[k]] = (seg[i] << 8 | seg[i + 1]) if pq else seg[i]
                    i += 2 if pq else 1
                quant[tq] = q
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                values = list(seg[i + 17:i + 17 + sum(counts)])
                i += 17 + sum(counts)
                table, code, k = {}, 0, 0
                for length_ in range(1, 17):
                    for _ in range(counts[length_ - 1]):
                        table[(length_, code)] = values[k]
                        code, k = code + 1, k + 1
                    code <<= 1
                (ac if tc else dc)[th] = table
        elif marker in (0xC0, 0xC1):
            height, width, n = (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            comps = [dict(id=seg[6 + 3 * c], h=seg[7 + 3 * c] >> 4, v=seg[7 + 3 * c] & 15, tq=seg[8 + 3 * c])
                     for c in range(n)]
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mcus_w, mcus_h = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.update(bw=mcus_w * c["h"], bh=mcus_h * c["v"], w=-(-width * c["h"] // hmax),
                         hh=-(-height * c["v"] // vmax))
                c["blocks"] = np.zeros((c["bh"], c["bw"], 64), np.int16)
        elif marker == 0xDD:
            restart = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:
            space = _color_space([c["id"] for c in comps], jfif, adobe) if space is None else space
            scan = []
            for i in range(seg[0]):
                c = next(x for x in comps if x["id"] == seg[1 + 2 * i])
                c.update(td=seg[2 + 2 * i] >> 4, ta=seg[2 + 2 * i] & 15, pred=0)
                scan.append(c)
            nxt = _decode_scan(data, nxt, scan, comps, dc, ac, restart, mcus_w, mcus_h)
        pos = nxt
    offset, out, coefs = 0, [], []
    for c in comps:
        out.append(jpeg.Component(c["h"], c["v"], c["bw"], c["bh"], c["w"], c["hh"], offset))
        offset += 64 * c["bw"] * c["bh"]
        coefs.append(c["blocks"].reshape(-1))
    return jpeg.Coefficients(width, height, out, np.concatenate(coefs),
                             np.stack([quant[c["tq"]] for c in comps]).astype(np.uint16), space)


def _color_space(ids, jfif, adobe):
    """The samples' colour space as libjpeg-turbo's jdapimin.c decides it
    from the markers before the first scan and the component IDs."""
    if len(ids) == 1:
        return jpeg.GRAYSCALE
    if len(ids) == 4:
        return jpeg.YCCK if adobe not in (None, 0) else jpeg.CMYK
    if jfif:
        return jpeg.YCBCR
    if adobe is not None:
        return jpeg.RGB if adobe == 0 else jpeg.YCBCR
    return jpeg.RGB if ids == [82, 71, 66] else jpeg.YCBCR


def _decode_scan(data, pos, scan, comps, dc, ac, restart, mcus_w, mcus_h):
    segments, cur = [], []
    while True:  # unstuff, split at restart markers, stop at any other marker
        b = data[pos]
        if b == 0xFF and data[pos + 1] != 0:
            if 0xD0 <= data[pos + 1] <= 0xD7:
                segments.append(cur)
                cur, pos = [], pos + 2
                continue
            break
        cur.append(b)
        pos += 2 if b == 0xFF else 1
    segments.append(cur)
    if len(scan) == 1:
        units_w, units_h = -(-scan[0]["w"] // 8), -(-scan[0]["hh"] // 8)
    else:
        units_w, units_h = mcus_w, mcus_h
    state = dict(bits="".join(f"{b:08b}" for b in segments[0]), at=0)

    def bits(n):
        v = int(state["bits"][state["at"]:state["at"] + n], 2) if n else 0
        state["at"] += n
        return v

    def huff(table):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | bits(1)
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("a code outside its table")

    def extend(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    to_go, segment = restart, 0
    for u in range(units_w * units_h):
        if restart and to_go == 0:
            segment += 1
            state.update(bits="".join(f"{b:08b}" for b in segments[segment]), at=0)
            to_go = restart
            for c in scan:
                c["pred"] = 0
        ux, uy = u % units_w, u // units_w
        for c in scan:
            bw, bh = (1, 1) if len(scan) == 1 else (c["h"], c["v"])
            for by in range(bh):
                for bx in range(bw):
                    blk = c["blocks"][uy * bh + by, ux * bw + bx]
                    s = huff(dc[c["td"]])
                    c["pred"] += extend(bits(s), s) if s else 0
                    blk[0] = c["pred"]
                    k = 1
                    while k < 64:
                        rs = huff(ac[c["ta"]])
                        run, size = rs >> 4, rs & 15
                        if size == 0:
                            if run != 15:
                                break
                            k += 16
                            continue
                        k += run
                        blk[ZIGZAG[k]] = extend(bits(size), size)
                        k += 1
        to_go -= 1
    return pos


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_idct_matches_jidctint():
    rng = np.random.RandomState(0)
    n = 300
    coef = np.zeros((n, 64), np.int16)
    for b in range(n):
        if b % 3 == 0:  # dense: large values reach the range limit's wrap
            coef[b] = rng.randint(-1024, 1024, 64)
        else:  # sparse as real files are; some blocks DC only, some columns AC-free
            k = rng.randint(0, 12)
            coef[b, rng.choice(64, k, replace=False)] = rng.randint(-200, 200, k)
            coef[b, 0] = rng.randint(-300, 300)
    quant = rng.randint(1, 100, (n, 64)).astype(np.int64)
    quant[::5] = 1
    got = jpeg.idct_islow_reference(torch.from_numpy(coef), torch.from_numpy(quant)).numpy().reshape(n, 64)
    want = np.asarray([idct_islow_loop(coef[b].tolist(), quant[b].tolist()) for b in range(n)])
    assert np.array_equal(got, want)
    limit = jpeg.range_limit(torch.arange(-2048, 2048)).numpy()
    assert np.array_equal(limit, [RANGE_LIMIT(x) for x in range(-2048, 2048)])


@pytest.mark.parametrize("shape", [(5, 3), (6, 8), (7, 11), (1, 4), (9, 9)])
def test_fancy_upsampling_matches_jdsample(shape):
    plane = np.random.RandomState(shape[0] * 31 + shape[1]).randint(0, 256, shape).astype(np.uint8)
    t = torch.from_numpy(plane)
    assert np.array_equal(jpeg.upsample_reference(t, 2, 1).numpy(), h2v1_fancy_loop(plane))
    assert np.array_equal(jpeg.upsample_reference(t, 2, 2).numpy(), h2v2_fancy_loop(plane))
    assert np.array_equal(jpeg.upsample_reference(t, 1, 2).numpy(), h1v2_fancy_loop(plane))
    assert np.array_equal(jpeg.upsample_reference(t, 1, 1).numpy(), plane)
    for hexp, vexp in ((4, 1), (3, 2), (1, 3), (4, 4)):
        assert np.array_equal(jpeg.upsample_reference(t, hexp, vexp).numpy(), int_upsample_loop(plane, hexp, vexp))


def _layout(w, h, factors, space):
    """A ``jpeg.Coefficients`` that carries only the frame: size, each
    component's factors and plane size, and the colour space."""
    sizes = [(-(-h * v // max(f[1] for f in factors)), -(-w * hh // max(f[0] for f in factors))) for hh, v in factors]
    comps = [jpeg.Component(hh, v, 0, 0, cw, ch, 0) for (hh, v), (ch, cw) in zip(factors, sizes)]
    return jpeg.Coefficients(w, h, comps, np.zeros(0, np.int16), np.zeros((len(factors), 64), np.uint16), space)


@pytest.mark.parametrize("hf,vf,h,w", [(2, 2, 9, 13), (2, 2, 10, 12), (2, 1, 7, 11), (1, 1, 6, 5), (1, 2, 9, 7),
                                       (4, 1, 5, 13)])
def test_colour_conversion_matches_jdcolor(hf, vf, h, w):
    """jdcolor.c's ycc_rgb_convert after each chroma plane's upsampling, on
    planes of the components' own sizes (luma hf x vf, chroma 1 x 1)."""
    rng = np.random.RandomState(h * w + hf + vf)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb = rng.randint(0, 256, (-(-h // vf), -(-w // hf))).astype(np.uint8)
    cr = rng.randint(0, 256, cb.shape).astype(np.uint8)
    cb[0, 0], cr[0, 0] = 0, 255  # the tables' ends
    up = {(2, 2): h2v2_fancy_loop, (2, 1): h2v1_fancy_loop, (1, 2): h1v2_fancy_loop,
          (1, 1): lambda p: p.astype(np.int64), (4, 1): lambda p: int_upsample_loop(p, 4, 1)}[(hf, vf)]
    want = ycc_rgb_loop(y, up(cb)[:h, :w], up(cr)[:h, :w])
    c = _layout(w, h, [(hf, vf), (1, 1), (1, 1)], jpeg.YCBCR)
    got = jpeg.color_reference([torch.from_numpy(p) for p in (y, cb, cr)], c).numpy()
    assert np.array_equal(got, want)


def test_grayscale_and_refused_samplings():
    """A grayscale plane becomes three equal channels; libjpeg's pick of the
    upsampling method, replication for planes 2 columns wide or less where
    the fancy filters need 3; a fractional sampling ratio raises."""
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (5, 7)).astype(np.uint8))
    rgb = jpeg.color_reference([y], _layout(7, 5, [(1, 1)], jpeg.GRAYSCALE))
    assert rgb.shape == (5, 7, 3) and all(torch.equal(rgb[..., k], y) for k in range(3))
    picks = {(hexp, vexp, width): jpeg.upsample_method(hexp, vexp, width)
             for hexp, vexp in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (3, 3)) for width in (1, 2, 3)}
    assert {k: v for k, v in picks.items() if v != "replicate"} == {
        (1, 1, 1): "fullsize", (1, 1, 2): "fullsize", (1, 1, 3): "fullsize", (2, 1, 3): "h2v1",
        (1, 2, 1): "h1v2", (1, 2, 2): "h1v2", (1, 2, 3): "h1v2", (2, 2, 3): "h2v2"}
    for factors in ([(3, 1), (2, 1), (2, 1)], [(2, 3), (1, 2), (1, 1)]):
        with pytest.raises(ValueError, match="fractional sampling ratio"):
            jpeg.upsampling(_layout(12, 12, factors, jpeg.YCBCR))


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the decoder is Pillow (``data/image_io.py``); the kernels'
    wrappers take CUDA tensors only and say so."""
    with open(os.path.join(FIXTURE, "000001.jpg"), "rb") as f:
        c = coefficients_python(f.read())
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.color_cuda(jpeg.planes_reference(c), c)
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.idct_cuda(c, torch.device("cpu"))


def test_plain_chain_equals_pillow_on_fixture_jpegs():
    from PIL import Image

    names = sorted(os.listdir(FIXTURE))
    for name in names[::29]:  # 4 of the 88
        path = os.path.join(FIXTURE, name)
        with open(path, "rb") as f:
            c = coefficients_python(f.read())
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(jpeg.decode_reference(c).numpy(), want), name


def test_image_hw_equals_pillow(tmp_path):
    from PIL import Image

    from threedod_torch.data.image_io import image_hw

    names = sorted(n for n in os.listdir(FIXTURE) if n.endswith(".jpg"))
    assert len(names) == 88
    for name in names:
        with Image.open(os.path.join(FIXTURE, name)) as im:
            assert image_hw(os.path.join(FIXTURE, name)) == (im.height, im.width), name
    with Image.open(os.path.join(FIXTURE, names[0])) as im:
        img = im.convert("RGB").crop((0, 0, 77, 51))
    exif = Image.Exif()
    exif[0x010E] = "x" * 3000  # a long APP1 segment before the frame header
    for i, kw in enumerate([dict(progressive=True), dict(exif=exif.tobytes()), dict(subsampling=0)]):
        path = str(tmp_path / f"{i}.jpg")
        img.save(path, "JPEG", **kw)
        assert image_hw(path) == (51, 77), kw
    img.save(str(tmp_path / "x.png"))
    assert image_hw(str(tmp_path / "x.png")) == (51, 77)  # a PNG's size from its IHDR
    (tmp_path / "x.txt").write_bytes(b"neither a JPEG nor a PNG")
    with pytest.raises(ValueError, match="x.txt: not a JPEG"):
        image_hw(str(tmp_path / "x.txt"))
    with open(str(tmp_path / "0.jpg"), "rb") as f:
        data = f.read()
    (tmp_path / "cut.jpg").write_bytes(data[:20])
    with pytest.raises(ValueError, match="cut.jpg"):
        image_hw(str(tmp_path / "cut.jpg"))
    sof = data.index(b"\xff\xc2")  # the progressive file's frame marker made a lossless arithmetic one's
    (tmp_path / "sof11.jpg").write_bytes(data[:sof] + b"\xff\xcb" + data[sof + 2:])
    with pytest.raises(ValueError, match="SOF11"):
        image_hw(str(tmp_path / "sof11.jpg"))


ENCODINGS = pytest.mark.parametrize("subsampling,restart,mode", [(0, 0, "RGB"), (1, 2, "RGB"), (2, 3, "RGB"),
                                                                  (2, 0, "L")],
                                    ids=["444", "422_restart", "420_restart", "gray"])


def _encoded(subsampling, restart, mode):
    """(bytes, Pillow's RGB) of a 61x45 crop of a fixture image written by
    Pillow: odd sizes, so partial MCUs at both edges; restart markers every
    ``restart`` MCUs, checked to be in the file."""
    from PIL import Image

    with Image.open(os.path.join(FIXTURE, "000004.jpg")) as im:
        img = im.convert(mode).crop((3, 5, 3 + 61, 5 + 45))
    buf = io.BytesIO()
    kw = dict(quality=90, subsampling=subsampling)
    if restart:
        kw["restart_marker_blocks"] = restart
    img.save(buf, "JPEG", **kw)
    data = buf.getvalue()
    assert (b"\xff\xd0" in data) == bool(restart)
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@ENCODINGS
def test_plain_chain_equals_pillow_on_other_encodings(subsampling, restart, mode):
    data, want = _encoded(subsampling, restart, mode)
    got = jpeg.decode_reference(coefficients_python(data)).numpy()
    assert got.shape == (45, 61, 3) and np.array_equal(got, want)


@pytest.mark.gpu
def test_card_decoder_equals_pillow_and_plain():
    """On a card: the host decoder's coefficients, the IDCT and colour
    kernels, and ``imread_rgb`` against the plain versions and Pillow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from PIL import Image

    from threedod_torch.data.image_io import imread_rgb

    dev = torch.device("cuda", 0)
    for name in sorted(os.listdir(FIXTURE))[:8]:
        path = os.path.join(FIXTURE, name)
        with open(path, "rb") as f:
            data = f.read()
        c = jpeg.decode_coefficients(data)
        ref = coefficients_python(data)
        assert np.array_equal(c.coef, ref.coef) and np.array_equal(c.quant, ref.quant)
        planes = jpeg.planes_cuda(c, dev)
        for got, want in zip(planes, jpeg.planes_reference(c)):
            assert torch.equal(got.cpu(), want)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(imread_rgb(path, dev).cpu().numpy(), want)


@pytest.mark.gpu
@ENCODINGS
def test_card_decoder_on_other_encodings(subsampling, restart, mode):
    """On a card, the encodings the fixture lacks: the host decoder's
    coefficients against the Python decoder's, the IDCT and colour kernels
    against their plain versions, and ``decode_jpeg`` against Pillow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    data, want = _encoded(subsampling, restart, mode)
    c = jpeg.decode_coefficients(data)
    ref = coefficients_python(data)
    assert c.components == ref.components
    assert np.array_equal(c.coef, ref.coef) and np.array_equal(c.quant, ref.quant)
    planes = jpeg.planes_cuda(c, dev)
    host = [p.cpu() for p in planes]
    for got, plain in zip(host, jpeg.planes_reference(c)):
        assert torch.equal(got, plain)
    rgb = jpeg.color_cuda(planes, c).cpu()
    assert torch.equal(rgb, jpeg.color_reference(host, c))
    assert np.array_equal(rgb.numpy(), want)
    assert np.array_equal(jpeg.decode_jpeg(data, dev).cpu().numpy(), want)


# ---------------------------------------------------------------------------
# the host decoder built by the host's compiler: progressive files, refusals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """``csrc/jpeg_entropy.cuh`` alone, compiled by the host's C++ compiler
    into a library that exports the card library's host entry points (about
    a second)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the host decoder with")
    folder = tmp_path_factory.mktemp("jpeg_host")
    (folder / "host.cpp").write_text('#include "jpeg_entropy.cuh"\n')
    lib = folder / "libjpeg_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-I", CSRC, "-o", str(lib),
                    str(folder / "host.cpp")], check=True, capture_output=True, text=True)
    return jpeg.declare_host(ctypes.CDLL(str(lib)))


def test_host_decoder_equals_python_on_baseline(host_decoder):
    """The C++ decoder's coefficients, quantization tables and component
    shapes equal the Python decoder's, on fixture files and on Pillow's other
    baseline encodings."""
    files = []
    for name in sorted(os.listdir(FIXTURE))[::29]:
        with open(os.path.join(FIXTURE, name), "rb") as f:
            files.append(f.read())
    files += [_encoded(*params)[0] for params in ((0, 0, "RGB"), (1, 2, "RGB"), (2, 3, "RGB"), (2, 0, "L"))]
    for data in files:
        got, want = jpeg.decode_coefficients(data, host_decoder), coefficients_python(data)
        assert got.components == want.components and (got.width, got.height) == (want.width, want.height)
        assert np.array_equal(got.coef, want.coef) and np.array_equal(got.quant, want.quant)


def _progressive(subsampling, restart, mode, w, h, source="000004.jpg"):
    """(bytes, Pillow's RGB) of a w x h crop of a fixture image written by
    Pillow as a progressive JPEG (its standard progression: DC first, AC
    bands, refinements)."""
    from PIL import Image

    with Image.open(os.path.join(FIXTURE, source)) as im:
        img = im.convert(mode).crop((3, 5, 3 + w, 5 + h))
    buf = io.BytesIO()
    kw = dict(quality=90, subsampling=subsampling, progressive=True)
    if restart:
        kw["restart_marker_blocks"] = restart
    img.save(buf, "JPEG", **kw)
    data = buf.getvalue()
    assert b"\xff\xc2" in data and b"\xff\xc0" not in data
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@ENCODINGS
def test_progressive_equals_pillow(host_decoder, subsampling, restart, mode, tmp_path):
    """Progressive files through the host decoder and the plain chain:
    Pillow's RGB at 0 levels, at odd sizes (partial MCUs, a one-block image,
    non-interleaved AC scans over each component's own block grid)."""
    from threedod_torch.data.image_io import image_hw, imread_rgb

    for w, h in ((1, 1), (17, 9), (37, 53), (61, 45)):
        data, want = _progressive(subsampling, restart, mode, w, h)
        if restart and w * h > 256:
            assert b"\xff\xd0" in data  # restart markers in the scans
        got = jpeg.decode_reference(jpeg.decode_coefficients(data, host_decoder)).numpy()
        assert got.shape == (h, w, 3) and np.array_equal(got, want), (w, h)
        path = tmp_path / f"{w}x{h}.jpg"
        path.write_bytes(data)
        assert np.array_equal(imread_rgb(str(path), "cpu").numpy(), want) and image_hw(str(path)) == (h, w)


# full-size progressive files: (fixture image, subsampling, restart option,
# mode, quality, noise sigma); without restart markers the AC scans' EOB runs
# span hundreds of blocks, with them each interval cuts its runs; the noisy
# file refines dense coefficients (correction bits on a long nonzero history)
FULL_SIZE = [("000001.jpg", 2, {}, "RGB", 75, 0), ("000017.jpg", 2, {"restart_marker_rows": 1}, "RGB", 90, 0),
             ("000033.jpg", 0, {}, "RGB", 95, 0), ("000050.jpg", 0, {"restart_marker_blocks": 37}, "RGB", 75, 0),
             ("000071.jpg", 1, {"restart_marker_blocks": 5}, "RGB", 85, 0), ("000088.jpg", 2, {}, "L", 75, 0),
             ("000040.jpg", 2, {"restart_marker_blocks": 3}, "RGB", 90, 12)]
FULL_SIZE_IDS = ["420_q75", "420_rows1", "444_q95", "444_restart37", "422_restart5", "gray", "420_noise_restart3"]


def _progressive_full(source, subsampling, restart, mode, quality, noise):
    """(bytes, Pillow's RGB) of a whole 640x480 fixture image (plus seeded
    noise of ``noise`` levels) written by Pillow as a progressive JPEG."""
    from PIL import Image

    with Image.open(os.path.join(FIXTURE, source)) as im:
        img = im.convert(mode)
    if noise:
        px = np.asarray(img).astype(np.float64)
        px += np.random.RandomState(21).normal(0, noise, px.shape)
        img = Image.fromarray(np.clip(px, 0, 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality, subsampling=subsampling, progressive=True, **restart)
    data = buf.getvalue()
    assert b"\xff\xc2" in data and (b"\xff\xd0" in data) == bool(restart)
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _longest_eob_class(data: bytes) -> int:
    """The largest r of the EOBr symbols (runs of 2^r to 2^(r+1) - 1 blocks)
    in the file's AC Huffman tables; a progressive file's tables are
    optimized, so they hold only the symbols its scans use."""
    out, pos = [0], 2
    while pos < len(data) - 3:
        if data[pos] == 0xFF and data[pos + 1] == 0xC4:
            n = (data[pos + 2] << 8) | data[pos + 3]
            seg, i = data[pos + 4:pos + 2 + n], 0
            while i < len(seg):
                k = sum(seg[i + 1:i + 17])
                if seg[i] >> 4 == 1:
                    out += [s >> 4 for s in seg[i + 17:i + 17 + k] if s & 15 == 0 and 0 < s >> 4 < 15]
                i += 17 + k
            pos += 2 + n
        else:
            pos += 1
    return max(out)


@pytest.mark.parametrize("source,subsampling,restart,mode,quality,noise", FULL_SIZE, ids=FULL_SIZE_IDS)
def test_progressive_full_size_equals_pillow(host_decoder, source, subsampling, restart, mode, quality, noise):
    """Whole 640x480 images re-saved as progressive files (4:4:4, 4:2:2,
    4:2:0 and gray, with and without restart markers): the host decoder and
    the plain chain give Pillow's RGB at 0 levels; without restart markers
    the file holds EOB runs of 64 blocks or more."""
    data, want = _progressive_full(source, subsampling, restart, mode, quality, noise)
    if not restart:
        assert _longest_eob_class(data) >= 6
    got = jpeg.decode_reference(jpeg.decode_coefficients(data, host_decoder)).numpy()
    assert got.shape == (480, 640, 3) and np.array_equal(got, want)


def test_incomplete_progressions(host_decoder):
    """A file missing scans: without the DC refinement (Ah 1, Al 0) libjpeg
    keeps the coarser DC, does not smooth (every AC bit is known), and the
    decode equals Pillow's; without the last AC refinement of the luma (bits
    of coefficients 1 to 9 unknown) libjpeg smooths the blocks, the host
    hands the luma's known bits with the coefficients, and the smoothed
    decode equals Pillow's; without the first DC scan every later scan is
    out of order, which libjpeg only warns of (JWRN_BOGUS_PROGRESSION), and a
    file cut inside its first scan and ended by EOI reads zeros past the
    marker (JWRN_HIT_MARKER): both decode as Pillow's."""
    from PIL import Image

    from threedod_torch.tools import jpeg_writer

    data, _ = _progressive(2, 0, "RGB", 37, 53)
    scans = jpeg_writer.scans(data)
    assert [s[3:] for s in scans][0] == (0, 0, 0, 1) and len(scans) == 10

    def without(k):
        return jpeg_writer.without_scans(data, [k])

    dc_refine = next(k for k, s in enumerate(scans) if s[3:] == (0, 0, 1, 0))
    coarse = without(dc_refine)
    got = jpeg.decode_reference(jpeg.decode_coefficients(coarse, host_decoder)).numpy()
    assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(coarse)).convert("RGB")))
    assert jpeg.decode_coefficients(coarse, host_decoder).smooth is None
    smoothed = without(len(scans) - 1)
    c = jpeg.decode_coefficients(smoothed, host_decoder)
    assert c.smooth is not None and c.smooth[0].tolist() == [0] + [1] * 9
    got = jpeg.decode_reference(c).numpy()
    assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(smoothed)).convert("RGB")))
    for damaged in (without(0), data[:scans[0][0] + 20] + b"\xff\xd9"):  # the second cut inside the first scan
        got = jpeg.decode_reference(jpeg.decode_coefficients(damaged, host_decoder)).numpy()
        assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(damaged)).convert("RGB")))


def test_refused_files_say_why(host_decoder):
    """Files outside the decoded subset raise ``ValueError`` with the reason:
    lossless arithmetic coding (SOF11), hierarchical frames (SOF5), a
    lossless file with a JFIF marker (YCbCr, which libjpeg does not convert
    in lossless mode), 12-bit samples, 2 components, sampling factors above
    4, a fractional sampling ratio and an MCU of more than 10 blocks. Pillow
    refuses the first three here (``test_torch_jpeg_colour.py`` holds it to
    refusing the last five too)."""
    from PIL import Image

    from threedod_torch.tools import jpeg_writer

    data, _ = _progressive(0, 0, "RGB", 17, 9)
    sof = data.index(b"\xff\xc2")

    def written(factors, **kw):
        grid = jpeg_writer.block_grid(17, 9, factors)
        return jpeg_writer.encode_jpeg(17, 9, [np.zeros((bh, bw, 64), np.int16) for bh, bw in grid], factors, **kw)

    rng = np.random.RandomState(24)
    lossless_jfif = jpeg_writer.encode_lossless(17, 9, [rng.randint(0, 256, (9, 17)) for _ in range(3)],
                                                [(1, 1)] * 3, jfif=True)
    pillow_refuses = {
        "lossless arithmetic-coded JPEG \\(SOF11\\)": data[:sof] + b"\xff\xcb" + data[sof + 2:],
        "hierarchical": data[:sof] + b"\xff\xc5" + data[sof + 2:],  # SOF5: differential sequential
        "lossless JPEG in YCbCr": lossless_jfif,
    }
    for reason, bad in pillow_refuses.items():
        with pytest.raises(OSError):
            with Image.open(io.BytesIO(bad)) as im:
                im.convert("RGB")
    cases = {
        **pillow_refuses,
        "not 8-bit": data[:sof + 4] + bytes([12]) + data[sof + 5:],
        "2 components": written([(1, 1), (1, 1)]),
        "sampling factors outside 1 to 4": data[:sof + 11] + bytes([0x51]) + data[sof + 12:],
        "fractional sampling ratio": written([(3, 1), (2, 1), (2, 1)]),
        "more than 10 blocks in an MCU": written([(4, 2), (1, 1), (2, 1)]),
    }
    for reason, bad in cases.items():
        with pytest.raises(ValueError, match=reason):
            jpeg.decode_coefficients(bad, host_decoder)


@pytest.mark.gpu
@ENCODINGS
def test_card_decoder_on_progressive_files(subsampling, restart, mode):
    """On a card: progressive files through the host decoder and the IDCT and
    colour kernels, against the plain chain and Pillow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for w, h in ((1, 1), (17, 9), (37, 53), (61, 45)):
        data, want = _progressive(subsampling, restart, mode, w, h)
        c = jpeg.decode_coefficients(data)
        rgb = jpeg.decode_jpeg(data, dev).cpu()
        assert torch.equal(rgb, jpeg.decode_reference(c)) and np.array_equal(rgb.numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("source,subsampling,restart,mode,quality,noise", FULL_SIZE, ids=FULL_SIZE_IDS)
def test_card_decoder_on_full_size_progressive_files(source, subsampling, restart, mode, quality, noise, tmp_path):
    """On a card: ``imread_rgb`` of whole 640x480 progressive files equals
    the plain chain and Pillow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from threedod_torch.data.image_io import imread_rgb

    data, want = _progressive_full(source, subsampling, restart, mode, quality, noise)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(data)
    rgb = imread_rgb(str(path), torch.device("cuda", 0)).cpu()
    assert torch.equal(rgb, jpeg.decode_reference(jpeg.decode_coefficients(data))) and np.array_equal(rgb.numpy(), want)
