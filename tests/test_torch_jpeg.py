"""The plain versions of the card's JPEG decoder (``threedod_torch/ops/
jpeg.py``) against loop transliterations of libjpeg(-turbo)'s C code, and the
whole plain chain against Pillow (libjpeg) on fixture JPEGs.

* ``idct_islow_reference`` vs ``jpeg_idct_islow`` (jidctint.c, with its
  all-zero-AC shortcuts and the post-IDCT range-limit table of jdmaster.c's
  ``prepare_range_limit_table``) on random blocks and quantization tables,
  sparse as real files are and dense enough to reach the range limit's wrap;
* ``upsample_reference`` vs ``h2v1_fancy_upsample`` and ``h2v2_fancy_upsample``
  (jdsample.c, with jdmainct.c's repeated edge rows) on random planes of odd
  and even sizes, every edge column and row included;
* ``ycc_to_rgb_reference`` vs ``ycc_rgb_convert`` (jdcolor.c's tables), and a
  grayscale plane to three equal channels; other samplings raise;
* a baseline JPEG's Huffman data decoded here in Python (a loop over the
  bits, the test's own), then the plain IDCT, upsampling and colour: equal to
  Pillow's RGB on fixture JPEGs and on files Pillow writes with other
  samplings, restart markers and odd sizes.
The card's kernels and the host decoder in ``csrc/`` are held against these
plain versions by the ``gpu`` test here and by ``chip_smoke.py``.

``data/image_io.image_hw`` reads the frame header (``jpeg.frame_hw``): the
size equals Pillow's on all 88 fixture JPEGs and on files Pillow writes
progressive, with EXIF or with other samplings; a PNG, a lossless frame or a
file that ends before its frame header raises with the file's path.
"""
from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

from threedod_torch.ops import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "datasets", "synth", "images")

# ---------------------------------------------------------------------------
# loop transliterations of libjpeg
# ---------------------------------------------------------------------------


def _range_limit_table():
    """jdmaster.c prepare_range_limit_table, returned as the post-IDCT view."""
    MAXJ, CENTER = 255, 128
    table = [0] * (5 * (MAXJ + 1) + CENTER)
    base = MAXJ + 1  # sample_range_limit
    for i in range(MAXJ + 1):
        table[base + i] = i
    for i in range(CENTER, 2 * (MAXJ + 1)):
        table[base + CENTER + i] = MAXJ
    for i in range(2 * (MAXJ + 1), 4 * (MAXJ + 1) - CENTER):
        table[base + CENTER + i] = 0
    for i in range(CENTER):
        table[base + CENTER + 4 * (MAXJ + 1) - CENTER + i] = table[base + i]
    return lambda x: table[base + CENTER + (x & 1023)]


RANGE_LIMIT = _range_limit_table()


def idct_islow_loop(coef, quant):
    """jidctint.c jpeg_idct_islow for one block (64 ints, natural order)."""
    CB, P1 = 13, 2
    F = jpeg.FIX

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    ws = [0] * 64
    for c in range(8):
        z = [coef[8 * k + c] * quant[8 * k + c] for k in range(8)]
        if all(v == 0 for v in z[1:]):
            for k in range(8):
                ws[8 * k + c] = z[0] << P1
            continue
        out = _butterfly(z, F)
        for k in range(8):
            ws[8 * k + c] = descale(out[k], CB - P1)
    block = [0] * 64
    for r in range(8):
        w = ws[8 * r:8 * r + 8]
        if all(v == 0 for v in w[1:]):
            for k in range(8):
                block[8 * r + k] = RANGE_LIMIT(descale(w[0], P1 + 3))
            continue
        out = _butterfly(w, F)
        for k in range(8):
            block[8 * r + k] = RANGE_LIMIT(descale(out[k], CB + P1 + 3))
    return block


def _butterfly(v, F):
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * F["f0_541196100"]
    tmp2 = z1 + z3 * (-F["f1_847759065"])
    tmp3 = z1 + z2 * F["f0_765366865"]
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F["f1_175875602"]
    tmp0 *= F["f0_298631336"]
    tmp1 *= F["f2_053119869"]
    tmp2 *= F["f3_072711026"]
    tmp3 *= F["f1_501321110"]
    z1 *= -F["f0_899976223"]
    z2 *= -F["f2_562915447"]
    z3 *= -F["f1_961570560"]
    z4 *= -F["f0_390180644"]
    z3 += z5
    z4 += z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0, tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2,
            tmp10 - tmp3]


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
    while True:
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        length = (data[pos] << 8) | data[pos + 1]
        seg, nxt = data[pos + 2:pos + length], pos + length
        if marker == 0xDB:
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
                             np.stack([quant[c["tq"]] for c in comps]).astype(np.uint16))


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
    assert np.array_equal(jpeg.upsample_reference(t, 1, 1).numpy(), plane)


@pytest.mark.parametrize("hf,vf,h,w", [(2, 2, 9, 13), (2, 2, 10, 12), (2, 1, 7, 11), (1, 1, 6, 5)])
def test_colour_conversion_matches_jdcolor(hf, vf, h, w):
    rng = np.random.RandomState(h * w + hf + vf)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb = rng.randint(0, 256, (-(-h // vf), -(-w // hf))).astype(np.uint8)
    cr = rng.randint(0, 256, cb.shape).astype(np.uint8)
    cb[0, 0], cr[0, 0] = 0, 255  # the tables' ends
    up = {(2, 2): h2v2_fancy_loop, (2, 1): h2v1_fancy_loop, (1, 1): lambda p: p.astype(np.int64)}[(hf, vf)]
    want = ycc_rgb_loop(y, up(cb)[:h, :w], up(cr)[:h, :w])
    got = jpeg.ycc_to_rgb_reference(torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr)).numpy()
    assert np.array_equal(got, want)


def test_grayscale_and_refused_samplings():
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (5, 7)).astype(np.uint8))
    rgb = jpeg.ycc_to_rgb_reference(y, None, None)
    assert rgb.shape == (5, 7, 3) and all(torch.equal(rgb[..., k], y) for k in range(3))
    for c_shape in ((5, 7 // 2 + 1 + 1), (3, 7), (2, 2)):  # wrong width, 4:4:0, 4:2:0 of a too narrow plane
        with pytest.raises(ValueError, match="4:2:0"):
            jpeg.sampling((5, 7) if c_shape != (2, 2) else (4, 4), c_shape)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the decoder is Pillow (``data/image_io.py``); the kernels'
    wrappers take CUDA tensors only and say so."""
    plane = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.ycc_to_rgb_cuda(plane, plane[:4, :4], plane[:4, :4])
    with open(os.path.join(FIXTURE, "000001.jpg"), "rb") as f:
        c = coefficients_python(f.read())
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
    sof = data.index(b"\xff\xc2")  # the progressive file's frame marker made a lossless one's
    (tmp_path / "sof3.jpg").write_bytes(data[:sof] + b"\xff\xc3" + data[sof + 2:])
    with pytest.raises(ValueError, match="SOF3"):
        image_hw(str(tmp_path / "sof3.jpg"))


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
    args, host_args = (planes, host) if len(planes) == 3 else ([planes[0], None, None], [host[0], None, None])
    rgb = jpeg.ycc_to_rgb_cuda(*args).cpu()
    assert torch.equal(rgb, jpeg.ycc_to_rgb_reference(*host_args))
    assert np.array_equal(rgb.numpy(), want)
    assert np.array_equal(jpeg.decode_jpeg(data, dev).cpu().numpy(), want)
