"""The card's JPEG decoder on out-of-range and damaged files, held to Pillow
(12.1, libjpeg-turbo 3.1.3) at 0 levels on the CPU, through the host
decoder (``csrc/jpeg_entropy.cuh``, built by the host's C++ compiler:
``test_torch_jpeg.host_decoder``) and the plain chain
(``jpeg.decode_reference``).

* The IDCT's arithmetic, pinned by impulse files that ``tools/jpeg_writer.py``
  writes with chosen quantization tables: DC-only blocks whose DC q crosses
  the int16 range and beyond, one AC coefficient at each of the 63 places,
  random pairs and triples (some saturate the first pass and not the
  output). ``idct_islow_reference`` (libjpeg-turbo's SIMD islow: 16-bit
  products and sums, the block-wide all-zero-AC shortcut's 16-bit shift,
  saturating packs) equals Pillow on every block; jidctint.c's C code, which
  wraps its output (x & 1023), does not (the table at q 4: DC q 6000 and
  8000 give 255, -6000 and -8000 give 0).
* A damaged corpus made from the repo alone: Pillow's baseline and
  progressive files (4:2:0, 4:4:4, gray, with and without restart markers),
  ``jpeg_writer``'s arithmetic transcodes (sequential and progressive) and
  lossless files, each with seeded bit flips, byte corruptions, EOI put
  inside a scan, cuts followed by EOI, a cut with no marker, restart markers
  dropped, renumbered, doubled and inserted, and dropped scans. Every file
  Pillow reads decodes to Pillow's RGB; every file Pillow refuses is
  refused with libjpeg's reason; the JAX package's native reader
  (libjpeg-turbo 2.1.5) equals Pillow on every file it reads but some
  progressive files that libjpeg smooths (2.1.5 smooths otherwise: a
  damaged last scan, a cut arithmetic progression).
* The recoveries one file each: a marker inside a scan, a missing restart
  marker, RST2 read as RST5 (equal to the clean file), a progression without
  its first DC scan or a middle scan, a cut inside the first scan, a bad
  Huffman code early (libjpeg's fast path) and late (its slow path), an AC
  run past a block's end and past a progressive band, a refinement's new
  coefficient past its band and of size 2, a DC category of 13, a file of
  one scan without its EOI that libjpeg's read-ahead reads to the end, a
  one-bit flip that drives a DC past the SIMD IDCT's 16-bit lanes,
  smoothing of the rows a last scan left out of data; and the refusals with
  Pillow's own raise: a file that ends without a marker (one of them where
  only the fast path's read-ahead meets the end), a reserved marker, a
  second SOI, a second scan in a file of one scan, a Huffman table that does
  not make a code, a progressive DC past 32 bits, arithmetic-coded data
  that ends.
The ``gpu`` test runs both IDCT instances on the sweep's blocks against
their plain versions.
"""
from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_jpeg import FIXTURE, host_decoder  # noqa: F401  (the fixture)

from threedod_torch.ops import jpeg
from threedod_torch.tools import jpeg_writer as writer


def _pillow(data: bytes):
    """Pillow's RGB, or the OSError it raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except OSError as e:
        return e


def _port(data: bytes, lib):
    """The host decoder and the plain chain's RGB, or the ValueError."""
    try:
        return jpeg.decode_reference(jpeg.decode_host(data, lib)).numpy()
    except ValueError as e:
        return e


# ---------------------------------------------------------------------------
# A: the IDCT's arithmetic
# ---------------------------------------------------------------------------

def _impulse_file(blocks: np.ndarray, quant) -> bytes:
    """A gray baseline file of the (n, 64) natural-order blocks in one row of
    blocks, with the quantization table ``quant`` (an int: flat)."""
    q = np.full(64, quant) if np.isscalar(quant) else np.asarray(quant)
    return writer.encode_jpeg(8 * len(blocks), 8, [np.asarray(blocks, np.int16)[None]], [(1, 1)], quant=[q, q])


def _sweep(kind: str):
    """[(blocks (n, 64), flat quantization value)] of one impulse sweep."""
    out = []
    if kind == "dc":  # DC-only blocks, DC q from -2047 q to 2047 q
        dcs = np.arange(-2047, 2048)
        for q in (1, 4, 8, 40, 255):
            blocks = np.zeros((len(dcs), 64), np.int64)
            blocks[:, 0] = dcs
            out.append((blocks, q))
    elif kind == "ac":  # one AC coefficient at each place
        values = np.concatenate([np.arange(-1023, 1024, 31), [-1023, 1023]])
        for q in (1, 16, 255):
            blocks = np.zeros((63 * len(values), 64), np.int64)
            for pos in range(1, 64):
                blocks[(pos - 1) * len(values):pos * len(values), pos] = values
            out.append((blocks, q))
    else:  # pairs and triples with a DC
        rng = np.random.RandomState(26)
        for q in (3, 64, 255):
            blocks = np.zeros((1024, 64), np.int64)
            for b in blocks:
                k = rng.randint(1, 3)
                b[rng.choice(np.arange(1, 64), k, replace=False)] = rng.randint(-1023, 1024, k)
                b[0] = rng.randint(-1000, 1001)
            out.append((blocks, q))
    return out


def _pass1_saturates(blocks: np.ndarray, q: int) -> np.ndarray:
    """Which blocks' first pass leaves the int16 range (where the SIMD code
    saturates)."""
    x = jpeg._wrap16(torch.from_numpy(blocks) * q).reshape(-1, 8, 8)
    cols = jpeg._idct_1d([x[:, k, :] for k in range(8)])
    ws = torch.stack([jpeg._descale(v, jpeg.CONST_BITS - jpeg.PASS1_BITS) for v in cols], 1)
    return ((ws < -32768) | (ws > 32767)).flatten(1).any(1).numpy()


@pytest.mark.parametrize("kind", ["dc", "ac", "pairs"])
def test_idct_impulse_sweep_equals_pillow(kind):
    """Every block of the sweep: the plain IDCT equals Pillow's samples at 0
    levels. The pairs reach blocks whose first pass saturates while some of
    their samples stay inside 1..254."""
    saturated = 0
    for blocks, q in _sweep(kind):
        with Image.open(io.BytesIO(_impulse_file(blocks, q))) as im:
            want = np.asarray(im.convert("L")).reshape(8, -1, 8).transpose(1, 0, 2)
        got = jpeg.idct_islow_reference(torch.from_numpy(blocks), torch.tensor(q)).numpy()
        assert np.array_equal(got, want), (kind, q, int((got != want).any((1, 2)).sum()))
        saturated += int((_pass1_saturates(blocks, q) & ((want > 0) & (want < 255)).any((1, 2))).sum())
    assert kind != "pairs" or saturated > 0


def test_idct_table_of_dc_only_blocks():
    """The first sample of DC-only blocks at q 4 (DC q 1600 to 8000 and
    -4000 to -8000) and at q 8 and 40 (DC q 12000), each block after a zero
    one: Pillow's, and the plain IDCT's; jidctint.c's C range limit (x &
    1023) would give 0, 104, 255 and 152 at q 4's 6000, 8000, -6000 and
    -8000, where the SIMD code saturates, and 255 at 12000, where its 16-bit
    shift wraps."""
    cases = {4: ([1600, 2400, 4000, 6000, 8000, -4000, -6000, -8000], [255] * 5 + [0] * 3), 8: ([12000], [0]),
             40: ([12000], [0])}
    for q, (dcq, want) in cases.items():
        blocks = np.zeros((2 * len(dcq), 64), np.int64)
        blocks[1::2, 0] = np.asarray(dcq) // q
        with Image.open(io.BytesIO(_impulse_file(blocks, q))) as im:
            pillow = np.asarray(im.convert("L"))[0, 8::16]
        got = jpeg.idct_islow_reference(torch.from_numpy(blocks), torch.tensor(q))[1::2, 0, 0].numpy()
        assert pillow.tolist() == want and got.tolist() == want, q
    blocks = np.zeros((4, 64), np.int64)
    blocks[:, 0] = [1500, 2000, -1500, -2000]
    assert _c_idct(torch.from_numpy(blocks), torch.tensor(4))[:, 0, 0].tolist() == [0, 104, 255, 152]


# ---------------------------------------------------------------------------
# B and C: the damaged corpus
# ---------------------------------------------------------------------------

def _crop(mode: str, source: str = "000004.jpg", box=(5, 7, 133, 103)):
    with Image.open(os.path.join(FIXTURE, source)) as im:
        return im.convert(mode).crop(box) if box else im.convert(mode)


def _saved(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _base(kind: str, lib) -> bytes:
    """A clean file of each kind the corpus damages (128x96 crops of fixture
    images at quality 85; the writer's lossless files at 45x31)."""
    pillow_kinds = {
        "baseline_420": ("RGB", dict(subsampling=2)),
        "baseline_444_restart": ("RGB", dict(subsampling=0, restart_marker_blocks=4)),
        "gray_restart_rows": ("L", dict(restart_marker_rows=1)),
        "progressive_420": ("RGB", dict(subsampling=2, progressive=True)),
        "progressive_444_restart": ("RGB", dict(subsampling=0, progressive=True, restart_marker_blocks=5)),
        "progressive_gray": ("L", dict(progressive=True)),
    }
    if kind in pillow_kinds:
        mode, kw = pillow_kinds[kind]
        return _saved(_crop(mode), quality=85, **kw)
    if kind.startswith("arithmetic"):
        huffman = _base("progressive_420" if kind.endswith("progressive") else "baseline_420", lib)
        blocks = jpeg.decode_coefficients(huffman, lib).blocks()
        return writer.transcode_arithmetic(huffman, blocks, restart=0 if kind.endswith("progressive") else 6)
    factors = [(1, 1)] * 3 if kind == "lossless_rgb" else [(1, 1)]
    planes = [np.asarray(_crop("L", box=(40 + 9 * k, 20, 85 + 9 * k, 51))).astype(np.int64) for k in
              range(len(factors))]
    return writer.encode_lossless(45, 31, planes, factors, predictor=4 if len(factors) == 3 else 7,
                                  restart=0 if len(factors) == 3 else 45 * 2)


BASES = ["baseline_420", "baseline_444_restart", "gray_restart_rows", "progressive_420", "progressive_444_restart",
         "progressive_gray", "arithmetic_sequential", "arithmetic_progressive", "lossless_rgb", "lossless_gray_restart"]


def _data_ranges(data: bytes):
    """(start, end) of each scan's entropy-coded data."""
    out = []
    for start, end, *_ in writer.scans(data):
        out.append((start + 2 + int.from_bytes(data[start + 2:start + 4], "big"), end))
    return out


def damaged(data: bytes, rng: np.random.RandomState) -> list:
    """[(kind, bytes)] of seeded damage to the file's entropy-coded data."""
    ranges = _data_ranges(data)

    def at():
        start, end = ranges[rng.randint(len(ranges))]
        return start + rng.randint(end - start)

    out = []
    for _ in range(6):
        p, b = at(), bytearray(data)
        b[p] ^= 1 << rng.randint(8)
        out.append(("bit flip", bytes(b)))
    for _ in range(4):
        p, b = at(), bytearray(data)
        b[p:p + 3] = bytes(rng.randint(0, 256, 3).tolist())
        out.append(("bytes", bytes(b[:len(data)])))
    p = at()
    out.append(("EOI inside a scan", data[:p] + b"\xff\xd9" + data[p:]))
    for _ in range(2):
        out.append(("cut, then EOI", data[:at()] + b"\xff\xd9"))
    out.append(("cut", data[:at()]))
    restarts = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    if restarts:
        for _ in range(2):
            i = restarts[rng.randint(len(restarts))]
            out.append(("restart marker dropped", data[:i] + data[i + 2:]))
            b = bytearray(data)
            b[i + 1] = 0xD0 + rng.randint(8)
            out.append(("restart marker renumbered", bytes(b)))
        i = restarts[rng.randint(len(restarts))]
        out.append(("restart marker doubled", data[:i] + data[i:i + 2] + data[i:]))
    p = at()
    out.append(("restart marker inserted", data[:p] + bytes([0xFF, 0xD0 + rng.randint(8)]) + data[p:]))
    if len(ranges) > 1:
        out.append(("scan dropped", writer.without_scans(data, [rng.randint(len(ranges))])))
    return out


def _native_reader():
    """The JAX package's native reader (libjpeg-turbo 2.1.5), or None."""
    from threedod.data import native_io

    return native_io._loaderc


def _holds(data: bytes, lib, native, tmp_path) -> str:
    """``data`` through the port against Pillow: 'read' (0 levels) or
    'refused' (both raise; the port with libjpeg's reason); the native
    reader, where it reads the file (2.1.5 reads no lossless file), equal to
    Pillow but on files libjpeg smooths."""
    want, got = _pillow(data), _port(data, lib)
    if isinstance(want, OSError):
        assert isinstance(got, ValueError), f"the port reads a file Pillow refuses ({want})"
        reason = "ends without a marker" if "truncated" in str(want) else "jd"
        assert reason in str(got), (str(want), str(got))
        return "refused"
    assert not isinstance(got, ValueError), f"the port refuses a file Pillow reads: {got}"
    assert got.shape == want.shape and np.array_equal(got, want), int(np.abs(got.astype(int) - want).max())
    if native is not None:
        path = tmp_path / "damaged.jpg"
        path.write_bytes(data)
        try:
            theirs = native.imread_rgb(str(path))
        except OSError:
            return "read"
        if not np.array_equal(theirs, want):
            c = jpeg.decode_host(data, lib)
            assert getattr(c, "smooth", None) is not None, "the native reader differs from Pillow"
    return "read"


@pytest.mark.parametrize("kind", BASES)
def test_damaged_files_equal_pillow(host_decoder, tmp_path, kind):  # noqa: F811
    """Each kind's clean file, then its seeded damage: Pillow's RGB at 0
    levels where Pillow reads the file, a refusal with libjpeg's reason
    where it refuses; most damaged files read, some refused, and the
    damage shows in the pixels of some."""
    native = _native_reader()
    clean = _base(kind, host_decoder)
    assert _holds(clean, host_decoder, native, tmp_path) == "read"
    clean_rgb = _pillow(clean)
    seen, changed = {"read": 0, "refused": 0}, 0
    for what, data in damaged(clean, np.random.RandomState(BASES.index(kind))):
        seen[_holds(data, host_decoder, native, tmp_path)] += 1
        rgb = _pillow(data)
        changed += not isinstance(rgb, OSError) and rgb.shape == clean_rgb.shape and not np.array_equal(rgb,
                                                                                                       clean_rgb)
    assert seen["read"] >= 10 and seen["refused"] >= 1 and changed >= 1, (seen, changed)


# ---------------------------------------------------------------------------
# the recoveries, one file each
# ---------------------------------------------------------------------------

def _c_idct(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """jidctint.c's C code (64-bit sums, the range limit's x & 1023), which
    the port ran before it took the SIMD code's arithmetic: (N, 64) -> (N,
    8, 8) uint8."""
    F = jpeg.FIX

    def butterfly(v):
        z1 = (v[2] + v[6]) * F["f0_541196100"]
        tmp2, tmp3 = z1 - v[6] * F["f1_847759065"], z1 + v[2] * F["f0_765366865"]
        tmp0, tmp1 = (v[0] + v[4]) << 13, (v[0] - v[4]) << 13
        e = [tmp0 + tmp3, tmp1 + tmp2, tmp1 - tmp2, tmp0 - tmp3]
        z5 = (v[7] + v[3] + v[5] + v[1]) * F["f1_175875602"]
        z1, z2 = (v[7] + v[1]) * -F["f0_899976223"], (v[5] + v[3]) * -F["f2_562915447"]
        z3, z4 = (v[7] + v[3]) * -F["f1_961570560"] + z5, (v[5] + v[1]) * -F["f0_390180644"] + z5
        o = [v[7] * F["f0_298631336"] + z1 + z3, v[5] * F["f2_053119869"] + z2 + z4,
             v[3] * F["f3_072711026"] + z2 + z3, v[1] * F["f1_501321110"] + z1 + z4]
        return [e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0], e[3] - o[0], e[2] - o[1], e[1] - o[2],
                e[0] - o[3]]

    x = (coef.to(torch.int64) * quant).reshape(-1, 8, 8)
    ws = torch.stack([(v + 1024) >> 11 for v in butterfly([x[:, k, :] for k in range(8)])], 1)
    out = torch.stack([(v + (1 << 17)) >> 18 for v in butterfly([ws[:, :, k] for k in range(8)])], 2) & 1023
    return torch.where(out < 128, out + 128, torch.where(out < 512, 255, torch.where(out < 896, 0, out - 896))).to(
        torch.uint8)

def _gray_scan(symbols, dc_values=None) -> bytes:
    """An 8x8 gray baseline file with a flat quantization table of 1 and
    Annex K's luminance tables (the DC table's symbols ``dc_values`` where
    given), whose scan codes ``symbols``: ("dc" or "ac", symbol, extra
    bits, their length)."""
    dc_counts, dc_symbols = writer.HUFFMAN["dc_luma"]
    dc_symbols = list(dc_values or dc_symbols)
    codes = {"dc": writer._codes(dc_counts, dc_symbols), "ac": writer._codes(*writer.HUFFMAN["ac_luma"])}
    bits = writer._Bits()
    for table, symbol, extra, length in symbols:
        bits.put(*codes[table][symbol])
        if length:
            bits.put(extra, length)
    bits.flush()
    dht = b"".join(bytes([tc]) + bytes(counts) + bytes(values) for tc, (counts, values) in
                   ((0x00, (dc_counts, dc_symbols)), (0x10, writer.HUFFMAN["ac_luma"])))
    return (b"\xff\xd8" + writer._segment(0xDB, bytes([0] + [1] * 64))
            + writer._frame(0xC0, 8, 8, [(1, 1)], [1]) + writer._segment(0xC4, dht)
            + writer._segment(0xDA, bytes([1, 1, 0, 0, 63, 0])) + bytes(bits.out) + b"\xff\xd9")


def _progressive_gray(scans) -> bytes:
    """An 8x8 gray progressive file (SOF2) with a flat quantization table
    of 1 and Annex K's luminance tables, of ``scans``: ((Ss, Se, Ah, Al),
    symbols), each symbol ("dc" or "ac", symbol, extra bits, their length)
    or ("bits", value, length)."""
    codes = {"dc": writer._codes(*writer.HUFFMAN["dc_luma"]), "ac": writer._codes(*writer.HUFFMAN["ac_luma"])}
    dht = b"".join(bytes([tc]) + bytes(counts) + bytes(values) for tc, (counts, values) in
                   ((0x00, writer.HUFFMAN["dc_luma"]), (0x10, writer.HUFFMAN["ac_luma"])))
    out = (b"\xff\xd8" + writer._segment(0xDB, bytes([0] + [1] * 64)) + writer._frame(0xC2, 8, 8, [(1, 1)], [1])
           + writer._segment(0xC4, dht))
    for (ss, se, ah, al), symbols in scans:
        bits = writer._Bits()
        for symbol in symbols:
            if symbol[0] == "bits":
                bits.put(symbol[1], symbol[2])
                continue
            table, value, extra, length = symbol
            bits.put(*codes[table][value])
            if length:
                bits.put(extra, length)
        bits.flush()
        out += writer._segment(0xDA, bytes([1, 1, 0, ss, se, (ah << 4) | al])) + bytes(bits.out)
    return out + b"\xff\xd9"


def _recovery(case: str, lib):
    """(damaged file, the clean file it should equal or None) of one recovery."""
    seq = _saved(_crop("RGB"), quality=85, subsampling=2)
    restart = _saved(_crop("RGB"), quality=85, subsampling=0, restart_marker_blocks=4)
    progressive = _saved(_crop("RGB"), quality=85, subsampling=2, progressive=True)
    (start, end), = _data_ranges(seq)
    rst = [restart.index(bytes([0xFF, 0xD0 + k])) for k in range(3)]
    if case == "marker inside a scan":
        return seq[:(start + end) // 2] + b"\xff\xd9" + seq[(start + end) // 2:], None
    if case == "missing RST1":
        return restart[:rst[1]] + restart[rst[1] + 2:], None
    if case == "RST2 read as RST5":
        return restart[:rst[2] + 1] + b"\xd5" + restart[rst[2] + 2:], restart
    if case == "progression without its first DC scan":
        return writer.without_scans(progressive, [0]), None
    if case == "progression without a middle scan":
        return writer.without_scans(progressive, [len(writer.scans(progressive)) // 2]), None
    if case == "cut inside the first scan":
        first = _data_ranges(progressive)[0]
        return progressive[:(first[0] + first[1]) // 2] + b"\xff\xd9", None
    if case in ("bad Huffman code early", "bad Huffman code late"):  # 16 one bits: no luminance AC code
        big = _saved(_crop("RGB", box=(0, 0, 400, 300)), quality=85, subsampling=2)
        (s, e), = _data_ranges(big)
        p = s + 100 if case.endswith("early") else e - 100
        return big[:p] + b"\xff\x00\xff\x00" + big[p + 2:], None
    if case == "AC run past the block's end":  # four ZRL-like runs of 15 zeros and a 1: the last lands at 63
        return _gray_scan([("dc", 1, 1, 1)] + [("ac", 0xF1, 1, 1)] * 4), None
    if case == "DC category 13":  # the table's category 11 code read as category 13
        return _gray_scan([("dc", 13, 4000, 13), ("ac", 0x00, 0, 0)], list(range(11)) + [13]), None
    if case == "AC run past a progressive band":  # band 1 to 5: runs of 3 and 2 put the second at place 7
        return _progressive_gray([((0, 0, 0, 0), [("dc", 3, 5, 3)]),
                                  ((1, 5, 0, 0), [("ac", 0x31, 1, 1), ("ac", 0x21, 0, 1)])]), None
    if case == "refinement past its band, of size 2":  # run 7, size 2: sign bit only, at place 6
        return _progressive_gray([((0, 0, 0, 0), [("dc", 3, 5, 3)]), ((1, 5, 0, 1), [("ac", 0x00, 0, 0)]),
                                  ((1, 5, 1, 0), [("ac", 0x72, 1, 1)])]), None
    if case == "EOI dropped, read to the end":  # libjpeg's read-ahead stops short of the file's end
        return _saved(_crop("RGB", "000008.jpg", (0, 0, 320, 240)), quality=60, subsampling=2)[:-2], None
    if case == "one-bit flip past the 16-bit lanes":
        data = _saved(_crop("RGB", "000001.jpg", (100, 100, 228, 196)), quality=85)
        (s, e), = _data_ranges(data)
        rng = np.random.RandomState(6)
        p, b = s + rng.randint(e - s), bytearray(data)
        b[p] ^= 1 << rng.randint(8)
        return bytes(b), None
    if case == "last scan out of data, smoothed":  # cut in its second scan, then EOI
        data = _saved(_crop("RGB", "000001.jpg", (0, 0, 200, 152)), quality=90, subsampling=0, progressive=True,
                      restart_marker_blocks=7)
        s, e = _data_ranges(data)[1]
        return data[:s + (e - s) * 3 // 10] + b"\xff\xd9", None
    raise ValueError(case)


RECOVERIES = ["marker inside a scan", "missing RST1", "RST2 read as RST5", "progression without its first DC scan",
              "progression without a middle scan", "cut inside the first scan", "bad Huffman code early",
              "bad Huffman code late", "AC run past the block's end", "AC run past a progressive band",
              "refinement past its band, of size 2", "DC category 13", "EOI dropped, read to the end",
              "one-bit flip past the 16-bit lanes", "last scan out of data, smoothed"]


@pytest.mark.parametrize("case", RECOVERIES)
def test_recoveries_equal_pillow(host_decoder, case):  # noqa: F811
    """Each recovery on a file made for it: Pillow reads it and the port
    gives its RGB at 0 levels (RST2 read as RST5 equals the clean file);
    the flipped file's DC q leaves what the 16-bit lanes hold, and the
    smoothed file's rows past the last scan's data are smoothed by the bits
    known before that scan."""
    data, clean = _recovery(case, host_decoder)
    want = _pillow(data)
    assert not isinstance(want, OSError), want
    c = jpeg.decode_host(data, host_decoder)
    assert np.array_equal(jpeg.decode_reference(c).numpy(), want)
    if clean is not None:
        assert np.array_equal(want, _pillow(clean))
    if case == "one-bit flip past the 16-bit lanes":  # jidctint.c's C arithmetic is off Pillow here
        c_planes = [_c_idct(torch.from_numpy(b.reshape(-1, 64)), torch.from_numpy(c.quant[k].astype(np.int64)))
                    .reshape(comp.blocks_h, comp.blocks_w, 8, 8).permute(0, 2, 1, 3)
                    .reshape(8 * comp.blocks_h, 8 * comp.blocks_w)[:comp.height, :comp.width]
                    for k, (b, comp) in enumerate(zip(c.blocks(), c.components))]
        assert np.abs(jpeg.color_reference(c_planes, c).numpy().astype(int) - want).max() > 200
    if case == "last scan out of data, smoothed":
        assert c.smooth_prev is not None
        assert not np.array_equal(jpeg.decode_reference(c._replace(smooth_prev=None)).numpy(), want)


def _dc_overflow() -> bytes:
    """A progressive 2048x2056 gray file whose one scan, a DC first scan,
    codes a DC difference of +32767 in every block (category 15, the DC
    table's only code): the prediction passes 2^31 at block 65539."""
    sof = writer._frame(0xC2, 2048, 2056, [(1, 1)], [1])
    dht = writer._segment(0xC4, bytes([0x00, 1] + [0] * 15 + [15]))
    sos = writer._segment(0xDA, bytes([1, 1, 0, 0, 0, 0]))
    data = b"\x7f\xff\x00" * (256 * 257)  # the code 0, then 15 one bits, with a stuffed zero after 0xFF
    return b"\xff\xd8" + writer._segment(0xDB, bytes([0] + [1] * 64)) + sof + dht + sos + data + b"\xff\xd9"


def _refused(case: str, lib) -> bytes:
    seq = _saved(_crop("RGB"), quality=85, subsampling=2)
    (start, end), = _data_ranges(seq)
    middle = (start + end) // 2
    if case == "ends without a marker":
        return seq[:middle]
    if case == "EOI dropped, the fast path's read-ahead at the end":
        return _saved(_crop("RGB", "000028.jpg", None), quality=60, subsampling=0)[:-2]
    if case == "reserved marker":
        return seq[:middle] + b"\xff\x02" + seq[middle:]
    if case == "second SOI":
        return seq[:middle] + b"\xff\xd8" + seq[middle:]
    if case == "second scan in a file of one scan":
        return seq[:-2] + seq[start - 14:]  # the SOS segment and the data again, then EOI
    if case == "Huffman table that makes no code":
        dht = seq.index(b"\xff\xc4")
        return seq[:dht + 6] + b"\x03" + seq[dht + 7:]  # three codes of 1 bit
    if case == "progressive DC past 32 bits":
        return _dc_overflow()
    if case == "arithmetic data that ends":
        arith = writer.transcode_arithmetic(seq, jpeg.decode_coefficients(seq, lib).blocks())
        (s, e), = _data_ranges(arith)
        return arith[:(s + e) // 2]
    raise ValueError(case)


REFUSALS = {"ends without a marker": "ends without a marker",
            "EOI dropped, the fast path's read-ahead at the end": "ends without a marker",
            "reserved marker": "JERR_UNKNOWN_MARKER",
            "second SOI": "JERR_SOI_DUPLICATE", "second scan in a file of one scan": "JERR_EOI_EXPECTED",
            "Huffman table that makes no code": "JERR_BAD_HUFF_TABLE",
            "progressive DC past 32 bits": "JERR_BAD_DCT_COEF", "arithmetic data that ends": "JERR_CANT_SUSPEND"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_name_libjpeg_reason(host_decoder, case):  # noqa: F811
    """Where Pillow raises, the port raises ``ValueError`` naming libjpeg's
    error (Pillow's "image file is truncated" for a file that ends without
    a marker)."""
    data = _refused(case, host_decoder)
    want = _pillow(data)
    assert isinstance(want, OSError)
    assert ("truncated" in str(want)) == (REFUSALS[case] == "ends without a marker"), str(want)
    with pytest.raises(ValueError, match=REFUSALS[case]):
        jpeg.decode_host(data, host_decoder)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def sweep_coefficients() -> list:
    """(name, Coefficients) of the sweep's blocks as one-component files,
    each also with smoothing bits (DC only, and AC scans at Al 2, some rows
    past a last good iMCU row) for the smoothing instance."""
    out = []
    for kind in ("dc", "ac", "pairs"):
        for blocks, q in _sweep(kind):
            n = len(blocks)
            w = min(n, 512)
            h = -(-n // w)
            grid = np.zeros((h * w, 64), np.int16)
            grid[:n] = blocks
            comp = jpeg.Component(1, 1, w, h, 8 * w, 8 * h, 0)
            quant = np.full((1, 64), q, np.uint16)
            c = jpeg.Coefficients(8 * w, 8 * h, [comp], grid.reshape(-1), quant, jpeg.GRAYSCALE)
            out.append((f"{kind} q {q}", c))
            bits = np.array([[0] + [-1] * 9], np.int32)
            prev = np.array([[0] + [2] * 9], np.int32)
            out.append((f"{kind} q {q} smoothed", c._replace(smooth=bits, smooth_prev=prev, last_good_row=h // 2)))
    return out


@pytest.mark.gpu
def test_idct_kernel_on_the_sweep():
    """On a card: both IDCT instances on the sweep's blocks equal their
    plain versions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for name, c in sweep_coefficients():
        comp = c.components[0]
        got = jpeg.idct_cuda(c, dev)[0].cpu()
        want = jpeg.planes_reference(c)[0]
        assert torch.equal(got[:comp.height, :comp.width], want), name
