"""The card's JPEG decoder on the entropy half of libjpeg that Huffman-coded
DCT files do not use: arithmetic coding (SOF9, SOF10, the DAC segment) and
8-bit lossless frames (SOF3), held to Pillow (12.1, libjpeg-turbo) at 0
levels on the CPU through the host decoder (``csrc/jpeg_entropy.cuh``, built
by the host's C++ compiler: ``test_torch_jpeg.host_decoder``) and the plain
chain (``jpeg.decode_reference``), and through ``imread_rgb(path, "cpu")``.

* Arithmetic files that ``tools/jpeg_writer.py`` writes (a port of
  jcarith.c) from the DCT of seeded pixels, at 61x45, 37x53, 17x9 and 1x1,
  at 4:4:4, 4:2:0 and gray (and 4:2:2 in one scan a component, CMYK and
  YCCK), sequential and progressive (libjpeg's simple progression), with
  and without DAC conditioning and restart markers: Pillow reads each as the
  plain chain reads the given coefficients, the host decoder gives exactly
  the coefficients the scans coded, and its RGB is Pillow's.
* Transcodes of Huffman files (``transcode_arithmetic``, what ``jpegtran
  -arithmetic`` makes of them, with the same scans): fixture crops and two
  whole 640x480 fixture images decode to the Huffman file's own
  coefficients and pixels.
* Lossless files the writer makes (predictors 1 to 7, point transforms 0, 2
  and 7, restart markers, gray, RGB and CMYK, one interleaved scan or one
  scan a component, the sampling factors Pillow reads, which it upsamples
  by replication): the host decoder's samples are the writer's, shifted by
  the point transform, and the RGB is Pillow's; differences of category 16
  (32768) and sums past 2^16 decode as Pillow's.
* libjpeg-turbo's colour space of a lossless file: 3 components are RGB
  whatever their IDs unless a JFIF marker or an Adobe transform other than
  0 says YCbCr, which libjpeg does not convert in lossless mode, so Pillow
  refuses it; 4 are CMYK, or YCCK (refused) under an Adobe transform other
  than 0.
* Still refused, each where Pillow raises too: lossless arithmetic coding
  (SOF11), hierarchical frames (SOF5 to SOF7, SOF13 to SOF15), lossless
  YCbCr and YCCK, samples of other than 8 bits, a lossless restart interval
  that is not a whole number of MCU rows. A bad arithmetic code, which
  libjpeg only warns of, and an arithmetic progression libjpeg smooths
  decode as Pillow's (``test_torch_jpeg_smooth.py`` holds the smoothing,
  ``test_torch_jpeg_damage.py`` damaged files).
* ``image_hw`` reads the size of SOF3, SOF9 and SOF10 files as Pillow does.
The ``gpu`` test runs every file here through the card's kernels against
their plain versions and ``decode_jpeg`` against Pillow; a lossless file
launches the colour kernel alone.
"""
from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_jpeg import FIXTURE, host_decoder  # noqa: F401  (the fixture)

from threedod_torch.data.image_io import image_hw, imread_rgb
from threedod_torch.ops import jpeg
from threedod_torch.tools import jpeg_writer as writer

SIZES = ((61, 45), (37, 53), (17, 9), (1, 1))
DAC = {(0, 0): 0x31, (0, 1): 0x52, (1, 0): 2, (1, 1): 20}  # DC (L, U) = (1, 3) and (2, 5); AC Kx 2 and 20


def _pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _space(n: int, kw: dict) -> int:
    """libjpeg's colour space of a DCT file the writer makes."""
    if n == 1:
        return jpeg.GRAYSCALE
    if n == 4:
        return jpeg.YCCK if kw.get("adobe") else jpeg.CMYK
    ids = tuple(kw.get("ids", (1, 2, 3)))
    return jpeg.RGB if kw.get("adobe") == 0 or (ids == (82, 71, 66) and not kw.get("jfif")) else jpeg.YCBCR


def _given(w, h, blocks, factors, space) -> jpeg.Coefficients:
    """The writer's coefficients as the host decoder lays them out, with the
    writer's quantization tables."""
    comps, offset = [], 0
    for (fh, fv), (bh, bw), (ch, cw) in zip(factors, writer.block_grid(w, h, factors),
                                             writer.component_size(w, h, factors)):
        comps.append(jpeg.Component(fh, fv, bw, bh, cw, ch, offset))
        offset += 64 * bw * bh
    quant = np.stack([writer.QUANT[min(k, 1)] for k in range(len(factors))]).astype(np.uint16)
    return jpeg.Coefficients(w, h, comps, np.concatenate([b.reshape(-1) for b in blocks]), quant, space)


def _coded(w, h, blocks, factors, scans) -> list:
    """The coefficients the scans code: a component that only scans of its
    own code keeps none past its own ceil(w / 8) x ceil(h / 8) blocks (DC,
    coded by scans with Ss 0, and AC, by scans with Se above 0, apart)."""
    out = []
    for k, (b, (ch, cw)) in enumerate(zip(blocks, writer.component_size(w, h, factors))):
        b = b.copy()
        outside = np.ones(b.shape[:2], bool)
        outside[:-(-ch // 8), :-(-cw // 8)] = False
        for band, codes in ((slice(0, 1), lambda ss, se: ss == 0), (slice(1, 64), lambda ss, se: se > 0)):
            if not any(len(comps) > 1 and k in comps for comps, ss, se, _, _ in scans if codes(ss, se)):
                b[outside, band] = 0
        out.append(b)
    return out


# (name, factors, progressive, writer options)
ARITH_CASES = [
    ("444", [(1, 1)] * 3, False, {}), ("444_dac_restart", [(1, 1)] * 3, False, {"dac": DAC, "restart": 3}),
    ("420", [(2, 2), (1, 1), (1, 1)], False, {"jfif": True}),
    ("420_dac_restart", [(2, 2), (1, 1), (1, 1)], False, {"dac": DAC, "restart": 2}),
    ("gray", [(1, 1)], False, {}), ("gray_dac_restart", [(1, 1)], False, {"dac": DAC, "restart": 5}),
    ("444_progressive", [(1, 1)] * 3, True, {}),
    ("444_progressive_dac_restart", [(1, 1)] * 3, True, {"dac": DAC, "restart": 3}),
    ("420_progressive", [(2, 2), (1, 1), (1, 1)], True, {}),
    ("420_progressive_dac_restart", [(2, 2), (1, 1), (1, 1)], True, {"dac": DAC, "restart": 1}),
    ("gray_progressive", [(1, 1)], True, {}),
    ("gray_progressive_dac_restart", [(1, 1)], True, {"dac": DAC, "restart": 4}),
    ("422_non_interleaved_restart", [(2, 1), (1, 1), (1, 1)], False, {"interleaved": False, "restart": 5}),
    ("cmyk_progressive_dac", [(1, 1)] * 4, True, {"adobe": 0, "dac": DAC}),
    ("ycck_411_restart", [(4, 1), (1, 1), (1, 1), (4, 1)], False, {"adobe": 2, "restart": 2}),
]


def _arith_file(name, factors, progressive, kw, w, h):
    """(given blocks, scans, bytes) of one arithmetic case at w x h."""
    blocks = writer.random_blocks(np.random.RandomState(sum(map(ord, name)) + w), w, h, factors)
    n = len(factors)
    scans = writer.progression(n) if progressive else (
        [(tuple(range(n)), 0, 63, 0, 0)] if kw.get("interleaved", True) and n > 1 else
        [((k,), 0, 63, 0, 0) for k in range(n)])
    data = writer.encode_jpeg(w, h, blocks, factors, arithmetic=True, scans=scans if progressive else None, **kw)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data and (b"\xff\xcc" in data) == ("dac" in kw)
    return blocks, scans, data


def _equal_pillow(data, host_decoder, tmp_path):  # noqa: F811
    """The host decoder and the plain chain, and ``imread_rgb`` on the CPU,
    against Pillow's RGB at 0 levels; returns what the host decoded."""
    c = jpeg.decode_host(data, host_decoder)
    want = _pillow_rgb(data)
    got = jpeg.decode_reference(c).numpy()
    assert got.shape == want.shape and np.array_equal(got, want), np.abs(got.astype(int) - want).max()
    path = tmp_path / "image.jpg"
    path.write_bytes(data)
    assert np.array_equal(imread_rgb(str(path), "cpu").numpy(), want)
    return c


@pytest.mark.parametrize("name,factors,progressive,kw", ARITH_CASES, ids=[c[0] for c in ARITH_CASES])
def test_arithmetic_files_equal_given_and_pillow(host_decoder, tmp_path, name, factors, progressive, kw):  # noqa: F811
    """The writer's arithmetic files at four sizes: Pillow reads each as the
    plain chain reads the given coefficients; the host decoder's
    coefficients are exactly those the scans coded, and its RGB Pillow's."""
    for w, h in SIZES:
        blocks, scans, data = _arith_file(name, factors, progressive, kw, w, h)
        want = _pillow_rgb(data)
        given = _given(w, h, blocks, factors, _space(len(factors), kw))
        assert np.array_equal(jpeg.decode_reference(given).numpy(), want), (name, w, h)
        c = _equal_pillow(data, host_decoder, tmp_path)
        assert isinstance(c, jpeg.Coefficients) and c.space == given.space
        assert c.components == given.components and np.array_equal(c.quant, given.quant)
        for got, coded in zip(c.blocks(), _coded(w, h, blocks, factors, scans)):
            assert np.array_equal(got, coded), (name, w, h)


def _huffman_crop(kind: str, w: int, h: int) -> bytes:
    with Image.open(os.path.join(FIXTURE, "000004.jpg")) as im:
        img = im.convert("L" if kind == "gray" else "RGB").crop((3, 5, 3 + w, 5 + h))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, **{"sequential_420_restart": dict(restart_marker_blocks=2),
                                          "progressive_444": dict(progressive=True, subsampling=0),
                                          "gray": dict(progressive=True)}[kind])
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["sequential_420_restart", "progressive_444", "gray"])
def test_transcoded_crops_decode_to_their_coefficients(host_decoder, tmp_path, kind):  # noqa: F811
    """Pillow's Huffman files of fixture crops (sequential 4:2:0 with restart
    markers, progressive 4:4:4, progressive gray) made arithmetic with the
    same scans, as they are, with DAC conditioning, and with another
    restart interval: the host decoder gives the Huffman file's own
    coefficients, and Pillow the Huffman file's own pixels."""
    for w, h in SIZES:
        data = _huffman_crop(kind, w, h)
        source = jpeg.decode_coefficients(data, host_decoder)
        for options in ({}, {"dac": DAC}, {"restart": 3, "dac": {(0, 0): 0x10, (1, 0): 63}}):
            arith = writer.transcode_arithmetic(data, source.blocks(), **options)
            assert b"\xff\xc4" not in arith and (b"\xff\xca" in arith) == (kind != "sequential_420_restart")
            c = _equal_pillow(arith, host_decoder, tmp_path)
            assert c.components == source.components and c.space == source.space
            assert np.array_equal(c.coef, source.coef) and np.array_equal(c.quant, source.quant)
            assert np.array_equal(_pillow_rgb(arith), _pillow_rgb(data)), (kind, w, h, options)


@pytest.mark.parametrize("source,options", [("000010.jpg", {}),
                                            ("000033.jpg", {"dac": DAC, "restart": 40})],
                         ids=["sequential_fixture", "progressive_dac_restart"])
def test_transcoded_full_size_equals_pillow(host_decoder, tmp_path, source, options):  # noqa: F811
    """Two whole 640x480 fixture images made arithmetic: the fixture file
    itself (sequential 4:2:0), and the image written progressive by Pillow,
    with DAC conditioning and a restart marker every 40 MCUs."""
    path = os.path.join(FIXTURE, source)
    with open(path, "rb") as f:
        data = f.read()
    if options:
        with Image.open(path) as im:
            buf = io.BytesIO()
            im.convert("RGB").save(buf, "JPEG", quality=90, progressive=True)
        data = buf.getvalue()
    huffman = jpeg.decode_coefficients(data, host_decoder)
    arith = writer.transcode_arithmetic(data, huffman.blocks(), **options)
    c = _equal_pillow(arith, host_decoder, tmp_path)
    assert (c.width, c.height) == (640, 480) and np.array_equal(c.coef, huffman.coef)
    assert np.array_equal(jpeg.decode_reference(c).numpy(), _pillow_rgb(data))


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------

LOSSLESS_KINDS = {"gray": [(1, 1)], "rgb": [(1, 1)] * 3, "cmyk": [(1, 1)] * 4}


def _planes(rng, w, h, factors) -> list:
    return [writer.seeded_samples(rng, cw, ch, 1)[..., 0] for ch, cw in writer.component_size(w, h, factors)]


def _lossless_equal(data, planes, pt, host_decoder, tmp_path, mode=None):  # noqa: F811
    """The host decoder's samples are the writer's planes with the point
    transform's bits dropped; the RGB is Pillow's, and Pillow's own samples
    are those (CMYK inverted: Pillow's ``CMYK;I``)."""
    c = _equal_pillow(data, host_decoder, tmp_path)
    assert isinstance(c, jpeg.Samples)
    for got, x in zip(jpeg.sample_planes(c), planes):
        assert np.array_equal(got, (np.asarray(x) >> pt) << pt)
    if mode is not None:
        with Image.open(io.BytesIO(data)) as im:
            assert im.mode == mode
            samples = np.stack(jpeg.sample_planes(c), -1)
            samples = samples[..., 0] if mode == "L" else samples
            assert np.array_equal(np.asarray(im), 255 - samples if mode == "CMYK" else samples)
    return c


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_equal_pillow(host_decoder, tmp_path, predictor):  # noqa: F811
    """Each predictor on gray, RGB and CMYK at 21x15, with point transforms
    0 and 2, as one interleaved scan, with a restart marker every 2 MCU
    rows, and as one scan a component with a restart marker every row."""
    rng = np.random.RandomState(predictor)
    w, h = 21, 15
    for kind, factors in LOSSLESS_KINDS.items():
        for pt in (0, 2):
            for kw in ({}, {"restart": 2 * w}, {"interleaved": False, "restart": w}):
                planes = _planes(rng, w, h, factors)
                data = writer.encode_lossless(w, h, planes, factors, predictor=predictor, pt=pt, **kw)
                assert (b"\xff\xd0" in data) == ("restart" in kw)
                _lossless_equal(data, planes, pt, host_decoder, tmp_path, {"gray": "L", "rgb": "RGB",
                                                                            "cmyk": "CMYK"}[kind])


# the sampling factors of lossless files: Pillow (libjpeg-turbo) reads each
# and upsamples by replication (int_upsample: no fancy filter without DCT
# blocks)
LOSSLESS_SAMPLINGS = [[(2, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
                      [(1, 1), (2, 2), (2, 1)], [(4, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1), (2, 2)]]


@pytest.mark.parametrize("factors", LOSSLESS_SAMPLINGS, ids=["2x1", "2x2", "1x2", "luma_below_chroma", "4x1",
                                                             "cmyk_2x2"])
def test_lossless_samplings_equal_pillow(host_decoder, tmp_path, factors):  # noqa: F811
    """Lossless files with sampling factors other than 1x1, interleaved
    (dummy samples past the edges) and one scan a component, at odd sizes,
    with restart markers every MCU row: the RGB is Pillow's, which is the
    samples replicated."""
    rng = np.random.RandomState(len(factors) * 10 + factors[0][0] + 3 * factors[0][1])
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    for w, h in ((21, 15), (2, 3), (1, 1)):
        for kw in ({}, {"restart": -(-w // hmax)}, {"interleaved": False}):
            planes = _planes(rng, w, h, factors)
            data = writer.encode_lossless(w, h, planes, factors, predictor=1 + (w + h) % 7, **kw)
            c = _lossless_equal(data, planes, 0, host_decoder, tmp_path)
            assert [(k.h, k.v) for k in c.components] == factors
            up = [np.repeat(np.repeat(p, vmax // fv, 0), hmax // fh, 1)[:h, :w] for p, (fh, fv) in zip(planes, factors)]
            if len(factors) == 3:
                assert np.array_equal(_pillow_rgb(data), np.stack(up, -1))


def test_lossless_category_16_and_wraparound(host_decoder, tmp_path):  # noqa: F811
    """Differences given as they are: category 16 (32768, no extra bits),
    -32767, and sums that pass 2^16 and then 8 bits: the host decoder's
    samples give Pillow's RGB."""
    rng = np.random.RandomState(16)
    for factors in ([(1, 1)], [(1, 1)] * 3):
        diffs = [rng.randint(-300, 300, (7, 9)) for _ in factors]
        diffs[0][0, 0], diffs[0][2, 3], diffs[0][4, 0] = 32768, 32768, -32767
        for predictor in (1, 4, 7):
            data = writer.encode_lossless(9, 7, None, factors, predictor=predictor, pt=1, diffs=diffs)
            assert isinstance(_equal_pillow(data, host_decoder, tmp_path), jpeg.Samples)


def test_lossless_whole_image_equals_pillow(host_decoder, tmp_path):  # noqa: F811
    """A whole 640x480 fixture image written lossless (RGB, predictor 6, a
    restart marker every 40 rows): its pixels exactly, as Pillow's."""
    with Image.open(os.path.join(FIXTURE, "000010.jpg")) as im:
        rgb = np.asarray(im.convert("RGB"))
    data = writer.encode_lossless(640, 480, [rgb[..., k] for k in range(3)], [(1, 1)] * 3, predictor=6,
                                  restart=640 * 40)
    assert np.array_equal(_pillow_rgb(data), rgb)
    _lossless_equal(data, [rgb[..., k] for k in range(3)], 0, host_decoder, tmp_path, "RGB")


# (name, number of components, writer options, colour space or None where Pillow refuses)
LOSSLESS_SPACES = [
    ("ids_123", 3, {}, jpeg.RGB), ("rgb_ids", 3, {"ids": (82, 71, 66)}, jpeg.RGB),
    ("other_ids", 3, {"ids": (5, 6, 7)}, jpeg.RGB), ("adobe0", 3, {"adobe": 0}, jpeg.RGB),
    ("jfif", 3, {"jfif": True}, None), ("adobe1", 3, {"adobe": 1}, None), ("adobe2", 3, {"adobe": 2}, None),
    ("jfif_rgb_ids", 3, {"jfif": True, "ids": (82, 71, 66)}, None),
    ("cmyk", 4, {}, jpeg.CMYK), ("cmyk_adobe0", 4, {"adobe": 0}, jpeg.CMYK),
    ("ycck_adobe2", 4, {"adobe": 2}, None), ("ycck_adobe1", 4, {"adobe": 1}, None),
]


@pytest.mark.parametrize("name,n,kw,space", LOSSLESS_SPACES, ids=[s[0] for s in LOSSLESS_SPACES])
def test_lossless_colour_space_rule(host_decoder, tmp_path, name, n, kw, space):  # noqa: F811
    """libjpeg-turbo's colour space of a lossless file: 3 components RGB
    unless a JFIF marker or an Adobe transform other than 0 says YCbCr, 4
    CMYK unless an Adobe transform other than 0 says YCCK; Pillow refuses
    lossless YCbCr and YCCK (no colour conversion in lossless mode), and so
    does the port, with the reason."""
    rng = np.random.RandomState(sum(map(ord, name)))
    planes = _planes(rng, 13, 11, [(1, 1)] * n)
    data = writer.encode_lossless(13, 11, planes, [(1, 1)] * n, predictor=4, **kw)
    if space is None:
        with pytest.raises(OSError):
            _pillow_rgb(data)
        with pytest.raises(ValueError, match="lossless JPEG in (YCbCr|YCCK)"):
            jpeg.decode_host(data, host_decoder)
        return
    c = _lossless_equal(data, planes, 0, host_decoder, tmp_path, "RGB" if n == 3 else "CMYK")
    assert c.space == space


# ---------------------------------------------------------------------------
# still refused
# ---------------------------------------------------------------------------

def _relabel(data: bytes, marker: int) -> bytes:
    sof = next(i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2, 0xC3, 0xC9, 0xCA))
    return data[:sof + 1] + bytes([marker]) + data[sof + 2:]


def _with_precision(data: bytes, precision: int) -> bytes:
    sof = next(i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] in (0xC9, 0xCA))
    return data[:sof + 4] + bytes([precision]) + data[sof + 5:]


def _refused_case(reason: str) -> bytes:
    rng = np.random.RandomState(7)
    gray = _planes(rng, 17, 9, [(1, 1)])
    lossless = writer.encode_lossless(17, 9, gray, [(1, 1)], predictor=1)
    rgb = _planes(rng, 17, 9, [(1, 1)] * 3)
    arith = writer.encode_jpeg(17, 9, writer.random_blocks(rng, 17, 9, [(1, 1)] * 3), [(1, 1)] * 3,
                               arithmetic=True, scans=writer.progression(3))
    return {
        "SOF11": _relabel(lossless, 0xCB), "SOF5": _relabel(arith, 0xC5), "SOF6": _relabel(arith, 0xC6),
        "SOF7": _relabel(lossless, 0xC7), "SOF13": _relabel(arith, 0xCD), "SOF14": _relabel(arith, 0xCE),
        "SOF15": _relabel(lossless, 0xCF),
        "lossless YCbCr": writer.encode_lossless(17, 9, rgb, [(1, 1)] * 3, jfif=True),
        "lossless YCCK": writer.encode_lossless(17, 9, rgb + gray, [(1, 1)] * 4, adobe=2),
        "lossless 12-bit": writer.encode_lossless(17, 9, gray, [(1, 1)], precision=12),
        "lossless 7-bit": writer.encode_lossless(17, 9, [g >> 1 for g in gray], [(1, 1)], precision=7),
        "arithmetic 12-bit": _with_precision(arith, 12),
        "lossless restart inside a row": writer.encode_lossless(17, 9, rgb, [(1, 1)] * 3, restart=5),
    }[reason]


REFUSALS = {
    "SOF11": "lossless arithmetic-coded JPEG", "SOF5": "hierarchical", "SOF6": "hierarchical",
    "SOF7": "hierarchical", "SOF13": "hierarchical", "SOF14": "hierarchical", "SOF15": "hierarchical",
    "lossless YCbCr": "lossless JPEG in YCbCr", "lossless YCCK": "lossless JPEG in YCCK",
    "lossless 12-bit": "not 8-bit", "lossless 7-bit": "not 8-bit", "arithmetic 12-bit": "not 8-bit",
    "lossless restart inside a row": "not a whole number of MCU rows",
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_still_refused_where_pillow_refuses(host_decoder, case):  # noqa: F811
    """Where Pillow raises (at ``open`` or at decoding), the port raises
    ``ValueError`` with the reason."""
    data = _refused_case(case)
    with pytest.raises(OSError):
        _pillow_rgb(data)
    with pytest.raises(ValueError, match=REFUSALS[case]):
        jpeg.decode_host(data, host_decoder)


def test_bad_arithmetic_code_and_smoothing_refused(host_decoder):  # noqa: F811
    """Files Pillow reads while libjpeg warns or smooths: a block whose AC
    zero run passes coefficient 63 (JWRN_ARITH_BAD_CODE: libjpeg leaves the
    rest of the scan as it is) decodes as Pillow's, its DC kept; an
    arithmetic progression without its last AC refinement, which libjpeg
    smooths, decodes, smoothed, as Pillow's."""
    blocks = [np.zeros((1, 1, 64), np.int16)]
    good = writer.encode_jpeg(8, 8, blocks, [(1, 1)], arithmetic=True)
    sos = good.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(good[sos + 2:sos + 4], "big")
    data = bytearray()
    enc = writer._ArithEncoder(data)
    dc, ac = [0] * 64, [0] * 256
    enc.encode(dc, 0, 0)  # a DC difference of 0
    enc.encode(ac, 0, 0)  # not the end of the block at coefficient 1
    for k in range(1, 64):  # then zeros past coefficient 63
        enc.encode(ac, 3 * (k - 1) + 1, 0)
    enc.finish()
    bad = good[:start] + bytes(data) + b"\xff\xd9"
    want = _pillow_rgb(bad)  # Pillow reads it, with libjpeg's warning
    got = jpeg.decode_reference(jpeg.decode_host(bad, host_decoder)).numpy()
    assert want.shape == (8, 8, 3) and np.array_equal(got, want)
    blocks = writer.random_blocks(np.random.RandomState(9), 37, 21, [(1, 1)])
    smoothed = writer.encode_jpeg(37, 21, blocks, [(1, 1)], arithmetic=True, scans=writer.progression(1)[:-1])
    c = jpeg.decode_host(smoothed, host_decoder)
    assert c.smooth is not None and np.array_equal(jpeg.decode_reference(c).numpy(), _pillow_rgb(smoothed))


def test_image_hw_on_the_new_kinds(tmp_path):
    """``image_hw`` (the frame header alone) gives Pillow's size for SOF3,
    SOF9 and SOF10 files."""
    rng = np.random.RandomState(3)
    files = {
        "sof3": writer.encode_lossless(23, 11, _planes(rng, 23, 11, [(1, 1)] * 3), [(1, 1)] * 3),
        "sof9": writer.encode_jpeg(29, 7, writer.random_blocks(rng, 29, 7, [(1, 1)]), [(1, 1)], arithmetic=True),
        "sof10": writer.encode_jpeg(5, 31, writer.random_blocks(rng, 5, 31, [(2, 2), (1, 1), (1, 1)]),
                                    [(2, 2), (1, 1), (1, 1)], arithmetic=True, scans=writer.progression(3)),
    }
    for name, data in files.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        with Image.open(str(path)) as im:
            assert image_hw(str(path)) == (im.height, im.width), name


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _all_files() -> list:
    """(name, bytes) of the arithmetic and lossless files above."""
    out = [(f"{c[0]}_{w}x{h}", _arith_file(*c, w, h)[2]) for c in ARITH_CASES for w, h in SIZES[::3]]
    rng = np.random.RandomState(5)
    for kind, factors in list(LOSSLESS_KINDS.items()) + [(f"sampling_{k}", f) for k, f in
                                                          enumerate(LOSSLESS_SAMPLINGS)]:
        for predictor in (1, 4, 7):
            out.append((f"lossless_{kind}_{predictor}", writer.encode_lossless(
                21, 15, _planes(rng, 21, 15, factors), factors, predictor=predictor, pt=predictor % 3)))
    return out


@pytest.mark.gpu
def test_card_decoder_on_entropy_cases(tmp_path):
    """On a card: every kind above through the host decoder and the card's
    kernels against their plain versions, ``decode_jpeg`` and ``imread_rgb``
    against Pillow, 0 levels; a lossless file launches no IDCT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    with open(os.path.join(FIXTURE, "000010.jpg"), "rb") as f:
        fixture = f.read()
    transcoded = writer.transcode_arithmetic(fixture, jpeg.decode_coefficients(fixture).blocks(), dac=DAC, restart=8)
    for name, data in _all_files() + [("fixture_transcoded", transcoded)]:
        c = jpeg.decode_host(data)
        idct = jpeg.LAUNCHES_IDCT
        planes = jpeg.planes_cuda(c, dev)
        assert (jpeg.LAUNCHES_IDCT - idct) == (0 if isinstance(c, jpeg.Samples) else 1), name
        host = [p.cpu() for p in planes]
        for got, plain in zip(host, jpeg.planes_reference(c)):
            assert torch.equal(got, plain), name
        rgb = jpeg.color_cuda(planes, c).cpu()
        assert torch.equal(rgb, jpeg.color_reference(host, c)), name
        want = _pillow_rgb(data)
        assert np.array_equal(rgb.numpy(), want) and np.array_equal(jpeg.decode_jpeg(data, dev).cpu().numpy(), want)
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        assert np.array_equal(imread_rgb(str(path), dev).cpu().numpy(), want), name
