"""The card's JPEG decoder on the colour half of libjpeg: colour spaces and
upsampling, held to Pillow (12.1, libjpeg-turbo) at 0 levels on the CPU
through the host decoder (``csrc/jpeg_entropy.cuh``, built by the host's
C++ compiler: ``test_torch_jpeg.host_decoder``) and the plain chain
(``jpeg.decode_reference``), and through ``imread_rgb(path, "cpu")``.

* The colour space of a 3-component file as libjpeg-turbo decides it: a JFIF
  marker means YCbCr; else an Adobe marker's transform 0 means RGB and any
  other YCbCr; else component IDs 'R', 'G', 'B' mean RGB and any others
  YCbCr. Of a 4-component file: Adobe transform 0 or no Adobe marker CMYK,
  any other transform YCCK. Each branch is a file here, among them the 64x48
  file Pillow writes with ``keep_rgb=True``, which the decoder once read as
  YCbCr (73 levels off).
* Pillow's reading of CMYK: its ``CMYK;I`` unpacking inverts libjpeg's
  samples, and ``cmyk2rgb`` is pinned over every value of C and K.
* Every integer sampling ratio with factors 1 to 4 (4:1:1, 4:4:0, 4x2 over
  1x1, luma below chroma, 3x1), chroma planes 1 and 2 columns wide,
  non-interleaved sequential files with restart markers, YCCK at 4:2:0,
  progressive CMYK and YCCK, written by Pillow or by the port's numpy writer
  (``threedod_torch/tools/jpeg_writer.py``), whose files are first held to
  the Python decoder of ``test_torch_jpeg.py`` and to Pillow.
* Where Pillow refuses (2 components, a fractional ratio, more than 10 blocks
  an MCU, 12-bit samples), the port raises ``ValueError`` with the reason.
The ``gpu`` test holds the IDCT and colour kernels to their plain versions,
and ``decode_jpeg`` to Pillow, on every file here.
"""
from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_jpeg import FIXTURE, coefficients_python, host_decoder  # noqa: F401  (the fixture)

from threedod_torch.data.image_io import imread_rgb
from threedod_torch.ops import jpeg
from threedod_torch.tools import jpeg_writer


def _crop(w, h, mode="RGB"):
    with Image.open(os.path.join(FIXTURE, "000004.jpg")) as im:
        return im.convert(mode).crop((3, 5, 3 + w, 5 + h))


def _pillow(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _segments(data: bytes):
    """(start, end, marker) of each marker segment before the first scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, end, data[pos + 1]))
        pos = end
    return out


def _without(data: bytes, marker: int) -> bytes:
    a, b, _ = next(s for s in _segments(data) if s[2] == marker)
    return data[:a] + data[b:]


def _with_first(data: bytes, marker: int, payload: bytes) -> bytes:
    """``data`` with a segment inserted right after SOI."""
    return data[:2] + bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload + data[2:]


def _transform(data: bytes, t: int) -> bytes:
    """``data`` with its Adobe marker's transform byte set to ``t``."""
    a, _, _ = next(s for s in _segments(data) if s[2] == 0xEE)
    return data[:a + 4 + 11] + bytes([t]) + data[a + 4 + 12:]


JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _equal_pillow(data, host_decoder, tmp_path, space=None):  # noqa: F811
    """The host decoder and the plain chain, and ``imread_rgb`` on the CPU,
    against Pillow's RGB at 0 levels; returns the decoded coefficients."""
    c = jpeg.decode_coefficients(data, host_decoder)
    want = _pillow_rgb(data)
    got = jpeg.decode_reference(c).numpy()
    assert got.shape == want.shape and np.array_equal(got, want), np.abs(got.astype(int) - want).max()
    path = tmp_path / "image.jpg"
    path.write_bytes(data)
    assert np.array_equal(imread_rgb(str(path), "cpu").numpy(), want)
    if space is not None:
        assert c.space == space
    return c


def test_keep_rgb_64x48_equals_pillow(host_decoder, tmp_path):  # noqa: F811
    """The fault: Pillow's ``keep_rgb=True`` writes an Adobe marker with
    transform 0, IDs R, G, B and no JFIF marker; libjpeg reads the samples
    as RGB, and read as YCbCr they are up to 73 levels off. Now 0."""
    data = _pillow(_crop(64, 48), keep_rgb=True)
    kinds = [m for _, _, m in _segments(data)]
    assert 0xEE in kinds and 0xE0 not in kinds
    c = _equal_pillow(data, host_decoder, tmp_path, jpeg.RGB)
    as_ycc = jpeg.decode_reference(c._replace(space=jpeg.YCBCR)).numpy().astype(int)
    assert np.abs(as_ycc - _pillow_rgb(data)).max() >= 50  # the old reading, far off


def _colour_case(name):
    rgb = _crop(61, 45)
    keep = _pillow(rgb, keep_rgb=True)            # Adobe 0, IDs R, G, B
    ycc = _pillow(rgb)                            # JFIF, IDs 1, 2, 3
    cmyk = _pillow(rgb.convert("CMYK"))           # Adobe 0, IDs C, M, Y, K
    blocks = jpeg_writer.random_blocks(np.random.RandomState(3), 61, 45, [(1, 1)] * 3)
    return {
        "jfif_ycc": (ycc, jpeg.YCBCR),
        "jfif_and_adobe0_rgb_ids": (_with_first(keep, 0xE0, JFIF), jpeg.YCBCR),
        "short_app0_rgb_ids": (_with_first(keep, 0xE0, b"JFIF\x00\x01\x01"), jpeg.RGB),
        "adobe0_rgb_ids": (keep, jpeg.RGB),
        "adobe1_rgb_ids": (_transform(keep, 1), jpeg.YCBCR),
        "adobe2_rgb_ids": (_transform(keep, 2), jpeg.YCBCR),
        "no_marker_rgb_ids": (_without(keep, 0xEE), jpeg.RGB),
        "no_marker_ids_123": (_without(ycc, 0xE0), jpeg.YCBCR),
        "no_marker_other_ids": (jpeg_writer.encode_jpeg(61, 45, blocks, [(1, 1)] * 3, ids=(82, 71, 67)),
                                jpeg.YCBCR),
        "cmyk_adobe0": (cmyk, jpeg.CMYK),
        "cmyk_no_adobe": (_without(cmyk, 0xEE), jpeg.CMYK),
        "ycck_adobe2": (_transform(cmyk, 2), jpeg.YCCK),
        "ycck_adobe1": (_transform(cmyk, 1), jpeg.YCCK),
    }[name]


COLOUR_CASES = ["jfif_ycc", "jfif_and_adobe0_rgb_ids", "short_app0_rgb_ids", "adobe0_rgb_ids", "adobe1_rgb_ids",
                "adobe2_rgb_ids", "no_marker_rgb_ids", "no_marker_ids_123", "no_marker_other_ids", "cmyk_adobe0",
                "cmyk_no_adobe", "ycck_adobe2", "ycck_adobe1"]


@pytest.mark.parametrize("name", COLOUR_CASES)
def test_colour_space_branches(host_decoder, tmp_path, name):  # noqa: F811
    """Each branch of libjpeg's colour-space decision, with the space the
    host decoder reports and the Python decoder's own reading of the rule."""
    data, space = _colour_case(name)
    c = _equal_pillow(data, host_decoder, tmp_path, space)
    assert coefficients_python(data).space == space and np.array_equal(coefficients_python(data).coef, c.coef)


def test_cmyk_as_pillow_reads_it(host_decoder):  # noqa: F811
    """Pillow opens a CMYK JPEG as libjpeg's samples inverted (``CMYK;I``),
    and its ``cmyk2rgb`` is nk - MULDIV255(c, nk), nk = 255 - k, over every
    value of each channel against every K."""
    data = _pillow(_crop(61, 45).convert("CMYK"))
    c = jpeg.decode_coefficients(data, host_decoder)
    samples = np.stack([p.numpy() for p in jpeg.planes_reference(c)], -1)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "CMYK" and np.array_equal(np.asarray(im), 255 - samples)
    v, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    libjpeg = np.stack([v, 255 - v, (v * 7) % 256, k], -1).astype(np.uint8)  # libjpeg's CMYK samples
    inverted = Image.frombytes("CMYK", (256, 256), (255 - libjpeg).tobytes())
    got = jpeg.cmyk_to_rgb_reference(torch.from_numpy(libjpeg)).numpy()
    assert np.array_equal(got, np.asarray(inverted.convert("RGB")))


# (name, width, height, factors, writer options): the writer's files
SAMPLINGS = [
    ("411", 61, 45, [(4, 1), (1, 1), (1, 1)], {}),
    ("440", 61, 45, [(1, 2), (1, 1), (1, 1)], {"restart": 5}),
    ("4x2_over_1x1", 61, 45, [(4, 2), (1, 1), (1, 1)], {}),
    ("3x1_over_1x1", 37, 21, [(3, 1), (1, 1), (1, 1)], {}),
    ("luma_below_chroma", 37, 21, [(1, 1), (2, 2), (2, 1)], {}),
    ("mixed_chroma", 37, 21, [(2, 2), (1, 2), (2, 1)], {}),
    ("non_interleaved_420_restart", 61, 45, [(2, 2), (1, 1), (1, 1)], {"interleaved": False, "restart": 7}),
    ("non_interleaved_4x4_jfif", 37, 21, [(4, 4), (1, 1), (1, 1)], {"interleaved": False, "jfif": True}),
    ("ycck_420", 61, 45, [(2, 2), (1, 1), (1, 1), (2, 2)], {"adobe": 2}),
    ("cmyk_411_non_interleaved", 37, 21, [(4, 1), (1, 1), (1, 1), (4, 1)], {"adobe": 0, "interleaved": False}),
    ("rgb_ids_422", 37, 21, [(2, 1), (1, 1), (1, 1)], {"ids": (82, 71, 66)}),
    ("gray_2x2", 37, 21, [(2, 2)], {}),
    ("411_1x1", 1, 1, [(4, 1), (1, 1), (1, 1)], {}),
    ("440_1x1", 1, 1, [(1, 2), (1, 1), (1, 1)], {}),
    ("411_chroma_2_wide", 7, 9, [(4, 1), (1, 1), (1, 1)], {}),
    ("422_chroma_2_wide", 4, 9, [(2, 1), (1, 1), (1, 1)], {}),
    ("420_chroma_1_wide", 2, 3, [(2, 2), (1, 1), (1, 1)], {}),
]


def _written(name, w, h, factors, kw):
    blocks = jpeg_writer.random_blocks(np.random.RandomState(sum(map(ord, name))), w, h, factors)
    return blocks, jpeg_writer.encode_jpeg(w, h, blocks, factors, **kw)


def test_writer_held_to_python_decoder_and_pillow():
    """The writer on its own terms: the Python decoder of
    ``test_torch_jpeg.py`` reads back the coefficients it was given (a
    one-component scan codes the component's own blocks only), and Pillow
    reads its files as the plain chain reads the given coefficients."""
    for name, w, h, factors, kw in SAMPLINGS:
        blocks, data = _written(name, w, h, factors, kw)
        got = coefficients_python(data)
        assert [(k.h, k.v) for k in got.components] == factors, name
        for comp, b in zip(got.components, blocks):
            coded = b.copy()
            if not kw.get("interleaved", True) or len(factors) == 1:
                coded[-(-comp.height // 8):] = 0
                coded[:, -(-comp.width // 8):] = 0
            n = 64 * comp.blocks_w * comp.blocks_h
            assert np.array_equal(got.coef[comp.offset:comp.offset + n].reshape(coded.shape), coded), name
        given = got._replace(coef=np.concatenate([b.reshape(-1) for b in blocks]))
        assert np.array_equal(jpeg.decode_reference(given).numpy(), _pillow_rgb(data)), name


@pytest.mark.parametrize("name,w,h,factors,kw", SAMPLINGS, ids=[s[0] for s in SAMPLINGS])
def test_samplings_equal_pillow(host_decoder, tmp_path, name, w, h, factors, kw):  # noqa: F811
    """Every integer sampling ratio, narrow chroma planes, non-interleaved
    sequential scans, YCCK and CMYK at their own samplings: the host
    decoder's coefficients equal the Python decoder's, and the RGB Pillow's."""
    _, data = _written(name, w, h, factors, kw)
    c = _equal_pillow(data, host_decoder, tmp_path)
    ref = coefficients_python(data)
    assert c.components == ref.components and c.space == ref.space and np.array_equal(c.coef, ref.coef)


@pytest.mark.parametrize("subsampling", [1, 2])
def test_pillow_narrow_chroma(host_decoder, tmp_path, subsampling):  # noqa: F811
    """Pillow's 4:2:2 and 4:2:0 files 1 to 4 columns wide: chroma planes 1
    and 2 columns wide, which libjpeg upsamples by replication, and 3 and 4
    columns (4:2:0 at 3 wide: a 2-column plane)."""
    for w in (1, 2, 3, 4, 5):
        _equal_pillow(_pillow(_crop(w, 7), subsampling=subsampling, quality=90), host_decoder, tmp_path)


@pytest.mark.parametrize("size", [(61, 45), (640, 480)], ids=["61x45", "640x480"])
def test_progressive_cmyk_and_ycck(host_decoder, tmp_path, size):  # noqa: F811
    """Progressive CMYK files Pillow writes (an interleaved DC scan of 4
    components, then each band alone), and the same read as YCCK."""
    if size[0] < 640:
        img = _crop(*size).convert("CMYK")
    else:
        with Image.open(os.path.join(FIXTURE, "000010.jpg")) as im:
            img = im.convert("CMYK")
    data = _pillow(img, progressive=True)
    assert b"\xff\xc2" in data
    _equal_pillow(data, host_decoder, tmp_path, jpeg.CMYK)
    _equal_pillow(_transform(data, 2), host_decoder, tmp_path, jpeg.YCCK)


def _refused(name):
    zeros = lambda w, h, f: [np.zeros((bh, bw, 64), np.int16) for bh, bw in jpeg_writer.block_grid(w, h, f)]  # noqa
    if name == "12-bit":
        data = _pillow(_crop(17, 9))
        sof = data.index(b"\xff\xc0")
        return data[:sof + 4] + bytes([12]) + data[sof + 5:]
    factors = {"2 components": [(1, 1), (1, 1)], "fractional sampling ratio": [(3, 1), (2, 1), (2, 1)],
               "more than 10 blocks in an MCU": [(4, 4), (1, 1), (1, 1)]}[name]
    return jpeg_writer.encode_jpeg(17, 9, zeros(17, 9, factors), factors)


@pytest.mark.parametrize("reason", ["2 components", "fractional sampling ratio", "more than 10 blocks in an MCU",
                                    "12-bit"])
def test_refused_where_pillow_refuses(host_decoder, tmp_path, reason):  # noqa: F811
    """Where Pillow raises (at ``open`` or at decoding), the port raises
    ``ValueError`` with the reason, ``imread_rgb`` on the card with the path."""
    data = _refused(reason)
    with pytest.raises(OSError):
        _pillow_rgb(data)
    with pytest.raises(ValueError, match="not 8-bit" if reason == "12-bit" else reason):
        jpeg.decode_coefficients(data, host_decoder)


def _all_cases():
    """(name, bytes) of every file above, for the card."""
    out = [("keep_rgb_64x48", _pillow(_crop(64, 48), keep_rgb=True))]
    out += [(name, _colour_case(name)[0]) for name in COLOUR_CASES]
    out += [(s[0], _written(*s)[1]) for s in SAMPLINGS]
    out += [(f"pillow_{sub}_{w}", _pillow(_crop(w, 7), subsampling=sub, quality=90)) for sub in (1, 2)
            for w in (1, 2, 3, 4, 5)]
    cmyk = _pillow(_crop(61, 45).convert("CMYK"), progressive=True)
    return out + [("progressive_cmyk", cmyk), ("progressive_ycck", _transform(cmyk, 2))]


@pytest.mark.gpu
def test_card_decoder_on_colour_cases(tmp_path):
    """On a card: every file above through the host decoder, the IDCT and
    colour kernels against their plain versions, ``decode_jpeg`` and
    ``imread_rgb`` against Pillow, 0 levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for name, data in _all_cases():
        c = jpeg.decode_coefficients(data)
        planes = jpeg.planes_cuda(c, dev)
        host = [p.cpu() for p in planes]
        for got, plain in zip(host, jpeg.planes_reference(c)):
            assert torch.equal(got, plain), name
        rgb = jpeg.color_cuda(planes, c).cpu()
        assert torch.equal(rgb, jpeg.color_reference(host, c)), name
        want = _pillow_rgb(data)
        assert np.array_equal(jpeg.decode_jpeg(data, dev).cpu().numpy(), want), name
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        assert np.array_equal(imread_rgb(str(path), dev).cpu().numpy(), want), name
