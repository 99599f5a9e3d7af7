"""The port's PNG decoder (``threedod_torch/ops/png.py``; its kernel in
``ops/csrc/png_decode.cu``) against Pillow's ``convert("RGB")``, on the CPU.

* files written with each filter type forced on every row and with a random
  filter a row (``encode_png``: numpy's forward filters, then ``zlib``), of
  every colour type, and files Pillow writes (gray, palette, RGB, RGBA,
  gray + alpha): the plain version equals Pillow with 0 levels;
* the forward and inverse filters against a byte-by-byte transliteration of
  the PNG specification's (section 9) definitions;
* what the decoder refuses, each ``ValueError`` naming the file where a path
  was given: interlaced, 16-bit, 4-bit palette, a bad CRC, a filter type
  past 4, a short IDAT, no signature; ``imread_rgb`` on a CUDA device
  refuses them before anything reaches the card;
* ``png_hw`` and ``image_io.image_hw`` against Pillow's sizes, ``read_png``
  on any 8-bit file;
* on a card (``gpu``, skipped here): the kernel against the plain version
  and Pillow.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from threedod_torch.data import image_io
from threedod_torch.ops import png
from threedod_torch.vis import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "datasets", "synth", "images")
COLOR_TYPES = [0, 2, 3, 4, 6]


def _pixels(color_type: int, h: int = 23, w: int = 31, seed: int = 0):
    """Random pixels of a colour type with smooth parts (so predictions
    matter) and a palette of 200 entries (indices past it are black)."""
    rng = np.random.RandomState(seed)
    c = png.CHANNELS[color_type]
    ramp = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3) % 256)[..., None]
    px = np.where(rng.rand(h, w, 1) < 0.5, ramp, rng.randint(0, 256, (h, w, c))).astype(np.uint8)
    return px, (rng.randint(0, 256, (200, 3)).astype(np.uint8) if color_type == 3 else None)


def _pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _spec_unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """PNG specification 9.2 and 9.4, byte by byte in Python."""
    h, n = filtered.shape
    out = np.zeros((h, n - 1), np.int64)
    for r in range(h):
        ftype = int(filtered[r, 0])
        for i in range(n - 1):
            x = int(filtered[r, 1 + i])
            a = int(out[r, i - bpp]) if i >= bpp else 0
            b = int(out[r - 1, i]) if r else 0
            c = int(out[r - 1, i - bpp]) if r and i >= bpp else 0
            if ftype == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[ftype]
            out[r, i] = (x + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("color_type", COLOR_TYPES, ids=lambda c: png.COLOR_NAMES[c])
def test_forced_filters_equal_pillow(color_type):
    px, palette = _pixels(color_type)
    rows = np.random.RandomState(1).randint(0, 5, px.shape[0])
    for filters in (0, 1, 2, 3, 4, rows):
        data = png.encode_png(px, color_type, filters, palette)
        p = png.parse(data)
        filtered = png.inflate(p)
        assert (filtered[:, 0] == np.broadcast_to(filters, (px.shape[0],))).all()
        got = png.decode_png(data, "cpu")
        assert got.dtype == torch.uint8 and got.shape == (*px.shape[:2], 3)
        np.testing.assert_array_equal(got.numpy(), _pillow(data), err_msg=f"filters {filters}")


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA", "LA"])
def test_pillow_written_files(mode, tmp_path):
    with Image.open(os.path.join(FIXTURE, "000003.jpg")) as im:
        img = im.convert("RGB").crop((0, 0, 97, 61)).convert(mode)
    if mode in ("RGBA", "LA"):
        img.putalpha(Image.fromarray(np.random.RandomState(2).randint(0, 256, (61, 97)).astype(np.uint8)))
    path = str(tmp_path / "x.png")
    img.save(path)
    with open(path, "rb") as f:
        data = f.read()
    assert png.parse(data).color_type == {"L": 0, "P": 3, "RGB": 2, "RGBA": 6, "LA": 4}[mode]
    want = _pillow(data)
    np.testing.assert_array_equal(png.decode_png(data, "cpu").numpy(), want)
    np.testing.assert_array_equal(read_png(path), want)
    assert image_io.image_hw(path) == (61, 97)


def test_filters_against_the_specification():
    rng = np.random.RandomState(3)
    for bpp in (1, 2, 3, 4):
        raw = rng.randint(0, 256, (9, 7 * bpp)).astype(np.uint8)
        filtered = png.filter_rows(raw, bpp, rng.randint(0, 5, 9))
        np.testing.assert_array_equal(_spec_unfilter(filtered, bpp), raw)
        np.testing.assert_array_equal(png.unfilter_reference(filtered, bpp), raw)
        noise = np.concatenate([rng.randint(0, 5, (9, 1)), rng.randint(0, 256, (9, 7 * bpp))], 1).astype(np.uint8)
        np.testing.assert_array_equal(png.unfilter_reference(noise, bpp), _spec_unfilter(noise, bpp))


def test_palette_index_past_the_palette_is_black():
    idx = np.arange(256, dtype=np.uint8).reshape(16, 16)
    palette = np.random.RandomState(4).randint(0, 256, (5, 3)).astype(np.uint8)
    data = png.encode_png(idx, 3, 4, palette)
    got = png.decode_png(data, "cpu").numpy().reshape(256, 3)
    np.testing.assert_array_equal(got, _pillow(data).reshape(256, 3))
    np.testing.assert_array_equal(got[:5], palette)
    assert not got[5:].any()


def _with_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (its CRC made anew)."""
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(width=w, height=h, depth=depth, color=color, comp=comp, filt=filt, interlace=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *vals.values())
    return data[:8] + png._chunk(b"IHDR", body) + data[33:]


@pytest.mark.parametrize("case", ["interlaced", "16bit", "4bit_palette", "crc", "filter_type", "short", "signature"])
def test_refused_files_raise_with_their_path(case, tmp_path):
    px, _ = _pixels(2)
    good = png.encode_png(px, 2, 1)
    if case == "interlaced":
        data, match = _with_header(good, interlace=1), "interlaced"
    elif case == "16bit":
        buf = io.BytesIO()
        Image.fromarray(px[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
        data, match = buf.getvalue(), "16-bit"
    elif case == "4bit_palette":
        buf = io.BytesIO()
        Image.fromarray(px).convert("P", palette=Image.Palette.ADAPTIVE, colors=8).save(buf, "PNG", bits=4)
        data, match = buf.getvalue(), "[124]-bit"
    elif case == "crc":
        data, match = good[:40] + bytes([good[40] ^ 1]) + good[41:], "bad CRC"
    elif case == "filter_type":
        rows = png.filter_rows(px.reshape(23, -1), 3, 0)
        rows[5, 0] = 5
        data = good[:33] + png._chunk(b"IDAT", zlib.compress(rows.tobytes())) + png._chunk(b"IEND", b"")
        match = "filter type 5"
    elif case == "short":
        data = good[:33] + png._chunk(b"IDAT", zlib.compress(b"\0" * 10)) + png._chunk(b"IEND", b"")
        match = "fewer than"
    else:
        data, match = b"GIF89a" + good[6:], "not a PNG"
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        png.decode_png(data, "cpu")
    with pytest.raises(ValueError, match=f"{case}.png"):
        read_png(str(path))
    with pytest.raises(ValueError, match=f"{case}.png"):  # refused on the host, before any copy to a card
        image_io.imread_rgb(str(path), torch.device("cuda"))


def test_sizes_from_ihdr(tmp_path):
    for i, (h, w) in enumerate([(375, 1242), (1, 1), (480, 640)]):
        path = tmp_path / f"{i}.png"
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(path)
        with open(path, "rb") as f:
            assert png.png_hw(f) == (h, w)
        assert image_io.image_hw(str(path)) == (h, w)
    (tmp_path / "cut.png").write_bytes((tmp_path / "0.png").read_bytes()[:20])
    with pytest.raises(ValueError, match="cut.png"):
        image_io.image_hw(str(tmp_path / "cut.png"))


def test_fixture_image_round_trip_at_its_size():
    """A fixture image at 640x480, a random filter a row, decoded by the
    plain version: Pillow's pixels, which are the JPEG's."""
    with Image.open(os.path.join(FIXTURE, "000005.jpg")) as im:
        rgb = np.asarray(im.convert("RGB"))
    data = png.encode_png(rgb, 2, np.random.RandomState(5).randint(0, 5, rgb.shape[0]))
    np.testing.assert_array_equal(png.decode_png(data, "cpu").numpy(), rgb)
    np.testing.assert_array_equal(_pillow(data), rgb)


def test_kernel_refuses_cpu_tensors_and_bad_shapes():
    px, _ = _pixels(2)
    p = png.parse(png.encode_png(px, 2, 0))
    with pytest.raises(ValueError, match="CUDA"):
        png.unfilter_rgb_cuda(torch.from_numpy(png.inflate(p).copy()), p)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        png.decode_png(png.encode_png(px, 2, 0), "meta")


@pytest.mark.gpu
@pytest.mark.parametrize("color_type", COLOR_TYPES, ids=lambda c: png.COLOR_NAMES[c])
def test_card_kernel_equals_plain_and_pillow(color_type, tmp_path):
    """On a card: the kernel at 1242x375 (one band) and 37x2100 rows
    (three bands of up to 1024 rows) against the plain version and Pillow,
    each filter forced and a random filter a row; ``imread_rgb`` too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for h, w in ((375, 1242), (2100, 37)):
        px, palette = _pixels(color_type, h, w, seed=h)
        for filters in (0, 1, 2, 3, 4, np.random.RandomState(6).randint(0, 5, h)):
            data = png.encode_png(px, color_type, filters, palette)
            p = png.parse(data)
            filtered = png.inflate(p)
            got = png.unfilter_rgb_cuda(torch.from_numpy(filtered.copy()).to(dev), p).cpu().numpy()
            np.testing.assert_array_equal(got, png.decode_reference(filtered, p).numpy())
            np.testing.assert_array_equal(got, _pillow(data))
        path = tmp_path / "x.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(image_io.imread_rgb(str(path), dev).cpu().numpy(), _pillow(data))
