"""The port's PNG decoder (``threedod_torch/ops/png.py``; its kernel in
``ops/csrc/png_decode.cu``) against Pillow's ``convert("RGB")``, on the CPU.

* files written with each filter type forced on every row and with a random
  filter a row (``encode_png``: numpy's forward filters, then ``zlib``), of
  every colour type at every bit depth it allows (1, 2, 4, 8, 16),
  interlaced (Adam7) and not, at 1x1, 3x5 (passes without rows) and 37x53,
  and files Pillow writes (gray, palette, RGB, RGBA, gray + alpha): the plain
  version, ``imread_rgb(path, "cpu")`` and ``image_hw`` equal Pillow with 0
  levels; the writer is first held to Pillow's own reading of its files;
* Pillow's conversions pinned value by value: 16-bit gray clamps at 255,
  16-bit colour keeps the high byte, 1-, 2- and 4-bit gray scale by 255, 85
  and 17;
* the forward and inverse filters against a byte-by-byte transliteration of
  the PNG specification's (section 9) definitions;
* the kernel's indexing (``layout``'s skewed channel planes, the bands'
  tagged carry rows, the shared ring and its stores) emulated in numpy
  against the plain version, for every colour type, depth and interlace;
* what the decoder refuses, each ``ValueError`` naming the file where a path
  was given: an unknown interlace method, a 16-bit palette, a palette image
  without PLTE, a bad CRC, a filter type past 4, a short IDAT, no
  signature; ``imread_rgb`` on a CUDA device refuses them before anything
  reaches the card;
* ``png_hw`` and ``image_io.image_hw`` against Pillow's sizes, ``read_png``
  on any file;
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
        (filtered,) = png.inflate(p)
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
    if case == "interlaced":  # Adam7 (method 1) is decoded; no other method exists
        data, match = _with_header(good, interlace=2), "interlace method 2"
    elif case == "16bit":  # 16-bit samples are decoded, but a palette has 1 to 8 bits
        data, match = _with_header(png.encode_png(px[..., :1].copy(), 0, 0), depth=16, color=3), "16-bit"
    elif case == "4bit_palette":  # a 4-bit palette file Pillow writes, its PLTE chunk taken out
        buf = io.BytesIO()
        Image.fromarray(px).convert("P", palette=Image.Palette.ADAPTIVE, colors=8).save(buf, "PNG", bits=4)
        full = buf.getvalue()
        assert full[24:26] == bytes([4, 3])  # IHDR: depth 4, colour type 3
        start = full.index(b"PLTE") - 4
        data, match = full[:start] + full[start + 12 + struct.unpack(">I", full[start:start + 4])[0]:], "PLTE"
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
    lay = png.layout(p, png.inflate(p))
    with pytest.raises(ValueError, match="CUDA"):
        png.unfilter_rgb_cuda(torch.from_numpy(lay.buf), lay, p)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        png.decode_png(png.encode_png(px, 2, 0), "meta")


# ---------------------------------------------------------------------------
# every colour type, bit depth and interlace
# ---------------------------------------------------------------------------

KINDS = [(ct, d, inter) for ct, depths in png.DEPTHS.items() for d in depths for inter in (False, True)]
KIND_IDS = [f"{png.COLOR_NAMES[ct]}{d}{'_adam7' if inter else ''}" for ct, d, inter in KINDS]


def _kind_pixels(color_type: int, depth: int, h: int, w: int, seed: int):
    """Random samples of a colour type at a bit depth, half of them a smooth
    ramp (so that predictions matter), with a palette of up to 200 entries."""
    rng = np.random.RandomState(seed)
    c, top = png.CHANNELS[color_type], 1 << depth
    ramp = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3) % top)[..., None]
    px = np.where(rng.rand(h, w, 1) < 0.5, ramp, rng.randint(0, top, (h, w, c)))
    px = px.astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.randint(0, 256, (min(200, top), 3)).astype(np.uint8) if color_type == 3 else None
    return px, palette


def _kind_file(color_type: int, depth: int, interlace: bool, h: int, w: int, seed: int):
    """(bytes, pixels, palette) of a file of a kind, a random filter a row."""
    px, palette = _kind_pixels(color_type, depth, h, w, seed)
    n_rows = sum(p.height for p in png.Png(w, h, color_type, depth, int(interlace), None, b"").passes())
    filters = np.random.RandomState(seed + 1).randint(0, 5, n_rows)
    return png.encode_png(px, color_type, filters, palette, bit_depth=depth, interlace=interlace), px, palette


SIZES = [(1, 1), (3, 5), (37, 53)]


@pytest.mark.parametrize("color_type,depth,interlace", KINDS, ids=KIND_IDS)
def test_writer_against_pillow(color_type, depth, interlace):
    """``encode_png``'s files read by Pillow (which reads Adam7 and every
    depth, but writes neither) give their source samples, at the precision
    Pillow keeps: its mode's own values, 16-bit colour and gray + alpha
    in their high bytes."""
    for i, (h, w) in enumerate(SIZES):
        data, px, palette = _kind_file(color_type, depth, interlace, h, w, seed=10 * i + depth)
        with Image.open(io.BytesIO(data)) as im:
            got = np.asarray(im)
            if color_type == 3:
                np.testing.assert_array_equal(np.asarray(im.getpalette()[:palette.size]), palette.reshape(-1))
        s = px.astype(np.int64)
        if color_type == 0:
            want = s[..., 0] if depth in (8, 16) else (s[..., 0] > 0 if depth == 1 else s[..., 0] * (255 // (2 ** depth - 1)))
        elif color_type == 3:
            want = s[..., 0]
        elif color_type == 4 and depth == 16:  # Pillow opens it as RGBA
            want = np.stack([s[..., 0] >> 8] * 3 + [s[..., 1] >> 8], -1)
        else:
            want = s >> 8 if depth == 16 else s
        assert got.shape == np.shape(want), (got.shape, np.shape(want))
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("color_type,depth,interlace", KINDS, ids=KIND_IDS)
def test_decoder_equals_pillow(color_type, depth, interlace, tmp_path):
    """The plain version, ``imread_rgb(path, "cpu")`` (what ``native_io``
    returns for these files) and ``image_hw`` against Pillow, at 1x1, 3x5
    (Adam7 passes without rows) and 37x53."""
    for i, (h, w) in enumerate(SIZES):
        data, _, _ = _kind_file(color_type, depth, interlace, h, w, seed=10 * i + depth + 1)
        want = _pillow(data)
        got = png.decode_png(data, "cpu")
        assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{h}x{w}")
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(image_io.imread_rgb(str(path), "cpu").numpy(), want)
        np.testing.assert_array_equal(read_png(str(path)), want)
        assert image_io.image_hw(str(path)) == (h, w)


def test_pillow_conversions_pinned():
    """Pillow's convert("RGB") value by value, and the plain version's."""
    def rgb(px, ct, depth, palette=None):
        data = png.encode_png(np.asarray(px, np.uint16 if depth == 16 else np.uint8)[None], ct, 0, palette,
                              bit_depth=depth)
        got, want = png.decode_png(data, "cpu").numpy()[0], _pillow(data)[0]
        np.testing.assert_array_equal(got, want)
        return want

    gray16 = [0, 255, 256, 1000, 65535, 0x1234]
    np.testing.assert_array_equal(rgb(np.array(gray16)[:, None], 0, 16)[:, 0], [0, 255, 255, 255, 255, 255])
    high = [0x1234, 0x12FF, 0x7F80, 0x00FF, 0xFF00]  # the high byte: 18, 18, 127, 0, 255; not a rounding
    np.testing.assert_array_equal(rgb(np.stack([high] * 3, -1), 2, 16)[:, 1], [18, 18, 127, 0, 255])
    np.testing.assert_array_equal(rgb(np.stack([high, high], -1), 4, 16)[:, 2], [18, 18, 127, 0, 255])
    np.testing.assert_array_equal(rgb(np.stack([high] * 4, -1), 6, 16)[:, 0], [18, 18, 127, 0, 255])
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        levels = np.arange(2 ** depth)
        np.testing.assert_array_equal(rgb(levels[:, None], 0, depth)[:, 0], levels * scale)
        palette = np.random.RandomState(depth).randint(0, 256, (2 ** depth, 3)).astype(np.uint8)
        np.testing.assert_array_equal(rgb(levels[:, None], 3, depth, palette), palette)


TAG = np.uint64(1 << 32)


def _emulate_kernel(lay: png.Layout, p: png.Png) -> np.ndarray:
    """png_decode.cu's indexing in numpy: the bands in ticket order, a band's
    32 lanes as vectors, its rows' skewed units read from ``lay.buf`` at the
    kernel's offsets, lane 0's upper units from the tagged carry words of the
    band above (a missing tag fails), every unit through the 64-slot ring
    swizzled by the row's parity (each slot stamped with its unit, so a store
    that reads a slot before its unit is made fails), stored LAG groups late."""
    buf = lay.buf.astype(np.int64)
    unit_b, depth, group, lag = lay.unit, p.depth, png.GROUP, 2
    spb_log2 = {1: 3, 2: 2, 4: 1}.get(depth, 0)
    scale = 255 // ((1 << depth) - 1) if depth < 8 else 1
    pal = lay.buf[lay.palette_offset:lay.palette_offset + 768].reshape(256, 3)
    carry = np.zeros(lay.carry_words, np.uint64)
    out = np.zeros((p.height, p.width, 3), np.uint8)
    lanes = np.arange(32)
    for band in range(lay.bands):
        k = max(j for j in range(len(lay.table)) if band >= lay.table[j][12])
        (in_off, ft_off, c_off, c_stride, pitch, units, height, width, x0, y0, dx, dy, first,
         channel) = (int(v) for v in lay.table[k])
        b = band - first
        row0, rows = b * 32, min(32, height - b * 32)
        has_prev, has_next = b > 0, b * 32 + 32 < height
        r = row0 + np.minimum(lanes, rows - 1)
        ftype = np.where(lanes < rows, buf[ft_off + r], 0)[:, None]
        groups = -(-(units + 31) // group)
        a, c, v = (np.zeros((32, unit_b), np.int64) for _ in range(3))
        ring = np.zeros((32, 64, unit_b), np.int64)
        stamp = np.full((32, 64), -10 ** 9)
        swz = (lanes & 1) << 4

        def flush(h):
            for row in range(rows):
                for kk in range(group << spb_log2):
                    unit, pix = h * group + (kk >> spb_log2), ((h * group) << spb_log2) + kk
                    if unit >= units or pix >= width:
                        continue
                    col = (unit & 63) ^ ((row & 1) << 4)
                    assert stamp[row, col] == unit, (band, row, unit, stamp[row, col])
                    byte = ring[row, col]
                    s = int(byte[0])
                    if spb_log2:
                        s = (s >> (8 - depth * ((kk & ((1 << spb_log2) - 1)) + 1))) & ((1 << depth) - 1)
                    o = out[y0 + (row0 + row) * dy, x0 + pix * dx]
                    if p.mode == png.MODE_CHANNEL:
                        o[channel] = byte[0]
                    elif p.mode == png.MODE_PALETTE:
                        o[:] = pal[s]
                    elif p.mode == png.MODE_GRAY16:
                        o[:] = min((int(byte[0]) << 8) | int(byte[1]), 255)
                    else:
                        o[:] = s * scale

        for g in range(groups):
            above = np.zeros((group, unit_b), np.int64)
            if has_prev:
                words = carry[c_off + (b - 1) * c_stride + g * group:][:group]
                for j in range(group):
                    if g * group + j < units:
                        assert words[j] >> np.uint64(32) != 0, "a carry word read before its tag"
                    above[j] = [int(words[j] >> np.uint64(8 * i)) & 255 for i in range(unit_b)]
            for j in range(group):
                x = g * group + j - lanes
                f = buf[in_off + r[:, None] * pitch + (g * group + j) * unit_b + np.arange(unit_b)[None]]
                up = np.roll(v, 1, axis=0)
                up[0] = above[j]
                pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
                pae = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
                pred = np.select([ftype == 1, ftype == 2, ftype == 3, ftype == 4], [a, up, (a + up) >> 1, pae], 0)
                v = (f + pred) & 255
                a, c = v, up
                slots = (x & 63) ^ swz
                ring[lanes, slots] = v
                stamp[lanes, slots] = x
                if has_next and 0 <= x[31] < units:
                    carry[c_off + b * c_stride + x[31]] = TAG | np.uint64(sum(int(v[31, i]) << (8 * i)
                                                                            for i in range(unit_b)))
            if g >= lag:
                flush(g - lag)
        for h in range(max(groups - lag, 0), groups):
            flush(h)
    return out


@pytest.mark.parametrize("color_type,depth,interlace", KINDS, ids=KIND_IDS)
def test_kernel_indexing_emulated(color_type, depth, interlace):
    """The kernel's indexing, emulated, equals the plain version: 3x5 and
    70x19 (three bands of a plane; Adam7's passes of 1 to 2 bands)."""
    for i, (h, w) in enumerate([(3, 5), (70, 19)]):
        data, _, _ = _kind_file(color_type, depth, interlace, h, w, seed=20 * i + depth + 2)
        p = png.parse(data)
        planes = png.inflate(p)
        lay = png.layout(p, planes)
        assert lay.buf.size % 16 == 0 and (lay.table[:, 0] % 16 == 0).all() and (lay.table[:, 4] % 16 == 0).all()
        np.testing.assert_array_equal(_emulate_kernel(lay, p), png.decode_reference(planes, p).numpy())


def _longest_path_loop(filter_types, units, latency):
    """The dependence graph's longest path, a unit at a time (the first
    row's upper units are constants)."""
    prev, longest = None, 0.0
    for f in filter_types:
        cur = []
        for x in range(units):
            left = cur[x - 1] if x else 0.0
            after_left = left + latency["row"][f] if f in (1, 3, 4) else 0.0
            if prev is None or f in (0, 1):
                cur.append(after_left)
                continue
            upper = max(prev[x], prev[x - 1] if x else 0.0) if f == 4 else prev[x]
            cur.append(max(after_left, upper + latency["hop"][f]))
        longest, prev = max([longest] + cur), cur
    return longest


LATENCY = {"row": {1: 2.5, 3: 9.0, 4: 21.0}, "hop": {2: 17.0, 3: 26.0, 4: 38.0}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dependence_path_equals_a_unit_by_unit_walk(seed):
    """``dependence_path_ns`` (the PNG kernel's dependence bound) against a
    walk over the units, on random filter types of 40 rows of 23 units; a
    file of Paeth rows is W row steps and H - 1 hops."""
    rng = np.random.RandomState(seed)
    ftypes = rng.randint(0, 5, 40)
    np.testing.assert_allclose(png.dependence_path_ns(ftypes, 23, LATENCY), _longest_path_loop(ftypes, 23, LATENCY),
                               rtol=1e-12)
    np.testing.assert_allclose(png.dependence_path_ns([4] * 40, 23, LATENCY), 23 * 21.0 + 39 * 38.0, rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("color_type,depth,interlace", KINDS, ids=KIND_IDS)
def test_card_kernel_every_kind(color_type, depth, interlace):
    """On a card: the kernel against the plain version at 1x1, 3x5, 37x53
    and 1242x375 for every colour type, depth and interlace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for i, (h, w) in enumerate(SIZES + [(375, 1242)]):
        data, _, _ = _kind_file(color_type, depth, interlace, h, w, seed=30 * i + depth)
        p = png.parse(data)
        planes = png.inflate(p)
        np.testing.assert_array_equal(png.decode_png(data, dev).cpu().numpy(), png.decode_reference(planes, p).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("color_type", COLOR_TYPES, ids=lambda c: png.COLOR_NAMES[c])
def test_card_kernel_equals_plain_and_pillow(color_type, tmp_path):
    """On a card: the kernel at 1242x375 (12 bands) and 37x2100 rows (66
    bands) against the plain version and Pillow, each filter forced and a
    random filter a row; ``imread_rgb`` too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    for h, w in ((375, 1242), (2100, 37)):
        px, palette = _pixels(color_type, h, w, seed=h)
        for filters in (0, 1, 2, 3, 4, np.random.RandomState(6).randint(0, 5, h)):
            data = png.encode_png(px, color_type, filters, palette)
            p = png.parse(data)
            planes = png.inflate(p)
            lay = png.layout(p, planes)
            got = png.unfilter_rgb_cuda(torch.from_numpy(lay.buf).to(dev), lay, p).cpu().numpy()
            np.testing.assert_array_equal(got, png.decode_reference(planes, p).numpy())
            np.testing.assert_array_equal(got, _pillow(data))
        path = tmp_path / "x.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(image_io.imread_rgb(str(path), dev).cpu().numpy(), _pillow(data))
