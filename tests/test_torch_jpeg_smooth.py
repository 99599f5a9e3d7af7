"""Block smoothing of incomplete progressive JPEGs: libjpeg-turbo (2.1 and
later, jdcoefct.c ``decompress_smooth_data``) estimates the low-frequency
coefficients whose bits a progressive file never sends from the stored DCs
of the 5x5 blocks around each block. The host decoder hands each
component's known bits (``Coefficients.smooth``) with the coefficients, and
``jpeg.smooth_reference`` (the smoothing instance of the IDCT kernel's
plain version) smooths a copy of the blocks before the IDCT.

* ``smooth_loop``, a loop transliteration of decompress_smooth_data (a 5x5
  window of stored DCs a block, libjpeg's sums, its rounding and its clamp),
  equals ``smooth_reference`` on seeded coefficient grids of 1x1, 1x3, 2x2
  and 5x7 blocks at vertical factors 1 to 4, with padding rows and
  columns, DC-only, partial and random coef_bits.
* Impulse files (``tools/jpeg_writer.py``: one large DC among zero or
  constant DCs, with chosen quantization tables): DC-only, DC at Al 2,
  partial AC bands and AC at Al 1 and 3 left unrefined decode as Pillow
  (12.1, libjpeg-turbo 3.1) does, 0 levels, and unsmoothed they do not; a
  change of any one weight of any sum by one, of the rounding or of the
  clamp makes the loop differ from Pillow on one of them, so the files pin
  every sum on its own.
* The window's edges: one large DC at every stored row (padding rows
  included) of 4:2:0-like frames at vertical factors 1 to 4 with partial
  last iMCU rows, and in a padding column: Pillow's pixels, 0 levels, where
  three other rules for row r + 2 and the columns each differ.
* Whole images: fixture images written progressive by Pillow at quality 90
  at 640x480 (RGB 4:2:0, 4:4:4, gray, CMYK) and a 633x465 crop at 4:2:0, cut
  to their DC scans, without their AC refinements, or without the first
  component's last refinement, and arithmetic transcodes of two: through the
  host decoder built by the host's compiler (``test_torch_jpeg.
  host_decoder``) and the plain chain, equal to Pillow's ``convert("RGB")``
  and to the JAX package's own reader (``threedod.data.native_io.
  imread_rgb``, the system's libjpeg-turbo), each after its unsmoothed
  decode is shown to differ.
The ``gpu`` test holds the kernel's smoothing instance to its plain version,
and ``decode_jpeg`` to Pillow, on the card; the kernel's weight tables are
held to ``jpeg.SMOOTH_AC`` and ``SMOOTH_DC_ONLY`` here.
"""
from __future__ import annotations

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_jpeg import CSRC, FIXTURE, host_decoder  # noqa: F401  (the fixture)

from threedod_torch.ops import jpeg
from threedod_torch.tools import jpeg_writer as writer

# decompress_smooth_data's sums, as its C code writes them: {zig-zag place:
# {window index 1 to 25 (DC01 to DC25, rows r - 2 to r + 2): weight}}; AC
# where some AC scan reached the component, DC_ONLY where none did
AC = {1: {11: -7, 12: 50, 14: -50, 15: 7}, 2: {3: -7, 8: 50, 18: -50, 23: 7},
      3: {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
      4: {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10, 9: -10},
      5: {11: -1, 12: 13, 13: -24, 14: 13, 15: -1}}
DC_ONLY = {
    1: {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3, 16: -3, 17: 13,
        19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1},
    2: {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13, 18: -38, 19: -13,
        20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1},
    3: {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1},
    4: {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    5: {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2},
    6: {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}, 7: {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    8: {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}, 9: {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1},
    0: {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8, 12: 42, 13: 152, 14: 42,
        15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2}}
NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)  # Q00_POS, Q01_POS, Q10_POS, ... Q30_POS


def predict(num: int, q: int, al: int, dc: bool = False) -> int:
    """pred of one estimate: ((Qk << 7) + |num|) / (Qk << 8), clamped to
    (1 << Al) - 1 where Al > 0 (an AC estimate's), the sign of num put
    back."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if not dc and al > 0 and pred >= 1 << al:
        pred = (1 << al) - 1
    return pred if num >= 0 else -pred


def smooth_loop(blocks, quant, coef_bits, component, ac=AC, dc_only=DC_ONLY, estimate=predict):
    """decompress_smooth_data for one component as loops, one (JCOEF)
    workspace a block: (blocks_h, blocks_w, 64) int16 -> the smoothed copy.
    Per iMCU row and block row of the component's own blocks, the rows of
    the window are r - 2 and r - 1 (or r at the top edge), r, r + 1 (or r
    at the bottom of the last iMCU row) and r + 2 where the iMCU row is not
    the last or the row lies inside its block rows, and the stored grid
    holds it (padding rows included), else the r + 1 row; the columns slide
    over the component's own width, the edge column repeated. ``ac``,
    ``dc_only`` and ``estimate`` are the sums and the rounding (the tests
    change them to show the files pin each)."""
    bh = blocks.shape[0]
    v = component.v
    rows, cols = -(-component.height // 8), -(-component.width // 8)
    last = bh // v - 1
    change_dc = all(b == -1 for b in coef_bits[1:10])
    sums = dc_only if change_dc else ac
    out = blocks.copy()
    for imcu in range(last + 1):
        block_rows = v if imcu < last else (rows % v or v)
        for block_row in range(block_rows):
            r = imcu * v + block_row
            prev = r - 1 if r > 0 else r
            prev_prev = r - 2 if r > 1 else prev
            nxt = r + 1 if block_row < block_rows - 1 or imcu < last else r
            nxt_nxt = r + 2 if (block_row < block_rows - 2 or imcu < last) and r + 2 < bh else nxt
            for c in range(cols):
                dc = [0] + [int(blocks[y, min(max(c + d, 0), cols - 1), 0])
                            for y in (prev_prev, prev, r, nxt, nxt_nxt) for d in (-2, -1, 0, 1, 2)]
                work = out[r, c]
                for k, terms in sums.items():
                    num = int(quant[0]) * sum(w * dc[j] for j, w in terms.items())
                    if k == 0:
                        work[0] = np.int64(estimate(num, int(quant[0]), coef_bits[0], dc=True)).astype(np.int16)
                    elif coef_bits[k] != 0 and blocks[r, c, NATURAL[k]] == 0:
                        work[NATURAL[k]] = np.int64(estimate(num, int(quant[NATURAL[k]]), coef_bits[k])).astype(
                            np.int16)
    return out


def decode_loop(c: jpeg.Coefficients, **kw) -> np.ndarray:
    """The plain chain with ``smooth_loop`` in place of ``smooth_reference``."""
    blocks = [smooth_loop(b, c.quant[k].astype(np.int64), c.smooth[k], comp, **kw)
              for k, (comp, b) in enumerate(zip(c.components, c.blocks()))]
    return jpeg.decode_reference(c._replace(coef=np.concatenate([b.reshape(-1) for b in blocks]), smooth=None)).numpy()


def pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def unsmoothed(c: jpeg.Coefficients) -> np.ndarray:
    return jpeg.decode_reference(c._replace(smooth=None)).numpy()


# ---------------------------------------------------------------------------
# the plain version against the loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v", [1, 2, 3, 4])
@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 3), (2, 2), (5, 7)])
def test_smooth_reference_equals_loop(rows, cols, v):
    """Seeded grids of a component's own rows x cols blocks inside an
    MCU-padded grid (vertical factor v, horizontal 2, so padding rows and
    columns), with DC-only coef_bits, partial ones (some places -1, some 0,
    some Al > 0), and DCs and tables large enough that estimates wrap to
    int16: ``smooth_reference`` equals ``smooth_loop``, padding untouched."""
    rng = np.random.RandomState(rows * 100 + cols * 10 + v)
    bh, bw = v * -(-rows // v), 2 * -(-cols // 2)
    comp = jpeg.Component(2, v, bw, bh, cols * 8 - rng.randint(8), rows * 8 - rng.randint(8), 0)
    for trial in range(8):
        big = trial == 7
        blocks = (rng.randint(-2047 if big else -60, 2048 if big else 61, (bh, bw, 64))
                  * (rng.rand(bh, bw, 64) < 0.3)).astype(np.int16)
        quant = rng.randint(1, 256, 64)
        if big:
            quant[list(NATURAL[1:])] = 1
            quant[0] = 255
        bits = rng.randint(-1, 5, 10)
        bits[0] = rng.randint(0, 3)
        if trial % 3 == 0:
            bits[1:] = -1  # DC only
        got = jpeg.smooth_reference(torch.from_numpy(blocks), torch.from_numpy(quant), bits, comp).numpy()
        want = smooth_loop(blocks, quant, bits, comp)
        assert np.array_equal(got, want), (trial, bits)
        assert np.array_equal(got[rows:], blocks[rows:]) and np.array_equal(got[:, cols:], blocks[:, cols:])


def test_reference_tables_are_the_loops():
    """``jpeg.SMOOTH_AC`` and ``SMOOTH_DC_ONLY`` hold the sums above, and
    the kernel's ``SMOOTH_WEIGHTS`` (``csrc/jpeg_decode.cu``) holds the
    same numbers."""
    for table, sums in ((jpeg.SMOOTH_AC, AC), (jpeg.SMOOTH_DC_ONLY, DC_ONLY)):
        want = np.zeros((10, 25), np.int64)
        for k, terms in sums.items():
            for j, w in terms.items():
                want[k, j - 1] = w
        assert np.array_equal(table, want)
    with open(os.path.join(CSRC, "jpeg_decode.cu")) as f:
        source = f.read()
    body = source[source.index("SMOOTH_WEIGHTS[2]"):]
    body = body[body.index("{"):body.index("};")]
    rows = [[int(x) for x in re.findall(r"-?\d+", row)] for row in re.findall(r"\{([-\d, ]*)\}", body)]
    kernel = np.array([row + [0] * (25 - len(row)) for row in rows]).reshape(2, 10, 25)
    assert np.array_equal(kernel[0], jpeg.SMOOTH_AC) and np.array_equal(kernel[1], jpeg.SMOOTH_DC_ONLY)
    natural = re.search(r"SMOOTH_NATURAL\[jpeg::SAVED_COEFS\] = \{([\d, ]*)\}", source).group(1)
    assert tuple(int(x) for x in natural.split(",")) == NATURAL == jpeg.SMOOTH_NATURAL


def test_host_hands_the_known_bits(host_decoder):  # noqa: F811
    """``Coefficients.smooth``: each component's coef_bits of zig-zag places
    0 to 9 where libjpeg smooths (a DC-only file: the DC scan's Al and -1;
    without the luma's last refinement: 1 for its AC places), and None for
    a whole progression and a sequential file."""
    data = _progressive("000004.jpg", "RGB", 2, (3, 5, 64, 50))
    scans = writer.scans(data)
    assert jpeg.decode_coefficients(data, host_decoder).smooth is None
    dc_only = jpeg.decode_coefficients(writer.incomplete(data, "dc_only"), host_decoder).smooth
    assert dc_only.tolist() == [[0] + [-1] * 9] * 3  # libjpeg's script: the DC at Al 1, then refined
    last = jpeg.decode_coefficients(writer.without_scans(data, [len(scans) - 1]), host_decoder).smooth
    assert last.tolist() == [[0] + [1] * 9, [0] * 10, [0] * 10]
    with open(os.path.join(FIXTURE, "000004.jpg"), "rb") as f:
        assert jpeg.decode_coefficients(f.read(), host_decoder).smooth is None


# ---------------------------------------------------------------------------
# impulse files: every sum, the rounding and the clamp against Pillow
# ---------------------------------------------------------------------------

# (scans of one gray component, pinned form): DC-only, DC-only with the DC at
# Al 2 (unrefined), AC places 9 to 63 sent (places 1 to 8 estimated with no
# clamp), and every AC place at Al 1 or 3, unrefined (the clamp)
IMPULSE_FORMS = {
    "dc_only_al2": [((0,), 0, 0, 0, 2)], "ac_al1": [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 1)],
    "dc_only": [((0,), 0, 0, 0, 0)], "partial": [((0,), 0, 0, 0, 0), ((0,), 9, 63, 0, 0)],
    "ac_al3": [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 3)],
}
# (impulse, Q00, the AC tables' value, the other DCs): scales 5/8 to 1/2 of
# a weight an estimate, on a constant field of -30 or -100 or on zeros,
# rounded halves (128 Q00 = 128 Qk 8)
IMPULSE_SCALES = [(60, 16, 6, -30), (200, 4, 3, -100), (128, 8, 8, 0), (-100, 8, 8, 0)]


def impulse(form: str, value: int, q00: int, qac: int, base: int, at=(3, 3), n: int = 7) -> bytes:
    """A gray n x n-block arithmetic-coded progressive JPEG of ``form``'s
    scans: DC ``base`` everywhere but ``base + value`` at block ``at``, no
    AC, quantization table ``qac`` with Q00 ``q00``."""
    quant = np.full(64, qac)
    quant[0] = q00
    blocks = np.zeros((n, n, 64), np.int16)
    blocks[..., 0] = base
    blocks[at + (0,)] = base + value
    return writer.encode_jpeg(8 * n, 8 * n, [blocks], [(1, 1)], arithmetic=True, scans=IMPULSE_FORMS[form],
                              quant=(quant, quant))


@pytest.fixture(scope="module")
def impulses(host_decoder):  # noqa: F811
    """{form: [(coefficients, Pillow's RGB)]} of every impulse file."""
    out = {}
    for form in IMPULSE_FORMS:
        out[form] = []
        for scale in IMPULSE_SCALES:
            data = impulse(form, *scale)
            out[form].append((jpeg.decode_coefficients(data, host_decoder), pillow(data)))
    return out


@pytest.mark.parametrize("form", list(IMPULSE_FORMS))
def test_impulse_files_equal_pillow(impulses, form):
    """Every impulse file of ``form``: smoothed, its plain decode is
    Pillow's at 0 levels, and so is the loops'; unsmoothed it is not."""
    for c, want in impulses[form]:
        assert c.smooth is not None
        assert not np.array_equal(unsmoothed(c), want)
        assert np.array_equal(jpeg.decode_reference(c).numpy(), want)
        assert np.array_equal(decode_loop(c), want)


def _mutants():
    """(name, smooth_loop options) of every change of one weight by one, of
    the rounding and of the clamp."""
    for name, sums, key in (("AC", AC, "ac"), ("DC_ONLY", DC_ONLY, "dc_only")):
        for k, terms in sums.items():
            for j in terms:
                for delta in (1, -1):
                    changed = {kk: dict(t) for kk, t in sums.items()}
                    changed[k][j] += delta
                    yield f"{name}[{k}][DC{j:02d}] {delta:+d}", {key: changed}

    def floor(num, q, al, dc=False):  # no half added
        pred = abs(num) // (q << 8)
        pred = min(pred, (1 << al) - 1) if al > 0 and not dc else pred
        return pred if num >= 0 else -pred

    def signed_floor(num, q, al, dc=False):  # rounded toward minus infinity, not away from 0
        pred = ((q << 7) + num) // (q << 8)
        return max(min(pred, (1 << al) - 1), 1 - (1 << al)) if al > 0 and not dc else pred

    def clamp_high(num, q, al, dc=False):  # clamped to 1 << Al
        pred = ((q << 7) + abs(num)) // (q << 8)
        pred = min(pred, 1 << al) if al > 0 and not dc else pred
        return pred if num >= 0 else -pred

    def dc_clamped(num, q, al, dc=False):  # the DC clamped too, by the DC scans' Al
        return predict(num, q, al)

    for fn in (floor, signed_floor, clamp_high, dc_clamped):
        yield fn.__name__, {"estimate": fn}


def test_impulse_files_pin_every_sum(impulses):
    """Each change of the loops (one weight of one sum by plus or minus
    one, the rounding toward zero or toward minus infinity, the clamp at 1
    << Al, the DC clamped) makes them differ from Pillow on some impulse
    file: together the files pin every sum on its own, the rounding and the
    clamp."""
    files = [f for fs in impulses.values() for f in fs]
    missed = []
    for name, kw in _mutants():
        if not any(not np.array_equal(decode_loop(c, **kw), want) for c, want in files):
            missed.append(name)
    assert not missed


# ---------------------------------------------------------------------------
# the window's edges
# ---------------------------------------------------------------------------

# (vertical factor, height, whether each other rule of ``_OTHER_RULES``
# differs from Pillow on the frame's files): luma at (2, v) over two 1x1
# chroma components, 40 pixels wide (5 own block columns of 6 stored). The
# first rule differs where the last iMCU row holds 3 or more own rows, the
# second where it holds 1 and padding rows follow, the third everywhere, the
# fourth where v > 1.
EDGE_FRAMES = [(1, 44, (False, False, True, False)), (2, 36, (False, True, True, True)),
               (3, 52, (False, True, True, True)), (3, 44, (True, False, True, True)),
               (4, 84, (True, False, True, True))]


def _edge_files(v: int, height: int) -> list:
    """(Coefficients, Pillow's RGB) of one large luma DC at each stored row
    (padding rows included) of column 4 (the last own column), and at row 0
    and the last own row of column 5 (a padding column), DC-only and with
    every AC at Al 1, unrefined."""
    factors = [(2, v), (1, 1), (1, 1)]
    grid = writer.block_grid(40, height, factors)
    rows = -(-height // 8)
    spots = [(r, 4) for r in range(grid[0][0])] + [(0, 5), (rows - 1, 5)]
    out = []
    for scans in ([((0, 1, 2), 0, 0, 0, 0)], [((0, 1, 2), 0, 0, 0, 0)] + [((k,), 1, 63, 0, 1) for k in range(3)]):
        for at in spots:
            blocks = [np.zeros((bh, bw, 64), np.int16) for bh, bw in grid]
            blocks[0][at + (0,)] = 60
            data = writer.encode_jpeg(40, height, blocks, factors, arithmetic=True, scans=scans)
            out.append((jpeg.decode_coefficients(data), pillow(data)))
    return out


def _r1_in_last_imcu_row(component, device=None):
    """Row r + 2 from the stored grid only while r's iMCU row is not the
    last, else r + 1 (it agrees with Pillow at v 1 and 2 only)."""
    window_rows, window_cols = RIGHT_WINDOW(component, device)
    r = window_rows[:, 2]
    last = r // component.v == component.blocks_h // component.v - 1
    window_rows[:, 4] = torch.where(last, window_rows[:, 3], window_rows[:, 4])
    return window_rows, window_cols


def _clamped_rows(component, device=None):
    """Row r + 2 clamped to the component's own rows, padding never read."""
    window_rows, window_cols = RIGHT_WINDOW(component, device)
    window_rows[:, 4] = (window_rows[:, 2] + 2).clamp(max=len(window_rows) - 1)
    return window_rows, window_cols


def turbo21_rows(component, device=None):
    """Row r + 2 as the system's libjpeg-turbo 2.1.5 reads it: from the
    stored grid where r + 2 lies in r's own iMCU row or r's iMCU row is
    before the last but one; else r + 1, clamped (Pillow's 3.1 reads r + 2
    at the last but one too)."""
    window_rows, window_cols = RIGHT_WINDOW(component, device)
    r = window_rows[:, 2]
    rows, v, imcus = len(window_rows), component.v, component.blocks_h // component.v
    block_rows = torch.where(r // v < imcus - 1, v, rows % v if rows % v else v)
    inside = (r % v < block_rows - 2) | (r // v + 1 < imcus - 1)
    window_rows[:, 4] = torch.where(inside, window_rows[:, 4], window_rows[:, 3])
    return window_rows, window_cols


def _stored_columns(component, device=None):
    """Columns clamped to the stored (MCU-padded) width."""
    window_rows, window_cols = RIGHT_WINDOW(component, device)
    cols = torch.arange(len(window_cols))[:, None] + torch.arange(-2, 3)
    return window_rows, cols.clamp(0, component.blocks_w - 1)


RIGHT_WINDOW = jpeg.smooth_window
_OTHER_RULES = (_r1_in_last_imcu_row, _clamped_rows, _stored_columns, turbo21_rows)


@pytest.mark.parametrize("v,height,refuted", EDGE_FRAMES)
def test_window_edges_equal_pillow(host_decoder, monkeypatch, v, height, refuted):  # noqa: F811
    """One large DC at every stored row and at a padding column of a frame
    with vertical factor v: every file is Pillow's, 0 levels; where another
    rule for row r + 2 or for the columns would read other blocks on these
    files, it differs from Pillow."""
    monkeypatch.setattr(jpeg, "_lib", lambda: host_decoder)
    files = _edge_files(v, height)
    for c, want in files:
        assert c.smooth is not None and np.array_equal(jpeg.decode_reference(c).numpy(), want)
    differs = []
    for rule in _OTHER_RULES:
        monkeypatch.setattr(jpeg, "smooth_window", rule)
        differs.append(any(not np.array_equal(jpeg.decode_reference(c).numpy(), want) for c, want in files))
    assert tuple(differs) == refuted


# ---------------------------------------------------------------------------
# whole images
# ---------------------------------------------------------------------------


def _progressive(source: str, mode: str, subsampling: int, box=None) -> bytes:
    """A fixture image written by Pillow as a progressive JPEG at quality 90."""
    with Image.open(os.path.join(FIXTURE, source)) as im:
        img = im.convert(mode)
    buf = io.BytesIO()
    (img.crop(box) if box else img).save(buf, "JPEG", quality=90, subsampling=subsampling, progressive=True)
    return buf.getvalue()


# (source, mode, subsampling, crop) of the whole images
WHOLE = {"420": ("000004.jpg", "RGB", 2, None), "444": ("000033.jpg", "RGB", 0, None),
         "gray": ("000004.jpg", "L", 0, None), "cmyk": ("000004.jpg", "CMYK", 0, None),
         "420_633x465": ("000004.jpg", "RGB", 2, (0, 0, 633, 465))}
CUTS = ("first_refinement", "no_ac_refinement", "dc_only")
# the CMYK file's first component (C) smooths to Pillow's pixels unsmoothed
WHOLE_CASES = [(k, cut) for k in WHOLE for cut in CUTS if (k, cut) != ("cmyk", "first_refinement")]


def _hold(c: jpeg.Coefficients, data: bytes, tmp_path, monkeypatch) -> None:
    """``c`` smoothed, differing from Pillow unsmoothed, and equal to Pillow
    through the plain chain; the JAX package's reader (the system's
    libjpeg-turbo 2.1.5 where its native loader is built) equal to it, or,
    where it reads row r + 2 as that libjpeg does (``turbo21_rows``: 4:2:0
    files here, by up to 2 levels), to the plain chain under that rule."""
    from threedod.data import native_io

    want = pillow(data)
    assert c.smooth is not None and not np.array_equal(unsmoothed(c), want)
    got = jpeg.decode_reference(c).numpy()
    assert np.array_equal(got, want)
    path = tmp_path / "incomplete.jpg"
    path.write_bytes(data)
    theirs = native_io.imread_rgb(str(path))
    if not np.array_equal(theirs, got):
        monkeypatch.setattr(jpeg, "smooth_window", turbo21_rows)
        assert np.array_equal(theirs, jpeg.decode_reference(c).numpy())


@pytest.mark.parametrize("kind,cut", WHOLE_CASES)
def test_whole_images_equal_pillow_and_the_jax_reader(host_decoder, tmp_path, monkeypatch, kind,  # noqa: F811
                                                      cut):
    """A fixture image written progressive and cut: Pillow's pixels, 0
    levels, where the unsmoothed decode differs; the JAX package's as
    ``_hold`` says."""
    data = writer.incomplete(_progressive(*WHOLE[kind]), cut)
    _hold(jpeg.decode_coefficients(data, host_decoder), data, tmp_path, monkeypatch)


@pytest.mark.parametrize("kind,cut", [("420_633x465", "dc_only"), ("444", "no_ac_refinement")])
def test_arithmetic_transcodes_equal_pillow(host_decoder, tmp_path, monkeypatch, kind, cut):  # noqa: F811
    """Arithmetic transcodes (``transcode_arithmetic``, the same scans) of
    two cut images: the Huffman file's coefficients and known bits, and
    Pillow's and the JAX package's pixels."""
    huffman = writer.incomplete(_progressive(*WHOLE[kind]), cut)
    source = jpeg.decode_coefficients(huffman, host_decoder)
    data = writer.transcode_arithmetic(huffman, source.blocks())
    c = jpeg.decode_coefficients(data, host_decoder)
    assert np.array_equal(c.coef, source.coef) and np.array_equal(c.smooth, source.smooth)
    _hold(c, data, tmp_path, monkeypatch)


@pytest.mark.gpu
def test_card_smoothing_instance():
    """On a card: the IDCT kernel's smoothing instance equals
    ``smooth_reference`` + ``idct_islow_reference`` plane for plane, and
    ``decode_jpeg`` equals Pillow, on whole images, a transcode and the
    edge files at v 3 and 4; a file that does not smooth launches the plain
    instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    files = [writer.incomplete(_progressive(*WHOLE[kind]), cut) for kind, cut in (("420", "dc_only"), ("cmyk", "dc_only"),
                                                                      ("420_633x465", "first_refinement"))]
    c = jpeg.decode_coefficients(files[0])
    files.append(writer.transcode_arithmetic(files[0], c.blocks()))
    for data in files:
        c = jpeg.decode_coefficients(data)
        before = jpeg.LAUNCHES_IDCT_SMOOTH
        planes = jpeg.planes_cuda(c, dev)
        assert jpeg.LAUNCHES_IDCT_SMOOTH == before + 1
        for got, want in zip(planes, jpeg.planes_reference(c)):
            assert torch.equal(got.cpu(), want)
        assert np.array_equal(jpeg.decode_jpeg(data, dev).cpu().numpy(), pillow(data))
    for c, want in _edge_files(3, 52) + _edge_files(4, 84):
        assert np.array_equal(jpeg.color_cuda(jpeg.planes_cuda(c, dev), c).cpu().numpy(), want)
    before = (jpeg.LAUNCHES_IDCT, jpeg.LAUNCHES_IDCT_SMOOTH)
    jpeg.decode_jpeg(_progressive(*WHOLE["420"]), dev)
    assert (jpeg.LAUNCHES_IDCT, jpeg.LAUNCHES_IDCT_SMOOTH) == (before[0] + 1, before[1])
