"""Fused residual-conv functions of the serving forward, kernels K4 to K8
(counterpart of ``threedod/ops/fused_conv.py``).

Five functions, each a CUDA kernel source (``csrc/fused_*.cu``):

* ``fused_basic_block`` (K4): a stride-1 residual BasicBlock (the ResNet
  trunks' 3x3 pairs);
* ``fused_tree_tail`` (K5): a DLA ``Tree(levels == 1)`` tail, one or two
  stride-1 BasicBlocks and the Root's 1x1 conv over the concat;
* ``fused_block_down`` (K6): a stride-2 BasicBlock with its pooled (or
  subsampled) and projected residual;
* ``fused_conv_relu_head`` (K7): the RPN head, conv3x3 + relu and the packed
  1x1 predictors;
* ``fused_fpn_level`` (K8): an FPN level, lateral 1x1 plus the 2x-repeated
  top-down carry, then the 3x3 output conv.

Tensors are NCHW, as the port's modules pass them; on the card they are
``torch.channels_last``, so their storage is the (B, H, W, C) the kernels
read, and results come back as channels-last NCHW views of (B, H, W, C)
buffers: nothing is copied on either side. Weights arrive as ``nn.Conv2d``
keeps them, (cout, cin, kh, kw), BatchNorm already folded in f32; the
wrappers repack them at the storage dtype. Biases stay f32: the kernels add
them to the f32 sums.

bfloat16 runs on the tensor cores, as launches of the implicit-GEMM
convolutions of ``csrc/conv_wgmma.cuh`` on ``wgmma`` fed by TMA (a 3x3, a
stride-2 3x3 and a multi-source 1x1; intermediates through L2); float32 runs
on the CUDA cores in exact f32, one kernel a call over
``csrc/fused_conv_common.cuh``. Every function also takes its weights packed
once (``pack_basic_block``, ``pack_tree_tail``, ``pack_block_down``,
``pack_conv_relu_head``, ``pack_fpn_level`` and the ``*_packed`` functions):
the ResNet blocks, the DLA trees, the RPN head and the FPN keep them from one
weight load to the next.

A tensor on a CUDA device always goes to the kernel, which is built at first
use and launched on the current stream; a build or launch failure raises. A
tensor on the CPU goes to the plain version (``*_reference``), which the
tests and the card-side comparison also use. Every public call adds one to
its entry of ``LAUNCHES``, however many launches it makes.

Eval only, and off unless ``ENABLED`` is set: the modules ask
``fused_conv_available()``. The kernels have no backward: on the card they
raise when grad mode is on and an input requires a gradient. Sums are f32 and every value between two
convolutions is rounded to the storage dtype, as in the unfused chain, so in
bf16 the two differ by roundings only (the kernels add bias and residual
before the one rounding, the chain rounds after each).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

ENABLED = False  # the fused serving forward; python -m threedod_torch.infer --fused-forward sets it
LAUNCHES = {"basic_block": 0, "tree_tail": 0, "block_down": 0, "conv_relu_head": 0, "fpn_level": 0}  # K4 to K8
MAX_CHILDREN = 4
_DTYPES = (torch.float32, torch.bfloat16)

BlockWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # w1, b1, w2, b2


def fused_conv_available() -> bool:
    return ENABLED


@contextlib.contextmanager
def fused_forward(on: bool = True):
    """Run a block of code with the switch set, and put it back after."""
    global ENABLED
    before, ENABLED = ENABLED, on
    try:
        yield
    finally:
        ENABLED = before


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------- plain versions -------------------------------------------


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    pad = (w.shape[-1] - 1) // 2
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride, padding=pad)


def basic_block_reference(x, w1, b1, w2, b2):
    t = F.relu(_conv(x, w1, b1))
    return F.relu(_conv(t, w2, b2) + x)


def tree_tail_reference(x, children, bb_a, bb_b, wr, br, *, two_blocks=False,
                        include_input_child=False, root_residual=False):
    x1 = basic_block_reference(x, *bb_a) if two_blocks else x
    x2 = basic_block_reference(x1, *bb_b)
    cat = [x2, x1] + list(children) + ([x] if include_input_child else [])
    y = _conv(torch.cat(cat, dim=1), wr, br)
    if root_residual:
        y = y + x2
    return F.relu(y)


def block_down_reference(x, w1, b1, w2, b2, wproj=None, bproj=None, *, pool_residual=True):
    t = F.relu(_conv(x, w1, b1, stride=2))
    y = _conv(t, w2, b2)
    resid = F.max_pool2d(x, 2) if pool_residual else x[:, :, ::2, ::2]
    if wproj is not None:
        resid = _conv(resid, wproj, bproj)
    return F.relu(y + resid)


def fpn_level_reference(f, prev, wlat, blat, wout, bout):
    """-> (out, cur)."""
    up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    cur = _conv(f, wlat, blat) + up
    return _conv(cur, wout, bout), cur


def conv_relu_head_reference(x, wc, bc, wh, bh):
    return _conv(F.relu(_conv(x, wc, bc)), wh, bh)


# ---------------- wrappers -------------------------------------------------


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors, an error for a mix or
    another device: nothing gives way to the plain version on the card."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"fused conv inputs must all be on the CPU or all on CUDA, got {sorted(kinds)}")


def _refuse_grad(*tensors: Optional[torch.Tensor]) -> None:
    """The kernels have no backward (the JAX package's are eval only too): on
    the card they raise when a gradient is wanted, rather than return a
    result that autograd cannot see through."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("the fused-conv kernels have no backward: run the fused forward under torch.no_grad() "
                           "or torch.inference_mode()")


def _nhwc(x: torch.Tensor, what: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The (B, H, W, C) storage of an NCHW activation: a view when it is
    channels-last, a copy otherwise."""
    if x.dim() != 4:
        raise ValueError(f"{what} must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or (dtype is not None and x.dtype != dtype):
        raise TypeError(f"{what}: the fused kernels take float32 or bfloat16 of one kind, got {x.dtype}")
    if x.shape[1] % 16:  # one k-step of the tensor cores
        raise ValueError(f"{what}: channel count {x.shape[1]} must be a multiple of 16")
    x = x.permute(0, 2, 3, 1).contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary for vector loads")
    return x


def _pack(w: torch.Tensor, dtype: torch.dtype, cin: int, cout: int, k: int, what: str, pad_to: int = 0) -> torch.Tensor:
    """(cout, cin, k, k) -> the kernels' layout at the storage dtype, with the
    output channels padded with zeros to ``pad_to``: (k, k, cin, cout) for
    float32 (the CUDA cores read a row of output channels), (k, k, cout, cin)
    for bfloat16 (the tensor cores' B fragment reads a run of input channels)."""
    if tuple(w.shape) != (cout, cin, k, k):
        raise ValueError(f"{what} must be {(cout, cin, k, k)}, got {tuple(w.shape)}")
    w = w.detach().to(dtype)
    if pad_to > cout:
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad_to - cout))
    return w.permute(2, 3, 1, 0).contiguous() if dtype == torch.float32 else w.permute(2, 3, 0, 1).contiguous()


def _bias(b: torch.Tensor, cout: int, what: str) -> torch.Tensor:
    if tuple(b.shape) != (cout,):
        raise ValueError(f"{what} must be ({cout},), got {tuple(b.shape)}")
    return b.detach().float().contiguous()


def _pack_block(bb: BlockWeights, dtype: torch.dtype, c: int, what: str) -> list:
    w1, b1, w2, b2 = bb
    return [_pack(w1, dtype, c, c, 3, f"{what}.w1"), _bias(b1, c, f"{what}.b1"),
            _pack(w2, dtype, c, c, 3, f"{what}.w2"), _bias(b2, c, f"{what}.b2")]


# ---------------- K4's weights and tiles -------------------------------------

KCHUNK, COUT_ALIGN = 64, 128  # conv_wgmma.cuh: input channels a k-chunk, output channels padded to


def _swizzle_index(rows: int, device) -> torch.Tensor:
    """(rows, 8): the 16-byte piece of a 128-byte row that holds piece g is
    g ^ (row % 8), the 128-byte swizzle; the map is its own inverse."""
    g = torch.arange(8, device=device)
    return g[None, :] ^ (torch.arange(rows, device=device) % 8)[:, None]


def _pack_taps(t: torch.Tensor) -> torch.Tensor:
    """(taps, cout, cin) -> (cin / 64 chunks, taps, cout padded to 128, 64)
    bf16, zeros past cin and cout, each 128-byte row in the 128-byte swizzle
    (the B operand of ``wgmma``, K-major)."""
    taps, cout, cin = t.shape
    nk, coutp = -(-cin // KCHUNK), -(-cout // COUT_ALIGN) * COUT_ALIGN
    t = F.pad(t.detach().to(torch.bfloat16), (0, nk * KCHUNK - cin, 0, coutp - cout))
    t = t.reshape(taps, coutp, nk, 8, 8).permute(2, 0, 1, 3, 4)
    idx = _swizzle_index(coutp, t.device)[None, None, :, :, None].expand(t.shape)
    return torch.gather(t, 3, idx).reshape(nk, taps, coutp, KCHUNK).contiguous()


def _unpack_taps(packed: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of ``_pack_taps``: (taps, cout, cin)."""
    nk, taps, coutp, _ = packed.shape
    t = packed.reshape(nk, taps, coutp, 8, 8)
    t = torch.gather(t, 3, _swizzle_index(coutp, t.device)[None, None, :, :, None].expand(t.shape))
    return t.permute(1, 2, 0, 3, 4).reshape(taps, coutp, nk * KCHUNK)[:, :cout, :cin]


def pack_conv3x3(w: torch.Tensor) -> torch.Tensor:
    """A folded 3x3 kernel (cout, cin, 3, 3) -> the bf16 layout that
    ``csrc/conv_wgmma.cuh`` copies tile by tile: (cin / 64 chunks, 9 taps,
    cout padded to 128, 64), zeros past cin and cout, each 128-byte row in the
    128-byte swizzle (the B operand of ``wgmma``, K-major)."""
    cout, cin = w.shape[:2]
    return _pack_taps(w.permute(2, 3, 0, 1).reshape(9, cout, cin))


def unpack_conv3x3(packed: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of ``pack_conv3x3``: (cout, cin, 3, 3) bf16."""
    return _unpack_taps(packed, cout, cin).reshape(3, 3, cout, cin).permute(2, 3, 0, 1).contiguous()


def pack_conv1x1(w: torch.Tensor, sources: Sequence[int]) -> torch.Tensor:
    """A folded 1x1 kernel (cout, sum(sources), 1, 1) over the concat of
    sources with those channel counts -> the bf16 layout that
    ``conv_wgmma.cuh::conv1x1_wgmma`` copies tile by tile: each source's
    columns packed as ``pack_conv3x3`` packs a kernel, with one tap, and the
    sources' chunks one after the other: (sum of ceil(c / 64) chunks, cout
    padded to 128, 64). A source's last chunk is zero past its channels."""
    cout, cin = w.shape[:2]
    if tuple(w.shape[2:]) != (1, 1) or sum(sources) != cin:
        raise ValueError(f"a 1x1 kernel over sources of {list(sources)} channels must be (cout, {sum(sources)}, 1, 1), "
                         f"got {tuple(w.shape)}")
    cols = torch.split(w.reshape(cout, cin), list(sources), dim=1)
    return torch.cat([_pack_taps(c[None]) for c in cols]).reshape(-1, -(-cout // COUT_ALIGN) * COUT_ALIGN, KCHUNK)


def unpack_conv1x1(packed: torch.Tensor, cout: int, sources: Sequence[int]) -> torch.Tensor:
    """The inverse of ``pack_conv1x1``: (cout, sum(sources), 1, 1) bf16."""
    chunks = [-(-c // KCHUNK) for c in sources]
    parts = torch.split(packed, chunks)
    cols = [_unpack_taps(part[:, None], cout, c)[0] for part, c in zip(parts, sources)]
    return torch.cat(cols, dim=1)[:, :, None, None].contiguous()


class PackedBasicBlock(NamedTuple):
    """K4's weights in the kernel's layout at one storage dtype: bf16
    ``pack_conv3x3`` tiles, or f32 (3, 3, cin, cout); f32 biases."""
    dtype: torch.dtype
    c: int
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


@torch.no_grad()
def pack_basic_block(w1, b1, w2, b2, dtype: torch.dtype) -> PackedBasicBlock:
    """Pack a folded BasicBlock (w1, w2 (C, C, 3, 3), b1, b2 (C,)) for K4 at
    ``dtype``, on the weights' device. A plain torch function: the ResNet
    blocks call it once a weight load, the plain wrapper once a call."""
    if dtype not in _DTYPES:
        raise TypeError(f"the fused kernels take float32 or bfloat16, got {dtype}")
    c = w1.shape[0]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (c, c, 3, 3):
            raise ValueError(f"block.{name} must be {(c, c, 3, 3)}, got {tuple(w.shape)}")
    if dtype == torch.bfloat16:  # biases in fresh (aligned) storage: the kernel reads them 16 bytes at a time
        return PackedBasicBlock(dtype, c, pack_conv3x3(w1), _bias(b1, c, "block.b1").clone(),
                                pack_conv3x3(w2), _bias(b2, c, "block.b2").clone())
    return PackedBasicBlock(dtype, c, *_pack_block((w1, b1, w2, b2), dtype, c, "block"))


def k4_slab(w: int, bm: int) -> Tuple[int, int, int, int]:
    """``conv_wgmma.cuh::slab_shape``: (S, bands, rows, box rows) of the
    activation slab for bm positions of a map w wide: one run of bm + 2 w + 2
    rows (S = w), or three bands of bm + 2, each on an 8-row boundary (S the
    band stride), where the run is longer than the bands or than a copy's 256."""
    run, band = bm + 2 * w + 2, -(-(bm + 2) // 8) * 8
    if run <= 3 * band and run <= 256:
        return w, 1, -(-run // 8) * 8, run
    return band, 3, 3 * band, bm + 2


def _k4_smem(bn: int, mt: int, c: int, w: int) -> int:
    """Shared memory of one K4 block (``conv_wgmma.cuh::smem_bytes``, four
    weight stages): the weight ring, one or two slab stages (which later hold
    the epilogue's f32 sums), a zero row, barriers."""
    rows = k4_slab(w, 64 * mt)[2]
    slabs = max((1 if c <= KCHUNK else 2) * rows * 128, mt * 64 * (bn + 8) * 4)
    return 1024 + 4 * bn * KCHUNK * 2 + slabs + 128 + 8 * 12


# registers a thread of each K4 instantiation (bn, warpgroups) (-Xptxas -v of the sm_90a build)
K4_REGISTERS = {(64, 1): 93, (64, 2): 93, (128, 1): 124, (128, 2): 124}
K4_SHAPES = tuple(K4_REGISTERS)
# how an SM's throughput grows with the warpgroups it holds (each drains its
# products every tap) and with the slice width (fewer drains a product):
# exponents chosen so that the cost ranks the four block shapes as their
# measured bf16 times do at ResNet34's four launch shapes (chip_smoke.py
# phase 5 prints those times)
K4_WG_GAIN, K4_BN_GAIN = 0.46, 0.38


def basic_block_tile(b: int, h: int, w: int, c: int, *, sms: int) -> Tuple[int, int]:
    """K4's block shape (bn output channels, mt warpgroups of 64 positions),
    chosen by the whole card of ``sms`` streaming multiprocessors (132 on an
    H100 SXM; the wrapper reads the card's). The 64 mt-position tiles of the
    B H W positions times the ceil(C / bn) slices make the blocks; shared
    memory, registers and threads set how many an SM holds (k). Cost: the
    blocks the busiest SM takes, ceil(blocks / sms), times a block's work in 64 x 64
    units (mt bn / 64: a slice past C and the last tile's empty rows count in
    full), over the SM's rate, (k mt)^0.46 (bn / 64)^0.38: the kernel is
    bound by latency (each warpgroup waits for its products every tap), so
    more resident warpgroups and wider products run faster, less than in
    proportion."""
    best, pick = None, (64, 1)
    for bn, mt in K4_SHAPES:
        blocks = -(-b * h * w // (64 * mt)) * -(-c // bn)
        threads = 128 * mt + 32
        k = min(233472 // (_k4_smem(bn, mt, c, w) + 1024), 65536 // (threads * K4_REGISTERS[bn, mt]),
                2048 // threads)
        if k < 1:
            continue
        cost = -(-blocks // sms) * mt * bn / 64 / ((k * mt) ** K4_WG_GAIN * (bn / 64) ** K4_BN_GAIN)
        if best is None or cost < best:
            best, pick = cost, (bn, mt)
    return pick


# ---------------- the 1x1's block shapes (K5's root, K8's lateral) -------------

# registers a thread of each conv1x1_wgmma instantiation (warpgroups), all
# with 64-channel slices (-Xptxas -v of the sm_90a build; chip_smoke.py phase
# 2 prints them)
K1X1_REGISTERS = {1: 58, 2: 58}
K1X1_WARPGROUPS = tuple(K1X1_REGISTERS)
K1X1_SLICE = 64  # conv_wgmma.cuh N1X1: the 1x1's output channels a block
STAGES_1X1 = 4  # conv_wgmma.cuh: the 1x1's ring holds min(4, k-chunks) stages
# how an SM's throughput grows with the warpgroups it holds: the exponent
# ranks the two block shapes as their measured bf16 times do at the nine 1x1
# launches of the DLA34 forward (chip_smoke.py phase_k5_k8 prints those times)
K1X1_WG_GAIN = 0.5


def _k1x1_smem(mt: int, nk: int) -> int:
    """Shared memory of one 1x1 block (``conv_wgmma.cuh::smem1x1_bytes``):
    min(4, nk) stages of an activation and a weight tile, which later hold
    the epilogue's f32 sums, and their barriers."""
    ns = min(STAGES_1X1, nk)
    return 1024 + max(ns * (64 * mt + K1X1_SLICE) * KCHUNK * 2, mt * 64 * (K1X1_SLICE + 8) * 4) + 16 * ns


def conv1x1_tile(b: int, h: int, w: int, sources: Sequence[int], cout: int, *, sms: int) -> int:
    """The 1x1's warpgroups of 64 positions a block (1 or 2) for a launch over
    ``sources`` (their channel counts) on a card of ``sms`` streaming
    multiprocessors. The 64 mt-position tiles of the B H W positions times
    the ceil(cout / 64) slices make the blocks; shared memory, registers and
    threads set how many an SM holds (k). Cost, as ``basic_block_tile``'s:
    the blocks the busiest SM takes, ceil(blocks / sms), times a block's work
    (mt) over the SM's rate, (k mt)^0.5: resident warpgroups overlap their
    copies, products and epilogues."""
    nk = sum(-(-c // KCHUNK) for c in sources)
    best, pick = None, 1
    for mt in K1X1_WARPGROUPS:
        blocks = -(-b * h * w // (64 * mt)) * -(-cout // K1X1_SLICE)
        threads = 128 * mt + 32
        k = min(233472 // (_k1x1_smem(mt, nk) + 1024), 65536 // (threads * K1X1_REGISTERS[mt]), 2048 // threads)
        if k < 1:
            continue
        cost = -(-blocks // sms) * mt / (k * mt) ** K1X1_WG_GAIN
        if best is None or cost < best:
            best, pick = cost, mt
    return pick


def _nchw(out: torch.Tensor) -> torch.Tensor:
    return out.permute(0, 3, 1, 2)


_P, _I = ctypes.c_void_p, ctypes.c_int


class _Children(ctypes.Structure):
    _fields_ = [("ptr", _P * MAX_CHILDREN), ("c", _I * MAX_CHILDREN), ("n", _I)]


def fused_basic_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x): a stride-1
    residual BasicBlock that keeps its channel count. x (B, C, H, W), w1 and
    w2 (C, C, 3, 3) folded, b1 and b2 (C,) -> (B, C, H, W). On the card the
    weights are packed at every call; ``fused_basic_block_packed`` takes
    them packed."""
    if not _on_card(x):
        return basic_block_reference(x, w1, b1, w2, b2)
    _refuse_grad(x, w1, b1, w2, b2)
    return fused_basic_block_packed(x, pack_basic_block(w1, b1, w2, b2, x.dtype))


def fused_basic_block_packed(x: torch.Tensor, packed: PackedBasicBlock,
                             tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4 on a CUDA tensor with weights from ``pack_basic_block`` at x's dtype
    on x's device. bfloat16: two launches of one kernel source, the first
    writing t to a scratch map (``csrc/fused_basic_block.cu``), with the block
    shape ``tile`` (bn, warpgroups) or ``basic_block_tile``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_basic_block_packed runs on CUDA tensors, got {x.device}")
    _refuse_grad(x)
    xs = _nhwc(x, "x", packed.dtype)
    b, h, w, c = xs.shape
    if c != packed.c:
        raise ValueError(f"x has {c} channels, the packed block {packed.c}")
    if any(t.device != xs.device for t in (packed.w1, packed.b1, packed.w2, packed.b2)):
        raise ValueError("the packed weights must be on x's device")
    out = torch.empty_like(xs)
    bf16 = xs.dtype == torch.bfloat16
    tmp = torch.empty_like(xs) if bf16 else None
    bn, mt = (tile or basic_block_tile(b, h, w, c, sms=_build.card_sms(xs.device))) if bf16 else (0, 0)
    if bf16 and (bn, mt) not in K4_SHAPES:
        raise ValueError(f"K4 block shape {(bn, mt)} is not one of {K4_SHAPES}")
    lib = _build.library("fused_basic_block", "threedod_fused_basic_block", [_P] * 7 + [_I] * 8 + [_P])
    is_bf16, device, stream = _build.launch_args(xs)
    err = lib.threedod_fused_basic_block(
        xs.data_ptr(), packed.w1.data_ptr(), packed.b1.data_ptr(), packed.w2.data_ptr(), packed.b2.data_ptr(),
        out.data_ptr(), None if tmp is None else tmp.data_ptr(), b, h, w, c, is_bf16, bn, mt, device, stream)
    _build.check_launch(lib, "fused_basic_block", err)
    LAUNCHES["basic_block"] += 1
    return _nchw(out)


class PackedTreeTail(NamedTuple):
    """K5's weights in the kernels' layout at one storage dtype: the blocks
    as ``pack_basic_block`` packs them (``block_a`` None for one block), the
    root bf16 ``pack_conv1x1`` tiles over its sources, or f32 (1, 1, ctot,
    cout); f32 biases. ``sources`` are the root's sources' channel counts in
    concat order: x2, x1, the children, then x when it is the last child."""
    dtype: torch.dtype
    c: int
    cout: int
    sources: Tuple[int, ...]
    include_input_child: bool
    block_a: Optional[PackedBasicBlock]
    block_b: PackedBasicBlock
    wr: torch.Tensor
    br: torch.Tensor


@torch.no_grad()
def pack_tree_tail(bb_a: Optional[BlockWeights], bb_b: BlockWeights, wr: torch.Tensor, br: torch.Tensor,
                   dtype: torch.dtype, *, children: Sequence[int] = (), two_blocks: bool = False,
                   include_input_child: bool = False) -> PackedTreeTail:
    """Pack a folded tree tail for K5 at ``dtype``, on the weights' device:
    ``children`` are the children's channel counts. A plain torch function:
    the DLA trees call it once a weight load, the plain wrapper once a
    call."""
    c = bb_b[0].shape[0]
    sources = (c, c, *children) + ((c,) if include_input_child else ())
    cout = wr.shape[0]
    if tuple(wr.shape) != (cout, sum(sources), 1, 1):
        raise ValueError(f"wr must be {(cout, sum(sources), 1, 1)} (x2, x1, children {list(children)}"
                         f"{', x' if include_input_child else ''}), got {tuple(wr.shape)}")
    block_a = pack_basic_block(*bb_a, dtype) if two_blocks else None
    block_b = pack_basic_block(*bb_b, dtype)
    if dtype == torch.bfloat16:  # bias in fresh (aligned) storage: the kernel reads it 16 bytes at a time
        wrp, brp = pack_conv1x1(wr, sources), _bias(br, cout, "br").clone()
    else:
        wrp, brp = _pack(wr, dtype, sum(sources), cout, 1, "wr"), _bias(br, cout, "br")
    return PackedTreeTail(dtype, c, cout, sources, include_input_child, block_a, block_b, wrp, brp)


def fused_tree_tail(
    x: torch.Tensor,
    children: Sequence[torch.Tensor],
    bb_a: Optional[BlockWeights],
    bb_b: BlockWeights,
    wr: torch.Tensor,
    br: torch.Tensor,
    *,
    two_blocks: bool = False,
    include_input_child: bool = False,
    root_residual: bool = False,
) -> torch.Tensor:
    """DLA Tree(levels == 1) tail.

    one block:  x1 = x;        x2 = BB_b(x1)
    two blocks: x1 = BB_a(x);  x2 = BB_b(x1)
    out = relu(concat([x2, x1, *children] + ([x] if include_input_child))
               @ wr + br [+ x2 if root_residual])

    x (B, C, H, W); children (B, Ck, H, W), read only by the root; ``bb_*``
    are (w1, b1, w2, b2) of a BasicBlock, folded; wr (Cout, sum of the
    concat's channels, 1, 1) in that order. On the card the weights are
    packed at every call; ``fused_tree_tail_packed`` takes them packed."""
    if not _on_card(x, *children):
        return tree_tail_reference(x, children, bb_a, bb_b, wr, br, two_blocks=two_blocks,
                                   include_input_child=include_input_child, root_residual=root_residual)
    _refuse_grad(x, *children, *(bb_a or ()), *bb_b, wr, br)
    packed = pack_tree_tail(bb_a, bb_b, wr, br, x.dtype, children=[ch.shape[1] for ch in children],
                            two_blocks=two_blocks, include_input_child=include_input_child)
    return fused_tree_tail_packed(x, children, packed, root_residual=root_residual)


def fused_tree_tail_packed(x: torch.Tensor, children: Sequence[torch.Tensor], packed: PackedTreeTail, *,
                           root_residual: bool = False,
                           tiles: Optional[Tuple[Tuple[int, int], int]] = None) -> torch.Tensor:
    """K5 on CUDA tensors with weights from ``pack_tree_tail`` at x's dtype on
    x's device. bfloat16: the blocks as K4's launch pairs into scratch maps x1
    (two blocks) and x2, then one 1x1 launch for the root over x2, x1, the
    children and x (``csrc/fused_tree_tail.cu``), with the block shapes
    ``tiles`` ((bn, mt) of the 3x3 launches, mt of the 1x1) or
    ``basic_block_tile``'s and ``conv1x1_tile``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_tree_tail_packed runs on CUDA tensors, got {x.device}")
    _refuse_grad(x, *children)
    if len(children) > MAX_CHILDREN:
        raise ValueError(f"at most {MAX_CHILDREN} children, got {len(children)}")
    xs = _nhwc(x, "x", packed.dtype)
    b, h, w, c = xs.shape
    kids = _Children()
    kids.n = len(children)
    held = []
    for i, ch in enumerate(children):
        cs = _nhwc(ch, f"child {i}", xs.dtype)
        if cs.shape[:3] != xs.shape[:3]:
            raise ValueError(f"child {i} is {tuple(ch.shape)}, x is {tuple(x.shape)}")
        held.append(cs)
        kids.ptr[i], kids.c[i] = cs.data_ptr(), cs.shape[3]
    two, incl = packed.block_a is not None, packed.include_input_child
    sources = (c, c, *(t.shape[3] for t in held)) + ((c,) if incl else ())
    if c != packed.c or sources != packed.sources:
        raise ValueError(f"x and the children give the root sources of {list(sources)} channels, the packed tail "
                         f"{list(packed.sources)}")
    cout = packed.cout
    if root_residual and cout != c:
        raise ValueError("root_residual needs as many output channels as x has")
    align = 8 if packed.dtype == torch.bfloat16 else 4  # bf16: the root's epilogue stores 16 bytes a thread
    if cout % align:
        raise ValueError(f"the root's output channels ({cout}) must be a multiple of {align}")
    weights = [*(packed.block_a[2:] if two else [None] * 4), *packed.block_b[2:], packed.wr, packed.br]
    if any(t is not None and t.device != xs.device for t in weights):
        raise ValueError("the packed weights must be on x's device")
    ptrs = [None if t is None else t.data_ptr() for t in weights]
    out = torch.empty((b, h, w, cout), dtype=xs.dtype, device=xs.device)
    is_bf16, device, stream = _build.launch_args(xs)
    if is_bf16:
        sms = _build.card_sms(xs.device)
        tile3, tile1 = tiles or (basic_block_tile(b, h, w, c, sms=sms), conv1x1_tile(b, h, w, sources, cout, sms=sms))
        if tile3 not in K4_SHAPES or tile1 not in K1X1_WARPGROUPS:
            raise ValueError(f"K5 block shapes {tile3}, {tile1} are not in {K4_SHAPES}, {K1X1_WARPGROUPS}")
        x1 = torch.empty_like(xs) if two else None
        x2, tmp = torch.empty_like(xs), torch.empty_like(xs)
        lib = _build.library("fused_tree_tail", "threedod_fused_tree_tail_bf16",
                             [_P, _Children] + [_P] * 14 + [_I] * 12 + [_P])
        err = lib.threedod_fused_tree_tail_bf16(
            xs.data_ptr(), kids, *ptrs, out.data_ptr(), None if x1 is None else x1.data_ptr(), x2.data_ptr(),
            tmp.data_ptr(), b, h, w, c, cout, int(two), int(incl), int(root_residual), *tile3, tile1,
            device, stream)
    else:
        lib = _build.library("fused_tree_tail", "threedod_fused_tree_tail_f32", [_P, _Children] + [_P] * 11 + [_I] * 9 + [_P])
        err = lib.threedod_fused_tree_tail_f32(
            xs.data_ptr(), kids, *ptrs, out.data_ptr(), b, h, w, c, cout, int(two), int(incl), int(root_residual),
            device, stream)
    _build.check_launch(lib, "fused_tree_tail", err)
    LAUNCHES["tree_tail"] += 1
    return _nchw(out)


# ---------------- K6: the stride-2 block ------------------------------------

# registers a thread of each conv3x3s2_wgmma instantiation (bn, warpgroups)
# (-Xptxas -v of the sm_90a build; chip_smoke.py phase 2 prints them)
K6_REGISTERS = {(64, 1): 96, (64, 2): 96, (128, 1): 133, (128, 2): 128}
K6_SHAPES = tuple(K6_REGISTERS)
S2_TW = 8  # conv_wgmma.cuh: output columns of a stride-2 tile; its rows are 8 mt
# the slice width's exponent in the cost (K4's warpgroup exponent stays): with
# it the cost ranks the four block shapes as their measured bf16 times do at
# the seven K6 launches of the DLA34 and ResNet34 forwards (any exponent from
# 0.42 up does; K4's 0.38 picks 64 x 2 where 128 x 2 is 13 % faster; chip_smoke.py
# phase_k6_k7(shapes=True) prints those times)
K6_BN_GAIN = 0.5


def _k6_smem(bn: int, mt: int, cin: int) -> int:
    """Shared memory of one stride-2 block (``conv_wgmma.cuh::s2_smem_bytes``,
    four weight stages): the weight ring, one or two stages of four parity
    planes of (8 mt + 1) x 9 rows (which later hold the epilogue's f32 sums),
    a zero row, barriers."""
    plane_rows = -(-(8 * mt + 1) * (S2_TW + 1) // 8) * 8
    slabs = max((1 if cin <= KCHUNK else 2) * 4 * plane_rows * 128, mt * 64 * (bn + 8) * 4)
    return 1024 + 4 * bn * KCHUNK * 2 + slabs + 128 + 8 * 12


def block_down_tile(b: int, ho: int, wo: int, cin: int, c: int, *, sms: int) -> Tuple[int, int]:
    """The block shape (bn output channels, mt warpgroups) of K6's stride-2
    3x3 from Cin to C on a (b, 2 ho, 2 wo) input, chosen by the whole card of
    ``sms`` streaming multiprocessors. A block's tile is 8 mt output rows by
    8 columns, so the blocks are ceil(b ho / 8 mt) x ceil(wo / 8) tiles times
    ceil(C / bn) slices; the cost is ``basic_block_tile``'s, with the same
    warpgroup exponent (each warpgroup waits for its products every tap, as
    there) and its own slice exponent, ``K6_BN_GAIN``."""
    best, pick = None, K6_SHAPES[0]
    for bn, mt in K6_SHAPES:
        smem = _k6_smem(bn, mt, cin)
        threads = 128 * mt + 32
        k = min(233472 // (smem + 1024), 65536 // (threads * K6_REGISTERS[bn, mt]), 2048 // threads)
        if smem > 232448 or k < 1:
            continue
        blocks = -(-b * ho // (8 * mt)) * -(-wo // S2_TW) * -(-c // bn)
        cost = -(-blocks // sms) * mt * bn / 64 / ((k * mt) ** K4_WG_GAIN * (bn / 64) ** K6_BN_GAIN)
        if best is None or cost < best:
            best, pick = cost, (bn, mt)
    return pick


class PackedBlockDown(NamedTuple):
    """K6's weights in the kernels' layout at one storage dtype: bf16
    ``pack_conv3x3`` (w1, w2) and ``pack_conv1x1`` (wp) tiles, or f32 (3, 3,
    cin, c), (3, 3, c, c) and (1, 1, cin, c); f32 biases. ``wp`` and ``bp``
    are None for a block without a projection (cin == c)."""
    dtype: torch.dtype
    cin: int
    c: int
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wp: Optional[torch.Tensor]
    bp: Optional[torch.Tensor]


@torch.no_grad()
def pack_block_down(w1, b1, w2, b2, wproj, bproj, dtype: torch.dtype) -> PackedBlockDown:
    """Pack a folded stride-2 block (w1 (C, Cin, 3, 3), w2 (C, C, 3, 3), the
    projection wproj (C, Cin, 1, 1) or None, biases (C,)) for K6 at
    ``dtype``, on the weights' device. A plain torch function: the DLA trees
    and the ResNet blocks call it once a weight load, the plain wrapper once
    a call."""
    if dtype not in _DTYPES:
        raise TypeError(f"the fused kernels take float32 or bfloat16, got {dtype}")
    c, cin = w1.shape[:2]
    if c % 16:
        raise ValueError(f"output channels ({c}) must be a multiple of 16")
    if wproj is None and cin != c:
        raise ValueError("without a projection the block must keep its channel count")
    if dtype == torch.bfloat16:  # biases in fresh (aligned) storage: the kernels read them 16 bytes at a time
        for name, w, shape in (("w1", w1, (c, cin, 3, 3)), ("w2", w2, (c, c, 3, 3)),
                               ("wproj", wproj, (c, cin, 1, 1))):
            if w is not None and tuple(w.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(w.shape)}")
        proj = (None, None) if wproj is None else (pack_conv1x1(wproj, [cin]), _bias(bproj, c, "bproj").clone())
        return PackedBlockDown(dtype, cin, c, pack_conv3x3(w1), _bias(b1, c, "b1").clone(), pack_conv3x3(w2),
                               _bias(b2, c, "b2").clone(), *proj)
    proj = (None, None) if wproj is None else (_pack(wproj, dtype, cin, c, 1, "wproj"), _bias(bproj, c, "bproj"))
    return PackedBlockDown(dtype, cin, c, _pack(w1, dtype, cin, c, 3, "w1"), _bias(b1, c, "b1"),
                           _pack(w2, dtype, c, c, 3, "w2"), _bias(b2, c, "b2"), *proj)


def _check_even(x: torch.Tensor) -> None:
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"fused_block_down needs even input dims, got {tuple(x.shape[2:])}")


def fused_block_down(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    wproj: Optional[torch.Tensor] = None,
    bproj: Optional[torch.Tensor] = None,
    *,
    pool_residual: bool = True,
) -> torch.Tensor:
    """Stride-2 BasicBlock head.

    t = relu(conv3x3_s2(x, w1) + b1); y = relu(conv3x3(t, w2) + b2 + residual);
    residual = proj(maxpool2x2(x)) when ``pool_residual`` (the DLA Tree's
    bottom and projection), else proj(x[::2, ::2]); proj is the identity when
    ``wproj`` is None. x (B, Cin, 2H, 2W) -> (B, Cout, H, W); even input dims.
    On the card the weights are packed at every call;
    ``fused_block_down_packed`` takes them packed."""
    _check_even(x)
    if not _on_card(x):
        return block_down_reference(x, w1, b1, w2, b2, wproj, bproj, pool_residual=pool_residual)
    _refuse_grad(x, w1, b1, w2, b2, wproj, bproj)
    return fused_block_down_packed(x, pack_block_down(w1, b1, w2, b2, wproj, bproj, x.dtype),
                                   pool_residual=pool_residual)


def fused_block_down_packed(x: torch.Tensor, packed: PackedBlockDown, *, pool_residual: bool = True,
                            tiles: Optional[Tuple[Tuple[int, int], int, Tuple[int, int]]] = None) -> torch.Tensor:
    """K6 on a CUDA tensor with weights from ``pack_block_down`` at x's dtype
    on x's device. bfloat16: the stride-2 3x3 into the scratch maps t and
    pooled (maxpool2x2(x), or x[::2, ::2]), the projection's 1x1 into a
    scratch residual map, then the 3x3 over t with the residual
    (``csrc/fused_block_down.cu``), with the block shapes ``tiles`` ((bn, mt)
    of the stride-2 3x3, mt of the 1x1, (bn, mt) of the second 3x3) or
    ``block_down_tile``'s, ``conv1x1_tile``'s and ``basic_block_tile``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_down_packed runs on CUDA tensors, got {x.device}")
    _check_even(x)
    _refuse_grad(x)
    xs = _nhwc(x, "x", packed.dtype)
    b, hi, wi, cin = xs.shape
    c, ho, wo = packed.c, hi // 2, wi // 2
    if cin != packed.cin:
        raise ValueError(f"x has {cin} channels, the packed block {packed.cin}")
    weights = packed[3:]
    if any(t is not None and t.device != xs.device for t in weights):
        raise ValueError("the packed weights must be on x's device")
    ptrs = [None if t is None else t.data_ptr() for t in weights]
    out = torch.empty((b, ho, wo, c), dtype=xs.dtype, device=xs.device)
    is_bf16, device, stream = _build.launch_args(xs)
    if is_bf16:
        sms = _build.card_sms(xs.device)
        tile1, tilep, tile3 = tiles or (block_down_tile(b, ho, wo, cin, c, sms=sms),
                                        conv1x1_tile(b, ho, wo, [cin], c, sms=sms), basic_block_tile(b, ho, wo, c, sms=sms))
        if tile1 not in K6_SHAPES or tilep not in K1X1_WARPGROUPS or tile3 not in K4_SHAPES:
            raise ValueError(f"K6 block shapes {tile1}, {tilep}, {tile3} are not in {K6_SHAPES}, {K1X1_WARPGROUPS}, "
                             f"{K4_SHAPES}")
        t, pooled = torch.empty_like(out), torch.empty((b, ho, wo, cin), dtype=xs.dtype, device=xs.device)
        resid = None if packed.wp is None else torch.empty_like(out)
        lib = _build.library("fused_block_down", "threedod_fused_block_down_bf16", [_P] * 11 + [_I] * 12 + [_P])
        err = lib.threedod_fused_block_down_bf16(
            xs.data_ptr(), *ptrs, out.data_ptr(), t.data_ptr(), pooled.data_ptr(),
            None if resid is None else resid.data_ptr(), b, hi, wi, cin, c, int(pool_residual), *tile1, tilep, *tile3,
            device, stream)
    else:
        lib = _build.library("fused_block_down", "threedod_fused_block_down_f32", [_P] * 8 + [_I] * 7 + [_P])
        err = lib.threedod_fused_block_down_f32(
            xs.data_ptr(), *ptrs, out.data_ptr(), b, hi, wi, cin, c, int(pool_residual), device, stream)
    _build.check_launch(lib, "fused_block_down", err)
    LAUNCHES["block_down"] += 1
    return _nchw(out)


# ---------------- K7: the RPN head -------------------------------------------


class PackedConvReluHead(NamedTuple):
    """K7's weights in the kernels' layout at one storage dtype: bf16
    ``pack_conv3x3`` (wc) and ``pack_conv1x1`` (wh) tiles and bh padded with
    zeros to a multiple of 8, or f32 (3, 3, c, cm) and (1, 1, cm, npad) with
    bh padded to npad, a multiple of 4; f32 biases."""
    dtype: torch.dtype
    c: int
    cm: int
    nout: int
    wc: torch.Tensor
    bc: torch.Tensor
    wh: torch.Tensor
    bh: torch.Tensor


@torch.no_grad()
def pack_conv_relu_head(wc: torch.Tensor, bc: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                        dtype: torch.dtype) -> PackedConvReluHead:
    """Pack the RPN head's conv (wc (Cm, C, 3, 3), bc (Cm,)) and its packed
    1x1 predictors (wh (N, Cm, 1, 1), bh (N,)) for K7 at ``dtype``, on the
    weights' device. In bf16 the conv keeps its channel count (Cm == C, as
    in every RPN head). A plain torch function: ``RPNHead`` calls it once a
    weight load, the plain wrapper once a call."""
    if dtype not in _DTYPES:
        raise TypeError(f"the fused kernels take float32 or bfloat16, got {dtype}")
    cm, c = wc.shape[:2]
    nout = wh.shape[0]
    if cm % 16:
        raise ValueError(f"the conv's output channels ({cm}) must be a multiple of 16")
    if dtype == torch.bfloat16:
        if tuple(wc.shape) != (c, c, 3, 3):
            raise ValueError(f"in bfloat16 wc must keep the channel count, {(c, c, 3, 3)}, got {tuple(wc.shape)}")
        return PackedConvReluHead(dtype, c, cm, nout, pack_conv3x3(wc), _bias(bc, cm, "bc").clone(),
                                  pack_conv1x1(wh, [cm]), F.pad(_bias(bh, nout, "bh"), (0, -(-nout // 8) * 8 - nout)))
    npad = -(-nout // 4) * 4  # the kernel sums 4 output channels a thread
    return PackedConvReluHead(dtype, c, cm, nout, _pack(wc, dtype, c, cm, 3, "wc"), _bias(bc, cm, "bc"),
                              _pack(wh, dtype, cm, nout, 1, "wh", pad_to=npad), F.pad(_bias(bh, nout, "bh"), (0, npad - nout)))


def fused_conv_relu_head(x: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                         wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, wc) + bc) @ wh + bh (the RPN head: the 1x1 predictors
    are packed into wh's output channels). x (B, C, H, W), wc (Cm, C, 3, 3),
    wh (N, Cm, 1, 1) -> (B, N, H, W). On the card the weights are packed at
    every call; ``fused_conv_relu_head_packed`` takes them packed."""
    if not _on_card(x):
        return conv_relu_head_reference(x, wc, bc, wh, bh)
    _refuse_grad(x, wc, bc, wh, bh)
    return fused_conv_relu_head_packed(x, pack_conv_relu_head(wc, bc, wh, bh, x.dtype))


def fused_conv_relu_head_packed(x: torch.Tensor, packed: PackedConvReluHead,
                                tiles: Optional[Tuple[Tuple[int, int], int]] = None) -> torch.Tensor:
    """K7 on a CUDA tensor with weights from ``pack_conv_relu_head`` at x's
    dtype on x's device. bfloat16: the 3x3 with relu into a scratch map t,
    then the predictors' 1x1 over t (``csrc/fused_conv_relu_head.cu``), with
    the block shapes ``tiles`` ((bn, mt) of the 3x3, mt of the 1x1) or
    ``basic_block_tile``'s and ``conv1x1_tile``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_relu_head_packed runs on CUDA tensors, got {x.device}")
    _refuse_grad(x)
    xs = _nhwc(x, "x", packed.dtype)
    b, h, w, c = xs.shape
    if c != packed.c:
        raise ValueError(f"x has {c} channels, the packed head {packed.c}")
    if any(t.device != xs.device for t in packed[4:]):
        raise ValueError("the packed weights must be on x's device")
    ptrs = [t.data_ptr() for t in packed[4:]]
    out = torch.empty((b, h, w, packed.nout), dtype=xs.dtype, device=xs.device)
    is_bf16, device, stream = _build.launch_args(xs)
    if is_bf16:
        sms = _build.card_sms(xs.device)
        tile3, tile1 = tiles or (basic_block_tile(b, h, w, c, sms=sms), conv1x1_tile(b, h, w, [c], packed.nout, sms=sms))
        if tile3 not in K4_SHAPES or tile1 not in K1X1_WARPGROUPS:
            raise ValueError(f"K7 block shapes {tile3}, {tile1} are not in {K4_SHAPES}, {K1X1_WARPGROUPS}")
        t = torch.empty_like(xs)
        lib = _build.library("fused_conv_relu_head", "threedod_fused_conv_relu_head_bf16", [_P] * 7 + [_I] * 9 + [_P])
        err = lib.threedod_fused_conv_relu_head_bf16(
            xs.data_ptr(), *ptrs, out.data_ptr(), t.data_ptr(), b, h, w, c, packed.nout, *tile3, tile1, device, stream)
    else:
        lib = _build.library("fused_conv_relu_head", "threedod_fused_conv_relu_head_f32", [_P] * 6 + [_I] * 8 + [_P])
        err = lib.threedod_fused_conv_relu_head_f32(
            xs.data_ptr(), *ptrs, out.data_ptr(), b, h, w, c, packed.cm, packed.bh.shape[0], packed.nout, device,
            stream)
    _build.check_launch(lib, "fused_conv_relu_head", err)
    LAUNCHES["conv_relu_head"] += 1
    return _nchw(out)


class PackedFPNLevel(NamedTuple):
    """K8's weights in the kernels' layout at one storage dtype: bf16
    ``pack_conv1x1`` (the lateral) and ``pack_conv3x3`` (the output conv)
    tiles, or f32 (1, 1, cl, c) and (3, 3, c, c); f32 biases."""
    dtype: torch.dtype
    cl: int
    c: int
    wlat: torch.Tensor
    blat: torch.Tensor
    wout: torch.Tensor
    bout: torch.Tensor


@torch.no_grad()
def pack_fpn_level(wlat: torch.Tensor, blat: torch.Tensor, wout: torch.Tensor, bout: torch.Tensor,
                   dtype: torch.dtype) -> PackedFPNLevel:
    """Pack an FPN level's convs (wlat (C, Cl, 1, 1), wout (C, C, 3, 3),
    biases (C,)) for K8 at ``dtype``, on the weights' device. A plain torch
    function: the FPN calls it once a weight load, the plain wrapper once a
    call."""
    if dtype not in _DTYPES:
        raise TypeError(f"the fused kernels take float32 or bfloat16, got {dtype}")
    c, cl = wlat.shape[:2]
    if dtype == torch.bfloat16:  # biases in fresh (aligned) storage: the kernels read them 16 bytes at a time
        if tuple(wout.shape) != (c, c, 3, 3):
            raise ValueError(f"wout must be {(c, c, 3, 3)}, got {tuple(wout.shape)}")
        return PackedFPNLevel(dtype, cl, c, pack_conv1x1(wlat, [cl]), _bias(blat, c, "blat").clone(),
                              pack_conv3x3(wout), _bias(bout, c, "bout").clone())
    return PackedFPNLevel(dtype, cl, c, _pack(wlat, dtype, cl, c, 1, "wlat"), _bias(blat, c, "blat"),
                          _pack(wout, dtype, c, c, 3, "wout"), _bias(bout, c, "bout"))


def fused_fpn_level(f: torch.Tensor, prev: torch.Tensor, wlat: torch.Tensor, blat: torch.Tensor,
                    wout: torch.Tensor, bout: torch.Tensor, *, emit_cur: bool = True):
    """One FPN level: cur = lateral_1x1(f) + repeat2x(prev); out = conv3x3(cur).
    Returns (out, cur) when ``emit_cur`` (cur feeds the next level down) else
    out. f (B, Cl, H, W) with even H and W, prev (B, C, H/2, W/2). On the card
    the weights are packed at every call; ``fused_fpn_level_packed`` takes
    them packed."""
    _check_fpn_dims(f, prev)
    if not _on_card(f, prev):
        out, cur = fpn_level_reference(f, prev, wlat, blat, wout, bout)
        return (out, cur) if emit_cur else out
    _refuse_grad(f, prev, wlat, blat, wout, bout)
    return fused_fpn_level_packed(f, prev, pack_fpn_level(wlat, blat, wout, bout, f.dtype), emit_cur=emit_cur)


def _check_fpn_dims(f: torch.Tensor, prev: torch.Tensor) -> None:
    if f.shape[2] % 2 or f.shape[3] % 2 or tuple(prev.shape[2:]) != (f.shape[2] // 2, f.shape[3] // 2):
        raise ValueError(f"fused_fpn_level needs even dims and a half-size carry, got f "
                         f"{tuple(f.shape)}, prev {tuple(prev.shape)}")


def fused_fpn_level_packed(f: torch.Tensor, prev: torch.Tensor, packed: PackedFPNLevel, *, emit_cur: bool = True,
                           tiles: Optional[Tuple[int, Tuple[int, int]]] = None):
    """K8 on CUDA tensors with weights from ``pack_fpn_level`` at f's dtype on
    f's device. bfloat16: one 1x1 launch for the lateral and the carry into
    cur (the output, or a scratch map when ``emit_cur`` is off), then one 3x3
    launch without relu (``csrc/fused_fpn_level.cu``), with the block shapes
    ``tiles`` (mt of the 1x1, (bn, mt) of the 3x3) or ``conv1x1_tile``'s and
    ``basic_block_tile``'s."""
    if f.device.type != "cuda":
        raise ValueError(f"fused_fpn_level_packed runs on CUDA tensors, got {f.device}")
    _check_fpn_dims(f, prev)
    _refuse_grad(f, prev)
    fs = _nhwc(f, "f", packed.dtype)
    ps = _nhwc(prev, "prev", fs.dtype)
    b, h, w, cl = fs.shape
    c = ps.shape[3]
    if (cl, c) != (packed.cl, packed.c):
        raise ValueError(f"f and prev have {cl} and {c} channels, the packed level {packed.cl} and {packed.c}")
    if any(t.device != fs.device for t in packed[3:]):
        raise ValueError("the packed weights must be on f's device")
    out = torch.empty((b, h, w, c), dtype=fs.dtype, device=fs.device)
    is_bf16, device, stream = _build.launch_args(fs)
    ptrs = [t.data_ptr() for t in packed[3:]]
    if is_bf16:
        cur = torch.empty_like(out)  # the scratch map, when nobody reads cur
        sms = _build.card_sms(fs.device)
        tile1, tile3 = tiles or (conv1x1_tile(b, h, w, [cl], c, sms=sms), basic_block_tile(b, h, w, c, sms=sms))
        if tile1 not in K1X1_WARPGROUPS or tile3 not in K4_SHAPES:
            raise ValueError(f"K8 block shapes {tile1}, {tile3} are not in {K1X1_WARPGROUPS}, {K4_SHAPES}")
        lib = _build.library("fused_fpn_level", "threedod_fused_fpn_level_bf16", [_P] * 8 + [_I] * 9 + [_P])
        err = lib.threedod_fused_fpn_level_bf16(
            fs.data_ptr(), ps.data_ptr(), *ptrs, out.data_ptr(), cur.data_ptr(), b, h, w, cl, c, tile1, *tile3,
            device, stream)
    else:
        cur = torch.empty_like(out) if emit_cur else None
        lib = _build.library("fused_fpn_level", "threedod_fused_fpn_level_f32", [_P] * 8 + [_I] * 6 + [_P])
        err = lib.threedod_fused_fpn_level_f32(
            fs.data_ptr(), ps.data_ptr(), *ptrs, out.data_ptr(), None if cur is None else cur.data_ptr(),
            b, h, w, cl, c, device, stream)
    _build.check_launch(lib, "fused_fpn_level", err)
    LAUNCHES["fpn_level"] += 1
    return (_nchw(out), _nchw(cur)) if emit_cur else _nchw(out)
