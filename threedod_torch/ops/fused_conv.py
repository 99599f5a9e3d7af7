"""Fused residual-conv functions of the serving forward, kernels K4 to K8
(counterpart of ``threedod/ops/fused_conv.py``).

Five functions, each one CUDA kernel that keeps a whole subgraph's
intermediates in shared memory (``csrc/fused_*.cu`` over
``csrc/fused_conv_common.cuh``):

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
them to the f32 sums. bfloat16 runs on the tensor cores (K4 on ``wgmma``
through ``csrc/conv_wgmma.cuh``, K5 to K8 on ``mma.sync``; f32
accumulators), float32 on the CUDA cores in exact f32. K4 also takes its
weights packed once (``pack_basic_block``, ``fused_basic_block_packed``):
the ResNet blocks keep them from one weight load to the next.

A tensor on a CUDA device always goes to the kernel, which is built at first
use and launched on the current stream; a build or launch failure raises. A
tensor on the CPU goes to the plain version (``*_reference``), which the
tests and the card-side comparison also use. Every launch adds one to its
entry of ``LAUNCHES``.

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
SMS = 132  # streaming multiprocessors of an H100 SXM


def _swizzle_index(rows: int, device) -> torch.Tensor:
    """(rows, 8): the 16-byte piece of a 128-byte row that holds piece g is
    g ^ (row % 8), the 128-byte swizzle; the map is its own inverse."""
    g = torch.arange(8, device=device)
    return g[None, :] ^ (torch.arange(rows, device=device) % 8)[:, None]


def pack_conv3x3(w: torch.Tensor) -> torch.Tensor:
    """A folded 3x3 kernel (cout, cin, 3, 3) -> the bf16 layout that
    ``csrc/conv_wgmma.cuh`` copies tile by tile: (cin / 64 chunks, 9 taps,
    cout padded to 128, 64), zeros past cin and cout, each 128-byte row in the
    128-byte swizzle (the B operand of ``wgmma``, K-major)."""
    cout, cin = w.shape[:2]
    nk, coutp = -(-cin // KCHUNK), -(-cout // COUT_ALIGN) * COUT_ALIGN
    t = w.detach().to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, cout, cin)
    t = F.pad(t, (0, nk * KCHUNK - cin, 0, coutp - cout))
    t = t.reshape(9, coutp, nk, 8, 8).permute(2, 0, 1, 3, 4)
    idx = _swizzle_index(coutp, t.device)[None, None, :, :, None].expand(t.shape)
    return torch.gather(t, 3, idx).reshape(nk, 9, coutp, KCHUNK).contiguous()


def unpack_conv3x3(packed: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of ``pack_conv3x3``: (cout, cin, 3, 3) bf16."""
    nk, _, coutp, _ = packed.shape
    t = packed.reshape(nk, 9, coutp, 8, 8)
    t = torch.gather(t, 3, _swizzle_index(coutp, t.device)[None, None, :, :, None].expand(t.shape))
    t = t.permute(1, 2, 0, 3, 4).reshape(9, coutp, nk * KCHUNK)[:, :cout, :cin]
    return t.reshape(3, 3, cout, cin).permute(2, 3, 0, 1).contiguous()


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


def basic_block_tile(b: int, h: int, w: int, c: int) -> Tuple[int, int]:
    """K4's block shape (bn output channels, mt warpgroups of 64 positions),
    chosen by the whole card. The 64 mt-position tiles of the B H W positions
    times the ceil(C / bn) slices make the blocks; shared memory, registers
    and threads set how many an SM holds (k). Cost: the blocks the busiest of
    the 132 SMs takes, ceil(blocks / 132), times a block's work in 64 x 64
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
        cost = -(-blocks // SMS) * mt * bn / 64 / ((k * mt) ** K4_WG_GAIN * (bn / 64) ** K4_BN_GAIN)
        if best is None or cost < best:
            best, pick = cost, (bn, mt)
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
    bn, mt = (tile or basic_block_tile(b, h, w, c)) if bf16 else (0, 0)
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
    concat's channels, 1, 1) in that order."""
    if not _on_card(x, *children):
        return tree_tail_reference(x, children, bb_a, bb_b, wr, br, two_blocks=two_blocks,
                                   include_input_child=include_input_child, root_residual=root_residual)
    _refuse_grad(x, *children, *(bb_a or ()), *bb_b, wr, br)
    if len(children) > MAX_CHILDREN:
        raise ValueError(f"at most {MAX_CHILDREN} children, got {len(children)}")
    xs = _nhwc(x, "x")
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
    cout = wr.shape[0]
    ctot = 2 * c + sum(t.shape[3] for t in held) + (c if include_input_child else 0)
    if root_residual and cout != c:
        raise ValueError("root_residual needs as many output channels as x has")
    if cout % 4:
        raise ValueError(f"the root's output channels ({cout}) must be a multiple of 4")
    blocks = _pack_block(bb_a, xs.dtype, c, "bb_a") if two_blocks else [None] * 4  # read only when two
    blocks += _pack_block(bb_b, xs.dtype, c, "bb_b")
    wrp = _pack(wr, xs.dtype, ctot, cout, 1, "wr")
    brp = _bias(br, cout, "br")
    out = torch.empty((b, h, w, cout), dtype=xs.dtype, device=xs.device)
    lib = _build.library("fused_tree_tail", "threedod_fused_tree_tail",
                   [_P, _Children] + [_P] * 11 + [_I] * 10 + [_P])
    is_bf16, device, stream = _build.launch_args(xs)
    err = lib.threedod_fused_tree_tail(
        xs.data_ptr(), kids, *[None if t is None else t.data_ptr() for t in blocks],
        wrp.data_ptr(), brp.data_ptr(), out.data_ptr(),
        b, h, w, c, cout, int(two_blocks), int(include_input_child), int(root_residual),
        is_bf16, device, stream,
    )
    _build.check_launch(lib, "fused_tree_tail", err)
    LAUNCHES["tree_tail"] += 1
    return _nchw(out)


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
    ``wproj`` is None. x (B, Cin, 2H, 2W) -> (B, Cout, H, W); even input dims."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"fused_block_down needs even input dims, got {tuple(x.shape[2:])}")
    if not _on_card(x):
        return block_down_reference(x, w1, b1, w2, b2, wproj, bproj, pool_residual=pool_residual)
    _refuse_grad(x, w1, b1, w2, b2, wproj, bproj)
    xs = _nhwc(x, "x")
    b, hi, wi, cin = xs.shape
    c = w1.shape[0]
    if c % 16:
        raise ValueError(f"output channels ({c}) must be a multiple of 16")
    if wproj is None and cin != c:
        raise ValueError("without a projection the block must keep its channel count")
    w1p, b1p = _pack(w1, xs.dtype, cin, c, 3, "w1"), _bias(b1, c, "b1")
    w2p, b2p = _pack(w2, xs.dtype, c, c, 3, "w2"), _bias(b2, c, "b2")
    wpp = None if wproj is None else _pack(wproj, xs.dtype, cin, c, 1, "wproj")
    bpp = None if wproj is None else _bias(bproj, c, "bproj")
    out = torch.empty((b, hi // 2, wi // 2, c), dtype=xs.dtype, device=xs.device)
    lib = _build.library("fused_block_down", "threedod_fused_block_down", [_P] * 8 + [_I] * 8 + [_P])
    is_bf16, device, stream = _build.launch_args(xs)
    err = lib.threedod_fused_block_down(
        xs.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(), b2p.data_ptr(),
        None if wpp is None else wpp.data_ptr(), None if bpp is None else bpp.data_ptr(), out.data_ptr(),
        b, hi, wi, cin, c, int(pool_residual), is_bf16, device, stream,
    )
    _build.check_launch(lib, "fused_block_down", err)
    LAUNCHES["block_down"] += 1
    return _nchw(out)


def fused_conv_relu_head(x: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                         wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, wc) + bc) @ wh + bh (the RPN head: the 1x1 predictors
    are packed into wh's output channels). x (B, C, H, W), wc (Cm, C, 3, 3),
    wh (N, Cm, 1, 1) -> (B, N, H, W)."""
    if not _on_card(x):
        return conv_relu_head_reference(x, wc, bc, wh, bh)
    _refuse_grad(x, wc, bc, wh, bh)
    xs = _nhwc(x, "x")
    b, h, w, c = xs.shape
    cm, nout = wc.shape[0], wh.shape[0]
    if cm % 16:
        raise ValueError(f"the conv's output channels ({cm}) must be a multiple of 16")
    npad = -(-nout // 4) * 4  # the kernel sums 4 output channels a thread
    wcp, bcp = _pack(wc, xs.dtype, c, cm, 3, "wc"), _bias(bc, cm, "bc")
    whp = _pack(wh, xs.dtype, cm, nout, 1, "wh", pad_to=npad)
    bhp = F.pad(_bias(bh, nout, "bh"), (0, npad - nout)).contiguous()
    out = torch.empty((b, h, w, nout), dtype=xs.dtype, device=xs.device)
    lib = _build.library("fused_conv_relu_head", "threedod_fused_conv_relu_head", [_P] * 6 + [_I] * 9 + [_P])
    is_bf16, device, stream = _build.launch_args(xs)
    err = lib.threedod_fused_conv_relu_head(
        xs.data_ptr(), wcp.data_ptr(), bcp.data_ptr(), whp.data_ptr(), bhp.data_ptr(), out.data_ptr(),
        b, h, w, c, cm, npad, nout, is_bf16, device, stream,
    )
    _build.check_launch(lib, "fused_conv_relu_head", err)
    LAUNCHES["conv_relu_head"] += 1
    return _nchw(out)


def fused_fpn_level(f: torch.Tensor, prev: torch.Tensor, wlat: torch.Tensor, blat: torch.Tensor,
                    wout: torch.Tensor, bout: torch.Tensor, *, emit_cur: bool = True):
    """One FPN level: cur = lateral_1x1(f) + repeat2x(prev); out = conv3x3(cur).
    Returns (out, cur) when ``emit_cur`` (cur feeds the next level down) else
    out. f (B, Cl, H, W) with even H and W, prev (B, C, H/2, W/2)."""
    if f.shape[2] % 2 or f.shape[3] % 2 or tuple(prev.shape[2:]) != (f.shape[2] // 2, f.shape[3] // 2):
        raise ValueError(f"fused_fpn_level needs even dims and a half-size carry, got f "
                         f"{tuple(f.shape)}, prev {tuple(prev.shape)}")
    if not _on_card(f, prev):
        out, cur = fpn_level_reference(f, prev, wlat, blat, wout, bout)
        return (out, cur) if emit_cur else out
    _refuse_grad(f, prev, wlat, blat, wout, bout)
    fs = _nhwc(f, "f")
    ps = _nhwc(prev, "prev", fs.dtype)
    b, h, w, cl = fs.shape
    c = ps.shape[3]
    wlp, blp = _pack(wlat, fs.dtype, cl, c, 1, "wlat"), _bias(blat, c, "blat")
    wop, bop = _pack(wout, fs.dtype, c, c, 3, "wout"), _bias(bout, c, "bout")
    out = torch.empty((b, h, w, c), dtype=fs.dtype, device=fs.device)
    cur = torch.empty_like(out) if emit_cur else None
    lib = _build.library("fused_fpn_level", "threedod_fused_fpn_level", [_P] * 8 + [_I] * 7 + [_P])
    is_bf16, device, stream = _build.launch_args(fs)
    err = lib.threedod_fused_fpn_level(
        fs.data_ptr(), ps.data_ptr(), wlp.data_ptr(), blp.data_ptr(), wop.data_ptr(), bop.data_ptr(),
        out.data_ptr(), None if cur is None else cur.data_ptr(), b, h, w, cl, c, is_bf16, device, stream,
    )
    _build.check_launch(lib, "fused_fpn_level", err)
    LAUNCHES["fpn_level"] += 1
    return (_nchw(out), _nchw(cur)) if emit_cur else _nchw(out)
