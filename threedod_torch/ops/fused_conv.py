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
them to the f32 sums. bfloat16 runs on the tensor cores (``mma.sync``, f32
accumulators), float32 on the CUDA cores in exact f32.

A tensor on a CUDA device always goes to the kernel, which is built at first
use and launched on the current stream; a build or launch failure raises. A
tensor on the CPU goes to the plain version (``*_reference``), which the
tests and the card-side comparison also use. Every launch adds one to its
entry of ``LAUNCHES``.

Eval only, and off unless ``ENABLED`` is set: the modules ask
``fused_conv_available()``. Sums are f32 and every value between two
convolutions is rounded to the storage dtype, as in the unfused chain, so in
bf16 the two differ by roundings only (the kernels add bias and residual
before the one rounding, the chain rounds after each).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence, Tuple

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


def _nchw(out: torch.Tensor) -> torch.Tensor:
    return out.permute(0, 3, 1, 2)


def _launch_args(x: torch.Tensor):
    return int(x.dtype == torch.bfloat16), x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream


def _raise(lib, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {lib.threedod_cuda_error_string(err).decode()}")


def _library(name: str, fn: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    lib.threedod_cuda_error_string.argtypes = [ctypes.c_int]
    lib.threedod_cuda_error_string.restype = ctypes.c_char_p
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


class _Children(ctypes.Structure):
    _fields_ = [("ptr", _P * MAX_CHILDREN), ("c", _I * MAX_CHILDREN), ("n", _I)]


def fused_basic_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x): a stride-1
    residual BasicBlock that keeps its channel count. x (B, C, H, W), w1 and
    w2 (C, C, 3, 3) folded, b1 and b2 (C,) -> (B, C, H, W)."""
    if not _on_card(x):
        return basic_block_reference(x, w1, b1, w2, b2)
    xs = _nhwc(x, "x")
    b, h, w, c = xs.shape
    packed = _pack_block((w1, b1, w2, b2), xs.dtype, c, "block")
    out = torch.empty_like(xs)
    lib = _library("fused_basic_block", "threedod_fused_basic_block", [_P] * 6 + [_I] * 6 + [_P])
    is_bf16, device, stream = _launch_args(xs)
    err = lib.threedod_fused_basic_block(
        xs.data_ptr(), *[t.data_ptr() for t in packed], out.data_ptr(), b, h, w, c, is_bf16, device, stream)
    _raise(lib, "fused_basic_block", err)
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
    lib = _library("fused_tree_tail", "threedod_fused_tree_tail",
                   [_P, _Children] + [_P] * 11 + [_I] * 10 + [_P])
    is_bf16, device, stream = _launch_args(xs)
    err = lib.threedod_fused_tree_tail(
        xs.data_ptr(), kids, *[None if t is None else t.data_ptr() for t in blocks],
        wrp.data_ptr(), brp.data_ptr(), out.data_ptr(),
        b, h, w, c, cout, int(two_blocks), int(include_input_child), int(root_residual),
        is_bf16, device, stream,
    )
    _raise(lib, "fused_tree_tail", err)
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
    lib = _library("fused_block_down", "threedod_fused_block_down", [_P] * 8 + [_I] * 8 + [_P])
    is_bf16, device, stream = _launch_args(xs)
    err = lib.threedod_fused_block_down(
        xs.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(), b2p.data_ptr(),
        None if wpp is None else wpp.data_ptr(), None if bpp is None else bpp.data_ptr(), out.data_ptr(),
        b, hi, wi, cin, c, int(pool_residual), is_bf16, device, stream,
    )
    _raise(lib, "fused_block_down", err)
    LAUNCHES["block_down"] += 1
    return _nchw(out)


def fused_conv_relu_head(x: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                         wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, wc) + bc) @ wh + bh (the RPN head: the 1x1 predictors
    are packed into wh's output channels). x (B, C, H, W), wc (Cm, C, 3, 3),
    wh (N, Cm, 1, 1) -> (B, N, H, W)."""
    if not _on_card(x):
        return conv_relu_head_reference(x, wc, bc, wh, bh)
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
    lib = _library("fused_conv_relu_head", "threedod_fused_conv_relu_head", [_P] * 6 + [_I] * 9 + [_P])
    is_bf16, device, stream = _launch_args(xs)
    err = lib.threedod_fused_conv_relu_head(
        xs.data_ptr(), wcp.data_ptr(), bcp.data_ptr(), whp.data_ptr(), bhp.data_ptr(), out.data_ptr(),
        b, h, w, c, cm, npad, nout, is_bf16, device, stream,
    )
    _raise(lib, "fused_conv_relu_head", err)
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
    fs = _nhwc(f, "f")
    ps = _nhwc(prev, "prev", fs.dtype)
    b, h, w, cl = fs.shape
    c = ps.shape[3]
    wlp, blp = _pack(wlat, fs.dtype, cl, c, 1, "wlat"), _bias(blat, c, "blat")
    wop, bop = _pack(wout, fs.dtype, c, c, 3, "wout"), _bias(bout, c, "bout")
    out = torch.empty((b, h, w, c), dtype=fs.dtype, device=fs.device)
    cur = torch.empty_like(out) if emit_cur else None
    lib = _library("fused_fpn_level", "threedod_fused_fpn_level", [_P] * 8 + [_I] * 7 + [_P])
    is_bf16, device, stream = _launch_args(fs)
    err = lib.threedod_fused_fpn_level(
        fs.data_ptr(), ps.data_ptr(), wlp.data_ptr(), blp.data_ptr(), wop.data_ptr(), bop.data_ptr(),
        out.data_ptr(), None if cur is None else cur.data_ptr(), b, h, w, cl, c, is_bf16, device, stream,
    )
    _raise(lib, "fused_fpn_level", err)
    LAUNCHES["fpn_level"] += 1
    return (_nchw(out), _nchw(cur)) if emit_cur else _nchw(out)
