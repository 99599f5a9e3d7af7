#!/usr/bin/env python3
"""Smoke run of the PyTorch port (threedod_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:
  1. device: a CUDA card must be present; prints nvidia-smi's name and power
     limit, and the torch / CUDA versions;
  2. build: compiles the ROIAlign forward (K1) and backward (K2) kernels, the
     five fused-forward kernels (K4 basic block, K5 tree tail, K6 block down,
     K7 RPN head, K8 FPN level), the flash-attention forward (K9) and backward
     and the deformable sampler (K3) from the repository's sources, one nvcc
     each, started together, and prints each kernel's registers and spills
     (and ptxas's warnings that it serialised wgmma);
  3. K1 vs its plain PyTorch version on the card, at the serving path's
     and training paths' shapes (batch 8, 512x672 FPN levels, C=256; 8000,
     800 and 4096 ROIs), in f32 (TF32 off) and bf16, with max error, the
     call's time (CUDA events around the public call), the kernel's own
     device time and that of the call's other kernels (``torch.profiler``);
     K1's level assignment against ``assign_levels``; and ROIs wider than the
     32-cell window (a 256x2112 canvas), which K1 pools tap by tap;
  4. K2 vs its plain PyTorch version on the card, at the training path's
     shapes (8 x 512 ROIs), for f32 and bf16 features, with max error, the
     call's time, the device time of the kernel, of the zeroing and of the
     cast, and the largest difference between two runs of K2 on the same
     input; then the same ROIs wider than the window;
  5. K5 to K8, each vs its plain PyTorch version (a chain of cuDNN calls) on
     the card at every shape the fused serving forward launches it with
     (batch 8), in f32 (TF32 off) and bf16, with max error, times and bound;
     then K4 at its four ResNet34 launch shapes and K6 at its three with the
     subsampled residual, the same way; then K4's own device time at each
     shape (``torch.profiler``), its call with the weights packed once, its
     TFLOP/s, block shape, CTAs and cluster, and in bf16 the device time of
     every block shape it has;
  6. K9 vs its plain PyTorch version at (1, S, 16, 64) for S = 2443, 2048,
     2049, 2175 (and timed at 1370), in f32 and bf16, with max error, times,
     bound and the time of ``scaled_dot_product_attention`` on the same
     tensors and the ratio of the two; K9's backward after its forward with
     the log-sum-exp at (2, 2117), (1, 2443), (1, 2049) and (1, 2175) x (16,
     64), in both dtypes, against the plain backward, bit-equal twice, beside
     SDPA's backward alone (``torch.autograd.grad`` on one retained forward);
     then K3 vs its plain version at GroundingDINO's two launch
     shapes at 800x800 (Lq 13294 and 900, levels 100x100 to 13x13, 8 heads of
     32, 4 points), in f32 and bf16, with max error, times, bound and the time
     of the grid_sample composition (four calls and a weighted sum);
  7. serving path: ``threedod_torch.infer`` on the DLA34-FPN configuration
     (batch 8, 512x672, bf16, 38 classes, 100 detections, seeded weights),
     first with the fused forward on, then stock: shapes, finiteness, kernel
     launch counts, ms per forward and images/s, and the stage times of
     trunk + FPN and of the RPN head; then the same on ResNet34-FPN (fused: 13
     K4, 3 K6, 3 K8, 5 K7 and 2 K1 launches a forward), and the stock forward
     of DenseNet121, MNASNet and ShuffleNet under the FPN (finite, ms);
  8. fused vs stock on the card: the f32 forward at batch 2 (features, RPN
     outputs, detections) and the bf16 features and logits at batch 8, for
     DLA34 and ResNet34;
  9. training path: ``threedod_torch.train`` on DLA34 and on ResNet34 (batch
     8, 512x672, bf16, 512 sampled ROIs an image, seeded weights and
     batches): finite losses of the expected keys, parameters and running
     statistics moved, no step skipped, one K1 and one K2 launch per step, ms
     per step, images/s and peak memory;
 10. card vs CPU: the f32 DLA34 forward, and one f32 training step (losses and
     a handful of gradient leaves) on the card and on the CPU, same weights
     and sampling noise, batch 2;
 11. depth path: ``threedod_torch.depth_infer`` on Depth-Anything-V2 ``vitl``
     (one 518x924 image, 2443 tokens, bf16, seeded weights): shape, finite
     depths inside (0, 20), 24 K9 launches, ms per forward; then ``vits`` in
     f32 on the card (K9) against the CPU (plain attention);
 12. GroundingDINO path: ``threedod_torch.gdino_infer`` (Swin-T, BERT-base,
     6 + 6 layers, 900 queries, one 800x800 image, bf16, seeded weights, the
     prompt "ground."): shapes, finite logits, boxes in [0, 1], 12 K3 launches
     a forward, ms per forward and the stages' times; then a reduced model in
     f32 on the card (K3) against the CPU (plain sampler): same queries,
     tokens, logits and boxes; K3 asked for a gradient on the card raises;
 13. depth fine-tuning: ``train.depth.DepthTrainer`` on Depth-Anything-V2
     ``vitl`` in f32, batch 2 at 644x644 (2117 tokens, seeded weights, one
     synthetic batch): ms per step, images/s, peak memory, forward, backward
     and optimizer spans, 24 K9 forward and 24 K9 backward launches a step,
     a falling loss, both parameter groups moved; then ``python -m
     threedod_torch.train_depth`` in-process (vits, 644, one synthetic epoch
     with evaluation and ``latest.pt``, reloaded strictly); then one vits
     loss and backward on the card (K9 both ways) against the CPU (plain
     versions): the loss and five parameters' gradients.
The line before the last is a JSON object with each kernel's launches, error,
times and bound (K1, K2 and K4 also ``kernel_ms``, the device time of the
kernel alone beside ``ms``, the call's); the last line is {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = {
    "roi_align_fwd": dict(source="threedod_torch/ops/csrc/roi_align_fwd.cu",
                          replaces="threedod/ops/roi_align_pallas.py:144"),
    "roi_align_bwd": dict(source="threedod_torch/ops/csrc/roi_align_bwd.cu",
                          replaces="threedod/ops/roi_align_pallas.py:623"),
    "fused_basic_block": dict(source="threedod_torch/ops/csrc/fused_basic_block.cu",
                              replaces="threedod/ops/fused_conv.py:287"),
    "fused_tree_tail": dict(source="threedod_torch/ops/csrc/fused_tree_tail.cu",
                            replaces="threedod/ops/fused_conv.py:369"),
    "fused_block_down": dict(source="threedod_torch/ops/csrc/fused_block_down.cu",
                             replaces="threedod/ops/fused_conv.py:511"),
    "fused_conv_relu_head": dict(source="threedod_torch/ops/csrc/fused_conv_relu_head.cu",
                                 replaces="threedod/ops/fused_conv.py:568"),
    "fused_fpn_level": dict(source="threedod_torch/ops/csrc/fused_fpn_level.cu",
                            replaces="threedod/ops/fused_conv.py:661"),
    "flash_attention_fwd": dict(source="threedod_torch/ops/csrc/flash_attention_fwd.cu",
                                replaces="threedod/ops/attention.py:51"),
    "flash_attention_bwd": dict(source="threedod_torch/ops/csrc/flash_attention_bwd.cu",
                                replaces="threedod/ops/attention.py:89 -> jax/experimental/pallas/ops/tpu/"
                                         "flash_attention.py:1121 (_flash_attention_dkv_kernel :796) and :1456 "
                                         "(_flash_attention_dq_kernel :1146)"),
    "ms_deform_sample": dict(source="threedod_torch/ops/csrc/ms_deform_sample.cu",
                             replaces="threedod/models/gdino/deformable.py:159"),
}
# backbone -> name in fused_conv.LAUNCHES -> launches in one fused bs8 512x672 forward
FUSED_LAUNCHES = {
    "dla34": {"basic_block": 0, "tree_tail": 6, "block_down": 4, "conv_relu_head": 5, "fpn_level": 3},
    "resnet34": {"basic_block": 13, "tree_tail": 0, "block_down": 3, "conv_relu_head": 5, "fpn_level": 3},
}
# K1 vs plain: f32 sums in another order -> 1e-5 absolute on unit-variance
# features; bf16 -> one rounding of the bf16 output, 2^-7 of the largest value
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# K2 vs plain: both sum hundreds of f32 contributions per cell with atomics,
# in an order that changes from run to run -> 1e-5 of the largest entry; with
# bf16 features one rounding of the bf16 result, 2^-7 of the largest entry
TOL_BWD = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# K4 to K8 vs plain. f32: sums of up to 4608 terms in another order than
# cuDNN's, through up to four convolutions -> 1e-4 of the largest entry. bf16:
# the kernels add bias and residual to the f32 sum and round once where the
# chain rounds after each step, and a flipped rounding of an intermediate is
# carried on by the next convolution -> 2^-6 of the largest entry
TOL_FUSED = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# K9 vs plain. f32: sums of 2443 terms in another order, exponentials of the
# same arguments -> 1e-5 of the largest entry. bf16: the probabilities are
# rounded to bf16 before the second product and the output once more -> 2^-7
# of the largest entry
TOL_ATTN = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the tensor
# cores, dense bf16 and TF32 FLOP/s of the tensor cores
PEAK_BYTES, PEAK_F32, PEAK_BF16, PEAK_TF32 = 3.35e12, 67e12, 989e12, 495e12
LOSS_KEYS = {"BoxHead/loss_cls", "BoxHead/loss_box_reg", "Cube/uncert", "Cube/loss_dims", "Cube/loss_xy",
             "Cube/loss_z", "Cube/loss_pose", "Cube/loss_joint", "rpn/cls", "rpn/loc"}


def build_report(log: str):
    """ptxas's registers, spills and serialisation warnings of each kernel in
    an nvcc log, one line a kernel: "<mangled name>: <registers>, <spills>"."""
    name, spills = None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spills = line
        elif "registers" in line:
            yield f"{name}: {line.split(':', 1)[-1].strip()}; {spills}"
        elif "C7513" in line or "C7510" in line:
            yield line


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, kernels) -> dict:
    """Mean device time of one call of ``fn`` by kernel, from
    ``torch.profiler``: {label: ms} for each label of ``kernels`` (label ->
    substring of the kernel's name, or a tuple of them), plus "all", every
    kernel the calls ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys([*kernels, "all"], 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        total["all"] += us
        for label, sub in kernels.items():
            if any(k in evt.key for k in ((sub,) if isinstance(sub, str) else sub)):
                total[label] += us
    check(all(total[label] > 0 for label in kernels), f"the profiler saw no device time for {sorted(kernels)}")
    return {k: v / iters / 1e3 for k, v in total.items()}


def random_boxes(torch, n_img, n, h, w, gen, device):
    """Detection-like ROIs: log-uniform sizes 8..512 px, aspect up to 3,
    clipped to the image."""
    u = torch.rand((n_img, n, 4), generator=gen)
    side = torch.exp(torch.log(torch.tensor(8.0)) + u[..., 0] * torch.log(torch.tensor(64.0)))
    ar = torch.exp((u[..., 1] - 0.5) * torch.log(torch.tensor(3.0)))
    bw, bh = side * ar.sqrt(), side / ar.sqrt()
    cx, cy = u[..., 2] * w, u[..., 3] * h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, h)
    return boxes.to(device).contiguous()


def _level_feats(torch, roi_align, gen, dev, b=8, c=256, h=512, w=672):
    return {
        nm: torch.randn((b, c, -(-h // s), -(-w // s)), generator=gen)
        .to(dev).contiguous(memory_format=torch.channels_last)
        for nm, s in roi_align.STRIDES.items()
    }


def roi_align_bound_ms(feats, n_rois: int, pooled_itemsize: int, s: int = 7, r: int = 2):
    """Least time for one ROIAlign pass in either direction: the level maps
    and the pooled block (or its cotangent) each cross the memory once, and
    every bin does r*r samples of 4 taps, one multiply-add a channel."""
    c = next(iter(feats.values())).shape[1]
    map_bytes = sum(t.numel() * t.element_size() for t in feats.values())
    pooled_bytes = n_rois * s * s * c * pooled_itemsize
    by_bytes = (map_bytes + pooled_bytes + n_rois * 20) / PEAK_BYTES * 1e3
    by_ops = n_rois * s * s * r * r * 4 * c * 2 / PEAK_F32 * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def wide_case(torch, roi_align, gen, dev):
    """Features of a 256x2112 canvas (p6 is 4 x 33 cells) and 2 x 64 ROIs,
    the first three clamped at p6 with taps over more than the 32-cell
    window: the kernels' per-tap path."""
    b, n, h, w = 2, 64, 256, 2112
    feats = _level_feats(torch, roi_align, gen, dev, b=b, h=h, w=w)
    boxes = random_boxes(torch, b, n, h, w, gen, "cpu")
    boxes[:, :3] = torch.tensor([[0.0, 0.0, 2112.0, 256.0], [3.0, 40.0, 2110.0, 90.0], [20.0, 0.0, 2090.0, 255.0]])
    names = sorted(roi_align.STRIDES)
    level = roi_align.assign_levels(boxes.reshape(-1, 4), names).reshape(b, n)
    check(bool((level[:, :3] == 4).all()), "the wide ROIs are not on p6")
    check(bool(((boxes[:, :3, 2] - boxes[:, :3, 0]) / 64.0 > 32.0).all()), "the wide ROIs fit the window")
    return feats, boxes.to(dev).contiguous()


def phase_kernel(torch, dev):
    from threedod_torch.ops import roi_align, roi_align_cuda

    gen = torch.Generator().manual_seed(0)
    b, c, h, w = 8, 256, 512, 672
    feats32 = _level_feats(torch, roi_align, gen, dev)
    wide32, wide_boxes = wide_case(torch, roi_align, gen, dev)
    results = {}
    with torch.no_grad():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            feats = {k: v.to(dtype) for k, v in feats32.items()}
            for n in (1000, 100, 512):  # box branch, cube branch, training
                boxes = random_boxes(torch, b, n, h, w, gen, dev)
                out = roi_align_cuda.multilevel_roi_align(feats, boxes)
                ref = roi_align.multilevel_roi_align(feats, boxes)
                torch.cuda.synchronize()
                check(out.shape == ref.shape == (b, n, 7, 7, c), f"K1 shape {tuple(out.shape)}")
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = TOL[dtype_name] * (scale if dtype_name == "bfloat16" else 1.0)

                def call():
                    return roi_align_cuda.multilevel_roi_align(feats, boxes)

                ms = cuda_ms(call, iters=20)
                dev_ms = device_ms(torch, call, 20, {"kernel": "roi_align_fwd_kernel"})
                plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align(feats, boxes), iters=3)
                bound, by = roi_align_bound_ms(feats, b * n, out.element_size())
                print(f"[K1] {dtype_name} rois={b * n}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                      f"call {ms:.4f} ms, kernel (device) {dev_ms['kernel']:.4f} ms, the call's other kernels "
                      f"{dev_ms['all'] - dev_ms['kernel']:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bound:.4f} ms ({by})", flush=True)
                check(err <= tol, f"K1 {dtype_name} rois={b * n} disagrees with the plain version: {err} > {tol}")
                names = sorted(feats)
                _, level = roi_align_cuda.roi_align_cuda(names, [feats[nm].permute(0, 2, 3, 1) for nm in names], boxes)
                want = roi_align.assign_levels(boxes.reshape(-1, 4), names).reshape(b, n)
                check(torch.equal(level.long(), want), f"K1's levels differ from assign_levels at rois={b * n}")
                results[(dtype_name, b * n)] = dict(max_abs_err=err, ms=ms, kernel_ms=dev_ms["kernel"],
                                                    plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            wide = {k: v.to(dtype) for k, v in wide32.items()}
            out = roi_align_cuda.multilevel_roi_align(wide, wide_boxes)
            ref = roi_align.multilevel_roi_align(wide, wide_boxes)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[dtype_name] * (ref.float().abs().max().item() if dtype_name == "bfloat16" else 1.0)
            print(f"[K1] {dtype_name} 256x2112 canvas, 2 x 64 ROIs, 6 wider than the window: "
                  f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
            check(err <= tol, f"K1 {dtype_name} on ROIs wider than the window disagrees: {err} > {tol}")
    return results


def phase_kernel_bwd(torch, dev):
    """K2 against the plain backward at the training shapes: 8 x 512 ROIs."""
    from threedod_torch.ops import roi_align, roi_align_cuda

    gen = torch.Generator().manual_seed(1)
    b, n, c, h, w = 8, 512, 256, 512, 672
    names = sorted(roi_align.STRIDES)
    feats32 = _level_feats(torch, roi_align, gen, dev)
    boxes = random_boxes(torch, b, n, h, w, gen, dev)
    grad = torch.randn((b, n, 7, 7, c), generator=gen).to(dev)
    wide32, wide_boxes = wide_case(torch, roi_align, gen, dev)
    wide_grad = torch.randn((*wide_boxes.shape[:2], 7, 7, c), generator=gen).to(dev)

    def cases(feats, boxes, grad):
        shapes = [tuple(feats[nm].shape[2:]) for nm in names]
        scales = [1.0 / roi_align.STRIDES[nm] for nm in names]
        level = roi_align.assign_levels(boxes.reshape(-1, 4), names).reshape(boxes.shape[:2])
        level32 = level.to(torch.int32).contiguous()
        return (lambda dtype: roi_align_cuda.roi_align_backward_cuda(grad, boxes, level32, names, shapes, 2, dtype),
                lambda dtype: roi_align.roi_align_backward(grad, boxes, level, shapes, scales, 2, dtype))

    def compare(kernel, plain, dtype):
        out, again, ref = kernel(dtype), kernel(dtype), plain(dtype)
        torch.cuda.synchronize()
        for o, r, nm in zip(out, ref, names):
            check(o.shape == r.shape and o.dtype == dtype, f"K2 {nm}: {tuple(o.shape)} {o.dtype}")
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        rerun = max((o.float() - a.float()).abs().max().item() for o, a in zip(out, again))
        return err, rerun, max(r.float().abs().max().item() for r in ref)

    kernel, plain = cases(feats32, boxes, grad)
    wide_kernel, wide_plain = cases(wide32, wide_boxes, wide_grad)
    results = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        err, rerun, scale = compare(kernel, plain, dtype)
        tol = TOL_BWD[dtype_name] * scale
        ms = cuda_ms(lambda: kernel(dtype), iters=10)
        dev_ms = device_ms(torch, lambda: kernel(dtype), 10, {
            "kernel": "roi_align_bwd_kernel", "zero": "FillFunctor",
            **({"cast": "copy_kernel"} if dtype == torch.bfloat16 else {})})
        plain_ms = cuda_ms(lambda: plain(dtype), iters=2, warmup=1)
        feats = {k: v.to(dtype) for k, v in feats32.items()}
        bound, by = roi_align_bound_ms(feats, b * n, grad.element_size())
        print(f"[K2] {dtype_name} rois={b * n}: max_abs_err={err:.3e} (tol {tol:.3e}, largest entry {scale:.2f}) "
              f"call {ms:.4f} ms, kernel (device) {dev_ms['kernel']:.4f} ms, zeroing {dev_ms['zero']:.4f} ms, "
              f"cast {dev_ms.get('cast', 0.0):.4f} ms, all kernels of the call {dev_ms['all']:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"two runs of K2 differ by at most {rerun:.3e}", flush=True)
        check(err <= tol, f"K2 {dtype_name} disagrees with the plain version: {err} > {tol}")
        check(rerun <= tol, f"two runs of K2 ({dtype_name}) differ by {rerun} > {tol}")
        results[dtype_name] = dict(max_abs_err=err, ms=ms, kernel_ms=dev_ms["kernel"], plain_ms=plain_ms,
                                   bound_ms=bound, bound_by=by)
        err, rerun, scale = compare(wide_kernel, wide_plain, dtype)
        tol = TOL_BWD[dtype_name] * scale
        print(f"[K2] {dtype_name} 256x2112 canvas, 2 x 64 ROIs, 6 wider than the window: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}); two runs differ by at most {rerun:.3e}", flush=True)
        check(err <= tol and rerun <= tol, f"K2 {dtype_name} on ROIs wider than the window: {err}, {rerun} > {tol}")
    # a level no ROI touches comes back as exact zeros
    shapes = [tuple(feats32[nm].shape[2:]) for nm in names]
    small = boxes.clamp(max=100.0)
    lvl = roi_align.assign_levels(small.reshape(-1, 4), names).reshape(b, n).to(torch.int32).contiguous()
    out = roi_align_cuda.roi_align_backward_cuda(grad, small, lvl, names, shapes, 2, torch.bfloat16)
    torch.cuda.synchronize()
    check(int(lvl.max()) < 4, "the untouched-level case touches p6")
    check(not bool(out[4].any()), "K2 left non-zero values in a level no ROI touches")
    return results


# Launch shapes of the fused bs8 512x672 DLA34-FPN forward.
# K5: (C, H, W, two blocks, children's channels, x as last child)
TREE_TAIL_SHAPES = [(64, 128, 168, False, (), False), (128, 64, 84, False, (), False),
                    (128, 64, 84, True, (64,), True), (256, 32, 42, False, (), False),
                    (256, 32, 42, True, (128,), True), (512, 16, 21, False, (256,), False)]
BLOCK_DOWN_SHAPES = [(32, 64, 256, 336), (64, 128, 128, 168), (128, 256, 64, 84), (256, 512, 32, 42)]  # Cin, C, Hi, Wi
HEAD_SHAPES = [(128, 168), (64, 84), (32, 42), (16, 21), (8, 11)]  # C = 256, 15 outputs
FPN_SHAPES = [(256, 32, 42, True), (128, 64, 84, True), (64, 128, 168, False)]  # Cl, H, W, emit_cur; C = 256


def fused_bound_ms(tensors, macs: int, dtype_name: str):
    """Least time for one fused call: every input, weight and output crosses
    the memory once; the multiply-adds run at the tensor cores' dense bf16
    peak, or at the f32 peak outside them for f32 inputs."""
    by_bytes = sum(t.numel() * t.element_size() for t in tensors) / PEAK_BYTES * 1e3
    by_ops = 2 * macs / (PEAK_BF16 if dtype_name == "bfloat16" else PEAK_F32) * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# Launch shapes of the fused bs8 512x672 ResNet34-FPN forward (its K8 and K7
# shapes are the DLA34 forward's). K4: (C, H, W, launches); K6 with the
# subsampled residual: (Cin, C, Hi, Wi)
BASIC_BLOCK_SHAPES = [(64, 128, 168, 3), (128, 64, 84, 3), (256, 32, 42, 5), (512, 16, 21, 2)]
RESNET_BLOCK_DOWN_SHAPES = [(64, 128, 128, 168), (128, 256, 64, 84), (256, 512, 32, 42)]


def _seeded(torch, dev, dtype, seed, b=8):
    """Makers of seeded inputs: activations of unit variance (channels-last),
    lecun-normal weights, biases of 0.1, a BasicBlock's four tensors."""
    gen = torch.Generator().manual_seed(seed)

    def act(c, h, w):
        return torch.randn((b, c, h, w), generator=gen).to(dev, dtype).contiguous(memory_format=torch.channels_last)

    def weight(cout, cin, k):
        return (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(dev)

    def bias(c):
        return (0.1 * torch.randn(c, generator=gen)).to(dev)

    def block(cin, c):
        return (weight(c, cin, 3), bias(c), weight(c, c, 3), bias(c))

    return act, weight, bias, block


def _fused_cases(torch, dev, dtype):
    """(kernel, label, fused call, plain call, tensors that cross the memory,
    multiply-adds, output shape, launches a forward) for every launch shape of
    the DLA34 forward, on seeded inputs."""
    from threedod_torch.ops import fused_conv as fcv

    b = 8
    act, weight, bias, block = _seeded(torch, dev, dtype, seed=2)
    for c, h, w, two, kid_c, incl in TREE_TAIL_SHAPES:
        x, kids = act(c, h, w), [act(k, h, w) for k in kid_c]
        bb_a, bb_b = (block(c, c) if two else None), block(c, c)
        ctot = 2 * c + sum(kid_c) + (c if incl else 0)
        wr, br = weight(c, ctot, 1), bias(c)
        kw = dict(two_blocks=two, include_input_child=incl)
        args = (x, kids, bb_a, bb_b, wr, br)
        convs = [t for bb in (bb_a, bb_b) if bb for t in bb]
        macs = b * h * w * ((4 if two else 2) * 9 * c * c + ctot * c)
        yield ("tree_tail", f"C={c} {h}x{w} {'two blocks' if two else 'one block'} children={list(kid_c)}"
               f"{'+x' if incl else ''}",
               lambda a=args, k=kw: fcv.fused_tree_tail(*a, **k), lambda a=args, k=kw: fcv.tree_tail_reference(*a, **k),
               [x, *kids, *convs, wr, br], macs, (b, c, h, w), 1)
    for cin, c, hi, wi in BLOCK_DOWN_SHAPES:
        x = act(cin, hi, wi)
        args = (x, *block(cin, c), weight(c, cin, 1), bias(c))
        macs = b * (hi // 2) * (wi // 2) * (9 * cin * c + 9 * c * c + cin * c)
        yield ("block_down", f"Cin={cin} C={c} {hi}x{wi}",
               lambda a=args: fcv.fused_block_down(*a), lambda a=args: fcv.block_down_reference(*a),
               list(args), macs, (b, c, hi // 2, wi // 2), 1)
    for h, w in HEAD_SHAPES:
        args = (act(256, h, w), weight(256, 256, 3), bias(256), weight(15, 256, 1), bias(15))
        macs = b * h * w * (9 * 256 * 256 + 256 * 15)
        yield ("conv_relu_head", f"C=256 {h}x{w}",
               lambda a=args: fcv.fused_conv_relu_head(*a), lambda a=args: fcv.conv_relu_head_reference(*a),
               list(args), macs, (b, 15, h, w), 1)
    for cl, h, w, emit in FPN_SHAPES:
        args = (act(cl, h, w), act(256, h // 2, w // 2), weight(256, cl, 1), bias(256), weight(256, 256, 3), bias(256))
        macs = b * h * w * (cl * 256 + 9 * 256 * 256)
        yield ("fpn_level", f"Cl={cl} {h}x{w} emit_cur={emit}",
               lambda a=args, e=emit: fcv.fused_fpn_level(*a, emit_cur=e),
               lambda a=args, e=emit: fcv.fpn_level_reference(*a)[: 2 if e else 1],
               list(args), macs, (b, 256, h, w), 1)


def _resnet_cases(torch, dev, dtype):
    """The same for the launch shapes only the ResNet34 forward has: K4, and
    K6 with the subsampled residual through the folded 1x1 downsample."""
    from threedod_torch.ops import fused_conv as fcv

    b = 8
    act, weight, bias, block = _seeded(torch, dev, dtype, seed=4)
    for c, h, w, count in BASIC_BLOCK_SHAPES:
        args = (act(c, h, w), *block(c, c))
        yield ("basic_block", f"C={c} {h}x{w} (x{count})",
               lambda a=args: fcv.fused_basic_block(*a), lambda a=args: fcv.basic_block_reference(*a),
               list(args), b * h * w * 2 * 9 * c * c, (b, c, h, w), count)
    for cin, c, hi, wi in RESNET_BLOCK_DOWN_SHAPES:
        args = (act(cin, hi, wi), *block(cin, c), weight(c, cin, 1), bias(c))
        macs = b * (hi // 2) * (wi // 2) * (9 * cin * c + 9 * c * c + cin * c)
        yield ("block_down", f"Cin={cin} C={c} {hi}x{wi} subsampled residual",
               lambda a=args: fcv.fused_block_down(*a, pool_residual=False),
               lambda a=args: fcv.block_down_reference(*a, pool_residual=False),
               list(args), macs, (b, c, hi // 2, wi // 2), 1)


# device-time names of K4's kernels: bf16 conv3x3_wgmma (two launches a
# call), f32 basic_block_f32_kernel; the earlier one-launch design's
# basic_block_kernel
K4_KERNELS = ("conv3x3_wgmma", "basic_block")


def _k4_device_ms(torch, fn) -> float:
    """Device time of K4's own kernels in one call of ``fn``."""
    return device_ms(torch, fn, 10, {"k4": K4_KERNELS})["k4"]


def phase_k4(torch, dev, rows=None):
    """K4 at its four ResNet34 launch shapes (the inputs of ``_resnet_cases``):
    the kernels' own device time beside the call with weights packed once (what
    the ResNet blocks pay), TFLOP/s on the kernel time, and the grid: blocks
    of (bn output channels, warpgroups of 64 positions), CTAs a launch, no
    cluster; in bf16 also every block shape the kernel has. ``rows`` (phase
    5's bf16 and f32 rows of ``basic_block``) get these numbers added. Runs
    on a package with the earlier one-launch design too (no packing, no
    block shapes), for comparisons."""
    from threedod_torch.ops import fused_conv as fcv

    redesign = hasattr(fcv, "pack_basic_block")
    out = {}
    with torch.no_grad():
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            act, weight, bias, block = _seeded(torch, dev, dtype, seed=4)
            for i, (c, h, w, count) in enumerate(BASIC_BLOCK_SHAPES):
                x, *bb = (act(c, h, w), *block(c, c))
                flops = 2 * 8 * h * w * 2 * 9 * c * c
                row = {}
                if redesign:
                    packed = fcv.pack_basic_block(*bb, dtype)
                    call = lambda x=x, p=packed: fcv.fused_basic_block_packed(x, p)  # noqa: E731
                    row["packed_call_ms"] = cuda_ms(call, iters=10, warmup=2)
                else:
                    call = lambda x=x, bb=bb: fcv.fused_basic_block(x, *bb)  # noqa: E731
                row["kernel_ms"] = _k4_device_ms(torch, call)
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                text = (f"kernel (device) {row['kernel_ms']:.4f} ms, {row['kernel_tflops']:.1f} TFLOP/s"
                        + (f", call with packed weights {row['packed_call_ms']:.4f} ms" if redesign else ""))
                if redesign and dtype == torch.bfloat16:
                    bn, mt = fcv.basic_block_tile(8, h, w, c)
                    row.update(block=[bn, mt], ctas=-(-8 * h * w // (64 * mt)) * -(-c // bn), cluster=1)
                    shapes = {}
                    for tile in fcv.K4_SHAPES:
                        shapes[f"{tile[0]}x{tile[1]}"] = _k4_device_ms(
                            torch, lambda x=x, p=packed, t=tile: fcv.fused_basic_block_packed(x, p, t))
                    row["block_shapes_ms"] = shapes
                    text += (f"; block {bn} channels x {mt} warpgroups ({64 * mt} positions), 2 launches of "
                             f"{row['ctas']} CTAs, cluster 1; block shapes (bn x warpgroups) "
                             + ", ".join(f"{k} {v:.4f}" for k, v in shapes.items()) + " ms")
                if rows is not None:
                    base = rows[dtype_name][i]
                    base.update(row)
                    text = (f"call {base['ms']:.4f} ms, cuDNN chain {base['plain_ms']:.4f} ms, bound "
                            f"{base['bound_ms']:.4f} ms ({base['bound_by']}); ") + text
                print(f"[K4] {dtype_name} C={c} {h}x{w} (x{count}): {text}", flush=True)
                out.setdefault(dtype_name, []).append(dict(count=count, **row))
            summed = {k: sum(r["count"] * r[k] for r in out[dtype_name]) for k in ("kernel_ms", "packed_call_ms")
                      if k in out[dtype_name][0]}
            print(f"[K4] {dtype_name}, summed over the 13 launches of one resnet34 forward: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in summed.items()), flush=True)
    return out


def phase_fused_kernels(torch, dev, cases, backbone):
    """K4 to K8 against their plain versions at every launch shape ``cases``
    yields. Returns {kernel: {dtype: [per-shape dict]}}; times and bounds of a
    shape are those of one launch, ``count`` says how many a forward makes."""
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 convs in full f32
    results = {}
    with torch.no_grad():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for kernel, label, fused, plain, moved, macs, out_shape, count in cases(torch, dev, dtype):
                out, ref = fused(), plain()
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                check(len(outs) == len(refs), f"{kernel} {label}: {len(outs)} outputs, plain has {len(refs)}")
                err = scale = 0.0
                for o, r in zip(outs, refs):
                    check(tuple(o.shape) == tuple(r.shape) == out_shape and o.dtype == dtype,
                          f"{kernel} {label}: output {tuple(o.shape)} {o.dtype}")
                    check(o.is_contiguous(memory_format=torch.channels_last), f"{kernel} {label}: not channels-last")
                    check(bool(torch.isfinite(o.float()).all()), f"{kernel} {label}: non-finite output")
                    err = max(err, (o.float() - r.float()).abs().max().item())
                    scale = max(scale, r.float().abs().max().item())
                tol = TOL_FUSED[dtype_name] * scale
                ms = cuda_ms(fused, iters=3, warmup=1)
                plain_ms = cuda_ms(plain, iters=3, warmup=1)
                bound, by = fused_bound_ms(moved + list(outs), macs, dtype_name)
                print(f"[{kernel}] {dtype_name} {label}: max_abs_err={err:.3e} (tol {tol:.3e}, largest entry "
                      f"{scale:.2f}) kernel {ms:.4f} ms, plain (cuDNN chain) {plain_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by}), {2 * macs / ms / 1e9:.2f} TFLOP/s", flush=True)
                check(err <= tol, f"{kernel} {dtype_name} {label} disagrees with the plain version: {err} > {tol}")
                results.setdefault(kernel, {}).setdefault(dtype_name, []).append(dict(
                    shape=label, count=count, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
    for kernel, by_dtype in results.items():
        for dtype_name, rows in by_dtype.items():
            n = sum(r["count"] for r in rows)
            check(n == FUSED_LAUNCHES[backbone][kernel],
                  f"{kernel}: {n} launches compared, the {backbone} forward makes {FUSED_LAUNCHES[backbone][kernel]}")
            print(f"[{kernel}] {dtype_name}, summed over the {n} launches of one {backbone} forward: "
                  f"kernel {_total(rows, 'ms'):.4f} ms, plain {_total(rows, 'plain_ms'):.4f} ms, "
                  f"bound {_total(rows, 'bound_ms'):.4f} ms", flush=True)
    return results


def _total(rows, key):
    """A per-launch quantity summed over the launches of one forward."""
    return sum(r["count"] * r[key] for r in rows)


def f32_ops_ms(ops: float) -> float:
    """Least time for ``ops`` f32 operations to f32 accuracy: on the CUDA cores
    at the f32 peak, or as three TF32 passes (3xTF32) on the tensor cores,
    whichever is faster (the second, on an H100)."""
    return min(ops / PEAK_F32, 3.0 * ops / PEAK_TF32) * 1e3


def attention_bound_ms(q, dtype_name: str):
    """Least time for one attention call: q, k, v and the output cross the
    memory once; 4 * B * H * S^2 * D operations at the tensor cores' dense bf16
    peak, or for f32 inputs to f32 accuracy (``f32_ops_ms``)."""
    b, s, h, d = q.shape
    by_bytes = 4 * q.numel() * q.element_size() / PEAK_BYTES * 1e3
    ops = 4.0 * b * h * s * s * d
    by_ops = ops / PEAK_BF16 * 1e3 if dtype_name == "bfloat16" else f32_ops_ms(ops)
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# K9's forward shapes at 16 heads: the depth path's (vitl at 518x924), the
# dispatch threshold, one-row tails past 64- and 128-row tiles, and the native
# 518x518 grid's 1370 tokens, which the port's dispatch leaves to the plain
# version (timed only for comparison)
ATTN_TOKENS = (2443, 2048, 2049, 2175, 1370)


def phase_attention_kernel(torch, dev):
    """K9 against its plain version at ``ATTN_TOKENS``, on the strided slices
    of one qkv projection as the ViT passes them, and its time beside
    ``scaled_dot_product_attention``'s (20 iterations each in bf16, 5 in f32)
    with their ratio. Returns {(dtype, tokens): dict}."""
    import torch.nn.functional as F

    from threedod_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    results = {}
    with torch.no_grad():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for s in ATTN_TOKENS:
                qkv = torch.randn((1, s, 3, 16, 64), generator=gen).to(dev, dtype)
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

                def kernel():
                    return attention.flash_attention(q, k, v)

                def plain():
                    return attention.attention_reference(q, k, v)

                def library():
                    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

                out, ref, lib = kernel(), plain(), library().transpose(1, 2)
                torch.cuda.synchronize()
                check(out.shape == ref.shape == (1, s, 16, 64) and out.dtype == dtype, f"K9 output {tuple(out.shape)}")
                check(bool(torch.isfinite(out.float()).all()), f"K9 {dtype_name} S={s}: non-finite output")
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                lib_err = (lib.float() - ref.float()).abs().max().item()
                tol = TOL_ATTN[dtype_name] * scale
                iters = 20 if dtype_name == "bfloat16" else 5
                ms, plain_ms, library_ms = cuda_ms(kernel, iters), cuda_ms(plain, 5), cuda_ms(library, iters)
                bound, by = attention_bound_ms(q, dtype_name)
                print(f"[K9] {dtype_name} (1, {s}, 16, 64): max_abs_err={err:.3e} (tol {tol:.3e}, largest entry "
                      f"{scale:.2f}; the library call is off by {lib_err:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms, scaled_dot_product_attention {library_ms:.4f} ms, kernel/SDPA {ms / library_ms:.3f}, "
                      f"bound {bound:.4f} ms ({by}), {4.0 * 16 * s * s * 64 / ms / 1e9:.2f} TFLOP/s", flush=True)
                check(err <= tol, f"K9 {dtype_name} S={s} disagrees with the plain version: {err} > {tol}")
                results[(dtype_name, s)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                                bound_by=by, library_ms=library_ms, ratio=ms / library_ms)
    return results


# K9's backward vs plain. f32: dq, dk, dv are sums of 2117 to 2443 products
# of rebuilt probabilities in another order than cuBLAS's, and dS subtracts
# delta from dP, which cancels: 1e-4 of each tensor's largest entry. bf16: the
# same f32 sums rounded once to bf16 (2^-8 relative), where the plain version
# also rounds once, so two roundings can fall apart by one step of the
# largest entry's binade: 2^-6 of the largest entry. lse: f32 sums and
# logarithms of the same logits in both dtypes (the bf16 kernel keeps its
# maximum in log2 units and converts once), 1e-5 of the largest entry
TOL_ATTN_BWD = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
TOL_LSE = 1e-5
# K9's backward shapes: the vitl training step at 644x644 (bs2, 46 * 46 + 1
# tokens), the depth cell's frame at 518x924 (37 * 66 + 1 tokens), and
# one-row tails past 64- and 128-row tiles
ATTN_BWD_SHAPES = [(2, 2117, 16, 64), (1, 2443, 16, 64), (1, 2049, 16, 64), (1, 2175, 16, 64)]


def attention_bwd_bound_ms(q, dtype_name: str):
    """Least time for one attention backward: q, k, v, out, dout, dq, dk, dv
    and the f32 lse cross the memory once; the five products, 10 * B * H *
    S^2 * D operations, at the tensor cores' dense bf16 peak, or for f32
    inputs to f32 accuracy (``f32_ops_ms``)."""
    b, s, h, d = q.shape
    by_bytes = (8 * q.numel() * q.element_size() + 4 * b * h * s) / PEAK_BYTES * 1e3
    ops = 10.0 * b * h * s * s * d
    by_ops = ops / PEAK_BF16 * 1e3 if dtype_name == "bfloat16" else f32_ops_ms(ops)
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_attention_bwd_kernel(torch, dev):
    """K9's forward with its log-sum-exp, then its backward, against the plain
    versions at ``ATTN_BWD_SHAPES``, in f32 and bf16, on the strided slices of
    one qkv projection; the backward's times (20 iterations in bf16, 10 in
    f32) beside the plain backward's, ``scaled_dot_product_attention``'s
    backward alone (``torch.autograd.grad`` repeated on one retained forward,
    as many iterations) with their ratio, and the bound; and two runs of the
    backward must agree bit for bit (no atomics). Returns {(dtype, shape):
    dict}."""
    import torch.nn.functional as F

    from threedod_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(19)
    results = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        iters = 20 if dtype_name == "bfloat16" else 10
        for shape in ATTN_BWD_SHAPES:
            b, s, h, d = shape
            qkv = torch.randn((b, s, 3, h, d), generator=gen).to(dev, dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            dout = torch.randn(shape, generator=gen).to(dev, dtype)
            with torch.no_grad():
                out, lse = attention.flash_forward_cuda(q, k, v, want_lse=True)
                ref_out, ref_lse = attention.attention_forward_reference(q, k, v)

                def kernel():
                    return attention.flash_backward_cuda(q, k, v, out, lse, dout)

                def plain():
                    return attention.attention_backward_reference(q, k, v, ref_out, ref_lse, dout)

                got, again, ref = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                fwd_lse_ms = cuda_ms(lambda: attention.flash_forward_cuda(q, k, v, want_lse=True), iters)
                fwd_ms = cuda_ms(lambda: attention.flash_forward_cuda(q, k, v, want_lse=False), iters)
                ms, plain_ms = cuda_ms(kernel, iters), cuda_ms(plain, 2, warmup=1)
            lse_err = (lse - ref_lse).abs().max().item()
            lse_tol = TOL_LSE * ref_lse.abs().max().item()
            out_err = (out.float() - ref_out.float()).abs().max().item()
            errs = {}
            for nm, g, r, a in zip(("dq", "dk", "dv"), got, ref, again):
                check(g.shape == r.shape == shape and g.dtype == dtype, f"K9 backward {nm}: {tuple(g.shape)} {g.dtype}")
                check(bool(torch.isfinite(g.float()).all()), f"K9 backward {dtype_name} {shape} {nm}: non-finite")
                check(torch.equal(g, a), f"K9 backward {dtype_name} {shape}: two runs give different {nm}")
                scale = r.float().abs().max().item()
                errs[nm] = ((g.float() - r.float()).abs().max().item(), TOL_ATTN_BWD[dtype_name] * scale)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt)  # one forward; its graph is kept
            dot = dout.transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True), iters)
            del lib_out
            bound, by = attention_bwd_bound_ms(q, dtype_name)
            print(f"[K9b] {dtype_name} {shape}: lse max_abs_err={lse_err:.3e} (tol {lse_tol:.3e}), out {out_err:.3e}; "
                  + ", ".join(f"{nm} max_abs_err={e:.3e} (tol {t:.3e})" for nm, (e, t) in errs.items())
                  + f"; backward kernel {ms:.4f} ms ({14.0 * b * h * s * s * d / ms / 1e9:.2f} TFLOP/s of the 14 "
                  f"B H S^2 D it does), plain {plain_ms:.4f} ms, scaled_dot_product_attention backward "
                  f"{library_ms:.4f} ms, kernel/SDPA {ms / library_ms:.3f}, bound {bound:.4f} ms ({by}); forward "
                  f"with lse {fwd_lse_ms:.4f} ms, without {fwd_ms:.4f} ms", flush=True)
            check(lse_err <= lse_tol, f"K9 {dtype_name} {shape}: lse disagrees with logsumexp: {lse_err} > {lse_tol}")
            out_tol = TOL_ATTN[dtype_name] * ref_out.float().abs().max().item()
            check(out_err <= out_tol, f"K9 {dtype_name} {shape}: the forward with lse disagrees: {out_err} > {out_tol}")
            for nm, (e, t) in errs.items():
                check(e <= t, f"K9 backward {dtype_name} {shape}: {nm} disagrees with the plain backward: {e} > {t}")
            results[(dtype_name, shape)] = dict(max_abs_err=max(e for e, _ in errs.values()), ms=ms, plain_ms=plain_ms,
                                                bound_ms=bound, bound_by=by, library_ms=library_ms,
                                                ratio=ms / library_ms, lse_max_abs_err=lse_err,
                                                fwd_lse_ms=fwd_lse_ms, fwd_ms=fwd_ms)
    return results


# GroundingDINO at 800x800: Swin-T's p3 to p5 and the extra stride-2 level
GDINO_LEVELS = [(100, 100), (50, 50), (25, 25), (13, 13)]
GDINO_S = sum(h * w for h, w in GDINO_LEVELS)  # 13294 tokens
# K3 vs plain: f32 sums of 16 samples of 4 taps in another order -> 1e-5 of the
# largest entry; bf16: one rounding of the output -> 2^-7 of the largest entry
TOL_DEFORM = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def deform_bound_ms(value, locations, weights, out):
    """Least time for one deformable-sampling call: value, locations, weights
    and output cross the memory once; each of the Lq * H * L * P samples does
    about 10 operations a channel (four taps, their weights and the weighted
    sum) at the f32 peak outside the tensor cores."""
    by_bytes = sum(t.numel() * t.element_size() for t in (value, locations, weights, out)) / PEAK_BYTES * 1e3
    by_ops = 10.0 * weights.numel() * value.shape[3] / PEAK_F32 * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def grid_sample_composition(torch, value, shapes, locations, weights):
    """Deformable DETR's ``ms_deform_attn_core_pytorch``: one ``grid_sample``
    (bilinear, zeros, align_corners=False) per level and a weighted sum. The
    yardstick beside K3; the port never calls it."""
    import torch.nn.functional as F

    b, _, h, d = value.shape
    lq, n_lvl, p = locations.shape[1], locations.shape[3], locations.shape[4]
    grids = 2.0 * locations - 1.0
    sampled, start = [], 0
    for lvl, (hl, wl) in enumerate(shapes):
        v = value[:, start:start + hl * wl].flatten(2).transpose(1, 2).reshape(b * h, d, hl, wl)
        start += hl * wl
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1).to(value.dtype)  # (B*H, Lq, P, 2)
        sampled.append(F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    w = weights.transpose(1, 2).reshape(b * h, 1, lq, n_lvl * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1).view(b, h * d, lq)
    return out.transpose(1, 2).reshape(b, lq, h, d)


def phase_deform_kernel(torch, dev, iters: int = 20):
    """K3 against its plain version at GroundingDINO's two launch shapes at
    800x800 (the encoder's Lq = 13294 and the decoder's 900 queries; levels
    100x100 to 13x13, H = 8, D = 32, P = 4, locations in [-0.1, 1.1]), in f32
    and bf16, with max error, times, bound and the time of the grid_sample
    composition. Returns {(dtype, Lq): dict}."""
    from threedod_torch.ops import ms_deform

    gen = torch.Generator().manual_seed(13)
    h, d, n_lvl, p = 8, 32, len(GDINO_LEVELS), 4
    results = {}
    with torch.no_grad():
        value32 = torch.randn((1, GDINO_S, h, d), generator=gen).to(dev)
        for lq in (GDINO_S, 900):
            loc = (torch.rand((1, lq, h, n_lvl, p, 2), generator=gen) * 1.2 - 0.1).to(dev)
            w32 = torch.softmax(torch.randn((1, lq, h, n_lvl * p), generator=gen), -1).reshape(1, lq, h, n_lvl, p).to(dev)
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                value, w = value32.to(dtype), w32.to(dtype)

                def kernel():
                    return ms_deform.ms_deform_sample_cuda(value, GDINO_LEVELS, loc, w)

                def plain():
                    return ms_deform.ms_deform_sample_reference(value, GDINO_LEVELS, loc, w)

                def library():
                    return grid_sample_composition(torch, value, GDINO_LEVELS, loc, w)

                out, ref, lib = kernel(), plain(), library()
                torch.cuda.synchronize()
                check(out.shape == ref.shape == (1, lq, h, d) and out.dtype == dtype, f"K3 output {tuple(out.shape)}")
                check(bool(torch.isfinite(out.float()).all()), f"K3 {dtype_name} Lq={lq}: non-finite output")
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                lib_err = (lib.float() - ref.float()).abs().max().item()
                tol = TOL_DEFORM[dtype_name] * scale
                ms, plain_ms, library_ms = cuda_ms(kernel, iters), cuda_ms(plain, 3), cuda_ms(library, iters)
                bound, by = deform_bound_ms(value, loc, w, out)
                moved = sum(t.numel() * t.element_size() for t in (value, loc, w, out))
                print(f"[K3] {dtype_name} Lq={lq}: max_abs_err={err:.3e} (tol {tol:.3e}, largest entry {scale:.3f}; "
                      f"the grid_sample composition is off by {lib_err:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms, grid_sample composition (4 calls) {library_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
                      f"{moved / 1e6:.2f} MB, {10.0 * w.numel() * d / 1e9:.3f} GFLOP)", flush=True)
                check(err <= tol, f"K3 {dtype_name} Lq={lq} disagrees with the plain version: {err} > {tol}")
                results[(dtype_name, lq)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                                 bound_by=by, library_ms=library_ms)
    # K3 has no backward: asked for a gradient on the card it must raise,
    # not return a result that autograd cannot see through
    value = value32[:, :, :, :].clone().requires_grad_(True)
    before = ms_deform.LAUNCHES
    try:
        ms_deform.ms_deform_sample(value, GDINO_LEVELS, loc, w32)
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    print(f"[K3] under grad with value requiring a gradient: raises {bool(raised)} ({raised[:60]}...)", flush=True)
    check("no backward" in raised and ms_deform.LAUNCHES == before, "K3 under grad did not refuse")
    return results


def _stage_ms(torch, model, batch, iters: int):
    """ms per call of trunk + FPN and of the RPN head, by CUDA events."""
    from threedod_torch.data.batch import normalize_image

    with torch.inference_mode():
        x = normalize_image(batch.image, model.cfg.model, batch.image_hw).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = model.backbone(x)
        trunk = cuda_ms(lambda: model.backbone(x), iters=iters, warmup=1)
        head = cuda_ms(lambda: model.proposal_generator.rpn_head(feats), iters=iters, warmup=1)
    return trunk, head


def phase_main_path(torch, dev, fused: bool, backbone: str = "dla34"):
    """The serving path at full width through ``threedod_torch.infer``, with
    the fused forward (kernels K4 to K8) on or off. Returns the launch counts
    of the timed forwards and the ms per forward."""
    from threedod_torch import infer
    from threedod_torch.ops import fused_conv, roi_align_cuda

    tag = f"main {backbone} {'fused' if fused else 'stock'}"
    cfg = infer.bench_config(backbone=backbone)
    model = infer.load_model(cfg, dev, seed=0)
    batch = infer.make_batch(cfg, infer.random_images(cfg, 8, seed=0), dev)
    warmup, iters = (1, 4) if fused else (2, 8)
    with fused_conv.fused_forward(fused):
        for _ in range(warmup):
            infer.predict(model, batch)
        torch.cuda.synchronize()
        roi_align_cuda.LAUNCHES = roi_align_cuda.BACKWARD_LAUNCHES = 0
        fused_conv.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            det = infer.predict(model, batch)
        end.record()
        torch.cuda.synchronize()
        launches = {"roi_align_fwd": roi_align_cuda.LAUNCHES, **fused_conv.LAUNCHES}
        ms = start.elapsed_time(end) / iters
        trunk_ms, head_ms = _stage_ms(torch, model, batch, 3 if fused else 10)
    print(f"[{tag}] bs8 512x672 bf16: {ms:.3f} ms/forward, {8 * 1000.0 / ms:.2f} images/s "
          f"({iters} forwards after {warmup} warm-up); trunk + FPN {trunk_ms:.3f} ms, RPN head {head_ms:.3f} ms",
          flush=True)
    print(f"[{tag}] kernel launches in {iters} forwards: {launches}", flush=True)
    want = {"roi_align_fwd": 2, **{k: (n if fused else 0) for k, n in FUSED_LAUNCHES[backbone].items()}}
    for k, n in want.items():
        check(launches[k] == n * iters,
              f"{tag}: expected {n * iters} launches of {k} ({n} per forward), got {launches[k]}")
    check(roi_align_cuda.BACKWARD_LAUNCHES == 0, "the serving path launched the backward kernel")
    d = 100
    want = {"boxes": (8, d, 4), "scores": (8, d), "scores_2d": (8, d), "classes": (8, d),
            "valid": (8, d), "center_cam": (8, d, 3), "dimensions": (8, d, 3), "pose": (8, d, 3, 3),
            "center_2d": (8, d, 2), "corners3d": (8, d, 8, 3)}
    for k, shape in want.items():
        t = getattr(det, k)
        check(tuple(t.shape) == shape, f"{k} shape {tuple(t.shape)} != {shape}")
        check(t.device.type == "cuda", f"{k} left the card")
        check(bool(torch.isfinite(t.float()).all()), f"{k} has non-finite values")
    n_valid = det.valid.sum(1).tolist()
    print(f"[{tag}] valid detections per image: {n_valid}", flush=True)
    check(min(n_valid) > 0, "an image has no detections")
    return launches, ms


def _forward_stages(torch, model, batch, fused: bool):
    """Features, RPN head outputs and detections of one forward, as numpy."""
    from threedod_torch.data.batch import normalize_image
    from threedod_torch.ops import fused_conv

    with torch.inference_mode(), fused_conv.fused_forward(fused):
        x = normalize_image(batch.image, model.cfg.model, batch.image_hw).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = model.backbone(x)
        logits, regs = model.proposal_generator.rpn_head(feats)
        det = model(batch)
    torch.cuda.synchronize()
    return ({k: v.float().cpu().numpy() for k, v in feats.items()},
            {k: v.float().cpu().numpy() for k, v in logits.items()},
            {k: v.float().cpu().numpy() for k, v in regs.items()},
            {k: v.cpu().numpy() for k, v in det._asdict().items()})


# Factors on the seeded weights that make the f32 detections comparable one to
# one: on the FPN laterals, to bring the pyramid to order 1, and on the class
# scores, to spread them without saturating them. DLA34's seeded features are
# of order 1 and leave the scores near-tied. ResNet34's reach 20 to 30 (its
# residual sums grow block by block under identity BatchNorm): the RPN's
# deltas then sit at their clamp, a box moves by more than 1e-3 px for a 5e-6
# change of a feature, and every class score saturates
SEED_SPREAD = {"dla34": dict(lateral=1.0, cls=50.0), "resnet34": dict(lateral=0.05, cls=10.0)}


def phase_fused_vs_stock(torch, dev, backbone: str = "dla34", bf16: bool = True):
    """The fused forward against the stock one on the card, same weights and
    images. f32 at batch 2 with TF32 off: features and RPN outputs within 1e-4
    of each level's largest entry (other sum orders through some forty
    convolutions), detections matched one to one with boxes and scores
    within 1e-3 and corners within 5e-3. bf16 at batch 8: features and logits
    only, within 2^-4 of each level's largest entry (one bf16 rounding is
    2^-8; the two paths round at different places through the same forty
    layers); a flipped rounding can change a discrete choice, so detections
    are not compared there. ``bf16`` false leaves that half out."""
    import numpy as np

    from threedod_torch import infer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype_name, bs, tol in (("float32", 2, 1e-4), ("bfloat16", 8, 2.0 ** -4))[: 2 if bf16 else 1]:
        cfg = infer.bench_config(dtype=dtype_name, backbone=backbone)
        model = infer.load_model(cfg, dev, seed=1)
        with torch.no_grad():
            for name, p in model.backbone.named_parameters():
                if name.startswith("fpn_lateral") and name.endswith("weight"):
                    p.mul_(SEED_SPREAD[backbone]["lateral"])
            model.roi_heads.box_predictor.cls_score.weight.mul_(SEED_SPREAD[backbone]["cls"])
        batch = infer.make_batch(cfg, infer.random_images(cfg, bs, seed=1), dev)
        fs, ls, rs, ds = _forward_stages(torch, model, batch, fused=False)
        ff, lf, rf, df = _forward_stages(torch, model, batch, fused=True)
        for what, a, b in (("features", fs, ff), ("rpn logits", ls, lf), ("rpn deltas", rs, rf)):
            if dtype_name == "bfloat16" and what == "rpn deltas":
                continue
            for lvl in a:
                check(a[lvl].shape == b[lvl].shape, f"{what} {lvl}: shapes {a[lvl].shape} vs {b[lvl].shape}")
                rel = np.abs(a[lvl] - b[lvl]).max() / np.abs(a[lvl]).max()
                print(f"[fused-vs-stock] {backbone} {dtype_name} bs{bs} {what} {lvl}: max err / largest entry {rel:.3e} "
                      f"(tol {tol:.3e})", flush=True)
                check(rel <= tol, f"{what} {lvl} differ fused vs stock in {dtype_name}: {rel}")
        if dtype_name != "float32":
            continue
        for i in range(bs):
            vs, vf = ds["valid"][i], df["valid"][i]
            key = lambda d, v: np.concatenate([d["boxes"][i][v], d["classes"][i][v, None] * 1e4], 1)  # noqa: E731
            frac, idx = _match_fraction(np, key(ds, vs), key(df, vf), atol=1e-3, rtol=0.0)
            print(f"[fused-vs-stock] {backbone} detections image {i}: {vs.sum()} stock / {vf.sum()} fused, "
                  f"boxes matched within 1e-3: {frac:.4f}", flush=True)
            check(vs.sum() == vf.sum() and frac == 1.0, f"detections differ fused vs stock (image {i})")
            for field, atol in (("scores", 1e-3), ("corners3d", 5e-3)):
                err = float(np.abs(ds[field][i][vs] - df[field][i][vf][idx]).max())
                print(f"[fused-vs-stock] {backbone} image {i} {field}: max abs err {err:.3e} (tol {atol})", flush=True)
                check(err <= atol, f"{field} differs fused vs stock (image {i}): {err} > {atol}")


# trunk tensors a few training steps must move: a first and a late weight, an
# early running mean and a late running variance
TRAIN_WATCH = {
    "dla34": ["base_layer.0.weight", "level5.root.bn.weight", "level2.tree1.bn1.running_mean",
              "level5.root.bn.running_var"],
    "resnet34": ["conv1.weight", "layer4.2.bn2.weight", "layer1.0.bn1.running_mean",
                 "layer4.0.downsample.1.running_var"],
}


def phase_train_path(torch, dev, backbone: str = "dla34", steps: int = 5):
    """The training path at full width, through ``threedod_torch.train``."""
    from threedod_torch import train
    from threedod_torch.data.batch import synthetic_train_batch
    from threedod_torch.ops import roi_align_cuda

    bs, warmup = 8, 2
    tag = f"train {backbone}"
    cfg = train.train_config(batch_size=bs, backbone=backbone)
    trainer = train.build_trainer(cfg, dev, seed=0)
    batch = synthetic_train_batch(cfg, bs, seed=3).to(dev)
    watch = [f"backbone.bottom_up.{k}" for k in TRAIN_WATCH[backbone]] + [
        "backbone.fpn_lateral3.weight", "proposal_generator.rpn_head.conv.weight",
        "roi_heads.box_predictor.cls_score.weight", "roi_heads.cube_head.bbox_3D_center_depth.bias"]
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items() if k in watch}
    check(len(before) == len(watch), "a watched tensor is missing from the state dict")
    outs = [trainer.train_step(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    roi_align_cuda.LAUNCHES = roi_align_cuda.BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    outs += [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0 / steps
    fwd, bwd = roi_align_cuda.LAUNCHES, roi_align_cuda.BACKWARD_LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[{tag}] bs{bs} 512x672 bf16, roi_batch {cfg.shapes.roi_batch}: {ms:.3f} ms/step, "
          f"{bs * 1000.0 / ms:.2f} images/s ({steps} steps after {warmup} warm-up), "
          f"peak memory {peak / 2 ** 30:.3f} GiB, 1 host sync per step", flush=True)
    print(f"[{tag}] kernel launches in {steps} steps: K1 {fwd}, K2 {bwd}", flush=True)
    check(fwd == steps and bwd == steps, f"expected {steps} launches of each kernel, got K1 {fwd}, K2 {bwd}")
    for i, out in enumerate(outs):
        check(set(out.losses) == LOSS_KEYS, f"step {i}: loss keys {sorted(out.losses)}")
        bad = [k for k, v in out.losses.items() if not (v == v and abs(v) != float("inf"))]
        check(not bad, f"step {i}: non-finite losses {bad}")
        check(not out.diverging, f"step {i} was skipped by the divergence guard (loss {out.total})")
    check(trainer.count == warmup + steps, "the schedule count did not advance with every step")
    after = trainer.model.state_dict()
    for k, old in before.items():
        check(bool(torch.isfinite(after[k]).all()), f"{k} is not finite after training")
        check(not torch.equal(after[k], old), f"{k} did not move in {warmup + steps} steps")
    print(f"[{tag}] total loss: first {outs[0].total:.4f}, last {outs[-1].total:.4f}; "
          f"fg/bg ROIs per image {outs[-1].metrics['roi/num_fg']:.1f}/{outs[-1].metrics['roi/num_bg']:.1f}; "
          f"{len(before)} watched parameters and running statistics moved", flush=True)
    return fwd, bwd, ms


def _match_fraction(np, a, b, atol, rtol):
    """Fraction of rows of a with an unused row of b within tolerance
    (greedy nearest), and the matched index of each row (-1 if none)."""
    if len(a) == 0:
        return 1.0, np.zeros(0, int)
    d = np.abs(a[:, None, :] - b[None, :, :]) - rtol * np.abs(a[:, None, :])
    d = d.max(-1)
    used = np.zeros(len(b), bool)
    idx = np.full(len(a), -1)
    for i in np.argsort(d.min(1), kind="stable"):
        for j in np.argsort(d[i], kind="stable"):
            if d[i, j] > atol:
                break
            if not used[j]:
                used[j], idx[i] = True, j
                break
    return float((idx >= 0).mean()), idx


def phase_card_vs_cpu(torch, dev):
    import numpy as np

    from threedod_torch import infer
    from threedod_torch.data.batch import normalize_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = infer.bench_config(dtype="float32")
    cpu_model = infer.load_model(cfg, torch.device("cpu"), seed=1)
    with torch.no_grad():  # spread random-init class scores so they are not near-tied
        cpu_model.roi_heads.box_predictor.cls_score.weight.mul_(50.0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    images = infer.random_images(cfg, 2, seed=1)
    out = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
        batch = infer.make_batch(cfg, images, device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = normalize_image(batch.image, cfg.model, batch.image_hw).permute(0, 3, 1, 2)
            if device.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            feats = model.backbone(x)
            props = model.proposal_generator(feats, batch.image_hw)
            det = model(batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (
            {k: v.float().cpu().numpy() for k, v in feats.items()},
            {k: v.cpu().numpy() for k, v in props._asdict().items()},
            {k: v.cpu().numpy() for k, v in det._asdict().items()},
        )
        print(f"[e2e] {name} f32 bs2 forward: {time.perf_counter() - t0:.2f} s", flush=True)
    (fc, pc, dc), (fg, pg, dg) = out["cpu"], out["gpu"]
    for lvl in fc:
        rel = np.abs(fc[lvl] - fg[lvl]).max() / np.abs(fc[lvl]).max()
        print(f"[e2e] features {lvl}: max rel err {rel:.3e} (tol 1e-4)", flush=True)
        check(rel <= 1e-4, f"features {lvl} differ card vs CPU: {rel}")
    for i in range(2):
        vc, vg = pc["valid"][i], pg["valid"][i]
        frac, _ = _match_fraction(np, pc["boxes"][i][vc], pg["boxes"][i][vg], atol=1e-2, rtol=1e-4)
        print(f"[e2e] proposals image {i}: {vc.sum()} cpu / {vg.sum()} gpu, matched {frac:.4f} (tol 0.99)", flush=True)
        check(vc.sum() == vg.sum() and frac >= 0.99, f"proposals differ card vs CPU (image {i})")
        vc, vg = dc["valid"][i], dg["valid"][i]
        key = lambda d, v: np.concatenate([d["boxes"][i][v], d["classes"][i][v, None] * 1e4], 1)  # noqa: E731
        frac, idx = _match_fraction(np, key(dc, vc), key(dg, vg), atol=1e-2, rtol=1e-4)
        print(f"[e2e] detections image {i}: {vc.sum()} cpu / {vg.sum()} gpu, matched {frac:.4f} (tol 0.98)",
              flush=True)
        check(vc.sum() == vg.sum() and frac >= 0.98, f"detections differ card vs CPU (image {i})")
        m = idx >= 0
        for field, atol in (("scores_2d", 1e-4), ("scores", 1e-4), ("center_cam", 1e-3),
                            ("dimensions", 1e-4), ("pose", 1e-3), ("corners3d", 2e-3)):
            a = dc[field][i][vc][m]
            bb = dg[field][i][vg][idx[m]]
            err = float(np.max(np.abs(a - bb) - 1e-3 * np.abs(a))) if len(a) else 0.0
            check(err <= atol, f"{field} differs card vs CPU (image {i}): {err} > {atol}")
        print(f"[e2e] image {i}: 2D scores and 3D fields of matched detections within tolerance", flush=True)


def phase_train_card_vs_cpu(torch, dev):
    """One f32 training forward and backward, card against CPU: same weights,
    batch and sampling noise (drawn on the CPU and moved). Both subsamplers
    are given room for every candidate, so that a last-digit difference in an
    IoU cannot swap a sampled anchor or ROI for another; proposal selection
    and its NMS run as configured."""
    from threedod_torch import train
    from threedod_torch.data.batch import synthetic_train_batch
    from threedod_torch.infer import load_model
    from threedod_torch.ops.matcher import gumbel_noise

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs = 2
    cfg = train.train_config(dtype="float32", batch_size=bs)
    n_anchors = sum(-(-cfg.shapes.canvas_height // s) * -(-cfg.shapes.canvas_width // s) * 3
                    for s in (4, 8, 16, 32, 64))
    n_cand = cfg.model.rpn.post_nms_topk_train + cfg.shapes.max_gt
    cfg.model.rpn.batch_size_per_image, cfg.shapes.roi_batch = n_anchors, n_cand
    cpu_model = load_model(cfg, torch.device("cpu"), seed=1).train()
    with torch.no_grad():  # lift the regressors off zero, where an L1 residual's sign is noise
        for name, p in cpu_model.roi_heads.named_parameters():
            if name.endswith("weight") and ("bbox_pred" in name or "bbox_3D" in name):
                p.mul_(30.0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = synthetic_train_batch(cfg, bs, seed=5)
    gen = torch.Generator().manual_seed(2)
    noise = {"rpn": tuple(gumbel_noise(gen, (bs, n_anchors), "cpu") for _ in range(2)),
             "roi": tuple(gumbel_noise(gen, (bs, n_cand), "cpu") for _ in range(2))}
    leaves = ["backbone.bottom_up.base_layer.0.weight", "backbone.fpn_lateral3.weight",
              "proposal_generator.rpn_head.conv.weight", "roi_heads.box_predictor.cls_score.weight",
              "roi_heads.box_predictor.bbox_pred.weight", "roi_heads.cube_head.bbox_3D_center_depth.weight",
              "roi_heads.cube_head.bbox_3D_dims.weight"]
    out = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
        t0 = time.perf_counter()
        nz = {k: tuple(t.to(device) for t in v) for k, v in noise.items()}
        losses, metrics = model(batch.to(device), nz)
        sum(losses.values()).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        params = dict(model.named_parameters())
        out[name] = ({k: v.item() for k, v in losses.items()}, {k: v.item() for k, v in metrics.items()},
                     {k: params[k].grad.float().cpu() for k in leaves})
        print(f"[e2e-train] {name} f32 bs{bs} forward + backward: {time.perf_counter() - t0:.2f} s", flush=True)
    (lc, mc, gc), (lg, mg, gg) = out["cpu"], out["gpu"]
    # sums run in another order (f32 convolutions, TF32 off), and one NMS
    # decision flipped among 1000 proposals moves a count by one and a loss
    # by ~1e-3: counts within 2 an image, losses within 2e-3 relative
    for k in ("roi/num_fg", "roi/num_bg", "rpn/num_pos_anchors", "rpn/num_neg_anchors"):
        print(f"[e2e-train] {k}: cpu {mc[k]:.1f} gpu {mg[k]:.1f} (tol 2)", flush=True)
        check(abs(mc[k] - mg[k]) <= 2, f"{k} differs card vs CPU: {mg[k]} vs {mc[k]}")
    for k in sorted(lc):
        rel = abs(lc[k] - lg[k]) / max(abs(lc[k]), 1e-6)
        print(f"[e2e-train] loss {k}: cpu {lc[k]:.6f} gpu {lg[k]:.6f} rel {rel:.2e} (tol 2e-3)", flush=True)
        check(rel <= 2e-3, f"loss {k} differs card vs CPU: {lg[k]} vs {lc[k]}")
    # gradients pass back through 34 BatchNorm layers at batch 2, which
    # magnify rounding differences (2e-2 at the stem on one host's CPU; other
    # CPUs round elsewhere): 1e-1 of each leaf's largest entry
    for k in leaves:
        rel = ((gc[k] - gg[k]).abs().max() / gc[k].abs().max()).item()
        print(f"[e2e-train] grad {k}: max rel err {rel:.2e} (tol 1e-1)", flush=True)
        check(rel <= 1e-1, f"gradient {k} differs card vs CPU: {rel}")


def phase_stock_trunks(torch, dev):
    """The stock bs8 512x672 bf16 forward on the other three trunks under the
    FPN, through ``threedod_torch.infer``: finite detections, ms per forward,
    and the trunk + FPN share. Returns {backbone: (forward ms, trunk + FPN ms)}."""
    from threedod_torch import infer
    from threedod_torch.ops import fused_conv

    out = {}
    for backbone in ("densenet121", "mnasnet", "shufflenet"):
        cfg = infer.bench_config(backbone=backbone)
        model = infer.load_model(cfg, dev, seed=0)
        batch = infer.make_batch(cfg, infer.random_images(cfg, 8, seed=0), dev)
        fused_conv.reset_launches()
        det = infer.predict(model, batch)
        ms = cuda_ms(lambda: infer.predict(model, batch), iters=4, warmup=1)
        trunk_ms, _ = _stage_ms(torch, model, batch, 4)
        check(tuple(det.corners3d.shape) == (8, 100, 8, 3), f"{backbone}: corners {tuple(det.corners3d.shape)}")
        for k in ("boxes", "scores", "corners3d", "dimensions"):
            check(bool(torch.isfinite(getattr(det, k).float()).all()), f"{backbone}: {k} has non-finite values")
        check(not any(fused_conv.LAUNCHES.values()), f"{backbone}: the stock forward launched a fused kernel")
        n_valid = det.valid.sum(1).tolist()
        print(f"[main {backbone} stock] bs8 512x672 bf16: {ms:.3f} ms/forward, {8 * 1000.0 / ms:.2f} images/s; "
              f"trunk + FPN {trunk_ms:.3f} ms; valid detections per image {n_valid}", flush=True)
        check(min(n_valid) > 0, f"{backbone}: an image has no detections")
        out[backbone] = (ms, trunk_ms)
    return out


def phase_depth_path(torch, dev, k9_ms: float):
    """The depth path at full width through ``threedod_torch.depth_infer``:
    Depth-Anything-V2 vitl, one 518x924 image, bf16, seeded weights. Returns
    the K9 launches of the timed forwards and the ms per forward."""
    from threedod_torch import depth_infer
    from threedod_torch.ops import attention

    h, w, iters = 518, 924, 5
    model = depth_infer.load_model("vitl", dev, seed=0)
    images = depth_infer.random_images(1, h, w, seed=0)
    depth_infer.predict(model, images, dev)  # warm-up
    torch.cuda.synchronize()
    attention.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        depth = depth_infer.predict(model, images, dev)
    end.record()
    torch.cuda.synchronize()
    launches, ms = attention.LAUNCHES, start.elapsed_time(end) / iters
    with torch.inference_mode():  # the two stages on their own, by CUDA events
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2)
        layer_ids = (4, 11, 17, 23)
        feats, hp, wp = model.pretrained.get_intermediate_layers(x, layer_ids)
        tokens = [f[0] for f in feats]
        vit_ms = cuda_ms(lambda: model.pretrained.get_intermediate_layers(x, layer_ids), iters=3, warmup=1)
        head_ms = cuda_ms(lambda: model.depth_head(tokens, hp, wp), iters=3, warmup=1)
    check(tuple(depth.shape) == (1, h, w) and depth.dtype == torch.float32, f"depth is {tuple(depth.shape)} {depth.dtype}")
    check(depth.device.type == "cuda", "the depth map left the card")
    check(bool(torch.isfinite(depth).all()), "the depth map has non-finite values")
    lo, hi = depth.min().item(), depth.max().item()
    check(0.0 < lo and hi < 20.0, f"depths [{lo}, {hi}] are not inside (0, 20)")
    print(f"[depth] vitl 518x924 bf16 (2443 tokens): {ms:.3f} ms/forward ({iters} forwards after 1 warm-up), "
          f"depths in [{lo:.3f}, {hi:.3f}]; K9 launches in {iters} forwards: {launches}; "
          f"24 launches of K9 at {k9_ms:.4f} ms are {24 * k9_ms / ms:.1%} of a forward; "
          f"ViT encoder {vit_ms:.3f} ms, DPT head {head_ms:.3f} ms", flush=True)
    check(launches == 24 * iters, f"expected {24 * iters} launches of K9 (24 per forward), got {launches}")
    return launches, ms


def phase_depth_card_vs_cpu(torch, dev):
    """Depth-Anything-V2 vits in f32 at 518x924, card against CPU, same
    weights and image: on the card every block's attention is K9, on the CPU
    the plain version. Depths of up to 20 through 12 blocks and the head, f32
    sums in other orders (TF32 off): 2e-3 absolute."""
    from threedod_torch import depth_infer
    from threedod_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = depth_infer.load_model("vits", torch.device("cpu"), seed=2, dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    images = depth_infer.random_images(1, 518, 924, seed=2)
    t0 = time.perf_counter()
    ref = depth_infer.predict(cpu_model, images, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    before = attention.LAUNCHES
    got = depth_infer.predict(gpu_model, images, dev)
    torch.cuda.synchronize()
    check(attention.LAUNCHES - before == 12, f"vits on the card launched K9 {attention.LAUNCHES - before} times, not 12")
    err = (got.cpu() - ref).abs().max().item()
    print(f"[e2e-depth] vits f32 518x924: card vs CPU max abs err {err:.3e} (tol 2e-3; depths in "
          f"[{ref.min().item():.3f}, {ref.max().item():.3f}]); CPU forward {t_cpu:.2f} s", flush=True)
    check(err <= 2e-3, f"the depth map differs card vs CPU: {err}")


# the parameters whose card gradients are held against the CPU's in the
# depth-training comparison: the position embedding (through the bicubic
# resize 644 takes), the cls token, the first block's qkv, the last block's
# projection (vits has 12) and the head's last convolution
DEPTH_GRAD_WATCH = ["pretrained.pos_embed", "pretrained.cls_token", "pretrained.blocks.0.attn.qkv.weight",
                    "pretrained.blocks.11.attn.proj.weight", "depth_head.scratch.output_conv2.2.weight"]


def _span_events(torch, model, optimizer):
    """CUDA events at the model's forward start and end and around the
    optimizer's step, by hooks: a list of [fwd start, fwd end, step start,
    step end] per step. The backward span runs from fwd end to step start
    (it holds the loss too)."""
    steps = []

    def mark(i):
        def hook(*_):
            if i == 0:
                steps.append([torch.cuda.Event(enable_timing=True) for _ in range(4)])
            steps[-1][i].record()
        return hook

    handles = [model.register_forward_pre_hook(mark(0)), model.register_forward_hook(mark(1)),
               optimizer.register_step_pre_hook(mark(2)), optimizer.register_step_post_hook(mark(3))]
    return steps, handles


def phase_depth_train(torch, dev, k9b, warmup: int = 1, steps: int = 3):
    """Depth fine-tuning at full width through ``train.depth.DepthTrainer``:
    Depth-Anything-V2 vitl in f32 (the tool's model, TF32 off), batch 2 at
    644x644 (2117 tokens, so every block's attention is K9 forward and
    backward), seeded weights, one ``SyntheticDepthDataset`` batch repeated,
    no flip, the tool's LR. ms per step by the host clock, images/s, peak
    memory, and the forward, backward and optimizer spans by CUDA events;
    24 K9 forward and 24 K9 backward launches a step, a finite loss that
    falls at every timed step, and parameters of both groups moved. Returns
    (K9 forward, K9 backward launches of the timed steps)."""
    from threedod_torch.models.depth.dpt import DepthAnythingV2, init_weights
    from threedod_torch.ops import attention
    from threedod_torch.train.depth import DepthTrainer
    from threedod_torch.train_depth import SyntheticDepthDataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, bs = 644, 2
    t0 = time.perf_counter()
    model = DepthAnythingV2("vitl", dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = DepthTrainer(model, dev, base_lr=5e-6, total_iters=1000)
    build_s = time.perf_counter() - t0
    sample = next(iter(SyntheticDepthDataset(size, bs, n_batches=1, seed=0)))
    image, depth, mask = (torch.from_numpy(sample[k]).to(dev) for k in ("image", "depth", "valid_mask"))
    watch = {nm: p for nm, p in model.named_parameters()
             if nm in ("pretrained.blocks.0.attn.qkv.weight", "depth_head.scratch.output_conv2.2.weight")}
    before = {nm: p.detach().clone() for nm, p in watch.items()}
    losses = [trainer.train_step(image, depth, mask, flip=False) for _ in range(warmup)]
    torch.cuda.synchronize()
    attention.LAUNCHES = attention.LAUNCHES_BWD = 0
    torch.cuda.reset_peak_memory_stats(dev)
    events, handles = _span_events(torch, model, trainer.optimizer)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.train_step(image, depth, mask, flip=False))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    fwd, bwd = attention.LAUNCHES, attention.LAUNCHES_BWD
    for hnd in handles:
        hnd.remove()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    spans = {nm: sum(e[i].elapsed_time(e[j]) for e in events) / len(events)
             for nm, (i, j) in (("forward", (0, 1)), ("backward", (1, 2)), ("optimizer", (2, 3)))}
    losses = [float(x) for x in losses]
    moved = {nm: (p.detach() - before[nm]).abs().max().item() for nm, p in watch.items()}
    k9b_row = k9b[("float32", (2, 2117, 16, 64))]
    k9b_ms, k9f_ms = k9b_row["ms"], k9b_row["fwd_lse_ms"]
    print(f"[depth-train] vitl f32 bs{bs} {size}x{size} (2117 tokens): {ms:.3f} ms/step ({steps} steps after "
          f"{warmup} warm-up), {bs * 1000.0 / ms:.3f} images/s, peak memory {peak:.3f} GiB; spans forward "
          f"{spans['forward']:.3f} ms, backward {spans['backward']:.3f} ms, optimizer {spans['optimizer']:.3f} ms; "
          f"losses {[round(x, 5) for x in losses]}; K9 launches in {steps} steps: {fwd} forward, {bwd} backward; "
          f"24 backwards at {k9b_ms:.4f} ms are {24 * k9b_ms / ms:.1%} of a step, 24 forwards with lse at "
          f"{k9f_ms:.4f} ms {24 * k9f_ms / ms:.1%}; largest parameter change "
          + ", ".join(f"{nm} {v:.3e}" for nm, v in moved.items())
          + f"; model built and placed in {build_s:.2f} s", flush=True)
    check(fwd == 24 * steps and bwd == 24 * steps,
          f"expected {24 * steps} K9 forward and backward launches (24 a step), got {fwd} and {bwd}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    # AdamW's first update moves every weight by about the LR with the sign of
    # its gradient, and on seeded random weights that overshoots (the loss
    # after it reads 10 to 15 times the first); the timed steps must then
    # descend, each below the one before
    check(all(b < a for a, b in zip(losses[warmup:], losses[warmup + 1:])),
          f"the loss did not fall over the timed steps: {losses}")
    check(all(v > 0 for v in moved.values()), f"a parameter group did not move: {moved}")
    return fwd, bwd


def phase_depth_train_entry(torch, dev):
    """``python -m threedod_torch.train_depth`` in-process: vits, 644x644,
    batch 2, one epoch of the synthetic data (4 steps with random flips, 2
    evaluation batches) and its checkpoint, which must load strictly into a
    fresh model and optimizer. 12 K9 forwards a training or evaluation
    forward, 12 backwards a step."""
    import tempfile

    from threedod_torch import train_depth
    from threedod_torch.models.depth.dpt import DepthAnythingV2
    from threedod_torch.train.depth import build_depth_optimizer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = train_depth.main(["--synthetic", "--encoder", "vits", "--img-size", "644", "--bs", "2", "--epochs",
                                "1", "--save-path", tmp])
        secs = time.perf_counter() - t0
        ck = torch.load(os.path.join(tmp, "latest.pt"), map_location="cpu", weights_only=True)
        model = DepthAnythingV2("vits", dtype=torch.float32)
        model.load_state_dict(ck["model"], strict=True)
        build_depth_optimizer(model, 5e-6).load_state_dict(ck["optimizer"])
    print(f"[depth-train-entry] vits 644x644 bs2, 1 epoch: {secs:.2f} s; steps {res['steps']}, last loss "
          f"{res['last_loss']:.5f}, best d1 {res['best']['d1']:.4f} abs_rel {res['best']['abs_rel']:.4f}; K9 "
          f"launches {res['flash_attention_launches']} forward, {res['flash_attention_bwd_launches']} backward; "
          f"latest.pt (step {ck['step']}, epoch {ck['epoch']}) reloads strictly", flush=True)
    check(res["steps"] == 4 and ck["step"] == 4 and ck["epoch"] == 0, f"steps {res['steps']}, checkpoint {ck['step']}")
    check(math.isfinite(res["last_loss"]), f"non-finite loss {res['last_loss']}")
    check(all(math.isfinite(v) for v in res["best"].values()), f"non-finite metrics {res['best']}")
    check(res["flash_attention_launches"] == 12 * (4 + 2) and res["flash_attention_bwd_launches"] == 12 * 4,
          f"K9 launches {res['flash_attention_launches']} forward, {res['flash_attention_bwd_launches']} backward")
    return res


def phase_depth_train_card_vs_cpu(torch, dev):
    """One loss and backward of Depth-Anything-V2 vits in f32 at 644x644 on
    one image, card against CPU, same weights and batch, no flip, TF32 off:
    on the card every block's attention is K9 forward and backward (12 each),
    on the CPU the plain versions. The loss within 1e-5 relative; the
    gradients of ``DEPTH_GRAD_WATCH`` within 1e-4 of each one's largest entry
    (f32 sums in other orders through 12 blocks, the head and a loss over
    414736 pixels, then back; the first card run read at most 2.1e-5, the
    position embedding's)."""
    from threedod_torch.models.depth.dpt import DepthAnythingV2, init_weights
    from threedod_torch.ops import attention
    from threedod_torch.train.depth import silog_loss
    from threedod_torch.train_depth import SyntheticDepthDataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = DepthAnythingV2("vits", dtype=torch.float32)
    init_weights(cpu_model, torch.Generator().manual_seed(3))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    sample = next(iter(SyntheticDepthDataset(644, 1, n_batches=1, seed=3)))

    def loss_and_grads(model, device):
        image, depth, valid = (torch.from_numpy(sample[k]).to(device) for k in ("image", "depth", "valid_mask"))
        loss = silog_loss(model(image.permute(0, 3, 1, 2)), depth, valid & (depth >= 0.001) & (depth <= 20.0))
        loss.backward()
        grads = dict(model.named_parameters())
        return loss.item(), {nm: grads[nm].grad.detach().cpu() for nm in DEPTH_GRAD_WATCH}

    t0 = time.perf_counter()
    ref_loss, ref = loss_and_grads(cpu_model, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    fwd0, bwd0 = attention.LAUNCHES, attention.LAUNCHES_BWD
    got_loss, got = loss_and_grads(gpu_model, dev)
    fwd, bwd = attention.LAUNCHES - fwd0, attention.LAUNCHES_BWD - bwd0
    print(f"[e2e-depth-train] vits f32 644x644: loss card {got_loss:.7f}, CPU {ref_loss:.7f}; K9 launches on the "
          f"card {fwd} forward, {bwd} backward; CPU loss and backward {t_cpu:.2f} s", flush=True)
    check(fwd == 12 and bwd == 12, f"vits on the card launched K9 {fwd} / {bwd} times, not 12 / 12")
    check(abs(got_loss - ref_loss) <= 1e-5 * abs(ref_loss), f"the loss differs card vs CPU: {got_loss} vs {ref_loss}")
    for nm in DEPTH_GRAD_WATCH:
        scale = ref[nm].abs().max().item()
        err = (got[nm] - ref[nm]).abs().max().item()
        print(f"[e2e-depth-train] grad {nm}: max abs err {err:.3e} (tol {1e-4 * scale:.3e}, largest entry "
              f"{scale:.3e})", flush=True)
        check(scale > 0 and err <= 1e-4 * scale, f"the gradient of {nm} differs card vs CPU: {err} (largest {scale})")


GDINO_PROMPT = [101, 2598, 1012, 102]  # "ground." as the asset tool tokenises it


def _stage_events(torch, model):
    """CUDA events around the Swin trunk, BERT, the enhancer and the decoder
    of one forward, by forward hooks: {stage: [start, end]}."""
    enc, dec = model.transformer.encoder, model.transformer.decoder
    stages = {"swin": (model.backbone[0], model.backbone[0]), "bert": (model.bert, model.bert),
              "enhancer": (enc.fusion_layers[0], enc.layers[-1]), "decoder": (dec.layers[0], dec.layers[-1])}
    events = {k: [torch.cuda.Event(enable_timing=True) for _ in range(2)] for k in stages}
    handles = []
    for k, (first, last) in stages.items():
        handles.append(first.register_forward_pre_hook(lambda *_, e=events[k][0]: e.record()))
        handles.append(last.register_forward_hook(lambda *_, e=events[k][1]: e.record()))
    return events, handles


def phase_gdino_path(torch, dev, k3):
    """The GroundingDINO path at full width through ``threedod_torch.
    gdino_infer``: Swin-T, BERT-base, 6 + 6 layers, 900 queries, one 800x800
    image, bf16, seeded weights, the prompt "ground.". Logits (1, 900, 4),
    boxes inside [0, 1], finite values, 12 K3 launches a forward, ms per
    forward (CUDA events over 5 forwards after 1 warm-up) and the stages'
    times from one more forward. Returns (K3 launches of the timed forwards,
    ms per forward)."""
    from threedod_torch import gdino_infer
    from threedod_torch.models.gdino import model as gmodel
    from threedod_torch.ops import ms_deform

    size, iters = 800, 5
    model = gdino_infer.load_model(dev, seed=0)
    images = gdino_infer.random_images(1, size, seed=0)
    gmodel._grid_constants.cache_clear()  # the host's one-off work for an image size, timed alone
    t0 = time.perf_counter()
    gmodel._grid_constants(tuple(GDINO_LEVELS), 256, dev)
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    gdino_infer.predict(model, images, GDINO_PROMPT, dev)  # warm-up
    torch.cuda.synchronize()
    ms_deform.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        logits, boxes, inter = gdino_infer.predict(model, images, GDINO_PROMPT, dev)
    end.record()
    torch.cuda.synchronize()
    launches, ms = ms_deform.LAUNCHES, start.elapsed_time(end) / iters
    events, handles = _stage_events(torch, model)
    gdino_infer.predict(model, images, GDINO_PROMPT, dev)
    torch.cuda.synchronize()
    for hnd in handles:
        hnd.remove()
    stage_ms = {k: s.elapsed_time(e) for k, (s, e) in events.items()}
    check(tuple(logits.shape) == (1, 900, 4) and tuple(boxes.shape) == (1, 900, 4),
          f"logits {tuple(logits.shape)}, boxes {tuple(boxes.shape)}")
    check(logits.device.type == "cuda" and boxes.device.type == "cuda", "the outputs left the card")
    check(tuple(inter["vis_enc"].shape) == (1, GDINO_S, 256), f"encoder tokens {tuple(inter['vis_enc'].shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "logits have non-finite values (the mask is full)")
    check(bool(torch.isfinite(boxes).all()) and 0.0 <= boxes.min().item() and boxes.max().item() <= 1.0,
          f"boxes outside [0, 1]: [{boxes.min().item()}, {boxes.max().item()}]")
    xyxy, score = gmodel.best_box_for_prompt(logits.float(), boxes, torch.tensor([[size, size]], device=dev))
    k3_ms = 6 * k3[("bfloat16", GDINO_S)]["ms"] + 6 * k3[("bfloat16", 900)]["ms"]
    print(f"[gdino] Swin-T + BERT-base 800x800 bf16 ({GDINO_S} tokens, 900 queries): {ms:.3f} ms/forward "
          f"({iters} forwards after 1 warm-up); stages of one forward: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items())
          + f"; K3 launches in {iters} forwards: {launches}; its 12 launches at {k3_ms:.4f} ms are "
          f"{k3_ms / ms:.1%} of a forward; best box {[round(v, 1) for v in xyxy[0].tolist()]} "
          f"score {score[0].item():.4f}; the grid's constants (sine embeddings, centres), built once an image "
          f"size on the host: {grid_ms:.3f} ms", flush=True)
    check(launches == 12 * iters, f"expected {12 * iters} launches of K3 (12 per forward), got {launches}")
    return launches, ms


def phase_gdino_card_vs_cpu(torch, dev):
    """A reduced GroundingDINO in f32 (Swin depths (2, 2, 2, 2), 2 BERT layers,
    2 + 2 transformer layers, 50 queries) at 256x384, card against CPU, same
    weights and image: on the card the sampling is K3, on the CPU the plain
    version. The selected queries must be the same; encoder tokens, logits
    and boxes agree within f32 sums in other orders through 8 Swin blocks, 2
    BERT layers and 4 transformer layers (TF32 off): 1e-4 of the largest
    entry for tokens and logits, 1e-4 absolute for boxes."""
    from threedod_torch import gdino_infer
    from threedod_torch.ops import ms_deform

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(swin_depths=(2, 2, 2, 2), bert_layers=2, enc_layers=2, dec_layers=2, num_queries=50)
    cpu_model = gdino_infer.load_model(torch.device("cpu"), seed=1, dtype=torch.float32, **cfg)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    images = gdino_infer.random_images(1, 384, seed=1)[:, :256]
    t0 = time.perf_counter()
    lc, bc, ic = gdino_infer.predict(cpu_model, images, GDINO_PROMPT, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    before = ms_deform.LAUNCHES
    lg, bg, ig = gdino_infer.predict(gpu_model, images, GDINO_PROMPT, dev)
    torch.cuda.synchronize()
    check(ms_deform.LAUNCHES - before == 4, f"the reduced model launched K3 {ms_deform.LAUNCHES - before} times, not 4")
    lg, bg, ig = lg.cpu(), bg.cpu(), {k: v.cpu() for k, v in ig.items()}
    same = torch.equal(ic["top_idx"], ig["top_idx"])
    print(f"[e2e-gdino] f32 256x384: selected queries equal card vs CPU: {same}; CPU forward {t_cpu:.2f} s", flush=True)
    check(same, "the selected queries differ card vs CPU")
    for what, a, b, rel in (("vis_enc", ic["vis_enc"], ig["vis_enc"], True), ("txt_enc", ic["txt_enc"], ig["txt_enc"], True),
                            ("logits", lc, lg, True), ("boxes", bc, bg, False)):
        err = (a - b).abs().max().item()
        scale = a.abs().max().item() if rel else 1.0
        print(f"[e2e-gdino] {what}: max abs err {err:.3e} (tol {1e-4 * scale:.3e}, largest entry "
              f"{a.abs().max().item():.3f})", flush=True)
        check(err <= 1e-4 * scale, f"{what} differs card vs CPU: {err}")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "threedod_torch")):
        fail("threedod_torch/ not found beside chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per source, started together
    from threedod_torch.ops import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, (lib, log, compile_s) in builds.items():
        print(f"[build] {lib.name}: nvcc {compile_s:.2f} s", flush=True)
        for line in build_report(log):
            print(f"[build] {name}: {line}", flush=True)
    print(f"[build] {len(builds)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3-6: every kernel against its plain version
    k1 = phase_kernel(torch, dev)
    k2 = phase_kernel_bwd(torch, dev)
    fused = phase_fused_kernels(torch, dev, _fused_cases, "dla34")
    fused_resnet = phase_fused_kernels(torch, dev, _resnet_cases, "resnet34")
    phase_k4(torch, dev, fused_resnet["basic_block"])
    k9 = phase_attention_kernel(torch, dev)
    k9b = phase_attention_bwd_kernel(torch, dev)
    k3 = phase_deform_kernel(torch, dev)

    # 7-10: the detector's paths
    runs = {}
    for backbone in ("dla34", "resnet34"):
        fused_launches, fused_ms = phase_main_path(torch, dev, fused=True, backbone=backbone)
        stock_launches, stock_ms = phase_main_path(torch, dev, fused=False, backbone=backbone)
        print(f"[main] {backbone} bs8 512x672 bf16 forward: fused (K4 to K8) {fused_ms:.3f} ms, "
              f"stock (cuDNN) {stock_ms:.3f} ms", flush=True)
        runs[backbone] = (fused_launches, stock_launches)
    phase_stock_trunks(torch, dev)
    phase_fused_vs_stock(torch, dev)
    phase_fused_vs_stock(torch, dev, backbone="resnet34")
    train_fwd, train_bwd, _ = phase_train_path(torch, dev)
    rn_fwd, rn_bwd, _ = phase_train_path(torch, dev, backbone="resnet34", steps=3)
    phase_card_vs_cpu(torch, dev)
    phase_train_card_vs_cpu(torch, dev)

    # 11: the depth path
    depth_launches, _ = phase_depth_path(torch, dev, k9[("bfloat16", 2443)]["ms"])
    phase_depth_card_vs_cpu(torch, dev)

    # 13: depth fine-tuning
    train_k9, train_k9b = phase_depth_train(torch, dev, k9b)
    entry = phase_depth_train_entry(torch, dev)
    phase_depth_train_card_vs_cpu(torch, dev)

    # 12: the GroundingDINO path
    gdino_launches, _ = phase_gdino_path(torch, dev, k3)
    phase_gdino_card_vs_cpu(torch, dev)

    def on_paths(key):
        """Launches of one kernel on the four serving runs, by backbone."""
        return {b: fl[key] + sl[key] for b, (fl, sl) in runs.items()}

    k1_serving = sum(on_paths("roi_align_fwd").values())
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda", **KERNELS["roi_align_fwd"],
         "launches": k1_serving + train_fwd + rn_fwd, "launches_serving": k1_serving,
         "launches_training": train_fwd + rn_fwd, **k1[("bfloat16", 8000)], "library_ms": None},
        {"name": "roi_align_bwd", "route": "cuda", **KERNELS["roi_align_bwd"],
         "launches": train_bwd + rn_bwd, "launches_serving": 0, "launches_training": train_bwd + rn_bwd,
         **k2["bfloat16"], "library_ms": None},
    ]
    for key in FUSED_LAUNCHES["dla34"]:
        # times and bound summed over the launches of one bf16 forward: the
        # ResNet34 forward's for K4, the DLA34 forward's for K5 to K8 (K6's
        # ResNet34 shapes are listed beside them); no single PyTorch call
        # computes any of the five, so no library time
        rows = (fused_resnet if key == "basic_block" else fused)[key]["bfloat16"]
        extra = fused_resnet[key]["bfloat16"] if key == "block_down" else []
        by_bytes = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        by_ops = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        per_path = on_paths(key)
        kernels.append({
            "name": f"fused_{key}", "route": "cuda", **KERNELS[f"fused_{key}"],
            "launches": sum(per_path.values()), "launches_serving": sum(per_path.values()), "launches_training": 0,
            "launches_by_backbone": per_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows + extra),
            "ms": _total(rows, "ms"), "plain_ms": _total(rows, "plain_ms"),
            "bound_ms": by_bytes + by_ops, "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "shapes": rows + extra,
            # K4: the ResNet blocks call it with weights packed once (``ms``); beside it the
            # kernels' own device time and the public call that packs at every call
            **(dict(ms=_total(rows, "packed_call_ms"), kernel_ms=_total(rows, "kernel_ms"),
                    call_packing_ms=_total(rows, "ms")) if key == "basic_block" else {}),
        })
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda", **KERNELS["flash_attention_fwd"],
        "launches": depth_launches + train_k9, "launches_serving": depth_launches, "launches_training": train_k9,
        "launches_training_entry": entry["flash_attention_launches"], **k9[("bfloat16", 2443)],
        "shapes": [dict(shape=f"{d} (1, {s}, 16, 64)", **row) for (d, s), row in k9.items()],
    })
    # K9's backward: the f32 training step's shape (the tool's model is f32)
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", **KERNELS["flash_attention_bwd"],
        "launches": train_k9b, "launches_serving": 0, "launches_training": train_k9b,
        "launches_training_entry": entry["flash_attention_bwd_launches"], **k9b[("float32", (2, 2117, 16, 64))],
        "library": "scaled_dot_product_attention backward (torch.autograd.grad on one retained forward)",
        "shapes": [dict(shape=f"{d} {shape}", **row) for (d, shape), row in k9b.items()],
    })
    # K3: times and bounds summed over the 12 launches of one forward (6 at the
    # encoder's shape, 6 at the decoder's); the library time is the grid_sample
    # composition, four grid_sample calls and a weighted sum, not one call
    k3_rows = [dict(shape=f"{d} Lq={lq} (x6)", count=6, **row) for (d, lq), row in k3.items()]
    k3_bf16 = [r for r in k3_rows if r["shape"].startswith("bfloat16")]
    kernels.append({
        "name": "ms_deform_sample", "route": "cuda", **KERNELS["ms_deform_sample"],
        "launches": gdino_launches, "launches_serving": gdino_launches, "launches_training": 0,
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        **{key: _total(k3_bf16, key) for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in k3_bf16) else "operations",
        "library": "grid_sample composition (ms_deform_attn_core_pytorch: 4 grid_sample calls and a weighted sum)",
        "shapes": k3_rows,
    })
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
