#!/usr/bin/env python3
"""Smoke run of the PyTorch port (threedod_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:
  1. device: a CUDA card must be present; prints nvidia-smi's name and power
     limit, and the torch / CUDA versions;
  2. build: compiles the ROIAlign forward (K1) and backward (K2) kernels, the
     five fused-forward kernels (K4 basic block, K5 tree tail, K6 block down,
     K7 RPN head, K8 FPN level), the flash-attention forward (K9) and backward
     and the deformable sampler (K3) and the card's JPEG decoder (IDCT and
     colour kernels) and PNG decoder from the repository's sources, one nvcc each, started
     together, and prints each kernel's registers and spills (and ptxas's
     warnings that it serialised wgmma);
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
     every block shape it has; then K5 and K8 at their nine DLA34 launch
     shapes the same way (``[K5]`` and ``[K8]`` lines: in bf16 the
     ``conv3x3_wgmma`` and ``conv1x1_wgmma`` launches of a call, the 1x1
     launch alone, both block shapes and CTAs); then K6 at its four DLA34 and
     three ResNet34 launch shapes and K7 at its five the same way (``[K6]``
     and ``[K7]`` lines: in bf16 the ``conv3x3s2_wgmma``, ``conv1x1_wgmma``
     and ``conv3x3_wgmma`` launches of a call, K6's stride-2 launch and K7's
     1x1 launch alone, block shapes and CTAs);
  6. K9 vs its plain PyTorch version at (1, S, 16, 64) for S = 2443, 2048,
     2049, 2175, 4552 (and timed at 1370), in f32 and bf16, with max error, times,
     bound and the time of ``scaled_dot_product_attention`` on the same
     tensors and the ratio of the two; K9's backward after its forward with
     the log-sum-exp at (2, 2117), (1, 2443), (1, 2049) and (1, 2175) x (16,
     64), in both dtypes, against the plain backward, bit-equal twice, beside
     SDPA's backward alone (``torch.autograd.grad`` on one retained forward);
     then K3 vs its plain version at GroundingDINO's two launch
     shapes at 800x800 (Lq 13294 and 900, levels 100x100 to 13x13, 8 heads of
     32, 4 points, locations drawn uniformly), in f32 and bf16, with max
     error, the variant ``ms_deform.sample_plan`` picked, the call's time, the
     kernel's own device time, bound and the time of the grid_sample
     composition (four calls and a weighted sum);
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
     a forward, ms per forward and the stages' times; K3 on the 12 inputs the
     model handed it in the warm-up forward, in bf16 and f32, against its
     plain version, with the kernel's device time, the call's time and the
     12 launches' device time as a share of the forward; then a reduced model in
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
 14. Base_Synth (``configs/Base_Synth.yaml``: DLA34-FPN, bf16, 10 classes,
     bs8 at 384x512) from the fixture's JPEGs (decoded on the card, the
     decoder checked in phase 17, which runs before it) to AP: K1 and K2
     against their plain versions at its shapes (the
     training step's 8 x 256 ROIs, an evaluation forward's 256 proposals and
     100 detections, 384x512 levels, f32 and bf16); ``python -m
     threedod_torch.train_net`` in two processes that cannot import Pillow or
     PyYAML, 30 iterations and then ``--resume`` to 60, each evaluating
     synth_test: finite losses falling over the 60, no step skipped, one K1
     and one K2 launch a step, the checkpoint resumed at iteration 30, finite
     AP2D and AP3D in ``results.json``, ms an iteration, the loader's share
     and peak memory; and a seeded state dict wrapped as a detectron2
     checkpoint (``{"model": ...}``, ``num_batches_tracked``) through
     ``--eval-only``, which must evaluate as the direct load does.
 15. weak Cube R-CNN (``configs/Omni_combined_Synth.yaml``: Base_Synth with
     ``RCNN3DCombined`` and the 7-loss menu): K1 and K2 against their plain
     versions at its shapes (Base_Synth's); the RANSAC ground planes of 8
     fixture depth and ground maps at 384x512 on the card against the CPU
     with the same hypothesis indices (normals to 1e-5) and the card's time
     for the 8 fits; one f32 weak training step at batch 2 on the card
     against the CPU (same weights, batch with the fixture's maps, sampling
     noise and hypotheses: every loss, a few gradients; the weak losses under
     ``torch.cuda.set_sync_debug_mode("error")``); then ``python -m
     threedod_torch.train_net`` in processes that cannot import Pillow or
     PyYAML, 30 iterations and then ``--resume`` to 50, each evaluating
     synth_test: every loss of the menu present and finite in every logged
     window, no step skipped, the loss falling, one K1 and one K2 launch a
     step, finite AP2D and AP3D, ms an iteration, the loader's share and
     peak memory; and ``--eval-only`` of the final checkpoint, which must
     evaluate as the resumed run did.
 16. BoxNet (``configs/BoxNet_Synth.yaml``: Base_Synth's DLA34-FPN with the
     propose-and-score stage, 16 ground-truth slots, 1000 proposals a box):
     K1 and K2 against their plain versions at its shapes (Base_Synth's: a
     PRED forward pools 1 x 256 proposals); ``boxer.propose_and_score`` on a
     fixture image card vs CPU with the same variates (every score, the
     ground normal, IoU3D, the best cubes), the card's call under
     ``torch.cuda.set_sync_debug_mode("error")``, and the card's ms for the
     call and each stage; then, in processes that cannot import Pillow or
     PyYAML, ``python -m threedod_torch.eval_boxes`` MABO in GT mode and AP in
     PRED mode over synth_test (finite results; K1 launches: none in GT mode,
     one an image in PRED mode), ``train.pseudo_gt pseudo`` over synth_train
     into a datasets root under ``build/`` that links the fixture (nothing
     written into ``datasets/``), and ``python -m threedod_torch.train_net``
     on Base_Synth for 30 iterations on that pseudo ground truth: no step
     skipped, the loss falling, one K1 and one K2 launch a step; every time
     beside the card's name and power limit.
 17. weak-method assets (run after phase 10, before the phases that train on
     the decoder's images): the JPEG decode gate on the 88 fixture JPEGs
     and on four Pillow-written 61x45 files (4:4:4; 4:2:2 and 4:2:0 with
     restart markers; grayscale): per plane against libjpeg's (Pillow's
     ``draft("YCbCr")``), the IDCT and colour kernels against their plain
     versions, bit for bit, the decoded RGB equal to Pillow's, 0 levels in
     every file; times an image); ``generate_object_masks``
     with a seeded SAM-HQ ViT-B checkpoint at 1024 in bf16 over synth_test
     (20 files of (N, 480, 640) uint8 masks and the annotations' ids, read
     back by the port's mapper); ``generate_ground_segmentations`` with a
     seeded GroundingDINO checkpoint over synth_val (``--box-threshold 0``;
     12 K3 launches a forward; K3 against its plain version on the inputs of
     the tool's first image) and with ``--heuristic``, then ``filter_ground``;
     ``generate_depth_maps --random-weights`` (vitl, 518) and
     ``generate_normal_vectors`` on those maps and masks (finite, unit
     normals); SAM and SAM-HQ reduced (256 px, width 768, depth 4) in f32
     card vs CPU; the SAM encoder's and decoder's ms and each tool's seconds,
     beside the card's name and power limit.
 18. the weak ``segmentation`` loss and the cube head's options (after phase
     16; K1 and K2 at the cube branch's own pool: 8 x 64 ROIs at 5x5 bins and
     at 7x7 over ROIs scaled by 1.25, 1 x 100 detections likewise, f32 and
     bf16, against their plain versions); the soft hull fill at 512 ROIs on
     the 96x128 mask grid card vs CPU, with its ms and the memory it adds;
     one f32 weak step with the 8-loss menu (the 7 and ``segmentation``) card
     vs CPU on ellipse masks; phase 17's seeded SAM-HQ checkpoint writes
     synth_train's object masks into a datasets root under ``build/`` that
     links the fixture (the share of ground-truth slots whose stored mask is
     not the filled box is printed, and must be above 0); then, in a process
     that cannot import Pillow or PyYAML, ``train_net`` on
     Omni_combined_Synth with the 8-loss menu on those masks for 30
     iterations and an evaluation (``Cube/loss_seg`` finite in every logged
     window, the loss falling, one K1 and one K2 launch a step); in this
     process, Base_Synth
     for 20 iterations and an evaluation under each of two option sets that
     between them set every flag of the cube head (two K1 and two K2 launches
     a step, two K1 launches an evaluation forward), and the 2D-only head
     (``loss_w_3d`` 0: no cube loss, one K1 and one K2 a step, finite AP2D);
     BoxNet's ``propose_and_score`` with SAM's masks of a training image.
 19. data parallelism (``threedod_torch/parallel/dist.py``) on the one card:
     Base_Synth's DLA34 step at bs8 384x512 without a process group, under a
     world-1 NCCL group (every collective runs) and over two gloo ranks that
     this script spawns on the card, 4 images each of the same global batch
     of 8: one f32 step (TF32 off, both samplers saturated) of each against
     the one-process step (losses 1e-4 relative, running statistics 1e-5 of
     their largest entry, gradients by cosine: the CPU tests'), the two
     ranks' gradients equal; then 5 bf16 steps of Base_Synth as shipped on
     each: ms an iteration, collectives a step, the NCCL kernels' device
     time of one step at world 1, 5 K1 and 5 K2 launches on every rank.
 20. the other DLA trunks, oracle 2D boxes, the drawings, the demos and KITTI
     (after phase 14, whose checkpoint it reads): the stock bs8 512x672 bf16
     forward of dla46_c, dla46x_c, dla60x_c, dla60, dla60x, dla102, dla102x
     and dla169 under the FPN (ms, trunk + FPN ms, peak memory, 2 K1 launches
     a forward, no fused kernel); cuDNN's grouped 3x3 of dla102x's
     bottlenecks beside the dense 3x3 of the same shape; dla46x_c and dla102x
     in f32 card vs CPU at 128x160 (FPN levels); dla102x under
     ``fused_forward()`` (K7 5 and K8 3 launches a forward, no K5 or K6, fused
     vs stock); K8 against its plain version at the new trunks' FPN shapes
     (lateral widths 64 to 512, and 1024 at 16x20); a DLA34 oracle forward
     on a synth_test batch card vs CPU (one K1 launch); ``python -m
     threedod_torch.demo`` over synth_test's 20 JPEGs with phase 14's
     checkpoint (every PNG re-read equal to the drawing of the card's
     detections); ``train_net`` on dla102x, 20 iterations with ``vis_period``
     5 and its evaluation, and ``eval_boxes`` AP with ``vis_period`` 5, in
     processes that cannot import Pillow, PyYAML or matplotlib; ``python -m
     threedod_torch.kitti_demo --display`` on synth_test, the KITTI export of
     its JSON and the z overwrite against the exported ground truth; every
     number beside the card's name and power limit.
 21. PNG on the card, the official checkpoints and the rest of the tools
     (after phases 14, 16 and 20, whose checkpoint, MABO results and KITTI
     predictions it reads): the PNG kernel (``csrc/png_decode.cu``) against
     its plain version, 0 levels, on every colour type (gray, RGB, palette,
     gray + alpha, RGBA) at every bit depth it allows (1, 2, 4, 8, 16),
     interlaced (Adam7) and not, at 1x1, 3x5, 37x53, 1242x375 and 2100x37,
     and with each filter forced at 1242x375; its times beside the bounds by
     bytes and by the dependence chain of its rows' filters
     (``png.step_latency_ns``, ``png.dependence_path_ns``); progressive
     JPEGs (4:4:4, 4:2:2 and 4:2:0 with restart markers, gray; crops and
     whole 640x480 images, those also through ``imread_rgb``) through the
     JPEG kernels against their plain versions and Pillow, 0 levels, and
     their host Huffman ms beside the same images written sequential;
     RGB-coded (Adobe marker; IDs R, G, B alone), CMYK and YCCK JPEGs and
     every sampling (4:1:1, 4:4:0, 4x2 over 1x1, one scan per component,
     chroma 2 columns wide), at 61x45, 1x1 and 640x480, through both
     kernels against their plain versions and through ``decode_jpeg`` and
     ``imread_rgb`` against Pillow, 0 levels, with the colour kernel's device
     and call ms at 640x480 4:2:0, CMYK and 4:1:1 beside its bytes bound, and
     ``python -m threedod_torch.demo`` over four synth_test images rewritten
     RGB-coded, CMYK, 4:1:1 and 4:4:0 (``colour_gate``); arithmetic-coded
     JPEGs (sequential and progressive, with DAC conditioning and restart
     markers, at 61x45 and 1x1, and two whole 640x480 fixture images
     transcoded with their own scans) and 8-bit lossless ones (gray, RGB and
     CMYK with predictors 1 to 7, and a 640x480 RGB file) through the
     kernels (a lossless file through the colour kernel alone) against their
     plain versions and through ``decode_jpeg`` and ``imread_rgb`` against
     Pillow, 0 levels, with the host decode's ms of the arithmetic
     transcodes beside the Huffman decode of the same coefficients, the
     lossless host ms and the colour kernel's device ms on the lossless
     file, and ``python -m threedod_torch.demo`` over four synth_test images
     rewritten arithmetic and lossless (``entropy_gate``); impulse blocks
     where libjpeg-turbo's SIMD IDCT wraps and saturates through both IDCT
     instances against their plain versions and the plain one against this
     machine's Pillow, and damaged JPEGs (bit flips, byte corruptions, EOI
     inside a scan, cuts, restart markers dropped and renumbered, dropped
     scans; baseline, progressive, gray, arithmetic, lossless) through
     ``decode_jpeg`` and ``imread_rgb`` against Pillow, 0 levels, or refused
     with the path where Pillow refuses them, with both instances' device ms
     (``damage_gate``); incomplete progressions through the IDCT's smoothing
     instance, and ``python -m threedod_torch.demo`` over four synth_test
     images cut to incomplete progressions and four rewritten with damage
     (``smooth_gate``); PNG
     copies of synth_test, plain and Adam7-interlaced, written from the card's
     JPEG decode, decoded on the card to the same pixels; ``python -m
     threedod_torch.kitti_demo --display`` on each (2 K1 launches an image;
     phase 20's detections, then the plain copies'); ``depth_to_pointcloud`` with vitl and
     an official-layout checkpoint on a 1242x375 PNG (518x1722, 4552 tokens,
     24 K9 launches, K9 held against its plain version at that length in 6;
     the PLY's z the depth of the port-dict model);
     ``fit_proposal_coefs``, ``priors``, ``datasetminify``, ``grid_effect``
     (card vs CPU), ``visualise_gt``, ``results`` and ``mabo_plots``, each with
     its seconds, every figure re-read.
The line before the last is a JSON object with each kernel's launches, error,
times and bound (K1 to K8 also ``kernel_ms``, the device time of the kernel
alone beside ``ms``, the call's: for K4 to K8 the call with weights packed
once, beside ``call_packing_ms``, the public call that packs; K5, K7 and K8
also ``conv1x1_ms``, K6 ``stride2_ms`` and its ResNet34 sums
``resnet34_*``; K1 and K2 also ``cube_pool_shapes``, phase 18's rows; K8 also phase
20's rows among its ``shapes``, and K7 and K8 phase 20's dla102x launches; K3 also ``model_*``, its 12 launches on the model's own
inputs, and the ground tool's launches; then the JPEG decoder's two kernels
and the PNG kernel, which replace no TPU kernel); the last line is {"ok": true, "device":
{...}}. ``k3_report`` times
K3 alone and ``phase_k4``, ``phase_k5_k8`` and ``phase_k6_k7`` time K4 to K8
alone (run them with runpy from a tree's root: their docstrings say how),
to compare two trees in one call.
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


# sessions of torch.profiler tried before a measurement fails: now and then a
# session keeps no device event at all (on an H100, in one of four runs of
# this file in one process each, a K4 session of phase 5), and a new one does
PROFILER_TRIES = 5


def device_ms(torch, fn, iters: int, kernels) -> dict:
    """Mean device time of one call of ``fn`` by kernel, from
    ``torch.profiler``: {label: ms} for each label of ``kernels`` (label ->
    substring of the kernel's name, or a tuple of them), plus "all", every
    kernel the calls ran. A session that saw no device time for a label runs
    again, at most ``PROFILER_TRIES`` sessions in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = dict.fromkeys([*kernels, "all"], 0.0)
        seen = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            total["all"] += us
            if us:
                seen.append(evt.key[:60])
            for label, sub in kernels.items():
                if any(k in evt.key for k in ((sub,) if isinstance(sub, str) else sub)):
                    total[label] += us
        if all(total[label] > 0 for label in kernels):
            return {k: v / iters / 1e3 for k, v in total.items()}
        print(f"[profiler] saw no device time for {sorted(kernels)}; it saw {seen[:8]}: timing again", flush=True)
    fail(f"the profiler saw no device time for {sorted(kernels)} in {PROFILER_TRIES} sessions running")


_PROFILER_WARM = []
LEAD_GROUPS = 3  # untimed groups ahead of the timed ones in a device_ms_each session


def device_ms_each(torch, fns, iters: int, kernel: str) -> list:
    """Mean device time of the kernel whose name holds ``kernel``, which each
    call of each of ``fns`` launches once, all timed in one ``torch.profiler``
    session (a process gets only so many sessions: past about 140 the
    profiler saw no kernel). Each function's calls end in a synchronize and
    20 ms of host sleep, and the kernels are split where the card idled longer
    than 10 ms (the host's and the card's clocks do not line up closely
    enough to split by host time, and the profiler drops events now and
    then: one of 80 in one run, a whole group of 20 in another, more in the
    first session of a process, which a throw-away session takes, and the
    first kernels of a session, which ``LEAD_GROUPS`` untimed groups take). A
    session that lost a group runs again, at most ``PROFILER_TRIES`` sessions
    in all; the mean is over the kernels kept."""
    from torch.profiler import ProfilerActivity, profile

    if not _PROFILER_WARM:
        with profile(activities=[ProfilerActivity.CUDA]):
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        _PROFILER_WARM.append(True)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # leading groups that are not timed: once a process has run for
            # a minute or so, a session can lose the kernels of its first
            # millisecond or two, whatever ran before it (5 to 13 kernels on
            # an H100; threedod_torch/tools/profiler_drops.py), and once lost
            # two whole groups in each of 5 sessions (phase 17's K3, 5
            # kernels a group), so only the last len(fns) groups are read
            for fn in (fns[0],) * LEAD_GROUPS + tuple(fns):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
        groups, end = [], None
        for e in sorted((e for e in prof.events()
                         if kernel in e.name and e.device_type != torch.autograd.DeviceType.CPU),
                        key=lambda e: e.time_range.start):
            if end is None or e.time_range.start - end > 10000.0:
                groups.append([])
            groups[-1].append(e.time_range.elapsed_us())
            end = e.time_range.end
        groups = groups[-len(fns):]
        if len(groups) == len(fns) and all(iters // 2 <= len(g) <= iters for g in groups):
            return [sum(g) / len(g) / 1e3 for g in groups]
        print(f"[profiler] kept the kernels named {kernel} as {[len(g) for g in groups]}, not {len(fns)} groups "
              f"of {iters}: timing again", flush=True)
    fail(f"the profiler lost kernels named {kernel} in {PROFILER_TRIES} sessions running")


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
                    sms = torch.cuda.get_device_properties(dev).multi_processor_count
                    bn, mt = fcv.basic_block_tile(8, h, w, c, sms=sms)
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


# device-time names of K5's and K8's kernels: bf16 conv3x3_wgmma and
# conv1x1_wgmma (K5 three or five launches a call, K8 two), f32 the one-kernel
# tree_tail_kernel and fpn_level_kernel (also the earlier bf16 design's)
K5_K8_KERNELS = {"tree_tail": ("conv3x3_wgmma", "conv1x1_wgmma", "tree_tail_kernel"),
                 "fpn_level": ("conv3x3_wgmma", "conv1x1_wgmma", "fpn_level_kernel")}


def _k5_k8_cases(torch, dev, dtype):
    """(kernel, label, args, keywords, FLOPs, launch shape (b, h, w, root
    sources or [Cl], Cout, C of the 3x3s)) at every K5 and K8 launch shape of
    the DLA34 forward, in ``TREE_TAIL_SHAPES`` and ``FPN_SHAPES`` order, on
    seeded inputs."""
    b = 8
    act, weight, bias, block = _seeded(torch, dev, dtype, seed=6)
    for c, h, w, two, kid_c, incl in TREE_TAIL_SHAPES:
        sources = [c, c, *kid_c] + ([c] if incl else [])
        args = (act(c, h, w), [act(k, h, w) for k in kid_c], block(c, c) if two else None, block(c, c),
                weight(c, sum(sources), 1), bias(c))
        flops = 2 * b * h * w * ((4 if two else 2) * 9 * c * c + sum(sources) * c)
        yield ("tree_tail", f"C={c} {h}x{w} {'two blocks' if two else 'one block'} children={list(kid_c)}"
               f"{'+x' if incl else ''}", args, dict(two_blocks=two, include_input_child=incl), flops,
               (b, h, w, sources, c, c))
    for cl, h, w, emit in FPN_SHAPES:
        args = (act(cl, h, w), act(256, h // 2, w // 2), weight(256, cl, 1), bias(256), weight(256, 256, 3),
                bias(256))
        yield ("fpn_level", f"Cl={cl} {h}x{w} emit_cur={emit}", args, dict(emit_cur=emit),
               2 * b * h * w * (cl * 256 + 9 * 256 * 256), (b, h, w, [cl], 256, 256))


def phase_k5_k8(torch, dev, rows=None):
    """K5 and K8 at every DLA34 launch shape (the shapes of ``_fused_cases``):
    the kernels' own device time (``torch.profiler``: every ``conv3x3_wgmma``
    and ``conv1x1_wgmma`` launch of a call in bf16, the one kernel in f32),
    the 1x1 launch's own time, the call with weights packed once (what the
    DLA trees and the FPN pay), TFLOP/s on the kernel time, and in bf16 the
    block shapes and CTAs of the launches, and the 1x1 launch at both its
    block shapes (1 and 2 warpgroups). ``rows`` (phase 5's results: the call
    that packs, the cuDNN chain, the bound) get these numbers added. Runs on
    a package with the earlier one-kernel design too (no packing), for
    comparisons."""
    from threedod_torch.ops import fused_conv as fcv

    redesign = hasattr(fcv, "pack_tree_tail")
    out = {}
    with torch.no_grad():
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            index = {"tree_tail": 0, "fpn_level": 0}
            for kernel, label, args, kw, flops, (b, h, w, sources, cout, c) in _k5_k8_cases(torch, dev, dtype):
                tag, i = ("K5" if kernel == "tree_tail" else "K8"), index[kernel]
                index[kernel] += 1
                row, labels = {}, {"kernel": K5_K8_KERNELS[kernel]}
                if redesign:
                    if kernel == "tree_tail":
                        x, kids, bb_a, bb_b, wr, br = args
                        packed = fcv.pack_tree_tail(bb_a, bb_b, wr, br, dtype, children=[k.shape[1] for k in kids],
                                                    **kw)
                        call = lambda t=None, x=x, k=kids, p=packed: fcv.fused_tree_tail_packed(x, k, p, tiles=t)  # noqa: E731
                    else:
                        packed = fcv.pack_fpn_level(*args[2:], dtype)
                        call = lambda t=None, a=args, p=packed, e=kw["emit_cur"]: fcv.fused_fpn_level_packed(  # noqa: E731
                            a[0], a[1], p, emit_cur=e, tiles=t)
                    row["packed_call_ms"] = cuda_ms(call, iters=10, warmup=2)
                    if dtype == torch.bfloat16:
                        labels["conv1x1"] = "conv1x1_wgmma"
                else:
                    call = lambda a=args, k=kw: getattr(fcv, f"fused_{kernel}")(*a, **k)  # noqa: E731
                dev_ms = device_ms(torch, call, 10, labels)
                row["kernel_ms"] = dev_ms["kernel"]
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                text = (f"kernel (device) {row['kernel_ms']:.4f} ms, {row['kernel_tflops']:.1f} TFLOP/s"
                        + (f", call with packed weights {row['packed_call_ms']:.4f} ms" if redesign else ""))
                if "conv1x1" in labels:
                    sms = torch.cuda.get_device_properties(dev).multi_processor_count
                    tile3, tile1 = fcv.basic_block_tile(b, h, w, c, sms=sms), fcv.conv1x1_tile(b, h, w, sources, cout,
                                                                                              sms=sms)
                    n3 = (4 if kw.get("two_blocks") else 2) if kernel == "tree_tail" else 1
                    slice1 = fcv.K1X1_SLICE
                    row.update(conv1x1_ms=dev_ms["conv1x1"], block_3x3=list(tile3), block_1x1=[slice1, tile1],
                               ctas_3x3=-(-b * h * w // (64 * tile3[1])) * -(-c // tile3[0]), launches_3x3=n3,
                               ctas_1x1=-(-b * h * w // (64 * tile1)) * -(-cout // slice1), cluster=1)
                    tiles = {}
                    for mt in fcv.K1X1_WARPGROUPS:
                        order = (tile3, mt) if kernel == "tree_tail" else (mt, tile3)
                        tiles[f"{slice1}x{mt}"] = device_ms(
                            torch, lambda c=call, o=order: c(o), 10, {"conv1x1": "conv1x1_wgmma"})["conv1x1"]
                    row["block_shapes_1x1_ms"] = tiles
                    text += (f"; 1x1 launch (device) {row['conv1x1_ms']:.4f} ms; 3x3 block {tile3[0]} channels x "
                             f"{tile3[1]} warpgroups, {n3} launch{'es' if n3 > 1 else ''} of {row['ctas_3x3']} CTAs; "
                             f"1x1 block {slice1} x {tile1}, 1 launch of {row['ctas_1x1']} CTAs; cluster 1; "
                             "1x1 block shapes (bn x warpgroups) "
                             + ", ".join(f"{k} {v:.4f}" for k, v in tiles.items()) + " ms")
                if rows is not None:
                    base = rows[kernel][dtype_name][i]
                    base.update(row)
                    text = (f"call {base['ms']:.4f} ms, cuDNN chain {base['plain_ms']:.4f} ms, bound "
                            f"{base['bound_ms']:.4f} ms ({base['bound_by']}); ") + text
                print(f"[{tag}] {dtype_name} {label}: {text}", flush=True)
                out.setdefault(kernel, {}).setdefault(dtype_name, []).append(row)
            for kernel, tag in (("tree_tail", "K5"), ("fpn_level", "K8")):
                got = out[kernel][dtype_name]
                summed = {k: sum(r[k] for r in got) for k in ("kernel_ms", "packed_call_ms", "conv1x1_ms")
                          if k in got[0]}
                print(f"[{tag}] {dtype_name}, summed over the {len(got)} launches of one dla34 forward: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in summed.items()), flush=True)
    return out


# device-time names of K6's and K7's kernels: bf16 conv3x3s2_wgmma (K6's
# stride-2 3x3), conv1x1_wgmma (K6's projection, K7's predictors) and
# conv3x3_wgmma (K6's second 3x3, K7's 3x3); f32 (and the earlier one-kernel
# bf16 design) block_down_kernel and conv_relu_head_kernel
K6_K7_KERNELS = {"block_down": ("conv3x3s2_wgmma", "conv3x3_wgmma", "conv1x1_wgmma", "block_down_kernel"),
                 "conv_relu_head": ("conv3x3_wgmma", "conv1x1_wgmma", "conv_relu_head_kernel")}


def _k6_k7_cases(torch, dev, dtype):
    """(kernel, tag, label, args, pool_residual, FLOPs, launch shape) at every
    K6 launch shape of the DLA34 forward (pooled) and of the ResNet34 forward
    (subsampled), and every K7 launch shape, on seeded inputs."""
    b = 8
    act, weight, bias, block = _seeded(torch, dev, dtype, seed=8)
    for shapes, pool, net in ((BLOCK_DOWN_SHAPES, True, "dla34"), (RESNET_BLOCK_DOWN_SHAPES, False, "resnet34")):
        for cin, c, hi, wi in shapes:
            ho, wo = hi // 2, wi // 2
            args = (act(cin, hi, wi), *block(cin, c), weight(c, cin, 1), bias(c))
            flops = 2 * b * ho * wo * (9 * cin * c + 9 * c * c + cin * c)
            yield ("block_down", net, f"Cin={cin} C={c} {hi}x{wi} {'pooled' if pool else 'subsampled'}", args, pool,
                   flops, (b, ho, wo, cin, c))
    for h, w in HEAD_SHAPES:
        args = (act(256, h, w), weight(256, 256, 3), bias(256), weight(15, 256, 1), bias(15))
        yield ("conv_relu_head", "dla34", f"C=256 {h}x{w}", args, None, 2 * b * h * w * (9 * 256 * 256 + 256 * 15),
               (b, h, w, 256, 15))


def phase_k6_k7(torch, dev, rows=None, resnet_rows=None, shapes=False):
    """K6 at its four DLA34 and three ResNet34 launch shapes and K7 at its
    five (the shapes of ``_fused_cases`` and ``_resnet_cases``): the kernels'
    own device time (``torch.profiler``: every launch of a call in bf16, the
    one kernel in f32), in bf16 K6's stride-2 launch and K7's 1x1 launch
    alone, the call with weights packed once (what the DLA trees, the ResNet
    blocks and the RPN head pay), TFLOP/s on the kernel time, and in bf16 the
    block shapes and CTAs of each launch; with ``shapes`` also the stride-2
    launch at every block shape and K7's 1x1 at both. ``rows`` and
    ``resnet_rows`` (phase 5's results for the DLA34 and ResNet34 forwards:
    the call that packs, the cuDNN chain, the bound) get these numbers added.
    Runs on a package with the earlier one-kernel design too (no packing),
    for comparisons."""
    from threedod_torch.ops import fused_conv as fcv

    redesign = hasattr(fcv, "pack_block_down")
    out = {}
    with torch.no_grad():
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            index = {}
            for kernel, net, label, args, pool, flops, (b, h, w, cin, c) in _k6_k7_cases(torch, dev, dtype):
                tag = "K6" if kernel == "block_down" else "K7"
                i = index.get((kernel, net), 0)
                index[kernel, net] = i + 1
                row, labels = {}, {"kernel": K6_K7_KERNELS[kernel]}
                bf16 = redesign and dtype == torch.bfloat16
                if redesign:
                    if kernel == "block_down":
                        packed = fcv.pack_block_down(*args[1:], dtype)
                        call = lambda t=None, x=args[0], p=packed, pl=pool: fcv.fused_block_down_packed(  # noqa: E731
                            x, p, pool_residual=pl, tiles=t)
                    else:
                        packed = fcv.pack_conv_relu_head(*args[1:], dtype)
                        call = lambda t=None, x=args[0], p=packed: fcv.fused_conv_relu_head_packed(x, p, tiles=t)  # noqa: E731
                    row["packed_call_ms"] = cuda_ms(call, iters=10, warmup=2)
                    if bf16:
                        labels["alone"] = "conv3x3s2_wgmma" if kernel == "block_down" else "conv1x1_wgmma"
                elif kernel == "block_down":
                    call = lambda a=args, pl=pool: fcv.fused_block_down(*a, pool_residual=pl)  # noqa: E731
                else:
                    call = lambda a=args: fcv.fused_conv_relu_head(*a)  # noqa: E731
                dev_ms = device_ms(torch, call, 10, labels)
                row["kernel_ms"] = dev_ms["kernel"]
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
                text = (f"kernel (device) {row['kernel_ms']:.4f} ms, {row['kernel_tflops']:.1f} TFLOP/s"
                        + (f", call with packed weights {row['packed_call_ms']:.4f} ms" if redesign else ""))
                if bf16:
                    sms = torch.cuda.get_device_properties(dev).multi_processor_count
                    slice1 = fcv.K1X1_SLICE
                    if kernel == "block_down":
                        s2, tilep, tile3 = (fcv.block_down_tile(b, h, w, cin, c, sms=sms),
                                            fcv.conv1x1_tile(b, h, w, [cin], c, sms=sms), fcv.basic_block_tile(b, h, w, c, sms=sms))
                        row.update(stride2_ms=dev_ms["alone"], block_s2=list(s2), block_1x1=[slice1, tilep],
                                   block_3x3=list(tile3),
                                   ctas_s2=-(-b * h // (8 * s2[1])) * -(-w // fcv.S2_TW) * -(-c // s2[0]),
                                   ctas_1x1=-(-b * h * w // (64 * tilep)) * -(-c // slice1),
                                   ctas_3x3=-(-b * h * w // (64 * tile3[1])) * -(-c // tile3[0]), cluster=1)
                        text += (f"; stride-2 launch (device) {row['stride2_ms']:.4f} ms; stride-2 block {s2[0]} "
                                 f"channels x {s2[1]} warpgroups ({8 * s2[1]}x8 positions), {row['ctas_s2']} CTAs; "
                                 f"1x1 block {slice1} x {tilep}, {row['ctas_1x1']} CTAs; 3x3 block {tile3[0]} x "
                                 f"{tile3[1]}, {row['ctas_3x3']} CTAs; cluster 1")
                        if shapes:
                            row["block_shapes_s2_ms"] = {
                                f"{t[0]}x{t[1]}": device_ms(torch, lambda c_=call, t_=(t, tilep, tile3): c_(t_), 10,
                                                            {"s2": "conv3x3s2_wgmma"})["s2"] for t in fcv.K6_SHAPES}
                            text += "; stride-2 block shapes (bn x warpgroups) " + ", ".join(
                                f"{k} {v:.4f}" for k, v in row["block_shapes_s2_ms"].items()) + " ms"
                    else:
                        # K7's launch shape: cin is the conv's channel count, c the predictors'
                        tile3, tile1 = fcv.basic_block_tile(b, h, w, cin, sms=sms), fcv.conv1x1_tile(b, h, w, [cin], c,
                                                                                                     sms=sms)
                        row.update(conv1x1_ms=dev_ms["alone"], block_3x3=list(tile3), block_1x1=[slice1, tile1],
                                   ctas_3x3=-(-b * h * w // (64 * tile3[1])) * -(-cin // tile3[0]),
                                   ctas_1x1=-(-b * h * w // (64 * tile1)), cluster=1)
                        text += (f"; 1x1 launch (device) {row['conv1x1_ms']:.4f} ms; 3x3 block {tile3[0]} x "
                                 f"{tile3[1]}, {row['ctas_3x3']} CTAs; 1x1 block {slice1} x {tile1}, "
                                 f"{row['ctas_1x1']} CTAs; cluster 1")
                        if shapes:
                            row["block_shapes_1x1_ms"] = {
                                f"{slice1}x{mt}": device_ms(torch, lambda c_=call, t_=(tile3, mt): c_(t_), 10,
                                                            {"c1": "conv1x1_wgmma"})["c1"] for mt in fcv.K1X1_WARPGROUPS}
                            text += "; 1x1 block shapes (bn x warpgroups) " + ", ".join(
                                f"{k} {v:.4f}" for k, v in row["block_shapes_1x1_ms"].items()) + " ms"
                target = resnet_rows if net == "resnet34" else (rows or {}).get(kernel)
                if target is not None:
                    base = target[dtype_name][i]
                    base.update(row)
                    text = (f"call {base['ms']:.4f} ms, cuDNN chain {base['plain_ms']:.4f} ms, bound "
                            f"{base['bound_ms']:.4f} ms ({base['bound_by']}); ") + text
                print(f"[{tag}] {dtype_name} {net} {label}: {text}", flush=True)
                out.setdefault((kernel, net), {}).setdefault(dtype_name, []).append(row)
            for (kernel, net), by_dtype in out.items():
                got = by_dtype[dtype_name]
                summed = {k: sum(r[k] for r in got) for k in ("kernel_ms", "packed_call_ms", "stride2_ms", "conv1x1_ms")
                          if k in got[0]}
                print(f"[{'K6' if kernel == 'block_down' else 'K7'}] {dtype_name}, summed over the {len(got)} launches "
                      f"of one {net} forward: " + ", ".join(f"{k} {v:.4f}" for k, v in summed.items()), flush=True)
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
# dispatch threshold, one-row tails past 64- and 128-row tiles,
# depth_to_pointcloud's (vitl at 518x1722: 37 x 123 patches and the class
# token), and the native 518x518 grid's 1370 tokens, which the port's
# dispatch leaves to the plain version (timed only for comparison)
ATTN_TOKENS = (2443, 2048, 2049, 2175, 4552, 1370)


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


def _k3_plan(ms_deform, value, shapes, loc) -> str:
    """The variant ``sample_plan`` picks, as text ("" for a package without
    one, such as the tree before the plan, timed beside this one)."""
    if not hasattr(ms_deform, "sample_plan"):
        return ""
    b, lq, h, n_lvl, p, _ = loc.shape
    plan = ms_deform.sample_plan(shapes, lq, h, value.shape[3], value.dtype, sms=ms_deform.card_sms(value.device),
                                 b=b, points=p)
    return f"{plan.kind} {plan.vec_bytes}-byte lanes x {plan.lanes}, {plan.staged} levels staged " \
           f"({plan.smem_bytes} bytes), {plan.per_pair} blocks an (image, head)"


def _k3_measure(torch, ms_deform, cases, iters: int, plain_iters: int = 3):
    """K3 on each of ``cases`` ((label, value, shapes, locations, weights))
    against its plain version: the error (checked), the call's time (CUDA
    events), the kernel's own device time (``torch.profiler``, one session
    for all the cases), the plain version's time and the bound. Prints one
    line a case; returns a dict a case."""
    rows = []
    for what, value, shapes, loc, w in cases:
        dtype_name = str(value.dtype).split(".")[-1]
        out = ms_deform.ms_deform_sample_cuda(value, shapes, loc, w)
        ref = ms_deform.ms_deform_sample_reference(value, shapes, loc, w)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == loc.shape[:3] + value.shape[3:] and out.dtype == value.dtype,
              f"K3 output {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()), f"K3 {what}: non-finite output")
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL_DEFORM[dtype_name] * scale
        check(err <= tol, f"K3 {what} disagrees with the plain version: {err} > {tol}")
        ms = cuda_ms(lambda: ms_deform.ms_deform_sample_cuda(value, shapes, loc, w), iters)
        plain_ms = cuda_ms(lambda: ms_deform.ms_deform_sample_reference(value, shapes, loc, w), plain_iters)
        bound, by = deform_bound_ms(value, loc, w, out)
        rows.append(dict(max_abs_err=err, tol=tol, scale=scale, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, plan=_k3_plan(ms_deform, value, shapes, loc)))
    kernel_ms = device_ms_each(torch, [lambda c=c: ms_deform.ms_deform_sample_cuda(*c[1:]) for c in cases], iters,
                               "ms_deform")
    for (what, *_), row, k_ms in zip(cases, rows, kernel_ms):
        row["kernel_ms"] = k_ms
        print(f"[K3] {what}: max_abs_err={row['max_abs_err']:.3e} (tol {row.pop('tol'):.3e}, largest entry "
              f"{row.pop('scale'):.3f}) kernel (device) {k_ms:.4f} ms, call {row['ms']:.4f} ms (call minus kernel "
              f"{row['ms'] - k_ms:.4f}), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}){'; ' + row['plan'] if row['plan'] else ''}", flush=True)
    return rows


def _k3_uniform_inputs(torch, dev):
    """Phase 6's K3 inputs: a (1, 13294, 8, 32) f32 value block and, for the
    encoder's Lq = 13294 and the decoder's 900, locations drawn uniformly in
    [-0.1, 1.1] and softmaxed f32 weights. Returns (value, {Lq: (locations,
    weights)})."""
    gen = torch.Generator().manual_seed(13)
    h, d, n_lvl, p = 8, 32, len(GDINO_LEVELS), 4
    value = torch.randn((1, GDINO_S, h, d), generator=gen).to(dev)
    inputs = {}
    for lq in (GDINO_S, 900):
        loc = (torch.rand((1, lq, h, n_lvl, p, 2), generator=gen) * 1.2 - 0.1).to(dev)
        w = torch.softmax(torch.randn((1, lq, h, n_lvl * p), generator=gen), -1).reshape(1, lq, h, n_lvl, p)
        inputs[lq] = (loc, w.to(dev))
    return value, inputs


def phase_deform_kernel(torch, dev, iters: int = 20):
    """K3 against its plain version at GroundingDINO's two launch shapes at
    800x800 (the encoder's Lq = 13294 and the decoder's 900 queries; levels
    100x100 to 13x13, H = 8, D = 32, P = 4, locations drawn uniformly in
    [-0.1, 1.1]), in f32 and bf16, with max error, the call's time and the
    kernel's device time, bound and the time of the grid_sample composition.
    Returns {(dtype, Lq): dict}."""
    from threedod_torch.ops import ms_deform

    d = 32
    results = {}
    value32, inputs = _k3_uniform_inputs(torch, dev)
    with torch.no_grad():
        keys, cases = [], []
        for lq, (loc, w32) in inputs.items():
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                keys.append((dtype_name, lq))
                cases.append((f"{dtype_name} Lq={lq} uniform", value32.to(dtype), GDINO_LEVELS, loc, w32.to(dtype)))
        for key, (_, value, shapes, loc, w), row in zip(keys, cases, _k3_measure(torch, ms_deform, cases, iters)):
            def library():
                return grid_sample_composition(torch, value, shapes, loc, w)

            lib_err = (library().float() - ms_deform.ms_deform_sample_reference(
                value, shapes, loc, w).float()).abs().max().item()
            library_ms = cuda_ms(library, iters)
            out_bytes = loc[..., 0, 0, 0].numel() * d * value.element_size()
            moved = sum(t.numel() * t.element_size() for t in (value, loc, w)) + out_bytes
            print(f"[K3] {key[0]} Lq={key[1]}: grid_sample composition (4 calls) {library_ms:.4f} ms, off by "
                  f"{lib_err:.3e}; {moved / 1e6:.2f} MB moved, {10.0 * w.numel() * d / 1e9:.3f} GFLOP", flush=True)
            results[key] = dict(row, library_ms=library_ms)
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


def capture_k3_inputs(torch, model, images, dev):
    """The (value, spatial shapes, locations, weights) that ``model`` hands K3
    in one ``gdino_infer.predict``, copied at each launch: the 12 launches of
    a GroundingDINO forward (6 encoder layers at Lq = 13294, then 6 decoder
    layers at 900 queries)."""
    from threedod_torch import gdino_infer
    from threedod_torch.ops import ms_deform

    captured, launch = [], ms_deform.ms_deform_sample_cuda

    def keep(value, shapes, locations, weights):
        captured.append((value.clone(), [(int(hl), int(wl)) for hl, wl in shapes], locations.clone(), weights.clone()))
        return launch(value, shapes, locations, weights)

    ms_deform.ms_deform_sample_cuda = keep
    try:
        gdino_infer.predict(model, images, GDINO_PROMPT, dev)
        torch.cuda.synchronize()
    finally:
        ms_deform.ms_deform_sample_cuda = launch
    check(len(captured) == 12, f"captured {len(captured)} K3 launches of one forward, not 12")
    return captured


def phase_deform_model(torch, dev, captured, iters: int = 20):
    """K3 on the inputs the seeded GroundingDINO really hands it in one 800x800
    bf16 forward (``capture_k3_inputs``): each launch in bf16 as captured and
    in f32 (value and weights cast), against its plain version, with the
    kernel's device time, the call's time and the bound. Returns {dtype:
    dict(rows, and kernel_ms, ms, plain_ms, bound_ms summed over the 12)}."""
    from threedod_torch.ops import ms_deform

    results = {}
    with torch.no_grad():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            cases = [(f"{dtype_name} model launch {i} ({'encoder' if loc.shape[1] == GDINO_S else 'decoder'}, "
                      f"Lq={loc.shape[1]})", value.to(dtype), shapes, loc, w.to(dtype))
                     for i, (value, shapes, loc, w) in enumerate(captured)]
            rows = [dict(row, launch=i, lq=c[3].shape[1])
                    for i, (c, row) in enumerate(zip(cases, _k3_measure(torch, ms_deform, cases, iters, 1)))]
            sums = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "ms", "plain_ms", "bound_ms")}
            print(f"[K3] {dtype_name} the model's 12 launches: kernel (device) {sums['kernel_ms']:.4f} ms, call "
                  f"{sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms, largest error "
                  f"{max(r['max_abs_err'] for r in rows):.3e}", flush=True)
            results[dtype_name] = dict(rows=rows, max_abs_err=max(r["max_abs_err"] for r in rows), **sums)
    return results


def k3_report(torch, dev):
    """K3 alone, to compare two trees in one call: build it (registers and
    spills), the uniform inputs of phase 6 and the model's own inputs. Run
    from a tree's root, with this file's functions:
        python3 -c "import runpy, torch; m = runpy.run_path('<this file>');
                    m['k3_report'](torch, torch.device('cuda', 0))"
    Prints one line "[K3-report] {json}": kernel device times by input."""
    from threedod_torch import gdino_infer
    from threedod_torch.ops import _build

    lib, log, seconds = _build.build("ms_deform_sample")
    print(f"[build] {lib.name}: nvcc {seconds:.2f} s", flush=True)
    for line in build_report(log):
        print(f"[build] ms_deform_sample: {line}", flush=True)
    uniform = phase_deform_kernel(torch, dev)
    model = gdino_infer.load_model(dev, seed=0)
    captured = capture_k3_inputs(torch, model, gdino_infer.random_images(1, 800, seed=0), dev)
    del model
    on_model = phase_deform_model(torch, dev, captured)
    report = {f"{d} Lq={lq} uniform": row["kernel_ms"] for (d, lq), row in uniform.items()}
    for d, res in on_model.items():
        report[f"{d} model 12 launches"] = res["kernel_ms"]
        for part, lq in (("encoder", GDINO_S), ("decoder", 900)):
            report[f"{d} model {part} (6)"] = sum(r["kernel_ms"] for r in res["rows"] if r["lq"] == lq)
    print("[K3-report] " + json.dumps(report), flush=True)
    return uniform, on_model


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


# Base_Synth (configs/Base_Synth.yaml): bs8 384x512 canvas, 256 sampled ROIs an
# image in training; an evaluation forward at batch 1 pools 256 proposals
# (box head) and up to 100 detections (cube head)
BASE_SYNTH = "configs/Base_Synth.yaml"
BASE_SYNTH_ROIS = {"training": (8, 256), "eval proposals": (1, 256), "eval detections": (1, 100)}
# run as ``python -c``: train_net with Pillow and PyYAML made unimportable
# before the port loads, so the card's data path is shown to need neither
BLOCKED_TRAIN_NET = ("import sys; sys.modules['PIL'] = None; sys.modules['yaml'] = None; "
                     "sys.modules['matplotlib'] = None; "
                     "from threedod_torch import train_net; train_net.main(sys.argv[1:])")


def jpeg_bound_ms(coef_bytes: int, plane_bytes: int, rgb_bytes: int):
    """Least card time of the IDCT kernel (coefficients in, planes out) and
    of the colour kernel (planes in, RGB out), both bound by bytes."""
    return (coef_bytes + plane_bytes) / PEAK_BYTES * 1e3, (plane_bytes + rgb_bytes) / PEAK_BYTES * 1e3


# the encodings the fixture lacks, written by Pillow from a 61x45 crop of a
# fixture image (partial MCUs at both edges): (name, Pillow's subsampling,
# restart interval in MCUs, mode)
JPEG_ENCODINGS = (("444", 0, 0, "RGB"), ("422_restart", 1, 2, "RGB"), ("420_restart", 2, 3, "RGB"),
                  ("gray", 2, 0, "L"))


def jpeg_encodings(Image, path):
    """[(name, bytes)] of ``JPEG_ENCODINGS`` cut from ``path``; fails if a
    file meant to hold restart markers holds none (a Pillow that ignores
    ``restart_marker_blocks``), or one meant to hold none does."""
    import io

    out = []
    for name, subsampling, restart, mode in JPEG_ENCODINGS:
        with Image.open(path) as im:
            img = im.convert(mode).crop((3, 5, 3 + 61, 5 + 45))
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90, subsampling=subsampling, **({"restart_marker_blocks": restart} if restart
                                                                       else {}))
        data = buf.getvalue()
        check((b"\xff\xd0" in data) == bool(restart), f"Pillow wrote the {name} JPEG with{'out' * bool(restart)} "
                                                       f"restart markers")
        out.append((name, data))
    return out


def _decode_gate(torch, np, jpeg, Image, name, data, c, dev, stats):
    """One file through the card's decoder, from its coefficients ``c``: each
    plane of the IDCT kernel and the colour kernel's RGB against their plain
    versions, bit for bit; for a YCbCr or gray file, Y, and Cb and Cr after
    the plain upsampling, against libjpeg's (Pillow's ``draft("YCbCr")``),
    and the RGB against Pillow's, counted into ``stats``. Returns (planes,
    rgb) on the card."""
    import io

    planes = jpeg.planes_cuda(c, dev)
    host = [p.cpu() for p in planes]
    for k, (got, ref) in enumerate(zip(host, jpeg.planes_reference(c))):
        check(torch.equal(got, ref), f"{name}: the IDCT kernel's plane {k} differs from jpeg_idct_islow's plain "
                                     f"version")
    rgb = jpeg.color_cuda(planes, c)
    check(torch.equal(rgb.cpu(), jpeg.color_reference(host, c)), f"{name}: the colour kernel differs from its plain "
                                                                 f"version")

    def add(what, got, want):
        d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
        n, largest, images = stats.get(what, (0, 0, 0))
        stats[what] = (n + int((d > 0).sum()), max(largest, int(d.max())), images + int((d > 0).any()))

    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
        if c.space == jpeg.GRAYSCALE:
            add("Y vs libjpeg", host[0].numpy(), np.asarray(im))
    if c.space == jpeg.YCBCR:
        with Image.open(io.BytesIO(data)) as im:
            im.draft("YCbCr", im.size)
            ycc = np.asarray(im.convert("YCbCr"))
        h, w = ycc.shape[:2]
        for k, (plane, (hexp, vexp)) in enumerate(zip(("Y", "Cb", "Cr"), jpeg.upsampling(c))):
            add(f"{plane} upsampled vs libjpeg", jpeg.upsample_reference(host[k], hexp, vexp)[:h, :w].numpy(),
                ycc[..., k])
    add("RGB vs Pillow", rgb.cpu().numpy(), want)
    return planes, rgb


def decode_check(torch, dev):
    """The port's JPEG decoder on the card against libjpeg (Pillow), on every
    fixture JPEG (640x480, 4:2:0) and on ``JPEG_ENCODINGS`` (4:4:4, 4:2:2 and
    4:2:0 with restart markers, grayscale, 61x45): per file, the host's
    coefficients, the IDCT and colour kernels against their plain versions
    bit for bit, each plane against libjpeg's and the RGB against Pillow's,
    0 levels everywhere (``_decode_gate``); the fixture through
    ``imread_rgb`` too. Times an image: the host's Huffman decoding, each
    kernel's call (CUDA events) and device time (``torch.profiler``), its
    plain version on the card, and the whole ``imread_rgb`` call.
    Returns the two kernels' rows for the kernels line."""
    import numpy as np

    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import jpeg

    try:
        from PIL import Image
    except ImportError:
        fail("the decode gate compares with Pillow (libjpeg), which is not installed")
    folder = os.path.join(HERE, "datasets", "synth", "images")
    paths = [os.path.join(folder, n) for n in sorted(os.listdir(folder))]
    check(len(paths) == 88, f"expected the fixture's 88 JPEGs, found {len(paths)}")
    stats = {}
    host_s, coef_bytes, plane_bytes, rgb_bytes = 0.0, 0, 0, 0
    for path in paths:
        name = os.path.basename(path)
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        c = jpeg.decode_coefficients(data)
        host_s += time.perf_counter() - t0
        planes, rgb = _decode_gate(torch, np, jpeg, Image, name, data, c, dev, stats)
        got = imread_rgb(path, dev)
        check(got.is_cuda and torch.equal(got, rgb), f"{name}: imread_rgb differs from the decoder's RGB")
        coef_bytes += c.coef.nbytes + c.quant.nbytes
        plane_bytes += sum(p.numel() for p in planes)
        rgb_bytes += rgb.numel()
    for what, (n, largest, images) in stats.items():
        print(f"[jpeg] port {what}: {n} values differ, largest {largest} levels, in {images} of {len(paths)} fixture "
              f"images", flush=True)
        check(n == 0, f"the port's decoder differs from libjpeg: {what}: {n} values, largest {largest} levels")
    for name, data in jpeg_encodings(Image, paths[3]):
        other = {}
        _decode_gate(torch, np, jpeg, Image, name, data, jpeg.decode_coefficients(data), dev, other)
        print(f"[jpeg] port on the {name} 61x45 encoding: " + ", ".join(
            f"{what} {n} values differ (largest {largest})" for what, (n, largest, _) in other.items()), flush=True)
        check(all(n == 0 for n, _, _ in other.values()), f"the port's decoder differs from libjpeg on {name}: {other}")
    # times an image on the last fixture file (all 88 are 640x480 4:2:0)
    with open(paths[-1], "rb") as f:
        c = jpeg.decode_coefficients(f.read())
    planes = jpeg.planes_cuda(c, dev)
    coef_dev = [torch.from_numpy(c.coef).to(dev), torch.from_numpy(c.quant.astype(np.int64)).to(dev)]
    idct_ms = cuda_ms(lambda: jpeg.idct_cuda(c, dev), iters=50)  # the coefficients' copy to the card included
    color_ms = cuda_ms(lambda: jpeg.color_cuda(planes, c), iters=50)
    idct_kernel_ms = device_ms(torch, lambda: jpeg.idct_cuda(c, dev), 20, {"k": "idct_kernel"})["k"]
    color_kernel_ms = device_ms(torch, lambda: jpeg.color_cuda(planes, c), 20, {"k": "color_kernel"})["k"]
    n_blocks = [comp.blocks_w * comp.blocks_h for comp in c.components]

    def plain_idct():
        start = 0
        for k, n in enumerate(n_blocks):
            jpeg.idct_islow_reference(coef_dev[0][start:start + 64 * n].reshape(n, 64), coef_dev[1][k])
            start += 64 * n

    idct_plain = cuda_ms(plain_idct, iters=10)
    color_plain = cuda_ms(lambda: jpeg.color_reference(planes, c), iters=10)
    call_ms = cuda_ms(lambda: imread_rgb(paths[-1], dev), iters=20)
    n = len(paths)
    idct_bound, color_bound = jpeg_bound_ms(coef_bytes / n, plane_bytes / n, rgb_bytes / n)
    print(f"[jpeg] decode of the {n} fixture JPEGs (640x480, 4:2:0) and the {len(JPEG_ENCODINGS)} other encodings "
          f"equal to libjpeg's planes and Pillow's RGB, 0 levels in every file; an image: host Huffman decoding "
          f"{host_s / n * 1e3:.3f} ms; IDCT call {idct_ms:.4f} ms (the coefficients' copy included), kernel (device) "
          f"{idct_kernel_ms:.4f} ms (plain {idct_plain:.4f}, bound {idct_bound:.5f} by bytes); colour call "
          f"{color_ms:.4f} ms, kernel (device) {color_kernel_ms:.4f} ms (plain {color_plain:.4f}, bound "
          f"{color_bound:.5f} by bytes); the whole imread_rgb call {call_ms:.3f} ms", flush=True)
    return {
        "jpeg_idct": dict(max_abs_err=0.0, ms=idct_ms, kernel_ms=idct_kernel_ms, plain_ms=idct_plain,
                          bound_ms=idct_bound, bound_by="bytes", library_ms=None, host_huffman_ms=host_s / n * 1e3,
                          imread_call_ms=call_ms),
        "jpeg_color": dict(max_abs_err=0.0, ms=color_ms, kernel_ms=color_kernel_ms, plain_ms=color_plain,
                           bound_ms=color_bound, bound_by="bytes", library_ms=None),
    }


def base_synth_kernels(torch, dev, tag: str = "base-synth"):
    """K1 and K2 against their plain versions at Base_Synth's shapes (which
    Omni_combined_Synth shares); the lines are printed under ``[tag]``."""
    from threedod_torch.ops import roi_align, roi_align_cuda

    gen = torch.Generator().manual_seed(7)
    names = sorted(roi_align.STRIDES)
    rows = {"roi_align_fwd": [], "roi_align_bwd": []}
    for batch in (8, 1):
        feats32 = _level_feats(torch, roi_align, gen, dev, b=batch, h=384, w=512)
        for label, (b, n) in BASE_SYNTH_ROIS.items():
            if b != batch:
                continue
            boxes = random_boxes(torch, b, n, 384, 512, gen, dev)
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                feats = {k: v.to(dtype) for k, v in feats32.items()}
                with torch.no_grad():
                    out = roi_align_cuda.multilevel_roi_align(feats, boxes)
                    ref = roi_align.multilevel_roi_align(feats, boxes)
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[dtype_name] * (ref.float().abs().max().item() if dtype_name == "bfloat16" else 1.0)
                with torch.no_grad():
                    ms = cuda_ms(lambda: roi_align_cuda.multilevel_roi_align(feats, boxes), iters=20)
                    plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align(feats, boxes), iters=3)
                bound, by = roi_align_bound_ms(feats, b * n, out.element_size())
                print(f"[{tag}] K1 {dtype_name} {label} {b} x {n} ROIs, 384x512 levels: max_abs_err={err:.3e} "
                      f"(tol {tol:.3e}), call {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})",
                      flush=True)
                check(err <= tol, f"K1 {dtype_name} at {tag}'s {label} shape disagrees: {err} > {tol}")
                rows["roi_align_fwd"].append(dict(shape=f"{dtype_name} {label} {b}x{n}", max_abs_err=err, ms=ms,
                                                  plain_ms=plain_ms, bound_ms=bound, bound_by=by))
                if label != "training":
                    continue
                grad = torch.randn((b, n, 7, 7, 256), generator=gen).to(dev)
                level = roi_align.assign_levels(boxes.reshape(-1, 4), names).reshape(b, n)
                shapes = [tuple(feats32[nm].shape[2:]) for nm in names]
                scales = [1.0 / roi_align.STRIDES[nm] for nm in names]
                level32 = level.to(torch.int32).contiguous()

                def kernel():
                    return roi_align_cuda.roi_align_backward_cuda(grad, boxes, level32, names, shapes, 2, dtype)

                def plain():
                    return roi_align.roi_align_backward(grad, boxes, level, shapes, scales, 2, dtype)

                got, want = kernel(), plain()
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                tol = TOL_BWD[dtype_name] * max(w.float().abs().max().item() for w in want)
                ms, plain_ms = cuda_ms(kernel, iters=10), cuda_ms(plain, iters=2, warmup=1)
                bound, by = roi_align_bound_ms(feats, b * n, grad.element_size())
                print(f"[{tag}] K2 {dtype_name} {b} x {n} ROIs, 384x512 levels: max_abs_err={err:.3e} "
                      f"(tol {tol:.3e}), call {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})",
                      flush=True)
                check(err <= tol, f"K2 {dtype_name} at {tag}'s training shape disagrees: {err} > {tol}")
                rows["roi_align_bwd"].append(dict(shape=f"{dtype_name} training {b}x{n}", max_abs_err=err, ms=ms,
                                                  plain_ms=plain_ms, bound_ms=bound, bound_by=by))
    return rows


def train_net_blocked(args, timeout: int = 600) -> dict:
    """``python -m threedod_torch.train_net ARGS`` with Pillow and PyYAML
    blocked; its last line's object, with the logged windows' medians (the
    lines before it) under ``windows``."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_TRAIN_NET, *args], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        fail(f"train_net {' '.join(args)} exited with {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) >= 2, f"train_net printed {len(lines)} lines")
    objects = [json.loads(line) for line in lines]  # one JSON object a line
    return dict(objects[-1], windows=objects[:-1])


def loader_report(torch, dev):
    """What the JPEG decoder costs the training paths, to compare two trees
    in one call: ``imread_rgb`` over the 88 fixture JPEGs (ms an image, CUDA
    events, the first call of each file), then ``train_net``'s first 30
    iterations of Base_Synth and of Omni_combined_Synth (ms an iteration
    after 10, loader share, the run's seconds). Copy this file into each
    tree's root and run it there:
        python3 -c "import runpy, torch; m = runpy.run_path('chip_smoke.py');
                    m['loader_report'](torch, torch.device('cuda', 0))"
    Prints "[loader]" lines."""
    import tempfile

    from threedod_torch.data.image_io import imread_rgb

    sys.path.insert(0, HERE)
    folder = os.path.join(HERE, "datasets", "synth", "images")
    paths = [os.path.join(folder, n) for n in sorted(os.listdir(folder))]
    imread_rgb(paths[0], dev)  # builds and loads the decoder
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for path in paths:
        imread_rgb(path, dev)
    end.record()
    end.synchronize()
    print(f"[loader] {HERE}: imread_rgb {start.elapsed_time(end) / len(paths):.3f} ms an image over the "
          f"{len(paths)} fixture JPEGs", flush=True)
    for config in (BASE_SYNTH, WEAK_SYNTH):
        out = tempfile.mkdtemp(prefix="loader_", dir=os.path.join(HERE, "build"))
        run = train_net_blocked(["--config-file", config, "solver.max_iter", "30", "solver.checkpoint_period", "30",
                                 "output_dir", out])
        print(f"[loader] {HERE}: {run['device']}: train_net {config} iterations 0..29: "
              f"{run['ms_per_iteration']:.3f} ms an iteration ({run['steps_timed']} after 10), loader "
              f"{100 * run['loader_share']:.2f} %, {run['seconds']:.2f} s", flush=True)


def phase_base_synth(torch, dev):
    """Base_Synth from the fixture to AP on the card (its images decoded by
    the card's decoder, checked in phase 17): K1 and K2 at its shapes, 30 + 30 iterations through ``train_net`` (the second resumed
    from the first's checkpoint) with Pillow and PyYAML blocked, evaluation on
    synth_test, and the zoo loader through ``--eval-only``."""
    import tempfile

    from threedod_torch import train_net
    from threedod_torch.infer import predict
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.model_zoo import load_model_weights

    t0 = time.perf_counter()
    rows = base_synth_kernels(torch, dev)
    out = tempfile.mkdtemp(prefix="base_synth_", dir=os.path.join(HERE, "build"))
    runs = []
    for resume, max_iter in ((False, 30), (True, 60)):
        args = ["--config-file", BASE_SYNTH] + (["--resume"] if resume else []) + [
            "solver.max_iter", str(max_iter), "solver.checkpoint_period", "30", "output_dir", out]
        run = train_net_blocked(args)
        runs.append(run)
        steps = run["iterations"] - run["first_iteration"]
        print(f"[base-synth] {run['device']}: train_net{' --resume' if resume else ''} iterations "
              f"{run['first_iteration']}..{run['iterations'] - 1}, bs8 384x512 bf16: {run['ms_per_iteration']:.3f} ms "
              f"an iteration ({run['steps_timed']} after 10), loader {100 * run['loader_share']:.2f} %, peak memory "
              f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB, skipped {run['skipped']}; K1 {run['k1_launches_training']} "
              f"and K2 {run['k2_launches_training']} launches in training, K1 {run['k1_launches_eval']} in "
              f"evaluating 20 images ({run['eval_seconds']:.2f} s)", flush=True)
        check(run["steps"] == 30 and run["skipped"] == 0 and run["attempts"] == 1, f"steps skipped or retried: {run}")
        check(run["nonfinite_losses"] == 0, f"{run['nonfinite_losses']} losses are not finite")
        check(run["k1_launches_training"] == steps and run["k2_launches_training"] == steps,
              f"expected one K1 and one K2 launch a step, got {run['k1_launches_training']} and "
              f"{run['k2_launches_training']} in {steps} steps")
        check(run["k1_launches_eval"] == 40, f"expected 2 K1 launches an evaluation forward, got {run['k1_launches_eval']}")
        check(os.path.exists(os.path.join(out, "model_final.pt")), "no checkpoint was written")
    first, second = runs
    check(second["first_iteration"] == 30 and second["iterations"] == 60,
          "the resumed run did not continue at iteration 30 to 60")
    head, tail = first["loss_first_mean"], second["loss_last_mean"]
    check(tail < head, f"the loss did not fall: mean of iterations 0..9 {head}, of 50..59 {tail}")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)["synth_test"]
    check(all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")), f"results.json: {res}")
    print(f"[base-synth] total loss, mean of the first 10 iterations {head:.4f}, of the last 10 "
          f"{tail:.4f}; synth_test after 60: AP2D {res['AP2D']:.4f} AP3D {res['AP3D']:.4f}", flush=True)

    # the zoo loader: a seeded state dict as a detectron2 checkpoint, through --eval-only
    zoo_dir = tempfile.mkdtemp(prefix="zoo_", dir=os.path.join(HERE, "build"))
    cfg, meta, priors = train_net.setup(BASE_SYNTH, ["output_dir", zoo_dir])
    sd = build_model(cfg, seed=5, priors=priors).state_dict()
    wrapped = {"model": dict(sd), "iteration": 0}
    for key in sd:
        if key.endswith("running_var"):
            wrapped["model"][key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    path = os.path.join(zoo_dir, "zoo_model.pth")
    torch.save(wrapped, path)
    only = train_net.run(train_net.parser().parse_args(
        ["--config-file", BASE_SYNTH, "--eval-only", "model.weights", path, "output_dir", zoo_dir]), dev)
    direct = build_model(cfg, seed=0)
    direct.load_state_dict(sd, strict=True)
    direct = direct.to(dev)
    direct_res = train_net.do_test(cfg, direct, meta, dev)
    check(only["results"] == direct_res, "the --eval-only zoo load and the direct load evaluate differently")
    from threedod_torch.data.build import TestLoader, get_dataset_dicts

    batch, _ = next(iter(TestLoader(get_dataset_dicts(["synth_test"]), cfg, device=dev)))
    zoo = load_model_weights(path, build_model(cfg, seed=0)).to(dev)
    a, b = predict(zoo, batch), predict(direct, batch)
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "the zoo load's detections differ from the direct load's")
    print(f"[base-synth] zoo-layout dict ({{'model': ...}}, num_batches_tracked) through --eval-only: AP2D "
          f"{only['results']['synth_test']['AP2D']:.4f} AP3D {only['results']['synth_test']['AP3D']:.4f}, equal to "
          f"the direct load's; {int(a.valid.sum())} detections on the first test image, bit-equal", flush=True)
    print(f"[base-synth] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, runs, os.path.join(out, "model_final.pt")


WEAK_SYNTH = "configs/Omni_combined_Synth.yaml"
# the full weak menu: Omni_combined_Synth's seven losses and ``segmentation``
MENU8 = "[dims, pose_alignment, pose_ground, iou, z, z_pseudo_gt_patch, depth, segmentation]"
WEAK_MENU_KEYS = {"Cube/loss_dims_w", "Cube/loss_dims_h", "Cube/loss_dims_l", "Cube/loss_pose", "Cube/loss_normal_vec",
                  "Cube/loss_iou", "Cube/loss_z", "Cube/loss_pseudo_gt_z", "Cube/loss_depth"}
# the training images whose maps the RANSAC and step checks read (8 of the 60)
WEAK_MAP_IDS = (1, 7, 13, 22, 35, 41, 48, 60)


def fixture_maps(torch, ids, dev):
    """(depth (B, 384, 512) f32, ground (B, 384, 512) f32, K at that size (B,
    3, 3)) of fixture images, resized as the mapper resizes them at the test
    scale, on ``dev``."""
    import numpy as np

    from threedod_torch.data.resize import resize_nearest

    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_train.json")) as f:
        Ks = {im["id"]: im["K"] for im in json.load(f)["images"]}
    depth, ground, K = [], [], []
    for i in ids:
        for kind, key, out in (("depth_maps", "depth", depth), ("ground_maps", "mask", ground)):
            with np.load(os.path.join(HERE, "datasets", kind, f"{i}.npz")) as z:
                out.append(resize_nearest(torch.from_numpy(np.asarray(z[key], np.float32)), 384, 512))
        k = torch.tensor(Ks[i], dtype=torch.float32) * 0.8  # 480x640 -> 384x512
        k[2, 2] = 1.0
        K.append(k)
    return torch.stack(depth).to(dev), torch.stack(ground).to(dev), torch.stack(K).to(dev)


def weak_ransac_check(torch, dev):
    """The ground planes of 8 fixture images on the card against the CPU,
    same hypothesis indices; the card's time for the 8 fits."""
    from threedod_torch.models.boxer import ground_plane_from_depth

    depth, ground, K = fixture_maps(torch, WEAK_MAP_IDS, dev)
    b = len(WEAK_MAP_IDS)
    hw = torch.tensor([[384, 512]] * b, dtype=torch.int32)
    idx = torch.randint(0, 76 * 102, (b, 1000, 3), generator=torch.Generator().manual_seed(3))
    cpu, _, _ = ground_plane_from_depth(idx, depth.cpu(), K.cpu(), ground.cpu(), valid_hw=hw)
    card, _, _ = ground_plane_from_depth(idx.to(dev), depth, K, ground, valid_hw=hw.to(dev))
    err = (card.cpu() - cpu).abs().max().item()
    idx_dev, hw_dev = idx.to(dev), hw.to(dev)
    ms = cuda_ms(lambda: ground_plane_from_depth(idx_dev, depth, K, ground, valid_hw=hw_dev), iters=10)
    print(f"[weak-synth] RANSAC ground planes of {b} fixture images at 384x512 (7752 points, 1000 hypotheses "
          f"each): card vs CPU normals max_abs_err={err:.3e} (tol 1e-5); {ms:.4f} ms for the {b} fits on the card; "
          f"normals {[[round(v, 4) for v in n] for n in card.cpu().tolist()[:3]]} ...", flush=True)
    check(err <= 1e-5, f"RANSAC ground normals differ card vs CPU: {err}")
    return dict(max_abs_err=err, ms=ms)


def weak_step_card_vs_cpu(torch, dev, segmentation: bool = False):
    """One f32 weak training forward and backward at batch 2, 384x512, card
    against CPU: same weights, batch (the fixture's depth and ground maps,
    box-filled masks), sampling noise and RANSAC hypotheses; both
    subsamplers have room for every candidate. With ``segmentation`` the
    menu has its eighth loss and the masks are the ellipses inside the
    boxes, as SAM's would be (lines under ``[seg]``)."""
    import numpy as np

    from threedod_torch.config_yaml import load_config
    from threedod_torch.data.batch import synthetic_train_batch
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.ops.matcher import gumbel_noise

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs = 2
    tag = "seg" if segmentation else "weak-synth"
    cfg = load_config(WEAK_SYNTH, ["model.dtype", "float32", "model.roi_heads.num_classes", "10",
                                   "solver.ims_per_batch", str(bs)] + (["loss_functions", MENU8] if segmentation else []))
    h, w = cfg.shapes.canvas_height, cfg.shapes.canvas_width
    n_anchors = sum(-(-h // s) * -(-w // s) * 3 for s in (4, 8, 16, 32, 64))
    n_cand = cfg.model.rpn.post_nms_topk_train + cfg.shapes.max_gt
    cfg.model.rpn.batch_size_per_image, cfg.shapes.roi_batch = n_anchors, n_cand
    cpu_model = build_model(cfg, seed=1).train()
    with torch.no_grad():  # lift the regressors off zero, where an L1 residual's sign is noise
        for name, p in cpu_model.roi_heads.named_parameters():
            if name.endswith("weight") and ("bbox_pred" in name or "bbox_3D" in name):
                p.mul_(30.0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = synthetic_train_batch(cfg, bs, seed=5)
    depth, ground, _ = fixture_maps(torch, WEAK_MAP_IDS[:bs], "cpu")
    boxes = batch.gt.boxes2d.numpy() / 4.0
    ys, xs = np.arange(h // 4)[None, None, :, None], np.arange(w // 4)[None, None, None, :]
    if segmentation:  # the ellipse inside each box
        centre, half = (boxes[..., :2] + boxes[..., 2:]) / 2, np.maximum((boxes[..., 2:] - boxes[..., :2]) / 2, 1e-3)
        masks = (((xs + 0.5 - centre[..., 0, None, None]) / half[..., 0, None, None]) ** 2
                 + ((ys + 0.5 - centre[..., 1, None, None]) / half[..., 1, None, None]) ** 2 <= 1)
    else:
        masks = ((ys >= boxes[..., 1, None, None]) & (ys < boxes[..., 3, None, None])
                 & (xs >= boxes[..., 0, None, None]) & (xs < boxes[..., 2, None, None]))
    batch = batch._replace(gt=batch.gt._replace(masks=torch.from_numpy(masks.astype(np.uint8))),
                           depth_map=depth.half(), ground_map=ground.to(torch.uint8))
    gen = torch.Generator().manual_seed(2)
    noise = {"rpn": tuple(gumbel_noise(gen, (bs, n_anchors), "cpu") for _ in range(2)),
             "roi": tuple(gumbel_noise(gen, (bs, n_cand), "cpu") for _ in range(2)),
             "ransac": torch.randint(0, 76 * 102, (bs, 1000, 3), generator=gen)}
    leaves = ["backbone.bottom_up.base_layer.0.weight", "proposal_generator.rpn_head.conv.weight",
              "roi_heads.cube_head.bbox_3D_center_depth.weight", "roi_heads.cube_head.bbox_3D_dims.weight",
              "roi_heads.cube_head.bbox_3D_pose.weight", "roi_heads.cube_head.bbox_3D_uncertainty.weight"]
    on = lambda device: {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))  # noqa: E731
                         for k, v in noise.items()}
    # the weak losses read nothing back to the host: after a forward that
    # copies their constant tables to the card once, a call inside them that
    # waits for the card raises
    with torch.no_grad():
        gpu_model(batch.to(dev), on(dev))
    inner = gpu_model.roi_heads.weak_cube_losses
    card_inputs = []

    def strict(*args, **kwargs):
        card_inputs[:] = args
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    gpu_model.roi_heads.weak_cube_losses = strict
    out = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
        t0 = time.perf_counter()
        losses, metrics = model(batch.to(device), on(device))
        sum(losses.values()).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        params = dict(model.named_parameters())
        out[name] = ({k: v.item() for k, v in losses.items()}, {k: v.item() for k, v in metrics.items()},
                     {k: params[k].grad.float().cpu() for k in leaves})
        print(f"[{tag}] step card vs CPU: {name} f32 bs{bs} 384x512 forward + backward "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    del gpu_model.roi_heads.weak_cube_losses
    print(f"[{tag}] the weak losses ran on the card with torch.cuda.set_sync_debug_mode('error'): no host sync",
          flush=True)
    (lc, mc, gc), (lg, mg, gg) = out["cpu"], out["gpu"]
    keys = WEAK_MENU_KEYS | ({"Cube/loss_seg"} if segmentation else set())
    check(keys <= set(lc) and set(lc) == set(lg), f"weak loss keys: {sorted(lc)} vs {sorted(lg)}")
    for k in ("roi/num_fg", "roi/num_bg", "rpn/num_pos_anchors"):
        print(f"[{tag}] {k}: cpu {mc[k]:.1f} gpu {mg[k]:.1f} (tol 2)", flush=True)
        check(abs(mc[k] - mg[k]) <= 2, f"{k} differs card vs CPU: {mg[k]} vs {mc[k]}")
    # as phase 10: sums in another order, 2e-3 relative; the weak losses'
    # discrete choices (window indices, the z search's step) see the same
    # inputs to f32 rounding. The segmentation loss is held below
    for k in sorted(lc):
        rel = abs(lc[k] - lg[k]) / max(abs(lc[k]), 1e-6)
        if k == "Cube/loss_seg":
            print(f"[{tag}] loss {k}: cpu {lc[k]:.6f} gpu {lg[k]:.6f} rel {rel:.2e} (whole step: reported only)",
                  flush=True)
            continue
        print(f"[{tag}] loss {k}: cpu {lc[k]:.6f} gpu {lg[k]:.6f} rel {rel:.2e} (tol 2e-3)", flush=True)
        check(math.isfinite(lg[k]) and rel <= 2e-3, f"loss {k} differs card vs CPU: {lg[k]} vs {lc[k]}")
    if segmentation:
        # the clamped corners of cubes near the camera lie on the canvas's
        # edge, where the reference's hull passes keep or snap a collinear
        # point on the last bit of the turn test: a one-ulp change of a
        # projected corner moves this loss by 2e-3 (the whole step above and
        # the CPU's weak losses on the card's cube outputs alike). So the loss
        # is held on the card's own projected corners and masks
        from threedod_torch.geometry.cuboids import backproject, cuboid_verts, project_points
        from threedod_torch.models.weak_heads import segmentation_loss

        cube, prefix, gt_masks = card_inputs[:3]
        with torch.no_grad():
            centers = backproject(cube["Ks_per"], cube["xy"], cube["z"])
            corners = project_points(cube["Ks_per"], cuboid_verts(torch.cat([centers, cube["dims"]], -1),
                                                                   cube["pose"]))[..., :2]
            b, f = prefix.classes.shape
            masks = gt_masks[torch.arange(b, device=dev).repeat_interleave(f), prefix.gt_index.reshape(-1)].float()
            card_rows = segmentation_loss(corners, masks, h, w).cpu()
            cpu_rows = segmentation_loss(corners.cpu(), masks.cpu(), h, w)
        rel = ((card_rows - cpu_rows).abs().max() / cpu_rows.abs().max()).item()
        gen = torch.Generator().manual_seed(0)
        moved = []
        for _ in range(4):  # each corner one ulp up, down or kept
            step = torch.randint(-1, 2, corners.shape, generator=gen)
            c = corners.cpu()
            c = torch.where(step > 0, torch.nextafter(c, c + 1), torch.where(step < 0, torch.nextafter(c, c - 1), c))
            rows = segmentation_loss(c, masks.cpu(), h, w)
            moved.append(((rows - cpu_rows).abs().max() / cpu_rows.abs().max()).item())
        print(f"[{tag}] segmentation_loss on the card's projected corners of {b * f} ROIs: card vs CPU max rel err "
              f"{rel:.2e} (tol 1e-5); on the CPU, corners nudged by one ulp move it by "
              + ", ".join(f"{m:.2e}" for m in moved) + " (reported only)", flush=True)
        check(torch.isfinite(card_rows).all().item() and rel <= 1e-5,
              f"the segmentation loss differs card vs CPU on the same corners: {rel}")
    for k in leaves:
        rel = ((gc[k] - gg[k]).abs().max() / gc[k].abs().max()).item()
        print(f"[{tag}] grad {k}: max rel err {rel:.2e} (tol 1e-1)", flush=True)
        check(rel <= 1e-1, f"gradient {k} differs card vs CPU: {rel}")


def phase_weak_synth(torch, dev):
    """Weak Cube R-CNN (Omni_combined_Synth) on the card: K1 and K2 at its
    shapes, the RANSAC ground planes and one weak step card vs CPU, then
    ``train_net`` for 30 iterations and ``--resume`` for 20 more, each with
    an evaluation of synth_test, in processes without Pillow and PyYAML, and
    ``--eval-only`` of the final checkpoint, which must evaluate as the
    resumed run did."""
    import tempfile

    from threedod_torch import train_net

    t0 = time.perf_counter()
    rows = base_synth_kernels(torch, dev, tag="weak-synth")
    ransac = weak_ransac_check(torch, dev)
    weak_step_card_vs_cpu(torch, dev)
    out = tempfile.mkdtemp(prefix="weak_synth_", dir=os.path.join(HERE, "build"))
    runs = []
    for resume, max_iter in ((False, 30), (True, 50)):  # the resumed run times 10 steps after its 10 warm-up
        args = ["--config-file", WEAK_SYNTH] + (["--resume"] if resume else []) + [
            "solver.max_iter", str(max_iter), "solver.checkpoint_period", "30", "output_dir", out]
        run = train_net_blocked(args)
        runs.append(run)
        steps = run["iterations"] - run["first_iteration"]
        print(f"[weak-synth] {run['device']}: train_net{' --resume' if resume else ''} Omni_combined_Synth iterations "
              f"{run['first_iteration']}..{run['iterations'] - 1}, bs8 384x512 bf16: {run['ms_per_iteration']:.3f} ms "
              f"an iteration ({run['steps_timed']} after 10), loader {100 * run['loader_share']:.2f} %, peak memory "
              f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB, skipped {run['skipped']}; K1 {run['k1_launches_training']} "
              f"and K2 {run['k2_launches_training']} launches in training, K1 {run['k1_launches_eval']} in evaluating "
              f"20 images ({run['eval_seconds']:.2f} s)", flush=True)
        check(run["steps"] == max_iter - 30 * resume and run["skipped"] == 0 and run["attempts"] == 1,
              f"steps skipped or retried: {run}")
        check(run["nonfinite_losses"] == 0, f"{run['nonfinite_losses']} losses are not finite")
        for window in run["windows"]:
            missing = WEAK_MENU_KEYS - set(window)
            check(not missing, f"window at iteration {window['iteration']} lacks {sorted(missing)}")
            check(all(math.isfinite(window[k]) for k in WEAK_MENU_KEYS), f"a weak loss is not finite: {window}")
        check(run["k1_launches_training"] == steps and run["k2_launches_training"] == steps,
              f"expected one K1 and one K2 launch a step, got {run['k1_launches_training']} and "
              f"{run['k2_launches_training']} in {steps} steps")
        check(run["k1_launches_eval"] == 40, f"expected 2 K1 launches an evaluation forward, got {run['k1_launches_eval']}")
        check(all(math.isfinite(run["results"]["synth_test"][k]) for k in ("AP2D", "AP3D")),
              f"results: {run['results']}")
    first, resumed = runs
    check(resumed["first_iteration"] == 30 and resumed["iterations"] == 50,
          "the resumed run did not continue at iteration 30 to 50")
    head, tail = first["loss_first_mean"], first["loss_last_mean"]
    check(tail < head, f"the loss did not fall: mean of the first 10 iterations {head}, of the last 10 {tail}")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)["synth_test"]

    def same(a, b):  # equal results, a category's NaN AP included
        return json.dumps(a, sort_keys=True, default=float) == json.dumps(b, sort_keys=True, default=float)

    check(same(res, resumed["results"]["synth_test"]), "results.json is not the resumed run's evaluation")
    only = train_net.run(train_net.parser().parse_args(["--config-file", WEAK_SYNTH, "--eval-only", "output_dir", out]),
                         dev)
    check(same(only["results"], resumed["results"]), "--eval-only of the final checkpoint evaluates differently from the "
          f"resumed run: {only['results']['synth_test']} vs {res}")
    last = first["windows"][-1]
    print(f"[weak-synth] total loss, mean of the first 10 iterations {head:.4f}, of the last 10 {tail:.4f}; "
          f"last window's medians: " + ", ".join(f"{k} {last[k]:.4g}" for k in sorted(WEAK_MENU_KEYS)), flush=True)
    print(f"[weak-synth] synth_test after 50: AP2D {res['AP2D']:.4f} AP3D {res['AP3D']:.4f}; --eval-only of the "
          f"final checkpoint evaluates equally", flush=True)
    print(f"[weak-synth] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, runs, ransac


BOXNET_SYNTH = "configs/BoxNet_Synth.yaml"
# run as ``python -c``: eval_boxes with Pillow and PyYAML made unimportable, as train_net is
BLOCKED_EVAL_BOXES = ("import sys; sys.modules['PIL'] = None; sys.modules['yaml'] = None; "
                      "sys.modules['matplotlib'] = None; "
                      "from threedod_torch import eval_boxes; eval_boxes.main(sys.argv[1:])")
# card vs CPU on propose_and_score's scores: the CPU scores the card's cubes,
# projected corners and points, and every entry of every score lies within
# TOL_BOXER of the card's (relative to the score's largest value, or 1). The
# whole call on the CPU is compared too, and only reported: projected
# corners an ulp apart there can make the reference's hull passes keep an
# interior point on one device only (geometry/hull.py), which moves a
# segmentation score by up to 0.55 on about 0.1 % of the entries
TOL_BOXER = 1e-4
PSEUDO_NAME = "pseudo_synth_train"


def eval_boxes_blocked(args, timeout: int = 600) -> dict:
    """``python -m threedod_torch.eval_boxes ARGS`` with Pillow and PyYAML
    blocked; its line's object."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_EVAL_BOXES, *args], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        fail(f"eval_boxes {' '.join(args)} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def boxer_card_vs_cpu(torch, dev, card):
    """``propose_and_score`` on the first fixture training image at
    BoxNet_Synth's shapes (16 ground-truth slots, 1000 proposals each,
    384x512), the same variates on the card and on the CPU, the card's call
    under ``torch.cuda.set_sync_debug_mode("error")``: the ground plane and
    the proposals card vs CPU, every score and IoU3D of the card's call
    against the CPU's from the card's cubes, corners and points; then the
    card's time for the call and for each of its stages."""
    import tempfile

    from threedod_torch import train_net
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.geometry.iou3d import iou3d_pairs
    from threedod_torch.models.boxer import BoxerDraws, ground_plane_from_depth, propose_and_score, score_proposals
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.proposals.proposals import draw_standard, propose_batch
    from threedod_torch.scoring import scorefunction as sf
    from threedod_torch.structures.cubes import Cubes, corners_to_boxes

    out = tempfile.mkdtemp(prefix="boxer_", dir=os.path.join(HERE, "build"))
    cfg, _, priors = train_net.setup(BOXNET_SYNTH, ["output_dir", out])
    model = build_model(cfg, priors=priors).to(dev)
    batch, _ = next(iter(TestLoader(get_dataset_dicts(["synth_train"])[:1], cfg, device=dev, load_maps=True)))
    kw, _, _, valid = model.score_inputs(batch)
    b, n = kw["boxes"].shape[:2]
    p = kw["number_of_proposals"]
    gen = torch.Generator().manual_seed(4)
    n_points = (384 // 5) * (512 // 5)
    draws = BoxerDraws(torch.randint(0, n_points, (b, 1000, 3), generator=gen),
                       draw_standard("propose", b, n, p, gen, with_normal=True), torch.rand((b, n, p), generator=gen))
    on = lambda d, device: BoxerDraws(d.ransac.to(device), {k: v.to(device) for k, v in d.proposals.items()},  # noqa: E731
                                      d.random.to(device))
    cpu_kw = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()}
    t0 = time.perf_counter()
    ref = propose_and_score(draws, "propose", **cpu_kw)
    cpu_s = time.perf_counter() - t0
    card_draws = on(draws, dev)
    propose_and_score(card_draws, "propose", **kw)  # the constant tables reach the card once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = propose_and_score(card_draws, "propose", **kw)
        drawn = propose_and_score(torch.Generator(device=dev).manual_seed(1), "propose", **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[boxnet-synth] propose_and_score ran on the card with torch.cuda.set_sync_debug_mode('error') (given "
          f"variates and a card generator): no host sync; {int(valid.sum())} of {n} slots hold a box", flush=True)
    v = valid.cpu()
    rel_tol = lambda r: TOL_BOXER * max(1.0, r.abs().max().item())  # noqa: E731
    for name in ref.scores:  # the whole call on each device: reported, not checked
        r, g = ref.scores[name][v], got.scores[name].cpu()[v]
        share = ((g - r).abs() <= rel_tol(r)).float().mean().item()
        print(f"[boxnet-synth] whole call card vs CPU {name}: max_abs_err={(g - r).abs().max().item():.3e}, "
              f"{100 * share:.3f} % within {rel_tol(r):.1e} (reported only)", flush=True)

    # the card's stages, which its whole call repeats exactly
    normal, points, pc_valid = ground_plane_from_depth(card_draws.ransac, kw["depth_maps"], kw["K_scaled"],
                                                       kw["ground_maps"], valid_hw=kw["valid_hw"])
    prop_args = (card_draws.proposals, "propose", kw["boxes"], kw["depth_maps"], kw["prior_means"], kw["prior_stds"],
                 kw["im_shape"], kw["K_scaled"], p)
    cubes = propose_batch(*prop_args, ground_normal=normal)
    bube = cubes.get_bube_corners(kw["K_scaled"][:, None, None], clamp=kw["im_shape"])
    check(torch.equal(normal, got.normal) and torch.equal(cubes.tensor, got.cubes.tensor),
          "the card's ground plane or proposals differ between its stages and its whole call")
    normal_err = (got.normal.cpu() - ref.normal).abs().max().item()
    cube_err = ((got.cubes.tensor.cpu() - ref.cubes.tensor)[v].abs() / ref.cubes.tensor[v].abs().clamp(min=1.0)).max().item()
    print(f"[boxnet-synth] card vs CPU on the same variates: ground normal max_abs_err={normal_err:.3e} (tol 1e-5), "
          f"proposals max_rel_err={cube_err:.3e} (tol 1e-3, relative to max(1, |x|)); CPU {cpu_s:.2f} s", flush=True)
    check(normal_err <= 1e-5 and cube_err <= 1e-3, "the ground plane or the proposals differ card vs CPU")

    # every score and IoU3D: the CPU scores the card's cubes, corners and points
    cpu = lambda t: t.cpu()  # noqa: E731
    want, _ = score_proposals(Cubes(cpu(cubes.tensor)), cpu(bube), cpu_kw["boxes"], cpu_kw["masks"], cpu(points),
                              cpu(pc_valid), cpu_kw["prior_means"], cpu_kw["prior_stds"], draws.random)
    gt = Cubes(kw["gt_cubes"]).get_all_corners()[:, :, None].expand(b, n, p, 8, 3).reshape(-1, 8, 3)
    corners = cubes.get_all_corners().reshape(-1, 8, 3)
    want["IoU3D"] = iou3d_pairs(cpu(gt), cpu(corners))[1].reshape(b, n, p)
    errs = {}
    for name, w in want.items():
        r, g = w[v], (got.iou3d if name == "IoU3D" else got.scores[name]).cpu()[v]
        check(bool(torch.isfinite(g).all()), f"score {name} is not finite on the card")
        tol = rel_tol(r)
        off = int(((g - r).abs() > tol).sum())
        errs[name] = (g - r).abs().max().item()
        print(f"[boxnet-synth] card vs CPU on the card's cubes, corners and points, {name}: "
              f"max_abs_err={errs[name]:.3e} (tol {tol:.1e}), {off} of {r.numel()} entries outside", flush=True)
        check(off == 0, f"score {name} differs card vs CPU on {off} entries")
    top2 = torch.sort(want["combined"][v], dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL_BOXER * top2[:, 1].abs()
    best = torch.argmax(want["combined"], dim=-1)[v][clear]
    best_err = (got.best_cubes.cpu()[v][clear] - cpu(cubes.tensor)[v][clear, best]).abs().max().item() \
        if clear.any() else 0.0
    print(f"[boxnet-synth] card vs CPU: best cubes of the {int(clear.sum())} boxes with a clear best "
          f"max_abs_err={best_err:.3e} (tol 0)", flush=True)
    check(best_err == 0.0, "the card's best cubes are not the CPU's best")
    check(bool(torch.isfinite(drawn.best_cubes[valid]).all()), "the card generator's best cubes are not finite")

    # the card's time for the call and for each stage, at these inputs
    prop_boxes = corners_to_boxes(bube)
    stages = {
        "ground plane": lambda: ground_plane_from_depth(card_draws.ransac, kw["depth_maps"], kw["K_scaled"],
                                                        kw["ground_maps"], valid_hw=kw["valid_hw"]),
        "proposals": lambda: propose_batch(*prop_args, ground_normal=normal),
        "projection": lambda: corners_to_boxes(cubes.get_bube_corners(kw["K_scaled"][:, None, None],
                                                                      clamp=kw["im_shape"])),
        "IoU2D": lambda: sf.score_iou(kw["boxes"], prop_boxes),
        "point_cloud": lambda: sf.score_point_cloud(points, cubes, pc_valid),
        "seg+seg_mod": lambda: sf.score_segmentation_pair(kw["masks"], bube),
        "corner": lambda: sf.score_corners(kw["masks"], bube),
        "dim": lambda: sf.score_dimensions(kw["prior_means"], kw["prior_stds"], cubes.dimensions, kw["boxes"],
                                           prop_boxes),
        "IoU3D": lambda: iou3d_pairs(gt, corners),
        "whole call": lambda: propose_and_score(card_draws, "propose", **kw),
    }
    with torch.inference_mode():
        ms = {k: cuda_ms(fn, iters=5) for k, fn in stages.items()}
    parts = {k: v for k, v in ms.items() if k != "whole call"}
    slowest = max((k for k in parts if k not in ("ground plane", "proposals", "projection")), key=parts.get)
    print(f"[boxnet-synth] {card}: propose_and_score at {n} slots x {p} proposals, 384x512, f32: "
          f"{ms['whole call']:.3f} ms an image; stages " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f" (sum {sum(parts.values()):.3f} ms); slowest score: {slowest}", flush=True)
    return dict(ms=ms, errs=errs, slowest=slowest)


def phase_boxnet_synth(torch, dev):
    """BoxNet (BoxNet_Synth) on the card: propose_and_score card vs CPU and
    its stages' times, ``eval_boxes`` MABO
    and AP PRED over synth_test, pseudo ground truth for synth_train in a
    datasets root under ``build/`` that links the fixture, and Base_Synth
    trained on it for 30 iterations with ``train_net``; the entries run in
    processes without Pillow and PyYAML. K1 and K2 run here at Base_Synth's
    shapes (1 x 256 ROIs of a PRED forward, 8 x 256 of a training step), which
    ``phase_base_synth`` holds against their plain versions."""
    import tempfile

    from threedod_torch.train_net import card_name_and_power_limit

    t0 = time.perf_counter()
    card = card_name_and_power_limit(dev)
    boxer = boxer_card_vs_cpu(torch, dev, card)
    root = tempfile.mkdtemp(prefix="boxnet_synth_", dir=os.path.join(HERE, "build"))
    os.makedirs(os.path.join(root, "Omni3D"))
    for name in ("synth_train", "synth_test"):
        os.symlink(os.path.join(HERE, "datasets", "Omni3D", f"{name}.json"), os.path.join(root, "Omni3D", f"{name}.json"))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(os.path.join(HERE, "datasets", name), os.path.join(root, name))
    fixture_before = sorted(os.listdir(os.path.join(HERE, "datasets", "Omni3D")))
    common = ["datasets.root", root, "output_dir", os.path.join(root, "eval")]

    runs = {}
    for label, opts in (("MABO GT", ["plot.eval", "MABO", "plot.mode2d", "GT"]),
                        ("AP PRED", ["plot.eval", "AP", "plot.mode2d", "PRED"])):
        run = eval_boxes_blocked(["--config-file", BOXNET_SYNTH] + opts + common)
        runs[label] = run
        check(run["images"] == 20, f"{label} evaluated {run['images']} images")
        want_k1 = 20 if label == "AP PRED" else 0
        check(run["k1_launches"] == want_k1, f"{label}: {run['k1_launches']} K1 launches, expected {want_k1} "
                                             "(one a PRED forward, none in GT mode)")
        res = run["results"]
        if label == "MABO GT":
            finite = all(math.isfinite(x) for k, x in res.items() if k != "combinations_mean")
            check(finite and all(math.isfinite(x) for x in res["combinations_mean"]), f"MABO: {res}")
            summary = (f"MABO_combined {res['MABO_combined']:.4f}, ABO_best_possible_combined "
                       f"{res['ABO_best_possible_combined']:.4f}, MABO_random {res['MABO_random']:.4f}")
        else:
            ap = res["synth_test"]
            check(all(math.isfinite(ap[k]) for k in ("AP2D", "AP3D")), f"AP: {ap}")
            summary = f"AP2D {ap['AP2D']:.4f}, AP3D {ap['AP3D']:.4f}"
        print(f"[boxnet-synth] {run['device']}: eval_boxes {label} ({run['proposal_function']}) over synth_test: "
              f"{run['seconds']:.3f} s for {run['images']} images, K1 {run['k1_launches']} launches; {summary}",
              flush=True)

    pseudo = eval_boxes_blocked(["--config-file", BOXNET_SYNTH, "--pseudo-gt-out", PSEUDO_NAME, "train.pseudo_gt",
                                 "pseudo"] + common)
    path = os.path.join(root, "Omni3D", f"{PSEUDO_NAME}.json")
    check(pseudo["pseudo_gt"] == path and os.path.exists(path), f"pseudo ground truth not at {path}: {pseudo}")
    check(pseudo["images"] == 60 and pseudo["annotations"] > 0, f"pseudo ground truth: {pseudo}")
    check(sorted(os.listdir(os.path.join(HERE, "datasets", "Omni3D"))) == fixture_before,
          "eval_boxes wrote into datasets/")
    print(f"[boxnet-synth] {pseudo['device']}: eval_boxes train.pseudo_gt pseudo over synth_train: "
          f"{pseudo['seconds']:.3f} s for {pseudo['images']} images, {pseudo['annotations']} annotations", flush=True)

    train = train_net_blocked(["--config-file", BASE_SYNTH, "datasets.root", root, "datasets.train", f"[{PSEUDO_NAME}]",
                               "solver.max_iter", "30", "solver.checkpoint_period", "30",
                               "output_dir", os.path.join(root, "train")])
    steps = train["iterations"] - train["first_iteration"]
    print(f"[boxnet-synth] {train['device']}: train_net Base_Synth on {PSEUDO_NAME} iterations "
          f"{train['first_iteration']}..{train['iterations'] - 1}, bs8 384x512 bf16: {train['ms_per_iteration']:.3f} ms "
          f"an iteration ({train['steps_timed']} after 10), loader {100 * train['loader_share']:.2f} %, peak memory "
          f"{train['peak_memory_bytes'] / 2 ** 30:.3f} GiB, skipped {train['skipped']}; K1 "
          f"{train['k1_launches_training']} and K2 {train['k2_launches_training']} launches in training, K1 "
          f"{train['k1_launches_eval']} in evaluating 20 images; total loss, mean of the first 10 iterations "
          f"{train['loss_first_mean']:.4f}, of the last 10 {train['loss_last_mean']:.4f}", flush=True)
    check(train["steps"] == 30 and train["skipped"] == 0 and train["attempts"] == 1, f"steps skipped or retried: {train}")
    check(train["nonfinite_losses"] == 0, f"{train['nonfinite_losses']} losses are not finite")
    check(train["k1_launches_training"] == steps and train["k2_launches_training"] == steps,
          f"expected one K1 and one K2 launch a step, got {train['k1_launches_training']} and "
          f"{train['k2_launches_training']} in {steps} steps")
    check(train["loss_last_mean"] < train["loss_first_mean"],
          f"the loss did not fall: {train['loss_first_mean']} then {train['loss_last_mean']}")
    print(f"[boxnet-synth] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    k1 = sum(r["k1_launches"] for r in runs.values()) + pseudo["k1_launches"] + train["k1_launches_training"] + \
        train["k1_launches_eval"]
    return dict(boxer=boxer, runs=runs, pseudo=pseudo, train=train, k1=k1, k2=train["k2_launches_training"])


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


def phase_gdino_path(torch, dev):
    """The GroundingDINO path at full width through ``threedod_torch.
    gdino_infer``: Swin-T, BERT-base, 6 + 6 layers, 900 queries, one 800x800
    image, bf16, seeded weights, the prompt "ground.". Logits (1, 900, 4),
    boxes inside [0, 1], finite values, 12 K3 launches a forward, ms per
    forward (CUDA events over 5 forwards after 1 warm-up) and the stages'
    times from one more forward. The warm-up forward keeps K3's 12 inputs,
    on which K3 is then timed and checked (``phase_deform_model``): the
    share of K3 in a forward is the model's own launches' device time.
    Returns (K3 launches of the timed forwards, ms per forward, K3 on the
    model's inputs)."""
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
    captured = capture_k3_inputs(torch, model, images, dev)  # the warm-up
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
    check(launches == 12 * iters, f"expected {12 * iters} launches of K3 (12 per forward), got {launches}")
    xyxy, score = gmodel.best_box_for_prompt(logits.float(), boxes, torch.tensor([[size, size]], device=dev))
    del model
    k3_model = phase_deform_model(torch, dev, captured)
    k3_ms = k3_model["bfloat16"]["kernel_ms"]
    print(f"[gdino] Swin-T + BERT-base 800x800 bf16 ({GDINO_S} tokens, 900 queries): {ms:.3f} ms/forward "
          f"({iters} forwards after 1 warm-up); stages of one forward: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items())
          + f"; K3 launches in {iters} forwards: {launches}; the model's 12 K3 launches take {k3_ms:.4f} ms of "
          f"device time, {k3_ms / ms:.2%} of a forward; best box {[round(v, 1) for v in xyxy[0].tolist()]} "
          f"score {score[0].item():.4f}; the grid's constants (sine embeddings, centres), built once an image "
          f"size on the host: {grid_ms:.3f} ms", flush=True)
    return launches, ms, k3_model


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


WEAK_ASSET_TOL = dict(logits=1e-3, firm=1e-2)  # card vs CPU SAM: logits to 1e-3 of the largest, masks where |x| > 1e-2


def _sam_card_vs_cpu(torch, dev, hq: bool):
    """A reduced SAM or SAM-HQ in f32 (256 px, width 768, depth 4 with global
    blocks 1 and 3, seeded) on the card and on the CPU, same image and boxes:
    the logits within 1e-3 of the CPU's largest |logit|, the masks (> 0)
    equal wherever the CPU's |logit| > 1e-2. Sums run in other orders
    through 4 blocks and the two-way decoder, TF32 off."""
    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.models import sam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = sam.build_sam(hq=hq, img_size=256, encoder_depth=4, global_attn_indexes=(1, 3),
                              dtype=torch.float32, seed=3)
    with torch.no_grad():  # the seeded tables are zero: give them values, so their paths count
        gen = torch.Generator().manual_seed(4)
        for name, p in cpu_model.named_parameters():
            if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    image = imread_rgb(os.path.join(HERE, "datasets", "synth", "images", "000061.jpg"), torch.device("cpu"))
    boxes = [[110.6, 339.1, 150.8, 366.1], [20.0, 200.0, 400.0, 470.0], [300.0, 40.0, 630.0, 300.0]]
    out = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("card", gpu_model, dev)):
        x, scale = sam.preprocess_sam_image(image.to(device), 256)
        b = torch.tensor([[c * scale for c in box] for box in boxes], dtype=torch.float32, device=device)
        with torch.no_grad():
            out[name] = model.decode_boxes(model.encode_image(x), b).float().cpu()
    ref, got = out["cpu"], out["card"]
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    firm = ref.abs() > WEAK_ASSET_TOL["firm"]
    flips = int(((got > 0) != (ref > 0))[firm].sum())
    print(f"[assets] {'SAM-HQ' if hq else 'SAM'} f32 256 px, width 768, depth 4, card vs CPU: logits max abs err "
          f"{err:.3e} (tol {WEAK_ASSET_TOL['logits'] * scale:.3e}, largest {scale:.3f}); masks differ at {flips} of "
          f"{int(firm.sum())} pixels where the CPU's |logit| > {WEAK_ASSET_TOL['firm']}", flush=True)
    check(err <= WEAK_ASSET_TOL["logits"] * scale, f"SAM (hq={hq}) logits differ card vs CPU: {err} > 1e-3 x {scale}")
    check(flips == 0, f"SAM (hq={hq}) masks differ card vs CPU at {flips} firm pixels")


def phase_weak_assets(torch, dev):
    """Phase 17, the weak-method assets on the card: the JPEG decode gate
    (``decode_check``), then the five asset tools in this process, their
    outputs under a temporary directory (nothing under ``datasets/``):
    object masks by SAM-HQ ViT-B at 1024 in bf16 (a seeded state dict saved
    as a checkpoint) over synth_test, read back by the port's mapper; ground
    masks over synth_val with a seeded GroundingDINO state dict (800x800
    bf16, 12 K3 launches a forward, K3 held against its plain version on the
    inputs the tool's preprocessing gives it; ``--box-threshold 0``, since
    the seeded detector's scores are far below the tool's 0.35, so SAM
    segments every box) and with ``--heuristic``, then
    ``filter_ground``; depth maps by DA-V2 vitl at 518 (random weights); the
    normals from those maps and the ground masks; then SAM and SAM-HQ card vs
    CPU. Times: the SAM ViT-B encoder at 1024 and its decoder a box (CUDA
    events), each tool's seconds over its set. Returns the kernels' launches
    in the tools' runs (each count zeroed just before a tool's run and read
    just after) and the decoder's and K3's rows."""
    import tempfile

    import numpy as np

    from threedod_torch import (filter_ground, gdino_infer, generate_depth_maps, generate_ground_segmentations,
                                generate_normal_vectors, generate_object_masks)
    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.models import sam
    from threedod_torch.ops import jpeg, ms_deform
    from threedod_torch.train_net import card_name_and_power_limit

    t_phase = time.perf_counter()
    card = card_name_and_power_limit(dev)
    jpeg_rows = decode_check(torch, dev)
    launches = dict(jpeg_idct=0, jpeg_color=0, k3=0)

    def tool(module, argv):
        """One tool's ``run`` on the card, its kernels' launches added to
        ``launches`` (the counts are zeroed just before and read just after)."""
        jpeg.LAUNCHES_IDCT = jpeg.LAUNCHES_COLOR = ms_deform.LAUNCHES = 0
        out = module.run(module.parser().parse_args(argv), dev)
        for key, count in (("jpeg_idct", jpeg.LAUNCHES_IDCT), ("jpeg_color", jpeg.LAUNCHES_COLOR),
                           ("k3", ms_deform.LAUNCHES)):
            launches[key] += count
        return out, dict(jpeg=jpeg.LAUNCHES_IDCT, k3=ms_deform.LAUNCHES)
    tmp = tempfile.mkdtemp(prefix="weak_assets_", dir=os.path.join(HERE, "build"))
    omni = os.path.join(HERE, "datasets", "Omni3D")
    images_root = os.path.join(HERE, "datasets")
    seconds = {}

    # object masks: SAM-HQ ViT-B at 1024, bf16, over synth_test
    t0 = time.perf_counter()
    sam_ckpt = os.path.join(tmp, "sam_hq_vit_b.pth")
    torch.save(sam.build_sam(hq=True, img_size=1024, dtype=torch.bfloat16, seed=0).state_dict(), sam_ckpt)
    save_s = time.perf_counter() - t0
    out_masks = os.path.join(tmp, "object_masks")
    res, count = tool(generate_object_masks, ["--dataset-json", os.path.join(omni, "synth_test.json"), "--image-root",
                                              images_root, "--out-dir", out_masks, "--checkpoint", sam_ckpt])
    seconds["object_masks"] = res["seconds"]
    check(count["jpeg"] == 20, f"the object-mask tool decoded {count['jpeg']} images on the card, not 20")
    with open(os.path.join(omni, "synth_test.json")) as f:
        test = json.load(f)
    anns = {}
    for a in test["annotations"]:
        anns.setdefault(a["image_id"], []).append(a["id"])
    check(res["hq"] and res["images"] == 20 and res["masks"] == len(test["annotations"]) == 103,
          f"object masks: {res}")
    check(len(os.listdir(out_masks)) == 20, f"{len(os.listdir(out_masks))} object-mask files, not 20")
    covered = []
    for im in test["images"]:
        with np.load(os.path.join(out_masks, f"{im['id']}.npz")) as z:
            m, ids = z["masks"], z["ann_ids"]
        check(m.dtype == np.uint8 and m.shape == (len(anns[im["id"]]), 480, 640) and ids.dtype == np.int64
              and ids.tolist() == anns[im["id"]], f"object masks of image {im['id']}: {m.dtype} {m.shape} {ids}")
        covered.append(float(m.mean()) if m.size else 0.0)
    _mapper_reads_object_masks(torch, dev, out_masks)
    print(f"[assets] {card}: generate_object_masks SAM-HQ ViT-B 1024 bf16 over synth_test: 20 files, 103 masks "
          f"(mean coverage {np.mean(covered):.4f}) in {seconds['object_masks']:.2f} s (saving the seeded checkpoint "
          f"{save_s:.2f} s before it); the port's mapper reads them back", flush=True)

    # the SAM ViT-B encoder at 1024 and the decoder a box, bf16
    model = sam.load_sam(sam_ckpt, 1024, dev)
    image = imread_rgb(os.path.join(HERE, "datasets", "synth", "images", "000061.jpg"), dev)
    x, scale = sam.preprocess_sam_image(image, 1024)
    boxes = torch.tensor([[110.6, 339.1, 150.8, 366.1]], dtype=torch.float32, device=dev) * scale
    with torch.no_grad():
        emb = model.encode_image(x)
        enc_ms = cuda_ms(lambda: model.encode_image(x), iters=5)
        dec_ms = cuda_ms(lambda: model.decode_boxes(emb, boxes), iters=10)
        boxes8 = boxes.expand(8, 4).contiguous()
        dec8_ms = cuda_ms(lambda: model.decode_boxes(emb, boxes8), iters=10) / 8
    del model, emb
    print(f"[assets] {card}: SAM-HQ ViT-B encoder at 1024 bf16 {enc_ms:.3f} ms; decoder {dec_ms:.3f} ms for one box, "
          f"{dec8_ms:.3f} ms a box in a call of 8 (CUDA events)", flush=True)

    # ground masks: GroundingDINO's box (K3), then SAM-HQ; the heuristic box; filter_ground
    t0 = time.perf_counter()
    gdino_ckpt = os.path.join(tmp, "gdino.pth")
    gmodel = gdino_infer.load_model(dev, seed=0)
    torch.save(gmodel.state_dict(), gdino_ckpt)
    save_s = time.perf_counter() - t0
    val_json = os.path.join(omni, "synth_val.json")
    ground = os.path.join(tmp, "ground_maps")
    args = ["--dataset-json", val_json, "--image-root", images_root, "--checkpoint", sam_ckpt]
    # the seeded detector's scores are far below the tool's 0.35: threshold 0, so SAM runs on every box it finds
    res, count = tool(generate_ground_segmentations, args + [
        "--out-dir", ground, "--no-ground-csv", os.path.join(tmp, "no_ground_gdino.csv"), "--gdino-checkpoint",
        gdino_ckpt, "--box-threshold", "0"])
    seconds["ground_gdino"] = res["seconds"]
    check(res["images"] == 8 and count["k3"] == res["k3_launches"] == 12 * 8,
          f"the ground tool launched K3 {count['k3']} times over 8 images, not 12 a forward")
    check(count["jpeg"] == 8, f"the ground tool decoded {count['jpeg']} images on the card, not 8")
    print(f"[assets] {card}: generate_ground_segmentations --gdino-checkpoint --box-threshold 0 over synth_val: "
          f"{res['masks']} masks, {len(res['no_ground'])} without ground (SAM's mask under 1 %), K3 launches "
          f"{count['k3']} (12 a forward) in {res['seconds']:.2f} s (saving the seeded GroundingDINO {save_s:.2f} s "
          f"before it)", flush=True)
    with open(val_json) as f:
        val = json.load(f)
    first = imread_rgb(os.path.join(images_root, val["images"][0]["file_path"]), dev)
    captured = capture_k3_inputs(torch, gmodel, generate_ground_segmentations.gdino_input(first, 800).cpu().numpy(),
                                 dev)
    k3_rows = phase_deform_model(torch, dev, captured, iters=5)
    for dtype_name, r in k3_rows.items():
        print(f"[assets] K3 {dtype_name} on the ground tool's first image: 12 launches, largest error "
              f"{r['max_abs_err']:.3e}", flush=True)
    del gmodel, captured
    res, _ = tool(generate_ground_segmentations, args + [
        "--out-dir", os.path.join(tmp, "ground_heuristic"), "--no-ground-csv", os.path.join(tmp, "no_ground_heuristic.csv"),
        "--heuristic"])
    seconds["ground_heuristic"] = res["seconds"]
    check(res["masks"] + len(res["no_ground"]) == 8, f"heuristic ground masks: {res}")
    kept = sorted(os.listdir(os.path.join(tmp, "ground_heuristic")))
    filt = filter_ground.run(filter_ground.parser().parse_args(
        ["--ground-dir", os.path.join(tmp, "ground_heuristic"), "--no-ground-csv",
         os.path.join(tmp, "no_ground_heuristic.csv")]))
    check(filt["removed"] == [] and sorted(filt["ids"]) == sorted(res["no_ground"]),
          f"filter_ground after the tool's own 1 % rule: {filt}")
    print(f"[assets] {card}: --heuristic: {res['masks']} masks ({len(kept)} files), {len(res['no_ground'])} without "
          f"ground in {res['seconds']:.2f} s; filter_ground removed {len(filt['removed'])}", flush=True)

    # depth maps: DA-V2 vitl at 518, random weights; then the normals
    depth_dir = os.path.join(tmp, "depth_maps")
    res, _ = tool(generate_depth_maps, ["--dataset-json", val_json, "--image-root", images_root, "--out-dir",
                                        depth_dir, "--random-weights"])
    seconds["depth_maps"] = res["seconds"]
    for im in val["images"]:
        with np.load(os.path.join(depth_dir, f"{im['id']}.npz")) as z:
            d = z["depth"]
        check(d.dtype == np.float32 and d.shape == (480, 640) and np.isfinite(d).all(), f"depth of image {im['id']}")
    normals_json = os.path.join(tmp, "normal_vectors.json")
    res, _ = tool(generate_normal_vectors, ["--dataset-json", val_json, "--depth-dir", depth_dir, "--ground-dir",
                                            os.path.join(tmp, "ground_heuristic"), "--out", normals_json])
    seconds["normal_vectors"] = res["seconds"]
    with open(normals_json) as f:
        normals = np.asarray(list(json.load(f).values()), np.float64)
    check(normals.shape == (8, 3) and np.isfinite(normals).all() and np.abs(np.linalg.norm(normals, axis=1) - 1).max()
          < 1e-5, f"normals: {normals}")
    print(f"[assets] {card}: generate_depth_maps vitl 518 (1813 tokens, plain attention) over synth_val "
          f"{seconds['depth_maps']:.2f} s; generate_normal_vectors 8 unit normals in {seconds['normal_vectors']:.2f} s",
          flush=True)
    check(launches["jpeg_idct"] == launches["jpeg_color"] == 44 and launches["k3"] == 96,
          f"the tools' launches: {launches} (the decoder 20 + 8 + 8 + 8 images, K3 8 forwards of 12)")

    _sam_card_vs_cpu(torch, dev, hq=False)
    _sam_card_vs_cpu(torch, dev, hq=True)
    print(f"[assets] phase took {time.perf_counter() - t_phase:.1f} s; the tools' seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    return dict(launches=launches, jpeg=jpeg_rows, k3=k3_rows, seconds=seconds, sam_encoder_ms=enc_ms,
                sam_decoder_ms=dec_ms, sam_checkpoint=sam_ckpt)


def _mapper_reads_object_masks(torch, dev, out_masks):
    """The port's mapper on synth_test's records with the tool's files: the
    stored masks, not the filled boxes, become ``gt_masks``."""
    import tempfile

    import numpy as np

    from threedod_torch import train_net
    from threedod_torch.data.build import get_dataset_dicts
    from threedod_torch.data.mapper import DatasetMapper3D

    cfg, _, _ = train_net.setup(WEAK_SYNTH, ["output_dir", tempfile.mkdtemp(prefix="masks_", dir=os.path.join(
        HERE, "build"))])
    records = get_dataset_dicts(["synth_test"])
    check(len(records) == 20, f"synth_test has {len(records)} records, not 20")
    read = 0
    for r in records[:4]:  # two mappers with one seed: the same scale and flip, stored masks or none
        stored = DatasetMapper3D(cfg, is_train=True, load_maps=True, rng=np.random.RandomState(0), device=dev)
        boxes = DatasetMapper3D(cfg, is_train=True, load_maps=True, rng=np.random.RandomState(0), device=dev)
        got = stored(dict(r, object_masks_path=os.path.join(out_masks, f"{r['image_id']}.npz")))["gt_masks"]
        for m, box in zip(got, boxes(dict(r, object_masks_path=None))["gt_masks"]):
            read += int(not np.array_equal(m, box))
        check(got.shape[0] == len(r["annotations"]) and got.dtype == np.float32, f"gt_masks {got.shape} {got.dtype}")
    check(read > 0, "the mapper gave the filled boxes, not the tool's masks")


# phase 18: two option sets that between them set every flag of the cube head
# away from its default; each pools the cube branch apart from the box branch
# (ROIs scaled by 1.25, a 5x5 cube pool), so K1 and K2 run twice a step
CUBE_OPTION_SETS = {
    "set 1": {"shared_fc": "False", "pose_type": "quaternion", "z_type": "sigmoid", "allocentric_pose": "False",
              "virtual_depth": "False", "dims_priors_func": "sigmoid", "scale_roi_boxes": "1.25",
              "disentangled_loss": "False", "inverse_z_weight": "True"},
    "set 2": {"pose_type": "euler", "z_type": "clusters", "cluster_bins": "3", "pooler_resolution": "5",
              "chamfer_pose": "False", "use_confidence": "0.0", "dims_priors_enabled": "False"},
}
# the cube branch's own pool at Base_Synth's shapes: (images, ROIs, bins, box scale)
SECOND_POOL_ROIS = {"training 5x5": (8, 64, 5, 1.0), "training scaled 1.25": (8, 64, 7, 1.25),
                    "eval detections 5x5": (1, 100, 5, 1.0), "eval detections scaled 1.25": (1, 100, 7, 1.25)}


def train_net_in_process(torch, dev, args) -> dict:
    """``threedod_torch.train_net.run`` in this process (no process start to
    pay), the ROIAlign counts set to 0 just before: its result, with the
    card's name under ``device`` and the logged windows' medians (from
    ``metrics.json``) under ``windows``, as ``train_net_blocked`` gives them."""
    from threedod_torch import train_net
    from threedod_torch.ops import roi_align_cuda

    parsed = train_net.parser().parse_args(args)
    roi_align_cuda.LAUNCHES = roi_align_cuda.BACKWARD_LAUNCHES = 0
    run = train_net.run(parsed, dev)
    out_dir = parsed.opts[parsed.opts.index("output_dir") + 1]
    with open(os.path.join(out_dir, "metrics.json")) as f:
        windows = [json.loads(line) for line in f]
    return dict(run, device=train_net.card_name_and_power_limit(dev), windows=windows)


def second_pool_kernels(torch, dev):
    """K1 (and, at the training shapes, K2) against their plain versions at
    the cube branch's own pool: Base_Synth's foreground prefix (8 x 64 ROIs)
    and an evaluation's 100 detections, at 5x5 bins (option set 2) and at
    7x7 over ROIs scaled by 1.25 (option set 1), in f32 and bf16."""
    from threedod_torch.ops import roi_align, roi_align_cuda

    gen = torch.Generator().manual_seed(8)
    names = sorted(roi_align.STRIDES)
    rows = {"roi_align_fwd": [], "roi_align_bwd": []}
    for batch in (8, 1):
        feats32 = _level_feats(torch, roi_align, gen, dev, b=batch, h=384, w=512)
        for label, (b, n, s, scale) in SECOND_POOL_ROIS.items():
            if b != batch:
                continue
            boxes = random_boxes(torch, b, n, 384, 512, gen, dev)
            ctr, half = (boxes[..., :2] + boxes[..., 2:]) * 0.5, (boxes[..., 2:] - boxes[..., :2]) * 0.5 * scale
            boxes = torch.cat([ctr - half, ctr + half], dim=-1).contiguous()
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                feats = {k: v.to(dtype) for k, v in feats32.items()}
                with torch.no_grad():
                    out = roi_align_cuda.multilevel_roi_align(feats, boxes, s)
                    ref = roi_align.multilevel_roi_align(feats, boxes, s)
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[dtype_name] * (ref.float().abs().max().item() if dtype_name == "bfloat16" else 1.0)
                with torch.no_grad():
                    ms = cuda_ms(lambda: roi_align_cuda.multilevel_roi_align(feats, boxes, s), iters=20)
                    plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align(feats, boxes, s), iters=3)
                bound, by = roi_align_bound_ms(feats, b * n, out.element_size(), s=s)
                print(f"[options] K1 {dtype_name} {label} {b} x {n} ROIs, {s}x{s} bins, 384x512 levels: "
                      f"max_abs_err={err:.3e} (tol {tol:.3e}), call {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})", flush=True)
                check(out.shape == (b, n, s, s, 256) and err <= tol,
                      f"K1 {dtype_name} at the cube pool's {label} shape disagrees: {err} > {tol}")
                rows["roi_align_fwd"].append(dict(shape=f"{dtype_name} {label} {b}x{n} {s}x{s}", max_abs_err=err,
                                                  ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
                if not label.startswith("training"):
                    continue
                grad = torch.randn((b, n, s, s, 256), generator=gen).to(dev)
                level = roi_align.assign_levels(boxes.reshape(-1, 4), names).reshape(b, n)
                shapes = [tuple(feats32[nm].shape[2:]) for nm in names]
                scales = [1.0 / roi_align.STRIDES[nm] for nm in names]
                level32 = level.to(torch.int32).contiguous()

                def kernel():
                    return roi_align_cuda.roi_align_backward_cuda(grad, boxes, level32, names, shapes, 2, dtype)

                def plain():
                    return roi_align.roi_align_backward(grad, boxes, level, shapes, scales, 2, dtype)

                got, want = kernel(), plain()
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                tol = TOL_BWD[dtype_name] * max(w.float().abs().max().item() for w in want)
                ms, plain_ms = cuda_ms(kernel, iters=10), cuda_ms(plain, iters=2, warmup=1)
                bound, by = roi_align_bound_ms(feats, b * n, grad.element_size(), s=s)
                print(f"[options] K2 {dtype_name} {label} {b} x {n} ROIs, {s}x{s} bins: max_abs_err={err:.3e} "
                      f"(tol {tol:.3e}), call {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})",
                      flush=True)
                check(err <= tol, f"K2 {dtype_name} at the cube pool's {label} shape disagrees: {err} > {tol}")
                rows["roi_align_bwd"].append(dict(shape=f"{dtype_name} {label} {b}x{n} {s}x{s}", max_abs_err=err,
                                                  ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
    return rows


def hull_fill_report(torch, dev, n: int = 512, hm: int = 96, wm: int = 128):
    """The soft hull fill of the ``segmentation`` loss at Omni_combined_Synth's
    shapes (8 images x 64 foreground ROIs, 8 corners, the 96x128 mask grid):
    forward and backward on the card against the CPU (the first 64 ROIs),
    the card's ms for the pair (CUDA events) and the peak memory the pair
    adds."""
    from threedod_torch.geometry.hull import convex_hull_mask

    gen = torch.Generator().manual_seed(9)
    centre = torch.rand((n, 1, 2), generator=gen) * torch.tensor([wm, hm])
    points = centre + (torch.rand((n, 8, 2), generator=gen) - 0.5) * 40.0
    g = torch.randn((n, hm, wm), generator=gen)
    out = {}
    for device, rows in (("cpu", 64), (dev, n)):
        p = points[:rows].to(device).requires_grad_(True)
        mask = convex_hull_mask(p, hm, wm)
        mask.backward(g[:rows].to(device))
        out[str(device)] = (mask.detach()[:64].cpu(), p.grad[:64].cpu())
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    err = (mc - mg).abs().max().item()
    gerr = ((gc - gg).abs().max() / gc.abs().max()).item()
    pts = points.detach().to(dev).requires_grad_(True)
    gd = g.to(dev)

    def pair():
        convex_hull_mask(pts, hm, wm).backward(gd)

    pair()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pair()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = cuda_ms(pair, iters=10)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: convex_hull_mask(pts, hm, wm), iters=10)
    print(f"[seg] hull fill {n} x 8 corners on {hm}x{wm}: card vs CPU forward max_abs_err={err:.3e} (tol 1e-6), "
          f"gradient max rel err {gerr:.3e} (tol 1e-5); forward {fwd_ms:.4f} ms, forward + backward {ms:.4f} ms, "
          f"peak memory added {peak / 2 ** 20:.1f} MiB (one (N, H, W) f32 plane is {n * hm * wm * 4 / 2 ** 20:.1f} "
          f"MiB)", flush=True)
    check(err <= 1e-6 and gerr <= 1e-5, f"the hull fill differs card vs CPU: {err}, {gerr}")
    return dict(max_abs_err=err, grad_rel_err=gerr, ms=ms, forward_ms=fwd_ms, peak_bytes=peak)


def _stored_mask_share(torch, dev, root):
    """The share of the ground-truth slots of Omni_combined_Synth's first
    training batch whose stored mask (SAM's, in ``root``) differs from its
    filled box."""
    import tempfile

    from threedod_torch import train_net
    from threedod_torch.data.build import TrainLoader, get_dataset_dicts

    cfg, _, _ = train_net.setup(WEAK_SYNTH, ["datasets.root", root, "output_dir", tempfile.mkdtemp(
        prefix="share_", dir=os.path.join(HERE, "build"))])
    records = get_dataset_dicts(cfg.datasets.train)
    check(all("object_masks_path" in r for r in records), "a training record has no stored masks")
    gt = TrainLoader(records, cfg, seed=cfg.seed, device=dev, load_maps=True).next_batch().gt
    hm, wm = gt.masks.shape[2:]
    x1, y1, x2, y2 = (gt.boxes2d.float().to(dev) / 4.0).unbind(-1)
    ys = torch.arange(hm, device=dev)[:, None]
    xs = torch.arange(wm, device=dev)[None, :]
    fills = ((ys >= y1[..., None, None]) & (ys < y2[..., None, None]) & (xs >= x1[..., None, None])
             & (xs < x2[..., None, None]))
    slots = (gt.valid & (gt.classes >= 0)).to(dev)
    differ = ((gt.masks.to(dev) > 0.5) != fills).flatten(2).any(-1)
    return (differ & slots).sum().item() / max(slots.sum().item(), 1), int(slots.sum().item())


def boxnet_with_sam_masks(torch, dev, root):
    """BoxNet's ``propose_and_score`` on the card with SAM's stored masks of a
    fixture training image (resized to the network's size, one a
    ground-truth slot) in place of the filled boxes: finite scores, and seg
    scores that differ from the filled boxes'."""
    import tempfile

    import numpy as np

    from threedod_torch import train_net
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.data.resize import resize_nearest
    from threedod_torch.models.meta_arch import build_model

    cfg, _, priors = train_net.setup(BOXNET_SYNTH, ["datasets.root", root, "output_dir", tempfile.mkdtemp(
        prefix="boxnet_masks_", dir=os.path.join(HERE, "build"))])
    model = build_model(cfg, priors=priors).to(dev)
    record = get_dataset_dicts(["synth_train"])[0]
    batch, _ = next(iter(TestLoader([record], cfg, device=dev, load_maps=True)))
    h, w = batch.image.shape[1:3]
    nh, nw = (int(v) for v in batch.image_hw[0].tolist())
    masks = torch.zeros((1, batch.gt.boxes2d.shape[1], h, w), dtype=torch.uint8, device=dev)
    with np.load(record["object_masks_path"]) as z:
        stored = dict(zip(z["ann_ids"].tolist(), z["masks"]))
    for k, anno in enumerate(record["annotations"][:masks.shape[1]]):
        masks[0, k, :nh, :nw] = resize_nearest(torch.from_numpy(stored[anno["ann_id"]]).to(dev), nh, nw)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(3)
        filled, _, _, valid = model(batch, "propose", draws=gen)
        gen = torch.Generator(device=dev).manual_seed(3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got, _, _, _ = model(batch, "propose", masks=masks, draws=gen)
        end.record()
        end.synchronize()
    v = valid[0]
    finite = all(torch.isfinite(t[0][v]).all().item() for t in got.scores.values())
    same = (got.scores["seg"][0][v] == filled.scores["seg"][0][v]).float().mean().item()
    print(f"[options] BoxNet propose_and_score with SAM's masks of image {record['image_id']} ({int(v.sum())} boxes x "
          f"{cfg.model.roi_cube_head.number_of_proposals} proposals): {start.elapsed_time(end):.3f} ms; finite "
          f"scores; {100 * same:.2f} % of the seg scores equal the filled boxes'", flush=True)
    check(finite and same < 1.0, f"BoxNet with SAM masks: finite {finite}, seg scores equal to the filled boxes' {same}")


def phase_seg_and_options(torch, dev, sam_ckpt):
    """Phase 18: the weak ``segmentation`` loss on SAM's masks, and the cube
    head's options. K1 and K2 at the cube branch's own pool; the hull fill
    card vs CPU with its ms and memory; one weak step with the 8-loss menu
    card vs CPU; SAM-HQ's masks for synth_train (``generate_object_masks``
    with phase 17's seeded checkpoint) into a datasets root under ``build/``
    that links the fixture; ``train_net`` on Omni_combined_Synth with the
    8-loss menu for 30 iterations and an evaluation; Base_Synth for 20
    iterations and an evaluation under each of ``CUBE_OPTION_SETS`` (K1 and
    K2 twice a step) and 2D-only (``loss_w_3d`` 0); BoxNet with SAM's masks.
    The weak ``train_net`` run is a process without Pillow and PyYAML, the
    Base_Synth runs are in this process; each counts its launches from 0.
    Returns the kernels' rows and launches."""
    import tempfile

    from threedod_torch import generate_object_masks
    from threedod_torch.train_net import card_name_and_power_limit

    t0 = time.perf_counter()
    card = card_name_and_power_limit(dev)
    rows = second_pool_kernels(torch, dev)
    fill = hull_fill_report(torch, dev)
    weak_step_card_vs_cpu(torch, dev, segmentation=True)

    root = tempfile.mkdtemp(prefix="seg_synth_", dir=os.path.join(HERE, "build"))
    os.makedirs(os.path.join(root, "Omni3D"))
    for name in ("synth_train", "synth_test"):
        os.symlink(os.path.join(HERE, "datasets", "Omni3D", f"{name}.json"), os.path.join(root, "Omni3D", f"{name}.json"))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(os.path.join(HERE, "datasets", name), os.path.join(root, name))
    res = generate_object_masks.run(generate_object_masks.parser().parse_args(
        ["--dataset-json", os.path.join(root, "Omni3D", "synth_train.json"), "--image-root", root, "--out-dir",
         os.path.join(root, "object_masks"), "--checkpoint", sam_ckpt]), dev)
    check(res["hq"] and res["images"] == 60 and res["masks"] > 0, f"object masks of synth_train: {res}")
    share, slots = _stored_mask_share(torch, dev, root)
    print(f"[seg] {card}: generate_object_masks SAM-HQ over synth_train: {res['masks']} masks of {res['images']} "
          f"images in {res['seconds']:.2f} s; {100 * share:.1f} % of the {slots} ground-truth slots of the first "
          f"training batch have a stored mask that differs from the filled box", flush=True)
    check(share > 0, "every stored mask equals its filled box: the loss would read box fills")

    launches = {"k1": 0, "k2": 0}
    runs = {}
    seg_keys = WEAK_MENU_KEYS | {"Cube/loss_seg"}
    # the weak run in a process without Pillow and PyYAML; the Base_Synth
    # runs in this one (phase 14 shows that path needs neither)
    cases = [("weak 8-loss menu", WEAK_SYNTH, ["datasets.root", root, "loss_functions", MENU8], 30, 1, 2)]
    cases += [(f"Base_Synth {label}", BASE_SYNTH, [x for k, v in opts.items() for x in (f"model.roi_cube_head.{k}", v)],
               20, 2, 2) for label, opts in CUBE_OPTION_SETS.items()]
    cases += [("Base_Synth 2D-only", BASE_SYNTH, ["model.roi_cube_head.loss_w_3d", "0.0"], 20, 1, 1)]
    for label, config, opts, iters, per_step, per_eval in cases:
        out = tempfile.mkdtemp(prefix="options_", dir=os.path.join(HERE, "build"))
        args = ["--config-file", config, *opts, "solver.max_iter", str(iters), "solver.checkpoint_period", str(iters),
                "output_dir", out]
        run = train_net_blocked(args) if label.startswith("weak") else train_net_in_process(torch, dev, args)
        runs[label] = run
        steps = run["iterations"] - run["first_iteration"]
        res = run["results"]["synth_test"]
        print(f"[options] {run['device']}: train_net {label} iterations 0..{run['iterations'] - 1}: "
              f"{run['ms_per_iteration']:.3f} ms an iteration ({run['steps_timed']} after 10), loader "
              f"{100 * run['loader_share']:.2f} %, peak memory {run['peak_memory_bytes'] / 2 ** 30:.3f} GiB, skipped "
              f"{run['skipped']}; K1 {run['k1_launches_training']} and K2 {run['k2_launches_training']} launches in "
              f"training, K1 {run['k1_launches_eval']} in evaluating 20 images; total loss, mean of the first 10 "
              f"iterations {run['loss_first_mean']:.4f}, of the last 10 {run['loss_last_mean']:.4f}; AP2D "
              f"{res['AP2D']:.4f} AP3D {res['AP3D']:.4f}", flush=True)
        check(run["steps"] == iters and run["skipped"] == 0 and run["attempts"] == 1, f"{label}: {run}")
        check(run["nonfinite_losses"] == 0, f"{label}: {run['nonfinite_losses']} losses are not finite")
        check(run["k1_launches_training"] == per_step * steps and run["k2_launches_training"] == per_step * steps,
              f"{label}: expected {per_step} K1 and {per_step} K2 launches a step, got {run['k1_launches_training']}"
              f" and {run['k2_launches_training']} in {steps} steps")
        check(run["k1_launches_eval"] == 20 * per_eval,
              f"{label}: expected {per_eval} K1 launches an evaluation forward, got {run['k1_launches_eval']}")
        check(math.isfinite(res["AP2D"]), f"{label}: AP2D {res['AP2D']}")
        launches["k1"] += run["k1_launches_training"] + run["k1_launches_eval"]
        launches["k2"] += run["k2_launches_training"]
        for window in run["windows"]:
            cube = {k for k in window if k.startswith("Cube/")}
            if label.endswith("2D-only"):
                check(not cube, f"the 2D-only run logged cube losses: {sorted(cube)}")
            elif label.startswith("weak"):
                check(seg_keys <= cube and all(math.isfinite(window[k]) for k in seg_keys),
                      f"window at iteration {window['iteration']}: {window}")
        if label.startswith("weak"):
            check(run["loss_last_mean"] < run["loss_first_mean"],
                  f"the loss did not fall: {run['loss_first_mean']} then {run['loss_last_mean']}")
            print(f"[seg] Cube/loss_seg in the logged windows: "
                  + ", ".join(f"{w['iteration']}: {w['Cube/loss_seg']:.4g}" for w in run["windows"]), flush=True)
    boxnet_with_sam_masks(torch, dev, root)
    print(f"[options] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(rows=rows, fill=fill, runs=runs, launches=launches)


# phase 19: data parallelism. The compared step: Base_Synth's DLA34 at bs8
# 384x512 in f32 (TF32 off) with both samplers saturated, as the CPU tests'
# (the RPN on p4 to p6, all 3024 anchors an image kept, no proposal NMS, all
# 3040 ROIs sampled), so that a rounding of the features cannot change a
# sampled set; the timed steps: Base_Synth as shipped (bf16)
DDP_SATURATE = ["model.dtype", "float32", "model.rpn.in_features", "[p4, p5, p6]", "model.rpn.nms_thresh", "1.0",
                "model.rpn.pre_nms_topk_train", "3024", "model.rpn.post_nms_topk_train", "3024",
                "model.rpn.batch_size_per_image", "3024", "shapes.roi_batch", "3040"]
DDP_STEPS, DDP_WARMUP = 5, 2
DDP_RANK_TIMEOUT_S = 300.0
# 2 ranks (or a group of one) vs one process, at the CPU tests' tolerances
# (tests/test_torch_ddp_train.py): in training mode losses 1e-4 relative,
# running statistics 1e-5 of each tensor's largest entry, gradients by cosine
# 0.99 a leaf and 0.9999 over all; with every BatchNorm on its running
# statistics ("frozen"), where a rounding of the batch statistics cannot move
# the gradients, losses 1e-5 relative and each gradient within 1e-5 of its
# leaf's largest entry. Those and the training-mode gradients' norm over all
# leaves (within 1e-3 of one process's) hold their scale: summed over the
# ranks, not averaged.
DDP_LOSS_RTOL, DDP_STATS_TOL, DDP_LEAF_COS, DDP_ALL_COS, DDP_NORM_RTOL = 1e-4, 1e-5, 0.99, 0.9999, 1e-3
DDP_FROZEN_LOSS_RTOL, DDP_FROZEN_GRAD_TOL = 1e-5, 1e-5


def ddp_run(torch, dev, profile_collectives: bool = False) -> dict:
    """This process's part (this rank's rows, or all 8 images without a
    group) of phase 19: the compared f32 step in training mode ("compare")
    and with every BatchNorm on its running statistics ("frozen"), then
    ``DDP_STEPS`` timed bf16 steps of Base_Synth after ``DDP_WARMUP``, with
    the K1, K2 and collective launches of the timed steps; with
    ``profile_collectives`` the device time of the NCCL kernels of one more
    step."""
    from torch.profiler import ProfilerActivity, profile

    from threedod_torch.config_yaml import load_config
    from threedod_torch.data.batch import synthetic_train_batch
    from threedod_torch.models.backbones.layers import BatchNorm2d
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.ops import roi_align_cuda
    from threedod_torch.parallel import dist
    from threedod_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for part, opts in (("compare", DDP_SATURATE), ("frozen", DDP_SATURATE), ("timed", [])):
        cfg = load_config(BASE_SYNTH, opts)
        trainer = Trainer(cfg, build_model(cfg, seed=0).to(dev), dev)
        batch = dist.local_rows(synthetic_train_batch(cfg, cfg.solver.ims_per_batch, seed=3)).to(dev)
        if part == "frozen":
            for m in trainer.model.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        if part != "timed":
            step = trainer.train_step(batch)
            out[part] = dict(losses=step.losses, total=step.total, diverging=step.diverging,
                             grads={k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()},
                             stats={k: v.detach().cpu() for k, v in trainer.model.state_dict().items()
                                    if k.endswith(("running_mean", "running_var"))})
            continue
        for _ in range(DDP_WARMUP):
            trainer.train_step(batch)
        torch.cuda.synchronize(dev)
        roi_align_cuda.LAUNCHES = roi_align_cuda.BACKWARD_LAUNCHES = 0
        c0, t0 = dist.COLLECTIVES, time.perf_counter()
        steps = [trainer.train_step(batch) for _ in range(DDP_STEPS)]
        torch.cuda.synchronize(dev)
        out[part] = dict(ms=(time.perf_counter() - t0) * 1000.0 / DDP_STEPS, k1=roi_align_cuda.LAUNCHES,
                         k2=roi_align_cuda.BACKWARD_LAUNCHES, collectives=(dist.COLLECTIVES - c0) / DDP_STEPS,
                         total=steps[-1].total, images=batch.image.shape[0])
        if profile_collectives:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                trainer.train_step(batch)
                torch.cuda.synchronize(dev)
            events = prof.key_averages()
            us = [e.self_cuda_time_total if getattr(e, "self_device_time_total", None) is None
                  else e.self_device_time_total for e in events]
            nccl = [u for e, u in zip(events, us) if "nccl" in e.key.lower()]
            out[part].update(collective_device_ms=sum(nccl) / 1e3, collective_kernels=len(nccl),
                             step_device_ms=sum(us) / 1e3)
        del trainer, batch
    torch.cuda.empty_cache()
    return out


def _ddp_rank(out_prefix: str, profile_collectives: bool) -> None:
    """One spawned rank of phase 19: ``ddp_run`` on cuda:0, saved to
    ``out_prefix``.<rank>."""
    import torch

    from threedod_torch.parallel import dist

    torch.save(ddp_run(torch, torch.device("cuda", 0), profile_collectives), f"{out_prefix}.{dist.rank()}")


def _ddp_close_frozen(got: dict, want: dict, what: str) -> str:
    """Hold the compared step with frozen BatchNorms against the one-process
    step: losses, and each gradient against its leaf's largest entry; -> a
    line of the largest differences."""
    check(not got["diverging"] and not want["diverging"], f"{what}: a step was skipped")
    worst_loss = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in want["losses"].items())
    check(set(got["losses"]) == set(want["losses"]) and worst_loss <= DDP_FROZEN_LOSS_RTOL,
          f"{what}, frozen BatchNorms: a loss parts by {worst_loss:.3e} relative")
    worst, leaf = 0.0, ""
    for k, w in want["grads"].items():
        err = float((got["grads"][k].double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30))
        if err > worst:
            worst, leaf = err, k
    check(worst <= DDP_FROZEN_GRAD_TOL, f"{what}, frozen BatchNorms: the gradient of {leaf} parts by {worst:.3e} "
                                         f"of its largest entry")
    return (f"frozen BatchNorms: losses within {worst_loss:.3e} relative, gradients within {worst:.3e} of their "
            f"leaf's largest entry ({leaf})")


def _ddp_close(torch, got: dict, want: dict, what: str) -> str:
    """Hold a compared step against the one-process step (the CPU tests'
    tolerances); -> a line of the largest differences."""
    check(not got["diverging"] and not want["diverging"], f"{what}: a step was skipped")
    worst_loss = max(abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in want["losses"].items())
    check(set(got["losses"]) == set(want["losses"]) and worst_loss <= DDP_LOSS_RTOL,
          f"{what}: a loss parts by {worst_loss:.3e} relative")
    worst_stat = max(float((got["stats"][k] - v).abs().max() / v.abs().max()) for k, v in want["stats"].items())
    check(worst_stat <= DDP_STATS_TOL, f"{what}: a running statistic parts by {worst_stat:.3e} of its largest")
    dot = ng = nw = 0.0
    low = 1.0
    for k, w in want["grads"].items():
        g, w = got["grads"][k].double().ravel(), w.double().ravel()
        if float(w.abs().max()) == 0:
            check(float(g.abs().max()) == 0, f"{what}: {k} has a gradient where one process has none")
            continue
        low = min(low, float(g @ w / (g.norm() * w.norm())))
        dot, ng, nw = dot + float(g @ w), ng + float(g @ g), nw + float(w @ w)
    cos = dot / math.sqrt(ng * nw)
    check(low >= DDP_LEAF_COS and cos >= DDP_ALL_COS, f"{what}: gradient cosine {low:.6f} a leaf, {cos:.8f} over all")
    check(abs(math.sqrt(ng / nw) - 1.0) <= DDP_NORM_RTOL, f"{what}: gradient norm {math.sqrt(ng / nw):.6f} x one process's")
    bits = all(torch.equal(got["grads"][k], v) for k, v in want["grads"].items()) and got["losses"] == want["losses"]
    return (f"losses within {worst_loss:.3e} relative, running statistics within {worst_stat:.3e} of their largest, "
            f"gradient cosine {low:.6f} the lowest leaf and {cos:.9f} over all, gradient norm over all "
            f"{math.sqrt(ng / nw):.9f} x one process's; bit-equal: {bits}")


def phase_ddp(torch, dev) -> dict:
    """Data parallelism on the one card: the Base_Synth step without a
    process group, under a world-1 NCCL group (collectives run) and over two
    gloo ranks spawned on this card with 4 images each of the same global
    batch of 8; the compared f32 step of each against the one-process step,
    the timed bf16 steps' ms an iteration, collectives a step and (world 1)
    their device time, and each rank's K1 and K2 launches."""
    import shutil
    import tempfile

    from threedod_torch.parallel import dist

    t0 = time.perf_counter()
    one = ddp_run(torch, dev)
    folder = tempfile.mkdtemp(prefix="ddp_", dir=os.path.join(HERE, "build"))
    try:
        prefix = os.path.join(folder, "out")
        dist.spawn(_ddp_rank, ["cuda:0"], (prefix + "_nccl", True), backend="nccl", timeout_s=DDP_RANK_TIMEOUT_S)
        nccl = torch.load(prefix + "_nccl.0", weights_only=True)
        dist.spawn(_ddp_rank, ["cuda:0", "cuda:0"], (prefix + "_gloo", False), backend="gloo",
                   timeout_s=DDP_RANK_TIMEOUT_S)
        gloo = [torch.load(f"{prefix}_gloo.{r}", weights_only=True) for r in range(2)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    print(f"[ddp] {smi}: world-1 NCCL group vs no group, f32 saturated bs8 384x512 step: "
          f"{_ddp_close(torch, nccl['compare'], one['compare'], 'world-1 NCCL')}; "
          f"{_ddp_close_frozen(nccl['frozen'], one['frozen'], 'world-1 NCCL')}", flush=True)
    for part in ("compare", "frozen"):
        for k, v in gloo[0][part]["grads"].items():
            check(torch.equal(v, gloo[1][part]["grads"][k]), f"the two gloo ranks hold other gradients of {k}")
        check(gloo[0][part]["losses"] == gloo[1][part]["losses"], "the two gloo ranks hold other losses")
    print(f"[ddp] {smi}: 2 gloo ranks x 4 images vs one process x 8, the same step: "
          f"{_ddp_close(torch, gloo[0]['compare'], one['compare'], '2 gloo ranks')}; "
          f"{_ddp_close_frozen(gloo[0]['frozen'], one['frozen'], '2 gloo ranks')}", flush=True)
    for name, runs in (("no group", [one]), ("world-1 NCCL", [nccl]), ("2 gloo ranks", gloo)):
        for r, run in enumerate(runs):
            t = run["timed"]
            check(t["k1"] == DDP_STEPS and t["k2"] == DDP_STEPS,
                  f"{name} rank {r}: expected {DDP_STEPS} K1 and K2 launches, got {t['k1']} and {t['k2']}")
            check(math.isfinite(t["total"]), f"{name} rank {r}: the loss is not finite")
    print(f"[ddp] {smi}: Base_Synth bf16, global batch 8 at 384x512, {DDP_STEPS} steps after {DDP_WARMUP}: "
          f"no group {one['timed']['ms']:.3f} ms an iteration; world-1 NCCL {nccl['timed']['ms']:.3f} ms "
          f"({nccl['timed']['collectives']:.1f} collectives a step, NCCL kernels "
          f"{nccl['timed']['collective_device_ms']:.3f} ms of {nccl['timed']['step_device_ms']:.3f} ms device time "
          f"in one step, {nccl['timed']['collective_kernels']} kernel names); 2 gloo ranks on the card, 4 images each: "
          f"{gloo[0]['timed']['ms']:.3f} / {gloo[1]['timed']['ms']:.3f} ms an iteration "
          f"({gloo[0]['timed']['collectives']:.1f} collectives a step); K1 and K2 {DDP_STEPS} launches each on "
          f"every rank; phase {time.perf_counter() - t0:.1f} s", flush=True)
    timed = [one["timed"], nccl["timed"], *(g["timed"] for g in gloo)]
    return {"k1": sum(t["k1"] for t in timed), "k2": sum(t["k2"] for t in timed),
            "ms": {"no_group": one["timed"]["ms"], "nccl_world1": nccl["timed"]["ms"],
                   "gloo_2_ranks": [g["timed"]["ms"] for g in gloo]},
            "collectives_a_step": nccl["timed"]["collectives"],
            "collective_device_ms_world1": nccl["timed"]["collective_device_ms"]}


# ---- phase 20: the other DLA trunks, oracle 2D boxes, the drawings, the demos, KITTI ----------

NEW_DLA = ("dla46_c", "dla46x_c", "dla60x_c", "dla60", "dla60x", "dla102", "dla102x", "dla169")
# the grouped 3x3 of dla102x's BottleneckX blocks at stride 1 (channels = groups x 4 .. 32), bs8 512x672
GROUPED_SHAPES = [(128, 128, 168), (256, 64, 84), (512, 32, 42), (1024, 16, 21)]
# K8 at the new trunks' FPN launch shapes (Cl, H, W, emit_cur; C = 256): the _c trunks' p3 and p4, dla60 and
# up's p2 to p4; p5 (16x21) has an odd width and stays stock. The last, Cl 1024 at 16x20, is no launch of
# the serving shape: it is the 1x1's 16 k-chunks through the ring of min(4, chunks) stages
DLA_FPN_SHAPES = [(64, 64, 84, True), (128, 32, 42, True), (128, 128, 168, False), (256, 64, 84, True),
                  (512, 32, 42, True), (1024, 16, 20, True)]


def _reset_launches():
    from threedod_torch.ops import fused_conv, roi_align_cuda

    roi_align_cuda.LAUNCHES = roi_align_cuda.BACKWARD_LAUNCHES = 0
    fused_conv.reset_launches()


def dla_trunk_forwards(torch, dev, smi: str) -> dict:
    """The stock bs8 512x672 bf16 serving forward of each new trunk under the
    FPN through ``threedod_torch.infer``: finite detections, ms a forward,
    trunk + FPN ms, peak memory, 2 K1 launches a forward and no fused kernel."""
    from threedod_torch import infer
    from threedod_torch.ops import fused_conv, roi_align_cuda

    out, k1 = {}, 0
    for name in NEW_DLA:
        cfg = infer.bench_config(backbone=name)
        model = infer.load_model(cfg, dev, seed=0)
        batch = infer.make_batch(cfg, infer.random_images(cfg, 8, seed=0), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        det = infer.predict(model, batch)
        ms = cuda_ms(lambda: infer.predict(model, batch), iters=3, warmup=1)
        launches = roi_align_cuda.LAUNCHES
        check(launches == 2 * 5, f"{name}: {launches} K1 launches in 5 forwards, expected 2 a forward")
        check(not any(fused_conv.LAUNCHES.values()), f"{name}: the stock forward launched a fused kernel")
        peak = torch.cuda.max_memory_allocated(dev)
        trunk_ms, _ = _stage_ms(torch, model, batch, 3)
        check(tuple(det.corners3d.shape) == (8, 100, 8, 3), f"{name}: corners {tuple(det.corners3d.shape)}")
        for k in ("boxes", "scores", "corners3d", "dimensions", "pose"):
            check(bool(torch.isfinite(getattr(det, k).float()).all()), f"{name}: {k} has non-finite values")
        # seeded residual roots (dla102, dla169) grow the features level by level, so most class scores
        # saturate into the background: the batch, not each image, must keep a detection
        n_valid = det.valid.sum(1).tolist()
        check(sum(n_valid) > 0, f"{name}: no image has a detection")
        params = sum(p.numel() for p in model.backbone.bottom_up.parameters())
        print(f"[dla] {smi}: {name} ({params / 1e6:.2f} M trunk parameters) stock bs8 512x672 bf16: {ms:.3f} ms a "
              f"forward, {8 * 1000.0 / ms:.2f} images/s, trunk + FPN {trunk_ms:.3f} ms, peak memory "
              f"{peak / 2 ** 30:.3f} GiB; valid detections per image {n_valid}", flush=True)
        out[name] = dict(ms=ms, trunk_fpn_ms=trunk_ms, peak_memory_bytes=peak)
        k1 += launches
        del model, batch, det
        torch.cuda.empty_cache()
    return dict(trunks=out, k1=k1)


def grouped_conv_report(torch, dev, smi: str) -> list:
    """cuDNN's grouped 3x3 (32 groups) of dla102x's bottlenecks against the
    dense 3x3 of the same shape, bf16 channels-last, bs8 512x672: ms each."""
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator().manual_seed(20)
    for c, h, w in GROUPED_SHAPES:
        x = torch.randn((8, c, h, w), generator=gen).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wg = torch.randn((c, c // 32, 3, 3), generator=gen).to(dev, torch.bfloat16)
        wd = torch.randn((c, c, 3, 3), generator=gen).to(dev, torch.bfloat16)
        with torch.no_grad():
            grouped = cuda_ms(lambda: F.conv2d(x, wg, padding=1, groups=32), iters=10, warmup=2)
            dense = cuda_ms(lambda: F.conv2d(x, wd, padding=1), iters=10, warmup=2)
        bytes_moved = 2 * 2 * x.numel()
        print(f"[dla] {smi}: grouped 3x3 C={c} {h}x{w} (32 groups) {grouped:.4f} ms "
              f"({bytes_moved / grouped / 1e6:.1f} GB/s of input and output), dense 3x3 of the same shape "
              f"{dense:.4f} ms", flush=True)
        rows.append(dict(shape=f"C={c} {h}x{w}", grouped_ms=grouped, dense_ms=dense))
    return rows


def dla_card_vs_cpu(torch, dev, smi: str) -> None:
    """dla46x_c and dla102x in f32 (TF32 off), 2 images at 128x160: the FPN
    levels on the card against the CPU within 1e-4 of each level's largest
    entry, and the detections' count."""
    import numpy as np

    from threedod_torch import infer
    from threedod_torch.data.batch import normalize_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("dla46x_c", "dla102x"):
        cfg = infer.bench_config(dtype="float32", backbone=name)
        cfg.shapes.canvas_height, cfg.shapes.canvas_width = 128, 160
        cpu_model = infer.load_model(cfg, torch.device("cpu"), seed=3)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        images = infer.random_images(cfg, 2, seed=3)
        feats = {}
        for side, model, device in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
            batch = infer.make_batch(cfg, images, device)
            with torch.inference_mode():
                x = normalize_image(batch.image, cfg.model, batch.image_hw).permute(0, 3, 1, 2)
                if device.type == "cuda":
                    x = x.contiguous(memory_format=torch.channels_last)
                feats[side] = {k: v.float().cpu().numpy() for k, v in model.backbone(x).items()}
                det = model(batch)
            check(bool(torch.isfinite(det.corners3d).all()), f"{name} {side}: non-finite corners")
        errs = {}
        for lvl, a in feats["cpu"].items():
            errs[lvl] = float(np.abs(a - feats["gpu"][lvl]).max() / np.abs(a).max())
            check(errs[lvl] <= 1e-4, f"{name}: FPN level {lvl} differs card vs CPU: {errs[lvl]}")
        print(f"[dla] {smi}: {name} f32 bs2 128x160 FPN levels card vs CPU, max err / largest entry: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (tol 1e-4)", flush=True)


def dla102x_fused(torch, dev, smi: str) -> dict:
    """dla102x's bf16 serving forward under ``fused_forward()``: K7 (5 a
    forward) and K8 (p2 to p4, 3 a forward) launch, K5 and K6 do not (its
    trees are BottleneckX), and the FPN levels and RPN logits stay within the
    fused-vs-stock phase's bf16 tolerance of the stock forward's."""
    import numpy as np

    from threedod_torch import infer
    from threedod_torch.ops import fused_conv, roi_align_cuda

    cfg = infer.bench_config(backbone="dla102x")
    model = infer.load_model(cfg, dev, seed=1)
    batch = infer.make_batch(cfg, infer.random_images(cfg, 8, seed=1), dev)
    fs, ls, _, _ = _forward_stages(torch, model, batch, fused=False)
    with fused_conv.fused_forward():
        infer.predict(model, batch)
        torch.cuda.synchronize()
        _reset_launches()
        det = infer.predict(model, batch)
        ms = cuda_ms(lambda: infer.predict(model, batch), iters=3, warmup=0)
        launches = {"roi_align_fwd": roi_align_cuda.LAUNCHES, **fused_conv.LAUNCHES}
    stock_ms = cuda_ms(lambda: infer.predict(model, batch), iters=3, warmup=1)
    want = {"roi_align_fwd": 2, "conv_relu_head": 5, "fpn_level": 3, "tree_tail": 0, "block_down": 0,
            "basic_block": 0}
    for k, n in want.items():
        check(launches[k] == 4 * n, f"dla102x fused: {launches[k]} launches of {k} in 4 forwards, expected {4 * n}")
    check(bool(torch.isfinite(det.corners3d.float()).all()), "dla102x fused: non-finite corners")
    ff, lf, _, _ = _forward_stages(torch, model, batch, fused=True)
    worst = 0.0
    for a, b in ((fs, ff), (ls, lf)):
        for lvl in a:
            worst = max(worst, float(np.abs(a[lvl] - b[lvl]).max() / np.abs(a[lvl]).max()))
    check(worst <= 2.0 ** -4, f"dla102x: fused and stock FPN levels or RPN logits differ by {worst}")
    print(f"[dla] {smi}: dla102x bs8 512x672 bf16 fused (K7, K8) {ms:.3f} ms a forward, stock {stock_ms:.3f} ms; "
          f"launches in 4 fused forwards {launches}; FPN levels and RPN logits fused vs stock max err / largest "
          f"entry {worst:.3e} (tol {2.0 ** -4:.3e})", flush=True)
    return dict(launches=launches, ms=ms, stock_ms=stock_ms)


def k8_dla_shapes(torch, dev, smi: str) -> list:
    """K8 against ``fpn_level_reference`` at ``DLA_FPN_SHAPES`` (bs8), f32 (TF32
    off) and bf16, with the call's and the plain chain's ms and the bound."""
    from threedod_torch.ops import fused_conv as fcv

    torch.backends.cudnn.allow_tf32 = False
    rows = []
    with torch.no_grad():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            act, weight, bias, _ = _seeded(torch, dev, dtype, seed=21)
            for cl, h, w, emit in DLA_FPN_SHAPES:
                args = (act(cl, h, w), act(256, h // 2, w // 2), weight(256, cl, 1), bias(256), weight(256, 256, 3),
                        bias(256))
                fused = lambda a=args, e=emit: fcv.fused_fpn_level(*a, emit_cur=e)  # noqa: E731
                plain = lambda a=args, e=emit: fcv.fpn_level_reference(*a)[: 2 if e else 1]  # noqa: E731
                out, ref = fused(), plain()
                outs = out if isinstance(out, tuple) else (out,)
                err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, ref))
                scale = max(r.float().abs().max().item() for r in ref)
                tol = TOL_FUSED[dtype_name] * scale
                check(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"K8 Cl={cl} {h}x{w}: non-finite")
                ms, plain_ms = cuda_ms(fused, iters=5, warmup=1), cuda_ms(plain, iters=5, warmup=1)
                macs = 8 * h * w * (cl * 256 + 9 * 256 * 256)
                bound, by = fused_bound_ms(list(args) + list(outs), macs, dtype_name)
                label = f"Cl={cl} {h}x{w} emit_cur={emit}"
                print(f"[K8 dla] {smi}: {dtype_name} {label}: max_abs_err={err:.3e} (tol {tol:.3e}), call "
                      f"{ms:.4f} ms, plain (cuDNN chain) {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
                check(err <= tol, f"K8 {dtype_name} {label} disagrees with its plain version: {err} > {tol}")
                rows.append(dict(shape=f"{dtype_name} {label}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by))
    return rows


def oracle_card_vs_cpu(torch, dev, smi: str) -> int:
    """DLA34 (Base_Synth in f32, TF32 off, seeded) with oracle 2D boxes on a
    synth_test batch, card against CPU: the ground-truth detections equal,
    the cube head's fields within the card-vs-CPU phase's tolerances; one K1
    launch a forward (the cube head's pool: no proposal is pooled). Returns
    the K1 launches."""
    import tempfile

    import numpy as np

    from threedod_torch import train_net
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.ops import roi_align_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = tempfile.mkdtemp(prefix="oracle_", dir=os.path.join(HERE, "build"))
    cfg, _, priors = train_net.setup(BASE_SYNTH, ["model.dtype", "float32", "output_dir", out])
    cpu_model = build_model(cfg, seed=4, priors=priors)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch, _ = next(iter(TestLoader(get_dataset_dicts(["synth_test"]), cfg, device=dev)))
    _reset_launches()
    with torch.inference_mode():
        card = gpu_model(batch, oracle=True)
        torch.cuda.synchronize()
        k1 = roi_align_cuda.LAUNCHES
        cpu = cpu_model(batch.to(torch.device("cpu")), oracle=True)
    check(k1 == 1, f"the oracle forward launched K1 {k1} times, expected once (the cube head's pool)")
    c, g = ({k: (v.float() if v.is_floating_point() else v).cpu().numpy() for k, v in d._asdict().items()}
            for d in (cpu, card))
    valid = c["valid"]
    check(valid.sum() > 0 and (valid == g["valid"]).all(), "oracle: valid slots differ card vs CPU")
    check((c["classes"] == g["classes"]).all() and (c["scores_2d"] == g["scores_2d"]).all(),
          "oracle: classes or 2D scores differ card vs CPU")
    np_err = float(np.abs(c["boxes"][valid] - g["boxes"][valid]).max())
    check(np_err <= 1e-4, f"oracle: boxes differ card vs CPU by {np_err}")
    errs = {}
    for field, atol in (("scores", 1e-4), ("center_cam", 1e-3), ("dimensions", 1e-4), ("pose", 1e-3),
                        ("corners3d", 2e-3)):
        a, b = c[field][valid], g[field][valid]
        errs[field] = float(np.max(np.abs(a - b) - 1e-3 * np.abs(a)))
        check(errs[field] <= atol, f"oracle: {field} differs card vs CPU: {errs[field]} > {atol}")
    print(f"[oracle] {smi}: DLA34 f32 oracle forward on synth_test's first image ({int(valid.sum())} ground-truth "
          f"boxes): card vs CPU, boxes {np_err:.2e}, cube fields (excess over 1e-3 relative) "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f"; {k1} K1 launch", flush=True)
    return k1


def _synth_test_folder(name: str) -> str:
    """A folder under build/ of links to synth_test's 20 JPEGs."""
    folder = os.path.join(HERE, "build", name)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        for im in json.load(f)["images"]:
            link = os.path.join(folder, os.path.basename(im["file_path"]))
            if not os.path.exists(link):
                os.symlink(os.path.join(HERE, "datasets", im["file_path"]), link)
    return folder


def demo_report(torch, dev, smi: str, checkpoint: str) -> dict:
    """``threedod_torch.demo`` over synth_test's 20 JPEGs with phase 14's
    checkpoint at the config's ``score_thresh_test``, at a threshold under
    the best score of every image that has a candidate (half the least of
    them), 10 detections an image: files written, detections, seconds, 2 K1
    launches an image; exactly the images with a candidate have a detection
    drawn, at least one does, every PNG re-reads to the array drawn, and the
    drawings are ``demo.draw_detections`` (the port's ``vis``) of the
    detections the card gave the tool."""
    from threedod_torch import demo
    from threedod_torch.config_yaml import load_config
    from threedod_torch.data.mapper import DatasetMapper3D
    from threedod_torch.infer import predict
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.ops import roi_align_cuda
    from threedod_torch.utils.model_zoo import load_model_weights
    from threedod_torch.vis import read_png

    folder, out_dir = _synth_test_folder("demo_in"), os.path.join(HERE, "build", "demo_out")
    opts = ["shapes.max_detections", "10"]
    cfg = load_config(BASE_SYNTH, opts)
    model = load_model_weights(checkpoint, build_model(cfg)).to(dev)
    mapper = DatasetMapper3D(cfg, is_train=False, device=dev)
    paths = demo.image_paths(folder)
    best = []  # each image's best candidate; None where none clears the config's score_thresh_test
    for p in paths:
        det = predict(model, demo.demo_batch(cfg, mapper, p, 2.0))
        scores = det.scores[0][det.valid[0]]
        best.append(float(scores.max()) if scores.numel() else None)
    has = [b is not None for b in best]
    # phase 14's 30 iterations on the card are not bit-reproducible (K2's atomics) and
    # can leave an image without a candidate: such an image must then be drawn empty
    check(any(has), "demo: no synth_test image has a candidate above the config's score_thresh_test")
    thresh = 0.5 * min(b for b in best if b is not None)
    del model
    drawn = []
    real = demo.draw_detections

    def recording(image, K, det, score_thresh):  # the card's detections and what the tool drew of them
        out = real(image, K, det, score_thresh)
        drawn.append(((image, K, det, score_thresh), out))
        return out

    demo.draw_detections = recording
    try:
        args = demo.parser().parse_args(["--config-file", BASE_SYNTH, "--input-folder", folder, "--output-dir",
                                         out_dir, "--checkpoint", checkpoint, "--score-thresh", str(thresh), *opts])
        _reset_launches()
        run = demo.run(args, dev)
        k1 = roi_align_cuda.LAUNCHES
    finally:
        demo.draw_detections = real
    check(run["images"] == 20 and len(run["files"]) == 60, f"demo: {run['images']} images, {len(run['files'])} files")
    check([n > 0 for n in run["detections"]] == has,
          f"demo: detections drawn {run['detections']}, where the images with a candidate are {has}")
    check(k1 == 40, f"demo: {k1} K1 launches over 20 images, expected 2 an image")
    for i, (path, (inputs, (front, novel, panel, _))) in enumerate(zip(paths, drawn)):
        stem = os.path.splitext(os.path.basename(path))[0]
        for suffix, want in (("_boxes", front), ("_novel", novel), ("", panel)):
            got = read_png(os.path.join(out_dir, f"{stem}{suffix}.png"))
            check(got.shape == want.shape and bool((got == want).all()), f"demo: {stem}{suffix}.png is not the drawing")
        if has[i]:
            check(bool((front != inputs[0]).any()), f"demo: nothing was drawn on {stem}")
        if i == 0:  # the port's vis applied anew to the card's detections draws the same
            again = real(*inputs)[:3]
            check(all(bool((a == b).all()) for a, b in zip(again, (front, novel, panel))),
                  f"demo: {stem}'s drawings differ from vis applied to its detections")
    print(f"[demo] {smi}: python -m threedod_torch.demo over synth_test's 20 JPEGs (phase 14's checkpoint, "
          f"threshold {thresh:.4f}): {len(run['files'])} PNG files, {sum(run['detections'])} detections drawn "
          f"({min(run['detections'])} to {max(run['detections'])} an image; {sum(has)} images have a candidate) "
          f"in {run['seconds']:.2f} s; {k1} K1 launches; every file re-reads to the array drawn, the drawings of the "
          "card's detections", flush=True)
    return dict(run, k1=k1, threshold=thresh)


def train_net_dla102x() -> dict:
    """``train_net`` on Base_Synth with dla102x, 20 iterations, ``vis_period``
    5 and its evaluation, in a process without Pillow, PyYAML or matplotlib:
    no step skipped, one K1 and one K2 launch a step, finite AP, and the
    drawings of synth_test's images 0, 5, 10 and 15."""
    import tempfile

    from threedod_torch.vis import read_png

    out = tempfile.mkdtemp(prefix="dla102x_", dir=os.path.join(HERE, "build"))
    run = train_net_blocked(["--config-file", BASE_SYNTH, "model.backbone", "dla102x", "solver.max_iter", "20",
                             "solver.checkpoint_period", "20", "vis_period", "5", "output_dir", out])
    steps = run["iterations"] - run["first_iteration"]
    check(run["steps"] == 20 and run["skipped"] == 0 and run["nonfinite_losses"] == 0, f"dla102x train_net: {run}")
    check(run["k1_launches_training"] == steps and run["k2_launches_training"] == steps,
          f"dla102x: expected one K1 and one K2 launch a step, got {run['k1_launches_training']} and "
          f"{run['k2_launches_training']} in {steps} steps")
    res = run["results"]["synth_test"]
    check(all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")), f"dla102x results: {res}")
    vis = os.path.join(out, "synth_test", "vis")
    names = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
    check(names == ["000000.png", "000005.png", "000010.png", "000015.png"], f"dla102x vis_period 5 drew {names}")
    shape = read_png(os.path.join(vis, names[0])).shape
    print(f"[dla] {run['device']}: train_net Base_Synth dla102x iterations {run['first_iteration']}.."
          f"{run['iterations'] - 1}, bs8 384x512 bf16: {run['ms_per_iteration']:.3f} ms an iteration "
          f"({run['steps_timed']} after 10), loader {100 * run['loader_share']:.2f} %, peak memory "
          f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB; K1 {run['k1_launches_training']} and K2 "
          f"{run['k2_launches_training']} in training, K1 {run['k1_launches_eval']} in evaluating; AP2D "
          f"{res['AP2D']:.4f} AP3D {res['AP3D']:.4f}; vis_period 5 drew {names} ({shape})", flush=True)
    return run


def eval_boxes_vis() -> dict:
    """``eval_boxes`` AP (GT boxes) on BoxNet_Synth with ``vis_period`` 5, in a
    process without Pillow, PyYAML or matplotlib: finite AP and the drawings
    of synth_test's images 0, 5, 10 and 15."""
    import tempfile

    root = tempfile.mkdtemp(prefix="boxnet_vis_", dir=os.path.join(HERE, "build"))
    os.makedirs(os.path.join(root, "Omni3D"))
    for name in ("synth_train", "synth_test"):
        os.symlink(os.path.join(HERE, "datasets", "Omni3D", f"{name}.json"), os.path.join(root, "Omni3D", f"{name}.json"))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(os.path.join(HERE, "datasets", name), os.path.join(root, name))
    run = eval_boxes_blocked(["--config-file", BOXNET_SYNTH, "plot.eval", "AP", "plot.mode2d", "GT", "vis_period",
                              "5", "datasets.root", root, "output_dir", os.path.join(root, "eval")])
    ap = run["results"]["synth_test"]
    check(all(math.isfinite(ap[k]) for k in ("AP2D", "AP3D")), f"eval_boxes AP with vis_period: {ap}")
    vis = os.path.join(root, "eval", "synth_test", "vis")
    names = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
    check(names == ["000000.png", "000005.png", "000010.png", "000015.png"], f"eval_boxes vis_period 5 drew {names}")
    print(f"[boxnet-vis] {run['device']}: eval_boxes AP GT over synth_test with vis_period 5: {run['seconds']:.3f} s, "
          f"AP2D {ap['AP2D']:.4f} AP3D {ap['AP3D']:.4f}, drew {names}", flush=True)
    return run


def kitti_report(torch, dev, smi: str, checkpoint: str, threshold: float) -> dict:
    """``threedod_torch.kitti_demo --display`` on synth_test with phase 14's
    checkpoint; its predictions JSON exported as KITTI label files beside
    the exported ground truth, then ``overwrite_pred_z_dir``: the z of every
    prediction a ground-truth box overlaps at IoU 0.7 is that box's, a second
    pass changes nothing."""
    import shutil

    import numpy as np

    from threedod_torch import kitti_demo
    from threedod_torch.data import kitti
    from threedod_torch.data.build import get_dataset_dicts
    from threedod_torch.data.omni3d import CATALOG
    from threedod_torch.ops import roi_align_cuda
    from threedod_torch.vis import read_png

    out_dir = os.path.join(HERE, "build", "kitti_demo")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = kitti_demo.parser().parse_args(["--config-file", BASE_SYNTH, "--dataset", "synth_test", "--checkpoint",
                                           checkpoint, "--threshold", str(threshold), "--display", "--output-dir",
                                           out_dir, "shapes.max_detections", "10", "output_dir",
                                           os.path.join(out_dir, "setup")])
    _reset_launches()
    run = kitti_demo.run(args, dev)
    k1 = roi_align_cuda.LAUNCHES
    with open(run["predictions_json"]) as f:
        data = json.load(f)
    check(len(data) == 20 and run["detections"] > 0, f"kitti_demo: {len(data)} images, {run['detections']} detections")
    check(k1 == 40, f"kitti_demo: {k1} K1 launches over 20 images, expected 2 an image")
    with_dets = [e for e in data if e["predictions"]]
    check(len(run["drawn"]) == len(with_dets) > 0, f"kitti_demo --display drew {len(run['drawn'])} of {len(with_dets)}")
    for e, name in zip(with_dets, run["drawn"]):
        h, w = e["height"], e["width"]
        check(read_png(os.path.join(out_dir, name)).shape == (h, w + h, 3), f"kitti_demo: {name} has another shape")
    records = get_dataset_dicts(["synth_test"])
    cats = list(CATALOG.metadata("omni3d_model").thing_classes)
    names = dict(enumerate(cats))
    preds = []
    for e in data:
        for p in e["predictions"]:
            x1, y1, x2, y2 = p["bbox"]
            preds.append({"image_id": e["image_id"], "category_id": cats.index(p["category"]),
                          "bbox": [x1, y1, x2 - x1, y2 - y1], "dimensions": p["dimensions"],
                          "center_cam": p["center_cam"], "pose": p["pose"], "score": p["score"]})
    pred_dir, gt_dir = os.path.join(out_dir, "kitti_pred"), os.path.join(out_dir, "kitti_gt")
    kitti.export_predictions_to_kitti(preds, names, pred_dir)
    kitti.export_gt_to_kitti(records, names, gt_dir)
    before = {n: open(os.path.join(pred_dir, n)).read().splitlines() for n in sorted(os.listdir(pred_dir))}
    rewritten = kitti.overwrite_pred_z_dir(pred_dir, gt_dir, 0.7)
    overwritten = 0
    for n, lines in before.items():
        after = open(os.path.join(pred_dir, n)).read().splitlines()
        gt = open(os.path.join(gt_dir, n)).read().splitlines()
        check([d.split() for d in kitti.overwrite_pred_z(lines, gt)] == [a.split() for a in after],
              f"overwrite_pred_z_dir wrote {n} otherwise than overwrite_pred_z")
        gz = {g.split()[13] for g in gt}
        overwritten += sum(a.split()[13] != b.split()[13] and a.split()[13] in gz for a, b in zip(after, lines))
    check(kitti.overwrite_pred_z_dir(pred_dir, gt_dir, 0.7) == 0, "a second z overwrite changed files")
    # the ground truth itself as predictions 1 m too far: the overwrite gives every line its z back
    moved_dir = os.path.join(out_dir, "kitti_moved")
    os.makedirs(moved_dir, exist_ok=True)
    lines_gt = 0
    for n in os.listdir(gt_dir):
        gt = open(os.path.join(gt_dir, n)).read().splitlines()
        lines_gt += len(gt)
        with open(os.path.join(moved_dir, n), "w") as f:
            f.writelines(" ".join(g.split()[:13] + [f"{float(g.split()[13]) + 1.0:.2f}"] + g.split()[14:] + ["1.0"])
                         + "\n" for g in gt)
    moved = kitti.overwrite_pred_z_dir(moved_dir, gt_dir, 0.7)
    for n in os.listdir(gt_dir):
        got = [d.split()[13] for d in open(os.path.join(moved_dir, n)).read().splitlines()]
        gt = [g.split() for g in open(os.path.join(gt_dir, n)).read().splitlines()]
        boxes = np.array([[float(v) for v in g[4:8]] for g in gt])
        iou = kitti._iou_matrix_xyxy(boxes, boxes)  # each line takes the z of the last box at IoU >= 0.7
        want = [gt[int(np.nonzero(row >= 0.7)[0][-1])][13] for row in iou]
        check(got == want, f"the z overwrite gave {n}'s moved ground truth {got}, not {want}")
    print(f"[kitti] {smi}: python -m threedod_torch.kitti_demo --display on synth_test (threshold {threshold:.4f}): "
          f"{run['detections']} detections in {len(data)} images, {len(run['drawn'])} scene views drawn, "
          f"{run['seconds']:.2f} s, {k1} K1 launches; KITTI export: {len(preds)} prediction lines in "
          f"{len(before)} files beside {len(os.listdir(gt_dir))} ground-truth files; overwrite_pred_z_dir rewrote "
          f"{rewritten} files, {overwritten} predictions took a ground truth's z; the {lines_gt} ground-truth lines "
          f"moved 1 m back took their z back in {moved} files", flush=True)
    return dict(run, k1=k1)


def phase_dla_and_drawings(torch, dev, checkpoint: str) -> dict:
    """Phase 20: the eight other DLA trunks at bs8 512x672 bf16 (ms, peak
    memory), cuDNN's grouped 3x3, dla46x_c and dla102x card vs CPU, dla102x
    fused (K7, K8), K8 at the new trunks' FPN shapes, oracle 2D boxes card vs
    CPU, the demo over synth_test, train_net on dla102x with vis_period,
    eval_boxes AP with vis_period, kitti_demo and the KITTI tools. Returns
    the K1, K2, K7 and K8 launches and K8's rows."""
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    trunks = dla_trunk_forwards(torch, dev, smi)
    grouped = grouped_conv_report(torch, dev, smi)
    dla_card_vs_cpu(torch, dev, smi)
    fused = dla102x_fused(torch, dev, smi)
    k8_rows = k8_dla_shapes(torch, dev, smi)
    k1_oracle = oracle_card_vs_cpu(torch, dev, smi)
    demo = demo_report(torch, dev, smi, checkpoint)
    train = train_net_dla102x()
    boxes = eval_boxes_vis()
    kitti = kitti_report(torch, dev, smi, checkpoint, demo["threshold"])
    seconds = time.perf_counter() - t0
    print(f"[dla] phase 20 took {seconds:.1f} s", flush=True)
    k1 = (trunks["k1"] + fused["launches"]["roi_align_fwd"] + k1_oracle + demo["k1"] + kitti["k1"]
          + train["k1_launches_training"] + train["k1_launches_eval"] + boxes["k1_launches"])
    return dict(k1=k1, k2=train["k2_launches_training"], k7=fused["launches"]["conv_relu_head"],
                k8=fused["launches"]["fpn_level"], k8_rows=k8_rows, trunks=trunks["trunks"], grouped=grouped,
                seconds=seconds, kitti_json=kitti["predictions_json"], kitti_threshold=demo["threshold"])


# phase 21: PNG decoding on the card, the official checkpoints' loader and the
# rest of the user tools
# (rows, columns): one pixel; Adam7 passes without rows; odd sizes over two
# bands; KITTI's image_2 (12 bands); 66 bands of a narrow image
PNG_SIZES = ((1, 1), (3, 5), (37, 53), (375, 1242), (2100, 37))
PNG_ROOT = os.path.join(HERE, "build", "png_root")
PNG_ROOT_ADAM7 = os.path.join(HERE, "build", "png_root_adam7")


def png_bound_ms(filtered_bytes: int, rgb_bytes: int) -> float:
    """Least card time of the PNG kernel by bytes: the filtered scanlines
    read once, the RGB written once, at the memory rate."""
    return (filtered_bytes + rgb_bytes) / PEAK_BYTES * 1e3


def png_dependence_bound_ms(filter_types, units: int, latency: dict) -> float:
    """Least card time of the PNG kernel by its dependence chain: the longest
    path through a plane of ``units`` units a row with these rows' filter
    types (``png.dependence_path_ns``), each step at the latency of its
    filter's chain along a row (no shuffle: the left unit is the lane's own)
    or down a column (a shuffle), as the card runs them fastest
    (``png.step_latency_ns``)."""
    from threedod_torch.ops import png

    return png.dependence_path_ns(filter_types, units, latency) * 1e-6


def png_pixels(np, rgb, color_type: int, rng):
    """(pixels, palette) of one colour type made from an RGB image: gray by
    integer luma, a random alpha, palette indices of a 3-3-2 bit colour cube
    under a 200-entry palette (indices 200 to 255 lie past it: black)."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    gray = ((r * 299 + g * 587 + b * 114) // 1000).astype(np.uint8)
    alpha = rng.randint(0, 256, rgb.shape[:2]).astype(np.uint8)
    if color_type == 0:
        return gray, None
    if color_type == 4:
        return np.stack([gray, alpha], -1), None
    if color_type == 6:
        return np.concatenate([rgb, alpha[..., None]], -1), None
    if color_type == 3:
        idx = (rgb[..., 0] >> 5 << 5) | (rgb[..., 1] >> 5 << 2) | (rgb[..., 2] >> 6)
        return idx.astype(np.uint8), rng.randint(0, 256, (200, 3)).astype(np.uint8)
    return rgb, None


def png_kind_file(np, png, rgb, color_type: int, depth: int, interlace: bool, rng) -> bytes:
    """A PNG of one (colour type, bit depth, interlace) made from an RGB image
    (``png_pixels`` at 8 bits; below 8 the samples' top bits, a palette of
    2^depth entries; at 16 each sample times 257 plus noise in the low byte),
    a random filter a row."""
    pixels, palette = png_pixels(np, rgb, color_type, rng)
    pixels = pixels.reshape(*rgb.shape[:2], -1)
    if depth < 8:
        pixels = pixels >> (8 - depth)
        palette = None if palette is None else palette[:1 << depth]
    elif depth == 16:
        pixels = pixels.astype(np.uint16) * 257 + rng.randint(0, 2, pixels.shape).astype(np.uint16)
    h, w = rgb.shape[:2]
    rows = sum(q.height for q in png.Png(w, h, color_type, depth, int(interlace), None, b"").passes())
    return png.encode_png(pixels, color_type, rng.randint(0, 5, rows), palette, level=1, bit_depth=depth,
                          interlace=interlace)


def png_gate(torch, dev, smi: str) -> dict:
    """The PNG kernel against its plain version, 0 levels, on every colour
    type at every bit depth it allows, interlaced (Adam7) and not, at each of
    ``PNG_SIZES`` (a fixture image tiled), and on each filter forced on every
    row at 1242x375 RGB; then its times at 1242x375 RGB with a random filter a
    row: the kernel's device time, its call on the card's input, the whole
    ``decode_png`` call (host inflate and layout included), the plain version
    on the host, the Adam7 file's device time, and the bounds by bytes and by
    the dependence chain of this file's filters (``png_dependence_bound_ms``;
    beside it the chain of a file of Paeth rows, W row steps and H - 1 hops).
    Returns the kernels line's row."""
    import numpy as np

    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import png

    rng = np.random.RandomState(21)
    src = imread_rgb(os.path.join(HERE, "datasets", "synth", "images", "000001.jpg"), dev).cpu().numpy()
    kinds = [(ct, d, inter) for ct, depths in png.DEPTHS.items() for d in depths for inter in (False, True)]

    def tiled(h, w):
        return np.tile(src, (-(-h // src.shape[0]), -(-w // src.shape[1]), 1))[:h, :w]

    def gate(data, what):
        p = png.parse(data)
        planes = png.inflate(p)
        got = png.decode_png(data, dev).cpu()
        want = png.decode_reference(planes, p)
        err = int((got.int() - want.int()).abs().max())
        check(got.shape == want.shape and err == 0, f"PNG kernel vs plain on {what}: {err} levels")
        return err

    cases, worst, t0 = 0, 0, time.perf_counter()
    for h, w in PNG_SIZES:
        base = tiled(h, w)
        for ct, d, inter in kinds:
            name = f"{w}x{h} {png.COLOR_NAMES[ct]} {d}-bit{' Adam7' if inter else ''}"
            worst, cases = max(worst, gate(png_kind_file(np, png, base, ct, d, inter, rng), name)), cases + 1
    h, w = 375, 1242
    base = tiled(h, w)
    for filt in range(5):
        worst, cases = max(worst, gate(png.encode_png(base, 2, filt, level=1), f"{w}x{h} RGB filter {filt}")), cases + 1
    gate_s = time.perf_counter() - t0
    data = png.encode_png(base, 2, rng.randint(0, 5, h))
    p = png.parse(data)
    planes = png.inflate(p)
    lay = png.layout(p, planes)
    buf = torch.from_numpy(lay.buf).to(dev)
    call_ms = cuda_ms(lambda: png.unfilter_rgb_cuda(buf, lay, p), iters=20)
    kernel_ms = device_ms(torch, lambda: png.unfilter_rgb_cuda(buf, lay, p), 10, {"k": "png_decode_kernel"})["k"]
    decode_ms = cuda_ms(lambda: png.decode_png(data, dev), iters=10)
    t1 = time.perf_counter()
    for _ in range(3):
        png.decode_reference(planes, p)
    plain_ms = (time.perf_counter() - t1) / 3 * 1e3
    adam7 = png.encode_png(base, 2, rng.randint(0, 5, sum(q.height for q in png.Png(w, h, 2, 8, 1, None, b"").passes())),
                           interlace=True)
    pa = png.parse(adam7)
    lay_a = png.layout(pa, png.inflate(pa))
    buf_a = torch.from_numpy(lay_a.buf).to(dev)
    adam7_ms = device_ms(torch, lambda: png.unfilter_rgb_cuda(buf_a, lay_a, pa), 10, {"k": "png_decode_kernel"})["k"]
    lat = png.step_latency_ns(dev)
    by_bytes = png_bound_ms(sum(f.nbytes for f in planes), h * w * 3)
    by_chain = png_dependence_bound_ms(planes[0][:, 0], w, lat)
    all_paeth = png_dependence_bound_ms(np.full(h, 4), w, lat)
    row_ns, hop_ns = ("/".join(f"{lat[k][f]:.3f}" for f in fs) for k, fs in (("row", png.ROW_FILTERS),
                                                                              ("hop", png.HOP_FILTERS)))
    print(f"[png] {smi}: kernel vs plain on {cases} files ({len(kinds)} colour type, depth and interlace kinds at "
          f"{len(PNG_SIZES)} sizes, 1x1 to 1242x375 and 2100 rows; each filter forced at 1242x375 RGB): largest "
          f"difference {worst} levels, {gate_s:.1f} s; at 1242x375 RGB, a random filter a row: kernel (device) "
          f"{kernel_ms:.4f} ms ({lay.bands} CTAs, a warp a band of 32 rows of a channel), call {call_ms:.4f} ms, the "
          f"whole decode_png {decode_ms:.3f} ms (host inflate and layout included), plain (host numpy) {plain_ms:.2f} "
          f"ms, Adam7 kernel (device) {adam7_ms:.4f} ms; bound {max(by_bytes, by_chain):.5f} ms: the dependence chain "
          f"of this file's filters {by_chain:.5f} ms (a step along a row, Sub/Average/Paeth {row_ns} ns; down a "
          f"column, Up/Average/Paeth {hop_ns} ns; every row Paeth: {w} x "
          f"{lat['row'][4]:.3f} + {h - 1} x {lat['hop'][4]:.3f} ns = {all_paeth:.5f} ms), bytes {by_bytes:.5f} ms",
          flush=True)
    return dict(max_abs_err=float(worst), ms=call_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(by_bytes, by_chain), bound_by="operations" if by_chain >= by_bytes else "bytes",
                dependence_bound_ms=by_chain, all_paeth_bound_ms=all_paeth, bytes_bound_ms=by_bytes,
                step_latency_ns=lat, library_ms=None, decode_png_ms=decode_ms, adam7_kernel_ms=adam7_ms,
                shape="1242x375 RGB, mixed filters")


# whole fixture images re-saved progressive: (image, subsampling, restart
# option, mode, quality, noise sigma), as tests/test_torch_jpeg.py's FULL_SIZE
PROGRESSIVE_FULL_SIZE = (
    ("000001.jpg", 2, {}, "RGB", 75, 0), ("000017.jpg", 2, {"restart_marker_rows": 1}, "RGB", 90, 0),
    ("000033.jpg", 0, {}, "RGB", 95, 0), ("000050.jpg", 0, {"restart_marker_blocks": 37}, "RGB", 75, 0),
    ("000071.jpg", 1, {"restart_marker_blocks": 5}, "RGB", 85, 0), ("000088.jpg", 2, {}, "L", 75, 0),
    ("000040.jpg", 2, {"restart_marker_blocks": 3}, "RGB", 90, 12))


def progressive_gate(torch, dev, smi: str) -> dict:
    """Progressive JPEGs (SOF2) that Pillow writes from fixture crops, at
    4:4:4, 4:2:2 and 4:2:0 with restart markers and gray, at 61x45, 37x53,
    17x9 and 1x1, and from whole 640x480 fixture images
    (``PROGRESSIVE_FULL_SIZE``: 4:4:4, 4:2:2, 4:2:0 and gray, with and
    without restart markers, one with seeded noise): the host's coefficients
    through the card's IDCT and colour kernels, each against its plain
    version and the RGB against Pillow, 0 levels (``_decode_gate``), and
    ``decode_jpeg`` equal to it; the whole files also through ``imread_rgb``
    from a file, and the host Huffman decode's ms of each beside that of the
    same image written sequential with the same settings."""
    import io

    import numpy as np
    from PIL import Image

    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import jpeg

    path = os.path.join(HERE, "datasets", "synth", "images", "000004.jpg")
    stats, n, t0 = {}, 0, time.perf_counter()
    for w, h in ((61, 45), (37, 53), (17, 9), (1, 1)):
        for name, subsampling, restart, mode in JPEG_ENCODINGS:
            with Image.open(path) as im:
                img = im.convert(mode).crop((3, 5, 3 + w, 5 + h))
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=90, subsampling=subsampling, progressive=True,
                     **({"restart_marker_blocks": restart} if restart else {}))
            data = buf.getvalue()
            check(b"\xff\xc2" in data, f"Pillow wrote the {name} {w}x{h} file without a progressive frame")
            _, rgb = _decode_gate(torch, np, jpeg, Image, f"progressive {name} {w}x{h}", data,
                                  jpeg.decode_coefficients(data), dev, stats)
            check(torch.equal(jpeg.decode_jpeg(data, dev), rgb), f"decode_jpeg differs on progressive {name} {w}x{h}")
            n += 1
    folder = os.path.join(HERE, "build", "progressive_jpeg")
    os.makedirs(folder, exist_ok=True)
    huffman = []
    for source, subsampling, restart, mode, quality, noise in PROGRESSIVE_FULL_SIZE:
        with Image.open(os.path.join(HERE, "datasets", "synth", "images", source)) as im:
            img = im.convert(mode)
        if noise:
            px = np.asarray(img).astype(np.float64)
            px += np.random.RandomState(21).normal(0, noise, px.shape)
            img = Image.fromarray(np.clip(px, 0, 255).astype(np.uint8))
        files = {}
        for progressive in (True, False):
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=quality, subsampling=subsampling, progressive=progressive, **restart)
            files[progressive] = buf.getvalue()
        data = files[True]
        name = f"{source} {mode} subsampling {subsampling} q{quality} {restart or 'no restarts'} noise {noise}"
        check(b"\xff\xc2" in data and (b"\xff\xd0" in data) == bool(restart),
              f"Pillow wrote {name} without a progressive frame or with the wrong restart markers")
        _, rgb = _decode_gate(torch, np, jpeg, Image, f"progressive {name}", data, jpeg.decode_coefficients(data),
                              dev, stats)
        file = os.path.join(folder, f"{len(huffman)}.jpg")
        with open(file, "wb") as f:
            f.write(data)
        got = imread_rgb(file, dev)
        check(got.is_cuda and torch.equal(got, rgb), f"imread_rgb differs on progressive {name}")
        ms = []
        for progressive in (True, False):
            jpeg.decode_coefficients(files[progressive])
            t1 = time.perf_counter()
            for _ in range(5):
                jpeg.decode_coefficients(files[progressive])
            ms.append((time.perf_counter() - t1) / 5 * 1e3)
        huffman.append((name, len(data), *ms))
        n += 1
    check(all(c == 0 for c, _, _ in stats.values()), f"the progressive decode differs: {stats}")
    print(f"[jpeg-progressive] {smi}: {n} progressive JPEGs (4:4:4, 4:2:2 and 4:2:0 with restart markers, gray; "
          f"61x45, 37x53, 17x9, 1x1; and {len(huffman)} whole 640x480 images, also through imread_rgb): the IDCT "
          f"and colour kernels equal to their plain versions on the host's coefficients and the RGB to Pillow's, 0 "
          f"levels; {time.perf_counter() - t0:.1f} s; host Huffman decode (ms), progressive / the same image "
          f"sequential: " + "; ".join(f"{nm} ({size} bytes) {p:.3f} / {s:.3f}" for nm, size, p, s in huffman),
          flush=True)
    return dict(files=n, huffman_ms=huffman)


def colour_files(np, Image, path: str, box) -> list:
    """[(name, bytes)] of the colour spaces and samplings Pillow's default
    files lack, cut from the fixture image ``path`` (``box``: a crop, or
    None for the whole image): RGB-coded (Adobe marker; IDs R, G, B without
    a marker), CMYK and YCCK (Pillow's CMYK file with the Adobe transform
    set to 2), and written by ``tools/jpeg_writer.py`` from the image's
    YCbCr: 4:1:1, 4:4:0, 4x2 luma over 1x1 chroma, one scan per component
    with restart markers; and a 4:2:2 file 4 columns wide (chroma planes 2
    columns wide)."""
    import io

    from threedod_torch.tools import jpeg_writer

    with Image.open(path) as im:
        rgb = im.convert("RGB") if box is None else im.convert("RGB").crop(box)

    def pillow(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90, **kw)
        return buf.getvalue()

    def segment(data, marker):  # (start, end) of the first segment with this marker
        pos = 2
        while data[pos + 1] != marker:
            pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        return pos, pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")

    keep = pillow(rgb, keep_rgb=True)
    a, b = segment(keep, 0xEE)
    cmyk = pillow(rgb.convert("CMYK"))
    t = segment(cmyk, 0xEE)[0] + 4 + 11  # the Adobe transform byte
    ycc = jpeg_writer.rgb_to_ycc(np.asarray(rgb))
    w, h = rgb.size
    out = [("rgb_adobe", keep), ("rgb_ids", keep[:a] + keep[b:]), ("cmyk", cmyk),
           ("ycck", cmyk[:t] + b"\x02" + cmyk[t + 1:])]
    for name, factors, kw in (("411", [(4, 1), (1, 1), (1, 1)], {}), ("440", [(1, 2), (1, 1), (1, 1)], {}),
                              ("4x2_1x1", [(4, 2), (1, 1), (1, 1)], {}),
                              ("420_non_interleaved", [(2, 2), (1, 1), (1, 1)], {"interleaved": False, "restart": 5})):
        out.append((name, jpeg_writer.encode_jpeg(w, h, jpeg_writer.image_blocks(ycc, factors), factors, jfif=True,
                                                  **kw)))
    return out + [("422_chroma_2_wide", pillow(rgb.crop((0, 0, min(w, 4), h)), subsampling=1))]


def colour_gate(torch, dev, smi: str, checkpoint: str) -> dict:
    """RGB-coded, CMYK and YCCK JPEGs and every sampling (``colour_files``)
    at 61x45, 1x1 and a whole 640x480 fixture image: the host's
    coefficients through the IDCT and colour kernels, each against its plain
    version, the RGB against Pillow's (``_decode_gate``), ``decode_jpeg`` and
    ``imread_rgb`` equal to it, 0 levels; the colour kernel's device ms
    (``torch.profiler``) and call ms on a fixture 640x480 4:2:0 file, its
    CMYK and its 4:1:1 rewriting beside the bytes bound; then ``python -m
    threedod_torch.demo`` over four synth_test images rewritten RGB-coded,
    CMYK, 4:1:1 and 4:4:0 (2 K1 launches and 2 reads an image, each an IDCT
    and a colour launch, counted from zero around the run). Returns the
    colour kernel's rows and the demo's JPEG launches."""
    import io

    import numpy as np
    from PIL import Image

    from threedod_torch import demo
    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import jpeg, roi_align_cuda
    from threedod_torch.tools import jpeg_writer

    t0 = time.perf_counter()
    images = os.path.join(HERE, "datasets", "synth", "images")
    folder = os.path.join(HERE, "build", "colour_jpeg")
    os.makedirs(folder, exist_ok=True)
    stats, n, whole = {}, 0, {}
    for size, path, box in (("61x45", "000004.jpg", (3, 5, 64, 50)), ("1x1", "000004.jpg", (3, 5, 4, 6)),
                            ("640x480", "000010.jpg", None)):
        for name, data in colour_files(np, Image, os.path.join(images, path), box):
            what = f"{name} {size}"
            c = jpeg.decode_coefficients(data)
            _, rgb = _decode_gate(torch, np, jpeg, Image, what, data, c, dev, stats)
            check(torch.equal(jpeg.decode_jpeg(data, dev), rgb), f"decode_jpeg differs from the kernels on {what}")
            file = os.path.join(folder, f"{name}_{size}.jpg")
            with open(file, "wb") as f:
                f.write(data)
            check(torch.equal(imread_rgb(file, dev), rgb), f"imread_rgb differs from the kernels on {what}")
            if size == "640x480":
                whole[name] = (data, c)
            n += 1
    check(all(k == 0 for k, _, _ in stats.values()), f"the colour decode differs: {stats}")
    with open(os.path.join(images, "000010.jpg"), "rb") as f:
        fixture = f.read()
    rows = []
    for name, (data, c) in (("640x480 4:2:0 (fixture)", (fixture, jpeg.decode_coefficients(fixture))),
                            ("640x480 CMYK", whole["cmyk"]), ("640x480 4:1:1", whole["411"])):
        planes = jpeg.planes_cuda(c, dev)
        kernel_ms = device_ms(torch, lambda: jpeg.color_cuda(planes, c), 20, {"k": "color_kernel"})["k"]
        call_ms = cuda_ms(lambda: jpeg.color_cuda(planes, c), iters=50)
        plain_ms = cuda_ms(lambda: jpeg.color_reference(planes, c), iters=5)
        plane_bytes = sum(p.numel() for p in planes)
        bound = (plane_bytes + 3 * c.width * c.height) / PEAK_BYTES * 1e3
        rows.append(dict(shape=name, kernel_ms=kernel_ms, ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes", max_abs_err=0.0))
        print(f"[jpeg-colour] {smi}: colour kernel at {name}: device {kernel_ms:.4f} ms, call {call_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms by bytes ({plane_bytes} bytes of planes in, "
              f"{3 * c.width * c.height} of RGB out)", flush=True)
    # the demo over four synth_test images rewritten in the new encodings
    demo_in, demo_out = os.path.join(HERE, "build", "demo_colour_in"), os.path.join(HERE, "build", "demo_colour_out")
    os.makedirs(demo_in, exist_ok=True)
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        sources = [os.path.join(HERE, "datasets", im["file_path"]) for im in json.load(f)["images"][:4]]
    kinds = ("rgb_adobe", "cmyk", "411", "440")
    for k, (kind, source) in enumerate(zip(kinds, sources)):
        data = dict(colour_files(np, Image, source, None))[kind]
        with open(os.path.join(demo_in, f"{k}_{kind}.jpg"), "wb") as f:
            f.write(data)
    args = demo.parser().parse_args(["--config-file", BASE_SYNTH, "--input-folder", demo_in, "--output-dir", demo_out,
                                     "--checkpoint", checkpoint, "shapes.max_detections", "10"])
    _reset_launches()
    jpeg.LAUNCHES_IDCT = jpeg.LAUNCHES_COLOR = 0
    run = demo.run(args, dev)
    k1, idct, color = roi_align_cuda.LAUNCHES, jpeg.LAUNCHES_IDCT, jpeg.LAUNCHES_COLOR
    check(run["images"] == 4 and len(run["files"]) == 12, f"demo on the rewritten images: {run['images']} images, "
                                                          f"{len(run['files'])} files")
    check(k1 == 8 and idct == color == 8, f"demo on the rewritten images: {k1} K1, {idct} IDCT and {color} colour "
                                          "launches over 4 images, expected 8 each (2 an image)")
    for k, kind in enumerate(kinds):
        path = os.path.join(demo_in, f"{k}_{kind}.jpg")
        with Image.open(path) as im:
            check(np.array_equal(imread_rgb(path, dev).cpu().numpy(), np.asarray(im.convert("RGB"))),
                  f"the demo's {kind} image differs from Pillow's")
    seconds = time.perf_counter() - t0
    print(f"[jpeg-colour] {smi}: {n} files (RGB-coded with and without the Adobe marker, CMYK, YCCK, 4:1:1, 4:4:0, "
          f"4x2 over 1x1, one scan per component, chroma 2 columns wide; 61x45, 1x1, 640x480): the IDCT and colour "
          f"kernels equal to their plain versions and the RGB, decode_jpeg and imread_rgb to Pillow's, 0 levels; "
          f"python -m threedod_torch.demo over 4 synth_test images rewritten {', '.join(kinds)}: "
          f"{sum(run['detections'])} detections in {run['seconds']:.2f} s, {k1} K1, {idct} IDCT and {color} colour "
          f"launches; {seconds:.1f} s", flush=True)
    return dict(rows=rows, idct=idct, color=color, files=n, seconds=seconds)


# the DAC conditioning of the arithmetic files: DC (L, U) (1, 3) and (2, 5), AC Kx 2 and 20
ENTROPY_DAC = {(0, 0): 0x31, (0, 1): 0x52, (1, 0): 2, (1, 1): 20}


def entropy_files(np, Image, images: str) -> list:
    """[(name, bytes)] of the entropy half of libjpeg that Huffman-coded DCT
    files do not use (a transcode: (name, bytes, the Huffman file's bytes)),
    written by ``tools/jpeg_writer.py``: arithmetic
    sequential (SOF9) and progressive (SOF10, libjpeg's simple progression)
    files of the DCT of seeded pixels at 61x45 and 1x1 (4:2:0 with a JFIF
    marker, 4:4:4 with DAC conditioning and restart markers, gray); two
    whole 640x480 fixture images made arithmetic with their own scans
    (``transcode_arithmetic``: the fixture file as it is, and one written
    progressive by Pillow with DAC conditioning and a restart marker every
    40 MCUs); lossless (SOF3) gray, RGB and CMYK files of a 61x45 fixture
    crop, each with predictors 1 to 7 (point transform 0 or 2, restart
    markers, one scan a component on the last), and one whole 640x480
    fixture image lossless RGB."""
    import io

    from threedod_torch.ops import jpeg
    from threedod_torch.tools import jpeg_writer

    out = []
    for w, h in ((61, 45), (1, 1)):
        for name, factors, kw in (("420", [(2, 2), (1, 1), (1, 1)], {"jfif": True}),
                                  ("444_dac_restart", [(1, 1)] * 3, {"dac": ENTROPY_DAC, "restart": 3}),
                                  ("gray", [(1, 1)], {})):
            blocks = jpeg_writer.random_blocks(np.random.RandomState(w + len(name)), w, h, factors)
            out.append((f"arithmetic sequential {name} {w}x{h}",
                        jpeg_writer.encode_jpeg(w, h, blocks, factors, arithmetic=True, **kw)))
            out.append((f"arithmetic progressive {name} {w}x{h}", jpeg_writer.encode_jpeg(
                w, h, blocks, factors, arithmetic=True, scans=jpeg_writer.progression(len(factors)), **kw)))
    with open(os.path.join(images, "000010.jpg"), "rb") as f:
        fixture = f.read()
    with Image.open(os.path.join(images, "000033.jpg")) as im:
        buf = io.BytesIO()
        im.convert("RGB").save(buf, "JPEG", quality=90, progressive=True)
    for name, data, kw in (("000010.jpg sequential 4:2:0", fixture, {}),
                           ("000033.jpg progressive q90 DAC restart 40", buf.getvalue(),
                            {"dac": ENTROPY_DAC, "restart": 40})):
        blocks = jpeg.decode_coefficients(data).blocks()
        out.append((f"transcoded {name}", jpeg_writer.transcode_arithmetic(data, blocks, **kw), data))
    with Image.open(os.path.join(images, "000004.jpg")) as im:
        crop = im.convert("RGB").crop((3, 5, 64, 50))
    for kind, img in (("gray", crop.convert("L")), ("rgb", crop), ("cmyk", crop.convert("CMYK"))):
        px = np.asarray(img).reshape(45, 61, -1)
        planes = [px[..., k] for k in range(px.shape[-1])]
        for predictor in range(1, 8):
            kw = {"pt": 2 * (predictor % 2 == 0), "restart": 61 * (predictor % 3)}
            if predictor == 7:
                kw["interleaved"] = False
            out.append((f"lossless {kind} predictor {predictor}", jpeg_writer.encode_lossless(
                61, 45, planes, [(1, 1)] * len(planes), predictor=predictor, **kw)))
    with Image.open(os.path.join(images, "000010.jpg")) as im:
        rgb = np.asarray(im.convert("RGB"))
    out.append(("lossless rgb 640x480", jpeg_writer.encode_lossless(640, 480, [rgb[..., k] for k in range(3)],
                                                                    [(1, 1)] * 3, predictor=6, restart=640 * 40)))
    return out


def entropy_gate(torch, dev, smi: str, checkpoint: str) -> dict:
    """Arithmetic-coded and 8-bit lossless JPEGs (``entropy_files``): the
    host's coefficients or samples through the card's kernels (a lossless
    file: the colour kernel alone), each against its plain version, the RGB
    against Pillow's (``_decode_gate``), ``decode_jpeg`` and ``imread_rgb``
    equal to it, 0 levels; the host decode's ms of the two 640x480
    transcodes beside the Huffman decode of the same coefficients, the
    lossless host decode's ms and the colour kernel's device ms on the
    640x480 lossless file; then ``python -m threedod_torch.demo`` over four
    synth_test images rewritten arithmetic sequential, arithmetic
    progressive, lossless RGB and lossless gray (2 K1 launches and 2 reads
    an image; an arithmetic read an IDCT and a colour launch, a lossless
    read a colour launch alone, counted from zero around the run). Returns
    the colour kernel's row, the timings and the demo's JPEG launches."""
    import io

    import numpy as np
    from PIL import Image

    from threedod_torch import demo
    from threedod_torch.data.image_io import image_hw, imread_rgb
    from threedod_torch.ops import jpeg, roi_align_cuda
    from threedod_torch.tools import jpeg_writer

    t0 = time.perf_counter()
    images = os.path.join(HERE, "datasets", "synth", "images")
    folder = os.path.join(HERE, "build", "entropy_jpeg")
    os.makedirs(folder, exist_ok=True)
    stats, lossless, transcoded, decoded = {}, 0, [], {}
    files = entropy_files(np, Image, images)
    split = {"write": time.perf_counter() - t0}
    for k, (name, data, *huffman) in enumerate(files):
        c = jpeg.decode_host(data)
        lossless += isinstance(c, jpeg.Samples)
        _, rgb = _decode_gate(torch, np, jpeg, Image, name, data, c, dev, stats)
        check(torch.equal(jpeg.decode_jpeg(data, dev), rgb), f"decode_jpeg differs from the kernels on {name}")
        file = os.path.join(folder, f"{k}.jpg")
        with open(file, "wb") as f:
            f.write(data)
        with Image.open(file) as im:
            check(image_hw(file) == (im.height, im.width), f"image_hw differs from Pillow's size on {name}")
        check(torch.equal(imread_rgb(file, dev), rgb), f"imread_rgb differs from the kernels on {name}")
        if huffman:
            check(np.array_equal(c.coef, jpeg.decode_coefficients(huffman[0]).coef),
                  f"{name}: the arithmetic file's coefficients differ from the Huffman file's")
            transcoded.append((name, data, huffman[0]))
        decoded[name] = (data, c)
    n = len(decoded)
    check(all(v == 0 for v, _, _ in stats.values()), f"the arithmetic or lossless decode differs: {stats}")
    split["check"] = time.perf_counter() - t0 - split["write"]

    def host_ms(data, reps=5):
        jpeg.decode_host(data)
        t1 = time.perf_counter()
        for _ in range(reps):
            jpeg.decode_host(data)
        return (time.perf_counter() - t1) / reps * 1e3

    timings = {name: dict(arithmetic_ms=host_ms(data), huffman_ms=host_ms(source), arithmetic_bytes=len(data),
                          huffman_bytes=len(source)) for name, data, source in transcoded}
    data, c = decoded["lossless rgb 640x480"]
    lossless_host = host_ms(data)
    planes = jpeg.planes_cuda(c, dev)
    kernel_ms = device_ms(torch, lambda: jpeg.color_cuda(planes, c), 20, {"k": "color_kernel"})["k"]
    call_ms = cuda_ms(lambda: jpeg.color_cuda(planes, c), iters=50)
    plain_ms = cuda_ms(lambda: jpeg.color_reference(planes, c), iters=5)
    plane_bytes = sum(p.numel() for p in planes)
    bound = (plane_bytes + 3 * c.width * c.height) / PEAK_BYTES * 1e3
    row = dict(shape="640x480 lossless RGB", kernel_ms=kernel_ms, ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes", max_abs_err=0.0)
    for name, t in timings.items():
        print(f"[jpeg-entropy] {smi}: host decode of {name}: arithmetic {t['arithmetic_ms']:.3f} ms "
              f"({t['arithmetic_bytes']} bytes), Huffman {t['huffman_ms']:.3f} ms ({t['huffman_bytes']} bytes), the "
              f"same coefficients", flush=True)
    print(f"[jpeg-entropy] {smi}: 640x480 lossless RGB: host decode (Huffman differences and the predictors) "
          f"{lossless_host:.3f} ms; colour kernel device {kernel_ms:.4f} ms, call {call_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms by bytes ({plane_bytes} bytes of samples in, "
          f"{3 * c.width * c.height} of RGB out); no IDCT", flush=True)
    # the demo over four synth_test images rewritten in the new encodings
    demo_in, demo_out = os.path.join(HERE, "build", "demo_entropy_in"), os.path.join(HERE, "build", "demo_entropy_out")
    os.makedirs(demo_in, exist_ok=True)
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        sources = [os.path.join(HERE, "datasets", im["file_path"]) for im in json.load(f)["images"][:4]]
    kinds = ("arithmetic_sequential", "arithmetic_progressive", "lossless_rgb", "lossless_gray")
    for k, (kind, source) in enumerate(zip(kinds, sources)):
        with Image.open(source) as im:
            rgb = im.convert("RGB")
        if kind.startswith("arithmetic"):
            buf = io.BytesIO()
            rgb.save(buf, "JPEG", quality=90, progressive=kind.endswith("progressive"))
            data = jpeg_writer.transcode_arithmetic(buf.getvalue(), jpeg.decode_coefficients(buf.getvalue()).blocks(),
                                                    dac=ENTROPY_DAC if kind.endswith("progressive") else None)
        else:
            px = np.asarray(rgb if kind == "lossless_rgb" else rgb.convert("L")).reshape(rgb.height, rgb.width, -1)
            data = jpeg_writer.encode_lossless(rgb.width, rgb.height, [px[..., i] for i in range(px.shape[-1])],
                                               [(1, 1)] * px.shape[-1], predictor=1 + k)
        with open(os.path.join(demo_in, f"{k}_{kind}.jpg"), "wb") as f:
            f.write(data)
    args = demo.parser().parse_args(["--config-file", BASE_SYNTH, "--input-folder", demo_in, "--output-dir", demo_out,
                                     "--checkpoint", checkpoint, "shapes.max_detections", "10"])
    split["times"] = time.perf_counter() - t0 - split["write"] - split["check"]
    _reset_launches()
    jpeg.LAUNCHES_IDCT = jpeg.LAUNCHES_COLOR = 0
    run = demo.run(args, dev)
    k1, idct, color = roi_align_cuda.LAUNCHES, jpeg.LAUNCHES_IDCT, jpeg.LAUNCHES_COLOR
    check(run["images"] == 4 and len(run["files"]) == 12, f"demo on the rewritten images: {run['images']} images, "
                                                          f"{len(run['files'])} files")
    check(k1 == 8 and idct == 4 and color == 8,
          f"demo on the rewritten images: {k1} K1, {idct} IDCT and {color} colour launches over 4 images, expected "
          "8, 4 (2 an arithmetic image, none a lossless one) and 8")
    for k, kind in enumerate(kinds):
        path = os.path.join(demo_in, f"{k}_{kind}.jpg")
        with Image.open(path) as im:
            check(np.array_equal(imread_rgb(path, dev).cpu().numpy(), np.asarray(im.convert("RGB"))),
                  f"the demo's {kind} image differs from Pillow's")
    seconds = time.perf_counter() - t0
    print(f"[jpeg-entropy] {smi}: {n} files ({n - lossless} arithmetic: sequential and progressive at 61x45 and "
          f"1x1, DAC and restart markers, two 640x480 transcodes; {lossless} lossless: gray, RGB and CMYK at 61x45 "
          f"with predictors 1 to 7, RGB at 640x480): the kernels equal to their plain versions and the RGB, "
          f"decode_jpeg and imread_rgb to Pillow's, 0 levels; python -m threedod_torch.demo over 4 synth_test "
          f"images rewritten {', '.join(kinds)}: {sum(run['detections'])} detections in {run['seconds']:.2f} s, "
          f"{k1} K1, {idct} IDCT and {color} colour launches; {seconds:.1f} s (writing the files "
          f"{split['write']:.1f}, checking them {split['check']:.1f}, the timings {split['times']:.1f}, the demo "
          f"with its files {seconds - sum(split.values()):.1f})", flush=True)
    return dict(row=row, idct=idct, color=color, files=n, seconds=seconds, transcodes=timings,
                lossless_host_ms=lossless_host)


def smooth_files(np, Image, images: str) -> list:
    """[(name, bytes)] of incomplete progressions, which libjpeg smooths
    (jdcoefct.c decompress_smooth_data): fixture images written progressive
    by Pillow at quality 90 and cut (``jpeg_writer.incomplete``): 640x480 4:2:0 with its
    DC scans only, a 633x465 crop at 4:2:0 without the luma's last
    refinement (its row r + 2 a padding row at the last-but-one iMCU row),
    640x480 4:4:4, gray and CMYK without their AC refinements, an
    arithmetic transcode of the 633x465 crop's DC scans; and two files of
    ``tools/jpeg_writer.py``, one large DC among zeros at 4:2:0's factors
    with vertical factor 4 (DC scans only; Annex K's tables) and at 4:4:4 with
    its AC scans at Al 2, unrefined."""
    import io

    from threedod_torch.ops import jpeg
    from threedod_torch.tools import jpeg_writer

    def progressive(name, mode, subsampling, box=None):
        with Image.open(os.path.join(images, name)) as im:
            img = im.convert(mode)
        buf = io.BytesIO()
        (img.crop(box) if box else img).save(buf, "JPEG", quality=90, subsampling=subsampling, progressive=True)
        return buf.getvalue()

    cut = jpeg_writer.incomplete
    crop = progressive("000004.jpg", "RGB", 2, (0, 0, 633, 465))
    out = [("640x480 4:2:0 DC only", cut(progressive("000004.jpg", "RGB", 2), "dc_only")),
           ("633x465 4:2:0 without the luma's last refinement", cut(crop, "first_refinement")),
           ("640x480 4:4:4 without AC refinements", cut(progressive("000033.jpg", "RGB", 0), "no_ac_refinement")),
           ("640x480 gray without AC refinements", cut(progressive("000033.jpg", "L", 0), "no_ac_refinement")),
           ("640x480 CMYK without AC refinements", cut(progressive("000004.jpg", "CMYK", 0), "no_ac_refinement"))]
    dc_only = cut(crop, "dc_only")
    out.append(("633x465 4:2:0 DC only, arithmetic",
                jpeg_writer.transcode_arithmetic(dc_only, jpeg.decode_coefficients(dc_only).blocks())))
    for name, w, h, factors, at, scans in (
            ("impulse 40x84 v4 DC only", 40, 84, [(1, 4), (1, 1), (1, 1)], (9, 2), [((0, 1, 2), 0, 0, 0, 0)]),
            ("impulse 56x56 4:4:4 Al 2", 56, 56, [(1, 1)] * 3, (3, 3),
             [((0, 1, 2), 0, 0, 0, 0)] + [((k,), 1, 63, 0, 2) for k in range(3)])):
        blocks = [np.zeros((bh, bw, 64), np.int16) for bh, bw in jpeg_writer.block_grid(w, h, factors)]
        blocks[0][at + (0,)] = 60
        out.append((name, jpeg_writer.encode_jpeg(w, h, blocks, factors, arithmetic=True, scans=scans)))
    return out


def smooth_gate(torch, dev, smi: str, checkpoint: str, extra=()) -> dict:
    """Incomplete progressive JPEGs (``smooth_files``), which libjpeg
    smooths: each file's unsmoothed decode (the IDCT kernel's plain
    instance) first shown to differ from Pillow's RGB; then the host's
    coefficients through the smoothing instance against ``smooth_reference``
    and ``idct_islow_reference`` and the colour kernel against its plain
    version (``_decode_gate``), the RGB, ``decode_jpeg`` and ``imread_rgb``
    against Pillow's, 0 levels; the two instances' device ms
    (``torch.profiler``) and call ms on the 640x480 4:2:0 DC-only file beside
    the bytes bound; then ``python -m threedod_torch.demo`` over four
    synth_test images rewritten as incomplete progressions (2 K1 launches and
    2 reads an image, each a smoothing IDCT and a colour launch, counted from
    zero around the run), and beside them the files of ``extra``, (name,
    bytes) of damaged JPEGs (``damage_gate``), in the same run. Returns the
    smoothing instance's row and the demo's launches."""
    import io

    import numpy as np
    from PIL import Image

    from threedod_torch import demo
    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import jpeg, roi_align_cuda
    from threedod_torch.tools import jpeg_writer

    t0 = time.perf_counter()
    images = os.path.join(HERE, "datasets", "synth", "images")
    folder = os.path.join(HERE, "build", "smooth_jpeg")
    os.makedirs(folder, exist_ok=True)
    stats, decoded = {}, {}
    files = smooth_files(np, Image, images)
    split = {"write": time.perf_counter() - t0}
    for k, (name, data) in enumerate(files):
        c = jpeg.decode_coefficients(data)
        check(c.smooth is not None, f"{name}: libjpeg would not smooth this file")
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        plain = c._replace(smooth=None)
        unsmoothed = jpeg.color_cuda(jpeg.planes_cuda(plain, dev), plain).cpu().numpy()
        check(not np.array_equal(unsmoothed, want), f"{name}: the unsmoothed decode already equals Pillow's")
        _, rgb = _decode_gate(torch, np, jpeg, Image, name, data, c, dev, stats)
        check(torch.equal(jpeg.decode_jpeg(data, dev), rgb), f"decode_jpeg differs from the kernels on {name}")
        file = os.path.join(folder, f"{k}.jpg")
        with open(file, "wb") as f:
            f.write(data)
        check(torch.equal(imread_rgb(file, dev), rgb), f"imread_rgb differs from the kernels on {name}")
        decoded[name] = (c, int(np.abs(unsmoothed.astype(np.int32) - want).max()))
    check(all(v == 0 for v, _, _ in stats.values()), f"the smoothed decode differs: {stats}")
    split["check"] = time.perf_counter() - t0 - split["write"]
    # the two instances on the same 640x480 4:2:0 file
    c, _ = decoded["640x480 4:2:0 DC only"]
    plain = c._replace(smooth=None)
    both = device_ms(torch, lambda: (jpeg.idct_cuda(c, dev), jpeg.idct_cuda(plain, dev)), 20,
                     {"smooth": "idct_kernel<true>", "plain": "idct_kernel<false>"})
    smooth_kernel, plain_kernel = both["smooth"], both["plain"]
    smooth_call = cuda_ms(lambda: jpeg.idct_cuda(c, dev), iters=50)
    plain_call = cuda_ms(lambda: jpeg.idct_cuda(plain, dev), iters=50)
    coef = torch.from_numpy(c.coef).to(dev)
    quant = torch.from_numpy(c.quant.astype(np.int64)).to(dev)

    def plain_version():
        for k, comp in enumerate(c.components):
            n = comp.blocks_w * comp.blocks_h
            blocks = coef[comp.offset:comp.offset + 64 * n].reshape(comp.blocks_h, comp.blocks_w, 64)
            jpeg.idct_islow_reference(jpeg.smooth_reference(blocks, quant[k], c.smooth[k], comp).reshape(n, 64),
                                      quant[k])

    plain_ms = cuda_ms(plain_version, iters=5)
    plane_bytes = sum(comp.blocks_w * comp.blocks_h * 64 for comp in c.components)
    bound = jpeg_bound_ms(c.coef.nbytes + c.quant.nbytes, plane_bytes, 0)[0]
    row = dict(shape="640x480 4:2:0 DC only", kernel_ms=smooth_kernel, ms=smooth_call, plain_ms=plain_ms,
               bound_ms=bound, bound_by="bytes", max_abs_err=0.0, library_ms=None, unsmoothed_kernel_ms=plain_kernel,
               unsmoothed_ms=plain_call)
    print(f"[jpeg-smooth] {smi}: 640x480 4:2:0 DC only: IDCT smoothing instance device {smooth_kernel:.4f} ms, call "
          f"{smooth_call:.4f} ms; plain instance on the same coefficients device {plain_kernel:.4f} ms, call "
          f"{plain_call:.4f} ms; plain version (smooth_reference + idct_islow_reference) {plain_ms:.4f} ms; bound "
          f"{bound:.5f} ms by bytes ({c.coef.nbytes + c.quant.nbytes} bytes of coefficients in, {plane_bytes} of "
          f"planes out)", flush=True)
    for name, (_, off) in decoded.items():
        print(f"[jpeg-smooth] {name}: unsmoothed up to {off} levels off Pillow, smoothed 0", flush=True)
    split["times"] = time.perf_counter() - t0 - split["write"] - split["check"]
    # the demo over four synth_test images rewritten as incomplete progressions
    demo_in, demo_out = os.path.join(HERE, "build", "demo_smooth_in"), os.path.join(HERE, "build", "demo_smooth_out")
    os.makedirs(demo_in, exist_ok=True)
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        sources = [os.path.join(HERE, "datasets", im["file_path"]) for im in json.load(f)["images"][:4]]
    kinds = ("dc_only", "first_refinement", "no_ac_refinement", "dc_only_arithmetic")
    for k, (kind, source) in enumerate(zip(kinds, sources)):
        with Image.open(source) as im:
            buf = io.BytesIO()
            im.convert("RGB").save(buf, "JPEG", quality=90, progressive=True, subsampling=2 * (k % 2))
        data = jpeg_writer.incomplete(buf.getvalue(), kind.replace("_arithmetic", ""))
        if kind.endswith("arithmetic"):
            data = jpeg_writer.transcode_arithmetic(data, jpeg.decode_coefficients(data).blocks())
        check(jpeg.decode_coefficients(data).smooth is not None, f"the demo's {kind} image would not be smoothed")
        with open(os.path.join(demo_in, f"{k}_{kind}.jpg"), "wb") as f:
            f.write(data)
    smoothing_extra = 0
    for name, data in extra:
        smoothing_extra += getattr(jpeg.decode_host(data), "smooth", None) is not None
        with open(os.path.join(demo_in, name), "wb") as f:
            f.write(data)
    n = len(kinds) + len(extra)
    args = demo.parser().parse_args(["--config-file", BASE_SYNTH, "--input-folder", demo_in, "--output-dir", demo_out,
                                     "--checkpoint", checkpoint, "shapes.max_detections", "10"])
    _reset_launches()
    jpeg.LAUNCHES_IDCT = jpeg.LAUNCHES_IDCT_SMOOTH = jpeg.LAUNCHES_COLOR = 0
    run = demo.run(args, dev)
    k1, idct, smooth, color = (roi_align_cuda.LAUNCHES, jpeg.LAUNCHES_IDCT, jpeg.LAUNCHES_IDCT_SMOOTH,
                               jpeg.LAUNCHES_COLOR)
    check(run["images"] == n and len(run["files"]) == 3 * n, f"demo on the rewritten images: {run['images']} images, "
                                                             f"{len(run['files'])} files")
    check(k1 == 2 * n and idct == 2 * n and smooth == 8 + 2 * smoothing_extra and color == 2 * n,
          f"demo on the rewritten images: {k1} K1, {idct} IDCT ({smooth} smoothing) and {color} colour launches over "
          f"{n} images, expected {2 * n}, {2 * n} ({8 + 2 * smoothing_extra} smoothing) and {2 * n}")
    for path in [os.path.join(demo_in, f"{k}_{kind}.jpg") for k, kind in enumerate(kinds)] + [
            os.path.join(demo_in, name) for name, _ in extra]:
        with Image.open(path) as im:
            check(np.array_equal(imread_rgb(path, dev).cpu().numpy(), np.asarray(im.convert("RGB"))),
                  f"the demo's image {os.path.basename(path)} differs from Pillow's")
    seconds = time.perf_counter() - t0
    print(f"[jpeg-smooth] {smi}: {len(files)} incomplete progressions (640x480 4:2:0, 4:4:4, gray, CMYK; 633x465 "
          f"4:2:0 Huffman and arithmetic; two impulse files): the smoothing instance equal to smooth_reference + "
          f"idct_islow_reference, the RGB, decode_jpeg and imread_rgb to Pillow's, 0 levels, each unsmoothed decode "
          f"off; python -m threedod_torch.demo over 4 synth_test images rewritten {', '.join(kinds)} and {len(extra)} "
          f"damaged ones (2 K1 launches and 2 reads each, {smoothing_extra} smoothed): "
          f"{sum(run['detections'])} detections in {run['seconds']:.2f} s, {k1} K1, {idct} IDCT ({smooth} smoothing) "
          f"and {color} colour launches; {seconds:.1f} s (writing the files {split['write']:.1f}, checking them "
          f"{split['check']:.1f}, the timings {split['times']:.1f}, the demo with its files "
          f"{seconds - sum(split.values()):.1f})", flush=True)
    return dict(row=row, idct=idct, smooth=smooth, color=color, files=len(files), seconds=seconds,
                damaged_images=len(extra))


def idct_sweeps(np) -> list:
    """[(name, blocks (n, 64) natural order, flat quantization value)] of
    impulse blocks where libjpeg-turbo's SIMD IDCT wraps and saturates:
    DC-only blocks of DC -2047 to 2047 at q 4, 40 and 255; one AC
    coefficient at each of the 63 places at q 16 and 255; seeded pairs and
    triples with a DC at q 64 and 255."""
    out = []
    dcs = np.arange(-2047, 2048)
    for q in (4, 40, 255):
        blocks = np.zeros((len(dcs), 64), np.int64)
        blocks[:, 0] = dcs
        out.append((f"DC only, q {q}", blocks, q))
    values = np.concatenate([np.arange(-1023, 1024, 31), [-1023, 1023]])
    for q in (16, 255):
        blocks = np.zeros((63 * len(values), 64), np.int64)
        for pos in range(1, 64):
            blocks[(pos - 1) * len(values):pos * len(values), pos] = values
        out.append((f"one AC, q {q}", blocks, q))
    rng = np.random.RandomState(26)
    for q in (64, 255):
        blocks = np.zeros((1024, 64), np.int64)
        for b in blocks:
            k = rng.randint(1, 3)
            b[rng.choice(np.arange(1, 64), k, replace=False)] = rng.randint(-1023, 1024, k)
            b[0] = rng.randint(-1000, 1001)
        out.append((f"pairs, q {q}", blocks, q))
    return out


def damaged_jpegs(np, Image, jpeg, jpeg_writer, images: str) -> list:
    """[(name, bytes)] of damaged JPEGs, each to be read as Pillow reads it or
    refused where Pillow refuses it: 128x96 crops of a fixture image written
    by Pillow at quality 85 (baseline 4:2:0, progressive 4:4:4 with restart
    markers, gray with a restart marker a row), an arithmetic transcode with
    restart markers and a lossless gray file with restart markers, each with
    seeded bit flips and byte corruptions, EOI inside a scan, a cut followed
    by EOI, a cut with no marker, a restart marker dropped and one
    renumbered, a dropped scan; and the one-bit flip of a 128x96 crop that
    drives a DC past the SIMD IDCT's 16-bit lanes."""
    import io

    def saved(mode, box=(5, 7, 133, 103), source="000004.jpg", **kw):
        with Image.open(os.path.join(images, source)) as im:
            img = im.convert(mode).crop(box)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=85, **kw)
        return buf.getvalue()

    def ranges(data):
        return [(start + 2 + int.from_bytes(data[start + 2:start + 4], "big"), end)
                for start, end, *_ in jpeg_writer.scans(data)]

    baseline = saved("RGB", subsampling=2)
    with Image.open(os.path.join(images, "000004.jpg")) as im:
        plane = np.asarray(im.convert("L").crop((40, 20, 85, 51))).astype(np.int64)
    bases = [("baseline 4:2:0", baseline),
             ("progressive 4:4:4, restart 5", saved("RGB", subsampling=0, progressive=True, restart_marker_blocks=5)),
             ("gray, restart a row", saved("L", restart_marker_rows=1)),
             ("arithmetic, restart 6", jpeg_writer.transcode_arithmetic(
                 baseline, jpeg.decode_coefficients(baseline).blocks(), restart=6)),
             ("lossless gray, restart 2 rows", jpeg_writer.encode_lossless(45, 31, [plane], [(1, 1)], predictor=7,
                                                                            restart=90))]
    out = []
    for k, (base, data) in enumerate(bases):
        rng = np.random.RandomState(k)
        spans = ranges(data)

        def at():
            start, end = spans[rng.randint(len(spans))]
            return start + rng.randint(end - start)

        out.append((base, data))
        for i in range(3):
            p, b = at(), bytearray(data)
            b[p] ^= 1 << rng.randint(8)
            out.append((f"{base}, bit flip {i}", bytes(b)))
        p, b = at(), bytearray(data)
        b[p:p + 3] = bytes(rng.randint(0, 256, 3).tolist())
        out.append((f"{base}, 3 bytes", bytes(b[:len(data)])))
        p = at()
        out.append((f"{base}, EOI inside a scan", data[:p] + b"\xff\xd9" + data[p:]))
        out.append((f"{base}, cut then EOI", data[:at()] + b"\xff\xd9"))
        out.append((f"{base}, cut", data[:at()]))
        restarts = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
        if restarts:
            i = restarts[rng.randint(len(restarts))]
            out.append((f"{base}, restart marker dropped", data[:i] + data[i + 2:]))
            b = bytearray(data)
            b[i + 1] = 0xD0 + rng.randint(8)
            out.append((f"{base}, restart marker renumbered", bytes(b)))
        if len(spans) > 1:
            out.append((f"{base}, scan dropped", jpeg_writer.without_scans(data, [rng.randint(len(spans))])))
    flip = saved("RGB", (100, 100, 228, 196), "000001.jpg")
    (start, end), = ranges(flip)
    rng = np.random.RandomState(6)
    p, b = start + rng.randint(end - start), bytearray(flip)
    b[p] ^= 1 << rng.randint(8)
    out.append(("128x96 4:2:0, one bit flipped past the 16-bit lanes", bytes(b)))
    return out


def damage_gate(torch, dev, smi: str) -> dict:
    """Out-of-range and damaged JPEGs on the card, against this machine's
    Pillow (whose libjpeg-turbo SIMD IDCT the IDCT kernel copies): the
    impulse sweeps (``idct_sweeps``) through the host decoder, the IDCT
    kernel's plain instance against ``idct_islow_reference`` and Pillow's
    samples, and its smoothing instance on the same blocks (DC-only bits,
    and AC bits of Al 2 past a last good row) against ``smooth_reference`` +
    ``idct_islow_reference``; the damaged files (``damaged_jpegs``) through
    both kernels against their plain versions and through ``decode_jpeg``
    and ``imread_rgb`` against Pillow's RGB, 0 levels, or refused with the
    file's path where Pillow refuses; both instances' device ms in one
    profiler session (the plain one on fixture 000004.jpg's 640x480 4:2:0
    coefficients and, as PR 25 timed them, on its DC-only cut, the smoothing
    one on that cut) beside the bound; and four synth_test images rewritten
    with damage Pillow reads, for the demo of ``smooth_gate``. Returns the
    times, the counts and the demo's files."""
    import io

    import numpy as np
    from PIL import Image

    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.ops import jpeg
    from threedod_torch.tools import jpeg_writer

    t0 = time.perf_counter()
    images = os.path.join(HERE, "datasets", "synth", "images")
    folder = os.path.join(HERE, "build", "damage_jpeg")
    os.makedirs(folder, exist_ok=True)
    blocks_checked = 0
    for name, blocks, q in idct_sweeps(np):
        data = jpeg_writer.encode_jpeg(8 * len(blocks), 8, [blocks.astype(np.int16)[None]], [(1, 1)],
                                       quant=[np.full(64, q)] * 2)
        c = jpeg.decode_coefficients(data)
        check(np.array_equal(c.coef.reshape(-1, 64), blocks), f"{name}: the host decoder's coefficients differ")
        with Image.open(io.BytesIO(data)) as im:
            pillow = torch.from_numpy(np.asarray(im.convert("L")).copy())
        plain = jpeg.planes_reference(c)[0]
        check(torch.equal(plain, pillow), f"{name}: idct_islow_reference differs from this machine's Pillow at "
                                          f"{int((plain != pillow).sum())} samples")
        check(torch.equal(jpeg.idct_cuda(c, dev)[0].cpu(), plain), f"{name}: the IDCT kernel differs from "
                                                                  "idct_islow_reference")
        # the smoothing instance on the same blocks, laid out 512 a row
        w = 512
        h = -(-len(blocks) // w)
        grid = np.zeros((h * w, 64), np.int16)
        grid[:len(blocks)] = blocks
        comp = jpeg.Component(1, 1, w, h, 8 * w, 8 * h, 0)
        smoothed = jpeg.Coefficients(8 * w, 8 * h, [comp], grid.reshape(-1), c.quant, jpeg.GRAYSCALE,
                                     np.array([[0] + [-1] * 9], np.int32), np.array([[0] + [2] * 9], np.int32),
                                     h // 2)
        check(torch.equal(jpeg.idct_cuda(smoothed, dev)[0].cpu(), jpeg.planes_reference(smoothed)[0]),
              f"{name}: the IDCT kernel's smoothing instance differs from smooth_reference + idct_islow_reference")
        blocks_checked += len(blocks)
    split = {"sweeps": time.perf_counter() - t0}
    files = damaged_jpegs(np, Image, jpeg, jpeg_writer, images)
    read = refused = 0
    for k, (name, data) in enumerate(files):
        path = os.path.join(folder, f"{k}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with Image.open(io.BytesIO(data)) as im:
                want = torch.from_numpy(np.asarray(im.convert("RGB")).copy())
        except OSError as e:
            for what, decode in (("decode_jpeg", lambda: jpeg.decode_jpeg(data, dev)),
                                 ("imread_rgb", lambda: imread_rgb(path, dev))):
                try:
                    decode()
                except ValueError as raised:
                    check(what == "decode_jpeg" or path in str(raised), f"{name}: imread_rgb's refusal does not "
                                                                       "name the file")
                else:
                    fail(f"{name}: {what} decodes a file this machine's Pillow refuses ({e})")
            refused += 1
            continue
        c = jpeg.decode_host(data)
        planes = jpeg.planes_cuda(c, dev)
        host = [p.cpu() for p in planes]
        for got, plain in zip(host, jpeg.planes_reference(c)):
            check(torch.equal(got, plain), f"{name}: a plane differs from its plain version")
        rgb = jpeg.color_cuda(planes, c).cpu()
        check(torch.equal(rgb, jpeg.color_reference(host, c)), f"{name}: the colour kernel differs from its plain "
                                                              "version")
        check(torch.equal(rgb, want), f"{name}: {int((rgb != want).any(-1).sum())} pixels differ from Pillow's")
        check(torch.equal(jpeg.decode_jpeg(data, dev).cpu(), want), f"{name}: decode_jpeg differs from Pillow")
        check(torch.equal(imread_rgb(path, dev).cpu(), want), f"{name}: imread_rgb differs from Pillow")
        read += 1
    check(read >= 30 and refused >= 5, f"the damaged files: {read} read, {refused} refused")
    split["files"] = time.perf_counter() - t0 - split["sweeps"]
    # the two instances' device time in one session
    with open(os.path.join(images, "000004.jpg"), "rb") as f:
        fixture = jpeg.decode_coefficients(f.read())
    with Image.open(os.path.join(images, "000004.jpg")) as im:
        buf = io.BytesIO()
        im.convert("RGB").save(buf, "JPEG", quality=90, subsampling=2, progressive=True)
    dc_only = jpeg.decode_coefficients(jpeg_writer.incomplete(buf.getvalue(), "dc_only"))
    check(dc_only.smooth is not None, "the 640x480 DC-only cut would not be smoothed")
    unsmoothed = dc_only._replace(smooth=None)
    plain_ms, cut_ms, smooth_ms = device_ms_each(
        torch, [lambda: jpeg.idct_cuda(fixture, dev), lambda: jpeg.idct_cuda(unsmoothed, dev),
                lambda: jpeg.idct_cuda(dc_only, dev)], 20, "idct_kernel")
    plane_bytes = sum(comp.blocks_w * comp.blocks_h * 64 for comp in fixture.components)
    bound = jpeg_bound_ms(fixture.coef.nbytes + fixture.quant.nbytes, plane_bytes, 0)[0]
    print(f"[jpeg-damage] {smi}: IDCT kernel device ms, one profiler session: plain instance {plain_ms:.4f} on fixture "
          f"000004.jpg's 640x480 4:2:0 coefficients, {cut_ms:.4f} on its DC-only cut (PR 25: 0.0020); smoothing "
          f"instance {smooth_ms:.4f} on the cut (PR 25: 0.0041); bound {bound:.5f} by bytes", flush=True)
    # four synth_test images with damage Pillow reads, for the smoothing gate's demo
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        sources = [os.path.join(HERE, "datasets", im["file_path"]) for im in json.load(f)["images"][4:8]]
    demo, kinds = [], ("bit flip", "restart marker dropped", "EOI inside a scan", "cut then EOI, progressive")
    for k, (kind, source) in enumerate(zip(kinds, sources)):
        with Image.open(source) as im:
            buf = io.BytesIO()
            im.convert("RGB").save(buf, "JPEG", quality=90, progressive=kind.endswith("progressive"),
                                   **({"restart_marker_blocks": 8} if "restart" in kind else {}))
        data = buf.getvalue()
        spans = [(s + 2 + int.from_bytes(data[s + 2:s + 4], "big"), e) for s, e, *_ in jpeg_writer.scans(data)]
        rng = np.random.RandomState(k)
        for _ in range(20):  # the first seeded damage Pillow reads
            start, end = spans[rng.randint(len(spans))]
            p = start + rng.randint(end - start)
            if kind == "bit flip":
                b = bytearray(data)
                b[p] ^= 1 << rng.randint(8)
                bad = bytes(b)
            elif kind.startswith("restart"):
                i = data.index(bytes([0xFF, 0xD0 + rng.randint(8)]), start)
                bad = data[:i] + data[i + 2:]
            elif kind.startswith("EOI"):
                bad = data[:p] + b"\xff\xd9" + data[p:]
            else:
                bad = data[:p] + b"\xff\xd9"
            try:
                with Image.open(io.BytesIO(bad)) as im:
                    im.convert("RGB")
                break
            except OSError:
                continue
        else:
            fail(f"no seeded damage of kind {kind} that Pillow reads")
        demo.append((f"damaged_{k}_{kind.replace(' ', '_').replace(',', '')}.jpg", bad))
    seconds = time.perf_counter() - t0
    print(f"[jpeg-damage] {smi}: {len(idct_sweeps(np))} impulse sweeps ({blocks_checked} blocks) through both IDCT "
          f"instances against their plain versions and the plain one against this machine's Pillow, 0 levels; "
          f"{len(files)} damaged files: {read} read (kernels against their plain versions, decode_jpeg and imread_rgb "
          f"against Pillow, 0 levels), {refused} refused as Pillow refuses them; {seconds:.1f} s (sweeps "
          f"{split['sweeps']:.1f}, files {split['files']:.1f})", flush=True)
    return dict(plain_ms=plain_ms, cut_ms=cut_ms, smooth_ms=smooth_ms, bound_ms=bound, read=read, refused=refused,
                blocks=blocks_checked, demo=demo, seconds=seconds)


def png_root(torch, dev, root: str = PNG_ROOT, interlace: bool = False) -> list:
    """A datasets root under build/ whose synth_test names PNG copies of its
    20 JPEGs (Adam7-interlaced where ``interlace``), written from the card's
    JPEG decode with a random filter a row; each PNG decoded on the card
    equals that decode. Returns the copies."""
    import numpy as np

    from threedod_torch.data.image_io import image_hw, imread_rgb
    from threedod_torch.ops import png

    rng = np.random.RandomState(20)
    os.makedirs(os.path.join(root, "Omni3D"), exist_ok=True)
    os.makedirs(os.path.join(root, "synth_png"), exist_ok=True)
    for name in ("synth", "depth_maps", "ground_maps"):
        if not os.path.exists(os.path.join(root, name)):
            os.symlink(os.path.join(HERE, "datasets", name), os.path.join(root, name))
    for split in ("synth_train", "synth_val"):
        link = os.path.join(root, "Omni3D", f"{split}.json")
        if not os.path.exists(link):
            os.symlink(os.path.join(HERE, "datasets", "Omni3D", f"{split}.json"), link)
    with open(os.path.join(HERE, "datasets", "Omni3D", "synth_test.json")) as f:
        data = json.load(f)
    copies = []
    for im in data["images"]:
        rgb = imread_rgb(os.path.join(HERE, "datasets", im["file_path"]), dev)
        stem = os.path.splitext(os.path.basename(im["file_path"]))[0]
        im["file_path"] = f"synth_png/{stem}.png"
        path = os.path.join(root, im["file_path"])
        h, w = rgb.shape[:2]
        rows = sum(q.height for q in png.Png(w, h, 2, 8, int(interlace), None, b"").passes())
        with open(path, "wb") as f:
            f.write(png.encode_png(rgb.cpu().numpy(), 2, rng.randint(0, 5, rows), level=1, interlace=interlace))
        got = imread_rgb(path, dev)
        check(got.is_cuda and torch.equal(got, rgb), f"{path} decoded on the card differs from the JPEG it was "
                                                      "written from")
        check(image_hw(path) == tuple(rgb.shape[:2]), f"image_hw({path}) is not {tuple(rgb.shape[:2])}")
        copies.append(path)
    with open(os.path.join(root, "Omni3D", "synth_test.json"), "w") as f:
        json.dump(data, f)
    return copies


def kitti_demo_png(torch, dev, smi: str, checkpoint: str, reference_json: str, threshold: float,
                   root: str = PNG_ROOT, what: str = "the PNG copies", reference: str = "phase 20's run on the JPEGs"
                   ) -> dict:
    """``kitti_demo --display`` on PNG copies of synth_test (``root``) with
    phase 14's checkpoint at phase 20's threshold: 2 K1 launches an image, a
    PNG decode an image and one more a drawing, and the detections of the
    reference run (``reference_json``: the same pixels) within 1e-3: the same
    images, the same number of detections in each, at least one in all."""
    import shutil

    from threedod_torch import kitti_demo
    from threedod_torch.ops import png, roi_align_cuda

    out_dir = os.path.join(HERE, "build", "kitti_demo_" + os.path.basename(root))
    shutil.rmtree(out_dir, ignore_errors=True)
    with open(reference_json) as f:
        jpeg_run = json.load(f)
    args = kitti_demo.parser().parse_args([
        "--config-file", BASE_SYNTH, "--dataset", "synth_test", "--checkpoint", checkpoint, "--threshold",
        str(threshold), "--display", "--output-dir", out_dir, "shapes.max_detections", "10", "datasets.root", root,
        "output_dir", os.path.join(out_dir, "setup")])
    _reset_launches()
    png.LAUNCHES = 0
    run = kitti_demo.run(args, dev)
    k1, decodes = roi_align_cuda.LAUNCHES, png.LAUNCHES
    with open(run["predictions_json"]) as f:
        data = json.load(f)
    check(run["images"] == 20 and k1 == 40, f"kitti_demo on {what}: {run['images']} images, {k1} K1 launches")
    check(decodes == 20 + len(run["drawn"]), f"kitti_demo on {what}: {decodes} PNG decodes, expected 20 and one a "
                                             f"drawing ({len(run['drawn'])})")
    check(all(e["file_path"].endswith(".png") for e in data), f"kitti_demo read other files than {what}")
    ids, jpeg_ids = sorted(e["image_id"] for e in data), sorted(e["image_id"] for e in jpeg_run)
    check(len(ids) == 20 and ids == jpeg_ids, f"kitti_demo on {what} wrote images {ids}, {reference} {jpeg_ids}")
    jpeg_dets = sum(len(e["predictions"]) for e in jpeg_run)
    check(run["detections"] > 0 and run["detections"] == jpeg_dets,
          f"kitti_demo on {what}: {run['detections']} detections, {reference} {jpeg_dets}")
    worst = 0.0
    for a, b in zip(sorted(data, key=lambda e: e["image_id"]), sorted(jpeg_run, key=lambda e: e["image_id"])):
        check(len(a["predictions"]) == len(b["predictions"]),
              f"image {a['image_id']}: {len(a['predictions'])} detections on {what}, {len(b['predictions'])} in "
              f"{reference}")
        for pa, pb in zip(a["predictions"], b["predictions"]):
            worst = max(worst, abs(pa["score"] - pb["score"]), *(abs(x - y) / 100 for x, y in zip(pa["bbox"], pb["bbox"])))
    check(worst <= 1e-3, f"kitti_demo on {what} differs from {reference} by {worst}")
    print(f"[png-kitti] {smi}: python -m threedod_torch.kitti_demo --display on {what} of synth_test: "
          f"{run['detections']} detections in {run['images']} images, {len(run['drawn'])} drawn, "
          f"{run['seconds']:.2f} s; {k1} K1 launches, {decodes} PNG kernel launches; the detections of {reference} "
          f"within {worst:.2e} (scores; boxes / 100 px)", flush=True)
    return dict(k1=k1, png=decodes, seconds=run["seconds"], predictions_json=run["predictions_json"])


def official_depth_checkpoint(torch, path: str) -> dict:
    """The seeded vitl DA-V2 saved as an official file is: ``{"model":
    ...}``, every key under ``module.``, with ``pretrained.mask_token`` and
    refinenet4's unused ``resConfUnit1``. Returns the port's own dict."""
    from threedod_torch.models.depth.dpt import build_depth_model

    sd = build_depth_model("vitl", dtype=torch.float32, seed=0).state_dict()
    official = {f"module.{k}": v for k, v in sd.items()}
    official["module.pretrained.mask_token"] = torch.zeros(1, 1024)
    for conv in ("conv1", "conv2"):
        w = sd[f"depth_head.scratch.refinenet3.resConfUnit1.{conv}.weight"]
        official[f"module.depth_head.scratch.refinenet4.resConfUnit1.{conv}.weight"] = torch.zeros_like(w)
        official[f"module.depth_head.scratch.refinenet4.resConfUnit1.{conv}.bias"] = torch.zeros(w.shape[0])
    torch.save({"model": official}, path)
    return sd


def depth_to_pointcloud_png(torch, dev, smi: str) -> dict:
    """``python -m threedod_torch.depth_to_pointcloud`` with an official-layout
    vitl checkpoint on a KITTI-shaped PNG (a fixture image tiled to
    1242x375): a 518x1722 input, 4552 tokens (37 x 123 patches and the class
    token, where phase 6 holds K9 against its plain version), 24 K9 launches,
    one PNG decode;
    the PLY re-read: every pixel a point, its colour the PNG's, its z the
    depth of the same model loaded from the port's own dict."""
    import numpy as np

    from threedod_torch import depth_to_pointcloud as dtp
    from threedod_torch.data.image_io import imread_rgb
    from threedod_torch.depth_infer import load_model
    from threedod_torch.models.depth.dpt import preprocess_image, resize_align_corners
    from threedod_torch.ops import attention, png

    folder = os.path.join(HERE, "build", "pointcloud")
    os.makedirs(os.path.join(folder, "in"), exist_ok=True)
    src = imread_rgb(os.path.join(HERE, "datasets", "synth", "images", "000002.jpg"), dev).cpu().numpy()
    image = np.tile(src, (1, 2, 1))[:375, :1242]
    path = os.path.join(folder, "in", "kitti.png")
    with open(path, "wb") as f:
        f.write(png.encode_png(image, 2, np.random.RandomState(7).randint(0, 5, 375), level=1))
    ckpt = os.path.join(folder, "dav2_vitl_official.pth")
    t0 = time.perf_counter()
    sd = official_depth_checkpoint(torch, ckpt)
    save_s = time.perf_counter() - t0
    args = dtp.parser().parse_args(["--img-path", os.path.join(folder, "in"), "--outdir", os.path.join(folder, "out"),
                                    "--encoder", "vitl", "--checkpoint", ckpt, "--input-size", "518"])
    png.LAUNCHES = attention.LAUNCHES = 0
    run = dtp.run(args, dev)
    k9, decodes = attention.LAUNCHES, png.LAUNCHES
    check(run["flash_attention_launches"] == k9 == 24, f"depth_to_pointcloud: {k9} K9 launches, expected 24 (vitl)")
    check(decodes == 1 and len(run["files"]) == 1, f"depth_to_pointcloud: {decodes} PNG decodes, {run['files']}")
    points, colors = dtp.read_ply(run["files"][0])
    check(points.shape == (375 * 1242, 3) and bool(np.isfinite(points).all()), f"PLY points {points.shape}")
    check(bool((colors == image.reshape(-1, 3)).all()), "the PLY's colours are not the PNG's pixels")
    model = load_model("vitl", dev, sd)
    x = preprocess_image(torch.from_numpy(image).to(dev).float() / 255.0, 518)
    check(tuple(x.shape) == (1, 3, 518, 1722), f"the KITTI input is {tuple(x.shape)}, not (1, 3, 518, 1722)")
    with torch.inference_mode():
        depth = resize_align_corners(model(x)[:, None].float(), 375, 1242)[0, 0]
    z = depth.reshape(-1).cpu().numpy()
    z_err = float(np.abs(points[:, 2] - z).max())
    # the same kernels on the same input: equal unless cuDNN picks another algorithm a call
    check(z_err <= 1e-3 * float(np.abs(z).max()), f"the PLY's z differs from the port-dict model's depth by {z_err}")
    print(f"[pointcloud] {smi}: python -m threedod_torch.depth_to_pointcloud --encoder vitl --input-size 518 on a "
          f"1242x375 PNG with an official-layout checkpoint ({save_s:.1f} s to write it): 518x1722 input, 4552 "
          f"tokens, {k9} K9 launches, {decodes} PNG decode, {len(points)} points in {run['seconds']:.2f} s; z equal "
          f"to the port-dict model's depth (largest difference {z_err})", flush=True)
    return dict(k9=k9, png=decodes, seconds=run["seconds"])


def other_tools(torch, dev, smi: str, run_dir: str, mabo_results: dict) -> dict:
    """The tools that move few numbers, each on the card where it has card
    work, with its seconds: fit_proposal_coefs on BoxNet_Synth (297 pairs),
    priors, datasetminify, grid_effect (card vs CPU), visualise_gt with
    phase 14's run, results on its metrics.json, mabo_plots on phase 16's
    MABO results; every PNG they write re-reads."""
    import glob
    import pickle

    import numpy as np

    from threedod_torch import (datasetminify, fit_proposal_coefs, grid_effect, mabo_plots, priors, results,
                                visualise_gt)
    from threedod_torch.vis import read_png

    out = os.path.join(HERE, "build", "tools")
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        seconds[name] = time.perf_counter() - t0
        return r

    fit = timed("fit_proposal_coefs", lambda: fit_proposal_coefs.run(fit_proposal_coefs.parser().parse_args(
        ["--config-file", BOXNET_SYNTH, "--plot-dir", os.path.join(out, "coef"), "output_dir",
         os.path.join(out, "coef_setup")]), dev))
    check(len(fit["pairs"]["x"]) == 297 and all(np.isfinite(v).all() for v in fit["fits"].values()),
          f"fit_proposal_coefs: {len(fit['pairs']['x'])} pairs, fits {fit['fits']}")
    pkl = os.path.join(out, "priors.pkl")
    timed("priors", lambda: priors.run(priors.parser().parse_args(["--config-file", BASE_SYNTH, "--out", pkl])))
    with open(pkl, "rb") as f:
        pri = pickle.load(f)
    check(len(pri["categories"]) == 10 and len(pri["priors_dims_per_cat"]) == 10, f"priors: {pri['categories']}")
    mini = timed("datasetminify", lambda: datasetminify.main(
        ["--src", os.path.join(HERE, "datasets", "Omni3D", "synth_train.json"), "--out",
         os.path.join(out, "synth_train_mini.json"), "--count", "5"]))
    with open(mini) as f:
        check(len(json.load(f)["images"]) == 5, "datasetminify did not keep 5 images")
    losses = timed("grid_effect", lambda: grid_effect.run(dev))
    cpu = grid_effect.run("cpu")
    check(all(abs(losses[d] - cpu[d]) <= 1e-5 for d in cpu), f"grid_effect card {losses} vs CPU {cpu}")
    vis = timed("visualise_gt", lambda: visualise_gt.run(visualise_gt.parser().parse_args(
        ["--dataset-json", os.path.join(HERE, "datasets", "Omni3D", "synth_train.json"), "--image-root",
         os.path.join(HERE, "datasets"), "--out-dir", os.path.join(out, "gt_vis"), "--max-images", "3", "--run-dirs",
         run_dir, run_dir, "--run-names", "base", "again"]), dev))
    check(len(vis["drawn"]) == 3 and vis["outliers"] == 0 and len(vis["ap3d_vs_ap2d"]["log"]) == 2,
          f"visualise_gt: {len(vis['drawn'])} drawn, {vis['outliers']} outliers")
    series = timed("results", lambda: results.run(results.parser().parse_args(
        ["--metrics", os.path.join(run_dir, "metrics.json"), "--out-dir", os.path.join(out, "plots")])))
    check("total_loss" in series and len(series["total_loss"][0]) > 0, f"results: {list(series)}")
    mabo_json = os.path.join(out, "mabo_results.json")
    with open(mabo_json, "w") as f:
        json.dump(mabo_results, f)
    mabo = timed("mabo_plots", lambda: mabo_plots.run(mabo_plots.parser().parse_args(
        ["--results", mabo_json, "--out-dir", os.path.join(out, "mabo")])))
    check(len(mabo["combinations"]) == 26 and mabo["mabo"], f"mabo_plots: {mabo}")
    figures = glob.glob(os.path.join(out, "**", "*.png"), recursive=True)
    for path in figures:
        check(read_png(path).ndim == 3, f"{path} does not re-read")
    print(f"[tools] {smi}: fit_proposal_coefs {len(fit['pairs']['x'])} pairs, " + ", ".join(
        f"{a}: gt = {v[0]:+.4f} median {v[1]:+.4f}" for a, v in fit["fits"].items())
          + f"; grid_effect 1 - IoU {[round(v, 4) for v in losses.values()]} (card = CPU within 1e-5); "
          f"visualise_gt {len(vis['drawn'])} drawings; {len(figures)} PNG figures re-read; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    return seconds


def phase_png_and_tools(torch, dev, checkpoint: str, kitti_json: str, kitti_threshold: float,
                        mabo_results: dict) -> dict:
    """Phase 21: the PNG kernel's gate, the progressive JPEG gate, the JPEG
    colour gate and the demo on rewritten JPEGs (``colour_gate``), the
    arithmetic and lossless JPEG gate and the demo on such files
    (``entropy_gate``), the gate of out-of-range and damaged JPEGs
    (``damage_gate``), the gate of incomplete progressions, which libjpeg
    smooths, and the demo on such files and on four damaged ones
    (``smooth_gate``), PNG copies
    of synth_test (plain and Adam7) decoded on the card, kitti_demo on each,
    depth_to_pointcloud on a KITTI-shaped PNG
    with an official-layout checkpoint, and the other tools. Returns the PNG
    kernel's row, its launches in the tools, and K1's and K9's."""
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    row = png_gate(torch, dev, smi)
    progressive_gate(torch, dev, smi)
    colour = colour_gate(torch, dev, smi, checkpoint)
    entropy = entropy_gate(torch, dev, smi, checkpoint)
    damage = damage_gate(torch, dev, smi)
    smooth = smooth_gate(torch, dev, smi, checkpoint, damage["demo"])
    copies = png_root(torch, dev)
    kitti = kitti_demo_png(torch, dev, smi, checkpoint, kitti_json, kitti_threshold)
    png_root(torch, dev, PNG_ROOT_ADAM7, interlace=True)
    adam7 = kitti_demo_png(torch, dev, smi, checkpoint, kitti["predictions_json"], kitti_threshold, PNG_ROOT_ADAM7,
                           "the Adam7 PNG copies", "the run on the plain PNG copies")
    cloud = depth_to_pointcloud_png(torch, dev, smi)
    tools = other_tools(torch, dev, smi, os.path.dirname(checkpoint), mabo_results)
    seconds = time.perf_counter() - t0
    print(f"[png] {smi}: phase 21 took {seconds:.1f} s ({len(copies)} PNG copies of synth_test, plain and Adam7)",
          flush=True)
    return dict(row=row, png=kitti["png"] + adam7["png"] + cloud["png"], k1=kitti["k1"] + adam7["k1"], k9=cloud["k9"],
                tools=tools, seconds=seconds, colour=colour, entropy=entropy, smooth=smooth, damage=damage)


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
    sources = [*KERNELS, "jpeg_decode", "png_decode"]  # the TPU kernels' ports and the card's image decoders
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    for name, (lib, log, compile_s) in builds.items():
        print(f"[build] {lib.name}: nvcc {compile_s:.2f} s", flush=True)
        for line in build_report(log):
            print(f"[build] {name}: {line}", flush=True)
    print(f"[build] {len(builds)} sources in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3-6: every kernel against its plain version
    k1 = phase_kernel(torch, dev)
    k2 = phase_kernel_bwd(torch, dev)
    fused = phase_fused_kernels(torch, dev, _fused_cases, "dla34")
    fused_resnet = phase_fused_kernels(torch, dev, _resnet_cases, "resnet34")
    phase_k4(torch, dev, fused_resnet["basic_block"])
    phase_k5_k8(torch, dev, fused)
    phase_k6_k7(torch, dev, fused, fused_resnet["block_down"])
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

    # 17: the JPEG decode gate and the weak-method asset tools (before the
    # phases that train on the decoder's images)
    assets = phase_weak_assets(torch, dev)

    # 14: Base_Synth from the fixture's JPEGs to AP
    synth_rows, synth_runs, synth_checkpoint = phase_base_synth(torch, dev)
    synth_k1 = sum(r["k1_launches_training"] + r["k1_launches_eval"] for r in synth_runs)
    synth_k2 = sum(r["k2_launches_training"] for r in synth_runs)

    # 15: weak Cube R-CNN (Omni_combined_Synth) from the fixture to AP
    weak_rows, weak_runs, _ = phase_weak_synth(torch, dev)
    weak_k1 = sum(r["k1_launches_training"] + r["k1_launches_eval"] for r in weak_runs)
    weak_k2 = sum(r["k2_launches_training"] for r in weak_runs)

    # 16: BoxNet (BoxNet_Synth): propose and score, MABO, AP PRED, pseudo ground truth, Base_Synth on it
    boxnet = phase_boxnet_synth(torch, dev)

    # 18: the weak segmentation loss on SAM's masks, the cube head's options, 2D-only
    options = phase_seg_and_options(torch, dev, assets["sam_checkpoint"])

    # 19: data parallelism: no group, a world-1 NCCL group, two gloo ranks on the card
    ddp = phase_ddp(torch, dev)

    # 20: the other DLA trunks, K8 at their widths, oracle 2D boxes, the demos, vis_period, KITTI
    dla = phase_dla_and_drawings(torch, dev, synth_checkpoint)

    # 21: PNG on the card, the official checkpoints' loader, the rest of the tools
    tools = phase_png_and_tools(torch, dev, synth_checkpoint, dla["kitti_json"], dla["kitti_threshold"],
                                boxnet["runs"]["MABO GT"]["results"])

    # 11: the depth path
    depth_launches, _ = phase_depth_path(torch, dev, k9[("bfloat16", 2443)]["ms"])
    phase_depth_card_vs_cpu(torch, dev)

    # 13: depth fine-tuning
    train_k9, train_k9b = phase_depth_train(torch, dev, k9b)
    entry = phase_depth_train_entry(torch, dev)
    phase_depth_train_card_vs_cpu(torch, dev)

    # 12: the GroundingDINO path
    gdino_launches, _, k3_model = phase_gdino_path(torch, dev)
    phase_gdino_card_vs_cpu(torch, dev)

    def on_paths(key):
        """Launches of one kernel on the four serving runs, by backbone."""
        return {b: fl[key] + sl[key] for b, (fl, sl) in runs.items()}

    k1_serving = sum(on_paths("roi_align_fwd").values())
    # BoxNet_Synth runs K1 and K2 at Base_Synth's shapes: its rows are those
    kernels = [
        {"name": "roi_align_fwd", "route": "cuda", **KERNELS["roi_align_fwd"],
         "launches": k1_serving + train_fwd + rn_fwd + synth_k1 + weak_k1 + boxnet["k1"] + options["launches"]["k1"]
         + ddp["k1"] + dla["k1"] + tools["k1"],
         "launches_serving": k1_serving, "launches_training": train_fwd + rn_fwd, "launches_base_synth": synth_k1,
         "launches_weak_synth": weak_k1, "launches_boxnet_synth": boxnet["k1"],
         "launches_seg_and_options": options["launches"]["k1"], "launches_data_parallel": ddp["k1"],
         "launches_dla_trunks_and_tools": dla["k1"], "launches_png_kitti_demo": tools["k1"],
         **k1[("bfloat16", 8000)], "library_ms": None, "base_synth_shapes": synth_rows["roi_align_fwd"],
         "weak_synth_shapes": weak_rows["roi_align_fwd"], "boxnet_synth_shapes": "base_synth_shapes",
         "cube_pool_shapes": options["rows"]["roi_align_fwd"]},
        {"name": "roi_align_bwd", "route": "cuda", **KERNELS["roi_align_bwd"],
         "launches": train_bwd + rn_bwd + synth_k2 + weak_k2 + boxnet["k2"] + options["launches"]["k2"] + ddp["k2"]
         + dla["k2"],
         "launches_serving": 0, "launches_training": train_bwd + rn_bwd, "launches_base_synth": synth_k2,
         "launches_weak_synth": weak_k2, "launches_boxnet_synth": boxnet["k2"],
         "launches_seg_and_options": options["launches"]["k2"], "launches_data_parallel": ddp["k2"],
         "launches_dla102x_training": dla["k2"],
         **k2["bfloat16"], "library_ms": None, "base_synth_shapes": synth_rows["roi_align_bwd"],
         "weak_synth_shapes": weak_rows["roi_align_bwd"], "boxnet_synth_shapes": "base_synth_shapes",
         "cube_pool_shapes": options["rows"]["roi_align_bwd"]},
    ]
    for key in FUSED_LAUNCHES["dla34"]:
        # times and bound summed over the launches of one bf16 forward: the
        # ResNet34 forward's for K4, the DLA34 forward's for K5 to K8 (K6's
        # ResNet34 shapes are listed beside them, and summed under resnet34_*);
        # no single PyTorch call computes any of the five, so no library time
        rows = (fused_resnet if key == "basic_block" else fused)[key]["bfloat16"]
        extra = fused_resnet[key]["bfloat16"] if key == "block_down" else []
        by_bytes = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        by_ops = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        per_path = on_paths(key)
        # phase 20's dla102x forwards under fused_forward(): K7 and K8 (K8 also at the new trunks' shapes)
        per_path["dla102x"] = {"conv_relu_head": dla["k7"], "fpn_level": dla["k8"]}.get(key, 0)
        extra = extra + (dla["k8_rows"] if key == "fpn_level" else [])
        kernels.append({
            "name": f"fused_{key}", "route": "cuda", **KERNELS[f"fused_{key}"],
            "launches": sum(per_path.values()), "launches_serving": sum(per_path.values()), "launches_training": 0,
            "launches_by_backbone": per_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows + extra),
            "ms": _total(rows, "ms"), "plain_ms": _total(rows, "plain_ms"),
            "bound_ms": by_bytes + by_ops, "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "shapes": rows + extra,
            # the ResNet blocks, the DLA trees, the RPN head and the FPN call them with
            # weights packed once (``ms``); beside it the kernels' own device time and the
            # public call that packs at every call; K5's, K7's and K8's 1x1 launches alone,
            # K6's stride-2 launches alone
            "ms": _total(rows, "packed_call_ms"), "kernel_ms": _total(rows, "kernel_ms"),
            "call_packing_ms": _total(rows, "ms"),
            **({"conv1x1_ms": _total(rows, "conv1x1_ms")} if key in ("tree_tail", "conv_relu_head", "fpn_level")
               else {}),
            **({"stride2_ms": _total(rows, "stride2_ms"),
                **{f"resnet34_{k}": _total(extra, r) for k, r in (
                    ("ms", "packed_call_ms"), ("kernel_ms", "kernel_ms"), ("call_packing_ms", "ms"),
                    ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"))}} if key == "block_down" else {}),
        })
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda", **KERNELS["flash_attention_fwd"],
        "launches": depth_launches + train_k9 + tools["k9"], "launches_serving": depth_launches,
        "launches_training": train_k9, "launches_training_entry": entry["flash_attention_launches"],
        "launches_depth_to_pointcloud": tools["k9"], **k9[("bfloat16", 2443)],
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
    # encoder's shape, 6 at the decoder's) on the uniform inputs, and beside
    # them the same sums on the model's own 12 inputs (``model_*``); the
    # library time is the grid_sample composition, four grid_sample calls and
    # a weighted sum, not one call
    k3_rows = [dict(shape=f"{d} Lq={lq} uniform (x6)", count=6, **row) for (d, lq), row in k3.items()]
    k3_bf16 = [r for r in k3_rows if r["shape"].startswith("bfloat16")]
    kernels.append({
        "name": "ms_deform_sample", "route": "cuda", **KERNELS["ms_deform_sample"],
        "launches": gdino_launches + assets["launches"]["k3"], "launches_serving": gdino_launches,
        "launches_training": 0, "launches_ground_tool": assets["launches"]["k3"],
        "ground_tool_model_launches": {d: {k: r[k] for k in ("kernel_ms", "ms", "plain_ms", "bound_ms", "max_abs_err")}
                                       for d, r in assets["k3"].items()},
        "max_abs_err": max([r["max_abs_err"] for r in k3_rows] + [m["max_abs_err"] for m in k3_model.values()]),
        **{key: _total(k3_bf16, key) for key in ("ms", "kernel_ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in k3_bf16) else "operations",
        **{f"model_{key}": k3_model["bfloat16"][key] for key in ("kernel_ms", "ms", "plain_ms", "bound_ms")},
        **{f"model_f32_{key}": k3_model["float32"][key] for key in ("kernel_ms", "ms", "bound_ms")},
        "library": "grid_sample composition (ms_deform_attn_core_pytorch: 4 grid_sample calls and a weighted sum)",
        "shapes": k3_rows,
        "model_launches": [dict(dtype=d, **r) for d, m in k3_model.items() for r in m["rows"]],
    })
    # the card's JPEG decoder: replaces no TPU kernel (the JAX package decodes on
    # the host with libjpeg); launches are those of phase 17's tools and of
    # phase 21's demos on rewritten JPEGs (colour spaces and samplings;
    # arithmetic and lossless files); the colour kernel's rows at phase 21's
    # three 640x480 files and its 640x480 lossless file beside its phase 17
    # times; the IDCT's row carries the host decode's ms of the arithmetic
    # transcodes and of the lossless file, and the damage gate's times of both
    # instances in one session (the smoothing demo's launches include its four
    # damaged images)
    colour, entropy, smooth, damage = tools["colour"], tools["entropy"], tools["smooth"], tools["damage"]
    for name, key in (("jpeg_idct", "idct"), ("jpeg_color", "color")):
        kernels.append({
            "name": name, "route": "cuda", "source": "threedod_torch/ops/csrc/jpeg_decode.cu",
            "replaces": "no TPU kernel: the host libjpeg decode of native/loaderc.cpp:50",
            "launches": assets["launches"][name] + colour[key] + entropy[key] + smooth[key],
            "launches_asset_tools": assets["launches"][name], "launches_demo_rewritten_jpegs": colour[key],
            "launches_demo_entropy_jpegs": entropy[key], "launches_demo_smoothed_jpegs": smooth[key],
            **assets["jpeg"][name],
            **({"shapes": colour["rows"] + [entropy["row"]]} if name == "jpeg_color" else
               {"arithmetic_transcodes_host_ms": entropy["transcodes"],
                "lossless_640x480_host_ms": entropy["lossless_host_ms"],
                "damage_gate": {k: damage[k] for k in ("plain_ms", "cut_ms", "smooth_ms", "bound_ms", "blocks",
                                                        "read", "refused")}}),
        })
    # the IDCT kernel's smoothing instance (incomplete progressions): its
    # launches are those of phase 21's demo on such files, its times those of
    # the 640x480 4:2:0 DC-only file beside the plain instance's
    kernels.append({
        "name": "jpeg_idct_smooth", "route": "cuda", "source": "threedod_torch/ops/csrc/jpeg_decode.cu",
        "replaces": "no TPU kernel: libjpeg's block smoothing (jdcoefct.c decompress_smooth_data) in the host decode "
                    "of native/loaderc.cpp:50",
        "launches": smooth["smooth"], **smooth["row"],
    })
    # the card's PNG decoder: replaces no TPU kernel (the JAX package reads PNG files on
    # the host with Pillow); launches are those of phase 21's tools
    kernels.append({
        "name": "png_decode", "route": "cuda", "source": "threedod_torch/ops/csrc/png_decode.cu",
        "replaces": "no TPU kernel: the host Pillow decode of threedod/data/native_io.py:29",
        "launches": tools["png"], **tools["row"],
    })
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
