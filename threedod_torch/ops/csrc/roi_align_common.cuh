// Shared by kernels K1 (roi_align_fwd.cu) and K2 (roi_align_bwd.cu): the
// level table, one ROI's sample geometry and its tap window.
//
// The window. The level bump (ops/roi_align.py::assign_levels) raises every
// ROI until its longest side is at most 30 cells of its level, so its 2 S R
// taps per axis lie inside WIN = 32 cells (WINDOW_Y of the TPU kernel). A
// block describes the window once for the ROI, per axis: for each window row
// (column) the summed bilinear weights of every bin's taps on it and the mask
// of the bins that have one, and for each bin the list of rows (columns) it
// touches with those weights. The bilinear sum over a bin's 4 R^2 taps then
// becomes a sum over the cells it touches, weight row weight x column
// weight: the forward reads each such cell once a bin (about 9 for 16 taps),
// the backward contracts columns then rows and writes each touched window
// cell once a ROI. A ROI whose taps span more than WIN cells (clamped at the
// top level on a canvas wider than about 2048 px) takes a per-tap path of
// the same kernel.
#pragma once

#include <cuda_runtime.h>

namespace roi_align {

constexpr int MAX_LEVELS = 5;
constexpr int WIN = 32;     // window cells a side
constexpr int MAX_S = 8;    // bins a side
constexpr int MAX_SR = 64;  // samples a side, S * R

struct Levels {
  void* ptr[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];
};

struct Level {
  void* ptr;
  int h, w;
  float scale;
};

// The parameters of level l, read at constant indices (a runtime index into
// the parameter struct puts it on the stack).
__device__ __forceinline__ Level pick(const Levels& lv, int l) {
  Level out{lv.ptr[0], lv.h[0], lv.w[0], lv.scale[0]};
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (i == l) out = Level{lv.ptr[i], lv.h[i], lv.w[i], lv.scale[i]};
  }
  return out;
}

// One sample along an axis: its two taps and their weights; t0 < 0 outside
// the [-1, dim] band. Inside it the coordinate clamps into [0, dim-1] and the
// second tap clamps into the map (its weight is 0 whenever that bites).
struct Sample {
  int t0, t1;
  float w0, w1;
};

__device__ __forceinline__ Sample axis_sample(float lo, float bin, int k, int R, int limit) {
  const float g = __fdiv_rn((float)k + 0.5f, (float)R);
  const float coord = __fadd_rn(lo, __fmul_rn(g, bin));
  Sample s{-1, -1, 0.0f, 0.0f};
  if (coord < -1.0f || coord > (float)limit) return s;
  const float cc = fminf(fmaxf(coord, 0.0f), (float)(limit - 1));
  const float f0 = floorf(cc);
  const float frac = __fsub_rn(cc, f0);
  s.t0 = (int)f0;
  s.t1 = min(s.t0 + 1, limit - 1);
  s.w0 = __fsub_rn(1.0f, frac);
  s.w1 = frac;
  return s;
}

// One ROI's geometry on its level. Index 0 is the y axis, 1 the x axis.
struct Window {
  Sample smp[2][MAX_SR];
  float wt[2][WIN][MAX_S];          // summed weights of bin p's taps on window row / column i
  unsigned char mask[2][WIN];       // bit p: bin p has a tap on row / column i
  unsigned char cells[2][MAX_S][WIN];  // the rows / columns bin p touches, in order ...
  float cell_wt[2][MAX_S][WIN];     // ... with their weights for bin p
  int count[2][MAX_S];              // ... and their number
  int origin[2];                    // first row / column of the window in the level
  int extent[2];                    // rows / columns spanned; more than WIN: per-tap path

  __device__ bool fits() const { return extent[0] <= WIN && extent[1] <= WIN; }
};

// Fills `win` for the ROI `box` (image coordinates) on level L, with the
// same arithmetic as the plain version. Warp 0 does the y axis, warp 1 the x
// axis (the block has at least 64 threads); the weight tables sum each cell's
// taps in sample order, so the result does not depend on scheduling. Ends
// with __syncthreads().
__device__ __forceinline__ void build_window(Window& win, const float* box, const Level& L, int S, int R) {
  const int lane = threadIdx.x & 31;
  const int axis = threadIdx.x >> 5;
  if (axis < 2) {
    const int limit = axis ? L.w : L.h;
    const float a = __fsub_rn(__fmul_rn(box[axis ? 0 : 1], L.scale), 0.5f);
    const float b = __fsub_rn(__fmul_rn(box[axis ? 2 : 3], L.scale), 0.5f);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(b, a), 1e-6f), (float)S);
    const int n = S * R;
    Sample* smp = win.smp[axis];
    int lo = 0x7fffffff, hi = -1;
    for (int k = lane; k < n; k += 32) {
      const Sample s = axis_sample(a, bin, k, R, limit);
      smp[k] = s;
      if (s.t0 >= 0) {
        lo = min(lo, s.t0);
        hi = max(hi, s.t1);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const int extent = hi >= lo ? hi - lo + 1 : 0;
    if (lane == 0) {
      win.origin[axis] = hi >= lo ? lo : 0;
      win.extent[axis] = extent;
    }
    __syncwarp();
    if (extent <= WIN) {
      // lane i: window cell origin + i
      float* wt = win.wt[axis][lane];
#pragma unroll
      for (int p = 0; p < MAX_S; ++p) wt[p] = 0.0f;
      unsigned mask = 0;
      const int cell = win.origin[axis] + lane;
      for (int k = 0; k < n; ++k) {
        const Sample s = smp[k];
        const int p = k / R;
        if (s.t0 == cell) {
          wt[p] += s.w0;
          mask |= 1u << p;
        }
        if (s.t1 == cell) {
          wt[p] += s.w1;
          mask |= 1u << p;
        }
      }
      win.mask[axis][lane] = (unsigned char)mask;
      __syncwarp();
      if (lane < S) {
        int n_cells = 0;
        for (int c = 0; c < extent; ++c) {
          if (win.mask[axis][c] >> lane & 1u) {
            win.cells[axis][lane][n_cells] = (unsigned char)c;
            win.cell_wt[axis][lane][n_cells] = win.wt[axis][c][lane];
            ++n_cells;
          }
        }
        win.count[axis][lane] = n_cells;
      }
    }
  }
  __syncthreads();
}

}  // namespace roi_align
