// Multilevel ROIAlignV2 backward for Hopper (sm_90a), kernel K2 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/roi_align_pallas.py::_bwd_kernel
// (launched by _pallas_backward, wired into autodiff by _make_pooler).
// Computes what threedod_torch/ops/roi_align.py::roi_align_backward computes:
// the gradient of the multilevel ROIAlign forward (roi_align_fwd.cu) with
// respect to the level maps. Every bin's cotangent, divided by its R x R
// samples, goes back to the four taps of each sample with the forward's
// bilinear weights, border rule and level, so it lands where the forward read.
//
// Inputs: cotangent g (B*N, S, S, C) f32; boxes (B*N, 4) f32; level (B*N,)
// int32, the assignment the forward wrote. Output: one f32 plane per level
// (B, H_l, W_l, C), zeroed by the wrapper on the same stream before the
// launch; the wrapper casts to the feature dtype after.
//
// What bounds it: bytes, and the L2's atomic units. Blocks run in no order
// and ROIs overlap, so sums across ROIs meet in global atomics; there is no
// arithmetic to speak of (about 1 k multiply-adds a channel a ROI; the dense
// selector products a tensor core could take would be about 9 k). So the
// design cuts the atomics: one global reduction per (ROI, touched window
// cell, 4-channel vector), where a per-tap scatter makes one per tap, 3.4
// times more on detection-like ROIs.
//   * One block per ROI (and per 256 channels), 256 threads; the block builds
//     the ROI's window once (roi_align_common.cuh): at most 32 x 32 cells,
//     with the per-bin weights of every row and column.
//   * The threads walk (touched window column, float4 of channels), lanes
//     across channels, so a warp's atomics cover 512 contiguous bytes of a
//     cell.
//   * Columns first: a thread contracts the cotangent (divided by R x R) of
//     the bins touching its column, from L1, with the column's weights into
//     one float4 for each bin row, in registers.
//   * Rows next: for every touched window row it sums those with the row's
//     per-bin weights and adds the result to the plane with one float4
//     atomicAdd whose result is unused (red.global.add.v4.f32).
// A bulk reduction of each cell's channels through shared memory
// (cp.reduce.async.bulk .add.f32, one 1 KB operation a cell) ran slower than
// the float4 atomics in a side-by-side trial, and is not used.
// Within a ROI the sums run in a fixed order; only overlapping ROIs meet in
// atomics, so two runs may differ in the last bits. The TPU kernel forms the
// window's gradient with selector matmuls and read-modify-writes it once per
// ROI in a fixed order. A ROI whose taps span more than 32 cells (only at the
// clamped top level) scatters tap by tap in the same kernel.

#include <cuda_runtime.h>

#include <stdint.h>

#include "roi_align_common.cuh"

using namespace roi_align;

namespace {

constexpr int CV = 4;  // channels a vector

__device__ __forceinline__ void red_add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p + 0, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& g) {
  acc.x = fmaf(w, g.x, acc.x);
  acc.y = fmaf(w, g.y, acc.y);
  acc.z = fmaf(w, g.z, acc.z);
  acc.w = fmaf(w, g.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float w, const float4& g) {
  return make_float4(w * g.x, w * g.y, w * g.z, w * g.w);
}

constexpr int THREADS = 256;
constexpr int VECS = 64;  // float4s of channels a block

// Two blocks an SM (88 registers, no spill) ran faster than more, smaller
// blocks in side-by-side trials: fewer atomics in flight at once.
__global__ void __launch_bounds__(THREADS, 2)
roi_align_bwd_kernel(Levels lv, const float* __restrict__ grad, const float* __restrict__ boxes,
                     const int* __restrict__ level, int rois_per_image, int C, int S, int R) {
  __shared__ Window win;

  const int roi = blockIdx.x;
  const Level L = pick(lv, level[roi]);
  build_window(win, boxes + 4 * roi, L, S, R);

  const int img = roi / rois_per_image;
  const int c_lo = blockIdx.y * VECS * CV;
  const int nv = min(VECS, (C - c_lo) / CV);  // float4s of this block
  const float* g = grad + (size_t)roi * S * S * C + c_lo;
  float* plane = static_cast<float*>(L.ptr) + (size_t)img * L.h * L.w * C + c_lo;
  const size_t row_stride = (size_t)L.w * C;
  const float inv_count = 1.0f / (float)(R * R);

  if (!win.fits()) {
    // per-tap path: one (bin, channel vector) at a time, four atomics a sample
    for (int i = threadIdx.x; i < S * S * nv; i += THREADS) {
      const int bin = i / nv, c0 = (i - bin * nv) * CV, py = bin / S, px = bin - py * S;
      const float4 gv = scale4(inv_count, __ldg(reinterpret_cast<const float4*>(g + (size_t)bin * C + c0)));
      for (int iy = py * R; iy < (py + 1) * R; ++iy) {
        const Sample sy = win.smp[0][iy];
        if (sy.t0 < 0) continue;
        for (int ix = px * R; ix < (px + 1) * R; ++ix) {
          const Sample sx = win.smp[1][ix];
          if (sx.t0 < 0) continue;
          red_add4(plane + sy.t0 * row_stride + (size_t)sx.t0 * C + c0, scale4(sy.w0 * sx.w0, gv));
          red_add4(plane + sy.t0 * row_stride + (size_t)sx.t1 * C + c0, scale4(sy.w0 * sx.w1, gv));
          red_add4(plane + sy.t1 * row_stride + (size_t)sx.t0 * C + c0, scale4(sy.w1 * sx.w0, gv));
          red_add4(plane + sy.t1 * row_stride + (size_t)sx.t1 * C + c0, scale4(sy.w1 * sx.w1, gv));
        }
      }
    }
    return;
  }

  const int cols = win.extent[1], rows = win.extent[0];
  float* origin = plane + (size_t)win.origin[0] * row_stride + (size_t)win.origin[1] * C;
  for (int i = threadIdx.x; i < cols * nv; i += THREADS) {
    const int x = i / nv, c0 = (i - x * nv) * CV;
    const unsigned cmask = win.mask[1][x];
    if (!cmask) continue;
    float4 a[MAX_S];
#pragma unroll
    for (int p = 0; p < MAX_S; ++p) a[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int px = 0; px < MAX_S; ++px) {
      if (cmask >> px & 1u) {
        const float w = __fmul_rn(inv_count, win.wt[1][x][px]);
#pragma unroll
        for (int p = 0; p < MAX_S; ++p) {
          if (p < S) fma4(a[p], w, __ldg(reinterpret_cast<const float4*>(g + (size_t)(p * S + px) * C + c0)));
        }
      }
    }
    float* col = origin + (size_t)x * C + c0;
    for (int r = 0; r < rows; ++r) {
      const unsigned m = win.mask[0][r];
      if (!m) continue;
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int p = 0; p < MAX_S; ++p) {
        if (m >> p & 1u) fma4(d, win.wt[0][r][p], a[p]);
      }
      red_add4(col + r * row_stride, d);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. The planes
// in `lv` must have been zeroed on the same stream. C must be a multiple of
// 4; S <= 8, S * R <= 64.
int threedod_roi_align_bwd(Levels lv, const float* grad, const float* boxes, const int* level, int num_rois,
                           int rois_per_image, int C, int S, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_rois == 0) return 0;
  const dim3 grid((unsigned)num_rois, (unsigned)((C + VECS * CV - 1) / (VECS * CV)));
  roi_align_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, grad, boxes, level, rois_per_image, C, S, R);
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
