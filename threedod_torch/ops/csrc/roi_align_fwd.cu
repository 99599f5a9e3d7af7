// Multilevel ROIAlignV2 forward for Hopper (sm_90a), kernel K1 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/roi_align_pallas.py::_kernel
// (launched by _pallas_forward, public entry multilevel_roi_align_tpu).
// Computes what threedod_torch/ops/roi_align.py::roi_align_levels computes:
// for every ROI, on its assigned pyramid level, S x S bins of R x R bilinear
// samples with the ROIAlignV2 border rule (zero outside [-1, dim], clamped
// into [0, dim-1] inside), averaged per bin. It also assigns the levels, with
// the arithmetic of ops/roi_align.py::assign_levels as PyTorch runs it on
// the card, and writes them out for the backward (K2).
//
// Inputs: up to five channels-last level maps (B, H_l, W_l, C), f32 or bf16;
// boxes (B*N, 4) f32 in image coordinates. Outputs (B*N, S, S, C) in the
// feature dtype, summed in f32, and the level index of each ROI (B*N,) int32.
//
// What bounds it: bytes. Its work is a gather, about 1 k multiply-adds a
// channel a ROI against 2 to 8 bytes read for each; tensor cores would need
// the dense selector products of the TPU kernel (about 9 k a channel a ROI)
// and buy nothing. What this card offers a gather is wide loads, enough warps
// in flight to cover the latency of L2, and the L1 in front of it, and the
// design is built on them:
//   * one block per ROI, one warp per bin at a time (S warps take the S x S
//     bins in turns), lanes across 16-byte channel vectors, so a warp reads
//     one cell's channels in one access (512 bytes at C = 256 in bf16; in f32
//     a lane takes two vectors, two 512-byte accesses a cell); wider maps take
//     the channels in further passes;
//   * the block builds the ROI's window once (roi_align_common.cuh): at most
//     32 x 32 cells, with every bin's touched rows and columns and their
//     summed weights, so a bin reads each cell its taps touch once (about 9
//     cells where it has 16 taps), weighted row weight x column weight;
//   * a lane keeps one bin's channel vectors in registers (40 registers in
//     bf16, 6 blocks of 7 warps an SM; 64 in f32, 4 blocks), so enough loads
//     are in flight to cover L2's latency; cells shared by neighbouring bins
//     come again from L1, since the ROI's bins all run in one block;
//   * each bin's channel vector is stored with one 16-byte store.
// The TPU kernel pools a DMA'd 32 x 48 VMEM window with matmuls; here the
// window's cells come straight into registers. A ROI whose taps span more
// than 32 cells (only at the clamped top level) pools tap by tap in the same
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "roi_align_common.cuh"

using namespace roi_align;

namespace {

// 16 bytes of T: the raw load, widened to f32, and the narrowing store.
template <typename T>
struct VecIO;

template <>
struct VecIO<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void widen(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct VecIO<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void widen(const Raw& r, float* v) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// assign_levels on one box, operation for operation as PyTorch computes it on
// the card: separate roundings (no contraction), a division by a Python
// scalar as a product with its f32 reciprocal. lmin, lmax: the pyramid's
// first and last level numbers (2..6); inv_stride0: 1 / stride of lmin.
__device__ __forceinline__ int assign_level(const float* box, int lmin, int lmax, float inv_stride0) {
  const float bw = __fsub_rn(box[2], box[0]);
  const float bh = __fsub_rn(box[3], box[1]);
  const float area = fmaxf(__fmul_rn(bw, bh), (float)1e-6);
  const float side = __fmul_rn(__fsqrt_rn(area), 1.0f / 224.0f);
  const float lvl = floorf(__fadd_rn(log2f(__fadd_rn(side, (float)1e-8)), 4.0f));
  const int assign = (int)fminf(fmaxf(lvl, (float)lmin), (float)lmax) - lmin;
  const float ext_cells = __fmul_rn(fmaxf(bw, bh), inv_stride0);
  const float need = ceilf(log2f(fmaxf(__fmul_rn(ext_cells, 1.0f / 30.0f), (float)1e-6)));
  return max(assign, (int)fminf(fmaxf(need, 0.0f), (float)(lmax - lmin)));
}

// NVEC: 16-byte channel vectors a lane, 32 x NVEC a warp per pass. The
// register budget, 64 for f32 (two vectors a lane) and 40 for bf16 (a few
// bytes spill to L1), and the unroll of 2 are the fastest of the trials at the
// heads' shapes.
template <typename T, int NVEC>
__global__ void __launch_bounds__(32 * MAX_S, sizeof(T) == 2 ? 6 : 4)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ boxes, int* __restrict__ level_out, T* __restrict__ out,
                     int rois_per_image, int C, int S, int R, int lmin, int lmax) {
  using IO = VecIO<T>;
  constexpr int VN = IO::N;
  constexpr int STEP = 32 * VN;  // channels between a lane's vectors
  __shared__ Window win;

  const int roi = blockIdx.x;
  const float* box = boxes + 4 * roi;
  const int l = assign_level(box, lmin, lmax, lv.scale[0]);
  if (threadIdx.x == 0) level_out[roi] = l;
  const Level L = pick(lv, l);
  build_window(win, box, L, S, R);

  const int img = roi / rois_per_image;
  const T* feat = static_cast<const T*>(L.ptr) + (size_t)img * L.h * L.w * C;
  T* dst = out + (size_t)roi * S * S * C;
  const size_t row_stride = (size_t)L.w * C;
  const float inv_count = 1.0f / (float)(R * R);
  const int warps = blockDim.x >> 5;
  const bool fits = win.fits();
  const T* corner = feat + (size_t)win.origin[0] * row_stride + (size_t)win.origin[1] * C;

  for (int c0 = (threadIdx.x & 31) * VN; c0 < C; c0 += NVEC * STEP) {
    bool on[NVEC];
#pragma unroll
    for (int i = 0; i < NVEC; ++i) on[i] = c0 + i * STEP < C;
    for (int bin = threadIdx.x >> 5; bin < S * S; bin += warps) {
      const int py = bin / S, px = bin - py * S;
      float acc[NVEC][VN] = {};
      if (fits) {
        const int nr = win.count[0][py], nc = win.count[1][px];
        for (int a = 0; a < nr; ++a) {
          const T* row = corner + win.cells[0][py][a] * row_stride + c0;
          const float wr = win.cell_wt[0][py][a];
#pragma unroll 2
          for (int b = 0; b < nc; ++b) {
            const T* cell = row + (size_t)win.cells[1][px][b] * C;
            const float w = wr * win.cell_wt[1][px][b];
#pragma unroll
            for (int i = 0; i < NVEC; ++i) {
              if (on[i]) {
                float v[VN];
                IO::widen(IO::load(cell + i * STEP), v);
#pragma unroll
                for (int c = 0; c < VN; ++c) acc[i][c] = fmaf(w, v[c], acc[i][c]);
              }
            }
          }
        }
      } else {
        // per-tap path: taps from global memory, sample by sample
        for (int iy = py * R; iy < (py + 1) * R; ++iy) {
          const Sample sy = win.smp[0][iy];
          if (sy.t0 < 0) continue;
          for (int ix = px * R; ix < (px + 1) * R; ++ix) {
            const Sample sx = win.smp[1][ix];
            if (sx.t0 < 0) continue;
#pragma unroll
            for (int i = 0; i < NVEC; ++i) {
              if (!on[i]) continue;
              const T* f = feat + c0 + i * STEP;
              float v00[VN], v01[VN], v10[VN], v11[VN];
              IO::widen(IO::load(f + sy.t0 * row_stride + (size_t)sx.t0 * C), v00);
              IO::widen(IO::load(f + sy.t0 * row_stride + (size_t)sx.t1 * C), v01);
              IO::widen(IO::load(f + sy.t1 * row_stride + (size_t)sx.t0 * C), v10);
              IO::widen(IO::load(f + sy.t1 * row_stride + (size_t)sx.t1 * C), v11);
#pragma unroll
              for (int c = 0; c < VN; ++c) {
                acc[i][c] += sy.w0 * (sx.w0 * v00[c] + sx.w1 * v01[c]) + sy.w1 * (sx.w0 * v10[c] + sx.w1 * v11[c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NVEC; ++i) {
        if (on[i]) {
#pragma unroll
          for (int c = 0; c < VN; ++c) acc[i][c] *= inv_count;
          IO::store(dst + (size_t)bin * C + c0 + i * STEP, acc[i]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. C must be a
// multiple of 8 (bf16) or 4 (f32); S <= 8, S * R <= 64; the levels lmin..lmax
// are consecutive.
int threedod_roi_align_fwd(Levels lv, const float* boxes, int* level_out, void* out, int num_rois,
                           int rois_per_image, int C, int S, int R, int lmin, int lmax, int is_bf16, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_rois == 0) return 0;
  const int threads = 32 * (S < 2 ? 2 : S);  // S warps take the bins in turns; build_window needs two
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16, 1><<<num_rois, threads, 0, s>>>(
        lv, boxes, level_out, static_cast<__nv_bfloat16*>(out), rois_per_image, C, S, R, lmin, lmax);
  } else {
    roi_align_fwd_kernel<float, 2><<<num_rois, threads, 0, s>>>(
        lv, boxes, level_out, static_cast<float*>(out), rois_per_image, C, S, R, lmin, lmax);
  }
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
