// Multilevel ROIAlignV2 backward for Hopper (sm_90a), kernel K2 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/roi_align_pallas.py::_bwd_kernel
// (launched by _pallas_backward, wired into autodiff by _make_pooler).
// Computes what threedod_torch/ops/roi_align.py::roi_align_backward computes:
// the gradient of the multilevel ROIAlign forward (roi_align_fwd.cu) with
// respect to the level maps. Every bin's cotangent, divided by its r x r
// samples, is sent back to the four taps of each sample with the forward's
// bilinear weights, border rule (nothing outside [-1, dim], clamped into
// [0, dim-1] inside) and level, so it lands exactly where the forward read.
//
// Inputs: cotangent g (B*N, S, S, C) f32; boxes (B*N, 4) f32; level (B*N,)
// int32, from the wrapper, the same assignment the forward used. Output: one
// f32 plane per level (B, H_l, W_l, C), zeroed by the wrapper on the same
// stream before the launch; the wrapper casts to the feature dtype after.
//
// What bounds it: bytes, and the atomic units of the L2. Each ROI reads
// 49 x C x 4 bytes of cotangent once and makes up to 49 x r^2 x 4 scattered
// read-modify-writes of C floats (C = 256, r = 2: 784 KB per ROI, most of it
// to cells that neighbouring samples and overlapping ROIs also write).
// There is no arithmetic to speak of. Blocks run in no order and many ROIs
// overlap, so the sum across ROIs is made with atomicAdd in global memory;
// on sm_90 that exists for float4, which cuts the number of atomic
// operations fourfold against scalar adds. One block per (ROI, bin row),
// threads across channels, four channels a thread: a warp's atomics cover a
// contiguous 512-byte run of one cell. Where the TPU kernel walks the ROIs
// in a fixed order through a VMEM window with conflict flags, here the order
// of the f32 additions is whatever the hardware takes, so two runs may
// differ in the last bits.

#include <cuda_runtime.h>

#include <stdint.h>

#define MAX_LEVELS 5

struct GradLevels {
  float* ptr[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];
};

// One sample coordinate along an axis, as in roi_align_fwd.cu: false outside
// the band; else both taps (the second clamped into the map, where its
// weight is 0) and the fraction towards the second.
__device__ __forceinline__ bool axis_sample(float coord, int limit, int* i0, int* i1, float* frac) {
  if (coord < -1.0f || coord > (float)limit) return false;
  const float cc = fminf(fmaxf(coord, 0.0f), (float)(limit - 1));
  const float f0 = floorf(cc);
  *i0 = (int)f0;
  *i1 = min(*i0 + 1, limit - 1);
  *frac = __fsub_rn(cc, f0);
  return true;
}

__device__ __forceinline__ void add4(float* p, float w, const float4& g) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
#else
  atomicAdd(p + 0, w * g.x);
  atomicAdd(p + 1, w * g.y);
  atomicAdd(p + 2, w * g.z);
  atomicAdd(p + 3, w * g.w);
#endif
}

__global__ void roi_align_bwd_kernel(GradLevels lv, const float* __restrict__ grad,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ level,
                                     int rois_per_image, int C, int S, int R) {
  const int row = blockIdx.x;  // roi * S + bin row
  const int roi = row / S;
  const int py = row - roi * S;
  const int img = roi / rois_per_image;
  const int l = level[roi];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float scale = lv.scale[l];
  float* plane = lv.ptr[l] + (size_t)img * H * W * C;

  // the forward's geometry, operation for operation
  const float x1 = __fsub_rn(__fmul_rn(boxes[4 * roi + 0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(boxes[4 * roi + 1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(boxes[4 * roi + 2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(boxes[4 * roi + 3], scale), 0.5f);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1e-6f), (float)S);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1e-6f), (float)S);
  const float inv_count = 1.0f / (float)(R * R);

  const int nvec = C / 4;
  for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
    const int c0 = cv * 4;
    for (int px = 0; px < S; ++px) {
      float4 g = *reinterpret_cast<const float4*>(grad + (((size_t)roi * S + py) * S + px) * C + c0);
      g.x *= inv_count;
      g.y *= inv_count;
      g.z *= inv_count;
      g.w *= inv_count;
      for (int iy = 0; iy < R; ++iy) {
        const float gy = __fdiv_rn((float)(py * R + iy) + 0.5f, (float)R);
        int ya, yb;
        float ly;
        if (!axis_sample(__fadd_rn(y1, __fmul_rn(gy, bin_h)), H, &ya, &yb, &ly)) continue;
        for (int ix = 0; ix < R; ++ix) {
          const float gx = __fdiv_rn((float)(px * R + ix) + 0.5f, (float)R);
          int xa, xb;
          float lx;
          if (!axis_sample(__fadd_rn(x1, __fmul_rn(gx, bin_w)), W, &xa, &xb, &lx)) continue;
          add4(plane + ((size_t)ya * W + xa) * C + c0, (1.0f - ly) * (1.0f - lx), g);
          add4(plane + ((size_t)ya * W + xb) * C + c0, (1.0f - ly) * lx, g);
          add4(plane + ((size_t)yb * W + xa) * C + c0, ly * (1.0f - lx), g);
          add4(plane + ((size_t)yb * W + xb) * C + c0, ly * lx, g);
        }
      }
    }
  }
}

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. The planes
// in `lv` must have been zeroed on the same stream.
int threedod_roi_align_bwd(GradLevels lv, const float* grad, const float* boxes, const int* level,
                           int num_rois, int rois_per_image, int C, int S, int R,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_rois == 0) return 0;
  const int nvec = C / 4;
  const int threads = min(256, ((nvec + 31) / 32) * 32);
  const dim3 grid((unsigned)num_rois * (unsigned)S);
  roi_align_bwd_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, grad, boxes, level, rois_per_image, C, S, R);
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
