// Stride-1 residual BasicBlock in one kernel for Hopper (sm_90a), kernel K4
// of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/fused_conv.py::_bb_kernel
// (public entry fused_basic_block). Computes what
// threedod_torch/ops/fused_conv.py::basic_block_reference computes:
//     t   = relu(conv3x3(x, w1) + b1)        rounded to the storage type
//     out = relu(conv3x3(t, w2) + b2 + x)
// x and out (B, H, W, C) channels-last. Weights in the layout of the storage
// type (fused_conv_common.cuh): float (3, 3, Cin, Cout), bfloat16 (3, 3, Cout,
// Cin), BatchNorm folded in; biases f32.
//
// What bounds it: operations (2 * 2 * 9 * C * C a position; at C >= 64 that
// is hundreds of operations a byte moved). One block owns a tile of th x tw
// positions: it loads x with a halo of 2, forms t on the tile plus a halo of
// 1 in shared memory (zero outside the image, because the second
// convolution pads with zeros and not with the first one evaluated outside),
// and runs the second product on the tile's own positions, adding bias and
// the residual from the x tile to the f32 sums before the one rounding. t
// never reaches device memory. The halo makes the first convolution run on
// more positions than the tile has; of the tiles that fit the 227 KB of
// shared memory the launcher takes the one with the least work.

#include "fused_conv_common.cuh"

using namespace fc;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
basic_block_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                   const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                   int C, int th, int tw) {
  constexpr int NP = IO<T>::NP, EW = IO<T>::EW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xh = th + 4, xw = tw + 4;
  const int t2 = tw + 2;
  const int cp = IO<T>::pitch(C);  // channel pitch of both tiles
  float* wsm = reinterpret_cast<float*>(smem);
  T* xt = reinterpret_cast<T*>(smem + WSM_BYTES);
  T* tt = xt + (size_t)xh * xw * cp;

  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  load_tile<T>(xt, x + (size_t)b * H * W * C, H, W, C, y0 - 2, x0 - 2, xh, xw);
  __syncthreads();

  // t = relu(conv(x) + b1) on (th + 2) x (tw + 2) from (y0 - 1, x0 - 1)
  for_each_pass<T>(
      th + 2, t2, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * xw + px[i]) * cp;
        mma_taps(acc, xt, off, xw * cp, cp, 3, C, IO<T>::conv(w1, C, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        float r[EW];
        const bool in = inside(y0 - 1 + py, x0 - 1 + px, H, W);
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = in ? fmaxf(v[j] + b1[co + j], 0.0f) : 0.0f;
        IO<T>::storev(tt + (py * t2 + px) * cp + co, r);
      });
  __syncthreads();

  // out = relu(conv(t) + b2 + x) on the tile's own positions
  T* oimg = out + (size_t)b * H * W * C;
  for_each_pass<T>(
      th, tw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * t2 + px[i]) * cp;
        mma_taps(acc, tt, off, t2 * cp, cp, 3, C, IO<T>::conv(w2, C, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 + py, gx = x0 + px;
        if (!inside(gy, gx, H, W)) return;
        float res[EW], r[EW];
        IO<T>::loadv(xt + ((py + 2) * xw + px + 2) * cp + co, res);
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = fmaxf(v[j] + b2[co + j] + res[j], 0.0f);
        IO<T>::storev(oimg + ((size_t)gy * W + gx) * C + co, r);
      });
}

template <typename T>
static cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                          void* out, int B, int H, int W, int C, cudaStream_t s) {
  const auto smem_bytes = [&](int th, int tw) -> size_t {
    return WSM_BYTES +
           sizeof(T) * IO<T>::pitch(C) * ((size_t)(th + 4) * (tw + 4) + (size_t)(th + 2) * (tw + 2));
  };
  const auto slots = [&](int th, int tw) {
    return stage_slots((th + 2) * (tw + 2), C, 9, C) + stage_slots(th * tw, C, 9, C);
  };
  int th, tw;
  if (!pick_tile(H, W, smem_bytes, slots, &th, &tw)) return cudaErrorInvalidValue;  // nothing fits
  const size_t bytes = smem_bytes(th, tw);
  cudaError_t err =
      cudaFuncSetAttribute(basic_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  basic_block_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), H, W, C, th, tw);
  return cudaGetLastError();
}

extern "C" {

// Launches on `stream` and returns the CUDA error as an int: 0 when the
// launch was accepted.
int threedod_fused_basic_block(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* out, int B, int H, int W, int C, int is_bf16,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, C, s)
                : launch<float>(x, w1, b1, w2, b2, out, B, H, W, C, s);
  return (int)err;
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
