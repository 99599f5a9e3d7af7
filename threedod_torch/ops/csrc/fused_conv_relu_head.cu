// RPN head in one kernel for Hopper (sm_90a), kernel K7 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/fused_conv.py::_crh_kernel
// (public entry fused_conv_relu_head). Computes what
// threedod_torch/ops/fused_conv.py::conv_relu_head_reference computes:
//     t   = relu(conv3x3(x, wc) + bc)      rounded to the storage type
//     out = t @ wh + bh                    the packed 1x1 predictors
// x (B, H, W, C) channels-last, out (B, H, W, nout). Weights in the layout of
// the storage type (fused_conv_common.cuh): float wc (3, 3, C, Cm) and wh
// (Cm, npad); bfloat16 wc (3, 3, Cm, C) and wh (npad, Cm); the predictors'
// nout output channels come first, zeros after.
//
// What bounds it: operations (2 * 9 * C * Cm a position against C + nout
// values moved). One block owns a tile of th x tw positions: it loads the
// tile with a halo of 1 into shared memory, runs the 3x3 product into a
// second shared tile (t never reaches device memory) and the small product
// from there. The products are fused_conv_common.cuh's: tensor cores for
// bfloat16, CUDA cores for float.

#include "fused_conv_common.cuh"

using namespace fc;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_relu_head_kernel(const T* __restrict__ x, const T* __restrict__ wc, const float* __restrict__ bc,
                      const T* __restrict__ wh, const float* __restrict__ bh, T* __restrict__ out,
                      int H, int W, int C, int Cm, int npad, int nout, int th, int tw) {
  constexpr int NP = IO<T>::NP, EW = IO<T>::EW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xh = th + 2, xw = tw + 2;
  const int cp = IO<T>::pitch(C), mp = IO<T>::pitch(Cm);  // channel pitches of the two tiles
  float* wsm = reinterpret_cast<float*>(smem);
  T* xt = reinterpret_cast<T*>(smem + WSM_BYTES);
  T* tt = xt + (size_t)xh * xw * cp;

  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  load_tile<T>(xt, x + (size_t)b * H * W * C, H, W, C, y0 - 1, x0 - 1, xh, xw);
  __syncthreads();

  for_each_pass<T>(
      th, tw, Cm,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * xw + px[i]) * cp;
        mma_taps(acc, xt, off, xw * cp, cp, 3, C, IO<T>::conv(wc, C, Cm), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        float r[EW];
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = fmaxf(v[j] + bc[co + j], 0.0f);
        IO<T>::storev(tt + (py * tw + px) * mp + co, r);
      });
  __syncthreads();

  T* oimg = out + (size_t)b * H * W * nout;
  for_each_pass<T>(
      th, tw, npad,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * tw + px[i]) * mp;
        mma_taps(acc, tt, off, 0, 0, 1, Cm, IO<T>::conv(wh, Cm, npad), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 + py, gx = x0 + px;
        if (!inside(gy, gx, H, W)) return;
#pragma unroll
        for (int j = 0; j < EW; ++j) {
          if (co + j < nout) IO<T>::store1(oimg + ((size_t)gy * W + gx) * nout + co + j, v[j] + bh[co + j]);
        }
      });
}

template <typename T>
static cudaError_t launch(const void* x, const void* wc, const float* bc, const void* wh, const float* bh,
                          void* out, int B, int H, int W, int C, int Cm, int npad, int nout,
                          cudaStream_t s) {
  const auto smem_bytes = [&](int th, int tw) -> size_t {
    return WSM_BYTES + sizeof(T) * ((size_t)(th + 2) * (tw + 2) * IO<T>::pitch(C) +
                                    (size_t)th * tw * IO<T>::pitch(Cm));
  };
  const auto slots = [&](int th, int tw) {
    return stage_slots(th * tw, Cm, 9, C) + stage_slots(th * tw, npad, 1, Cm);
  };
  int th, tw;
  if (!pick_tile(H, W, smem_bytes, slots, &th, &tw)) return cudaErrorInvalidValue;  // nothing fits
  const size_t bytes = smem_bytes(th, tw);
  cudaError_t err = cudaFuncSetAttribute(conv_relu_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  conv_relu_head_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), bc, static_cast<const T*>(wh), bh,
      static_cast<T*>(out), H, W, C, Cm, npad, nout, th, tw);
  return cudaGetLastError();
}

extern "C" {

// Launches on `stream` (a cudaStream_t as an integer) and returns the CUDA
// error as an int: 0 when the launch was accepted.
int threedod_fused_conv_relu_head(const void* x, const void* wc, const float* bc, const void* wh,
                                  const float* bh, void* out, int B, int H, int W, int C, int Cm,
                                  int npad, int nout, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(x, wc, bc, wh, bh, out, B, H, W, C, Cm, npad, nout, s)
                : launch<float>(x, wc, bc, wh, bh, out, B, H, W, C, Cm, npad, nout, s);
  return (int)err;
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
