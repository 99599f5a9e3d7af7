// RPN head for Hopper (sm_90a), kernel K7 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/fused_conv.py::_crh_kernel
// (public entry fused_conv_relu_head). Computes what
// threedod_torch/ops/fused_conv.py::conv_relu_head_reference computes:
//     t   = relu(conv3x3(x, wc) + bc)      rounded to the storage type
//     out = t @ wh + bh                    the packed 1x1 predictors
// x (B, H, W, C) channels-last, out (B, H, W, nout).
//
// What bounds it: operations (2 * 9 * C * Cm a position against C + nout
// values moved).
//
// * bfloat16: two launches of conv_wgmma.cuh's implicit GEMMs on wgmma fed
//   by TMA: conv3x3_wgmma with relu (Cm == C) into a scratch map t, then
//   conv1x1_wgmma over t with the nout predictors in one 64-channel slice,
//   whose epilogue stores a ragged row (nout = 15) one value at a time. t
//   goes through L2 and memory (88 MB at p2 of a bs8 512x672 forward, more
//   than L2 holds: about 0.05 ms of its round trip at 3.35 TB/s). Weights
//   come packed once (fused_conv.py::pack_conv_relu_head: wc as
//   pack_conv3x3, wh as pack_conv1x1 packs them, bh padded to 8 values); the
//   wrapper picks each launch's block shape from the card's SM count.
// * float: one kernel on the CUDA cores in exact f32
//   (fused_conv_common.cuh). One block owns a tile of th x tw positions: it
//   loads the tile with a halo of 1 into shared memory, runs the 3x3 product
//   into a second shared tile (t never reaches device memory) and the small
//   product from there. Weights wc (3, 3, C, Cm) and wh (Cm, npad), the
//   predictors' nout output channels first, zeros after.

#include "conv_wgmma.cuh"
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

// bfloat16: the 3x3 into t, then the predictors over t
static cudaError_t launch_bf16(const void* x, const void* wc, const float* bc, const void* wh, const float* bh,
                               void* out, void* t, int B, int H, int W, int C, int nout, int bn3, int mt3, int mt1,
                               cudaStream_t s) {
  using cw::bf16;
  cw::ConvParams p3{};
  p3.w = static_cast<const bf16*>(wc);
  p3.bias = bc;
  p3.out = static_cast<bf16*>(t);
  p3.P = B * H * W;
  p3.H = H;
  p3.W = W;
  p3.C = C;
  cudaError_t err = cw::conv3x3<false, true>(bn3, mt3, static_cast<const bf16*>(x), p3, s);
  if (err != cudaSuccess) return err;
  const bf16* src[1] = {static_cast<const bf16*>(t)};
  cw::Conv1x1Params p1{};
  p1.w = static_cast<const bf16*>(wh);
  p1.bias = bh;
  p1.out = static_cast<bf16*>(out);
  p1.P = B * H * W;
  p1.H = H;
  p1.W = W;
  p1.Cout = nout;
  return cw::conv1x1<false>(mt1, src, &C, 1, p1, s);
}

extern "C" {

// float32. Launches on `stream` (a cudaStream_t as an integer) and returns
// the CUDA error as an int: 0 when the launch was accepted.
int threedod_fused_conv_relu_head_f32(const void* x, const void* wc, const float* bc, const void* wh,
                                      const float* bh, void* out, int B, int H, int W, int C, int Cm, int npad,
                                      int nout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * H * W == 0) return 0;
  return (int)launch<float>(x, wc, bc, wh, bh, out, B, H, W, C, Cm, npad, nout, static_cast<cudaStream_t>(stream));
}

// bfloat16, two launches: weights packed for conv_wgmma.cuh (the 3x3 keeps
// C channels), biases f32 on 16-byte boundaries, bh padded to a multiple of
// 8 values; the scratch map t (B, H, W, C); the 3x3's block shape (bn3, mt3)
// and the 1x1's warpgroups a block, mt1.
int threedod_fused_conv_relu_head_bf16(const void* x, const void* wc, const float* bc, const void* wh,
                                       const float* bh, void* out, void* t, int B, int H, int W, int C, int nout,
                                       int bn3, int mt3, int mt1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B * H * W == 0) return 0;
  return (int)launch_bf16(x, wc, bc, wh, bh, out, t, B, H, W, C, nout, bn3, mt3, mt1,
                          static_cast<cudaStream_t>(stream));
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
