// Stride-2 BasicBlock head in one kernel for Hopper (sm_90a), kernel K6 of
// the port.
//
// Replaces the Pallas TPU kernel threedod/ops/fused_conv.py::_bd_kernel
// (public entry fused_block_down). Computes what
// threedod_torch/ops/fused_conv.py::block_down_reference computes:
//     t   = relu(conv3x3 stride 2 (x, w1) + b1)   rounded to the storage type
//     res = maxpool2x2(x), or x[::2, ::2]; through the 1x1 projection
//           (wp, bp) where there is one
//     out = relu(conv3x3(t, w2) + b2 + res)
// x (B, Hi, Wi, Cin) channels-last with Hi and Wi even; out (B, Hi/2, Wi/2, C).
// Weights in the layout of the storage type (fused_conv_common.cuh): float w1
// (3, 3, Cin, C), w2 (3, 3, C, C), wp (Cin, C); bfloat16 w1 (3, 3, C, Cin), w2
// (3, 3, C, C) with input channels last, wp (C, Cin). wp is null where the
// block has no projection (then Cin == C).
//
// What bounds it: operations (2 * 9 * (Cin + C) * C an output position). One
// block owns a tile of th x tw output positions: it loads the (2 th + 5) x
// (2 tw + 5) window of x that t needs on the tile plus a halo of 1, forms t
// there in shared memory (zero outside the image: the second conv's padding
// is zeros), pools the same window for the residual, and sums the second
// conv and the projection into one accumulator. Neither t nor the pooled
// map reaches device memory.

#include "fused_conv_common.cuh"

using namespace fc;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
block_down_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                  const T* __restrict__ w2, const float* __restrict__ b2, const T* __restrict__ wp,
                  const float* __restrict__ bp, T* __restrict__ out, int Hi, int Wi, int Cin, int C,
                  int pool, int th, int tw) {
  constexpr int NP = IO<T>::NP, EW = IO<T>::EW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Ho = Hi / 2, Wo = Wi / 2;
  const int xh = 2 * th + 5, xw = 2 * tw + 5;
  const int tth = th + 2, ttw = tw + 2;
  const int ip = IO<T>::pitch(Cin), cp = IO<T>::pitch(C);  // channel pitches: x and pooled tiles, t tile
  float* wsm = reinterpret_cast<float*>(smem);
  T* xt = reinterpret_cast<T*>(smem + WSM_BYTES);
  T* tt = xt + (size_t)xh * xw * ip;
  T* pt = tt + (size_t)tth * ttw * cp;

  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  // t row (y0 - 1 + py) reads input rows 2 (y0 - 1 + py) - 1 + dy = (2 y0 - 3) + 2 py + dy
  load_tile<T>(xt, x + (size_t)b * Hi * Wi * Cin, Hi, Wi, Cin, 2 * y0 - 3, 2 * x0 - 3, xh, xw);
  __syncthreads();

  // residual source at the tile's own positions: input rows 2 (y0 + py) and
  // the next one are window rows 2 py + 3 and 2 py + 4
  const int nvec = th * tw * (Cin / 4);
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const int p = i / (Cin / 4);
    const int c = (i - p * (Cin / 4)) * 4;
    const int py = p / tw, px = p - py * tw;
    const T* src = xt + ((2 * py + 3) * xw + 2 * px + 3) * ip + c;
    float v[4];
    IO<T>::load4(src, v);
    if (pool) {
      float u[4];
      IO<T>::load4(src + ip, u);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], u[j]);
      IO<T>::load4(src + xw * ip, u);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], u[j]);
      IO<T>::load4(src + xw * ip + ip, u);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fmaxf(v[j], u[j]);
    }
    IO<T>::store4(pt + p * ip + c, v);
  }

  for_each_pass<T>(
      tth, ttw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (2 * py[i] * xw + 2 * px[i]) * ip;
        mma_taps(acc, xt, off, xw * ip, ip, 3, Cin, IO<T>::conv(w1, Cin, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        float r[EW];
        const bool in = inside(y0 - 1 + py, x0 - 1 + px, Ho, Wo);
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = in ? fmaxf(v[j] + b1[co + j], 0.0f) : 0.0f;
        IO<T>::storev(tt + (py * ttw + px) * cp + co, r);
      });
  __syncthreads();

  T* oimg = out + (size_t)b * Ho * Wo * C;
  for_each_pass<T>(
      th, tw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * ttw + px[i]) * cp;
        mma_taps(acc, tt, off, ttw * cp, cp, 3, C, IO<T>::conv(w2, C, C), co0, ncols, wsm);
        if (wp) {
#pragma unroll
          for (int i = 0; i < NP; ++i) off[i] = (py[i] * tw + px[i]) * ip;
          mma_taps(acc, pt, off, 0, 0, 1, Cin, IO<T>::conv(wp, Cin, C), co0, ncols, wsm);
        }
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 + py, gx = x0 + px;
        if (!inside(gy, gx, Ho, Wo)) return;
        float res[EW];
        if (wp) {
#pragma unroll
          for (int j = 0; j < EW; ++j) res[j] = bp[co + j];
        } else {
          IO<T>::loadv(pt + (py * tw + px) * ip + co, res);
        }
        float r[EW];
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = fmaxf(v[j] + b2[co + j] + res[j], 0.0f);
        IO<T>::storev(oimg + ((size_t)gy * Wo + gx) * C + co, r);
      });
}

template <typename T>
static cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                          const void* wp, const float* bp, void* out, int B, int Hi, int Wi, int Cin, int C,
                          int pool, cudaStream_t s) {
  const size_t ip = IO<T>::pitch(Cin), cp = IO<T>::pitch(C);
  const int Ho = Hi / 2, Wo = Wi / 2;
  const auto smem_bytes = [&](int th, int tw) -> size_t {
    return WSM_BYTES + sizeof(T) * ((size_t)(2 * th + 5) * (2 * tw + 5) * ip +
                                    (size_t)(th + 2) * (tw + 2) * cp + (size_t)th * tw * ip);
  };
  const auto slots = [&](int th, int tw) {
    return stage_slots((th + 2) * (tw + 2), C, 9, Cin) + stage_slots(th * tw, C, 9, C) +
           (wp ? stage_slots(th * tw, C, 1, Cin) : 0.0);
  };
  int th, tw;
  if (!pick_tile(Ho, Wo, smem_bytes, slots, &th, &tw)) return cudaErrorInvalidValue;  // nothing fits
  const size_t bytes = smem_bytes(th, tw);
  cudaError_t err =
      cudaFuncSetAttribute(block_down_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wo + tw - 1) / tw, (Ho + th - 1) / th, B);
  block_down_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(wp), bp, static_cast<T*>(out), Hi, Wi, Cin, C, pool, th, tw);
  return cudaGetLastError();
}

extern "C" {

// `wp` and `bp` are null where the block has no projection (Cin == C).
// Launches on `stream` and returns the CUDA error as an int: 0 when the
// launch was accepted.
int threedod_fused_block_down(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, const void* wp, const float* bp, void* out, int B, int Hi,
                              int Wi, int Cin, int C, int pool, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hi % 2 || Wi % 2 || (!wp && Cin != C)) return (int)cudaErrorInvalidValue;
  if (B * Hi * Wi == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, wp, bp, out, B, Hi, Wi, Cin, C, pool, s)
                : launch<float>(x, w1, b1, w2, b2, wp, bp, out, B, Hi, Wi, Cin, C, pool, s);
  return (int)err;
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
