// One FPN level for Hopper (sm_90a), kernel K8 of the port.
//
// Replaces the Pallas TPU kernel threedod/ops/fused_conv.py::_fpn_kernel
// (public entry fused_fpn_level). Computes what
// threedod_torch/ops/fused_conv.py::fpn_level_reference computes:
//     cur = f @ wl + bl + prev[y / 2, x / 2]   rounded to the storage type
//     out = conv3x3(cur, wo) + bo
// f (B, H, W, Cl) and prev (B, H/2, W/2, C) channels-last; out and, when
// asked for, cur are (B, H, W, C). H and W are even, so the 2x repeat of
// prev is the nearest upsampling.
//
// What bounds it: operations (2 * (Cl + 9 * C) * C a position).
//
// * bfloat16: two launches of conv_wgmma.cuh's implicit GEMMs on wgmma fed
//   by TMA: conv1x1_wgmma for the lateral, whose epilogue adds bias and the
//   carry prev[b, y / 2, x / 2] (16-byte loads) before the one rounding and
//   writes cur (to the caller's output, or to a scratch map that stays in L2
//   when nobody reads cur, as K4's t does); then conv3x3_wgmma over cur with
//   relu off. Weights come packed once (fused_conv.py::pack_fpn_level: wl as
//   pack_conv1x1, wo as pack_conv3x3 packs them); the wrapper picks each
//   launch's block shape from the card's SM count.
// * float: one kernel on the CUDA cores in exact f32
//   (fused_conv_common.cuh). One block owns a tile of th x tw positions: it
//   loads f with a halo of 1, forms cur on that halo'd region in shared
//   memory (prev is read from device memory at half resolution, zero outside
//   the image, because the 3x3's padding is zeros and not the lateral
//   evaluated outside), then runs the 3x3 product. cur reaches device memory
//   only where the next level needs it, for the tile's own positions.
//   Weights wl (Cl, C) and wo (3, 3, C, C), output channels last.

#include "conv_wgmma.cuh"
#include "fused_conv_common.cuh"

using namespace fc;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fpn_level_kernel(const T* __restrict__ f, const T* __restrict__ prev, const T* __restrict__ wl,
                 const float* __restrict__ bl, const T* __restrict__ wo, const float* __restrict__ bo,
                 T* __restrict__ out, T* __restrict__ cur, int H, int W, int Cl, int C, int th, int tw) {
  constexpr int NP = IO<T>::NP, EW = IO<T>::EW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = th + 2, cw = tw + 2;
  const int lp = IO<T>::pitch(Cl), cp = IO<T>::pitch(C);  // channel pitches of the two tiles
  float* wsm = reinterpret_cast<float*>(smem);
  T* ft = reinterpret_cast<T*>(smem + WSM_BYTES);
  T* ct = ft + (size_t)ch * cw * lp;

  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  load_tile<T>(ft, f + (size_t)b * H * W * Cl, H, W, Cl, y0 - 1, x0 - 1, ch, cw);
  __syncthreads();

  const int Hp = H / 2, Wp = W / 2;
  const T* pimg = prev + (size_t)b * Hp * Wp * C;
  T* cimg = cur ? cur + (size_t)b * H * W * C : nullptr;
  for_each_pass<T>(
      ch, cw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * cw + px[i]) * lp;
        mma_taps(acc, ft, off, 0, 0, 1, Cl, IO<T>::conv(wl, Cl, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 - 1 + py, gx = x0 - 1 + px;
        float r[EW];
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = 0.0f;
        const bool in = inside(gy, gx, H, W);
        if (in) {
          float up[EW];
          IO<T>::loadv(pimg + ((size_t)(gy / 2) * Wp + gx / 2) * C + co, up);
#pragma unroll
          for (int j = 0; j < EW; ++j) r[j] = (v[j] + bl[co + j]) + up[j];
        }
        IO<T>::storev(ct + (py * cw + px) * cp + co, r);
        if (in && cimg && py >= 1 && py <= th && px >= 1 && px <= tw) {
          IO<T>::storev(cimg + ((size_t)gy * W + gx) * C + co, r);
        }
      });
  __syncthreads();

  T* oimg = out + (size_t)b * H * W * C;
  for_each_pass<T>(
      th, tw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * cw + px[i]) * cp;
        mma_taps(acc, ct, off, cw * cp, cp, 3, C, IO<T>::conv(wo, C, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 + py, gx = x0 + px;
        if (!inside(gy, gx, H, W)) return;
        float r[EW];
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = v[j] + bo[co + j];
        IO<T>::storev(oimg + ((size_t)gy * W + gx) * C + co, r);
      });
}

template <typename T>
static cudaError_t launch(const void* f, const void* prev, const void* wl, const float* bl, const void* wo,
                          const float* bo, void* out, void* cur, int B, int H, int W, int Cl, int C,
                          cudaStream_t s) {
  const auto smem_bytes = [&](int th, int tw) -> size_t {
    return WSM_BYTES + sizeof(T) * (size_t)(th + 2) * (tw + 2) * (IO<T>::pitch(Cl) + IO<T>::pitch(C));
  };
  const auto slots = [&](int th, int tw) {
    return stage_slots((th + 2) * (tw + 2), C, 1, Cl) + stage_slots(th * tw, C, 9, C);
  };
  int th, tw;
  if (!pick_tile(H, W, smem_bytes, slots, &th, &tw)) return cudaErrorInvalidValue;  // nothing fits
  const size_t bytes = smem_bytes(th, tw);
  cudaError_t err =
      cudaFuncSetAttribute(fpn_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  fpn_level_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(f), static_cast<const T*>(prev), static_cast<const T*>(wl), bl,
      static_cast<const T*>(wo), bo, static_cast<T*>(out), static_cast<T*>(cur), H, W, Cl, C, th, tw);
  return cudaGetLastError();
}

// bfloat16: the lateral and carry into cur, then the output convolution
static cudaError_t launch_bf16(const void* f, const void* prev, const void* wl, const float* bl, const void* wo,
                               const float* bo, void* out, void* cur, int B, int H, int W, int Cl, int C, int mt1,
                               int bn3, int mt3, cudaStream_t s) {
  using cw::bf16;
  const bf16* src[1] = {static_cast<const bf16*>(f)};
  cw::Conv1x1Params p1{};
  p1.w = static_cast<const bf16*>(wl);
  p1.bias = bl;
  p1.carry = static_cast<const bf16*>(prev);
  p1.out = static_cast<bf16*>(cur);
  p1.P = B * H * W;
  p1.H = H;
  p1.W = W;
  p1.Cout = C;
  cudaError_t err = cw::conv1x1<false>(mt1, src, &Cl, 1, p1, s);
  if (err != cudaSuccess) return err;
  cw::ConvParams p3{};
  p3.w = static_cast<const bf16*>(wo);
  p3.bias = bo;
  p3.out = static_cast<bf16*>(out);
  p3.P = B * H * W;
  p3.H = H;
  p3.W = W;
  p3.C = C;
  return cw::conv3x3<false, false>(bn3, mt3, static_cast<const bf16*>(cur), p3, s);
}

extern "C" {

// float32. `cur` may be null (the finest level, whose carry nobody reads).
// Launches on `stream` and returns the CUDA error as an int: 0 when the
// launch was accepted.
int threedod_fused_fpn_level_f32(const void* f, const void* prev, const void* wl, const float* bl,
                                 const void* wo, const float* bo, void* out, void* cur, int B, int H, int W,
                                 int Cl, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return 0;
  return (int)launch<float>(f, prev, wl, bl, wo, bo, out, cur, B, H, W, Cl, C, static_cast<cudaStream_t>(stream));
}

// bfloat16, two launches: weights packed for conv_wgmma.cuh, biases f32 on
// 16-byte boundaries; `cur` (B, H, W, C) is always written (a scratch map
// when the caller does not read it); the lateral's warpgroups a block, mt1,
// and the output convolution's block shape (bn3, mt3).
int threedod_fused_fpn_level_bf16(const void* f, const void* prev, const void* wl, const float* bl,
                                  const void* wo, const float* bo, void* out, void* cur, int B, int H, int W,
                                  int Cl, int C, int mt1, int bn3, int mt3, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H % 2 || W % 2 || cur == nullptr) return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return 0;
  return (int)launch_bf16(f, prev, wl, bl, wo, bo, out, cur, B, H, W, Cl, C, mt1, bn3, mt3,
                          static_cast<cudaStream_t>(stream));
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
