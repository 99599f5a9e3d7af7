// Bias-free multi-head attention backward for Hopper (sm_90a), the backward of
// kernel K9 of the port.
//
// Replaces the two backward kernels of the Pallas TPU flash attention that
// threedod/ops/attention.py::multi_head_attention calls at 2048 tokens and
// more: _flash_attention_dkv_kernel (dK, dV) and _flash_attention_dq_kernel
// (dQ) of jax/experimental/pallas/ops/tpu/flash_attention.py. Computes what
// threedod_torch/ops/attention.py::attention_backward_reference computes, with
// s = 1 / sqrt(D) and the row log-sum-exp lse that the forward
// (flash_attention_fwd.cu) saved:
//     P     = exp(s q k^T - lse)          (rebuilt, never stored)
//     delta = rowsum(dout * out)
//     dV    = P^T dout
//     dS    = P * (dout v^T - delta)
//     dQ    = s dS k,      dK = s dS^T q
// q, k, v, out, dout (B, S, H, D) with D = 64 and any strides whose last is 1
// (q, k, v are slices of one qkv projection); lse and the scratch delta
// (B, H, S) f32; dq, dk, dv (B, S, H, D) contiguous, in the inputs' type.
//
// What bounds it: operations (10 B H S^2 D for the five products; the kernels
// here form q k^T and dout v^T twice, once for dK/dV and once for dQ, which
// makes 14). Three launches:
//   1. delta: one warp a row, f32 (the JAX library forms it outside its
//      kernels too, flash_attention.py:273-275);
//   2. dK/dV: one block owns 64 keys of one (image, head), keeps their K and V
//      tiles in shared memory and their dK and dV in registers, and walks the
//      queries 64 at a time;
//   3. dQ: one block owns 64 queries and walks the keys 64 at a time.
// Each output element is summed by one thread, in one order: no atomics, no
// zeroed buffer, the same bits from run to run. The ragged tail is masked
// here: keys past S get no probability, queries past S are loaded as zeros,
// get an lse of +inf (so no probability either) and are not stored.
//
// Both element types run on the CUDA cores in f32: tiles are converted to f32
// as they are staged in shared memory, every product and sum is f32, and the
// result is rounded once to the inputs' type. 256 threads as 16 x 16; a
// thread owns a 4 x 4 block of each 64 x 64 product (rows ty + 16 r, columns
// tx + 16 c), as in the forward's f32 path. mma.sync or wgmma for bf16, TMA
// and a persistent grid are left for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // head width
constexpr int T64 = 64;     // queries or keys a tile
constexpr int FP = D + 1;   // f32 tile pitch: rows fall on different banks
constexpr int TILE = T64 * FP;
constexpr int THREADS = 256;

struct Strides {
  long long b, s, h;  // in elements; the last dimension's stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// four neighbouring elements of a row as f32: one 16-byte (f32) or 8-byte
// (bf16) load; the wrapper keeps rows on 16-byte boundaries
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// rows [r0, r0 + 64) of one head of one image -> f32 tile[64][FP], zeros past S
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < T64 * (D / 4); idx += THREADS) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + r < S) load4(base + (long long)(r0 + r) * row_stride + c, v);
    float* dst = tile + r * FP + c;
    dst[0] = v[0];
    dst[1] = v[1];
    dst[2] = v[2];
    dst[3] = v[3];
  }
}

// lse and delta of queries [q0, q0 + 64): +inf and 0 past S, so that a query
// past S has no probability
__device__ __forceinline__ void load_rows(float* lse_s, float* del_s, const float* lse, const float* delta, int q0,
                                          int S) {
  if (threadIdx.x < T64) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < S ? lse[row] : INFINITY;
    del_s[threadIdx.x] = row < S ? delta[row] : 0.0f;
  }
}

// the 4 x 4 block (queries ty + 16 r, keys tx + 16 c) of s q k^T and dout v^T
// for the staged tiles
__device__ __forceinline__ void logits_and_dp(const float* qs, const float* dos, const float* ks, const float* vs,
                                              int tx, int ty, float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = 0.0f;
      dp[r][c] = 0.0f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = qs[(ty + 16 * r) * FP + d];
      g[r] = dos[(ty + 16 * r) * FP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bk[c] = ks[(tx + 16 * c) * FP + d];
      bv[c] = vs[(tx + 16 * c) * FP + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r], bk[c], s[r][c]);
        dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
      }
    }
  }
}

// p = exp(scale s - lse) with keys past S masked, and ds = p (dp - delta), in
// place of s and dp
__device__ __forceinline__ void probs_and_ds(float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
                                             const float* del_s, int k0, int S, int tx, int ty, float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float l = lse_s[ty + 16 * r], dl = del_s[ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = k0 + tx + 16 * c < S ? expf(fmaf(s[r][c], scale, -l)) : 0.0f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dl);
    }
  }
}

constexpr int DELTA_ROWS = THREADS / 32;  // rows a block of the delta kernel

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta, int S, int H,
                Strides so, Strides sdo, long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 5);  // (b, i, h) in that order
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % H);
  const long long bi = row / H;
  const int i = (int)(bi % S), b = (int)(bi / S);
  const T* o = out + b * so.b + i * so.s + h * so.h;
  const T* g = dout + b * sdo.b + i * sdo.s + h * sdo.h;
  float acc = to_f32(o[lane]) * to_f32(g[lane]) + to_f32(o[lane + 32]) * to_f32(g[lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * S + i] = acc;
}

constexpr int DKV_SMEM = (6 * TILE + 2 * T64) * sizeof(float);  // k, v, q, dout, p, ds tiles; lse, delta

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, int S, int H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + TILE;
  float* qs = vs + TILE;
  float* dos = qs + TILE;
  float* ps = dos + TILE;   // p of the tile, (query, key)
  float* dss = ps + TILE;   // ds of the tile, (query, key)
  float* lse_s = dss + TILE;
  float* del_s = lse_s + T64;
  const int k0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + ((long long)b * H + h) * S;
  const float* del_b = delta + ((long long)b * H + h) * S;

  load_tile(ks, k + b * sk.b + h * sk.h, sk.s, k0, S);
  load_tile(vs, v + b * sv.b + h * sv.h, sv.s, k0, S);
  float acc_dk[4][4], acc_dv[4][4];  // keys ty + 16 r, channels tx + 16 c
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_dk[r][c] = 0.0f;
      acc_dv[r][c] = 0.0f;
    }
  }

  for (int q0 = 0; q0 < S; q0 += T64) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(qs, qb, sq.s, q0, S);
    load_tile(dos, dob, sdo.s, q0, S);
    load_rows(lse_s, del_s, lse_b, del_b, q0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    logits_and_dp(qs, dos, ks, vs, tx, ty, s, dp);
    probs_and_ds(s, dp, lse_s, del_s, k0, S, tx, ty, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ps[(ty + 16 * r) * FP + tx + 16 * c] = s[r][c];
        dss[(ty + 16 * r) * FP + tx + 16 * c] = dp[r][c];
      }
    }
    __syncthreads();

    // dV += P^T dout and dK += dS^T q over this tile's 64 queries
#pragma unroll 4
    for (int j = 0; j < T64; ++j) {
      float pa[4], da[4], go[4], qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[r] = ps[j * FP + ty + 16 * r];
        da[r] = dss[j * FP + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        go[c] = dos[j * FP + tx + 16 * c];
        qv[c] = qs[j * FP + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_dv[r][c] = fmaf(pa[r], go[c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(da[r], qv[c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= S) continue;
    const long long o = (((long long)b * S + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(acc_dk[r][c] * scale);
      dv[o + tx + 16 * c] = from_f32<T>(acc_dv[r][c]);
    }
  }
}

constexpr int DQ_SMEM = (5 * TILE + 2 * T64) * sizeof(float);  // q, dout, k, v, ds tiles; lse, delta

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
             Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + TILE;
  float* ks = dos + TILE;
  float* vs = ks + TILE;
  float* dss = vs + TILE;  // ds of the tile, (query, key)
  float* lse_s = dss + TILE;
  float* del_s = lse_s + T64;
  const int q0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_rows(lse_s, del_s, lse + ((long long)b * H + h) * S, delta + ((long long)b * H + h) * S, q0, S);
  float acc[4][4];  // queries ty + 16 r, channels tx + 16 c
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += T64) {
    __syncthreads();  // the previous tile's readers are done (and q, dout, lse, delta are staged)
    load_tile(ks, kb, sk.s, k0, S);
    load_tile(vs, vb, sv.s, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    logits_and_dp(qs, dos, ks, vs, tx, ty, s, dp);
    probs_and_ds(s, dp, lse_s, del_s, k0, S, tx, ty, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * r) * FP + tx + 16 * c] = dp[r][c];
    }
    __syncthreads();

    // dQ += dS k over this tile's 64 keys
#pragma unroll 4
    for (int j = 0; j < T64; ++j) {
      float da[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) da[r] = dss[(ty + 16 * r) * FP + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[j * FP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(da[r], kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= S) continue;
    const long long o = (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[o + tx + 16 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout, const void* lse,
           void* delta, void* dq, void* dk, void* dv, int B, int S, int H, Strides sq, Strides sk, Strides sv,
           Strides so, Strides sdo, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const float scale = 1.0f / sqrtf((float)D);
  const long long rows = (long long)B * S * H;

  flash_bwd_delta<T><<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS), THREADS, 0, stream>>>(
      static_cast<const T*>(out), dop, dp, S, H, so, sdo, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((S + T64 - 1) / T64, H, B);
  err = cudaFuncSetAttribute(flash_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv<T><<<grid, THREADS, DKV_SMEM, stream>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dk),
                                                        static_cast<T*>(dv), S, H, sq, sk, sv, sdo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T><<<grid, THREADS, DQ_SMEM, stream>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dq), S, H, sq, sk,
                                                      sv, sdo, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out, dout: (B, S, H, 64) with element strides (batch, token, head)
// each and a last stride of 1; lse (B, H, S) f32 from the forward; delta
// (B, H, S) f32 scratch; dq, dk, dv (B, S, H, 64) contiguous. Three launches
// on `stream`; returns the CUDA error as an int: 0 when all were accepted.
int threedod_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                 const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
                                 int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                 long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                 long long o_sb, long long o_ss, long long o_sh, long long do_sb, long long do_ss,
                                 long long do_sh, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Dh != D || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B * S * H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh},
      sdo{do_sb, do_ss, do_sh};
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, sq, sk, sv, so, sdo, s);
  }
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, sq, sk, sv, so, sdo, s);
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
