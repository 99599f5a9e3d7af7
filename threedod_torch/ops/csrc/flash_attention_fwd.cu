// Bias-free multi-head attention forward with a running softmax, for Hopper
// (sm_90a), kernel K9 of the port.
//
// Replaces the Pallas TPU flash-attention call of
// threedod/ops/attention.py::multi_head_attention (the route it takes at 2048
// tokens and more). Computes what
// threedod_torch/ops/attention.py::attention_reference computes:
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D)) v[b, j, h, :]
// q, k, v (B, S, H, D) with D = 64 and any strides whose last is 1 (they are
// slices of one qkv projection: nothing is transposed, padded or copied); out
// (B, S, H, D) contiguous, in the inputs' type; when the caller wants a
// gradient, also lse (B, H, S) f32, the row log-sum-exp of the scaled logits in
// natural-log units (lse = m + log l), which the backward
// (flash_attention_bwd.cu) rebuilds the probabilities from.
//
// What bounds it: operations (4 * S * S * D a head; q, k, v and out cross the
// memory once and the S x S logits never do). One block owns 64 queries of one
// head of one image and walks over the keys 64 at a time: the K and V tiles
// are staged in shared memory, the logits of the tile are formed, the running
// row maximum and row sum are kept in f32, the accumulator is rescaled when
// the maximum moves, and one division ends the row. The ragged tail is
// handled here: keys past S get -inf before the maximum (their tiles are
// loaded as zeros), queries past S are computed on zeros and not stored.
//
// * bfloat16: on the tensor cores with mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators). 4 warps, each 16 queries by all 64 keys. K and V tiles come
//   in with cp.async into two stages, so the next tile is in flight while this
//   one is multiplied. Q fragments stay in registers for the whole walk; every
//   fragment is read with ldmatrix (V's through .trans from the row-major
//   tile); the logits' accumulator fragments are, after the exponential and one
//   rounding to bf16, the A fragments of the second product. Exponentials are
//   exp2 of logits scaled by log2(e)/sqrt(D).
// * float: on the CUDA cores in exact f32. 256 threads as 16 x 16, a thread
//   sums 4 queries by 4 keys of the logits, a warp does the softmax of 8 rows
//   through shared memory, then a thread sums 4 queries by 4 channels of P V.
//   This is the path the comparisons with the plain version and the CPU rest
//   on.
//
// wgmma, TMA and warp specialisation are left for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;    // head width
constexpr int BQ = 64;   // queries a block
constexpr int BK = 64;   // keys a tile
constexpr int KP = D + 8;  // bf16 tile pitch: 16 bytes off a multiple of 128, conflict-free fragment loads
constexpr int FP = D + 1;  // f32 tile pitch: rows fall on different banks
constexpr int BLOCKS_PER_SM = 4;  // bf16 blocks resident on an SM that the register budget is held to

struct Strides {
  long long b, s, h;  // in elements; the last dimension's stride is 1
};

// ---------------- bfloat16, tensor cores ------------------------------------

// 16 bytes global -> shared without passing through registers; zeros when
// `valid` is false (a source size of 0 fills the destination with zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// rows [r0, r0 + 64) of one head of one image -> tile[64][KP], zeros past S;
// asynchronous: the caller commits and waits
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, const __nv_bfloat16* base, long long row_stride,
                                               int r0, int S) {
#pragma unroll
  for (int i = 0; i < 64 * (D / 8) / 128; ++i) {
    const int idx = threadIdx.x + 128 * i;
    const int r = idx >> 3, c = (idx & 7) * 8;
    const bool valid = r0 + r < S;
    cp_async16(tile + r * KP + c, base + (long long)(valid ? r0 + r : 0) * row_stride + c, valid);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, one row address a lane (lanes
// 8 m .. 8 m + 7 name the rows of matrix m); thread (g, t) gets elements
// (g; 2 t, 2 t + 1) of each, or with `.trans` elements (2 t, 2 t + 1; g)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__global__ void __launch_bounds__(128, BLOCKS_PER_SM)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S,
               int H, Strides sq, Strides sk, Strides sv, float scale_log2) {
  // two stages of a K and a V tile; the Q tile passes through stage 1's K buffer
  __shared__ __align__(16) __nv_bfloat16 ks[2][BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vs[2][BK * KP];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;  // the ldmatrix row and matrix this lane names
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  load_tile_bf16(ks[1], q + b * sq.b + h * sq.h, sq.s, q0, S);
  cp_async_commit();
  load_tile_bf16(ks[0], kb, sk.s, 0, S);
  load_tile_bf16(vs[0], vb, sv.s, 0, S);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  // this warp's 16 queries as A fragments, four k-steps of 16 channels:
  // matrices (rows 0-7, k low), (rows 8-15, k low), (rows 0-7, k high), (rows 8-15, k high)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qa[kk], ks[1] + (warp * 16 + 8 * (lmat & 1) + lrow) * KP + kk * 16 + 8 * (lmat >> 1));
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running maxima of rows g and g + 8, in the scaled log2 domain
  float l[2] = {0.0f, 0.0f};            // this thread's share of their running sums

  const int ntiles = (S + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK, st = tile & 1;
    __syncthreads();  // the other stage's readers (the previous tile, or the Q fragments) are done
    if (tile + 1 < ntiles) {
      load_tile_bf16(ks[st ^ 1], kb, sk.s, k0 + BK, S);
      load_tile_bf16(vs[st ^ 1], vb, sv.s, k0 + BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next one stays in flight
    __syncthreads();
    const __nv_bfloat16* kt = ks[st];
    const __nv_bfloat16* vt = vs[st];

    // logits of 16 queries by 64 keys: s[j] covers keys k0 + 8 j .. + 7
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        // B fragments of key blocks j and j + 1: (j, k low), (j, k high), (j + 1, k low), (j + 1, k high)
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (8 * (j + (lmat >> 1)) + lrow) * KP + kk * 16 + 8 * (lmat & 1));
        mma_bf16(s[j], qa[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qa[kk], kf[2], kf[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (k0 + BK <= S) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    } else {  // the ragged last tile: keys past S leave the softmax
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = key < S ? s[j][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a quad hold one row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);  // finite: every tile has a key below S
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // o += P v: two neighbouring logit fragments are one A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        // the row-major V tile transposed on the way: (keys low, channels j), (keys high, j),
        // (keys low, j + 1), (keys high, j + 1) are the B fragments of channel blocks j and j + 1
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + 8 * (lmat & 1) + lrow) * KP + 8 * (j + (lmat >> 1)));
        mma_bf16(o[j], pa, vf[0], vf[1]);
        mma_bf16(o[j + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    // the maximum is kept in log2 units of the scaled logits: back to natural log once, here
    if (lse != nullptr && t == 0) lse[((long long)b * H + h) * S + row] = m[r] * 0.6931471805599453f + logf(l[r]);
    const float inv = 1.0f / l[r];
    __nv_bfloat16* op = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

// ---------------- float, CUDA cores -----------------------------------------

__device__ __forceinline__ void load_tile_f32(float* tile, const float* base, long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += blockDim.x) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < S) v = *reinterpret_cast<const float4*>(base + (long long)(r0 + r) * row_stride + c);
    float* dst = tile + r * FP + c;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

constexpr int F32_SMEM = (4 * 64 * FP + 3 * BQ) * sizeof(float);  // q, k, v and logit tiles; row max, sum, rescale

__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, float* __restrict__ lse, int S, int H, Strides sq, Strides sk, Strides sv,
              float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + 64 * FP;
  float* vs = ks + 64 * FP;
  float* ps = vs + 64 * FP;  // logits, then probabilities, of the tile
  float* row_m = ps + 64 * FP;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // this thread's rows ty + 16 r, columns tx + 16 c
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile_f32(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  if (threadIdx.x < BQ) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.0f;
  }
  float o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q, row_m, row_l are written)
    load_tile_f32(ks, kb, sk.s, k0, S);
    load_tile_f32(vs, vb, sv.s, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * FP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = ks[(tx + 16 * c) * FP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ps[(ty + 16 * r) * FP + tx + 16 * c] = k0 + tx + 16 * c < S ? s[r][c] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // softmax bookkeeping: warp w takes rows 8 w .. 8 w + 7, a lane two keys
    for (int i = 0; i < 8; ++i) {
      const int row = warp * 8 + i;
      const float s0 = ps[row * FP + lane], s1 = ps[row * FP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mo = row_m[row];
      const float mn = fmaxf(mo, mx);  // finite: every tile has a key below S
      const float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[row * FP + lane] = p0;
      ps[row * FP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(mo - mn);
        row_a[row] = a;
        row_m[row] = mn;
        row_l[row] = row_l[row] * a + sum;
      }
    }
    __syncthreads();

    // o = o * rescale + P v, this thread's 4 queries by channels tx + 16 c
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = row_a[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(ty + 16 * r) * FP + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = vs[j * FP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = fmaf(p[r], vv[c], o[r][c]);
      }
    }
  }

  __syncthreads();
  if (lse != nullptr && threadIdx.x < BQ && q0 + threadIdx.x < S) {
    lse[((long long)b * H + h) * S + q0 + threadIdx.x] = row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= S) continue;
    const float inv = 1.0f / row_l[ty + 16 * r];
    float* op = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) op[tx + 16 * c] = o[r][c] * inv;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, S, H, 64) with element strides (batch, token, head) each and a
// last stride of 1; out (B, S, H, 64) contiguous; lse (B, H, S) f32 or null,
// when nothing is to be written there. Launches on `stream` and returns the
// CUDA error as an int: 0 when the launch was accepted.
int threedod_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                                 int H,
                                 int Dh, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                 long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Dh != D || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B * S * H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  if (is_bf16) {
    flash_fwd_bf16<<<grid, 128, 0, s>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                                        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                                        static_cast<float*>(lse), S, H, sq, sk, sv, scale * 1.4426950408889634f);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<<<grid, 256, F32_SMEM, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<float*>(out),
                                              static_cast<float*>(lse), S, H, sq, sk, sv, scale);
  }
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
