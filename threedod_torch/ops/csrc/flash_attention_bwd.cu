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
// What bounds it on an H100: operations, 10 B H S^2 D for the five products
// (the (B, H, S, S) probabilities are never stored, so q, k, v, out, dout and
// the gradients cross the memory once: bf16 at (2, 2117, 16, 64) needs 0.093
// ms of tensor-core time against 0.005 ms of memory time). The two kernels
// here form q k^T and dout v^T twice, which makes 14, and in exchange need no
// atomics. The design therefore puts every product on the tensor cores and
// keeps every tile of P and dS in registers. Three launches:
//   1. delta: one warp a row, f32 (the JAX library forms it outside its
//      kernels too, flash_attention.py:273-275);
//   2. dK/dV: a block owns 64 keys of one (image, head), a warp 16 of them, and
//      walks the queries 32 at a time: S^T = K Q^T -> P^T = exp2(s log2e S^T -
//      log2e lse) -> dV += P^T dout, then dP^T = V dout^T -> dS^T = P^T (dP^T -
//      delta) -> dK += dS^T Q; each accumulator of the first products becomes,
//      in registers, the A operand of the next;
//   3. dQ: a block owns 64 queries, a warp 16, and walks the keys 32 at a
//      time: S = Q K^T, dP = dout V^T, dQ += dS K.
// Each output element is summed by one thread, in one order: no atomics, no
// zeroed buffer, the same bits from run to run. The walked tiles (and lse,
// delta) come in with cp.async into two stages, so the next tile is in flight
// while this one is multiplied. Walked tiles of 32 rows keep the per-tile
// logits at 16 registers a thread, which is what lets three bf16 blocks (168
// registers) share an SM. The ragged tail is masked here: a query or key past
// S is loaded as zeros, gets no probability and is not stored.
//
// * bfloat16: mma.sync.m16n8k16 (bf16 operands, f32 accumulators). A warp
//   holds its 16 rows of K and V (or Q and dout) as A fragments for the whole
//   walk; the walked tiles are read with ldmatrix, plain for the first two
//   products and .trans for the last ones. P and dS are rounded once to bf16
//   as they become A fragments, as the forward rounds P before P V.
// * float: the same structure on the tf32 tensor cores in three passes
//   (3xTF32, flash_attention_common.cuh): f32-accurate, not the TF32 that
//   allow_tf32 governs. Its cost is in the instructions around the mma:
//   each walked tile is split into hi and lo planes once, by the whole block,
//   instead of by every warp as it reads its fragments; the held tiles stay
//   in shared memory and are split as their fragments are read. The small
//   terms have accumulators of their own and each tile's dK, dV or dQ comes
//   from a fresh accumulator, against the tensor cores' truncation. The
//   accumulator-to-A layout mismatch of tf32 is met by reading the last
//   products' B rows in the permuted order (tf32_pb). Two blocks an SM: their
//   shared memory is 87.5 KB each.
// wgmma, TMA and a persistent grid are left for a later redesign.

#include "flash_attention_common.cuh"

namespace {

using namespace k9;
using bf16 = __nv_bfloat16;

constexpr int T64 = 64;        // keys a dK/dV block, queries a dQ block (four warps of 16 rows)
constexpr int WT = 32;         // rows of a walked tile (queries for dK/dV, keys for dQ)
constexpr int NB = WT / 8;     // n8 blocks of a walked tile
constexpr int THREADS = 128;
constexpr int BF16_BLOCKS_PER_SM = 3;  // held to 168 registers
constexpr int F32_BLOCKS_PER_SM = 2;   // what the f32 kernels' shared memory allows
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_ROWS = DELTA_THREADS / 32;  // rows a block of the delta kernel

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
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

// lse and delta of a walked tile of queries: WT f32 values each from r0, zeros past S
__device__ __forceinline__ void load_stats(float* ls, float* dls, const float* lse, const float* delta, int r0,
                                           int S) {
  const int i = threadIdx.x & (WT - 1);
  const bool valid = r0 + i < S;
  if (threadIdx.x < WT) {
    cp_async4(ls + i, lse + (valid ? r0 + i : 0), valid);
  } else if (threadIdx.x < 2 * WT) {
    cp_async4(dls + i, delta + (valid ? r0 + i : 0), valid);
  }
}

// P^T in place of the logits S^T (16 keys by WT queries from q0), with the
// queries' lse (log-sum-exp) staged in ls: exp2(s log2e S^T - log2e lse),
// none for a query past S
template <int N>
__device__ __forceinline__ void probs_by_column(float (&s)[N][4], const float* ls, int q0, int S, float scale_log2) {
  const int t = threadIdx.x & 3;
  const bool ragged = q0 + 8 * N > S;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], scale_log2, -((e & 1) ? l.y : l.x) * LOG2E));
      s[j][e] = ragged && q0 + c + (e & 1) >= S ? 0.0f : p;
    }
  }
}

// dS^T = P^T (dP^T - delta) in place of dP^T, delta by column (query)
template <int N>
__device__ __forceinline__ void ds_by_column(const float (&p)[N][4], float (&dp)[N][4], const float* dls) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
  }
}

// P and dS in place of the logits S and dP (16 queries by WT keys from k0),
// with this thread's rows' lse in log2 units and delta: none for a key past S
template <int N>
__device__ __forceinline__ void probs_ds_by_row(float (&s)[N][4], float (&dp)[N][4], const float (&l2)[2],
                                                const float (&dl)[2], int k0, int S, float scale_log2) {
  const int t = threadIdx.x & 3;
  const bool ragged = k0 + 8 * N > S;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(s[j][e], scale_log2, -l2[e >> 1]));
      if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= S) p = 0.0f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
    }
  }
}

// this thread's two query rows of a dQ block: lse in log2 units and delta (0
// past S: those rows are not stored)
__device__ __forceinline__ void row_stats(const float* lse, const float* delta, int row0, int S, float (&l2)[2],
                                          float (&dl)[2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    l2[r] = row < S ? lse[row] * LOG2E : 0.0f;
    dl[r] = row < S ? delta[row] : 0.0f;
  }
}

// rows row0 .. row0 + 15 (this warp's) of a (64, D) accumulator -> out, rows past S skipped
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[D / 8][4], float mul, int row0,
                                           int S, int H, int b, int h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    T* o = dst + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(o + 8 * j, acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// ---------------- bfloat16 --------------------------------------------------

// c (16 rows by N n8 blocks) = A B^T over the 64 channels: A held as four
// k-step fragments, B rows 0 .. 8 N - 1 of a row-major [n][k] bf16 tile (ldmatrix)
template <int N>
__device__ __forceinline__ void bf16_abt(const uint32_t (&a)[D / 16][4], const bf16* b_tile, float (&c)[N][4]) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      // B fragments of blocks j and j + 1: (j, k low), (j, k high), (j + 1, k low), (j + 1, k high)
      uint32_t f[4];
      ldmatrix_x4(f, b_tile + (8 * (j + (lmat >> 1)) + lrow) * KP + kk * 16 + 8 * (lmat & 1));
      mma_bf16(c[j], a[kk], f[0], f[1]);
      mma_bf16(c[j + 1], a[kk], f[2], f[3]);
    }
  }
}

// sum (16 rows by 64 columns) += P B over N n8 blocks of k: P given as C
// fragments (two neighbouring blocks, rounded to bf16, are one A fragment of
// 16), B rows 0 .. 8 N - 1 of a row-major [k][n] bf16 tile, transposed by ldmatrix
template <int N>
__device__ __forceinline__ void bf16_pb(const float (&p)[N][4], const bf16* b_tile, float (&sum)[D / 8][4]) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    uint32_t pa[4];
    c_to_bf16_a(p[2 * kk], p[2 * kk + 1], pa);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      // (keys low, channels j), (keys high, j), (keys low, j + 1), (keys high, j + 1)
      uint32_t f[4];
      ldmatrix_x4_trans(f, b_tile + (kk * 16 + 8 * (lmat & 1) + lrow) * KP + 8 * (j + (lmat >> 1)));
      mma_bf16(sum[j], pa, f[0], f[1]);
      mma_bf16(sum[j + 1], pa, f[2], f[3]);
    }
  }
}

// this warp's 16 rows (from r0) of a staged [64][KP] bf16 tile as A fragments, four k-steps of 16 channels
__device__ __forceinline__ void bf16_a_frags(const bf16* tile, int r0, uint32_t (&a)[D / 16][4]) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + (r0 + 8 * (lmat & 1) + lrow) * KP + kk * 16 + 8 * (lmat >> 1));
  }
}

__global__ void __launch_bounds__(THREADS, BF16_BLOCKS_PER_SM)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, Strides sq, Strides sk, Strides sv,
                   Strides sdo, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 ks[T64 * KP];
  __shared__ __align__(16) bf16 vs[T64 * KP];
  __shared__ __align__(16) bf16 qs[2][WT * KP];   // two stages of the walked Q, dout, lse, delta
  __shared__ __align__(16) bf16 dos[2][WT * KP];
  __shared__ __align__(16) float ls[2][WT];
  __shared__ __align__(16) float dls[2][WT];
  const int k0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + ((long long)b * H + h) * S;
  const float* del_b = delta + ((long long)b * H + h) * S;

  load_tile<T64, THREADS>(ks, KP, k + b * sk.b + h * sk.h, sk.s, k0, S);
  load_tile<T64, THREADS>(vs, KP, v + b * sv.b + h * sv.h, sv.s, k0, S);
  load_tile<WT, THREADS>(qs[0], KP, qb, sq.s, 0, S);
  load_tile<WT, THREADS>(dos[0], KP, dob, sdo.s, 0, S);
  load_stats(ls[0], dls[0], lse_b, del_b, 0, S);
  cp_async_commit();
  float acc_dk[D / 8][4], acc_dv[D / 8][4];  // keys warp * 16 + g (+ 8), channels 8 j + 2 t (+ 1)
  zero(acc_dk);
  zero(acc_dv);
  uint32_t ka[D / 16][4], va[D / 16][4];  // this warp's 16 keys of K and V as A fragments

  const int ntiles = (S + WT - 1) / WT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * WT, st = tile & 1;
    __syncthreads();  // the other stage's readers (the previous tile) are done
    if (tile + 1 < ntiles) {
      load_tile<WT, THREADS>(qs[st ^ 1], KP, qb, sq.s, q0 + WT, S);
      load_tile<WT, THREADS>(dos[st ^ 1], KP, dob, sdo.s, q0 + WT, S);
      load_stats(ls[st ^ 1], dls[st ^ 1], lse_b, del_b, q0 + WT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next one stays in flight
    __syncthreads();
    if (tile == 0) {  // the held tile has landed with the first walked one
      bf16_a_frags(ks, warp * 16, ka);
      bf16_a_frags(vs, warp * 16, va);
    }
    float s[NB][4], dp[NB][4];  // S^T and dP^T, 16 keys by WT queries
    bf16_abt(ka, qs[st], s);
    bf16_abt(va, dos[st], dp);
    probs_by_column(s, ls[st], q0, S, scale_log2);
    ds_by_column(s, dp, dls[st]);
    bf16_pb(s, dos[st], acc_dv);  // dV += P^T dout
    bf16_pb(dp, qs[st], acc_dk);  // dK += dS^T Q
  }
  store_rows(dk, acc_dk, scale, k0 + warp * 16, S, H, b, h);
  store_rows(dv, acc_dv, 1.0f, k0 + warp * 16, S, H, b, h);
}

__global__ void __launch_bounds__(THREADS, BF16_BLOCKS_PER_SM)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, Strides sq, Strides sk, Strides sv, Strides sdo,
                  float scale_log2, float scale) {
  __shared__ __align__(16) bf16 qs[T64 * KP];
  __shared__ __align__(16) bf16 dos[T64 * KP];
  __shared__ __align__(16) bf16 ks[2][WT * KP];  // two stages of the walked K and V
  __shared__ __align__(16) bf16 vs[2][WT * KP];
  const int q0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<T64, THREADS>(qs, KP, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<T64, THREADS>(dos, KP, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_tile<WT, THREADS>(ks[0], KP, kb, sk.s, 0, S);
  load_tile<WT, THREADS>(vs[0], KP, vb, sv.s, 0, S);
  cp_async_commit();
  float l2[2], dl[2];
  row_stats(lse + ((long long)b * H + h) * S, delta + ((long long)b * H + h) * S, q0 + warp * 16, S, l2, dl);
  float acc[D / 8][4];
  zero(acc);
  uint32_t qa[D / 16][4], oa[D / 16][4];  // this warp's 16 queries of Q and dout as A fragments

  const int ntiles = (S + WT - 1) / WT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * WT, st = tile & 1;
    __syncthreads();
    if (tile + 1 < ntiles) {
      load_tile<WT, THREADS>(ks[st ^ 1], KP, kb, sk.s, k0 + WT, S);
      load_tile<WT, THREADS>(vs[st ^ 1], KP, vb, sv.s, k0 + WT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == 0) {  // the held tile has landed with the first walked one
      bf16_a_frags(qs, warp * 16, qa);
      bf16_a_frags(dos, warp * 16, oa);
    }
    float s[NB][4], dp[NB][4];  // S and dP, 16 queries by WT keys
    bf16_abt(qa, ks[st], s);
    bf16_abt(oa, vs[st], dp);
    probs_ds_by_row(s, dp, l2, dl, k0, S, scale_log2);
    bf16_pb(dp, ks[st], acc);  // dQ += dS K
  }
  store_rows(dq, acc, scale, q0 + warp * 16, S, H, b, h);
}

// ---------------- float, 3xTF32 ---------------------------------------------

constexpr int HELD = T64 * FP;  // floats of a held f32 tile
constexpr int WALK = WT * FP;   // floats of a walked f32 tile
// two held tiles, two stages of two walked tiles, the lo planes of the current
// walked tiles, two stages of lse and delta
constexpr int F32_SMEM = (2 * HELD + 6 * WALK + 4 * WT) * (int)sizeof(float);

__global__ void __launch_bounds__(THREADS, F32_BLOCKS_PER_SM)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int H, Strides sq, Strides sk, Strides sv,
                  Strides sdo, float scale_log2, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + HELD;
  float* qs = vs + HELD;        // [2][WALK]
  float* dos = qs + 2 * WALK;   // [2][WALK]
  float* qlo = dos + 2 * WALK;  // the lo planes of the current Q and dout tiles
  float* dolo = qlo + WALK;
  float* ls = dolo + WALK;      // [2][WT]
  float* dls = ls + 2 * WT;     // [2][WT]
  const int k0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + ((long long)b * H + h) * S;
  const float* del_b = delta + ((long long)b * H + h) * S;

  load_tile<T64, THREADS>(ks, FP, k + b * sk.b + h * sk.h, sk.s, k0, S);
  load_tile<T64, THREADS>(vs, FP, v + b * sv.b + h * sv.h, sv.s, k0, S);
  load_tile<WT, THREADS>(qs, FP, qb, sq.s, 0, S);
  load_tile<WT, THREADS>(dos, FP, dob, sdo.s, 0, S);
  load_stats(ls, dls, lse_b, del_b, 0, S);
  cp_async_commit();
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  zero(acc_dk);
  zero(acc_dv);

  const int ntiles = (S + WT - 1) / WT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * WT, st = tile & 1;
    __syncthreads();
    if (tile + 1 < ntiles) {
      load_tile<WT, THREADS>(qs + (st ^ 1) * WALK, FP, qb, sq.s, q0 + WT, S);
      load_tile<WT, THREADS>(dos + (st ^ 1) * WALK, FP, dob, sdo.s, q0 + WT, S);
      load_stats(ls + (st ^ 1) * WT, dls + (st ^ 1) * WT, lse_b, del_b, q0 + WT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* qt = qs + st * WALK;
    float* dot = dos + st * WALK;
    split_tile<THREADS>(qt, qlo, WT);  // each walked tile split once, for all four warps
    split_tile<THREADS>(dot, dolo, WT);
    __syncthreads();
    // one product at a time, so that few tiles are live: S^T -> P^T -> dV, then dP^T -> dS^T -> dK
    float s[NB][4], dp[NB][4];
    tf32_abt(ks, warp * 16, qt, qlo, lane, s);
    probs_by_column(s, ls + st * WT, q0, S, scale_log2);
    tf32_pb(s, dot, dolo, lane, acc_dv);  // dV += P^T dout
    tf32_abt(vs, warp * 16, dot, dolo, lane, dp);
    ds_by_column(s, dp, dls + st * WT);
    tf32_pb(dp, qt, qlo, lane, acc_dk);  // dK += dS^T Q
  }
  store_rows(dk, acc_dk, scale, k0 + warp * 16, S, H, b, h);
  store_rows(dv, acc_dv, 1.0f, k0 + warp * 16, S, H, b, h);
}

__global__ void __launch_bounds__(THREADS, F32_BLOCKS_PER_SM)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int H, Strides sq, Strides sk, Strides sv, Strides sdo,
                 float scale_log2, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + HELD;
  float* ks = dos + HELD;       // [2][WALK]
  float* vs = ks + 2 * WALK;    // [2][WALK]
  float* klo = vs + 2 * WALK;   // the lo planes of the current K and V tiles
  float* vlo = klo + WALK;
  const int q0 = blockIdx.x * T64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<T64, THREADS>(qs, FP, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<T64, THREADS>(dos, FP, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_tile<WT, THREADS>(ks, FP, kb, sk.s, 0, S);
  load_tile<WT, THREADS>(vs, FP, vb, sv.s, 0, S);
  cp_async_commit();
  float l2[2], dl[2];
  row_stats(lse + ((long long)b * H + h) * S, delta + ((long long)b * H + h) * S, q0 + warp * 16, S, l2, dl);
  float acc[D / 8][4];
  zero(acc);

  const int ntiles = (S + WT - 1) / WT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * WT, st = tile & 1;
    __syncthreads();
    if (tile + 1 < ntiles) {
      load_tile<WT, THREADS>(ks + (st ^ 1) * WALK, FP, kb, sk.s, k0 + WT, S);
      load_tile<WT, THREADS>(vs + (st ^ 1) * WALK, FP, vb, sv.s, k0 + WT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* kt = ks + st * WALK;
    float* vt = vs + st * WALK;
    split_tile<THREADS>(kt, klo, WT);  // each walked tile split once, for all four warps
    split_tile<THREADS>(vt, vlo, WT);
    __syncthreads();
    float s[NB][4], dp[NB][4];  // S and dP: 16 queries by WT keys
    tf32_abt(qs, warp * 16, kt, klo, lane, s);
    tf32_abt(dos, warp * 16, vt, vlo, lane, dp);
    probs_ds_by_row(s, dp, l2, dl, k0, S, scale_log2);
    tf32_pb(dp, kt, klo, lane, acc);  // dQ += dS K
  }
  store_rows(dq, acc, scale, q0 + warp * 16, S, H, b, h);
}

template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int B, int S, int H, Strides so, Strides sdo,
                 cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  flash_bwd_delta<T><<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS), DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, S, H, so, sdo, rows);
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
  const dim3 grid((S + T64 - 1) / T64, H, B);
  const float scale = 1.0f / sqrtf((float)D), scale_log2 = scale * LOG2E;
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  if (is_bf16) {
    int e = launch_delta<bf16>(out, dout, dp, B, S, H, so, sdo, s);
    if (e) return e;
    const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
               *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
    flash_bwd_dkv_bf16<<<grid, THREADS, 0, s>>>(qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv), S, H, sq, sk, sv, sdo, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16<<<grid, THREADS, 0, s>>>(qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), S, H, sq, sk, sv,
                                               sdo, scale_log2, scale);
    return (int)cudaGetLastError();
  }
  int e = launch_delta<float>(out, dout, dp, B, S, H, so, sdo, s);
  if (e) return e;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *dop = static_cast<const float*>(dout);
  err = cudaFuncSetAttribute(flash_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32<<<grid, THREADS, F32_SMEM, s>>>(qp, kp, vp, dop, lp, dp, static_cast<float*>(dk),
                                                    static_cast<float*>(dv), S, H, sq, sk, sv, sdo, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32<<<grid, THREADS, F32_SMEM, s>>>(qp, kp, vp, dop, lp, dp, static_cast<float*>(dq), S, H, sq, sk,
                                                   sv, sdo, scale_log2, scale);
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
