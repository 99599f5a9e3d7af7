// Bias-free multi-head attention forward with a running softmax, for Hopper
// (sm_90a), kernel K9 of the port.
//
// Replaces the Pallas TPU flash-attention call of
// threedod/ops/attention.py::multi_head_attention (the route it takes at 2048
// tokens and more; jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel). Computes what
// threedod_torch/ops/attention.py::attention_reference computes:
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D)) v[b, j, h, :]
// q, k, v (B, S, H, D) with D = 64 and any strides whose last is 1 (they are
// slices of one qkv projection: nothing is transposed, padded or copied); out
// (B, S, H, D) contiguous, in the inputs' type; when the caller wants a
// gradient, also lse (B, H, S) f32, the row log-sum-exp of the scaled logits in
// natural-log units, which the backward (flash_attention_bwd.cu) rebuilds the
// probabilities from.
//
// What bounds it on an H100: operations, 4 S^2 D a head (bf16 at (1, 2443,
// 16, 64): 0.025 ms of tensor-core time against 0.006 ms of memory time); q,
// k, v and out cross the memory once and the S x S logits never do. So both
// products run on the tensor cores and everything between them stays in
// registers. One block of four warps owns 64 queries of one head of one image
// and walks the keys a tile at a time: K and V tiles come in with cp.async
// into two stages, so the next tile is in flight while this one is
// multiplied; the running row maximum (in log2 units of the scaled logits,
// exp2) and row sum are kept in f32 registers by the four threads that share
// a row, the accumulator is rescaled when the maximum moves, and one division
// ends the row. lse = m ln 2 + log l is converted once, at the store. The
// ragged tail: keys past S get -inf before the maximum (their tiles are
// loaded as zeros), queries past S are computed on zeros and not stored.
//
// * bfloat16: wgmma, the only way to the full bf16 rate. The four warps are
//   one warpgroup: S = Q K^T is wgmma.m64n128k16 over 128-key tiles with A =
//   Q from registers (loaded once by ldmatrix) and B = the K tile from shared
//   memory, K-major; O += P V is wgmma.m64n64k16 with A = P, the logits'
//   accumulators after the exponential and one rounding to bf16 (the
//   accumulator layout is the A fragment layout), and B = the V tile read
//   MN-major through the instruction's transpose bit. K and V tiles are
//   stored with the 128-byte swizzle that the descriptors name, 1024-byte
//   aligned, and cp.async writes them through the generic proxy, so a
//   fence.proxy.async precedes the barrier before the wgmma that reads them.
//   Three blocks an SM (168 registers, 74 KB of shared memory) overlap one
//   block's softmax with another's products.
// * float: mma.sync.m16n8k8 on the tf32 tensor cores in three passes
//   (3xTF32, flash_attention_common.cuh): f32-accurate, not the TF32 that
//   allow_tf32 governs. The cost is in the instructions around the mma:
//   each 32-key K and V tile is split into hi and lo planes once, by the whole
//   block, and the warps read hi and lo fragments from them; Q stays in
//   shared memory and is split as its fragments are read; P's accumulators
//   become A fragments in the permuted order {c0, c2, c1, c3}, and V's B rows
//   are read in the same order (tf32_pb). The small terms have accumulators
//   of their own and each tile's P V comes from fresh accumulators, added to O
//   in f32, against the tensor cores' truncation. Three blocks an SM.
// TMA, warp specialisation and overlap of the softmax with the products
// inside a block are left for a later redesign.

#include "flash_attention_common.cuh"

namespace {

using namespace k9;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;   // queries a block (one warpgroup, 16 a warp)
constexpr int BK = 128;  // keys a bf16 tile
constexpr int THREADS = 128;
constexpr int BF16_BLOCKS_PER_SM = 3;  // held to 168 registers and 74 KB of shared memory

// ---------------- wgmma --------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// cp.async writes shared memory through the generic proxy, wgmma reads it through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 64, f32) += a (64 x 16, bf16 registers) b (16 x 64, bf16 in shared memory); d is
// read only when scale_d is not 0; TRANS_B: b is MN-major (its n index contiguous)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 128, f32) += a (64 x 16, bf16 registers) b (16 x 128, bf16 in shared memory); d is
// read only when scale_d is not 0; TRANS_B: b is MN-major (its n index contiguous)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// rows [r0, r0 + ROWS) -> a [ROWS][64] bf16 tile of 128-byte rows in the
// 128-byte swizzle (16-byte piece c of row r at piece c ^ (r % 8)); zeros
// past S; asynchronous
template <int ROWS>
__device__ __forceinline__ void load_tile_sw128(bf16* tile, const bf16* base, long long row_stride, int r0, int S) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int r = idx >> 3, c = idx & 7;
    const bool valid = r0 + r < S;
    cp_async16(tile + r * D + ((c ^ (r & 7)) << 3), base + (long long)(valid ? r0 + r : 0) * row_stride + c * 8,
               valid);
  }
}

// ---------------- the running softmax, both dtypes -------------------------

// logits s of 16 rows by NB * 8 keys from k0 (scaled here by scale_log2) ->
// unnormalised probabilities; m, l: running maximum and this thread's share
// of the running sum of rows g and g + 8; o rescaled
template <int NB>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float (&m)[2], float (&l)[2],
                                               float (&o)[D / 8][4], int k0, int S, float scale_log2) {
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
  if (k0 + NB * 8 <= S) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
  } else {  // the ragged last tile: keys past S leave the softmax
#pragma unroll
    for (int j = 0; j < NB; ++j) {
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
  for (int j = 0; j < NB; ++j) {
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
}

// the end of a row: out = o / l, and lse when asked for
template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, float* __restrict__ lse, float (&o)[D / 8][4],
                                          float (&m)[2], float (&l)[2], int row0, int S, int H, int b, int h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    // the maximum is kept in log2 units of the scaled logits: back to natural log once, here
    if (lse != nullptr && t == 0) lse[((long long)b * H + h) * S + row] = m[r] * 0.6931471805599453f + logf(l[r]);
    const float inv = 1.0f / l[r];
    T* op = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ---------------- bfloat16, wgmma -------------------------------------------

constexpr int BF16_TILE = BK * D;  // elements of one swizzled K or V tile (16 KB)
// two stages of K and V, the Q tile, and room to align the tiles to 1024 bytes
constexpr int BF16_SMEM = (4 * BF16_TILE + BQ * KP) * (int)sizeof(bf16) + 1024;

__global__ void __launch_bounds__(THREADS, BF16_BLOCKS_PER_SM)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ out, float* __restrict__ lse, int S, int H, Strides sq, Strides sk, Strides sv,
               float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t pad = (1024u - ((uint32_t)__cvta_generic_to_shared(smem) & 1023u)) & 1023u;
  bf16* ks = reinterpret_cast<bf16*>(smem + pad);  // [2][BF16_TILE]
  bf16* vs = ks + 2 * BF16_TILE;                   // [2][BF16_TILE]
  bf16* qs = vs + 2 * BF16_TILE;                   // [BQ][KP]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lrow = lane & 7, lmat = lane >> 3;  // the ldmatrix row and matrix this lane names
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<BQ, THREADS>(qs, KP, q + b * sq.b + h * sq.h, sq.s, q0, S);
  cp_async_commit();
  load_tile_sw128<BK>(ks, kb, sk.s, 0, S);
  load_tile_sw128<BK>(vs, vb, sv.s, 0, S);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  // this warp's 16 queries as A fragments (wgmma's register A is mma.sync's
  // m16n8k16 A, a warp a 16-row slice), four k-steps of 16 channels
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + 8 * (lmat & 1) + lrow) * KP + kk * 16 + 8 * (lmat >> 1));
  }

  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  const int ntiles = (S + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK, st = tile & 1;
    __syncthreads();  // the other stage's wgmma reads (the previous tile) are done
    if (tile + 1 < ntiles) {
      load_tile_sw128<BK>(ks + (st ^ 1) * BF16_TILE, kb, sk.s, k0 + BK, S);
      load_tile_sw128<BK>(vs + (st ^ 1) * BF16_TILE, vb, sv.s, k0 + BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next one stays in flight
    fence_proxy_async();
    __syncthreads();
    const bf16* kt = ks + st * BF16_TILE;
    const bf16* vt = vs + st * BF16_TILE;

    // S = Q K^T, 64 queries by 128 keys: K-major B, 8-row groups 1024 bytes
    // apart, a k-step of 16 channels 32 bytes along the swizzled rows
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_128<0>(s, qa[kk], sw128_desc(kt + kk * 16, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();

    online_softmax<BK / 8>(s, m, l, o, k0, S, scale_log2);

    // O += P V: two neighbouring logit blocks are one A fragment of 16 keys;
    // V [key][channel] is MN-major for B (transpose bit), 16 keys = 2048 bytes
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) c_to_bf16_a(s[2 * kk], s[2 * kk + 1], pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_64<1>(o, pa[kk], sw128_desc(vt + kk * 16 * D, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
  }
  store_out(out, lse, o, m, l, q0 + warp * 16, S, H, b, h);
}

// ---------------- float, 3xTF32 ---------------------------------------------

constexpr int WT = 32;  // keys a f32 tile
constexpr int F32_BLOCKS_PER_SM = 3;
constexpr int WALK = WT * FP;  // floats of one f32 K or V tile
// the Q tile, two stages of K and V, the lo planes of the current K and V
constexpr int F32_SMEM = (BQ * FP + 6 * WALK) * (int)sizeof(float);

__global__ void __launch_bounds__(THREADS, F32_BLOCKS_PER_SM)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, float* __restrict__ lse, int S, int H, Strides sq, Strides sk, Strides sv,
              float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;             // [BQ][FP]
  float* ks = qs + BQ * FP;    // [2][WALK]
  float* vs = ks + 2 * WALK;   // [2][WALK]
  float* klo = vs + 2 * WALK;  // the lo planes of the current K and V tiles
  float* vlo = klo + WALK;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<BQ, THREADS>(qs, FP, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<WT, THREADS>(ks, FP, kb, sk.s, 0, S);
  load_tile<WT, THREADS>(vs, FP, vb, sv.s, 0, S);
  cp_async_commit();
  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  const int ntiles = (S + WT - 1) / WT;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * WT, st = tile & 1;
    __syncthreads();  // the other stage's readers (the previous tile) are done
    if (tile + 1 < ntiles) {
      load_tile<WT, THREADS>(ks + (st ^ 1) * WALK, FP, kb, sk.s, k0 + WT, S);
      load_tile<WT, THREADS>(vs + (st ^ 1) * WALK, FP, vb, sv.s, k0 + WT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* kt = ks + st * WALK;
    float* vt = vs + st * WALK;
    split_tile<THREADS>(kt, klo, WT);  // each tile split once, for all four warps
    split_tile<THREADS>(vt, vlo, WT);
    __syncthreads();
    float s[WT / 8][4];  // S = Q K^T, 16 queries by WT keys
    tf32_abt(qs, warp * 16, kt, klo, lane, s);
    online_softmax<WT / 8>(s, m, l, o, k0, S, scale_log2);
    tf32_pb(s, vt, vlo, lane, o);  // O += P V, each tile's product from fresh accumulators
  }
  store_out(out, lse, o, m, l, q0 + warp * 16, S, H, b, h);
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
  const float scale_log2 = LOG2E / sqrtf((float)D);
  if (is_bf16) {
    err = cudaFuncSetAttribute(flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16<<<grid, THREADS, BF16_SMEM, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                    static_cast<const bf16*>(v), static_cast<bf16*>(out),
                                                    static_cast<float*>(lse), S, H, sq, sk, sv, scale_log2);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<<<grid, THREADS, F32_SMEM, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                  static_cast<const float*>(v), static_cast<float*>(out),
                                                  static_cast<float*>(lse), S, H, sq, sk, sv, scale_log2);
  }
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
