// Device routines shared by the five fused-forward kernels of the port
// (K4 fused_basic_block.cu, K5 fused_tree_tail.cu, K6 fused_block_down.cu,
// K7 fused_conv_relu_head.cu, K8 fused_fpn_level.cu), for Hopper (sm_90a).
//
// Each kernel is a chain of small matrix products over a tile of one image
// that stays in shared memory: a 3x3 (or 1x1) convolution is the product of
// the tile's positions (M) by the output channels (N), summed over taps and
// input channels (K). Activations are channels-last: a tile is (rows, cols,
// pitch) with the channels innermost.
//
// One block has 256 threads and covers 128 positions by 64 channels in one
// pass; a region larger than that takes several passes (for_each_pass). The
// weights of a pass go through shared memory 32 (float) or 64 (bfloat16)
// input channels at a time, into two buffers in turn, and the next stage is
// fetched into registers while the current one is multiplied (mma_taps). Two
// ways to multiply, chosen by the storage type:
//
// * float: on the CUDA cores. The threads are 16 position groups by 16
//   channel groups; a thread sums 8 positions by 4 channels in registers with
//   f32 FMAs. Weights are (taps, Cin, Cout), staged as f32; the 16 threads of
//   a position group read the same tile address, which shared memory
//   broadcasts. This is the exact-f32 path that the comparisons with the
//   plain version and the CPU rest on.
// * bfloat16: on the tensor cores, with mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators). Each of the 8 warps owns 16 positions by all 64 channels:
//   8 accumulator fragments, 32 registers a thread. A thread loads its A
//   fragment straight from the tile with four 32-bit loads at its own two
//   positions' addresses, so positions need no regular stride (a region row
//   may wrap, a stride-2 conv skips positions). For those loads to spread
//   over the banks, a tile's channel pitch is padded by 8 values where the
//   channel count is a multiple of 16. Weights are (taps, Cout, Cin), staged
//   as [64 channels][64 + 8] bf16, so a B fragment is two 32-bit loads.
//
// Between two convolutions a value is rounded to the storage type (IO<T>::
// storev) and positions outside the image are forced to zero by the kernels'
// epilogues: the next convolution's padding is zeros, not the previous one
// evaluated outside the image.
//
// wgmma, TMA and clusters are left for a later redesign.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace fc {

constexpr int THREADS = 256;
constexpr int NC = 64;   // channels a pass
constexpr int MP = 128;  // positions a pass
constexpr int KC = 32;   // input channels staged at a time, float
constexpr int KCB = 64;  // the same, bfloat16
constexpr int KP = KCB + 8;  // k pitch of the staged bfloat16 weights, for conflict-free B loads
// two staging buffers, so that one block-wide barrier a stage is enough: the
// next stage is written into the buffer that was read two stages ago
constexpr int WSM_BYTES = 2 * (KC * NC * 4 > NC * KP * 2 ? KC * NC * 4 : NC * KP * 2);
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may ask for

// Work of one stage of a block, in units of one input channel of one pass:
// a region of `positions` by `cout` channels takes whole passes of 128 by 64.
inline double stage_slots(int positions, int cout, int taps, int K) {
  return (double)((positions + MP - 1) / MP) * ((cout + NC - 1) / NC) * taps * K;
}

// The output tile (rows, cols) of one block: of those whose buffers fit in
// shared memory (`bytes(th, tw)`), the one with the least work over the whole
// H x W map, blocks times `slots(th, tw)`. A larger tile recomputes less halo
// but may fill its passes worse or leave a ragged edge; false if none fits.
template <typename Bytes, typename Slots>
inline bool pick_tile(int H, int W, Bytes bytes, Slots slots, int* th, int* tw) {
  const int hs[] = {1, 2, 3, 4, 6, 8, 12, 16};
  const int ws[] = {1, 2, 4, 6, 8, 12, 16, 24, 32};
  double best = -1.0;
  for (int h : hs) {
    for (int w : ws) {
      if (bytes(h, w) > (size_t)SMEM_LIMIT) continue;
      const double cost = (double)((H + h - 1) / h) * ((W + w - 1) / w) * slots(h, w);
      if (best < 0.0 || cost <= best) {  // on a tie the larger tile, which loads less halo
        best = cost;
        *th = h;
        *tw = w;
      }
    }
  }
  return best >= 0.0;
}

// Where a block of weights lives. float: element (tap, k, n) at
// p[(tap * K + k) * ld + n]; bfloat16: at p[(tap * cout + n) * ld + k].
template <typename T>
struct Weights {
  const T* p;
  int cout;
  int ld;
};

template <typename T>
struct IO;

template <>
struct IO<float> {
  static constexpr int NP = 8;  // positions a thread holds in a pass
  static constexpr int EW = 4;  // neighbouring channels an epilogue call gets
  __host__ __device__ static int pitch(int c) { return c; }
  // a conv's whole kernel, (taps, K, cout)
  __device__ static Weights<float> conv(const float* w, int K, int cout) { return {w, cout, cout}; }
  // rows [row, row + K) of a (ktot, cout) matrix
  __device__ static Weights<float> rows(const float* w, int row, int ktot, int cout) {
    return {w + (size_t)row * cout, cout, cout};
  }
  __device__ static __forceinline__ void load4(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static __forceinline__ void loadv(const float* p, float* v) { load4(p, v); }
  __device__ static __forceinline__ void storev(float* p, const float* v) { store4(p, v); }
  __device__ static __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <>
struct IO<__nv_bfloat16> {
  static constexpr int NP = 2;
  static constexpr int EW = 2;
  // channel pitch of a tile: 16 bytes off a multiple of 32, so that the eight
  // positions a warp reads at once fall on different banks
  __host__ __device__ static int pitch(int c) { return c % 16 == 0 ? c + 8 : c; }
  // a conv's whole kernel, (taps, cout, K)
  __device__ static Weights<__nv_bfloat16> conv(const __nv_bfloat16* w, int K, int cout) {
    return {w, cout, K};
  }
  // columns [row, row + K) of a (cout, ktot) matrix
  __device__ static Weights<__nv_bfloat16> rows(const __nv_bfloat16* w, int row, int ktot, int cout) {
    return {w + row, cout, ktot};
  }
  __device__ static __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xffff0000u);
  }
  __device__ static __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  __device__ static __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(raw << 16);
    v[1] = __uint_as_float(raw & 0xffff0000u);
  }
  __device__ static __forceinline__ void storev(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
  __device__ static __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// Copy the (th, tw, C) window of one image whose first position is (y0, x0)
// into a shared tile of channel pitch IO<T>::pitch(C), with zeros outside the
// image. C is a multiple of 8.
template <typename T>
__device__ __forceinline__ void load_tile(T* sm, const T* img, int H, int W, int C,
                                          int y0, int x0, int th, int tw) {
  constexpr int V = 16 / sizeof(T);
  const int cp = IO<T>::pitch(C);
  const int cv = C / V;
  const int n = th * tw * cv;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int p = i / cv;
    const int c = (i - p * cv) * V;
    const int y = p / tw;
    const int gy = y0 + y;
    const int gx = x0 + (p - y * tw);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = *reinterpret_cast<const uint4*>(img + ((size_t)gy * W + gx) * C + c);
    }
    *reinterpret_cast<uint4*>(sm + (size_t)p * cp + c) = v;
  }
}

// acc += sum over taps (dy, dx) and k < K of
//     a[off[i] + dy * row_pitch + dx * col_pitch + k] * w(dy * ntap + dx, k, co0 + n)
// for this thread's positions (off) and channels, in the layout of its
// storage type (see for_each_pass). `a` is a tile in shared memory or an image
// in global memory; `ncols` channels from co0 on are valid. Every thread of
// the block must call it with the same ntap, K, w, co0 and ncols: it
// synchronises the block.

// float: acc[i][j] is position i of 8 (off[i]), channel co0 + 4 * (tid % 16) + j.
// K is a multiple of 4, ncols of 4.
__device__ __forceinline__ void fetch_weights(float (&pre)[KC / 16][4], const Weights<float>& w, int K,
                                              int kchunks, int chunk, int co0, bool col_ok) {
  const int t = chunk / kchunks;
  const int k0 = (chunk - t * kchunks) * KC;
  const int cg = threadIdx.x & 15;
  const int srow = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < KC / 16; ++r) {
    const int k = k0 + srow + 16 * r;
    if (col_ok && k < K) {
      IO<float>::load4(w.p + ((size_t)t * K + k) * w.ld + co0 + cg * 4, pre[r]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[r][j] = 0.0f;
    }
  }
}

__device__ __forceinline__ void mma_taps(float (&acc)[8][4], const float* a, const int (&off)[8],
                                         int row_pitch, int col_pitch, int ntap, int K,
                                         const Weights<float>& w, int co0, int ncols, float* wsm) {
  const int cg = threadIdx.x & 15;
  const int srow = threadIdx.x >> 4;
  const bool col_ok = cg * 4 < ncols;
  const int kchunks = (K + KC - 1) / KC;
  const int total = ntap * ntap * kchunks;
  float pre[KC / 16][4];
  fetch_weights(pre, w, K, kchunks, 0, co0, col_ok);
  __syncthreads();  // an earlier call's readers are done with both buffers
  for (int chunk = 0; chunk < total; ++chunk) {
    float* buf = wsm + (chunk & 1) * (KC * NC);
#pragma unroll
    for (int r = 0; r < KC / 16; ++r) {
      *reinterpret_cast<float4*>(buf + (srow + 16 * r) * NC + cg * 4) =
          make_float4(pre[r][0], pre[r][1], pre[r][2], pre[r][3]);
    }
    __syncthreads();
    if (chunk + 1 < total) fetch_weights(pre, w, K, kchunks, chunk + 1, co0, col_ok);
    if (!col_ok) continue;
    const int t = chunk / kchunks;
    const int k0 = (chunk - t * kchunks) * KC;
    const int kc = min(KC, K - k0);
    const int ty = t / ntap;
    const int tap_off = ty * row_pitch + (t - ty * ntap) * col_pitch + k0;
    for (int kk = 0; kk < kc; kk += 4) {
      float av[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) IO<float>::load4(a + off[i] + tap_off + kk, av[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(buf + (kk + j) * NC + cg * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(av[i][j], b.x, acc[i][0]);
          acc[i][1] = fmaf(av[i][j], b.y, acc[i][1]);
          acc[i][2] = fmaf(av[i][j], b.z, acc[i][2]);
          acc[i][3] = fmaf(av[i][j], b.w, acc[i][3]);
        }
      }
    }
  }
}

// bfloat16: the warp's 16 positions are rows of m16n8k16 fragments; this
// thread (g = lane / 4, t = lane % 4) addresses rows g (off[0]) and g + 8
// (off[1]). acc[j] is the accumulator fragment of channels co0 + 8 j ..
// + 7: acc[j][0..1] row g, acc[j][2..3] row g + 8, channels 8 j + 2 t, + 1.
// K is a multiple of 16.
struct StagedWeights {
  uint4 lo, hi;  // k values [8 q, 8 q + 8) and [32 + 8 q, 32 + 8 q + 8) of channel tid / 4, q = tid % 4
};

__device__ __forceinline__ StagedWeights fetch_weights(const Weights<__nv_bfloat16>& w, int K, int kchunks,
                                                       int chunk, int co0, int ncols) {
  const int t = chunk / kchunks;
  const int k = (chunk - t * kchunks) * KCB + (threadIdx.x & 3) * 8;
  const int n = threadIdx.x >> 2;
  StagedWeights s;
  s.lo = s.hi = make_uint4(0u, 0u, 0u, 0u);
  if (n < ncols) {
    const __nv_bfloat16* p = w.p + ((size_t)t * w.cout + co0 + n) * w.ld + k;
    if (k < K) s.lo = *reinterpret_cast<const uint4*>(p);
    if (k + 32 < K) s.hi = *reinterpret_cast<const uint4*>(p + 32);
  }
  return s;
}

__device__ __forceinline__ void mma_taps(float (&acc)[8][4], const __nv_bfloat16* a, const int (&off)[2],
                                         int row_pitch, int col_pitch, int ntap, int K,
                                         const Weights<__nv_bfloat16>& w, int co0, int ncols, float* wsm_raw) {
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(wsm_raw);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kchunks = (K + KCB - 1) / KCB;
  const int total = ntap * ntap * kchunks;
  StagedWeights pre = fetch_weights(w, K, kchunks, 0, co0, ncols);
  __syncthreads();  // an earlier call's readers are done with both buffers
  for (int chunk = 0; chunk < total; ++chunk) {
    __nv_bfloat16* buf = wsm + (chunk & 1) * (NC * KP);
    __nv_bfloat16* dst = buf + (threadIdx.x >> 2) * KP + (threadIdx.x & 3) * 8;
    *reinterpret_cast<uint4*>(dst) = pre.lo;
    *reinterpret_cast<uint4*>(dst + 32) = pre.hi;
    __syncthreads();
    if (chunk + 1 < total) pre = fetch_weights(w, K, kchunks, chunk + 1, co0, ncols);
    const int t = chunk / kchunks;
    const int k0 = (chunk - t * kchunks) * KCB;
    const int kc = min(KCB, K - k0);
    const int ty = t / ntap;
    const int tap_off = ty * row_pitch + (t - ty * ntap) * col_pitch + k0 + 2 * t4;
    for (int kk = 0; kk < kc; kk += 16) {
      const __nv_bfloat16* ap0 = a + off[0] + tap_off + kk;
      const __nv_bfloat16* ap1 = a + off[1] + tap_off + kk;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap0);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap1);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap0 + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap1 + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j < ncols) {
          const __nv_bfloat16* bp = buf + (8 * j + g) * KP + kk + 2 * t4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
      }
    }
  }
}

// Walk a region of oh x ow positions and `cout` channels (a multiple of 4) in
// passes of 128 positions by 64 channels. `accumulate(acc, py, px, co0, ncols)`
// sums the pass with mma_taps at this thread's IO<T>::NP positions (every
// thread calls it; positions past the end of the region repeat the last one
// and are dropped here); `epilogue(py, px, co, v)` gets each real position
// with its IO<T>::EW sums for channels co .. co + EW - 1.
template <typename T, typename Acc, typename Epi>
__device__ __forceinline__ void for_each_pass(int oh, int ow, int cout, Acc accumulate, Epi epilogue) {
  constexpr int NP = IO<T>::NP;
  constexpr bool cores = sizeof(T) == 4;
  const int lane = threadIdx.x & 31;
  // float: position group tid / 16, positions 16 apart; bfloat16: rows g and g + 8 of the warp's 16
  const int first = cores ? threadIdx.x >> 4 : (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int step = cores ? 16 : 8;
  const int m = oh * ow;
  for (int pb = 0; pb < m; pb += MP) {
    int py[NP], px[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = min(pb + first + step * i, m - 1);
      py[i] = p / ow;
      px[i] = p - py[i] * ow;
    }
    for (int co0 = 0; co0 < cout; co0 += NC) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      accumulate(acc, py, px, co0, min(NC, cout - co0));
      if constexpr (cores) {
        const int co = co0 + (threadIdx.x & 15) * 4;
        if (co < cout) {
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (pb + first + step * i < m) epilogue(py[i], px[i], co, acc[i]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = co0 + 8 * j + 2 * (lane & 3);
          if (co < cout) {
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              if (pb + first + step * i < m) {
                float v[2] = {acc[j][2 * i], acc[j][2 * i + 1]};
                epilogue(py[i], px[i], co, v);
              }
            }
          }
        }
      }
    }
  }
}

__host__ __device__ inline bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

}  // namespace fc
