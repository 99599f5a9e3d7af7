// Shared pieces of kernel K9's forward (flash_attention_fwd.cu) and backward
// (flash_attention_bwd.cu): strides, cp.async staging, ldmatrix, the bf16 and
// tf32 mma.sync wrappers, the 3xTF32 split and products, conversions and tile
// loaders.
//
// Fragment layouts of mma.sync (thread (g, t) = (lane / 4, lane % 4)):
//   m16n8k16 bf16  A: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//                  B: (k 2t..2t+1, n g), (k 2t+8.., n g)
//   m16n8k8  tf32  A: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
//                  B: (k t, n g), (k t+4, n g)
//   both           C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// The bf16 C fragments of two neighbouring n8 blocks are, packed to bf16, one
// A fragment of the next product. The tf32 C fragment is not a tf32 A
// fragment (columns 2t, 2t+1 against t, t+4): the next product reads its A as
// {c0, c2, c1, c3}, so that logical column t is physical column 2t and t + 4
// is 2t + 1, and reads its B rows in the same permuted order (tf32_pb).
// A sum over k does not depend on the order of k.
//
// 3xTF32: a f32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x -
// hi) (x - hi is exact in f32), and a b is formed as lo_a hi_b + hi_a lo_b +
// hi_a hi_b on the tf32 tensor cores with f32 accumulators: about 22 bits of
// each operand, the dropped lo lo term 2^-22 relative; the accumulators are
// chosen against the tensor cores' truncation (below). This is f32-accurate
// arithmetic, not the TF32 that torch.backends.cuda.matmul.allow_tf32 turns
// on (one pass on operands truncated to 10 mantissa bits). cvt.rna rounds; a
// raw f32 register fed to a tf32 mma would be truncated.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace k9 {

constexpr int D = 64;       // head width
constexpr int KP = D + 8;   // bf16 tile pitch: rows 16 bytes off a multiple of 128, conflict-free ldmatrix
constexpr int FP = D + 4;   // f32 tile pitch: conflict-free ldmatrix rows and tf32_pb's column reads
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the last dimension's stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// two neighbouring outputs p[0], p[1], rounded once to T
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the bf16 m16n8k16 A fragment of 16 columns whose two n8 halves are the f32
// accumulators lo and hi (rounded once to bf16)
__device__ __forceinline__ void c_to_bf16_a(const float (&lo)[4], const float (&hi)[4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---------------- asynchronous copies ---------------------------------------

// 16 bytes global -> shared without passing through registers; zeros when
// `valid` is false (a source size of 0 fills the destination with zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of one head of one image (64 elements each, row
// stride `row_stride`) -> tile[ROWS][pitch], zeros past S; asynchronous, by
// NT threads: the caller commits and waits
template <int ROWS, int NT, typename T>
__device__ __forceinline__ void load_tile(T* tile, int pitch, const T* base, long long row_stride, int r0, int S) {
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;  // 16-byte pieces a row
  constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int idx = threadIdx.x + NT * i;
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * PER;
    const bool valid = r0 + r < S;
    cp_async16(tile + r * pitch + c, base + (long long)(valid ? r0 + r : 0) * row_stride + c, valid);
  }
}

// n = 64 consecutive f32 values of a (B, H, S) row from r0, zeros past S
template <int NT>
__device__ __forceinline__ void load_row64(float* dst, const float* row, int r0, int S) {
  for (int i = threadIdx.x; i < 64; i += NT) cp_async4(dst + i, row + (r0 + i < S ? r0 + i : 0), r0 + i < S);
}

// ---------------- fragments and products ------------------------------------

// four 8x8 16-bit matrices from shared memory, one row address a lane (lanes
// 8 m .. 8 m + 7 name the rows of matrix m); thread (g, t) gets elements
// (g; 2 t, 2 t + 1) of each, or with `.trans` elements (2 t, 2 t + 1; g). On a
// f32 tile a row of 16 bytes is 4 floats and thread (g, t) gets float (g; t).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------- 3xTF32 ------------------------------------------------------
//
// The tensor cores align a product's terms to the largest and truncate, so
// every mma into an accumulator of magnitude A costs up to an ulp of A,
// always towards zero: along a chain of mma calls the error grows with the
// chain's length, not its square root. Two rules keep that at f32 accuracy:
// the small terms (lo hi, hi lo) of a product go into an accumulator of their
// own, added to the hi hi terms' once at the end; and a sum across tiles
// takes each tile's product from a fresh accumulator and adds it with an
// ordinary (rounded) f32 add. Products run over four n8 blocks (32 columns)
// at a time, so the small terms' accumulator is 16 registers.

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
  }
}

// c[c0 + n] += sm[n], n < 4, rounded
template <int N>
__device__ __forceinline__ void add4(float (&c)[N][4], int c0, const float (&sm)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[c0 + n][e] += sm[n][e];
  }
}

// the A fragment (16 rows from r0, k columns k0 .. k0 + 7) of a row-major f32 tile, split
__device__ __forceinline__ void tf32_a(const float* tile, int r0, int k0, int lane, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  uint32_t x[4];
  ldmatrix_x4(x, tile + (r0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * FP + k0 + 4 * (lane >> 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// the rows [0, rows) of a landed row-major f32 tile split in place: the tile
// keeps hi, `lo` (same layout) gets lo; by NT threads. A walked tile is split
// once here rather than by each warp as it reads its fragments.
template <int NT>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += NT) {
    const int at = (i / (D / 4)) * FP + (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + at);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(tile + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// c (16 rows by NB n8 blocks, fresh) = A B^T over the 64 channels: A rows r0
// .. r0 + 15 of a row-major f32 tile, split as its fragments are read; B rows
// 0 .. 8 NB - 1 of a row-major [n][k] f32 tile split into planes bhi, blo
// (split_tile), its fragments read by ldmatrix (row n, columns k .. k + 3 is
// b0 of thread (n % 8, k))
template <int NB>
__device__ __forceinline__ void tf32_abt(const float* a_tile, int r0, const float* bhi, const float* blo, int lane,
                                         float (&c)[NB][4]) {
  const int boff = (8 * (lane >> 4) + (lane & 7)) * FP + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int c0 = 0; c0 < NB; c0 += 4) {
    float sm[4][4];
    zero(sm);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[c0 + n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      tf32_a(a_tile, r0, kk * 8, lane, ah, al);
#pragma unroll
      for (int jp = 0; jp < 4; jp += 2) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, bhi + boff + 8 * (c0 + jp) * FP + kk * 8);
        ldmatrix_x4(bl, blo + boff + 8 * (c0 + jp) * FP + kk * 8);
        mma_tf32(sm[jp], al, bh[0], bh[1]);
        mma_tf32(sm[jp], ah, bl[0], bl[1]);
        mma_tf32(c[c0 + jp], ah, bh[0], bh[1]);
        mma_tf32(sm[jp + 1], al, bh[2], bh[3]);
        mma_tf32(sm[jp + 1], ah, bl[2], bl[3]);
        mma_tf32(c[c0 + jp + 1], ah, bh[2], bh[3]);
      }
    }
    add4(c, c0, sm);
  }
}

// sum (16 rows by 64 columns) += P B over KB k blocks of 8, each group of
// four n8 blocks from fresh accumulators: P given as the C fragments p[j] of
// its k blocks j, B rows 0 .. 8 KB - 1 of a row-major [k][n] f32 tile split
// into planes bhi, blo. P's fragments are read as A in the order {c0, c2, c1,
// c3} (logical columns t, t + 4 are physical columns 2t, 2t + 1), B's rows in
// the same order.
template <int KB>
__device__ __forceinline__ void tf32_pb(const float (&p)[KB][4], const float* bhi, const float* blo, int lane,
                                        float (&sum)[D / 8][4]) {
  const int boff = 2 * (lane & 3) * FP + (lane >> 2);
  const uint32_t* hp = reinterpret_cast<const uint32_t*>(bhi) + boff;
  const uint32_t* lp = reinterpret_cast<const uint32_t*>(blo) + boff;
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += 4) {
    float big[4][4], sm[4][4];
    zero(big);
    zero(sm);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int o0 = 8 * j * FP + 8 * (c0 + n), o1 = o0 + FP;
        mma_tf32(sm[n], al, hp[o0], hp[o1]);
        mma_tf32(sm[n], ah, lp[o0], lp[o1]);
        mma_tf32(big[n], ah, hp[o0], hp[o1]);
      }
    }
    add4(big, 0, sm);
    add4(sum, c0, big);
  }
}

}  // namespace k9
