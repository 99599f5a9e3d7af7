// Implicit-GEMM convolutions on Hopper's tensor cores (sm_90a): wgmma with
// B (and, for the 1x1, A) read from shared memory, both operands brought by
// the TMA (tensor copies for the activations, bulk copies for the weights)
// into rings of shared memory guarded by mbarriers. Kernel K4
// (fused_basic_block.cu) runs its two convolutions on the 3x3; K5
// (fused_tree_tail.cu) runs its blocks on the 3x3 and its root on the 1x1;
// K6 (fused_block_down.cu) runs its stride-2 convolution on the stride-2 3x3
// (which also writes the pooled or subsampled input), its projection on the
// 1x1 and its second convolution on the 3x3 with the residual; K7
// (fused_conv_relu_head.cu) runs its convolution on the 3x3 and its 15
// predictors on the 1x1 (a ragged row of outputs); K8 (fused_fpn_level.cu)
// runs its lateral and carry on the 1x1 and its output convolution on the
// 3x3 without relu.
//
// ---- conv3x3_wgmma<BN, MT, RESID, RELU>
//
//     out[p, n] = act(sum over taps (dy, dx) and k of x[p + (dy-1) W + dx - 1, k] w[tap, n, k]
//                     + bias[n] (+ resid[p, n]))
// act = relu, or the identity when RELU is off; zero padding outside the
// image, x, resid and out (P, C) channels-last bf16 (P = B H W positions),
// sums in f32, one rounding at the store. Cin = Cout = C, a multiple of 16.
//
// The GEMM: M is the flattened positions, 64 a warpgroup and MT (1 or 2)
// warpgroups a block, so only the map's last tile is ragged; N is a slice of
// BN (64 or 128) output channels; K is 9 taps x C, walked as k-chunks of 64
// input channels, each chunk through its 9 taps. A block has MT consumer
// warpgroups and one producer warp:
//
// * the producer's one thread copies, for each k-chunk, the activation slab
//   that the tile's 9 taps read: a run of 64 MT + 2 W + 2 positions, or three
//   bands of 64 MT + 2 (one a tap row) where that is shorter, each by one
//   tensor copy of a tensor map over x as a (P, C) matrix (64 channels by the
//   rows, 128-byte swizzle, zeros outside the matrix: rows before 0 or past
//   P, channels past C), into a ring of two slab stages; and for each (chunk,
//   tap) the BN x 64 weight tile, by one bulk copy, into a ring of four
//   stages. The weights are packed once on the host
//   (threedod_torch/ops/fused_conv.py::pack_conv3x3) as (chunk, tap, Cout
//   padded to 128, 64) with each 128-byte row already in the 128-byte
//   swizzle, so a copy lands a tile in the layout the B descriptor names.
//   Each stage has a full barrier (the copies' bytes) and an empty barrier
//   (every consumer thread): no block-wide barrier in the loop.
// * each consumer warpgroup reads its A fragments from the slab with
//   ldmatrix, one row address a lane: the tap shift is an offset, a tap
//   outside the image (or a row past P) points at a zero row, so padding,
//   image edges and ragged rows cost nothing. Per tap: 4 wgmma m64nBNk16 from
//   the shared weight tile, one commit, and a wait for them before the next
//   tap's fragments load: ptxas serialises every wgmma whose A registers are
//   written while products are in flight (C7513), so the drain is explicit
//   and the blocks and warpgroups resident on an SM hide it from each other.
// * the epilogue parks each warpgroup's f32 sums in the slab memory and adds
//   bias (and the residual) eight channels a thread, with 16-byte loads and
//   stores along the output rows.
//
// What bounds it: operations (2 x 9 x C x C a position; at C = 64 to 512, 64
// to 512 times more than the bytes a position moves). What holds it back is
// latency: each warpgroup waits for its products every tap.
//
// ---- conv1x1_wgmma<MT, RELU>: a 1x1 convolution over up to 7 sources
//
//     out[p, n] = act(sum over sources s and k of x_s[p, k] w[s, n, k] + bias[n]
//                     (+ resid[p, n]) (+ carry[b, y / 2, x / 2, n]))
// each source x_s (P, C_s) channels-last bf16 with its own channel count, in
// the order of the concatenation it stands for (which is never written out);
// resid (P, Cout) is K5's root residual, carry (B, H/2, W/2, Cout) K8's
// top-down map, repeated 2x by the index.
//
// The GEMM: M and the block as above; N a slice of 64 output channels (a
// wider slice lost at every launch of K5 and K8); K walks the sources in
// 64-channel chunks. Per chunk the producer brings the tile's 64 MT x 64
// activation tile with one tensor copy of the source's own map (passed as a
// __grid_constant__ parameter; zeros past P and past C_s) and the 64 x 64
// weight tile with one bulk copy, into
// a ring of up to four stages. The weights are packed once as pack_conv3x3 packs
// them, with one tap and each source's chunks in turn
// (threedod_torch/ops/fused_conv.py::pack_conv1x1). Both operands are read
// by wgmma from shared memory (no A registers, so nothing serialises): 4
// m64n64k16 a chunk, one commit, and a wait for the chunk before, so one
// chunk's products run while the next is issued. The epilogue is the 3x3's.
//
// What bounds it: bytes at K5's and K8's shapes but the last root (C = 512,
// K = 1280), where the operations catch up (2 K Cout operations a position
// against 2 (K + Cout) bytes). A Cout that is not a multiple of 8 (K7's 15
// predictors) is stored one value at a time, without residual or carry.
//
// ---- conv3x3s2_wgmma<BN, MT>: the stride-2 3x3 of K6
//
//     t[r, xo, n] = relu(sum over taps (dy, dx) and k of
//                        x[b, 2 yo + dy - 1, 2 xo + dx - 1, k] w[tap, n, k] + bias[n])
// x (B, 2 Ho, 2 Wo, Cin) channels-last bf16, t (B Ho Wo, C) with r = b Ho + yo
// running over the B Ho output rows; Cin and C multiples of 16, not equal in
// general. Zero padding at row and column -1 (rows and columns 2 Ho and 2 Wo
// are never read).
//
// An output tile is a box of 8 MT output rows (of the B Ho, so a box may
// span two images) by 8 columns: 64 MT positions, 64 a warpgroup. Its input
// positions are no run of flattened rows, as the stride-1 3x3's are: output
// (r, xo) reads input rows 2 r - 1 .. 2 r + 1. Seen as four parity planes,
// plane (py, px)[r, xo] = x[b, 2 yo + py, 2 xo + px], the nine taps read
// plane (dy != 1, dx != 1) at (r - (dy == 0), xo - (dx == 0)): each k-chunk
// of the tile is the four planes' boxes of (8 MT + 1) x 9 positions from
// (r0 - 1, xo0 - 1), each brought by one tensor copy of a 5-D tensor map over
// x viewed as (B Ho, 2, Wo, 2, Cin), the box taking one row parity and one
// column parity. The map's zeros outside the tensor are the padding at
// column -1 and at the first image's row -1; at row -1 of a later image the
// box holds the image above's last row, so there the lane's tap mask points
// at the zero row, as a tap outside the image does in the 3x3. The taps are
// then row offsets into the four planes, read with ldmatrix by row address;
// the weight tiles come as the 3x3's do (pack_conv3x3, Cout != Cin). A Cin
// of 32 fills half a k-chunk: the map's zeros past Cin and the packed
// weights' zeros make the other half's products zero (work done for
// nothing, at DLA34's first head only).
//
// The blocks of the first output-channel slice also write the residual's
// source for K6's next launches, pooled (B Ho Wo, Cin): the 2x2 maximum of
// the four planes at the tile's own positions (the taps (1 1), (1 2), (2 1),
// (2 2)), or the (even, even) plane alone for x[::2, ::2], read from the
// slab that the taps read, 16 bytes a thread.
//
// What bounds it: operations (2 x 9 x Cin x C a position); as the 3x3, the
// latency of each tap's products.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cw {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;              // input channels a k-chunk: one 128-byte swizzled row
constexpr int TAPS = 9;
constexpr int WG = 128;             // threads of a warpgroup; a block has 1 or 2 that multiply and a warp that copies
constexpr int COUT_ALIGN = 128;     // packed output channels: a multiple of the widest slice
constexpr int MAX_BOX = 256;        // rows one tensor copy may bring
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may ask for
constexpr int MAX_SOURCES = 7;      // the 1x1's sources: K5's root reads x2, x1, up to 4 children and x
constexpr int STAGES_1X1 = 4;       // the 1x1's ring of (activation, weight) tile stages, at most
constexpr int N1X1 = 64;            // the 1x1's output-channel slice

struct ConvParams {
  const bf16* w;      // (nk, 9, coutp, 64), rows swizzled
  const float* bias;  // (C)
  const bf16* resid;  // (P, C) or null
  bf16* out;          // (P, C)
  int P, H, W, C;
  int coutp, nk;      // packed output channels, k-chunks
  int S;              // slab rows from one tap row (dy) to the next: W in a run, the band stride in bands
  int bands;          // 1: one run; 3: a band a tap row
  int slab_rows;      // rows a slab stage holds, a multiple of 8
  int box_rows;       // rows one tensor copy brings: the whole run, or one band of bm + 2
  int na, nb;         // slab stages (1 or 2), weight stages
  int nslices;        // output-channel slices
};

// Slab geometry for bm positions of a map W wide: one run covers positions
// [p0 - W - 1, p0 + bm + W + 1); where that is longer than three bands of bm
// + 2 (one a tap row, each on a 1024-byte boundary) or than one copy may
// bring, three bands.
struct Slab {
  int S, bands, rows, box_rows;
};

__host__ __device__ inline Slab slab_shape(int W, int bm) {
  const int run = bm + 2 * W + 2, band = (bm + 2 + 7) / 8 * 8;
  if (run <= 3 * band && run <= MAX_BOX) return {W, 1, (run + 7) / 8 * 8, run};
  return {band, 3, 3 * band, bm + 2};
}

// the slab stages also hold the epilogue's f32 sums, [mt][64][bn + 8]
__host__ __device__ inline size_t slab_bytes(int bn, int mt, int na, int slab_rows) {
  const size_t slabs = (size_t)na * slab_rows * KC * 2, sums = (size_t)mt * 64 * (bn + 8) * 4;
  return slabs > sums ? slabs : sums;
}

__host__ __device__ inline size_t smem_bytes(int bn, int mt, int nb, int na, int slab_rows) {
  return 1024 + (size_t)nb * bn * KC * 2 + slab_bytes(bn, mt, na, slab_rows) + KC * 2 + 8 * (4 + 2 * nb);
}

// ---------------- PTX wrappers ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait that never ends
// (2^26 polls, seconds, where a block lives for a millisecond) traps, so a
// fault shows as a launch error and not as a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  int spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++spins == (1 << 26)) __trap();
  } while (!done);
}

// `bytes` (a multiple of 16) global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// the box of a 2D tensor map at (c0 innermost, c1) -> shared memory, completion
// counted on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tensor_copy_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// the box of a 5D tensor map at (c0 innermost, .., c4) -> shared memory,
// completion counted on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tensor_copy_5d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                               int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, "
      "%6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

// barrier ID (1 to 15) among `threads` threads of the block, whole warps
template <int ID>
__device__ __forceinline__ void named_barrier_sync(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle, 8-row
// groups 1024 bytes apart, 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x BN, f32) += a (64 x 16 bf16, registers) b (16 x BN, bf16 K-major in shared memory); the
// scale-d predicate is set from a register (always 1: d is zeroed before the first product)
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 8][4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16 bf16, K-major in shared memory) b (16 x 64, bf16 K-major in shared
// memory); both descriptors from sw128_desc
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------- the kernels -------------------------------------------------

template <int BN, int MT, bool RESID, bool RELU = true>
__global__ void __launch_bounds__(MT * WG + 32, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap, const ConvParams p) {
  constexpr int BM = 64 * MT, CONSUMERS = MT * WG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  bf16* wring = reinterpret_cast<bf16*>(smem_raw + pad);  // [nb][BN][64], 1024-byte aligned stages
  bf16* slab = wring + (size_t)p.nb * BN * KC;            // [na][slab_rows][64], swizzled rows
  bf16* zrow = slab + slab_bytes(BN, MT, p.na, p.slab_rows) / 2;  // [64] zeros
  uint64_t* full_a = reinterpret_cast<uint64_t*>(zrow + KC);
  uint64_t* empty_a = full_a + 2;
  uint64_t* full_b = full_a + 4;
  uint64_t* empty_b = full_b + p.nb;

  const int tile = blockIdx.x / p.nslices;
  const int n0 = (blockIdx.x - tile * p.nslices) * BN;
  const int p0 = tile * BM;

  if (threadIdx.x < 8) reinterpret_cast<uint4*>(zrow)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], CONSUMERS);
    }
    for (int i = 0; i < p.nb; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the slab and weight copies in flight
    if (threadIdx.x != CONSUMERS) return;
    const bf16* wsrc = p.w + (size_t)n0 * KC;
    int ib = 0;
    for (int kc = 0; kc < p.nk; ++kc) {
      const int sa = kc % p.na;
      mbar_wait(&empty_a[sa], ((kc / p.na) & 1) ^ 1);
      bf16* dst = slab + (size_t)sa * p.slab_rows * KC;
      mbar_expect_tx(&full_a[sa], p.bands * p.box_rows * KC * 2);
      for (int r = 0; r < p.bands; ++r) {
        const int s0 = p0 + (p.bands == 1 ? -p.W : (r - 1) * p.W) - 1;
        tensor_copy_2d(dst + (size_t)r * p.S * KC, &xmap, kc * KC, s0, &full_a[sa]);
      }
      for (int t = 0; t < TAPS; ++t, ++ib) {
        const int sb = ib % p.nb;
        mbar_wait(&empty_b[sb], ((ib / p.nb) & 1) ^ 1);
        mbar_expect_tx(&full_b[sb], BN * KC * 2);
        bulk_copy(wring + (size_t)sb * BN * KC, wsrc + (size_t)(kc * TAPS + t) * p.coutp * KC, BN * KC * 2,
                  &full_b[sb]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup m owns rows 64 m .. 64 m + 63 of the tile
  const int m = threadIdx.x / WG, warp = (threadIdx.x % WG) >> 5, lane = threadIdx.x & 31;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int r_ld = 64 * m + warp * 16 + 8 * (lmat & 1) + lrow;  // the tile row this lane names to ldmatrix
  const int kpiece = lmat >> 1;                                  // its 16-byte piece of a k16 step: 0 or 1
  int mask = 0;  // bit 3 dy + dx: that tap of the row lies inside the image
  {
    const int q = p0 + r_ld;
    if (q < p.P) {
      const int rem = q % (p.H * p.W);
      const int y = rem / p.W, x = rem - (rem / p.W) * p.W;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
        if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) mask |= 1 << t;
      }
    }
  }

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  const unsigned char* zero = reinterpret_cast<const unsigned char*>(zrow);
  int ib = 0;
  for (int kc = 0; kc < p.nk; ++kc) {
    const int sa = kc % p.na;
    mbar_wait(&full_a[sa], (kc / p.na) & 1);
    const unsigned char* sl = reinterpret_cast<const unsigned char*>(slab + (size_t)sa * p.slab_rows * KC);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      // A: the tap's rows, loaded while no product is in flight (the tensor
      // cores read A's registers asynchronously; ptxas would otherwise
      // serialise every product)
      uint32_t a[4][4];
      {
        const int q = r_ld + t % 3 + (t / 3) * p.S;  // slab row of this lane's position's tap
        const bool in = (mask >> t) & 1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int piece = 2 * kk + kpiece;  // 128-byte swizzle: piece c of row q sits at c ^ (q % 8)
          ldmatrix_x4(a[kk], in ? sl + q * 128 + ((piece ^ (q & 7)) << 4) : zero + (piece << 4));
        }
      }
      if (t == TAPS - 1) mbar_arrive(&empty_a[sa]);  // this chunk's slab is read
      const int sb = ib % p.nb;
      mbar_wait(&full_b[sb], (ib / p.nb) & 1);
      const bf16* bt = wring + (size_t)sb * BN * KC;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, a[kk], sw128_desc(bt + kk * 16));
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(&empty_b[sb]);
      ++ib;
    }
  }

  // epilogue, through shared memory: once every consumer is done with the
  // slabs, each warpgroup parks its f32 sums there ([64][BN + 8], so a
  // warp's float2 stores miss each other's banks), then its threads add
  // bias (and the residual) eight channels at a time, with 16-byte loads and
  // stores along each output row
  named_barrier_sync<1>(CONSUMERS);
  constexpr int SP = BN + 8;
  float* stage = reinterpret_cast<float*>(slab) + m * 64 * SP;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * h) * SP + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  if (m == 0) {
    named_barrier_sync<2>(WG);
  } else {
    named_barrier_sync<3>(WG);
  }
  for (int i = threadIdx.x % WG; i < 64 * BN / 8; i += WG) {
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    const int q = p0 + 64 * m + r, n = n0 + c8;
    if (q >= p.P || n >= p.C) continue;
    float v[8];
    const float4* sv = reinterpret_cast<const float4*>(stage + r * SP + c8);
    const float4* bv = reinterpret_cast<const float4*>(p.bias + n);
    const float4 s0 = sv[0], s1 = sv[1], b0 = bv[0], b1 = bv[1];
    v[0] = s0.x + b0.x, v[1] = s0.y + b0.y, v[2] = s0.z + b0.z, v[3] = s0.w + b0.w;
    v[4] = s1.x + b1.x, v[5] = s1.y + b1.y, v[6] = s1.z + b1.z, v[7] = s1.w + b1.w;
    if constexpr (RESID) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p.resid + (size_t)q * p.C + n);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] += __uint_as_float(w[e] << 16);
        v[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pr = RELU ? __floats2bfloat162_rn(fmaxf(v[2 * e], 0.0f), fmaxf(v[2 * e + 1], 0.0f))
                                     : __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      o[e] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    *reinterpret_cast<uint4*>(p.out + (size_t)q * p.C + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

struct SourceMaps {
  CUtensorMap map[MAX_SOURCES];  // one tensor map a source, (P, C_s): 64 channels by 64 MT rows a copy
};

struct Conv1x1Params {
  const bf16* w;       // (nk, coutp, 64), rows swizzled: each source's chunks in turn
  const float* bias;   // (Cout)
  const bf16* resid;   // (P, Cout) or null
  const bf16* carry;   // (B, H/2, W/2, Cout) or null
  bf16* out;           // (P, Cout)
  int P, H, W, Cout;
  int coutp, nk;       // packed output channels, k-chunks over all sources
  int nsrc;
  int chunks[MAX_SOURCES];  // k-chunks of each source
  int nslices;
  int ns;                   // ring stages: min(STAGES_1X1, nk), so a short K leaves room for more blocks
};

// the ring also holds the epilogue's f32 sums, [mt][64][N1X1 + 8]
__host__ __device__ inline size_t ring1x1_bytes(int mt, int ns) {
  const size_t ring = (size_t)ns * (64 * mt + N1X1) * KC * 2, sums = (size_t)mt * 64 * (N1X1 + 8) * 4;
  return ring > sums ? ring : sums;
}

__host__ __device__ inline size_t smem1x1_bytes(int mt, int ns) {
  return 1024 + ring1x1_bytes(mt, ns) + 16 * ns;
}

template <int MT, bool RELU>
__global__ void __launch_bounds__(MT * WG + 32, 1)
    conv1x1_wgmma(const __grid_constant__ SourceMaps maps, const __grid_constant__ Conv1x1Params p) {
  constexpr int BM = 64 * MT, BN = N1X1, CONSUMERS = MT * WG;
  constexpr int A_BYTES = BM * KC * 2, STAGE = A_BYTES + BN * KC * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* ring = smem_raw + pad;  // [ns][A (BM x 64) | B (BN x 64)], 1024-byte aligned, swizzled rows
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring1x1_bytes(MT, p.ns));
  uint64_t* empty = full + p.ns;

  const int tile = blockIdx.x / p.nslices;
  const int n0 = (blockIdx.x - tile * p.nslices) * BN;
  const int p0 = tile * BM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.ns; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread walks the sources' chunks in concat order
    // (both parameters are __grid_constant__: a runtime index reads them in
    // place, where it would copy a plain parameter to the stack)
    if (threadIdx.x != CONSUMERS) return;
    const bf16* wsrc = p.w + (size_t)n0 * KC;
    int i = 0, st = 0, round = 0;  // step, its stage, and how often the ring has turned
#pragma unroll
    for (int src = 0; src < MAX_SOURCES; ++src) {
      if (src >= p.nsrc) break;
      for (int kc = 0; kc < p.chunks[src]; ++kc, ++i) {
        mbar_wait(&empty[st], (round & 1) ^ 1);
        unsigned char* dst = ring + (size_t)st * STAGE;
        mbar_expect_tx(&full[st], STAGE);
        tensor_copy_2d(dst, &maps.map[src], kc * KC, p0, &full[st]);
        bulk_copy(dst + A_BYTES, wsrc + (size_t)i * p.coutp * KC, BN * KC * 2, &full[st]);
        if (++st == p.ns) st = 0, ++round;
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup m owns rows 64 m .. 64 m + 63 of the tile
  const int m = threadIdx.x / WG, warp = (threadIdx.x % WG) >> 5, lane = threadIdx.x & 31;
  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  for (int i = 0, st = 0, round = 0, before = 0; i < p.nk; ++i) {
    mbar_wait(&full[st], round & 1);
    const unsigned char* a = ring + (size_t)st * STAGE + m * 64 * KC * 2;
    const unsigned char* b = ring + (size_t)st * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before is multiplied: its stage goes back to the producer
    if (i > 0) mbar_arrive(&empty[before]);
    before = st;
    if (++st == p.ns) st = 0, ++round;
  }
  wgmma_wait<0>();

  // epilogue as the 3x3's: the f32 sums parked in the ring once every
  // consumer is done with it, then bias, the residual or the carry, eight
  // channels a thread with 16-byte loads and stores
  named_barrier_sync<1>(CONSUMERS);
  constexpr int SP = BN + 8;
  float* stage = reinterpret_cast<float*>(ring) + m * 64 * SP;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * h) * SP + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  if (m == 0) {
    named_barrier_sync<2>(WG);
  } else {
    named_barrier_sync<3>(WG);
  }
  const int hw = p.H * p.W, hh = p.H / 2, wh = p.W / 2;
  const bool whole = p.Cout % 8 == 0;  // else a ragged row (K7's 15 predictors): one value a store
  for (int i = threadIdx.x % WG; i < 64 * BN / 8; i += WG) {
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    const int q = p0 + 64 * m + r, n = n0 + c8;
    if (q >= p.P || n >= p.Cout) continue;
    float v[8];
    const float4* sv = reinterpret_cast<const float4*>(stage + r * SP + c8);
    const float4* bv = reinterpret_cast<const float4*>(p.bias + n);
    const float4 s0 = sv[0], s1 = sv[1], b0 = bv[0], b1 = bv[1];
    v[0] = s0.x + b0.x, v[1] = s0.y + b0.y, v[2] = s0.z + b0.z, v[3] = s0.w + b0.w;
    v[4] = s1.x + b1.x, v[5] = s1.y + b1.y, v[6] = s1.z + b1.z, v[7] = s1.w + b1.w;
    const bf16* add[2] = {nullptr, nullptr};
    if (p.resid != nullptr) add[0] = p.resid + (size_t)q * p.Cout + n;
    if (p.carry != nullptr) {
      const int b = q / hw, rem = q - b * hw, y = rem / p.W, x = rem - y * p.W;
      add[1] = p.carry + ((size_t)(b * hh + y / 2) * wh + x / 2) * p.Cout + n;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (add[k] == nullptr) continue;
      const uint4 raw = *reinterpret_cast<const uint4*>(add[k]);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] += __uint_as_float(w[e] << 16);
        v[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
      }
    }
    if (!whole) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (n + e < p.Cout) p.out[(size_t)q * p.Cout + n + e] = __float2bfloat16_rn(RELU ? fmaxf(v[e], 0.0f) : v[e]);
      }
      continue;
    }
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pr = RELU ? __floats2bfloat162_rn(fmaxf(v[2 * e], 0.0f), fmaxf(v[2 * e + 1], 0.0f))
                                     : __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      o[e] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    *reinterpret_cast<uint4*>(p.out + (size_t)q * p.Cout + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

struct S2Params {
  const bf16* w;      // (nk, 9, coutp, 64), rows swizzled (pack_conv3x3 of a (C, Cin, 3, 3) kernel)
  const float* bias;  // (C)
  bf16* out;          // t (R Wo, C)
  bf16* pooled;       // (R Wo, Cin): the residual's source, written by the first slice's blocks
  int pool;           // 1: the 2x2 maximum of the planes, 0: the (even, even) plane
  int R, Ho, Wo, Cin, C;  // R = B Ho output rows
  int coutp, nk;          // packed output channels, k-chunks of Cin
  int plane_rows;         // rows of one plane's box, (8 MT + 1) x 9 rounded up to 8 (a 1024-byte stage)
  int na, nb;             // slab stages (1 or 2), weight stages
  int nslices, col_tiles;
};

constexpr int S2_TW = 8;  // output columns of a stride-2 tile; its rows are 64 MT / 8

__host__ __device__ inline int s2_plane_rows(int mt) { return ((8 * mt + 1) * (S2_TW + 1) + 7) / 8 * 8; }

// the slab stages ([na][4 planes][plane_rows][64]) also hold the epilogue's f32 sums
__host__ __device__ inline size_t s2_slab_bytes(int bn, int mt, int na) {
  const size_t slabs = (size_t)na * 4 * s2_plane_rows(mt) * KC * 2, sums = (size_t)mt * 64 * (bn + 8) * 4;
  return slabs > sums ? slabs : sums;
}

__host__ __device__ inline size_t s2_smem_bytes(int bn, int mt, int nb, int na) {
  return 1024 + (size_t)nb * bn * KC * 2 + s2_slab_bytes(bn, mt, na) + KC * 2 + 8 * (4 + 2 * nb);
}

// eight bf16 maxima, NaN kept as max_pool2d keeps it
__device__ __forceinline__ uint4 max8(uint4 a, const uint4 b) {
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 m = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&pa[e]),
                                         *reinterpret_cast<const __nv_bfloat162*>(&pb[e]));
    pa[e] = *reinterpret_cast<const uint32_t*>(&m);
  }
  return a;
}

template <int BN, int MT>
__global__ void __launch_bounds__(MT * WG + 32, 1)
    conv3x3s2_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ S2Params p) {
  constexpr int BM = 64 * MT, TH = BM / S2_TW, CONSUMERS = MT * WG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  bf16* wring = reinterpret_cast<bf16*>(smem_raw + pad);  // [nb][BN][64], 1024-byte aligned stages
  bf16* slab = wring + (size_t)p.nb * BN * KC;            // [na][4][plane_rows][64], swizzled rows
  bf16* zrow = slab + s2_slab_bytes(BN, MT, p.na) / 2;    // [64] zeros
  uint64_t* full_a = reinterpret_cast<uint64_t*>(zrow + KC);
  uint64_t* empty_a = full_a + 2;
  uint64_t* full_b = full_a + 4;
  uint64_t* empty_b = full_b + p.nb;

  const int tile = blockIdx.x / p.nslices;
  const int n0 = (blockIdx.x - tile * p.nslices) * BN;
  const int r0 = (tile / p.col_tiles) * TH, xo0 = (tile % p.col_tiles) * S2_TW;
  const int stage_rows = 4 * p.plane_rows;

  if (threadIdx.x < 8) reinterpret_cast<uint4*>(zrow)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], CONSUMERS);
    }
    for (int i = 0; i < p.nb; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the plane and weight copies in flight
    if (threadIdx.x != CONSUMERS) return;
    const bf16* wsrc = p.w + (size_t)n0 * KC;
    int ib = 0;
    for (int kc = 0; kc < p.nk; ++kc) {
      const int sa = kc % p.na;
      mbar_wait(&empty_a[sa], ((kc / p.na) & 1) ^ 1);
      bf16* dst = slab + (size_t)sa * stage_rows * KC;
      mbar_expect_tx(&full_a[sa], 4 * (TH + 1) * (S2_TW + 1) * KC * 2);
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // plane (py, px) = (s / 2, s % 2), its box from (r0 - 1, xo0 - 1)
        tensor_copy_5d(dst + (size_t)s * p.plane_rows * KC, &xmap, kc * KC, s & 1, xo0 - 1, s >> 1, r0 - 1,
                       &full_a[sa]);
      }
      for (int t = 0; t < TAPS; ++t, ++ib) {
        const int sb = ib % p.nb;
        mbar_wait(&empty_b[sb], ((ib / p.nb) & 1) ^ 1);
        mbar_expect_tx(&full_b[sb], BN * KC * 2);
        bulk_copy(wring + (size_t)sb * BN * KC, wsrc + (size_t)(kc * TAPS + t) * p.coutp * KC, BN * KC * 2,
                  &full_b[sb]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup m owns rows 64 m .. 64 m + 63 of the tile,
  // tile row i at output (r0 + i / 8, xo0 + i % 8)
  const int m = threadIdx.x / WG, warp = (threadIdx.x % WG) >> 5, lane = threadIdx.x & 31;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int r_ld = 64 * m + warp * 16 + 8 * (lmat & 1) + lrow;  // the tile row this lane names to ldmatrix
  const int kpiece = lmat >> 1;                                  // its 16-byte piece of a k16 step: 0 or 1
  const int base = (r_ld / S2_TW + 1) * (S2_TW + 1) + r_ld % S2_TW + 1;  // box row of its own position
  int mask = 0;  // bit 3 dy + dx: that tap of the row lies inside the image
  {
    const int r = r0 + r_ld / S2_TW, xo = xo0 + r_ld % S2_TW;
    if (r < p.R && xo < p.Wo) {
      const int yo = r % p.Ho;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        if ((t / 3 != 0 || yo > 0) && (t % 3 != 0 || xo > 0)) mask |= 1 << t;
      }
    }
  }

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  const unsigned char* zero = reinterpret_cast<const unsigned char*>(zrow);
  int ib = 0;
  for (int kc = 0; kc < p.nk; ++kc) {
    const int sa = kc % p.na;
    mbar_wait(&full_a[sa], (kc / p.na) & 1);
    const unsigned char* sl = reinterpret_cast<const unsigned char*>(slab + (size_t)sa * stage_rows * KC);
    if (n0 == 0) {
      // the residual's source at the tile's own positions: box row i / 8 + 1, column i % 8 + 1 of each plane
      for (int i = threadIdx.x; i < BM * 8; i += CONSUMERS) {
        const int row = i >> 3, piece = i & 7, c = kc * KC + piece * 8;
        const int r = r0 + row / S2_TW, xo = xo0 + row % S2_TW;
        if (r >= p.R || xo >= p.Wo || c >= p.Cin) continue;
        const int q = (row / S2_TW + 1) * (S2_TW + 1) + row % S2_TW + 1;
        const int off = q * 128 + ((piece ^ (q & 7)) << 4);
        uint4 v = *reinterpret_cast<const uint4*>(sl + off);
        if (p.pool) {
#pragma unroll
          for (int s = 1; s < 4; ++s) v = max8(v, *reinterpret_cast<const uint4*>(sl + s * p.plane_rows * 128 + off));
        }
        *reinterpret_cast<uint4*>(p.pooled + ((size_t)r * p.Wo + xo) * p.Cin + c) = v;
      }
    }
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      uint32_t a[4][4];
      {
        const int dy = t / 3, dx = t % 3;
        const int plane = (dy != 1) * 2 + (dx != 1);
        const int q = base - (dy == 0) * (S2_TW + 1) - (dx == 0);  // the tap's row in its plane's box
        const unsigned char* row = sl + (size_t)plane * p.plane_rows * 128 + q * 128;
        const bool in = (mask >> t) & 1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int piece = 2 * kk + kpiece;  // 128-byte swizzle: piece c of row q sits at c ^ (q % 8)
          ldmatrix_x4(a[kk], in ? row + ((piece ^ (q & 7)) << 4) : zero + (piece << 4));
        }
      }
      if (t == TAPS - 1) mbar_arrive(&empty_a[sa]);  // this chunk's planes are read
      const int sb = ib % p.nb;
      mbar_wait(&full_b[sb], (ib / p.nb) & 1);
      const bf16* bt = wring + (size_t)sb * BN * KC;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, a[kk], sw128_desc(bt + kk * 16));
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(&empty_b[sb]);
      ++ib;
    }
  }

  // epilogue as the 3x3's, each tile row stored at its output position
  named_barrier_sync<1>(CONSUMERS);
  constexpr int SP = BN + 8;
  float* stage = reinterpret_cast<float*>(slab) + m * 64 * SP;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * h) * SP + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  if (m == 0) {
    named_barrier_sync<2>(WG);
  } else {
    named_barrier_sync<3>(WG);
  }
  for (int i = threadIdx.x % WG; i < 64 * BN / 8; i += WG) {
    const int rr = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    const int row = 64 * m + rr, n = n0 + c8;
    const int r = r0 + row / S2_TW, xo = xo0 + row % S2_TW;
    if (r >= p.R || xo >= p.Wo || n >= p.C) continue;
    const float4* sv = reinterpret_cast<const float4*>(stage + rr * SP + c8);
    const float4* bv = reinterpret_cast<const float4*>(p.bias + n);
    const float4 s0 = sv[0], s1 = sv[1], b0 = bv[0], b1 = bv[1];
    const float v[8] = {s0.x + b0.x, s0.y + b0.y, s0.z + b0.z, s0.w + b0.w,
                        s1.x + b1.x, s1.y + b1.y, s1.z + b1.z, s1.w + b1.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(fmaxf(v[2 * e], 0.0f), fmaxf(v[2 * e + 1], 0.0f));
      o[e] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    *reinterpret_cast<uint4*>(p.out + ((size_t)r * p.Wo + xo) * p.C + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  return fn;
}

// A (P, C) bf16 matrix as a 2D tensor map: 64 channels by `rows` positions a
// copy, 128-byte swizzle, zeros outside (rows before 0 or past P, channels
// past C). C * 2 bytes must be a multiple of 16 and x on a 16-byte boundary.
inline bool encode_rows(CUtensorMap* map, const bf16* x, int P, int C, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(x), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (B, 2 Ho, 2 Wo, Cin) bf16 as the 5D tensor (R = B Ho, 2, Wo, 2, Cin),
// innermost last: row parity and column parity apart, so one box of 64
// channels x 1 x 9 columns x 1 x (th + 1) rows is a parity plane's window.
// 128-byte swizzle, zeros outside (columns or rows before 0 or past the
// end, channels past Cin). Cin * 2 bytes must be a multiple of 16.
inline bool encode_planes(CUtensorMap* map, const bf16* x, int R, int Wo, int Cin, int th) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)Cin, 2, (cuuint64_t)Wo, 2, (cuuint64_t)R};
  const cuuint64_t c2 = (cuuint64_t)Cin * 2;
  const cuuint64_t strides[4] = {c2, 2 * c2, 2 * (cuuint64_t)Wo * c2, 4 * (cuuint64_t)Wo * c2};
  const cuuint32_t box[5] = {(cuuint32_t)KC, 1, (cuuint32_t)(S2_TW + 1), 1, (cuuint32_t)(th + 1)};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<bf16*>(x), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the stride-2 3x3 of x (B, 2 Ho, 2 Wo, Cin) into p.out on `s`:
// ceil(B Ho / 8 MT) x ceil(Wo / 8) tiles x ceil(C / BN) slices, the slices of
// one tile adjacent in launch order, so they meet its planes in L2.
template <int BN, int MT>
inline cudaError_t launch_conv3x3s2(const bf16* x, S2Params p, cudaStream_t s) {
  constexpr int TH = 8 * MT;
  p.nk = (p.Cin + KC - 1) / KC;
  p.coutp = (p.C + COUT_ALIGN - 1) / COUT_ALIGN * COUT_ALIGN;
  p.na = p.nk > 1 ? 2 : 1;
  p.nb = 4;
  p.nslices = (p.C + BN - 1) / BN;
  p.col_tiles = (p.Wo + S2_TW - 1) / S2_TW;
  p.plane_rows = s2_plane_rows(MT);
  const size_t bytes = s2_smem_bytes(BN, MT, p.nb, p.na);
  if (bytes > (size_t)SMEM_LIMIT || p.Cin % 16 || p.C % 16) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  if (!encode_planes(&xmap, x, p.R, p.Wo, p.Cin, TH)) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3s2_wgmma<BN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.R + TH - 1) / TH) * p.col_tiles * p.nslices;
  conv3x3s2_wgmma<BN, MT><<<(unsigned)blocks, MT * WG + 32, bytes, s>>>(xmap, p);
  return cudaGetLastError();
}

// the stride-2 3x3 at a block shape (bn 64 or 128, mt 1 or 2) chosen at run time
inline cudaError_t conv3x3s2(int bn, int mt, const bf16* x, const S2Params& p, cudaStream_t s) {
  if (bn == 64 && mt == 1) return launch_conv3x3s2<64, 1>(x, p, s);
  if (bn == 64 && mt == 2) return launch_conv3x3s2<64, 2>(x, p, s);
  if (bn == 128 && mt == 1) return launch_conv3x3s2<128, 1>(x, p, s);
  if (bn == 128 && mt == 2) return launch_conv3x3s2<128, 2>(x, p, s);
  return cudaErrorInvalidValue;
}

// Launch one convolution of x (P, C) into p.out on `s`: ceil(P / 64 MT) x
// ceil(C / BN) blocks, the BN slices of one position tile adjacent in launch
// order, so they meet its slab in L2. The slab comes through a tensor map of
// x as a (P, C) matrix: 64 channels by box_rows positions a copy, 128-byte
// swizzle, zeros outside (rows before 0 or past P, channels past C).
template <int BN, int MT, bool RESID, bool RELU = true>
inline cudaError_t launch_conv3x3(const bf16* x, ConvParams p, cudaStream_t s) {
  p.nk = (p.C + KC - 1) / KC;
  p.coutp = (p.C + COUT_ALIGN - 1) / COUT_ALIGN * COUT_ALIGN;
  p.na = p.nk > 1 ? 2 : 1;
  p.nslices = (p.C + BN - 1) / BN;
  const Slab sl = slab_shape(p.W, 64 * MT);
  p.S = sl.S;
  p.bands = sl.bands;
  p.slab_rows = sl.rows;
  p.box_rows = sl.box_rows;
  p.nb = 4;
  const size_t bytes = smem_bytes(BN, MT, p.nb, p.na, p.slab_rows);
  if (bytes > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  if (!encode_rows(&xmap, x, p.P, p.C, p.box_rows)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma<BN, MT, RESID, RELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.P + 64 * MT - 1) / (64 * MT)) * p.nslices;
  conv3x3_wgmma<BN, MT, RESID, RELU><<<(unsigned)blocks, MT * WG + 32, bytes, s>>>(xmap, p);
  return cudaGetLastError();
}

// Launch one 1x1 convolution over the sources src[0 .. nsrc) (P, c[s]) into
// p.out on `s`: ceil(P / 64 MT) x ceil(Cout / 64) blocks, the slices of one
// position tile adjacent in launch order, so they meet its tiles in L2.
template <int MT, bool RELU>
inline cudaError_t launch_conv1x1(const bf16* const* src, const int* c, int nsrc, Conv1x1Params p, cudaStream_t s) {
  // a ragged Cout is stored one value at a time: no 16-byte residual or carry loads beside it
  if (nsrc < 1 || nsrc > MAX_SOURCES || (p.Cout % 8 && (p.resid != nullptr || p.carry != nullptr))) {
    return cudaErrorInvalidValue;
  }
  p.coutp = (p.Cout + COUT_ALIGN - 1) / COUT_ALIGN * COUT_ALIGN;
  p.nslices = (p.Cout + N1X1 - 1) / N1X1;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  SourceMaps maps{};
  p.nsrc = nsrc;
  p.nk = 0;
  for (int i = 0; i < MAX_SOURCES; ++i) {
    p.chunks[i] = i < nsrc ? (c[i] + KC - 1) / KC : 0;
    p.nk += p.chunks[i];
    if (i < nsrc && !encode_rows(&maps.map[i], src[i], p.P, c[i], 64 * MT)) return cudaErrorInvalidValue;
  }
  p.ns = p.nk < STAGES_1X1 ? p.nk : STAGES_1X1;
  const size_t bytes = smem1x1_bytes(MT, p.ns);
  if (bytes > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(conv1x1_wgmma<MT, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.P + 64 * MT - 1) / (64 * MT)) * p.nslices;
  conv1x1_wgmma<MT, RELU><<<(unsigned)blocks, MT * WG + 32, bytes, s>>>(maps, p);
  return cudaGetLastError();
}

// the 1x1 with mt (1 or 2) warpgroups a block, chosen at run time
template <bool RELU>
inline cudaError_t conv1x1(int mt, const bf16* const* src, const int* c, int nsrc, const Conv1x1Params& p,
                           cudaStream_t s) {
  if (mt == 1) return launch_conv1x1<1, RELU>(src, c, nsrc, p, s);
  if (mt == 2) return launch_conv1x1<2, RELU>(src, c, nsrc, p, s);
  return cudaErrorInvalidValue;
}

// the 3x3 at a block shape (bn 64 or 128, mt 1 or 2) chosen at run time
template <bool RESID, bool RELU>
inline cudaError_t conv3x3(int bn, int mt, const bf16* x, const ConvParams& p, cudaStream_t s) {
  if (bn == 64 && mt == 1) return launch_conv3x3<64, 1, RESID, RELU>(x, p, s);
  if (bn == 64 && mt == 2) return launch_conv3x3<64, 2, RESID, RELU>(x, p, s);
  if (bn == 128 && mt == 1) return launch_conv3x3<128, 1, RESID, RELU>(x, p, s);
  if (bn == 128 && mt == 2) return launch_conv3x3<128, 2, RESID, RELU>(x, p, s);
  return cudaErrorInvalidValue;
}

// A stride-1 BasicBlock, relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x),
// as two launches: the first writes t to the scratch map tmp, which the
// second reads through L2. x, out and tmp (B H W, C). A template (T is bf16),
// so a source that runs no block compiles none of its kernels.
template <typename T>
inline cudaError_t basic_block(int bn, int mt, const T* x, const T* w1, const float* b1, const T* w2,
                               const float* b2, T* out, T* tmp, int B, int H, int W, int C, cudaStream_t s) {
  ConvParams p{};
  p.P = B * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.w = w1;
  p.bias = b1;
  p.out = tmp;
  cudaError_t err = conv3x3<false, true>(bn, mt, x, p, s);
  if (err != cudaSuccess) return err;
  p.w = w2;
  p.bias = b2;
  p.resid = x;
  p.out = out;
  return conv3x3<true, true>(bn, mt, tmp, p, s);
}

}  // namespace cw
