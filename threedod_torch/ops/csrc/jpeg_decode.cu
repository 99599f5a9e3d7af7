// The card's JPEG decoder, bit-equal to libjpeg(-turbo) with its defaults.
//
// Replaces no TPU kernel: the JAX package decodes JPEGs on the host with
// libjpeg (native/loaderc.cpp:50-77, default settings: islow IDCT, fancy
// upsampling) or Pillow. nvJPEG's IDCT gives other luma samples than
// libjpeg's (one level off at 12529 of the fixture's 27 million, in every one
// of its 88 images, read from its planar output on an H100), so the port
// decodes the files itself and links no decoder library:
//   * host: markers and entropy-coded data -> quantized coefficients,
//     Huffman or arithmetic, sequential or progressive, or a lossless file's
//     samples, which skip the IDCT (jpeg_entropy.cuh; threedod_jpeg_header,
//     threedod_jpeg_coefficients, threedod_jpeg_samples);
//   * idct_kernel: dequantization and libjpeg's islow IDCT into each
//     component's plane, with the arithmetic of libjpeg-turbo's SIMD code
//     (simd/x86_64/jidctint-avx2.asm), which Pillow and the JAX package's
//     native reader run: 16-bit products and sums where it has 16-bit lanes
//     (they wrap), int16 saturation after each pass, the all-zero-AC block
//     shortcut's 16-bit shift, an output saturated to 0..255 (ops/jpeg.py
//     idct_islow_reference). It equals jidctint.c's C code wherever no lane
//     overflows, which holds for natural images; far out of range C wraps
//     (its x & 1023 range limit) where the SIMD code saturates. A
//     block of 64 threads takes 8 DCT blocks, a thread a column in the first
//     pass and a row in the second, the 8x8 workspace in shared memory, 32-bit
//     sums. Its SMOOTH instance
//     launches only for a progressive file that leaves bits of the first 9
//     AC coefficients unknown, and first smooths a copy of each of a
//     component's own blocks as libjpeg-turbo's jdcoefct.c
//     decompress_smooth_data does (ops/jpeg.py smooth_reference): the 8
//     threads of a DCT block load its 64 coefficients and the 25 stored DCs
//     of the 5x5 window around it (SmoothTable's extents, v and last iMCU row
//     give the window's edge rules) into shared memory, then each computes up
//     to two of the 10 estimates (Q00 times a weighted sum of the DCs, a
//     64-bit division by Qk << 8, the clamp to (1 << Al) - 1) into the copy,
//     which the first pass reads;
//   * color_kernel: every component upsampled to the image's size and the
//     colour space converted to Pillow's RGB in one pass, one thread an output
//     pixel. Each of up to 4 components is expanded by (hexp, vexp), the
//     largest sampling factors over its own, by the method jdsample.c's
//     jinit_upsampler picks (the wrapper passes it):
//       fullsize, the plane as it is;
//       h2v1 fancy, (3 C[j] + C[j - 1] + 1) >> 2 for an even output column and
//       (3 C[j] + C[j + 1] + 2) >> 2 for an odd one;
//       h1v2 fancy, (3 C[i] + C[i - 1] + 1) >> 2 for an even output row and
//       (3 C[i] + C[i + 1] + 2) >> 2 for an odd one;
//       h2v2 fancy, the column sums s = 3 C[i] + C[i -+ 1] of the nearer and
//       the next-nearer row, then (3 s[j] + s[j - 1] + 8) >> 4 and
//       (3 s[j] + s[j + 1] + 7) >> 4;
//       replication (int_upsample, and h2v1 / h2v2 of planes 2 columns wide
//       or less), C[y / vexp][x / hexp];
//     rows and columns past a plane's edges repeat the edge. Then the colour
//     space: YCbCr by the tables of build_ycc_rgb_table (SCALEBITS 16,
//     ONE_HALF, FIX(x) = (int)(x 2^16 + 0.5)), the G term summed before its
//     arithmetic shift, range_limit's clamp to 0..255; RGB as it is (jdcolor.c
//     rgb_rgb_convert); grayscale to three equal channels; CMYK as Pillow
//     reads it, every sample inverted (its CMYK;I unpacking) and then its
//     cmyk2rgb, nk - MULDIV255(c, nk) with nk = 255 - k; YCCK first through
//     jdcolor.c ycck_cmyk_convert (255 minus the YCbCr -> RGB value, K as it
//     is), so after the inversion the RGB value itself meets cmyk2rgb.
// Both kernels move few bytes (at 640x480 4:2:0 about 0.9 MB of coefficients
// in, 0.46 MB of planes, 0.92 MB of RGB out; a CMYK image 1.23 MB of planes):
// they are bound by bytes, a microsecond or less of HBM time, so at these
// sizes the launches and the host's Huffman decoding take the time. The
// colour kernel reads each plane through L1 (up to 4 neighbours of a sample,
// shared by the neighbouring threads), integer work of a few dozen
// operations a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jpeg_entropy.cuh"

namespace {

// jidctint.c, CONST_BITS 13
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433, F0_765366865 = 6270,
                    F0_899976223 = 7373, F1_175875602 = 9633, F1_501321110 = 12299, F1_847759065 = 15137,
                    F1_961570560 = 16069, F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

// jdcolor.c, SCALEBITS 16
constexpr int SCALEBITS = 16;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);
constexpr int FIX_1_40200 = 91881;   // (int)(1.40200 * 65536 + 0.5)
constexpr int FIX_1_77200 = 116130;  // (int)(1.77200 * 65536 + 0.5)
constexpr int FIX_0_71414 = 46802;   // (int)(0.71414 * 65536 + 0.5)
constexpr int FIX_0_34414 = 22554;   // (int)(0.34414 * 65536 + 0.5)

constexpr int BLOCKS_A_CTA = 8;

struct ComponentTable {
  long long first_block[jpeg::MAX_COMPONENTS + 1];  // cumulative block counts
  int blocks_w[jpeg::MAX_COMPONENTS];
  int pitch[jpeg::MAX_COMPONENTS];
  uint8_t* plane[jpeg::MAX_COMPONENTS];
  int components;
};

// Block smoothing's view of each component (the SMOOTH instance only).
struct SmoothTable {
  int rows[jpeg::MAX_COMPONENTS];      // the component's own blocks: ceil(height / 8)
  int cols[jpeg::MAX_COMPONENTS];      // and ceil(width / 8)
  int blocks_h[jpeg::MAX_COMPONENTS];  // the stored grid's rows, padding included
  int v[jpeg::MAX_COMPONENTS];         // vertical sampling factor: block rows an iMCU row
  int last_imcu[jpeg::MAX_COMPONENTS];
  int dc_only[jpeg::MAX_COMPONENTS];   // coef_bits 1 to 9 all -1: no AC scan reached it
  int coef_bits[jpeg::MAX_COMPONENTS][jpeg::SAVED_COEFS];
  // the iMCU rows past last_good (those the last scan reached out of data)
  // are smoothed by the coef_bits before the component's last scan
  int last_good[jpeg::MAX_COMPONENTS];
  int prev_dc_only[jpeg::MAX_COMPONENTS];
  int prev_bits[jpeg::MAX_COMPONENTS][jpeg::SAVED_COEFS];
};

// jdcoefct.c's weights of the window's stored DCs (DC01 to DC25, rows r - 2 to
// r + 2, columns c - 2 to c + 2) in the estimate of each zig-zag place 0 to 9:
// [0] where AC scans reached the component (places 1 to 5), [1] where none did
// (every place, the DC replaced). ops/jpeg.py SMOOTH_AC, SMOOTH_DC_ONLY.
__constant__ short SMOOTH_WEIGHTS[2][jpeg::SAVED_COEFS][25] = {
    {{0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0}, {0}, {0}, {0}},
    {{-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2},
     {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}}};
// zig-zag places 0 to 9 in natural order
__constant__ int SMOOTH_NATURAL[jpeg::SAVED_COEFS] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// Row i (0 to 4: r - 2 to r + 2) of the window around a component's own block
// row r, as decompress_smooth_data reads it: r - 2 to r + 1 clamped to the
// component's own rows; r + 2 where it lies in the stored grid (padding rows
// included) while r's iMCU row is not the last, and in the own rows where it
// is; else r + 1, clamped.
__device__ __forceinline__ int window_row(const SmoothTable& s, int c, int r, int i) {
  const int below = r + 1 < s.rows[c] ? r + 1 : s.rows[c] - 1;
  if (i < 2) return r - 2 + i < 0 ? 0 : r - 2 + i;
  if (i == 2) return r;
  if (i == 3) return below;
  const int limit = r / s.v[c] < s.last_imcu[c] ? s.blocks_h[c] : s.rows[c];
  return r + 2 < limit ? r + 2 : below;
}

// x as a 16-bit SIMD lane holds it (paddw, psubw, pmullw, psllw): wrapped
__device__ __forceinline__ int wrap16(int x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }

// packssdw: x saturated to int16
__device__ __forceinline__ int sat16(int x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); }

// One pass of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm) on the
// int16 values in[0..7], before the pass's descale, into out[0..7]: the
// products in pairs (pmaddwd, exact in 32 bits), the sums in0 + in4, in0 -
// in4, z3 = in7 + in3 and z4 = in5 + in1 in 16-bit lanes, which wrap. No
// 32-bit sum can overflow for int16 inputs (the largest, out[2], stays
// under 2^31 - 2^17). ops/jpeg.py _idct_1d.
__device__ __forceinline__ void idct_1d(const int* in, int* out) {
  const int tmp0 = wrap16(in[0] + in[4]) * (1 << CONST_BITS);
  const int tmp1 = wrap16(in[0] - in[4]) * (1 << CONST_BITS);
  const int tmp3 = in[2] * (F0_541196100 + F0_765366865) + in[6] * F0_541196100;
  const int tmp2 = in[2] * F0_541196100 + in[6] * (F0_541196100 - F1_847759065);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  const int z3p = z3 * (F1_175875602 - F1_961570560) + z4 * F1_175875602;
  const int z4p = z3 * F1_175875602 + z4 * (F1_175875602 - F0_390180644);
  const int t0 = in[7] * (F0_298631336 - F0_899976223) - in[1] * F0_899976223 + z3p;
  const int t1 = in[5] * (F2_053119869 - F2_562915447) - in[3] * F2_562915447 + z4p;
  const int t2 = in[3] * (F3_072711026 - F2_562915447) - in[5] * F2_562915447 + z3p;
  const int t3 = in[1] * (F1_501321110 - F0_899976223) - in[7] * F0_899976223 + z4p;
  out[0] = tmp10 + t3;
  out[7] = tmp10 - t3;
  out[1] = tmp11 + t2;
  out[6] = tmp11 - t2;
  out[2] = tmp12 + t1;
  out[5] = tmp12 - t1;
  out[3] = tmp13 + t0;
  out[4] = tmp13 - t0;
}

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// the output stage: packssdw, packsswb (x saturated to -128..127), + 128
__device__ __forceinline__ uint8_t output_sample(int x) {
  return static_cast<uint8_t>((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
}

template <bool SMOOTH>
__global__ void __launch_bounds__(64) idct_kernel(const int16_t* __restrict__ coef, const int* __restrict__ quant,
                                                  ComponentTable t, SmoothTable s, long long total_blocks) {
  __shared__ int ws[BLOCKS_A_CTA][64];
  __shared__ int16_t smoothed[SMOOTH ? BLOCKS_A_CTA : 1][64];
  __shared__ int window[SMOOTH ? BLOCKS_A_CTA : 1][25];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const long long block = static_cast<long long>(blockIdx.x) * BLOCKS_A_CTA + local;
  const bool live = block < total_blocks;
  int c = 0;
  if (live) {
    while (c + 1 < t.components && block >= t.first_block[c + 1]) ++c;
  }
  const int16_t* in = coef + block * 64;
  if constexpr (SMOOTH) {
    // the block's copy and its window's stored DCs; padding blocks (outside
    // the component's own rows and columns) are left as they are
    const long long b = block - t.first_block[c];
    const int by = static_cast<int>(b / t.blocks_w[c]), bx = static_cast<int>(b % t.blocks_w[c]);
    const bool own = live && by < s.rows[c] && bx < s.cols[c];
    if (live) {
#pragma unroll
      for (int k = 0; k < 8; ++k) smoothed[local][k * 8 + lane] = in[k * 8 + lane];
    }
    if (own) {
      for (int j = lane; j < 25; j += 8) {
        const int x = bx - 2 + j % 5;
        const int col = x < 0 ? 0 : (x >= s.cols[c] ? s.cols[c] - 1 : x);
        const long long at =
            t.first_block[c] + static_cast<long long>(window_row(s, c, by, j / 5)) * t.blocks_w[c] + col;
        window[local][j] = coef[at * 64];
      }
    }
    __syncthreads();
    if (own) {
      const bool stale = by / s.v[c] > s.last_good[c];
      const bool dc_only = (stale ? s.prev_dc_only[c] : s.dc_only[c]) != 0;
      const int* bits = stale ? s.prev_bits[c] : s.coef_bits[c];
      const long long q00 = quant[c * 64];
      for (int e = lane; e < jpeg::SAVED_COEFS; e += 8) {
        const int pos = SMOOTH_NATURAL[e], al = bits[e];
        // the DC is replaced where no AC scan reached the component; an AC
        // estimate (places 1 to 5, or all 9 there) replaces a stored 0 whose
        // bits are not all known
        const bool apply = e == 0 ? dc_only : (dc_only || e <= 5) && al != 0 && smoothed[local][pos] == 0;
        if (!apply) continue;
        const short* w = SMOOTH_WEIGHTS[dc_only][e];
        long long sum = 0;
#pragma unroll
        for (int j = 0; j < 25; ++j) sum += w[j] * window[local][j];
        const long long num = q00 * sum, qk = quant[c * 64 + pos];
        long long mag = ((qk << 7) + (num < 0 ? -num : num)) / (qk << 8);
        if (e != 0 && al > 0 && mag >= (1LL << al)) mag = (1LL << al) - 1;
        smoothed[local][pos] = static_cast<int16_t>(num < 0 ? -mag : mag);  // (JCOEF) pred
      }
    }
    __syncthreads();
  }
  // pass 1: column `lane`, dequantized in 16-bit lanes (pmullw). A block
  // whose coefficient rows 1 to 7 are all zero skips the butterfly (the
  // SIMD code's test, on the whole block): each column is its dequantized DC
  // shifted left by PASS1_BITS in a 16-bit lane (psllw), which wraps where
  // the butterfly's descale saturates (packssdw).
  const int16_t* src = in;
  if constexpr (SMOOTH) src = smoothed[local];
  bool ac = false;
  if (live) {
#pragma unroll
    for (int k = 1; k < 8; ++k) ac |= src[k * 8 + lane] != 0;
  }
  // the 8 columns of this DCT block are lanes 8 (local % 4) to 8 (local % 4) + 7 of the warp
  const bool dc_only = ((__ballot_sync(0xffffffffu, ac) >> (8 * (local & 3))) & 0xFFu) == 0;
  if (live) {
    const int* q = quant + c * 64;
    int col[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      col[k] = wrap16(
          static_cast<int>(static_cast<uint32_t>(src[k * 8 + lane]) * static_cast<uint32_t>(q[k * 8 + lane])));
    if (dc_only) {
      const int dc = wrap16(col[0] * (1 << PASS1_BITS));
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[local][k * 8 + lane] = dc;
    } else {
      idct_1d(col, out);
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[local][k * 8 + lane] = sat16(descale(out[k], CONST_BITS - PASS1_BITS));
    }
  }
  __syncthreads();
  // pass 2: row `lane` of the int16 workspace, saturated into the plane
  if (live) {
    int row[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = ws[local][lane * 8 + k];
    idct_1d(row, out);
    const long long b = block - t.first_block[c];
    const long long by = b / t.blocks_w[c], bx = b % t.blocks_w[c];
    uint8_t* dst = t.plane[c] + (by * 8 + lane) * t.pitch[c] + bx * 8;
    uint32_t lo = 0, hi = 0;  // the row's 8 samples, little-endian, one 8-byte store
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= static_cast<uint32_t>(output_sample(descale(out[k], CONST_BITS + PASS1_BITS + 3))) << (8 * k);
      hi |= static_cast<uint32_t>(output_sample(descale(out[k + 4], CONST_BITS + PASS1_BITS + 3))) << (8 * k);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

__device__ __forceinline__ int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

__device__ __forceinline__ uint8_t range_limit(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

enum Method { FULLSIZE = 0, H2V1 = 1, H1V2 = 2, H2V2 = 3, REPLICATE = 4 };  // jpeg.py METHODS

struct ColorPlanes {
  const uint8_t* plane[jpeg::MAX_COMPONENTS];
  int pitch[jpeg::MAX_COMPONENTS];
  int width[jpeg::MAX_COMPONENTS];
  int height[jpeg::MAX_COMPONENTS];
  int hexp[jpeg::MAX_COMPONENTS];
  int vexp[jpeg::MAX_COMPONENTS];
  int method[jpeg::MAX_COMPONENTS];
};

// Component k's value at output pixel (x, y), upsampled by its method.
__device__ __forceinline__ int upsampled(const ColorPlanes& p, int k, int x, int y) {
  const uint8_t* c = p.plane[k];
  const int pitch = p.pitch[k];
  switch (p.method[k]) {
    case FULLSIZE:
      return c[static_cast<size_t>(y) * pitch + x];
    case REPLICATE:
      return c[static_cast<size_t>(y / p.vexp[k]) * pitch + x / p.hexp[k]];
    case H1V2: {
      const int i = y >> 1;
      const int in = (y & 1) ? clamp_index(i + 1, p.height[k]) : clamp_index(i - 1, p.height[k]);
      const int s = 3 * c[static_cast<size_t>(i) * pitch + x] + c[static_cast<size_t>(in) * pitch + x];
      return (s + ((y & 1) ? 2 : 1)) >> 2;
    }
    default:
      break;
  }
  const int j = x >> 1;
  const int jn = (x & 1) ? clamp_index(j + 1, p.width[k]) : clamp_index(j - 1, p.width[k]);
  if (p.method[k] == H2V1) {
    const uint8_t* row = c + static_cast<size_t>(y) * pitch;
    return (x & 1) ? (3 * row[j] + row[jn] + 2) >> 2 : (3 * row[j] + row[jn] + 1) >> 2;
  }
  const int i = y >> 1;
  const int in = (y & 1) ? clamp_index(i + 1, p.height[k]) : clamp_index(i - 1, p.height[k]);
  const uint8_t* near = c + static_cast<size_t>(i) * pitch;
  const uint8_t* far = c + static_cast<size_t>(in) * pitch;
  const int s = 3 * near[j] + far[j];
  const int sn = 3 * near[jn] + far[jn];
  return (x & 1) ? (3 * s + sn + 7) >> 4 : (3 * s + sn + 8) >> 4;
}

// Pillow's cmyk2rgb of one inverted sample c against nk = 255 - inverted k:
// nk - MULDIV255(c, nk), which stays in 0..nk
__device__ __forceinline__ uint8_t cmyk_channel(int c, int nk) {
  const int t = c * nk + 128;
  return static_cast<uint8_t>(nk - (((t >> 8) + t) >> 8));
}

__global__ void color_kernel(ColorPlanes p, int space, uint8_t* __restrict__ out, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
  const int s0 = upsampled(p, 0, x, y);
  if (space == jpeg::GRAYSCALE) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(s0);
    return;
  }
  const int s1 = upsampled(p, 1, x, y), s2 = upsampled(p, 2, x, y);
  if (space == jpeg::RGB) {
    o[0] = static_cast<uint8_t>(s0);
    o[1] = static_cast<uint8_t>(s1);
    o[2] = static_cast<uint8_t>(s2);
    return;
  }
  int c0 = 255 - s0, c1 = 255 - s1, c2 = 255 - s2;  // CMYK: the inverted samples
  if (space != jpeg::CMYK) {  // YCbCr, YCCK: ycc_rgb_convert
    const int b = s1 - 128, r = s2 - 128;
    c0 = range_limit(s0 + ((FIX_1_40200 * r + ONE_HALF) >> SCALEBITS));
    c1 = range_limit(s0 + (((-FIX_0_34414) * b + ONE_HALF + (-FIX_0_71414) * r) >> SCALEBITS));
    c2 = range_limit(s0 + ((FIX_1_77200 * b + ONE_HALF) >> SCALEBITS));
    if (space == jpeg::YCBCR) {
      o[0] = static_cast<uint8_t>(c0);
      o[1] = static_cast<uint8_t>(c1);
      o[2] = static_cast<uint8_t>(c2);
      return;
    }
  }
  const int nk = upsampled(p, 3, x, y);  // 255 minus the inverted K: the sample itself
  o[0] = cmyk_channel(c0, nk);
  o[1] = cmyk_channel(c1, nk);
  o[2] = cmyk_channel(c2, nk);
}

}  // namespace

extern "C" {

// threedod_jpeg_header, threedod_jpeg_coefficients, threedod_jpeg_samples
// and threedod_jpeg_error are the host decoder's, defined in
// jpeg_entropy.cuh.

// table: per component (first block, blocks_w, blocks_h, plane pitch) as
// int64; planes: one device pointer per component, each (8 blocks_h) rows of
// `pitch` bytes. quant: int32 (components, 64) on the card. smooth: null
// (the plain instance), or per component (rows, cols, v, dc_only, coef_bits
// of zig-zag places 0 to 9, last good iMCU row, prev_dc_only, prev coef_bits)
// as int64 for the SMOOTH instance.
int threedod_jpeg_idct(const int16_t* coef, const int* quant, int components, const int64_t* table,
                       uint8_t* const* planes, const int64_t* smooth, cudaStream_t stream) {
  if (components < 1 || components > jpeg::MAX_COMPONENTS) return static_cast<int>(cudaErrorInvalidValue);
  ComponentTable t = {};
  SmoothTable s = {};
  t.components = components;
  long long total = 0;
  for (int k = 0; k < components; ++k) {
    t.first_block[k] = total;
    t.blocks_w[k] = static_cast<int>(table[4 * k + 1]);
    t.pitch[k] = static_cast<int>(table[4 * k + 3]);
    t.plane[k] = planes[k];
    if (table[4 * k] != total) return static_cast<int>(cudaErrorInvalidValue);
    total += table[4 * k + 1] * table[4 * k + 2];
    if (smooth != nullptr) {
      const int64_t* m = smooth + (6 + 2 * jpeg::SAVED_COEFS) * k;
      s.rows[k] = static_cast<int>(m[0]);
      s.cols[k] = static_cast<int>(m[1]);
      s.v[k] = static_cast<int>(m[2]);
      s.dc_only[k] = static_cast<int>(m[3]);
      s.blocks_h[k] = static_cast<int>(table[4 * k + 2]);
      if (s.v[k] < 1 || s.v[k] > jpeg::MAX_SAMP_FACTOR || s.blocks_h[k] % s.v[k] || s.rows[k] < 1 ||
          s.rows[k] > s.blocks_h[k] || s.cols[k] < 1 || s.cols[k] > t.blocks_w[k])
        return static_cast<int>(cudaErrorInvalidValue);
      s.last_imcu[k] = s.blocks_h[k] / s.v[k] - 1;
      s.last_good[k] = static_cast<int>(m[4 + jpeg::SAVED_COEFS]);
      s.prev_dc_only[k] = static_cast<int>(m[5 + jpeg::SAVED_COEFS]);
      if (s.last_good[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
      for (int e = 0; e < jpeg::SAVED_COEFS; ++e) {
        s.coef_bits[k][e] = static_cast<int>(m[4 + e]);
        s.prev_bits[k][e] = static_cast<int>(m[6 + jpeg::SAVED_COEFS + e]);
        if (s.coef_bits[k][e] < -1 || s.coef_bits[k][e] > 13 || s.prev_bits[k][e] < -1 || s.prev_bits[k][e] > 13)
          return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  t.first_block[components] = total;
  const long long grid = (total + BLOCKS_A_CTA - 1) / BLOCKS_A_CTA;
  if (smooth != nullptr)
    idct_kernel<true><<<static_cast<unsigned>(grid), 64, 0, stream>>>(coef, quant, t, s, total);
  else
    idct_kernel<false><<<static_cast<unsigned>(grid), 64, 0, stream>>>(coef, quant, t, s, total);
  return static_cast<int>(cudaGetLastError());
}

// table: per component (plane pitch, width, height, h_expand, v_expand,
// method) as int64, each plane `height` rows of `pitch` bytes on the card;
// space: the samples' colour space (jpeg::ColorSpace). out: (height, width, 3) uint8.
int threedod_jpeg_color(const int64_t* table, const uint8_t* const* planes, int components, int space, uint8_t* out,
                        int height, int width, cudaStream_t stream) {
  const int needed = space == jpeg::GRAYSCALE ? 1 : (space == jpeg::CMYK || space == jpeg::YCCK ? 4 : 3);
  if (space < jpeg::GRAYSCALE || space > jpeg::YCCK || components != needed || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ColorPlanes p = {};
  for (int k = 0; k < components; ++k) {
    const int64_t* t = table + 6 * k;
    p.plane[k] = planes[k];
    p.pitch[k] = static_cast<int>(t[0]);
    p.width[k] = static_cast<int>(t[1]);
    p.height[k] = static_cast<int>(t[2]);
    p.hexp[k] = static_cast<int>(t[3]);
    p.vexp[k] = static_cast<int>(t[4]);
    p.method[k] = static_cast<int>(t[5]);
    if (p.hexp[k] < 1 || p.hexp[k] > jpeg::MAX_SAMP_FACTOR || p.vexp[k] < 1 || p.vexp[k] > jpeg::MAX_SAMP_FACTOR ||
        p.method[k] < FULLSIZE || p.method[k] > REPLICATE || static_cast<int64_t>(p.width[k]) * p.hexp[k] < width ||
        static_cast<int64_t>(p.height[k]) * p.vexp[k] < height)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 128;
  dim3 grid((width + threads - 1) / threads, height);
  color_kernel<<<grid, threads, 0, stream>>>(p, space, out, height, width);
  return static_cast<int>(cudaGetLastError());
}

const char* threedod_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
