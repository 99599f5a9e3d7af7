// The card's JPEG decoder, bit-equal to libjpeg(-turbo) with its defaults.
//
// Replaces no TPU kernel: the JAX package decodes JPEGs on the host with
// libjpeg (native/loaderc.cpp:50-77, default settings: islow IDCT, fancy
// upsampling) or Pillow. nvJPEG's IDCT gives other luma samples than
// libjpeg's (one level off at 12529 of the fixture's 27 million, in every one
// of its 88 images, read from its planar output on an H100), so the port
// decodes the files itself and links no decoder library:
//   * host: markers and Huffman data -> quantized coefficients, sequential or
//     progressive (jpeg_entropy.cuh; threedod_jpeg_header,
//     threedod_jpeg_coefficients);
//   * idct_kernel: dequantization and jpeg_idct_islow (jidctint.c) into each
//     component's plane. A block of 64 threads takes 8 DCT blocks, a thread a
//     column in the first pass and a row in the second, the 8x8 workspace in
//     shared memory; 64-bit sums, as libjpeg's JLONG;
//   * ycc_rgb_kernel: jdsample.c's h2v2 / h2v1 fancy upsampling and jdcolor.c's
//     ycc_rgb_convert, one thread an output pixel:
//       4:2:0 the column sums 3 C[i] + C[i -+ 1] of the nearer and the
//       next-nearer chroma row, then (3 s[j] + s[j - 1] + 8) >> 4 for an even
//       output column and (3 s[j] + s[j + 1] + 7) >> 4 for an odd one; 4:2:2
//       (3 C[j] + C[j - 1] + 1) >> 2 and (3 C[j] + C[j + 1] + 2) >> 2; the
//       rows and columns past the plane's edges repeat the edge; 4:4:4 reads
//       C as it is; then the tables of build_ycc_rgb_table (SCALEBITS 16,
//       ONE_HALF, FIX(x) = (int)(x 2^16 + 0.5)), the G term summed before its
//       arithmetic shift, and range_limit's clamp to 0..255. A grayscale image
//       becomes three equal channels.
// Both kernels move few bytes (at 640x480 4:2:0 about 0.9 MB of coefficients
// in, 0.46 MB of planes, 0.92 MB of RGB out): they are bound by bytes, a
// microsecond or less of HBM time, so at these sizes the launches and the
// host's Huffman decoding take the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jpeg_entropy.cuh"

namespace {

// jidctint.c, CONST_BITS 13
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr long long F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433, F0_765366865 = 6270,
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

// One pass of jpeg_idct_islow on in[0..7], before the pass's descale, into
// out[0..7].
__device__ __forceinline__ void idct_1d(const long long* in, long long* out) {
  long long z2 = in[2], z3 = in[6];
  long long z1 = (z2 + z3) * F0_541196100;
  long long tmp2 = z1 + z3 * -F1_847759065;
  long long tmp3 = z1 + z2 * F0_765366865;
  long long tmp0 = (in[0] + in[4]) * (1LL << CONST_BITS);
  long long tmp1 = (in[0] - in[4]) * (1LL << CONST_BITS);
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  long long z4 = t1 + t3;
  long long z5 = (z3 + z4) * F1_175875602;
  t0 *= F0_298631336;
  t1 *= F2_053119869;
  t2 *= F3_072711026;
  t3 *= F1_501321110;
  z1 *= -F0_899976223;
  z2 *= -F2_562915447;
  z3 = z3 * -F1_961570560 + z5;
  z4 = z4 * -F0_390180644 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  out[0] = tmp10 + t3;
  out[7] = tmp10 - t3;
  out[1] = tmp11 + t2;
  out[6] = tmp11 - t2;
  out[2] = tmp12 + t1;
  out[5] = tmp12 - t1;
  out[3] = tmp13 + t0;
  out[4] = tmp13 - t0;
}

__device__ __forceinline__ long long descale(long long x, int n) { return (x + (1LL << (n - 1))) >> n; }

// prepare_range_limit_table's post-IDCT table, indexed with x & 1023
__device__ __forceinline__ uint8_t range_limit_idct(long long x) {
  int i = static_cast<int>(x & 1023);
  return static_cast<uint8_t>(i < 128 ? i + 128 : (i < 512 ? 255 : (i < 896 ? 0 : i - 896)));
}

__global__ void __launch_bounds__(64) idct_kernel(const int16_t* __restrict__ coef, const int* __restrict__ quant,
                                                  ComponentTable t, long long total_blocks) {
  __shared__ int ws[BLOCKS_A_CTA][64];
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const long long block = static_cast<long long>(blockIdx.x) * BLOCKS_A_CTA + local;
  const bool live = block < total_blocks;
  int c = 0;
  if (live) {
    while (c + 1 < t.components && block >= t.first_block[c + 1]) ++c;
  }
  // pass 1: column `lane`, dequantized
  if (live) {
    const int16_t* in = coef + block * 64;
    const int* q = quant + c * 64;
    long long col[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = static_cast<long long>(in[k * 8 + lane]) * q[k * 8 + lane];
    idct_1d(col, out);
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[local][k * 8 + lane] = static_cast<int>(descale(out[k], CONST_BITS - PASS1_BITS));
  }
  __syncthreads();
  // pass 2: row `lane`, range-limited into the plane
  if (live) {
    long long row[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = ws[local][lane * 8 + k];
    idct_1d(row, out);
    const long long b = block - t.first_block[c];
    const long long by = b / t.blocks_w[c], bx = b % t.blocks_w[c];
    uint8_t* dst = t.plane[c] + (by * 8 + lane) * t.pitch[c] + bx * 8;
    uint32_t lo = 0, hi = 0;  // the row's 8 samples, little-endian, one 8-byte store
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= static_cast<uint32_t>(range_limit_idct(descale(out[k], CONST_BITS + PASS1_BITS + 3))) << (8 * k);
      hi |= static_cast<uint32_t>(range_limit_idct(descale(out[k + 4], CONST_BITS + PASS1_BITS + 3))) << (8 * k);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

__device__ __forceinline__ int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

__device__ __forceinline__ uint8_t range_limit(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One chroma plane's value at output pixel (x, y), upsampled by libjpeg's
// fancy filter for factors (hf, vf) in {(1, 1), (2, 1), (2, 2)}.
__device__ __forceinline__ int upsampled(const uint8_t* c, int pitch, int cw, int ch, int hf, int vf, int x, int y) {
  if (hf == 1) return c[static_cast<size_t>(y) * pitch + x];
  const int j = x >> 1;
  const int jn = (x & 1) ? clamp_index(j + 1, cw) : clamp_index(j - 1, cw);
  if (vf == 1) {
    const uint8_t* row = c + static_cast<size_t>(y) * pitch;
    return (x & 1) ? (3 * row[j] + row[jn] + 2) >> 2 : (3 * row[j] + row[jn] + 1) >> 2;
  }
  const int i = y >> 1;
  const int in = (y & 1) ? clamp_index(i + 1, ch) : clamp_index(i - 1, ch);
  const uint8_t* near = c + static_cast<size_t>(i) * pitch;
  const uint8_t* far = c + static_cast<size_t>(in) * pitch;
  const int s = 3 * near[j] + far[j];
  const int sn = 3 * near[jn] + far[jn];
  return (x & 1) ? (3 * s + sn + 7) >> 4 : (3 * s + sn + 8) >> 4;
}

__global__ void ycc_rgb_kernel(const uint8_t* __restrict__ y_plane, int y_pitch, const uint8_t* __restrict__ cb,
                               const uint8_t* __restrict__ cr, int c_pitch, int cw, int ch, int hf, int vf,
                               uint8_t* __restrict__ out, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  const int luma = y_plane[static_cast<size_t>(y) * y_pitch + x];
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
  if (cb == nullptr) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(luma);
    return;
  }
  const int b = upsampled(cb, c_pitch, cw, ch, hf, vf, x, y) - 128;
  const int r = upsampled(cr, c_pitch, cw, ch, hf, vf, x, y) - 128;
  const int cr_r = (FIX_1_40200 * r + ONE_HALF) >> SCALEBITS;
  const int cb_b = (FIX_1_77200 * b + ONE_HALF) >> SCALEBITS;
  const int g = ((-FIX_0_34414) * b + ONE_HALF + (-FIX_0_71414) * r) >> SCALEBITS;
  o[0] = range_limit(luma + cr_r);
  o[1] = range_limit(luma + g);
  o[2] = range_limit(luma + cb_b);
}

}  // namespace

extern "C" {

// threedod_jpeg_header, threedod_jpeg_coefficients and threedod_jpeg_error
// are the host decoder's, defined in jpeg_entropy.cuh.

// table: per component (first block, blocks_w, blocks_h, plane pitch) as
// int64; planes: one device pointer per component, each (8 blocks_h) rows of
// `pitch` bytes. quant: int32 (components, 64) on the card.
int threedod_jpeg_idct(const int16_t* coef, const int* quant, int components, const int64_t* table,
                       uint8_t* const* planes, cudaStream_t stream) {
  if (components < 1 || components > jpeg::MAX_COMPONENTS) return static_cast<int>(cudaErrorInvalidValue);
  ComponentTable t = {};
  t.components = components;
  long long total = 0;
  for (int k = 0; k < components; ++k) {
    t.first_block[k] = total;
    t.blocks_w[k] = static_cast<int>(table[4 * k + 1]);
    t.pitch[k] = static_cast<int>(table[4 * k + 3]);
    t.plane[k] = planes[k];
    if (table[4 * k] != total) return static_cast<int>(cudaErrorInvalidValue);
    total += table[4 * k + 1] * table[4 * k + 2];
  }
  t.first_block[components] = total;
  const long long grid = (total + BLOCKS_A_CTA - 1) / BLOCKS_A_CTA;
  idct_kernel<<<static_cast<unsigned>(grid), 64, 0, stream>>>(coef, quant, t, total);
  return static_cast<int>(cudaGetLastError());
}

// cb and cr null: grayscale. (hf, vf): the luma plane's size over the chroma
// planes', (1, 1), (2, 1) or (2, 2); the wrapper refuses any other.
int threedod_jpeg_ycc_rgb(const uint8_t* y_plane, int y_pitch, const uint8_t* cb, const uint8_t* cr, int c_pitch,
                          int cw, int ch, int hf, int vf, uint8_t* out, int height, int width, cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((width + threads - 1) / threads, height);
  ycc_rgb_kernel<<<grid, threads, 0, stream>>>(y_plane, y_pitch, cb, cr, c_pitch, cw, ch, hf, vf, out, height,
                                               width);
  return static_cast<int>(cudaGetLastError());
}

const char* threedod_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
