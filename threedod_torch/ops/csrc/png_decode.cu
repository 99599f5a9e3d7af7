// The card's PNG decoder: the five row filters undone, the samples unpacked
// and turned into RGB as Pillow's convert("RGB") does, and each Adam7 pass's
// pixels scattered to their places, for every plane of an image in one
// launch.
//
// Replaces no TPU kernel: the JAX package reads PNG files on the host with
// Pillow (threedod/data/native_io.py:29-38). KITTI's image_2 is PNG, and the
// port decodes every image the card reads itself, so this kernel sits beside
// the JPEG decoder (jpeg_decode.cu). The host (ops/png.py) walks the chunks,
// checks the CRCs, inflates the IDAT data with zlib and lays the planes out
// for this kernel (png.layout).
//
// What bounds it: PNG's Sub, Average and Paeth filters predict a byte from
// the same byte of the pixel to its left (the byte to its left below 8 bits
// a sample), Up, Average and Paeth from the byte above, Paeth also from the
// one above-left, so neither a row nor a column is independent: a plane of W
// units and H rows is a chain of W + H - 1 dependent steps, whatever the
// bytes. The bytes of a pixel, though, never meet (the filters work byte by
// byte, modulo 256): each byte of the pixel is a chain of its own, and only
// the bytes the conversion reads are decoded at all (R, G and B of RGB and
// RGBA, their high bytes at 16 bits; the gray byte of gray + alpha, its high
// byte at 16 bits). The host hands the kernel each such byte as a plane of
// its own, a "channel", except 16-bit gray, whose clamp reads both bytes: its
// units are the two bytes. So a unit is 1 byte (2 for 16-bit gray).
//
// The design: a band of 32 rows of one channel is one warp (a CTA), lane t
// its row t, and at step s lane t undoes unit s - t. Its left unit it made
// itself at step s - 1 (registers), its upper unit lane t - 1 made at step
// s - 1 (__shfl_up_sync), its upper-left one it got from lane t - 1 at step
// s - 1 (registers). Lane 0 takes its upper units from the band above's last
// row, which that band's lane 31 stores to a carry row in global memory as it
// makes them, each unit in a 64-bit word whose high half is a tag (the carry
// rows are zeroed before the launch), so a word is its own flag: lane 0 loads
// a group's words half a group ahead (in the middle of the steps before it)
// with relaxed loads and reloads while a tag is missing. Bands take their order from a ticket (an atomic counter) as
// their CTAs start, so the band a band waits for has always started: no
// co-residency is assumed. Every band of every channel of every plane (the
// image, or Adam7's seven passes) is a CTA of the same launch; channels and
// planes do not wait for each other.
//
// Inputs: the host stores row r's unit x at byte (x + r % 32) * unit of the
// row, so in step group g (16 steps) every lane reads bytes [16 g unit,
// 16 (g + 1) unit) of its row, one or two 16-byte vectors at the same place
// on every lane, loaded a group ahead into registers; the group's 16 steps
// are unrolled, so each takes its bytes, and lane 0 its upper unit, at
// constant places in registers.
//
// Outputs: each lane writes its units to a ring of 64 units a row in shared
// memory (swizzled by the row's parity, so neither the steps' stores nor the
// stores' reads conflict); after group g the warp converts and stores the
// group made LAG groups earlier, whose units every lane has done, with lanes
// along a row, so that stores of neighbouring lanes are neighbouring pixels,
// reading 16 ring cells before it stores any (read one by one, each behind
// its store's branch, they took nearly as long as all the steps).
// Designs tried and dropped: a thread a row over whole pixels of 3 to 8
// bytes, a group's inputs staged in shared memory and read a step ahead, the
// next group's carry loaded a whole group ahead, the stores spread over the
// next group's steps.
// Pillow's conversions: a channel byte to its place in the pixel (R, G or B);
// gray to three equal channels (1-, 2- and 4-bit samples times 255, 85 and
// 17; 16-bit gray clamped at 255); a palette index looked up in a 256-entry
// table whose entries past the file's PLTE are black.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;          // a band: a warp, a row a lane
constexpr int GROUP = 16;         // steps (units) a group
constexpr int LAG = 2;            // groups until every lane has done a group: ceil(31 / GROUP)
constexpr int RING = 64;          // units of each row held in shared memory until they are stored
constexpr int MAX_PLANES = 7 * 3; // Adam7's passes, three channels each
constexpr int TABLE_FIELDS = 14;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long TAG = 1ull << 32;
constexpr int MAX_POLLS = 1 << 24;  // reloads of a carry group (seconds of L2 round trips) before the kernel traps

enum Mode { GRAY = 0, GRAY_SCALED = 1, GRAY16 = 2, PALETTE = 3, CHANNEL = 4 };

struct Plane {
  long long in_offset;     // the plane's first row in the input
  long long ftype_offset;  // its rows' filter types
  long long carry_offset;  // its first band's carry row, in 64-bit words
  long long carry_stride;  // words between two bands' carry rows
  int pitch;               // bytes between rows: whole groups
  int units;               // units a row: pixels, or bytes below 8 bits
  int height;
  int width;               // pixels a row
  int x0, y0, dx, dy;      // where its pixels go in the image
  int first_band;
  int channel;             // CHANNEL: the byte of the RGB pixel it fills
};

struct Planes {
  Plane p[MAX_PLANES];
  int count;
};

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

__device__ __forceinline__ void load_relaxed(const unsigned long long* p, unsigned long long& x,
                                             unsigned long long& y) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(x), "=l"(y) : "l"(p));
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// the carry words of units [GROUP g, GROUP (g + 1)) of the band above
__device__ __forceinline__ void load_group(const unsigned long long* above, int g, unsigned long long (&w)[GROUP]) {
  const unsigned long long* p = above + static_cast<long long>(g) * GROUP;
#pragma unroll
  for (int i = 0; i < GROUP; i += 2) load_relaxed(p + i, w[i], w[i + 1]);
}

__device__ __forceinline__ bool tagged(const unsigned long long (&w)[GROUP], int first_unit, int units) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < GROUP; ++i) ok &= first_unit + i >= units || (w[i] >> 32) != 0;
  return ok;
}

// UNIT: bytes of a unit (2 for 16-bit gray, else 1); MODE, DEPTH: the
// conversion and the bits of a sample, known at compile time, so that the
// stores' loop has no branch
template <int UNIT, int MODE, int DEPTH>
__global__ void __launch_bounds__(ROWS) png_decode_kernel(const uint8_t* __restrict__ in,
                                                          const __grid_constant__ Planes planes,
                                                          const uint8_t* __restrict__ palette,
                                                          unsigned long long* __restrict__ carry,
                                                          uint8_t* __restrict__ out, int out_width) {
  constexpr int VEC = GROUP * UNIT / 16;                                          // 16-byte input vectors a group
  constexpr int SPB_LOG2 = DEPTH == 1 ? 3 : DEPTH == 2 ? 2 : DEPTH == 4 ? 1 : 0;  // samples a unit, log2
  constexpr int PER_ROW_LOG2 = 4 + SPB_LOG2;                                      // pixels of a row in a group
  constexpr int SCALE = DEPTH < 8 ? 255 / ((1 << DEPTH) - 1) : 1;
  __shared__ uint32_t ring[ROWS][RING];
  __shared__ uint32_t pal[256];                // R | G << 8 | B << 16
  const int lane = threadIdx.x;

  int band = 0;
  if (lane == 0) band = atomicAdd(reinterpret_cast<int*>(carry), 1);
  band = __shfl_sync(FULL, band, 0);
  if (MODE == PALETTE)
    for (int i = lane; i < 256; i += ROWS)
      pal[i] = palette[3 * i] | palette[3 * i + 1] << 8 | palette[3 * i + 2] << 16;
  int k = 0;
  for (int j = 1; j < planes.count; ++j)
    if (band >= planes.p[j].first_band) k = j;
  const Plane& pl = planes.p[k];
  const int units = pl.units, height = pl.height, width = pl.width;
  const int b = band - pl.first_band;
  const int row0 = b * ROWS;
  const int rows = min(ROWS, height - row0);
  const bool has_prev = b > 0, has_next = row0 + ROWS < height;
  const int r = row0 + min(lane, rows - 1);  // a lane past the band's rows repeats its last row, unstored
  const uint4* src = reinterpret_cast<const uint4*>(in + pl.in_offset + static_cast<long long>(r) * pl.pitch);
  const int ftype = lane < rows ? in[pl.ftype_offset + r] : 0;
  // the row's filter type as masks: the predictor is selected without a branch
  const int m_sub = -(ftype == 1), m_up = -(ftype == 2), m_avg = -(ftype == 3), m_paeth = -(ftype == 4);
  const unsigned long long* above = carry + pl.carry_offset + (b - 1) * pl.carry_stride;
  unsigned long long* below = carry + pl.carry_offset + b * pl.carry_stride;
  const int groups = (units + ROWS - 1 + GROUP - 1) / GROUP;
  const int swz = (lane & 1) << 4;
  const long long out_row0 = static_cast<long long>(pl.y0) + static_cast<long long>(row0) * pl.dy;
  const int x0 = pl.x0, dx = pl.dx, dy = pl.dy, channel = pl.channel;
  __syncwarp();

  // converts and stores units [GROUP h, GROUP (h + 1)) of the band's rows:
  // lanes along a row, 32 pixels of the group at a time, in batches whose
  // shared-memory reads all go before their stores
  const long long out_base = (out_row0 * out_width + x0) * 3, row_stride = static_cast<long long>(dy) * out_width * 3;
  const int pix_stride = dx * 3;
  auto flush = [&](int h) {
    constexpr int ITEMS = 1 << PER_ROW_LOG2, BATCH = ITEMS < 16 ? ITEMS : 16;
#pragma unroll 1
    for (int it0 = 0; it0 < ITEMS; it0 += BATCH) {
      uint32_t w[BATCH];
#pragma unroll
      for (int e = 0; e < BATCH; ++e) {
        const int i = (it0 + e) * ROWS + lane;
        const int row = i >> PER_ROW_LOG2, unit = h * GROUP + ((i & (ITEMS - 1)) >> SPB_LOG2);
        w[e] = ring[row][(unit & (RING - 1)) ^ ((row & 1) << 4)];
      }
#pragma unroll
      for (int e = 0; e < BATCH; ++e) {
        const int i = (it0 + e) * ROWS + lane;
        const int row = i >> PER_ROW_LOG2, kk = i & (ITEMS - 1);
        const int unit = h * GROUP + (kk >> SPB_LOG2), pix = ((h * GROUP) << SPB_LOG2) + kk;
        int sample = w[e] & 255;
        if (SPB_LOG2) sample = (sample >> (8 - DEPTH * ((kk & ((1 << SPB_LOG2) - 1)) + 1))) & ((1 << DEPTH) - 1);
        uint32_t rgb;  // R | G << 8 | B << 16
        if (MODE == PALETTE) {
          rgb = pal[sample];
        } else {
          const int gray = MODE == GRAY16 ? min(((w[e] & 255) << 8) | ((w[e] >> 8) & 255), 255) : sample * SCALE;
          rgb = gray * 0x010101u;
        }
        uint8_t* o = out + out_base + row * row_stride + pix * pix_stride;
        if (row < rows && unit < units && pix < width) {
          if (MODE == CHANNEL) {
            o[channel] = static_cast<uint8_t>(w[e]);
          } else {
            o[0] = static_cast<uint8_t>(rgb);
            o[1] = static_cast<uint8_t>(rgb >> 8);
            o[2] = static_cast<uint8_t>(rgb >> 16);
          }
        }
      }
    }
  };

  int a[UNIT], c[UNIT];  // the left and upper-left units' bytes
  uint32_t v = 0;        // the last unit this lane made, little-endian
#pragma unroll
  for (int i = 0; i < UNIT; ++i) a[i] = c[i] = 0;
  uint4 cur[VEC], nxt[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) nxt[q] = __ldg(src + q);
  unsigned long long cc[GROUP], cn[GROUP];  // lane 0: the row above's units of this group and the next
#pragma unroll
  for (int i = 0; i < GROUP; ++i) cc[i] = cn[i] = 0;
  if (has_prev && lane == 0) load_group(above, 0, cn);

  for (int g = 0; g < groups; ++g) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) cur[q] = nxt[q];
    if (g + 1 < groups) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) nxt[q] = __ldg(src + (g + 1) * VEC + q);
    }
    if (has_prev && lane == 0) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) cc[i] = cn[i];
      for (int polls = 0; !tagged(cc, g * GROUP, units); ++polls) {
        if (polls == MAX_POLLS) __trap();  // a protocol fault is a launch error, not a hung card
        load_group(above, g, cc);
      }
    }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int q = j * UNIT;  // the unit's first byte in the group's input
      const uint4& u4 = cur[q >> 4];
      const int wi = (q >> 2) & 3;
      const uint32_t word = wi == 0 ? u4.x : wi == 1 ? u4.y : wi == 2 ? u4.z : u4.w;
      const uint32_t f = (word >> (8 * (q & 3))) & (UNIT == 2 ? 0xffffu : 0xffu);
      if (j == GROUP / 2 && has_prev && lane == 0 && g + 1 < groups) load_group(above, g + 1, cn);  // half a group ahead
      const int x = g * GROUP + j - lane;  // this lane's unit at this step
      uint32_t up = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) up = static_cast<uint32_t>(cc[j]);
      uint32_t nv = 0;
#pragma unroll
      for (int i = 0; i < UNIT; ++i) {
        const int bi = UNIT == 1 ? static_cast<int>(up) : (up >> (8 * i)) & 255;
        const int fi = UNIT == 1 ? static_cast<int>(f) : (f >> (8 * i)) & 255;
        const int p = (a[i] & m_sub) | (bi & m_up) | (((a[i] + bi) >> 1) & m_avg) | (paeth(a[i], bi, c[i]) & m_paeth);
        const int vi = (fi + p) & 255;
        nv |= static_cast<uint32_t>(vi) << (8 * i);
        a[i] = vi;
        c[i] = bi;
      }
      v = nv;
      ring[lane][(x & (RING - 1)) ^ swz] = nv;
      if (lane == ROWS - 1 && has_next && x >= 0 && x < units) store_relaxed(below + x, TAG | nv);
    }
    __syncwarp();
    if (g >= LAG) flush(g - LAG);
  }
  __syncwarp();
  for (int h = groups - LAG > 0 ? groups - LAG : 0; h < groups; ++h) flush(h);
}

template <int UNIT, int MODE, int DEPTH>
cudaError_t launch(const uint8_t* in, const Planes& planes, int bands, const uint8_t* palette,
                   unsigned long long* carry, uint8_t* out, int out_width, cudaStream_t stream) {
  png_decode_kernel<UNIT, MODE, DEPTH><<<bands, ROWS, 0, stream>>>(in, planes, palette, carry, out, out_width);
  return cudaGetLastError();
}

// One warp, `steps` steps of one filter's dependence chain, each on the
// last. HOP: a step down a column, the row above's unit by a shuffle from the
// lane above, the left unit the lane's own last result. Otherwise a step along
// a row: the left unit is the last step's result in a register, and the upper
// units come from a stream that does not depend on the chain. FILTER: 1 Sub,
// 2 Up, 3 Average, 4 Paeth (the predictor alone, without the other masks).
template <int FILTER, bool HOP>
__global__ void step_latency_kernel(int steps, int* sink) {
  int a = threadIdx.x & 255, b = (5 * threadIdx.x) & 255, c = (3 * threadIdx.x) & 255, v = (7 * threadIdx.x) & 255;
  for (int s = 0; s < steps; ++s) {
    const int up = HOP ? __shfl_up_sync(FULL, v, 1) : (b * 5 + 1) & 255;
    const int left = HOP ? a : v;
    const int p = FILTER == 1 ? left : FILTER == 2 ? up : FILTER == 3 ? (left + up) >> 1 : paeth(left, up, c);
    v = (s + p) & 255;
    asm volatile("" : "+r"(v));  // opaque: no folding of one step into the next
    a = v;
    b = up;
    c = up;
  }
  sink[threadIdx.x] = v;
}

}  // namespace

extern "C" {

// table: TABLE_FIELDS int64 a channel plane (png.TABLE_FIELDS' order);
// carry: carry_words 64-bit words on the card, zeroed here before the launch;
// palette: 256 x 3 bytes on the card; out: (height, out_width, 3) bytes.
int threedod_png_decode(const uint8_t* in, const int64_t* table, int planes, int unit, int mode, int depth,
                        const uint8_t* palette, unsigned long long* carry, int64_t carry_words, uint8_t* out,
                        int out_width, cudaStream_t stream) {
  if (planes < 1 || planes > MAX_PLANES || carry_words < 2) return static_cast<int>(cudaErrorInvalidValue);
  Planes p = {};
  p.count = planes;
  int bands = 0;
  for (int k = 0; k < planes; ++k) {
    const int64_t* t = table + k * TABLE_FIELDS;
    Plane& q = p.p[k];
    q.in_offset = t[0];
    q.ftype_offset = t[1];
    q.carry_offset = t[2];
    q.carry_stride = t[3];
    q.pitch = static_cast<int>(t[4]);
    q.units = static_cast<int>(t[5]);
    q.height = static_cast<int>(t[6]);
    q.width = static_cast<int>(t[7]);
    q.x0 = static_cast<int>(t[8]);
    q.y0 = static_cast<int>(t[9]);
    q.dx = static_cast<int>(t[10]);
    q.dy = static_cast<int>(t[11]);
    q.first_band = static_cast<int>(t[12]);
    q.channel = static_cast<int>(t[13]);
    if (q.units < 1 || q.height < 1 || q.first_band != bands || q.pitch % 16 || q.in_offset % 16 ||
        q.carry_offset % 2 || q.carry_stride % 2 || q.channel < 0 || q.channel > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    bands += (q.height + ROWS - 1) / ROWS;
  }
  cudaError_t err = cudaMemsetAsync(carry, 0, static_cast<size_t>(carry_words) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every (unit bytes, conversion, depth) a PNG colour type and depth give
#define PNG_CASE(U, M, D) \
  if (unit == U && mode == M && depth == D) return static_cast<int>(launch<U, M, D>(in, p, bands, palette, carry, out, out_width, stream));
  PNG_CASE(1, GRAY_SCALED, 1) PNG_CASE(1, GRAY_SCALED, 2) PNG_CASE(1, GRAY_SCALED, 4)  // gray below 8 bits
  PNG_CASE(1, GRAY, 8) PNG_CASE(1, GRAY, 16)     // gray, gray + alpha (the gray byte, or its high byte)
  PNG_CASE(2, GRAY16, 16)                        // 16-bit gray: both bytes
  PNG_CASE(1, PALETTE, 1) PNG_CASE(1, PALETTE, 2) PNG_CASE(1, PALETTE, 4) PNG_CASE(1, PALETTE, 8)
  PNG_CASE(1, CHANNEL, 8) PNG_CASE(1, CHANNEL, 16)  // RGB, RGBA: R, G and B (their high bytes)
#undef PNG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// hop 0: along a row, filter 1, 3 or 4 (Sub, Average, Paeth); hop 1: down a
// column, filter 2, 3 or 4 (Up, Average, Paeth).
int threedod_png_step_latency(int steps, int filter, int hop, int* sink, cudaStream_t stream) {
#define STEP_CASE(F, H) \
  if (filter == F && hop == H) step_latency_kernel<F, H><<<1, ROWS, 0, stream>>>(steps, sink); else
  STEP_CASE(1, 0) STEP_CASE(3, 0) STEP_CASE(4, 0) STEP_CASE(2, 1) STEP_CASE(3, 1) STEP_CASE(4, 1)
  return static_cast<int>(cudaErrorInvalidValue);
#undef STEP_CASE
  return static_cast<int>(cudaGetLastError());
}

const char* threedod_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
