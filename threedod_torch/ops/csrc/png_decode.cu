// The card's PNG decoder: the five row filters undone and the pixels turned
// into RGB as Pillow's convert("RGB") does, in one kernel.
//
// Replaces no TPU kernel: the JAX package reads PNG files on the host with
// Pillow (threedod/data/native_io.py:29-38). KITTI's image_2 is PNG, and the
// port decodes every image the card reads itself, so this kernel sits beside
// the JPEG decoder (jpeg_decode.cu). The host (ops/png.py) walks the chunks,
// checks the CRCs and inflates the IDAT data with zlib into the filtered
// scanlines: a filter type byte, then W * bpp bytes, a row.
//
// What bounds it: PNG's Sub, Average and Paeth filters predict a byte from
// its left neighbour, Up, Average and Paeth from the byte above, Paeth also
// from the one above-left, so neither a row nor a column is independent. The
// kernel is one block that runs a thread a row, the rows in a wavefront one
// pixel apart: at step s the thread of band row t undoes pixel s - t, whose
// left pixel it made itself at step s - 1 (kept in a register) and whose upper
// and upper-left pixels the thread above made at steps s - 1 and s - 2 (a
// two-pixel ring in shared memory a row; the upper-left one also stays in a
// register from the previous step's read). A band is at most 1024 rows, one a
// thread; the band's last row is written to a carry row in device memory,
// which the next band's first row reads as its upper row. So the time is
// (W + rows - 1) steps of one barrier each per band: the dependences, not the
// bytes (a 1242x375 RGB file moves about 2.8 MB, under a microsecond of HBM
// time), bound it.
//
// The conversion is Pillow's: gray (and gray + alpha) to three equal
// channels, alpha dropped, a palette index looked up in a 256-entry table
// whose entries past the file's PLTE are black.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BAND = 1024;

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

__device__ __forceinline__ uint32_t load_pixel(const uint8_t* p, int bpp) {
  uint32_t v = 0;
  for (int i = 0; i < bpp; ++i) v |= static_cast<uint32_t>(p[i]) << (8 * i);
  return v;
}

__global__ void __launch_bounds__(MAX_BAND) unfilter_rgb_kernel(const uint8_t* __restrict__ filtered, int height,
                                                                 int width, int bpp, int color_type,
                                                                 const uint8_t* __restrict__ palette,
                                                                 uint8_t* __restrict__ carry,
                                                                 uint8_t* __restrict__ out) {
  __shared__ uint32_t ring[MAX_BAND][2];  // each band row's last two pixels, bytes packed little-endian
  __shared__ uint8_t pal[256 * 3];
  for (int i = threadIdx.x; i < 256 * 3; i += blockDim.x) pal[i] = palette[i];
  __syncthreads();
  const int t = threadIdx.x;
  const long long stride = static_cast<long long>(width) * bpp;
  for (int band = 0; band < height; band += blockDim.x) {
    const int rows = min(static_cast<int>(blockDim.x), height - band);
    const int r = band + t;
    const bool live = t < rows;
    const uint8_t* in = filtered + static_cast<long long>(r) * (stride + 1);
    const int ftype = live ? in[0] : 0;
    uint8_t* o = out + static_cast<long long>(r) * width * 3;
    uint32_t a = 0, c = 0;  // the left and upper-left pixels
    const int steps = width + rows - 1;
    for (int s = 0; s < steps; ++s) {
      const int x = s - t;
      if (live && x >= 0 && x < width) {
        uint32_t b = 0;  // the upper pixel: none above the image's first row
        if (t > 0) {
          b = ring[t - 1][x & 1];
        } else if (r > 0) {
          b = load_pixel(carry + static_cast<long long>(x) * bpp, bpp);
        }
        const uint32_t f = load_pixel(in + 1 + static_cast<long long>(x) * bpp, bpp);
        uint32_t v = 0;
        for (int i = 0; i < bpp; ++i) {
          const int fa = (a >> (8 * i)) & 255, fb = (b >> (8 * i)) & 255, fc = (c >> (8 * i)) & 255;
          const int pred = ftype == 1 ? fa : ftype == 2 ? fb : ftype == 3 ? (fa + fb) >> 1
                         : ftype == 4 ? paeth(fa, fb, fc) : 0;
          v |= static_cast<uint32_t>((((f >> (8 * i)) & 255) + pred) & 255) << (8 * i);
        }
        ring[t][x & 1] = v;
        if (t == rows - 1) {
          for (int i = 0; i < bpp; ++i) carry[static_cast<long long>(x) * bpp + i] = (v >> (8 * i)) & 255;
        }
        uint8_t* px = o + static_cast<long long>(x) * 3;
        if (color_type == 3) {
          const int k = (v & 255) * 3;
          px[0] = pal[k];
          px[1] = pal[k + 1];
          px[2] = pal[k + 2];
        } else if (color_type == 0 || color_type == 4) {
          px[0] = px[1] = px[2] = v & 255;
        } else {
          px[0] = v & 255;
          px[1] = (v >> 8) & 255;
          px[2] = (v >> 16) & 255;
        }
        a = v;
        c = b;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int threedod_png_unfilter_rgb(const uint8_t* filtered, int height, int width, int bpp, int color_type,
                              const uint8_t* palette, uint8_t* carry, uint8_t* out, cudaStream_t stream) {
  if (height < 1 || width < 1 || bpp < 1 || bpp > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((height < MAX_BAND ? height : MAX_BAND) + 31) / 32 * 32;
  unfilter_rgb_kernel<<<1, threads, 0, stream>>>(filtered, height, width, bpp, color_type, palette, carry, out);
  return static_cast<int>(cudaGetLastError());
}

const char* threedod_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
