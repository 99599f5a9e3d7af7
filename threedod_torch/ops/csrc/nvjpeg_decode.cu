// JPEG decoding on the card with nvJPEG: a JPEG's bytes in host memory ->
// interleaved RGB, uint8 (H, W, 3), in device memory the caller allocated.
//
// threedod_jpeg_size reads the image's size from its header;
// threedod_jpeg_decode decodes into `out` (pitch 3 W) on `stream` and waits
// for the stream, so the decoder's state and its host buffers are free again
// when it returns. One nvJPEG handle and state per device, made at first use.
// Every entry point returns 0, a CUDA error, or NVJPEG_ERROR_BASE plus an
// nvjpegStatus_t; threedod_cuda_error_string names either.
#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

constexpr int MAX_DEVICES = 16;
constexpr int NVJPEG_ERROR_BASE = 100000;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

Decoder g_decoders[MAX_DEVICES];

int nvjpeg_error(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : NVJPEG_ERROR_BASE + static_cast<int>(s); }

int decoder(int device, Decoder** out) {
  if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Decoder& d = g_decoders[device];
  if (d.handle == nullptr) {
    int err = nvjpeg_error(nvjpegCreateSimple(&d.handle));
    if (err) return err;
    err = nvjpeg_error(nvjpegJpegStateCreate(d.handle, &d.state));
    if (err) return err;
  }
  *out = &d;
  return 0;
}

}  // namespace

extern "C" {

int threedod_jpeg_size(const unsigned char* data, size_t length, int device, int* height, int* width) {
  Decoder* d = nullptr;
  int err = decoder(device, &d);
  if (err) return err;
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  err = nvjpeg_error(nvjpegGetImageInfo(d->handle, data, length, &components, &subsampling, widths, heights));
  if (err) return err;
  *height = heights[0];
  *width = widths[0];
  return 0;
}

int threedod_jpeg_decode(const unsigned char* data, size_t length, unsigned char* out, int width, int device,
                         cudaStream_t stream) {
  Decoder* d = nullptr;
  int err = decoder(device, &d);
  if (err) return err;
  nvjpegImage_t image = {};
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(3) * width;
  err = nvjpeg_error(nvjpegDecode(d->handle, d->state, data, length, NVJPEG_OUTPUT_RGBI, &image, stream));
  if (err) return err;
  return static_cast<int>(cudaStreamSynchronize(stream));
}

const char* threedod_cuda_error_string(int err) {
  if (err < NVJPEG_ERROR_BASE) return cudaGetErrorString(static_cast<cudaError_t>(err));
  switch (err - NVJPEG_ERROR_BASE) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: architecture mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "nvJPEG: implementation not supported";
    default: return "nvJPEG: unknown status";
  }
}

}  // extern "C"
