// Multi-scale deformable sampling for Hopper (sm_90a), kernel K3 of the port.
//
// Replaces the Pallas TPU kernel threedod/models/gdino/deformable.py::
// ms_deform_sample_pallas (one pallas_call per level under a vmap over
// images). Computes what threedod_torch/ops/ms_deform.py::
// ms_deform_sample_reference computes: for each (image, query, head), the sum
// over L levels and P points of the softmaxed weight times a bilinear sample
// of the level's value map at pixel (x * W_l - 0.5, y * H_l - 0.5), taps
// outside the map reading zero.
//
// Inputs: value (B, S, H, D) f32 or bf16, the levels concatenated along S;
// locations (B, Lq, H, L, P, 2) f32; weights (B, Lq, H, L, P) in value's
// type; the level table (H_l, W_l, first row) for up to eight levels. Output
// (B, Lq, H, D) in value's type. Sums in f32, one rounding at the store.
//
// What bounds it: bytes. Every sample reads four taps of D values and does
// about ten operations a value, against the locations, weights and output it
// moves once: GroundingDINO's encoder launch (Lq = S = 13294, H = 8, D = 32,
// L = P = 4, bf16) moves 30.6 MB and does 0.54 GFLOP. The value block (6.8 MB
// in bf16) fits in the 50 MB L2, so the gathers mostly hit there; the design
// keeps every load wide and the locations read once:
//   - a group of 8 threads serves one (image, query, head), 4 channels a
//     thread (one 8-byte load in bf16, 16 bytes in f32 per tap), so a group
//     reads a head's 32 channels of a tap as one contiguous run, and a warp
//     serves 4 heads of one query;
//   - the group's L * P locations and weights are loaded once, one a thread
//     (coalesced), and passed round with __shfl_sync;
//   - value is read through the read-only cache (__ldg);
//   - the corner is clamped to [-2, W_l + 1] x [-2, H_l + 1] as a float before
//     it becomes an int, so a location far off the map (seeded offsets throw
//     some there) is a tap outside like any other, never an overflow;
//   - x and y are computed with explicit round-to-nearest products and
//     differences (no contraction into an FMA), so the corner and fractions
//     are the plain version's bit for bit.
// The TPU kernel's row-selector and column-selector matmuls and its per-level
// chunk schedule are its layout of the same function for the MXU and VMEM; a
// gather through the cache needs neither.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#define MAX_LEVELS 8
#define GROUP 8  // threads serving one (image, query, head)
#define GROUPS_PER_BLOCK 32

struct LevelTable {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float scalar(const float* p) { return __ldg(p); }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
};

// Adds wt * value[yy, xx, c:c+4] to s unless the tap lies outside the map.
template <typename T>
__device__ __forceinline__ void add_tap(const T* v_l, size_t row, int yy, int xx, int Hl, int Wl, float wt,
                                        float* s) {
  if (xx < 0 || xx >= Wl || yy < 0 || yy >= Hl) return;
  float v[4];
  Vec4<T>::load(v_l + ((size_t)yy * Wl + xx) * row, v);
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] += wt * v[q];
}

template <typename T>
__global__ void __launch_bounds__(GROUP * GROUPS_PER_BLOCK)
    ms_deform_sample_kernel(const T* __restrict__ value, const float2* __restrict__ loc,
                            const T* __restrict__ attw, T* __restrict__ out, LevelTable lv, int S, int H,
                            int D, int Lq, int L, int P, long long groups) {
  // the level table in shared memory: indexed by a runtime level, a kernel
  // parameter would be copied to the stack first (so it is read here at
  // constant indices only)
  __shared__ int lh[MAX_LEVELS], lw[MAX_LEVELS], lstart[MAX_LEVELS];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAX_LEVELS; ++i) {
      lh[i] = lv.h[i];
      lw[i] = lv.w[i];
      lstart[i] = lv.start[i];
    }
  }
  __syncthreads();
  const long long gid = (long long)blockIdx.x * GROUPS_PER_BLOCK + threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const bool active = gid < groups;
  // a group past the end shadows the last one, so every lane of the warp
  // takes part in the shuffles; it stores nothing
  const long long g = active ? gid : groups - 1;
  const int h = (int)(g % H);
  const int b = (int)(g / H / Lq);
  const int LP = L * P;
  const float2* loc_g = loc + g * LP;
  const T* w_g = attw + g * LP;
  const size_t row = (size_t)H * D;  // elements from one value row to the next
  const T* v_bh = value + (size_t)b * S * row + (size_t)h * D;
  const int nvec = D / 4;

  for (int v0 = 0; v0 < nvec; v0 += GROUP) {
    const int vec = v0 + lane;
    const bool has_vec = vec < nvec;
    const int c = 4 * vec;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j0 = 0; j0 < LP; j0 += GROUP) {
      float2 my_loc = make_float2(0.0f, 0.0f);
      float my_w = 0.0f;
      if (j0 + lane < LP) {
        my_loc = __ldg(loc_g + j0 + lane);
        my_w = Vec4<T>::scalar(w_g + j0 + lane);
      }
      const int n = min(GROUP, LP - j0);
      for (int k = 0; k < n; ++k) {
        const float lx = __shfl_sync(0xffffffffu, my_loc.x, k, GROUP);
        const float ly = __shfl_sync(0xffffffffu, my_loc.y, k, GROUP);
        const float aw = __shfl_sync(0xffffffffu, my_w, k, GROUP);
        if (!has_vec) continue;
        const int l = (j0 + k) / P;
        const int Hl = lh[l];
        const int Wl = lw[l];
        const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
        const float xf = floorf(x);
        const float yf = floorf(y);
        const float fx = __fsub_rn(x, xf);
        const float fy = __fsub_rn(y, yf);
        const int x0 = (int)fminf(fmaxf(xf, -2.0f), (float)(Wl + 1));
        const int y0 = (int)fminf(fmaxf(yf, -2.0f), (float)(Hl + 1));
        const T* v_l = v_bh + (size_t)lstart[l] * row + c;
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        add_tap(v_l, row, y0, x0, Hl, Wl, (1.0f - fy) * (1.0f - fx), s);
        add_tap(v_l, row, y0, x0 + 1, Hl, Wl, (1.0f - fy) * fx, s);
        add_tap(v_l, row, y0 + 1, x0, Hl, Wl, fy * (1.0f - fx), s);
        add_tap(v_l, row, y0 + 1, x0 + 1, Hl, Wl, fy * fx, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += aw * s[q];
      }
    }
    if (active && has_vec) Vec4<T>::store(out + g * D + c, acc);
  }
}

extern "C" {

// hw holds (H_l, W_l, first row) for each of the L levels. Launches on
// `stream` (a cudaStream_t as an integer) and returns cudaGetLastError() as
// an int: 0 when the launch was accepted.
int threedod_ms_deform_sample(const void* value, const void* loc, const void* attw, void* out, const int* hw,
                              int B, int S, int H, int D, int Lq, int L, int P, int is_bf16, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > MAX_LEVELS || D % 4) return (int)cudaErrorInvalidValue;
  LevelTable lv;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    lv.h[i] = i < L ? hw[3 * i] : 0;
    lv.w[i] = i < L ? hw[3 * i + 1] : 0;
    lv.start[i] = i < L ? hw[3 * i + 2] : 0;
  }
  const long long groups = (long long)B * Lq * H;
  if (groups == 0) return 0;
  const dim3 grid((unsigned)((groups + GROUPS_PER_BLOCK - 1) / GROUPS_PER_BLOCK));
  const int threads = GROUP * GROUPS_PER_BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* loc2 = static_cast<const float2*>(loc);
  if (is_bf16) {
    ms_deform_sample_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), loc2, static_cast<const __nv_bfloat16*>(attw),
        static_cast<__nv_bfloat16*>(out), lv, S, H, D, Lq, L, P, groups);
  } else {
    ms_deform_sample_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(value), loc2, static_cast<const float*>(attw), static_cast<float*>(out), lv, S,
        H, D, Lq, L, P, groups);
  }
  return (int)cudaGetLastError();
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
