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
// type; the level table (H_l, W_l, first row). Output (B, Lq, H, D) in
// value's type. Sums in f32, one rounding at the store.
//
// What bounds it: not the bytes that must cross device memory (GroundingDINO's
// encoder launch, Lq = S = 13294, H = 8, D = 32, L = P = 4, bf16, moves 30.6
// MB), but the gathers: every sample reads four taps of a head's D channels,
// 6.8 million 64-byte taps an encoder launch, 435 MB of load traffic from L2
// and L1, behind one short dependent chain a sample (locations -> corners ->
// taps -> sums), and the instructions around them (corners, the bf16 unpack,
// the FMAs). The design keeps many taps in flight on many warps and moves the
// coarse levels' taps to shared memory:
//   - 16-byte lanes: a group of `lanes` threads (a power of two) serves one
//     (image, query, head), NV vectors of VB bytes a tap a thread (VB 16, or 8
//     where a head's bf16 run is not a multiple of 16 bytes or value is not
//     16-byte aligned); each lane reads its (query, head)'s locations and
//     weights itself, as vectors, so no shuffle and no division by P is
//     needed; a sample's weight is folded into its four tap weights;
//   - at GroundingDINO's (L, P) = (4, 4) the level loop is unrolled and the
//     taps of PF samples of a level (8 taps at PF = 2) are loaded before the
//     first is used; the level table is a kernel parameter read at constant
//     indices only (a runtime index would copy it to the stack);
//   - staged (the encoder's shape): a persistent grid of blocks of 1024
//     threads (768 in bf16 with 16-byte lanes), each one (image, head) and a
//     run of consecutive queries; the block first copies its head's slice of
//     the coarsest levels that fit a 128 KB budget (ms_deform.sample_plan
//     chooses how many: levels 2 and 3 at 800x800) into shared memory with
//     cp.async, then gathers those levels there and the others through the
//     L1 left beside them (ld.global.nc), where the neighbouring queries of
//     the model share taps;
//   - split (the decoder's shape, too few (query, head) pairs to fill the
//     card's SMs): the L levels go to L lane groups of one warp, two vectors
//     a lane, whose f32 sums are added with __shfl_xor_sync, so four times
//     the threads wait on one level's taps each;
//   - generic: any other L (up to 8) and P, one sample's four taps at a time,
//     the level table in shared memory;
//   - the earlier design's 16-byte spill (a group of 8 threads a (query,
//     head)) was the registers it saved to the stack around its call to the
//     64-bit division routine (g % H); the staged kernel divides 32-bit
//     indices only, and its thread count is set so that ptxas keeps it free
//     of spills and stack frames, as the others are (chip_smoke.py phase 2
//     prints the counts);
//   - the corner is clamped to [-2, W_l + 1] x [-2, H_l + 1] as a float before
//     it becomes an int, so a location far off the map (seeded offsets throw
//     some there) is a tap outside like any other, never an overflow; x and y
//     are computed with explicit round-to-nearest products and differences
//     (no contraction into an FMA), so the corner and fractions are the plain
//     version's bit for bit.
// The TPU kernel's row-selector and column-selector matmuls and its per-level
// chunk schedule are its layout of the same function for the MXU and VMEM; a
// gather through the caches needs neither.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int FAST = 4;  // L and P of the specialised kernels
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can have
constexpr int PF = 2;  // samples of a level whose taps are loaded before the first is used

enum Variant { GENERIC = 0, SPLIT = 1, STAGED = 2 };

// Threads of a staged block: 1024 (64 registers a thread) where the kernel
// fits them without a spill, 768 (80) for bf16 with 16-byte vectors, which
// spills at 64
template <typename T, int VB>
constexpr int STAGED_THREADS = sizeof(T) == 2 && VB == 16 ? 768 : 1024;

// (H_l, W_l, first row) of four levels and, for a level held in shared
// memory, its first element there (-1 for a level gathered from memory)
struct Levels4 {
  int h[FAST], w[FAST], start[FAST], soff[FAST];
};

struct LevelTable {
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// ---- VB-byte vectors of T, unpacked to f32 -----------------------------------

template <int VB>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
  __device__ static uint4 zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <>
struct Raw<8> {
  using type = uint2;
  __device__ static uint2 zero() { return make_uint2(0u, 0u); }
};

__device__ __forceinline__ void words(const uint4& r, uint32_t (&w)[4]) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ void words(const uint2& r, uint32_t (&w)[2]) {
  w[0] = r.x;
  w[1] = r.y;
}

template <typename T, int VB>
struct Vec {
  static constexpr int VE = VB / (int)sizeof(T);  // elements a lane
  using R = typename Raw<VB>::type;
  __device__ static R zero() { return Raw<VB>::zero(); }
  __device__ static R ldg(const T* p) { return __ldg(reinterpret_cast<const R*>(p)); }
  __device__ static R lds(const T* p) { return *reinterpret_cast<const R*>(p); }
  __device__ static void unpack(const R& r, float (&f)[VE]) {
    uint32_t w[VB / 4];
    words(r, w);
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < VB / 4; ++i) f[i] = __uint_as_float(w[i]);
    } else {  // bf16: the element at the lower address is the low half
#pragma unroll
      for (int i = 0; i < VB / 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
  __device__ static void store(T* p, const float* f) {
    uint32_t w[VB / 4];
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
};

// the P = 4 weights of one (query, head, level), as one vector
__device__ __forceinline__ void load_weights4(const float* p, float (&a)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void load_weights4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  a[0] = __uint_as_float(v.x << 16);
  a[1] = __uint_as_float(v.x & 0xffff0000u);
  a[2] = __uint_as_float(v.y << 16);
  a[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float weight1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float weight1(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// ---- one sample's four taps ------------------------------------------------------

// The pixel (row-major within the level) of each of the four taps of the
// sample at (lx, ly), -1 for a tap outside the map, and its bilinear weight.
__device__ __forceinline__ void corners(float lx, float ly, int Hl, int Wl, int* off, float* tw) {
  const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
  const float xf = floorf(x);
  const float yf = floorf(y);
  const float fx = __fsub_rn(x, xf);
  const float fy = __fsub_rn(y, yf);
  const int x0 = (int)fminf(fmaxf(xf, -2.0f), (float)(Wl + 1));
  const int y0 = (int)fminf(fmaxf(yf, -2.0f), (float)(Hl + 1));
  const bool cx0 = x0 >= 0 && x0 < Wl, cx1 = x0 >= -1 && x0 + 1 < Wl;
  const bool cy0 = y0 >= 0 && y0 < Hl, cy1 = y0 >= -1 && y0 + 1 < Hl;
  const int r0 = y0 * Wl + x0;
  off[0] = cy0 && cx0 ? r0 : -1;
  off[1] = cy0 && cx1 ? r0 + 1 : -1;
  off[2] = cy1 && cx0 ? r0 + Wl : -1;
  off[3] = cy1 && cx1 ? r0 + Wl + 1 : -1;
  tw[0] = (1.0f - fy) * (1.0f - fx);
  tw[1] = (1.0f - fy) * fx;
  tw[2] = fy * (1.0f - fx);
  tw[3] = fy * fx;
}

// acc += the weighted sum of one level's four samples, at the locations `xy`,
// on one lane's NV vectors of channels (the first nv_ok of them exist): the
// taps of PF samples are loaded (from shared memory or through L1) before the
// first is used. `base` points at the lane's channels of the level's first
// pixel, `stride` elements apart from one pixel to the next.
template <typename T, int VB, int NV, bool SHARED>
__device__ __forceinline__ void level4(const T* base, int stride, int nv_ok, const float4* xy,
                                       const float (&aw)[4], int Hl, int Wl,
                                       float (&acc)[NV * Vec<T, VB>::VE]) {
  static_assert(FAST % PF == 0, "PF divides the four samples of a level");
  using V = Vec<T, VB>;
  constexpr int VE = V::VE;
  const float4 la = __ldg(xy), lb = __ldg(xy + 1);
  const float at[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
  for (int p0 = 0; p0 < 4; p0 += PF) {
    // this batch's corners only: fewer registers live
    int off[4 * PF];
    float tw[4 * PF];
#pragma unroll
    for (int p = 0; p < PF; ++p) corners(at[2 * (p0 + p)], at[2 * (p0 + p) + 1], Hl, Wl, off + 4 * p, tw + 4 * p);
    typename V::R raw[4 * PF][NV];
#pragma unroll
    for (int k = 0; k < 4 * PF; ++k) {
      const int o = off[k];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const bool ok = o >= 0 && n < nv_ok;
        if constexpr (SHARED) {
          raw[k][n] = ok ? V::lds(base + o * stride + n * VE) : V::zero();
        } else {
          raw[k][n] = ok ? V::ldg(base + (size_t)o * stride + n * VE) : V::zero();
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PF; ++p) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float wt = aw[p0 + p] * tw[4 * p + t];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float v[VE];
          V::unpack(raw[4 * p + t][n], v);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[n * VE + e] += wt * v[e];
        }
      }
    }
  }
}

// a field of a runtime level (0..3) of the table by selects, never by a
// runtime index into a parameter
__device__ __forceinline__ int pick(const int (&a)[FAST], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// ---- staged: a persistent block an (image, head), coarse levels in shared memory

template <int VB>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

template <typename T, int VB, int NV>
__global__ void __launch_bounds__(STAGED_THREADS<T, VB>, 1)
    ms_deform_staged(const T* __restrict__ value, const float4* __restrict__ loc, const T* __restrict__ attw,
                     T* __restrict__ out, Levels4 lv, int S, int H, int D, int Lq, int lane_shift, int per_pair,
                     int per_block, int first_staged) {
  using V = Vec<T, VB>;
  constexpr int VE = V::VE;
  constexpr int NT = STAGED_THREADS<T, VB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int pair = blockIdx.x / per_pair;
  const int part = blockIdx.x - pair * per_pair;
  const int b = pair / H;
  const int h = pair - b * H;
  // queries [q_begin, q_end): per_block of them a block, from the host, so
  // that no 64-bit division (a call, with registers saved to the stack) is
  // needed here
  const int q_begin = part * per_block;
  const int q_end = min(Lq, q_begin + per_block);
  if (q_begin >= q_end) return;  // the whole block: more blocks than queries
  const size_t row = (size_t)H * D;
  const T* v_bh = value + (size_t)b * S * row + (size_t)h * D;
  const int nvec = D / VE;

#pragma unroll
  for (int l = 0; l < FAST; ++l) {
    if (l < first_staged) continue;
    const int n = lv.h[l] * lv.w[l] * nvec;
    const T* src = v_bh + (size_t)lv.start[l] * row;
    T* dst = sm + lv.soff[l];
    for (int i = threadIdx.x; i < n; i += NT) {
      const int pix = i / nvec;
      const int c = (i - pix * nvec) * VE;
      cp_async<VB>(dst + pix * D + c, src + (size_t)pix * row + c);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lanes = 1 << lane_shift;
  const int sub = threadIdx.x & (lanes - 1);
  for (int q = q_begin + (threadIdx.x >> lane_shift); q < q_end; q += NT >> lane_shift) {
    const long long g = ((long long)b * Lq + q) * H + h;
    const float4* lg = loc + g * (FAST * FAST / 2);
    const T* wg = attw + g * (FAST * FAST);
    for (int vec = sub * NV; vec < nvec; vec += lanes * NV) {
      const int nv_ok = min(NV, nvec - vec);
      float acc[NV * VE];
#pragma unroll
      for (int e = 0; e < NV * VE; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int l = 0; l < FAST; ++l) {
        float aw[4];
        load_weights4(wg + FAST * l, aw);
        if (l >= first_staged) {
          level4<T, VB, NV, true>(sm + lv.soff[l] + vec * VE, D, nv_ok, lg + 2 * l, aw, lv.h[l], lv.w[l],
                                      acc);
        } else {
          level4<T, VB, NV, false>(v_bh + (size_t)lv.start[l] * row + vec * VE, (int)row, nv_ok,
                                       lg + 2 * l, aw, lv.h[l], lv.w[l], acc);
        }
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n < nv_ok) V::store(out + g * D + (vec + n) * VE, acc + n * VE);
      }
    }
  }
}

// ---- split: one level a lane group, the levels' sums added by shuffles --------

template <typename T, int VB, int NV>
__global__ void __launch_bounds__(THREADS, 2)
    ms_deform_split(const T* __restrict__ value, const float4* __restrict__ loc, const T* __restrict__ attw,
                    T* __restrict__ out, Levels4 lv, int S, int H, int D, int Lq, int lane_shift, long long groups) {
  using V = Vec<T, VB>;
  constexpr int VE = V::VE;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long gid = t >> (lane_shift + 2);
  const int l = (int)(t >> lane_shift) & (FAST - 1);
  const int lanes = 1 << lane_shift;
  const int sub = (int)t & (lanes - 1);
  // a group past the end shadows the last one, so every lane of the warp
  // takes part in the shuffles; it stores nothing
  const bool active = gid < groups;
  const long long g = active ? gid : groups - 1;
  const int h = (int)(g % H);
  const int b = (int)(g / H / Lq);
  const int Hl = pick(lv.h, l), Wl = pick(lv.w, l);
  const size_t row = (size_t)H * D;
  const T* v_l = value + ((size_t)b * S + pick(lv.start, l)) * row + (size_t)h * D;
  const float4* lg = loc + g * (FAST * FAST / 2) + 2 * l;
  const T* wg = attw + g * (FAST * FAST) + FAST * l;
  const int nvec = D / VE;
  for (int v0 = 0; v0 < nvec; v0 += lanes * NV) {
    const int vec = v0 + sub * NV;
    const int nv_ok = min(NV, nvec - vec);
    float acc[NV * VE];
#pragma unroll
    for (int e = 0; e < NV * VE; ++e) acc[e] = 0.0f;
    if (nv_ok > 0) {
      float aw[4];
      load_weights4(wg, aw);
      level4<T, VB, NV, false>(v_l + vec * VE, (int)row, nv_ok, lg, aw, Hl, Wl, acc);
    }
#pragma unroll
    for (int m = 1; m < FAST; m <<= 1) {
#pragma unroll
      for (int e = 0; e < NV * VE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m << lane_shift);
    }
    if (active && l == 0) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n < nv_ok) V::store(out + g * D + (vec + n) * VE, acc + n * VE);
      }
    }
  }
}

// ---- generic: any L up to 8 and any P -------------------------------------------

template <typename T, int VB>
__global__ void __launch_bounds__(THREADS)
    ms_deform_generic(const T* __restrict__ value, const float2* __restrict__ loc, const T* __restrict__ attw,
                      T* __restrict__ out, LevelTable lv, int S, int H, int D, int Lq, int L, int P, int lane_shift,
                      long long groups) {
  using V = Vec<T, VB>;
  constexpr int VE = V::VE;
  // the level table in shared memory: indexed by a runtime level, a kernel
  // parameter would be copied to the stack first
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
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long g = t >> lane_shift;
  if (g >= groups) return;
  const int lanes = 1 << lane_shift;
  const int sub = (int)t & (lanes - 1);
  const int h = (int)(g % H);
  const int b = (int)(g / H / Lq);
  const size_t row = (size_t)H * D;
  const T* v_bh = value + (size_t)b * S * row + (size_t)h * D;
  const float2* lg = loc + g * L * P;
  const T* wg = attw + g * L * P;
  const int nvec = D / VE;
  for (int vec = sub; vec < nvec; vec += lanes) {
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int Hl = lh[l], Wl = lw[l];
      const T* v_l = v_bh + (size_t)lstart[l] * row + vec * VE;
      for (int p = 0; p < P; ++p) {
        const float2 xy = __ldg(lg + l * P + p);
        const float aw = weight1(wg + l * P + p);
        int off[4];
        float tw[4];
        corners(xy.x, xy.y, Hl, Wl, off, tw);
        typename V::R raw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) raw[k] = off[k] >= 0 ? V::ldg(v_l + (size_t)off[k] * row) : V::zero();
        float s[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) s[e] = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v[VE];
          V::unpack(raw[k], v);
#pragma unroll
          for (int e = 0; e < VE; ++e) s[e] += tw[k] * v[e];
        }
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] += aw * s[e];
      }
    }
    V::store(out + g * D + vec * VE, acc);
  }
}

// The vectors a lane loads a tap are the plan's (ms_deform.VECTORS_A_LANE);
// the kernels are instantiated for those only: one in the generic and staged
// kernels, two in the split one. Any other count returns cudaErrorInvalidValue.
template <typename T, int VB>
int launch(const void* value, const void* loc, const void* attw, void* out, const int* hw, int B, int S, int H,
           int D, int Lq, int L, int P, int variant, int vectors, int lane_shift, int first_staged, int per_pair,
           int device, cudaStream_t stream) {
  constexpr int VE = Vec<T, VB>::VE;
  if (D % VE || lane_shift < 0 || lane_shift > 5 || vectors != (variant == SPLIT ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  const T* v = static_cast<const T*>(value);
  const T* w = static_cast<const T*>(attw);
  T* o = static_cast<T*>(out);
  const long long groups = (long long)B * Lq * H;
  if (variant == GENERIC) {
    LevelTable lv;
    for (int i = 0; i < MAX_LEVELS; ++i) {
      lv.h[i] = i < L ? hw[3 * i] : 0;
      lv.w[i] = i < L ? hw[3 * i + 1] : 0;
      lv.start[i] = i < L ? hw[3 * i + 2] : 0;
    }
    const long long blocks = ((groups << lane_shift) + THREADS - 1) / THREADS;
    ms_deform_generic<T, VB><<<(unsigned)blocks, THREADS, 0, stream>>>(
        v, static_cast<const float2*>(loc), w, o, lv, S, H, D, Lq, L, P, lane_shift, groups);
    return (int)cudaGetLastError();
  }
  if (L != FAST || P != FAST) return (int)cudaErrorInvalidValue;
  Levels4 lv;
  int smem = 0;
  for (int i = FAST - 1; i >= 0; --i) {
    lv.h[i] = hw[3 * i];
    lv.w[i] = hw[3 * i + 1];
    lv.start[i] = hw[3 * i + 2];
    lv.soff[i] = -1;
  }
  for (int i = 0; i < FAST; ++i) {
    if (variant == STAGED && i >= first_staged) {
      lv.soff[i] = smem / (int)sizeof(T);
      smem += lv.h[i] * lv.w[i] * D * (int)sizeof(T);
    }
  }
  const float4* l4 = static_cast<const float4*>(loc);
  if (variant == SPLIT) {
    if ((FAST << lane_shift) > 32) return (int)cudaErrorInvalidValue;
    const long long blocks = ((groups << (lane_shift + 2)) + THREADS - 1) / THREADS;
    ms_deform_split<T, VB, 2><<<(unsigned)blocks, THREADS, 0, stream>>>(v, l4, w, o, lv, S, H, D, Lq, lane_shift,
                                                                          groups);
    return (int)cudaGetLastError();
  }
  if (variant != STAGED || smem > SMEM_MAX || per_pair < 1 || first_staged < 0 || first_staged > FAST)
    return (int)cudaErrorInvalidValue;
  static bool opted_in[64] = {};
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !opted_in[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(ms_deform_staged<T, VB, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  const long long blocks = (long long)B * H * per_pair;
  const int per_block = (Lq + per_pair - 1) / per_pair;
  ms_deform_staged<T, VB, 1><<<(unsigned)blocks, STAGED_THREADS<T, VB>, smem, stream>>>(
      v, l4, w, o, lv, S, H, D, Lq, lane_shift, per_pair, per_block, first_staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hw holds (H_l, W_l, first row) for each of the L levels. `variant`,
// `vec_bytes`, `vectors` (a lane loads a tap), `lane_shift` (log2 of the
// lanes serving one (query, head)), `first_staged` (the first level held in
// shared memory) and `per_pair` (blocks an (image, head)) come from
// ms_deform.sample_plan; a combination
// the kernels do not take returns cudaErrorInvalidValue. Launches on `stream`
// (a cudaStream_t as an integer) and returns cudaGetLastError() as an int: 0
// when the launch was accepted.
int threedod_ms_deform_sample(const void* value, const void* loc, const void* attw, void* out, const int* hw,
                              int B, int S, int H, int D, int Lq, int L, int P, int variant, int vec_bytes,
                              int vectors, int lane_shift, int first_staged, int per_pair, int is_bf16, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > MAX_LEVELS || P < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec_bytes == 16)
    return launch<__nv_bfloat16, 16>(value, loc, attw, out, hw, B, S, H, D, Lq, L, P, variant, vectors, lane_shift,
                                     first_staged, per_pair, device, s);
  if (is_bf16 && vec_bytes == 8)
    return launch<__nv_bfloat16, 8>(value, loc, attw, out, hw, B, S, H, D, Lq, L, P, variant, vectors, lane_shift,
                                    first_staged, per_pair, device, s);
  if (!is_bf16 && vec_bytes == 16)
    return launch<float, 16>(value, loc, attw, out, hw, B, S, H, D, Lq, L, P, variant, vectors, lane_shift,
                             first_staged, per_pair, device, s);
  return (int)cudaErrorInvalidValue;
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
