// DLA Tree(levels == 1) tail in one kernel for Hopper (sm_90a), kernel K5 of
// the port.
//
// Replaces the Pallas TPU kernel made by
// threedod/ops/fused_conv.py::_make_tail_kernel (public entry
// fused_tree_tail). Computes what
// threedod_torch/ops/fused_conv.py::tree_tail_reference computes:
//     BB(v; w1, b1, w2, b2) = relu(conv3x3(relu(conv3x3(v, w1) + b1), w2) + b2 + v)
//     x1  = two blocks ? BB_a(x) : x
//     x2  = BB_b(x1)
//     out = relu(concat(x2, x1, children..., [x]) @ wr + br [+ x2])
// x (B, H, W, C) channels-last, the children (B, H, W, Ck) each with its own
// channel count. Weights in the layout of the storage type
// (fused_conv_common.cuh): float 3x3 kernels (3, 3, Cin, Cout) and wr (Ctot,
// Cout); bfloat16 (3, 3, Cout, Cin) and wr (Cout, Ctot); Ctot is the sum of
// the concat's channels, in the concat's order. Every value between two
// convolutions is rounded to the storage type.
//
// What bounds it: operations (2 * 9 * C * C a position for each of the two or
// four convolutions, plus the root). One block owns a tile of th x tw
// positions and loads x with a halo of 2 a BasicBlock (4 for two blocks).
// Three shared buffers carry the whole chain: the x tile, in which x1
// replaces x in place (the residual a thread reads is the element it then
// writes), one buffer for the inner activation of either block, and x2 on the
// tile's own positions. Each intermediate is zero outside the image, because
// the next convolution pads with zeros. The halo makes the first convolutions
// run on more positions than the tile has; of the tiles that fit the 227 KB
// of shared memory the launcher takes the one with the least work. The root reads x2 and x1 from shared memory
// and the children (and x again, as the last child of a two-block tail) from
// device memory, at the tile's own positions only.

#include "fused_conv_common.cuh"

using namespace fc;

#define MAX_CHILDREN 4

struct TailChildren {
  const void* ptr[MAX_CHILDREN];
  int c[MAX_CHILDREN];
  int n;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
tree_tail_kernel(const T* __restrict__ x, TailChildren kids, const T* __restrict__ w1a,
                 const float* __restrict__ b1a, const T* __restrict__ w2a, const float* __restrict__ b2a,
                 const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, const T* __restrict__ wr, const float* __restrict__ br,
                 T* __restrict__ out, int H, int W, int C, int Cout, int Ctot, int two, int incl, int rres,
                 int th, int tw) {
  constexpr int NP = IO<T>::NP, EW = IO<T>::EW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = two ? 4 : 2;
  const int xh = th + 2 * halo, xw = tw + 2 * halo;
  const int cp = IO<T>::pitch(C);  // channel pitch of all three tiles
  float* wsm = reinterpret_cast<float*>(smem);
  T* xt = reinterpret_cast<T*>(smem + WSM_BYTES);
  T* tt = xt + (size_t)xh * xw * cp;
  T* x2t = tt + (size_t)(xh - 2) * (xw - 2) * cp;

  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const T* ximg = x + (size_t)b * H * W * C;
  load_tile<T>(xt, ximg, H, W, C, y0 - halo, x0 - halo, xh, xw);
  __syncthreads();

  int o1 = 0;  // where x1's region, whose first position is (y0 - 2, x0 - 2), starts in xt
  if (two) {
    const int t6 = tw + 6;
    // t = relu(conv(x) + b1a) on (th + 6) x (tw + 6) from (y0 - 3, x0 - 3)
    for_each_pass<T>(
        th + 6, t6, C,
        [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
          int off[NP];
#pragma unroll
          for (int i = 0; i < NP; ++i) off[i] = (py[i] * xw + px[i]) * cp;
          mma_taps(acc, xt, off, xw * cp, cp, 3, C, IO<T>::conv(w1a, C, C), co0, ncols, wsm);
        },
        [&](int py, int px, int co, float (&v)[EW]) {
          float r[EW];
          const bool in = inside(y0 - 3 + py, x0 - 3 + px, H, W);
#pragma unroll
          for (int j = 0; j < EW; ++j) r[j] = in ? fmaxf(v[j] + b1a[co + j], 0.0f) : 0.0f;
          IO<T>::storev(tt + (py * t6 + px) * cp + co, r);
        });
    __syncthreads();
    // x1 = relu(conv(t) + b2a + x) on (th + 4) x (tw + 4) from (y0 - 2, x0 - 2), over x in xt
    for_each_pass<T>(
        th + 4, tw + 4, C,
        [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
          int off[NP];
#pragma unroll
          for (int i = 0; i < NP; ++i) off[i] = (py[i] * t6 + px[i]) * cp;
          mma_taps(acc, tt, off, t6 * cp, cp, 3, C, IO<T>::conv(w2a, C, C), co0, ncols, wsm);
        },
        [&](int py, int px, int co, float (&v)[EW]) {
          T* xp = xt + ((py + 2) * xw + px + 2) * cp + co;
          float res[EW], r[EW];
          IO<T>::loadv(xp, res);
          const bool in = inside(y0 - 2 + py, x0 - 2 + px, H, W);
#pragma unroll
          for (int j = 0; j < EW; ++j) r[j] = in ? fmaxf(v[j] + b2a[co + j] + res[j], 0.0f) : 0.0f;
          IO<T>::storev(xp, r);
        });
    __syncthreads();
    o1 = 2;
  }

  const int t2 = tw + 2;
  // t = relu(conv(x1) + b1) on (th + 2) x (tw + 2) from (y0 - 1, x0 - 1)
  for_each_pass<T>(
      th + 2, t2, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = ((py[i] + o1) * xw + px[i] + o1) * cp;
        mma_taps(acc, xt, off, xw * cp, cp, 3, C, IO<T>::conv(w1, C, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        float r[EW];
        const bool in = inside(y0 - 1 + py, x0 - 1 + px, H, W);
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = in ? fmaxf(v[j] + b1[co + j], 0.0f) : 0.0f;
        IO<T>::storev(tt + (py * t2 + px) * cp + co, r);
      });
  __syncthreads();

  // x2 = relu(conv(t) + b2 + x1) on the tile's own positions
  const int own = o1 + 2;  // the tile's first position in xt
  for_each_pass<T>(
      th, tw, C,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * t2 + px[i]) * cp;
        mma_taps(acc, tt, off, t2 * cp, cp, 3, C, IO<T>::conv(w2, C, C), co0, ncols, wsm);
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        float res[EW], r[EW];
        IO<T>::loadv(xt + ((py + own) * xw + px + own) * cp + co, res);
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = fmaxf(v[j] + b2[co + j] + res[j], 0.0f);
        IO<T>::storev(x2t + (py * tw + px) * cp + co, r);
      });
  __syncthreads();

  // root: the concat's blocks of wr, one product a source
  T* oimg = out + (size_t)b * H * W * Cout;
  for_each_pass<T>(
      th, tw, Cout,
      [&](float (&acc)[8][4], const int (&py)[NP], const int (&px)[NP], int co0, int ncols) {
        int off[NP], pos[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = (py[i] * tw + px[i]) * cp;
        mma_taps(acc, x2t, off, 0, 0, 1, C, IO<T>::rows(wr, 0, Ctot, Cout), co0, ncols, wsm);
#pragma unroll
        for (int i = 0; i < NP; ++i) off[i] = ((py[i] + own) * xw + px[i] + own) * cp;
        mma_taps(acc, xt, off, 0, 0, 1, C, IO<T>::rows(wr, C, Ctot, Cout), co0, ncols, wsm);
        // positions past the image's edge read its last row or column and are dropped below
#pragma unroll
        for (int i = 0; i < NP; ++i) pos[i] = min(y0 + py[i], H - 1) * W + min(x0 + px[i], W - 1);
        int row = 2 * C;
        for (int k = 0; k < kids.n; ++k) {
          const int ck = kids.c[k];
#pragma unroll
          for (int i = 0; i < NP; ++i) off[i] = pos[i] * ck;
          mma_taps(acc, static_cast<const T*>(kids.ptr[k]) + (size_t)b * H * W * ck, off, 0, 0, 1, ck,
                   IO<T>::rows(wr, row, Ctot, Cout), co0, ncols, wsm);
          row += ck;
        }
        if (incl) {
#pragma unroll
          for (int i = 0; i < NP; ++i) off[i] = pos[i] * C;
          mma_taps(acc, ximg, off, 0, 0, 1, C, IO<T>::rows(wr, row, Ctot, Cout), co0, ncols, wsm);
        }
      },
      [&](int py, int px, int co, float (&v)[EW]) {
        const int gy = y0 + py, gx = x0 + px;
        if (!inside(gy, gx, H, W)) return;
        float r[EW];
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = v[j] + br[co + j];
        if (rres) {
          float res[EW];
          IO<T>::loadv(x2t + (py * tw + px) * cp + co, res);
#pragma unroll
          for (int j = 0; j < EW; ++j) r[j] += res[j];
        }
#pragma unroll
        for (int j = 0; j < EW; ++j) r[j] = fmaxf(r[j], 0.0f);
        IO<T>::storev(oimg + ((size_t)gy * W + gx) * Cout + co, r);
      });
}

template <typename T>
static cudaError_t launch(const void* x, TailChildren kids, const void* w1a, const float* b1a,
                          const void* w2a, const float* b2a, const void* w1, const float* b1,
                          const void* w2, const float* b2, const void* wr, const float* br, void* out,
                          int B, int H, int W, int C, int Cout, int two, int incl, int rres,
                          cudaStream_t s) {
  const int halo = two ? 4 : 2;
  int ctot = (incl ? 3 : 2) * C;
  for (int k = 0; k < kids.n; ++k) ctot += kids.c[k];
  const auto smem_bytes = [&](int th, int tw) -> size_t {
    return WSM_BYTES + sizeof(T) * IO<T>::pitch(C) *
                           ((size_t)(th + 2 * halo) * (tw + 2 * halo) +
                            (size_t)(th + 2 * halo - 2) * (tw + 2 * halo - 2) + (size_t)th * tw);
  };
  const auto slots = [&](int th, int tw) {
    const double first = stage_slots((th + 6) * (tw + 6), C, 9, C) + stage_slots((th + 4) * (tw + 4), C, 9, C);
    return (two ? first : 0.0) + stage_slots((th + 2) * (tw + 2), C, 9, C) + stage_slots(th * tw, C, 9, C) +
           stage_slots(th * tw, Cout, 1, ctot);
  };
  int th, tw;
  if (!pick_tile(H, W, smem_bytes, slots, &th, &tw)) return cudaErrorInvalidValue;  // nothing fits
  const size_t bytes = smem_bytes(th, tw);
  cudaError_t err =
      cudaFuncSetAttribute(tree_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  tree_tail_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), kids, static_cast<const T*>(w1a), b1a, static_cast<const T*>(w2a), b2a,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, static_cast<const T*>(wr), br,
      static_cast<T*>(out), H, W, C, Cout, ctot, two, incl, rres, th, tw);
  return cudaGetLastError();
}

extern "C" {

// The first block's weights (w1a .. b2a) are read only when `two` is set.
// Launches on `stream` and returns the CUDA error as an int: 0 when the
// launch was accepted.
int threedod_fused_tree_tail(const void* x, TailChildren kids, const void* w1a, const float* b1a,
                             const void* w2a, const float* b2a, const void* w1, const float* b1,
                             const void* w2, const float* b2, const void* wr, const float* br, void* out,
                             int B, int H, int W, int C, int Cout, int two, int incl, int rres,
                             int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kids.n < 0 || kids.n > MAX_CHILDREN || (rres && Cout != C)) return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(x, kids, w1a, b1a, w2a, b2a, w1, b1, w2, b2, wr, br, out, B, H, W,
                                        C, Cout, two, incl, rres, s)
                : launch<float>(x, kids, w1a, b1a, w2a, b2a, w1, b1, w2, b2, wr, br, out, B, H, W, C, Cout,
                                two, incl, rres, s);
  return (int)err;
}

const char* threedod_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
