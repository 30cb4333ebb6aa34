// K2's backward: the gradient of the view-streaming ray sampler
// (csrc/streaming_sample_mean_var.cu) with respect to the feature maps.
//
// Replaces the autodiff of the lax.scan over views in
// nerfdet_tpu/ops/render.py (streaming_sample_mean_var, scan body `body`,
// and the statistics after it) through its packed bilinear gathers
// (nerfdet_tpu/ops/grid_sample.py: grid_sample_2d_packed): per (point,
// view) the transpose of the bilinear sample, a scatter-add into the
// feature maps. Given g, the cotangent of globalfeat's feature half, mean
// and e = exp(-var) from the forward, its unmasked sums s1u and count cnt,
// with d = cnt + 1e-8 and V views, per point and channel (pass 0)
//
//   g_var = -(g_e e)
//   d s1m = (g_mean + (g_var (2V mean - 2 s1u)) / d) / d
//   d s2u = g_var / d          d s1u = ((-2 mean) g_var) / d
//
// and per (point, view), with f the forward's bilinear sample (recomputed
// from the map), m the view's mask and w_k the window's four tap weights,
//
//   df = (d s1u + m d s1m) + (2 f) d s2u,   d map[tap k] += df w_k
//
// (JAX adds df's terms as (d s1u + (2 f) d s2u) + m d s1m: one rounding of
// df apart, well inside the 1e-5 x max the kernel is held to).
//
// Nothing is skipped where cnt = 0: 1 / d is then 1e8, and a point seen by
// no view but with a partial border weight in some view has a small s2u,
// so exp(-var) need not underflow and its gradient can be large. JAX
// computes exactly this.
//
// What bounds it on an H100 at the training path's shape (2048 rays x 64
// samples = 131,072 points, 50 views, 59x80x32 f32 maps: 6.55 M (point,
// view) pairs, 4.20 M with a non-zero tap weight): bytes. The least
// traffic is 232.5 MB (the maps read and their gradient written, 30.2 MB
// each; g's and globalfeat's feature halves, 33.5 MB each; s1u 16.8 MB;
// the pairs' keys and the kept pairs' indices), 0.069 ms at 3.35 TB/s,
// against 2.92 GFLOP (0.044 ms). What the design moves on top of that is
// the gather of each kept pair's cotangent rows, 4.20 M x 256 B = 1.08 GB
// from a 50.3 MB array (coef) that the 50 MB L2 does not keep, and the
// packed windows' round trip (120.8 MB each way).
//
// Deterministic, with no float atomics; integer atomics only count:
//
// Pass 0 (keys_kernel, coef_kernel): each (point n, view v) pair, at p = v
//   N + n, gets the key v FH FW + its feature window's start texel, or V FH
//   FW (past every window) where all four tap weights are 0; the points'
//   cotangents go to coef (N, 3, C) as the rows d s1u + d s1m (for a view
//   that sees the point), d s1u (for one that does not) and d s2u, so pass
//   1 reads two rows a pair, 256 B, where d s1u, d s2u and d s1m would
//   take three. Dropping the
//   zero-weight pairs (most of the pairs outside a view: their window is
//   clamped to the map's edge, so one edge window would otherwise sum
//   millions of zero terms) changes at most the sign of an exact zero:
//   their terms are df * 0. A pair with a partial weight, its coordinate in
//   (-1, 0) or (size - 1, size), keeps its key.
// Index preparation (csrc/counting_sort.cuh): a stable counting sort per
//   view over its FH FW window bins that places only the kept pairs, a
//   window's pairs in ascending point order, and writes `off`, where each
//   window's pairs start, from its own scan.
// Pass 1 (window_kernel): a warp a window (v, texel), lane c channel c.
//   The warp loads the window's four taps once, then its pairs 32 at a
//   time: lane j loads pair j's index and projects it once (the forward's
//   arithmetic, separately rounded), and the warp walks the 32 in order,
//   each pair's weights and mask handed out by shuffle, the cotangent rows
//   of kDepth pairs loaded before the first of them is used. It sums df w_k
//   into four registers a lane: packed (V FH FW, 4, C), written only for
//   the windows that hold a pair.
// Pass 2 (unpack_kernel): a thread a texel and 4 channels (1 where C % 4
//   != 0) adds the four windows that hold it in a fixed order, packed[y,
//   x].00 + packed[y, x-1].01 + packed[y-1, x].10 + packed[y-1, x-1].11,
//   reading only the windows that hold a pair (an empty window's sum is
//   +0, which adds nothing to a sum that cannot be -0); a window's taps
//   past the right or bottom edge are never read (the transpose of
//   pack_bilinear's zero pad).
//
// Summation order: per window, its pairs in ascending point order; then
// the fixed unpack: the order of the design before this one, whose df
// added its terms as JAX does.
//
// bfloat16 maps (the bf16 compute path): the result rounds as XLA's CPU
// backend runs JAX's transpose of the bfloat16 taps, which the plain
// version (ops/render.py: _backward_plain_bf16) follows. Pass 0 writes the
// rows (d s1m, d s1u, d s2u), and per pair df = (d s1u + (2 f) d s2u) + m
// d s1m in JAX's order, f the forward's bfloat16 sample; df is rounded to
// bfloat16, each tap's df w_k (w_k the forward's bfloat16 weight) too, and
// each window's four sums are rounded after every add, in point order.
// Pass 2 adds a texel's four windows in the order of the transpose of
// pack_bilinear, tap 10, 11, 01, 00, rounding each sum, and writes
// bfloat16. All roundings __float2bfloat16_rn, to nearest even. The maps
// and their gradient move half the bytes (the least traffic 202 MB at
// the training path's shape, 0.060 ms); pass 1 still gathers the same
// cotangent rows, and each pair now also rounds six values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "counting_sort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The forward's projection row ((p0 x + p1 y) + p2 z) + p3.
__device__ __forceinline__ float row(const float* p, float x, float y,
                                     float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[0], x), __fmul_rn(p[1], y)),
                             __fmul_rn(p[2], z)),
                   p[3]);
}

// Window start clip(floor(p), 0, size - 1) and its two tap weights.
__device__ __forceinline__ int window(float p, int size, float* w0,
                                      float* w1) {
  const float s = fminf(fmaxf(floorf(p), 0.f), (float)(size - 1));
  const float r = __fsub_rn(p, s);
  *w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(r)));
  *w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(r, 1.f))));
  return (int)s;
}

// x rounded to bfloat16, to nearest even, as a float.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A float that holds a bfloat16 value, as its 16 bits.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return static_cast<unsigned short>(__float_as_uint(x) >> 16);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

// One (point, view): the feature window's start texel, its tap weights
// (00, 01, 10, 11) and the view's mask, as the forward computes them.
struct Pair {
  int idx;
  float4 w;
  bool m;
};

__device__ __forceinline__ Pair project(const float* pv, const float* pt,
                                        float h1, float w1, int fh, int fw,
                                        float fsx, float fsy) {
  const float x = pt[0], y = pt[1], z = pt[2];
  const float cx = row(pv, x, y, z);
  const float cy = row(pv + 4, x, y, z);
  const float cz = row(pv + 8, x, y, z);
  const float zc = fmaxf(cz, 1e-8f);
  const float px = fminf(fmaxf(__fdiv_rn(cx, zc), -1e6f), 1e6f);
  const float py = fminf(fmaxf(__fdiv_rn(cy, zc), -1e6f), 1e6f);
  Pair q;
  q.m = cz > 0.f && px <= w1 && px >= 0.f && py <= h1 && py >= 0.f;
  float wx0, wx1, wy0, wy1;
  const int x0 = window(__fmul_rn(px, fsx), fw, &wx0, &wx1);
  const int y0 = window(__fmul_rn(py, fsy), fh, &wy0, &wy1);
  q.w = make_float4(__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                    __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1));
  q.idx = y0 * fw + x0;
  return q;
}

// ---- pass 0 ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const float* __restrict__ pts, const float* __restrict__ proj,
                int* __restrict__ keys, int n, int n_views, int fh, int fw,
                float h1, float w1, float fsx, float fsy) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n * n_views) return;
  const int v = p / n, i = p - v * n;
  float pv[12], pt[3];
#pragma unroll
  for (int k = 0; k < 12; ++k) pv[k] = __ldg(proj + 16 * v + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) pt[k] = __ldg(pts + (size_t)i * 3 + k);
  const Pair q = project(pv, pt, h1, w1, fh, fw, fsx, fsy);
  const int hw = fh * fw;
  const bool zero =
      q.w.x == 0.f && q.w.y == 0.f && q.w.z == 0.f && q.w.w == 0.f;
  keys[p] = zero ? n_views * hw : v * hw + q.idx;
}

// Thread t of the grid: point t / C, channel t % C. Rows (d s1u + d s1m,
// d s1u, d s2u), or with kBf (d s1m, d s1u, d s2u).
template <bool kBf>
__global__ void __launch_bounds__(kThreads)
    coef_kernel(const float* __restrict__ g, const float* __restrict__ gf,
                const float* __restrict__ s1u, const float* __restrict__ cnt,
                float* __restrict__ coef, int n, int n_views, int c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * c) return;
  const int i = (int)(t / c), ch = (int)(t % c);
  const int cs = 3 + c;
  const size_t at = (size_t)i * 2 * cs + 3 + ch;
  const float g_mean = __ldg(g + at), g_e = __ldg(g + at + cs);
  const float mean = __ldg(gf + at), e = __ldg(gf + at + cs);
  const float su = __ldg(s1u + (size_t)i * c + ch);
  const float d = __fadd_rn(__ldg(cnt + i), 1e-8f);
  const float g_var = -__fmul_rn(g_e, e);
  const float slope = __fsub_rn(__fmul_rn(2.f * (float)n_views, mean),
                                __fmul_rn(2.f, su));
  const float d_s1m =
      __fdiv_rn(__fadd_rn(g_mean, __fdiv_rn(__fmul_rn(g_var, slope), d)), d);
  const float d_s1u = __fdiv_rn(__fmul_rn(__fmul_rn(-2.f, mean), g_var), d);
  float* out = coef + (size_t)i * 3 * c + ch;
  out[0] = kBf ? d_s1m : __fadd_rn(d_s1u, d_s1m);  // a pair the view sees
  out[c] = d_s1u;                    // one it does not
  out[2 * c] = __fdiv_rn(g_var, d);  // d s2u
}

// ---- pass 1: a warp a window ---------------------------------------------

constexpr int kDepth = 8;  // pairs whose cotangent rows are loaded ahead

template <bool kBf>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const float* __restrict__ pts,
                  const float* __restrict__ proj,
                  const typename std::conditional<kBf, uint16_t,
                                                  float>::type* __restrict__
                      feats,
                  const float* __restrict__ coef,
                  const int* __restrict__ order, const int* __restrict__ off,
                  float* __restrict__ packed, int n, int n_views, int fh,
                  int fw, int c, float h1, float w1, float fsx, float fsy) {
  const int hw = fh * fw;
  const int win = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (win >= n_views * hw) return;
  const int lane = threadIdx.x & 31;
  const int v = win / hw, idx = win - v * hw;
  const int beg = __ldg(off + win), end = __ldg(off + win + 1);
  if (beg >= end) return;  // no pair here: pass 2 does not read the window
  const bool has_ch = lane < c;
  float* out = packed + (size_t)win * 4 * c + lane;
  float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
  float pv[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) pv[k] = __ldg(proj + 16 * v + k);
  // the window's four taps of channel `lane`, zero past the edges
  const int y0 = idx / fw, x0 = idx - y0 * fw;
  const bool x1 = x0 + 1 < fw, y1 = y0 + 1 < fh;
  const auto* fv = feats + (size_t)v * hw * c + lane;
  float t00 = 0.f, t01 = 0.f, t10 = 0.f, t11 = 0.f;
  if (has_ch) {
    t00 = load1(fv + (size_t)idx * c);
    if (x1) t01 = load1(fv + (size_t)(idx + 1) * c);
    if (y1) t10 = load1(fv + (size_t)(idx + fw) * c);
    if (x1 && y1) t11 = load1(fv + (size_t)(idx + fw + 1) * c);
  }
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int cnt = min(32, end - j0);
    // lane k: pair j0 + k, projected once
    int i = 0;
    float4 wq = make_float4(0.f, 0.f, 0.f, 0.f);
    float mq = 0.f;
    if (lane < cnt) {
      i = __ldg(order + j0 + lane) - v * n;
      float pt[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pt[k] = __ldg(pts + (size_t)i * 3 + k);
      const Pair q = project(pv, pt, h1, w1, fh, fw, fsx, fsy);
      wq = q.w;
      if constexpr (kBf)  // the forward's bfloat16 feature weights
        wq = make_float4(bf16r(wq.x), bf16r(wq.y), bf16r(wq.z), bf16r(wq.w));
      mq = q.m ? 1.f : 0.f;
    }
    for (int k0 = 0; k0 < cnt; k0 += kDepth) {
      // kBf: da the d s1u row, dm the d s1m row where the view sees the
      // point; otherwise da the row this pair reads and dm unused
      float da[kDepth], d2[kDepth], dm[kBf ? kDepth : 1];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int k = (k0 + u) & 31;
        const int ik = __shfl_sync(0xffffffffu, i, k);
        const float m = __shfl_sync(0xffffffffu, mq, k);
        da[u] = d2[u] = 0.f;
        if constexpr (kBf) dm[u] = 0.f;
        if (has_ch && k0 + u < cnt) {
          const float* cf = coef + (size_t)ik * 3 * c + lane;
          if constexpr (kBf) {
            da[u] = __ldg(cf + c);
            if (m != 0.f) dm[u] = __ldg(cf);
          } else {
            da[u] = __ldg(cf + (m != 0.f ? 0 : c));
          }
          d2[u] = __ldg(cf + 2 * c);
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int k = (k0 + u) & 31;
        const float w00 = __shfl_sync(0xffffffffu, wq.x, k);
        const float w01 = __shfl_sync(0xffffffffu, wq.y, k);
        const float w10 = __shfl_sync(0xffffffffu, wq.z, k);
        const float w11 = __shfl_sync(0xffffffffu, wq.w, k);
        if (k0 + u >= cnt) break;  // uniform over the warp
        // the forward's sample ((t00 w00 + t01 w01) + t10 w10) + t11 w11
        float f = __fmul_rn(t00, w00);
        f = __fadd_rn(f, __fmul_rn(t01, w01));
        f = __fadd_rn(f, __fmul_rn(t10, w10));
        f = __fadd_rn(f, __fmul_rn(t11, w11));
        if constexpr (kBf) {
          f = bf16r(f);
          float df = __fadd_rn(da[u], __fmul_rn(__fmul_rn(2.f, f), d2[u]));
          if (__shfl_sync(0xffffffffu, mq, k) != 0.f)
            df = __fadd_rn(df, dm[u]);
          df = bf16r(df);
          a00 = bf16r(__fadd_rn(a00, bf16r(__fmul_rn(df, w00))));
          a01 = bf16r(__fadd_rn(a01, bf16r(__fmul_rn(df, w01))));
          a10 = bf16r(__fadd_rn(a10, bf16r(__fmul_rn(df, w10))));
          a11 = bf16r(__fadd_rn(a11, bf16r(__fmul_rn(df, w11))));
        } else {
          const float df =
              __fadd_rn(da[u], __fmul_rn(__fmul_rn(2.f, f), d2[u]));
          a00 = __fadd_rn(a00, __fmul_rn(df, w00));
          a01 = __fadd_rn(a01, __fmul_rn(df, w01));
          a10 = __fadd_rn(a10, __fmul_rn(df, w10));
          a11 = __fadd_rn(a11, __fmul_rn(df, w11));
        }
      }
    }
  }
  if (has_ch) {
    out[0] = a00;
    out[c] = a01;
    out[2 * c] = a10;
    out[3 * c] = a11;
  }
}

// ---- pass 2: the windows into texels -------------------------------------

// Thread t: texel t / (C / kW), channels kW (t % (C / kW)) + e, e < kW.
template <int kW>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const float* __restrict__ packed,
                  const int* __restrict__ off, float* __restrict__ d_feats,
                  int n_views, int fh, int fw, int c) {
  using Vec = typename std::conditional<kW == 4, float4, float>::type;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int hw = fh * fw, groups = c / kW;
  if (t >= (long long)n_views * hw * groups) return;
  const int ch = (int)(t % groups) * kW;
  const int texel = (int)(t / groups);
  const int v = texel / hw, idx = texel - v * hw;
  const int y = idx / fw, x = idx - y * fw;
  const float* pv = packed + (size_t)v * hw * 4 * c + ch;
  const int* ov = off + (size_t)v * hw;
  const size_t stride = 4 * (size_t)c;
  float s[kW];
#pragma unroll
  for (int e = 0; e < kW; ++e) s[e] = 0.f;
  // tap j of window k, where the window holds a pair (+0 + x is x: a
  // window's sum is never -0)
  auto add = [&](int k, int j) {
    if (__ldg(ov + k + 1) == __ldg(ov + k)) return;
    const Vec q = __ldg(
        reinterpret_cast<const Vec*>(pv + (size_t)k * stride + j * c));
    const float* qa = reinterpret_cast<const float*>(&q);
#pragma unroll
    for (int e = 0; e < kW; ++e) s[e] = __fadd_rn(s[e], qa[e]);
  };
  add(idx, 0);
  if (x > 0) add(idx - 1, 1);
  if (y > 0) add(idx - fw, 2);
  if (x > 0 && y > 0) add(idx - fw - 1, 3);
  float* out = d_feats + (size_t)texel * c + ch;
  if constexpr (kW == 4)
    *reinterpret_cast<float4*>(out) = make_float4(s[0], s[1], s[2], s[3]);
  else
    out[0] = s[0];
}

// The bfloat16 unpack: thread t, texel t / (C / kW), channels kW (t % (C /
// kW)) + e; the windows in the order (y-1, x).10, (y-1, x-1).11, (y,
// x-1).01, (y, x).00, each sum rounded; an empty window adds nothing
// (its taps are +0, and rounding a bfloat16 value leaves it).
template <int kW>
__global__ void __launch_bounds__(kThreads)
    unpack_bf16_kernel(const float* __restrict__ packed,
                       const int* __restrict__ off,
                       uint16_t* __restrict__ d_feats, int n_views, int fh,
                       int fw, int c) {
  using Vec = typename std::conditional<kW == 4, float4, float>::type;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int hw = fh * fw, groups = c / kW;
  if (t >= (long long)n_views * hw * groups) return;
  const int ch = (int)(t % groups) * kW;
  const int texel = (int)(t / groups);
  const int v = texel / hw, idx = texel - v * hw;
  const int y = idx / fw, x = idx - y * fw;
  const float* pv = packed + (size_t)v * hw * 4 * c + ch;
  const int* ov = off + (size_t)v * hw;
  const size_t stride = 4 * (size_t)c;
  float s[kW];
#pragma unroll
  for (int e = 0; e < kW; ++e) s[e] = 0.f;
  auto add = [&](int k, int j) {
    if (__ldg(ov + k + 1) == __ldg(ov + k)) return;
    const Vec q = __ldg(
        reinterpret_cast<const Vec*>(pv + (size_t)k * stride + j * c));
    const float* qa = reinterpret_cast<const float*>(&q);
#pragma unroll
    for (int e = 0; e < kW; ++e) s[e] = bf16r(__fadd_rn(s[e], qa[e]));
  };
  if (y > 0) add(idx - fw, 2);
  if (x > 0 && y > 0) add(idx - fw - 1, 3);
  if (x > 0) add(idx - 1, 1);
  add(idx, 0);
  uint16_t* out = d_feats + (size_t)texel * c + ch;
  if constexpr (kW == 4) {
    *reinterpret_cast<uint2*>(out) = make_uint2(
        bf16_bits(s[0]) | (unsigned)bf16_bits(s[1]) << 16,
        bf16_bits(s[2]) | (unsigned)bf16_bits(s[3]) << 16);
  } else {
    out[0] = bf16_bits(s[0]);
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Pass 0. pts (N, 3); proj (V, 4, 4); g and globalfeat (N, 2(3 + C)); s1u
// (N, C), the feature channels' unmasked sums; cnt (N,), the count the
// forward's statistics used; outputs keys (V, N) int32 and coef (N, 3, C),
// its rows laid out for bfloat16 maps where bf16 is set. (h, w) is the
// image size the projection lives in, fsx, fsy scale its pixels into the
// (FH, FW) maps. Everything contiguous, 1 <= C <= 32, V N < 2^31. Returns
// the first cudaError_t of the launches.
extern "C" int streaming_sample_mean_var_backward_keys(
    const float* pts, const float* proj, const float* g, const float* gf,
    const float* s1u, const float* cnt, int* keys, float* coef, int n,
    int n_views, int fh, int fw, int c, int h, int w, float fsx, float fsy,
    int bf16, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_views == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  keys_kernel<<<blocks_for((long long)n * n_views), kThreads, 0, s>>>(
      pts, proj, keys, n, n_views, fh, fw, (float)(h - 1), (float)(w - 1),
      fsx, fsy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16)
    coef_kernel<true><<<blocks_for((long long)n * c), kThreads, 0, s>>>(
        g, gf, s1u, cnt, coef, n, n_views, c);
  else
    coef_kernel<false><<<blocks_for((long long)n * c), kThreads, 0, s>>>(
        g, gf, s1u, cnt, coef, n, n_views, c);
  return static_cast<int>(cudaGetLastError());
}

// The points of a tile of the index preparation: the wrapper sizes its
// scratch by it.
extern "C" int streaming_sample_mean_var_backward_tile() {
  return csort::kTile;
}

// Index preparation. keys (V, N) from pass 0; hist (V, J, FH FW) and
// tile_kept (V, J) int32 scratch, J = ceil(N / tile); order (V N) int32
// out, the kept
// pairs by window in point order (the entries past off[V FH FW]
// unspecified); off (V FH FW + 1) int32 out. Returns the first cudaError_t.
extern "C" int streaming_sample_mean_var_backward_order(
    const int* keys, int* hist, int* tile_kept, int* order, int* off, int n,
    int n_views, int hw, void* stream) {
  return static_cast<int>(csort::sort(
      keys, hist, tile_kept, order, off, nullptr, nullptr, n_views, n, hw,
      -hw, 0, 0, n, static_cast<cudaStream_t>(stream)));
}

// Pass 1: feats (V, FH, FW, C), float32 or (bf16 set) bfloat16; coef from
// pass 0; order and off from the index preparation; packed (V FH FW, 4, C)
// float32, of which it writes the windows that hold a pair.
extern "C" int streaming_sample_mean_var_backward_windows(
    const float* pts, const float* proj, const void* feats,
    const float* coef, const int* order, const int* off, float* packed, int n,
    int n_views, int fh, int fw, int c, int h, int w, float fsx, float fsy,
    int bf16, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = (long long)n_views * fh * fw;
  if (windows == 0 || n == 0) return 0;
  const int blocks = (int)((windows + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    window_kernel<true><<<blocks, kThreads, 0, s>>>(
        pts, proj, static_cast<const uint16_t*>(feats), coef, order, off,
        packed, n, n_views, fh, fw, c, (float)(h - 1), (float)(w - 1), fsx,
        fsy);
  else
    window_kernel<false><<<blocks, kThreads, 0, s>>>(
        pts, proj, static_cast<const float*>(feats), coef, order, off,
        packed, n, n_views, fh, fw, c, (float)(h - 1), (float)(w - 1), fsx,
        fsy);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: d_feats (V, FH, FW, C) out from packed and off, float32 or (bf16
// set) bfloat16.
extern "C" int streaming_sample_mean_var_backward_unpack(
    const float* packed, const int* off, void* d_feats, int n_views, int fh,
    int fw, int c, int bf16, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = (long long)n_views * fh * fw;
  if (windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    uint16_t* out = static_cast<uint16_t*>(d_feats);
    if (c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0)
      unpack_bf16_kernel<4><<<blocks_for(windows * (c / 4)), kThreads, 0,
                              s>>>(packed, off, out, n_views, fh, fw, c);
    else
      unpack_bf16_kernel<1><<<blocks_for(windows * c), kThreads, 0, s>>>(
          packed, off, out, n_views, fh, fw, c);
    return static_cast<int>(cudaGetLastError());
  }
  float* d_out = static_cast<float*>(d_feats);
  if (c % 4 == 0)
    unpack_kernel<4><<<blocks_for(windows * (c / 4)), kThreads, 0, s>>>(
        packed, off, d_out, n_views, fh, fw, c);
  else
    unpack_kernel<1><<<blocks_for(windows * c), kThreads, 0, s>>>(
        packed, off, d_out, n_views, fh, fw, c);
  return static_cast<int>(cudaGetLastError());
}
