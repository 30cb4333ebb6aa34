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
// version (ops/render.py: _backward_plain_bf16) follows: per pair df = (d
// s1u + (2 f) d s2u) + m d s1m in JAX's order, f the forward's bfloat16
// sample, rounded to bfloat16; each tap's df w_k (w_k the forward's
// bfloat16 weight) rounded; each window's four sums rounded after every
// add, in point order; then a texel's four windows in the order of the
// transpose of pack_bilinear, tap 10, 11, 01, 00, each sum rounded. All
// roundings to nearest even (__float2bfloat16_rn, or two values in one
// __floats2bfloat162_rn). The design before this one (a warp a window, as
// float32's window_kernel, each pair's three cotangent rows gathered)
// spent its time on the rounding chain and on warps that waited for the
// longest window of their block, not on the gathers (kernel_ab.py
// --ablate-style variants on the H100). So each kept pair's df is formed
// once, point-major, stored at its slot in the windows' order, and the
// window walk streams the slots:
//
// Pass 0 (keys_kernel only: the cotangents are formed in pass 1a).
// Index preparation: the same counting sort, which writes each kept
//   pair's place in the windows' order (its slot, `rank`) instead of the
//   order itself.
// Pass 1a (pair_bf16_kernel): the forward's layout: a block owns 64
//   points and walks every view, each (point, view) projected once into a
//   tap table in shared memory (which also writes a kept pair's four
//   bfloat16 weights to its slot, 8 B); 8 channels a lane in 16-byte
//   loads and stores, 4 lanes a point, the points' d s1m, d s1u and d s2u
//   in registers (coef_kernel's arithmetic). For each kept pair it
//   gathers the window's four taps from the maps (15 MB of bfloat16,
//   L2-resident), forms df and stores it as bfloat16 (exact: df is a
//   bfloat16 value) at the pair's slot, 64 B at C = 32.
// Pass 1b (window_bf16_kernel): the slots cut into equal shares, a warp
//   takes the windows whose first slot lies in a share and streams their
//   slots through a ring of stages in shared memory filled by 16-byte
//   cp.async copies (64-byte rows loaded a lane at a time kept too few
//   bytes in flight), lane c channel c, each window's run of slots in a
//   stage 4 at a time; each window's sums rounded as above and written as
//   bfloat16 (exact), only for the windows that hold a pair. Equal shares
//   keep the ~1,100-slot windows from holding a block.
// Pass 2 (unpack_bf16_kernel): the four windows of a texel, from the
//   bfloat16 windows, in the order above.
//
// At the training path's shape that moves 4.20 M x 72 B = 302 MB through
// the slots, written once and read once, and 60 MB of packed windows each
// way, against the 1.6 GB of cotangent rows the window walk gathered and
// the 121 MB float32 windows. The least traffic is 202 MB (0.060 ms): the
// maps and their gradient move half the bytes. The passes are bound by
// their instruction count: the projections, taps and roundings of 6.55 M
// pairs in pass 1a, ~30 instructions a slot in pass 1b.
//
// Summation order: per window its pairs in slot order, which is ascending
// point order; so the result is the design before this one's, bit for bit.

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

// a and b rounded to bfloat16, to nearest even, as floats: one
// conversion for the two.
__device__ __forceinline__ void bf16r2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&h);
  a = __uint_as_float(u << 16);  // a in the low half
  b = __uint_as_float(u & 0xffff0000u);
}

// A float that holds a bfloat16 value, as its 16 bits.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return static_cast<unsigned short>(__float_as_uint(x) >> 16);
}

// A bfloat16 value widened to float (exact).
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
  int edge;  // kX1 where the right taps lie in the map, kY1 the bottom ones
};

constexpr int kX1 = 1, kY1 = 2;

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
  q.edge = (x0 + 1 < fw ? kX1 : 0) | (y0 + 1 < fh ? kY1 : 0);
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

// Point i's cotangents of channel ch: d s1m, d s1u, d s2u. stat_views is
// the V of the statistics, every view of the scene: more than the views
// of this launch's maps where the views are sharded over ranks.
__device__ __forceinline__ void cotangents(const float* g, const float* gf,
                                           const float* s1u, const float* cnt,
                                           int i, int ch, int stat_views,
                                           int c, float* d_s1m, float* d_s1u,
                                           float* d_s2u) {
  const int cs = 3 + c;
  const size_t at = (size_t)i * 2 * cs + 3 + ch;
  const float g_mean = __ldg(g + at), g_e = __ldg(g + at + cs);
  const float mean = __ldg(gf + at), e = __ldg(gf + at + cs);
  const float su = __ldg(s1u + (size_t)i * c + ch);
  const float d = __fadd_rn(__ldg(cnt + i), 1e-8f);
  const float g_var = -__fmul_rn(g_e, e);
  const float slope = __fsub_rn(__fmul_rn(2.f * (float)stat_views, mean),
                                __fmul_rn(2.f, su));
  *d_s1m =
      __fdiv_rn(__fadd_rn(g_mean, __fdiv_rn(__fmul_rn(g_var, slope), d)), d);
  *d_s1u = __fdiv_rn(__fmul_rn(__fmul_rn(-2.f, mean), g_var), d);
  *d_s2u = __fdiv_rn(g_var, d);
}

// Thread t of the grid: point t / C, channel t % C. Rows (d s1u + d s1m,
// d s1u, d s2u).
__global__ void __launch_bounds__(kThreads)
    coef_kernel(const float* __restrict__ g, const float* __restrict__ gf,
                const float* __restrict__ s1u, const float* __restrict__ cnt,
                float* __restrict__ coef, int n, int stat_views, int c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * c) return;
  const int i = (int)(t / c), ch = (int)(t % c);
  float d_s1m, d_s1u, d_s2u;
  cotangents(g, gf, s1u, cnt, i, ch, stat_views, c, &d_s1m, &d_s1u, &d_s2u);
  float* out = coef + (size_t)i * 3 * c + ch;
  out[0] = __fadd_rn(d_s1u, d_s1m);  // a pair the view sees
  out[c] = d_s1u;                    // one it does not
  out[2 * c] = d_s2u;
}

// ---- pass 1: a warp a window ---------------------------------------------

constexpr int kDepth = 8;  // pairs whose cotangent rows are loaded ahead

__global__ void __launch_bounds__(kThreads)
    window_kernel(const float* __restrict__ pts,
                  const float* __restrict__ proj,
                  const float* __restrict__ feats,
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
  const float* fv = feats + (size_t)v * hw * c + lane;
  float t00 = 0.f, t01 = 0.f, t10 = 0.f, t11 = 0.f;
  if (has_ch) {
    t00 = __ldg(fv + (size_t)idx * c);
    if (x1) t01 = __ldg(fv + (size_t)(idx + 1) * c);
    if (y1) t10 = __ldg(fv + (size_t)(idx + fw) * c);
    if (x1 && y1) t11 = __ldg(fv + (size_t)(idx + fw + 1) * c);
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
      mq = q.m ? 1.f : 0.f;
    }
    for (int k0 = 0; k0 < cnt; k0 += kDepth) {
      // the row this pair reads: d s1u + d s1m where the view sees the
      // point, else d s1u; and d s2u
      float da[kDepth], d2[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int k = (k0 + u) & 31;
        const int ik = __shfl_sync(0xffffffffu, i, k);
        const float m = __shfl_sync(0xffffffffu, mq, k);
        da[u] = d2[u] = 0.f;
        if (has_ch && k0 + u < cnt) {
          const float* cf = coef + (size_t)ik * 3 * c + lane;
          da[u] = __ldg(cf + (m != 0.f ? 0 : c));
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
        const float df =
            __fadd_rn(da[u], __fmul_rn(__fmul_rn(2.f, f), d2[u]));
        a00 = __fadd_rn(a00, __fmul_rn(df, w00));
        a01 = __fadd_rn(a01, __fmul_rn(df, w01));
        a10 = __fadd_rn(a10, __fmul_rn(df, w10));
        a11 = __fadd_rn(a11, __fmul_rn(df, w11));
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

// ---- bfloat16 maps: pass 1a, each kept pair's df formed once --------------

// Four bfloat16 values, as floats that hold them, in 8 bytes.
__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  return make_uint2(bf16_bits(a) | (unsigned)bf16_bits(b) << 16,
                    bf16_bits(c) | (unsigned)bf16_bits(d) << 16);
}

constexpr int kPts = 8;                   // points a warp
constexpr int kTile = kPts * kWarps;      // points a block
constexpr int kViews = kThreads / kTile;  // views projected a round
constexpr int kKept = 4, kSeen = 8;       // flags beside kX1, kY1

// One (point, view) of pass 1a's tap table: its window's start texel,
// edge flags, whether it is kept and seen, its slot and its four
// bfloat16 weights.
struct PairTap {
  int idx;
  int flags;
  int slot;
  int pad;
  float4 w;
};

// kVec bfloat16 channels of one texel, loaded as 16-bit words, widened
// to float exactly where read.
template <int kVec>
struct Texels {
  static constexpr int kWords = (kVec + 1) / 2;
  uint32_t w[kWords];  // kVec == 1: the channel in the high half
  __device__ __forceinline__ void load(const uint16_t* p) {
    if constexpr (kVec == 8) {  // 16-byte aligned
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else {
      w[0] = static_cast<uint32_t>(
                 __ldg(reinterpret_cast<const unsigned short*>(p)))
             << 16;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float operator[](int e) const {
    if constexpr (kVec == 1) return __uint_as_float(w[0]);
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u
                                 : w[e >> 1] << 16);
  }
};

// x[0 .. kN) rounded to bfloat16 in place, two values a conversion
// (unpacked by __low2float / __high2float: in pass 1a the shift-and-mask
// form of bf16r2 compiled 17% slower on the H100)
template <int kN>
__device__ __forceinline__ void round_all(float* x) {
  if constexpr (kN == 1) {
    x[0] = bf16r(x[0]);
  } else {
#pragma unroll
    for (int e = 0; e < kN; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[e], x[e + 1]);
      x[e] = __low2float(h);
      x[e + 1] = __high2float(h);
    }
  }
}

// The forward's layout (csrc/streaming_sample_mean_var.cu): a block owns
// kTile consecutive points and walks all views; each (point, view) is
// projected once, by one thread, into a double-buffered tap table in
// shared memory (kViews views a round), which also writes a kept pair's
// four weights to its slot. A lane group of 32 / kVec lanes takes kPts /
// kVec of the warp's points, kVec channels a lane (kVec = 8: 16-byte
// loads and stores, 4 lanes a point; kVec = 1: lane c channel c of each
// of the warp's points in turn), and keeps their cotangents in registers.
// For each kept pair it loads the window's four taps, forms df and stores
// it at the pair's slot.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    pair_bf16_kernel(const float* __restrict__ pts,
                     const float* __restrict__ proj,
                     const uint16_t* __restrict__ feats,
                     const float* __restrict__ g, const float* __restrict__ gf,
                     const float* __restrict__ s1u,
                     const float* __restrict__ cnt,
                     const int* __restrict__ rank, uint16_t* __restrict__ df,
                     uint2* __restrict__ wts, int n, int n_views,
                     int stat_views, int fh, int fw, int c, float h1,
                     float w1, float fsx, float fsy) {
  constexpr int kGroup = 32 / kVec;  // lanes a point
  constexpr int kRun = kPts / kVec;  // points a lane group
  __shared__ PairTap taps[2][kViews][kTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTile;

  // projection role: point tp of the tile, view v0 + tv of each round
  const int tp = tid % kTile, tv = tid / kTile;
  const bool has_pt = n0 + tp < n;
  float pt[3] = {0.f, 0.f, 0.f};
  if (has_pt) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pt[k] = __ldg(pts + (size_t)(n0 + tp) * 3 + k);
  }
  auto project_round = [&](int v0, int buf) {
    PairTap t = {0, 0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
    const int v = v0 + tv;
    if (has_pt && v < n_views) {
      float pv[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) pv[k] = __ldg(proj + 16 * v + k);
      const Pair q = project(pv, pt, h1, w1, fh, fw, fsx, fsy);
      if (!(q.w.x == 0.f && q.w.y == 0.f && q.w.z == 0.f &&
            q.w.w == 0.f)) {  // kept: the forward's bfloat16 weights
        t.idx = q.idx;
        t.flags = q.edge | kKept | (q.m ? kSeen : 0);
        t.slot = __ldg(rank + (size_t)v * n + n0 + tp);
        t.w = make_float4(bf16r(q.w.x), bf16r(q.w.y), bf16r(q.w.z),
                          bf16r(q.w.w));
        wts[t.slot] = pack4(t.w.x, t.w.y, t.w.z, t.w.w);
      }
    }
    taps[buf][tv][tp] = t;
  };

  // accumulation role: lane group gq, channels ch .. ch + kVec - 1 of
  // points q0 .. q0 + kRun - 1 of the tile
  const int gq = lane / kGroup;
  const int ch = (lane % kGroup) * kVec;
  const int q0 = warp * kPts + gq * kRun;
  const bool has_ch = ch < c;
  float d1m[kRun][kVec], d1u[kRun][kVec], d2u[kRun][kVec];
#pragma unroll
  for (int p = 0; p < kRun; ++p)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      d1m[p][e] = d1u[p][e] = d2u[p][e] = 0.f;
      if (has_ch && n0 + q0 + p < n)
        cotangents(g, gf, s1u, cnt, n0 + q0 + p, ch + e, stat_views, c,
                   &d1m[p][e], &d1u[p][e], &d2u[p][e]);
    }
  const size_t feat_view = (size_t)fh * fw * c;
  const int feat_row = fw * c;

  project_round(0, 0);
  __syncthreads();
  int buf = 0;
  for (int v0 = 0; v0 < n_views; v0 += kViews, buf ^= 1) {
    if (v0 + kViews < n_views) project_round(v0 + kViews, buf ^ 1);
    const int nv = min(kViews, n_views - v0);
    for (int k = 0; k < nv; ++k) {
      const uint16_t* fv = feats + (v0 + k) * feat_view + ch;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        const PairTap& t = taps[buf][k][q0 + p];
        const int fl = t.flags;
        if (!(fl & kKept) || !has_ch) continue;
        const uint16_t* q = fv + (size_t)t.idx * c;
        Texels<kVec> t00, t01, t10, t11;
        t00.load(q);
        if (fl & kX1) t01.load(q + c);
        else t01.zero();
        if (fl & kY1) t10.load(q + feat_row);
        else t10.zero();
        if ((fl & kX1) && (fl & kY1)) t11.load(q + feat_row + c);
        else t11.zero();
        const float4 w = t.w;
        // the forward's sample ((t00 w00 + t01 w01) + t10 w10) + t11 w11
        // rounded to bfloat16 (two channels a conversion), then df
        float f[kVec], out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          f[e] = __fmul_rn(t00[e], w.x);
          f[e] = __fadd_rn(f[e], __fmul_rn(t01[e], w.y));
          f[e] = __fadd_rn(f[e], __fmul_rn(t10[e], w.z));
          f[e] = __fadd_rn(f[e], __fmul_rn(t11[e], w.w));
        }
        round_all<kVec>(f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          out[e] = __fadd_rn(d1u[p][e], __fmul_rn(__fmul_rn(2.f, f[e]),
                                                  d2u[p][e]));
          if (fl & kSeen) out[e] = __fadd_rn(out[e], d1m[p][e]);
        }
        uint16_t* o = df + (size_t)t.slot * c + ch;
        if constexpr (kVec == 8) {
          uint32_t word[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(out[2 * k], out[2 * k + 1]);
            word[k] = *reinterpret_cast<const uint32_t*>(&h);
          }
          *reinterpret_cast<uint4*>(o) =
              make_uint4(word[0], word[1], word[2], word[3]);
        } else {
          o[0] = bf16_bits(bf16r(out[0]));
        }
      }
    }
    __syncthreads();  // before the other buffer is projected into again
  }
}

// ---- bfloat16 maps: pass 1b, the slots streamed by window ------------------

constexpr int kSlots = 32;  // slots a stage
constexpr int kRing = 4;    // stages a warp: kRing - 1 in flight
constexpr int kShares = 4;  // shares of the slots a warp takes in turn

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// The bytes of a stage's df rows in shared memory: kSlots rows of C
// bfloat16 values, from the 16-byte boundary at or below the first.
__host__ __device__ constexpr int stage_bytes(int c) {
  return (kSlots * c * 2 + 16 + 15) / 16 * 16;
}

// The first index k in [lo, hi] with off[k] >= x (off non-decreasing,
// off[hi] >= x), found by the warp 32 probes a round.
__device__ __forceinline__ int lower_bound(const int* off, int lo, int hi,
                                           int x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int k = min(lo + lane * step, hi);
    // probes 0 .. t - 1 lie below x, probe t (if any) does not
    const int t = __popc(__ballot_sync(0xffffffffu, __ldg(off + k) < x));
    if (t == 0) return lo;
    hi = min(lo + t * step, hi);
    lo += (t - 1) * step + 1;
  }
  const int k = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, k < hi && __ldg(off + k) < x));
}

// The slots are cut into kShares shares a warp of the grid; warp gw takes
// shares gw, gw + warps, ..., and for each the windows whose first slot
// lies in it, streaming their slots in order through a ring of kRing
// stages of kSlots slots in shared memory, filled by 16-byte cp.async
// copies (the df rows, 64 B a slot at C = 32, too narrow to keep enough
// bytes in flight as loads a lane), kRing - 1 stages ahead of the one
// added. Lane c takes channel c; at each window boundary the finished
// window's four sums are written (as bfloat16: exact) and the next
// non-empty window starts. A window's sums run in slot order, each tap
// and each add rounded. `slots` is df's allocation in slots; it holds 8
// values more, so that a stage's last 16-byte copy stays inside it.
__global__ void __launch_bounds__(kThreads)
    window_bf16_kernel(const uint16_t* __restrict__ df,
                       const uint2* __restrict__ wts,
                       const int* __restrict__ off,
                       uint16_t* __restrict__ packed, int windows, int c,
                       int slots) {
  extern __shared__ __align__(16) unsigned char ring_all[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sb = stage_bytes(c);
  unsigned char* ring_df = ring_all + (size_t)wid * kRing * (sb + kSlots * 8);
  uint2* ring_w = reinterpret_cast<uint2*>(ring_df + kRing * sb);
  const int warps = gridDim.x * kWarps;
  const int total = __ldg(off + windows);
  const int shares = warps * kShares;
  const int share = (total + shares - 1) / shares;
  const bool has_ch = lane < c;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(df);
  const long long src_end = ((long long)slots * c * 2 + 15) / 16 * 16;
  for (int sh = blockIdx.x * kWarps + wid; sh < shares; sh += warps) {
    const int s_beg = min(sh * share, total);
    const int s_end = min(s_beg + share, total);
    if (s_beg >= s_end) break;
    int win = lower_bound(off, 0, windows, s_beg);  // the first window here
    const int last = lower_bound(off, win, windows, s_end);  // past the last
    if (last == win) continue;  // no window starts in this share
    const int j_first = __ldg(off + win), j_end = __ldg(off + last);
    // stage k: slots j_first + k kSlots ..; its df bytes from the 16-byte
    // boundary at or below the first
    auto fill = [&](int k) {
      const int js = j_first + k * kSlots;
      if (js < j_end) {
        unsigned char* dst = ring_df + (k % kRing) * sb;
        const long long lo = (long long)js * c * 2 / 16 * 16;
        const long long hi = min(((long long)(js + kSlots) * c * 2 + 15) /
                                     16 * 16, src_end);
        for (long long b = lo + 16 * lane; b < hi; b += 16 * 32)
          cp_async16(dst + (b - lo), src + b);
        if (js + lane < j_end)
          cp_async8(ring_w + (k % kRing) * kSlots + lane, wts + js + lane);
      }
      cp_async_commit();  // an empty group keeps the count
    };
    // the windows' ends, 32 at a time: lane k holds off[base + k + 1]
    int base = win, ends = __ldg(off + min(base + lane + 1, windows));
    auto end_of = [&](int w) {  // off[w + 1], w >= base
      if (w - base >= 32) {
        base = w;
        ends = __ldg(off + min(base + lane + 1, windows));
      }
      return __shfl_sync(0xffffffffu, ends, w - base);
    };
    int stop = end_of(win);
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    auto flush = [&]() {
      if (has_ch) {
        uint16_t* out = packed + (size_t)win * 4 * c + lane;
        out[0] = bf16_bits(a00);
        out[c] = bf16_bits(a01);
        out[2 * c] = bf16_bits(a10);
        out[3 * c] = bf16_bits(a11);
      }
    };
#pragma unroll
    for (int k = 0; k < kRing - 1; ++k) fill(k);
    for (int k = 0; j_first + k * kSlots < j_end; ++k) {
      fill(k + kRing - 1);
      cp_async_wait_ring();
      __syncwarp();
      const int js = j_first + k * kSlots;
      const long long lo = (long long)js * c * 2 / 16 * 16;
      const unsigned char* sdf = ring_df + (k % kRing) * sb;
      const uint2* sw = ring_w + (k % kRing) * kSlots;
      const int n = min(kSlots, j_end - js);
      // one slot: its df (channel `lane`) and weights, the window's sums
      auto add = [&](const unsigned char* row, uint2 wv) {
        const float d =
            has_ch ? __uint_as_float(
                         static_cast<unsigned>(
                             *reinterpret_cast<const uint16_t*>(row))
                         << 16)
                   : 0.f;
        // each tap rounded, then each sum, two values a conversion
        float p00 = __fmul_rn(d, __uint_as_float(wv.x << 16));
        float p01 = __fmul_rn(d, __uint_as_float(wv.x & 0xffff0000u));
        float p10 = __fmul_rn(d, __uint_as_float(wv.y << 16));
        float p11 = __fmul_rn(d, __uint_as_float(wv.y & 0xffff0000u));
        bf16r2(p00, p01);
        bf16r2(p10, p11);
        a00 = __fadd_rn(a00, p00);
        a01 = __fadd_rn(a01, p01);
        a10 = __fadd_rn(a10, p10);
        a11 = __fadd_rn(a11, p11);
        bf16r2(a00, a01);
        bf16r2(a10, a11);
      };
      for (int u = 0; u < n;) {
        const int j = js + u;
        while (j == stop) {  // the window ends: write it, find the next
          flush();
          a00 = a01 = a10 = a11 = 0.f;
          do {  // empty windows are not written: pass 2 does not read them
            ++win;
            stop = end_of(win);
          } while (stop == j);
        }
        // the window's run of slots in this stage, 4 at a time
        const int run = min(stop, js + n) - j;
        const unsigned char* row =
            sdf + ((long long)j * c * 2 - lo) + 2 * lane;
        const uint2* w = sw + u;
        const int stride = 2 * c;
        int r = 0;
        for (; r + 4 <= run; r += 4) {
          const uint2 w0 = w[r], w1 = w[r + 1], w2 = w[r + 2], w3 = w[r + 3];
          const unsigned char* q = row + r * stride;
          add(q, w0);
          add(q + stride, w1);
          add(q + 2 * stride, w2);
          add(q + 3 * stride, w3);
        }
        for (; r < run; ++r) add(row + r * stride, w[r]);
        u += run;
      }
      __syncwarp();  // before this stage's buffer is filled again
    }
    flush();  // the share's last window
    cp_async_wait_all();  // the empty groups, before the next share's fills
    __syncwarp();
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

// The bfloat16 unpack from the bfloat16 windows: thread t, texel t / (C /
// kW), channels kW (t % (C / kW)) + e; the windows in the order (y-1,
// x).10, (y-1, x-1).11, (y, x-1).01, (y, x).00, each sum rounded; an empty
// window adds nothing (its taps are +0, and rounding a bfloat16 value
// leaves it).
template <int kW>
__global__ void __launch_bounds__(kThreads)
    unpack_bf16_kernel(const uint16_t* __restrict__ packed,
                       const int* __restrict__ off,
                       uint16_t* __restrict__ d_feats, int n_views, int fh,
                       int fw, int c) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int hw = fh * fw, groups = c / kW;
  if (t >= (long long)n_views * hw * groups) return;
  const int ch = (int)(t % groups) * kW;
  const int texel = (int)(t / groups);
  const int v = texel / hw, idx = texel - v * hw;
  const int y = idx / fw, x = idx - y * fw;
  const uint16_t* pv = packed + (size_t)v * hw * 4 * c + ch;
  const int* ov = off + (size_t)v * hw;
  const size_t stride = 4 * (size_t)c;
  float s[kW];
#pragma unroll
  for (int e = 0; e < kW; ++e) s[e] = 0.f;
  auto add = [&](int k, int j) {
    if (__ldg(ov + k + 1) == __ldg(ov + k)) return;
    const uint16_t* q = pv + (size_t)k * stride + j * c;
    float qa[kW];
    if constexpr (kW == 4) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(q));
      qa[0] = __uint_as_float(b.x << 16);
      qa[1] = __uint_as_float(b.x & 0xffff0000u);
      qa[2] = __uint_as_float(b.y << 16);
      qa[3] = __uint_as_float(b.y & 0xffff0000u);
    } else {
      qa[0] = load1(q);
    }
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
// forward's statistics used; stat_views, the V of those statistics (V
// itself unless the views are sharded over ranks); outputs keys (V, N)
// int32 and, where coef is not null (float32 maps), coef (N, 3, C). (h, w) is the image size the
// projection lives in, fsx, fsy scale its pixels into the (FH, FW) maps.
// Everything contiguous, 1 <= C <= 32, V N < 2^31. Returns the first
// cudaError_t of the launches.
extern "C" int streaming_sample_mean_var_backward_keys(
    const float* pts, const float* proj, const float* g, const float* gf,
    const float* s1u, const float* cnt, int* keys, float* coef, int n,
    int n_views, int stat_views, int fh, int fw, int c, int h, int w,
    float fsx, float fsy, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_views == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  keys_kernel<<<blocks_for((long long)n * n_views), kThreads, 0, s>>>(
      pts, proj, keys, n, n_views, fh, fw, (float)(h - 1), (float)(w - 1),
      fsx, fsy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || coef == nullptr) return static_cast<int>(err);
  coef_kernel<<<blocks_for((long long)n * c), kThreads, 0, s>>>(
      g, gf, s1u, cnt, coef, n, stat_views, c);
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
      keys, hist, tile_kept, order, nullptr, off, nullptr, nullptr, n_views,
      n, hw, -hw, 0, 0, n, static_cast<cudaStream_t>(stream)));
}

// The same sort for bfloat16 maps: rank (V N) int32 out, each kept pair's
// place in that order (the dropped pairs' entries unspecified), and off.
extern "C" int streaming_sample_mean_var_backward_rank(
    const int* keys, int* hist, int* tile_kept, int* rank, int* off, int n,
    int n_views, int hw, void* stream) {
  return static_cast<int>(csort::sort(
      keys, hist, tile_kept, nullptr, rank, off, nullptr, nullptr, n_views,
      n, hw, -hw, 0, 0, n, static_cast<cudaStream_t>(stream)));
}

// Pass 1 on float32 maps: feats (V, FH, FW, C); coef from pass 0; order
// and off from the index preparation; packed (V FH FW, 4, C) float32, of
// which it writes the windows that hold a pair.
extern "C" int streaming_sample_mean_var_backward_windows(
    const float* pts, const float* proj, const float* feats,
    const float* coef, const int* order, const int* off, float* packed, int n,
    int n_views, int fh, int fw, int c, int h, int w, float fsx, float fsy,
    void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = (long long)n_views * fh * fw;
  if (windows == 0 || n == 0) return 0;
  const int blocks = (int)((windows + kWarps - 1) / kWarps);
  window_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, proj, feats, coef, order, off, packed, n, n_views, fh, fw, c,
      (float)(h - 1), (float)(w - 1), fsx, fsy);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1a on bfloat16 maps: feats (V, FH, FW, C) bfloat16; g, globalfeat,
// s1u, cnt and stat_views as pass 0 takes them; rank from the index preparation; df
// (slots, C) bfloat16 and wts (slots, 4) bfloat16 out, written at each
// kept pair's slot (slots >= the kept pairs).
extern "C" int streaming_sample_mean_var_backward_pairs(
    const float* pts, const float* proj, const void* feats, const float* g,
    const float* gf, const float* s1u, const float* cnt, const int* rank,
    void* df, void* wts, int n, int n_views, int stat_views, int fh, int fw,
    int c, int h, int w, float fsx, float fsy, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_views == 0) return 0;
  const auto* f = static_cast<const uint16_t*>(feats);
  // 8 channels a lane where C and the maps allow 16-byte loads (df's
  // slots then hold C % 8 == 0 channels, 16-byte aligned), else one
  const bool vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(df) % 16 == 0;
  const int blocks = (n + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    pair_bf16_kernel<8><<<blocks, kThreads, 0, s>>>(
        pts, proj, f, g, gf, s1u, cnt, rank, static_cast<uint16_t*>(df),
        static_cast<uint2*>(wts), n, n_views, stat_views, fh, fw, c,
        (float)(h - 1), (float)(w - 1), fsx, fsy);
  else
    pair_bf16_kernel<1><<<blocks, kThreads, 0, s>>>(
        pts, proj, f, g, gf, s1u, cnt, rank, static_cast<uint16_t*>(df),
        static_cast<uint2*>(wts), n, n_views, stat_views, fh, fw, c,
        (float)(h - 1), (float)(w - 1), fsx, fsy);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1b on bfloat16 maps: packed (windows, 4, C) bfloat16 out from pass
// 1a's df (slots, C), allocated with 8 values more, and wts (slots, 4),
// and the index preparation's off (windows + 1); it writes the windows
// that hold a pair.
extern "C" int streaming_sample_mean_var_backward_windows_bf16(
    const void* df, const void* wts, const int* off, void* packed,
    int windows, int c, int slots, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  const size_t smem = (size_t)kWarps * kRing * (stage_bytes(c) + kSlots * 8);
  cudaError_t err = csort::fit_smem((const void*)window_bf16_kernel, smem);
  if (err == cudaSuccess)  // all the SM's shared memory: blocks by smem
    err = cudaFuncSetAttribute((const void*)window_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  // a persistent grid: the warps the card holds at once share the slots
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_bf16_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_bf16_kernel<<<(per_sm > 0 ? per_sm : 1) * sms, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(df), static_cast<const uint2*>(wts), off,
      static_cast<uint16_t*>(packed), windows, c, slots);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: d_feats (V, FH, FW, C) out from packed and off: float32 windows
// into float32 texels, or (bf16 set) bfloat16 ones into bfloat16 texels.
extern "C" int streaming_sample_mean_var_backward_unpack(
    const void* packed, const int* off, void* d_feats, int n_views, int fh,
    int fw, int c, int bf16, void* stream) {
  if (c < 1 || c > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = (long long)n_views * fh * fw;
  if (windows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const uint16_t* in = static_cast<const uint16_t*>(packed);
    uint16_t* out = static_cast<uint16_t*>(d_feats);
    if (c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0)
      unpack_bf16_kernel<4><<<blocks_for(windows * (c / 4)), kThreads, 0,
                              s>>>(in, off, out, n_views, fh, fw, c);
    else
      unpack_bf16_kernel<1><<<blocks_for(windows * c), kThreads, 0, s>>>(
          in, off, out, n_views, fh, fw, c);
    return static_cast<int>(cudaGetLastError());
  }
  const float* in = static_cast<const float*>(packed);
  float* d_out = static_cast<float*>(d_feats);
  if (c % 4 == 0)
    unpack_kernel<4><<<blocks_for(windows * (c / 4)), kThreads, 0, s>>>(
        in, off, d_out, n_views, fh, fw, c);
  else
    unpack_kernel<1><<<blocks_for(windows * c), kThreads, 0, s>>>(
        in, off, d_out, n_views, fh, fw, c);
  return static_cast<int>(cudaGetLastError());
}
