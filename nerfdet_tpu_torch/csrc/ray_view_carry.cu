// K2: view-streaming ray sampler (the carry of streaming_sample_mean_var).
//
// Replaces the lax.scan over views in nerfdet_tpu/ops/render.py
// (streaming_sample_mean_var, scan body `body`) with its packed bilinear
// gathers (nerfdet_tpu/ops/grid_sample.py: grid_sample_2d_packed). For
// every sample point n and source view v, in view order, it projects the
// point with proj[v] = K4 @ pose, samples the denormalized image (3
// channels) and the mapped feature map (C channels) bilinearly with zero
// padding, and accumulates, with f = [rgb, features]:
//
//   s1u[n] += f      s2u[n] += f * f      (every view, masked or not)
//   s1m[n] += f * m  cnt[n] += m          (m = inside img_hw and in front)
//
// The bilinear window starts at clip(floor(p), 0, size - 1) and its taps
// weigh max(0, 1 - |p - start - k|), so a coordinate in (-1, 0) or
// (size - 1, size) keeps a partial weight on its one tap in the map; a
// tap past the right or bottom edge reads zero.
//
// What bounds it on an H100 at the render path's shape (a chunk of 2048
// rays x 64 samples, 50 views, 240x320 images, 59x80x32 feature maps):
// 6.55 M (point, view) pairs of ~470 FLOP (projection, two windows, 4
// taps and 3 sums per channel) = 3.1 GFLOP, 0.046 ms at the 67 TFLOP/s
// of fp32 CUDA cores, against ~0.04 ms to read the maps once and write
// the accumulators. What it really waits on is the gathers: 4 taps x 35
// channels per pair, ~3.7 GB from L1/L2 per chunk.
//
// Design: a block owns a tile of 64 points and loops over all views
// inside the kernel; every (point, view) is projected once, by one of
// the block's 256 threads (four views a round), into shared memory: the
// two windows' start pixels, tap weights, edge flags and the mask. Each
// warp then owns 8 points: lane c accumulates feature channel c of all 8
// in registers, so a warp's tap read is one 128-byte row (C = 32); lanes
// 0-23 take the 3 rgb channels of the 8 points, lanes 0-7 the counts.
// Nothing but the maps, the points and the final sums touches device
// memory; the (V, R, S, 2) pixel tensor of the JAX scan never exists.
//
// Every product and sum is rounded on its own, in the order of the plain
// PyTorch version (ops/render.py: ray_view_carry_plain), so the kernel
// equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPts = 8;                   // points per warp
constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;     // 256
constexpr int kTile = kPts * kWarps;      // 64 points per block
constexpr int kViews = kThreads / kTile;  // views projected per round

constexpr int kImgX1 = 1, kImgY1 = 2, kFeatX1 = 4, kFeatY1 = 8, kMask = 16;

// One (point, view): both windows' start pixels, tap weights (00, 01, 10,
// 11), which of their right / bottom taps lie in the map, and the mask.
struct Tap {
  int img_idx;
  int feat_idx;
  int flags;
  int pad;
  float4 wi;
  float4 wf;
};

__device__ __forceinline__ float row(const float* p, float x, float y,
                                     float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(p), x),
                                       __fmul_rn(__ldg(p + 1), y)),
                             __fmul_rn(__ldg(p + 2), z)),
                   __ldg(p + 3));
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

__device__ __forceinline__ int weights(float px, float py, int height,
                                       int width, float4* w, int* idx) {
  float wx0, wx1, wy0, wy1;
  const int x0 = window(px, width, &wx0, &wx1);
  const int y0 = window(py, height, &wy0, &wy1);
  *w = make_float4(__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                   __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1));
  *idx = y0 * width + x0;
  return (x0 + 1 < width ? 1 : 0) | (y0 + 1 < height ? 2 : 0);
}

// ((t00 * w00 + t01 * w01) + t10 * w10) + t11 * w11 over a channel of a
// map whose pixels are `stride` floats apart.
__device__ __forceinline__ float bilinear(const float* base, int idx,
                                          int width, int stride, float4 w,
                                          bool x1, bool y1) {
  const float t00 = __ldg(base + (size_t)idx * stride);
  const float t01 = x1 ? __ldg(base + (size_t)(idx + 1) * stride) : 0.f;
  const float t10 = y1 ? __ldg(base + (size_t)(idx + width) * stride) : 0.f;
  const float t11 =
      x1 && y1 ? __ldg(base + (size_t)(idx + width + 1) * stride) : 0.f;
  float f = __fmul_rn(t00, w.x);
  f = __fadd_rn(f, __fmul_rn(t01, w.y));
  f = __fadd_rn(f, __fmul_rn(t10, w.z));
  return __fadd_rn(f, __fmul_rn(t11, w.w));
}

__global__ void __launch_bounds__(kThreads) ray_view_carry_kernel(
    const float* __restrict__ pts, const float* __restrict__ imgs,
    const float* __restrict__ feats, const float* __restrict__ proj,
    float* __restrict__ s1u, float* __restrict__ s2u,
    float* __restrict__ s1m, float* __restrict__ cnt, int n, int n_views,
    int ih, int iw, int fh, int fw, int c, float h1, float w1, float sx,
    float sy, float fsx, float fsy) {
  __shared__ Tap taps[kViews][kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kTile;

  // projection role: point tp of the tile, view v0 + tv of each round
  const int tp = tid % kTile;
  const int tv = tid / kTile;
  const bool has_pt = n0 + tp < n;
  float x = 0.f, y = 0.f, z = 0.f;
  if (has_pt) {
    const float* p = pts + (size_t)(n0 + tp) * 3;
    x = __ldg(p);
    y = __ldg(p + 1);
    z = __ldg(p + 2);
  }

  // accumulation roles: feature channel `lane` of the warp's kPts
  // points; rgb channel rc of point rj (lanes < 3 * kPts); the count of
  // point `lane` (lanes < kPts)
  float f1[kPts], f2[kPts], fm[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) f1[j] = f2[j] = fm[j] = 0.f;
  float r1 = 0.f, r2 = 0.f, rm = 0.f, count = 0.f;
  const int rj = lane / 3;
  const int rc = lane - 3 * rj;
  const size_t img_view = (size_t)ih * iw * 3;
  const size_t feat_view = (size_t)fh * fw * c;

  for (int v0 = 0; v0 < n_views; v0 += kViews) {
    Tap t = {0, 0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f),
             make_float4(0.f, 0.f, 0.f, 0.f)};
    const int v = v0 + tv;
    if (has_pt && v < n_views) {
      const float* pv = proj + 16 * v;
      const float cx = row(pv, x, y, z);
      const float cy = row(pv + 4, x, y, z);
      const float cz = row(pv + 8, x, y, z);
      const float zc = fmaxf(cz, 1e-8f);
      const float px = fminf(fmaxf(__fdiv_rn(cx, zc), -1e6f), 1e6f);
      const float py = fminf(fmaxf(__fdiv_rn(cy, zc), -1e6f), 1e6f);
      const bool m = cz > 0.f && px <= w1 && px >= 0.f && py <= h1 &&
                     py >= 0.f;
      t.flags = weights(__fmul_rn(px, sx), __fmul_rn(py, sy), ih, iw, &t.wi,
                        &t.img_idx) |
                weights(__fmul_rn(px, fsx), __fmul_rn(py, fsy), fh, fw,
                        &t.wf, &t.feat_idx) << 2 |
                (m ? kMask : 0);
    }
    taps[tv][tp] = t;
    __syncthreads();

    const int nv = min(kViews, n_views - v0);
    for (int k = 0; k < nv; ++k) {
      const Tap* tk = taps[k] + warp * kPts;
      if (lane < 3 * kPts) {
        const Tap& tr = tk[rj];
        const float f =
            bilinear(imgs + (v0 + k) * img_view + rc, tr.img_idx, iw, 3,
                     tr.wi, tr.flags & kImgX1, tr.flags & kImgY1);
        const float m = tr.flags & kMask ? 1.f : 0.f;
        r1 = __fadd_rn(r1, f);
        r2 = __fadd_rn(r2, __fmul_rn(f, f));
        rm = __fadd_rn(rm, __fmul_rn(f, m));
      }
      if (lane < kPts) {
        count = __fadd_rn(count, tk[lane].flags & kMask ? 1.f : 0.f);
      }
      if (lane < c) {
        const float* fv = feats + (v0 + k) * feat_view + lane;
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const Tap& tf = tk[j];
          const float f = bilinear(fv, tf.feat_idx, fw, c, tf.wf,
                                   tf.flags & kFeatX1, tf.flags & kFeatY1);
          const float m = tf.flags & kMask ? 1.f : 0.f;
          f1[j] = __fadd_rn(f1[j], f);
          f2[j] = __fadd_rn(f2[j], __fmul_rn(f, f));
          fm[j] = __fadd_rn(fm[j], __fmul_rn(f, m));
        }
      }
    }
    __syncthreads();  // taps is rewritten by the next round
  }

  const int cs = 3 + c;
  const int nw = n0 + warp * kPts;
  if (lane < c) {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (nw + j < n) {
        const size_t o = (size_t)(nw + j) * cs + 3 + lane;
        s1u[o] = f1[j];
        s2u[o] = f2[j];
        s1m[o] = fm[j];
      }
    }
  }
  if (lane < 3 * kPts && nw + rj < n) {
    const size_t o = (size_t)(nw + rj) * cs + rc;
    s1u[o] = r1;
    s2u[o] = r2;
    s1m[o] = rm;
  }
  if (lane < kPts && nw + lane < n) cnt[nw + lane] = count;
}

}  // namespace

// pts (N, 3); imgs (V, IH, IW, 3); feats (V, FH, FW, C), 1 <= C <= 32;
// proj (V, 4, 4); outputs s1u, s2u, s1m (N, 3 + C) and cnt (N,), all
// float32 and contiguous. (h, w) is the image size the projection lives
// in; sx, sy, fsx, fsy scale its pixels into the images and the feature
// maps. The caller checks shapes. Returns the cudaError_t of the launch.
extern "C" int ray_view_carry(const float* pts, const float* imgs,
                              const float* feats, const float* proj,
                              float* s1u, float* s2u, float* s1m, float* cnt,
                              int n, int n_views, int ih, int iw, int fh,
                              int fw, int c, int h, int w, float sx, float sy,
                              float fsx, float fsy, void* stream) {
  const int blocks = (n + kTile - 1) / kTile;
  ray_view_carry_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pts, imgs, feats, proj, s1u, s2u, s1m, cnt, n, n_views, ih, iw, fh,
      fw, c, (float)(h - 1), (float)(w - 1), sx, sy, fsx, fsy);
  return static_cast<int>(cudaGetLastError());
}
