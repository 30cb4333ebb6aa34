// K2: the whole streaming_sample_mean_var (view-streaming ray sampler
// and its statistics) in one kernel.
//
// Replaces the lax.scan over views in nerfdet_tpu/ops/render.py
// (streaming_sample_mean_var, scan body `body`, and the statistics after
// it) with its packed bilinear gathers (nerfdet_tpu/ops/grid_sample.py:
// grid_sample_2d_packed). For every sample point n and source view v, in
// view order, it projects the point with proj[v] = K4 @ pose, samples
// the denormalized image (3 channels) and the mapped feature map (C
// channels) bilinearly with zero padding, and accumulates in registers,
// with f = [rgb, features]:
//
//   s1u += f      s2u += f * f      (every view, masked or not)
//   s1m += f * m  cnt += m          (m = inside img_hw and in front)
//
// then writes only globalfeat = [mean, exp(-var)] (N, 2(3 + C)) and
// pixel_mask = cnt > 1 (N,), with the plain epilogue's order
// (ops/render.py: sample_stats):
//
//   denom = cnt + 1e-8   mean = s1m / denom
//   var = (s2u - (2 mean) s1u + (V mean) mean) / denom
//
// The bilinear window starts at clip(floor(p), 0, size - 1) and its taps
// weigh max(0, 1 - |p - start - k|), so a coordinate in (-1, 0) or
// (size - 1, size) keeps a partial weight on its one tap in the map; a
// tap past the right or bottom edge reads zero.
//
// What bounds it on an H100 at the render path's shape (a chunk of 2048
// rays x 64 samples, 50 views, 240x320 images, 59x80x32 feature maps):
// 6.55 M (point, view) pairs of ~470 FLOP = 3.1 GFLOP, ~0.05 ms at the
// 67 TFLOP/s of fp32 CUDA cores, against ~0.03 ms to read the maps once
// and write globalfeat. What it waits on is issuing the gathers and the
// separately rounded tap arithmetic: 4 taps x 35 channels a pair, ~3.7 GB
// from L1/L2 a chunk (bfloat16: half the bytes). With every gather
// replaced by arithmetic on the address (kernel_ab.py --ablate) the
// bfloat16 eval form keeps ~70% of its time: the projection of each
// pair, the widening of each texel and the sums are the larger part.
//
// Design: a block owns a tile of 64 consecutive points and loops over
// all views inside the kernel. Each (point, view) is projected once, by
// one of the block's 256 threads (four views a round), into a tap table
// in shared memory: both windows' start pixels, tap weights, edge flags
// and the mask. The table is double-buffered: a round projects the next
// four views while it accumulates the current four, one barrier a round.
// Each warp owns 8 consecutive points. A lane loads kVec channels of a
// tap with one load of 16 bytes where the maps allow it: 4 float32
// channels (kVec = 4: 8 lanes a point, a warp 4 points an instruction,
// each group of 8 lanes accumulating 2 consecutive points), or 8
// bfloat16 channels (kVec = 8: 4 lanes a point, a warp 8 points an
// instruction, a group its one point). That needs C % kVec == 0 and
// 16-byte aligned maps; bfloat16 maps that are only 8-byte aligned, or
// whose C is 4 (mod 8), load 4 channels in 8 bytes (kVec = 4), and any
// other C one channel a lane (kVec = 1: lane c takes channel c of all 8
// points). The shape picks the form; each is the same template. Texels
// stay packed in registers until their channel's arithmetic. A point
// whose feature window is that of the group's previous point reuses its
// four taps from registers instead of loading them again; the test reads
// the tap table, so it is uniform over the lanes that share the point.
// Lanes 3p + k take rgb channel k of the group's point p, lanes p its
// count. The statistics are computed in the lanes that hold the sums;
// nothing but the maps, the points, globalfeat and the mask touches
// device memory.
//
// Every sum is rounded on its own, in the order of the plain PyTorch
// version (ray_view_carry_plain, then sample_stats), and the exponential
// is expf, so the kernel equals it bit for bit. Where a product is exact
// in float32, its multiply and the add after it are one fused
// multiply-add, which then rounds exactly as the two did:
//
//   fmaf(a, b, s) = round(s + a b) = round(s + round(a b)) when a b is a
//   float32 value.
//
// That holds for f m (m is 0 or 1) in s1m, in both dtypes. At bfloat16 it
// also holds for each feature tap's t w (the texel and the weight both
// bfloat16: 8-bit significands, so their product has at most 16
// significant bits, within float32's 24) and for f f in s2u (f rounded to
// bfloat16 first). The one exception is a product below float32's normal
// range (|a b| < 2^-126), which the separate multiply rounds to a
// subnormal first: there the fused form can differ in the last bit.
// float32 feature taps and s2u, and the rgb taps (float32 weights, as
// JAX's f32_taps) keep their separately rounded products.
//
// Two forms, one template (kHost): the eval form samples the images' rgb
// in the kernel; the training form (the precomputed_rgb branch of the
// JAX function) takes the rgb sums and the count from the host
// (data/ray_stats.host_ray_rgb_stats), samples only the C feature
// channels, and computes every channel's statistics with the host count,
// as the JAX function does. Under autograd either form also writes what
// K2's backward (csrc/streaming_sample_mean_var_backward.cu) needs beside
// globalfeat: the feature channels' unmasked sums s1u (N, C) and, in the
// eval form, its count (N, 1).
//
// bfloat16 (kBf, the bf16 compute path of the JAX package): the feature maps
// and the images are bfloat16, read as their 16 bits and widened to float
// exactly (a 16-byte tap load holds 8 channels). The taps round as JAX's
// grid_sample_2d_packed on bfloat16 maps: a feature tap rounds its four
// weights to bfloat16 (exact products, fused with the float sums as above)
// and its sum to bfloat16; an rgb tap keeps float weights and rounds only
// its sum. Both to nearest even (two channels' sums in one conversion,
// __floats2bfloat162_rn). The sums and the epilogue stay float32, so the
// kernel still equals its plain version bit for bit. The bound is the
// float32 form's (operations, 3.1 GFLOP a chunk); the bytes fall from 0.12
// to 0.08 GB and were never the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPts = 8;                   // points per warp
constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;     // 256
constexpr int kTile = kPts * kWarps;      // 64 points per block
constexpr int kViews = kThreads / kTile;  // views projected per round
// Blocks an SM the compiler must fit (registers a thread: 85 for 3, 64
// for 4). Four for the training forms of the 16-byte lane mappings, which
// run faster so (the float32 one despite a few spilled registers), three
// elsewhere: the eval forms hold the rgb sums too and lose at 64.
template <int kVec, bool kHost, bool kBf>
constexpr int min_blocks() {
  return kHost && kVec == (kBf ? 8 : 4) ? 4 : 3;
}

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

// x rounded to bfloat16, to nearest even, as a float.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 bf16r(float4 w) {
  return make_float4(bf16r(w.x), bf16r(w.y), bf16r(w.z), bf16r(w.w));
}

// ((t0 * w.x + t1 * w.y) + t2 * w.z) + t3 * w.w, every product and sum
// rounded on its own
__device__ __forceinline__ float blend(float t0, float t1, float t2,
                                       float t3, float4 w) {
  float f = __fmul_rn(t0, w.x);
  f = __fadd_rn(f, __fmul_rn(t1, w.y));
  f = __fadd_rn(f, __fmul_rn(t2, w.z));
  return __fadd_rn(f, __fmul_rn(t3, w.w));
}

// blend where every product is exact (bfloat16 texels and weights): the
// same value with each multiply and add fused
__device__ __forceinline__ float blend_exact(float t0, float t1, float t2,
                                             float t3, float4 w) {
  float f = __fmul_rn(t0, w.x);
  f = __fmaf_rn(t1, w.y, f);
  f = __fmaf_rn(t2, w.z, f);
  return __fmaf_rn(t3, w.w, f);
}

__device__ __forceinline__ float widen(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// kVec channels of one tap, as loaded: float32 values, or bfloat16 pairs
// in 32-bit words (channel 2k in the low half of word k), widened to
// float exactly where they are read.
template <typename T, int kVec>
struct Texels;

template <int kVec>
struct Texels<float, kVec> {
  float v[kVec];
  __device__ __forceinline__ void load(const float* p) {  // 16-byte aligned
    if constexpr (kVec == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = 0.f;
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

template <int kVec>
struct Texels<uint16_t, kVec> {
  static constexpr int kWords = (kVec + 1) / 2;
  uint32_t w[kWords];  // kVec == 1: the channel in the high half
  __device__ __forceinline__ void load(const uint16_t* p) {
    if constexpr (kVec == 8) {  // 16-byte aligned
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else if constexpr (kVec == 4) {  // 8-byte aligned
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x;
      w[1] = q.y;
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

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <int kVec>
__device__ __forceinline__ void zero(float (&t)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) t[e] = 0.f;
}

// The epilogue of one channel: (mean, exp(-var)), in sample_stats' order.
__device__ __forceinline__ float2 stats(float s1u, float s2u, float s1m,
                                        float cnt, float n_views) {
  const float denom = __fadd_rn(cnt, 1e-8f);
  const float mean = __fdiv_rn(s1m, denom);
  const float var = __fdiv_rn(
      __fadd_rn(__fsub_rn(s2u, __fmul_rn(__fmul_rn(2.f, mean), s1u)),
                __fmul_rn(__fmul_rn(n_views, mean), mean)),
      denom);
  return make_float2(mean, expf(-var));
}

// The host sums of the training form (null in the eval form).
struct HostRgb {
  const float* s1u;  // (N, 3)
  const float* s2u;  // (N, 3)
  const float* s1m;  // (N, 3)
  const float* cnt;  // (N,)
};

template <bool kBf>
using Elem = typename std::conditional<kBf, uint16_t, float>::type;

template <int kVec, bool kHost, bool kBf>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks<kVec, kHost, kBf>()) k2_kernel(
    const float* __restrict__ pts, const Elem<kBf>* __restrict__ imgs,
    const Elem<kBf>* __restrict__ feats,
    const float* __restrict__ proj,
    HostRgb host, float* __restrict__ gf, uint8_t* __restrict__ mask,
    float* __restrict__ s1u_out, float* __restrict__ cnt_out, int n,
    int n_views, int ih, int iw, int fh, int fw, int c, float h1, float w1,
    float sx, float sy, float fsx, float fsy) {
  using T = Elem<kBf>;
  constexpr int kGroup = 32 / kVec;          // lanes per point
  constexpr int kRun = kPts / kVec;          // points per lane group
  __shared__ Tap taps[2][kViews][kTile];
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
  auto project = [&](int v0, int buf) {
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
      if constexpr (!kHost)
        t.flags = weights(__fmul_rn(px, sx), __fmul_rn(py, sy), ih, iw,
                          &t.wi, &t.img_idx);
      t.flags |= weights(__fmul_rn(px, fsx), __fmul_rn(py, fsy), fh, fw,
                         &t.wf, &t.feat_idx) << 2 |
                 (m ? kMask : 0);
      if constexpr (kBf) t.wf = bf16r(t.wf);
    }
    taps[buf][tv][tp] = t;
  };

  // accumulation roles in lane group g: channels ch .. ch + kVec - 1 of
  // its kRun points q0 ..; rgb channel rc of its point rp (s < 3 kRun);
  // the count of its point s (s < kRun)
  const int g = lane / kGroup;
  const int s = lane % kGroup;
  const int q0 = warp * kPts + g * kRun;
  const int ch = s * kVec;
  const bool has_ch = ch < c;
  const int rp = s / 3;
  const int rc = s - 3 * rp;
  const bool has_rgb = s < 3 * kRun;
  float f1[kRun][kVec], f2[kRun][kVec], fm[kRun][kVec];
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    zero(f1[p]);
    zero(f2[p]);
    zero(fm[p]);
  }
  float r1 = 0.f, r2 = 0.f, rm = 0.f, count = 0.f;
  const size_t img_view = (size_t)ih * iw * 3;
  const size_t feat_view = (size_t)fh * fw * c;
  const int img_row = iw * 3;  // a row of the image, a row of the map
  const int feat_row = fw * c;

  project(0, 0);
  __syncthreads();
  int buf = 0;
  for (int v0 = 0; v0 < n_views; v0 += kViews, buf ^= 1) {
    if (v0 + kViews < n_views) project(v0 + kViews, buf ^ 1);
    const int nv = min(kViews, n_views - v0);
    for (int k = 0; k < nv; ++k) {
      const Tap* tk = taps[buf][k] + q0;
      const int v = v0 + k;
      if (!kHost && has_rgb) {
        const Tap& tr = tk[rp];
        const T* q = imgs + v * img_view + rc + (size_t)tr.img_idx * 3;
        const bool x1 = tr.flags & kImgX1, y1 = tr.flags & kImgY1;
        const float t00 = load1(q);
        const float t01 = x1 ? load1(q + 3) : 0.f;
        const float t10 = y1 ? load1(q + img_row) : 0.f;
        const float t11 = x1 && y1 ? load1(q + img_row + 3) : 0.f;
        float f = blend(t00, t01, t10, t11, tr.wi);
        if constexpr (kBf) f = bf16r(f);
        const float m = tr.flags & kMask ? 1.f : 0.f;
        r1 = __fadd_rn(r1, f);
        r2 = kBf ? __fmaf_rn(f, f, r2) : __fadd_rn(r2, __fmul_rn(f, f));
        rm = __fmaf_rn(f, m, rm);
      }
      if (!kHost && s < kRun)
        count = __fadd_rn(count, tk[s].flags & kMask ? 1.f : 0.f);
      if (has_ch) {
        const auto* fv = feats + v * feat_view + ch;
        Texels<T, kVec> t00, t01, t10, t11;
        int prev = -1;
#pragma unroll
        for (int p = 0; p < kRun; ++p) {
          const int4 head = *reinterpret_cast<const int4*>(&tk[p]);
          const int idx = head.y;  // feat_idx
          const int fl = head.z;   // flags
          const float4 w = tk[p].wf;
          // the edge flags follow from the window's start pixel, so the
          // index alone says whether the taps are those of point p - 1
          if (idx != prev) {
            const T* q = fv + (size_t)idx * c;
            t00.load(q);
            if (fl & kFeatX1) t01.load(q + c);
            else t01.zero();
            if (fl & kFeatY1) t10.load(q + feat_row);
            else t10.zero();
            if ((fl & kFeatX1) && (fl & kFeatY1)) t11.load(q + feat_row + c);
            else t11.zero();
          }
          prev = idx;
          const float m = fl & kMask ? 1.f : 0.f;
          constexpr int kStep = kBf && kVec > 1 ? 2 : 1;
#pragma unroll
          for (int e = 0; e < kVec; e += kStep) {
            float f[kStep];
            if constexpr (kBf) {
              f[0] = blend_exact(t00[e], t01[e], t10[e], t11[e], w);
              if constexpr (kStep == 2) {  // two sums rounded at once
                const __nv_bfloat162 r = __floats2bfloat162_rn(
                    f[0],
                    blend_exact(t00[e + 1], t01[e + 1], t10[e + 1],
                                t11[e + 1], w));
                f[0] = __low2float(r);
                f[1] = __high2float(r);
              } else {
                f[0] = bf16r(f[0]);
              }
            } else {
              f[0] = blend(t00[e], t01[e], t10[e], t11[e], w);
            }
#pragma unroll
            for (int j = 0; j < kStep; ++j) {
              f1[p][e + j] = __fadd_rn(f1[p][e + j], f[j]);
              f2[p][e + j] = kBf ? __fmaf_rn(f[j], f[j], f2[p][e + j])
                                 : __fadd_rn(f2[p][e + j],
                                             __fmul_rn(f[j], f[j]));
              fm[p][e + j] = __fmaf_rn(f[j], m, fm[p][e + j]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next round reads buf ^ 1 and rewrites buf
  }

  // the epilogue, in the lanes that hold the sums; the counts come from
  // the lanes that hold them, or from the host
  const float nvf = (float)n_views;
  const int cs = 3 + c;
  const size_t out_row = 2 * (size_t)cs;
  const int nr = n0 + q0 + rp;
  float rgb_cnt;
  if constexpr (kHost)
    rgb_cnt = has_rgb && nr < n ? __ldg(host.cnt + nr) : 0.f;
  else
    rgb_cnt = __shfl_sync(0xffffffffu, count, g * kGroup + rp);
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const int np = n0 + q0 + p;
    float cnt;
    if constexpr (kHost)
      cnt = has_ch && np < n ? __ldg(host.cnt + np) : 0.f;
    else
      cnt = __shfl_sync(0xffffffffu, count, g * kGroup + p);
    if (has_ch && np < n) {
      float* o = gf + (size_t)np * out_row + 3 + ch;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float2 st = stats(f1[p][e], f2[p][e], fm[p][e], cnt, nvf);
        o[e] = st.x;
        o[cs + e] = st.y;
      }
      if (s1u_out != nullptr) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s1u_out[(size_t)np * c + ch + e] = f1[p][e];
      }
    }
  }
  if (has_rgb && nr < n) {
    if constexpr (kHost) {
      const size_t i = (size_t)nr * 3 + rc;
      r1 = __ldg(host.s1u + i);
      r2 = __ldg(host.s2u + i);
      rm = __ldg(host.s1m + i);
    }
    const float2 st = stats(r1, r2, rm, rgb_cnt, nvf);
    gf[(size_t)nr * out_row + rc] = st.x;
    gf[(size_t)nr * out_row + cs + rc] = st.y;
  }
  const int ns = n0 + q0 + s;
  if (s < kRun && ns < n) {
    if constexpr (kHost) {
      mask[ns] = __ldg(host.cnt + ns) > 1.f;
    } else {
      mask[ns] = count > 1.f;
      if (cnt_out != nullptr) cnt_out[ns] = count;
    }
  }
}

template <int kVec, bool kHost, bool kBf>
void launch(int blocks, cudaStream_t s, const float* pts, const void* imgs,
            const void* feats, const float* proj, HostRgb host, float* gf,
            uint8_t* mask, float* s1u_out, float* cnt_out, int n,
            int n_views, int ih, int iw, int fh, int fw, int c, int h, int w,
            float sx, float sy, float fsx, float fsy) {
  using T = Elem<kBf>;
  k2_kernel<kVec, kHost, kBf><<<blocks, kThreads, 0, s>>>(
      pts, static_cast<const T*>(imgs), static_cast<const T*>(feats), proj,
      host, gf, mask, s1u_out, cnt_out, n, n_views, ih, iw, fh, fw, c,
      (float)(h - 1), (float)(w - 1), sx, sy, fsx, fsy);
}

}  // namespace

// pts (N, 3); imgs (V, IH, IW, 3), or null in the training form, where
// host_s1u, host_s2u, host_s1m (N, 3) and host_cnt (N,) hold the host rgb
// sums and count (all null in the eval form); feats (V, FH, FW, C), 1 <= C
// <= 32; proj (V, 4, 4); outputs globalfeat (N, 2(3 + C)) float32 and
// pixel_mask (N,) bool (one byte), and, where not null, s1u_out (N, C)
// (the feature channels' unmasked sums) and cnt_out (N,) (the eval form's
// count), all contiguous. (h, w) is the image size the projection lives
// in; sx, sy, fsx, fsy scale its pixels into the images and the feature
// maps. With bf16 set, feats and imgs are bfloat16 (the rest float32).
// Feature taps load 16 bytes a lane where C and the maps' alignment allow
// it (4 float32 channels, 8 bfloat16), 8 bytes (4 bfloat16 channels)
// where only that fits, one channel otherwise. The caller checks shapes.
// Returns the cudaError_t of the launch.
extern "C" int streaming_sample_mean_var(
    const float* pts, const void* imgs, const void* feats,
    const float* proj, const float* host_s1u, const float* host_s2u,
    const float* host_s1m, const float* host_cnt, float* gf, uint8_t* mask,
    float* s1u_out, float* cnt_out, int n, int n_views, int ih, int iw,
    int fh, int fw, int c, int h, int w, float sx, float sy, float fsx,
    float fsy, int bf16, void* stream) {
  const int blocks = (n + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HostRgb host = {host_s1u, host_s2u, host_s1m, host_cnt};
  const bool with_host = host_cnt != nullptr;
  if (with_host && (host_s1u == nullptr || host_s2u == nullptr ||
                    host_s1m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(feats);
#define K2_LAUNCH(VEC, BF)                                                  \
  if (with_host)                                                            \
    launch<VEC, true, BF>(blocks, s, pts, imgs, feats, proj, host, gf,      \
                          mask, s1u_out, cnt_out, n, n_views, ih, iw, fh,   \
                          fw, c, h, w, sx, sy, fsx, fsy);                   \
  else                                                                      \
    launch<VEC, false, BF>(blocks, s, pts, imgs, feats, proj, host, gf,     \
                           mask, s1u_out, cnt_out, n, n_views, ih, iw, fh,  \
                           fw, c, h, w, sx, sy, fsx, fsy)
  if (bf16) {
    if (c % 8 == 0 && align % 16 == 0) K2_LAUNCH(8, true);
    else if (c % 4 == 0 && align % 8 == 0) K2_LAUNCH(4, true);
    else K2_LAUNCH(1, true);
  } else {
    if (c % 4 == 0 && align % 16 == 0) K2_LAUNCH(4, false);
    else K2_LAUNCH(1, false);
  }
#undef K2_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
