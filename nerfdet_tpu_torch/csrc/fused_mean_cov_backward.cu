// K1's backward: the gradient of the view-streaming fusion carry
// (csrc/fused_mean_cov.cu) with respect to the feature maps, the mapped
// kernel W and the mapped bias b.
//
// Replaces the autodiff of the lax.scan over views in
// nerfdet_tpu/ops/voxel.py (fused_mean_cov, scan body `body`). The forward
// accumulates, for every voxel n over the views v that see it (x the row of
// view v at the voxel's pixel p = pix[v, n], y = x @ W + b, the row P[v, p]
// of phase A),
//
//   s1[n] += x      s2[n] += x * x      s2m[n] += y^2 (y = b where unseen).
//
// Given the cotangents g1, g2 (N, C) and gm (N, M), x and y depend only on
// the (view, pixel), so the backward is factored per pixel as the forward's
// phase A is: with G1, G2, GM the sums of g1, g2, gm over the voxels that
// map to (v, p) and dY = 2 y * GM,
//
//   d feats[v, p] = G1 + 2 x * G2 + dY @ W^T     (zeros where no voxel maps)
//   dW            = sum_(v, p) x^T dY
//   db            = sum_(v, p) dY + 2 b * sum_n (V - count[n]) gm[n]
//
// the last term being the views that do not see voxel n, whose y is b.
//
// What bounds it on an H100 at the training path's shape (50 views of
// 60x80 rows, C = 256, M = 32, 25,600 voxels, no s2 cotangent): bytes. At
// phase 4's pixel indices (34% of the rows referenced) the least traffic
// is 373.9 MB (the d-features map written, 245.8 MB; the referenced rows
// of the maps and of phase A's mapped rows read once; g1, gm and the
// indices), 0.112 ms at 3.35 TB/s, against 3.0 GFLOP (0.045 ms); at the
// intrinsic scaled to ori_shape (85% referenced) 514.7 MB, 0.154 ms. What
// the design moves on top of that: pass 1 gathers each valid (voxel,
// view) pair's 1 KB g1 row and its gm row (1.05 M pairs at phase 4, ~1.1
// GB, from L2: g1 is 26 MB), and pass 2 reads the referenced rows of the
// maps again.
//
// The sums run in a fixed order, so two runs give the same bits; integer
// atomics only count:
//
// Index preparation (csrc/counting_sort.cuh): a stable counting sort of
//   each view's pix over its HW + 1 bins (bin 0 the invalid voxels), which
//   gives order (V, N), each pixel's voxels in ascending order, off (V, HW
//   + 1) from its own scan, and each view's referenced rows, compacted.
// Pass 1 (pixel_kernel): a warp per pixel row, over all V*HW rows (a
//   persistent grid; each warp loads its next row's range while it works
//   on this one). The warp loads up to 32 of the row's voxel indices in
//   one load, hands them out by shuffle and keeps the g1 (g2, gm) rows of
//   kDepth voxels in flight before it adds the first, in ascending voxel
//   order. Lane l holds C / 32 channels (16-byte loads where every row is
//   16-byte aligned) and lane m < M holds GM[m] and dY[m]. The product dY @
//   W^T takes W^T from shared memory, dY[m] by shuffle. It writes the
//   d-features row and, for a referenced row, its dY row.
// Pass 2 (weight_kernel): x^T dY as a product over the compacted
//   referenced rows in f32 FMA (no TF32), split into kParts fixed ranges of
//   them and channel tiles of up to 256. A block resolves its rows' indices
//   into shared memory, then stages kRows rows of x and dY at a time with
//   cp.async, kStages - 1 stages in flight while it computes one; a thread holds a 4 x 8 tile of
//   (channel, mapped output) sums. The first channel tile also sums dY into
//   db and the invalid-view sums (V - count[n]) gm[n] over its range of
//   voxels (a warp every kTile / 32-th voxel, the warps' sums in order).
//   Each block writes its partial sums.
// Pass 3 (reduce_kernel): dW and db as the sums of the partials in block
//   order, 16 partials loaded ahead of their adds.
//
// Summation order: d features as the design before this one, bit for bit
// (each pixel's voxels in ascending voxel order); dW and db per range of
// referenced rows in ascending (view, pixel) order, then the ranges in
// order (the design before summed fixed ranges of all rows).
//
// bfloat16 maps (the bf16 compute path): d features is bfloat16 and rounds
// as XLA's CPU backend runs JAX's transpose of the scan (the plain version,
// ops/voxel.py: _pair_cotangents_bf16, follows it): each (voxel, view)
// pair's float32 cotangent of its row, ((2 x g2) + g1) + (2 y gm) @ W^T in
// JAX's order, is rounded to bfloat16 and added to its pixel in ascending
// voxel order, each sum rounded (__float2bfloat16_rn, to nearest even).
// So pass 1 (pixel_bf16_kernel) does per pair what the float32 pass does
// per pixel: the product with W^T once a pair. dY, dW and db are as for
// float32 maps; pass 2 stages the rows of bfloat16 maps as they are, by
// cp.async, and widens them (exactly) where it reads them.
// That makes the bfloat16 form bound by operations: at phase 8's indices
// (0.72 M valid pairs, 203 K referenced rows) 15.6 GFLOP, 11.8 of them
// the pairs' 2 C M products, against 288 MB (0.23 ms at 67 TFLOP/s).
// Pass 1 runs the products in float32 FMAs on groups of kP pairs that
// share each read of W^T (see pixel_bf16_kernel).
//
// Inputs: float32 or bfloat16 maps, C in {32, 64, 128, 256, 512, 1024},
// 1 <= M <= 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "counting_sort.cuh"

namespace {

constexpr int kMaxMap = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kParts = 256;  // ranges of referenced rows in pass 2
constexpr int kTileMax = 256;
constexpr int kRows = 16;  // rows a stage of pass 2
constexpr int kStages = 4;  // stages of pass 2 in shared memory
constexpr int kIdx = 1024;  // row indices pass 2 resolves at a time

template <int kW>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (kW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (kW == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

// bfloat16 is carried as its 16 bits; widening to float is exact.
template <int kW>
__device__ __forceinline__ void load(const uint16_t* p, float* x) {
  if constexpr (kW == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (kW == 2) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    x[0] = __uint_as_float(v << 16);
    x[1] = __uint_as_float(v & 0xffff0000u);
  } else {
    x[0] = __uint_as_float(
        static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
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

// Floats that hold bfloat16 values, stored as their 16 bits.
template <int kW>
__device__ __forceinline__ void store(uint16_t* p, const float* x) {
  unsigned short b[kW];
#pragma unroll
  for (int e = 0; e < kW; ++e)
    b[e] = static_cast<unsigned short>(__float_as_uint(x[e]) >> 16);
  if constexpr (kW == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(b[0] | (unsigned)b[1] << 16, b[2] | (unsigned)b[3] << 16);
  } else if constexpr (kW == 2) {
    *reinterpret_cast<unsigned*>(p) = b[0] | (unsigned)b[1] << 16;
  } else {
    p[0] = b[0];
  }
}

template <int kW>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (kW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (kW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// ---- pass 1: a warp per pixel row ------------------------------------------

// Lane l holds channels (j * 32 + l) * kW + e, j < kCpl / kW, e < kW.
// kG2: the s2 cotangent is given. Shared memory: W^T [n_map][C] f32 when
// the mapped stream is given.
template <int kCpl, int kW, bool kG2>
__global__ void __launch_bounds__(kThreads, (kG2 || kCpl > 8) ? 1 : 3)
    pixel_kernel(const float* __restrict__ feats,
                 const int* __restrict__ order, const int* __restrict__ off,
                 const float* __restrict__ g1, const float* __restrict__ g2,
                 const float* __restrict__ gm,
                 const float* __restrict__ mapped, const float* __restrict__ w,
                 float* __restrict__ dfeat, float* __restrict__ dy,
                 int n_views, int hw, int n_vox, int n_map) {
  extern __shared__ __align__(16) float wt_s[];
  constexpr int kC = 32 * kCpl;
  constexpr int kPass = kCpl / kW;
  // voxels whose rows are loaded before the first is added
  constexpr int kDepth = kCpl >= 32 ? 1 : (32 / kCpl < 8 ? 32 / kCpl : 8);
  const int lane = threadIdx.x & 31;
  const bool with_m = mapped != nullptr;
  if (with_m) {
    for (int i = threadIdx.x; i < kC * n_map; i += kThreads) {
      const int c = i / n_map, m = i % n_map;
      wt_s[m * kC + c] = w[i];
    }
    __syncthreads();
  }
  const long long rows = (long long)n_views * hw;
  const long long warps = (long long)gridDim.x * kWarps;
  // a row's voxel range, loaded one row ahead
  auto range = [&](long long r, int* beg, int* end) {
    *beg = *end = 0;
    if (r < rows) {
      const int v = (int)(r / hw), p = (int)(r % hw);
      const int* offv = off + (size_t)v * (hw + 1);
      *beg = __ldg(offv + p);
      *end = __ldg(offv + p + 1);
    }
  };
  long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int beg, end;
  range(r, &beg, &end);
  for (; r < rows; r += warps) {
    int next_beg, next_end;
    range(r + warps, &next_beg, &next_end);
    const int v = (int)(r / hw);
    // the row's mapped value, loaded before its voxels
    float y = 0.f;
    if (with_m && lane < n_map && beg < end)
      y = __ldg(mapped + (size_t)r * n_map + lane);
    float a1[kCpl], a2[kCpl];
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      a1[c] = 0.f;
      a2[c] = 0.f;
    }
    float am = 0.f;
    const int* ordv = order + (size_t)v * n_vox;
    for (int i0 = beg; i0 < end; i0 += 32) {
      const int cnt = min(32, end - i0);
      const int mine = lane < cnt ? __ldg(ordv + i0 + lane) : 0;
      for (int k0 = 0; k0 < cnt; k0 += kDepth) {
        float t1[kDepth][kCpl], t2[kG2 ? kDepth : 1][kCpl], tm[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int n = __shfl_sync(0xffffffffu, mine, (k0 + u) & 31);
          if (k0 + u >= cnt) break;  // uniform over the warp
          const float* row1 = g1 + (size_t)n * kC + lane * kW;
#pragma unroll
          for (int j = 0; j < kPass; ++j)
            load<kW>(row1 + j * 32 * kW, &t1[u][j * kW]);
          if constexpr (kG2) {
            const float* row2 = g2 + (size_t)n * kC + lane * kW;
#pragma unroll
            for (int j = 0; j < kPass; ++j)
              load<kW>(row2 + j * 32 * kW, &t2[u][j * kW]);
          }
          if (with_m && lane < n_map)
            tm[u] = __ldg(gm + (size_t)n * n_map + lane);
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          if (k0 + u >= cnt) break;
#pragma unroll
          for (int c = 0; c < kCpl; ++c) a1[c] = __fadd_rn(a1[c], t1[u][c]);
          if constexpr (kG2) {
#pragma unroll
            for (int c = 0; c < kCpl; ++c)
              a2[c] = __fadd_rn(a2[c], t2[u][c]);
          }
          if (with_m && lane < n_map) am = __fadd_rn(am, tm[u]);
        }
      }
    }
    float* out = dfeat + (size_t)r * kC + lane * kW;
    if (beg < end) {
      if constexpr (kG2) {  // G1 + 2 x G2
        float x[kCpl];
        const float* xr = feats + (size_t)r * kC + lane * kW;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          load<kW>(xr + j * 32 * kW, &x[j * kW]);
#pragma unroll
        for (int c = 0; c < kCpl; ++c)
          a1[c] = __fadd_rn(a1[c], __fmul_rn(__fmul_rn(2.f, x[c]), a2[c]));
      }
      if (with_m) {  // + dY @ W^T
        float d = 0.f;
        if (lane < n_map) {
          d = __fmul_rn(__fmul_rn(2.f, y), am);
          dy[(size_t)r * n_map + lane] = d;
        }
        float acc[kCpl];
#pragma unroll
        for (int c = 0; c < kCpl; ++c) acc[c] = 0.f;
        for (int m = 0; m < n_map; ++m) {
          const float dm = __shfl_sync(0xffffffffu, d, m);
          const float* wm = wt_s + m * kC + lane * kW;
#pragma unroll
          for (int j = 0; j < kPass; ++j)
#pragma unroll
            for (int e = 0; e < kW; ++e)
              acc[j * kW + e] =
                  fmaf(dm, wm[j * 32 * kW + e], acc[j * kW + e]);
        }
#pragma unroll
        for (int c = 0; c < kCpl; ++c) a1[c] = __fadd_rn(a1[c], acc[c]);
      }
    }  // else no voxel maps here: a1 holds zeros
#pragma unroll
    for (int j = 0; j < kPass; ++j) store<kW>(out + j * 32 * kW, &a1[j * kW]);
    beg = next_beg;
    end = next_end;
  }
}

// The pass on bfloat16 maps. Each pair's cotangent is rounded and added on
// its own, so the product with W^T runs once a pair, not once a row; the
// pairs go through it kP at a time, so that each W^T value read from
// shared memory serves kP pairs' FMAs (one pair at a time, the reads of
// W^T bound the pass, not its FMAs).
//
// Warp w walks batches of 32 pixel rows, w, w + warps, ...: lane i takes
// row b + i B of batch b (B batches; interleaved, so that a batch samples
// the whole map: the rows with many pairs lie together, and batches of
// adjacent rows left a few warps most of the pairs), a row without a
// voxel is written zeros at once, and the batch's pairs, in row then
// voxel order, are appended to
// the warp's ring of (voxel, row) in shared memory, 32 at a time (lane k
// finds pair q's row by a binary search over the lanes' inclusive
// counts). Whenever the ring holds kP pairs, a group leaves it, across
// row and batch boundaries alike:
//   - its g1 rows are loaded (lane l channels (j * 32 + l) * kW + e, as
//     pixel_kernel), then lane m < M loads each pair's gm[m] and its row's
//     mapped value y[m] and puts dm = (2 y) gm into the warp's slot dm_s[m]
//     [p] in shared memory;
//   - the product: for m = 0 .. M - 1 the lane reads its channels of W^T
//     row m once and dm_s[m][0 .. kP) as broadcasts, and adds kP x kCpl
//     FMAs, each pair's channel the same fmaf chain in ascending m as
//     before, so each pair's product keeps its bits;
//   - the pairs are then added in order: a pair of a new row first writes
//     the row before it (d features and dY) and starts the new one; each
//     pair's ((2 x g2) + g1) + product is rounded and added, the sum
//     rounded, and lane m sums gm for dY.
// So each row's voxels add in ascending voxel order, as before, and the
// d features are the design before this one's bit for bit. kP is 8 up to
// 8 channels a lane (the FMAs of a group, 64 a lane for each m, then
// outnumber its shared-memory wavefronts, 10), fewer above (registers).
template <int kCpl, int kW, bool kG2>
__global__ void __launch_bounds__(kThreads, 1)
    pixel_bf16_kernel(const uint16_t* __restrict__ feats,
                      const int* __restrict__ order,
                      const int* __restrict__ off,
                      const float* __restrict__ g1,
                      const float* __restrict__ g2,
                      const float* __restrict__ gm,
                      const float* __restrict__ mapped,
                      const float* __restrict__ w,
                      uint16_t* __restrict__ dfeat, float* __restrict__ dy,
                      int n_views, int hw, int n_vox, int n_map) {
  constexpr int kC = 32 * kCpl;
  constexpr int kPass = kCpl / kW;
  constexpr int kP = kCpl <= 8 ? 8 : 64 / kCpl;  // pairs a group
  constexpr int kRing = 64;  // a group and a batch's 32 pairs fit
  extern __shared__ __align__(16) float wt_s[];
  __shared__ __align__(16) float dm_all[kWarps][kMaxMap][kP];
  __shared__ int ring_all[kWarps][2][kRing];  // voxel, row
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const bool with_m = mapped != nullptr;
  if (with_m) {
    for (int i = threadIdx.x; i < kC * n_map; i += kThreads) {
      const int c = i / n_map, m = i % n_map;
      wt_s[m * kC + c] = w[i];
    }
    __syncthreads();
  }
  float(*dm_s)[kP] = dm_all[wid];
  int* ring_n = ring_all[wid][0];
  int* ring_r = ring_all[wid][1];
  int head = 0, len = 0;  // the ring's pairs, the same over the warp

  // the open row: its sum, lane m's gm sum and mapped value, and 2 x
  int cur = -1;
  float acc[kCpl], am = 0.f, ycur = 0.f, x2[kG2 ? kCpl : 1];
#pragma unroll
  for (int c = 0; c < kCpl; ++c) acc[c] = 0.f;
  auto finish = [&]() {
    if (cur < 0) return;
    uint16_t* out = dfeat + (size_t)cur * kC + lane * kW;
#pragma unroll
    for (int j = 0; j < kPass; ++j) store<kW>(out + j * 32 * kW, &acc[j * kW]);
    if (with_m && lane < n_map)
      dy[(size_t)cur * n_map + lane] = __fmul_rn(__fmul_rn(2.f, ycur), am);
  };

  // the np <= kP pairs at the ring's head, in order
  auto group = [&](int np) {
    int gn[kP], gr[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      gn[p] = p < np ? ring_n[(head + p) & (kRing - 1)] : 0;
      gr[p] = p < np ? ring_r[(head + p) & (kRing - 1)] : -1;
    }
    float t1[kP][kCpl];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p >= np) break;  // uniform over the warp
      const float* row1 = g1 + (size_t)gn[p] * kC + lane * kW;
#pragma unroll
      for (int j = 0; j < kPass; ++j)
        load<kW>(row1 + j * 32 * kW, &t1[p][j * kW]);
    }
    float gq[kP], yq[kP], prod[kP][kCpl];
    if (with_m) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        gq[p] = yq[p] = 0.f;
        if (p < np && lane < n_map) {
          gq[p] = __ldg(gm + (size_t)gn[p] * n_map + lane);
          yq[p] = __ldg(mapped + (size_t)gr[p] * n_map + lane);
        }
      }
      if (lane < n_map) {
#pragma unroll
        for (int p = 0; p < kP; ++p)
          dm_s[lane][p] = __fmul_rn(__fmul_rn(2.f, yq[p]), gq[p]);
      }
      __syncwarp();
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int c = 0; c < kCpl; ++c) prod[p][c] = 0.f;
#pragma unroll 4  // the next m's shared-memory reads go out early
      for (int m = 0; m < n_map; ++m) {
        float wv[kCpl], dv[kP];
        const float* wm = wt_s + m * kC + lane * kW;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
#pragma unroll
          for (int e = 0; e < kW; ++e) wv[j * kW + e] = wm[j * 32 * kW + e];
        if constexpr (kP % 4 == 0) {
#pragma unroll
          for (int p = 0; p < kP; p += 4) {
            const float4 q = *reinterpret_cast<const float4*>(&dm_s[m][p]);
            dv[p] = q.x;
            dv[p + 1] = q.y;
            dv[p + 2] = q.z;
            dv[p + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p) dv[p] = dm_s[m][p];
        }
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int c = 0; c < kCpl; ++c)
            prod[p][c] = fmaf(dv[p], wv[c], prod[p][c]);
      }
      __syncwarp();  // before the slots are written again
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p >= np) break;  // uniform over the warp
      if (gr[p] != cur) {
        finish();
        cur = gr[p];
#pragma unroll
        for (int c = 0; c < kCpl; ++c) acc[c] = 0.f;
        am = 0.f;
        if (with_m) ycur = yq[p];
        if constexpr (kG2) {
          const uint16_t* xr = feats + (size_t)cur * kC + lane * kW;
#pragma unroll
          for (int j = 0; j < kPass; ++j)
            load<kW>(xr + j * 32 * kW, &x2[j * kW]);
#pragma unroll
          for (int c = 0; c < kCpl; ++c) x2[c] = __fmul_rn(2.f, x2[c]);
        }
      }
      float d[kCpl];
#pragma unroll
      for (int c = 0; c < kCpl; ++c) d[c] = t1[p][c];
      if constexpr (kG2) {  // (2 x g2) + g1
        float t2[kCpl];
        const float* row2 = g2 + (size_t)gn[p] * kC + lane * kW;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          load<kW>(row2 + j * 32 * kW, &t2[j * kW]);
#pragma unroll
        for (int c = 0; c < kCpl; ++c)
          d[c] = __fadd_rn(__fmul_rn(x2[c], t2[c]), d[c]);
      }
      if (with_m) {  // + (2 y gm) @ W^T
#pragma unroll
        for (int c = 0; c < kCpl; ++c) d[c] = __fadd_rn(d[c], prod[p][c]);
        if (lane < n_map) am = __fadd_rn(am, gq[p]);
      }
      // each pair's cotangent rounded, then each sum, two values a
      // conversion (kCpl is 1 or even)
      if constexpr (kCpl == 1) {
        acc[0] = bf16r(__fadd_rn(acc[0], bf16r(d[0])));
      } else {
#pragma unroll
        for (int c = 0; c < kCpl; c += 2) {
          bf16r2(d[c], d[c + 1]);
          acc[c] = __fadd_rn(acc[c], d[c]);
          acc[c + 1] = __fadd_rn(acc[c + 1], d[c + 1]);
          bf16r2(acc[c], acc[c + 1]);
        }
      }
    }
    head += np;
    len -= np;
  };

  const long long rows = (long long)n_views * hw;
  const long long batches = (rows + 31) / 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long bt = (long long)blockIdx.x * kWarps + wid; bt < batches;
       bt += warps) {
    const long long r = bt + lane * batches;
    int cnt = 0, base = 0;
    if (r < rows) {
      const int v = (int)(r / hw), p = (int)(r % hw);
      const int* offv = off + (size_t)v * (hw + 1);
      const int beg = __ldg(offv + p);
      cnt = __ldg(offv + p + 1) - beg;
      base = v * n_vox + beg;  // where the row's voxels start in order
    }
    // rows without a voxel: zeros
    unsigned empty = __ballot_sync(0xffffffffu, r < rows && cnt == 0);
    while (empty) {
      const int k = __ffs(empty) - 1;
      empty &= empty - 1;
      const float zero[kW] = {};
      uint16_t* out = dfeat + (size_t)(bt + k * batches) * kC + lane * kW;
#pragma unroll
      for (int j = 0; j < kPass; ++j) store<kW>(out + j * 32 * kW, zero);
    }
    int inc = cnt;  // inclusive count over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    const int total = __shfl_sync(0xffffffffu, inc, 31);
    // pair q's place in order is base_i + q, i its row's lane
    const int start = base - (inc - cnt);
    for (int q0 = 0; q0 < total; q0 += 32) {
      const int q = q0 + lane;
      int i = 0;  // the lanes whose inclusive count is <= q
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int t = __shfl_sync(0xffffffffu, inc, i + step - 1);
        if (t <= q) i += step;
      }
      const int at = __shfl_sync(0xffffffffu, start, i & 31) + q;
      if (q < total) {
        const int k = (head + len + lane) & (kRing - 1);
        ring_n[k] = __ldg(order + at);
        ring_r[k] = (int)(bt + i * batches);
      }
      __syncwarp();
      len += min(32, total - q0);
      while (len >= kP) group(kP);
    }
  }
  if (len > 0) group(len);
  finish();
}

// ---- pass 2: per-block partial sums of dW and db -------------------------

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// A block of kTile threads: thread t sums channels c0 + 4 (t % (kTile / 4))
// + e, e < 4, against mapped outputs 8 (t / (kTile / 4)) + k, k < 8. The
// block's referenced rows are [g_beg, g_end) of the views' compacted lists
// in order; pre (V + 1) in dynamic shared memory holds where each view's
// list starts. kVec: the rows of x and dY are 16-byte aligned (x 8-byte
// aligned where T is bfloat16). Rows of bfloat16 maps are staged as they
// are, by cp.async where aligned, and widened where they are read.
template <int kTile, bool kVec, typename T>
__global__ void __launch_bounds__(kTile)
    weight_kernel(const T* __restrict__ feats,
                  const float* __restrict__ dy, const int* __restrict__ rows,
                  const int* __restrict__ n_rows,
                  const float* __restrict__ gm,
                  const float* __restrict__ count, float* __restrict__ part_w,
                  float* __restrict__ part_b, float* __restrict__ part_i,
                  int n_views, int hw, int channels, int n_vox, int n_map) {
  constexpr int kGroups = kTile / 4;
  // dynamic shared memory: kStages buffers of kRows rows of x, then of
  // dY, then pre (V + 1)
  extern __shared__ __align__(16) float stage_s[];
  constexpr bool kBf = std::is_same<T, uint16_t>::value;
  float(*x_s)[kRows][kTile] =
      reinterpret_cast<float(*)[kRows][kTile]>(stage_s);
  uint16_t(*xb_s)[kRows][kTile] =  // the same buffers, for bfloat16 rows
      reinterpret_cast<uint16_t(*)[kRows][kTile]>(stage_s);
  float(*dy_s)[kRows][kMaxMap] = reinterpret_cast<float(*)[kRows][kMaxMap]>(
      stage_s + kStages * kRows * kTile);
  int* pre = reinterpret_cast<int*>(stage_s + kStages * kRows *
                                                  (kTile + kMaxMap));
  __shared__ int at_s[kIdx];
  __shared__ int red[32];
  const int tid = threadIdx.x;
  const int part = blockIdx.x, c0 = blockIdx.y * kTile;
  const bool first_tile = blockIdx.y == 0;

  // where each view's referenced rows start in the concatenated list
  int carry = 0;
  for (int v0 = 0; v0 < n_views; v0 += kTile) {
    const int v = v0 + tid;
    const int k = v < n_views ? __ldg(n_rows + v) : 0;
    int total;
    const int ex = csort::block_scan(k, red, &total);
    if (v < n_views) pre[v] = carry + ex;
    carry += total;
  }
  if (tid == 0) pre[n_views] = carry;
  __syncthreads();
  const int per = (carry + kParts - 1) / kParts;
  const int g_beg = min(part * per, carry);
  const int g_end = min(g_beg + per, carry);

  // rows at_s[s0, s0 + n_s) into buffer `buf`, zeros past n_s
  auto stage = [&](int buf, int s0, int n_s) {
    constexpr int kChunks = kVec ? kTile / 4 : kTile;
    for (int q = tid; q < kRows * kChunks; q += kTile) {
      const int s = q / kChunks, k = q % kChunks;
      const int r = s < n_s ? at_s[s0 + s] : -1;
      if constexpr (kBf) {
        if (kVec) {
          uint16_t* dst = &xb_s[buf][s][4 * k];
          if (r >= 0)
            cp_async8(dst, feats + (size_t)r * channels + c0 + 4 * k);
          else
            *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
        } else {
          xb_s[buf][s][k] =
              r >= 0 ? feats[(size_t)r * channels + c0 + k] : uint16_t(0);
        }
      } else if (kVec) {
        float* dst = &x_s[buf][s][4 * k];
        if (r >= 0)
          cp_async16(dst, feats + (size_t)r * channels + c0 + 4 * k);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        if (r >= 0)
          cp_async4(&x_s[buf][s][k], feats + (size_t)r * channels + c0 + k);
        else
          x_s[buf][s][k] = 0.f;
      }
    }
    constexpr int kMapChunks = kVec ? kMaxMap / 4 : kMaxMap;
    for (int q = tid; q < kRows * kMapChunks; q += kTile) {
      const int s = q / kMapChunks, k = q % kMapChunks;
      const int r = s < n_s ? at_s[s0 + s] : -1;
      if (kVec) {  // n_map % 4 == 0
        float* dst = &dy_s[buf][s][4 * k];
        if (r >= 0 && 4 * k < n_map)
          cp_async16(dst, dy + (size_t)r * n_map + 4 * k);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        if (r >= 0 && k < n_map)
          cp_async4(&dy_s[buf][s][k], dy + (size_t)r * n_map + k);
        else
          dy_s[buf][s][k] = 0.f;
      }
    }
    cp_async_commit();
  };

  const int cg = tid % kGroups, mg = tid / kGroups;
  float acc[4][8];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[e][k] = 0.f;
  float acc_b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc_b[k] = 0.f;
  const bool sums_b = first_tile && cg == 0;

  for (int gb = g_beg; gb < g_end; gb += kIdx) {
    // the rows' indices: the last view whose list starts at or before g
    const int n_idx = min(kIdx, g_end - gb);
    for (int k = tid; k < n_idx; k += kTile) {
      const int g = gb + k;
      int lo = 0, hi = n_views;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= g) lo = mid; else hi = mid;
      }
      at_s[k] = lo * hw + __ldg(rows + (size_t)lo * hw + (g - pre[lo]));
    }
    __syncthreads();
    // kStages - 1 stages in flight ahead of the one computed (an empty
    // group where the rows run out keeps the count)
    for (int q = 0; q < kStages - 1; ++q) {
      if (q * kRows < n_idx)
        stage(q, q * kRows, min(kRows, n_idx - q * kRows));
      else
        cp_async_commit();
    }
    for (int s0 = 0, t = 0; s0 < n_idx; s0 += kRows, ++t) {
      const int buf = t % kStages, ahead = s0 + (kStages - 1) * kRows;
      if (ahead < n_idx)
        stage((t + kStages - 1) % kStages, ahead,
              min(kRows, n_idx - ahead));
      else
        cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int n_s = min(kRows, n_idx - s0);
      for (int s = 0; s < n_s; ++s) {
        float xs[4];
        if constexpr (kBf) {
          const uint2 x =
              *reinterpret_cast<const uint2*>(&xb_s[buf][s][4 * cg]);
          xs[0] = __uint_as_float(x.x << 16);
          xs[1] = __uint_as_float(x.x & 0xffff0000u);
          xs[2] = __uint_as_float(x.y << 16);
          xs[3] = __uint_as_float(x.y & 0xffff0000u);
        } else {
          const float4 x =
              *reinterpret_cast<const float4*>(&x_s[buf][s][4 * cg]);
          xs[0] = x.x;
          xs[1] = x.y;
          xs[2] = x.z;
          xs[3] = x.w;
        }
        const float4 d0 =
            *reinterpret_cast<const float4*>(&dy_s[buf][s][8 * mg]);
        const float4 d1 =
            *reinterpret_cast<const float4*>(&dy_s[buf][s][8 * mg + 4]);
        const float ds[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[e][k] = fmaf(xs[e], ds[k], acc[e][k]);
        if (sums_b) {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc_b[k] = __fadd_rn(acc_b[k], ds[k]);
        }
      }
      __syncthreads();  // before this buffer, or at_s, is written again
    }
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int m = 8 * mg + k;
    if (m >= n_map) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part_w[((size_t)part * channels + c0 + 4 * cg + e) * n_map + m] =
          acc[e][k];
    if (sums_b) part_b[(size_t)part * n_map + m] = acc_b[k];
  }
  if (first_tile) {  // views that do not see the voxel
    // warp q sums voxels n_beg + q, n_beg + q + kTile / 32, ... (lane m
    // output m), then the warps' sums add in warp order
    constexpr int kGroups32 = kTile / 32;
    __shared__ float inv_s[kGroups32][kMaxMap];
    const int lane = tid & 31, q = tid >> 5;
    const int nper = (n_vox + kParts - 1) / kParts;
    const int n_beg = min(part * nper, n_vox);
    const int n_end = min(n_beg + nper, n_vox);
    float s = 0.f;
    constexpr int kAhead = 8;  // voxels loaded before their products add
    if (lane < n_map)
      for (int n0 = n_beg + q; n0 < n_end; n0 += kAhead * kGroups32) {
        float cv[kAhead], gv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int n = n0 + u * kGroups32;
          cv[u] = n < n_end ? __ldg(count + n) : 0.f;
          gv[u] = n < n_end ? __ldg(gm + (size_t)n * n_map + lane) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (n0 + u * kGroups32 < n_end)
            s = fmaf(__fsub_rn((float)n_views, cv[u]), gv[u], s);
      }
    inv_s[q][lane] = s;
    __syncthreads();
    if (tid < n_map) {
      float t = inv_s[0][tid];
      for (int k = 1; k < kGroups32; ++k) t = __fadd_rn(t, inv_s[k][tid]);
      part_i[(size_t)part * n_map + tid] = t;
    }
  }
}

// ---- pass 3: the partials' sums, in block order --------------------------

__global__ void reduce_kernel(const float* __restrict__ part_w,
                              const float* __restrict__ part_b,
                              const float* __restrict__ part_i,
                              const float* __restrict__ b,
                              float* __restrict__ dw, float* __restrict__ db,
                              int cm, int n_map) {
  constexpr int kAhead = 16;  // partials loaded before they are added
  static_assert(kParts % kAhead == 0, "whole groups of partials");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cm) {
    float s = 0.f;
    for (int q0 = 0; q0 < kParts; q0 += kAhead) {
      float x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        x[u] = __ldg(part_w + (size_t)(q0 + u) * cm + i);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) s = __fadd_rn(s, x[u]);
    }
    dw[i] = s;
  } else if (i < cm + n_map) {
    const int m = i - cm;
    float s = 0.f, t = 0.f;
    for (int q0 = 0; q0 < kParts; q0 += kAhead) {
      float x[kAhead], y[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        x[u] = __ldg(part_b + (q0 + u) * n_map + m);
        y[u] = __ldg(part_i + (q0 + u) * n_map + m);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        s = __fadd_rn(s, x[u]);
        t = __fadd_rn(t, y[u]);
      }
    }
    db[m] = __fadd_rn(s, __fmul_rn(__fmul_rn(2.f, __ldg(b + m)), t));
  }
}

template <typename T>
struct PixelKernel;

template <>
struct PixelKernel<float> {
  template <int kCpl, int kW, bool kG2>
  static constexpr auto get() { return pixel_kernel<kCpl, kW, kG2>; }
};

template <>
struct PixelKernel<uint16_t> {
  template <int kCpl, int kW, bool kG2>
  static constexpr auto get() { return pixel_bf16_kernel<kCpl, kW, kG2>; }
};

template <int kCpl, int kW, bool kG2, typename T>
cudaError_t launch_pixel(const T* feats, const int* order, const int* off,
                         const float* g1, const float* g2, const float* gm,
                         const float* mapped, const float* w, T* dfeat,
                         float* dy, int n_views, int hw, int n_vox, int n_map,
                         cudaStream_t s) {
  auto kernel = PixelKernel<T>::template get<kCpl, kW, kG2>();
  const size_t smem =
      mapped != nullptr ? (size_t)32 * kCpl * n_map * sizeof(float) : 0;
  cudaError_t err = csort::fit_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)n_views * hw;
  const long long need = (rows + kWarps - 1) / kWarps;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(need < resident ? need : resident);
  kernel<<<blocks, kThreads, smem, s>>>(feats, order, off, g1, g2, gm, mapped,
                                        w, dfeat, dy, n_views, hw, n_vox,
                                        n_map);
  return cudaGetLastError();
}

template <int kCpl, int kW, typename T>
cudaError_t pixel_by_g2(const T* feats, const int* order, const int* off,
                        const float* g1, const float* g2, const float* gm,
                        const float* mapped, const float* w, T* dfeat,
                        float* dy, int n_views, int hw, int n_vox, int n_map,
                        cudaStream_t s) {
  return g2 != nullptr
             ? launch_pixel<kCpl, kW, true>(feats, order, off, g1, g2, gm,
                                            mapped, w, dfeat, dy, n_views, hw,
                                            n_vox, n_map, s)
             : launch_pixel<kCpl, kW, false>(feats, order, off, g1, g2, gm,
                                             mapped, w, dfeat, dy, n_views,
                                             hw, n_vox, n_map, s);
}

template <int kCpl, typename T>
cudaError_t pixel_by_width(bool vec, const T* feats, const int* order,
                           const int* off, const float* g1, const float* g2,
                           const float* gm, const float* mapped,
                           const float* w, T* dfeat, float* dy,
                           int n_views, int hw, int n_vox, int n_map,
                           cudaStream_t s) {
  constexpr int kVec = kCpl < 4 ? kCpl : 4;
  return vec ? pixel_by_g2<kCpl, kVec>(feats, order, off, g1, g2, gm, mapped,
                                       w, dfeat, dy, n_views, hw, n_vox,
                                       n_map, s)
             : pixel_by_g2<kCpl, 1>(feats, order, off, g1, g2, gm, mapped, w,
                                    dfeat, dy, n_views, hw, n_vox, n_map, s);
}

template <int kTile, bool kVec, typename T>
cudaError_t launch_weight(const T* feats, const float* dy,
                          const int* rows, const int* n_rows, const float* gm,
                          const float* count, float* part_w, float* part_b,
                          float* part_i, int n_views, int hw, int channels,
                          int n_vox, int n_map, cudaStream_t s) {
  auto kernel = weight_kernel<kTile, kVec, T>;
  const size_t smem = sizeof(float) * kStages * kRows * (kTile + kMaxMap) +
                      (size_t)(n_views + 1) * sizeof(int);
  cudaError_t err = csort::fit_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kParts, channels / kTile);
  kernel<<<grid, kTile, smem, s>>>(feats, dy, rows, n_rows, gm, count,
                                   part_w, part_b, part_i, n_views, hw,
                                   channels, n_vox, n_map);
  return cudaGetLastError();
}

template <int kTile, typename T>
cudaError_t weight_by_alignment(bool vec, const T* feats,
                                const float* dy, const int* rows,
                                const int* n_rows, const float* gm,
                                const float* count, float* part_w,
                                float* part_b, float* part_i, int n_views,
                                int hw, int channels, int n_vox, int n_map,
                                cudaStream_t s) {
  return vec ? launch_weight<kTile, true>(feats, dy, rows, n_rows, gm, count,
                                          part_w, part_b, part_i, n_views,
                                          hw, channels, n_vox, n_map, s)
             : launch_weight<kTile, false>(feats, dy, rows, n_rows, gm,
                                           count, part_w, part_b, part_i,
                                           n_views, hw, channels, n_vox,
                                           n_map, s);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool k1_width(int channels) {
  return channels == 32 || channels == 64 || channels == 128 ||
         channels == 256 || channels == 512 || channels == 1024;
}

}  // namespace

// The ranges of referenced rows pass 2 splits them into: the wrapper sizes
// the partial-sum buffers by it.
extern "C" int fused_mean_cov_backward_parts() { return kParts; }

// The voxels of a tile of the index preparation: the wrapper sizes its
// scratch by it.
extern "C" int fused_mean_cov_backward_tile() { return csort::kTile; }

// Index preparation. pix (V, N) int32, -1 where invalid; hist (V J + V,
// HW + 1) and tile_kept (V, J) int32 scratch, J = ceil(N / tile); outputs
// order (V, N) int32, each view's voxels sorted stably by pixel (the
// invalid first); off (V, HW + 1) int32, the start of each pixel's voxels
// in `order` (off[v, p + 1] - off[v, p] of them); rows (V, HW) int32, each
// view's referenced pixels in order, -1 past n_rows[v]; n_rows (V,) int32.
extern "C" int fused_mean_cov_backward_order(const int* pix, int* hist,
                                             int* tile_kept, int* order,
                                             int* off, int* rows, int* n_rows,
                                             int n_views, int n_vox, int hw,
                                             void* stream) {
  return static_cast<int>(csort::sort(
      pix, hist, tile_kept, order, nullptr, off, rows, n_rows, n_views,
      n_vox, hw + 1, 0, 1, 1, 0, static_cast<cudaStream_t>(stream)));
}

// Pass 1. feats (V, HW, C) float32, or bfloat16 where bf16 is set; order
// and off from the index preparation; g1 (N, C); g2 (N, C) or null; dfeat
// (V, HW, C) out, in the maps' dtype. With the mapped stream: gm (N, M),
// mapped (V, HW, M) (phase A's rows), w (C, M); dy (V, HW, M) out at the
// referenced rows. Without it, those are null. Everything contiguous; C in
// {32, ..., 1024}, 1 <= M <= 32. Returns the first cudaError_t of the
// set-up and the launch.
extern "C" int fused_mean_cov_backward_pixels(
    const void* feats, const int* order, const int* off, const float* g1,
    const float* g2, const float* gm, const float* mapped, const float* w,
    void* dfeat, float* dy, int n_views, int hw, int channels, int n_vox,
    int n_map, int bf16, void* stream) {
  if (mapped != nullptr && (n_map < 1 || n_map > kMaxMap || gm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!k1_width(channels)) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)n_views * hw == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(feats) && aligned16(g1) && aligned16(g2) &&
                   aligned16(dfeat);
  cudaError_t err = cudaSuccess;
#define K1B_PIXEL(CPL, T)                                                    \
  err = pixel_by_width<CPL>(vec, static_cast<const T*>(feats), order, off,  \
                            g1, g2, gm, mapped, w, static_cast<T*>(dfeat),  \
                            dy, n_views, hw, n_vox, n_map, s);              \
  break
#define K1B_WIDTHS(T)         \
  switch (channels) {         \
    case 32: K1B_PIXEL(1, T);   \
    case 64: K1B_PIXEL(2, T);   \
    case 128: K1B_PIXEL(4, T);  \
    case 256: K1B_PIXEL(8, T);  \
    case 512: K1B_PIXEL(16, T); \
    case 1024: K1B_PIXEL(32, T); \
  }
  if (bf16) {
    K1B_WIDTHS(uint16_t)
  } else {
    K1B_WIDTHS(float)
  }
#undef K1B_WIDTHS
#undef K1B_PIXEL
  return static_cast<int>(err);
}

namespace {

template <typename T>
cudaError_t weights_by_width(bool vec, const T* feats, const float* dy,
                             const int* rows, const int* n_rows,
                             const float* gm, const float* count,
                             float* part_w, float* part_b, float* part_i,
                             int n_views, int hw, int channels, int n_vox,
                             int n_map, cudaStream_t s) {
  switch (channels) {
    case 32:
      return weight_by_alignment<32>(vec, feats, dy, rows, n_rows, gm, count,
                                     part_w, part_b, part_i, n_views, hw,
                                     channels, n_vox, n_map, s);
    case 64:
      return weight_by_alignment<64>(vec, feats, dy, rows, n_rows, gm, count,
                                     part_w, part_b, part_i, n_views, hw,
                                     channels, n_vox, n_map, s);
    case 128:
      return weight_by_alignment<128>(vec, feats, dy, rows, n_rows, gm,
                                      count, part_w, part_b, part_i, n_views,
                                      hw, channels, n_vox, n_map, s);
    default:  // 256 and up: tiles of 256 channels
      return weight_by_alignment<kTileMax>(vec, feats, dy, rows, n_rows, gm,
                                           count, part_w, part_b, part_i,
                                           n_views, hw, channels, n_vox,
                                           n_map, s);
  }
}

}  // namespace

// Pass 2. feats (V, HW, C), float32 or (bf16 set) bfloat16; dy from pass
// 1; rows and n_rows from the index preparation; gm (N, M); count (N,);
// part_w (kParts, C, M), part_b and part_i (kParts, M) out.
extern "C" int fused_mean_cov_backward_weights(
    const void* feats, const float* dy, const int* rows, const int* n_rows,
    const float* gm, const float* count, float* part_w, float* part_b,
    float* part_i, int n_views, int hw, int channels, int n_vox, int n_map,
    int bf16, void* stream) {
  if (n_map < 1 || n_map > kMaxMap || !k1_width(channels))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(feats) && aligned16(dy) && n_map % 4 == 0;
  const cudaError_t err =
      bf16 ? weights_by_width(vec, static_cast<const uint16_t*>(feats), dy,
                              rows, n_rows, gm, count, part_w, part_b,
                              part_i, n_views, hw, channels, n_vox, n_map, s)
           : weights_by_width(vec, static_cast<const float*>(feats), dy,
                              rows, n_rows, gm, count, part_w, part_b,
                              part_i, n_views, hw, channels, n_vox, n_map, s);
  return static_cast<int>(err);
}

// Pass 3. dw (C, M) and db (M,) out from pass 2's partials and b (M,).
extern "C" int fused_mean_cov_backward_reduce(const float* part_w,
                                              const float* part_b,
                                              const float* part_i,
                                              const float* b, float* dw,
                                              float* db, int channels,
                                              int n_map, void* stream) {
  const int cm = channels * n_map;
  const int threads = 256;
  reduce_kernel<<<(cm + n_map + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(part_w, part_b,
                                                       part_i, b, dw, db, cm,
                                                       n_map);
  return static_cast<int>(cudaGetLastError());
}
