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
// The sums run in a fixed order, so two runs give the same bits:
//
// Pass 1 (pixel_kernel): a warp per pixel row, over all V*HW rows (a
//   persistent grid). The voxels of row (v, p) are order[v, off[v, p] ..
//   off[v, p + 1]), pix[v] sorted stably (the wrapper's index
//   preparation), so the warp sums their g1, g2, gm rows in ascending voxel
//   order. Lane l holds C / 32 channels (16-byte loads where every row is
//   16-byte aligned) and lane m < M holds GM[m] and dY[m]. The product dY @
//   W^T takes W^T from shared memory, dY[m] by shuffle. It writes the
//   d-features row and, for a referenced row, its dY row.
// Pass 2 (weight_kernel): the grid splits the rows into kParts fixed
//   ranges and the channels into tiles of up to 256. Each block walks its
//   range 32 rows at a time, stages the referenced ones (a ballot of
//   off[v, p + 1] > off[v, p], in row order) and adds x[c] * dY[m] into one
//   register a (c, m) cell; warp 0 of the first tile adds dY into db, warp 1
//   the invalid-view sums (V - count[n]) gm[n] over its range of voxels.
//   Each block writes its partial sums.
// Pass 3 (reduce_kernel): dW and db as the sums of the partials in block
//   order.
//
// Inputs: f32 maps (the forward's bf16 maps take no gradient), C in {32,
// 64, 128, 256, 512, 1024}, 1 <= M <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMap = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kParts = 256;  // row ranges of pass 2 (must match the wrapper)
constexpr int kTileMax = 256;

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
// Shared memory: W^T [n_map][C] f32 when the mapped stream is given.
template <int kCpl, int kW>
__global__ void __launch_bounds__(kThreads)
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
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < rows; r += warps) {
    const int v = (int)(r / hw), p = (int)(r % hw);
    const int* offv = off + (size_t)v * (hw + 1);
    const int beg = __ldg(offv + p), end = __ldg(offv + p + 1);
    float a1[kCpl], a2[kCpl];
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      a1[c] = 0.f;
      a2[c] = 0.f;
    }
    float am = 0.f;
    const int* ordv = order + (size_t)v * n_vox;
    for (int i = beg; i < end; ++i) {
      const int n = __ldg(ordv + i);
      float t[kCpl];
      const float* row1 = g1 + (size_t)n * kC + lane * kW;
#pragma unroll
      for (int j = 0; j < kPass; ++j) load<kW>(row1 + j * 32 * kW, &t[j * kW]);
#pragma unroll
      for (int c = 0; c < kCpl; ++c) a1[c] = __fadd_rn(a1[c], t[c]);
      if (g2 != nullptr) {
        const float* row2 = g2 + (size_t)n * kC + lane * kW;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          load<kW>(row2 + j * 32 * kW, &t[j * kW]);
#pragma unroll
        for (int c = 0; c < kCpl; ++c) a2[c] = __fadd_rn(a2[c], t[c]);
      }
      if (with_m && lane < n_map)
        am = __fadd_rn(am, __ldg(gm + (size_t)n * n_map + lane));
    }
    float* out = dfeat + (size_t)r * kC + lane * kW;
    if (beg == end) {  // no voxel maps here
#pragma unroll
      for (int c = 0; c < kCpl; ++c) a1[c] = 0.f;
#pragma unroll
      for (int j = 0; j < kPass; ++j)
        store<kW>(out + j * 32 * kW, &a1[j * kW]);
      continue;
    }
    if (g2 != nullptr) {  // G1 + 2 x G2
      float x[kCpl];
      const float* xr = feats + (size_t)r * kC + lane * kW;
#pragma unroll
      for (int j = 0; j < kPass; ++j) load<kW>(xr + j * 32 * kW, &x[j * kW]);
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
        a1[c] = __fadd_rn(a1[c], __fmul_rn(__fmul_rn(2.f, x[c]), a2[c]));
    }
    if (with_m) {  // + dY @ W^T
      float d = 0.f;
      if (lane < n_map) {
        d = __fmul_rn(__fmul_rn(2.f, __ldg(mapped + (size_t)r * n_map + lane)),
                      am);
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
            acc[j * kW + e] = fmaf(dm, wm[j * 32 * kW + e], acc[j * kW + e]);
      }
#pragma unroll
      for (int c = 0; c < kCpl; ++c) a1[c] = __fadd_rn(a1[c], acc[c]);
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) store<kW>(out + j * 32 * kW, &a1[j * kW]);
  }
}

// ---- pass 2: per-block partial sums of dW and db -------------------------

// Thread t owns mapped output m = t % 32 and channels c0 + t / 32 + 8 k of
// the block's tile, k < kTile / 8. Shared memory: the staged rows' x tile
// [32][kTile] and dY [32][kMaxMap].
template <int kTile>
__global__ void __launch_bounds__(kThreads)
    weight_kernel(const float* __restrict__ feats, const int* __restrict__ off,
                  const float* __restrict__ dy, const float* __restrict__ gm,
                  const float* __restrict__ count, float* __restrict__ part_w,
                  float* __restrict__ part_b, float* __restrict__ part_i,
                  int n_views, int hw, int channels, int n_vox, int n_map) {
  constexpr int kAcc = kTile / kWarps;
  __shared__ __align__(16) float x_s[32][kTile];
  __shared__ float dy_s[32][kMaxMap];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x, c0 = blockIdx.y * kTile;
  const long long rows = (long long)n_views * hw;
  const long long per = (rows + kParts - 1) / kParts;
  const long long r_beg = part * per;
  const long long r_end = r_beg + per < rows ? r_beg + per : rows;
  const bool first_tile = blockIdx.y == 0;

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  float acc_b = 0.f;

  for (long long r0 = r_beg; r0 < r_end; r0 += 32) {
    // the window's referenced rows, in row order
    const long long r = r0 + lane;
    bool ref = false;
    if (r < r_end) {
      const int v = (int)(r / hw), p = (int)(r % hw);
      const int* offv = off + (size_t)v * (hw + 1);
      ref = __ldg(offv + p + 1) > __ldg(offv + p);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, ref);
    const int n_ref = __popc(mask);
    if (n_ref == 0) continue;  // uniform over the block: same window
    // stage: slot s holds the s-th referenced row of the window
    for (int i = tid; i < n_ref * kTile; i += kThreads) {
      const int s = i / kTile, c = i % kTile;
      const int bit = __fns(mask, 0, s + 1);  // position of the s-th set bit
      x_s[s][c] = __ldg(feats + (size_t)(r0 + bit) * channels + c0 + c);
    }
    for (int i = tid; i < n_ref * kMaxMap; i += kThreads) {
      const int s = i / kMaxMap, m = i % kMaxMap;
      const int bit = __fns(mask, 0, s + 1);
      dy_s[s][m] = m < n_map ? __ldg(dy + (size_t)(r0 + bit) * n_map + m)
                             : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < n_ref; ++s) {
      const float d = dy_s[s][lane];
#pragma unroll
      for (int k = 0; k < kAcc; ++k)
        acc[k] = fmaf(x_s[s][warp + kWarps * k], d, acc[k]);
      if (warp == 0) acc_b = __fadd_rn(acc_b, d);
    }
    __syncthreads();
  }

  if (lane < n_map) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k)
      part_w[((size_t)part * channels + c0 + warp + kWarps * k) * n_map +
             lane] = acc[k];
    if (first_tile && warp == 0) part_b[(size_t)part * n_map + lane] = acc_b;
    if (first_tile && warp == 1) {  // views that do not see the voxel
      const int nper = (n_vox + kParts - 1) / kParts;
      const int n_beg = part * nper;
      const int n_end = n_beg + nper < n_vox ? n_beg + nper : n_vox;
      float s = 0.f;
      for (int n = n_beg; n < n_end; ++n)
        s = fmaf(__fsub_rn((float)n_views, __ldg(count + n)),
                 __ldg(gm + (size_t)n * n_map + lane), s);
      part_i[(size_t)part * n_map + lane] = s;
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cm) {
    float s = 0.f;
    for (int q = 0; q < kParts; ++q)
      s = __fadd_rn(s, part_w[(size_t)q * cm + i]);
    dw[i] = s;
  } else if (i < cm + n_map) {
    const int m = i - cm;
    float s = 0.f, t = 0.f;
    for (int q = 0; q < kParts; ++q) {
      s = __fadd_rn(s, part_b[q * n_map + m]);
      t = __fadd_rn(t, part_i[q * n_map + m]);
    }
    db[m] = __fadd_rn(s, __fmul_rn(__fmul_rn(2.f, __ldg(b + m)), t));
  }
}

template <int kCpl, int kW>
cudaError_t launch_pixel(const float* feats, const int* order, const int* off,
                         const float* g1, const float* g2, const float* gm,
                         const float* mapped, const float* w, float* dfeat,
                         float* dy, int n_views, int hw, int n_vox, int n_map,
                         cudaStream_t s) {
  auto kernel = pixel_kernel<kCpl, kW>;
  const size_t smem =
      mapped != nullptr ? (size_t)32 * kCpl * n_map * sizeof(float) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
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

template <int kCpl>
cudaError_t pixel_by_width(bool vec, const float* feats, const int* order,
                           const int* off, const float* g1, const float* g2,
                           const float* gm, const float* mapped,
                           const float* w, float* dfeat, float* dy,
                           int n_views, int hw, int n_vox, int n_map,
                           cudaStream_t s) {
  constexpr int kVec = kCpl < 4 ? kCpl : 4;
  return vec ? launch_pixel<kCpl, kVec>(feats, order, off, g1, g2, gm, mapped,
                                        w, dfeat, dy, n_views, hw, n_vox,
                                        n_map, s)
             : launch_pixel<kCpl, 1>(feats, order, off, g1, g2, gm, mapped, w,
                                     dfeat, dy, n_views, hw, n_vox, n_map, s);
}

template <int kTile>
cudaError_t launch_weight(const float* feats, const int* off, const float* dy,
                          const float* gm, const float* count, float* part_w,
                          float* part_b, float* part_i, int n_views, int hw,
                          int channels, int n_vox, int n_map, cudaStream_t s) {
  const dim3 grid(kParts, channels / kTile);
  weight_kernel<kTile><<<grid, kThreads, 0, s>>>(feats, off, dy, gm, count,
                                                 part_w, part_b, part_i,
                                                 n_views, hw, channels, n_vox,
                                                 n_map);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The row ranges pass 2 splits the rows into: the wrapper sizes the
// partial-sum buffers by it.
extern "C" int fused_mean_cov_backward_parts() { return kParts; }

// feats (V, HW, C) f32; order (V, N) int32, each view's voxels sorted
// stably by pixel; off (V, HW + 1) int32, the start of each pixel's voxels
// in `order` (off[v, p + 1] - off[v, p] of them); g1 (N, C); g2 (N, C) or
// null; dfeat (V, HW, C) out. With the mapped stream: gm (N, M), mapped (V,
// HW, M) (phase A's rows), w (C, M), b (M,), count (N,); dy (V, HW, M)
// scratch, part_w (kParts, C, M), part_b and part_i (kParts, M) scratch;
// dw (C, M) and db (M,) out. Without it, all of those are null. Everything
// contiguous; C in {32, ..., 1024}, 1 <= M <= 32. Returns the first
// cudaError_t of the set-up and the launches.
extern "C" int fused_mean_cov_backward(
    const float* feats, const int* order, const int* off, const float* g1,
    const float* g2, const float* gm, const float* mapped, const float* w,
    const float* b, const float* count, float* dfeat, float* dy,
    float* part_w, float* part_b, float* part_i, float* dw, float* db,
    int n_views, int hw, int channels, int n_vox, int n_map, void* stream) {
  const bool with_m = mapped != nullptr;
  if (with_m && (n_map < 1 || n_map > kMaxMap || gm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)n_views * hw == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(feats) && aligned16(g1) && aligned16(g2) &&
                   aligned16(dfeat);
  cudaError_t err;
#define K1B_PIXEL(CPL)                                                        \
  err = pixel_by_width<CPL>(vec, feats, order, off, g1, g2, gm, mapped, w,   \
                            dfeat, dy, n_views, hw, n_vox, n_map, s);        \
  break
  switch (channels) {
    case 32: K1B_PIXEL(1);
    case 64: K1B_PIXEL(2);
    case 128: K1B_PIXEL(4);
    case 256: K1B_PIXEL(8);
    case 512: K1B_PIXEL(16);
    case 1024: K1B_PIXEL(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1B_PIXEL
  if (err != cudaSuccess || !with_m) return static_cast<int>(err);
  switch (channels) {
    case 32:
      err = launch_weight<32>(feats, off, dy, gm, count, part_w, part_b,
                              part_i, n_views, hw, channels, n_vox, n_map, s);
      break;
    case 64:
      err = launch_weight<64>(feats, off, dy, gm, count, part_w, part_b,
                              part_i, n_views, hw, channels, n_vox, n_map, s);
      break;
    case 128:
      err = launch_weight<128>(feats, off, dy, gm, count, part_w, part_b,
                               part_i, n_views, hw, channels, n_vox, n_map, s);
      break;
    default:  // 256 and up: tiles of 256 channels
      err = launch_weight<kTileMax>(feats, off, dy, gm, count, part_w, part_b,
                                    part_i, n_views, hw, channels, n_vox,
                                    n_map, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cm = channels * n_map;
  const int threads = 256;
  reduce_kernel<<<(cm + n_map + threads - 1) / threads, threads, 0, s>>>(
      part_w, part_b, part_i, b, dw, db, cm, n_map);
  return static_cast<int>(cudaGetLastError());
}
