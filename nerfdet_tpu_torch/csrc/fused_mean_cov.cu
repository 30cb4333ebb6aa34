// K1: view-streaming multi-view voxel fusion (the carry of fused_mean_cov),
// in two phases.
//
// Replaces the lax.scan over views in nerfdet_tpu/ops/voxel.py
// (fused_mean_cov, scan body `body`): for every voxel n and view v it
// takes the nearest-pixel feature row x of view v (precomputed flat pixel
// index, -1 where the voxel is not seen) and accumulates
//
//   s1[n, c]  += x           s2[n, c] += x * x        count[n] += valid
//   s2m[n, m] += y[m]^2,  y = x @ W + b              (mapped stream, optional)
//
// An invalid view gathers a zero row, so its y is exactly the bias b and it
// adds b^2 to s2m, as the JAX scan does.
//
// The JAX scan computes y once per (voxel, view), because on a TPU a second
// gather was the dear part. But y depends only on the (view, pixel): on the
// main path's scene 1.05 M valid (voxel, view) pairs reference 81 k
// distinct pixel rows. So K1 runs in two phases, launched one after the
// other on the caller's stream:
//
// Phase A (mapped_rows_kernel): P[v, p, :] = feats[v, p, :] @ W + b for
//   every pixel of every view, in fp32 FMAs on the CUDA cores (no TF32: s2m
//   is held to 1e-5). At the flagship (V=50 maps of 60x80, C=256, M=32) it
//   reads 245.8 MB of f32 maps and writes 30.7 MB (~0.083 ms at 3.35 TB/s)
//   and does 3.9 GFLOP (~0.059 ms at 67 TFLOP/s): bound by bytes. Design: a
//   persistent grid; each block keeps W (C x 32, zero-padded past M) and b
//   in shared memory and walks tiles of 128 rows; a ring of 4 stages of 32
//   channels is filled by 16-byte cp.async copies, and each thread holds a
//   4-row x 4-output tile in registers (two 16-byte shared loads per 16
//   FMAs). A map that is not 16-byte aligned is staged element by element.
//
// Phase B (carry_kernel): each warp owns its voxels (one at C >= 256,
//   256 / C of them below) and walks all views in order, with no shared
//   memory and no barrier. One load gives each lane the pixel index of one
//   (view, voxel) pair, 32 views at once at C >= 256, handed out by
//   shuffles. Lane l holds C / 32 channels of each voxel, read with 16-byte
//   loads where the map is 16-byte aligned (one element a load otherwise).
//   Lane m < M adds y^2 with y = P[v, p, m], or b[m] where the view does
//   not see the voxel. All warps walk the views in step, so the current
//   view's map (4.9 MB at the flagship) and P (0.6 MB) stay in L2. What
//   bounds it is the gathered rows (1.07 GB from L1/L2 at the flagship),
//   not device memory; a warp a voxel keeps 16 sums a lane and so the most
//   warps resident.
//
// s1, s2, count and s2m use separately rounded multiply and add in view
// order, so s1, s2 and count equal the plain PyTorch version bit for bit;
// s2m differs only in the order of the C-long dot product of phase A.
//
// The rgb stream (rgb_kernel, the depth_sp configs' path) replaces the
// in-scan rgb branch of the same JAX scan body (nerfdet_tpu/ops/voxel.py,
// fused_mean_cov, `body`: s1e/s2e of the (V, H, W, 3) denormalized images
// gathered at their own projection, depth-gated). The TPU folded it into
// the one scan; here it is a launch of its own, so phase B's register tile
// stays that of every config. Each thread owns one voxel and walks the
// views in order: the (V, N) pixel indices are read coalesced across
// voxels, kAheadRgb views at a time, then those views' 12-byte pixels are
// all requested before any is summed, so a thread keeps kAheadRgb gathers
// in flight. What it must move is the index (4 B a pair), 12 B a kept pair
// and the outputs: 10.2 MB + 12 B x kept pairs at 100 views of a 40x40x16
// volume, about 0.004 ms at 3.35 TB/s when the depth gate keeps a few
// percent of the pairs. The sums use separately rounded multiply and add
// in view order (a dropped pair adds nothing, as the plain version's zero
// row does), so s1e and s2e equal the plain version bit for bit. The
// images may be bfloat16 (the bf16 compute path, which rounds them to
// bfloat16 before the scan): a pixel is then 6 bytes, widened to float
// exactly, and the sums are the same float32 sums; the least traffic
// falls with it (5.9 MB, 0.0018 ms at 50 views), latency still bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMap = 32;  // M <= 32: lane m of a warp owns output m

// ---- shared helpers -------------------------------------------------------

// bfloat16 is carried as its 16 bits; widening to float is exact.
__device__ __forceinline__ void unpack2(unsigned u, float* x) {
  x[0] = __uint_as_float(u << 16);
  x[1] = __uint_as_float(u & 0xffff0000u);
}

// kW consecutive elements at p (kW * sizeof(T) bytes, that aligned).
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
__device__ __forceinline__ void load(const uint16_t* p, float* x) {
  if constexpr (kW == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(v.x, x);
    unpack2(v.y, x + 2);
    unpack2(v.z, x + 4);
    unpack2(v.w, x + 6);
  } else if constexpr (kW == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(v.x, x);
    unpack2(v.y, x + 2);
  } else if constexpr (kW == 2) {
    unpack2(__ldg(reinterpret_cast<const unsigned*>(p)), x);
  } else {
    x[0] = __uint_as_float(
        static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
}

template <int kW>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (kW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kW / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (kW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// ---- the rgb stream ---------------------------------------------------------

constexpr int kThreadsRgb = 64;
constexpr int kAheadRgb = 8;  // views whose pixels a thread has in flight

template <typename T>
__global__ void __launch_bounds__(kThreadsRgb)
    rgb_kernel(const T* __restrict__ images, const int* __restrict__ pix,
               float* __restrict__ s1, float* __restrict__ s2, int n_views,
               int hw, int n_vox) {
  const int n = blockIdx.x * kThreadsRgb + threadIdx.x;
  if (n >= n_vox) return;
  float a1[3] = {0.f, 0.f, 0.f}, a2[3] = {0.f, 0.f, 0.f};
  for (int v0 = 0; v0 < n_views; v0 += kAheadRgb) {
    int p[kAheadRgb];
    float x[kAheadRgb][3];
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k)
      p[k] = v0 + k < n_views
                 ? __ldg(pix + static_cast<size_t>(v0 + k) * n_vox + n)
                 : -1;
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k) {
      const T* px = images + (static_cast<size_t>(v0 + k) * hw +
                              (p[k] < 0 ? 0 : p[k])) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[k][c] = 0.f;
        if (p[k] >= 0) load<1>(px + c, &x[k][c]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k) {
      if (p[k] < 0) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a1[c] = __fadd_rn(a1[c], x[k][c]);
        a2[c] = __fadd_rn(a2[c], __fmul_rn(x[k][c], x[k][c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s1[static_cast<size_t>(n) * 3 + c] = a1[c];
    s2[static_cast<size_t>(n) * 3 + c] = a2[c];
  }
}

// ---- phase A: the mapped rows ---------------------------------------------

constexpr int kThreadsA = 256;
constexpr int kRowsT = 4;            // rows a thread
constexpr int kRowsA = 32 * kRowsT;  // rows a tile
constexpr int kChunk = 32;           // channels a stage
constexpr int kStages = 4;

// Elements a staged row: a multiple of 16 bytes, and the four rows a warp
// reads at once fall in distinct banks (must match the wrapper's size).
template <typename T>
__host__ __device__ constexpr int pitch() {
  return sizeof(T) == 4 ? 36 : 40;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// Four staged channels as floats (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 four(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 four(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  float x[4];
  unpack2(u.x, x);
  unpack2(u.y, x + 2);
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Shared memory: W [channels][kMaxMap] f32, b [kMaxMap] f32, then the ring
// [kStages][kRowsA][pitch<T>()] of T.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreadsA)
    mapped_rows_kernel(const T* __restrict__ feats, const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ out,
                       int n_rows, int channels, int n_map) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = pitch<T>();
  constexpr int kStage = kRowsA * kPitch;
  constexpr int kPieceElems = 16 / sizeof(T);
  constexpr int kPiecesRow = kChunk / kPieceElems;
  constexpr int kPieces = kRowsA * kPiecesRow / kThreadsA;  // a thread
  float* w_s = reinterpret_cast<float*>(smem);
  float* b_s = w_s + channels * kMaxMap;
  T* ring = reinterpret_cast<T*>(b_s + kMaxMap);
  const int tid = threadIdx.x;

  for (int i = tid; i < channels * kMaxMap; i += kThreadsA) {
    const int k = i / kMaxMap, m = i % kMaxMap;
    w_s[i] = m < n_map ? w[(size_t)k * n_map + m] : 0.f;
  }
  if (tid < kMaxMap) b_s[tid] = tid < n_map ? b[tid] : 0.f;

  // the block's work: chunks j of its tiles blockIdx.x + t * gridDim.x
  const int n_chunks = channels / kChunk;
  const int n_tiles = (n_rows + kRowsA - 1) / kRowsA;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_tiles * n_chunks;

  auto stage_in = [&](int j) {
    if (j < total) {
      const int r0 = ((int)blockIdx.x + (j / n_chunks) * (int)gridDim.x) *
                     kRowsA;
      const T* src = feats + (size_t)r0 * channels + (j % n_chunks) * kChunk;
      T* dst = ring + (j % kStages) * kStage;
      if constexpr (kAsync) {
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
          const int piece = tid + q * kThreadsA;
          const int r = piece / kPiecesRow;
          const int e = (piece % kPiecesRow) * kPieceElems;
          if (r0 + r < n_rows)
            cp_async16(dst + r * kPitch + e, src + (size_t)r * channels + e);
        }
      } else {
        for (int i = tid; i < kRowsA * kChunk; i += kThreadsA) {
          const int r = i / kChunk, e = i % kChunk;
          if (r0 + r < n_rows)
            dst[r * kPitch + e] = src[(size_t)r * channels + e];
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // thread tile: outputs 4 mg .. 4 mg + 3 of rows rg + 32 i, i < 4
  const int mg = tid % 8, rg = tid / 8;
  float acc[kRowsT][4];
#pragma unroll
  for (int i = 0; i < kRowsT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage_in(j);
  for (int j = 0; j < total; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage j is in; stage j - 1 is free for j + 3
    stage_in(j + kStages - 1);
    const T* st = ring + (j % kStages) * kStage + rg * kPitch;
    const float* wk = w_s + (j % n_chunks) * kChunk * kMaxMap + 4 * mg;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 x[kRowsT];
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) x[i] = four(st + 32 * i * kPitch + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wk + (kk + e) * kMaxMap);
#pragma unroll
        for (int i = 0; i < kRowsT; ++i) {
          const float xe = part(x[i], e);
          acc[i][0] = fmaf(xe, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xe, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xe, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xe, wv.w, acc[i][3]);
        }
      }
    }
    if (j % n_chunks == n_chunks - 1) {  // the tile's last chunk: write it
      const int r0 = ((int)blockIdx.x + (j / n_chunks) * (int)gridDim.x) *
                     kRowsA;
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) {
        const int row = r0 + rg + 32 * i;
        float y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          y[q] = __fadd_rn(acc[i][q], b_s[4 * mg + q]);
          acc[i][q] = 0.f;
        }
        if (row >= n_rows) continue;
        float* o = out + (size_t)row * n_map + 4 * mg;
        if (n_map % 4 == 0) {
          if (4 * mg < n_map) store<4>(o, y);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * mg + q < n_map) o[q] = y[q];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- phase B: the carry ---------------------------------------------------

constexpr int kWarpsB = 8;
constexpr int kThreadsB = 32 * kWarpsB;

// Voxels a warp owns, for kCpl channels a lane: 8 channels a lane in
// all, one voxel from C = 256 up.
__host__ __device__ constexpr int vox_per_warp(int cpl) {
  return cpl >= 8 ? 1 : 8 / cpl;
}

// Lane l holds channels (j * 32 + l) * kW + e, j < kCpl / kW, e < kW.
template <typename T, int kCpl, int kW>
__global__ void __launch_bounds__(kThreadsB)
    carry_kernel(const T* __restrict__ feats, const int* __restrict__ pix,
                 const float* __restrict__ mapped, const float* __restrict__ b,
                 float* __restrict__ s1, float* __restrict__ s2,
                 float* __restrict__ count, float* __restrict__ s2m,
                 int n_views, int hw, int n_vox, int n_map) {
  constexpr int kVox = vox_per_warp(kCpl);
  constexpr int kPass = kCpl / kW;
  constexpr int kViews = 32 / kVox;  // views one index load covers
  constexpr int kC = 32 * kCpl;
  const int lane = threadIdx.x & 31;
  const int n0 = ((int)blockIdx.x * kWarpsB + (int)(threadIdx.x >> 5)) * kVox;
  if (n0 >= n_vox) return;  // the whole warp

  float a1[kVox][kCpl], a2[kVox][kCpl], am[kVox], cnt[kVox];
#pragma unroll
  for (int k = 0; k < kVox; ++k) {
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      a1[k][c] = 0.f;
      a2[k][c] = 0.f;
    }
    am[k] = 0.f;
    cnt[k] = 0.f;
  }
  const bool has_m = mapped != nullptr && lane < n_map;
  const float bias = has_m ? __ldg(b + lane) : 0.f;
  const size_t view_elems = (size_t)hw * kC;

  for (int v0 = 0; v0 < n_views; v0 += kViews) {
    // lane l: the index of view v0 + l / kVox, voxel n0 + l % kVox
    const int lv = v0 + lane / kVox, ln = n0 + lane % kVox;
    const int lp = lv < n_views && ln < n_vox
                       ? __ldg(pix + (size_t)lv * n_vox + ln)
                       : -1;
    const int nv = min(kViews, n_views - v0);
    for (int i = 0; i < nv; ++i) {
      // the view's rows for the warp's voxels, then their sums
      const int v = v0 + i;
      const T* fv = feats + (size_t)v * view_elems;
      float x[kVox][kCpl], y[kVox];
      int p[kVox];
#pragma unroll
      for (int k = 0; k < kVox; ++k) {
        p[k] = __shfl_sync(0xffffffffu, lp, i * kVox + k);
        y[k] = bias;
        if (p[k] >= 0) {
          const T* row = fv + (size_t)p[k] * kC + lane * kW;
#pragma unroll
          for (int j = 0; j < kPass; ++j)
            load<kW>(row + j * 32 * kW, &x[k][j * kW]);
          if (has_m)
            y[k] = __ldg(mapped + ((size_t)v * hw + p[k]) * n_map + lane);
        }
      }
#pragma unroll
      for (int k = 0; k < kVox; ++k) {
        if (p[k] >= 0) {
#pragma unroll
          for (int c = 0; c < kCpl; ++c) {
            a1[k][c] = __fadd_rn(a1[k][c], x[k][c]);
            a2[k][c] = __fadd_rn(a2[k][c], __fmul_rn(x[k][c], x[k][c]));
          }
          cnt[k] = __fadd_rn(cnt[k], 1.f);
        }
        am[k] = __fadd_rn(am[k], __fmul_rn(y[k], y[k]));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kVox; ++k) {
    const int n = n0 + k;
    if (n >= n_vox) break;
    float* o1 = s1 + (size_t)n * kC + lane * kW;
    float* o2 = s2 + (size_t)n * kC + lane * kW;
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      store<kW>(o1 + j * 32 * kW, &a1[k][j * kW]);
      store<kW>(o2 + j * 32 * kW, &a2[k][j * kW]);
    }
    if (has_m) s2m[(size_t)n * n_map + lane] = am[k];
    if (lane == 0) count[n] = cnt[k];
  }
}

template <typename T, int kCpl>
cudaError_t launch_carry(bool vec, const T* feats, const int* pix,
                         const float* mapped, const float* b, float* s1,
                         float* s2, float* count, float* s2m, int n_views,
                         int hw, int n_vox, int n_map, cudaStream_t s) {
  constexpr int kVec = (int)(16 / sizeof(T)) < kCpl ? (int)(16 / sizeof(T))
                                                   : kCpl;
  constexpr int kTile = kWarpsB * vox_per_warp(kCpl);
  const int blocks = (n_vox + kTile - 1) / kTile;
  if (vec)
    carry_kernel<T, kCpl, kVec><<<blocks, kThreadsB, 0, s>>>(
        feats, pix, mapped, b, s1, s2, count, s2m, n_views, hw, n_vox, n_map);
  else
    carry_kernel<T, kCpl, 1><<<blocks, kThreadsB, 0, s>>>(
        feats, pix, mapped, b, s1, s2, count, s2m, n_views, hw, n_vox, n_map);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_carry(int channels, const void* feats, const int* pix,
                           const float* mapped, const float* b, float* s1,
                           float* s2, float* count, float* s2m, int n_views,
                           int hw, int n_vox, int n_map, cudaStream_t s) {
  const T* f = static_cast<const T*>(feats);
  const bool vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0;
#define K1_CARRY(CPL)                                                         \
  return launch_carry<T, CPL>(vec, f, pix, mapped, b, s1, s2, count, s2m,    \
                              n_views, hw, n_vox, n_map, s)
  switch (channels) {
    case 32: K1_CARRY(1);
    case 64: K1_CARRY(2);
    case 128: K1_CARRY(4);
    case 256: K1_CARRY(8);
    case 512: K1_CARRY(16);
    case 1024: K1_CARRY(32);
    default: return cudaErrorInvalidValue;
  }
#undef K1_CARRY
}

template <typename T, bool kAsync>
cudaError_t launch_mapped_rows(const T* feats, const float* w, const float* b,
                               float* out, int n_rows, int channels,
                               int n_map, size_t smem, cudaStream_t s) {
  auto kernel = mapped_rows_kernel<T, kAsync>;
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
                                                        kThreadsA, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kRowsA - 1) / kRowsA;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = tiles < resident ? tiles : resident;
  kernel<<<blocks, kThreadsA, smem, s>>>(feats, w, b, out, n_rows, channels,
                                         n_map);
  return cudaGetLastError();
}

}  // namespace

// Phase A. feats (rows, C) float32 or bfloat16 (the (V, H*W, C) maps); w
// (C, M) and b (M,) float32; out (rows, M) float32, all contiguous, with C
// a multiple of 32 and 1 <= M <= 32. `smem` is the block's shared memory in
// bytes, as the wrapper sizes it (ops/voxel.py: fusion_smem_bytes); more
// than the device lets a block opt into is refused. Rows are staged with
// 16-byte copies where feats is 16-byte aligned. Returns the cudaError_t of
// the set-up and launch.
extern "C" int fused_mean_cov_mapped_rows(const void* feats, int feats_bf16,
                                          const float* w, const float* b,
                                          float* out, int n_rows,
                                          int channels, int n_map,
                                          long long smem, void* stream) {
  if (channels % kChunk != 0 || channels <= 0 || n_map < 1 ||
      n_map > kMaxMap || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem <= 0 || smem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool async = reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const size_t bytes = static_cast<size_t>(smem);
  if (feats_bf16) {
    const uint16_t* f = static_cast<const uint16_t*>(feats);
    err = async ? launch_mapped_rows<uint16_t, true>(f, w, b, out, n_rows,
                                                     channels, n_map, bytes, s)
                : launch_mapped_rows<uint16_t, false>(f, w, b, out, n_rows,
                                                      channels, n_map, bytes, s);
  } else {
    const float* f = static_cast<const float*>(feats);
    err = async ? launch_mapped_rows<float, true>(f, w, b, out, n_rows,
                                                  channels, n_map, bytes, s)
                : launch_mapped_rows<float, false>(f, w, b, out, n_rows,
                                                   channels, n_map, bytes, s);
  }
  return static_cast<int>(err);
}

// Phase B. feats (V, H*W, C) float32 or bfloat16, C in {32, 64, 128, 256,
// 512, 1024}; pix (V, N) int32; mapped (V, H*W, M) float32 from phase A and
// b (M,), 1 <= M <= 32, or both null; outputs s1, s2 (N, C), count (N,),
// s2m (N, M) float32 (s2m null without the mapped stream), all contiguous.
// The caller checks shapes. Returns the cudaError_t of the launch.
extern "C" int fused_mean_cov_carry(const void* feats, int feats_bf16,
                                    const int* pix, const float* mapped,
                                    const float* b, float* s1, float* s2,
                                    float* count, float* s2m, int n_views,
                                    int hw, int channels, int n_vox,
                                    int n_map, void* stream) {
  if (mapped != nullptr && (n_map < 1 || n_map > kMaxMap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_vox == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feats_bf16 ? dispatch_carry<uint16_t>(channels, feats, pix, mapped, b,
                                            s1, s2, count, s2m, n_views, hw,
                                            n_vox, n_map, s)
                 : dispatch_carry<float>(channels, feats, pix, mapped, b, s1,
                                         s2, count, s2m, n_views, hw, n_vox,
                                         n_map, s);
  return static_cast<int>(err);
}

// The rgb stream. images (V, hw, 3) float32, or bfloat16 where images_bf16
// is set; pix (V, N) int32 (-1 where the pair is dropped), s1 and s2 (N, 3)
// float32, all contiguous; the caller checks shapes. Returns the
// cudaError_t of the launch.
extern "C" int fused_mean_cov_rgb(const void* images, int images_bf16,
                                  const int* pix, float* s1, float* s2,
                                  int n_views, int hw, int n_vox,
                                  void* stream) {
  if (n_views < 0 || hw < 0 || n_vox < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_vox == 0) return 0;
  const int blocks = (n_vox + kThreadsRgb - 1) / kThreadsRgb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (images_bf16)
    rgb_kernel<uint16_t><<<blocks, kThreadsRgb, 0, s>>>(
        static_cast<const uint16_t*>(images), pix, s1, s2, n_views, hw,
        n_vox);
  else
    rgb_kernel<float><<<blocks, kThreadsRgb, 0, s>>>(
        static_cast<const float*>(images), pix, s1, s2, n_views, hw, n_vox);
  return static_cast<int>(cudaGetLastError());
}
