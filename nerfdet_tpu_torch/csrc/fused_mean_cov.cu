// K1: view-streaming multi-view voxel fusion (the carry of fused_mean_cov).
//
// Replaces the lax.scan over views in nerfdet_tpu/ops/voxel.py
// (fused_mean_cov, scan body `body`): for every voxel n and view v it
// takes the nearest-pixel feature row of view v (precomputed flat pixel
// index, -1 where the voxel is not seen) and accumulates
//
//   s1[n, c]  += x           s2[n, c] += x * x        count[n] += valid
//   s2m[n, m] += (x @ W + b)[m]^2          (mapped stream, optional)
//
// An invalid view gathers a zero row, so its mapped value is exactly the
// bias b and it adds b^2 to s2m, as the JAX scan does.
//
// What bounds it on an H100 at the flagship shape (V=50 views of 60x80,
// C=256, N=40*40*16=25,600 voxels, W 256x32): the mapped product is
// 2*V*N*C*32 = 21 GFLOP, ~0.31 ms at the 67 TFLOP/s of fp32 CUDA cores,
// against ~0.09 ms to read the f32 feature maps once and write s1/s2.
// So it is bound by operations when the mapped stream is on and by bytes
// (the row gathers) when it is off.
//
// Design: one block owns a tile of TILE voxels and loops over all views
// inside the kernel; the s1/s2 accumulators stay in registers for the
// whole loop (one thread per channel, blockDim.x == C), so nothing but
// the gathered rows and the final sums touch device memory. Gathers are
// coalesced: a warp reads 32 neighbouring channels of one row. For the
// mapped stream the tile's rows are staged in shared memory and each
// thread computes TILE*M/C of the mapped outputs with fp32 FMAs, the
// running squares kept in shared memory. Tensor cores (wgmma on the
// staged rows) and compaction of the valid rows are left for later.
//
// s1, s2 and count use separately rounded multiply and add in view
// order, so they equal the plain PyTorch version bit for bit; only s2m
// depends on the order of the C-long dot product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void fused_mean_cov_kernel(const T* __restrict__ feats,
                                      const int* __restrict__ pix,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      float* __restrict__ s1,
                                      float* __restrict__ s2,
                                      float* __restrict__ count,
                                      float* __restrict__ s2m, int n_views,
                                      int hw, int channels, int n_vox,
                                      int n_map) {
  extern __shared__ float smem[];
  __shared__ int tile_pix[kTile];
  float* rows = smem;                      // [kTile][channels], mapped only
  float* acc_m = smem + kTile * channels;  // [kTile][n_map], mapped only

  const int c = threadIdx.x;  // blockDim.x == channels
  const int n0 = blockIdx.x * kTile;
  const bool mapped = w != nullptr;
  const int n_out = kTile * n_map;

  float a1[kTile], a2[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    a1[i] = 0.f;
    a2[i] = 0.f;
  }
  float cnt = 0.f;  // voxel n0 + c, threads c < kTile
  if (mapped) {
    for (int o = c; o < n_out; o += channels) acc_m[o] = 0.f;
  }

  for (int v = 0; v < n_views; ++v) {
    if (c < kTile) {
      const int n = n0 + c;
      const int p = n < n_vox ? pix[(size_t)v * n_vox + n] : -1;
      tile_pix[c] = p;
      cnt = __fadd_rn(cnt, p >= 0 ? 1.f : 0.f);
    }
    __syncthreads();
    const T* fv = feats + (size_t)v * hw * channels;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int p = tile_pix[i];
      float x = 0.f;
      if (p >= 0) {
        x = to_float(fv[(size_t)p * channels + c]);
        a1[i] = __fadd_rn(a1[i], x);
        a2[i] = __fadd_rn(a2[i], __fmul_rn(x, x));
      }
      if (mapped) rows[i * channels + c] = x;
    }
    __syncthreads();
    if (mapped) {
      for (int o = c; o < n_out; o += channels) {
        const int i = o / n_map;
        const int m = o - i * n_map;
        const float* r = rows + i * channels;
        float acc = 0.f;
        for (int k = 0; k < channels; ++k)
          acc = fmaf(r[k], __ldg(w + (size_t)k * n_map + m), acc);
        const float y = __fadd_rn(acc, __ldg(b + m));
        acc_m[o] = __fadd_rn(acc_m[o], __fmul_rn(y, y));
      }
      // rows and tile_pix are rewritten by the next view
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int n = n0 + i;
    if (n < n_vox) {
      s1[(size_t)n * channels + c] = a1[i];
      s2[(size_t)n * channels + c] = a2[i];
    }
  }
  if (c < kTile && n0 + c < n_vox) count[n0 + c] = cnt;
  if (mapped) {
    for (int o = c; o < n_out; o += channels) {
      const int n = n0 + o / n_map;
      if (n < n_vox) s2m[(size_t)n * n_map + o % n_map] = acc_m[o];
    }
  }
}

}  // namespace

extern "C" int fused_mean_cov_tile() { return kTile; }

// feats (V, H*W, C) float32 or bfloat16; pix (V, N) int32; w (C, M) and
// b (M,) float32 or both null; outputs s1, s2 (N, C), count (N,), s2m
// (N, M) float32. The caller checks shapes; channels must be a multiple
// of 32 and at most 1024. Returns the cudaError_t of the launch.
extern "C" int fused_mean_cov_carry(const void* feats, int feats_bf16,
                                    const int* pix, const float* w,
                                    const float* b, float* s1, float* s2,
                                    float* count, float* s2m, int n_views,
                                    int hw, int channels, int n_vox,
                                    int n_map, void* stream) {
  const int blocks = (n_vox + kTile - 1) / kTile;
  const size_t shmem =
      w != nullptr ? sizeof(float) * (size_t)kTile * (channels + n_map) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    fused_mean_cov_kernel<__nv_bfloat16><<<blocks, channels, shmem, s>>>(
        static_cast<const __nv_bfloat16*>(feats), pix, w, b, s1, s2, count,
        s2m, n_views, hw, channels, n_vox, n_map);
  } else {
    fused_mean_cov_kernel<float><<<blocks, channels, shmem, s>>>(
        static_cast<const float*>(feats), pix, w, b, s1, s2, count, s2m,
        n_views, hw, channels, n_vox, n_map);
  }
  return static_cast<int>(cudaGetLastError());
}
