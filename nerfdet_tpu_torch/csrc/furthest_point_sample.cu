// K3: iterative farthest-point sampling of one cloud.
//
// Replaces the Pallas TPU kernel nerfdet_tpu/ops/pallas_fps.py
// (fps_pallas -> _fps_kernel): starting from index 0, step i keeps the
// running minimum over steps of the squared distance of every point to
// the last pick, summed over all C columns in column order, and picks the
// first index of its maximum. C is a runtime argument: 3 for D-FPS, more
// for F-FPS over (xyz, features).
//
// Design: one block of up to 1024 threads owns the cloud and runs the
// whole serial loop. The points arrive as (C, N) planes, so a warp's
// loads of one column are coalesced; each thread keeps the loads of four
// points in flight (C=3 is compiled apart, so a point's three loads issue
// together). The (N,) running minimum stays in
// dynamic shared memory for the whole loop (4*N bytes: 160 KB at
// N=40000, above the 48 KB default, hence cudaFuncSetAttribute), as the
// Pallas kernel keeps it in VMEM. Each step a thread updates its strided
// points and keeps its (value, index) maximum, warps reduce it with
// shuffles, one warp reduces the warps' partials and broadcasts the
// pick's coordinates through shared memory. A tie goes to the smaller
// index at every level. Distances use __fsub_rn/__fmul_rn/__fadd_rn
// starting from 0, so nvcc cannot contract them into FMAs and the indices
// equal the plain PyTorch version's bit for bit.
//
// What bounds it on an H100: not bytes (the points are read once from
// device memory, then from L1/L2) nor operations (~11 per point and step
// at C=3), but the serial chain of S-1 block-wide reductions, each with
// two barriers, on one SM; at N=40000 each step also re-reads the 480 KB
// of points from L2 through that one SM. The later redesign spreads a
// cloud over a thread-block cluster (points and distances held on chip
// across its SMs, the argmax exchanged through distributed shared
// memory) and batches clouds, one cluster each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// kC > 0: C fixed at compile time (the loads of a point issue together);
// kC == 0: C read from c_rt.
template <int kC>
__global__ void fps_kernel(const float* __restrict__ planes,
                           int* __restrict__ out, int n, int c_rt,
                           int n_samples) {
  extern __shared__ float smem[];
  const int c = kC > 0 ? kC : c_rt;
  float* min_dist = smem;              // [n]
  float* sel = smem + n;               // [c] coordinates of the last pick
  float* part_v = sel + c;             // [kWarps]
  int* part_i = reinterpret_cast<int*>(part_v + kWarps);  // [kWarps]

  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (stride + 31) >> 5;

  for (int j = tid; j < n; j += stride) min_dist[j] = INFINITY;
  for (int k = tid; k < c; k += stride) sel[k] = planes[(size_t)k * n];
  if (tid == 0) out[0] = 0;
  __syncthreads();

  for (int i = 1; i < n_samples; ++i) {
    float best = -INFINITY;
    int best_i = n;
    // kUnroll points per thread per pass, so their loads are in flight
    // together; a thread still visits its points in increasing order
    for (int j0 = tid; j0 < n; j0 += kUnroll * stride) {
      float d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d[u] = 0.f;
#pragma unroll
      for (int k = 0; k < c; ++k) {
        const float s = sel[k];
        const float* col = planes + (size_t)k * n;
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * stride;
          x[u] = j < n ? __ldg(col + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float diff = __fsub_rn(x[u], s);
          d[u] = __fadd_rn(d[u], __fmul_rn(diff, diff));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < n) {
          const float m = fminf(min_dist[j], d[u]);
          min_dist[j] = m;
          if (m > best) {  // j grows: strict keeps the first index
            best = m;
            best_i = j;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      better(best, best_i, ov, oi);
    }
    if (lane == 0) {
      part_v[warp] = best;
      part_i[warp] = best_i;
    }
    __syncthreads();  // partials written
    if (warp == 0) {
      best = lane < n_warps ? part_v[lane] : -INFINITY;
      best_i = lane < n_warps ? part_i[lane] : n;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        better(best, best_i, ov, oi);
      }
      best_i = __shfl_sync(0xffffffffu, best_i, 0);
      if (lane == 0) out[i] = best_i;
      for (int k = lane; k < c; k += 32)
        sel[k] = planes[(size_t)k * n + best_i];
    }
    __syncthreads();  // sel holds the pick; partials free for the next step
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for an (N, C) cloud.
extern "C" int furthest_point_sample_smem_bytes(int n, int c) {
  return static_cast<int>(sizeof(float) * ((size_t)n + c + kWarps) +
                          sizeof(int) * kWarps);
}

// The most dynamic shared memory a block may opt into on `device`.
extern "C" int furthest_point_sample_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return bytes;
}

// planes (C, N) float32; out (n_samples,) int32. The caller checks
// 1 <= n_samples <= N and the shared-memory size. Returns the
// cudaError_t of the set-up and launch.
extern "C" int furthest_point_sample(const float* planes, int* out, int n,
                                     int c, int n_samples, void* stream) {
  const int smem = furthest_point_sample_smem_bytes(n, c);
  auto kernel = c == 3 ? fps_kernel<3> : fps_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, out, n, c, n_samples);
  return static_cast<int>(cudaGetLastError());
}
