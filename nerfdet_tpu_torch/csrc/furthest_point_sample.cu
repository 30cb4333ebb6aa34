// K3: iterative farthest-point sampling of one cloud, on a thread-block
// cluster.
//
// Replaces the Pallas TPU kernel nerfdet_tpu/ops/pallas_fps.py
// (fps_pallas -> _fps_kernel): starting from index 0, step i keeps the
// running minimum over steps of the squared distance of every point to
// the last pick, summed over all C columns in column order, and picks the
// first index of its maximum. C is a runtime argument: 3 for D-FPS, more
// for F-FPS over (xyz, features).
//
// What bounds it on an H100: neither bytes (the points are read from
// device memory once) nor operations (~11 per point and step at C = 3),
// but the serial chain of S - 1 argmaxes over the whole cloud. A design
// on one SM re-reads the 480 KB of a 40000-point cloud from L2 through
// that SM every step (~58 GB/s measured: 8.3 us a step).
//
// Design: the cloud is cut into `cluster` contiguous slices of `slice`
// points, one per CTA of a thread-block cluster (1 to 16 CTAs on
// neighbouring SMs). Each CTA copies its slice's C planes into shared
// memory once and keeps its slice's running minimum beside them for the
// whole loop. A step:
//   1. each thread updates its strided points and keeps its (value,
//      index) maximum; warps reduce it (two redux.sync) and write their
//      partials, double-buffered by step parity; one block barrier;
//   2. alone (cluster of 1): every warp reduces the partials itself, the
//      pick's coordinates are read from the slice in shared memory: one
//      barrier a step;
//      in a cluster: warp 0 reduces the partials and writes the CTA's
//      best (value, index, C coordinates) into this step's slot of every
//      CTA's shared memory (distributed shared memory, map_shared_rank);
//      the slots are double-buffered by step parity, so one cluster
//      barrier (arrive.release / wait.acquire) a step suffices; every
//      warp then reduces the cluster's slots itself and takes the pick's
//      coordinates from its slot, never from device memory.
// A tie goes to the smaller index at every level. Distances use
// __fsub_rn/__fmul_rn/__fadd_rn starting from 0, so nvcc cannot contract
// them into FMAs and the indices equal the plain PyTorch version's bit
// for bit. The cluster size and slice are chosen by the caller
// (ops/pointnet.fps_plan), a pure function of (N, C).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kPointsPerThread = 4;

// The warp's best (value, index) in every lane: the largest value, then
// the smallest index. Distances are >= 0, so their bit patterns order as
// unsigned integers and two redux.sync reductions replace a shuffle
// tree; a lane without a point (-inf, n) counts as (0, n), which loses
// to every point, ties included, since a point's index is below n.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned key = __float_as_uint(fmaxf(v, 0.f));
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  i = (int)__reduce_min_sync(0xffffffffu,
                             key == top ? (unsigned)i : 0xffffffffu);
  v = __uint_as_float(top);
}

// Shared memory of a CTA: the slice's planes [c][slice], its running
// minimum [slice], the first pick [c], the warps' partials (values
// [2][32], indices [2][32]) and the slots [2][kMaxCluster][c + 2] (value,
// index bits, coordinates). The caller sizes it (ops/pointnet.py:
// fps_smem_bytes) and passes the byte count.

// kC > 0: C fixed at compile time; kC == 0: C read from c_rt.
template <int kC, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ planes, int* __restrict__ out,
               int n, int c_rt, int n_samples, int slice) {
  extern __shared__ float smem[];
  const int c = kC > 0 ? kC : c_rt;
  int rank = 0, n_ranks = 1;
  if constexpr (kCluster) {
    rank = (int)cg::this_cluster().block_rank();
    n_ranks = (int)cg::this_cluster().num_blocks();
  }
  const int lo = rank * slice;
  const int m = max(0, min(slice, n - lo));  // points of this CTA
  float* pts = smem;                         // [c][slice]
  float* min_dist = pts + (size_t)c * slice;  // [slice]
  float* first = min_dist + slice;            // [c]
  float* part_v = first + c;                  // [2][32]
  int* part_i = reinterpret_cast<int*>(part_v + 64);        // [2][32]
  float* slots = reinterpret_cast<float*>(part_i + 64);     // [2][16][c+2]
  const int sw = c + 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = 0; k < c; ++k)
    for (int j = tid; j < m; j += blockDim.x)
      pts[(size_t)k * slice + j] = planes[(size_t)k * n + lo + j];
  for (int j = tid; j < m; j += blockDim.x) min_dist[j] = INFINITY;
  for (int k = tid; k < c; k += blockDim.x) first[k] = planes[(size_t)k * n];
  if (tid == 0 && rank == 0) out[0] = 0;
  if constexpr (kCluster)
    cg::this_cluster().sync();  // every CTA's shared memory exists
  else
    __syncthreads();

  const float* sel = first;  // coordinates of the last pick,
  int sel_stride = 1;        // sel[k * sel_stride]
  for (int i = 1; i < n_samples; ++i) {
    const int p = i & 1;
    float s[kC > 0 ? kC : 1];
    if constexpr (kC > 0) {
#pragma unroll
      for (int k = 0; k < kC; ++k) s[k] = sel[k * sel_stride];
    }
    float best = -INFINITY;
    int best_i = n;
#pragma unroll 4
    for (int j = tid; j < m; j += blockDim.x) {
      float d = 0.f;
      if constexpr (kC > 0) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          const float diff = __fsub_rn(pts[(size_t)k * slice + j], s[k]);
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
      } else {
        for (int k = 0; k < c; ++k) {
          const float diff =
              __fsub_rn(pts[(size_t)k * slice + j], sel[k * sel_stride]);
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
      }
      const float md = fminf(min_dist[j], d);
      min_dist[j] = md;
      if (md > best) {  // j grows: strict keeps the first index
        best = md;
        best_i = lo + j;
      }
    }
    warp_best(best, best_i);
    if (lane == 0) {
      part_v[p * 32 + warp] = best;
      part_i[p * 32 + warp] = best_i;
    }
    __syncthreads();  // partials written

    if constexpr (!kCluster) {
      best = lane < n_warps ? part_v[p * 32 + lane] : -INFINITY;
      best_i = lane < n_warps ? part_i[p * 32 + lane] : n;
      warp_best(best, best_i);
      sel = pts + best_i;
      sel_stride = slice;
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0) {
        best = lane < n_warps ? part_v[p * 32 + lane] : -INFINITY;
        best_i = lane < n_warps ? part_i[p * 32 + lane] : n;
        warp_best(best, best_i);
        // lane r writes the CTA's best into its slot in CTA r
        if (lane < n_ranks) {
          float* dst = cluster.map_shared_rank(slots, lane) +
                       (p * kMaxCluster + rank) * sw;
          const bool has = best_i < n;  // false only for an empty slice
          dst[0] = best;
          dst[1] = __int_as_float(best_i);
          for (int k = 0; k < c; ++k)
            dst[2 + k] = has ? pts[(size_t)k * slice + (best_i - lo)] : 0.f;
        }
      }
      cluster.sync();  // slots of step i written everywhere
      best = -INFINITY;
      best_i = n;
      if (lane < n_ranks) {
        const float* row = slots + (p * kMaxCluster + lane) * sw;
        best = row[0];
        best_i = __float_as_int(row[1]);
      }
      warp_best(best, best_i);
      // the slices are contiguous: the pick's slot is that of its slice
      sel = slots + (p * kMaxCluster + best_i / slice) * sw + 2;
      sel_stride = 1;
    }
    if (tid == 0 && rank == 0) out[i] = best_i;
  }
}

template <int kC, bool kCluster>
cudaError_t launch(const float* planes, int* out, int n, int c,
                   int n_samples, int cluster, int slice, int threads,
                   size_t smem, cudaStream_t stream) {
  auto kernel = fps_kernel<kC, kCluster>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (!kCluster) {
    kernel<<<1, threads, smem, stream>>>(planes, out, n, c, n_samples, slice);
    return cudaGetLastError();
  }
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, planes, out, n, c, n_samples,
                           slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// planes (C, N) float32; out (n_samples,) int32; the cloud is cut into
// `cluster` (1, 2, 4, 8 or 16) slices of `slice` points, each CTA given
// `smem` bytes of shared memory. The caller checks 1 <= n_samples <= N
// and cluster * slice >= N; a cluster above 16 or a shared-memory size
// above what the device lets a block opt into is refused here. Returns
// the cudaError_t of the set-up and launch.
extern "C" int furthest_point_sample(const float* planes, int* out, int n,
                                     int c, int n_samples, int cluster,
                                     int slice, long long smem,
                                     void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (long long)cluster * slice < n)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem < 0 || smem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (slice + kPointsPerThread - 1) / kPointsPerThread;
  threads = ((threads + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (cluster == 1)
    err = c == 3 ? launch<3, false>(planes, out, n, c, n_samples, 1, slice,
                                    threads, bytes, s)
                 : launch<0, false>(planes, out, n, c, n_samples, 1, slice,
                                    threads, bytes, s);
  else
    err = c == 3 ? launch<3, true>(planes, out, n, c, n_samples, cluster,
                                   slice, threads, bytes, s)
                 : launch<0, true>(planes, out, n, c, n_samples, cluster,
                                   slice, threads, bytes, s);
  return static_cast<int>(err);
}
