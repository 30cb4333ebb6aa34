// A stable counting sort per view, the index preparation of K1's and K2's
// backward kernels (csrc/fused_mean_cov_backward.cu,
// csrc/streaming_sample_mean_var_backward.cu).
//
// Each of V views holds N items with an int32 key. An item's bin is
// key + v * key_step + key_bias; a bin outside [0, nb) drops the item. The
// sort lists every kept item of bin b of view v in ascending item order,
// views in order, bins in order; integer atomics only count, so the
// placement does not depend on their order and two runs give the same
// bits. Four launches:
//
// count_kernel: a block a tile of kTile items of one view, a histogram of
//   its nb bins in shared memory, written to hist's rows (V, J, nb) with
//   the tile's kept count in tile_kept (V, J), J = ceil(N / kTile).
// tile_scan_kernel: a thread a bin of one view, many blocks a view (one
//   block a view walking every tile is slow where V is small). In place,
//   each count of the bin becomes the sum of the view's tiles before it;
//   the bin's total goes to hist's last V rows, tot (V, nb).
// scan_kernel: a block a view. The view's exclusive scan of its bins'
//   totals, and from it `off`; then tot in place becomes where bin b of
//   view v starts in the output. Optionally the view's non-empty bins,
//   compacted.
// place_kernel: a block a tile cut into up to kPlaceWarps parts, each
//   with its own cursors in shared memory: the bin's start plus the
//   tile's row of tile_scan_kernel plus the counts of the parts before.
//   All kPlaceThreads threads count the parts and set the cursors (a few
//   placing warps alone wait on every load where V is small); then a warp
//   a part walks it 32 items a round in item order; the lanes of one bin
//   (found by a ballot a bit of the bin) take consecutive places in lane
//   order, the bin's last lane advances its cursor. It writes each kept
//   item at its place (`order`), or its place at the item (`rank`, the
//   inverse), or both.
//
// Two layouts:
// - global (K2): positions run over all views, viewbase + the view's scan;
//   off (V nb + 1): off[v nb + b] where bin b of view v starts, the last
//   entry the kept total.
// - per view (K1): positions v N + the view's scan, every item kept; off
//   (V, nb): off[v, b] = the start of bin b + 1 in the view (bin 0 holds
//   the items K1 sorts first), so off[v, nb - 1] = N. The non-empty bins
//   b >= 1 come out as rows b - 1 (V, nb - 1), -1 past the view's count.
//
// The bytes are the keys read three times, the kept items' indices (or
// places) written once and the histograms (4 V J nb bytes) written, read,
// rewritten and read again. Every loop over global memory loads kAhead
// values before it uses the first.

#pragma once

#include <cuda_runtime.h>

namespace csort {

constexpr int kTile = 8192;  // items of one view a tile holds
constexpr int kCountThreads = 256;
constexpr int kTileScanThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kAhead = 8;  // rounds of keys a placing warp loads ahead
constexpr int kPlaceWarps = 4;  // placing warps a tile, at most
constexpr int kPlaceThreads = 512;

__device__ __forceinline__ void tile_range(int n, int* beg, int* end) {
  *beg = blockIdx.x * kTile;
  *end = min(*beg + kTile, n);
}

__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const int* __restrict__ keys, int* __restrict__ hist,
                 int* __restrict__ tile_kept, int n, int nb, int key_step,
                 int key_bias) {
  extern __shared__ int h[];  // nb bins, then the tile's kept count
  const int v = blockIdx.y, tiles = gridDim.x;
  for (int b = threadIdx.x; b <= nb; b += kCountThreads) h[b] = 0;
  __syncthreads();
  int beg, end;
  tile_range(n, &beg, &end);
  const int* kv = keys + (size_t)v * n;
  const int shift = v * key_step + key_bias;
  int kept = 0;
  for (int i0 = beg + threadIdx.x; i0 < end; i0 += kAhead * kCountThreads) {
    int bin[kAhead];  // kAhead loads in flight before the first atomic
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = i0 + k * kCountThreads;
      bin[k] = i < end ? __ldg(kv + i) + shift : -1;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (bin[k] >= 0 && bin[k] < nb) {
        atomicAdd(h + bin[k], 1);
        ++kept;
      }
    }
  }
  if (kept) atomicAdd(h + nb, kept);
  __syncthreads();
  int* row = hist + ((size_t)v * tiles + blockIdx.x) * nb;
  for (int b = threadIdx.x; b < nb; b += kCountThreads) row[b] = h[b];
  if (threadIdx.x == 0) tile_kept[v * tiles + blockIdx.x] = h[nb];
}

// Exclusive scan of one value a thread over the block, in thread order;
// returns the thread's prefix and sets *total. `red` holds 32 ints.
__device__ __forceinline__ int block_scan(int x, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? red[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    red[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int out = (warp ? red[warp - 1] : 0) + inc - x;
  *total = red[(blockDim.x >> 5) - 1];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kTileScanThreads)
    tile_scan_kernel(int* __restrict__ hist, int* __restrict__ tot,
                     int tiles, int nb) {
  const int v = blockIdx.y;
  const int b = blockIdx.x * kTileScanThreads + threadIdx.x;
  if (b >= nb) return;
  int* hb = hist + (size_t)v * tiles * nb + b;
  int s = 0;
  for (int j0 = 0; j0 < tiles; j0 += kAhead) {
    int c[kAhead];  // kAhead loads in flight
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      c[k] = j0 + k < tiles ? hb[(size_t)(j0 + k) * nb] : 0;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j0 + k < tiles) hb[(size_t)(j0 + k) * nb] = s;
      s += c[k];
    }
  }
  tot[(size_t)v * nb + b] = s;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ tot, const int* __restrict__ tile_kept,
                int* __restrict__ off, int* __restrict__ rows,
                int* __restrict__ n_rows, int n_views, int tiles, int n,
                int nb, int per_view) {
  extern __shared__ int t[];  // nb + 1: the bins' totals, then their scan
  __shared__ int red[32];
  const int v = blockIdx.x;
  int* tv = tot + (size_t)v * nb;
  for (int b0 = threadIdx.x; b0 < nb; b0 += kAhead * kScanThreads) {
    int c[kAhead];  // kAhead loads in flight
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int b = b0 + k * kScanThreads;
      c[k] = b < nb ? tv[b] : 0;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int b = b0 + k * kScanThreads;
      if (b < nb) t[b] = c[k];
    }
  }
  // the view's start: v N, or the kept items of the views before it
  int base = 0;
  if (per_view) {
    base = v * n;
  } else {
    int s = 0;
    for (int k = threadIdx.x; k < v * tiles; k += kScanThreads)
      s += __ldg(tile_kept + k);
    int total;
    block_scan(s, red, &total);  // its total is the sum
    base = total;
  }
  __syncthreads();
  // each thread scans a contiguous run of bins
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = min((int)threadIdx.x * per, nb), b1 = min(b0 + per, nb);
  int sum = 0, nonempty = 0;
  for (int b = b0; b < b1; ++b) {
    sum += t[b];
    nonempty += (b >= 1 && t[b] > 0);
  }
  int total, n_ref;
  int run = block_scan(sum, red, &total);
  int ref = block_scan(nonempty, red, &n_ref);
  for (int b = b0; b < b1; ++b) {
    const int c = t[b];
    if (rows != nullptr && b >= 1 && c > 0)
      rows[(size_t)v * (nb - 1) + ref++] = b - 1;
    t[b] = run;
    run += c;
  }
  if (threadIdx.x == 0) t[nb] = total;
  __syncthreads();
  if (per_view) {
    for (int b = threadIdx.x; b < nb; b += kScanThreads)
      off[(size_t)v * nb + b] = t[b + 1];
  } else {
    for (int b = threadIdx.x; b < nb; b += kScanThreads)
      off[(size_t)v * nb + b] = base + t[b];
    if (v == n_views - 1 && threadIdx.x == 0)
      off[(size_t)n_views * nb] = base + total;
  }
  if (rows != nullptr) {
    for (int k = n_ref + threadIdx.x; k < nb - 1; k += kScanThreads)
      rows[(size_t)v * (nb - 1) + k] = -1;
    if (threadIdx.x == 0) n_rows[v] = n_ref;
  }
  // the bins' starts in the output
  for (int b = threadIdx.x; b < nb; b += kScanThreads) tv[b] = base + t[b];
}

// `parts` (up to kPlaceWarps) equal parts of a tile, warp w placing the
// w-th. For kept item i of view v, item = v item_step + i:
// `order[place] = item` and `rank[item] = place`, each where not null.
__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const int* __restrict__ keys, const int* __restrict__ base,
                 const int* __restrict__ start, int* __restrict__ order,
                 int* __restrict__ rank, int n, int nb, int key_step,
                 int key_bias, int item_step, int parts) {
  extern __shared__ int cur[];  // a part's nb cursors after another's
  const int v = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int beg, end;
  tile_range(n, &beg, &end);
  const int part = kTile / parts;
  const int* kv = keys + (size_t)v * n;
  const int shift = v * key_step + key_bias;
  // each part's histogram, then per bin the parts' cursors: the tile's
  // start plus the parts before
  for (int i = threadIdx.x; i < parts * nb; i += kPlaceThreads) cur[i] = 0;
  __syncthreads();
  for (int i0 = beg + threadIdx.x; i0 < end; i0 += kAhead * kPlaceThreads) {
    int bin[kAhead];  // kAhead loads in flight before the first atomic
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = i0 + k * kPlaceThreads;
      bin[k] = i < end ? __ldg(kv + i) + shift : -1;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = i0 + k * kPlaceThreads;
      if (bin[k] >= 0 && bin[k] < nb)
        atomicAdd(cur + (i - beg) / part * nb + bin[k], 1);
    }
  }
  __syncthreads();
  const int* row = base + ((size_t)v * gridDim.x + blockIdx.x) * nb;
  const int* sv = start + (size_t)v * nb;
  for (int b0 = threadIdx.x; b0 < nb; b0 += kAhead * kPlaceThreads) {
    int at[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int b = b0 + k * kPlaceThreads;
      at[k] = b < nb ? __ldg(row + b) + __ldg(sv + b) : 0;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int b = b0 + k * kPlaceThreads;
      if (b >= nb) break;
      for (int w = 0; w < parts; ++w) {
        const int c = cur[w * nb + b];
        cur[w * nb + b] = at[k];
        at[k] += c;
      }
    }
  }
  __syncthreads();
  if (warp >= parts) return;  // no barrier below
  const int my_beg = min(beg + warp * part, end);
  const int my_end = min(my_beg + part, end);
  int* mine = cur + warp * nb;
  const unsigned below = (1u << lane) - 1u;
  const int bits = 32 - __clz(nb);  // bins and nb, the dropped items' value
  // the next kAhead rounds' keys load while this group is placed
  int next[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int i = my_beg + 32 * k + lane;
    next[k] = i < my_end ? __ldg(kv + i) + shift : -1;
  }
  for (int i0 = my_beg; i0 < my_end; i0 += 32 * kAhead) {
    int bin[kAhead];
    unsigned peers[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      bin[k] = next[k] >= 0 && next[k] < nb ? next[k] : nb;
      peers[k] = 0xffffffffu;
      const int i = i0 + 32 * (kAhead + k) + lane;
      next[k] = i < my_end ? __ldg(kv + i) + shift : -1;
    }
    // the lanes of each round with this lane's bin: a ballot a bit, the
    // rounds' ballots independent of each other
    for (int j = 0; j < bits; ++j) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const bool one = (bin[k] >> j) & 1;
        const unsigned set = __ballot_sync(0xffffffffu, one);
        peers[k] &= one ? set : ~set;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const bool keep = bin[k] < nb;
      int at = 0;
      if (keep) at = mine[bin[k]] + __popc(peers[k] & below);
      __syncwarp();
      if (keep) {
        const int item = v * item_step + i0 + 32 * k + lane;
        if (order != nullptr) order[at] = item;
        if (rank != nullptr) rank[item] = at;
        if (lane == 31 - __clz(peers[k])) mine[bin[k]] = at + 1;
      }
      __syncwarp();
    }
  }
}

inline int tiles_for(int n) { return (n + kTile - 1) / kTile; }

// Lets `kernel` take `bytes` of dynamic shared memory, or refuses more than
// a block may opt into.
inline cudaError_t fit_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)most) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The four launches. hist (V J + V, nb) and tile_kept (V, J) are
// scratch. order / rank, rows / n_rows may be null.
inline cudaError_t sort(const int* keys, int* hist, int* tile_kept,
                        int* order, int* rank, int* off, int* rows,
                        int* n_rows,
                        int n_views, int n, int nb, int key_step,
                        int key_bias, int per_view, int item_step,
                        cudaStream_t s) {
  if (n_views == 0 || n == 0) return cudaSuccess;
  const int tiles = tiles_for(n);
  const dim3 grid(tiles, n_views);
  const size_t smem = (size_t)(nb + 1) * sizeof(int);
  cudaError_t err = fit_smem((const void*)count_kernel, smem);
  if (err == cudaSuccess) err = fit_smem((const void*)scan_kernel, smem);
  // as many parts as their cursors fit in shared memory
  int parts = kPlaceWarps;
  while (err == cudaSuccess) {
    err = fit_smem((const void*)place_kernel, (size_t)parts * nb * 4);
    if (err != cudaErrorInvalidValue || parts == 1) break;
    parts /= 2;
    err = cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  count_kernel<<<grid, kCountThreads, smem, s>>>(keys, hist, tile_kept, n,
                                                 nb, key_step, key_bias);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int* tot = hist + (size_t)n_views * tiles * nb;
  const dim3 bins((nb + kTileScanThreads - 1) / kTileScanThreads, n_views);
  tile_scan_kernel<<<bins, kTileScanThreads, 0, s>>>(hist, tot, tiles, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<n_views, kScanThreads, smem, s>>>(
      tot, tile_kept, off, rows, n_rows, n_views, tiles, n, nb, per_view);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  place_kernel<<<grid, kPlaceThreads, (size_t)parts * nb * 4, s>>>(
      keys, hist, tot, order, rank, n, nb, key_step, key_bias, item_step,
      parts);
  return cudaGetLastError();
}

}  // namespace csort
