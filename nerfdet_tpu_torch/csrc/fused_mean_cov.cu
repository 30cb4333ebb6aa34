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
// Phase A: P[v, p, :] = feats[v, p, :] @ W + b for every pixel of every
//   view. Both forms are persistent grids; a block walks tiles of 128 rows,
//   the grid's tiles in step, whose 32-channel chunks a ring of stages
//   fills by 16-byte cp.async copies (element by element where the map is
//   not 16-byte aligned), the first stages in flight while W is staged.
//   - float32 maps (mapped_rows_kernel): fp32 FMAs on the CUDA cores (no
//     TF32: s2m is held to 1e-5). At the flagship (V=50 maps of 60x80,
//     C=256, M=32) it reads 245.8 MB and writes 30.7 MB (~0.083 ms at 3.35
//     TB/s) and does 3.9 GFLOP (~0.059 ms at 67 TFLOP/s): bound by bytes.
//     W (C x 32, zero-padded past M) and b sit in shared memory as float;
//     each thread holds a 4-row x 4-output tile (two 16-byte shared loads
//     per 16 FMAs).
//   - bfloat16 maps (mapped_rows_tc_kernel): the tensor cores. JAX
//     multiplies the widened bf16 rows by the float32 W. Each block splits
//     W exactly into three bfloat16 pieces as it stages it, hi = rn(W), mid
//     = rn(W - hi), lo = rn(W - hi - mid) (each difference exact in float32;
//     the three hold W's 24-bit significand), and every bf16 x bf16 product
//     is exact in float32, so x@lo + x@mid + x@hi is JAX's product up to
//     the order of the sum. A warp owns 32 rows x 16 outputs of the tile;
//     per 16 channels it takes x by ldmatrix.x4 from the ring (rows 80 bytes
//     apart: conflict-free), each piece by one ldmatrix.x4 from its
//     transposed copy Wt[piece][m][C + 8] (the "col" operand: 16 channels
//     of 16 outputs), and issues mma.sync m16n8k16 bf16 -> f32. The pieces
//     are added small to large (lo, mid, hi over the chunk's 32 channels)
//     into a fresh accumulator per chunk, and the chunks are added with
//     separately rounded float adds, then the bias: a tensor core's float32
//     accumulation is not round-to-nearest per add, and this keeps its
//     error to a chunk. At the flagship it reads 122.9 MB of bf16 maps and
//     writes 30.7 MB (~0.046 ms at 3.35 TB/s) against 3 x 3.9 GFLOP (~0.012
//     ms at 989 TFLOP/s): bound by bytes. The pieces take 3 x 32 x (C + 8)
//     x 2 bytes of shared memory, so the ring has 4 stages up to C = 512
//     and 3 at C = 1024.
//
// Phase B (carry_kernel): each warp owns its voxels (one at C >= 256,
//   256 / C of them below) and walks all views in order, with no shared
//   memory and no barrier. One load gives each lane the pixel index of one
//   (view, voxel) pair, 32 views at once at C >= 256, handed out by
//   shuffles. Lane l holds C / 32 channels of each voxel, read with 16-byte
//   loads where the map is 16-byte aligned (one element a load otherwise).
//   Lane m < M adds y^2 with y = P[v, p, m], or b[m] where the view does
//   not see the voxel. On bfloat16 maps the views are walked in groups
//   (kDepth: 4 views at C <= 256): every row and mapped value of a group
//   is requested, raw, before the first is widened and summed, so a warp
//   keeps a group's gathers in flight where it kept one (float32 keeps one
//   view a group: groups read slower there). All warps walk the views in
//   step, so the current views' maps (4.9 MB each in float32 at the
//   flagship) and P (0.6 MB) stay in L2. What bounds it is the gathered
//   rows and mapped values from L2 (640 bytes a valid pair at bf16 C =
//   256), not device memory.
//
// s1, s2 and count use separately rounded multiply and add in view order,
// so they equal the plain PyTorch version bit for bit, in every group
// depth; s2m differs only in the order of the C-long dot product of
// phase A.
//
// The rgb stream (rgb_kernel, the depth_sp configs' path) replaces the
// in-scan rgb branch of the same JAX scan body (nerfdet_tpu/ops/voxel.py,
// fused_mean_cov, `body`: s1e/s2e of the (V, H, W, 3) denormalized images
// gathered at their own projection, depth-gated). The TPU folded it into
// the one scan; here it is a launch of its own, so phase B's register tile
// stays that of every config. A block owns 32 voxels (a lane each) across
// all views, 64 views a pass: each of its 8 warps loads the indices of 8
// views, coalesced across the voxels, all before any is used; each lane
// whose pair is kept requests its pixel at once; the values (0 where the
// pair is dropped) go to shared memory. Then 6 warps sum them, a thread a
// (voxel, channel, s1 or s2), over the pass's views in ascending order. A
// pass pays two dependent memory round trips whatever its 64 views hold,
// and 800 blocks of 8 warps cover the 25,600 voxels of a 40x40x16 volume
// (the next pass's indices requested before a pass is summed read
// slower: kernel_ab.py --ablate-fusion).
// What it must move is the index (4 B a pair), 12 B a kept pair and the
// outputs: 10.2 MB + 12 B x kept pairs at 100 views, about 0.0034 ms at
// 3.35 TB/s when the depth gate keeps a few percent of the pairs. The sums
// use separately rounded multiply and add in view order; a dropped pair
// adds +0, which leaves any sum bitwise as it is (a sum begun at +0 is
// never -0), as the plain version's zero row does. So s1e and s2e equal
// the plain version bit for bit. The images may be bfloat16 (the bf16
// compute path, which rounds them to bfloat16 before the scan): a pixel is
// then 6 bytes, widened to float exactly, and the sums are the same
// float32 sums.

#include <cuda_bf16.h>
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

// kW consecutive elements of T, loaded raw and widened where summed.
template <int kBytes>
struct Bits;
template <>
struct Bits<16> {
  using type = uint4;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<4> {
  using type = unsigned;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <typename T, int kW>
using Raw = typename Bits<kW * (int)sizeof(T)>::type;

template <typename T, int kW>
__device__ __forceinline__ Raw<T, kW> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, kW>*>(p));
}

template <typename T>
__device__ __forceinline__ void widen_word(unsigned u, float* x) {
  if constexpr (sizeof(T) == 4)
    x[0] = __uint_as_float(u);
  else
    unpack2(u, x);
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* x) {
  constexpr int e = 4 / sizeof(T);
  widen_word<T>(v.x, x);
  widen_word<T>(v.y, x + e);
  widen_word<T>(v.z, x + 2 * e);
  widen_word<T>(v.w, x + 3 * e);
}
template <typename T>
__device__ __forceinline__ void widen(const uint2& v, float* x) {
  widen_word<T>(v.x, x);
  widen_word<T>(v.y, x + 4 / sizeof(T));
}
template <typename T>
__device__ __forceinline__ void widen(unsigned v, float* x) {
  widen_word<T>(v, x);
}
template <typename T>
__device__ __forceinline__ void widen(unsigned short v, float* x) {
  x[0] = __uint_as_float(static_cast<unsigned>(v) << 16);
}

// One element as float.
template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  float x;
  widen<T>(load_raw<T, 1>(p), &x);
  return x;
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

constexpr int kVoxRgb = 32;   // voxels a block, a lane each
constexpr int kWarpsRgb = 8;
constexpr int kThreadsRgb = 32 * kWarpsRgb;
constexpr int kAheadRgb = 8;  // views a warp has in flight in a pass
constexpr int kViewsRgb = kWarpsRgb * kAheadRgb;  // views a pass
constexpr int kSummers = 2 * 3 * kVoxRgb;  // a (channel, s1 | s2) a voxel

template <typename T>
__global__ void __launch_bounds__(kThreadsRgb)
    rgb_kernel(const T* __restrict__ images, const int* __restrict__ pix,
               float* __restrict__ s1, float* __restrict__ s2, int n_views,
               int hw, int n_vox) {
  __shared__ float vals[3][kViewsRgb][kVoxRgb];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (int)blockIdx.x * kVoxRgb + lane;
  // the summing threads: warps 0-2 sum channel 0-2's s1, warps 3-5 s2
  const int ch = warp % 3;
  const bool squares = warp >= 3;
  float acc = 0.f;
  for (int v0 = 0; v0 < n_views; v0 += kViewsRgb) {
    int p[kAheadRgb];
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k) {
      const int v = v0 + warp + kWarpsRgb * k;
      p[k] = v < n_views && n < n_vox
                 ? __ldg(pix + static_cast<size_t>(v) * n_vox + n)
                 : -1;
    }
    float x[kAheadRgb][3];
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k) {
      const int v = v0 + warp + kWarpsRgb * k;
      const T* px =
          images + (static_cast<size_t>(v) * hw + (p[k] < 0 ? 0 : p[k])) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) x[k][c] = p[k] >= 0 ? load1(px + c) : 0.f;
    }
    __syncthreads();  // the previous pass's sums are done with vals
#pragma unroll
    for (int k = 0; k < kAheadRgb; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) vals[c][warp + kWarpsRgb * k][lane] = x[k][c];
    __syncthreads();
    if (threadIdx.x < kSummers) {
      const int nv = min(kViewsRgb, n_views - v0);
      if (squares) {
        for (int i = 0; i < nv; ++i) {
          const float xv = vals[ch][i][lane];
          acc = __fadd_rn(acc, __fmul_rn(xv, xv));
        }
      } else {
        for (int i = 0; i < nv; ++i) acc = __fadd_rn(acc, vals[ch][i][lane]);
      }
    }
  }
  if (threadIdx.x < kSummers && n < n_vox)
    (squares ? s2 : s1)[static_cast<size_t>(n) * 3 + ch] = acc;
}

// ---- phase A: the mapped rows ---------------------------------------------

constexpr int kThreadsA = 256;
constexpr int kRowsT = 4;            // rows a thread (float32 form)
constexpr int kRowsA = 32 * kRowsT;  // rows a tile
constexpr int kChunk = 32;           // channels a stage
constexpr int kStages = 4;

// Elements a staged row: a multiple of 16 bytes, and the rows a warp
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

// The block's stage count: its tiles (blockIdx.x + t * gridDim.x) times
// the chunks of a row. The grid walks the tiles in step, so the blocks
// read one window of the maps at a time (an even share of the rows for
// each block read slower on the H100).
__device__ __forceinline__ int block_stages(int n_rows, int n_chunks) {
  const int n_tiles = (n_rows + kRowsA - 1) / kRowsA;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  return my_tiles * n_chunks;
}

// The first row of the block's t-th tile.
__device__ __forceinline__ int tile_row(int t) {
  return ((int)blockIdx.x + t * (int)gridDim.x) * kRowsA;
}

// Stage j of a block's work (chunk j % n_chunks of its tile j / n_chunks)
// into ring slot j % kS, then commit a group (an empty one past the end
// keeps the count).
template <typename T, bool kAsync, int kS>
__device__ __forceinline__ void stage_in(T* ring, const T* __restrict__ feats,
                                         int j, int total, int n_chunks,
                                         int n_rows, int channels) {
  constexpr int kPitch = pitch<T>();
  constexpr int kPieceElems = 16 / sizeof(T);
  constexpr int kPiecesRow = kChunk / kPieceElems;
  constexpr int kPieces = kRowsA * kPiecesRow / kThreadsA;  // a thread
  const int tid = threadIdx.x;
  if (j < total) {
    const int r0 = tile_row(j / n_chunks);
    const T* src = feats + (size_t)r0 * channels + (j % n_chunks) * kChunk;
    T* dst = ring + (j % kS) * (kRowsA * kPitch);
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
  cp_async_commit();
}

// float32 maps. Shared memory: W [channels][kMaxMap] f32, b [kMaxMap] f32,
// then the ring [kStages][kRowsA][pitch<float>()].
template <bool kAsync>
__global__ void __launch_bounds__(kThreadsA)
    mapped_rows_kernel(const float* __restrict__ feats,
                       const float* __restrict__ w, const float* __restrict__ b,
                       float* __restrict__ out, int n_rows, int channels,
                       int n_map) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = pitch<float>();
  constexpr int kStage = kRowsA * kPitch;
  float* w_s = reinterpret_cast<float*>(smem);
  float* b_s = w_s + channels * kMaxMap;
  float* ring = b_s + kMaxMap;
  const int tid = threadIdx.x;

  const int n_chunks = channels / kChunk;
  const int total = block_stages(n_rows, n_chunks);
  // the ring's first stages are in flight while W is staged
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j)
    stage_in<float, kAsync, kStages>(ring, feats, j, total, n_chunks, n_rows,
                                     channels);
#pragma unroll 8
  for (int i = tid; i < channels * kMaxMap; i += kThreadsA) {
    const int k = i / kMaxMap, m = i % kMaxMap;
    w_s[i] = m < n_map ? w[(size_t)k * n_map + m] : 0.f;
  }
  if (tid < kMaxMap) b_s[tid] = tid < n_map ? b[tid] : 0.f;

  // thread tile: outputs 4 mg .. 4 mg + 3 of rows rg + 32 i, i < 4
  const int mg = tid % 8, rg = tid / 8;
  float acc[kRowsT][4];
#pragma unroll
  for (int i = 0; i < kRowsT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage j is in; stage j - 1 is free for j + 3
    stage_in<float, kAsync, kStages>(ring, feats, j + kStages - 1, total,
                                     n_chunks, n_rows, channels);
    const float* st = ring + (j % kStages) * kStage + rg * kPitch;
    const float* wk = w_s + (j % n_chunks) * kChunk * kMaxMap + 4 * mg;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 x[kRowsT];
#pragma unroll
      for (int i = 0; i < kRowsT; ++i)
        x[i] = *reinterpret_cast<const float4*>(st + 32 * i * kPitch + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wk + (kk + e) * kMaxMap);
#pragma unroll
        for (int i = 0; i < kRowsT; ++i) {
          const float xe = e == 0   ? x[i].x
                           : e == 1 ? x[i].y
                           : e == 2 ? x[i].z
                                    : x[i].w;
          acc[i][0] = fmaf(xe, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xe, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xe, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xe, wv.w, acc[i][3]);
        }
      }
    }
    if (j % n_chunks == n_chunks - 1) {  // the tile's last chunk: write it
      const int r0 = tile_row(j / n_chunks);
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

// bfloat16 maps, on the tensor cores.
constexpr int kPiecePad = 8;  // elements past C in a row of a W piece

constexpr int kStagesTc = 4;  // ring stages below C = 1024

__host__ __device__ constexpr int tc_stages(int channels) {
  return channels >= 1024 ? 3 : kStagesTc;
}

// Shared memory of the tensor-core form: b [kMaxMap] f32, the pieces
// Wt [3][kMaxMap][channels + kPiecePad] bf16, the ring
// [stages][kRowsA][pitch<uint16_t>()] bf16.
__host__ __device__ constexpr size_t tc_smem_bytes(int channels) {
  return 4 * kMaxMap + 2 * 3 * kMaxMap * (size_t)(channels + kPiecePad) +
         2 * (size_t)tc_stages(channels) * kRowsA * pitch<uint16_t>();
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp owns rows 32 (warp % 4) .. + 31 of a tile (two 16-row m tiles)
// and outputs 16 (warp / 4) .. + 15 (two 8-output n tiles). Fragment
// layouts of m16n8k16 (g = lane / 4, t = lane % 4): the accumulator holds
// rows g and g + 8, outputs 2t and 2t + 1 of its m and n tile.
template <bool kAsync, int kS>
__global__ void __launch_bounds__(kThreadsA)
    mapped_rows_tc_kernel(const uint16_t* __restrict__ feats,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ out,
                          int n_rows, int channels, int n_map) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = pitch<uint16_t>();
  constexpr int kStage = kRowsA * kPitch;
  const int wpitch = channels + kPiecePad;
  const int piece_elems = kMaxMap * wpitch;
  float* b_s = reinterpret_cast<float*>(smem);
  uint16_t* wt = reinterpret_cast<uint16_t*>(b_s + kMaxMap);
  uint16_t* ring = wt + 3 * piece_elems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int n_chunks = channels / kChunk;
  const int total = block_stages(n_rows, n_chunks);
  // the ring's first stages are in flight while W is split
#pragma unroll
  for (int j = 0; j < kS - 1; ++j)
    stage_in<uint16_t, kAsync, kS>(ring, feats, j, total, n_chunks, n_rows,
                                   channels);
  // W split exactly into hi + mid + lo, transposed, zero past M
#pragma unroll 8
  for (int i = tid; i < channels * kMaxMap; i += kThreadsA) {
    const int k = i / kMaxMap, m = i % kMaxMap;
    const float x = m < n_map ? w[(size_t)k * n_map + m] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    const __nv_bfloat16 lo =
        __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
    uint16_t* dst = wt + m * wpitch + k;
    dst[0] = __bfloat16_as_ushort(lo);
    dst[piece_elems] = __bfloat16_as_ushort(mid);
    dst[2 * piece_elems] = __bfloat16_as_ushort(hi);
  }
  if (tid < kMaxMap) b_s[tid] = tid < n_map ? b[tid] : 0.f;

  const int row_w = 32 * (warp % 4), out_w = 16 * (warp / 4);
  // ldmatrix addresses: x rows row_w + 16 mi + lane % 16, channels
  // 8 (lane / 16) on; a piece's outputs out_w + 8 (lane / 16) + lane % 8,
  // channels 8 ((lane / 8) % 2) on
  const int a_off = (row_w + lane % 16) * kPitch + 8 * (lane / 16);
  const int b_off = (out_w + 8 * (lane / 16) + lane % 8) * wpitch +
                    8 * ((lane / 8) % 2);

  float tot[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[i][n][q] = 0.f;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // stage j is in; stage j - 1 is free for j + kS - 1
    stage_in<uint16_t, kAsync, kS>(ring, feats, j + kS - 1, total, n_chunks,
                                   n_rows, channels);
    const uint16_t* st = ring + (j % kS) * kStage + a_off;
    const uint16_t* wk = wt + b_off + (j % n_chunks) * kChunk;
    unsigned a[2][2][4];  // [16-channel step][m tile]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[ks][mi], st + 16 * mi * kPitch + 16 * ks);
    float acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
#pragma unroll
    for (int piece = 0; piece < 3; ++piece) {  // lo, mid, hi
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned bq[4];  // n tile 0: bq[0..1], n tile 1: bq[2..3]
        ldmatrix_x4(bq, wk + piece * piece_elems + 16 * ks);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][0], a[ks][mi], bq[0], bq[1]);
          mma_bf16(acc[mi][1], a[ks][mi], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tot[i][n][q] = __fadd_rn(tot[i][n][q], acc[i][n][q]);

    if (j % n_chunks == n_chunks - 1) {  // the tile's last chunk: write it
      const int r0 = tile_row(j / n_chunks) + row_w + lane / 4;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = out_w + 8 * n + 2 * (lane % 4);
        const float b0 = b_s[col], b1 = b_s[col + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g, g + 8
            const int row = r0 + 16 * i + 8 * h;
            const float y0 = __fadd_rn(tot[i][n][2 * h], b0);
            const float y1 = __fadd_rn(tot[i][n][2 * h + 1], b1);
            tot[i][n][2 * h] = tot[i][n][2 * h + 1] = 0.f;
            if (row >= n_rows || col >= n_map) continue;
            float* o = out + (size_t)row * n_map + col;
            if (n_map % 2 == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
            } else {
              o[0] = y0;
              if (col + 1 < n_map) o[1] = y1;
            }
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

// Views a group of the walk: about 16 registers of raw rows a lane in
// flight (a lane holds max(8, kCpl) channels of a view: 4 views at bf16 C
// <= 256, 2 at 512, 1 at 1024). float32 keeps one view a group (groups
// of 4 read slower there, and bf16 groups of 8 or 16 slower than 4, on
// the H100: kernel_ab.py --ablate-fusion).
template <typename T>
__host__ __device__ constexpr int group_depth(int cpl) {
  return sizeof(T) == 4 ? 1 : 32 / (cpl > 8 ? cpl : 8);
}

// Lane l holds channels (j * 32 + l) * kW + e, j < kCpl / kW, e < kW.
template <typename T, int kCpl, int kW, int kDepth>
__global__ void __launch_bounds__(kThreadsB)
    carry_kernel(const T* __restrict__ feats, const int* __restrict__ pix,
                 const float* __restrict__ mapped, const float* __restrict__ b,
                 float* __restrict__ s1, float* __restrict__ s2,
                 float* __restrict__ count, float* __restrict__ s2m,
                 int n_views, int hw, int n_vox, int n_map) {
  constexpr int kVox = vox_per_warp(kCpl);
  constexpr int kPass = kCpl / kW;
  constexpr int kViews = 32 / kVox;  // views one index load covers
  constexpr int kGroup = kDepth < kViews ? kDepth : kViews;  // divides it
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
    // lane l: the index of view v0 + l / kVox, voxel n0 + l % kVox (-1
    // past the last view)
    const int lv = v0 + lane / kVox, ln = n0 + lane % kVox;
    const int lp = lv < n_views && ln < n_vox
                       ? __ldg(pix + (size_t)lv * n_vox + ln)
                       : -1;
    const int nv = min(kViews, n_views - v0);
    for (int g = 0; g < nv; g += kGroup) {
      // the group's rows and mapped values for the warp's voxels, all
      // requested, then their sums in view order
      Raw<T, kW> raw[kGroup][kVox][kPass];
      float y[kGroup][kVox];
      int p[kGroup][kVox];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int v = v0 + g + i;
        const T* fv = feats + (size_t)v * view_elems;
#pragma unroll
        for (int k = 0; k < kVox; ++k) {
          p[i][k] = __shfl_sync(0xffffffffu, lp, (g + i) * kVox + k);
          y[i][k] = bias;
          if (p[i][k] >= 0) {
            const T* row = fv + (size_t)p[i][k] * kC + lane * kW;
#pragma unroll
            for (int j = 0; j < kPass; ++j)
              raw[i][k][j] = load_raw<T, kW>(row + j * 32 * kW);
            if (has_m)
              y[i][k] = __ldg(mapped + ((size_t)v * hw + p[i][k]) * n_map +
                              lane);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (g + i >= nv) break;  // past the last view: not even the bias
#pragma unroll
        for (int k = 0; k < kVox; ++k) {
          if (p[i][k] >= 0) {
            float x[kCpl];
#pragma unroll
            for (int j = 0; j < kPass; ++j) widen<T>(raw[i][k][j], x + j * kW);
#pragma unroll
            for (int c = 0; c < kCpl; ++c) {
              a1[k][c] = __fadd_rn(a1[k][c], x[c]);
              a2[k][c] = __fadd_rn(a2[k][c], __fmul_rn(x[c], x[c]));
            }
            cnt[k] = __fadd_rn(cnt[k], 1.f);
          }
          am[k] = __fadd_rn(am[k], __fmul_rn(y[i][k], y[i][k]));
        }
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
  constexpr int kDepth = group_depth<T>(kCpl);
  constexpr int kTile = kWarpsB * vox_per_warp(kCpl);
  const int blocks = (n_vox + kTile - 1) / kTile;
  if (vec)
    carry_kernel<T, kCpl, kVec, kDepth><<<blocks, kThreadsB, 0, s>>>(
        feats, pix, mapped, b, s1, s2, count, s2m, n_views, hw, n_vox, n_map);
  else
    carry_kernel<T, kCpl, 1, kDepth><<<blocks, kThreadsB, 0, s>>>(
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

// A persistent grid of phase A: as many blocks as are resident, at most
// one a tile.
template <typename T>
cudaError_t launch_persistent(void (*kernel)(const T*, const float*,
                                             const float*, float*, int, int,
                                             int),
                              const T* feats, const float* w, const float* b,
                              float* out, int n_rows, int channels, int n_map,
                              size_t smem, cudaStream_t s) {
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

// Shared memory of a phase A block for C channels of float32 or bfloat16
// maps, in bytes. float32: W (C x 32, zero-padded past M) and b as float,
// then the ring [kStages][kRowsA][pitch<float>()]; bfloat16: the
// tensor-core form's (tc_smem_bytes). The launcher sizes its blocks by it;
// ops/voxel.py's fusion_smem_bytes states it for the tests.
extern "C" long long fused_mean_cov_mapped_rows_smem(int feats_bf16,
                                                     int channels) {
  return static_cast<long long>(
      feats_bf16 ? tc_smem_bytes(channels)
                 : 4 * ((size_t)channels * kMaxMap + kMaxMap) +
                       4 * (size_t)kStages * kRowsA * pitch<float>());
}

// Phase A. feats (rows, C) float32 or bfloat16 (the (V, H*W, C) maps); w
// (C, M) and b (M,) float32; out (rows, M) float32, all contiguous, with C
// a multiple of 32 and 1 <= M <= 32. A block takes
// fused_mean_cov_mapped_rows_smem bytes of shared memory; more than the
// device lets a block opt into is refused. float32 maps take the CUDA
// cores, bfloat16 maps the tensor cores. Rows are staged with 16-byte
// copies where feats is 16-byte aligned. Returns the cudaError_t of the
// set-up and launch.
extern "C" int fused_mean_cov_mapped_rows(const void* feats, int feats_bf16,
                                          const float* w, const float* b,
                                          float* out, int n_rows,
                                          int channels, int n_map,
                                          void* stream) {
  if (channels % kChunk != 0 || channels <= 0 || n_map < 1 ||
      n_map > kMaxMap || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem =
      fused_mean_cov_mapped_rows_smem(feats_bf16, channels);
  if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool async = reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const size_t bytes = static_cast<size_t>(smem);
  if (feats_bf16) {
    const uint16_t* f = static_cast<const uint16_t*>(feats);
    const bool three = tc_stages(channels) == 3;
    auto kernel = async ? (three ? mapped_rows_tc_kernel<true, 3>
                                 : mapped_rows_tc_kernel<true, kStagesTc>)
                        : (three ? mapped_rows_tc_kernel<false, 3>
                                 : mapped_rows_tc_kernel<false, kStagesTc>);
    err = launch_persistent(kernel, f, w, b, out, n_rows, channels, n_map,
                            bytes, s);
  } else {
    const float* f = static_cast<const float*>(feats);
    err = launch_persistent(async ? mapped_rows_kernel<true>
                                  : mapped_rows_kernel<false>,
                            f, w, b, out, n_rows, channels, n_map, bytes, s);
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
  const int blocks = (n_vox + kVoxRgb - 1) / kVoxRgb;
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
