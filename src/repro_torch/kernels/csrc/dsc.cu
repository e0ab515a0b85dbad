// B1: COO DSC (y = M w) over voxel-sorted tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dsc.py:dsc_pallas
// (_dsc_kernel).  It computes the same function: for every coefficient k of
// a TilePlan over voxel-sorted coefficients,
//     out[row_block(k) * R + local_row[k], :] += D[atom[k], :] * w[fiber[k]] * value[k]
// The scaling w[fiber] * value, which the reference computes in XLA before
// its call, is fused in here.
//
// Bound: every coefficient reads a whole row of D (Ntheta values) and does
// 2 * Ntheta flops on it, against 16 bytes of indices and value from device
// memory.  At the STN96 shapes (Na 1,024, Ntheta 96, fp32) that is 384 B of
// D a coefficient, 15 GB a call at 3.95e7 coefficients beside 0.57 GB of
// compulsory traffic.  Read from L2 those rows cost more than the rest of
// the kernel; held in shared memory they cost its bandwidth (~32 TB/s on
// the card: ~0.5 ms a call), which is this kernel's floor, above the 0.17 ms
// of device memory.
//
// Design (the main path, dsc_coo_kernel):
//  * Column slices.  The wrapper (kernels/dsc.py:col_slices) picks the least
//    number s of column slices for which one slice of D (a whole number of
//    16-byte vectors per row, zero-padded) and the block's slot staging fit
//    the shared memory one block may opt in to: s = 1 where D fits whole
//    (bf16 at Na 1,024; the toy sizes), 2 for fp32 at Na 1,024 and Ntheta 96
//    (48 columns, 196,608 B a slice).  A block stages its slice once and
//    computes only its columns of y.
//  * A group of s blocks per range of row blocks.  The blocks that own the
//    slices of one range sit side by side in a grid that holds no more
//    blocks than the SMs hold at once, so they run together and walk the
//    same tiles at the same time: the tile stream comes from device memory
//    once and from L2 for the other slices.  Each block writes its own
//    columns of every row of its range, so y is written once, with no
//    atomics and no partial buffers.
//  * Ranges balanced by tiles.  A warp's range of row blocks starts at the
//    row block that holds tile floor(i * n_tiles / n_ranges) (a 32-way search
//    of tile_ptr), so warps get about the same number of slots however the
//    density varies over the volume; a warp per equal count of row blocks
//    left the kernel waiting on its densest warps.
//  * A slot loop built on 16-byte shared loads.  The warp walks its row
//    blocks' tiles in batches of up to 32 real slots (common.cuh:TileWalk):
//    one coalesced load per index array and the w gathers, then each batch's
//    (offset of the atom's row, w * value) is staged once in shared memory.
//    Groups of G lanes take one slot each, 32 / G slots side by side; a
//    lane reads 16-byte vectors lg, lg + G, ... (K of them) of its slot's
//    row of the slice (4 fp32 or 8 bf16 columns each: 12 vectors make a
//    48-column fp32 row) and sums them in registers, in fp32.  G is the
//    fewest of 8, 16 and 32 at which a lane's sums fit kMaxSums registers:
//    8 lanes and K = 2 for the coo-solve slice, 16 for a 96-column fp32 or
//    bf16 row.  At G = 8 a quarter warp's load is one row's 128 contiguous
//    bytes, free of bank conflicts; 4-lane groups (3 vectors a lane, 8
//    slots a step) put two rows in each quarter warp and ran 23% slower at
//    the coo-solve shape, and 8 lanes with 3 vectors a lane on the toy
//    shapes' 96-column rows ran 30% slower than 16 lanes with 2.
//  * local_row is nondecreasing within a row block, across its tiles too, so
//    a batch splits into runs of equal rows (found by one ballot).  When the
//    row changes, the groups' partial sums are added in a fixed tree
//    (log2(32 / G) shuffles), group 0 stores the row, and the rows skipped
//    between get zeros, 32 / n_vec rows a store; after a row block's last
//    slot its remaining rows get zeros.
//    Every element is summed in one order fixed by the tile plan, so a
//    second launch repeats the first bit for bit.
//  * The loads run ahead of the sums: while a warp sums batch b, batch
//    b + 1's w gathers and batch b + 2's slot loads are in flight.  The
//    slot loop is unrolled to keep 4 vectors a lane in flight (4 slots at
//    K = 1 vector a lane, 2 at K = 2); unrolling by 4 at K = 2 spilled
//    under the 64-register cap and ran 8% slower at the coo-solve shape.
//  * 1,024-thread blocks, one per SM beside a 196 KB slice: 32 warps at no
//    more than 64 registers.
//  * Each slice walks the whole tile stream again, so the cost of the walk
//    grows with s while the shared-memory bytes do not.  Past kMaxSlices
//    slices (fp32 D of more than ~1.8 MB at Ntheta 96, e.g. 6,144 atoms),
//    the read-only-cache path (dsc_coo_ldg_kernel) runs: a warp per equal
//    count of row blocks, every slot broadcast by shuffles and each lane
//    summing columns lane, lane + 32, ... of D read through the read-only
//    cache, once per 128 columns.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Main path: D's column slices in shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVecBytes = 16;                  // one shared load of D
constexpr int kMaxSlices = 8;
constexpr int kMaxSums = 8;                    // columns a lane sums

// A staged slot: the byte offset of its atom's row in the slice, and
// w[fiber] * value.
struct SlotEntry {
  int off;
  float scale;
};
constexpr int kStageBytes = kWarps * 32 * sizeof(SlotEntry);

// 16 bytes of D as floats: 4 fp32 or 8 bf16 columns.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kCols = 4;
  __device__ static void fma(const unsigned char* p, float sc,
                             float (&acc)[kCols]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] = fmaf(v.x, sc, acc[0]);
    acc[1] = fmaf(v.y, sc, acc[1]);
    acc[2] = fmaf(v.z, sc, acc[2]);
    acc[3] = fmaf(v.w, sc, acc[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kCols = 8;
  __device__ static void fma(const unsigned char* p, float sc,
                             float (&acc)[kCols]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
    // bf16 is the top half of a float; the lower address holds the low half
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(__uint_as_float(words[i] << 16), sc, acc[2 * i]);
      acc[2 * i + 1] =
          fmaf(__uint_as_float(words[i] & 0xffff0000u), sc, acc[2 * i + 1]);
    }
  }
};

__device__ __forceinline__ float from_float(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_float(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

// The columns one block owns: [c0, c1) of a row of n_theta, n_vec vectors
// of V columns from c0 (those past c1 are padding).
struct Slice {
  int c0, c1, n_vec, n_theta;
  bool vec_ok;  // float4 stores: the rows of y are 16-byte aligned
};

// V values into columns col .. col + V - 1 of an output row, those below c1.
template <int V>
__device__ __forceinline__ void store_vec(float* dst, int col,
                                          const Slice& sl,
                                          const float (&v)[V]) {
  if (sl.vec_ok && col + V <= sl.c1) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(dst + col + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (col + i < sl.c1) dst[col + i] = v[i];
    }
  }
}

// The row being summed is done: add the groups' partial sums (the same
// tree on every lane), store them into output row lo and zeros into rows
// lo + 1 .. hi - 1 of the block's columns; zero the sums.
template <int G, int K, int V>
__device__ __forceinline__ void finish_rows(float* out, size_t lo, size_t hi,
                                            float (&acc)[K][V],
                                            const Slice& sl, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
        acc[k][c] += __shfl_xor_sync(kFull, acc[k][c], o);
      }
    }
  }
  if (lane < G) {
    float* dst = out + lo * sl.n_theta;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane + G * k;
      if (q < sl.n_vec) store_vec<V>(dst, sl.c0 + q * V, sl, acc[k]);
    }
  }
  if (hi - lo > 1) {
    float zeros[V];
#pragma unroll
    for (int c = 0; c < V; ++c) zeros[c] = 0.f;
    if (sl.n_vec > 32) {
      for (size_t r = lo + 1; r < hi; ++r) {
        for (int q = lane; q < sl.n_vec; q += 32) {
          store_vec<V>(out + r * sl.n_theta, sl.c0 + q * V, sl, zeros);
        }
      }
    } else {  // 32 / n_vec rows a store: lane i takes row i / n_vec and
              // vector i % n_vec
      const int per = 32 / sl.n_vec;
      const int zr = lane / sl.n_vec;
      const int col = sl.c0 + (lane - zr * sl.n_vec) * V;
      if (zr < per) {
        for (size_t r = lo + 1 + zr; r < hi; r += per) {
          store_vec<V>(out + r * sl.n_theta, col, sl, zeros);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < V; ++c) acc[k][c] = 0.f;
  }
}

// The least i in [0, n] with a[i] >= t, for a[0..n] nondecreasing and
// a[n] >= t: 32 probes a round, the same answer on every lane.
__device__ __forceinline__ int warp_lower_bound(const int* a, int n, int t,
                                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const int k = __popc(__ballot_sync(kFull, i < hi && a[i] < t));
    if (k == 0) return lo;
    const int base = lo;
    lo = base + (k - 1) * step + 1;
    hi = min(hi, base + k * step);
  }
  return lo;
}

// Row blocks [rb0, rb1) of warp range `range` of n_ranges: ranges cut where
// the tiles are split evenly, at row block boundaries.
__device__ __forceinline__ void balanced_range(const int* tile_ptr,
                                               int n_row_blocks, int range,
                                               int n_ranges, int lane,
                                               int* rb0, int* rb1) {
  const long long n_tiles = tile_ptr[n_row_blocks];
  *rb0 = range == 0 ? 0
                    : warp_lower_bound(
                          tile_ptr, n_row_blocks,
                          static_cast<int>(n_tiles * range / n_ranges), lane);
  *rb1 = range + 1 == n_ranges
             ? n_row_blocks
             : warp_lower_bound(
                   tile_ptr, n_row_blocks,
                   static_cast<int>(n_tiles * (range + 1) / n_ranges), lane);
}

// G lanes share a slot, each summing vectors lane, lane + G, ... (K of them)
// of its row; 32 / G slots run side by side.
template <typename T, int G, int K>
__global__ void __launch_bounds__(kThreads, 1) dsc_coo_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_row_blocks, int c_tile, int row_tile,
    int n_atoms, int n_theta, int n_vec, int n_slices) {
  constexpr int V = Vec<T>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slice = blockIdx.x % n_slices;  // the block's rank in its group
  const int row_cols = n_vec * V;           // a staged row, padding included
  Slice sl;
  sl.c0 = slice * row_cols;
  sl.c1 = min(sl.c0 + row_cols, n_theta);
  sl.n_vec = n_vec;
  sl.n_theta = n_theta;
  sl.vec_ok = n_theta % 4 == 0;

  T* s_dict = reinterpret_cast<T*>(smem);  // Na x row_cols
  for (int i = threadIdx.x; i < n_atoms * row_cols; i += blockDim.x) {
    const int a = i / row_cols;
    const int c = sl.c0 + (i - a * row_cols);
    s_dict[i] = c < sl.c1 ? dict[static_cast<size_t>(a) * n_theta + c]
                          : from_float(0.f, T());
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  SlotEntry* stage =
      reinterpret_cast<SlotEntry*>(smem + static_cast<size_t>(n_atoms) *
                                              n_vec * kVecBytes) +
      warp * 32;
  __syncthreads();

  int rb0, rb1;
  balanced_range(tile_ptr, n_row_blocks,
                 blockIdx.x / n_slices * kWarps + warp,
                 gridDim.x / n_slices * kWarps, lane, &rb0, &rb1);
  if (rb0 >= rb1) return;
  const size_t R = row_tile;
  const int row_bytes = n_vec * kVecBytes;
  const int g = lane / G;
  const int lg = lane % G;

  TileWalk walk(tile_ptr, tile_len, rb0, rb1, c_tile, lane);
  CooBatch b = walk.next();
  CooSlot s = load_slot(b, atoms, fibers, values, local_row, lane);
  float w_s = lane < b.m ? __ldg(w + s.other) : 0.f;
  CooBatch b1 = walk.next();
  CooSlot s1 = load_slot(b1, atoms, fibers, values, local_row, lane);

  int rb = rb0;  // row block and row being summed
  int row = 0;
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < V; ++c) acc[k][c] = 0.f;
  }
  while (b.m > 0) {
    const CooBatch b2 = walk.next();
    const CooSlot s2 = load_slot(b2, atoms, fibers, values, local_row, lane);
    const float w1 = lane < b1.m ? __ldg(w + s1.other) : 0.f;

    if (b.rb != rb) {  // row block rb is done; so are those up to b.rb
      finish_rows<G>(out, rb * R + row, b.rb * R, acc, sl, lane);
      rb = b.rb;
      row = 0;
    }
    __syncwarp();  // the last batch's sums have read the stage
    if (lane < b.m) stage[lane] = SlotEntry{s.atom * row_bytes, w_s * s.value};
    int prev = __shfl_up_sync(kFull, s.row, 1);
    if (lane == 0) prev = row;
    // the slots at which the row changes
    const unsigned heads =
        __ballot_sync(kFull, lane < b.m && s.row != prev);
    __syncwarp();
    // runs of equal rows: [j, e)
    for (int j = 0; j < b.m;) {
      if ((heads >> j) & 1u) {
        const int r = __shfl_sync(kFull, s.row, j);
        finish_rows<G>(out, rb * R + row, rb * R + r, acc, sl, lane);
        row = r;
      }
      const unsigned later = j < 31 ? heads >> (j + 1) : 0u;
      const int e = later ? j + __ffs(later) : b.m;
#pragma unroll (4 / K)
      for (int k = j + g; k < e; k += 32 / G) {
        const SlotEntry en = stage[k];
        const unsigned char* drow = smem + en.off;
#pragma unroll
        for (int v = 0; v < K; ++v) {
          const int q = lg + G * v;
          if (v + 1 < K || q < n_vec) {
            Vec<T>::fma(drow + q * kVecBytes, en.scale, acc[v]);
          }
        }
      }
      j = e;
    }

    b = b1;
    s = s1;
    w_s = w1;
    b1 = b2;
    s1 = s2;
  }
  finish_rows<G>(out, rb * R + row, rb1 * R, acc, sl, lane);
}

// Launches as many blocks as the SMs hold at once, in whole groups of
// n_slices: group i takes warp ranges i * kWarps .. i * kWarps + kWarps - 1,
// its block j the slice j (never more groups than there are row blocks for
// their warps).  The whole grid is resident, so the blocks of a group walk
// the same tiles at the same time.
template <typename T, int G, int K>
cudaError_t launch_slices(const int* tile_ptr, const int* tile_len,
                          const int* atoms, const int* fibers,
                          const T* values, const int* local_row,
                          const T* dict, const float* w, float* out,
                          int n_row_blocks, int c_tile, int row_tile,
                          int n_atoms, int n_theta, int n_vec, int n_slices,
                          cudaStream_t stream) {
  auto kernel = dsc_coo_kernel<T, G, K>;
  const size_t smem =
      static_cast<size_t>(n_atoms) * n_vec * kVecBytes + kStageBytes;
  const int work = (n_row_blocks + kWarps - 1) / kWarps;
  int blocks = 0;
  cudaError_t e =
      resident_grid(kernel, kThreads, smem, work * n_slices, &blocks);
  if (e != cudaSuccess) return e;
  const int grid = blocks / n_slices * n_slices;
  if (grid < n_slices) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, stream>>>(
      tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,
      n_row_blocks, c_tile, row_tile, n_atoms, n_theta, n_vec, n_slices);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Past kMaxSlices: D through the read-only cache
// ---------------------------------------------------------------------------

constexpr int kLdgThreads = 512;
constexpr int kLdgWarps = kLdgThreads / 32;

// Columns c0 + lane + 32k of output rows [lo, hi): `acc` into row lo,
// zeros into the rows after it.
template <int kCols>
__device__ __forceinline__ void store_rows(float* out, size_t lo, size_t hi,
                                           const float (&acc)[kCols], int c0,
                                           int lane, int n_theta) {
  for (size_t r = lo; r < hi; ++r) {
    float* dst = out + r * n_theta;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = c0 + lane + 32 * k;
      if (col < n_theta) dst[col] = r == lo ? acc[k] : 0.f;
    }
  }
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kLdgThreads) dsc_coo_ldg_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ d, const float* __restrict__ w,
    float* __restrict__ out, int n_row_blocks, int c_tile, int row_tile,
    int n_theta) {
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * kLdgWarps;
  const int per_warp = (n_row_blocks + n_warps - 1) / n_warps;
  const int warp = blockIdx.x * kLdgWarps + threadIdx.x / 32;
  const int rb0 = min(warp * per_warp, n_row_blocks);
  const int rb1 = min(rb0 + per_warp, n_row_blocks);
  if (rb0 >= rb1) return;
  const size_t R = row_tile;

  for (int c0 = 0; c0 < n_theta; c0 += 32 * kCols) {
    TileWalk walk(tile_ptr, tile_len, rb0, rb1, c_tile, lane);
    CooBatch b = walk.next();
    CooSlot s = load_slot(b, atoms, fibers, values, local_row, lane);
    float w_s = lane < b.m ? __ldg(w + s.other) : 0.f;
    CooBatch b1 = walk.next();
    CooSlot s1 = load_slot(b1, atoms, fibers, values, local_row, lane);

    int rb = rb0;  // row block and row being summed
    int row = 0;
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    while (b.m > 0) {
      const CooBatch b2 = walk.next();
      const CooSlot s2 = load_slot(b2, atoms, fibers, values, local_row,
                                   lane);
      const float w1 = lane < b1.m ? __ldg(w + s1.other) : 0.f;

      if (b.rb != rb) {  // row block rb is done; so are those up to b.rb
        store_rows(out, rb * R + row, b.rb * R, acc, c0, lane, n_theta);
        rb = b.rb;
        row = 0;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
      }
      const float scaled = w_s * s.value;
      int prev = __shfl_up_sync(kFull, s.row, 1);
      if (lane == 0) prev = row;
      // the slots at which the row changes
      const unsigned heads =
          __ballot_sync(kFull, lane < b.m && s.row != prev);
#pragma unroll 4
      for (int j = 0; j < b.m; ++j) {
        if ((heads >> j) & 1u) {
          const int r = __shfl_sync(kFull, s.row, j);
          store_rows(out, rb * R + row, rb * R + r, acc, c0, lane,
                     n_theta);
          row = r;
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
        }
        const T* drow = d + __shfl_sync(kFull, s.atom, j) * n_theta;
        const float sc = __shfl_sync(kFull, scaled, j);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int col = c0 + lane + 32 * k;
          if (col < n_theta) {
            acc[k] = fmaf(load_dict<false>(drow + col), sc, acc[k]);
          }
        }
      }

      b = b1;
      s = s1;
      w_s = w1;
      b1 = b2;
      s1 = s2;
    }
    store_rows(out, rb * R + row, rb1 * R, acc, c0, lane, n_theta);
  }
}

template <typename T, int kCols>
cudaError_t launch_ldg(const int* tile_ptr, const int* tile_len,
                       const int* atoms, const int* fibers, const T* values,
                       const int* local_row, const T* dict, const float* w,
                       float* out, int n_row_blocks, int c_tile, int row_tile,
                       int n_theta, cudaStream_t stream) {
  auto kernel = dsc_coo_ldg_kernel<T, kCols>;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kLdgThreads, 0,
                                (n_row_blocks + kLdgWarps - 1) / kLdgWarps,
                                &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kLdgThreads, 0, stream>>>(tile_ptr, tile_len, atoms, fibers,
                                           values, local_row, dict, w, out,
                                           n_row_blocks, c_tile, row_tile,
                                           n_theta);
  return cudaGetLastError();
}

template <typename T>
int dsc_launch(const int* tile_ptr, const int* tile_len, const int* atoms,
               const int* fibers, const T* values, const int* local_row,
               const T* dict, const float* w, float* out, int n_row_blocks,
               int c_tile, int row_tile, int n_atoms, int n_theta,
               int n_slices, cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  if (n_slices < 0 || n_slices > kMaxSlices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DSC_COO_ARGS                                                       \
  tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,    \
      n_row_blocks, c_tile, row_tile
  cudaError_t e;
  if (n_slices > 0) {
    constexpr int V = Vec<T>::kCols;
    const int n_vec = ((n_theta + V - 1) / V + n_slices - 1) / n_slices;
#define DSC_SLICE_ARGS DSC_COO_ARGS, n_atoms, n_theta, n_vec, n_slices, stream
    // the fewest lanes a slot (8, 16, 32) at which a lane's sums fit
    // kMaxSums registers
    int lanes = 8;
    while (lanes < 32 && (n_vec + lanes - 1) / lanes * V > kMaxSums) {
      lanes *= 2;
    }
    const int k = (n_vec + lanes - 1) / lanes;
    constexpr int kTwo = kMaxSums / V >= 2 ? 2 : 1;  // fp32: 2 vectors a lane
    if (k * V > kMaxSums) {
      e = cudaErrorInvalidValue;
    } else if (lanes == 8) {
      e = k == 1 ? launch_slices<T, 8, 1>(DSC_SLICE_ARGS)
                 : launch_slices<T, 8, kTwo>(DSC_SLICE_ARGS);
    } else if (lanes == 16) {
      e = k == 1 ? launch_slices<T, 16, 1>(DSC_SLICE_ARGS)
                 : launch_slices<T, 16, kTwo>(DSC_SLICE_ARGS);
    } else {
      e = k == 1 ? launch_slices<T, 32, 1>(DSC_SLICE_ARGS)
                 : launch_slices<T, 32, kTwo>(DSC_SLICE_ARGS);
    }
#undef DSC_SLICE_ARGS
  } else {
    switch ((n_theta + 31) / 32) {
      case 1: e = launch_ldg<T, 1>(DSC_COO_ARGS, n_theta, stream); break;
      case 2: e = launch_ldg<T, 2>(DSC_COO_ARGS, n_theta, stream); break;
      case 3: e = launch_ldg<T, 3>(DSC_COO_ARGS, n_theta, stream); break;
      default: e = launch_ldg<T, 4>(DSC_COO_ARGS, n_theta, stream);
    }
  }
#undef DSC_COO_ARGS
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per storage type of D and the values.  n_slices is
// kernels/dsc.py:col_slices's count (0: the read-only-cache path).  Each
// returns cudaGetLastError() after its launch (0 = launched).
extern "C" int dsc_coo_f32(const int* tile_ptr, const int* tile_len,
                           const int* atoms, const int* fibers,
                           const float* values, const int* local_row,
                           const float* dict, const float* w, float* out,
                           int n_row_blocks, int c_tile, int row_tile,
                           int n_atoms, int n_theta, int n_slices,
                           void* stream) {
  return dsc_launch<float>(tile_ptr, tile_len, atoms, fibers, values,
                           local_row, dict, w, out, n_row_blocks, c_tile,
                           row_tile, n_atoms, n_theta, n_slices,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_coo_bf16(const int* tile_ptr, const int* tile_len,
                            const int* atoms, const int* fibers,
                            const __nv_bfloat16* values, const int* local_row,
                            const __nv_bfloat16* dict, const float* w,
                            float* out, int n_row_blocks, int c_tile,
                            int row_tile, int n_atoms, int n_theta,
                            int n_slices, void* stream) {
  return dsc_launch<__nv_bfloat16>(tile_ptr, tile_len, atoms, fibers, values,
                                   local_row, dict, w, out, n_row_blocks,
                                   c_tile, row_tile, n_atoms, n_theta,
                                   n_slices,
                                   static_cast<cudaStream_t>(stream));
}
