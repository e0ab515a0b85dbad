// B1: COO DSC (y = M w) over voxel-sorted tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dsc.py:dsc_pallas
// (_dsc_kernel).  It computes the same function: for every coefficient k of
// a TilePlan over voxel-sorted coefficients,
//     out[row_block(k) * R + local_row[k], :] += D[atom[k], :] * w[fiber[k]] * value[k]
// The scaling w[fiber] * value, which the reference computes in XLA before
// its call, is fused in here.
//
// Bound: bytes.  Per real coefficient the kernel reads 16 bytes of indices
// and value (14 with bf16 values) and gathers 4 bytes of w, and does
// 2 * Ntheta flops; it writes the (n_row_blocks * R, Ntheta) float output
// once.  That is a few flops per byte, well below the ~20 fp32 flops per
// byte at which an H100 stops waiting on device memory.  The output is most
// of the compulsory traffic (100.7 MB of 117 MB at Nv = 262,144,
// Ntheta = 96), so the stores matter as much as the gathers.  At c_tile 256
// a tile holds ~31 real slots, so what holds a kernel back is latency: the
// chain tile_ptr -> tile_len -> slots -> w[fiber] before any sum, and block
// barriers between those steps.
//
// Design (the one of B3, csrc/dsc_sell.cu, over tiles):
//  * A warp owns a contiguous range of row blocks and writes every row of
//    it once, coalesced: zeros for rows that no slot reaches and for row
//    blocks no tile visits.  No other warp touches those rows: no atomics,
//    and each output element is summed in slot order, so results repeat
//    bit for bit.
//  * The warp walks its row blocks' tiles in batches of up to 32 real slots
//    (common.cuh:TileWalk, which reads tile_ptr and tile_len 32 entries at
//    a time): the lanes load a batch's atoms, fibers, values and local rows
//    with one coalesced load each and gather w[fiber] in parallel.  Only a
//    tile's real prefix (tile_len) is read.
//  * Shuffles broadcast each slot; each lane owns columns lane, lane + 32,
//    ... (kCols = ceil(Ntheta / 32) of them) and sums them in registers.
//    Above Ntheta = 128 the walk runs once per 128 columns.
//  * local_row is nondecreasing within a row block, across its tiles too,
//    so a row is finished when the row changes (found for a whole batch by
//    one ballot): the finished row is stored, and the rows skipped between
//    get zeros; after a row block's last slot its remaining rows get zeros.
//    R is a run-time value and no register array is indexed by it.
//  * The loads run ahead of the sums: while a warp sums batch b, batch
//    b + 1's w gathers and batch b + 2's slot loads are in flight.  At
//    c_tile 256 a row block is usually one batch.  The slot loop is
//    unrolled by 4, so the shuffles and shared-memory loads of the next
//    slots issue while one slot's FMAs wait; in a probe on the card that
//    was faster than no unrolling or 2, and level with 8.
//  * Blocks of 512 threads stay resident and stage D into shared memory
//    once (read through the read-only cache when it does not fit,
//    kSmemD = false).  After that one barrier there is none: warps never
//    wait for each other.  ptxas takes 64 registers (two blocks per SM);
//    capping it for three blocks was slower, as were 256-thread blocks
//    and streaming (__stcs) stores of y.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

template <typename T, bool kSmemD, int kCols>
__global__ void __launch_bounds__(kThreads) dsc_coo_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_row_blocks, int c_tile, int row_tile,
    int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_dict = reinterpret_cast<T*>(smem);  // Na x Ntheta
  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
    __syncthreads();
  }
  const T* d = kSmemD ? s_dict : dict;
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * kWarps;
  const int per_warp = (n_row_blocks + n_warps - 1) / n_warps;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
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
            acc[k] = fmaf(load_dict<kSmemD>(drow + col), sc, acc[k]);
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

template <typename T, bool kSmemD, int kCols>
cudaError_t launch_main(const int* tile_ptr, const int* tile_len,
                        const int* atoms, const int* fibers, const T* values,
                        const int* local_row, const T* dict, const float* w,
                        float* out, int n_row_blocks, int c_tile,
                        int row_tile, int n_atoms, int n_theta, size_t smem,
                        cudaStream_t stream) {
  auto kernel = dsc_coo_kernel<T, kSmemD, kCols>;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kThreads, smem,
                                (n_row_blocks + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(
      tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,
      n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  return cudaGetLastError();
}

template <typename T, bool kSmemD>
cudaError_t launch_by_width(const int* tile_ptr, const int* tile_len,
                            const int* atoms, const int* fibers,
                            const T* values, const int* local_row,
                            const T* dict, const float* w, float* out,
                            int n_row_blocks, int c_tile, int row_tile,
                            int n_atoms, int n_theta, size_t smem,
                            cudaStream_t stream) {
#define DSC_COO_ARGS                                                       \
  tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,    \
      n_row_blocks, c_tile, row_tile, n_atoms, n_theta, smem, stream
  switch ((n_theta + 31) / 32) {
    case 1: return launch_main<T, kSmemD, 1>(DSC_COO_ARGS);
    case 2: return launch_main<T, kSmemD, 2>(DSC_COO_ARGS);
    case 3: return launch_main<T, kSmemD, 3>(DSC_COO_ARGS);
    default: return launch_main<T, kSmemD, 4>(DSC_COO_ARGS);
  }
#undef DSC_COO_ARGS
}

template <typename T>
int dsc_launch(const int* tile_ptr, const int* tile_len, const int* atoms,
               const int* fibers, const T* values, const int* local_row,
               const T* dict, const float* w, float* out, int n_row_blocks,
               int c_tile, int row_tile, int n_atoms, int n_theta,
               cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  cudaError_t e;
  if (dict_bytes <= static_cast<size_t>(smem_optin_bytes())) {
    e = launch_by_width<T, true>(tile_ptr, tile_len, atoms, fibers, values,
                                 local_row, dict, w, out, n_row_blocks, c_tile,
                                 row_tile, n_atoms, n_theta, dict_bytes,
                                 stream);
  } else {
    e = launch_by_width<T, false>(tile_ptr, tile_len, atoms, fibers, values,
                                  local_row, dict, w, out, n_row_blocks,
                                  c_tile, row_tile, n_atoms, n_theta, 0,
                                  stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int dsc_coo_f32(const int* tile_ptr, const int* tile_len,
                           const int* atoms, const int* fibers,
                           const float* values, const int* local_row,
                           const float* dict, const float* w, float* out,
                           int n_row_blocks, int c_tile, int row_tile,
                           int n_atoms, int n_theta, void* stream) {
  return dsc_launch<float>(tile_ptr, tile_len, atoms, fibers, values,
                           local_row, dict, w, out, n_row_blocks, c_tile,
                           row_tile, n_atoms, n_theta,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_coo_bf16(const int* tile_ptr, const int* tile_len,
                            const int* atoms, const int* fibers,
                            const __nv_bfloat16* values, const int* local_row,
                            const __nv_bfloat16* dict, const float* w,
                            float* out, int n_row_blocks, int c_tile,
                            int row_tile, int n_atoms, int n_theta,
                            void* stream) {
  return dsc_launch<__nv_bfloat16>(tile_ptr, tile_len, atoms, fibers, values,
                                   local_row, dict, w, out, n_row_blocks,
                                   c_tile, row_tile, n_atoms, n_theta,
                                   static_cast<cudaStream_t>(stream));
}
