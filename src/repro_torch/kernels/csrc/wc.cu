// B2: COO WC (w = M^T y) over fiber-sorted tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wc.py:wc_pallas
// (_wc_kernel).  It computes the same function: for every coefficient k of
// a TilePlan over fiber-sorted coefficients,
//     out[row_block(k) * R + local_row[k]] += value[k] * <D[atom[k], :], Y[voxel[k], :]>
// The reference pre-gathers an (n_tiles, c_tile, Ntheta) stream of Y rows
// in XLA before its call; here the kernel gathers each Y row itself, so no
// Nc x Ntheta stream is ever written to device memory.
//
// Bound: bytes.  Per real coefficient the kernel reads 16 bytes of indices
// and value (14 with bf16 values) and gathers one Ntheta-float Y row, and
// does 2 * Ntheta flops: well below the ~20 fp32 flops per byte at which an
// H100 stops waiting on device memory.  The compulsory traffic counts Y
// once (100.7 MB at Nv = 262,144, Ntheta = 96); fiber order gathers a row
// per slot (0.40 GB at the smoke size if no row hit the 50 MB L2), so what
// decides is how many Y rows each warp has in flight.
//
// Design (the one of B6, csrc/wc_fcoo.cu, simpler here: a fiber block
// belongs wholly to one warp, so there are no carries and no fold):
//  * A warp owns a contiguous range of fiber blocks.  It first zeroes their
//    R weights each (so fibers that no slot reaches come out 0), then
//    stores each fiber's sum once; no other warp touches those weights.
//  * The warp walks its fiber blocks' tiles in batches of up to 32 real
//    slots (common.cuh:TileWalk): each lane loads one slot's atom, voxel,
//    value and local row, coalesced; only a tile's real prefix (tile_len)
//    is read.  Those loads run one batch ahead of the sums.
//  * The warp splits into 4 groups of 8 lanes, one slot each
//    (common.cuh:batch_dots, shared with B6): every lane loads kVecs
//    float4s of the slot's Y row and of D's row (Ntheta = 96: 3 each), so 4
//    rows are in flight per step and up to 32 per batch; three shuffles
//    sum each dot product.  Ntheta that is not a multiple of 4, or above
//    128, takes a scalar column loop instead (kVecs = 0).
//  * Rows in flight per warp and warps per SM pull against each other
//    through the registers.  The launch bounds ask for one resident block
//    of 512 threads per SM: 128 registers a thread (with a 24-byte spill at
//    Ntheta = 96), 16 warps.  In a probe on the card that beat one block
//    of 256 threads at 160 registers (B6's choice), two such blocks at
//    128, three at 80, four blocks of 128 threads at 128 (spilling more)
//    and ptxas's own 59 registers; 384 threads ran level.
//  * A segmented scan over the batch's 32 products, keyed by the output row
//    (a fixed tree), sums each run of one fiber; the run left open at the
//    batch's end is carried to the next batch in a register.  The lane at
//    a run's end stores it to out[rb * R + row].
//  * Blocks stage D into shared memory once (read through the read-only
//    cache when it does not fit, kSmemD = false); after that there is no
//    block barrier.  No atomics: every weight is summed in one fixed order
//    (slots of a batch by the scan's tree, batches in slot order), so a
//    second launch is bit-identical.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kSmemD, int kVecs>
__global__ void __launch_bounds__(kThreads, 1) wc_coo_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ voxels,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ dict, const float* __restrict__ y,
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
  const unsigned upto = kFull >> (31 - lane);
  const int n_warps = gridDim.x * kWarps;
  const int per_warp = (n_row_blocks + n_warps - 1) / n_warps;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int rb0 = min(warp * per_warp, n_row_blocks);
  const int rb1 = min(rb0 + per_warp, n_row_blocks);
  if (rb0 >= rb1) return;

  // zeros first; __syncwarp orders them before the runs' stores below
  for (int i = rb0 * row_tile + lane; i < rb1 * row_tile; i += 32) {
    out[i] = 0.f;
  }
  __syncwarp();

  TileWalk walk(tile_ptr, tile_len, rb0, rb1, c_tile, lane);
  CooBatch b = walk.next();
  CooSlot s = load_slot(b, atoms, voxels, values, local_row, lane);
  int cur = -1;     // output row of the run left open by the last batch
  float run = 0.f;  // its sum so far
  while (b.m > 0) {
    const CooBatch b1 = walk.next();
    const CooSlot s1 = load_slot(b1, atoms, voxels, values, local_row, lane);

    const bool active = lane < b.m;
    float mine = batch_dots<T, kSmemD, kVecs>(d, y, s.atom, s.other, lane,
                                              n_theta);
    mine = active ? mine * s.value : 0.f;
    const int key = b.rb * row_tile + s.row;

    // segmented inclusive scan: x ends as the sum of the lane's run from
    // its first lane in this batch up to the lane
    const int key_up = __shfl_up_sync(kFull, key, 1);
    const unsigned heads =
        __ballot_sync(kFull, active && (lane == 0 || key != key_up));
    const int start = 31 - __clz(heads & upto);
    float x = segmented_scan(mine, start, lane);
    const int key_down = __shfl_down_sync(kFull, key, 1);
    const unsigned ends =
        __ballot_sync(kFull, active && (lane == b.m - 1 || key_down != key));

    // the run left open by the last batch either ends there or goes on in
    // this batch's first run
    const int key0 = __shfl_sync(kFull, key, 0);
    if (cur >= 0 && key0 != cur) {
      if (lane == 0) out[cur] = run;
    } else if (cur >= 0 && start == 0) {
      x += run;
    }
    // runs that end inside the batch are complete; the one at lane m - 1
    // stays open
    const unsigned closing = ends & ~(1u << (b.m - 1));
    if ((closing >> lane) & 1u) out[key] = x;
    run = __shfl_sync(kFull, x, b.m - 1);
    cur = __shfl_sync(kFull, key, b.m - 1);

    b = b1;
    s = s1;
  }
  if (cur >= 0 && lane == 0) out[cur] = run;
}

template <typename T, bool kSmemD, int kVecs>
cudaError_t launch_main(const int* tile_ptr, const int* tile_len,
                        const int* atoms, const int* voxels, const T* values,
                        const int* local_row, const T* dict, const float* y,
                        float* out, int n_row_blocks, int c_tile,
                        int row_tile, int n_atoms, int n_theta, size_t smem,
                        cudaStream_t stream) {
  auto kernel = wc_coo_kernel<T, kSmemD, kVecs>;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kThreads, smem,
                                (n_row_blocks + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(
      tile_ptr, tile_len, atoms, voxels, values, local_row, dict, y, out,
      n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  return cudaGetLastError();
}

template <typename T, bool kSmemD>
cudaError_t launch_by_width(int vecs, const int* tile_ptr,
                            const int* tile_len, const int* atoms,
                            const int* voxels, const T* values,
                            const int* local_row, const T* dict,
                            const float* y, float* out, int n_row_blocks,
                            int c_tile, int row_tile, int n_atoms,
                            int n_theta, size_t smem, cudaStream_t stream) {
#define WC_COO_ARGS                                                        \
  tile_ptr, tile_len, atoms, voxels, values, local_row, dict, y, out,    \
      n_row_blocks, c_tile, row_tile, n_atoms, n_theta, smem, stream
  switch (vecs) {
    case 1: return launch_main<T, kSmemD, 1>(WC_COO_ARGS);
    case 2: return launch_main<T, kSmemD, 2>(WC_COO_ARGS);
    case 3: return launch_main<T, kSmemD, 3>(WC_COO_ARGS);
    case 4: return launch_main<T, kSmemD, 4>(WC_COO_ARGS);
    default: return launch_main<T, kSmemD, 0>(WC_COO_ARGS);
  }
#undef WC_COO_ARGS
}

template <typename T>
int wc_launch(const int* tile_ptr, const int* tile_len, const int* atoms,
              const int* voxels, const T* values, const int* local_row,
              const T* dict, const float* y, float* out, int n_row_blocks,
              int c_tile, int row_tile, int n_atoms, int n_theta,
              cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict = dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  const int vecs = dot_vecs(n_theta, y, dict, stage_dict);
  cudaError_t e;
  if (stage_dict) {
    e = launch_by_width<T, true>(vecs, tile_ptr, tile_len, atoms, voxels,
                                 values, local_row, dict, y, out,
                                 n_row_blocks, c_tile, row_tile, n_atoms,
                                 n_theta, dict_bytes, stream);
  } else {
    e = launch_by_width<T, false>(vecs, tile_ptr, tile_len, atoms, voxels,
                                  values, local_row, dict, y, out,
                                  n_row_blocks, c_tile, row_tile, n_atoms,
                                  n_theta, 0, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int wc_coo_f32(const int* tile_ptr, const int* tile_len,
                          const int* atoms, const int* voxels,
                          const float* values, const int* local_row,
                          const float* dict, const float* y, float* out,
                          int n_row_blocks, int c_tile, int row_tile,
                          int n_atoms, int n_theta, void* stream) {
  return wc_launch<float>(tile_ptr, tile_len, atoms, voxels, values,
                          local_row, dict, y, out, n_row_blocks, c_tile,
                          row_tile, n_atoms, n_theta,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int wc_coo_bf16(const int* tile_ptr, const int* tile_len,
                           const int* atoms, const int* voxels,
                           const __nv_bfloat16* values, const int* local_row,
                           const __nv_bfloat16* dict, const float* y,
                           float* out, int n_row_blocks, int c_tile,
                           int row_tile, int n_atoms, int n_theta,
                           void* stream) {
  return wc_launch<__nv_bfloat16>(tile_ptr, tile_len, atoms, voxels, values,
                                  local_row, dict, y, out, n_row_blocks,
                                  c_tile, row_tile, n_atoms, n_theta,
                                  static_cast<cudaStream_t>(stream));
}
