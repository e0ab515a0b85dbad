// B4: SELL WC (w = M^T y) over a fiber-row SELL layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wc.py:wc_sell_pallas
// (_wc_sell_kernel).  It computes the same function: for every fiber row r
// of the dense (rows_padded, width) slot arrays of formats/sell.py:SellPhi,
//     out[r] = sum over real slots s of values[r, s] * <D[atoms[r, s], :], Y[voxels[r, s], :]>
// The reference pre-gathers a (rows_padded, width, Ntheta) stream of Y rows
// in XLA before its call (kernels/ops.py:152), 1.23 GB per call at 50,000
// fibers, width 64 and Ntheta 96; here the kernel gathers each Y row itself
// and that stream is never written.
//
// Bound: bytes.  Per real coefficient the kernel reads 12 bytes of index and
// value (10 with bf16 values) and gathers one Ntheta-float row of Y, and
// does 2 * Ntheta flops: well below the ~20 fp32 flops per byte at which an
// H100 stops waiting on device memory.  The Y row gathers dominate; the
// compulsory traffic counts Y once (100 MB at Nv = 262,144, Ntheta = 96),
// and rows of voxels along one streamline recur, so many hit in L2.  What
// decides is how many Y rows each warp has in flight.
//
// Design (B2's, csrc/wc.cu, over SELL rows):
//  * A warp owns a contiguous range of fiber rows, at least kMinRows of
//    them.  It first zeroes their weights (so empty rows and the padding
//    rows past n_rows come out 0), then stores each row's sum once; no
//    other warp touches those weights.
//  * Fiber rows are short (20.6 real slots on average at the smoke size),
//    so a warp that took one row at a time would leave a third of its lanes
//    idle.  Instead common.cuh:SellWalk packs the real slots of the warp's
//    rows into batches of up to 32 that span rows: it reads row_nnz 32
//    rows at a time, scans it over the lanes into each row's end in the
//    packed stream, and each lane finds the row of its slot by a binary
//    search over those ends (five shuffles).  Only each row's real prefix
//    is read.  A batch's slot loads (atom, voxel, value; coalesced) run one
//    batch ahead of its sums.
//  * The warp splits into 4 groups of 8 lanes, one slot each
//    (common.cuh:batch_dots): every lane loads kVecs float4s of the slot's
//    Y row and of D's row (Ntheta = 96: 3 each), so 4 rows are in flight
//    per step and up to 32 per batch.  Ntheta that is not a multiple of 4,
//    or above 128, takes a scalar column loop instead (kVecs = 0).
//  * A segmented scan over the batch's 32 products, keyed by the row (a
//    fixed tree), sums each row's run; the run left open at the batch's end
//    is carried to the next batch in a register.  The lane at a run's end
//    stores it to out[row].
//  * Launch shape: one resident block of 512 threads per SM, at most 128
//    registers a thread (128 and no spill at Ntheta = 96 with D in shared
//    memory), 16 warps: B2's.  Timed on the card against 384 threads at
//    up to 168 registers, two blocks of 256 at 128, one of 256 at up to
//    255 and two of 512 at 64, and against batches that stop at each
//    row's end instead of packing rows (tune/probe_wc_sell.py), it was
//    the fastest.  Blocks stage D into shared memory once
//    (read through the read-only cache when it does not fit, kSmemD =
//    false); after that there is no block barrier.  No atomics: every
//    weight is summed in one fixed order (slots of a batch by the scan's
//    tree, batches in slot order), so a second launch is bit-identical.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Rows a warp owns at the least: fewer would leave batches part-empty where
// rows outnumber warps only a little.
constexpr int kMinRows = 8;

template <typename T, bool kSmemD, int kVecs>
__global__ void __launch_bounds__(kThreads, 1) wc_sell_kernel(
    const int* __restrict__ atoms, const int* __restrict__ voxels,
    const T* __restrict__ values, const int* __restrict__ row_nnz,
    const T* __restrict__ dict, const float* __restrict__ y,
    float* __restrict__ out, int n_rows, int rows_padded, int width,
    int rows_per_warp, int n_atoms, int n_theta) {
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
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const long long first = static_cast<long long>(warp) * rows_per_warp;
  if (first >= rows_padded) return;
  const int r0 = static_cast<int>(first);
  const int r1 = min(r0 + rows_per_warp, rows_padded);

  // zeros first; __syncwarp orders them before the runs' stores below
  for (int i = r0 + lane; i < r1; i += 32) out[i] = 0.f;
  __syncwarp();

  SellWalk walk(row_nnz, r0, min(r1, n_rows), width, lane);
  SellBatch b = walk.next();
  CooSlot s = load_slot(b, atoms, voxels, values, lane);
  int cur = -1;     // row of the run left open by the last batch
  float run = 0.f;  // its sum so far
  while (b.m > 0) {
    const SellBatch b1 = walk.next();
    const CooSlot s1 = load_slot(b1, atoms, voxels, values, lane);

    const bool active = lane < b.m;
    float mine = batch_dots<T, kSmemD, kVecs>(d, y, s.atom, s.other, lane,
                                              n_theta);
    mine = active ? mine * s.value : 0.f;
    const int key = s.row;

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
cudaError_t launch_main(const int* atoms, const int* voxels, const T* values,
                        const int* row_nnz, const T* dict, const float* y,
                        float* out, int n_rows, int rows_padded, int width,
                        int n_atoms, int n_theta, size_t smem,
                        cudaStream_t stream) {
  auto kernel = wc_sell_kernel<T, kSmemD, kVecs>;
  const int block_rows = kWarps * kMinRows;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kThreads, smem,
                                (rows_padded + block_rows - 1) / block_rows,
                                &grid);
  if (e != cudaSuccess) return e;
  const int n_warps = grid * kWarps;
  const int even = (rows_padded + n_warps - 1) / n_warps;
  const int rows_per_warp = even > kMinRows ? even : kMinRows;
  kernel<<<grid, kThreads, smem, stream>>>(
      atoms, voxels, values, row_nnz, dict, y, out, n_rows, rows_padded,
      width, rows_per_warp, n_atoms, n_theta);
  return cudaGetLastError();
}

template <typename T, bool kSmemD>
cudaError_t launch_by_width(int vecs, const int* atoms, const int* voxels,
                            const T* values, const int* row_nnz,
                            const T* dict, const float* y, float* out,
                            int n_rows, int rows_padded, int width,
                            int n_atoms, int n_theta, size_t smem,
                            cudaStream_t stream) {
#define WC_SELL_ARGS                                                       \
  atoms, voxels, values, row_nnz, dict, y, out, n_rows, rows_padded,     \
      width, n_atoms, n_theta, smem, stream
  switch (vecs) {
    case 1: return launch_main<T, kSmemD, 1>(WC_SELL_ARGS);
    case 2: return launch_main<T, kSmemD, 2>(WC_SELL_ARGS);
    case 3: return launch_main<T, kSmemD, 3>(WC_SELL_ARGS);
    case 4: return launch_main<T, kSmemD, 4>(WC_SELL_ARGS);
    default: return launch_main<T, kSmemD, 0>(WC_SELL_ARGS);
  }
#undef WC_SELL_ARGS
}

template <typename T>
int wc_sell_launch(const int* atoms, const int* voxels, const T* values,
                   const int* row_nnz, const T* dict, const float* y,
                   float* out, int n_rows, int rows_padded, int width,
                   int n_atoms, int n_theta, cudaStream_t stream) {
  if (rows_padded <= 0) return static_cast<int>(cudaSuccess);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict = dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  const int vecs = dot_vecs(n_theta, y, dict, stage_dict);
  cudaError_t e;
  if (stage_dict) {
    e = launch_by_width<T, true>(vecs, atoms, voxels, values, row_nnz, dict,
                                 y, out, n_rows, rows_padded, width, n_atoms,
                                 n_theta, dict_bytes, stream);
  } else {
    e = launch_by_width<T, false>(vecs, atoms, voxels, values, row_nnz, dict,
                                  y, out, n_rows, rows_padded, width, n_atoms,
                                  n_theta, 0, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int wc_sell_f32(const int* atoms, const int* voxels,
                           const float* values, const int* row_nnz,
                           const float* dict, const float* y, float* out,
                           int n_rows, int rows_padded, int width,
                           int n_atoms, int n_theta, void* stream) {
  return wc_sell_launch<float>(atoms, voxels, values, row_nnz, dict, y, out,
                               n_rows, rows_padded, width, n_atoms, n_theta,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int wc_sell_bf16(const int* atoms, const int* voxels,
                            const __nv_bfloat16* values, const int* row_nnz,
                            const __nv_bfloat16* dict, const float* y,
                            float* out, int n_rows, int rows_padded,
                            int width, int n_atoms, int n_theta,
                            void* stream) {
  return wc_sell_launch<__nv_bfloat16>(atoms, voxels, values, row_nnz, dict,
                                       y, out, n_rows, rows_padded, width,
                                       n_atoms, n_theta,
                                       static_cast<cudaStream_t>(stream));
}
