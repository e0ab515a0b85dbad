// B1: COO DSC (y = M w) over voxel-sorted tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dsc.py:dsc_pallas
// (_dsc_kernel).  It computes the same function: for every coefficient k of
// a TilePlan over voxel-sorted coefficients,
//     out[row_block(k) * R + local_row[k], :] += D[atom[k], :] * w[fiber[k]] * value[k]
// The scaling w[fiber] * value, which the reference computes in XLA before
// its call, is fused in here: it is gathered while a tile is staged.
//
// Bound: bytes.  Per coefficient the kernel reads 16 bytes of indices and
// value (14 with bf16 values) and gathers 4 bytes of w, and does 2 * Ntheta
// flops; it writes the (n_row_blocks * R, Ntheta) float output once.  That
// is a few flops per byte, well below the ~20 fp32 flops per byte at which
// an H100 stops waiting on device memory (67 TFLOP/s over 3.35 TB/s).
//
// Design:
//  * One thread block owns one row block (R output rows) at a time.  It
//    walks the contiguous range of tiles the host's tile_ptr gives that row
//    block and writes the R x Ntheta block once, zeros included.  No other
//    block touches those rows: no atomics, and each output element is summed
//    in one fixed order, so results are identical run to run.
//  * Blocks stride over row blocks, with only as many blocks as are resident
//    on the SMs, so the dictionary is staged into shared memory once per
//    block rather than once per row block.  When D does not fit (e.g.
//    Na = 2048 at Ntheta = 96) the same kernel reads it through the
//    read-only cache instead (kSmemD = false).
//  * All threads stage a tile's atoms, rows and scaled values into shared
//    memory with coalesced loads and parallel gathers of w.  Only the
//    tile's real prefix (tile_len) is read, never its padding.
//  * Each thread owns output columns.  Coefficients are voxel-sorted, so a
//    thread sums a run of equal rows in a register and adds it to the
//    shared R x Ntheta accumulator when the row changes; R is a run-time
//    value and no register array is indexed by it.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kMaxThreads) dsc_coo_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_row_blocks, int c_tile, int row_tile,
    int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block_elems = row_tile * n_theta;
  float* s_acc = reinterpret_cast<float*>(smem);             // R x Ntheta
  float* s_scaled = s_acc + block_elems;                      // c_tile
  int* s_atom = reinterpret_cast<int*>(s_scaled + c_tile);    // c_tile
  int* s_row = s_atom + c_tile;                               // c_tile
  T* s_dict = reinterpret_cast<T*>(s_row + c_tile);           // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;

  for (int rb = blockIdx.x; rb < n_row_blocks; rb += gridDim.x) {
    for (int i = threadIdx.x; i < block_elems; i += blockDim.x) s_acc[i] = 0.f;
    const int t_end = tile_ptr[rb + 1];
    for (int t = tile_ptr[rb]; t < t_end; ++t) {
      __syncthreads();  // last tile's readers are done; zeros and D visible
      const int n = tile_len[t];
      const size_t base = static_cast<size_t>(t) * c_tile;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_atom[i] = atoms[base + i];
        s_row[i] = local_row[base + i];
        s_scaled[i] = __ldg(w + fibers[base + i]) * to_float(values[base + i]);
      }
      __syncthreads();
      for (int col = threadIdx.x; col < n_theta; col += blockDim.x) {
        int cur = n > 0 ? s_row[0] : 0;
        float run = 0.f;
        for (int i = 0; i < n; ++i) {
          const int r = s_row[i];
          if (r != cur) {
            s_acc[cur * n_theta + col] += run;
            run = 0.f;
            cur = r;
          }
          run = fmaf(load_dict<kSmemD>(d + s_atom[i] * n_theta + col),
                     s_scaled[i], run);
        }
        if (n > 0) s_acc[cur * n_theta + col] += run;
      }
    }
    __syncthreads();
    float* dst = out + static_cast<size_t>(rb) * block_elems;
    for (int i = threadIdx.x; i < block_elems; i += blockDim.x) dst[i] = s_acc[i];
    __syncthreads();  // the block is written before the next one is zeroed
  }
}

template <typename T>
int dsc_launch(const int* tile_ptr, const int* tile_len, const int* atoms,
               const int* fibers, const T* values, const int* local_row,
               const T* dict, const float* w, float* out, int n_row_blocks,
               int c_tile, int row_tile, int n_atoms, int n_theta,
               cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  int threads = ((n_theta + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = sizeof(float) * (static_cast<size_t>(row_tile) * n_theta
                                       + c_tile)
                      + 2 * sizeof(int) * static_cast<size_t>(c_tile);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(dsc_coo_kernel<T, true>, threads, smem + dict_bytes,
                      n_row_blocks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_coo_kernel<T, true><<<grid, threads, smem + dict_bytes, stream>>>(
        tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,
        n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  } else {
    e = resident_grid(dsc_coo_kernel<T, false>, threads, smem, n_row_blocks,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_coo_kernel<T, false><<<grid, threads, smem, stream>>>(
        tile_ptr, tile_len, atoms, fibers, values, local_row, dict, w, out,
        n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
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
