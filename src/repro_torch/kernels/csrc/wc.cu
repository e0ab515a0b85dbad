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
// Bound: bytes.  Per coefficient the kernel reads 16 bytes of indices and
// value (14 with bf16 values) and gathers one Ntheta-float row of Y, and
// does 2 * Ntheta flops: well below the ~20 fp32 flops per byte at which an
// H100 stops waiting on device memory.  The Y row gathers dominate; rows
// of neighbouring voxels recur along a streamline, so many hit in L2.
//
// Design:
//  * One thread block owns one fiber block (R fibers) at a time, walks the
//    contiguous range of tiles the host's tile_ptr gives it, and writes the
//    R weights once, zeros included.  No atomics; each weight is summed in
//    one fixed order, so results are identical run to run.
//  * Blocks stride over fiber blocks with only as many blocks as are
//    resident, staging D into shared memory once per block; when D does not
//    fit it is read through the read-only cache (kSmemD = false).
//  * A tile's atoms, voxels, rows and values are staged into shared memory
//    by all threads; only its real prefix (tile_len) is read.
//  * Each warp takes a contiguous chunk of the tile.  Per coefficient the
//    warp's lanes stride over Ntheta (coalesced loads of the Y row and the D
//    row), and a butterfly of shuffles sums the dot product.  Coefficients
//    are fiber-sorted, so lane 0 sums a run of equal fibers in a register
//    and adds it to the warp's slot of a shared (warps x R) table when the
//    fiber changes; at the end of the fiber block the R weights are summed
//    over the warps in warp order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kThreads) wc_coo_kernel(
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_len,
    const int* __restrict__ atoms, const int* __restrict__ voxels,
    const T* __restrict__ values, const int* __restrict__ local_row,
    const T* __restrict__ dict, const float* __restrict__ y,
    float* __restrict__ out, int n_row_blocks, int c_tile, int row_tile,
    int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem);           // warps x R
  float* s_val = s_part + kWarps * row_tile;                 // c_tile
  int* s_atom = reinterpret_cast<int*>(s_val + c_tile);      // c_tile
  int* s_vox = s_atom + c_tile;                              // c_tile
  int* s_row = s_vox + c_tile;                               // c_tile
  T* s_dict = reinterpret_cast<T*>(s_row + c_tile);          // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int rb = blockIdx.x; rb < n_row_blocks; rb += gridDim.x) {
    for (int i = threadIdx.x; i < kWarps * row_tile; i += blockDim.x) {
      s_part[i] = 0.f;
    }
    const int t_end = tile_ptr[rb + 1];
    for (int t = tile_ptr[rb]; t < t_end; ++t) {
      __syncthreads();  // last tile's readers are done; zeros and D visible
      const int n = tile_len[t];
      const size_t base = static_cast<size_t>(t) * c_tile;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_atom[i] = atoms[base + i];
        s_vox[i] = voxels[base + i];
        s_row[i] = local_row[base + i];
        s_val[i] = to_float(values[base + i]);
      }
      __syncthreads();
      const int chunk = (n + kWarps - 1) / kWarps;
      const int lo = warp * chunk;
      const int hi = lo + chunk < n ? lo + chunk : n;
      int cur = lo < hi ? s_row[lo] : 0;
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        const T* drow = d + s_atom[i] * n_theta;
        const float* yrow = y + static_cast<size_t>(s_vox[i]) * n_theta;
        float p = 0.f;
        for (int c = lane; c < n_theta; c += 32) {
          p = fmaf(load_dict<kSmemD>(drow + c), __ldg(yrow + c), p);
        }
        p = warp_sum(p);
        const int r = s_row[i];
        if (r != cur) {
          if (lane == 0) s_part[warp * row_tile + cur] += run;
          run = 0.f;
          cur = r;
        }
        run = fmaf(p, s_val[i], run);
      }
      if (lo < hi && lane == 0) s_part[warp * row_tile + cur] += run;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < row_tile; r += blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < kWarps; ++k) s += s_part[k * row_tile + r];
      out[static_cast<size_t>(rb) * row_tile + r] = s;
    }
    __syncthreads();  // the block is written before the next one is zeroed
  }
}

template <typename T>
int wc_launch(const int* tile_ptr, const int* tile_len, const int* atoms,
              const int* voxels, const T* values, const int* local_row,
              const T* dict, const float* y, float* out, int n_row_blocks,
              int c_tile, int row_tile, int n_atoms, int n_theta,
              cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kWarps) * row_tile
                                       + c_tile)
                      + 3 * sizeof(int) * static_cast<size_t>(c_tile);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(wc_coo_kernel<T, true>, kThreads, smem + dict_bytes,
                      n_row_blocks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_coo_kernel<T, true><<<grid, kThreads, smem + dict_bytes, stream>>>(
        tile_ptr, tile_len, atoms, voxels, values, local_row, dict, y, out,
        n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  } else {
    e = resident_grid(wc_coo_kernel<T, false>, kThreads, smem, n_row_blocks,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_coo_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        tile_ptr, tile_len, atoms, voxels, values, local_row, dict, y, out,
        n_row_blocks, c_tile, row_tile, n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
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
