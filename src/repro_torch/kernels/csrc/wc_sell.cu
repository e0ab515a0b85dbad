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
// and rows of voxels along one streamline recur, so many hit in L2.
//
// Design:
//  * One warp owns one fiber row at a time and writes its weight once,
//    zero for an empty row and for the padding rows past n_rows.  No
//    atomics; each weight is summed in one fixed order, so results repeat
//    bit for bit.
//  * The row reads only its row_nnz[r] real slots, never its padding.  The
//    warp's lanes load 32 slots' (atom, voxel, value) at once with one
//    coalesced load each and hand them round by shuffles.
//  * Per slot the lanes stride over Ntheta (coalesced loads of the Y row and
//    the D row) and each lane keeps its share of the weight in a register;
//    one butterfly of shuffles sums the lanes when the row is done.
//  * Blocks stride over rows with only as many blocks as are resident,
//    staging D into shared memory once per block; when it does not fit it
//    is read through the read-only cache (kSmemD = false).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kThreads) wc_sell_kernel(
    const int* __restrict__ atoms, const int* __restrict__ voxels,
    const T* __restrict__ values, const int* __restrict__ row_nnz,
    const T* __restrict__ dict, const float* __restrict__ y,
    float* __restrict__ out, int n_rows, int rows_padded, int width,
    int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_dict = reinterpret_cast<T*>(smem);                    // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
    __syncthreads();
  }
  const T* d = kSmemD ? s_dict : dict;
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kWarps;

  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows_padded;
       r += warps) {
    const int n = r < n_rows ? row_nnz[r] : 0;   // warp-uniform
    const size_t base = static_cast<size_t>(r) * width;
    float acc = 0.f;
    for (int s0 = 0; s0 < n; s0 += 32) {
      int a = 0, v = 0;
      float val = 0.f;
      if (s0 + lane < n) {
        a = atoms[base + s0 + lane];
        v = voxels[base + s0 + lane];
        val = to_float(values[base + s0 + lane]);
      }
      const int m = n - s0 < 32 ? n - s0 : 32;
      for (int j = 0; j < m; ++j) {
        const int aj = __shfl_sync(0xffffffffu, a, j);
        const int vj = __shfl_sync(0xffffffffu, v, j);
        const float valj = __shfl_sync(0xffffffffu, val, j);
        const T* drow = d + aj * n_theta;
        const float* yrow = y + static_cast<size_t>(vj) * n_theta;
        float p = 0.f;
        for (int c = lane; c < n_theta; c += 32) {
          p = fmaf(load_dict<kSmemD>(drow + c), __ldg(yrow + c), p);
        }
        acc = fmaf(p, valj, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

template <typename T>
int wc_sell_launch(const int* atoms, const int* voxels, const T* values,
                   const int* row_nnz, const T* dict, const float* y,
                   float* out, int n_rows, int rows_padded, int width,
                   int n_atoms, int n_theta, cudaStream_t stream) {
  if (rows_padded <= 0) return static_cast<int>(cudaSuccess);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict = dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  const int row_groups = (rows_padded + kWarps - 1) / kWarps;
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(wc_sell_kernel<T, true>, kThreads, dict_bytes,
                      row_groups, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_sell_kernel<T, true><<<grid, kThreads, dict_bytes, stream>>>(
        atoms, voxels, values, row_nnz, dict, y, out, n_rows, rows_padded,
        width, n_atoms, n_theta);
  } else {
    e = resident_grid(wc_sell_kernel<T, false>, kThreads, 0, row_groups,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_sell_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        atoms, voxels, values, row_nnz, dict, y, out, n_rows, rows_padded,
        width, n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
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
