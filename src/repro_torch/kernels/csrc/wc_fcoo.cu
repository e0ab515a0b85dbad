// B6: F-COO WC segment partials over the fiber-major view of the one
// resident stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fcoo.py:wc_fcoo_pallas
// (_wc_fcoo_kernel).  It computes the same function: with j = wc_perm[g]
// the stream position of slot g = t * c_tile + i of the fiber-major view,
//     P[t, k] = sum over slots i of chunk t with rank[g] == k of
//               values[j] * <D[atoms[j], :], Y[voxels[j], :]>
// and P[t, k] = 0 for every k at or past the chunk's segment count.  The
// reference gathers atoms, values and a (n_chunks, c_tile, Ntheta) stream
// of Y rows through wc_perm in XLA on every call (kernels/ops.py:209-212;
// 395 MB of Y rows per call at the smoke size).  Here the kernel reads
// atoms, voxels and values at wc_perm[g] and the Y row at that voxel
// itself, so the stream stays one resident copy and nothing per call is
// written but the (n_chunks, K) partials.  The combine over seg_rows_wc
// stays an index_add_ in kernels/ops.py.
//
// Bound: bytes.  Per slot the kernel reads 20 bytes of permutation, index,
// rank and value (18 with bf16 values) and gathers one Ntheta-float row of
// Y, and does 2 * Ntheta flops.  The compulsory traffic counts Y once
// (100 MB at Nv = 262,144, Ntheta = 96); the permuted reads are scattered,
// one voxel-major stream position per slot.
//
// Design:
//  * One thread block owns one chunk at a time and writes its K partials
//    once, zeros included.  No atomics; each partial is summed in one
//    fixed order, so results repeat bit for bit.
//  * Each warp takes a contiguous part of the chunk.  Its lanes load 32
//    slots' (atom, voxel, value, rank) at once through wc_perm and hand
//    them round by shuffles; per slot the lanes stride over Ntheta and a
//    butterfly of shuffles sums the dot product.  Ranks are nondecreasing
//    in a chunk, so the warp sums a run of equal ranks in a register and
//    adds it to its own row of a shared (warps x K) table when the rank
//    changes; at the end of the chunk the K partials are summed over the
//    warps in warp order.  The TPU kernel's one-hot matmul is not carried
//    over.
//  * Blocks stride over chunks with only as many blocks as are resident,
//    staging D into shared memory once per block; when it does not fit it
//    is read through the read-only cache (kSmemD = false).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kThreads) wc_fcoo_kernel(
    const int* __restrict__ wc_perm, const int* __restrict__ atoms,
    const int* __restrict__ voxels, const T* __restrict__ values,
    const int* __restrict__ ranks, const T* __restrict__ dict,
    const float* __restrict__ y, float* __restrict__ out, int n_chunks,
    int c_tile, int seg_k, int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem);            // warps x K
  T* s_dict = reinterpret_cast<T*>(s_part + kWarps * seg_k);  // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per_warp = (c_tile + kWarps - 1) / kWarps;
  const int lo = warp * per_warp < c_tile ? warp * per_warp : c_tile;
  const int hi = lo + per_warp < c_tile ? lo + per_warp : c_tile;

  for (int t = blockIdx.x; t < n_chunks; t += gridDim.x) {
    for (int i = threadIdx.x; i < kWarps * seg_k; i += blockDim.x) {
      s_part[i] = 0.f;
    }
    __syncthreads();  // zeros and D are visible
    const size_t chunk = static_cast<size_t>(t) * c_tile;
    int cur = -1;
    float run = 0.f;
    for (int s0 = lo; s0 < hi; s0 += 32) {
      int a = 0, v = 0, k = 0;
      float val = 0.f;
      if (s0 + lane < hi) {
        const size_t g = chunk + s0 + lane;
        const int j = wc_perm[g];
        a = atoms[j];
        v = voxels[j];
        val = to_float(values[j]);
        k = ranks[g];
      }
      const int m = hi - s0 < 32 ? hi - s0 : 32;
      for (int jj = 0; jj < m; ++jj) {
        const int aj = __shfl_sync(0xffffffffu, a, jj);
        const int vj = __shfl_sync(0xffffffffu, v, jj);
        const int kj = __shfl_sync(0xffffffffu, k, jj);
        const float valj = __shfl_sync(0xffffffffu, val, jj);
        const T* drow = d + aj * n_theta;
        const float* yrow = y + static_cast<size_t>(vj) * n_theta;
        float p = 0.f;
        for (int c = lane; c < n_theta; c += 32) {
          p = fmaf(load_dict<kSmemD>(drow + c), __ldg(yrow + c), p);
        }
        p = warp_sum(p);
        if (kj != cur) {
          if (cur >= 0 && lane == 0) s_part[warp * seg_k + cur] += run;
          run = 0.f;
          cur = kj;
        }
        run = fmaf(p, valj, run);
      }
    }
    if (cur >= 0 && lane == 0) s_part[warp * seg_k + cur] += run;
    __syncthreads();
    float* part = out + static_cast<size_t>(t) * seg_k;
    for (int kk = threadIdx.x; kk < seg_k; kk += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < kWarps; ++q) s += s_part[q * seg_k + kk];
      part[kk] = s;
    }
    __syncthreads();  // the table is read before the next chunk zeroes it
  }
}

template <typename T>
int wc_fcoo_launch(const int* wc_perm, const int* atoms, const int* voxels,
                   const T* values, const int* ranks, const T* dict,
                   const float* y, float* out, int n_chunks, int c_tile,
                   int seg_k, int n_atoms, int n_theta, cudaStream_t stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(seg_k);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(wc_fcoo_kernel<T, true>, kThreads, smem + dict_bytes,
                      n_chunks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_fcoo_kernel<T, true><<<grid, kThreads, smem + dict_bytes, stream>>>(
        wc_perm, atoms, voxels, values, ranks, dict, y, out, n_chunks, c_tile,
        seg_k, n_atoms, n_theta);
  } else {
    e = resident_grid(wc_fcoo_kernel<T, false>, kThreads, smem, n_chunks,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    wc_fcoo_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        wc_perm, atoms, voxels, values, ranks, dict, y, out, n_chunks, c_tile,
        seg_k, n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int wc_fcoo_f32(const int* wc_perm, const int* atoms,
                           const int* voxels, const float* values,
                           const int* ranks, const float* dict,
                           const float* y, float* out, int n_chunks,
                           int c_tile, int seg_k, int n_atoms, int n_theta,
                           void* stream) {
  return wc_fcoo_launch<float>(wc_perm, atoms, voxels, values, ranks, dict, y,
                               out, n_chunks, c_tile, seg_k, n_atoms, n_theta,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int wc_fcoo_bf16(const int* wc_perm, const int* atoms,
                            const int* voxels, const __nv_bfloat16* values,
                            const int* ranks, const __nv_bfloat16* dict,
                            const float* y, float* out, int n_chunks,
                            int c_tile, int seg_k, int n_atoms, int n_theta,
                            void* stream) {
  return wc_fcoo_launch<__nv_bfloat16>(wc_perm, atoms, voxels, values, ranks,
                                       dict, y, out, n_chunks, c_tile, seg_k,
                                       n_atoms, n_theta,
                                       static_cast<cudaStream_t>(stream));
}
