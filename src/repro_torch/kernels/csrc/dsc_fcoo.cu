// B5: F-COO DSC segment partials over the voxel-major stream, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fcoo.py:dsc_fcoo_pallas
// (_dsc_fcoo_kernel).  It computes the same function: for every chunk t of
// c_tile slots of the one resident stream of formats/fcoo.py:FcooPhi and
// every chunk-local segment k < K,
//     P[t, k, :] = sum over slots i of chunk t with rank[t, i] == k of
//                  D[atoms[t, i], :] * w[fibers[t, i]] * values[t, i]
// and P[t, k, :] = 0 for every k at or past the chunk's segment count, so
// the output equals the reference's partials slot for slot.  The scaling
// w[fiber] * value, which the reference computes in XLA before its call
// (kernels/ops.py:195), is fused in here.  The combine over seg_rows_dsc
// (runs that cross chunks) stays an index_add_ in kernels/ops.py.
//
// Bound: bytes.  Per slot the kernel reads 16 bytes of index, rank and
// value (14 with bf16 values) and gathers 4 bytes of w, and does 2 * Ntheta
// flops.  Its output is (n_chunks, K, Ntheta) float partials: K is the
// most segments any chunk holds, so the partials are larger than y itself
// (247 MB against y's 101 MB at the smoke size, 1,028,333 coefficients,
// K = 160, Ntheta = 96) and writing them dominates.  Fusing the combine by
// a carry-out between chunks would remove them; that is later work.
//
// Design:
//  * One thread block owns one chunk at a time and writes its whole
//    K x Ntheta partials block once, zeros included.  No atomics; each
//    partial is summed in slot order, so results repeat bit for bit.
//  * The chunk's slots are staged in shared memory in pieces of kPiece
//    (atom, rank, scaled value), with coalesced loads and parallel gathers
//    of w.  The TPU kernel's one-hot (K, c_tile) matmul is not carried
//    over: ranks are nondecreasing within a chunk, so each thread owns
//    output columns, sums a run of equal ranks in a register and writes
//    P[t, rank, col] when the rank changes.  When Ntheta exceeds the
//    block's threads, the block walks the chunk once per group of columns.
//  * Blocks stride over chunks with only as many blocks as are resident,
//    so the dictionary is staged into shared memory once per block; when it
//    does not fit it is read through the read-only cache (kSmemD = false).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPiece = 256;  // slots staged in shared memory at a time

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kMaxThreads) dsc_fcoo_kernel(
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ ranks,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_chunks, int c_tile, int seg_k,
    int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_scaled = reinterpret_cast<float*>(smem);          // kPiece
  int* s_atom = reinterpret_cast<int*>(s_scaled + kPiece);   // kPiece
  int* s_rank = s_atom + kPiece;                             // kPiece
  T* s_dict = reinterpret_cast<T*>(s_rank + kPiece);         // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;

  for (int t = blockIdx.x; t < n_chunks; t += gridDim.x) {
    const size_t chunk = static_cast<size_t>(t) * c_tile;
    float* part = out + static_cast<size_t>(t) * seg_k * n_theta;
    for (int col0 = 0; col0 < n_theta; col0 += blockDim.x) {
      const int col = col0 + threadIdx.x;
      int cur = 0;
      float run = 0.f;
      for (int base = 0; base < c_tile; base += kPiece) {
        const int n = c_tile - base < kPiece ? c_tile - base : kPiece;
        __syncthreads();  // last piece's readers are done; D is visible
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const size_t s = chunk + base + i;
          s_atom[i] = atoms[s];
          s_rank[i] = ranks[s];
          s_scaled[i] = __ldg(w + fibers[s]) * to_float(values[s]);
        }
        __syncthreads();
        if (col < n_theta) {
          for (int i = 0; i < n; ++i) {
            const int k = s_rank[i];
            if (k != cur) {
              part[static_cast<size_t>(cur) * n_theta + col] = run;
              run = 0.f;
              cur = k;
            }
            run = fmaf(load_dict<kSmemD>(d + s_atom[i] * n_theta + col),
                       s_scaled[i], run);
          }
        }
      }
      if (col < n_theta) {
        part[static_cast<size_t>(cur) * n_theta + col] = run;
        for (int k = cur + 1; k < seg_k; ++k) {
          part[static_cast<size_t>(k) * n_theta + col] = 0.f;
        }
      }
    }
  }
}

template <typename T>
int dsc_fcoo_launch(const int* atoms, const int* fibers, const T* values,
                    const int* ranks, const T* dict, const float* w,
                    float* out, int n_chunks, int c_tile, int seg_k,
                    int n_atoms, int n_theta, cudaStream_t stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaSuccess);
  int threads = ((n_theta + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = (sizeof(float) + 2 * sizeof(int)) * kPiece;
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(dsc_fcoo_kernel<T, true>, threads, smem + dict_bytes,
                      n_chunks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_fcoo_kernel<T, true><<<grid, threads, smem + dict_bytes, stream>>>(
        atoms, fibers, values, ranks, dict, w, out, n_chunks, c_tile, seg_k,
        n_atoms, n_theta);
  } else {
    e = resident_grid(dsc_fcoo_kernel<T, false>, threads, smem, n_chunks,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_fcoo_kernel<T, false><<<grid, threads, smem, stream>>>(
        atoms, fibers, values, ranks, dict, w, out, n_chunks, c_tile, seg_k,
        n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int dsc_fcoo_f32(const int* atoms, const int* fibers,
                            const float* values, const int* ranks,
                            const float* dict, const float* w, float* out,
                            int n_chunks, int c_tile, int seg_k, int n_atoms,
                            int n_theta, void* stream) {
  return dsc_fcoo_launch<float>(atoms, fibers, values, ranks, dict, w, out,
                                n_chunks, c_tile, seg_k, n_atoms, n_theta,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_fcoo_bf16(const int* atoms, const int* fibers,
                             const __nv_bfloat16* values, const int* ranks,
                             const __nv_bfloat16* dict, const float* w,
                             float* out, int n_chunks, int c_tile, int seg_k,
                             int n_atoms, int n_theta, void* stream) {
  return dsc_fcoo_launch<__nv_bfloat16>(atoms, fibers, values, ranks, dict, w,
                                        out, n_chunks, c_tile, seg_k, n_atoms,
                                        n_theta,
                                        static_cast<cudaStream_t>(stream));
}
