// B5: F-COO DSC, y = M w over the voxel-major stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fcoo.py:dsc_fcoo_pallas
// (_dsc_fcoo_kernel) together with the scatter-add that folds its partials
// (src/repro/kernels/ops.py:make_fcoo_ops, matvec).  The TPU kernel writes,
// for every chunk t of c_tile slots of the one resident stream of
// formats/fcoo.py:FcooPhi and every chunk-local segment k (a run of equal
// voxels),
//     P[t, k, :] = sum over slots i of chunk t in segment k of
//                  D[atoms[t, i], :] * w[fibers[t, i]] * values[t, i],
// and the reference adds P onto y over seg_rows_dsc.  This kernel computes
// the sum of both, y (n_voxels, Ntheta) float32, without the partials:
// no (n_chunks, K, Ntheta) buffer (247 MB at the smoke size, 62% of it
// padding segments that the reference adds onto one dummy row).
//
// Bound: bytes.  Per slot 16 bytes of atom, voxel, fiber and value (14 with
// bf16 values) and a 4-byte gather of w; y written once (101 MB at the
// smoke size, most of the bound).
//
// Design (one call runs a memset and two kernels; the wrapper counts it as
// one launch):
//  * y is zeroed first (voxels with no coefficient stay zero).
//  * A group of threads owns one chunk at a time, several groups to a
//    block (384 threads) so that more chunks are in flight per SM while D
//    is staged once per block (in shared memory when it fits).  A group
//    stages its chunk's atoms, voxels and w[fiber] * value in shared
//    memory in pieces of kPiece slots; each thread owns output columns and
//    sums a run of equal voxels in a register, in slot order.
//  * The stream is voxel-sorted, so a segment that is neither the first nor
//    the last of its chunk is the whole of its voxel's run: the block
//    stores it straight to y[voxel].  The first and last segments may
//    continue runs of the neighbouring chunks: they go to a carry buffer
//    (n_chunks, 2, Ntheta) with their voxels (a chunk of one segment
//    carries it first and 0.0 last, on the same voxel).
//  * dsc_fcoo_fold_kernel, the second kernel, gives one warp to each carry
//    that starts a run (its voxel differs from the carry before it): it
//    adds the run's carries in chunk order, however many chunks the run
//    spans, and stores the total to y.
//  * No atomics: every output is summed in one fixed order, so a second
//    call is bit-identical.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 384;
constexpr int kPiece = 256;  // slots staged in shared memory at a time
constexpr int kFoldThreads = 256;

// Per block `groups` chunks at once, one group of `per_chunk` threads
// (>= Ntheta, a multiple of 32) each: with the dictionary staged once per
// block, more chunks in flight per SM hide the latency of each thread's
// serial run over its chunk's slots.
template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kMaxThreads) dsc_fcoo_kernel(
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ voxels,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ y, float* __restrict__ carry,
    int* __restrict__ carry_vox, int n_chunks, int c_tile, int n_atoms,
    int n_theta, int per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / per_chunk;
  const int group = threadIdx.x / per_chunk;
  const int lt = threadIdx.x - group * per_chunk;
  float* s_scaled = reinterpret_cast<float*>(smem) + group * kPiece;
  int* s_atom = reinterpret_cast<int*>(smem) + (groups + group) * kPiece;
  int* s_vox = reinterpret_cast<int*>(smem) + (2 * groups + group) * kPiece;
  T* s_dict = reinterpret_cast<T*>(reinterpret_cast<int*>(smem)
                                   + 3 * groups * kPiece);   // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;

  // every thread runs the same number of rounds, so the block barriers
  // below are reached by all; a group past the last chunk idles
  for (int t0 = blockIdx.x * groups; t0 < n_chunks;
       t0 += gridDim.x * groups) {
    const int t = t0 + group;
    const bool active = t < n_chunks;
    const size_t chunk = static_cast<size_t>(active ? t : 0) * c_tile;
    float* head = carry + static_cast<size_t>(2 * t) * n_theta;
    float* tail = head + n_theta;
    if (active && lt == 0) {
      carry_vox[2 * t] = voxels[chunk];
      carry_vox[2 * t + 1] = voxels[chunk + c_tile - 1];
    }
    for (int col0 = 0; col0 < n_theta; col0 += per_chunk) {
      const int col = col0 + lt;
      const bool mine = active && col < n_theta;
      int cur = -1;       // voxel of the open segment
      int closed = 0;     // segments of this chunk already stored
      float run = 0.f;
      for (int base = 0; base < c_tile; base += kPiece) {
        const int n = c_tile - base < kPiece ? c_tile - base : kPiece;
        __syncthreads();  // last piece's readers are done; D is visible
        if (active) {
          for (int i = lt; i < n; i += per_chunk) {
            const size_t s = chunk + base + i;
            s_atom[i] = atoms[s];
            s_vox[i] = voxels[s];
            s_scaled[i] = __ldg(w + fibers[s]) * to_float(values[s]);
          }
        }
        __syncthreads();
        if (mine) {
          if (cur < 0) cur = s_vox[0];
#pragma unroll 4
          for (int i = 0; i < n; ++i) {
            const int v = s_vox[i];
            if (v != cur) {
              if (closed == 0) {
                head[col] = run;
              } else {
                y[static_cast<size_t>(cur) * n_theta + col] = run;
              }
              ++closed;
              run = 0.f;
              cur = v;
            }
            run = fmaf(load_dict<kSmemD>(d + s_atom[i] * n_theta + col),
                       s_scaled[i], run);
          }
        }
      }
      if (mine) {
        if (closed == 0) {
          head[col] = run;
          tail[col] = 0.f;
        } else {
          tail[col] = run;
        }
      }
    }
  }
}

// One warp per carry: a carry whose voxel differs from the one before it
// starts a run; its warp sums the run's carries in chunk order and stores
// the total.
__global__ void __launch_bounds__(kFoldThreads) dsc_fcoo_fold_kernel(
    const float* __restrict__ carry, const int* __restrict__ carry_vox,
    float* __restrict__ y, int n_carries, int n_theta) {
  const int p = blockIdx.x * (kFoldThreads / 32) + threadIdx.x / 32;
  if (p >= n_carries) return;
  const int v = carry_vox[p];
  if (p > 0 && carry_vox[p - 1] == v) return;
  int end = p + 1;
  while (end < n_carries && carry_vox[end] == v) ++end;
  for (int col = threadIdx.x % 32; col < n_theta; col += 32) {
    float sum = carry[static_cast<size_t>(p) * n_theta + col];
    for (int q = p + 1; q < end; ++q) {
      sum += carry[static_cast<size_t>(q) * n_theta + col];
    }
    y[static_cast<size_t>(v) * n_theta + col] = sum;
  }
}

template <typename T>
int dsc_fcoo_launch(const int* atoms, const int* fibers, const T* values,
                    const int* voxels, const T* dict, const float* w,
                    float* y, float* carry, int* carry_vox, int n_chunks,
                    int c_tile, int n_voxels, int n_atoms, int n_theta,
                    cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(
      y, 0, sizeof(float) * static_cast<size_t>(n_voxels) * n_theta, stream);
  if (e != cudaSuccess || n_chunks <= 0) return static_cast<int>(e);
  int per_chunk = ((n_theta + 31) / 32) * 32;
  per_chunk = per_chunk > 256 ? 256 : per_chunk;
  const int groups = kMaxThreads / per_chunk;
  const int threads = groups * per_chunk;
  const size_t smem = (sizeof(float) + 2 * sizeof(int)) * kPiece * groups;
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  const int work = (n_chunks + groups - 1) / groups;
  int grid = 0;
  if (stage_dict) {
    e = resident_grid(dsc_fcoo_kernel<T, true>, threads, smem + dict_bytes,
                      work, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_fcoo_kernel<T, true><<<grid, threads, smem + dict_bytes, stream>>>(
        atoms, fibers, values, voxels, dict, w, y, carry, carry_vox,
        n_chunks, c_tile, n_atoms, n_theta, per_chunk);
  } else {
    e = resident_grid(dsc_fcoo_kernel<T, false>, threads, smem, work, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_fcoo_kernel<T, false><<<grid, threads, smem, stream>>>(
        atoms, fibers, values, voxels, dict, w, y, carry, carry_vox,
        n_chunks, c_tile, n_atoms, n_theta, per_chunk);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_carries = 2 * n_chunks;
  constexpr int kWarps = kFoldThreads / 32;
  dsc_fcoo_fold_kernel<<<(n_carries + kWarps - 1) / kWarps, kFoldThreads, 0,
                         stream>>>(carry, carry_vox, y, n_carries, n_theta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launches (0 = launched).  carry
// (n_chunks x 2 x n_theta floats) and carry_vox (n_chunks x 2 ints) are
// scratch.
extern "C" int dsc_fcoo_f32(const int* atoms, const int* fibers,
                            const float* values, const int* voxels,
                            const float* dict, const float* w, float* y,
                            float* carry, int* carry_vox, int n_chunks,
                            int c_tile, int n_voxels, int n_atoms,
                            int n_theta, void* stream) {
  return dsc_fcoo_launch<float>(atoms, fibers, values, voxels, dict, w, y,
                                carry, carry_vox, n_chunks, c_tile, n_voxels,
                                n_atoms, n_theta,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_fcoo_bf16(const int* atoms, const int* fibers,
                             const __nv_bfloat16* values, const int* voxels,
                             const __nv_bfloat16* dict, const float* w,
                             float* y, float* carry, int* carry_vox,
                             int n_chunks, int c_tile, int n_voxels,
                             int n_atoms, int n_theta, void* stream) {
  return dsc_fcoo_launch<__nv_bfloat16>(atoms, fibers, values, voxels, dict,
                                        w, y, carry, carry_vox, n_chunks,
                                        c_tile, n_voxels, n_atoms, n_theta,
                                        static_cast<cudaStream_t>(stream));
}
