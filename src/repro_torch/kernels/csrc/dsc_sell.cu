// B3: SELL DSC (y = M w) over a voxel-row SELL layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dsc.py:dsc_sell_pallas
// (_dsc_sell_kernel).  It computes the same function: for every output row
// r of the dense (rows_padded, width) slot arrays of formats/sell.py:SellPhi,
//     out[r, :] = sum over real slots s of D[atoms[r, s], :] * w[fibers[r, s]] * values[r, s]
// The scaling w[fiber] * value, which the reference computes in XLA before
// its call (kernels/ops.py:125), is fused in here.
//
// Bound: bytes.  Per real coefficient the kernel reads 12 bytes of index and
// value (10 with bf16 values) and gathers 4 bytes of w, does 2 * Ntheta
// flops, and writes the (rows_padded, Ntheta) float output once: a few
// flops per byte, well below the ~20 fp32 flops per byte at which an H100
// stops waiting on device memory.  The output (100.7 MB at Nv = 262,144,
// Ntheta = 96) is most of the compulsory traffic.
//
// Design:
//  * SELL rows are independent and row r's real slots are the first
//    row_nnz[r] of its row, so a warp owns output rows: each warp takes a
//    contiguous range of rows (adjacent rows' slots share cache lines) and
//    writes every row of it once, zeros for empty rows and for the padding
//    rows past n_rows.  No atomics, and each output element is summed in
//    slot order, so results repeat bit for bit.
//  * Per row, the lanes load up to 32 slots' atom, fiber and value in one
//    coalesced load each and gather w[fiber] in parallel; shuffles
//    broadcast each slot; each lane owns columns lane, lane + 32, ... and
//    sums them in registers (kCols = ceil(Ntheta / 32) of them, columns in
//    passes of 128 above Ntheta = 128); the row is stored once, coalesced.
//    A row longer than 32 slots loads its further slots as it goes.  The
//    row's padding slots are never read.
//  * The loads run ahead of the sums: while a warp sums row r, it has row
//    r + 1's w gathers and row r + 2's slot loads in flight, and the
//    row_nnz of 32 rows come in one load.
//  * Blocks of 512 threads stay resident and stage D into shared memory
//    once (read through the read-only cache when it does not fit,
//    kSmemD = false).  After that one barrier there is none: warps never
//    wait for each other.  The TPU kernel's slot-chunk grid axis, its
//    @pl.when zero-init and the 128-lane padding of Ntheta are not carried
//    over.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// One row's slots as this lane holds them: slot `lane` of the first 32.
struct RowSlots {
  int nnz = 0;      // real slots of the row (warp-uniform)
  int atom = 0;
  int fiber = 0;
  float value = 0.f;
};

template <typename T, bool kSmemD, int kCols>
__global__ void __launch_bounds__(kThreads) dsc_sell_kernel(
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ row_nnz,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int rows_padded, int width,
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
  const int per_warp = (rows_padded + n_warps - 1) / n_warps;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int r0 = min(warp * per_warp, rows_padded);
  const int r1 = min(r0 + per_warp, rows_padded);
  const int nnz_end = min(r1, n_rows);  // rows past n_rows hold no slot

  int nnz_block = 0;  // row_nnz of rows r0 + 32k + lane, for the loads ahead
  // row q's first 32 slots; rows are asked for in order r0, r0 + 1, ...
  auto load_row = [&](int q) {
    RowSlots s;
    if (q >= r1) return s;
    if (((q - r0) & 31) == 0) {
      nnz_block = q + lane < nnz_end ? row_nnz[q + lane] : 0;
    }
    s.nnz = __shfl_sync(kFull, nnz_block, (q - r0) & 31);
    if (lane < s.nnz) {
      const size_t slot = static_cast<size_t>(q) * width + lane;
      s.atom = atoms[slot];
      s.fiber = fibers[slot];
      s.value = to_float(values[slot]);
    }
    return s;
  };

  RowSlots cur = load_row(r0);
  float cur_w = lane < cur.nnz ? __ldg(w + cur.fiber) : 0.f;
  RowSlots next = load_row(r0 + 1);
  for (int r = r0; r < r1; ++r) {
    const RowSlots after = load_row(r + 2);
    const float next_w = lane < next.nnz ? __ldg(w + next.fiber) : 0.f;

    const float scaled = cur_w * cur.value;
    for (int c0 = 0; c0 < n_theta; c0 += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
      for (int base = 0; base < cur.nnz; base += 32) {
        int atom = cur.atom;
        float sc = scaled;
        if (base > 0) {  // a row longer than 32 slots: its next piece
          atom = 0;
          sc = 0.f;
          if (base + lane < cur.nnz) {
            const size_t slot = static_cast<size_t>(r) * width + base + lane;
            atom = atoms[slot];
            sc = __ldg(w + fibers[slot]) * to_float(values[slot]);
          }
        }
        const int m = cur.nnz - base < 32 ? cur.nnz - base : 32;
        for (int s = 0; s < m; ++s) {
          const T* drow = d + __shfl_sync(kFull, atom, s) * n_theta;
          const float ss = __shfl_sync(kFull, sc, s);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int col = c0 + lane + 32 * k;
            if (col < n_theta) {
              acc[k] = fmaf(load_dict<kSmemD>(drow + col), ss, acc[k]);
            }
          }
        }
      }
      float* dst = out + static_cast<size_t>(r) * n_theta;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int col = c0 + lane + 32 * k;
        if (col < n_theta) dst[col] = acc[k];
      }
    }

    cur = next;
    cur_w = next_w;
    next = after;
  }
}

template <typename T, bool kSmemD, int kCols>
cudaError_t launch_main(const int* atoms, const int* fibers, const T* values,
                        const int* row_nnz, const T* dict, const float* w,
                        float* out, int n_rows, int rows_padded, int width,
                        int n_atoms, int n_theta, size_t smem,
                        cudaStream_t stream) {
  auto kernel = dsc_sell_kernel<T, kSmemD, kCols>;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kThreads, smem,
                                (rows_padded + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(atoms, fibers, values, row_nnz,
                                           dict, w, out, n_rows, rows_padded,
                                           width, n_atoms, n_theta);
  return cudaGetLastError();
}

template <typename T, bool kSmemD>
cudaError_t launch_by_width(const int* atoms, const int* fibers,
                            const T* values, const int* row_nnz,
                            const T* dict, const float* w, float* out,
                            int n_rows, int rows_padded, int width,
                            int n_atoms, int n_theta, size_t smem,
                            cudaStream_t stream) {
#define DSC_SELL_ARGS                                                   \
  atoms, fibers, values, row_nnz, dict, w, out, n_rows, rows_padded, \
      width, n_atoms, n_theta, smem, stream
  switch ((n_theta + 31) / 32) {
    case 1: return launch_main<T, kSmemD, 1>(DSC_SELL_ARGS);
    case 2: return launch_main<T, kSmemD, 2>(DSC_SELL_ARGS);
    case 3: return launch_main<T, kSmemD, 3>(DSC_SELL_ARGS);
    default: return launch_main<T, kSmemD, 4>(DSC_SELL_ARGS);
  }
#undef DSC_SELL_ARGS
}

template <typename T>
int dsc_sell_launch(const int* atoms, const int* fibers, const T* values,
                    const int* row_nnz, const T* dict, const float* w,
                    float* out, int n_rows, int rows_padded, int width,
                    int n_atoms, int n_theta, cudaStream_t stream) {
  if (rows_padded <= 0) return static_cast<int>(cudaSuccess);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  cudaError_t e;
  if (dict_bytes <= static_cast<size_t>(smem_optin_bytes())) {
    e = launch_by_width<T, true>(atoms, fibers, values, row_nnz, dict, w, out,
                                 n_rows, rows_padded, width, n_atoms, n_theta,
                                 dict_bytes, stream);
  } else {
    e = launch_by_width<T, false>(atoms, fibers, values, row_nnz, dict, w,
                                  out, n_rows, rows_padded, width, n_atoms,
                                  n_theta, 0, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int dsc_sell_f32(const int* atoms, const int* fibers,
                            const float* values, const int* row_nnz,
                            const float* dict, const float* w, float* out,
                            int n_rows, int rows_padded, int width,
                            int n_atoms, int n_theta, void* stream) {
  return dsc_sell_launch<float>(atoms, fibers, values, row_nnz, dict, w, out,
                                n_rows, rows_padded, width, n_atoms, n_theta,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_sell_bf16(const int* atoms, const int* fibers,
                             const __nv_bfloat16* values, const int* row_nnz,
                             const __nv_bfloat16* dict, const float* w,
                             float* out, int n_rows, int rows_padded,
                             int width, int n_atoms, int n_theta,
                             void* stream) {
  return dsc_sell_launch<__nv_bfloat16>(atoms, fibers, values, row_nnz, dict,
                                        w, out, n_rows, rows_padded, width,
                                        n_atoms, n_theta,
                                        static_cast<cudaStream_t>(stream));
}
