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
// stops waiting on device memory.  The output (100 MB at Nv = 262,144,
// Ntheta = 96) is most of the compulsory traffic.
//
// Design:
//  * One thread block owns one block of row_tile output rows at a time and
//    writes those rows once, zeros for empty rows and for the padding rows
//    past n_rows.  No other block touches them: no atomics, and each output
//    element is summed in slot order, so results repeat bit for bit.
//  * Each row reads only its row_nnz[r] real slots, never its padding, so
//    the width of the layout (the longest row, rounded up) costs memory but
//    no bandwidth.  The TPU kernel's slot-chunk grid axis, its @pl.when
//    zero-init and the 128-lane padding of Ntheta are not carried over.
//  * The real slots of a row block are staged in shared memory in pieces of
//    kPiece (atom, row, scaled value), with coalesced loads and parallel
//    gathers of w; a row longer than a piece spans several pieces.
//  * Each thread owns output columns.  Slots arrive in row order, so a
//    thread sums a run of equal rows in a register and adds it to the
//    shared row_tile x Ntheta accumulator when the row changes.
//  * Blocks stride over row blocks with only as many blocks as are resident,
//    so the dictionary is staged into shared memory once per block; when it
//    does not fit it is read through the read-only cache (kSmemD = false).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPiece = 256;  // slots staged in shared memory at a time

template <typename T, bool kSmemD>
__global__ void __launch_bounds__(kMaxThreads) dsc_sell_kernel(
    const int* __restrict__ atoms, const int* __restrict__ fibers,
    const T* __restrict__ values, const int* __restrict__ row_nnz,
    const T* __restrict__ dict, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int n_row_blocks, int width,
    int row_tile, int n_atoms, int n_theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block_elems = row_tile * n_theta;
  float* s_acc = reinterpret_cast<float*>(smem);             // R x Ntheta
  float* s_scaled = s_acc + block_elems;                      // kPiece
  int* s_atom = reinterpret_cast<int*>(s_scaled + kPiece);    // kPiece
  int* s_row = s_atom + kPiece;                               // kPiece
  int* s_start = s_row + kPiece;                              // R + 1
  T* s_dict = reinterpret_cast<T*>(s_start + row_tile + 1);   // Na x Ntheta

  if constexpr (kSmemD) {
    for (int i = threadIdx.x; i < n_atoms * n_theta; i += blockDim.x) {
      s_dict[i] = dict[i];
    }
  }
  const T* d = kSmemD ? s_dict : dict;

  for (int rb = blockIdx.x; rb < n_row_blocks; rb += gridDim.x) {
    const int row0 = rb * row_tile;
    for (int i = threadIdx.x; i < block_elems; i += blockDim.x) s_acc[i] = 0.f;
    if (threadIdx.x == 0) {
      // offsets of each row's real slots in the row block's slot list;
      // padding rows past n_rows hold none
      int acc = 0;
      for (int r = 0; r < row_tile; ++r) {
        s_start[r] = acc;
        acc += row0 + r < n_rows ? row_nnz[row0 + r] : 0;
      }
      s_start[row_tile] = acc;
    }
    __syncthreads();
    const int total = s_start[row_tile];
    for (int base = 0; base < total; base += kPiece) {
      const int n = total - base < kPiece ? total - base : kPiece;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int flat = base + i;
        int r = 0;
        while (flat >= s_start[r + 1]) ++r;
        const size_t slot = static_cast<size_t>(row0 + r) * width
                            + (flat - s_start[r]);
        s_atom[i] = atoms[slot];
        s_row[i] = r;
        s_scaled[i] = __ldg(w + fibers[slot]) * to_float(values[slot]);
      }
      __syncthreads();
      for (int col = threadIdx.x; col < n_theta; col += blockDim.x) {
        int cur = s_row[0];
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
        s_acc[cur * n_theta + col] += run;
      }
      __syncthreads();  // the piece's readers are done before the next one
    }
    float* dst = out + static_cast<size_t>(row0) * n_theta;
    for (int i = threadIdx.x; i < block_elems; i += blockDim.x) dst[i] = s_acc[i];
    __syncthreads();  // the block is written before the next one is zeroed
  }
}

template <typename T>
int dsc_sell_launch(const int* atoms, const int* fibers, const T* values,
                    const int* row_nnz, const T* dict, const float* w,
                    float* out, int n_rows, int n_row_blocks, int width,
                    int row_tile, int n_atoms, int n_theta,
                    cudaStream_t stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaSuccess);
  int threads = ((n_theta + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(row_tile) * n_theta + kPiece)
      + sizeof(int) * (2 * static_cast<size_t>(kPiece) + row_tile + 1);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict =
      smem + dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  int grid = 0;
  cudaError_t e;
  if (stage_dict) {
    e = resident_grid(dsc_sell_kernel<T, true>, threads, smem + dict_bytes,
                      n_row_blocks, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_sell_kernel<T, true><<<grid, threads, smem + dict_bytes, stream>>>(
        atoms, fibers, values, row_nnz, dict, w, out, n_rows, n_row_blocks,
        width, row_tile, n_atoms, n_theta);
  } else {
    e = resident_grid(dsc_sell_kernel<T, false>, threads, smem, n_row_blocks,
                      &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    dsc_sell_kernel<T, false><<<grid, threads, smem, stream>>>(
        atoms, fibers, values, row_nnz, dict, w, out, n_rows, n_row_blocks,
        width, row_tile, n_atoms, n_theta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int dsc_sell_f32(const int* atoms, const int* fibers,
                            const float* values, const int* row_nnz,
                            const float* dict, const float* w, float* out,
                            int n_rows, int n_row_blocks, int width,
                            int row_tile, int n_atoms, int n_theta,
                            void* stream) {
  return dsc_sell_launch<float>(atoms, fibers, values, row_nnz, dict, w, out,
                                n_rows, n_row_blocks, width, row_tile,
                                n_atoms, n_theta,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dsc_sell_bf16(const int* atoms, const int* fibers,
                             const __nv_bfloat16* values, const int* row_nnz,
                             const __nv_bfloat16* dict, const float* w,
                             float* out, int n_rows, int n_row_blocks,
                             int width, int row_tile, int n_atoms,
                             int n_theta, void* stream) {
  return dsc_sell_launch<__nv_bfloat16>(atoms, fibers, values, row_nnz, dict,
                                        w, out, n_rows, n_row_blocks, width,
                                        row_tile, n_atoms, n_theta,
                                        static_cast<cudaStream_t>(stream));
}
