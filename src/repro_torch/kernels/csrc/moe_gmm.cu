// B7: grouped matrix product over expert-sorted token tiles (the MoE expert
// FFN), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py:moe_gmm
// (_gmm_kernel).  It computes the same function:
//     out[r, :] = x[r, :] @ W[expert_of_tile[r / t_tile]]
// for x (n_tiles * t_tile, K), W (E, K, N), out (n_tiles * t_tile, N), in
// bf16 with float32 sums rounded once to bf16 (the Pallas body's
// preferred_element_type=float32 then astype), or in float32 throughout.
// An expert id outside [0, E) is clamped into it, so no launch reads
// outside W.
//
// Bound: at prefill widths (thousands of rows per product) the tensor cores
// (2 M K N operations against one read of x and of each selected W); at
// decode (8 real rows per tile) device memory, since every tile streams
// its expert's whole K x N block of W for a handful of rows.
//
// Design (a simple one that is right; wgmma, TMA and fusing gate, up and
// SiLU are later work):
//  * A thread block owns one (token tile, 128-column) block of out: it reads
//    its tile's expert id once (the TPU's scalar prefetch becomes a plain
//    int32 load) and never touches another tile's rows, so one tile's
//    weights are never applied to another tile's rows.  Tiles of more than
//    64 rows take several blocks of 64 rows; tiles of 32 rows or fewer take
//    blocks of 16 rows.  Rows past the end of a short tile are predicated
//    off: loaded as zeros, never stored.
//  * K in steps of 64 bytes: the block's x rows and the W slice are copied
//    into shared memory with cp.async, four stages deep, so the next steps'
//    loads are in flight while this one is multiplied.  Rows are padded by
//    16 bytes so that the fragment loads hit 8 distinct bank groups.
//  * bf16: four warps, each a 32 x 64 (or 16 x 32) piece of the block, load
//    fragments with ldmatrix (.trans for W, whose rows are K) and multiply
//    on the tensor cores with mma.sync.m16n8k16, float32 accumulators.
//  * float32: the same tiling and loads, products by the CUDA cores, each
//    thread an (BM / 8) x 8 piece of the block.
//  * Ragged K and N (multiples of 16 bytes) are loaded as zeros past the
//    end; columns past N are never stored.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 128;
constexpr int kStages = 4;

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per cp.async
  static constexpr int kBK = 64 / static_cast<int>(sizeof(T));   // K per stage
  static constexpr int kAStride = kBK + kVec;   // padded smem row of x
  static constexpr int kBStride = kBN + kVec;   // padded smem row of W
  template <int BM>
  static constexpr size_t stage_elems() {
    return static_cast<size_t>(BM) * kAStride
           + static_cast<size_t>(kBK) * kBStride;
  }
};

// Warp layout of a BM x 128 block for the tensor-core path.
template <int BM>
struct Warps {
  static constexpr int M = BM >= 64 ? 2 : 1;
  static constexpr int N = 4 / M;
  static constexpr int WM = BM / M;      // rows of one warp
  static constexpr int WN = kBN / N;     // columns of one warp
  static constexpr int MT = WM / 16;     // m16 pieces
  static constexpr int NT = WN / 8;      // n8 pieces
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !pred (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies one K step of the block's x rows (BM x BK) and of the expert's W
// slice (BK x 128) into stage buffers a and b.
template <typename T, int BM>
__device__ __forceinline__ void load_stage(T* a, T* b, const T* x,
                                           const T* we, int row0, int rows,
                                           int k0, int n0, int K, int N) {
  using Tl = Tile<T>;
  constexpr int kAChunksPerRow = Tl::kBK / Tl::kVec;
  for (int c = threadIdx.x; c < BM * kAChunksPerRow; c += kThreads) {
    const int r = c / kAChunksPerRow;
    const int kc = (c % kAChunksPerRow) * Tl::kVec;
    const bool ok = r < rows && k0 + kc < K;
    const T* src = ok ? x + static_cast<size_t>(row0 + r) * K + k0 + kc : x;
    cp_async16(smem_u32(a + r * Tl::kAStride + kc), src, ok);
  }
  constexpr int kBChunksPerRow = kBN / Tl::kVec;
  for (int c = threadIdx.x; c < Tl::kBK * kBChunksPerRow; c += kThreads) {
    const int r = c / kBChunksPerRow;
    const int nc = (c % kBChunksPerRow) * Tl::kVec;
    const bool ok = k0 + r < K && n0 + nc < N;
    const T* src = ok ? we + static_cast<size_t>(k0 + r) * N + n0 + nc : we;
    cp_async16(smem_u32(b + r * Tl::kBStride + nc), src, ok);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) moe_gmm_kernel(
    const int* __restrict__ expert_of_tile, const T* __restrict__ x,
    const T* __restrict__ w, T* __restrict__ out, int t_tile, int subs,
    int n_experts, int K, int N) {
  using Tl = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_a = reinterpret_cast<T*>(smem);                     // stages x BM x AS
  T* s_b = s_a + kStages * BM * Tl::kAStride;              // stages x BK x BS

  const int tile = blockIdx.y / subs;
  const int sub = blockIdx.y - tile * subs;
  const int row0 = tile * t_tile + sub * BM;
  const int rows = min(BM, t_tile - sub * BM);   // rows of this block's tile
  const int n0 = blockIdx.x * kBN;
  int e = expert_of_tile[tile];
  e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
  const T* we = w + static_cast<size_t>(e) * K * N;
  const int k_tiles = (K + Tl::kBK - 1) / Tl::kBK;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      load_stage<T, BM>(s_a + s * BM * Tl::kAStride,
                        s_b + s * Tl::kBK * Tl::kBStride, x, we, row0, rows,
                        s * Tl::kBK, n0, K, N);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using W = Warps<BM>;
    const int wm = warp / W::N;
    const int wn = warp % W::N;
    float acc[W::MT][W::NT][4];
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int j = 0; j < W::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // step kt has landed; step kt-1's readers are done
      const int next = kt + kStages - 1;
      if (next < k_tiles) {
        const int s = next % kStages;
        load_stage<T, BM>(s_a + s * BM * Tl::kAStride,
                          s_b + s * Tl::kBK * Tl::kBStride, x, we, row0,
                          rows, next * Tl::kBK, n0, K, N);
      }
      cp_async_commit();
      const int s = kt % kStages;
      const T* a = s_a + s * BM * Tl::kAStride;
      const T* b = s_b + s * Tl::kBK * Tl::kBStride;
#pragma unroll
      for (int kk = 0; kk < Tl::kBK; kk += 16) {
        uint32_t af[W::MT][4];
#pragma unroll
        for (int i = 0; i < W::MT; ++i) {
          const int r = wm * W::WM + i * 16 + (lane & 15);
          const int c = kk + (lane >> 4) * 8;
          ldmatrix_x4(af[i], smem_u32(a + r * Tl::kAStride + c));
        }
#pragma unroll
        for (int j = 0; j < W::NT / 2; ++j) {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
          // (k 8-15, n 8-15) of this 16 x 16 piece of W
          const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * W::WN + j * 16 + (lane >> 4) * 8;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(b + k * Tl::kBStride + n));
#pragma unroll
          for (int i = 0; i < W::MT; ++i) {
            mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
            mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();

    const int g = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int col = n0 + wn * W::WN + j * 8 + t4 * 2;
        if (col >= N) continue;
        const int r_lo = wm * W::WM + i * 16 + g;
        if (r_lo < rows) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row0 + r_lo) * N + col) =
              __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
        }
        if (r_lo + 8 < rows) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row0 + r_lo + 8) * N + col) =
              __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
        }
      }
    }
  } else {
    constexpr int TM = BM / 8;   // rows of one thread
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < k_tiles) {
        const int s = next % kStages;
        load_stage<T, BM>(s_a + s * BM * Tl::kAStride,
                          s_b + s * Tl::kBK * Tl::kBStride, x, we, row0,
                          rows, next * Tl::kBK, n0, K, N);
      }
      cp_async_commit();
      const int s = kt % kStages;
      const float* a = reinterpret_cast<const float*>(s_a)
                       + s * BM * Tl::kAStride;
      const float* b = reinterpret_cast<const float*>(s_b)
                       + s * Tl::kBK * Tl::kBStride;
#pragma unroll
      for (int kk = 0; kk < Tl::kBK; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(b + kk * Tl::kBStride + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            b + kk * Tl::kBStride + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = a[(ty * TM + i) * Tl::kAStride + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    cp_async_wait<0>();

    float* o = reinterpret_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      if (r >= rows) continue;
      float* orow = o + static_cast<size_t>(row0 + r) * N;
      const int c0 = n0 + tx * 4;
      const int c1 = n0 + 64 + tx * 4;
      if (c0 < N) {
        *reinterpret_cast<float4*>(orow + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      if (c1 < N) {
        *reinterpret_cast<float4*>(orow + c1) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

template <typename T, int BM>
cudaError_t launch_bm(const int* expert_of_tile, const T* x, const T* w,
                      T* out, int n_tiles, int t_tile, int n_experts, int K,
                      int N, cudaStream_t stream) {
  const int subs = (t_tile + BM - 1) / BM;
  const long long grid_y = static_cast<long long>(n_tiles) * subs;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = kStages * Tile<T>::template stage_elems<BM>() * sizeof(T);
  auto kernel = moe_gmm_kernel<T, BM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>(grid_y));
  kernel<<<grid, kThreads, smem, stream>>>(expert_of_tile, x, w, out, t_tile,
                                           subs, n_experts, K, N);
  return cudaGetLastError();
}

template <typename T>
int moe_gmm_launch(const int* expert_of_tile, const T* x, const T* w, T* out,
                   int n_tiles, int t_tile, int n_experts, int K, int N,
                   cudaStream_t stream) {
  if (n_tiles <= 0 || t_tile <= 0 || N <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_experts <= 0 || K % Tile<T>::kVec || N % Tile<T>::kVec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e =
      t_tile > 16
          ? launch_bm<T, 64>(expert_of_tile, x, w, out, n_tiles, t_tile,
                             n_experts, K, N, stream)
          : launch_bm<T, 16>(expert_of_tile, x, w, out, n_tiles, t_tile,
                             n_experts, K, N, stream);
  return static_cast<int>(e);
}

}  // namespace

// C entry points, one per element type.  Each returns cudaGetLastError()
// after its launch (0 = launched).
extern "C" int moe_gmm_f32(const int* expert_of_tile, const float* x,
                           const float* w, float* out, int n_tiles,
                           int t_tile, int n_experts, int K, int N,
                           void* stream) {
  return moe_gmm_launch<float>(expert_of_tile, x, w, out, n_tiles, t_tile,
                               n_experts, K, N,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gmm_bf16(const int* expert_of_tile, const __nv_bfloat16* x,
                            const __nv_bfloat16* w, __nv_bfloat16* out,
                            int n_tiles, int t_tile, int n_experts, int K,
                            int N, void* stream) {
  return moe_gmm_launch<__nv_bfloat16>(expert_of_tile, x, w, out, n_tiles,
                                       t_tile, n_experts, K, N,
                                       static_cast<cudaStream_t>(stream));
}
