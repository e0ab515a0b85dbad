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
// outside W.  The ids are read on the card only; the host never waits on
// them.
//
// Bound: at prefill widths (thousands of rows per product) the tensor cores
// and W's bytes about equally (the gate product 5120 x 4096 -> 6400 over 16
// experts: 0.27 ms of bf16 operations, 0.28 ms to read x, every expert's W
// and out once); at decode (8 real rows per tile) W's bytes alone.
//
// bf16 design (wgmma + TMA, warp-specialised):
//  * A thread block owns up to 128 rows and one 256-column slab of out:
//    two 64-row groups, one per consumer warpgroup.  A group is a piece of
//    at most 64 rows of one token tile (tiles of more than 64 rows are cut
//    into pieces), and a block pairs two groups of one run (consecutive
//    tiles of one expert) or holds one alone, so every block has one
//    expert.  Rows of a group past its tile's end are multiplied but never
//    stored.
//  * A producer warp keeps a ring of four 48 KB stages filled with TMA
//    (cp.async.bulk.tensor, completion on an mbarrier): per 64-deep K
//    step, each group's 64 x 64 slice of x and the expert's 64 x 256 slice
//    of W, 128-byte swizzled.  TMA zero-fills past K, N and the last row;
//    W boxes wholly past N are skipped.  setmaxnreg moves registers from
//    the producer warpgroup to the consumers (128 accumulators each).
//  * Each consumer warpgroup runs wgmma.m64n256k16 (x K-major from shared
//    memory, W N-major through the transpose bit), float32 accumulators in
//    registers, one K step in flight while the next one's barrier is
//    awaited; it frees a stage once the products reading it are done.
//  * W from device memory once per call.  Blocks are numbered run by run
//    and, within a run, column slab by column slab with the run's row
//    blocks side by side: they read each K slice of the expert's W slab
//    within microseconds of each other, so all but the first find it in
//    L2, and no other run reads that expert's W (for expert-sorted tiles).
//    Warp 0 of each block finds its run, slab and groups by a scan over
//    expert_of_tile (32 tiles per step) at the start; the host never reads
//    the ids, and launches as many blocks as one-tile runs would need
//    (blocks past the ids' own count exit at once).  A grid that runs one
//    tile's column blocks together instead (the previous design's order)
//    streams an expert's whole W (52 MB at 4096 x 6400, more than the
//    50 MB L2) once per tile or row block.
//  * Decode tiles of 8 rows take a 64-row wgmma each, 56 rows predicated
//    off, one group per block (the second warpgroup idles); W's bytes
//    bound the call there.
//
// float32 design (SIMT, not on the serve path): a thread block owns one
// (token tile, 128-column) block, four-stage cp.async into padded shared
// memory, each thread an (BM / 8) x 8 piece with CUDA-core FMAs.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 128;
constexpr int kBN = 128;
constexpr int kStages = 4;
constexpr int kVec = 4;                 // floats per cp.async (16 bytes)
constexpr int kBK = 16;                 // K per stage (64 bytes)
constexpr int kAStride = kBK + kVec;    // padded smem row of x
constexpr int kBStride = kBN + kVec;    // padded smem row of W

template <int BM>
constexpr size_t stage_floats() {
  return static_cast<size_t>(BM) * kAStride
         + static_cast<size_t>(kBK) * kBStride;
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

// Copies one K step of the block's x rows (BM x BK) and of the expert's W
// slice (BK x 128) into stage buffers a and b.
template <int BM>
__device__ __forceinline__ void load_stage(float* a, float* b, const float* x,
                                           const float* we, int row0,
                                           int rows, int k0, int n0, int K,
                                           int N) {
  constexpr int kAChunksPerRow = kBK / kVec;
  for (int c = threadIdx.x; c < BM * kAChunksPerRow; c += kThreads) {
    const int r = c / kAChunksPerRow;
    const int kc = (c % kAChunksPerRow) * kVec;
    const bool ok = r < rows && k0 + kc < K;
    const float* src = ok ? x + static_cast<size_t>(row0 + r) * K + k0 + kc
                          : x;
    cp_async16(smem_u32(a + r * kAStride + kc), src, ok);
  }
  constexpr int kBChunksPerRow = kBN / kVec;
  for (int c = threadIdx.x; c < kBK * kBChunksPerRow; c += kThreads) {
    const int r = c / kBChunksPerRow;
    const int nc = (c % kBChunksPerRow) * kVec;
    const bool ok = k0 + r < K && n0 + nc < N;
    const float* src = ok ? we + static_cast<size_t>(k0 + r) * N + n0 + nc
                          : we;
    cp_async16(smem_u32(b + r * kBStride + nc), src, ok);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads) moe_gmm_f32_kernel(
    const int* __restrict__ expert_of_tile, const float* __restrict__ x,
    const float* __restrict__ w, float* __restrict__ out, int t_tile,
    int subs, int n_experts, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);            // stages x BM x AS
  float* s_b = s_a + kStages * BM * kAStride;             // stages x BK x BS

  const int tile = blockIdx.y / subs;
  const int sub = blockIdx.y - tile * subs;
  const int row0 = tile * t_tile + sub * BM;
  const int rows = min(BM, t_tile - sub * BM);   // rows of this block's tile
  const int n0 = blockIdx.x * kBN;
  int e = expert_of_tile[tile];
  e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
  const float* we = w + static_cast<size_t>(e) * K * N;
  const int k_tiles = (K + kBK - 1) / kBK;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      load_stage<BM>(s_a + s * BM * kAStride, s_b + s * kBK * kBStride, x,
                     we, row0, rows, s * kBK, n0, K, N);
    }
    cp_async_commit();
  }

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
    __syncthreads();   // step kt has landed; step kt-1's readers are done
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      const int s = next % kStages;
      load_stage<BM>(s_a + s * BM * kAStride, s_b + s * kBK * kBStride, x,
                     we, row0, rows, next * kBK, n0, K, N);
    }
    cp_async_commit();
    const int s = kt % kStages;
    const float* a = s_a + s * BM * kAStride;
    const float* b = s_b + s * kBK * kBStride;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(b + kk * kBStride + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + kk * kBStride + 64 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = a[(ty * TM + i) * kAStride + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) continue;
    float* orow = out + static_cast<size_t>(row0 + r) * N;
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

template <int BM>
cudaError_t launch(const int* expert_of_tile, const float* x, const float* w,
                   float* out, int n_tiles, int t_tile, int n_experts, int K,
                   int N, cudaStream_t stream) {
  const int subs = (t_tile + BM - 1) / BM;
  const long long grid_y = static_cast<long long>(n_tiles) * subs;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = kStages * stage_floats<BM>() * sizeof(float);
  auto kernel = moe_gmm_f32_kernel<BM>;
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

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kGroupRows = 64;          // rows of one wgmma / one group
constexpr int kBK = 64;                 // K per stage: one 128-byte row
constexpr int kBox = 64 * 64;           // elements of one TMA box
constexpr int kBoxBytes = kBox * 2;     // 8 KB: 64 rows of 128 bytes
constexpr int kConsumerWarps = 8;       // two consumer warpgroups
constexpr int kThreads = 384;           // + one producer warpgroup

constexpr int kBN = 256;                // columns of a slab
constexpr int kWBoxes = kBN / 64;       // W boxes of 64 columns
constexpr int kStages = 4;              // 4 x 48 KB of ring
constexpr int kAcc = kBN / 2;           // accumulator floats per thread

// One ring stage; every box starts on a 1024-byte boundary, the period of
// the 128-byte swizzle.
struct Stage {
  __nv_bfloat16 x[2][kBox];               // group 0's rows, group 1's
  __nv_bfloat16 w[kWBoxes][kBox];         // the expert's W slice
};

struct Shared {
  Stage stage[kStages];
  uint64_t full[kStages];                 // TMA bytes landed
  uint64_t empty[kStages];                // consumers done reading
};

constexpr size_t kSmemBytes = sizeof(Shared) + 1024;   // + alignment slack

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | 1ull << 62;
}

// x's 64 x 64 box: K-major rows of 128 bytes, 8-row swizzle atoms 1024
// bytes apart (SBO); the k16 slice s starts 32 s bytes into the row.
__device__ __forceinline__ uint64_t desc_x(uint32_t box, int s) {
  return desc_sw128(box + 32 * s, 16, 1024);
}

// W's 64-column boxes: N-major (64 K rows of 128 bytes each), 8-row atoms
// along K 1024 bytes apart (SBO), each next 64 columns one box (8 KB)
// further (LBO); the k16 slice s starts 16 rows (2048 bytes) down.
__device__ __forceinline__ uint64_t desc_w(uint32_t box0, int s) {
  return desc_sw128(box0 + 2048 * s, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, bf16, K-major) * B (16 x 256, bf16,
// N-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The block's work, found by warp 0 (schedule()): its first group's index
// (a group is a piece of at most 64 rows of one tile), whether a second
// group follows in the same run of one expert, and its column slab.
struct Sched {
  int g0, pair, n0, live;
};

__device__ __forceinline__ int clamp_expert(int e, int n_experts) {
  return e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
}

// Blocks are numbered run by run (a run: consecutive tiles of one expert),
// slab by slab within a run, row block by row block within a slab; a row
// block pairs the run's groups 2 b and 2 b + 1 (the last alone when the
// run has an odd number).  Warp 0 scans the ids 32 tiles at a time:
// per tile its run's first tile and the row blocks it starts, a running
// sum of those (P), and from P the run holding block L's row blocks.
__device__ Sched schedule(const int* __restrict__ expert_of_tile,
                          int n_tiles, int subs, int n_experts, int n_slabs,
                          int bn) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const long long L = blockIdx.x;
  const long long q = L / n_slabs;      // some row block of L's run
  int prev_e = -1, run0 = 0, p_run0 = 0, p = 0;
  int found = 0, rs = 0, p_before = 0, tile = 0, end_tile = n_tiles;
  int p_end = -1;
  for (int c0 = 0; c0 < n_tiles; c0 += 32) {
    const int i = c0 + lane;
    const bool in = i < n_tiles;
    const int e = in ? clamp_expert(expert_of_tile[i], n_experts) : -1;
    const int up = __shfl_up_sync(all, e, 1);
    const bool start = in && e != (lane == 0 ? prev_e : up);
    int r = start ? i : -1;                 // last run start at or before i
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(all, r, d);
      if (lane >= d) r = max(r, v);
    }
    if (r < 0) r = run0;
    const int pos = i - r;
    const int cnt = in ? ((pos + 1) * subs + 1) / 2 - (pos * subs + 1) / 2 : 0;
    int inc = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(all, inc, d);
      if (lane >= d) inc += v;
    }
    const int p_incl = p + inc;
    const int p_excl = p_incl - cnt;
    const int from = __shfl_sync(all, p_excl, (r - c0) & 31);
    const int p_start = r >= c0 ? from : p_run0;   // P where i's run began
    if (!found) {
      const unsigned hit = __ballot_sync(all, in && p_excl <= q && q < p_incl);
      if (hit) {
        const int l = __ffs(hit) - 1;
        found = 1;
        tile = c0 + l;
        rs = __shfl_sync(all, r, l);
        p_before = __shfl_sync(all, p_start, l);
      }
    }
    if (found) {
      const unsigned next = __ballot_sync(all, start && i > tile);
      if (next) {
        const int l = __ffs(next) - 1;
        end_tile = c0 + l;
        p_end = __shfl_sync(all, p_excl, l);
        break;
      }
    }
    prev_e = __shfl_sync(all, e, 31);
    run0 = __shfl_sync(all, r, 31);
    p_run0 = __shfl_sync(all, p_start, 31);
    p = __shfl_sync(all, p_incl, 31);
  }
  if (!found) return {0, 0, 0, 0};
  if (p_end < 0) p_end = p;
  const int blocks = p_end - p_before;           // row blocks of the run
  const long long in_run = L - static_cast<long long>(n_slabs) * p_before;
  const int slab = static_cast<int>(in_run / blocks);
  const int rb = static_cast<int>(in_run % blocks);
  const int groups = (end_tile - rs) * subs;
  return {rs * subs + 2 * rb, 2 * rb + 1 < groups, slab * bn, 1};
}

// The group's first row, rows to store (0: compute only), expert.
struct Group {
  int row0, rows, expert;
};

__device__ __forceinline__ Group group_of(const int* expert_of_tile, int g,
                                          bool real, int t_tile, int subs,
                                          int n_experts) {
  const int tile = g / subs;
  const int sub = g - tile * subs;
  return {tile * t_tile + sub * kGroupRows,
          real ? min(kGroupRows, t_tile - sub * kGroupRows) : 0,
          clamp_expert(expert_of_tile[tile], n_experts)};
}

__global__ void __launch_bounds__(kThreads, 1) moe_gmm_bf16_kernel(
    __grid_constant__ const CUtensorMap tm_x,
    __grid_constant__ const CUtensorMap tm_w,
    const int* __restrict__ expert_of_tile, __nv_bfloat16* __restrict__ out,
    int n_tiles, int t_tile, int subs, int n_experts, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  __shared__ Sched s_sched;

  if (threadIdx.x < 32) {
    const Sched sc = schedule(expert_of_tile, n_tiles, subs, n_experts,
                              (N + kBN - 1) / kBN, kBN);
    if (threadIdx.x == 0) {
      s_sched = sc;
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&sh.full[s], 1);
        mbar_init(&sh.empty[s], kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const Sched sc = s_sched;
  if (!sc.live) return;                // past the last row block
  const int n0 = sc.n0;
  const Group g0 = group_of(expert_of_tile, sc.g0, true, t_tile, subs,
                            n_experts);
  const Group g1 = group_of(expert_of_tile, sc.g0 + sc.pair, sc.pair, t_tile,
                            subs, n_experts);   // g0 again when alone
  const int k_tiles = (K + kBK - 1) / kBK;

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 2) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int w_boxes = min(kWBoxes, (N - n0 + 63) / 64);  // inside N
      const uint32_t bytes =
          (1 + sc.pair + w_boxes) * static_cast<uint32_t>(kBoxBytes);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) {
          mbar_wait(&sh.empty[s], ((kt / kStages) - 1) & 1);
        }
        Stage& st = sh.stage[s];
        mbar_expect_tx(&sh.full[s], bytes);
        const int k0 = kt * kBK;
        tma_load_2d(st.x[0], &tm_x, &sh.full[s], k0, g0.row0);
        if (sc.pair) tma_load_2d(st.x[1], &tm_x, &sh.full[s], k0, g1.row0);
        for (int b = 0; b < w_boxes; ++b) {
          tma_load_3d(st.w[b], &tm_w, &sh.full[s], n0 + 64 * b, k0,
                      g0.expert);
        }
      }
    }
  } else {
    // consumers: warpgroup 0 multiplies group 0, warpgroup 1 group 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    // a lone group's block leaves warpgroup 1 idle: it only frees stages
    const bool active = warpgroup == 0 || sc.pair;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&sh.full[s], (kt / kStages) & 1);
      __syncwarp();
      if (active) {
        const uint32_t xb = smem_u32(sh.stage[s].x[warpgroup]);
        const uint32_t wb = smem_u32(sh.stage[s].w[0]);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_m64n256k16(acc, desc_x(xb, ks), desc_w(wb, ks));
        }
        wgmma_commit();
        wgmma_wait<1>();   // step kt-1's products are done: free its stage
        fence_acc(acc);
        if (kt > 0 && lane == 0) {
          mbar_arrive(&sh.empty[(kt - 1) % kStages]);
        }
      } else if (lane == 0) {
        mbar_arrive(&sh.empty[s]);
      }
    }
    if (!active) return;
    wgmma_wait<0>();
    fence_acc(acc);

    // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16 w .. 16 w + 15; per 8 columns j, {d[4j], d[4j+1]} sit at row
    // lane / 4, columns 2 (lane % 4) + {0, 1}, {d[4j+2], d[4j+3]} 8 rows
    // down
    const Group& g = warpgroup == 0 ? g0 : g1;
    const int r_lo = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
      if (r_lo < g.rows) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(g.row0 + r_lo) * N + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      }
      if (r_lo + 8 < g.rows) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(g.row0 + r_lo + 8) * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) with 64 x 64 x 1
// boxes, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const int* expert_of_tile, const __nv_bfloat16* x,
                   const __nv_bfloat16* w, __nv_bfloat16* out, int n_tiles,
                   int t_tile, int n_experts, int K, int N,
                   cudaStream_t stream) {
  const int subs = (t_tile + kGroupRows - 1) / kGroupRows;
  if (static_cast<long long>(n_tiles) * subs > (1 << 30)) {
    return cudaErrorInvalidConfiguration;
  }
  const long long m = static_cast<long long>(n_tiles) * t_tile;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                   static_cast<cuuint64_t>(N) * K * 2};
  if (!make_map(&tm_x, x, 2, x_dims, x_strides)
      || !make_map(&tm_w, w, 3, w_dims, w_strides)) {
    return cudaErrorInvalidValue;
  }
  // as many row blocks as runs of one tile each would need: blocks past
  // the ids' own count exit at once
  const long long blocks = static_cast<long long>(n_tiles) * ((subs + 1) / 2)
                           * ((N + kBN - 1LL) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaError_t e = cudaFuncSetAttribute(
      moe_gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  moe_gmm_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                        stream>>>(tm_x, tm_w, expert_of_tile, out, n_tiles,
                                  t_tile, subs, n_experts, K, N);
  return cudaGetLastError();
}

}  // namespace wg

bool bad_sizes(int n_tiles, int t_tile, int n_experts, int K, int N,
               int vec) {
  return n_tiles < 0 || t_tile <= 0 || n_experts <= 0 || K <= 0 || N < 0
         || K % vec || N % vec;
}

}  // namespace

// C entry points, one per element type.  Each returns cudaGetLastError()
// after its launch (0 = launched).
extern "C" int moe_gmm_f32(const int* expert_of_tile, const float* x,
                           const float* w, float* out, int n_tiles,
                           int t_tile, int n_experts, int K, int N,
                           void* stream) {
  if (bad_sizes(n_tiles, t_tile, n_experts, K, N, simt::kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      t_tile > 16 ? simt::launch<64>(expert_of_tile, x, w, out, n_tiles,
                                     t_tile, n_experts, K, N, s)
                  : simt::launch<16>(expert_of_tile, x, w, out, n_tiles,
                                     t_tile, n_experts, K, N, s);
  return static_cast<int>(e);
}

extern "C" int moe_gmm_bf16(const int* expert_of_tile, const __nv_bfloat16* x,
                            const __nv_bfloat16* w, __nv_bfloat16* out,
                            int n_tiles, int t_tile, int n_experts, int K,
                            int N, void* stream) {
  if (bad_sizes(n_tiles, t_tile, n_experts, K, N, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0 || N == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(wg::launch(expert_of_tile, x, w, out, n_tiles,
                                     t_tile, n_experts, K, N,
                                     static_cast<cudaStream_t>(stream)));
}
