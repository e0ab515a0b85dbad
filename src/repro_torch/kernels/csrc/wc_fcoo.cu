// B6: F-COO WC, w = M^T y over the fiber-major view of the one resident
// stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fcoo.py:wc_fcoo_pallas
// (_wc_fcoo_kernel) together with the scatter-add that folds its partials
// (src/repro/kernels/ops.py:make_fcoo_ops, rmatvec).  The TPU kernel writes,
// for every chunk t of c_tile slots of the fiber-major view and every
// chunk-local segment k (a run of equal fibers),
//     P[t, k] = sum over slots g of chunk t in segment k of
//               values[j] * <D[atoms[j], :], Y[voxels[j], :]>,  j = wc_perm[g]
// and the reference adds P onto w over seg_rows_wc.  This kernel computes
// the sum of both, w (n_fibers,) float32, without the partials or an atomic:
// fibers with no coefficient get 0.  The reference gathers atoms, values and
// a (n_chunks, c_tile, Ntheta) stream of Y rows through wc_perm in XLA on
// every call; here the kernel reads atoms, voxels and values at wc_perm[g]
// and the Y row at that voxel itself, so the stream stays one resident copy.
//
// Bound: bytes.  Per slot 20 bytes of wc_perm, fiber, atom, voxel and value
// (18 with bf16 values) and one Ntheta-float Y row gathered, 2 * Ntheta
// flops.  The compulsory traffic counts Y once (100.7 MB at Nv = 262,144,
// Ntheta = 96); fiber order gathers a row per slot (0.40 GB at the smoke
// size if no row hit the 50 MB L2), so the kernel lands between the two.
//
// Design (one call runs a memset and two kernels; the wrapper counts it as
// one launch):
//  * w is zeroed first.
//  * One warp owns one chunk at a time; blocks of 8 warps stride over the
//    chunks with only as many blocks as are resident, staging D into shared
//    memory once per block (read through the read-only cache when it does
//    not fit, kSmemD = false).  No block barrier after the staging.
//  * A warp takes its chunk in batches of 32 slots.  Each lane loads one
//    slot's wc_perm and fiber (coalesced; the fibers are a resident
//    fiber-major copy, wc_fibers = fibers[wc_perm]) and then its atom, voxel
//    and value through wc_perm.  Those loads run one batch ahead of the
//    sums, and the wc_perm loads two ahead.
//  * The warp splits into 4 groups of 8 lanes, one slot each: every lane
//    loads kVecs float4s of the slot's Y row and of D's row (Ntheta = 96:
//    3 each), so 4 rows are in flight per step and up to 32 per batch;
//    three shuffles sum each dot product.  Ntheta that is not a multiple
//    of 4, or above 128, takes a scalar column loop instead (kVecs = 0).
//    Rows in flight per warp matter more than warps: the launch bounds ask
//    for one resident block per SM, so the kernel takes the registers to
//    hoist a batch's loads (168 at Ntheta = 96 in fp32).  That was faster
//    than 64 registers and four blocks per SM, which ptxas picks without
//    the minimum, and than caps of 128 or 80 registers for two or three
//    blocks per SM, which spill.
//  * The stream is fiber-sorted, so runs are found from the fibers
//    themselves: a segmented scan over the batch's 32 products (a fixed
//    tree), plus the run left open by the batch before.  A segment that is
//    neither the first nor the last of its chunk is the whole of its
//    fiber's run: the lane at its end stores it straight to w[fiber].  The
//    first and last segments may continue runs of the neighbouring chunks:
//    they go to a carry buffer (n_chunks, 2) with their fibers (a chunk of
//    one segment carries it first and 0.0 last, on the same fiber).
//  * wc_fcoo_fold_kernel, the second kernel, gives one thread to each carry
//    that starts a run (its fiber differs from the carry before it): it adds
//    the run's carries in chunk order, however many chunks the run spans,
//    and stores the total to w.  The carries are scalars, so a thread does
//    what B5's fold gives a warp.
//  * No atomics: every output is summed in one fixed order (slots of a
//    batch by the scan's tree, batches in slot order, chunks in chunk
//    order), so a second call is bit-identical.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // lanes that share one slot's dot product
constexpr int kFoldThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive D entries as floats (16-byte aligned for float, 8 for
// bf16), from shared memory or through the read-only cache.
template <bool kSmem>
__device__ __forceinline__ float4 load_dict4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  if constexpr (kSmem) {
    return *q;
  } else {
    return __ldg(q);
  }
}

template <bool kSmem>
__device__ __forceinline__ float4 load_dict4(const __nv_bfloat16* p) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  uint2 u;
  if constexpr (kSmem) {
    u = *q;
  } else {
    u = __ldg(q);
  }
  // bf16 is the top half of a float; the lower address holds the low half
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Lane lg's share of <drow, yrow>: float4 columns lg, lg + 8, ... (kVecs of
// them), or every 8th column from lg when kVecs == 0.
template <typename T, bool kSmemD, int kVecs>
__device__ __forceinline__ float group_dot(const T* drow, const float* yrow,
                                           int lg, int n_theta) {
  float p = 0.f;
  if constexpr (kVecs > 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int q = lg + kGroup * k;
      if (4 * q < n_theta) {
        const float4 yv = __ldg(reinterpret_cast<const float4*>(yrow) + q);
        const float4 dv = load_dict4<kSmemD>(drow + 4 * q);
        p = fmaf(dv.x, yv.x, p);
        p = fmaf(dv.y, yv.y, p);
        p = fmaf(dv.z, yv.z, p);
        p = fmaf(dv.w, yv.w, p);
      }
    }
  } else {
    for (int c = lg; c < n_theta; c += kGroup) {
      p = fmaf(load_dict<kSmemD>(drow + c), __ldg(yrow + c), p);
    }
  }
  return p;
}

template <typename T, bool kSmemD, int kVecs>
__global__ void __launch_bounds__(kThreads, 1) wc_fcoo_kernel(
    const int* __restrict__ wc_perm, const int* __restrict__ wc_fibers,
    const int* __restrict__ atoms, const int* __restrict__ voxels,
    const T* __restrict__ values, const T* __restrict__ dict,
    const float* __restrict__ y, float* __restrict__ w,
    float* __restrict__ carry, int* __restrict__ carry_fib, int n_chunks,
    int c_tile, int n_atoms, int n_theta) {
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
  const int lg = lane % kGroup;
  const int group_lane0 = lane - lg;
  const unsigned below = (1u << lane) - 1u;
  const unsigned upto = kFull >> (31 - lane);
  const int n_batches = (c_tile + 31) / 32;

  for (int t = blockIdx.x * kWarps + threadIdx.x / 32; t < n_chunks;
       t += gridDim.x * kWarps) {
    const size_t chunk = static_cast<size_t>(t) * c_tile;
    // batch 0's slot (fiber -1 past the chunk's end), batch 1's position
    int a = 0, v = 0, f = -1;
    float val = 0.f;
    if (lane < c_tile) {
      const int j = wc_perm[chunk + lane];
      f = wc_fibers[chunk + lane];
      a = atoms[j];
      v = voxels[j];
      val = to_float(values[j]);
    }
    int j1 = 0, f1 = -1;
    if (32 + lane < c_tile) {
      j1 = wc_perm[chunk + 32 + lane];
      f1 = wc_fibers[chunk + 32 + lane];
    }
    const int first_fib = __shfl_sync(kFull, f, 0);
    int cur = -1;     // fiber of the run left open by the last batch
    float run = 0.f;  // its sum so far
    int closed = 0;   // segments of this chunk already stored

    for (int b = 0; b < n_batches; ++b) {
      const int n = c_tile - 32 * b < 32 ? c_tile - 32 * b : 32;
      // batch b + 1's atoms, voxels and values; batch b + 2's positions
      int a1 = 0, v1 = 0;
      float val1 = 0.f;
      if (32 * (b + 1) + lane < c_tile) {
        a1 = atoms[j1];
        v1 = voxels[j1];
        val1 = to_float(values[j1]);
      }
      int j2 = 0, f2 = -1;
      if (32 * (b + 2) + lane < c_tile) {
        j2 = wc_perm[chunk + 32 * (b + 2) + lane];
        f2 = wc_fibers[chunk + 32 * (b + 2) + lane];
      }

      // group q takes slots 8q .. 8q + 7 of the batch, one per step, so
      // the product of slot `lane` ends on lane `lane`
      float mine = 0.f;
#pragma unroll
      for (int it = 0; it < kGroup; ++it) {
        const int as = __shfl_sync(kFull, a, group_lane0 + it);
        const int vs = __shfl_sync(kFull, v, group_lane0 + it);
        float p = group_dot<T, kSmemD, kVecs>(
            d + static_cast<size_t>(as) * n_theta,
            y + static_cast<size_t>(vs) * n_theta, lg, n_theta);
        p += __shfl_xor_sync(kFull, p, 4);
        p += __shfl_xor_sync(kFull, p, 2);
        p += __shfl_xor_sync(kFull, p, 1);
        if (lg == it) mine = p;
      }
      const bool active = lane < n;
      mine = active ? mine * val : 0.f;

      // segmented inclusive scan: x ends as the sum of the lane's segment
      // from its first lane in this batch up to the lane
      const int f_up = __shfl_up_sync(kFull, f, 1);
      const unsigned heads =
          __ballot_sync(kFull, active && (lane == 0 || f != f_up));
      const int start = 31 - __clz(heads & upto);
      float x = mine;
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
        const float o = __shfl_up_sync(kFull, x, dd);
        if (lane - dd >= start) x += o;
      }
      const int f_down = __shfl_down_sync(kFull, f, 1);
      const unsigned ends =
          __ballot_sync(kFull, active && (lane == n - 1 || f_down != f));

      // the run left open by the last batch either ends there or goes on
      // in this batch's first segment
      const int f0 = __shfl_sync(kFull, f, 0);
      if (cur >= 0 && f0 != cur) {
        if (lane == 0) {
          if (closed == 0) {
            carry[2 * t] = run;
          } else {
            w[cur] = run;
          }
        }
        ++closed;
      } else if (cur >= 0 && start == 0) {
        x += run;
      }
      // segments that end inside the batch are complete; the one at lane
      // n - 1 stays open
      const unsigned closing = ends & ~(1u << (n - 1));
      if ((closing >> lane) & 1u) {
        if (closed == 0 && (closing & below) == 0) {
          carry[2 * t] = x;  // the chunk's first segment
        } else {
          w[f] = x;
        }
      }
      closed += __popc(closing);
      run = __shfl_sync(kFull, x, n - 1);
      cur = __shfl_sync(kFull, f, n - 1);

      a = a1;
      v = v1;
      val = val1;
      f = f1;
      j1 = j2;
      f1 = f2;
    }
    if (lane == 0) {
      if (closed == 0) {
        carry[2 * t] = run;
        carry[2 * t + 1] = 0.f;
      } else {
        carry[2 * t + 1] = run;
      }
      carry_fib[2 * t] = first_fib;
      carry_fib[2 * t + 1] = cur;
    }
  }
}

// One thread per carry: a carry whose fiber differs from the one before it
// starts a run; its thread sums the run's carries in chunk order and stores
// the total.
__global__ void __launch_bounds__(kFoldThreads) wc_fcoo_fold_kernel(
    const float* __restrict__ carry, const int* __restrict__ carry_fib,
    float* __restrict__ w, int n_carries) {
  const int p = blockIdx.x * kFoldThreads + threadIdx.x;
  if (p >= n_carries) return;
  const int f = carry_fib[p];
  if (p > 0 && carry_fib[p - 1] == f) return;
  float sum = carry[p];
  for (int q = p + 1; q < n_carries && carry_fib[q] == f; ++q) {
    sum += carry[q];
  }
  w[f] = sum;
}

template <typename T, bool kSmemD, int kVecs>
cudaError_t launch_main(const int* wc_perm, const int* wc_fibers,
                        const int* atoms, const int* voxels, const T* values,
                        const T* dict, const float* y, float* w, float* carry,
                        int* carry_fib, int n_chunks, int c_tile, int n_atoms,
                        int n_theta, size_t smem, cudaStream_t stream) {
  auto kernel = wc_fcoo_kernel<T, kSmemD, kVecs>;
  int grid = 0;
  cudaError_t e = resident_grid(kernel, kThreads, smem,
                                (n_chunks + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(wc_perm, wc_fibers, atoms, voxels,
                                           values, dict, y, w, carry,
                                           carry_fib, n_chunks, c_tile,
                                           n_atoms, n_theta);
  return cudaGetLastError();
}

template <typename T, bool kSmemD>
cudaError_t launch_by_width(int vecs, const int* wc_perm,
                            const int* wc_fibers, const int* atoms,
                            const int* voxels, const T* values, const T* dict,
                            const float* y, float* w, float* carry,
                            int* carry_fib, int n_chunks, int c_tile,
                            int n_atoms, int n_theta, size_t smem,
                            cudaStream_t stream) {
#define WC_FCOO_ARGS                                                        \
  wc_perm, wc_fibers, atoms, voxels, values, dict, y, w, carry, carry_fib, \
      n_chunks, c_tile, n_atoms, n_theta, smem, stream
  switch (vecs) {
    case 1: return launch_main<T, kSmemD, 1>(WC_FCOO_ARGS);
    case 2: return launch_main<T, kSmemD, 2>(WC_FCOO_ARGS);
    case 3: return launch_main<T, kSmemD, 3>(WC_FCOO_ARGS);
    case 4: return launch_main<T, kSmemD, 4>(WC_FCOO_ARGS);
    default: return launch_main<T, kSmemD, 0>(WC_FCOO_ARGS);
  }
#undef WC_FCOO_ARGS
}

template <typename T>
int wc_fcoo_launch(const int* wc_perm, const int* wc_fibers, const int* atoms,
                   const int* voxels, const T* values, const T* dict,
                   const float* y, float* w, float* carry, int* carry_fib,
                   int n_chunks, int c_tile, int n_fibers, int n_atoms,
                   int n_theta, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(
      w, 0, sizeof(float) * static_cast<size_t>(n_fibers), stream);
  if (e != cudaSuccess || n_chunks <= 0) return static_cast<int>(e);
  const size_t dict_bytes = sizeof(T) * static_cast<size_t>(n_atoms) * n_theta;
  const bool stage_dict = dict_bytes <= static_cast<size_t>(smem_optin_bytes());
  // float4 columns need Ntheta % 4 == 0 and aligned rows of Y and of D
  const bool aligned =
      n_theta % 4 == 0 && reinterpret_cast<size_t>(y) % 16 == 0
      && (stage_dict || reinterpret_cast<size_t>(dict) % (4 * sizeof(T)) == 0);
  const int vecs = aligned && n_theta <= 4 * 32 ? (n_theta + 31) / 32 : 0;
  if (stage_dict) {
    e = launch_by_width<T, true>(vecs, wc_perm, wc_fibers, atoms, voxels,
                                 values, dict, y, w, carry, carry_fib,
                                 n_chunks, c_tile, n_atoms, n_theta,
                                 dict_bytes, stream);
  } else {
    e = launch_by_width<T, false>(vecs, wc_perm, wc_fibers, atoms, voxels,
                                  values, dict, y, w, carry, carry_fib,
                                  n_chunks, c_tile, n_atoms, n_theta, 0,
                                  stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_carries = 2 * n_chunks;
  wc_fcoo_fold_kernel<<<(n_carries + kFoldThreads - 1) / kFoldThreads,
                        kFoldThreads, 0, stream>>>(carry, carry_fib, w,
                                                   n_carries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, one per storage type of D and the values.  Each returns
// cudaGetLastError() after its launches (0 = launched).  carry (n_chunks x 2
// floats) and carry_fib (n_chunks x 2 ints) are scratch.
extern "C" int wc_fcoo_f32(const int* wc_perm, const int* wc_fibers,
                           const int* atoms, const int* voxels,
                           const float* values, const float* dict,
                           const float* y, float* w, float* carry,
                           int* carry_fib, int n_chunks, int c_tile,
                           int n_fibers, int n_atoms, int n_theta,
                           void* stream) {
  return wc_fcoo_launch<float>(wc_perm, wc_fibers, atoms, voxels, values, dict,
                               y, w, carry, carry_fib, n_chunks, c_tile,
                               n_fibers, n_atoms, n_theta,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int wc_fcoo_bf16(const int* wc_perm, const int* wc_fibers,
                            const int* atoms, const int* voxels,
                            const __nv_bfloat16* values,
                            const __nv_bfloat16* dict, const float* y,
                            float* w, float* carry, int* carry_fib,
                            int n_chunks, int c_tile, int n_fibers,
                            int n_atoms, int n_theta, void* stream) {
  return wc_fcoo_launch<__nv_bfloat16>(wc_perm, wc_fibers, atoms, voxels,
                                       values, dict, y, w, carry, carry_fib,
                                       n_chunks, c_tile, n_fibers, n_atoms,
                                       n_theta,
                                       static_cast<cudaStream_t>(stream));
}
