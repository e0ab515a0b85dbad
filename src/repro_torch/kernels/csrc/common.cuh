// Helpers shared by the kernels under csrc/.  Plain CUDA C++: no
// PyTorch header is included anywhere under csrc/, so nvcc builds each
// kernel in seconds (route (b): a shared library with a C interface, loaded
// from Python with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

// Storage types of the dictionary and the Phi values: float, or bf16 widened
// on load.  Every sum is taken in float.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dictionary loads: from shared memory when the kernel staged D there, else
// from device memory through the read-only data cache.
template <bool kSmem, typename T>
__device__ __forceinline__ float load_dict(const T* p) {
  if constexpr (kSmem) {
    return to_float(*p);
  } else {
    return to_float(__ldg(p));
  }
}

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFull, v, offset);
  }
  return v;
}

// ---------------------------------------------------------------------------
// Row dot products <D[atom], Y[voxel]> of a batch of 32 slots (B2, B4, B6).
// ---------------------------------------------------------------------------

constexpr int kGroup = 8;  // lanes that share one slot's dot product

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

// The products <D[a], Y[v]> of the 32 slots whose atom a and voxel v lane s
// holds for slot s.  The warp splits into 4 groups of 8 lanes; group q takes
// slots 8q .. 8q + 7, one per step, and sums each product over its lanes by
// three shuffles, so the product of slot `lane` ends on lane `lane`.
template <typename T, bool kSmemD, int kVecs>
__device__ __forceinline__ float batch_dots(const T* d, const float* y, int a,
                                            int v, int lane, int n_theta) {
  const int lg = lane % kGroup;
  const int group_lane0 = lane - lg;
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
  return mine;
}

// float4 vectors per lane that group_dot may take for rows of Ntheta: 0 (the
// scalar path) unless Ntheta is a multiple of 4 up to 128 and the rows of Y
// and of D (when D is read from device memory) are aligned for them.
template <typename T>
static inline int dot_vecs(int n_theta, const float* y, const T* dict,
                           bool stage_dict) {
  const bool aligned =
      n_theta % 4 == 0 && reinterpret_cast<size_t>(y) % 16 == 0
      && (stage_dict || reinterpret_cast<size_t>(dict) % (4 * sizeof(T)) == 0);
  return aligned && n_theta <= 4 * 32 ? (n_theta + 31) / 32 : 0;
}

// Segmented inclusive scan over the warp, in a fixed tree: `start` is the
// first lane of this lane's segment; returns the sum of x over lanes
// start .. lane.
__device__ __forceinline__ float segmented_scan(float x, int start,
                                                int lane) {
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const float o = __shfl_up_sync(kFull, x, dd);
    if (lane - dd >= start) x += o;
  }
  return x;
}

// ---------------------------------------------------------------------------
// A warp's walk over COO tiles (B1, B2).
// ---------------------------------------------------------------------------

// One batch of a walk: up to 32 consecutive real slots of one tile.
struct CooBatch {
  int rb;        // row block of the batch's tile (warp-uniform)
  int m;         // real slots in the batch; 0 once the walk is done
  size_t slot0;  // index of its first slot in the (n_tiles, c_tile) arrays
};

// The tiles of row blocks [rb0, rb1) of a TilePlan, tile_ptr[rb0] ..
// tile_ptr[rb1] in order, each tile's real prefix (tile_len) in batches of
// up to 32 slots.  Every lane holds the same walk.  tile_ptr and tile_len
// are read 32 entries at a time (lane i holds entry base + i) and broadcast
// by shuffles, so a batch usually costs no load of its own besides its
// slots.  A tile of no real slot yields no batch.
class TileWalk {
 public:
  __device__ TileWalk(const int* tile_ptr, const int* tile_len, int rb0,
                      int rb1, int c_tile, int lane)
      : tile_ptr_(tile_ptr), tile_len_(tile_len), c_tile_(c_tile),
        lane_(lane), rb_end_(rb1), rb_(rb0) {
    ptr_base_ = rb0;
    ptr_win_ = rb0 + lane <= rb1 ? tile_ptr[rb0 + lane] : 0;
    t_ = __shfl_sync(kFull, ptr_win_, 0) - 1;
    t_end_ = tile_ptr[rb1];
    len_base_ = t_ + 1 - 32;  // the first len() loads its window
  }

  __device__ CooBatch next() {
    while (base_ >= n_) {  // the tile is done: on to the next one
      if (++t_ >= t_end_) return CooBatch{rb_end_, 0, 0};
      base_ = 0;
      n_ = len(t_);
      while (ptr(rb_ + 1) <= t_) ++rb_;
    }
    const CooBatch b{rb_, n_ - base_ < 32 ? n_ - base_ : 32,
                     static_cast<size_t>(t_) * c_tile_ + base_};
    base_ += 32;
    return b;
  }

 private:
  // tile_ptr[i] and tile_len[i]; i never decreases between calls
  __device__ int ptr(int i) {
    if (i >= ptr_base_ + 32) {
      ptr_base_ = i;
      ptr_win_ = i + lane_ <= rb_end_ ? tile_ptr_[i + lane_] : 0;
    }
    return __shfl_sync(kFull, ptr_win_, i - ptr_base_);
  }

  __device__ int len(int i) {
    if (i >= len_base_ + 32) {
      len_base_ = i;
      len_win_ = i + lane_ < t_end_ ? tile_len_[i + lane_] : 0;
    }
    return __shfl_sync(kFull, len_win_, i - len_base_);
  }

  const int* tile_ptr_;
  const int* tile_len_;
  int c_tile_, lane_, rb_end_;
  int rb_;         // row block of tile t_
  int t_, t_end_;  // the current tile; one past the walk's last
  int base_ = 0;   // slot of tile t_ that the next batch starts at
  int n_ = 0;      // tile_len[t_]
  int ptr_base_, ptr_win_, len_base_, len_win_ = 0;
};

// A batch's slot `lane` as this lane holds it (zeros past the batch's end).
struct CooSlot {
  int atom = 0;
  int other = 0;  // fiber (DSC) or voxel (WC)
  int row = 0;    // row within the row block (COO), the row (SELL)
  float value = 0.f;
};

template <typename T>
__device__ __forceinline__ CooSlot load_slot(const CooBatch& b,
                                             const int* atoms,
                                             const int* others,
                                             const T* values,
                                             const int* local_row, int lane) {
  CooSlot s;
  if (lane < b.m) {
    const size_t i = b.slot0 + lane;
    s.atom = atoms[i];
    s.other = others[i];
    s.row = local_row[i];
    s.value = to_float(values[i]);
  }
  return s;
}

// ---------------------------------------------------------------------------
// A warp's walk over SELL rows (B4).
// ---------------------------------------------------------------------------

// One batch of a SellWalk: up to 32 consecutive real slots of the warp's
// rows.  m is warp-uniform; row and slot are this lane's own (row -1 and
// slot 0 on lanes m .. 31).
struct SellBatch {
  int m;        // real slots in the batch; 0 once the walk is done
  int row;      // the row of this lane's slot
  size_t slot;  // its index in the (rows_padded, width) slot arrays
};

// The real slots of rows [r0, r1) of a SELL layout (row r's are its prefix
// [0, row_nnz[r]) of `width` slots), in row order, packed into batches of
// up to 32: a batch may span several rows, a row of more than 32 slots
// spans batches and a row of none yields nothing.  row_nnz is read 32 rows
// at a time (lane i holds row base + i) and scanned over the lanes, so each
// lane holds where its row ends in the window's packed stream; a lane finds
// the row of its slot by a binary search over those ends (five shuffles).
// Every lane holds the same walk.  r1 may not pass the end of row_nnz.
class SellWalk {
 public:
  __device__ SellWalk(const int* row_nnz, int r0, int r1, int width,
                      int lane)
      : row_nnz_(row_nnz), r_end_(r1), width_(width), lane_(lane) {
    window(r0);
  }

  __device__ SellBatch next() {
    SellBatch b{0, -1, 0};
    while (b.m < 32) {
      if (pos_ == total_) {  // the window is done: on to the next one
        if (base_ + 32 >= r_end_) break;
        window(base_ + 32);
        continue;
      }
      const int take = min(32 - b.m, total_ - pos_);
      const int q = pos_ + lane_ - b.m;  // this lane's slot in the window
      // k: the rows of the window that end at or before slot q
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, end_, k + step - 1) <= q) k += step;
      }
      const int start = __shfl_sync(kFull, end_ - nnz_, k);
      if (lane_ >= b.m && lane_ < b.m + take) {
        b.row = base_ + k;
        b.slot = static_cast<size_t>(b.row) * width_ + (q - start);
      }
      b.m += take;
      pos_ += take;
    }
    return b;
  }

 private:
  // rows [base, base + 32): nnz_ and end_ (the inclusive scan of nnz_) of
  // this lane's row, total_ the window's real slots
  __device__ void window(int base) {
    base_ = base;
    nnz_ = base + lane_ < r_end_ ? row_nnz_[base + lane_] : 0;
    end_ = nnz_;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int o = __shfl_up_sync(kFull, end_, dd);
      if (lane_ >= dd) end_ += o;
    }
    total_ = __shfl_sync(kFull, end_, 31);
    pos_ = 0;
  }

  const int* row_nnz_;
  int r_end_, width_, lane_;
  int base_;         // first row of the window
  int nnz_, end_;    // this lane's row: real slots, end in the window
  int total_;        // real slots of the window
  int pos_;          // slot of the window that the next batch starts at
};

template <typename T>
__device__ __forceinline__ CooSlot load_slot(const SellBatch& b,
                                             const int* atoms,
                                             const int* others,
                                             const T* values, int lane) {
  CooSlot s;
  if (lane < b.m) {
    s.atom = atoms[b.slot];
    s.other = others[b.slot];
    s.row = b.row;
    s.value = to_float(values[b.slot]);
  }
  return s;
}

// Shared memory one block may use after opting in (227 KB on an H100).
static inline int smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// Grid for a kernel whose blocks stride over `work_items` row blocks: as
// many blocks as fit on the SMs at once (never more than there is work),
// so per-block set-up such as staging the dictionary is paid once per
// resident block.  Opts the kernel in to `smem` bytes of dynamic shared
// memory first when that exceeds the 48 KB default.
template <typename Kernel>
static cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                                 int work_items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long g = static_cast<long long>(sms) * per_sm;
  if (g > work_items) g = work_items;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return cudaSuccess;
}
