// Batched linear-SVM window scoring (eq. 6): feats (B, F) f32 or bf16,
// w (F,) f32, b () f32 -> scores (B,) f32 = feats . w + b, accumulated in
// f32. A bf16 feature is upcast exactly (its 16 bits become the high half
// of an f32) before its product with the f32 weight, which is what the
// reference kernel path computes.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:38 (svm_scores),
// a (TB, TF) x (TF, 1) MXU matmul with F padded to 3840 and the K grid
// dimension accumulating into the output block.
//
// Bound on the H100: bytes. One row is 15.1 KB in f32 (7.6 KB in bf16),
// so B = 5,949 rows read 90 MB (45 MB), 27 us (13 us) at 3.35 TB/s; the
// 15 KB weight vector stays in L1/L2. 2*F operations per row are far
// below the f32 rate. A one-column product has nothing for a matrix unit
// to reuse, so the design is a streaming reduction with enough loads in
// flight: a row's 8 (f32) or 4 (bf16) segments on as many warps.
//
// The summation order -- fixed by F and the dtype alone, never by B, so
// a window's score is the same bits whatever batch it is in
// (kernels/svm_matmul.py:svm_order; tests/test_torch_window_tail_plan.py
// models it in numpy):
//  * a row is U units of 16 bytes (4 f32 or 8 bf16 features) and a tail
//    of F - U * unit features; the units are cut into SEGS segments, 8
//    for f32 and 4 for bf16 (about 1.9 KB each at F = 3,780), segment s =
//    units [s*U/SEGS, (s+1)*U/SEGS);
//  * in a segment, lane l of a warp takes units u0 + 32 j + l, and adds
//    each unit's products one by one, in feature order, into its
//    accumulator j % 4; the lane's sum is ((a0 + a1) + a2) + a3, and a
//    5-step xor shuffle adds the 32 lanes;
//  * the tail's products are added in order from 0; the score is
//    ((p0 + p1 + ...) + tail) + b, left to right.
// A CTA of 8 warps owns 8 / SEGS rows (1 f32, 2 bf16), one warp a segment
// (kernels/svm_matmul.py:svm_scores_plan; the launcher refuses any other):
// of 1 to 8 rows a CTA tried on the H100 at B 11 to 5,949, that was the
// fastest or within 7% everywhere. Loads: rows stream through
// ld.global.cs in 16-byte loads, 4 in flight a lane; a bf16 row that
// starts 8 bytes off a 16-byte boundary (the odd rows at F = 3,780) loads
// the 16 bytes from the middle of unit u to the middle of unit u + 1 and
// takes unit u's first half from the lane before it (a shuffle; lane 0
// from lane 31 of the step before, or, first, an 8-byte load), so it too
// runs on 16-byte loads in the same order; any other alignment loads
// element by element. The weights go through the read-only path and stay
// in L1.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ACC = 4;                // accumulators of a lane
constexpr unsigned FULL = 0xffffffffu;

enum Load { kVec = 0, kShift = 1, kScalar = 2 };

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float madd(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
__device__ __forceinline__ float4 weights4(const float* w, bool wvec) {
  return wvec ? __ldg(reinterpret_cast<const float4*>(w))
              : make_float4(__ldg(w), __ldg(w + 1), __ldg(w + 2),
                            __ldg(w + 3));
}

// f32 rows: a unit is 4 features, a row 8 segments
struct F32 {
  using T = float;
  static constexpr int UNIT = 4, SEGS = 8;
  static __device__ __forceinline__ float dot(uint4 x, const float* w,
                                              bool wvec, float acc) {
    const float4 v = weights4(w, wvec);
    acc = madd(acc, __uint_as_float(x.x), v.x);
    acc = madd(acc, __uint_as_float(x.y), v.y);
    acc = madd(acc, __uint_as_float(x.z), v.z);
    return madd(acc, __uint_as_float(x.w), v.w);
  }
  static __device__ __forceinline__ float feature(const T* row, int f) {
    return __ldcs(row + f);
  }
  static __device__ __forceinline__ uint4 scalar_unit(const T* row, int u) {
    const T* p = row + UNIT * u;
    return make_uint4(__float_as_uint(__ldcs(p)),
                      __float_as_uint(__ldcs(p + 1)),
                      __float_as_uint(__ldcs(p + 2)),
                      __float_as_uint(__ldcs(p + 3)));
  }
};

// bf16 rows, as raw 16-bit words: a unit is 8 features, two a word (the
// first in the low half), a row 4 segments (as many bytes a segment as
// f32's)
struct BF16 {
  using T = uint16_t;
  static constexpr int UNIT = 8, SEGS = 4;
  static __device__ __forceinline__ float dot(uint4 x, const float* w,
                                              bool wvec, float acc) {
    const float4 a = weights4(w, wvec), b = weights4(w + 4, wvec);
    acc = madd(acc, bf16_lo(x.x), a.x);
    acc = madd(acc, bf16_hi(x.x), a.y);
    acc = madd(acc, bf16_lo(x.y), a.z);
    acc = madd(acc, bf16_hi(x.y), a.w);
    acc = madd(acc, bf16_lo(x.z), b.x);
    acc = madd(acc, bf16_hi(x.z), b.y);
    acc = madd(acc, bf16_lo(x.w), b.z);
    return madd(acc, bf16_hi(x.w), b.w);
  }
  static __device__ __forceinline__ float feature(const T* row, int f) {
    return __uint_as_float(static_cast<uint32_t>(__ldcs(row + f)) << 16);
  }
  static __device__ __forceinline__ uint32_t pair(const T* p) {
    return static_cast<uint32_t>(__ldcs(p)) |
           (static_cast<uint32_t>(__ldcs(p + 1)) << 16);
  }
  static __device__ __forceinline__ uint4 scalar_unit(const T* row, int u) {
    const T* p = row + UNIT * u;
    return make_uint4(pair(p), pair(p + 2), pair(p + 4), pair(p + 6));
  }
};

// A warp's loads of one chunk of a segment, units [base, base + 32 ACC)
// clipped at u1: lane l's k-th is unit base + 32 k + l, raw (zero past
// u1); kShift rows load from the middle of the unit, kScalar ones element
// by element.
template <class D>
__device__ __forceinline__ void load_chunk(uint4 (&x)[ACC],
                                           const typename D::T* row,
                                           int base, int u1, int load,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int u = base + 32 * k + lane;
    x[k] = make_uint4(0u, 0u, 0u, 0u);
    if (u >= u1) continue;
    if (load == kScalar)
      x[k] = D::scalar_unit(row, u);
    else
      x[k] = __ldcs(reinterpret_cast<const uint4*>(
          row + D::UNIT * u + (load == kShift ? D::UNIT / 2 : 0)));
  }
}

// kShift: the first half of a segment's first unit, which lane 0 takes
// (an 8-byte load); zero otherwise.
template <class D>
__device__ __forceinline__ uint2 peel(const typename D::T* row, int u0,
                                      int u1, int load, int lane) {
  if (D::UNIT == 8 && load == kShift && lane == 0 && u0 < u1)
    return __ldcs(reinterpret_cast<const uint2*>(row + D::UNIT * u0));
  return make_uint2(0u, 0u);
}

// Add a loaded chunk's units into the lane's accumulators, unit j of the
// segment into acc[j % ACC]. kShift: each lane takes its unit's first half
// from the lane before (lane 0 from ``carry``, which then holds lane 31's
// for the next chunk).
template <class D>
__device__ __forceinline__ void add_chunk(float (&acc)[ACC], uint2& carry,
                                          uint4 (&x)[ACC], const float* w,
                                          int base, int u1, int load,
                                          bool wvec, int lane) {
  if constexpr (D::UNIT == 8) {
    if (load == kShift) {              // whole warps: a row is one warp's
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        const uint32_t lz = __shfl_up_sync(FULL, x[k].z, 1);
        const uint32_t lw = __shfl_up_sync(FULL, x[k].w, 1);
        const uint32_t nz = __shfl_sync(FULL, x[k].z, 31);
        const uint32_t nw = __shfl_sync(FULL, x[k].w, 31);
        x[k] = make_uint4(lane == 0 ? carry.x : lz, lane == 0 ? carry.y : lw,
                          x[k].x, x[k].y);
        carry = make_uint2(nz, nw);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    const int u = base + 32 * k + lane;
    if (u < u1) acc[k] = D::dot(x[k], w + D::UNIT * u, wvec, acc[k]);
  }
}

// ((a0 + a1) + a2) + a3, then the 32 lanes by a 5-step xor shuffle; every
// lane returns the warp's sum.
__device__ __forceinline__ float warp_total(const float (&acc)[ACC]) {
  float v = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The warp's sum of units [u0, u1) of one row, chunk by chunk.
template <class D>
__device__ __forceinline__ float segment_sum(const typename D::T* row,
                                             const float* w, int u0, int u1,
                                             int load, bool wvec, int lane) {
  float acc[ACC] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint2 carry = peel<D>(row, u0, u1, load, lane);
#pragma unroll 1
  for (int base = u0; base < u1; base += 32 * ACC) {
    uint4 x[ACC];
    load_chunk<D>(x, row, base, u1, load, lane);
    add_chunk<D>(acc, carry, x, w, base, u1, load, wvec, lane);
  }
  return warp_total(acc);
}

// The load mode of a row at ``x``: 16-byte loads where it is 16-byte
// aligned, shifted ones where a bf16 row starts 8 bytes off and its tail
// holds the last unit's second half, element by element otherwise.
template <class D>
__device__ __forceinline__ int load_mode(const typename D::T* x, int F,
                                         int U) {
  const unsigned off = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(x) & 15u);
  return off == 0 ? kVec
         : D::UNIT == 8 && off == 8 && F - 8 * U >= 4 ? kShift : kScalar;
}

// CTA i takes rows [i R, i R + R), R = 8 / SEGS: warp w adds up segment
// w % SEGS of row w / SEGS (one warp a segment); the warp of the last
// segment also the tail, its features loaded one a lane before the
// segment (so their latency overlaps the segment's loads) and added in
// order by lane 0 after it; the segment sums meet in shared memory and
// one thread a row adds them up with the tail and the bias.
template <class D>
__global__ void __launch_bounds__(THREADS)
svm_scores_kernel(const void* __restrict__ feats_in,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ out, int B, int F, bool wvec) {
  using T = typename D::T;
  constexpr int SEGS = D::SEGS, R = WARPS / SEGS;
  extern __shared__ float part[];       // [R][SEGS + 1]: sums, tail
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = warp / SEGS, s = warp % SEGS;
  const long long row = static_cast<long long>(blockIdx.x) * R + r;
  const int U = F / D::UNIT, tail0 = D::UNIT * U;
  if (row < B) {                        // whole warps: a row is one warp's
    const T* x = static_cast<const T*>(feats_in) + row * F;
    const bool tail = s == SEGS - 1 && tail0 + lane < F;
    const float tx = tail ? D::feature(x, tail0 + lane) : 0.0f;
    const float tw = tail ? __ldg(w + tail0 + lane) : 0.0f;
    const float v = segment_sum<D>(x, w, s * U / SEGS, (s + 1) * U / SEGS,
                                   load_mode<D>(x, F, U), wvec, lane);
    float* p = part + r * (SEGS + 1);
    if (lane == 0) p[s] = v;
    if (s == SEGS - 1) {
      const float pt = __fmul_rn(tx, tw);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < D::UNIT - 1; ++k) {
        const float pk = __shfl_sync(FULL, pt, k);
        if (tail0 + k < F) sum = __fadd_rn(sum, pk);
      }
      if (lane == 0) p[SEGS] = sum;
    }
  }
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * R + threadIdx.x;
  if (threadIdx.x < R && q < B) {
    const float* pq = part + threadIdx.x * (SEGS + 1);
    float sum = pq[0];
#pragma unroll
    for (int k = 1; k <= SEGS; ++k) sum = __fadd_rn(sum, pq[k]);
    out[q] = __fadd_rn(sum, bias[0]);
  }
}

using Kernel = void (*)(const void*, const float*, const float*, float*, int,
                        int, bool);

// The instantiation for a dtype (0 f32, 1 bf16), its rows a CTA and its
// shared memory (the rows' segment sums and tails).
template <class D>
Kernel instance(int* rows, int* smem) {
  *rows = WARPS / D::SEGS;
  *smem = 4 * *rows * (D::SEGS + 1);
  return svm_scores_kernel<D>;
}

Kernel pick(int bf16, int* rows, int* smem) {
  if (bf16 == 0) return instance<F32>(rows, smem);
  if (bf16 == 1) return instance<BF16>(rows, smem);
  return nullptr;
}

}  // namespace

// Launch with the plan of kernels/svm_matmul.py:svm_scores_plan: grid
// ceil(B / rows) CTAs of THREADS. feats is f32 when bf16 == 0, bf16 (as
// raw 16-bit words) otherwise. A plan whose rows or thread count is not
// the dtype's, whose grid is not the rows' cover, or whose shared memory
// is short is refused with cudaErrorInvalidValue.
extern "C" int svm_scores_launch(const void* feats, const float* w,
                                 const float* bias, float* out, int B, int F,
                                 int bf16, int rows, int grid, int threads,
                                 int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  int want = 0, need = 0;
  const Kernel k = pick(bf16, &want, &need);
  if (k == nullptr || rows != want || threads != THREADS ||
      smem_bytes < need || F < 1 ||
      static_cast<long long>(grid) * rows < B ||
      static_cast<long long>(grid - 1) * rows >= B)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  k<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      feats, w, bias, out, B, F, wvec);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the dtype's kernel that one SM can hold at this thread count and
// shared memory, written to *blocks; returns the CUDA error code.
extern "C" int svm_scores_occupancy(int bf16, int rows, int threads,
                                    int smem_bytes, int* blocks) {
  int want = 0, need = 0;
  const Kernel k = pick(bf16, &want, &need);
  if (k == nullptr || rows != want)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, threads, smem_bytes));
}
