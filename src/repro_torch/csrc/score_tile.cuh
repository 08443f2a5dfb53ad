// The dense SVM scorer's kernel body, shared by score_matmul.cu (f32 and
// bf16 in, f32 out) and score_matmul_int8.cu (int8 in, exact int32 out):
// (M, K) block rows @ (K, N) per-offset weights -> (M, N).
//
// Heads: the N columns may be H equal groups (stacked SVM heads, each
// NH = N / H <= MAX_N columns wide, head-major: column h*NH + o is head
// h's offset o). The grid's second axis is the head: CTA (b, h) stages
// only head h's (K, NH) weights and runs the one-head body on them, then
// writes its NH columns at column h*NH of each row. Shared memory is the
// one-head size whatever H, and head h's outputs are, by construction,
// those of scoring head h alone. H = 1 is the plain (M, K) @ (K, N).
//
// Launch plan (kernels/svm_matmul.py:score_plan, checked by
// tests/test_torch_score_plan.py; the launcher refuses any other): rows
// go in units of 4, U = ceil(M / 4) of them, and the grid is
// G = min(max(1, SMs / H), U) CTAs per head, one per SM in all. CTA b
// owns the contiguous units [b*U/G, (b+1)*U/G) (floor division), so
// every CTA has floor(U/G) or ceil(U/G) units and the busiest SM
// 4*ceil(U/G) rows, the fewest possible; only the last unit of the last
// CTA is ragged. A CTA walks its span in passes of at most pass_units
// units, as many as its threads hold f32 micro-tiles
// (512 / ceil(NH/4): 18 units, 72 rows at NH = 105).
//
// Per pass, the product runs on
//  * f32: the CUDA cores. Each thread owns a 4-row x 4-column micro-tile
//    with 16 independent accumulators, k = 0..K-1 in order through
//    explicit fmaf (the build has --fmad=false);
//  * bf16: the tensor cores, mma.sync m16n8k16 (products exact in f32,
//    f32 accumulation);
//  * int8: the tensor cores, mma.sync m16n8k32 with s32 accumulation
//    (exact: |sum| <= K * 127^2).
// Each warp takes a run of 8-column tiles across every 16-row block, its
// B fragments gathered once from the raw weights.
//
// Shared memory, one CTA (layout<T>(), mirrored by
// svm_matmul.py:score_smem_bytes):
//   ws      the weights as they are in memory (K x N): no repacking pass
//           and no barrier for one; the f32 micro-tiles and the B
//           fragments read them where they are, consecutive threads
//           (or fragment lanes) in different banks;
//   xs[2]   two slabs of a pass's P = 4 * pass_units rows as they are in
//           memory (rows of Kp = K rounded up to 4 elements; Kp = K at
//           K = 36), the next pass's prefetched during this one;
//   outs    the pass's (rows x N) outputs, row-major: the span they
//           occupy in the output, written with 16-byte stores.
// (With heads, N is NH there: the head's weights are staged packed, row
// by row, and its outputs leave row by row, NH values at a row pitch of
// N.) Raw bytes arrive by 16-byte cp.async where the source is 16-byte
// aligned (the wrapper's vec flags, from data_ptr() % 16 and, with
// heads, NH), a tail by 4-byte cp.async; a misaligned source and rows
// whose K is no multiple of 4 go element by element, and so do the
// outputs of heads whose NH values are no multiple of 16 bytes (NH =
// 105: a head's columns start at h*420 bytes).
//
// Each phase runs a few iterations per launch: loops stay rolled
// (#pragma unroll 1) unless unrolling batches loads, and loads that may
// be skipped are made from a safe index and their value selected after,
// so no branch splits a batch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace score {

// kernels/svm_matmul.py:SCORE_THREADS, _MAX_K, _MAX_N
constexpr int MAX_THREADS = 512;
constexpr int MAX_K = 64;
constexpr int MAX_N = 128;
// the dynamic shared memory a CTA takes without opting in
constexpr int SMEM_DEFAULT = 48 * 1024;
// vec flags: which sources or destination are 16-byte aligned throughout
constexpr int VEC_X = 1, VEC_W = 2, VEC_OUT = 4;

// Element type T in memory -> output type C; KSTEP the mma depth (0: the
// CUDA cores), PACK the k values of one 4-byte fragment register.
template <typename T>
struct Elem {
  using C = float;
  static constexpr int KSTEP = 0, PACK = 1;
};
template <>
struct Elem<__nv_bfloat16> {
  using C = float;
  static constexpr int KSTEP = 16, PACK = 2;
};
template <>
struct Elem<int8_t> {
  using C = int;
  static constexpr int KSTEP = 32, PACK = 4;
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Byte offsets of one CTA's shared memory; every region starts 16-byte
// aligned.
struct Layout {
  int ws, xs0, xs1, outs, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int K, int N, int pass_units) {
  const int P = 4 * pass_units;
  const int ws = round_up(K * N * static_cast<int>(sizeof(T)), 16);
  const int xs = round_up(P * round_up(K, 4) * static_cast<int>(sizeof(T)),
                          16);
  Layout l;
  l.ws = 0;
  l.xs0 = ws;
  l.xs1 = ws + xs;
  l.outs = ws + 2 * xs;
  l.total = l.outs + P * N * 4;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// n elements from global src to shared dst. vec (both 16-byte aligned):
// whole 16-byte chunks, then 4-byte ones, all by cp.async, so no thread
// waits on a load here; what is left under 4 bytes, and everything when
// not vec, element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n,
                                      bool vec) {
  int done = 0;
  if (vec) {
    const int bytes = n * static_cast<int>(sizeof(T));
    char* d = reinterpret_cast<char*>(dst);
    const char* s = reinterpret_cast<const char*>(src);
    const int c16 = bytes / 16;
    for (int i = threadIdx.x; i < c16; i += blockDim.x)
      cp_async16(d + 16 * i, s + 16 * i);
    for (int i = 4 * c16 + threadIdx.x; i < bytes / 4; i += blockDim.x)
      cp_async4(d + 4 * i, s + 4 * i);
    done = bytes / 4 * 4 / static_cast<int>(sizeof(T));
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// rows x K input elements into rows of Kp: one flat copy where Kp == K
// and the span is 16-byte aligned (VEC_X), else element by element with
// zeros past K.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           int K, int Kp, bool vec) {
  if (vec) {
    stage(dst, src, rows * K, true);
    return;
  }
  for (int i = threadIdx.x; i < rows * Kp; i += blockDim.x) {
    const int r = i / Kp, k = i - r * Kp;
    dst[i] = k < K ? src[r * K + k] : T{};
  }
}

// n outputs from shared src to global dst: 16-byte stores when vec.
template <typename C>
__device__ __forceinline__ void store(C* dst, const C* src, int n,
                                      bool vec) {
  int done = 0;
  if (vec) {
    const int nv = n / 4;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    done = 4 * nv;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// rows x cols elements at a row pitch of `pitch` in global src, packed
// into shared dst (cols apart): the flat copy where they are contiguous;
// else, when vec (src, cols and pitch all on 16 bytes), 16-byte cp.async
// chunks row by row; else element by element.
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, const T* src, int rows,
                                           int cols, int pitch, bool vec) {
  if (cols == pitch) {
    stage(dst, src, rows * cols, vec);
    return;
  }
  if (vec) {
    const int c16 = cols * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < rows * c16; i += blockDim.x) {
      const int r = i / c16, c = i - r * c16;
      cp_async16(reinterpret_cast<char*>(dst + r * cols) + 16 * c,
                 reinterpret_cast<const char*>(src + r * pitch) + 16 * c);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[i] = src[r * pitch + c];
  }
}

// rows x cols outputs packed in shared src to global dst at a row pitch
// of `pitch`: the flat store where they are contiguous; else, when vec
// (dst, cols and pitch on 16 bytes), 16-byte stores row by row; else
// element by element, consecutive threads on consecutive columns.
template <typename C>
__device__ __forceinline__ void store_cols(C* dst, const C* src, int rows,
                                           int cols, int pitch, bool vec) {
  if (cols == pitch) {
    store(dst, src, rows * cols, vec);
    return;
  }
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int r = i / c4, c = i - r * c4;
      reinterpret_cast<int4*>(dst + r * pitch)[c] =
          reinterpret_cast<const int4*>(src + r * cols)[c];
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[static_cast<long long>(r) * pitch + c] = src[i];
  }
}

// A B fragment register from the raw weights w (K x N): column col, k
// from k0 on, PACK values packed little-endian (the lower k in the lower
// bits); zero at or past K. Every load is made, from row 0 past K, and
// its value selected after, so no branch splits the loads.
__device__ __forceinline__ unsigned b_word(const __nv_bfloat16* w, int k0,
                                           int col, int K, int N) {
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(w);
  unsigned word = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const unsigned v = bits[(k0 + e < K ? k0 + e : 0) * N + col];
    word |= (k0 + e < K ? v : 0u) << (16 * e);
  }
  return word;
}
__device__ __forceinline__ unsigned b_word(const int8_t* w, int k0, int col,
                                           int K, int N) {
  unsigned word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned v =
        static_cast<uint8_t>(w[(k0 + e < K ? k0 + e : 0) * N + col]);
    word |= (k0 + e < K ? v : 0u) << (8 * e);
  }
  return word;
}

// f32 on the CUDA cores: the thread's 4 x 4 micro-tile, the 4 staged rows
// from xr (Kp apart) times the raw weights' columns cg, cg + NG, cg + 2 NG,
// cg + 3 NG (NG = ceil(N/4); past N a column reads column 0, its outputs
// unused), 16 independent accumulators, k = 0..Kp-1 in order through
// explicit fmaf (past K the staged rows hold zeros, and the weights' last
// row is read). Each 16-byte row load feeds 4 columns and each weight
// load 4 rows; consecutive threads read consecutive weights.
__device__ __forceinline__ void micro_tile(const float* xr, int Kp, int K,
                                           const float* w, int N, int cg,
                                           int NG, float acc[4][4]) {
  int col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = cg + NG * j < N ? cg + NG * j : 0;
#pragma unroll 1
  for (int k = 0; k < Kp; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i * Kp + k);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* wr = w + min(k + t, K - 1) * N;
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wr[col[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][t], b[j], acc[i][j]);
    }
  }
}

// 4 bytes of a staged row from element k on (an A fragment register),
// zero at or past Kp, where the mma depth pads K (loaded from element 0
// there and discarded, so the loads need no branch).
template <typename T>
__device__ __forceinline__ unsigned a_word(const T* row, int k, int Kp) {
  const unsigned v =
      *reinterpret_cast<const unsigned*>(row + (k < Kp ? k : 0));
  return k < Kp ? v : 0u;
}

__device__ __forceinline__ void mma(const __nv_bfloat16*, const unsigned a[4],
                                    const unsigned b[2], float c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(const int8_t*, const unsigned a[4],
                                    const unsigned b[2], int c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 and int8 on the tensor cores: the pass's rows (slab, rows of Kp)
// times the raw weights w, in (16-row, 8-column) output tiles. Warp v
// takes the J column tiles J v .. J v + J - 1 (then J warps on, ...) of
// every 16-row block, J = ceil(column tiles / warps) so the tiles spread
// over the warps in one round: it gathers their B fragments once, for all
// k-steps, then per block loads the A fragments once for all J. The
// fragments are laid out as the PTX ISA gives them (lane = 4 g + t: A
// rows g and g + 8, k from PACK * t and KSTEP / 2 on; B column g, the
// same k); the results go into outs.
template <typename T, int J>
__device__ __forceinline__ void mma_tiles(const T* slab, int rows, int Kp,
                                          const T* w, int K, int N,
                                          typename Elem<T>::C* outs) {
  using C = typename Elem<T>::C;
  constexpr int PACK = Elem<T>::PACK, KSTEP = Elem<T>::KSTEP;
  constexpr int STEPS = (MAX_K + KSTEP - 1) / KSTEP;  // k-steps at most
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NT = (N + 7) / 8;
  const int MT = (rows + 15) / 16;
#pragma unroll 1
  for (int n0 = J * (threadIdx.x >> 5); n0 < NT;
       n0 += J * (blockDim.x >> 5)) {
    int n[J];
    unsigned b[STEPS][J][2];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      n[j] = 8 * min(n0 + j, NT - 1);   // a spare tile redoes the last
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[s][j][h] = b_word(w, s * KSTEP + h * KSTEP / 2 + PACK * t,
                              min(n[j] + g, N - 1), K, N);
    }
#pragma unroll 1
    for (int m = 0; m < MT; ++m) {
      const int r0 = 16 * m + g;
      const T* xa = slab + min(r0, rows - 1) * Kp;      // rows past the
      const T* xb = slab + min(r0 + 8, rows - 1) * Kp;  // pass: a real row
      C c[J][4];
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[j][q] = C(0);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (s * KSTEP >= K) break;
        const int k = s * KSTEP + PACK * t;
        const unsigned a[4] = {a_word(xa, k, Kp), a_word(xb, k, Kp),
                               a_word(xa, k + KSTEP / 2, Kp),
                               a_word(xb, k + KSTEP / 2, Kp)};
#pragma unroll
        for (int j = 0; j < J; ++j) mma(slab, a, b[s][j], c[j]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (n0 + j >= NT) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + 8 * (q >> 1), cc = n[j] + 2 * t + (q & 1);
          if (r < rows && cc < N) outs[r * N + cc] = c[j][q];
        }
      }
    }
  }
}

// mma_tiles with J = ceil(column tiles / warps), at most 4 (more take
// further rounds).
template <typename T>
__device__ __forceinline__ void mma_pass(const T* slab, int rows, int Kp,
                                         const T* w, int K, int N,
                                         typename Elem<T>::C* outs) {
  const int warps = blockDim.x >> 5;
  const int per = ((N + 7) / 8 + warps - 1) / warps;
  if (per <= 1)
    mma_tiles<T, 1>(slab, rows, Kp, w, K, N, outs);
  else if (per == 2)
    mma_tiles<T, 2>(slab, rows, Kp, w, K, N, outs);
  else if (per == 3)
    mma_tiles<T, 3>(slab, rows, Kp, w, K, N, outs);
  else
    mma_tiles<T, 4>(slab, rows, Kp, w, K, N, outs);
}

// The kernel body. out points at the (M, N) output, N = heads * NH;
// this CTA scores head blockIdx.y, its NH columns. pass_units and vec
// come from the plan and the wrapper.
template <typename T>
__device__ __forceinline__ void run(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    typename Elem<T>::C* __restrict__ out,
                                    int M, int K, int N, int heads,
                                    int pass_units, int vec) {
  using C = typename Elem<T>::C;
  extern __shared__ __align__(16) unsigned char smem[];
  // from here on the one-head body: N is the head's width, and w and out
  // point at its first column (row pitch ldo)
  const int ldo = N;
  N /= heads;
  w += static_cast<int>(blockIdx.y) * N;
  out += static_cast<int>(blockIdx.y) * N;
  const Layout L = layout<T>(K, N, pass_units);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  // slab s of the pass rows, from the shared base each time: an array of
  // the two pointers, indexed at run time, would go to local memory and
  // turn the row loads into generic ones
  auto slab = [&](int s) {
    return reinterpret_cast<T*>(smem + (s ? L.xs1 : L.xs0));
  };
  C* outs = reinterpret_cast<C*>(smem + L.outs);
  const int P = 4 * pass_units;
  const int Kp = round_up(K, 4);

  // this CTA's span (ScorePlan.span) and passes (ScorePlan.passes); the
  // launcher keeps units * grid under 2^31
  const int units = (M + 3) / 4;
  const int u0 = static_cast<int>(blockIdx.x) * units / gridDim.x;
  const int u1 = (static_cast<int>(blockIdx.x) + 1) * units / gridDim.x;
  const int r0 = 4 * u0;
  const int r1 = min(4 * u1, M);
  const int npass = (u1 - u0 + pass_units - 1) / pass_units;

  // 1. the weights (every CTA reads the same tile, so they go first) and
  // the first pass's rows
  stage_cols(ws, w, K, N, ldo, vec & VEC_W);
  stage_rows(slab(0), x + static_cast<long long>(r0) * K, min(P, r1 - r0), K,
             Kp, vec & VEC_X);
  cp_async_commit();

  // f32: the thread's micro-tile, rows 4u..4u+3 of a pass, columns cg,
  // cg + NG, cg + 2 NG, cg + 3 NG
  const int NG = (N + 3) / 4;
  const int u = threadIdx.x / NG;
  const int cg = threadIdx.x - u * NG;
  for (int p = 0; p < npass; ++p) {
    const int row0 = r0 + p * P;
    const int rows = min(P, r1 - row0);
    // 2. prefetch the next pass's rows; wait for this one's (and, in the
    // first pass, the weights)
    if (p + 1 < npass) {
      const int next = row0 + P;
      stage_rows(slab((p + 1) & 1), x + static_cast<long long>(next) * K,
                 min(P, r1 - next), K, Kp, vec & VEC_X);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 3. the product, into the pass's row-major output tile
    if constexpr (Elem<T>::KSTEP == 0) {
      if (4 * u < rows) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        micro_tile(slab(p & 1) + 4 * u * Kp, Kp, K, ws, N, cg, NG, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * u + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cg + NG * j;
            if (r < rows && c < N) outs[r * N + c] = acc[i][j];
          }
        }
      }
    } else {
      mma_pass(slab(p & 1), rows, Kp, ws, K, N, outs);
    }
    __syncthreads();

    // 4. the pass's outputs: one contiguous span of rows * N (one head:
    // rows of N at a pitch of ldo)
    store_cols(out + static_cast<long long>(row0) * ldo, outs, rows, N, ldo,
               vec & VEC_OUT);
  }
}

// Check a plan against ScorePlan's rules and launch; a plan that breaks
// them is refused with cudaErrorInvalidValue.
template <typename T, typename Kernel>
int launch(Kernel kernel, const T* x, const T* w, typename Elem<T>::C* out,
           int M, int K, int N, int grid, int heads, int pass_units,
           int threads, int smem_bytes, int vec, cudaStream_t stream) {
  if (M <= 0) return 0;
  if (heads < 1 || heads > 65535 || N < 1 || N % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NH = N / heads;
  if (K < 1 || K > MAX_K || NH > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (M + 3) / 4;
  const int NG = (NH + 3) / 4;
  if (grid < 1 || grid > units ||
      static_cast<long long>(units) * grid >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int umax = (units + grid - 1) / grid;
  const int most = MAX_THREADS / NG;
  const int npass = (umax + most - 1) / most;
  if (pass_units != (umax + npass - 1) / npass ||
      threads != (pass_units * NG + 31) / 32 * 32 ||
      smem_bytes != layout<T>(K, NH, pass_units).total || (vec & ~7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > SMEM_DEFAULT) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<dim3(grid, heads), threads, smem_bytes, stream>>>(
      x, w, out, M, K, N, heads, pass_units, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace score
