// Flash attention backward for LM training, GQA, causal or not: from q
// (B, H, Sq, hd), k and v (B, K, Sk, hd) with H = K * rep, the forward's
// output o and its log-sum-exp lse (f32 (B, H, Sq), written by
// csrc/flash_attention.cu or csrc/flash_attention_sm90.cu on request),
// and the output's gradient do -> dq, dk, dv in the inputs' dtype. f32
// or bf16; every tensor but lse read or written through element strides
// (the last dimension unit-stride), so training hands in its (B, S, H,
// hd) projections with no transpose copy. Query head h reads KV head
// h / rep. hd <= 128 and a multiple of 8; any lengths (rows past Sq and
// keys past Sk are masked). The queries sit at key positions q_off ..
// q_off + Sq - 1 (q_off + Sq <= Sk): causal, query i sees key j iff j <=
// q_off + i, as in the forward's offset form; a whole sequence is q_off
// 0 with Sq = Sk, and a context-parallel step hands each device its
// chunk of queries against the whole sequence's keys. A key that no
// query of the chunk sees gets exactly zero dK and dV.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward. Its
// gradient for attention is repro/models/attention.py:359 (_flash_bwd,
// the custom VJP of sdpa_flash), which recomputes the weights as
// w = exp(s - lse) from the saved LSE and forms dv = w^T do, dw = do v^T,
// delta = rowsum(dw * w), ds = w * (dw - delta) * scale, dq = ds k and
// dk = ds^T q. The port's forward is a hand-written kernel, so its
// gradient is one too. The same function here, in f32 with the
// reference's two roundings: w and ds are rounded to the inputs' dtype
// before they multiply (w.astype(v.dtype), ds.astype(q.dtype)); dw = do
// v^T stays f32 (the reference rounds it to the inputs' dtype too), and
// delta is rowsum(do * o) in f32, equal to rowsum(dw * w) in exact
// arithmetic and one pass over hd instead of a second sweep over keys.
//
// Bound on the H100 at qwen3-14b's widths (H 40, K 8, hd 128, bf16,
// causal): B 4 x S 512 moves q, k, v, o, do, dq, dk, dv and lse once
// (~100 MB, 30 us at 3.35 TB/s) and its five products over the attended
// pairs (s, dp, dV, dK, dQ: 2 hd operations each) are ~27 GFLOP (27 us at
// the bf16 tensor-core rate). This first
// version is simple and right, not fast: every product on CUDA cores in
// f32, three kernels on one stream, no atomics (a rerun is bit-identical):
//
//  * flash_attention_bwd_delta: delta = rowsum(do * o) in f32, one warp a
//    row, into an f32 (B, H, S) scratch the wrapper allocates.
//  * flash_attention_bwd_dkdv: one thread block per (b, KV head, 64-key
//    tile). It keeps the tile's K and V in shared memory and its dK and
//    dV in registers, and loops over the rep query heads of the group and
//    their 64-query tiles (from the diagonal tile on when causal),
//    recomputing s, w and ds for each; the GQA sum over rep is this loop,
//    so no two blocks write one dK or dV row.
//  * flash_attention_bwd_dq: one thread block per (b, h, 64-query tile),
//    longest rows first when causal, looping over the key tiles up to the
//    diagonal; dQ in registers.
//
// Both main kernels take 256 threads: thread (ty, tx) owns rows 4ty..4ty+3
// of a 64 x 64 score tile at columns tx + 16j (j < 4), and the same rows
// of its 64 x hd accumulators at columns tx + 16c (c < 8). Tiles are f32
// in shared memory with rows padded to hd + 1 (an odd stride: 16 lanes
// reading 16 rows hit 16 banks): at hd 128 that is four tiles and the
// 64 x 65 w / ds tile, 149,248 bytes, so the launch opts in
// (kernels/flash_attention.py:bwd_smem_bytes mirrors it and checks it
// against build.SMEM_OPTIN per call).
//
// build.py compiles with --fmad=false: the dot products are spelled with
// __fmaf_rn, the rest with explicit roundings; expf, never __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per tile
constexpr int BK = 64;                // keys per tile
constexpr int THREADS = 256;
constexpr int MAX_HD = 128;
constexpr int CPT = MAX_HD / 16;      // accumulator columns per thread
constexpr int MAX_DEVICES = 64;       // devices whose opt-in is remembered
constexpr int N_STRIDES = 24;         // 3 per tensor: q k v o do dq dk dv

// four f32 tiles of 64 rows at stride hd + 1, the 64 x 65 w / ds tile,
// and 64 lse and 64 delta values; kernels/flash_attention.py:bwd_smem_bytes
__host__ __device__ __forceinline__ int smem_floats(int hd) {
  return 4 * 64 * (hd + 1) + 64 * (BQ + 1) + 2 * 64;
}

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const T* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void store(T* p, long long i, float x) {
    p[i] = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

struct BF16 {
  using T = uint16_t;                 // raw bf16 bits
  static __device__ __forceinline__ float load(const T* p, long long i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
  static __device__ __forceinline__ void store(T* p, long long i, float x) {
    p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// element strides (batch, head, row) of one tensor
struct Strides {
  long long b, h, s;
};

struct Args {
  Strides q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ long long off(const Strides& st, int b, int h) {
  return b * st.b + h * st.h;
}

// rows r0..r0+63 of a (S, hd) slice into a 64 x (hd + 1) f32 tile, zeros
// past S
template <typename D>
__device__ __forceinline__ void load_tile(float* dst, const typename D::T* src,
                                          long long ss, int r0, int S,
                                          int hd) {
  for (int i = threadIdx.x; i < 64 * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd, row = r0 + r;
    dst[r * (hd + 1) + c] = row < S ? D::load(src, row * ss + c) : 0.0f;
  }
}

// delta[b, h, i] = sum_d do[i, d] * o[i, d] in f32: one warp a row
template <typename D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_delta(const typename D::T* __restrict__ o,
                          const typename D::T* __restrict__ dout,
                          float* __restrict__ delta, int H, int Sq, int hd,
                          long long rows, Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const typename D::T* ob = o + off(a.o, b, h) + i * a.o.s;
  const typename D::T* db = dout + off(a.dout, b, h) + i * a.dout.s;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32)
    acc = __fmaf_rn(D::load(db, c), D::load(ob, c), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  if (lane == 0) delta[row] = acc;
}

// s = a_tile . b_tile^T and t = c_tile . d_tile^T over hd for this
// thread's 4 x 4 entries: rows 4ty + i of a and c, rows tx + 16j of b
// and d (every tile at stride hd + 1)
__device__ __forceinline__ void two_products(const float* A, const float* Bt,
                                             const float* C, const float* Dt,
                                             int hd, float (&s)[4][4],
                                             float (&t)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, st = hd + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = A[(4 * ty + i) * st + d];
      cv[i] = C[(4 * ty + i) * st + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = Bt[(tx + 16 * j) * st + d];
      dv[j] = Dt[(tx + 16 * j) * st + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
        t[i][j] = __fmaf_rn(cv[i], dv[j], t[i][j]);
      }
  }
}

// acc[i][c] += sum_x P[4ty + i][x] * M[x][tx + 16c] over the 64 columns
// of P (stride BQ + 1) and rows of M (stride hd + 1)
__device__ __forceinline__ void accumulate(float (&acc)[4][CPT],
                                           const float* P, const float* M,
                                           int hd) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, st = hd + 1;
#pragma unroll 4
  for (int x = 0; x < 64; ++x) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(4 * ty + i) * (BQ + 1) + x];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        const float mv = M[x * st + col];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][c] = __fmaf_rn(pv[i], mv, acc[i][c]);
      }
    }
  }
}

template <typename D>
__device__ __forceinline__ void store_acc(typename D::T* dst, long long ss,
                                          const float (&acc)[4][CPT], int r0,
                                          int S, int hd) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) D::store(dst, row * ss + col, acc[i][c]);
    }
  }
}

// w = exp(s * scale - lse) (0 where masked) rounded to the inputs' dtype,
// and ds = w * (dp - delta) * scale rounded likewise, for this thread's
// 4 x 4 entries; qi / ki give each entry's query and key index, and key
// ki is masked past Sk, query qi past Sq, and, causal, where ki > q_off
// + qi
template <typename D, bool KEY_ROWS>
__device__ __forceinline__ void weights(float (&s)[4][4], float (&dp)[4][4],
                                        const float* lse_s,
                                        const float* delta_s, int r0, int c0,
                                        int Sq, int Sk, int q_off,
                                        int causal, float scale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * ty + i, c = tx + 16 * j;
      const int qi = KEY_ROWS ? c0 + c : r0 + r;
      const int ki = KEY_ROWS ? r0 + r : c0 + c;
      const int qr = KEY_ROWS ? c : r;          // the query's tile row
      float w = 0.0f, ds = 0.0f;
      if (qi < Sq && ki < Sk && !(causal && ki > q_off + qi)) {
        w = D::round(expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_s[qr])));
        ds = D::round(__fmul_rn(__fmul_rn(w, __fsub_rn(dp[i][j],
                                                       delta_s[qr])),
                                scale));
      }
      s[i][j] = w;
      dp[i][j] = ds;
    }
}

__device__ __forceinline__ void put(float* P, const float (&x)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) P[(4 * ty + i) * (BQ + 1) + tx + 16 * j] =
        x[i][j];
}

// dK and dV of one (b, KV head, key tile): keys are the rows of every
// score tile (s^T = K Q^T), so dV += w^T do and dK += ds^T q accumulate
// without a transpose. Causal, the first query tile is the one that holds
// query k0 - q_off; a tile of keys past q_off + Sq - 1 steps over none
// and stores zeros
template <typename D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkdv(const typename D::T* __restrict__ q,
                         const typename D::T* __restrict__ k,
                         const typename D::T* __restrict__ v,
                         const typename D::T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         typename D::T* __restrict__ dk,
                         typename D::T* __restrict__ dv, int H, int K,
                         int Sq, int Sk, int q_off, int hd, int causal,
                         float scale, Args a) {
  extern __shared__ float smem[];
  const int st = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + 64 * st;
  float* Qs = Vs + 64 * st;
  float* Os = Qs + 64 * st;            // do
  float* Ps = Os + 64 * st;            // w, then ds (keys x queries)
  float* lse_s = Ps + 64 * (BQ + 1);
  float* delta_s = lse_s + 64;

  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int rep = H / K, k0 = blockIdx.y * BK;
  load_tile<D>(Ks, k + off(a.k, b, kvh), a.k.s, k0, Sk, hd);
  load_tile<D>(Vs, v + off(a.v, b, kvh), a.v.s, k0, Sk, hd);

  float dK[4][CPT], dV[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dK[i][c] = dV[i][c] = 0.0f;

  const int nq = (Sq + BQ - 1) / BQ;
  const int first = causal ? max(k0 - q_off, 0) / BQ : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                // the last tile's Q, do, P are read
      load_tile<D>(Qs, q + off(a.q, b, h), a.q.s, q0, Sq, hd);
      load_tile<D>(Os, dout + off(a.dout, b, h), a.dout.s, q0, Sq, hd);
      if (threadIdx.x < 64) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse_h[qi] : 0.0f;
        delta_s[threadIdx.x] = qi < Sq ? delta_h[qi] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products(Ks, Qs, Vs, Os, hd, s, dp);    // K q^T, V do^T
      weights<D, true>(s, dp, lse_s, delta_s, k0, q0, Sq, Sk, q_off, causal,
                       scale);
      put(Ps, s);
      __syncthreads();
      accumulate(dV, Ps, Os, hd);
      __syncthreads();
      put(Ps, dp);
      __syncthreads();
      accumulate(dK, Ps, Qs, hd);
    }
  }
  store_acc<D>(dk + off(a.dk, b, kvh), a.dk.s, dK, k0, Sk, hd);
  store_acc<D>(dv + off(a.dv, b, kvh), a.dv.s, dV, k0, Sk, hd);
}

// dQ of one (b, h, query tile): dQ += ds K over the key tiles up to the
// diagonal, shifted by q_off (all when not causal)
template <typename D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dq(const typename D::T* __restrict__ q,
                       const typename D::T* __restrict__ k,
                       const typename D::T* __restrict__ v,
                       const typename D::T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       typename D::T* __restrict__ dq, int H, int K, int Sq,
                       int Sk, int q_off, int hd, int causal, float scale,
                       Args a) {
  extern __shared__ float smem[];
  const int st = hd + 1;
  float* Qs = smem;
  float* Os = Qs + 64 * st;            // do
  float* Ks = Os + 64 * st;
  float* Vs = Ks + 64 * st;
  float* Ps = Vs + 64 * st;            // ds (queries x keys)
  float* lse_s = Ps + 64 * (BQ + 1);
  float* delta_s = lse_s + 64;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  load_tile<D>(Qs, q + off(a.q, b, h), a.q.s, q0, Sq, hd);
  load_tile<D>(Os, dout + off(a.dout, b, h), a.dout.s, q0, Sq, hd);
  if (threadIdx.x < 64) {
    const int qi = q0 + threadIdx.x;
    const long long row = (static_cast<long long>(b) * H + h) * Sq + qi;
    lse_s[threadIdx.x] = qi < Sq ? lse[row] : 0.0f;
    delta_s[threadIdx.x] = qi < Sq ? delta[row] : 0.0f;
  }

  float dQ[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dQ[i][c] = 0.0f;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_off + q0 + BQ - 1) / BK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                  // the last tile's K and ds are read
    load_tile<D>(Ks, k + off(a.k, b, kvh), a.k.s, k0, Sk, hd);
    load_tile<D>(Vs, v + off(a.v, b, kvh), a.v.s, k0, Sk, hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products(Qs, Ks, Os, Vs, hd, s, dp);      // q K^T, do V^T
    weights<D, false>(s, dp, lse_s, delta_s, q0, k0, Sq, Sk, q_off, causal,
                      scale);
    put(Ps, dp);
    __syncthreads();
    accumulate(dQ, Ps, Ks, hd);
  }
  store_acc<D>(dq + off(a.dq, b, h), a.dq.s, dQ, q0, Sq, hd);
}

// set the dynamic shared-memory opt-in of one kernel once per device, for
// the largest request so far
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int (&opted)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (bytes > 48 * 1024 && (dev >= MAX_DEVICES || bytes > opted[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted[dev] = bytes;
  }
  return cudaSuccess;
}

template <typename D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int K, int Sq, int Sk,
           int q_off, int hd, int causal, const Args& a,
           cudaStream_t stream) {
  using T = typename D::T;
  const int bytes = smem_floats(hd) * static_cast<int>(sizeof(float));
  static int opted_kv[MAX_DEVICES] = {}, opted_q[MAX_DEVICES] = {};
  cudaError_t e = opt_in(flash_attention_bwd_dkdv<D>, bytes, opted_kv);
  if (e == cudaSuccess)
    e = opt_in(flash_attention_bwd_dq<D>, bytes, opted_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the forward's 1.0 / math.sqrt(hd), a double cut to f32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const long long rows = static_cast<long long>(B) * H * Sq;
  const unsigned nrow_blocks =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_attention_bwd_delta<D><<<nrow_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Sq, hd,
      rows, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned key_tiles = static_cast<unsigned>((Sk + BK - 1) / BK);
  const unsigned query_tiles = static_cast<unsigned>((Sq + BQ - 1) / BQ);
  flash_attention_bwd_dkdv<D>
      <<<dim3(B * K, key_tiles), THREADS, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), H, K, Sq, Sk, q_off, hd,
          causal, scale, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dq<D>
      <<<dim3(B * H, query_tiles), THREADS, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dq), H, K, Sq, Sk, q_off, hd, causal, scale, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv are f32 when bf16 == 0, bf16 (raw 16-bit
// words) otherwise; lse (the forward's) and delta (scratch) are
// contiguous f32 (B, H, Sq). q, o, dout and dq hold Sq rows, k, v, dk and
// dv Sk rows, the queries at key positions q_off on (q_off + Sq <= Sk).
// st: element strides (batch, head, row) of q, k, v, o, dout, dq, dk, dv
// in that order, 24 values; the last dimension of each is unit-stride.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int K, int Sq, int Sk, int q_off, int hd,
    int causal, int bf16, const long long* st, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K || hd <= 0 || hd > MAX_HD || hd % 8 || q_off < 0 ||
      q_off + Sq > Sk || (Sk + BK - 1) / BK > 65535 ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  Strides* all[8] = {&a.q, &a.k, &a.v, &a.o, &a.dout, &a.dq, &a.dk, &a.dv};
  for (int i = 0; i < N_STRIDES / 3; ++i)
    *all[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                             K, Sq, Sk, q_off, hd, causal, a, s)
              : launch<F32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            K, Sq, Sk, q_off, hd, causal, a, s);
}
