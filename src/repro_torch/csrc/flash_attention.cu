// Flash attention forward for LM prefill, GQA, causal or not:
// q (B, H, Sq, hd), k and v (B, K, Sk, hd) with H = K * rep, f32 or bf16,
// read through element strides (the last dimension unit-stride), so
// prefill hands in its (B, S, H, hd) projections with no transpose copy.
// Query head h reads KV head h / rep. Scale 1/sqrt(hd); scores, the
// running max m and sum l, and the accumulator are f32; p is rounded to
// v's dtype before the P.V product (as the TPU kernel's p.astype(v.dtype))
// while l sums the unrounded p; out = acc / max(l, 1e-30) in q's dtype.
// On request (training) each row's log-sum-exp m + log(max(l, 1e-30))
// goes to an f32 (B, H, S) output, as repro/models/attention.py:348
// (_flash_fwd_impl) keeps it for the backward
// (csrc/flash_attention_bwd.cu). Any lengths: rows past Sq and keys
// past Sk are masked (the TPU kernel asserts S is a multiple of its block).
//
// The queries may start at an offset into the keys (context-parallel
// prefill: one device's chunk of Sq queries at q_off against the whole
// sequence's Sk >= q_off + Sq keys). Causal, query i sees key j iff
// j <= q_off + i; otherwise it sees every key. A whole sequence is
// q_off 0 and Sq = Sk.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:86
// (flash_attention): a (B*H, nQ, nK) grid whose innermost K sweep carries
// (m, l, acc) in VMEM scratch from one grid step to the next. Thread
// blocks carry nothing between them, so here one thread block owns one
// (b*h, 64-query tile) and loops over the key tiles itself, skipping the
// tiles wholly above the diagonal when causal.
//
// This is the CUDA-core route of kernels/flash_attention.py:route: every
// f32 call, and bf16 at an hd other than 16, 64 or 128. bf16 at those hd
// goes to csrc/flash_attention_sm90.cu (wgmma tensor cores, TMA). f32
// stays here because TF32 tensor cores would break its 1e-5 checks.
//
// Bound on the H100 at qwen3-14b's widths (H 40, K 8, hd 128, bf16):
// bytes for B 4 x S 512 (q, k, v read once, o written once: 50.3 MB,
// 15 us at 3.35 TB/s); operations for B 1 x S 2048 (causal: 42.9 GFLOP,
// 43 us at the bf16 tensor-core rate). This first version runs both
// products on CUDA cores in f32, 256 threads a block: thread (ty, tx)
// owns query rows 4ty..4ty+3, score columns tx + 16j (j < 4) and output
// columns tx + 16c (c < 8), so a row's max and sum are a 16-lane shuffle
// and the online-softmax rescale stays in the thread's registers. Q, K
// and V tiles are staged in shared memory as f32, rows of Q and K padded
// to hd + 1 (an odd stride: the 16 lanes reading 16 K rows hit 16 banks);
// P reuses the K tile's space once the scores are in registers. At hd 128
// that is 98,816 bytes, above the 48 KB default, so the launch opts in
// (the wrapper checks the request, kernels/flash_attention.py).
//
// build.py compiles with --fmad=false: the dot products are spelled with
// __fmaf_rn, the rest with explicit roundings; expf, never __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per thread block
constexpr int BK = 64;                // keys per tile
constexpr int THREADS = 256;
constexpr int MAX_HD = 128;
constexpr int CPT = MAX_HD / 16;      // output columns per thread
constexpr float NEG_INF = -1e30f;     // the TPU kernel's mask value
constexpr int MAX_DEVICES = 64;       // devices whose opt-in is remembered

__host__ __device__ __forceinline__ int kp_floats(int hd) {
  const int k = BK * (hd + 1), p = BQ * (BK + 1);
  return k > p ? k : p;
}

// Q tile, K tile (then P), V tile; kernels/flash_attention.py:smem_bytes
__host__ __device__ __forceinline__ int smem_floats(int hd) {
  return BQ * (hd + 1) + kp_floats(hd) + BK * hd;
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

template <typename D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const typename D::T* __restrict__ q,
                       const typename D::T* __restrict__ k,
                       const typename D::T* __restrict__ v,
                       typename D::T* __restrict__ o,
                       float* __restrict__ lse, int H, int K, int Sq,
                       int Sk, int q_off, int hd, int causal, float scale,
                       long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long osb,
                       long long osh, long long oss) {
  extern __shared__ float smem[];
  const int QS = hd + 1, KS = hd + 1, VS = hd, PS = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Ps = Ks;                     // P overwrites K after the scores
  float* Vs = Ks + kp_floats(hd);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const typename D::T* qb = q + b * qsb + h * qsh;
  const typename D::T* kb = k + b * ksb + kvh * ksh;
  const typename D::T* vb = v + b * ksb + kvh * ksh;

  for (int i = t; i < BQ * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd, qi = q0 + r;
    Qs[r * QS + c] = qi < Sq ? D::load(qb, qi * qss + c) : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + q_off + BQ - 1) / BK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                  // the last tile's P and V are read
    for (int i = t; i < BK * hd; i += THREADS) {
      const int r = i / hd, c = i - r * hd, ki = k0 + r;
      const bool in = ki < Sk;
      const long long off = ki * kss + c;
      Ks[r * KS + c] = in ? D::load(kb, off) : 0.0f;
      Vs[r * VS + c] = in ? D::load(vb, off) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] = __fmaf_rn(qv[i], kv[jj], s[i][jj]);
    }

    // scale and mask; the row max over the tile's 64 keys (16 lanes)
    float mnew[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_off + q0 + 4 * ty + i;   // the row's key position
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ki = k0 + tx + 16 * jj;
        float x = __fmul_rn(s[i][jj], scale);
        if (ki >= Sk || (causal && ki > qi)) x = NEG_INF;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mnew[i] = mx;
    }
    __syncthreads();                  // every thread's K reads are done

    // p = exp(s - m_new); l = l * corr + sum(p); acc *= corr; P to smem
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = expf(__fsub_rn(m[i], mnew[i]));
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(__fsub_rn(s[i][jj], mnew[i]));
        rs = __fadd_rn(rs, p);
        Ps[(4 * ty + i) * PS + tx + 16 * jj] = D::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), rs);
      m[i] = mnew[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = Vs[kk * VS + col];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][c] = __fmaf_rn(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  typename D::T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) D::store(ob, qi * oss + col, __fdiv_rn(acc[i][c], den));
    }
    // the row's log-sum-exp for the backward (training only): every lane
    // of the 16 holds the row's m and l
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qi] =
          __fadd_rn(m[i], logf(den));
  }
}

template <typename D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int Sq, int Sk, int q_off, int hd,
           int causal, const long long* st, cudaStream_t stream) {
  const int bytes = smem_floats(hd) * static_cast<int>(sizeof(float));
  // the opt-in persists per function and device: set it once, for the
  // largest request so far (every launch on the device can then use it)
  static int opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes > 48 * 1024 && (dev >= MAX_DEVICES || bytes > opted[dev])) {
    e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) opted[dev] = bytes;
  }
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  // the TPU kernel's 1.0 / math.sqrt(hd), a double cut to f32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  using T = typename D::T;
  flash_attention_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, K, Sq, Sk, q_off,
      hd, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o are f32 when bf16 == 0, bf16 (raw 16-bit words) otherwise.
// Element strides of the first three dimensions: q's (qsb, qsh, qss), k's
// and v's (ksb, ksh, kss), o's (osb, osh, oss); the fourth is unit-stride.
// lse: null (serving), or a contiguous f32 (B, H, Sq) output that takes
// each row's m + log(max(l, 1e-30)) for the backward. Query row i sits at
// key position q_off + i; q_off >= 0 and q_off + Sq <= Sk.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int K, int Sq, int Sk, int q_off, int hd, int causal,
    int bf16, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long osb, long long osh, long long oss, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K || hd <= 0 || hd > MAX_HD || hd % 8 || q_off < 0 ||
      q_off + Sq > Sk || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(q, k, v, o, lse, B, H, K, Sq, Sk, q_off, hd,
                            causal, st, s)
              : launch<F32>(q, k, v, o, lse, B, H, K, Sq, Sk, q_off, hd,
                            causal, st, s);
}
