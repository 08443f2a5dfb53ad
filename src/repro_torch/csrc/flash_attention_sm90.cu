// Flash attention forward for LM prefill on Hopper's tensor cores, bf16:
// q (B, H, Sq, hd), k and v (B, K, Sk, hd) with H = K * rep, hd 16, 64 or
// 128, read through their strides (the last dimension unit-stride, the
// others multiples of 16 bytes), so prefill hands in its (B, S, H, hd)
// projections with no transpose copy. Query head h reads KV head h / rep.
// The function is csrc/flash_attention.cu's, rounding for rounding: f32
// scores times the f32 1/sqrt(hd), masked to -1e30; a running max m and
// sum l in f32, l summing the unrounded p; p = exp(s - m_new) rounded to
// bf16 before the P.V product; an f32 accumulator; out = acc / max(l,
// 1e-30) in bf16; on request each row's log-sum-exp m + log(max(l,
// 1e-30)) in f32 for the backward (csrc/flash_attention_bwd.cu). Any
// lengths: keys past Sk are masked, rows past Sq not stored. The queries
// may start at an offset q_off into the keys (context-parallel prefill:
// a device's chunk of the sequence against all of it): causal, query i
// sees key j iff j <= q_off + i, as in csrc/flash_attention.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:86
// (flash_attention) for bf16 at those hd; kernels/flash_attention.py:route
// sends every other call (f32, other hd) to csrc/flash_attention.cu, the
// CUDA-core kernel. f32 stays there: its checks hold it to 1e-5 of the
// plain version and the f32 prefill/decode consistency to 1e-3, and TF32
// tensor cores (10-bit mantissas) would break both.
//
// Bound on the H100 at qwen3-14b's widths (H 40, K 8, hd 128): bytes for
// B 4 x S 512 (q, k, v read once, o written once: 50.3 MB, 15 us at
// 3.35 TB/s); operations for B 1 x S 2048 (causal: 42.9 GFLOP, 43 us at
// the 989 TFLOP/s bf16 rate). Both products must run on the tensor cores
// and the loads must overlap them, so:
//
//  * One thread block owns one (b*h, 128-query tile), longest tiles first
//    when causal, and loops over 128-key tiles, skipping those wholly
//    above the diagonal. 384 threads: two consumer warpgroups of 64 query
//    rows each and a producer warpgroup, of which one thread issues the
//    copies; setmaxnreg gives the consumers 240 registers a thread and
//    the producer 24 (at 232 the hd 128 consumer spilled 8 bytes).
//  * Loads are TMA (cp.async.bulk.tensor, 4-D maps over hd, S, heads, B
//    with the real strides, built per call on the host and passed as
//    __grid_constant__ parameters). Q is loaded once; K and V stream
//    through a 2-stage ring with full/empty mbarriers. TMA zero-fills rows
//    past S. A row of a tile is cut into chunks of the swizzle span (128
//    bytes at hd 64 and 128, two chunks at hd 128; 32 bytes at hd 16), so
//    the swizzle TMA writes is the one the wgmma descriptors read.
//  * S = Q.K^T is wgmma m64n128k16 from shared memory, both K-major, into
//    64 f32 registers a thread. A row's 128 scores sit in a quad of
//    threads: the row max is two __shfl_xor_sync; l is summed per thread
//    and across the quad once, at the end.
//  * O += P.V is wgmma m64n{hd}k16 with P as the register A operand: the
//    f32 accumulator layout of S is the A-fragment layout, so p packs into
//    bf16x2 in place. V is the B operand from shared memory, MN-major (the
//    transpose bit). Each 16-key step is issued as soon as its p are
//    packed, so the tensor cores run it while the next exps are made; the
//    other consumer warpgroup's softmax overlaps this one's products.
//  * Shared memory at hd 128: Q 32 KB + 2 x (K 32 KB + V 32 KB), 160 KB
//    (kernels/flash_attention.py:smem_bytes_sm90 mirrors it and checks it
//    against the 227 KB opt-in); one block per SM.
//
// build.py compiles with --fmad=false: the softmax is spelled with
// explicit roundings; expf, never __expf. The scale is an f32 multiply
// after the product, as in the CUDA-core kernel.
#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"   // mbarriers, TMA, descriptors, wgmma

namespace {

using namespace sm90;

constexpr int BQ = 128;               // query rows per thread block
constexpr int BK = 128;               // keys per tile
constexpr int STAGES = 2;             // the K/V ring
constexpr int CONSUMERS = 256;        // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr float NEG_INF = -1e30f;     // the TPU kernel's mask value
constexpr int MAX_DEVICES = 64;       // devices whose opt-in is remembered

// Shared-memory geometry of one hd. A tile row is cut into NC chunks of
// CW columns, each chunk a (rows x SW bytes) block in the SW-byte swizzle
// (sm90_wgmma.cuh:Swz).
template <int HD>
struct Geo : Swz<HD> {
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // 1024 bytes to align the tiles to the swizzle's repeat, then Q, the
  // K ring, the V ring and the barriers (q_full, full[], empty[])
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int K,
                            int Sq, int Sk, int q_off, int causal,
                            float scale, long long osb,
                            long long osh, long long oss) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + G::Q_BYTES;                  // + stage * KV_BYTES
  const uint32_t sv = sk + STAGES * G::KV_BYTES;
  const uint32_t q_full = base + G::BAR_OFF;
  const uint32_t full = q_full + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + q_off + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q once, then K and V tile j into stage j % STAGES once
    // every consumer thread has released the tile held there before
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
      for (int c = 0; c < G::NC; ++c)
        tma_load(sq + c * BQ * G::SW, &tq, q_full, c * G::CW, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
          const uint32_t off = s * G::KV_BYTES + c * BK * G::SW;
          tma_load(sk + off, &tk, full + 8 * s, c * G::CW, j * BK, kvh, b);
          tma_load(sv + off, &tv, full + 8 * s, c * G::CW, j * BK, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    // thread (warp w, lane) of this warpgroup holds rows r and r + 8,
    // r = 16w + lane / 4, and of every 8 columns the two at 2 (lane % 4)
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int pos0 = q_off + row0;     // row0's key position
    const int col0 = (lane % 4) * 2;
    const uint32_t sq_wg = sq + wg * 64 * G::SW;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES, k0 = j * BK;
      // each operand's descriptor once per tile; the steps add constants
      // to its address field (no carry: shared addresses are < 2^18).
      // The empty asm keeps the compiler from hoisting a copy per step
      // out of the loop, which costs more registers than it saves
      uint64_t dq = mdesc(sq_wg, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dk = mdesc(sk + s * G::KV_BYTES, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dv = mdesc(sv + s * G::KV_BYTES, BK * G::SW, 8 * G::SW,
                          G::LAYOUT);
      asm volatile("" : "+l"(dq), "+l"(dk), "+l"(dv));
      mbar_wait(full + 8 * s, (j / STAGES) & 1);

      // S = Q K^T: hd / 16 steps of 16 columns, 32 bytes into a chunk
      float sc[BK / 2];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / G::CW, off = (kk * 16 % G::CW) * 2;
        wgmma_ss_n128(sc, dq + ((c * BQ * G::SW + off) >> 4),
                      dk + ((c * BK * G::SW + off) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask (only tiles that cross the diagonal or Sk), row max.
      // Row r keeps keys below lim = Sk, or min(Sk, q_off + r + 1) when
      // causal: score i's key is k0 + col0 + 8 (i / 4) + (i & 1)
      const bool edge =
          k0 + BK > Sk || (causal && k0 + BK - 1 > q_off + q0 + wg * 64);
      int thr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        thr[r] = (causal ? min(Sk, pos0 + 8 * r + 1) : Sk) - k0 - col0;
      float mn[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = __fmul_rn(sc[i], scale);
        if (edge && 8 * (i / 4) + (i & 1) >= thr[(i >> 1) & 1]) x = NEG_INF;
        sc[i] = x;
        mn[(i >> 1) & 1] = fmaxf(mn[(i >> 1) & 1], x);
      }
      // the running max, then l and acc rescaled to it before the new p
      // are made (so the factors die before the exps)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
        mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
        const float corr = expf(__fsub_rn(m[r], mn[r]));
        m[r] = mn[r];
        l[r] = __fmul_rn(l[r], corr);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[4 * i + 2 * r] = __fmul_rn(acc[4 * i + 2 * r], corr);
          acc[4 * i + 2 * r + 1] = __fmul_rn(acc[4 * i + 2 * r + 1], corr);
        }
      }

      // p = exp(s - m_new), summed unrounded into l, packed to bf16 as the
      // A fragment of P.V's k-step of 16 keys (V tile rows 16kk..16kk+15,
      // its column chunks LBO apart), which is issued at once: the tensor
      // cores run step kk while the next 16 keys' exps are made
      uint32_t pa[BK / 16][4];
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = expf(__fsub_rn(sc[8 * kk + e], m[(e >> 1) & 1]));
          l[(e >> 1) & 1] = __fadd_rn(l[(e >> 1) & 1], p[e]);
        }
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
        fence_regs(pa[kk]);
        wgmma_fence();      // the fragment's writes before the wgmma reads
        wgmma_rs_hd<HD>(acc, pa[kk], dv + ((kk * 16 * G::SW) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    }
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row * oss + col0);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        dst[4 * i] = pack_bf16(__fdiv_rn(acc[4 * i + 2 * r], den),
                               __fdiv_rn(acc[4 * i + 2 * r + 1], den));
      // the row's log-sum-exp for the backward (training only): the quad
      // shares m and l
      if (lse != nullptr && (lane & 3) == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] =
            __fadd_rn(m[r], logf(den));
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int K, int Sq, int Sk, int q_off, int causal,
           const long long* st, cudaStream_t stream) {
  using G = Geo<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(enc, &tq, q, Sq, H, B, st, BQ) ||
      !make_map<HD>(enc, &tk, k, Sk, K, B, st + 3, BK) ||
      !make_map<HD>(enc, &tv, v, Sk, K, B, st + 6, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in persists per function and device: set it once per device
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(flash_attention_kernel_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  // the TPU kernel's 1.0 / math.sqrt(hd), a double cut to f32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_attention_kernel_sm90<HD><<<grid, THREADS, G::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, K, Sq, Sk, q_off,
      causal, scale,
      st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o are bf16 (raw 16-bit words). Element strides of the first
// three dimensions: q's (qsb, qsh, qss), k's, v's and o's likewise; the
// fourth is unit-stride. hd is 16, 64 or 128. lse: null (serving), or a
// contiguous f32 (B, H, Sq) output of each row's m + log(max(l, 1e-30)).
// Query row i sits at key position q_off + i; q_off >= 0, q_off + Sq <= Sk.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int K, int Sq, int Sk, int q_off, int hd, int causal,
    long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K || q_off < 0 || q_off + Sq > Sk ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, K, Sq, Sk, q_off,
                                 causal, st, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, K, Sq, Sk, q_off,
                                 causal, st, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, K, Sq, Sk, q_off,
                                 causal, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
