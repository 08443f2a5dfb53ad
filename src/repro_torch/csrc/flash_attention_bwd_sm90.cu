// Flash attention backward for LM training on Hopper's tensor cores, bf16
// at hd 16, 64 or 128, GQA, causal or not: from q (B, H, Sq, hd), k and v
// (B, K, Sk, hd) with H = K * rep, the forward's output o and its
// log-sum-exp lse (f32 (B, H, Sq)), and the output's gradient do -> dq,
// dk, dv in bf16. Every tensor but lse is read or written through element
// strides (the last dimension unit-stride, the others multiples of 16
// bytes), so training hands in its (B, S, H, hd) projections with no
// transpose copy. Query head h reads KV head h / rep. Any lengths: TMA
// zero-fills rows past Sq (q, do) and Sk (k, v), and the ragged tiles
// and the causal diagonal are masked in registers. The queries sit at key
// positions q_off .. q_off + Sq - 1 (q_off + Sq <= Sk): causal, query i
// sees key j iff j <= q_off + i, as in the forward's offset form; a whole
// sequence is q_off 0 with Sq = Sk. A context-parallel step hands each
// device its chunk of queries against the whole sequence's keys: a key
// tile past the chunk's last query steps over no query tile and stores
// zeros, so a key that no query of the chunk sees gets exactly zero dK
// and dV.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward. Its
// gradient for attention is repro/models/attention.py:359 (_flash_bwd,
// the custom VJP of sdpa_flash). The function is csrc/flash_attention_bwd.cu's
// (the CUDA-core route, which kernels/flash_attention.py:route keeps for
// f32 and other hd), rounding for rounding: scores are f32 products times
// the f32 1/sqrt(hd); w = bf16(expf(s * scale - lse)), 0 where masked;
// dp = do v^T in f32; delta = rowsum(do * o) in f32; ds = bf16(w * (dp -
// delta) * scale); dv = w^T do, dk = ds^T q and dq = ds k with f32
// accumulators, stored in bf16. The bf16 w and ds are exactly the A
// operands wgmma takes; nothing rounds anywhere else.
//
// Bound on the H100 at qwen3-14b's widths (H 40, K 8, hd 128, causal):
// B 4 x S 512 moves ~100 MB (30 us at 3.35 TB/s) against five products
// over the attended pairs (s, dp, dv, dk, dq: 2 hd operations each), ~27
// GFLOP (27 us at the 989 TFLOP/s bf16 rate). The CUDA-core route ran
// them on CUDA cores in f32 at 87x its bound. Here every product runs on
// the tensor cores (wgmma) fed by TMA:
//
//  * flash_attention_bwd_sm90_delta: delta = rowsum(do * o) in f32, one
//    warp a row, each lane hd / 32 contiguous elements (2 at hd 16) in
//    one load per tensor, the lanes summed by xor shuffles. It writes
//    (lse, delta) pairs into an f32 (B, H, Sp, 2) scratch the wrapper
//    allocates, Sp = Sq rounded up to PAD, zeros past Sq, so the kernels
//    below fetch a tile's pairs with one 16-byte-aligned bulk copy.
//  * flash_attention_bwd_sm90_dkdv: one thread block per (b, KV head,
//    head group, 128-key tile), key tile 0 (the most work when causal)
//    first. Two consumer warpgroups own 64 keys each and keep their dK and
//    dV (64 x hd f32) in registers; a producer warpgroup loads the K and V
//    tiles once, then streams the group's query heads' 64-query Q and do
//    tiles and their (lse, delta) pairs through a STAGES ring (full and
//    empty mbarriers), from the diagonal tile on when causal (the tile of
//    query k0 - q_off). Keys are the
//    rows: S^T = K Q^T and dP^T = V do^T are shared-by-shared m64n64k16
//    products, both K-major; w and ds are packed to bf16 in place (the f32
//    accumulator layout is the A-fragment layout, as the forward packs p);
//    dV += P^T do and dK += dS^T Q are register-by-shared m64n{hd}k16
//    products reading the same Q and do tiles MN-major (the transpose
//    bit). The GQA sum over the group's heads is this loop, in a fixed
//    order.
//  * flash_attention_bwd_sm90_dq: one thread block per (b, h, 128-query
//    tile), longest rows first when causal. Q and do are loaded once; K
//    and V stream through the ring in 128-key tiles up to the diagonal
//    (the key q_off + the tile's last row).
//    S = Q K^T and dP = do V^T come from shared memory (m64n128k16), and
//    dQ += dS K takes dS as the register A operand and K MN-major. It runs
//    on a second stream beside the dK/dV kernel (forked after delta,
//    joined before the call returns), so its blocks fill the SMs that the
//    short key tiles leave. (One launch of both roles did the same, but
//    ptxas spilled 68 bytes in it at hd 128 where neither role alone
//    spills.)
//  * flash_attention_bwd_sm90_sum, when a KV head's rep query heads are
//    split into head groups: kernels/flash_attention.py:bwd_plan_sm90
//    splits them where one causal key tile 0 over all rep heads would
//    outlast the launch's mean work an SM (B 1 x S 2,048: 2 groups;
//    hymba: 3). Each group's dK/dV block writes f32 partials; this kernel
//    adds them in group order and stores bf16.
//
// A rerun gives identical bits: no atomics; every dK, dV, dQ and partial
// element is written by exactly one block, and every sum runs in a fixed
// order. The price is that the dQ kernel recomputes S, dP, w and ds: 7
// products where 5 would do (at B 4 x S 512 ~38 GFLOP, ~38 us of
// tensor-core work), and every exponential twice. Per (key, query) pair
// w and ds come out of the same roundings in both kernels.
//
// Registers: each consumer thread holds dK and dV (hd / 2 + hd / 2 f32)
// and S^T and dP^T (32 + 32), w's and ds's bf16 fragments never live at
// once; or dQ, S and dP (64 each), S packed to bf16 before dP is read. So
// setmaxnreg gives the consumers 240 registers and the producer 24.
// Shared memory at hd 128: dK/dV K + V 64 KB, STAGES x (Q + do 32 KB +
// 512 bytes of pairs) = 130 KB; dQ Q + do 64 KB + STAGES x (K + V 64 KB)
// = 193 KB (mirrored by kernels/flash_attention.py:bwd_smem_bytes_sm90,
// checked against the 227 KB opt-in); one block per SM.
//
// build.py compiles with --fmad=false: every rounding is spelled with
// __fmul_rn / __fsub_rn; expf, never __expf. The bf16 packs of w and ds
// round to nearest even, once.
#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"   // mbarriers, TMA, descriptors, wgmma

namespace {

using namespace sm90;

constexpr int BKV = 128;              // keys per dK/dV block
constexpr int BQ = 64;                // queries per dK/dV ring step
constexpr int DQ_BQ = 128;            // queries per dQ block
constexpr int DQ_BK = 128;            // keys per dQ ring step
constexpr int STAGES = 2;             // both roles' rings
constexpr int PAD = 128;              // rows of the (lse, delta) scratch
constexpr int CONSUMERS = 256;        // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr int DELTA_THREADS = 256;
constexpr int MAX_DEVICES = 64;       // devices whose opt-in is remembered

static_assert(DQ_BK == BKV, "the two kernels share the K and V maps");
static_assert(PAD % BQ == 0 && PAD % DQ_BQ == 0, "a tile's pairs in Sp");

// the dK/dV kernel's shared memory: 1024 bytes to align the tiles to the
// swizzle's repeat, K, V, the Q ring, the do ring, the (lse, delta) ring
// and the barriers (kv_full, full[], empty[])
template <int HD>
struct KvGeo : Swz<HD> {
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int QT_BYTES = BQ * HD * 2;     // one Q or do tile
  static constexpr int LD_BYTES = BQ * 8;          // its (lse, delta) pairs
  static constexpr int LD_OFF = 2 * KV_BYTES + 2 * STAGES * QT_BYTES;
  static constexpr int BAR_OFF = LD_OFF + STAGES * LD_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// the dQ kernel's: alignment, Q, do, the K ring, the V ring, the barriers
// (q_full, full[], empty[])
template <int HD>
struct QGeo : Swz<HD> {
  static constexpr int Q_BYTES = DQ_BQ * HD * 2;
  static constexpr int KV_BYTES = DQ_BK * HD * 2;  // one K or V tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// element strides (batch, head, row) of one tensor
struct Strides {
  long long b, h, s;
};

// the two bf16 halves of a packed word, exactly
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void init_barriers(uint32_t first, uint32_t full,
                                              uint32_t empty) {
  if (threadIdx.x == 0) {
    mbar_init(first, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ld[(b, h, i)] = (lse[b, h, i], sum_d do[i, d] * o[i, d]) in f32 for
// i < Sq, (0, 0) for Sq <= i < Sp. One warp a row, rows in (b, i, h) order
// so that neighbouring warps read neighbouring heads of one position
template <int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_attention_bwd_sm90_delta(const uint16_t* __restrict__ o,
                               const uint16_t* __restrict__ dout,
                               const float* __restrict__ lse,
                               float2* __restrict__ ld, int H, int Sq, int Sp,
                               long long rows, Strides so, Strides sd) {
  constexpr int E = HD >= 64 ? HD / 32 : 2;        // elements a lane
  const long long row = static_cast<long long>(blockIdx.x)
                        * (DELTA_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(row % H);
  const long long bi = row / H;
  const int i = static_cast<int>(bi % Sp), b = static_cast<int>(bi / Sp);
  float acc = 0.0f;
  if (i < Sq && lane * E < HD) {
    const uint16_t* po = o + b * so.b + h * so.h + i * so.s + lane * E;
    const uint16_t* pd = dout + b * sd.b + h * sd.h + i * sd.s + lane * E;
    uint32_t wo[E / 2], wd[E / 2];
    if constexpr (E == 4) {
      const uint2 a = *reinterpret_cast<const uint2*>(po);
      const uint2 c = *reinterpret_cast<const uint2*>(pd);
      wo[0] = a.x; wo[1] = a.y; wd[0] = c.x; wd[1] = c.y;
    } else {
      wo[0] = *reinterpret_cast<const uint32_t*>(po);
      wd[0] = *reinterpret_cast<const uint32_t*>(pd);
    }
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      acc = __fmaf_rn(lo_bf16(wd[e]), lo_bf16(wo[e]), acc);
      acc = __fmaf_rn(hi_bf16(wd[e]), hi_bf16(wo[e]), acc);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  if (lane == 0) {
    const long long bh = static_cast<long long>(b) * H + h;
    ld[bh * Sp + i] = i < Sq ? make_float2(lse[bh * Sq + i], acc)
                             : make_float2(0.0f, 0.0f);
  }
}

// the arguments of both block roles: the maps of q and do (rows of the
// dK/dV role's and the dQ role's tiles), of k and v, the (lse, delta)
// pairs, the outputs and their element strides; Sq queries at key
// positions q_off on, Sk keys
struct Args {
  int B, H, K, Sq, Sk, q_off, Sp, causal, groups, n_kv;
  float scale;
  const float2* ld;
  __nv_bfloat16 *dq, *dk, *dv;
  Strides sdq, sdk, sdv;
  float* part;       // groups > 1: f32 (2, groups, B, K, Sk, hd) partials
};

struct Maps {
  CUtensorMap q64, do64, q128, do128, k, v;
};

// dK and dV of one (b, KV head, 128-key tile at k0) over the query heads
// of head group g (rep / groups of them, the first rep % groups groups
// one more); see the note at the top
template <int HD>
__device__ __forceinline__ void dkdv_block(uint8_t* smem_raw, const Maps& m,
                                           const Args& a, int b, int kvh,
                                           int k0, int g) {
  using G = KvGeo<HD>;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, q_off = a.q_off, Sp = a.Sp;
  const int causal = a.causal;
  const float scale = a.scale;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = sk + G::KV_BYTES;
  const uint32_t sq = sv + G::KV_BYTES;                 // + stage * QT_BYTES
  const uint32_t sdo = sq + STAGES * G::QT_BYTES;
  const uint32_t sld = base + G::LD_OFF;                // + stage * LD_BYTES
  const uint32_t kv_full = base + G::BAR_OFF;
  const uint32_t full = kv_full + 8;                    // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int rep = H / a.K;
  const int h0 = kvh * rep + g * (rep / a.groups) + min(g, rep % a.groups);
  const int heads = rep / a.groups + (g < rep % a.groups);
  // the diagonal tile (past the last one: no step, zeros stored)
  const int first = causal ? max(k0 - q_off, 0) / BQ : 0;
  const int nq = max((Sq + BQ - 1) / BQ - first, 0);    // query tiles a head
  const int steps = heads * nq;
  init_barriers(kv_full, full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: K and V once, then step j's Q and do tiles and pairs into
    // stage j % STAGES once every consumer thread has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * G::KV_BYTES);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        const uint32_t off = c * BKV * G::SW;
        tma_load(sk + off, &m.k, kv_full, c * G::CW, k0, kvh, b);
        tma_load(sv + off, &m.v, kv_full, c * G::CW, k0, kvh, b);
      }
      for (int j = 0; j < steps; ++j) {
        const int s = j % STAGES;
        const int h = h0 + j / nq, q0 = (first + j % nq) * BQ;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::QT_BYTES + G::LD_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
          const uint32_t off = s * G::QT_BYTES + c * BQ * G::SW;
          tma_load(sq + off, &m.q64, full + 8 * s, c * G::CW, q0, h, b);
          tma_load(sdo + off, &m.do64, full + 8 * s, c * G::CW, q0, h, b);
        }
        bulk_load(sld + s * G::LD_BYTES,
                  a.ld + (static_cast<long long>(b) * H + h) * Sp + q0,
                  G::LD_BYTES, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    // thread (warp w, lane) of this warpgroup holds keys r and r + 8,
    // r = key0 + 16w + lane / 4, and of every 8 queries the two at
    // 2 (lane % 4); score i is key r + 8 ((i >> 1) & 1), query
    // 8 (i / 4) + col0 + (i & 1) of the tile
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key0 = k0 + wg * 64;
    const int krow = key0 + (t / 32) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    const float4* lds = reinterpret_cast<const float4*>(
        smem_raw + (sld - raw));                        // + stage * BQ / 2
    float dK[HD / 2], dV[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dK[i] = dV[i] = 0.0f;
    // this warpgroup's 64 K and V rows, the A operands of S^T and dP^T
    const uint64_t dka = mdesc(sk + wg * 64 * G::SW, 16, 8 * G::SW,
                               G::LAYOUT);
    const uint64_t dva = mdesc(sv + wg * 64 * G::SW, 16, 8 * G::SW,
                               G::LAYOUT);

    mbar_wait(kv_full, 0);
    for (int j = 0; j < steps; ++j) {
      const int s = j % STAGES, q0 = (first + j % nq) * BQ;
      // Q and do of the stage: K-major B operands of S^T and dP^T, and
      // MN-major B operands of dK and dV (the empty asm keeps the
      // compiler from hoisting a copy per step out of the loop)
      uint64_t dqk = mdesc(sq + s * G::QT_BYTES, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dok = mdesc(sdo + s * G::QT_BYTES, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dqm = mdesc(sq + s * G::QT_BYTES, BQ * G::SW, 8 * G::SW,
                           G::LAYOUT);
      uint64_t dom = mdesc(sdo + s * G::QT_BYTES, BQ * G::SW, 8 * G::SW,
                           G::LAYOUT);
      asm volatile("" : "+l"(dqk), "+l"(dok), "+l"(dqm), "+l"(dom));
      mbar_wait(full + 8 * s, (j / STAGES) & 1);

      // a tile wholly above the diagonal for these keys adds nothing
      if (!(causal && key0 > q_off + q0 + BQ - 1)) {
        float st[BQ / 2], dpt[BQ / 2];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk * 16 / G::CW, off = (kk * 16 % G::CW) * 2;
          wgmma_ss_n64(st, dka + ((c * BKV * G::SW + off) >> 4),
                       dqk + ((c * BQ * G::SW + off) >> 4), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk * 16 / G::CW, off = (kk * 16 % G::CW) * 2;
          wgmma_ss_n64(dpt, dva + ((c * BKV * G::SW + off) >> 4),
                       dok + ((c * BQ * G::SW + off) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_one();                 // S^T is in; dP^T may run on
        fence_regs(st);

        // w = bf16(expf(s * scale - lse)), 0 where masked (only tiles that
        // cross the diagonal, Sq or Sk): key r keeps queries lo <= q < Sq,
        // lo = r - q_off when causal, and nothing when r >= Sk. Packed in
        // place (the pack is the one rounding) as the A fragments of dV +=
        // P^T do, whose k-steps of 16 queries are issued at once
        const float4* ldt = lds + s * (BQ / 2);
        const bool edge = (causal && key0 + 63 > q_off + q0)
                          || q0 + BQ > Sq || key0 + 64 > Sk;
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = krow + 8 * r;
          lo[r] = (causal ? key - q_off : 0) - q0 - col0;
          hi[r] = key < Sk ? Sq - q0 - col0 : lo[r];
        }
        uint32_t pw[BQ / 16][4];
#pragma unroll
        for (int g = 0; g < BQ / 8; ++g) {
          const float4 x = ldt[(8 * g + col0) / 2];   // (lse, delta) x 2
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e, r = e >> 1, at = 8 * g + (e & 1);
            const float w = expf(__fsub_rn(__fmul_rn(st[i], scale),
                                           (e & 1) ? x.z : x.x));
            st[i] = edge && (at < lo[r] || at >= hi[r]) ? 0.0f : w;
          }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          pw[kk][0] = pack_bf16(st[8 * kk], st[8 * kk + 1]);
          pw[kk][1] = pack_bf16(st[8 * kk + 2], st[8 * kk + 3]);
          pw[kk][2] = pack_bf16(st[8 * kk + 4], st[8 * kk + 5]);
          pw[kk][3] = pack_bf16(st[8 * kk + 6], st[8 * kk + 7]);
        }
        fence_regs(pw);
        fence_regs(dV);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_hd<HD>(dV, pw[kk], dom + ((kk * 16 * G::SW) >> 4));
        wgmma_commit();
        wgmma_wait_one();                 // dP^T is in; dV may run on
        fence_regs(dpt);

        // ds = bf16(w * (dp - delta) * scale), w read back from its packed
        // bf16 (exact), packed as the A fragments of dK += dS^T Q once dV
        // is in (so that w's fragments and ds's are never live together)
#pragma unroll
        for (int g = 0; g < BQ / 8; ++g) {
          const float4 x = ldt[(8 * g + col0) / 2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e;
            const uint32_t word = pw[g / 2][(g & 1) * 2 + (e >> 1)];
            const float w = (e & 1) ? hi_bf16(word) : lo_bf16(word);
            dpt[i] = __fmul_rn(__fmul_rn(w, __fsub_rn(dpt[i],
                                                      (e & 1) ? x.w : x.y)),
                               scale);
          }
        }
        wgmma_wait_all();
        fence_regs(dV);
        fence_regs(pw);
        uint32_t pd[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          pd[kk][0] = pack_bf16(dpt[8 * kk], dpt[8 * kk + 1]);
          pd[kk][1] = pack_bf16(dpt[8 * kk + 2], dpt[8 * kk + 3]);
          pd[kk][2] = pack_bf16(dpt[8 * kk + 4], dpt[8 * kk + 5]);
          pd[kk][3] = pack_bf16(dpt[8 * kk + 6], dpt[8 * kk + 7]);
        }
        fence_regs(pd);
        fence_regs(dK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_hd<HD>(dK, pd[kk], dqm + ((kk * 16 * G::SW) >> 4));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dK);
        fence_regs(pd);
      }
      mbar_arrive(empty + 8 * s);
    }

    if (a.groups > 1) {
      // this group's f32 partials; flash_attention_bwd_sm90_sum adds the
      // groups in order
      const long long plane = static_cast<long long>(a.B) * a.K * Sk * HD;
      float* pk = a.part + g * plane
                  + ((static_cast<long long>(b) * a.K + kvh) * Sk) * HD;
      float* pv = pk + a.groups * plane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = krow + 8 * r;
        if (row >= Sk) continue;
        float2* gk = reinterpret_cast<float2*>(pk + row * HD + col0);
        float2* gv = reinterpret_cast<float2*>(pv + row * HD + col0);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          gk[4 * i] = make_float2(dK[4 * i + 2 * r], dK[4 * i + 2 * r + 1]);
          gv[4 * i] = make_float2(dV[4 * i + 2 * r], dV[4 * i + 2 * r + 1]);
        }
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = krow + 8 * r;
      if (row >= Sk) continue;
      uint32_t* gk = reinterpret_cast<uint32_t*>(
          a.dk + b * a.sdk.b + kvh * a.sdk.h + row * a.sdk.s + col0);
      uint32_t* gv = reinterpret_cast<uint32_t*>(
          a.dv + b * a.sdv.b + kvh * a.sdv.h + row * a.sdv.s + col0);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        gk[4 * i] = pack_bf16(dK[4 * i + 2 * r], dK[4 * i + 2 * r + 1]);
        gv[4 * i] = pack_bf16(dV[4 * i + 2 * r], dV[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dQ of one (b, h, 128-query tile at q0); see the note at the top
template <int HD>
__device__ __forceinline__ void dq_block(uint8_t* smem_raw, const Maps& m,
                                         const Args& a, int b, int h,
                                         int q0) {
  using G = QGeo<HD>;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, q_off = a.q_off, Sp = a.Sp;
  const int causal = a.causal;
  const float scale = a.scale;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = sq + G::Q_BYTES;
  const uint32_t sk = sdo + G::Q_BYTES;                 // + stage * KV_BYTES
  const uint32_t sv = sk + STAGES * G::KV_BYTES;
  const uint32_t q_full = base + G::BAR_OFF;
  const uint32_t full = q_full + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int kvh = h / (H / a.K);
  int nk = (Sk + DQ_BK - 1) / DQ_BK;
  if (causal) nk = min(nk, (q_off + q0 + DQ_BQ - 1) / DQ_BK + 1);
  init_barriers(q_full, full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 2 * G::Q_BYTES);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        const uint32_t off = c * DQ_BQ * G::SW;
        tma_load(sq + off, &m.q128, q_full, c * G::CW, q0, h, b);
        tma_load(sdo + off, &m.do128, q_full, c * G::CW, q0, h, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
          const uint32_t off = s * G::KV_BYTES + c * DQ_BK * G::SW;
          tma_load(sk + off, &m.k, full + 8 * s, c * G::CW, j * DQ_BK, kvh,
                   b);
          tma_load(sv + off, &m.v, full + 8 * s, c * G::CW, j * DQ_BK, kvh,
                   b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    // rows r and r + 8, r = q0 + 64 wg + 16w + lane / 4; score i is key
    // k0 + 8 (i / 4) + col0 + (i & 1) of row r + 8 ((i >> 1) & 1)
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    float lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = a.ld[(static_cast<long long>(b) * H + h) * Sp
                          + row0 + 8 * r];       // row0 + 8 < Sp: PAD
      lse[r] = x.x;
      delta[r] = x.y;
    }
    float dQ[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dQ[i] = 0.0f;
    const uint64_t dqa = mdesc(sq + wg * 64 * G::SW, 16, 8 * G::SW,
                               G::LAYOUT);
    const uint64_t doa = mdesc(sdo + wg * 64 * G::SW, 16, 8 * G::SW,
                               G::LAYOUT);

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES, k0 = j * DQ_BK;
      uint64_t dkk = mdesc(sk + s * G::KV_BYTES, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dvk = mdesc(sv + s * G::KV_BYTES, 16, 8 * G::SW, G::LAYOUT);
      uint64_t dkm = mdesc(sk + s * G::KV_BYTES, DQ_BK * G::SW, 8 * G::SW,
                           G::LAYOUT);
      asm volatile("" : "+l"(dkk), "+l"(dvk), "+l"(dkm));
      mbar_wait(full + 8 * s, (j / STAGES) & 1);

      float sc[DQ_BK / 2], dp[DQ_BK / 2];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / G::CW, off = (kk * 16 % G::CW) * 2;
        wgmma_ss_n128(sc, dqa + ((c * DQ_BQ * G::SW + off) >> 4),
                      dkk + ((c * DQ_BK * G::SW + off) >> 4), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / G::CW, off = (kk * 16 % G::CW) * 2;
        wgmma_ss_n128(dp, doa + ((c * DQ_BQ * G::SW + off) >> 4),
                      dvk + ((c * DQ_BK * G::SW + off) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_one();                   // S is in; dP may run on
      fence_regs(sc);

      // w, masked on tiles that cross the diagonal or Sk: row r keeps
      // keys below min(Sk, q_off + r + 1) when causal, Sk otherwise
      const bool edge = k0 + DQ_BK > Sk
                        || (causal && k0 + DQ_BK - 1 > q_off + q0 + wg * 64);
      // (packed to bf16 at once: the f32 scores die before dP is read)
      int thr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        thr[r] = (causal ? min(Sk, q_off + row0 + 8 * r + 1) : Sk) - k0
                 - col0;
      uint32_t pw[DQ_BK / 4];
#pragma unroll
      for (int i = 0; i < DQ_BK / 2; i += 2) {
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ((i + e) >> 1) & 1;
          w[e] = expf(__fsub_rn(__fmul_rn(sc[i + e], scale), lse[r]));
          if (edge && 8 * (i / 4) + e >= thr[r]) w[e] = 0.0f;
        }
        pw[i / 2] = pack_bf16(w[0], w[1]);
      }
      wgmma_wait_all();
      fence_regs(dp);

      // ds, packed as the A fragment of dQ's k-step of 16 keys (K tile
      // rows 16kk..16kk+15, MN-major), issued at once
      uint32_t pd[DQ_BK / 16][4];
      fence_regs(dQ);
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          const uint32_t word = pw[i / 2];
          x[e] = __fmul_rn(__fmul_rn((e & 1) ? hi_bf16(word) : lo_bf16(word),
                                     __fsub_rn(dp[i], delta[(e >> 1) & 1])),
                           scale);
        }
        pd[kk][0] = pack_bf16(x[0], x[1]);
        pd[kk][1] = pack_bf16(x[2], x[3]);
        pd[kk][2] = pack_bf16(x[4], x[5]);
        pd[kk][3] = pack_bf16(x[6], x[7]);
        fence_regs(pd[kk]);
        wgmma_fence();
        wgmma_rs_hd<HD>(dQ, pd[kk], dkm + ((kk * 16 * G::SW) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dQ);
      fence_regs(pd);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      uint32_t* g = reinterpret_cast<uint32_t*>(
          a.dq + b * a.sdq.b + h * a.sdq.h + row * a.sdq.s + col0);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        g[4 * i] = pack_bf16(dQ[4 * i + 2 * r], dQ[4 * i + 2 * r + 1]);
    }
  }
}

// dk and dv (bf16, through their strides) = the sum over the head groups
// of the f32 partials, in group order. One thread 4 columns of a row
template <int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_attention_bwd_sm90_sum(const Args a) {
  const long long n = static_cast<long long>(a.B) * a.K * a.Sk * (HD / 4);
  const long long t = static_cast<long long>(blockIdx.x) * DELTA_THREADS
                      + threadIdx.x;
  if (t >= 2 * n) return;
  const int which = static_cast<int>(t / n);             // 0 dk, 1 dv
  const long long e = t % n;
  const int c = static_cast<int>(e % (HD / 4)) * 4;
  const long long row = e / (HD / 4);                     // (b, kvh, i)
  const int i = static_cast<int>(row % a.Sk);
  const int bk = static_cast<int>(row / a.Sk);
  const long long plane = n * 4;
  const float* src = a.part + which * a.groups * plane + row * HD + c;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < a.groups; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * plane);
    acc.x = __fadd_rn(acc.x, x.x);
    acc.y = __fadd_rn(acc.y, x.y);
    acc.z = __fadd_rn(acc.z, x.z);
    acc.w = __fadd_rn(acc.w, x.w);
  }
  const Strides& st = which ? a.sdv : a.sdk;
  __nv_bfloat16* dst = (which ? a.dv : a.dk) + (bk / a.K) * st.b
                       + (bk % a.K) * st.h + i * st.s + c;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// The dK/dV blocks, key tile by key tile (tile 0, the most work when
// causal, first), each (b, KV head) in `groups` head groups
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_sm90_dkdv(const __grid_constant__ Maps m,
                              const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int per_tile = a.B * a.K * a.groups, j = blockIdx.x % per_tile;
  const int bk = j / a.groups;
  dkdv_block<HD>(smem_raw, m, a, bk / a.K, bk % a.K,
                 blockIdx.x / per_tile * BKV, j % a.groups);
}

// The dQ blocks, query tile by query tile (longest rows first when
// causal)
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_sm90_dq(const __grid_constant__ Maps m,
                            const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int bh = blockIdx.x % (a.B * a.H);
  const int nqt = (a.Sq + DQ_BQ - 1) / DQ_BQ;
  dq_block<HD>(smem_raw, m, a, bh / a.H, bh % a.H,
               (nqt - 1 - static_cast<int>(blockIdx.x) / (a.B * a.H))
                   * DQ_BQ);
}

// the second stream of each device that the dQ kernel runs on beside the
// dK/dV kernel, and the events that fork it from and join it to the
// caller's stream
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

cudaError_t side_of_device(Side** out) {
  static Side sides[MAX_DEVICES];
  static bool made[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Side& side = sides[dev];
  if (!made[dev]) {
    e = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
    made[dev] = true;
  }
  *out = &side;
  return cudaSuccess;
}

// set a kernel's dynamic shared-memory opt-in once per device
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool (&opted)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  return cudaSuccess;
}

Strides strides_at(const long long* st, int tensor) {
  return Strides{st[3 * tensor], st[3 * tensor + 1], st[3 * tensor + 2]};
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* ld, float* part,
           void* dq, void* dk, void* dv, int B, int H, int K, int Sq,
           int Sk, int q_off, int causal, int groups, const long long* st,
           cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // q's and do's maps (Sq rows) with the dK/dV role's and the dQ role's
  // rows; k's and v's (Sk rows) (st: q 0, k 3, v 6, o 9, do 12, dq 15, dk
  // 18, dv 21)
  Maps m;
  if (!make_map<HD>(enc, &m.q64, q, Sq, H, B, st, BQ) ||
      !make_map<HD>(enc, &m.do64, dout, Sq, H, B, st + 12, BQ) ||
      !make_map<HD>(enc, &m.q128, q, Sq, H, B, st, DQ_BQ) ||
      !make_map<HD>(enc, &m.do128, dout, Sq, H, B, st + 12, DQ_BQ) ||
      !make_map<HD>(enc, &m.k, k, Sk, K, B, st + 3, BKV) ||
      !make_map<HD>(enc, &m.v, v, Sk, K, B, st + 6, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_kv[MAX_DEVICES] = {}, opted_q[MAX_DEVICES] = {};
  cudaError_t e = opt_in(flash_attention_bwd_sm90_dkdv<HD>, KvGeo<HD>::SMEM,
                         opted_kv);
  if (e == cudaSuccess)
    e = opt_in(flash_attention_bwd_sm90_dq<HD>, QGeo<HD>::SMEM, opted_q);
  Side* side = nullptr;
  if (e == cudaSuccess) e = side_of_device(&side);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.B = B;
  a.H = H;
  a.K = K;
  a.Sq = Sq;
  a.Sk = Sk;
  a.q_off = q_off;
  a.Sp = (Sq + PAD - 1) / PAD * PAD;
  a.causal = causal;
  a.groups = groups;
  a.n_kv = B * K * groups * ((Sk + BKV - 1) / BKV);
  a.part = part;
  // the forward's 1.0 / math.sqrt(hd), a double cut to f32
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  a.ld = reinterpret_cast<const float2*>(ld);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.sdq = strides_at(st, 5);
  a.sdk = strides_at(st, 6);
  a.sdv = strides_at(st, 7);
  const long long rows = static_cast<long long>(B) * a.Sp * H;
  flash_attention_bwd_sm90_delta<HD>
      <<<static_cast<unsigned>((rows + DELTA_THREADS / 32 - 1)
                               / (DELTA_THREADS / 32)),
         DELTA_THREADS, 0, stream>>>(
          static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
          lse, reinterpret_cast<float2*>(ld), H, Sq, a.Sp, rows,
          strides_at(st, 3), strides_at(st, 4));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the dQ kernel on the side stream once delta is in, beside the dK/dV
  // kernel (launched first, so its blocks are handed out first; the dQ
  // blocks fill the SMs its short key tiles leave); then the sum of the
  // head groups' partials; the caller's stream waits for both
  e = cudaEventRecord(side->fork, stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_sm90_dkdv<HD>
      <<<static_cast<unsigned>(a.n_kv), THREADS, KvGeo<HD>::SMEM, stream>>>(
          m, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_sm90_dq<HD>
      <<<static_cast<unsigned>(B * H * ((Sq + DQ_BQ - 1) / DQ_BQ)), THREADS,
         QGeo<HD>::SMEM, side->stream>>>(m, a);
  e = cudaGetLastError();
  if (e == cudaSuccess && groups > 1) {
    const long long n = 2LL * B * K * Sk * (HD / 4);
    flash_attention_bwd_sm90_sum<HD>
        <<<static_cast<unsigned>((n + DELTA_THREADS - 1) / DELTA_THREADS),
           DELTA_THREADS, 0, stream>>>(a);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = cudaEventRecord(side->join, side->stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(stream, side->join, 0);
  return static_cast<int>(e);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv are bf16 (raw 16-bit words); q, o, dout
// and dq hold Sq rows, k, v, dk and dv Sk rows, the queries at key
// positions q_off on (q_off + Sq <= Sk); lse (the forward's) is a
// contiguous f32 (B, H, Sq); ld is an f32 scratch of B * H * Sp * 2
// values, Sp = Sq rounded up to 128; part, where groups > 1, an f32
// scratch of 2 * groups * B * K * Sk * hd values. st: element strides
// (batch, head, row) of q, k, v, o, dout, dq, dk, dv in that order, 24
// values; the last dimension of each is unit-stride, and those of q, k,
// v and dout are multiples of 8 (TMA). hd is 16, 64 or 128.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* ld, float* part, void* dq,
    void* dk, void* dv, int B, int H, int K, int Sq, int Sk, int q_off,
    int hd, int causal, int groups, const long long* st, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K || groups < 1 || groups > H / K || q_off < 0
      || q_off + Sq > Sk || (groups > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, ld, part, dq, dk, dv, B, H, K,
                        Sq, Sk, q_off, causal, groups, st, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, ld, part, dq, dk, dv, B, H, K,
                        Sq, Sk, q_off, causal, groups, st, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, ld, part, dq, dk, dv, B, H,
                         K, Sq, Sk, q_off, causal, groups, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
