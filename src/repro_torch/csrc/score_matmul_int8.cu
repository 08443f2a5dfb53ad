// Dense int8 SVM scoring matmul of the fixed-point chain: (M, K) int8
// block codes @ (K, N) int8 weight codes -> (M, N) int32, exact.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:118
// (score_matmul_int8): an MXU int8 dot with int32 accumulation over M
// tiles, the whole (K, N) weight tile resident. In the detector K = 36
// (one block's codes) and N = 105 (window offsets); M is the scene's
// block count, 4524 / 2852 / 1813 at the three 640x480 pyramid levels.
// Codes lie in [-127, 127], so a sum of 36 products is at most
// 36 * 127^2 < 2^20: int32 accumulation is exact in any order.
//
// Design: each thread block stages the weight tile in shared memory,
// transposed so that column c's K codes are KW = ceil(K/4) packed int32
// words (9 for K = 36; zero bytes pad K to a multiple of 4), and a TM-row
// slab of the input packed the same way. Its threads walk the TM x N
// outputs in row-major order, so consecutive threads write consecutive
// int32 and read the weight words at an odd stride (KW = 9), free of
// bank conflicts. Each output is KW __dp4a steps (4 int8 products and
// their sum per instruction, into an int32).
//
// Bound on the H100: at M = 4524 the kernel reads 0.17 MB of codes and
// writes 1.9 MB of int32, 0.6 us at 3.35 TB/s; its 34 M int8 operations
// are 0.02 us at the 1,979 TOPS int8 tensor-core rate. Both are below a
// launch, so the kernel stays on the CUDA cores' dp4a; int8 tensor cores
// (mma.sync m16n8k32 s8, then wgmma) are later performance work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;                // input rows per thread block
constexpr int THREADS = 256;
constexpr int MAX_K = 64;             // the wrapper checks K <= 64
constexpr int MAX_N = 128;            // and N <= 128
constexpr int MAX_KW = MAX_K / 4;

// Four int8 codes of src[0], src[stride], ... as one word, byte t holding
// element t (little-endian, as __dp4a reads its operands); elements at
// or past n are zero.
__device__ __forceinline__ int pack4(const int8_t* src, int n, int stride) {
  unsigned w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (t < n)
      w |= static_cast<unsigned>(static_cast<uint8_t>(src[t * stride]))
           << (8 * t);
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(THREADS)
score_matmul_int8_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         int32_t* __restrict__ out, int M, int K, int N) {
  __shared__ int ws[MAX_N * MAX_KW];  // (N, KW): column c's packed codes
  __shared__ int xs[TM * MAX_KW];     // (TM, KW): row r's packed codes
  const int KW = (K + 3) / 4;
  const int m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0);
  for (int i = threadIdx.x; i < N * KW; i += THREADS) {
    const int c = i / KW, j = i % KW;
    ws[i] = pack4(w + 4 * j * N + c, K - 4 * j, N);
  }
  for (int i = threadIdx.x; i < rows * KW; i += THREADS) {
    const int r = i / KW, j = i % KW;
    xs[i] = pack4(x + static_cast<long long>(m0 + r) * K + 4 * j, K - 4 * j,
                  1);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < rows * N; o += THREADS) {
    const int r = o / N, c = o % N;
    const int* xr = xs + r * KW;
    const int* wc = ws + c * KW;
    int acc = 0;
    for (int j = 0; j < KW; ++j) acc = __dp4a(xr[j], wc[j], acc);
    out[static_cast<long long>(m0 + r) * N + c] = acc;
  }
}

}  // namespace

extern "C" int score_matmul_int8_launch(const int8_t* x, const int8_t* w,
                                        int32_t* out, int M, int K, int N,
                                        void* stream) {
  if (M <= 0) return 0;
  if (K > MAX_K || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((M + TM - 1) / TM);
  score_matmul_int8_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, w, out,
                                                                  M, K, N);
  return static_cast<int>(cudaGetLastError());
}
