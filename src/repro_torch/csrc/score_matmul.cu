// Dense SVM scoring matmul: (M, K) block rows @ (K, N) per-offset
// weights -> (M, N) f32, f32 or bf16 inputs, f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:80 (score_matmul):
// an MXU dot over M tiles with the whole (K, N) weight tile resident.
// In the detector K = 36 (one block descriptor) and N = 105 (window
// offsets); M is the scene's block count, 4524 / 2852 / 1813 at the
// three 640x480 pyramid levels.
//
// Design: each thread block stages the whole (K, N) weight tile (15 KB
// in f32) and a TM-row slab of the input in shared memory, converted to
// f32, then its threads walk the TM x N outputs in row-major order, so
// consecutive threads write consecutive addresses. Each output is a
// K-step fmaf chain. Products of bf16 values are exact in f32, so the
// bf16 path differs from an f32 matmul of the upcast inputs only in the
// summation order.
//
// Bound on the H100: 2*M*K*N = 34 MFLOP at M = 4524, 0.5 us at the 67
// TFLOP/s f32 (CUDA-core) rate; the output (1.9 MB) takes 0.6 us at
// 3.35 TB/s. Both are below a launch, so CUDA cores suffice and the
// tensor cores are left for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;                // input rows per thread block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ out, int M, int K, int N) {
  extern __shared__ float smem[];
  float* ws = smem;                   // (K, N)
  float* xs = smem + K * N;           // (TM, K)
  const int m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0);
  for (int i = threadIdx.x; i < K * N; i += THREADS) ws[i] = to_f32(w[i]);
  for (int i = threadIdx.x; i < rows * K; i += THREADS)
    xs[i] = to_f32(x[static_cast<long long>(m0) * K + i]);
  __syncthreads();
  for (int o = threadIdx.x; o < rows * N; o += THREADS) {
    const int r = o / N, c = o % N;
    const float* xr = xs + r * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], ws[k * N + c], acc);
    out[static_cast<long long>(m0 + r) * N + c] = acc;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x and w share it). Shared memory is
// (K*N + TM*K) floats; the wrapper keeps it under the 48 KB static limit.
extern "C" int score_matmul_launch(const void* x, const void* w, float* out,
                                   int M, int K, int N, int dtype,
                                   void* stream) {
  if (M <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((M + TM - 1) / TM);
  const size_t smem = static_cast<size_t>(K * N + TM * K) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    score_matmul_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), out, M, K, N);
  else
    score_matmul_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), out, M,
        K, N);
  return static_cast<int>(cudaGetLastError());
}
