// Batched 5-point stencil kernels over halo-padded d-grids, for sm_90a.
//
// Replace the Pallas TPU kernels src/repro/kernels/stencil/jacobi.py:51
// (jacobi_sweep) and :78 (residual).  p is (G, n+2, n+2) f32 with a halo of
// one cell, f is (G, n, n) f32, the output is (G, n, n) f32.  One thread
// computes one output cell; consecutive threads take consecutive cells of a
// row, so the reads of p and f and the write of out are coalesced, and the
// four neighbours of a cell come from the same or adjacent rows already in
// L1/L2.  Bound on the H100: bytes, 4·(G·(n+2)² + 2·G·n²) at 3.35 TB/s; the
// 7 flops per cell are far below the compute roofline.
//
// The explicit __f*_rn intrinsics stop nvcc from contracting a*b+c into an
// FMA, so the results round exactly as the plain PyTorch version's separate
// operations do.
//
// C interface, loaded with ctypes: each function launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void jacobi_sweep_kernel(const float* __restrict__ p, const float* __restrict__ f,
                                    float* __restrict__ out, long long total, int n, float h2,
                                    float one_minus_omega, float omega) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nn = n * n;
  const int np2 = n + 2;
  const long long g = idx / nn;
  const int r = static_cast<int>(idx - g * nn);
  const int i = r / n;
  const int j = r - i * n;
  const float* c = p + g * np2 * np2 + (i + 1) * np2 + (j + 1);
  // 0.25·(up + down + left + right − h²·f), summed left to right as the reference does
  float s = __fadd_rn(__fadd_rn(__fadd_rn(c[-np2], c[np2]), c[-1]), c[1]);
  float nw = __fmul_rn(0.25f, __fsub_rn(s, __fmul_rn(h2, f[idx])));
  out[idx] = __fadd_rn(__fmul_rn(one_minus_omega, c[0]), __fmul_rn(omega, nw));
}

__global__ void residual_kernel(const float* __restrict__ p, const float* __restrict__ f,
                                float* __restrict__ out, long long total, int n, float inv_h2) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nn = n * n;
  const int np2 = n + 2;
  const long long g = idx / nn;
  const int r = static_cast<int>(idx - g * nn);
  const int i = r / n;
  const int j = r - i * n;
  const float* c = p + g * np2 * np2 + (i + 1) * np2 + (j + 1);
  // (up + down + left + right − 4·centre)·(1/h²), as the Pallas kernel computes it
  float s = __fadd_rn(__fadd_rn(__fadd_rn(c[-np2], c[np2]), c[-1]), c[1]);
  float lap = __fmul_rn(__fsub_rn(s, __fmul_rn(4.0f, c[0])), inv_h2);
  out[idx] = __fsub_rn(f[idx], lap);
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int jacobi_sweep_f32(const void* p, const void* f, void* out, long long G, int n,
                                float h2, float one_minus_omega, float omega, void* stream) {
  const long long total = G * n * n;
  if (total > 0) {
    jacobi_sweep_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(f), static_cast<float*>(out), total,
        n, h2, one_minus_omega, omega);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int residual_f32(const void* p, const void* f, void* out, long long G, int n,
                            float inv_h2, void* stream) {
  const long long total = G * n * n;
  if (total > 0) {
    residual_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(f), static_cast<float*>(out), total,
        n, inv_h2);
  }
  return static_cast<int>(cudaGetLastError());
}
