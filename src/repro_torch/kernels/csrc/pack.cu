// d-grid → linear write-buffer pack (paper §3.2), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack/linear.py:32
// (pack_grids).  p is (G, n+2, n+2), the output (G, n·n): each d-grid's
// interior without its halo, as one contiguous row.  Pure data movement, so
// it is templated on the element size only (1, 2, 4 or 8 bytes) and copies
// bits, which makes it exact for every dtype.  One thread moves one element;
// consecutive threads write consecutive addresses of the output and read
// runs of n consecutive addresses of the input.  Bound on the H100: bytes,
// G·((n+2)² + n²)·itemsize at 3.35 TB/s.
//
// C interface, loaded with ctypes: launches on the given stream and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for an element
// size it does not take).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void pack_grids_kernel(const T* __restrict__ p, T* __restrict__ out, long long total,
                                  int n) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nn = n * n;
  const int np2 = n + 2;
  const long long g = idx / nn;
  const int r = static_cast<int>(idx - g * nn);
  const int i = r / n;
  const int j = r - i * n;
  out[idx] = p[g * np2 * np2 + (i + 1) * np2 + (j + 1)];
}

template <typename T>
void launch(const void* p, void* out, long long total, int n, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  pack_grids_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(p),
                                                        static_cast<T*>(out), total, n);
}

}  // namespace

extern "C" int pack_grids(const void* p, void* out, long long G, int n, int elem_size,
                          void* stream) {
  const long long total = G * n * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    switch (elem_size) {
      case 1: launch<uint8_t>(p, out, total, n, s); break;
      case 2: launch<uint16_t>(p, out, total, n, s); break;
      case 4: launch<uint32_t>(p, out, total, n, s); break;
      case 8: launch<uint64_t>(p, out, total, n, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
