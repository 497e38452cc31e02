// HMMU redirection-table row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hmmu_lookup.py::hmmu_lookup (its
// pallas_call at line 78), which gathered one packed table row per grid
// step through a scalar-prefetched index_map.
//
// out[b, i, :] = table[b, clamp(pages[b, i], 0, n_pages - 1), :]
//
// table int32[B, n_pages, 8], pages int32[B, m], out int32[B, m, 8]; a row
// is 32 bytes. One thread per (b, i) clamps its page and moves its row as
// two 16-byte loads and two 16-byte stores, so neighbouring threads touch
// neighbouring 32-byte output rows.
//
// What bounds it: the bytes. B * (m * 32 B read + m * 32 B written +
// m * 4 B of indices) against 3.35 TB/s is about 20 ns at B = 1,
// m = 514 (the chunk of 512 plus the DMA swap pair), far below the few
// microseconds of one launch: launch latency sets this kernel's time, and
// the design keeps it to one launch per chunk.
#include <cuda_runtime.h>

namespace {

constexpr int kRowW = 8;
constexpr int kThreads = 256;

__global__ void hmmu_lookup_kernel(const int4* __restrict__ table,
                                   const int* __restrict__ pages,
                                   int4* __restrict__ out,
                                   long long total, int n_pages, int m) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long b = t / m;
  int p = pages[t];
  p = p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
  const int4* src = table + ((b * n_pages + p) * (kRowW / 4));
  int4 lo = src[0];
  int4 hi = src[1];
  out[t * 2] = lo;
  out[t * 2 + 1] = hi;
}

}  // namespace

extern "C" int hmmu_lookup_launch(const void* table, const void* pages,
                                  void* out, int batch, int n_pages, int m,
                                  cudaStream_t stream) {
  long long total = (long long)batch * m;
  if (total <= 0 || n_pages <= 0) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  hmmu_lookup_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(table), static_cast<const int*>(pages),
      static_cast<int4*>(out), total, n_pages, m);
  return (int)cudaGetLastError();
}
