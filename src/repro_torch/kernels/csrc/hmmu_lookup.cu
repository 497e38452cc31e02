// HMMU redirection-table row gather for Hopper (sm_90a): kernel A.
//
// Replaces the TPU kernel repro/kernels/hmmu_lookup.py::hmmu_lookup (its
// pallas_call at line 78; hmmu_lookup_fused at line 87 goes through it),
// which gathered one packed table row per grid step through a
// scalar-prefetched index_map.
//
// Two entry points:
//
// hmmu_lookup_launch: out[b, i, :] = table[b, clamp(pages[b, i]), :]
//   table int32[B, n_pages, 8], pages int32[B, m], out int32[B, m, 8]. The
//   scan path's gather when the swap pair is not fused.
//
// hmmu_lookup_fused_launch: stage 2 of the scan-path chunk step for B
//   design points in ONE launch: every point's chunk rows AND its DMA swap
//   pair, rows[b, i, :] = table[b, clamp(pages[b, i]), :] and
//   swap[b, k, :] = table[b, clamp(max(page_k[b], 0)), :] for k in {a, b},
//   each point reading its own table at stride n_pages * 8. The raw DMA
//   registers (-1 when idle) are clamped here, so no clamp_min, stack or
//   cat launch runs before it. A chunk shared by every point comes in as
//   an expanded view: its point stride is 0.
//
// clamp(p) = min(max(p, 0), n_pages - 1), as the plain version
// (kernels/ref.py) and the JAX kernel clamp.
//
// What bounds it. A row is 32 bytes; the fused launch moves, for each
// point, m + 2 rows read, m + 2 rows written and m + 2 indices:
// (m + 2) * 68 B = 34,952 B at the chunk of 512. Over 3.35 TB/s that is
// 10.4 ns at B = 1, 167 ns at B = 16 and 668 ns at B = 64, all below the
// 1.57 us that one launch of the unfused gather took at B = 1 (device
// time, chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700.00 W). So the
// launch, not the bytes, sets this kernel's time at every B a sweep uses,
// and the design's gain is in launches: one launch a chunk for ALL points
// (the scan path used to launch once a chunk per point), and no launches
// around it.
//
// Why nothing more. Each row is read once and written once, with no reuse
// to stage: shared memory or TMA would add a copy and a barrier to a
// 32-byte move. There is no arithmetic for tensor cores. The rows are
// scattered across the table, so one 16-byte load and one 16-byte store
// per thread (two threads a row, neighbouring threads on neighbouring
// output addresses) is the whole kernel; the table reads go through the
// read-only path (__ldg).
#include <cuda_runtime.h>

namespace {

constexpr int kRowW = 8;     // int32 lanes of a packed row
constexpr int kHalves = 2;   // 16-byte halves of a row, one thread each
constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_page(int p, int n_pages) {
  return p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
}

__global__ void hmmu_lookup_kernel(const int4* __restrict__ table,
                                   const int* __restrict__ pages,
                                   int4* __restrict__ out,
                                   long long total, int n_pages, int m) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long b = t / m;
  int p = clamp_page(pages[t], n_pages);
  const int4* src = table + ((b * n_pages + p) * (kRowW / 4));
  int4 lo = src[0];
  int4 hi = src[1];
  out[t * 2] = lo;
  out[t * 2 + 1] = hi;
}

__global__ void hmmu_lookup_fused_kernel(
    const int4* __restrict__ table, const int* __restrict__ pages,
    const int* __restrict__ page_a, const int* __restrict__ page_b,
    int4* __restrict__ rows, int4* __restrict__ swap, long long total,
    int n_pages, int m, long long pages_stride, long long a_stride,
    long long b_stride) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int half = (int)(t % kHalves);
  const long long r = t / kHalves;   // row of the launch: point b, slot i
  const long long b = r / (m + 2);
  const int i = (int)(r - b * (m + 2));
  long long point = b;               // whose table the row is read from
  int p;
  int4* dst;
  if (i < m) {
    p = pages[b * pages_stride + i];
    dst = rows + (b * m + i) * kHalves;
  } else {
    p = i == m ? page_a[b * a_stride] : page_b[b * b_stride];
    dst = swap + (b * 2 + (i - m)) * kHalves;
  }
  p = clamp_page(p, n_pages);
  dst[half] = __ldg(table + (point * n_pages + p) * kHalves + half);
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

// Strides are in int32 elements: pages_stride between points' chunks (0
// for a chunk shared by every point; the chunk itself is contiguous),
// a_stride and b_stride between points' DMA registers.
extern "C" int hmmu_lookup_fused_launch(
    const void* table, const void* pages, const void* page_a,
    const void* page_b, void* rows, void* swap, int batch, int n_pages,
    int m, long long pages_stride, long long a_stride, long long b_stride,
    cudaStream_t stream) {
  long long total = (long long)batch * (m + 2) * kHalves;
  if (batch <= 0 || m < 0 || n_pages <= 0) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  hmmu_lookup_fused_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(table), static_cast<const int*>(pages),
      static_cast<const int*>(page_a), static_cast<const int*>(page_b),
      static_cast<int4*>(rows), static_cast<int4*>(swap), total, n_pages, m,
      pages_stride, a_stride, b_stride);
  return (int)cudaGetLastError();
}
