// Gather-and-sum of indexed payload columns, for Hopper (sm_90a). Replaces
// the Pallas TPU kernel scripts/r5_dma_gather_probe.py::_dma_kernel
// (launched by dma_gather_sum), the probe of an in-kernel gather.
//
// What it computes: payload is (R, N) f32, row-major; idx is (n_chunks, MC)
// int32 column ids in [0, N).
//   out[r] = sum over chunks c, in chunk order, of sum_j payload[r, idx[c, j]]
//
// What bounds it on this card: the elements of one column lie N floats
// apart, so every gathered element is 4 useful bytes in a 32-byte sector of
// its own: eight times the useful bytes cross the memory bus. A chunk of
// MC = 256 columns at R = 16 reads 4,096 sectors (128 KB) for 16 KB of data,
// and N = 2M columns read 1.0 GB for 128 MB. With a random permutation
// nothing is reused from L2 (50 MB, against a 64-128 MB payload). The
// arithmetic is one add per element, so the kernel is bound by how many
// sector reads the card keeps in flight and by their latency.
//
// The reference's two disciplines, one block per chunk:
//  * serial: one column fetch in flight per block. Threads r < R each issue
//    the cp.async of row r of column j and wait for it, and the block meets
//    at a barrier before column j + 1 is issued: the latency of a dependent
//    gather. (The TPU grid ran one chunk at a time; here up to eight blocks
//    share an SM, so chunks of different blocks overlap.)
//  * batched: every thread issues the cp.async copies of its columns, all R
//    rows, the block commits them as one group, waits once, and reduces:
//    how many independent sector reads the card keeps in flight.
// The staged columns go to shared memory as (R, MC), so the reduction reads
// it without bank conflicts.
//
// Deterministic: each block writes its chunk's R partial sums, each in a
// fixed order (lane strides, then a butterfly over the warp, lane 0's
// value), into partial (R, n_chunks). A second kernel, one block per row,
// sums that row's partials in chunk order, as the reference adds each grid
// step into its output: the block stages tiles of partials in shared memory
// with all its threads, and one thread adds them one after the other. No
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void gather_chunks_kernel(const float* __restrict__ payload,
                                     const int32_t* __restrict__ idx,
                                     long long n, long long n_chunks,
                                     int rows, int mc, int serial,
                                     float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* vals = smem;  // (rows, mc)
  int32_t* cols = reinterpret_cast<int32_t*>(smem + (size_t)rows * mc);
  const int t = threadIdx.x;
  const long long chunk = blockIdx.x;
  const int32_t* cidx = idx + chunk * mc;
  for (int j = t; j < mc; j += blockDim.x) cols[j] = cidx[j];
  __syncthreads();

  if (serial) {
    for (int j = 0; j < mc; ++j) {
      const long long c = cols[j];
      for (int r = t; r < rows; r += blockDim.x)
        cp_async_f32(vals + (size_t)r * mc + j, payload + (size_t)r * n + c);
      cp_async_commit_and_wait();
      __syncthreads();
    }
  } else {
    for (int j = t; j < mc; j += blockDim.x) {
      const long long c = cols[j];
      for (int r = 0; r < rows; ++r)
        cp_async_f32(vals + (size_t)r * mc + j, payload + (size_t)r * n + c);
    }
    cp_async_commit_and_wait();
    __syncthreads();
  }

  const int warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const float* v = vals + (size_t)r * mc;
    float s = 0.f;
    for (int j = lane; j < mc; j += 32) s += v[j];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) partial[(size_t)r * n_chunks + chunk] = s;
  }
}

constexpr int kTile = 4096;  // partials staged at a time (16 KB)

__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  long long n_chunks, float* __restrict__ out) {
  __shared__ float tile[kTile];
  const float* p = partial + (size_t)blockIdx.x * n_chunks;
  float s = 0.f;
  for (long long base = 0; base < n_chunks; base += kTile) {
    const int cnt = (int)(n_chunks - base < kTile ? n_chunks - base : kTile);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) tile[i] = p[base + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < cnt; ++i) s += tile[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

extern "C" const char* emba_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// partial: (rows, n_chunks) f32 scratch; out: (rows,) f32. Returns 0, or
// the cudaError_t of the first launch that failed.
extern "C" int emba_gather_sum(const void* payload, const void* idx,
                               long long n, int rows, long long n_chunks,
                               int mc, int serial, void* partial, void* out,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || mc < 1 || n_chunks < 0 || n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const size_t smem = ((size_t)rows * mc + mc) * sizeof(float);
  if (smem > 49152) {
    err = cudaFuncSetAttribute(gather_chunks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_chunks > 0) {
    gather_chunks_kernel<<<(unsigned)n_chunks, kThreads, smem, st>>>(
        (const float*)payload, (const int32_t*)idx, n, n_chunks, rows, mc,
        serial, (float*)partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_chunks_kernel<<<rows, kThreads, 0, st>>>((const float*)partial, n_chunks,
                                              (float*)out);
  return (int)cudaGetLastError();
}
