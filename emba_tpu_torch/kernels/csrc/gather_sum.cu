// Gather-and-sum of indexed payload columns, for Hopper (sm_90a). Replaces
// the Pallas TPU kernel scripts/r5_dma_gather_probe.py::_dma_kernel
// (launched by dma_gather_sum), the probe of an in-kernel gather.
//
// What it computes: payload is (R, N) f32, row-major; idx is (n_chunks, MC)
// int32 column ids in [0, N).
//   out[r] = sum over chunks c of sum_j payload[r, idx[c, j]]
//
// What bounds it on this card:
//  * sectors: the elements of one column lie N floats apart, so every
//    gathered element is 4 useful bytes of a 32-byte sector. N = 2M columns
//    at R = 16 touch 1.0 GB of sectors for 128 MB of payload; from device
//    memory at 3.35 TB/s that alone is 0.31 ms. But a sector holds 8
//    neighbouring columns of its row, and all 8 are gathered sooner or
//    later: if the sector stays in L2 between its 8 reads, device memory
//    moves each payload byte about once (0.04 ms).
//  * L2 hit throughput and L1 requests: each warp load of 32 random ids is
//    32 sectors of 32 different lines, one L1 wavefront and one L2 request
//    each. Served from L2, the gather is bound by how many sector requests
//    a second the L1s and the L2 slices pass.
//  * loads in flight: one add an element, so the rest is latency, hidden
//    only by many independent loads.
//
// What the batched discipline does about each (the row sweep):
//  * the R rows are swept in passes of P rows (rows_per_pass), pass-major:
//    a pass's payload, P * N * 4 bytes, is sized by the wrapper to a share
//    of the card's L2 (gather_sum.py, L2_SHARE), so that the 8 reads of a
//    sector find it in L2 and device memory moves each sector about once;
//  * the grid is persistent (the SMs times the blocks that fit on one) and
//    its warps walk the work items (pass p, chunk c) in pass-major order,
//    with a stride of the grid: the card finishes pass p before it goes
//    deep into pass p + 1, and there is no tail of waves;
//  * one warp an item: each lane reads its ids idx[c, lane + 32 k] once,
//    coalesced and marked evict-first (they are read once a pass), keeps
//    them in registers for all P rows, and issues its 8 payload loads of a
//    row (ld.global.nc) before its first add. No shared memory, no
//    cp.async, no barrier. The launch bounds hold a thread to 32 registers,
//    so that 64 warps fit an SM (at 48 registers, 40 fit).
// Measured on an H100 (PERF.md, the probe's sweep at R = 16): the
// rule P = (L2 / 4) / (4 N) rows a pass, one row at N = 2M, was the
// fastest, but every P from 1 to 16 came within a few percent of it. The
// L2 blocking buys little because device memory is not what bounds the
// gather: the rate of sector requests is, and torch's own gather kernel
// (index_select) runs at about the same rate. Loads that skip L1
// (ld.global.nc.L1::no_allocate) were a little slower than ld.global.nc.
//
// The serial discipline keeps the reference's meaning, one column fetch in
// flight per block: one block a chunk, thread r holds row r, and for each
// column j every thread loads its row's element, adds it, and the block
// meets at a barrier before column j + 1: the latency of a dependent
// gather. (Up to eight blocks share an SM, so chunks of different blocks
// overlap.)
//
// Deterministic, no atomics: each (row, chunk) gets one partial[r, c] in a
// fixed order. Batched: a lane adds its columns j = lane + 32 k in k order,
// then the warp adds its lanes by a butterfly; that order depends on
// neither P nor the grid. Serial: thread r adds the chunk's columns in
// order. A second kernel, one block a row, sums the row's partials in a
// fixed tree (thread strides, a butterfly, the warps in order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;              // ids a lane holds, loads it keeps in flight
constexpr int kGroup = 32 * kPer;    // columns a warp covers at once

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The lane's ids of columns base + lane + 32 k, k < kPer; those at or past
// mc are not read.
__device__ __forceinline__ void load_ids(const int32_t* cidx, int base, int mc,
                                         int lane, int (&ids)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = base + lane + 32 * k;
    ids[k] = j < mc ? __ldcs(cidx + j) : 0;
  }
}

// s plus the lane's elements of one row, in k order: all kPer loads are
// issued before the first add.
__device__ __forceinline__ float lane_sum(const float* row, const int (&ids)[kPer],
                                          int base, int mc, int lane, float s) {
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = base + lane + 32 * k < mc ? __ldg(row + ids[k]) : 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (base + lane + 32 * k < mc) s += v[k];
  return s;
}

__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
gather_sweep_kernel(const float* __restrict__ payload, const int32_t* __restrict__ idx,
                    long long n, long long n_chunks, int rows, int mc,
                    int rows_per_pass, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long passes = (rows + rows_per_pass - 1) / rows_per_pass;
  const long long items = passes * n_chunks;
  for (long long item = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       item < items; item += warps) {
    const long long p = item / n_chunks;
    const long long c = item - p * n_chunks;
    const int r0 = (int)(p * rows_per_pass);
    const int r1 = min(rows, r0 + rows_per_pass);
    const int32_t* cidx = idx + c * mc;
    float* out = partial + c;
    if (mc <= kGroup) {
      int ids[kPer];
      load_ids(cidx, 0, mc, lane, ids);
      for (int r = r0; r < r1; ++r) {
        const float s = warp_sum(lane_sum(payload + (size_t)r * n, ids, 0, mc, lane, 0.f));
        if (lane == 0) out[(size_t)r * n_chunks] = s;
      }
    } else {
      for (int r = r0; r < r1; ++r) {
        float s = 0.f;
        for (int base = 0; base < mc; base += kGroup) {
          int ids[kPer];
          load_ids(cidx, base, mc, lane, ids);
          s = lane_sum(payload + (size_t)r * n, ids, base, mc, lane, s);
        }
        s = warp_sum(s);
        if (lane == 0) out[(size_t)r * n_chunks] = s;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_serial_kernel(const float* __restrict__ payload, const int32_t* __restrict__ idx,
                     long long n, long long n_chunks, int rows, int mc,
                     float* __restrict__ partial) {
  __shared__ int32_t cols[kThreads];
  const long long c = blockIdx.x;
  const int32_t* cidx = idx + c * mc;
  for (int r0 = 0; r0 < rows; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const float* row = payload + (size_t)(r < rows ? r : 0) * n;
    float s = 0.f;
    for (int base = 0; base < mc; base += kThreads) {
      const int cnt = min(kThreads, mc - base);
      __syncthreads();
      if ((int)threadIdx.x < cnt) cols[threadIdx.x] = cidx[base + threadIdx.x];
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        if (r < rows) s += __ldg(row + cols[j]);
        __syncthreads();
      }
    }
    if (r < rows) partial[(size_t)r * n_chunks + c] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
sum_chunks_kernel(const float* __restrict__ partial, long long n_chunks,
                  float* __restrict__ out) {
  __shared__ float warp_sums[kThreads / 32];
  const float* p = partial + (size_t)blockIdx.x * n_chunks;
  float s = 0.f;
  for (long long i = threadIdx.x; i < n_chunks; i += kThreads) s += p[i];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
    out[blockIdx.x] = t;
  }
}

}  // namespace

extern "C" const char* emba_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of the batched launch when the caller gives none: as many as are
// resident on the current device at once (asked once a device), and no
// more than the items need.
static cudaError_t sweep_blocks(long long items, int* blocks) {
  constexpr int kDevices = 64;
  static int resident[kDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < kDevices ? resident[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_sweep_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) resident[dev] = full;
  }
  const long long need = (items + kThreads / 32 - 1) / (kThreads / 32);
  *blocks = (int)(need < full ? need : full);
  return cudaSuccess;
}

// partial: (rows, n_chunks) f32 scratch; out: (rows,) f32. rows_per_pass
// (batched only) is P; blocks, if > 0, sets the batched grid. Launches on
// the given device (made current for the launches, then restored). Returns
// 0, or the cudaError_t of the first call that failed.
extern "C" int emba_gather_sum(int device, const void* payload, const void* idx,
                               long long n, int rows, long long n_chunks, int mc,
                               int serial, int rows_per_pass, int blocks, void* partial,
                               void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || mc < 1 || rows_per_pass < 1 || blocks < 0 || n_chunks < 0 ||
      n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks > 0) {
    if (serial) {
      gather_serial_kernel<<<(unsigned)n_chunks, kThreads, 0, st>>>(
          (const float*)payload, (const int32_t*)idx, n, n_chunks, rows, mc,
          (float*)partial);
    } else {
      const long long passes = (rows + rows_per_pass - 1) / rows_per_pass;
      if (blocks == 0) err = sweep_blocks(passes * n_chunks, &blocks);
      if (err == cudaSuccess)
        gather_sweep_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
            (const float*)payload, (const int32_t*)idx, n, n_chunks, rows, mc,
            rows_per_pass, (float*)partial);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    sum_chunks_kernel<<<rows, kThreads, 0, st>>>((const float*)partial, n_chunks,
                                                (float*)out);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
