// Normal-equation accumulation for the LEGM bundle adjustment, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
// emba_tpu/kernels/a12_accum.py::_kernel (launched by a12_accumulate).
//
// What it computes, for each measurement k with weight w_k >= 0:
//   u_k = sqrt(w_k) * (Jc_k at columns 3*i_c.., Jp_k at columns 3*i_p..)
//   A12 row pm_pix_k += w_k * J_k * dx_k   (Gx plane, columns [0, dp_pad))
//                     += w_k * J_k * dy_k   (Gy plane, columns [dp_pad, ..))
//   px5 row pm_pix_k += (w dx^2, w dx dy, w dy^2, w e dx, w e dy)
//   A11 += u_k u_k^T,  b1 += sqrt(w_k) e_k u_k
//
// What bounds it on this card: writing the A12 rows (R_pad x 2*dp_pad f32,
// about 1.3 GB a forming pass at the 1024x512 panorama and 97 knots) and
// reading about N x (4 + 2D) f32 of measurement data (2M x 16 x 4 B, about
// 0.13 GB at order 2). Both are device-memory traffic; the arithmetic is a
// few multiply-adds per byte.
//
// Design. Every sum is taken in a fixed order, so repeated runs give the
// same bits (no float atomics anywhere):
//  * a12_rows_kernel: the wrapper sorts measurement ids by row (stable) and
//    gives per-row offsets. One warp owns one row: it walks the row's
//    measurements in sorted order and adds into a row buffer in shared
//    memory, then writes the whole row once. Rows without measurements are
//    written as zeros (or as the carry), so A12 needs no separate memset.
//  * a11_partial_kernel: A11 is (3K)^2 f32, too big for one block's shared
//    memory, and i_c, i_p of one measurement may be far apart. Each block
//    owns a fixed range of measurements and a private (3K+1) x 3K partial in
//    global scratch; thread (a, b) adds u_a u_b of one measurement into it,
//    one measurement at a time. Entries of the prev half that land on a
//    column of the curr half are folded into the curr entry first, so the
//    cells one measurement touches are distinct.
//  * a11_reduce_kernel: sums the partials in block order into a11b.
//
// Making it fast is later work: a segmented reduction over warps for rows
// with many measurements, rows staged out through TMA, and a blocked A11
// accumulation that keeps partial tiles in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void a12_rows_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ row_off,
    const int32_t* __restrict__ i_c, const int32_t* __restrict__ i_p,
    const float* __restrict__ Jc, const float* __restrict__ Jp,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ e, const float* __restrict__ wA,
    long long n, int d, int dp_pad, int r_pad, int accumulate,
    float* __restrict__ a12, float* __restrict__ px5) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= r_pad) return;  // warp-uniform; no block-level barrier below
  const int width = 2 * dp_pad;
  float* buf = smem + (size_t)warp * width;
  float* out = a12 + (size_t)row * width;
  for (int c = lane; c < width; c += 32) buf[c] = accumulate ? out[c] : 0.f;
  float p = (accumulate && lane < 8) ? px5[row * 8 + lane] : 0.f;
  __syncwarp();

  // lane -> (plane, component j) of the 2D Jacobian entries of one half
  const bool act = lane < 2 * d;
  const int plane = lane < d ? 0 : 1;
  const int j = lane - plane * d;
  const int beg = row_off[row], end = row_off[row + 1];
  for (int s = beg; s < end; ++s) {
    const int k = order[s];
    const float w = wA[k];
    if (w == 0.f) continue;  // same k on every lane: warp-uniform
    const float ddx = dx[k], ddy = dy[k];
    if (lane < 5) {
      const float we = w * e[k];
      const float v = lane == 0 ? w * ddx * ddx
                    : lane == 1 ? w * ddx * ddy
                    : lane == 2 ? w * ddy * ddy
                    : lane == 3 ? we * ddx
                                : we * ddy;
      p += v;
    }
    const float wg = w * (plane ? ddy : ddx);
    // curr half, then prev half: their columns may coincide
    if (act) buf[plane * dp_pad + 3 * i_c[k] + j] += wg * Jc[(size_t)j * n + k];
    __syncwarp();
    if (act) buf[plane * dp_pad + 3 * i_p[k] + j] += wg * Jp[(size_t)j * n + k];
    __syncwarp();
  }
  for (int c = lane; c < width; c += 32) out[c] = buf[c];
  if (lane < 8) px5[row * 8 + lane] = p;
}

__global__ void a11_partial_kernel(
    const int32_t* __restrict__ i_c, const int32_t* __restrict__ i_p,
    const float* __restrict__ Jc, const float* __restrict__ Jp,
    const float* __restrict__ e, const float* __restrict__ wA,
    long long n, int order, int dim, long long per_block,
    float* __restrict__ partial) {
  __shared__ int col[25];
  __shared__ float val[25];
  const int d = 3 * order;
  const int nd = 2 * d;
  const int t = threadIdx.x;  // blockDim.x == (nd + 1) * nd
  const int a = t / nd, b = t % nd;
  const size_t cells = (size_t)(dim + 1) * dim;
  float* part = partial + (size_t)blockIdx.x * cells;
  for (size_t c = t; c < cells; c += blockDim.x) part[c] = 0.f;
  __syncthreads();

  const long long beg = (long long)blockIdx.x * per_block;
  const long long end = beg + per_block < n ? beg + per_block : n;
  for (long long k = beg; k < end; ++k) {
    const float w = wA[k];
    if (w == 0.f) continue;  // block-uniform
    if (t < nd) {
      const int ic = i_c[k], ip = i_p[k];
      const float sw = sqrtf(w);
      if (t < d) {
        // curr entry s, plus the prev entry on the same column if any
        float v = Jc[(size_t)t * n + k];
        const int op = ic + t / 3 - ip;
        if (op >= 0 && op < order) v += Jp[(size_t)(3 * op + t % 3) * n + k];
        col[t] = 3 * ic + t;
        val[t] = sw * v;
      } else {
        const int s = t - d;
        const int knot = ip + s / 3;
        const bool folded = knot >= ic && knot < ic + order;
        col[t] = folded ? -1 : 3 * ip + s;
        val[t] = folded ? 0.f : sw * Jp[(size_t)s * n + k];
      }
    } else if (t == nd) {
      col[nd] = dim;  // the b1 row of the partial
      val[nd] = sqrtf(w) * e[k];
    }
    __syncthreads();
    const int ca = col[a], cb = col[b];
    if (ca >= 0 && cb >= 0) part[(size_t)ca * dim + cb] += val[a] * val[b];
    __syncthreads();
  }
}

__global__ void a11_reduce_kernel(const float* __restrict__ partial, int nblk,
                                  int dim, int dp_pad, int accumulate,
                                  float* __restrict__ a11b) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)(dp_pad + 8) * dp_pad;
  if (idx >= total) return;
  const int r = (int)(idx / dp_pad), c = (int)(idx % dp_pad);
  const int src = r < dim ? r : (r == dp_pad ? dim : -1);
  float s = accumulate ? a11b[idx] : 0.f;
  if (src >= 0 && c < dim) {
    const size_t cells = (size_t)(dim + 1) * dim;
    const float* p = partial + (size_t)src * dim + c;
    for (int blk = 0; blk < nblk; ++blk) s += p[(size_t)blk * cells];
  }
  a11b[idx] = s;
}

}  // namespace

extern "C" const char* emba_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int emba_a12_accumulate(
    const void* order, const void* row_off, const void* i_c, const void* i_p,
    const void* Jc, const void* Jp, const void* dx, const void* dy,
    const void* e, const void* wA, long long n, int spline_order,
    int dim_pose, int dp_pad, int r_pad, int accumulate, int nblk_a11,
    long long per_block, void* a12, void* px5, void* a11b, void* partial,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int d = 3 * spline_order;
  // col/val hold at most 2 * 12 + 1 entries: orders 2 to 4
  if (spline_order < 2 || spline_order > 4 || dp_pad < dim_pose || nblk_a11 < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  // rows: as many warps a block as fit 48 KB of row buffers, at least one
  const size_t row_bytes = (size_t)2 * dp_pad * sizeof(float);
  int warps = (int)(49152 / row_bytes);
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const size_t smem = row_bytes * warps;
  if (smem > 49152) {
    err = cudaFuncSetAttribute(a12_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (r_pad > 0) {
    const int grid = (r_pad + warps - 1) / warps;
    a12_rows_kernel<<<grid, warps * 32, smem, st>>>(
        (const int32_t*)order, (const int32_t*)row_off, (const int32_t*)i_c,
        (const int32_t*)i_p, (const float*)Jc, (const float*)Jp,
        (const float*)dx, (const float*)dy, (const float*)e, (const float*)wA,
        n, d, dp_pad, r_pad, accumulate, (float*)a12, (float*)px5);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  a11_partial_kernel<<<nblk_a11, (2 * d + 1) * 2 * d, 0, st>>>(
      (const int32_t*)i_c, (const int32_t*)i_p, (const float*)Jc,
      (const float*)Jp, (const float*)e, (const float*)wA, n, spline_order,
      dim_pose, per_block, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)(dp_pad + 8) * dp_pad;
  a11_reduce_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(
      (const float*)partial, nblk_a11, dim_pose, dp_pad, accumulate,
      (float*)a11b);
  return (int)cudaGetLastError();
}
