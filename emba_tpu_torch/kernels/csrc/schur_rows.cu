// The Schur complement of the LEGM normal equations over the map rows that
// take part in it, for Hopper (sm_90a), and the back substitution of the
// map update over the same rows.
//
// It replaces no TPU kernel: the JAX package leaves the Schur products to
// XLA over every row of the row space (emba_tpu/model.py,
// solve_normal_eq). Only the rows whose damped 2x2 inverse M_r is nonzero
// contribute, 8-29% of the row space in the benchmark's windows, so the
// port lists them on the device (schur_rows.py, row_list) and these kernels
// read the list and its length from device memory: a CUDA graph captured
// once then does work that follows each replay's count, with no host read,
// no cap and no row dropped.
//
// What it computes, for the listed rows r (rows[0 .. *count)), with
// a = A12[r, 0:dp) and o = A12[r, dp:2dp), both zero outside the columns
// [col_lo, col_hi):
//   S_red   = sum_r a (m00 a + m01 o)^T + o (m01 a + m11 o)^T   (dp, dp)
//   rhs_red = sum_r (m00 b2x + m01 b2y) a + (m01 b2x + m11 b2y) o (dp,)
// and, for the back substitution with x the masked pose step,
//   x2[:, r] = M_r (b2[r] - [a . x, o . x]),  x2 = 0 on every other row.
//
// What bounds it on this card: the f32 FMA rate. S_red is a product of
// K = 2 n terms (a and o of each listed row); its upper triangle over the
// c live columns is 2 n c (c + 1) flops, 0.10 ms at 67 TFLOP/s for
// n = 42k, c = 288 (the whole product over dp = 320 padded columns,
// 4 n dp^2, would be 0.26 ms); the rows themselves are 2 dp * 4 bytes each
// (110 MB at that n, 0.03 ms). The back substitution reads the listed rows
// once: bound by bytes.
//
// What the design does about it:
//  * f32 FMA on the SIMT cores, no tensor cores: TF32 fails the
//    benchmark's step1_gap limit, and S feeds a Cholesky factor.
//  * S is symmetric: only the tiles ti <= tj of 64 x 64 are formed
//    (15 of 25 at dp = 320) and the reduction mirrors them.
//  * A block is one tile and one split of the row list: 64 threads, each
//    holding an 8 x 8 block of the tile in registers (its rows ty*4 + i and
//    32 + ty*4 + i, its columns likewise, so that the float4 reads of
//    shared memory are free of bank conflicts). A stage is 8 listed rows:
//    each thread loads one row's float4s of a and o for the tile's two
//    column ranges into registers (the next stage's, while the current one
//    is multiplied), applies the column mask and forms m00 a + m01 o and
//    m01 a + m11 o of the J side before it stores them: no masked copy of
//    A12 and no Z plane exist. 16 K terms a stage, 64 FMAs per 4 float4
//    reads of shared memory.
//  * The split of the rows follows the count read on the device: each of
//    the fixed number of splits (the grid, fixed when a graph captures it)
//    takes ceil(count / splits) rows, so every block does equal work
//    whatever the fill; a split past the count exits at once.
//  * Deterministic, no atomics: each block sums its rows in list order into
//    its own partial tile; a second kernel adds the splits' partials in
//    split order. The row list is ascending, so the same rows give the same
//    bits.
//  * The diagonal tiles also form rhs_red's partials of their 64 columns,
//    from the a and o already in shared memory.
//  * Back substitution: one warp a listed row, lanes over float4 columns,
//    a butterfly sum; a fixed grid strides over the count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // tile side, columns of S
constexpr int kQ = kT / 4;     // float4 of a tile row
constexpr int kRB = 8;         // listed rows a stage
constexpr int kK = 2 * kRB;    // K terms a stage: a and o of each row
constexpr int kThreads = 64;   // 8 x 8 threads of 8 x 8 entries
constexpr int kMaxSplits = 128;
constexpr int kSumThreads = 256;
constexpr int kBackThreads = 256;

// Rows a split takes: ceil(n / splits), rounded up to whole stages.
__device__ __forceinline__ int split_rows(int n, int splits) {
  const int c = (n + splits - 1) / splits;
  return (c + kRB - 1) / kRB * kRB;
}

// Tile t of the upper triangle, row by row over ti <= tj.
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// The bits of the four columns c0 .. c0 + 3 inside [lo, hi).
__device__ __forceinline__ unsigned col_bits(int c0, int lo, int hi) {
  unsigned b = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) b |= (c0 + e >= lo && c0 + e < hi) ? (1u << e) : 0u;
  return b;
}

__device__ __forceinline__ float4 keep(float4 v, unsigned b) {
  v.x = (b & 1u) ? v.x : 0.f;
  v.y = (b & 2u) ? v.y : 0.f;
  v.z = (b & 4u) ? v.z : 0.f;
  v.w = (b & 8u) ? v.w : 0.f;
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lin2(float p, float4 a, float q, float4 o) {
  return make_float4(p * a.x + q * o.x, p * a.y + q * o.y, p * a.z + q * o.z,
                     p * a.w + q * o.w);
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One thread's share of a stage: one listed row's float4s q and q + 8 of a
// and o in the I and J column ranges, and the row's M and b2.
struct Stage {
  float4 ai[2], oi[2], aj[2], oj[2];
  float m00, m01, m11, bx, by;
};

struct Args {
  const float* a12;
  const int32_t* rows;
  const float *m00, *m01, *m11, *b2x, *b2y;
  int dp;
};

__device__ __forceinline__ void load_stage(Stage& s, const Args& g, int idx, int end,
                                           int ci, int cj, bool diag, unsigned mi,
                                           unsigned mj, int q) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool ok = idx < end;
  const int r = ok ? g.rows[idx] : 0;
  const float* row = g.a12 + (size_t)r * (size_t)(2 * g.dp);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (q + 8 * h) * 4;
    const bool li = ok && ((mi >> (4 * h)) & 15u);
    s.ai[h] = li ? ld4(row + ci + c) : z;
    s.oi[h] = li ? ld4(row + g.dp + ci + c) : z;
    const bool lj = ok && !diag && ((mj >> (4 * h)) & 15u);
    s.aj[h] = lj ? ld4(row + cj + c) : z;
    s.oj[h] = lj ? ld4(row + g.dp + cj + c) : z;
  }
  s.m00 = ok ? __ldg(g.m00 + r) : 0.f;
  s.m01 = ok ? __ldg(g.m01 + r) : 0.f;
  s.m11 = ok ? __ldg(g.m11 + r) : 0.f;
  s.bx = ok ? __ldg(g.b2x + r) : 0.f;
  s.by = ok ? __ldg(g.b2y + r) : 0.f;
}

// Stores a stage: a and o of the I columns, m00 a + m01 o and m01 a + m11 o
// of the J columns (a diagonal tile's J columns are its I columns), each
// under the column mask, and M b2 of the row.
__device__ __forceinline__ void store_stage(const Stage& s, float4 (*xs)[kQ],
                                            float4 (*ys)[kQ], float2* ib, bool diag,
                                            unsigned mi, unsigned mj, int q, int rr) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 ai = keep(s.ai[h], mi >> (4 * h));
    const float4 oi = keep(s.oi[h], mi >> (4 * h));
    const float4 aj = diag ? ai : keep(s.aj[h], mj >> (4 * h));
    const float4 oj = diag ? oi : keep(s.oj[h], mj >> (4 * h));
    xs[2 * rr][q + 8 * h] = ai;
    xs[2 * rr + 1][q + 8 * h] = oi;
    ys[2 * rr][q + 8 * h] = lin2(s.m00, aj, s.m01, oj);
    ys[2 * rr + 1][q + 8 * h] = lin2(s.m01, aj, s.m11, oj);
  }
  if (q == 0) ib[rr] = make_float2(s.m00 * s.bx + s.m01 * s.by, s.m01 * s.bx + s.m11 * s.by);
}

__global__ void __launch_bounds__(kThreads)
schur_tiles_kernel(Args g, const int32_t* __restrict__ count, int nt, int col_lo,
                   int col_hi, float* __restrict__ part, float* __restrict__ rpart) {
  __shared__ __align__(16) float4 xs[2][kK][kQ];  // a, o of the I columns
  __shared__ __align__(16) float4 ys[2][kK][kQ];  // m00 a + m01 o, m01 a + m11 o of J
  __shared__ float2 ib[2][kRB];                    // M b2 of each row

  const int n = *count;
  const int chunk = split_rows(n, gridDim.y);
  const int begin = (int)blockIdx.y * chunk;
  if (begin >= n) return;  // the whole block: nothing listed for this split
  const int end = min(n, begin + chunk);
  int ti, tj;
  tile_of(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;  // compute: columns, rows of the tile
  const int q = tid & 7, rr = tid >> 3;   // load: float4 q, q + 8 of stage row rr
  const int ci = ti * kT, cj = tj * kT;
  const unsigned mi = col_bits(ci + 4 * q, col_lo, col_hi) |
                      (col_bits(ci + 4 * (q + 8), col_lo, col_hi) << 4);
  const unsigned mj = col_bits(cj + 4 * q, col_lo, col_hi) |
                      (col_bits(cj + 4 * (q + 8), col_lo, col_hi) << 4);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float racc = 0.f;

  Stage s;
  load_stage(s, g, begin + rr, end, ci, cj, diag, mi, mj, q);
  store_stage(s, xs[0], ys[0], ib[0], diag, mi, mj, q, rr);
  __syncthreads();
  int b = 0;
  for (int idx = begin; idx < end; idx += kRB) {
    const bool more = idx + kRB < end;
    if (more) load_stage(s, g, idx + kRB + rr, end, ci, cj, diag, mi, mj, q);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 x0 = xs[b][k][ty], x1 = xs[b][k][ty + 8];
      const float4 y0 = ys[b][k][tx], y1 = ys[b][k][tx + 8];
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    if (diag) {
      const float* xf = reinterpret_cast<const float*>(xs[b]);
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const float2 w = ib[b][k];
        racc = fmaf(w.x, xf[(2 * k) * kT + tid], racc);
        racc = fmaf(w.y, xf[(2 * k + 1) * kT + tid], racc);
      }
    }
    if (more) store_stage(s, xs[b ^ 1], ys[b ^ 1], ib[b ^ 1], diag, mi, mj, q, rr);
    __syncthreads();
    b ^= 1;
  }

  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (kT * kT);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 32) + ty * 4 + (i & 3);
    float4* o = reinterpret_cast<float4*>(out + row * kT);
    o[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[tx + 8] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (diag) rpart[(size_t)blockIdx.y * nt * kT + ci + tid] = racc;
}

// S (dp, dp) and rhs (dp,) from the partials of the splits that hold rows,
// added in split order; each upper-triangle entry is written to both of
// its places.
__global__ void __launch_bounds__(kSumThreads)
schur_sum_kernel(const float* __restrict__ part, const float* __restrict__ rpart,
                 const int32_t* __restrict__ count, int splits, int nt, int dp,
                 float* __restrict__ S, float* __restrict__ rhs) {
  const int n = *count;
  const int chunk = split_rows(n, splits);
  const int used = chunk > 0 ? (n + chunk - 1) / chunk : 0;
  const int ntri = nt * (nt + 1) / 2;
  const long long cells = (long long)ntri * kT * kT;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < cells) {
    const int t = (int)(e / (kT * kT)), w = (int)(e % (kT * kT));
    const int ii = w / kT, jj = w % kT;
    int ti, tj;
    tile_of(t, nt, ti, tj);
    const int gi = ti * kT + ii, gj = tj * kT + jj;
    if (gi >= dp || gj >= dp || (ti == tj && ii > jj)) return;
    float s = 0.f;
    for (int p = 0; p < used; ++p) s += part[((size_t)p * ntri + t) * (kT * kT) + w];
    S[(size_t)gi * dp + gj] = s;
    S[(size_t)gj * dp + gi] = s;
  } else if (e < cells + (long long)nt * kT) {
    const int c = (int)(e - cells);
    if (c >= dp) return;
    float s = 0.f;
    for (int p = 0; p < used; ++p) s += rpart[(size_t)p * nt * kT + c];
    rhs[c] = s;
  }
}

__global__ void __launch_bounds__(kBackThreads)
back_kernel(Args g, const int32_t* __restrict__ count, const float* __restrict__ x,
            long long R, float* __restrict__ x2) {
  const int n = *count;
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int q4 = g.dp / 4;
  const float4* xv = reinterpret_cast<const float4*>(x);
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < n;
       i += warps) {
    const int r = g.rows[i];
    const float4* a = reinterpret_cast<const float4*>(g.a12 + (size_t)r * (size_t)(2 * g.dp));
    const float4* o = a + q4;
    float sa = 0.f, so = 0.f;
    for (int c = lane; c < q4; c += 32) {
      const float4 u = __ldg(a + c), v = __ldg(o + c), w = __ldg(xv + c);
      sa = fmaf(u.x, w.x, sa);
      sa = fmaf(u.y, w.y, sa);
      sa = fmaf(u.z, w.z, sa);
      sa = fmaf(u.w, w.w, sa);
      so = fmaf(v.x, w.x, so);
      so = fmaf(v.y, w.y, so);
      so = fmaf(v.z, w.z, so);
      so = fmaf(v.w, w.w, so);
    }
    sa = warp_sum(sa);
    so = warp_sum(so);
    if (lane == 0) {
      const float vx = g.b2x[r] - sa, vy = g.b2y[r] - so;
      const float m00 = g.m00[r], m01 = g.m01[r], m11 = g.m11[r];
      x2[r] = m00 * vx + m01 * vy;
      x2[R + r] = m01 * vx + m11 * vy;
    }
  }
}

// Per device, asked once: (SMs, resident tile blocks an SM).
static cudaError_t device_shape(int* sms, int* per_sm) {
  constexpr int kDevices = 64;
  static int known[kDevices][2];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev][0] > 0) {
    *sms = known[dev][0];
    *per_sm = known[dev][1];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, schur_tiles_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (dev < kDevices) {
    known[dev][0] = *sms;
    known[dev][1] = *per_sm;
  }
  return cudaSuccess;
}

struct DeviceGuard {
  int prev = 0, dev = 0;
  cudaError_t err;
  explicit DeviceGuard(int device) : dev(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  cudaError_t done(cudaError_t e) {
    if (prev != dev) {
      const cudaError_t back = cudaSetDevice(prev);
      if (e == cudaSuccess) e = back;
    }
    return e;
  }
};

}  // namespace

extern "C" const char* emba_schur_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The splits of the row list for dp columns on the given device: as many as
// fill the card with tile blocks once, at least 1 and at most kMaxSplits.
extern "C" int emba_schur_splits(int device, int dp, int* splits) {
  if (dp < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int sms = 0, per_sm = 0;
  cudaError_t err = device_shape(&sms, &per_sm);
  if (err == cudaSuccess) {
    const int nt = (dp + kT - 1) / kT;
    const int ntri = nt * (nt + 1) / 2;
    int s = sms * per_sm / ntri;
    *splits = s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
  }
  return (int)guard.done(err);
}

// S_red (dp, dp) and rhs_red (dp,) over rows[0 .. *count). part: (splits,
// ntri, 64, 64) f32 scratch; rpart: (splits, nt * 64). Returns 0 or the
// cudaError_t of the first call that failed.
extern "C" int emba_schur_reduce(int device, const void* a12, const void* rows,
                                 const void* count, const void* m00, const void* m01,
                                 const void* m11, const void* b2x, const void* b2y, int dp,
                                 int col_lo, int col_hi, int splits, void* part, void* rpart,
                                 void* S, void* rhs, void* stream) {
  if (dp < 4 || dp % 4 || splits < 1 || splits > kMaxSplits || col_lo < 0 ||
      col_hi > dp)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = (cudaStream_t)stream;
  const Args g{(const float*)a12, (const int32_t*)rows, (const float*)m00,
               (const float*)m01, (const float*)m11, (const float*)b2x,
               (const float*)b2y, dp};
  const int nt = (dp + kT - 1) / kT;
  const int ntri = nt * (nt + 1) / 2;
  schur_tiles_kernel<<<dim3(ntri, splits), kThreads, 0, st>>>(
      g, (const int32_t*)count, nt, col_lo, col_hi, (float*)part, (float*)rpart);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    const long long cells = (long long)ntri * kT * kT + (long long)nt * kT;
    schur_sum_kernel<<<(unsigned)((cells + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                       st>>>((const float*)part, (const float*)rpart, (const int32_t*)count,
                             splits, nt, dp, (float*)S, (float*)rhs);
    err = cudaGetLastError();
  }
  return (int)guard.done(err);
}

// x2 (2, R): row r of rows[0 .. *count) gets M_r (b2[r] - [a . x, o . x]);
// the caller zeroes the other rows. Returns 0 or a cudaError_t.
extern "C" int emba_schur_back(int device, const void* a12, const void* rows,
                               const void* count, const void* m00, const void* m01,
                               const void* m11, const void* b2x, const void* b2y,
                               const void* x, int dp, long long R, void* x2, void* stream) {
  if (dp < 4 || dp % 4 || R < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int sms = 0, per_sm = 0;
  cudaError_t err = device_shape(&sms, &per_sm);
  if (err == cudaSuccess) {
    const Args g{(const float*)a12, (const int32_t*)rows, (const float*)m00,
                 (const float*)m01, (const float*)m11, (const float*)b2x,
                 (const float*)b2y, dp};
    back_kernel<<<sms * (2048 / kBackThreads), kBackThreads, 0, (cudaStream_t)stream>>>(
        g, (const int32_t*)count, (const float*)x, R, (float*)x2);
    err = cudaGetLastError();
  }
  return (int)guard.done(err);
}
