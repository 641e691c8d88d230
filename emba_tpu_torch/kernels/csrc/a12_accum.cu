// Normal-equation accumulation for the LEGM bundle adjustment, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
// emba_tpu/kernels/a12_accum.py::_kernel (launched by a12_accumulate, with
// its XLA prepass _bucket_prepass).
//
// What it computes, for each measurement k with weight w_k > 0:
//   u_k = (Jc_k at columns 3*i_c.., Jp_k at columns 3*i_p..)
//   A12 row pm_pix_k += w_k * u_k * dx_k   (Gx plane, columns [0, dp_pad))
//                     += w_k * u_k * dy_k   (Gy plane, columns [dp_pad, ..))
//   px5 row pm_pix_k += (w dx^2, w dx dy, w dy^2, w e dx, w e dy)
//   A11 += w_k u_k u_k^T,  b1 += w_k e_k u_k
// A measurement with w <= 0, a row outside [0, R_pad) or knots outside
// [0, dim_pose) adds nothing (the wrapper's contract gives such rows zero
// weight; the knot test keeps every store inside its buffer).
//
// The bound on this card is memory. At the main shapes (N = 2M, R_pad =
// 524,288, dp_pad = 320, order 2) the call must write A12 (1,342,177,280
// B), px5 (16,777,216 B) and A11/b1 (419,840 B) and read 19 words per
// measurement (3 int32 + 12 Jc/Jp + 4 f32: 152,000,000 B): 1.511 GB, 0.451
// ms at 3.35 TB/s. The arithmetic is a few hundred FLOP per measurement.
//
// What held the first version back (3.9 ms a call on an H100 SXM), and what
// the kernels here do about it:
//  * It read each measurement through the row permutation from the (D, N)
//    planes, one 32-byte sector per lane, about 19 sectors a measurement.
//    Now keys_kernel makes a row key and a knot-pair key (i_c * K + i_p);
//    the wrapper sorts both stably and inverts the pair order; pack_kernel
//    reads every measurement once, coalesced, and writes one record of
//    whole 32-byte sectors at its place in pair order (nearly sequential in
//    a real window, where events come in time order). A chunk of a pair run
//    is then one contiguous run of records; a row reaches its records
//    through slot[s] = pos[row_ids[s]], three sectors a measurement.
//  * A prev entry on a curr column is folded into it in the record, before
//    any product, as u_k is formed: Jc and Jp of a shared knot nearly
//    cancel in a real window, and squaring them apart lost A11 to 1.2e-5
//    of its largest entry. The folded record serves A12, px5 and A11.
//  * One warp walked a row with two __syncwarp a measurement, staged every
//    row (empty ones too) through shared memory and stored it with 4-byte
//    stores. Now (walk_records) a lane reads one word of each record, four
//    records in flight, and the lanes take what they need by shuffles; the
//    columns of one measurement are distinct after the fold, so one
//    __syncwarp a measurement is enough. rows_kernel writes an empty row as
//    float4 zeros without staging it, leaves it untouched under carry, and
//    stores every row with float4.
//  * A row of more than HEAVY_ROW measurements was one warp's serial walk.
//    Now the wrapper cuts it into chunks of HEAVY_ROW; heavy_kernel reduces
//    each chunk with its own warp into a partial row, and rows_kernel adds
//    the partials in chunk order.
//  * A11 came from 1,024 blocks, each walking ~2,000 measurements with two
//    __syncthreads and a read-modify-write of ~144 cells in global memory a
//    step, into 348 MB of private partials. Now A11/b1 is a keyed reduction:
//    the pair runs are cut into chunks of PAIR_CHUNK; a11_chunk_kernel gives
//    a chunk to a warp whose lanes hold the upper triangle of v v^T (v =
//    sqrt(w) u_k and sqrt(w) e, 91 cells at order 2) in registers: no shared
//    memory, no barrier. a11_keysum_kernel adds each key's chunks into its
//    first chunk; a11_marginal_kernel adds, per knot, the curr-curr block of
//    the keys (ic, *) and the prev-prev block of the keys (*, ip); and
//    a11_assemble_kernel builds each A11/b1 cell from those and the cross
//    blocks of the (at most order^2) keys that reach it. Scratch follows N
//    and K only.
//
// Determinism: no float atomics. Every sum is taken in a fixed order: a
// row's records in stable row order (then its heavy partials in chunk
// order), a chunk's records in stable pair order, a key's chunks by warp
// (chunk index mod 8) and then warp by warp pairwise, a knot's keys in key
// order, an A11 cell's terms in a fixed order of knots. A11[r][c] and
// A11[c][r] are the same sum. So repeated runs give the same bits.
//
// Launches never synchronize and allocate nothing; the wrapper's index maps
// (sort, searchsorted, cumsum, scatter_, gather) take no size from the
// host, so the whole call can be captured in a CUDA graph. The scratch
// layout (Shape below) is defined here only: the wrapper sizes its buffers
// from emba_a12_sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// A measurement's record: i_c, i_p (int bits), sqrt(w) dx, sqrt(w) dy,
// sqrt(w) e, then v = sqrt(w) u_k: the D curr entries (each with the prev
// entry on its column folded in) and the D prev entries (0 where folded).
// Records are whole 32-byte sectors, so that no two records share a sector
// and the pack kernel's scattered stores never write part of one.
constexpr int RECORD_HEAD = 5;
constexpr int W_DX = 2, W_DY = 3, W_E = 4;

template <int O>
struct Shape {
  static constexpr int D = 3 * O;
  static constexpr int RW = (RECORD_HEAD + 2 * D + 7) / 8 * 8;  // record words
  static constexpr int P = 2 * D + 1;  // the A11 vector: v, then sqrt(w) e
  static constexpr int NC = P * (P + 1) / 2;                   // cells of v v^T
  static constexpr int NCL = (NC + 31) / 32;                   // cells a lane
  static constexpr int NCP = NCL * 32;                         // padded cells
  static constexpr int ROLES = 4 * D + 5;                      // row roles
  static constexpr int NR = (ROLES + 31) / 32;                 // roles a lane
};

// Record word of entry i of the A11 vector (v, then sqrt(w) e).
template <int O>
__device__ __forceinline__ int vector_word(int i) {
  return i < 2 * Shape<O>::D ? RECORD_HEAD + i : W_E;
}

__device__ __forceinline__ int cell_index(int a, int b, int p) {
  // (a <= b) -> packed upper triangle of a p x p matrix, row-major
  return a * p - a * (a - 1) / 2 + (b - a);
}

__global__ void keys_kernel(const int32_t* __restrict__ pm_pix,
                            const int32_t* __restrict__ i_c,
                            const int32_t* __restrict__ i_p,
                            const float* __restrict__ wA, long long n, int d,
                            int dim, int r_pad, int knots,
                            int32_t* __restrict__ row_key,
                            int32_t* __restrict__ pair_key) {
  const int last = dim >= d ? (dim - d) / 3 : -1;  // last first knot in range
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const int pix = pm_pix[k], ic = i_c[k], ip = i_p[k];
    const bool ok = wA[k] > 0.f && pix >= 0 && pix < r_pad && ic >= 0 &&
                    ip >= 0 && ic <= last && ip <= last;
    row_key[k] = ok ? pix : r_pad;
    pair_key[k] = ok ? ic * knots + ip : knots * knots;
  }
}

template <int O>
__global__ void pack_kernel(const int32_t* __restrict__ pos,
                            const int32_t* __restrict__ n_valid,
                            const int32_t* __restrict__ i_c,
                            const int32_t* __restrict__ i_p,
                            const float* __restrict__ Jc,
                            const float* __restrict__ Jp,
                            const float* __restrict__ dx,
                            const float* __restrict__ dy,
                            const float* __restrict__ e,
                            const float* __restrict__ wA, long long n,
                            float* __restrict__ rec) {
  using S = Shape<O>;
  constexpr int D = S::D;
  const int valid = *n_valid;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const int slot = pos[k];
    if (slot >= valid) continue;  // dropped: sorted past the valid runs
    const int ic = i_c[k], ip = i_p[k];
    const float sw = sqrtf(wA[k]);
    float jc[D], jp[D], r[S::RW];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      jc[j] = Jc[(size_t)j * n + k];
      jp[j] = Jp[(size_t)j * n + k];
    }
#pragma unroll
    for (int i = 0; i < S::RW; ++i) r[i] = 0.f;
    r[0] = __int_as_float(ic);
    r[1] = __int_as_float(ip);
    r[W_DX] = sw * dx[k];
    r[W_DY] = sw * dy[k];
    r[W_E] = sw * e[k];
    // A prev entry on a curr column is folded into it before any product,
    // as u_k is formed: Jc and Jp of a shared knot nearly cancel in a real
    // window, and squaring them apart lost A11 to 1.2e-5 of its largest entry.
    const int shift = 3 * (ic - ip);  // prev index of curr index j: j + shift
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float c = jc[j];
#pragma unroll
      for (int i = 0; i < D; ++i)
        if (i == j + shift) c += jp[i];
      const bool folded = j - shift >= 0 && j - shift < D;
      r[RECORD_HEAD + j] = sw * c;
      r[RECORD_HEAD + D + j] = folded ? 0.f : sw * jp[j];
    }
    float4* out = reinterpret_cast<float4*>(rec + (size_t)slot * S::RW);
#pragma unroll
    for (int i = 0; i < S::RW / 4; ++i)
      out[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
  }
}

// Adds one record into buf (2*dp_pad A12 columns, then 8 px5 columns).
// Lane l holds word l of the record. Lane roles: t < 2D the curr entry
// (plane t/D, component t%D), t < 4D the prev entries that were not folded,
// t < 4D+5 the px5 sums; each adds g * a of two record words. The columns
// one measurement touches are distinct, so one __syncwarp a measurement
// orders the shared-memory updates.
template <int O>
__device__ __forceinline__ void add_record(float x, float* buf, int dp_pad,
                                           int lane) {
  using S = Shape<O>;
  constexpr int D = S::D;
  const int ic = __float_as_int(__shfl_sync(FULL, x, 0));
  const int ip = __float_as_int(__shfl_sync(FULL, x, 1));
#pragma unroll
  for (int rr = 0; rr < S::NR; ++rr) {
    const int t = lane + 32 * rr;
    int gs = 0, as = 0, col = -1;
    if (t < 2 * D) {
      const int p = t / D, j = t % D;
      gs = W_DX + p;
      as = RECORD_HEAD + j;
      col = p * dp_pad + 3 * ic + j;
    } else if (t < 4 * D) {
      const int p = (t - 2 * D) / D, jp = (t - 2 * D) % D;
      const int j = jp + 3 * (ip - ic);
      gs = W_DX + p;
      as = RECORD_HEAD + D + jp;
      col = (j >= 0 && j < D) ? -1 : p * dp_pad + 3 * ip + jp;
    } else if (t < S::ROLES) {
      const int i = t - 4 * D;  // w dx dx, w dx dy, w dy dy, w e dx, w e dy
      gs = i < 2 ? W_DX : (i == 2 ? W_DY : W_E);
      as = (i == 0 || i == 3) ? W_DX : W_DY;
      col = 2 * dp_pad + i;
    }
    const float g = __shfl_sync(FULL, x, gs);
    const float a = __shfl_sync(FULL, x, as);
    if (col >= 0) buf[col] += g * a;
  }
  __syncwarp();
}

// Adds the records of row-sorted measurements [s0, s1) (record slot[s])
// into buf, in row order, four a step with the next four loaded meanwhile.
template <int O>
__device__ void walk_records(const float* __restrict__ rec,
                             const int32_t* __restrict__ slot, int s0, int s1,
                             float* buf, int dp_pad, int lane) {
  constexpr int RW = Shape<O>::RW;
  int at[4];
  float x[4], y[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) at[u] = s0 + u < s1 ? slot[s0 + u] : -1;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    x[u] = (at[u] >= 0 && lane < RW) ? rec[(size_t)at[u] * RW + lane] : 0.f;
  for (int s = s0; s < s1; s += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) at[u] = s + 4 + u < s1 ? slot[s + 4 + u] : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u] = (at[u] >= 0 && lane < RW) ? rec[(size_t)at[u] * RW + lane] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (s + u < s1) add_record<O>(x[u], buf, dp_pad, lane);  // warp-uniform
      x[u] = y[u];
    }
  }
}

// One warp per heavy chunk: the chunk's records summed into a partial row.
template <int O>
__global__ void heavy_kernel(const float* __restrict__ rec,
                             const int32_t* __restrict__ slot,
                             const int32_t* __restrict__ row_off,
                             const int32_t* __restrict__ hc_start,
                             const int32_t* __restrict__ hc_row, int max_heavy,
                             int heavy, int dp_pad, int r_pad,
                             float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wb4 = (2 * dp_pad + 8) / 4;
  float4* buf4 = smem4 + (size_t)warp * wb4;
  float* buf = reinterpret_cast<float*>(buf4);
  for (int c = blockIdx.x * warps + warp; c < max_heavy; c += gridDim.x * warps) {
    const int row = hc_row[c];
    if (row >= r_pad) break;  // chunks past the last heavy one: none follow
    const int s0 = row_off[row] + (c - hc_start[row]) * heavy;
    const int s1 = min(s0 + heavy, row_off[row + 1]);
    for (int q = lane; q < wb4; q += 32) buf4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    walk_records<O>(rec, slot, s0, s1, buf, dp_pad, lane);
    float4* out = reinterpret_cast<float4*>(part) + (size_t)c * wb4;
    for (int q = lane; q < wb4; q += 32) out[q] = buf4[q];
    __syncwarp();
  }
}

// One warp per row, grid-stride over the rows. An empty row is written as
// float4 zeros without staging, and not touched at all under carry.
template <int O>
__global__ void rows_kernel(const float* __restrict__ rec,
                            const int32_t* __restrict__ slot,
                            const int32_t* __restrict__ row_off,
                            const int32_t* __restrict__ hc_start,
                            const float* __restrict__ part, int dp_pad,
                            int r_pad, int accumulate, float* __restrict__ a12,
                            float* __restrict__ px5) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a4 = 2 * dp_pad / 4, wb4 = a4 + 2;
  float4* buf4 = smem4 + (size_t)warp * wb4;
  float* buf = reinterpret_cast<float*>(buf4);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int row = blockIdx.x * warps + warp; row < r_pad; row += gridDim.x * warps) {
    float4* out = reinterpret_cast<float4*>(a12) + (size_t)row * a4;
    float4* pxo = reinterpret_cast<float4*>(px5) + (size_t)row * 2;
    const int beg = row_off[row], end = row_off[row + 1];
    if (beg == end) {  // empty: zeros, or the carry as it is
      if (!accumulate) {
        for (int q = lane; q < a4; q += 32) out[q] = zero;
        if (lane < 2) pxo[lane] = zero;
      }
      continue;
    }
    const int c0 = hc_start[row], c1 = hc_start[row + 1];
    if (c1 > c0) {  // heavy: the partials in chunk order, no staging
      for (int q = lane; q < wb4; q += 32) {
        float4* dst = q < a4 ? out + q : pxo + (q - a4);
        float4 v = accumulate ? *dst : zero;
        for (int c = c0; c < c1; ++c) {
          const float4 p = reinterpret_cast<const float4*>(part)[(size_t)c * wb4 + q];
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
        *dst = v;
      }
      continue;
    }
    for (int q = lane; q < wb4; q += 32)
      buf4[q] = accumulate ? (q < a4 ? out[q] : pxo[q - a4]) : zero;
    __syncwarp();
    walk_records<O>(rec, slot, beg, end, buf, dp_pad, lane);
    for (int q = lane; q < a4; q += 32) out[q] = buf4[q];
    if (lane < 2) pxo[lane] = buf4[a4 + lane];
    __syncwarp();
  }
}

// One warp per chunk of a pair run: lane l holds cells l, l+32, .. of the
// packed upper triangle of the A11 vector's outer product in registers.
template <int O>
__global__ void a11_chunk_kernel(const float* __restrict__ rec,
                                 const int32_t* __restrict__ key_off,
                                 const int32_t* __restrict__ ck_start,
                                 const int32_t* __restrict__ ck_key,
                                 int max_chunks, int num_keys, int chunk,
                                 float* __restrict__ part) {
  using S = Shape<O>;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int ca[S::NCL], cb[S::NCL];
#pragma unroll
  for (int i = 0; i < S::NCL; ++i) {
    int t = lane + 32 * i, a = 0;
    if (t >= S::NC) t = 0;  // padding cell: computed, never read
    while (t >= S::P - a) { t -= S::P - a; ++a; }
    ca[i] = vector_word<O>(a);
    cb[i] = vector_word<O>(a + t);
  }
  for (int c = blockIdx.x * warps + warp; c < max_chunks; c += gridDim.x * warps) {
    const int key = ck_key[c];
    if (key >= num_keys) break;  // chunks past the last one: none follow
    const int s0 = key_off[key] + (c - ck_start[key]) * chunk;
    const int s1 = min(s0 + chunk, key_off[key + 1]);
    float acc[S::NCL];
#pragma unroll
    for (int i = 0; i < S::NCL; ++i) acc[i] = 0.f;
    // four records a step, the next four loaded while these are summed
    float x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = (s0 + u < s1 && lane < S::RW) ? rec[(size_t)(s0 + u) * S::RW + lane] : 0.f;
    for (int s = s0; s < s1; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[u] = (s + 4 + u < s1 && lane < S::RW)
                   ? rec[(size_t)(s + 4 + u) * S::RW + lane] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < S::NCL; ++i)
          acc[i] += __shfl_sync(FULL, x[u], ca[i]) * __shfl_sync(FULL, x[u], cb[i]);
        x[u] = y[u];
      }
    }
    float* out = part + (size_t)c * S::NCP;
#pragma unroll
    for (int i = 0; i < S::NCL; ++i) out[lane + 32 * i] = acc[i];
  }
}

// Each key with more than one chunk: its chunks summed, cell by cell, into
// its first chunk's partial (in place: the key's chunks belong to this block
// alone). Warp w sums chunks c0 + w, c0 + w + 8, .. in order; the eight warp
// sums are added pairwise. A key's sum then lies at part[ck_start[key]].
template <int O>
__global__ void a11_keysum_kernel(float* __restrict__ part,
                                  const int32_t* __restrict__ ck_start,
                                  int num_keys) {
  using S = Shape<O>;
  __shared__ float red[8][S::NCP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int key = blockIdx.x; key < num_keys; key += gridDim.x) {
    const int c0 = ck_start[key], c1 = ck_start[key + 1];
    if (c1 - c0 < 2) continue;  // block-uniform
#pragma unroll
    for (int i = 0; i < S::NCL; ++i) {
      const int t = lane + 32 * i;
      float acc = 0.f;
#pragma unroll 4
      for (int c = c0 + warp; c < c1; c += 8) acc += part[(size_t)c * S::NCP + t];
      red[warp][t] = acc;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < S::NCP; t += blockDim.x)
      part[(size_t)c0 * S::NCP + t] = ((red[0][t] + red[1][t]) + (red[2][t] + red[3][t])) +
                                      ((red[4][t] + red[5][t]) + (red[6][t] + red[7][t]));
    __syncthreads();
  }
}

// Cell t of the key sums of keys first, first + stride, .. (count of them),
// the empty ones skipped, summed in key order with their ranges loaded
// eight at a time.
template <int NCP>
__device__ float sum_keys(const float* __restrict__ part,
                          const int32_t* __restrict__ ck_start, int first,
                          int stride, int count, int t) {
  float s = 0.f;
  for (int q0 = 0; q0 < count; q0 += 8) {
    int lo[8], hi[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int key = first + (q0 + u) * stride;
      lo[u] = q0 + u < count ? ck_start[key] : 0;
      hi[u] = q0 + u < count ? ck_start[key + 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (hi[u] > lo[u]) s += part[(size_t)lo[u] * NCP + t];
  }
  return s;
}

// marg[0][ic][cell]: the sums of keys (ic, *) added, for the cells of the
// curr-curr block and of (curr, e); marg[1][ip][cell]: the sums of keys
// (*, ip), for the prev-prev block and (prev, e). Key order throughout.
template <int O>
__global__ void a11_marginal_kernel(const float* __restrict__ part,
                                    const int32_t* __restrict__ ck_start,
                                    int knots, float* __restrict__ marg) {
  using S = Shape<O>;
  constexpr int D = S::D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2LL * knots * S::NCP) return;
  const int t = (int)(idx % S::NCP);
  const int m = (int)((idx / S::NCP) % knots);
  const int which = (int)(idx / ((long long)S::NCP * knots));
  float s = 0.f;
  if (t < S::NC) {
    int r = t, a = 0;
    while (r >= S::P - a) { r -= S::P - a; ++a; }
    const int b = a + r;
    if (which == 0 && a < D && (b < D || b == 2 * D))
      s = sum_keys<S::NCP>(part, ck_start, m * knots, 1, knots, t);  // (m, *)
    else if (which == 1 && a >= D && a < 2 * D)
      s = sum_keys<S::NCP>(part, ck_start, m, knots, knots, t);  // (*, m)
  }
  marg[idx] = s;
}

// One thread per cell of a11b. A11[r][c] for r <= c (and its mirror, the
// same sum) adds, in this order: the curr-curr sums of the curr knots whose
// block holds both, the prev-prev sums of the prev knots, the (curr r, prev
// c) cross cells of each pair's sum reaching them, then (prev r, curr c).
template <int O>
__global__ void a11_assemble_kernel(const float* __restrict__ part,
                                    const int32_t* __restrict__ ck_start,
                                    const float* __restrict__ marg, int knots,
                                    int dim, int dp_pad, int accumulate,
                                    float* __restrict__ a11b) {
  using S = Shape<O>;
  constexpr int D = S::D, P = S::P;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)(dp_pad + 8) * dp_pad) return;
  const int row = (int)(idx / dp_pad), col = (int)(idx % dp_pad);
  float s = accumulate ? a11b[idx] : 0.f;
  const float* mc = marg;
  const float* mp = marg + (size_t)knots * S::NCP;
  if (col < dim && (row < dim || row == dp_pad)) {
    if (row == dp_pad) {  // b1: the (curr, e) and (prev, e) cells
      const int kc = col / 3;
      for (int m = max(0, kc - O + 1); m <= kc && m < knots; ++m)
        s += mc[(size_t)m * S::NCP + cell_index(col - 3 * m, 2 * D, P)];
      for (int m = max(0, kc - O + 1); m <= kc && m < knots; ++m)
        s += mp[(size_t)m * S::NCP + cell_index(D + col - 3 * m, 2 * D, P)];
    } else {
      const int r = min(row, col), c = max(row, col);
      const int kr = r / 3, kc = c / 3;
      float acc = 0.f;
      for (int m = max(0, kc - O + 1); m <= kr && m < knots; ++m)
        acc += mc[(size_t)m * S::NCP + cell_index(r - 3 * m, c - 3 * m, P)];
      for (int m = max(0, kc - O + 1); m <= kr && m < knots; ++m)
        acc += mp[(size_t)m * S::NCP + cell_index(D + r - 3 * m, D + c - 3 * m, P)];
      for (int ic = max(0, kr - O + 1); ic <= kr && ic < knots; ++ic)
        for (int ip = max(0, kc - O + 1); ip <= kc && ip < knots; ++ip) {
          const int key = ic * knots + ip;
          if (ck_start[key + 1] > ck_start[key])
            acc += part[(size_t)ck_start[key] * S::NCP +
                        cell_index(r - 3 * ic, D + c - 3 * ip, P)];
        }
      for (int ip = max(0, kr - O + 1); ip <= kr && ip < knots; ++ip)
        for (int ic = max(0, kc - O + 1); ic <= kc && ic < knots; ++ic) {
          const int key = ic * knots + ip;
          if (ck_start[key + 1] > ck_start[key])
            acc += part[(size_t)ck_start[key] * S::NCP +
                        cell_index(c - 3 * ic, D + r - 3 * ip, P)];
        }
      s += acc;
    }
  }
  a11b[idx] = s;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

long long grid_for(long long items, int per_block, int blocks_per_sm) {
  const long long need = (items + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  return need < cap ? need : cap;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 49152) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct FormArgs {
  const int32_t *pos, *slot, *row_off, *hc_start, *hc_row, *key_off, *ck_start,
      *ck_key, *i_c, *i_p;
  const float *Jc, *Jp, *dx, *dy, *e, *wA;
  long long n;
  int dim, dp_pad, r_pad, knots, accumulate, max_heavy, heavy, max_chunks,
      chunk;
  float *rec, *heavy_part, *a11_part, *marg, *a12, *px5, *a11b;
};

template <int O>
int form(const FormArgs& f, cudaStream_t st) {
  using S = Shape<O>;
  cudaError_t err;
  if (f.n > 0) {
    const long long g = grid_for(f.n, 256, 64);
    pack_kernel<O><<<(int)g, 256, 0, st>>>(
        f.pos, f.row_off + f.r_pad, f.i_c, f.i_p, f.Jc, f.Jp, f.dx, f.dy, f.e,
        f.wA, f.n, f.rec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // rows: as many warps a block as fit 48 KB of row buffers, at least one
  const size_t row_bytes = (size_t)(2 * f.dp_pad + 8) * sizeof(float);
  int warps = (int)(49152 / row_bytes);
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const size_t smem = row_bytes * warps;
  if ((err = allow_smem(heavy_kernel<O>, smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(rows_kernel<O>, smem)) != cudaSuccess) return (int)err;
  if (f.max_heavy > 0) {
    const long long g = grid_for(f.max_heavy, warps, 64 / warps);
    heavy_kernel<O><<<(int)g, warps * 32, smem, st>>>(
        f.rec, f.slot, f.row_off, f.hc_start, f.hc_row, f.max_heavy, f.heavy,
        f.dp_pad, f.r_pad, f.heavy_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (f.r_pad > 0) {
    const long long g = grid_for(f.r_pad, warps, 64 / warps);
    rows_kernel<O><<<(int)g, warps * 32, smem, st>>>(
        f.rec, f.slot, f.row_off, f.hc_start, f.heavy_part, f.dp_pad, f.r_pad,
        f.accumulate, f.a12, f.px5);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const int num_keys = f.knots * f.knots;
  if (f.max_chunks > 0) {
    const long long g = grid_for(f.max_chunks, 8, 8);
    a11_chunk_kernel<O><<<(int)g, 256, 0, st>>>(
        f.rec, f.key_off, f.ck_start, f.ck_key, f.max_chunks, num_keys,
        f.chunk, f.a11_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long gk = grid_for(num_keys, 1, 16);
    a11_keysum_kernel<O><<<(int)gk, 256, 0, st>>>(f.a11_part, f.ck_start, num_keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long nm = 2LL * f.knots * S::NCP;
  a11_marginal_kernel<O><<<(int)((nm + 255) / 256), 256, 0, st>>>(
      f.a11_part, f.ck_start, f.knots, f.marg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)(f.dp_pad + 8) * f.dp_pad;
  a11_assemble_kernel<O><<<(int)((total + 255) / 256), 256, 0, st>>>(
      f.a11_part, f.ck_start, f.marg, f.knots, f.dim, f.dp_pad, f.accumulate,
      f.a11b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* emba_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The scratch layout of Shape<spline_order>, for the wrapper's buffers: the
// words of a record (rec is n x record_words) and the padded A11 cells of a
// chunk partial (a11_part is max_chunks x cells, marg 2 x knots x cells).
// Returns 0, or cudaErrorInvalidValue for an order outside [2, 4].
extern "C" int emba_a12_sizes(int spline_order, int* record_words, int* cells) {
  switch (spline_order) {
    case 2: *record_words = Shape<2>::RW; *cells = Shape<2>::NCP; return 0;
    case 3: *record_words = Shape<3>::RW; *cells = Shape<3>::NCP; return 0;
    case 4: *record_words = Shape<4>::RW; *cells = Shape<4>::NCP; return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sort keys: row_key[k] = pm_pix (R_pad if dropped), pair_key[k] =
// i_c*knots + i_p (knots^2 if dropped). Returns 0 or the cudaError_t.
extern "C" int emba_a12_keys(const void* pm_pix, const void* i_c,
                             const void* i_p, const void* wA, long long n,
                             int spline_order, int dim_pose, int r_pad,
                             int knots, void* row_key, void* pair_key,
                             void* stream) {
  if (spline_order < 2 || spline_order > 4 || knots < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long g = grid_for(n, 256, 64);
  keys_kernel<<<(int)g, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pm_pix, (const int32_t*)i_c, (const int32_t*)i_p,
      (const float*)wA, n, 3 * spline_order, dim_pose, r_pad, knots,
      (int32_t*)row_key, (int32_t*)pair_key);
  return (int)cudaGetLastError();
}

// Pack, rows (heavy chunks first) and A11/b1, from the wrapper's index maps:
// pos[k] the record slot of measurement k (its place in pair order), slot[s]
// the record of the s-th measurement in row order. Returns 0, or the
// cudaError_t of the first launch that failed.
extern "C" int emba_a12_form(
    const void* pos, const void* slot, const void* row_off,
    const void* hc_start, const void* hc_row, const void* key_off,
    const void* ck_start, const void* ck_key, const void* i_c, const void* i_p,
    const void* Jc, const void* Jp, const void* dx, const void* dy,
    const void* e, const void* wA, long long n, int spline_order, int dim_pose,
    int dp_pad, int r_pad, int knots, int accumulate, int max_heavy, int heavy,
    int max_chunks, int chunk, void* rec, void* heavy_part,
    void* a11_part, void* marg, void* a12, void* px5, void* a11b,
    void* stream) {
  if (spline_order < 2 || spline_order > 4 || dp_pad < dim_pose || dp_pad % 4 ||
      knots < 1 || heavy < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const FormArgs f{
      (const int32_t*)pos, (const int32_t*)slot, (const int32_t*)row_off,
      (const int32_t*)hc_start, (const int32_t*)hc_row, (const int32_t*)key_off,
      (const int32_t*)ck_start, (const int32_t*)ck_key, (const int32_t*)i_c,
      (const int32_t*)i_p, (const float*)Jc, (const float*)Jp, (const float*)dx,
      (const float*)dy, (const float*)e, (const float*)wA, n, dim_pose, dp_pad,
      r_pad, knots, accumulate, max_heavy, heavy, max_chunks, chunk,
      (float*)rec, (float*)heavy_part, (float*)a11_part,
      (float*)marg, (float*)a12, (float*)px5, (float*)a11b};
  cudaStream_t st = (cudaStream_t)stream;
  switch (spline_order) {
    case 2: return form<2>(f, st);
    case 3: return form<3>(f, st);
    default: return form<4>(f, st);
  }
}
