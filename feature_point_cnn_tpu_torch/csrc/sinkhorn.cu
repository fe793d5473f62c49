// SuperGlue's log-space Sinkhorn (`models/superglue.py::log_optimal_transport`)
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no SuperGlue.  It was added
// because the plain loop streams the float32 couplings, (B, N+1, M+1) =
// 134.5 MB at the benchmark's (32, 1024, 1024), through device memory about
// five times a half-iteration in ~5 launches, 200 half-iterations a call:
// ~86 ms of a ~136-ms SuperGlue frame on an H100.
//
// What it computes, as the plain loop does: the couplings are the scores
// with a dustbin row and column of `alpha`; for `iters` iterations
//   u_i = log_mu_i - logsumexp_j (C_ij + v_j),
//   v_j = log_nu_j - logsumexp_i (C_ij + u_i),
// from the initial v the caller gives (0 on valid columns and the dustbin,
// -inf on padded ones); then Z = C + u + v - norm.  Each logsumexp is
// torch's: the max, shifted to 0 where it is infinite, then
// log(sum(exp(x - max))) + max.  The marginals and `norm` come from the
// caller, so padded rows and columns are -inf exactly where the plain
// loop's are.
//
// Bound on an H100 SXM: the couplings do not fit on chip (30 MB of shared
// memory on 132 SMs, 50 MB of L2), so each iteration reads them once from
// device memory: 100 x 134.5 MB = 13.4 GB, 4.0 ms at 3.35 TB/s.  The
// exponentials, two an entry an iteration (6.72 G), take 1.6 ms at 16 a
// clock an SM.
//
// Design.  An iteration is two launches.  `band_kernel`: persistent blocks,
// three an SM, walk over bands of kSlots / cols rows of a pair (8 at the
// benchmark's M = 1024); each thread holds `cols` score columns (tid +
// kThreads * k) of every row of the band in registers, read once from
// `scores` (the couplings tensor is never built: the dustbin row and column
// are `alpha`).  With v the block takes the band's row logsumexps (a
// transposed warp butterfly, then the warps' partials in shared memory) and
// so u for its rows; with that u, each thread takes its columns' logsumexp
// over the band's rows on its own registers and writes one float a column:
// the band's partial.  `column_kernel` folds a pair's band partials into v
// (17 MB written and read an iteration at the benchmark's shape, mostly in
// L2, against the couplings' 134.5).  Iterations alternate the order of the
// bands, so that the bands read last, still in L2, are read first again.
// `output_kernel` writes Z once, reading the scores a last time.  No launch
// allocates or synchronises: u, v, the partials and Z are the caller's.
// On the H100 at the benchmark's shape, three blocks an SM of 8-row bands
// (80 registers a thread) ran faster than two of 16-row bands (128), and
// reading each band straight into registers faster than bulk copies of the
// next band into shared memory during the current one (PERF.md, PR 18).
// Exponentials and logarithms are the hardware's approximations (__expf,
// __logf: ex2 and lg2 of the scaled argument): a term's relative error is
// ~1e-7 times its distance from the row's max, and terms 87 below it, which
// PyTorch keeps as denormals, flush to 0 beside the max's 1.  Z stays within
// 1e-6 of its largest magnitude of the plain loop's after 100 iterations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;          // couplings a thread holds: rows x cols
constexpr int kBlocksPerSm = 3;     // band blocks an SM holds (80 registers a thread)
constexpr int kMaxCols = 16;        // score columns a thread holds at most
constexpr int kColumnThreads = 256; // threads of the column and output kernels

// score columns a thread holds for m of them: the least power of two with
// kThreads * cols >= m
int cols_of(int m) {
  int cols = 1;
  while (kThreads * cols < m) cols *= 2;
  return cols;
}

// a block's dynamic shared memory for bands of `rows` rows: each warp's row
// maxima and sums, and each row's max and u (576 B at 8 rows)
size_t band_smem_bytes(int rows) {
  return 4 * static_cast<size_t>(rows) * (2 * kWarps + 2);
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Reduces each of a lane's first N values over the warp's 32 lanes by a
// transposed butterfly: a step with offset OFF trades half of the values
// still held with lane ^ OFF, so (for N <= 32) N - 1 + log2(32 / N) shuffles
// do the work of 5 N.  After it, lane l holds in a[0 .. max(N / 32, 1)) the warp's values
// of rows scatter_row<N>(l) + 0, 1, ...
template <int N, int OFF = 16, int SIZE, class Op>
__device__ __forceinline__ void reduce_scatter(float (&a)[SIZE], int lane, Op op) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = lane & OFF;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? a[i] : a[i + H];
        const float keep = upper ? a[i + H] : a[i];
        a[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
      }
      reduce_scatter<H, OFF / 2>(a, lane, op);
    } else {
      a[0] = op(a[0], __shfl_xor_sync(0xffffffffu, a[0], OFF));
      reduce_scatter<1, OFF / 2>(a, lane, op);
    }
  }
}

template <int N>
__device__ __forceinline__ int scatter_row(int lane) {
  int row = 0;
#pragma unroll
  for (int off = 16, n = N; off >= 1 && n > 1; off >>= 1) {
    n /= 2;
    if (lane & off) row += n;
  }
  return row;
}

// each warp's reduction of the N rows `a` holds, into partials[row][kWarps]:
// the lanes of one copy of each row write it
template <int N, class Op>
__device__ __forceinline__ void warp_partials(float (&a)[N], float* partials, int lane,
                                              int warp, Op op) {
  reduce_scatter<N>(a, lane, op);
  constexpr int kHeld = N >= 32 ? N / 32 : 1;
  if ((lane & (N >= 32 ? 0 : 32 / N - 1)) == 0) {
    const int row = scatter_row<N>(lane);
#pragma unroll
    for (int v = 0; v < kHeld; ++v) partials[(row + v) * kWarps + warp] = a[v];
  }
}

// torch.logsumexp's shift: the max, or 0 where the max is infinite
__device__ __forceinline__ float shift_of(float mx) { return isinf(mx) ? 0.0f : mx; }

// grid: persistent blocks; block k takes bands k, k + gridDim.x, ... of the
// `total` = b * bands, pair by pair, last to first where `reverse`.
// scores (b, n, m); log_mu, u (b, n + 1); v (b, m + 1); partial (b, bands,
// m + 1)
template <int COLS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
band_kernel(const float* __restrict__ scores, const float* __restrict__ alpha_ptr,
            const float* __restrict__ log_mu, const float* __restrict__ v,
            float* __restrict__ u, float* __restrict__ partial, int n, int m,
            int bands, int total, int reverse) {
  constexpr int kRows = kSlots / COLS;
  extern __shared__ float smem[];
  float* warp_maxes = smem;                          // [kRows][kWarps]
  float* warp_sums = warp_maxes + kRows * kWarps;
  float* row_max = warp_sums + kRows * kWarps;       // [kRows]
  float* row_u = row_max + kRows;                    // [kRows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float alpha = *alpha_ptr;

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int band = reverse ? total - 1 - t : t, pair = band / bands;
    const int row0 = (band - pair * bands) * kRows;
    const float* vp = v + static_cast<size_t>(pair) * (m + 1);

    // the band's couplings: row row0 + r, score column tid + kThreads * k
    float c[kRows][COLS];
    float vc[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int j = tid + kThreads * k;
      vc[k] = j < m ? vp[j] : -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* src = scores + (static_cast<size_t>(pair) * n + row0 + r) * m;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int j = tid + kThreads * k;
        c[r][k] = row0 + r < n && j < m ? src[j] : alpha;
      }
    }
    const float bin = alpha + vp[m];   // the dustbin column's C + v, every row

    // ---- u: each row's logsumexp over the columns -----------------------
    {
      float mx[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        mx[r] = tid == 0 ? bin : -INFINITY;
#pragma unroll
        for (int k = 0; k < COLS; ++k) mx[r] = fmaxf(mx[r], c[r][k] + vc[k]);
      }
      warp_partials(mx, warp_maxes, lane, warp, Max{});
    }
    __syncthreads();
    if (tid < kRows) {
      float mx = warp_maxes[tid * kWarps];
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, warp_maxes[tid * kWarps + w]);
      row_max[tid] = mx;
    }
    __syncthreads();
    {
      float sum[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sh = shift_of(row_max[r]);
        sum[r] = tid == 0 ? __expf(bin - sh) : 0.0f;
#pragma unroll
        for (int k = 0; k < COLS; ++k) sum[r] += __expf(c[r][k] + vc[k] - sh);
      }
      warp_partials(sum, warp_sums, lane, warp, Add{});
    }
    __syncthreads();
    if (tid < kRows) {
      float s = warp_sums[tid * kWarps];
      for (int w = 1; w < kWarps; ++w) s += warp_sums[tid * kWarps + w];
      const int i = row0 + tid;
      float ui = -INFINITY;    // rows past the dustbin take no part
      if (i <= n) {
        const size_t at = static_cast<size_t>(pair) * (n + 1) + i;
        ui = log_mu[at] - (__logf(s) + shift_of(row_max[tid]));
        u[at] = ui;
      }
      row_u[tid] = ui;
    }
    __syncthreads();

    // ---- the band's partial of each column's logsumexp over the rows -----
    float* out = partial + static_cast<size_t>(band) * (m + 1);
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int j = tid + kThreads * k;
      if (j < m) {
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < kRows; ++r) mx = fmaxf(mx, c[r][k] + row_u[r]);
        const float sh = shift_of(mx);
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) s += __expf(c[r][k] + row_u[r] - sh);
        out[j] = __logf(s) + sh;
      }
    }
    if (tid == kThreads - 1) {   // the dustbin column: alpha on every row
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kRows; ++r) mx = fmaxf(mx, alpha + row_u[r]);
      const float sh = shift_of(mx);
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) s += __expf(alpha + row_u[r] - sh);
      out[m] = __logf(s) + sh;
    }
  }
}

// grid: one block a (pair, 32 of the m + 1 columns); warp w folds bands w,
// w + kColumnWarps, ... of its lane's column, the warps' maxima and sums
// then meet in shared memory
__global__ void __launch_bounds__(kColumnThreads)
column_kernel(const float* __restrict__ partial, const float* __restrict__ log_nu,
              float* __restrict__ v, int m, int bands, int chunks) {
  constexpr int kColumnWarps = kColumnThreads / 32;
  __shared__ float warp_maxes[kColumnWarps][32];
  __shared__ float warp_sums[kColumnWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = blockIdx.x / chunks;
  const int j = (blockIdx.x - pair * chunks) * 32 + lane;
  const bool live = j <= m;
  const float* p = partial + static_cast<size_t>(pair) * bands * (m + 1) + j;
  float mx = -INFINITY;
  if (live)
    for (int b = warp; b < bands; b += kColumnWarps)
      mx = fmaxf(mx, p[static_cast<size_t>(b) * (m + 1)]);
  warp_maxes[warp][lane] = mx;
  __syncthreads();
  for (int w = 0; w < kColumnWarps; ++w) mx = fmaxf(mx, warp_maxes[w][lane]);
  const float sh = shift_of(mx);
  float s = 0.0f;
  if (live)
    for (int b = warp; b < bands; b += kColumnWarps)
      s += __expf(p[static_cast<size_t>(b) * (m + 1)] - sh);
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && live) {
    s = warp_sums[0][lane];
    for (int w = 1; w < kColumnWarps; ++w) s += warp_sums[w][lane];
    const size_t at = static_cast<size_t>(pair) * (m + 1) + j;
    v[at] = log_nu[at] - (__logf(s) + sh);
  }
}

// grid: one block a (pair, row) of Z (b, n + 1, m + 1); ((C + u) + v) - norm,
// the plain loop's order
__global__ void __launch_bounds__(kColumnThreads)
output_kernel(const float* __restrict__ scores, const float* __restrict__ alpha_ptr,
              const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ norm, float* __restrict__ z, int n, int m) {
  const int row = blockIdx.x;
  const int pair = row / (n + 1), i = row - pair * (n + 1);
  const float alpha = *alpha_ptr, ui = u[row], nm = norm[pair];
  const float* src = scores + (static_cast<size_t>(pair) * n + i) * m;
  const float* vp = v + static_cast<size_t>(pair) * (m + 1);
  float* dst = z + static_cast<size_t>(row) * (m + 1);
  for (int j = threadIdx.x; j <= m; j += kColumnThreads) {
    const float c = i < n && j < m ? src[j] : alpha;
    dst[j] = c + ui + vp[j] - nm;
  }
}

template <int COLS>
int run(const float* scores, const float* alpha, const float* log_mu,
        const float* log_nu, const float* norm, float* u, float* v, float* partial,
        float* z, int b, int n, int m, int iters, cudaStream_t st) {
  constexpr int kRows = kSlots / COLS;
  const int bands = (n + 1 + kRows - 1) / kRows;
  const int chunks = (m + 1 + 31) / 32;
  const long long total = static_cast<long long>(b) * bands;
  if (total > 0x7fffffffLL || static_cast<long long>(b) * chunks > 0x7fffffffLL ||
      static_cast<long long>(b) * (n + 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = band_smem_bytes(kRows);
  int device = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_kernel<COLS>, kThreads, smem));
  if (err) return err;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned int blocks = static_cast<unsigned int>(total < resident ? total : resident);
  for (int it = 0; it < iters; ++it) {
    band_kernel<COLS><<<blocks, kThreads, smem, st>>>(
        scores, alpha, log_mu, v, u, partial, n, m, bands, static_cast<int>(total), it & 1);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    column_kernel<<<b * chunks, kColumnThreads, 0, st>>>(partial, log_nu, v, m, bands,
                                                        chunks);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  output_kernel<<<b * (n + 1), kColumnThreads, 0, st>>>(scores, alpha, u, v, norm, z, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: (b, n, m) float32 contiguous; alpha: one float32 on the device;
// log_mu: (b, n + 1), log_nu: (b, m + 1), norm: (b); v: (b, m + 1), the
// initial column potentials on entry and the last ones on return; u:
// (b, n + 1) and partial: (b, ceil((n + 1) / (kSlots / cols)), m + 1)
// scratch; z: (b, n + 1, m + 1).  m <= kThreads * kMaxCols, iters >= 1.
// 2 * iters + 1 launches on `stream`; returns the first cudaError_t (0 on
// success).
extern "C" int sinkhorn_launch(const float* scores, const float* alpha,
                               const float* log_mu, const float* log_nu,
                               const float* norm, float* u, float* v, float* partial,
                               float* z, int b, int n, int m, int iters, void* stream) {
  if (b == 0) return 0;
  if (n < 0 || m < 0 || m > kThreads * kMaxCols || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols_of(m)) {
    case 1: return run<1>(scores, alpha, log_mu, log_nu, norm, u, v, partial, z, b, n, m, iters, st);
    case 2: return run<2>(scores, alpha, log_mu, log_nu, norm, u, v, partial, z, b, n, m, iters, st);
    case 4: return run<4>(scores, alpha, log_mu, log_nu, norm, u, v, partial, z, b, n, m, iters, st);
    case 8: return run<8>(scores, alpha, log_mu, log_nu, norm, u, v, partial, z, b, n, m, iters, st);
    case 16: return run<16>(scores, alpha, log_mu, log_nu, norm, u, v, partial, z, b, n, m, iters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
