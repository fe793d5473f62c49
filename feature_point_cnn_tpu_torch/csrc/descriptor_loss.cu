// Hinge descriptor loss over all cell pairs, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel feature_point_cnn_tpu/ops/pallas/
// descriptor_loss.py: hinge_descriptor_loss_pallas (_fwd_kernel,
// _bwd_kernel).  Per batch item, with unit descriptors d_i, wd_j (N x D):
//   a_ij = relu(d_i . wd_j)           rr_i = rsqrt(sum_j a_ij^2 + 1e-12)
//   u_ij = a_ij rr_i                  c_j  = sum_i u_ij^2
//   rc_j = rsqrt(c_j + 1e-12)         v_ij = u_ij rc_j
//   s_ij = |warped_center_i - center_j|^2 < (cell - 0.5)^2
//   loss = sum_ij m_j (s ? lambda max(0, mp - v) : max(0, v - mn))
// and backward, with G_ij = g m_j (s ? -lambda [mp - v > 0] : [v - mn > 0]):
//   T_j = rc_j^3 sum_i G_ij u_ij      h_ij = G_ij rc_j - T_j u_ij
//   srow_i = rr_i^3 sum_j h_ij a_ij   dg_ij = a_ij > 0 ? h_ij rr_i - srow_i a_ij : 0
//   dd_i = sum_j dg_ij wd_j           dwd_j = sum_i dg_ij d_i
// No (B, N, N) array is ever written to device memory.
//
// Bound on an H100 SXM: operations.  One N x N x D product is 2 N^2 D flop
// (0.369 GFLOP at N = 1200, D = 128); the inputs and outputs are four
// (B, N, D) arrays, under 0.03 ms at 3.35 TB/s for B = 32, against
// float32 FMAs at 67 TFLOP/s.  The function needs 2 products forward and 4
// backward (2 rebuilt, 2 gradient products): 0.35 and 0.70 ms at B = 32.
//
// Design.  The TPU kernel holds a whole wd panel on chip and walks the row
// tiles in order, carrying c_j, T_j and dwd across them.  Here blocks run in
// no order and an SM has 227 KB, so every pass is one "sweep" kernel: a block
// owns one 64-row tile of one side (rows i of d, or columns j of wd) of one
// batch item, keeps it in shared memory, and walks the other side in
// 64-row chunks, rebuilding each 64 x 64 tile of a_ij from one dot product
// (16 x 16 threads, a 4 x 4 register tile each).  Whatever crosses tiles is
// owned by a block of the right side, so no sum crosses blocks:
//   forward   rr (row owner), c (column owner), loss (row owner), then one
//             small block adds the per-block partial losses in a fixed order;
//   backward  T (column owner), srow (row owner), dd (row owner, the tile of
//             dg goes through shared memory into a second product with the
//             wd chunk), dwd (column owner, likewise with the d chunk).
// The (B, N) vectors rr, c, T, srow live in device memory between passes.
// That makes 3 products forward and 6 backward (4 rebuilt dots, 2 gradient
// products), one and two more than the bound counts: the price of a row
// statistic that needs a sweep of its own.  Each launcher is 4 launches
// (forward: 3 sweeps and the sum; backward: 4 sweeps).  There is no atomicAdd: every sum has a fixed order, so value
// and gradients repeat bit for bit.  The ragged edge (N need not be a
// multiple of 64) is masked, not padded.  Plain float32 FMAs; no tensor
// cores, TMA or TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;        // tile edge (rows a block owns, rows per chunk)
constexpr int kLd = kT + 4;   // shared-memory row pitch, keeps float4 aligned
constexpr int kThreads = 256; // 16 x 16, each a 4 x 4 piece of the tile
constexpr int kDc = 128;      // gradient columns one block accumulates
constexpr float kEps = 1e-12f;

enum Mode { kRr, kC, kLoss, kTcol, kSrow, kDd, kDwd };

struct Args {
  const float* d;     // (B, N, D)
  const float* wd;    // (B, N, D)
  const float* wc;    // (B, N, 2) warped centers (y, x), i side
  const float* ct;    // (N, 2) centers (y, x), j side
  const float* mj;    // (B, N)
  const float* rr;    // (B, N) or null
  const float* c;     // (B, N) or null
  const float* tcol;  // (B, N) or null
  const float* srow;  // (B, N) or null
  const float* g;     // upstream gradient, one float, or null
  float* out;
  int n, dim;
  float lambda_d, mp, mn, thr2;
};

// rows [row0, row0 + kT) of a (n, dim) matrix -> s[k * kLd + r], zero past n
__device__ __forceinline__ void load_tile(float* s, const float* m, int row0,
                                          int n, int dim) {
  for (int idx = threadIdx.x; idx < kT * dim; idx += kThreads) {
    const int r = idx / dim, k = idx - r * dim;
    const int row = row0 + r;
    s[k * kLd + r] = row < n ? m[static_cast<size_t>(row) * dim + k] : 0.0f;
  }
}

// i-side vectors of one tile: rr, srow, warped center y, x
__device__ __forceinline__ void load_i(float* iv, const Args& p, int b, int i0) {
  const int t = threadIdx.x;
  if (t >= kT) return;
  const int i = i0 + t;
  const bool ok = i < p.n;
  const size_t o = static_cast<size_t>(b) * p.n + i;
  iv[t] = ok && p.rr ? p.rr[o] : 0.0f;
  iv[kT + t] = ok && p.srow ? p.srow[o] : 0.0f;
  iv[2 * kT + t] = ok ? p.wc[o * 2] : 0.0f;
  iv[3 * kT + t] = ok ? p.wc[o * 2 + 1] : 0.0f;
}

// j-side vectors of one tile: rc, T, mask, center y, x
__device__ __forceinline__ void load_j(float* jv, const Args& p, int b, int j0) {
  const int t = threadIdx.x;
  if (t >= kT) return;
  const int j = j0 + t;
  const bool ok = j < p.n;
  const size_t o = static_cast<size_t>(b) * p.n + j;
  jv[t] = ok && p.c ? rsqrtf(p.c[o] + kEps) : 0.0f;
  jv[kT + t] = ok && p.tcol ? p.tcol[o] : 0.0f;
  jv[2 * kT + t] = ok ? p.mj[o] : 0.0f;
  jv[3 * kT + t] = ok ? p.ct[static_cast<size_t>(j) * 2] : 0.0f;
  jv[4 * kT + t] = ok ? p.ct[static_cast<size_t>(j) * 2 + 1] : 0.0f;
}

template <int MODE>
__device__ __forceinline__ float elem(float a, const float* iv, const float* jv,
                                      int il, int jl, float g, const Args& p) {
  if (MODE == kRr) return a * a;
  const float rr = iv[il];
  const float u = a * rr;
  if (MODE == kC) return u * u;
  const float rc = jv[jl];
  const float v = u * rc;
  const float m = jv[2 * kT + jl];
  const float dy = iv[2 * kT + il] - jv[3 * kT + jl];
  const float dx = iv[3 * kT + il] - jv[4 * kT + jl];
  const bool s = dy * dy + dx * dx < p.thr2;
  if (MODE == kLoss)
    return m * (s ? p.lambda_d * fmaxf(0.0f, p.mp - v) : fmaxf(0.0f, v - p.mn));
  const float gg = g * m * (s ? (p.mp - v > 0.0f ? -p.lambda_d : 0.0f)
                              : (v - p.mn > 0.0f ? 1.0f : 0.0f));
  if (MODE == kTcol) return gg * u;
  const float h = gg * rc - jv[kT + jl] * u;
  if (MODE == kSrow) return h * a;
  return a > 0.0f ? h * rr - iv[kT + il] * a : 0.0f;
}

// grid (tiles, B, column groups of kDc for the gradient modes, else 1)
template <int MODE>
__global__ void __launch_bounds__(kThreads) sweep_kernel(Args p) {
  constexpr bool kRowOwner =
      MODE == kRr || MODE == kLoss || MODE == kSrow || MODE == kDd;
  constexpr bool kGemm = MODE == kDd || MODE == kDwd;
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, dim = p.dim;
  float* ps = smem;              // [dim][kLd] the owned tile, transposed
  float* qs = ps + dim * kLd;    // [dim][kLd] the swept chunk, transposed
  float* es = qs + dim * kLd;    // [kT][kLd] tile of dg as [swept][owned]
  float* iv = es + kT * kLd;     // [4][kT]
  float* jv = iv + 4 * kT;       // [5][kT]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y;
  const int own0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(b) * n * dim;
  const float* pmat = (kRowOwner ? p.d : p.wd) + base;
  const float* qmat = (kRowOwner ? p.wd : p.d) + base;
  const float g = MODE >= kTcol ? *p.g : 0.0f;

  load_tile(ps, pmat, own0, n, dim);
  if (kRowOwner) load_i(iv, p, b, own0); else load_j(jv, p, b, own0);

  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gacc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 8; ++m) gacc[a][m] = 0.0f;
  int kcol[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    kcol[m] = min(static_cast<int>(blockIdx.z) * kDc + tx + 16 * m, dim - 1);

  for (int s0 = 0; s0 < n; s0 += kT) {
    __syncthreads();  // the previous chunk is used up
    load_tile(qs, qmat, s0, n, dim);
    if (kRowOwner) load_j(jv, p, b, s0); else load_i(iv, p, b, s0);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < dim; ++k) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + k * kLd + ty * 4);
      const float4 qb = *reinterpret_cast<const float4*>(qs + k * kLd + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float qv[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pv[a], qv[c], acc[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ol = ty * 4 + a, sl = tx * 4 + c;
        const bool valid = own0 + ol < n && s0 + sl < n;
        const int il = kRowOwner ? ol : sl, jl = kRowOwner ? sl : ol;
        const float e =
            valid ? elem<MODE>(fmaxf(acc[a][c], 0.0f), iv, jv, il, jl, g, p) : 0.0f;
        if (kGemm) acc[a][c] = e; else racc[a] += e;
      }
    }

    if (kGemm) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(es + (tx * 4 + c) * kLd + ty * 4) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        const float4 e4 = *reinterpret_cast<const float4*>(es + s * kLd + ty * 4);
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float q = qs[kcol[m] * kLd + s];
#pragma unroll
          for (int a = 0; a < 4; ++a) gacc[a][m] = fmaf(ev[a], q, gacc[a][m]);
        }
      }
    }
  }

  if constexpr (kGemm) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = own0 + ty * 4 + a;
      if (row >= n) continue;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int col = blockIdx.z * kDc + tx + 16 * m;
        if (col < dim) p.out[base + static_cast<size_t>(row) * dim + col] = gacc[a][m];
      }
    }
  } else {
    // sum over the 16 lanes (tx) that share the owned rows; fixed order
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        racc[a] += __shfl_xor_sync(0xffffffffu, racc[a], o);

    if constexpr (MODE == kLoss) {
      __syncthreads();
      if (tx == 0)
        for (int a = 0; a < 4; ++a) es[ty * 4 + a] = racc[a];
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.0f;
        for (int r = 0; r < kT; ++r) total += es[r];
        p.out[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = total;
      }
    } else if (tx == 0) {
      for (int a = 0; a < 4; ++a) {
        const int ol = ty * 4 + a;
        if (own0 + ol >= n) continue;
        float r = racc[a];
        if (MODE == kRr) r = rsqrtf(r + kEps);
        if (MODE == kTcol) { const float rc = jv[ol]; r *= rc * rc * rc; }
        if (MODE == kSrow) { const float rr = iv[ol]; r *= rr * rr * rr; }
        p.out[static_cast<size_t>(b) * n + own0 + ol] = r;
      }
    }
  }
}

// one block: out[0] = sum of x[0..count), in a fixed order
__global__ void __launch_bounds__(kThreads) sum_kernel(const float* x, int count,
                                                       float* out) {
  __shared__ float part[kThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) s += x[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) part[threadIdx.x] += part[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = part[0];
}

size_t smem_bytes(int dim) {
  return sizeof(float) * (2 * static_cast<size_t>(dim) * kLd + kT * kLd + 9 * kT);
}

template <int MODE>
int launch(const Args& p, int b, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.dim);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.n + kT - 1) / kT;
  const int groups = (MODE == kDd || MODE == kDwd) ? (p.dim + kDc - 1) / kDc : 1;
  sweep_kernel<MODE><<<dim3(tiles, b, groups), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest descriptor width the shared-memory tiles hold.
extern "C" int descriptor_loss_max_dim() {
  return static_cast<int>((227 * 1024 / sizeof(float) - kT * kLd - 9 * kT) / (2 * kLd));
}

// d, wd: (b, n, dim) float32 contiguous; wc: (b, n, 2); ct: (n, 2); mj: (b, n).
// Writes rr, c: (b, n), partial: (b * ceil(n / 64)), loss: (1).
// Returns the first cudaError_t of the launches (0 on success).
extern "C" int descriptor_loss_fwd_launch(
    const float* d, const float* wd, const float* wc, const float* ct,
    const float* mj, float* rr, float* c, float* partial, float* loss, int b,
    int n, int dim, float lambda_d, float mp, float mn, float cell, void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float thr = cell - 0.5f;
  Args p{d, wd, wc, ct, mj, nullptr, nullptr, nullptr, nullptr, nullptr,
         rr, n, dim, lambda_d, mp, mn, thr * thr};
  int err = launch<kRr>(p, b, st);
  if (err) return err;
  p.rr = rr; p.out = c;
  err = launch<kC>(p, b, st);
  if (err) return err;
  p.c = c; p.out = partial;
  err = launch<kLoss>(p, b, st);
  if (err) return err;
  sum_kernel<<<1, kThreads, 0, st>>>(partial, b * ((n + kT - 1) / kT), loss);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus the saved rr, c and the upstream gradient g: (1).
// Writes tcol, srow: (b, n) and dd, dwd: (b, n, dim).
extern "C" int descriptor_loss_bwd_launch(
    const float* d, const float* wd, const float* wc, const float* ct,
    const float* mj, const float* rr, const float* c, const float* g,
    float* tcol, float* srow, float* dd, float* dwd, int b, int n, int dim,
    float lambda_d, float mp, float mn, float cell, void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float thr = cell - 0.5f;
  Args p{d, wd, wc, ct, mj, rr, c, nullptr, nullptr, g,
         tcol, n, dim, lambda_d, mp, mn, thr * thr};
  int err = launch<kTcol>(p, b, st);
  if (err) return err;
  p.tcol = tcol; p.out = srow;
  err = launch<kSrow>(p, b, st);
  if (err) return err;
  p.srow = srow; p.out = dd;
  err = launch<kDd>(p, b, st);
  if (err) return err;
  p.out = dwd;
  return launch<kDwd>(p, b, st);
}
