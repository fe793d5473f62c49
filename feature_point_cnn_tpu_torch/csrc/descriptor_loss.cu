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
// (B, N, D) arrays, under 0.03 ms at 3.35 TB/s for B = 32.  The function
// needs 2 products forward and 4 backward (2 rebuilt, 2 gradient products).
// At float32 accuracy the tensor cores give a product as three TF32 products
// (see below), 495 / 3 = 165 TFLOP/s: 0.14 and 0.29 ms at B = 32.  As float32
// FMAs outside the tensor cores (67 TFLOP/s) it is 0.35 and 0.70 ms.
//
// Design.  The TPU kernel holds a whole wd panel on chip and walks the row
// tiles in order, carrying c_j, T_j and dwd across them.  Here blocks run in
// no order and an SM has 227 KB, so every pass is one "sweep" kernel: a block
// owns one tile of rows of one side (rows i of d, or columns j of wd) of one
// batch item and walks the other side in chunks, rebuilding each tile of
// a_ij from one product.  Whatever crosses tiles is owned by a block of the
// right side, so no sum crosses blocks:
//   forward   rr (row owner), c (column owner), loss (row owner), then one
//             small block adds the per-block partial losses in a fixed order;
//   backward  T (column owner), srow (row owner), dd (row owner, the tile of
//             dg feeds a second product with the wd chunk), dwd (column
//             owner, likewise with the d chunk).
// The (B, N) vectors rr, c, T, srow live in device memory between passes.
// That makes 3 products forward and 6 backward (4 rebuilt dots, 2 gradient
// products), one and two more than the function needs: the price of a row
// statistic that needs a sweep of its own.  There is no atomicAdd: every sum
// has a fixed order, so value and gradients repeat bit for bit.  The ragged
// edge (N need not be a multiple of a tile) is masked or zero-filled.
//
// Operations bound the function, so the products are wgmma.mma_async m64nNk8
// TF32 with float32 accumulators.  One TF32 product keeps ~3 digits, which
// flips the hinge's comparisons and breaks the gradients, so every operand x
// is split, hi = x rounded to TF32 (to nearest), lo = x - hi, and a product is
// lo.hi + hi.lo + hi.hi: float32-grade (the dropped lo.lo is ~2^-22
// relative).  wgmma reads its B operand from shared memory, so the swept
// side is split once per call by a small kernel into hi and lo arrays laid
// out exactly as a stage's tile lies in shared memory (K-major core
// matrices, no swizzle, rows zero-padded to whole chunks): one thread brings
// a 64-row chunk's two tiles with two bulk asynchronous copies
// (cp.async.bulk) that complete on an mbarrier, while the block multiplies
// the chunk before.  (16-byte cp.async from all threads did not overlap: the
// warps spent that time handing the copies over.)  The A operand is the owned
// side, from registers: a block of two warpgroups owns 128 rows in shared
// memory at a pitch of D + 4 floats (conflict-free fragment loads), a warp
// splits its 16 rows' fragment of a k-step in registers, and the next
// k-step's fragment is split while this one's three wgmmas run.  A
// warpgroup's a tile is 64 x 64: 32 accumulators a thread, in the layout of
// mma.sync's C fragments.  Row statistics are sums over a thread's own
// accumulators and a 4-lane shuffle.  Launches: a call splits d and wd (1
// launch forward, 2 backward with the transposed copies), then forward 3
// sweeps and the sum (5 in all), backward 4 sweeps (6 in all).
//   The gradient sweeps keep the dg tile in registers: the accumulators of
// n-tile ks are the A fragment of k-step ks of the second product once the
// k index is permuted (slot t holds swept row 2t, slot t + 4 row 2t + 1), and
// the B operand is the chunk transposed (columns x rows, K-major again), made
// by the split kernel in that same permuted order.  A chunk is then two
// pairs of tiles, each single-buffered: the next K-major pair is copied
// while the gradient product runs, the next transposed pair while the a tile
// is rebuilt.  The tensor cores' adder truncates, so each chunk's piece of
// dd or dwd (64 x 128 a warpgroup) is summed from zero and added to the
// running sum in float32 outside them; summed in place over all N / 8
// k-steps the error was 20 times larger.  The order of the two small terms
// follows d and wd, not A and B, so a_ij has the same bits in a row-owner
// and a column-owner sweep.
//   Shapes: any N >= 1 (the ragged edge is masked); D a multiple of 8 (a
// k-step) up to 128, the columns of dd or dwd that a warp's accumulators
// hold.  The caller zero-pads other D up to the next multiple of 8: the
// tile copies here stay free of branches on D, which keeps the wgmma
// descriptors in uniform registers (with such branches in the kernels'
// prologue the compiler moved them to vector registers and every sweep ran
// 5% slower at D = 128).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-12f;

enum Mode { kRr, kC, kLoss, kTcol, kSrow, kDd, kDwd };

__host__ __device__ constexpr bool row_owner(int mode) {
  return mode == kRr || mode == kLoss || mode == kSrow || mode == kDd;
}
__host__ __device__ constexpr bool gradient_product(int mode) {
  return mode == kDd || mode == kDwd;
}

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
  // set by launch_split: d and wd split into hi + lo ...
  const float* d_hi = nullptr;
  const float* d_lo = nullptr;
  const float* wd_hi = nullptr;
  const float* wd_lo = nullptr;
  // ... and the same transposed by chunks, for the gradient products
  const float* d_hit = nullptr;
  const float* d_lot = nullptr;
  const float* wd_hit = nullptr;
  const float* wd_lot = nullptr;
};

// What a pair's term needs of its row i and of its column j.
struct ISide { float rr, srow, y, x; };
struct JSide { float rc, tcol, m, y, x; };

__device__ __forceinline__ ISide read_i(const Args& p, int b, int i) {
  if (i >= p.n) return ISide{0.0f, 0.0f, 0.0f, 0.0f};
  const size_t o = static_cast<size_t>(b) * p.n + i;
  return ISide{p.rr ? p.rr[o] : 0.0f, p.srow ? p.srow[o] : 0.0f, p.wc[o * 2],
               p.wc[o * 2 + 1]};
}

__device__ __forceinline__ JSide read_j(const Args& p, int b, int j) {
  if (j >= p.n) return JSide{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const size_t o = static_cast<size_t>(b) * p.n + j;
  return JSide{p.c ? rsqrtf(p.c[o] + kEps) : 0.0f, p.tcol ? p.tcol[o] : 0.0f, p.mj[o],
               p.ct[static_cast<size_t>(j) * 2], p.ct[static_cast<size_t>(j) * 2 + 1]};
}

// One side's values for COUNT rows in shared memory, field by field:
// v[f * COUNT + r]
template <int COUNT>
__device__ __forceinline__ void put_i(float* v, int r, const ISide& s) {
  v[r] = s.rr; v[COUNT + r] = s.srow; v[2 * COUNT + r] = s.y; v[3 * COUNT + r] = s.x;
}

template <int COUNT>
__device__ __forceinline__ void put_j(float* v, int r, const JSide& s) {
  v[r] = s.rc; v[COUNT + r] = s.tcol; v[2 * COUNT + r] = s.m;
  v[3 * COUNT + r] = s.y; v[4 * COUNT + r] = s.x;
}

template <int COUNT>
__device__ __forceinline__ void load_i(float* v, const Args& p, int b, int row0) {
  if (threadIdx.x < COUNT) put_i<COUNT>(v, threadIdx.x, read_i(p, b, row0 + threadIdx.x));
}

template <int COUNT>
__device__ __forceinline__ void load_j(float* v, const Args& p, int b, int row0) {
  if (threadIdx.x < COUNT) put_j<COUNT>(v, threadIdx.x, read_j(p, b, row0 + threadIdx.x));
}

template <int COUNT>
__device__ __forceinline__ ISide get_i(const float* v, int r) {
  return ISide{v[r], v[COUNT + r], v[2 * COUNT + r], v[3 * COUNT + r]};
}

template <int COUNT>
__device__ __forceinline__ JSide get_j(const float* v, int r) {
  return JSide{v[r], v[COUNT + r], v[2 * COUNT + r], v[3 * COUNT + r], v[4 * COUNT + r]};
}

// One pair's term of MODE from a = relu(d_i . wd_j).
template <int MODE>
__device__ __forceinline__ float elem(float a, const ISide& i, const JSide& j, float g,
                                      const Args& p) {
  if (MODE == kRr) return a * a;
  const float u = a * i.rr;
  if (MODE == kC) return u * u;
  const float v = u * j.rc;
  const float dy = i.y - j.y;
  const float dx = i.x - j.x;
  const bool s = dy * dy + dx * dx < p.thr2;
  if (MODE == kLoss)
    return j.m * (s ? p.lambda_d * fmaxf(0.0f, p.mp - v) : fmaxf(0.0f, v - p.mn));
  const float gg = g * j.m * (s ? (p.mp - v > 0.0f ? -p.lambda_d : 0.0f)
                                : (v - p.mn > 0.0f ? 1.0f : 0.0f));
  if (MODE == kTcol) return gg * u;
  const float h = gg * j.rc - j.tcol * u;
  if (MODE == kSrow) return h * a;
  return a > 0.0f ? h * i.rr - i.srow * a : 0.0f;
}

// What an owner block writes for one of its rows from the row's sum; own0 is
// the row's rr (row owner) or rc (column owner).
template <int MODE>
__device__ __forceinline__ float row_result(float r, float own0) {
  if (MODE == kRr) return rsqrtf(r + kEps);
  if (MODE == kTcol || MODE == kSrow) return r * own0 * own0 * own0;  // rc^3, rr^3
  return r;
}

// ---- the products: tensor cores (wgmma), 3 x TF32 ---------------------------

constexpr int kOwn = 128;            // rows a block owns: 64 a warpgroup, 16 a warp
constexpr int kChunk = 64;           // rows of the other side in a stage: wgmma's N
constexpr int kStages = 2;           // a chunk's stage and barrier parity are c & 1, c >> 1
constexpr int kThreads = 256;        // two warpgroups
constexpr int kNt = kChunk / 8;      // n-tiles (of 8 swept rows) of the a tile
constexpr int kMaxDim = 128;         // columns of dd, dwd a warp accumulates

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

// rows [row0, row0 + ROWS) of a (n, dim) matrix -> s[r * ld + k], zero past n
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* s, const float* m, int row0,
                                          int n, int dim, int ld) {
  const int per_row = dim >> 2;
  for (int idx = threadIdx.x; idx < ROWS * per_row; idx += kThreads) {
    const int r = idx / per_row, q = idx - r * per_row;
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(s + r * ld + 4 * q,
               m + static_cast<size_t>(ok ? row : 0) * dim + 4 * q, ok);
  }
}

// x = hi + lo with hi = x rounded to TF32's 11 significant bits, to nearest
// (Veltkamp's split: three float32 operations at full rate, where
// cvt.rna.tf32.f32 is a quarter-rate conversion), and lo = x - hi, exact in
// float32.  The tensor core reads the upper 19 bits of each.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// hi and lo of x (see split), written as wgmma's K-major operand
// without swizzle: 8-row x 16-byte core matrices of 128 contiguous bytes, the
// next 4 k 128 bytes on, the next 8 rows dim * 32 bytes on.  Rows are padded
// with zeros to npad, a multiple of kChunk, so the kChunk rows from row
// kChunk c of item b are one contiguous block of kChunk * dim floats at
// (b * npad + kChunk c) * dim: one bulk copy brings a stage's tile.  A warp's
// 32 pieces are 8 rows x 64 bytes: whole sectors read, whole lines written.
// grid (pieces, 2): y = 0 splits x0 into out[0], out[1] (hi, lo), y = 1 x1 into
// out[2], out[3], each of b * npad * dim floats
__global__ void __launch_bounds__(256) split_kernel(const float* x0, const float* x1,
                                                    float* out, int b, int n, int npad,
                                                    int dim) {
  const float* x = blockIdx.y ? x1 : x0;
  const size_t count = static_cast<size_t>(b) * npad * dim;
  float* hi = out + 2 * blockIdx.y * count;
  float* lo = hi + count;
  const int kqs = dim >> 2;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(b) * npad * kqs) return;
  const int r8 = static_cast<int>(idx & 7);
  const size_t rest = idx >> 3;
  const int kq = static_cast<int>(rest % kqs);
  const size_t rg = rest / kqs;                 // 8-row group, over all items
  const int item = static_cast<int>(rg / (npad >> 3));
  const int row = static_cast<int>(rg % (npad >> 3)) * 8 + r8;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < n)
    v = *reinterpret_cast<const float4*>(x + (static_cast<size_t>(item) * n + row) * dim +
                                         kq * 4);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  const size_t o = rg * dim * 8 + kq * 32 + r8 * 4;
  *reinterpret_cast<float4*>(hi + o) = make_float4(
      __uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + o) = make_float4(
      __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

// one arrival that expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16) from global to shared memory, completion on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// The descriptor of a tile's first k-step, a tile of `k` floats a row: the
// next 4 k are 128 bytes on, the next 8 rows k * 32 bytes; k-step ks is 256
// bytes on.
__device__ __forceinline__ uint64_t core_desc(const float* tile, int k) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((k * 32) >> 4) << 32);
}
constexpr uint64_t kDescStep = 256 >> 4;

// d (64 x N of the warpgroup, this warp's 16 rows) += A (registers) B (shared),
// N = 64 and N = 128
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One k-step of a product at float32 grade: the warp's A fragment (a0: row g,
// slot t; a1: row g + 8; a2, a3: slot t + 4) is split in registers, the
// chunk's hi and lo tiles are read by the tensor cores.
template <bool SWAP, int NT>
__device__ __forceinline__ void k_step(float (&acc)[NT][4], float a0, float a1, float a2,
                                       float a3, uint64_t dh, uint64_t dl,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(a0, ah[0], al[0]);
  split(a1, ah[1], al[1]);
  split(a2, ah[2], al[2]);
  split(a3, ah[3], al[3]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (SWAP) {
    wgmma_tf32(acc, ah, dl);
    wgmma_tf32(acc, al, dh);
  } else {
    wgmma_tf32(acc, al, dh);
    wgmma_tf32(acc, ah, dl);
  }
  wgmma_tf32(acc, ah, dh);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  // the k-step before this one is done: its A registers are free again
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// acc = the warp's 16 owned rows (arow: row g, column t of the owned tile,
// pitch ld) times the chunk whose hi tile is at q and lo tile kChunk * dim on
template <bool SWAP>
__device__ __forceinline__ void a_tile(float (&acc)[kNt][4], const float* arow, int ld,
                                       const float* q, int dim) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  uint64_t dh = core_desc(q, dim), dl = core_desc(q + kChunk * dim, dim);
  uint32_t ah0[4], al0[4], ah1[4], al1[4];
  for (int k0 = 0; k0 < dim; k0 += 16) {
    const float* a = arow + k0;
    k_step<SWAP>(acc, a[0], a[8 * ld], a[4], a[8 * ld + 4], dh, dl, ah0, al0);
    if (k0 + 8 < dim)
      k_step<SWAP>(acc, a[8], a[8 * ld + 8], a[12], a[8 * ld + 12], dh + kDescStep,
                   dl + kDescStep, ah1, al1);
    dh += 2 * kDescStep;
    dl += 2 * kDescStep;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(acc[nt][r])::"memory");
}

size_t smem_floats(int dim) {
  return static_cast<size_t>(kStages) * 2 * kChunk * dim + static_cast<size_t>(kOwn) * (dim + 4) +
         kStages * 5 * kChunk + kOwn + 2 * kStages;   // barriers: 8 bytes each
}

// grid (tiles of kOwn, B); p.d_hi .. p.wd_lo hold the split operands
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) wgmma_sweep_kernel(Args p) {
  static_assert(!gradient_product(MODE), "the gradient sweeps are wgmma_grad_kernel's");
  constexpr bool kRowOwner = row_owner(MODE);
  extern __shared__ __align__(128) float smem[];
  const int n = p.n, dim = p.dim, ld = dim + 4;
  float* stage = smem;                            // [kStages][hi, lo][kChunk * dim]
  float* own = stage + kStages * 2 * kChunk * dim;  // [kOwn][ld]
  float* sv = own + kOwn * ld;                    // [kStages][5][kChunk]
  float* red = sv + kStages * 5 * kChunk;         // [kOwn]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + kOwn);   // [kStages]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp * 16;                    // the warp's first owned row
  const int b = blockIdx.y;
  const int own0 = blockIdx.x * kOwn;
  const int chunks = (n + kChunk - 1) / kChunk;
  const float* pmat = (kRowOwner ? p.d : p.wd) + static_cast<size_t>(b) * n * dim;
  const size_t tiled = static_cast<size_t>(b) * chunks * kChunk * dim;
  const float* qhi = (kRowOwner ? p.wd_hi : p.d_hi) + tiled;
  const float* qlo = (kRowOwner ? p.wd_lo : p.d_lo) + tiled;
  const float gup = MODE >= kTcol ? *p.g : 0.0f;
  const uint32_t tile_bytes = kChunk * dim * sizeof(float);

  // one thread asks for a chunk's hi and lo tiles; they land on bar[stage]
  auto fetch = [&](int c) {
    float* dst = stage + (c & 1) * 2 * kChunk * dim;
    mbar_expect(bar + (c & 1), 2 * tile_bytes);
    bulk_copy(dst, qhi + static_cast<size_t>(c) * kChunk * dim, tile_bytes, bar + (c & 1));
    bulk_copy(dst + kChunk * dim, qlo + static_cast<size_t>(c) * kChunk * dim, tile_bytes,
              bar + (c & 1));
  };

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_rows<kOwn>(own, pmat, own0, n, dim, ld);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (kRowOwner) load_j<kChunk>(sv, p, b, 0); else load_i<kChunk>(sv, p, b, 0);

  ISide oi[2] = {};
  JSide oj[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = own0 + strip + g + 8 * h;
    if (kRowOwner) oi[h] = read_i(p, b, row); else oj[h] = read_j(p, b, row);
  }
  float racc[2] = {0.0f, 0.0f};
  const float* arow = own + (strip + g) * ld + t;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                                 // barriers and the owned tile are set
  if (threadIdx.x == 0) fetch(0);

  for (int c = 0; c < chunks; ++c) {
    // every warp is done with chunk c - 1: its stage takes chunk c + 1 while
    // chunk c is multiplied
    if (c > 0) __syncthreads();
    if (threadIdx.x == 0 && c + 1 < chunks) fetch(c + 1);
    ISide ni = {};
    JSide nj = {};
    if (c + 1 < chunks && threadIdx.x < kChunk) {
      if (kRowOwner) nj = read_j(p, b, (c + 1) * kChunk + threadIdx.x);
      else ni = read_i(p, b, (c + 1) * kChunk + threadIdx.x);
    }
    mbar_wait(bar + (c & 1), (c >> 1) & 1);
    const float* q = stage + (c & 1) * 2 * kChunk * dim;
    const float* svc = sv + (c & 1) * 5 * kChunk;
    const int s0 = c * kChunk;

    float acc[kNt][4];
    a_tile<!kRowOwner>(acc, arow, ld, q, dim);

    // accumulator r of n-tile nt: owned row strip + g + 8 (r / 2), swept row
    // s0 + 8 nt + 2 t + r % 2
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int sl = nt * 8 + 2 * t;
      ISide si[2] = {};
      JSide sj[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kRowOwner) sj[e] = get_j<kChunk>(svc, sl + e);
        else si[e] = get_i<kChunk>(svc, sl + e);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1, e = r & 1;
        const bool valid = own0 + strip + g + 8 * h < n && s0 + sl + e < n;
        const float a = fmaxf(acc[nt][r], 0.0f);
        const float x = kRowOwner ? elem<MODE>(a, oi[h], sj[e], gup, p)
                                  : elem<MODE>(a, si[e], oj[h], gup, p);
        racc[h] += valid ? x : 0.0f;
      }
    }
    if (c + 1 < chunks && threadIdx.x < kChunk) {
      float* nv = sv + ((c + 1) & 1) * 5 * kChunk;
      if (kRowOwner) put_j<kChunk>(nv, threadIdx.x, nj); else put_i<kChunk>(nv, threadIdx.x, ni);
    }
  }

  // a row's sum: the 4 lanes t of a group, in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    racc[h] += __shfl_xor_sync(0xffffffffu, racc[h], 1);
    racc[h] += __shfl_xor_sync(0xffffffffu, racc[h], 2);
  }
  if constexpr (MODE == kLoss) {
    if (t == 0) {
      red[strip + g] = racc[0];
      red[strip + g + 8] = racc[1];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int r = 0; r < kOwn; ++r) total += red[r];
      p.out[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = total;
    }
  } else if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ol = strip + g + 8 * h;
      if (own0 + ol < n)
        p.out[static_cast<size_t>(b) * n + own0 + ol] =
            row_result<MODE>(racc[h], kRowOwner ? oi[h].rr : oj[h].rc);
    }
  }
}

template <int MODE>
int launch_sweep(const Args& p, int b, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p.dim);
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.n + kOwn - 1) / kOwn;
  wgmma_sweep_kernel<MODE><<<dim3(tiles, b), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the two gradient sweeps ------------------------------------------------

constexpr int kCols = kMaxDim;       // rows of a transposed tile: the columns of dd, dwd
constexpr int kCt = kCols / 8;

// hi and lo of x transposed, for the gradient products: per item and chunk a
// tile of kCols rows (the columns of x, zero from dim on) x kChunk k-slots
// (the chunk's rows of x, zero from n on), in the layout of split_kernel.
// Within each 8 slots, slot t holds row 2t and slot t + 4 row 2t + 1: the
// order in which a thread's accumulators of the dg tile become its A fragment.
// grid (pieces, 2) as split_kernel, each part of b * chunks * kCols * kChunk
// floats
__global__ void __launch_bounds__(256) split_transposed_kernel(const float* x0,
                                                               const float* x1, float* out,
                                                               int b, int n, int dim) {
  const int chunks = (n + kChunk - 1) / kChunk;
  const float* x = blockIdx.y ? x1 : x0;
  const size_t count = static_cast<size_t>(b) * chunks * kCols * kChunk;
  float* hi = out + 2 * blockIdx.y * count;
  float* lo = hi + count;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(b) * chunks * (kChunk / 4) * kCols) return;
  const int col = static_cast<int>(idx % kCols);
  const int kq = static_cast<int>((idx / kCols) % (kChunk / 4));   // 4 slots
  const size_t tile = idx / (kCols * (kChunk / 4));                // item * chunks + chunk
  const int item = static_cast<int>(tile / chunks);
  const int row0 = static_cast<int>(tile % chunks) * kChunk + (kq >> 1) * 8;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int slot = (kq & 1) * 4 + e;                // within the k-step's 8
    const int row = row0 + (slot < 4 ? 2 * slot : 2 * (slot - 4) + 1);
    v[e] = row < n && col < dim ? x[(static_cast<size_t>(item) * n + row) * dim + col] : 0.0f;
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], h[e], l[e]);
  const size_t o = tile * kCols * kChunk + (col >> 3) * (kChunk * 8) + kq * 32 + (col & 7) * 4;
  *reinterpret_cast<float4*>(hi + o) = make_float4(
      __uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + o) = make_float4(
      __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

size_t grad_smem_floats(int dim) {
  return 2 * static_cast<size_t>(kChunk) * dim + 2 * kCols * kChunk +
         static_cast<size_t>(kOwn) * (dim + 4) + 2 * 5 * kChunk + 4;   // 2 barriers
}

// grid (tiles of kOwn, B).  A chunk is two tiles pairs, each in one buffer:
// the K-major pair feeds the a tile, the transposed pair the gradient
// product, and each pair's next copy runs while the other is multiplied.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) wgmma_grad_kernel(Args p) {
  static_assert(gradient_product(MODE), "the other sweeps are wgmma_sweep_kernel's");
  constexpr bool kRowOwner = row_owner(MODE);
  extern __shared__ __align__(128) float smem[];
  const int n = p.n, dim = p.dim, ld = dim + 4;
  float* ktile = smem;                            // [hi, lo][kChunk * dim]
  float* ttile = ktile + 2 * kChunk * dim;        // [hi, lo][kCols * kChunk]
  float* own = ttile + 2 * kCols * kChunk;        // [kOwn][ld]
  float* sv = own + kOwn * ld;                    // [2][5][kChunk]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 2 * 5 * kChunk);   // K, T

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp * 16;
  const int b = blockIdx.y;
  const int own0 = blockIdx.x * kOwn;
  const int chunks = (n + kChunk - 1) / kChunk;
  const size_t base = static_cast<size_t>(b) * n * dim;
  const float* pmat = (kRowOwner ? p.d : p.wd) + base;
  const size_t tiled = static_cast<size_t>(b) * chunks * kChunk * dim;
  const float* qhi = (kRowOwner ? p.wd_hi : p.d_hi) + tiled;
  const float* qlo = (kRowOwner ? p.wd_lo : p.d_lo) + tiled;
  const size_t ttiled = static_cast<size_t>(b) * chunks * kCols * kChunk;
  const float* thi = (kRowOwner ? p.wd_hit : p.d_hit) + ttiled;
  const float* tlo = (kRowOwner ? p.wd_lot : p.d_lot) + ttiled;
  const float gup = *p.g;
  const uint32_t k_bytes = kChunk * dim * sizeof(float);
  const uint32_t t_bytes = kCols * kChunk * sizeof(float);

  auto fetch_k = [&](int c) {
    mbar_expect(bar, 2 * k_bytes);
    bulk_copy(ktile, qhi + static_cast<size_t>(c) * kChunk * dim, k_bytes, bar);
    bulk_copy(ktile + kChunk * dim, qlo + static_cast<size_t>(c) * kChunk * dim, k_bytes, bar);
  };
  auto fetch_t = [&](int c) {
    mbar_expect(bar + 1, 2 * t_bytes);
    bulk_copy(ttile, thi + static_cast<size_t>(c) * kCols * kChunk, t_bytes, bar + 1);
    bulk_copy(ttile + kCols * kChunk, tlo + static_cast<size_t>(c) * kCols * kChunk, t_bytes,
              bar + 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_rows<kOwn>(own, pmat, own0, n, dim, ld);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (kRowOwner) load_j<kChunk>(sv, p, b, 0); else load_i<kChunk>(sv, p, b, 0);

  ISide oi[2] = {};
  JSide oj[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = own0 + strip + g + 8 * h;
    if (kRowOwner) oi[h] = read_i(p, b, row); else oj[h] = read_j(p, b, row);
  }
  float gacc[kCt][4];
#pragma unroll
  for (int ct = 0; ct < kCt; ++ct)
#pragma unroll
    for (int r = 0; r < 4; ++r) gacc[ct][r] = 0.0f;
  const float* arow = own + (strip + g) * ld + t;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                                 // barriers and the owned tile are set
  if (threadIdx.x == 0) {
    fetch_k(0);
    fetch_t(0);
  }

  for (int c = 0; c < chunks; ++c) {
    ISide ni = {};
    JSide nj = {};
    if (c + 1 < chunks && threadIdx.x < kChunk) {
      if (kRowOwner) nj = read_j(p, b, (c + 1) * kChunk + threadIdx.x);
      else ni = read_i(p, b, (c + 1) * kChunk + threadIdx.x);
    }
    const float* svc = sv + (c & 1) * 5 * kChunk;
    const int s0 = c * kChunk;

    mbar_wait(bar, c & 1);
    float acc[kNt][4];
    a_tile<!kRowOwner>(acc, arow, ld, ktile, dim);
    __syncthreads();                               // the K-major pair is used up
    if (threadIdx.x == 0 && c + 1 < chunks) fetch_k(c + 1);

    // the dg tile, in place: accumulator r of n-tile nt is owned row
    // strip + g + 8 (r / 2), swept row s0 + 8 nt + 2 t + r % 2
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int sl = nt * 8 + 2 * t;
      ISide si[2] = {};
      JSide sj[2] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kRowOwner) sj[e] = get_j<kChunk>(svc, sl + e);
        else si[e] = get_i<kChunk>(svc, sl + e);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1, e = r & 1;
        const bool valid = own0 + strip + g + 8 * h < n && s0 + sl + e < n;
        const float a = fmaxf(acc[nt][r], 0.0f);
        const float x = kRowOwner ? elem<MODE>(a, oi[h], sj[e], gup, p)
                                  : elem<MODE>(a, si[e], oj[h], gup, p);
        acc[nt][r] = valid ? x : 0.0f;
      }
    }

    // gradient product: the dg tile (16 x 64 a warp) times the chunk (64 x
    // D), read transposed.  k-step ks takes n-tile ks of dg as its A
    // fragment: slot t = swept row 2t, slot t + 4 = swept row 2t + 1, the
    // order split_transposed_kernel stores.  Each chunk's piece is summed
    // from zero on the tensor cores, whose adder truncates, and added to the
    // running sum in float32 outside them: over N / 8 k-steps the truncation
    // would otherwise add up.
    mbar_wait(bar + 1, c & 1);
    float tmp[kCt][4];
#pragma unroll
    for (int ct = 0; ct < kCt; ++ct)
#pragma unroll
      for (int r = 0; r < 4; ++r) tmp[ct][r] = 0.0f;
    const uint64_t th = core_desc(ttile, kChunk), tl = core_desc(ttile + kCols * kChunk, kChunk);
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
#pragma unroll
    for (int ks = 0; ks < kNt; ks += 2) {
      k_step<false>(tmp, acc[ks][0], acc[ks][2], acc[ks][1], acc[ks][3], th + ks * kDescStep,
                    tl + ks * kDescStep, ah0, al0);
      k_step<false>(tmp, acc[ks + 1][0], acc[ks + 1][2], acc[ks + 1][1], acc[ks + 1][3],
                    th + (ks + 1) * kDescStep, tl + (ks + 1) * kDescStep, ah1, al1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int ct = 0; ct < kCt; ++ct)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        asm volatile("" : "+f"(tmp[ct][r])::"memory");
        gacc[ct][r] += tmp[ct][r];
      }

    if (c + 1 < chunks && threadIdx.x < kChunk) {
      float* nv = sv + ((c + 1) & 1) * 5 * kChunk;
      if (kRowOwner) put_j<kChunk>(nv, threadIdx.x, nj); else put_i<kChunk>(nv, threadIdx.x, ni);
    }
    __syncthreads();                               // the transposed pair is used up
    if (threadIdx.x == 0 && c + 1 < chunks) fetch_t(c + 1);
  }

  const int r0 = own0 + strip + g, r1 = r0 + 8;
#pragma unroll
  for (int ct = 0; ct < kCt; ++ct) {
    const int col = ct * 8 + 2 * t;
    if (col >= dim) continue;
    if (r0 < n)
      *reinterpret_cast<float2*>(p.out + base + static_cast<size_t>(r0) * dim + col) =
          make_float2(gacc[ct][0], gacc[ct][1]);
    if (r1 < n)
      *reinterpret_cast<float2*>(p.out + base + static_cast<size_t>(r1) * dim + col) =
          make_float2(gacc[ct][2], gacc[ct][3]);
  }
}

template <int MODE>
int launch_grad(const Args& p, int b, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * grad_smem_floats(p.dim);
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_grad_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.n + kOwn - 1) / kOwn;
  wgmma_grad_kernel<MODE><<<dim3(tiles, b), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// scratch <- hi, lo of d, then hi, lo of wd, as split_kernel lays them out
// (4 x b * npad * dim floats) and, with `transposed`, as
// split_transposed_kernel does (4 x b * chunks * kCols * kChunk more); sets
// p's pointers
int launch_split(Args& p, float* scratch, int b, bool transposed, cudaStream_t stream) {
  const int chunks = (p.n + kChunk - 1) / kChunk;
  const int npad = chunks * kChunk;
  const size_t count = static_cast<size_t>(b) * npad * p.dim;
  p.d_hi = scratch;
  p.d_lo = scratch + count;
  p.wd_hi = scratch + 2 * count;
  p.wd_lo = scratch + 3 * count;
  const unsigned blocks = static_cast<unsigned>((count / 4 + 255) / 256);
  split_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(p.d, p.wd, scratch, b, p.n, npad, p.dim);
  const int err = static_cast<int>(cudaGetLastError());
  if (err || !transposed) return err;
  float* ts = scratch + 4 * count;
  const size_t tcount = static_cast<size_t>(b) * chunks * kCols * kChunk;
  p.d_hit = ts;
  p.d_lot = ts + tcount;
  p.wd_hit = ts + 2 * tcount;
  p.wd_lot = ts + 3 * tcount;
  const unsigned tblocks = static_cast<unsigned>((tcount / 4 + 255) / 256);
  split_transposed_kernel<<<dim3(tblocks, 2), 256, 0, stream>>>(p.d, p.wd, ts, b, p.n, p.dim);
  return static_cast<int>(cudaGetLastError());
}

// one block: out[0] = sum of x[0..count), in a fixed order
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads) sum_kernel(const float* x, int count,
                                                          float* out) {
  __shared__ float part[kSumThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += kSumThreads) s += x[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = kSumThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) part[threadIdx.x] += part[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = part[0];
}

bool takes(int b, int n, int dim) {
  return b > 0 && n > 0 && dim > 0 && dim % 8 == 0 && dim <= kMaxDim;
}

template <int MODE>
int launch(const Args& p, int b, cudaStream_t stream) {
  if constexpr (gradient_product(MODE)) return launch_grad<MODE>(p, b, stream);
  else return launch_sweep<MODE>(p, b, stream);
}

}  // namespace

// The largest descriptor width the kernels take.
extern "C" int descriptor_loss_max_dim() { return kMaxDim; }

// d, wd: (b, n, dim) float32 contiguous, 16-byte aligned, dim a multiple of 8
// up to descriptor_loss_max_dim(); wc: (b, n, 2);
// ct: (n, 2); mj: (b, n); scratch: what launch_split asks for.
// Writes rr, c: (b, n), partial: (b * ceil(n / kOwn)), loss: (1).
// Returns the first cudaError_t of the launches (0 on success).
extern "C" int descriptor_loss_fwd_launch(
    const float* d, const float* wd, const float* wc, const float* ct,
    const float* mj, float* rr, float* c, float* partial, float* loss,
    float* scratch, int b, int n, int dim, float lambda_d, float mp, float mn,
    float cell, void* stream) {
  if (!takes(b, n, dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float thr = cell - 0.5f;
  Args p{d, wd, wc, ct, mj, nullptr, nullptr, nullptr, nullptr, nullptr,
         rr, n, dim, lambda_d, mp, mn, thr * thr};
  int err = launch_split(p, scratch, b, false, st);
  if (err) return err;
  err = launch<kRr>(p, b, st);
  if (err) return err;
  p.rr = rr; p.out = c;
  err = launch<kC>(p, b, st);
  if (err) return err;
  p.c = c; p.out = partial;
  err = launch<kLoss>(p, b, st);
  if (err) return err;
  sum_kernel<<<1, kSumThreads, 0, st>>>(partial, b * ((n + kOwn - 1) / kOwn), loss);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus the saved rr, c and the upstream gradient g: (1).
// Writes tcol, srow: (b, n) and dd, dwd: (b, n, dim).
extern "C" int descriptor_loss_bwd_launch(
    const float* d, const float* wd, const float* wc, const float* ct,
    const float* mj, const float* rr, const float* c, const float* g,
    float* tcol, float* srow, float* dd, float* dwd, float* scratch, int b,
    int n, int dim, float lambda_d, float mp, float mn, float cell,
    void* stream) {
  if (!takes(b, n, dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float thr = cell - 0.5f;
  Args p{d, wd, wc, ct, mj, rr, c, nullptr, nullptr, g,
         tcol, n, dim, lambda_d, mp, mn, thr * thr};
  int err = launch_split(p, scratch, b, true, st);
  if (err) return err;
  err = launch<kTcol>(p, b, st);
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
