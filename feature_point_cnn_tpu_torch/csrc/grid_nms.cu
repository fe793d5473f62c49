// Exact-greedy grid NMS for Hopper (sm_90a): one launch a call, the whole
// convergence loop on the device, each frame held by one thread-block
// cluster.
//
// Replaces the TPU kernel feature_point_cnn_tpu/ops/pallas/nms.py:
// grid_nms_pallas (_nms_kernel, _maxpool2d, _running_max_axis).  Greedy NMS
// as iterated window-max suppression on the strict priority key of
// ops/detection.py:nms_priority_key: each round keeps every remaining
// candidate that is the maximum of its (2r+1)^2 window, then zeroes the
// windows of the kept points, until no candidate is left (capped at H*W
// rounds).  Output: the kept scores, 0 elsewhere; and each frame's rounds.
//
// Bound on an H100 SXM: bytes, for the function.  A 480x640 frame reads
// 1.23 MB of scores and writes 1.23 MB, about 0.73 us at 3.35 TB/s; the
// window maxima cost 2 * 2 * 2r comparisons per pixel per round, some
// 0.7 us per frame over 3 rounds at 67 TFLOP/s of float32.  What holds
// this kernel back is instruction issue on the 8 SMs of a frame's cluster.
//
// Design.  The TPU kernel pins the frame in VMEM and runs its while_loop on
// chip.  Here a cluster of C CTAs (C = 8, the portable limit, fewer for maps
// under 8 * max(r, 1) rows) owns a frame: CTA k holds rows
// [k*H/C, (k+1)*H/C) in its shared memory as 4 bytes of remaining key and 1
// byte of flags a pixel (192,000 B a CTA at 480x640).  A round is
//   winners:  key > 0 && key == window max of key    -> flags = kept | round
//   cluster barrier
//   suppress: key = 0 where the window holds a winner of this round
//   cluster barrier, then "any candidate left" reduced over the cluster
// The r halo rows above and below a band are read straight from the
// neighbouring CTAs' shared memory (distributed shared memory, generic
// pointers from map_shared_rank); every band is at least r rows tall, so a
// halo never reaches past the next CTA.  The barriers (release / acquire at
// cluster scope) order each pass's writes before the next pass's reads, and
// a last barrier keeps every CTA's shared memory alive until the others are
// done with it.  A winner's flags carry the round mod 128; a tag seen again
// 128 rounds on marks a window zeroed when it won, so it zeroes nothing.
//
// Activity.  Beside the state each CTA keeps two bytes a (row, 128-column
// strip): whether it holds candidates, and winners of this round, each with
// a bit for the strip's first and last 8 columns (the window reaches no
// further into a neighbouring strip).  A pass only touches what they name.
//
// Window max, two ways; a pass picks one from the number of (row, strip)
// pairs that hold candidates (`kDirectMax`):
// - ring (dense passes): a warp takes a strip (4 consecutive columns a
//   lane) and a chunk of ~20 rows and walks down it.  Per row it loads each
//   value once, takes the horizontal max from its own 4 values and the
//   neighbouring lanes' (shuffles; lanes at the strip's edge load the
//   groups beyond it), and pushes the row into a register ring of 2r+1 rows
//   whose window max comes by van Herk / Gil-Werman: about 3 max a column a
//   row instead of 2r.  Rows without activity push zeros without a load.
//   Shared memory is read once per pixel and pass, not 2r+1 times per axis:
//   at 60x640 a band the naive reread would move 144 B a pixel a round
//   through shared memory, some 5.5 MB a CTA a round, ~25 us at 128 B a
//   clock, 30 times the frame's HBM bound.
// - direct (sparse passes, most rounds after the first): the CTA lists the
//   (row, strip) pairs with candidates and its warps take them in turn,
//   each the horizontal max of the active rows of its window only.
//
// Maps larger than the cluster's shared memory (above ~370 K pixels a frame
// at C = 8, i.e. 232,448 B a CTA at 5 B a pixel) keep their state in a
// device-memory scratch that the wrapper allocates instead; the same code
// reads it through the same generic pointers, and the same cluster
// barriers order the accesses.
//
// Float == and max are exact and the build keeps denormals (no fast math),
// so the kept set equals the plain PyTorch version's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;             // consecutive columns a lane holds
constexpr int kStrip = 32 * kGroup;   // columns a warp covers
constexpr int kMaxCluster = 8;        // portable cluster size
constexpr int kSmemLimit = 232448;    // dynamic shared memory a CTA may use
constexpr int kSmemReserve = 64;      // convergence slot, list count, mbarrier
constexpr int kCopyPiece = 1 << 16;   // bytes a bulk copy moves at most
constexpr int kDirectMax = 128;       // listed (row, strip) pairs a direct pass takes
constexpr unsigned char kKept = 0x80; // flags: kept; low 7 bits: round won
constexpr unsigned char kAny = 1, kFirst = 2, kLast = 4;   // activity bits

__host__ __device__ constexpr int strips_of(int w) { return (w + kStrip - 1) / kStrip; }

// a CTA's dynamic shared memory: the reserve; per (row, strip) of its band
// two activity bytes and a 2-byte list entry, rounded up to 16 B; and, when
// the band lies in shared memory, 4 B of key and 1 B of flags a pixel
size_t band_smem_bytes(int rows, int w, bool in_shared) {
  const size_t act = (4 * static_cast<size_t>(rows) * strips_of(w) + 15) / 16 * 16;
  return kSmemReserve + act + (in_shared ? 5 * static_cast<size_t>(rows) * w : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Generic pointers to the first row of the previous, own and next band's
// state and activity (in shared memory of this or a neighbouring CTA, or
// in the scratch).  The winners' activity lies act_stride bytes after the
// candidates'.
struct Band {
  float* kp; float* ks; float* kn;
  unsigned char* fp; unsigned char* fs; unsigned char* fn;
  unsigned char* ap; unsigned char* as; unsigned char* an;
  int yp, ys, ye;   // first row of the previous band; own band [ys, ye)
  int h, w, nstrips, act_stride;
  bool vec;         // w % 4 == 0: rows start on 16 B, groups load as one
};

template <typename T>
__device__ __forceinline__ T* row_of(const Band& b, T* p, T* s, T* n, int y, int pitch) {
  return y < b.ys ? p + static_cast<ptrdiff_t>(y - b.yp) * pitch
       : y >= b.ye ? n + static_cast<ptrdiff_t>(y - b.ye) * pitch
                   : s + static_cast<ptrdiff_t>(y - b.ys) * pitch;
}

// the 4 values at columns x..x+3 of a row (x a multiple of 4); columns
// outside the map read 0, which leaves every positive window max unchanged
__device__ __forceinline__ void load4(const Band& b, const float* row, int x, float (&v)[4]) {
  if (x < 0 || x >= b.w) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
  } else if (b.vec) {
    const float4 q = *reinterpret_cast<const float4*>(row + x);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = x + c < b.w ? row[x + c] : 0.0f;
  }
}

// 1 where the flags at x..x+3 equal `tag` (won this round), else 0
__device__ __forceinline__ void load4(const Band& b, const unsigned char* row, int x,
                                      unsigned char tag, float (&v)[4]) {
  if (x < 0 || x >= b.w) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
  } else if (b.vec) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(row + x);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = ((q >> (8 * c)) & 0xffu) == tag ? 1.0f : 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = x + c < b.w && row[x + c] == tag ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ void store4(const Band& b, float* row, int x, const float (&v)[4]) {
  if (x >= b.w) return;
  if (b.vec) {
    *reinterpret_cast<float4*>(row + x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (x + c < b.w) row[x + c] = v[c];
  }
}

// the activity bits of a warp's strip from each lane's "any of my 4"
__device__ __forceinline__ unsigned char activity(bool any4) {
  const uint32_t m = __ballot_sync(0xffffffffu, any4);
  return static_cast<unsigned char>((m ? kAny : 0) | ((m & 0x3u) ? kFirst : 0) |
                                    ((m & 0xc0000000u) ? kLast : 0));
}

// Whether row y can reach strip s's window max: an active pixel in the
// strip or within 8 columns of it (candidates in the winners pass, this
// round's winners in the suppress pass: `off` bytes into the activity).
__device__ __forceinline__ bool row_relevant(const Band& b, int y, int s, int off) {
  if (y < 0 || y >= b.h) return false;
  const unsigned char* a = row_of(b, b.ap, b.as, b.an, y, b.nstrips) + off;
  return (a[s] & kAny) || (s > 0 && (a[s - 1] & kLast)) ||
         (s + 1 < b.nstrips && (a[s + 1] & kFirst));
}

// The horizontal (2R+1) max at x..x+3 of row y: keys (winners pass) or
// this round's winners (suppress pass, `tag`).  Every lane of the warp
// calls it with the same y.  The lanes at the strip's edges load the
// groups beyond it, one predicated load per distance j, together with
// their own; the rest comes from the neighbouring lanes.
template <int R, bool FLAGS>
__device__ __forceinline__ void hmax_row(const Band& b, int y, int x, int lane,
                                         unsigned char tag, float (&out)[4]) {
  constexpr int NL = (R + kGroup - 1) / kGroup;   // neighbour groups a side
  constexpr int NE = NL > 0 ? NL : 1;
  constexpr int C0 = kGroup * NL;                 // index of the own group
  float a[kGroup * (2 * NL + 1)];
  float own[4];
  float edge[NE][4] = {};
  if constexpr (FLAGS) {
    const unsigned char* row = row_of(b, b.fp, b.fs, b.fn, y, b.w);
    load4(b, row, x, tag, own);
#pragma unroll
    for (int j = 1; j <= NL; ++j)
      if (lane < j || lane >= 32 - j)
        load4(b, row, lane < j ? x - kGroup * j : x + kGroup * j, tag, edge[j - 1]);
  } else {
    const float* row = row_of(b, b.kp, b.ks, b.kn, y, b.w);
    load4(b, row, x, own);
#pragma unroll
    for (int j = 1; j <= NL; ++j)
      if (lane < j || lane >= 32 - j)
        load4(b, row, lane < j ? x - kGroup * j : x + kGroup * j, edge[j - 1]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) a[C0 + c] = own[c];
#pragma unroll
  for (int j = 1; j <= NL; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float l = __shfl_up_sync(0xffffffffu, own[c], j);
      const float r = __shfl_down_sync(0xffffffffu, own[c], j);
      a[C0 - kGroup * j + c] = lane < j ? edge[j - 1][c] : l;
      a[C0 + kGroup * j + c] = lane >= 32 - j ? edge[j - 1][c] : r;
    }
  }
  // the windows [c - R, c + R] of c = 0..3 share [3 - R, R]
  constexpr int LO = 3 - R, HI = R;
  if constexpr (LO <= HI) {
    float common = a[C0 + LO];
#pragma unroll
    for (int d = LO + 1; d <= HI; ++d) common = fmaxf(common, a[C0 + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float m = common;
#pragma unroll
      for (int d = c - R; d < LO; ++d) m = fmaxf(m, a[C0 + d]);
#pragma unroll
      for (int d = HI + 1; d <= c + R; ++d) m = fmaxf(m, a[C0 + d]);
      out[c] = m;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float m = a[C0 + c - R];
#pragma unroll
      for (int d = -R + 1; d <= R; ++d) m = fmaxf(m, a[C0 + c + d]);
      out[c] = m;
    }
  }
}

// Own row y, strip s, given the window max m of its 4 columns (with some
// active row in the window).  Winners pass: marks the winners of round
// `tag` and records the strip's winners' activity.  Suppress pass: zeroes
// the keys under a winner, records the candidates' activity and returns
// whether any candidate is left.
template <bool SUPPRESS>
__device__ __forceinline__ bool row_result(const Band& b, int y, int s, int x, int lane,
                                           unsigned char tag, const float (&m)[4]) {
  unsigned char* act = b.as + (y - b.ys) * b.nstrips + s;
  float* krow = b.ks + static_cast<ptrdiff_t>(y - b.ys) * b.w;
  float k[4];
  load4(b, krow, x, k);
  if constexpr (!SUPPRESS) {
    bool won = false;
    unsigned char* frow = b.fs + static_cast<ptrdiff_t>(y - b.ys) * b.w;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (k[c] > 0.0f && k[c] == m[c]) {   // never a column past w: its k is 0
        frow[x + c] = static_cast<unsigned char>(kKept | tag);
        won = true;
      }
    }
    const unsigned char w_act = activity(won);
    if (lane == 0) act[b.act_stride] = w_act;
    return false;
  } else {
    bool dead_any = false, any = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool dead = m[c] > 0.0f;
      dead_any |= dead && k[c] > 0.0f;
      if (dead) k[c] = 0.0f;
      any |= k[c] > 0.0f;
    }
    if (dead_any) store4(b, krow, x, k);
    const unsigned char c_act = activity(any);
    if (lane == 0) *act = c_act;
    return c_act != 0;
  }
}

// Ring mode, one warp task: output rows [ya, yb) of the own band in strip
// s.  Input rows without activity push zeros without a load; output rows
// without candidates, or whose window has no active row, are left alone.
// Both are read 32 rows at a time, a row a lane, into ballot masks.  The
// vertical max of the last K = 2R+1 pushed rows: the pushes go in blocks of
// K; at a block's start the ring (the block before) becomes its suffix
// maxima in place, a running max p covers the block so far, and the window
// ending at slot t is max(suffix[t+1], p).
template <int R, bool SUPPRESS>
__device__ __forceinline__ bool run_chunk(const Band& b, int ya, int yb, int s, int lane,
                                          unsigned char tag) {
  constexpr int K = 2 * R + 1;
  constexpr uint32_t kWin = (1u << K) - 1;
  const int x = s * kStrip + lane * kGroup;
  const int off = SUPPRESS ? b.act_stride : 0;
  float ring[K][4], p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) ring[t][c] = 0.0f;
  uint32_t rel = 0;                   // activity of the rows pushed, newest in bit 0
  uint32_t rel_in = 0, has_out = 0;   // the ballot masks of 32 rows
  bool left = false;
  const int n_in = yb - ya + 2 * R;   // rows pushed: ya-R .. yb+R-1
  for (int base = 0; base < n_in; base += K) {
    if (base > 0) {
#pragma unroll
      for (int t = K - 2; t >= 0; --t)
#pragma unroll
        for (int c = 0; c < 4; ++c) ring[t][c] = fmaxf(ring[t][c], ring[t + 1][c]);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int i = base + t;
      if (i >= n_in) break;
      if ((i & 31) == 0) {
        const int idx = i + lane;
        rel_in = __ballot_sync(0xffffffffu,
                               idx < n_in && row_relevant(b, ya - R + idx, s, off));
      }
      const bool r_in = (rel_in >> (i & 31)) & 1u;
      rel = (rel << 1) | (r_in ? 1u : 0u);
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r_in) hmax_row<R, SUPPRESS>(b, ya - R + i, x, lane, tag, v);
      float m[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = t == 0 ? v[c] : fmaxf(p[c], v[c]);
        m[c] = t < K - 1 ? fmaxf(ring[t < K - 1 ? t + 1 : t][c], p[c]) : p[c];
        ring[t][c] = v[c];
      }
      if (i < 2 * R) continue;
      const int o = i - 2 * R;        // output row ya + o
      if ((o & 31) == 0) {
        const int yo = ya + o + lane;
        has_out = __ballot_sync(0xffffffffu,
                                yo < yb && (b.as[(yo - b.ys) * b.nstrips + s] & kAny));
      }
      if (!((has_out >> (o & 31)) & 1u)) continue;   // no candidate in the row
      if (rel & kWin) left |= row_result<SUPPRESS>(b, ya + o, s, x, lane, tag, m);
      else left |= SUPPRESS;          // nothing dies here; its candidates stay
    }
  }
  return left;
}

// Direct mode, one listed (row, strip) pair: the window max from the
// active rows of its window only.
template <int R, bool SUPPRESS>
__device__ __forceinline__ bool run_item(const Band& b, int e, int lane, unsigned char tag) {
  constexpr int K = 2 * R + 1;
  const int yl = e / b.nstrips, s = e - yl * b.nstrips;
  const int y = b.ys + yl, x = s * kStrip + lane * kGroup;
  const uint32_t rel = __ballot_sync(
      0xffffffffu, lane < K && row_relevant(b, y - R + lane, s, SUPPRESS ? b.act_stride : 0));
  if (!rel) return SUPPRESS;          // nothing dies here; its candidates stay
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (uint32_t r = rel; r; r &= r - 1) {
    float v[4];
    hmax_row<R, SUPPRESS>(b, y - R + __ffs(r) - 1, x, lane, tag, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = fmaxf(m[c], v[c]);
  }
  return row_result<SUPPRESS>(b, y, s, x, lane, tag, m);
}

// One pass over the own band.  The (row, strip) pairs with candidates are
// listed first; at most kDirectMax of them go to the direct mode, a warp
// an item, else the warps walk strips times chunks of rows, about one
// task a warp.
template <int R, bool SUPPRESS>
__device__ __forceinline__ bool band_pass(const Band& b, unsigned char tag,
                                          unsigned short* list, int* count) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pairs = (b.ye - b.ys) * b.nstrips;
  if (tid == 0) *count = 0;
  __syncthreads();
  for (int e = tid; e < pairs; e += kThreads) {
    if (!SUPPRESS) b.as[b.act_stride + e] = 0;   // winners of this round: none yet
    if (b.as[e] & kAny) list[atomicAdd(count, 1)] = static_cast<unsigned short>(e);
  }
  __syncthreads();
  const int n = *count;
  bool left = false;
  if (n <= kDirectMax) {
    for (int k = warp; k < n; k += kWarps) left |= run_item<R, SUPPRESS>(b, list[k], lane, tag);
  } else {
    const int nchunks = max(1, kWarps / b.nstrips);
    const int chunk = (b.ye - b.ys + nchunks - 1) / nchunks;
    for (int t = warp; t < b.nstrips * nchunks; t += kWarps) {
      const int ya = b.ys + (t / b.nstrips) * chunk;
      const int yb = min(ya + chunk, b.ye);
      if (ya < yb) left |= run_chunk<R, SUPPRESS>(b, ya, yb, t % b.nstrips, lane, tag);
    }
  }
  return left;
}

// whether any CTA of the cluster set its slot
__device__ __forceinline__ bool cluster_any(cg::cluster_group& cluster, int* slot) {
  const int lane = threadIdx.x & 31;
  int v = 0;
  if (lane < static_cast<int>(cluster.num_blocks())) v = *cluster.map_shared_rank(slot, lane);
  return __any_sync(0xffffffffu, v != 0);
}

// grid (C, B), clusters of (C, 1, 1): cluster y holds frame y.  gkey/gflag
// are the device-memory state, (B, H, W) each, or null when the bands lie
// in shared memory (rows_max rows a CTA).
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
grid_nms_kernel(const float* __restrict__ scores, float* __restrict__ out,
                float* gkey, unsigned char* gflag, int* __restrict__ rounds,
                int h, int w, int rows_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t frame = blockIdx.y;
  int* slot = reinterpret_cast<int*>(smem);
  int* count = reinterpret_cast<int*>(smem + 4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 16);

  Band b;
  b.h = h; b.w = w; b.vec = (w % 4) == 0;
  b.nstrips = strips_of(w);
  b.act_stride = rows_max * b.nstrips;
  b.ys = static_cast<int>(static_cast<long long>(rank) * h / nc);
  b.ye = static_cast<int>(static_cast<long long>(rank + 1) * h / nc);
  b.yp = static_cast<int>(static_cast<long long>(max(rank - 1, 0)) * h / nc);
  unsigned char* act = smem + kSmemReserve;
  unsigned short* list = reinterpret_cast<unsigned short*>(act + 2 * b.act_stride);
  b.as = act;
  b.ap = rank > 0 ? cluster.map_shared_rank(act, rank - 1) : nullptr;
  b.an = rank < nc - 1 ? cluster.map_shared_rank(act, rank + 1) : nullptr;
  const bool in_shared = gkey == nullptr;
  if (in_shared) {
    float* k = reinterpret_cast<float*>(
        smem + kSmemReserve + (4 * static_cast<size_t>(b.act_stride) + 15) / 16 * 16);
    unsigned char* f = reinterpret_cast<unsigned char*>(k + static_cast<size_t>(rows_max) * w);
    b.ks = k; b.fs = f;
    b.kp = rank > 0 ? cluster.map_shared_rank(k, rank - 1) : nullptr;
    b.fp = rank > 0 ? cluster.map_shared_rank(f, rank - 1) : nullptr;
    b.kn = rank < nc - 1 ? cluster.map_shared_rank(k, rank + 1) : nullptr;
    b.fn = rank < nc - 1 ? cluster.map_shared_rank(f, rank + 1) : nullptr;
  } else {
    float* k = gkey + frame * h * w;
    unsigned char* f = gflag + frame * h * w;
    b.ks = k + static_cast<size_t>(b.ys) * w; b.fs = f + static_cast<size_t>(b.ys) * w;
    b.kp = k + static_cast<size_t>(b.yp) * w; b.fp = f + static_cast<size_t>(b.yp) * w;
    b.kn = k + static_cast<size_t>(b.ye) * w; b.fn = f + static_cast<size_t>(b.ye) * w;
  }

  // load the band's scores: one bulk copy into the key rows where they
  // lie in shared memory on 16 B, else straight from device memory
  const float* frame_scores = scores + frame * h * w;
  const float* src = frame_scores + static_cast<size_t>(b.ys) * w;
  const int rows = b.ye - b.ys;
  const int n = rows * w;
  if (in_shared && b.vec && (reinterpret_cast<uintptr_t>(scores) & 15) == 0) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(bar)), "r"(n * 4) : "memory");
      for (int o = 0; o < n * 4; o += kCopyPiece)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(reinterpret_cast<unsigned char*>(b.ks) + o)),
               "l"(reinterpret_cast<const unsigned char*>(src) + o),
               "r"(min(kCopyPiece, n * 4 - o)), "r"(smem_u32(bar)) : "memory");
    }
    __syncthreads();   // the barrier is initialised before anyone waits on it
    mbar_wait(bar, 0);
    src = b.ks;        // the scores now lie where the keys go
  }

  // the priority key in place, flags cleared, the candidates' activity:
  // a warp a row, its strips in turn; the column phase x % (2R+1) steps
  // along instead of being divided out per pixel
  constexpr int win = 2 * R + 1;
  bool any = false;
  for (int yl = warp; yl < rows; yl += kWarps) {
    const int y = b.ys + yl;
    const int yprio = 255 - (y % win) * win;
    const float* srow = src + static_cast<size_t>(yl) * w;
    float* krow = b.ks + static_cast<size_t>(yl) * w;
    unsigned char* frow = b.fs + static_cast<size_t>(yl) * w;
    int xm = (lane * kGroup) % win;
    for (int s = 0; s < b.nstrips; ++s) {
      const int x = s * kStrip + lane * kGroup;
      float v[4];
      load4(b, srow, x, v);
      bool any4 = false;
      int xc = xm;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = v[c] > 0.0f ? __int_as_float((__float_as_int(v[c]) & ~0xFF) | (yprio - xc)) : 0.0f;
        any4 |= v[c] > 0.0f;
        xc = xc + 1 == win ? 0 : xc + 1;
      }
      store4(b, krow, x, v);
      if (x < w) {
        if (b.vec) {
          *reinterpret_cast<uint32_t*>(frow + x) = 0u;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (x + c < w) frow[x + c] = 0;
        }
      }
      const unsigned char a = activity(any4);
      if (lane == 0) act[yl * b.nstrips + s] = a;
      any |= a != 0;
      xm += kStrip % win;
      if (xm >= win) xm -= win;
    }
  }
  any = __syncthreads_or(any);
  if (tid == 0) *slot = any;
  cluster.sync();
  any = cluster_any(cluster, slot);

  const long long cap = static_cast<long long>(h) * w;
  int nr = 0;
  while (any && nr < cap) {
    // a winner's flags: kKept | the round mod 128
    const unsigned char tag = static_cast<unsigned char>(kKept | (nr & 0x7f));
    band_pass<R, false>(b, tag, list, count);
    cluster.sync();                       // winners written before they are read
    const bool left = __syncthreads_or(band_pass<R, true>(b, tag, list, count));
    if (tid == 0) *slot = left;
    cluster.sync();                       // keys, activity and slots written
    any = cluster_any(cluster, slot);
    ++nr;
  }

  // kept ? score : 0 over the band; the score is read again only where kept
  const float* sc = frame_scores + static_cast<size_t>(b.ys) * w;
  float* o = out + frame * h * w + static_cast<size_t>(b.ys) * w;
  if (b.vec && (reinterpret_cast<uintptr_t>(scores) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int i = tid * 4; i < n; i += kThreads * 4) {
      const uint32_t f = *reinterpret_cast<const uint32_t*>(b.fs + i);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f & 0x80808080u) {
        const float4 s = *reinterpret_cast<const float4*>(sc + i);
        v.x = (f & 0x00000080u) ? s.x : 0.0f;
        v.y = (f & 0x00008000u) ? s.y : 0.0f;
        v.z = (f & 0x00800000u) ? s.z : 0.0f;
        v.w = (f & 0x80000000u) ? s.w : 0.0f;
      }
      *reinterpret_cast<float4*>(o + i) = v;
    }
  } else {
    for (int i = tid; i < n; i += kThreads) o[i] = (b.fs[i] & kKept) ? sc[i] : 0.0f;
  }
  if (rank == 0 && tid == 0) rounds[frame] = nr;
  cluster.sync();   // no CTA leaves while another may read its shared memory
}

// Checks the layout and prepares the launch of the kernel for radius R.
template <int R>
int configure(int b, int h, int w, int cluster, int band_in_shared, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr, int* rows_max) {
  if (cluster < 1 || cluster > kMaxCluster || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // every band at least max(r, 1) rows tall, so a halo reaches one CTA only
  if (cluster > 1 && h / cluster < (R > 0 ? R : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  *rows_max = (h + cluster - 1) / cluster;
  // list entries are 16-bit (row, strip) indices
  if (static_cast<long long>(*rows_max) * strips_of(w) > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = band_smem_bytes(*rows_max, w, band_in_shared != 0);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(grid_nms_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, b, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <int R>
int launch(const float* scores, float* out, float* gkey, unsigned char* gflag, int* rounds,
           int b, int h, int w, int cluster, int band_in_shared, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int rows_max = 0;
  int err = configure<R>(b, h, w, cluster, band_in_shared, &cfg, attr, &rows_max);
  if (err != 0) return err;
  if (!band_in_shared && (gkey == nullptr || gflag == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.stream = s;
  cudaError_t e = cudaLaunchKernelEx(&cfg, grid_nms_kernel<R>, scores, out,
                                     band_in_shared ? nullptr : gkey,
                                     band_in_shared ? nullptr : gflag, rounds, h, w, rows_max);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int max_active(int h, int w, int cluster, int band_in_shared, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int rows_max = 0;
  int err = configure<R>(1, h, w, cluster, band_in_shared, &cfg, attr, &rows_max);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, grid_nms_kernel<R>, &cfg));
}

}  // namespace

// scores, out: (b, h, w) float32; key_scratch (b*h*w float32) and
// flag_scratch (b*h*w bytes) hold the state when band_in_shared is 0 and
// may be null otherwise; rounds: b int32 on the device, each frame's
// suppression rounds.  One launch on `stream`, no synchronise; returns the
// first cudaError_t met (0 on success).
extern "C" int grid_nms_launch(const float* scores, float* out, float* key_scratch,
                               unsigned char* flag_scratch, int* rounds, int b, int h,
                               int w, int r, int cluster, int band_in_shared,
                               void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // r <= 7: the priority key is unique within 15x15 windows only
#define NMS_CASE(R) \
  case R: return launch<R>(scores, out, key_scratch, flag_scratch, rounds, b, h, w, cluster, band_in_shared, s);
  switch (r) {
    NMS_CASE(0) NMS_CASE(1) NMS_CASE(2) NMS_CASE(3)
    NMS_CASE(4) NMS_CASE(5) NMS_CASE(6) NMS_CASE(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NMS_CASE
}

// *count receives cudaOccupancyMaxActiveClusters for the launch that
// grid_nms_launch would make with these arguments.
extern "C" int grid_nms_max_active_clusters(int h, int w, int r, int cluster,
                                            int band_in_shared, int* count) {
  *count = 0;
#define NMS_CASE(R) case R: return max_active<R>(h, w, cluster, band_in_shared, count);
  switch (r) {
    NMS_CASE(0) NMS_CASE(1) NMS_CASE(2) NMS_CASE(3)
    NMS_CASE(4) NMS_CASE(5) NMS_CASE(6) NMS_CASE(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NMS_CASE
}
