// Fused keypoint-probability decode for Hopper (sm_90a).
//
// Replaces the TPU kernel feature_point_cnn_tpu/ops/pallas/decode.py:
// decode_threshold_pallas (_decode_kernel).  Per 8x8 cell: a stable 65-way
// softmax with the reference epsilon, exp(l - m) / (sum + 1e-5 * exp(-m)),
// the dustbin dropped, depth-to-space, then where(p >= t, p, 0).
//
// Bound on an H100 SXM: bytes.  A 480x640 frame reads 60*80*65*4 = 1.25 MB
// of logits and writes 480*640*4 = 1.23 MB of map, about 0.74 us at
// 3.35 TB/s; the ~5 flops per logit are nothing beside that.
//
// Design.  The TPU kernel's grid step is one cell row; here a block takes
// one segment of a cell row, up to kSegCells cells (a whole 640-px row of
// 80 cells is one segment).  Its logits are one contiguous run (20,800 B
// at 80 cells), brought into shared memory by one cp.async.bulk on an
// mbarrier where the run starts and ends on 16 B (Wc % 4 == 0), and by
// coalesced loads of all threads otherwise.  A warp takes a cell: each lane
// reads two logits (lane 0 also the dustbin) from shared memory, max and
// sum by shuffles, and writes its two thresholded probabilities into an
// (8, cells*8) tile in shared memory (rows padded by 8 floats, so the four
// in-cell rows a store touches fall in distinct banks).  The tile leaves as
// 8 contiguous output rows in 16-byte stores from all threads, so each
// thread has whole 16 B pieces in flight in both directions.
// expf without --use_fast_math keeps the result within 1e-6 of PyTorch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCell = 8;
constexpr int kChannels = kCell * kCell + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegCells = 80;         // cells a block decodes at most
constexpr int kTilePad = 8;           // floats of padding per tile row
constexpr int kBarBytes = 16;         // the mbarrier, padded to 16 B

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// a block's dynamic shared memory for segments of `seg` cells: the
// mbarrier, the logits (rounded up to 16 B), the (8, seg*8 + kTilePad) tile;
// 41,552 B at kSegCells, under the 48 KB a launch may take unasked
size_t segment_smem_bytes(int seg) {
  return static_cast<size_t>(kBarBytes) + 4 * static_cast<size_t>(round4(seg * kChannels)) +
         4 * static_cast<size_t>(kCell) * (seg * kCell + kTilePad);
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

// grid: one block per (frame, cell row, segment); seg = min(kSegCells, wc)
__global__ void __launch_bounds__(kThreads)
decode_row_kernel(const float* __restrict__ logits, float* __restrict__ out,
                  int wc, int nseg, int seg, float threshold, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* lg = reinterpret_cast<float*>(smem + kBarBytes);
  float* tile = lg + round4(seg * kChannels);
  const int pitch = seg * kCell + kTilePad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x / nseg;          // frame * hc + cell row
  const int cx0 = (blockIdx.x - static_cast<int>(row) * nseg) * seg;
  const int ncell = min(seg, wc - cx0);
  const int nfl = ncell * kChannels;
  const float* src = logits + (row * wc + cx0) * kChannels;

  if (bulk) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(bar)), "r"(nfl * 4) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(lg)), "l"(src), "r"(nfl * 4), "r"(smem_u32(bar)) : "memory");
    }
    __syncthreads();   // the barrier is initialised before anyone waits on it
    mbar_wait(bar, 0);
  } else {
    for (int i = tid; i < nfl; i += kThreads) lg[i] = src[i];
    __syncthreads();
  }

  const int dy = lane >> 3, dx = lane & 7;
  for (int c = warp; c < ncell; c += kWarps) {
    const float* l = lg + c * kChannels;
    const float a = l[lane];
    const float b = l[lane + 32];
    const float d = lane == 0 ? l[64] : -INFINITY;

    float m = fmaxf(fmaxf(a, b), d);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float ea = expf(a - m);
    const float eb = expf(b - m);
    float s = ea + eb + (lane == 0 ? expf(d - m) : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float denom = s + 1e-5f * expf(-m);
    const float pa = ea / denom;
    const float pb = eb / denom;
    // lane owns in-cell rows dy and dy + 4 at column dx
    tile[dy * pitch + c * kCell + dx] = pa >= threshold ? pa : 0.0f;
    tile[(dy + 4) * pitch + c * kCell + dx] = pb >= threshold ? pb : 0.0f;
  }
  __syncthreads();

  // 8 output rows of ncell*8 floats, 16 B a store (W = wc*8 keeps rows on 16 B)
  const int quads = ncell * 2;
  const size_t width = static_cast<size_t>(wc) * kCell;
  float* dst = out + row * kCell * width + static_cast<size_t>(cx0) * kCell;
  for (int i = tid; i < kCell * quads; i += kThreads) {
    const int r = i / quads, q = i - (i / quads) * quads;
    *reinterpret_cast<float4*>(dst + r * width + 4 * q) =
        *reinterpret_cast<const float4*>(tile + r * pitch + 4 * q);
  }
}

}  // namespace

// logits: (b, hc, wc, 65) float32, contiguous; out: (b, hc*8, wc*8) float32,
// 16-byte aligned.  One launch; returns its cudaError_t (0 on success).
extern "C" int decode_threshold_launch(const float* logits, float* out, int b,
                                       int hc, int wc, float threshold,
                                       void* stream) {
  if (b == 0 || hc == 0 || wc == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = wc < kSegCells ? wc : kSegCells;
  const int nseg = (wc + seg - 1) / seg;
  const size_t smem = segment_smem_bytes(seg);
  // whole 16 B runs: every segment starts at a multiple of 4 cells
  const int bulk = wc % 4 == 0 && (reinterpret_cast<uintptr_t>(logits) & 15) == 0;
  const long long blocks = static_cast<long long>(b) * hc * nseg;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  decode_row_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(logits, out, wc, nseg, seg,
                                                           threshold, bulk);
  return static_cast<int>(cudaGetLastError());
}
