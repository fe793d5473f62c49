// Fused keypoint-probability decode for Hopper (sm_90a).
//
// Replaces the TPU kernel feature_point_cnn_tpu/ops/pallas/decode.py:
// decode_threshold_pallas (_decode_kernel).  Per 8x8 cell: a stable 65-way
// softmax with the reference epsilon, exp(l - m) / (sum + 1e-5 * exp(-m)),
// the dustbin dropped, depth-to-space, then where(p >= t, p, 0).
//
// Bound on an H100 SXM: bytes.  A 480x640 frame reads 60*80*65*4 = 1.25 MB
// of logits and writes 480*640*4 = 1.23 MB of map, about 0.74 us at
// 3.35 TB/s; the ~5 flops per logit are nothing beside that.  Design: one
// warp per cell.  The warp reads its cell's 65 contiguous logits once
// (lanes 0-31 and 32-63, lane 0 also the dustbin), takes the max and the sum
// with shuffles, and writes the 64 probabilities straight to their (H, W)
// positions: lane c owns in-cell rows c/8 and c/8 + 4, column c%8.  Nothing
// goes through shared memory and the softmax never reaches device memory.
// expf without --use_fast_math keeps the result within 1e-6 of PyTorch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCell = 8;
constexpr int kChannels = kCell * kCell + 1;
constexpr int kWarpsPerBlock = 8;

__global__ void decode_threshold_kernel(const float* __restrict__ logits,
                                        float* __restrict__ out, int ncell,
                                        int hc, int wc, float threshold) {
  const int cell = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= ncell) return;  // whole warps exit together

  const float* l = logits + static_cast<size_t>(cell) * kChannels;
  const float a = l[lane];
  const float c = l[lane + 32];
  const float d = lane == 0 ? l[64] : -INFINITY;

  float m = fmaxf(fmaxf(a, c), d);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  const float ea = expf(a - m);
  const float ec = expf(c - m);
  float s = ea + ec + (lane == 0 ? expf(d - m) : 0.0f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float denom = s + 1e-5f * expf(-m);
  const float pa = ea / denom;
  const float pc = ec / denom;

  const int per_image = hc * wc;
  const int b = cell / per_image;
  const int r = cell - b * per_image;
  const int cy = r / wc;
  const int cx = r - cy * wc;
  const size_t width = static_cast<size_t>(wc) * kCell;
  const size_t base =
      (static_cast<size_t>(b) * hc * kCell + static_cast<size_t>(cy) * kCell) * width +
      static_cast<size_t>(cx) * kCell;
  const int dy = lane >> 3, dx = lane & 7;
  out[base + dy * width + dx] = pa >= threshold ? pa : 0.0f;
  out[base + (dy + 4) * width + dx] = pc >= threshold ? pc : 0.0f;
}

}  // namespace

// logits: (b, hc, wc, 65) float32, contiguous; out: (b, hc*8, wc*8) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_threshold_launch(const float* logits, float* out, int b,
                                       int hc, int wc, float threshold,
                                       void* stream) {
  const int ncell = b * hc * wc;
  if (ncell == 0) return 0;
  const int blocks = (ncell + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_threshold_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      logits, out, ncell, hc, wc, threshold);
  return static_cast<int>(cudaGetLastError());
}
