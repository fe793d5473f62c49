// Exact-greedy grid NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel feature_point_cnn_tpu/ops/pallas/nms.py:
// grid_nms_pallas (_nms_kernel, _maxpool2d, _running_max_axis).  Greedy NMS
// as iterated window-max suppression on the strict priority key of
// ops/detection.py:nms_priority_key: each round keeps every remaining
// candidate that is the maximum of its (2r+1)^2 window, then zeroes the
// windows of the kept points, until no candidate is left (capped at H*W
// rounds).  Output: the kept scores, 0 elsewhere.
//
// Bound on an H100 SXM: bytes, for the function.  A 480x640 frame reads
// 1.23 MB of scores and writes 1.23 MB, about 0.73 us at 3.35 TB/s; the
// window maxima cost 2 * 2 * 2r comparisons per pixel per round, some
// 2.5 us per frame over 10 rounds at 67 TFLOP/s of float32.  The TPU kernel
// pins the whole map in VMEM for all rounds; an SM has 227 KB of shared
// memory, so here the map stays in device memory (L2 holds it: 1.2 MB per
// frame) and each round is two launches over (B, H, W):
//   winners:  remaining > 0 && remaining == window max;  keep |= winners
//   suppress: remaining = 0 where a winner lies in the window, and a
//             device flag is set if any candidate remains.
// Each launch tiles the map in 32x16 blocks with an r-pixel halo in shared
// memory and takes the window max separably (rows, then columns).  The
// host reads the flag after each round: that round trip, not the bytes, is
// what this first design pays; a persistent or cluster design is later
// work.  Float == and max are exact, so the kept set equals the plain
// PyTorch version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 16;
constexpr int kRMax = 7;  // the priority key is unique within 15x15
constexpr int kTW = kTX + 2 * kRMax;
constexpr int kTH = kTY + 2 * kRMax;

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// Loads this block's tile (halo r, out-of-map entries = 0) and returns the
// (2r+1)^2 window max at the thread's own pixel.  Every thread of the
// block must call it.  Values are >= 0, so a 0 fill leaves every positive
// window max unchanged.
template <typename T>
__device__ T tile_window_max(const T* __restrict__ img, int h, int w, int r,
                             T* tile, T* rowmax) {
  const int x0 = blockIdx.x * kTX - r;
  const int y0 = blockIdx.y * kTY - r;
  const int tw = kTX + 2 * r;
  const int th = kTY + 2 * r;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int i = tid; i < tw * th; i += kTX * kTY) {
    const int ty = i / tw, tx = i - (i / tw) * tw;
    const int y = y0 + ty, x = x0 + tx;
    tile[ty * kTW + tx] = (y >= 0 && y < h && x >= 0 && x < w)
                              ? img[static_cast<size_t>(y) * w + x]
                              : T(0);
  }
  __syncthreads();
  for (int i = tid; i < th * kTX; i += kTX * kTY) {
    const int ty = i / kTX, tx = i - (i / kTX) * kTX;
    T m = tile[ty * kTW + tx];
    for (int k = 1; k <= 2 * r; ++k) m = vmax(m, tile[ty * kTW + tx + k]);
    rowmax[ty * kTX + tx] = m;
  }
  __syncthreads();
  T m = rowmax[threadIdx.y * kTX + threadIdx.x];
  for (int k = 1; k <= 2 * r; ++k)
    m = vmax(m, rowmax[(threadIdx.y + k) * kTX + threadIdx.x]);
  return m;
}

// remaining = nms_priority_key(scores): the score's low mantissa byte
// replaced by a position priority unique within any (2r+1)^2 window.
__global__ void nms_init(const float* __restrict__ scores,
                         float* __restrict__ rem, unsigned char* __restrict__ keep,
                         int* __restrict__ flag, long long n, int h, int w, int win) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const long long p = i % (static_cast<long long>(h) * w);
  const int y = static_cast<int>(p / w), x = static_cast<int>(p % w);
  const float s = scores[i];
  const int prio = 255 - ((y % win) * win + (x % win));
  const float key = s > 0.0f ? __int_as_float((__float_as_int(s) & ~0xFF) | prio) : 0.0f;
  rem[i] = key;
  keep[i] = 0;
  if (key > 0.0f) *flag = 1;
}

__global__ void nms_winners(const float* __restrict__ rem,
                            unsigned char* __restrict__ win,
                            unsigned char* __restrict__ keep, int h, int w, int r) {
  __shared__ float tile[kTH * kTW];
  __shared__ float rowmax[kTH * kTX];
  const size_t off = static_cast<size_t>(blockIdx.z) * h * w;
  const float m = tile_window_max(rem + off, h, w, r, tile, rowmax);
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float v = tile[(threadIdx.y + r) * kTW + threadIdx.x + r];
  const unsigned char won = v > 0.0f && v == m;
  const size_t i = off + static_cast<size_t>(y) * w + x;
  win[i] = won;
  if (won) keep[i] = 1;
}

__global__ void nms_suppress(float* __restrict__ rem,
                             const unsigned char* __restrict__ win,
                             int* __restrict__ flag, int h, int w, int r) {
  __shared__ unsigned char tile[kTH * kTW];
  __shared__ unsigned char rowmax[kTH * kTX];
  const size_t off = static_cast<size_t>(blockIdx.z) * h * w;
  const unsigned char dead = tile_window_max(win + off, h, w, r, tile, rowmax);
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = off + static_cast<size_t>(y) * w + x;
  if (dead) {
    rem[i] = 0.0f;
  } else if (rem[i] > 0.0f) {
    *flag = 1;
  }
}

__global__ void nms_finalize(const float* __restrict__ scores,
                             const unsigned char* __restrict__ keep,
                             float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < n) out[i] = keep[i] ? scores[i] : 0.0f;
}

}  // namespace

// scores, out, rem: (b, h, w) float32; win, keep: (b, h, w) uint8 scratch;
// flag: one int32 on the device.  Runs the whole convergence loop on
// `stream` and returns the first cudaError_t met (0 on success); *rounds
// receives the number of suppression rounds.
extern "C" int grid_nms_launch(const float* scores, float* out, float* rem,
                               unsigned char* win, unsigned char* keep, int* flag,
                               int b, int h, int w, int r, int* rounds,
                               void* stream) {
  *rounds = 0;
  if (r < 0 || r > kRMax) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(b) * h * w;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned int blocks1d = static_cast<unsigned int>((n + threads - 1) / threads);
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, b);
  int host_flag = 0;
  cudaError_t err;
#define NMS_CHECK(expr)                          \
  do {                                           \
    err = (expr);                                \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

  NMS_CHECK(cudaMemsetAsync(flag, 0, sizeof(int), s));
  nms_init<<<blocks1d, threads, 0, s>>>(scores, rem, keep, flag, n, h, w, 2 * r + 1);
  NMS_CHECK(cudaGetLastError());
  NMS_CHECK(cudaMemcpyAsync(&host_flag, flag, sizeof(int), cudaMemcpyDeviceToHost, s));
  NMS_CHECK(cudaStreamSynchronize(s));
  const long long cap = static_cast<long long>(h) * w;
  while (host_flag && *rounds < cap) {
    nms_winners<<<grid, block, 0, s>>>(rem, win, keep, h, w, r);
    NMS_CHECK(cudaGetLastError());
    NMS_CHECK(cudaMemsetAsync(flag, 0, sizeof(int), s));
    nms_suppress<<<grid, block, 0, s>>>(rem, win, flag, h, w, r);
    NMS_CHECK(cudaGetLastError());
    NMS_CHECK(cudaMemcpyAsync(&host_flag, flag, sizeof(int), cudaMemcpyDeviceToHost, s));
    NMS_CHECK(cudaStreamSynchronize(s));
    ++*rounds;
  }
  nms_finalize<<<blocks1d, threads, 0, s>>>(scores, keep, out, n);
  NMS_CHECK(cudaGetLastError());
#undef NMS_CHECK
  return 0;
}
