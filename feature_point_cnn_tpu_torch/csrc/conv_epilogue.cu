// The VGG SuperPoint's convolution epilogue
// (`models/vgg_superpoint.py::VGGSuperPoint._conv`) for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU XLA fuses a convolution's bias and
// ReLU into the convolution, so the JAX package has none for them.  It was
// added because on the H100 PyTorch runs them after cuDNN's convolution as
// three passes over its output, the bias add (a broadcast over
// channels-last bf16 that PyTorch does not vectorise), ReLU and the 2x2
// max-pool: 65% of the VGG forward's device time at B = 32, 480x640.
//
// What it computes, bit for bit as those passes do: for each element y of
// the convolution's bf16 output (computed without bias) and the float32
// bias b of its channel,
//   v = bf16_rn(float(y) + float(bf16_rn(b)))   (the bf16 add in float opmath)
//   v = isnan(v) ? v : fmaxf(v, 0)              (ReLU: clamp_min, NaN kept)
// then, with the pool, the max of each 2x2 window (floor: a last odd row or
// column is dropped) scanned row by row from -inf, a later value taken when
// it is greater or NaN (max_pool2d's rule, so NaN propagates); written as
// bf16 or, for the 1x1 heads, as float32.
//
// Bound on an H100 SXM: bytes.  At 480x640 a frame's twelve convolutions
// write 118.6 MB of bf16; this pass reads it once and writes 81.1 MB (the
// maps before a pool are never written; the two 1x1 heads are float32):
// 59.6 us a frame at 3.35 TB/s, against ~10 instructions an element.
//
// Design.  Each thread moves 16 B (8 channels) a load and a store,
// neighbouring threads on neighbouring channels and then pixels.  The flat
// variant walks the NHWC tensor as one run of 8-element vectors, keeping
// the channel of its vector by a running sum (no division a vector); the
// pooled one gives a thread 8 channels of one output pixel, whose four
// input pixels (two neighbouring pixels on each of two rows) are four 16-B
// loads in flight together.  Blocks are persistent and grid-strided, at
// most kBlocksPerSm of kThreads an SM.  The conv output is dead after this
// pass, so it is read with the streaming (evict-first) hint; the output is
// stored plainly, so that the next convolution finds what L2 holds of it.
// The bias, rounded to bf16 as the plain add rounds it, sits in shared
// memory.  No launch allocates or synchronises: a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;               // bf16 channels in a 16-byte load
constexpr int kBlocksPerSm = 8;       // 2,048 threads an SM
constexpr int kMaxChannels = 4096;    // the bias in shared memory: 16 KB at most

union Pack {
  uint4 u;
  unsigned short s[kVec];
};

__device__ __forceinline__ float bf16_to_float(unsigned short s) {
  return __uint_as_float(static_cast<unsigned int>(s) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the bias add and the activation of one element; the result is a bf16 value
template <bool RELU>
__device__ __forceinline__ float act(unsigned short y, float b) {
  float v = round_bf16(bf16_to_float(y) + b);
  if (RELU) v = isnan(v) ? v : fmaxf(v, 0.0f);
  return v;
}

// max_pool2d's step: a later value wins when greater or NaN
__device__ __forceinline__ float pool_step(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// 8 values, each a bf16 value, stored at element `e` of `out`: as float32,
// or as bf16 by their high halves (exact: every value is bf16 already)
template <bool F32>
__device__ __forceinline__ void store8(void* out, size_t e, const float (&v)[kVec]) {
  if (F32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + e);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    u.x = (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xffff0000u);
    u.y = (__float_as_uint(v[2]) >> 16) | (__float_as_uint(v[3]) & 0xffff0000u);
    u.z = (__float_as_uint(v[4]) >> 16) | (__float_as_uint(v[5]) & 0xffff0000u);
    u.w = (__float_as_uint(v[6]) >> 16) | (__float_as_uint(v[7]) & 0xffff0000u);
    *reinterpret_cast<uint4*>(static_cast<unsigned short*>(out) + e) = u;
  }
}

template <bool F32>
__device__ __forceinline__ void store1(void* out, size_t e, float v) {
  if (F32)
    static_cast<float*>(out)[e] = v;
  else
    static_cast<unsigned short*>(out)[e] = static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ void load_bias(float* sbias, const float* __restrict__ bias, int c) {
  for (int i = threadIdx.x; i < c; i += kThreads) sbias[i] = round_bf16(bias[i]);
  __syncthreads();
}

// y, out: (n / c pixels, c) channels-last, n elements; vector v holds
// elements 8v .. 8v + 7, the last one maybe fewer.  WHOLE: c % 8 == 0, so
// a vector's channels are ch .. ch + 7 of one pixel.
template <bool RELU, bool F32, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const unsigned short* __restrict__ y, const float* __restrict__ bias,
            void* __restrict__ out, long long n, unsigned int vectors, int c) {
  extern __shared__ float sbias[];
  load_bias(sbias, bias, c);
  const unsigned int stride = gridDim.x * kThreads;
  unsigned int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= vectors) return;
  int ch = static_cast<int>((static_cast<long long>(v) * kVec) % c);
  const int step = static_cast<int>((static_cast<long long>(stride) * kVec) % c);
  for (; v < vectors; v += stride) {
    const size_t e = static_cast<size_t>(v) * kVec;
    if (static_cast<long long>(e) + kVec <= n) {
      Pack p;
      p.u = __ldcs(reinterpret_cast<const uint4*>(y + e));
      float r[kVec];
      if (WHOLE) {
        const float4 b0 = reinterpret_cast<const float4*>(sbias + ch)[0];
        const float4 b1 = reinterpret_cast<const float4*>(sbias + ch)[1];
        const float b[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int k = 0; k < kVec; ++k) r[k] = act<RELU>(p.s[k], b[k]);
      } else {
        int ck = ch;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          r[k] = act<RELU>(p.s[k], sbias[ck]);
          if (++ck == c) ck = 0;
        }
      }
      store8<F32>(out, e, r);
    } else {                              // the last, partial vector
      int ck = ch;
      for (long long i = static_cast<long long>(e); i < n; ++i) {
        store1<F32>(out, static_cast<size_t>(i), act<RELU>(y[i], sbias[ck]));
        if (++ck == c) ck = 0;
      }
    }
    ch += step;
    if (ch >= c) ch -= c;
  }
}

// y: (b, h, w, c) channels-last; out: (b, h / 2, w / 2, c); c % 8 == 0.
// Vector v is ((image * ho + oy) * wo + ox) * groups + g: channels
// 8g .. 8g + 7 of output pixel (oy, ox).
template <bool RELU, bool F32>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const uint4* __restrict__ y, const float* __restrict__ bias,
            void* __restrict__ out, int h, int w, int c, int ho, int wo,
            unsigned int vectors) {
  extern __shared__ float sbias[];
  load_bias(sbias, bias, c);
  const unsigned int groups = static_cast<unsigned int>(c / kVec);
  const size_t row = static_cast<size_t>(w) * groups;      // uint4s an input row
  const unsigned int stride = gridDim.x * kThreads;
  for (unsigned int v = blockIdx.x * kThreads + threadIdx.x; v < vectors; v += stride) {
    const unsigned int g = v % groups;
    unsigned int p = v / groups;
    const unsigned int ox = p % wo;
    p /= wo;
    const unsigned int oy = p % ho;
    const unsigned int image = p / ho;
    const size_t at = ((static_cast<size_t>(image) * h + 2 * oy) * w + 2 * ox) * groups + g;
    Pack q[4];
    q[0].u = __ldcs(y + at);
    q[1].u = __ldcs(y + at + groups);
    q[2].u = __ldcs(y + at + row);
    q[3].u = __ldcs(y + at + row + groups);
    const float4 b0 = reinterpret_cast<const float4*>(sbias + g * kVec)[0];
    const float4 b1 = reinterpret_cast<const float4*>(sbias + g * kVec)[1];
    const float b[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) m = pool_step(m, act<RELU>(q[i].s[k], b[k]));
      r[k] = m;
    }
    store8<F32>(out, static_cast<size_t>(v) * kVec, r);
  }
}

template <bool RELU, bool F32>
int run(const void* y, const float* bias, void* out, int b, int c, int h, int w, bool pool,
        cudaStream_t st) {
  long long n = 0, vectors = 0;
  const int ho = h / 2, wo = w / 2;
  if (pool) {
    vectors = static_cast<long long>(b) * ho * wo * (c / kVec);
  } else {
    n = static_cast<long long>(b) * c * h * w;
    vectors = (n + kVec - 1) / kVec;
  }
  if (vectors == 0) return 0;
  if (vectors > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err) return err;
  const long long want = (vectors + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms > 0 ? sms : 1) * kBlocksPerSm;
  const unsigned int blocks = static_cast<unsigned int>(want < most ? want : most);
  const size_t smem = sizeof(float) * static_cast<size_t>(c);
  const unsigned int nv = static_cast<unsigned int>(vectors);
  if (pool)
    pool_kernel<RELU, F32><<<blocks, kThreads, smem, st>>>(
        static_cast<const uint4*>(y), bias, out, h, w, c, ho, wo, nv);
  else if (c % kVec == 0)
    flat_kernel<RELU, F32, true><<<blocks, kThreads, smem, st>>>(
        static_cast<const unsigned short*>(y), bias, out, n, nv, c);
  else
    flat_kernel<RELU, F32, false><<<blocks, kThreads, smem, st>>>(
        static_cast<const unsigned short*>(y), bias, out, n, nv, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (b, c, h, w) bf16, dense channels-last, 16-byte aligned; bias: (c)
// float32; out: (b, c, h, w), or (b, c, h / 2, w / 2) with `pool`,
// channels-last, bf16 or, with `out_f32`, float32.  1 <= c <= kMaxChannels;
// with `pool`, c % 8 == 0.  One launch on `stream`; returns the first
// cudaError_t (0 on success).
extern "C" int conv_epilogue_launch(const void* y, const float* bias, void* out, int b, int c,
                                    int h, int w, int relu, int pool, int out_f32,
                                    void* stream) {
  if (b < 0 || h < 0 || w < 0 || c < 1 || c > kMaxChannels || (pool && c % kVec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu)
    return out_f32 ? run<true, true>(y, bias, out, b, c, h, w, pool, st)
                   : run<true, false>(y, bias, out, b, c, h, w, pool, st);
  return out_f32 ? run<false, true>(y, bias, out, b, c, h, w, pool, st)
                 : run<false, false>(y, bias, out, b, c, h, w, pool, st);
}
