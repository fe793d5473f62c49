// fpc_ops: the decode and NMS kernels as the operators fpc::decode_threshold
// and fpc::grid_nms, for the native host (superpoint_serve.cc).
//
// An AOTInductor package of the frame program (`SuperPointFrontend.
// export_native`) calls these two operators through the dispatcher.  In
// Python they are `torch.library` ops (`ops/kernels/decode.py`, `nms.py`);
// a C++ process has no Python, so this library defines the same schemas,
// letter for letter (tests/test_torch_export.py holds them equal), and
// their CUDA implementations: each allocates its outputs with at::empty and
// calls the kernel's C launcher (`csrc/decode_threshold.cu`,
// `csrc/grid_nms.cu`) on the current stream, as the Python wrappers do.
// There is no CPU implementation: a CPU package holds the plain versions
// inline and needs no op library.  Python never loads this file, so the
// two registrations cannot collide.
//
// Built by inference/native.py into a shared library that the host links
// with --no-as-needed, so that the static registrars below run.

#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include "nms_layout.h"

extern "C" int decode_threshold_launch(const float* logits, float* out, int b,
                                       int hc, int wc, float threshold,
                                       void* stream);
extern "C" int grid_nms_launch(const float* scores, float* out, float* key_scratch,
                               unsigned char* flag_scratch, int* rounds, int b,
                               int h, int w, int r, int cluster,
                               int band_in_shared, void* stream);

namespace {

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA error ", err);
}

at::Tensor decode_threshold_cuda(const at::Tensor& logits_in, int64_t cell,
                                 double threshold) {
  TORCH_CHECK(cell == 8 && logits_in.dim() == 4 && logits_in.size(3) == 65,
              "the decode kernel takes cell 8 and (B, Hc, Wc, 65) logits, got cell ",
              cell, ", ", logits_in.sizes());
  TORCH_CHECK(logits_in.scalar_type() == at::kFloat, "want float32 logits, got ",
              logits_in.scalar_type());
  const at::Tensor logits = logits_in.contiguous();
  const c10::cuda::CUDAGuard guard(logits.device());
  const int64_t b = logits.size(0), hc = logits.size(1), wc = logits.size(2);
  at::Tensor out = at::empty({b, hc * cell, wc * cell}, logits.options());
  check_launch(decode_threshold_launch(
                   logits.data_ptr<float>(), out.data_ptr<float>(),
                   static_cast<int>(b), static_cast<int>(hc), static_cast<int>(wc),
                   static_cast<float>(threshold),
                   at::cuda::getCurrentCUDAStream().stream()),
               "decode_threshold_launch");
  return out;
}

std::tuple<at::Tensor, at::Tensor> grid_nms_cuda(const at::Tensor& scores_in,
                                                 int64_t dist_thresh) {
  TORCH_CHECK(scores_in.dim() == 3 && scores_in.scalar_type() == at::kFloat,
              "want (B, H, W) float32, got ", scores_in.sizes(), " ",
              scores_in.scalar_type());
  TORCH_CHECK(0 <= dist_thresh && dist_thresh <= 7,
              "the NMS kernel supports 0 <= dist_thresh <= 7");
  const at::Tensor scores = scores_in.contiguous();
  const c10::cuda::CUDAGuard guard(scores.device());
  const int64_t b = scores.size(0), h = scores.size(1), w = scores.size(2);
  const fpc::NmsLayout layout = fpc::nms_layout(h, w, dist_thresh);
  at::Tensor out = at::empty_like(scores);
  at::Tensor rounds = at::empty({b}, scores.options().dtype(at::kInt));
  if (h * w == 0) rounds.zero_();
  at::Tensor scratch;
  float* key = nullptr;
  unsigned char* flag = nullptr;
  if (!layout.band_in_shared) {
    scratch = at::empty({fpc::kNmsStateBytes * scores.numel()},
                        scores.options().dtype(at::kByte));
    key = reinterpret_cast<float*>(scratch.data_ptr<uint8_t>());
    flag = scratch.data_ptr<uint8_t>() + 4 * scores.numel();
  }
  check_launch(grid_nms_launch(scores.data_ptr<float>(), out.data_ptr<float>(), key,
                               flag, rounds.data_ptr<int>(), static_cast<int>(b),
                               static_cast<int>(h), static_cast<int>(w),
                               static_cast<int>(dist_thresh), layout.cluster,
                               layout.band_in_shared ? 1 : 0,
                               at::cuda::getCurrentCUDAStream().stream()),
               "grid_nms_launch");
  return {out, rounds};
}

}  // namespace

TORCH_LIBRARY(fpc, m) {
  m.def("decode_threshold(Tensor logits, int cell, float threshold) -> Tensor");
  m.def("grid_nms(Tensor scores, int dist_thresh) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(fpc, CUDA, m) {
  m.impl("decode_threshold", &decode_threshold_cuda);
  m.impl("grid_nms", &grid_nms_cuda);
}
