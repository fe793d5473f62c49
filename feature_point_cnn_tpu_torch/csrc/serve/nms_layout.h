// The NMS kernel's launch layout for (H, W) maps at radius r: the C++ copy
// of `ops/kernels/nms.py::nms_layout`, for the op library (fpc_ops.cc) that
// launches `grid_nms.cu` without Python.  tests/test_torch_export.py holds
// the two to the same answers.

#ifndef FPC_NMS_LAYOUT_H_
#define FPC_NMS_LAYOUT_H_

#include <cstdint>

namespace fpc {

struct NmsLayout {
  int cluster;          // CTAs holding one frame
  int64_t rows;         // rows of the tallest band
  int64_t smem_bytes;   // dynamic shared memory a CTA
  bool band_in_shared;  // false: the state lies in a device-memory scratch
};

constexpr int kNmsMaxCluster = 8;          // CTAs a cluster, the portable limit
constexpr int64_t kNmsSmemLimit = 232448;  // dynamic shared memory a CTA may use
constexpr int64_t kNmsSmemReserve = 64;    // the convergence slot and the mbarrier
constexpr int64_t kNmsStateBytes = 5;      // a pixel's remaining key and flags
constexpr int64_t kNmsStrip = 128;         // columns a warp task covers

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline NmsLayout nms_layout(int64_t h, int64_t w, int64_t r) {
  int cluster = kNmsMaxCluster;
  const int64_t min_rows = r > 1 ? r : 1;
  while (cluster > 1 && h / cluster < min_rows) cluster /= 2;
  const int64_t rows = ceil_div(h, cluster);
  const int64_t base =
      kNmsSmemReserve + ceil_div(4 * rows * ceil_div(w, kNmsStrip), 16) * 16;
  const bool in_shared = base + kNmsStateBytes * rows * w <= kNmsSmemLimit;
  return {cluster, rows, base + (in_shared ? kNmsStateBytes * rows * w : 0), in_shared};
}

}  // namespace fpc

#endif  // FPC_NMS_LAYOUT_H_
