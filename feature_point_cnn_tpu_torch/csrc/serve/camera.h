// Frame sources for the port's native serving host (superpoint_serve.cc).
//
// The port's own copy of the JAX package's `csrc/camera.{h,cc}`, the
// counterpart of the reference's OpenCV camera wrapper
// (cv::VideoCapture(CAP_V4L2) → resize → grayscale → float [0,1]).  This
// implementation talks V4L2 directly (mmap streaming ioctls, YUYV/GREY pixel
// formats) so the serving binary needs no OpenCV; the same resize + gray
// conversions feed all three sources:
//
//   * SyntheticSource — drifting checkerboard (headless testing)
//   * RawFileSource   — raw float32 frames from a file (replay / testing)
//   * V4l2Camera      — live /dev/video* capture
//
// All sources produce NHWC float32 frames in [0, 1] with the gray value
// replicated across channels, matching the Python pipeline's
// `make_query_image` contract (inference/camera.py).

#ifndef FPC_CAMERA_H_
#define FPC_CAMERA_H_

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace fpc {

// --- pure conversion helpers (unit-tested in camera_selftest.cc) ------------

// YUYV 4:2:2 → gray float [0,1]; takes the luma byte of each pixel.
void YuyvToGrayF32(const uint8_t* yuyv, int width, int height, float* gray);

// 8-bit gray → float [0,1].
void GreyToGrayF32(const uint8_t* grey, int width, int height, float* gray);

// Bilinear resize of a single-channel float image.
void ResizeBilinear(const float* src, int src_h, int src_w, float* dst,
                    int dst_h, int dst_w);

// Replicate a gray (h, w) plane into an NHWC (h, w, c) frame buffer.
void ReplicateChannels(const float* gray, int h, int w, int c, float* out);

// --- frame sources -----------------------------------------------------------

class FrameSource {
 public:
  virtual ~FrameSource() = default;
  // Fill `dst` with one (h, w, c) float32 frame; false when exhausted.
  virtual bool GetFrame(float* dst, int h, int w, int c) = 0;
};

class SyntheticSource : public FrameSource {
 public:
  bool GetFrame(float* dst, int h, int w, int c) override;

 private:
  int frame_ = 0;
};

class RawFileSource : public FrameSource {
 public:
  // The file holds concatenated raw (h, w, c) float32 frames; frames
  // replay in order, then the source reports exhaustion.
  explicit RawFileSource(const std::string& path);
  bool GetFrame(float* dst, int h, int w, int c) override;

 private:
  std::vector<char> data_;
  size_t offset_ = 0;
};

// Live V4L2 capture (streaming mmap I/O).  Negotiates YUYV or GREY at the
// camera's native resolution and bilinearly resizes to the requested output
// size per frame, like the reference's cv::resize path.
class V4l2Camera : public FrameSource {
 public:
  explicit V4l2Camera(const std::string& device);  // throws on failure
  ~V4l2Camera() override;
  bool GetFrame(float* dst, int h, int w, int c) override;

  int native_width() const { return width_; }
  int native_height() const { return height_; }

 private:
  struct Buffer {
    void* start = nullptr;
    size_t length = 0;
  };
  int fd_ = -1;
  int width_ = 0;
  int height_ = 0;
  uint32_t pixel_format_ = 0;
  std::vector<Buffer> buffers_;
  std::vector<float> gray_native_;  // conversion scratch, native resolution
};

// Parse a --source spec: "synthetic", a /dev/video* path (or bare camera
// index like the reference CLI), or a raw frame file path.
std::unique_ptr<FrameSource> OpenSource(const std::string& spec);

}  // namespace fpc

#endif  // FPC_CAMERA_H_
