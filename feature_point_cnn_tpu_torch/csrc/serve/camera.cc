#include "camera.h"

#include <fcntl.h>
#include <linux/videodev2.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/select.h>
#include <unistd.h>

#include <cerrno>
#include <cmath>
#include <cstring>
#include <fstream>
#include <stdexcept>

namespace fpc {

// --- conversions -------------------------------------------------------------

void YuyvToGrayF32(const uint8_t* yuyv, int width, int height, float* gray) {
  const int n = width * height;
  for (int i = 0; i < n; ++i) {
    gray[i] = static_cast<float>(yuyv[2 * i]) * (1.0f / 255.0f);
  }
}

void GreyToGrayF32(const uint8_t* grey, int width, int height, float* gray) {
  const int n = width * height;
  for (int i = 0; i < n; ++i) {
    gray[i] = static_cast<float>(grey[i]) * (1.0f / 255.0f);
  }
}

void ResizeBilinear(const float* src, int src_h, int src_w, float* dst,
                    int dst_h, int dst_w) {
  if (src_h == dst_h && src_w == dst_w) {
    std::memcpy(dst, src, sizeof(float) * static_cast<size_t>(src_h) * src_w);
    return;
  }
  // align-corners=false sampling (matches cv2.resize INTER_LINEAR)
  const float sy = static_cast<float>(src_h) / static_cast<float>(dst_h);
  const float sx = static_cast<float>(src_w) / static_cast<float>(dst_w);
  for (int y = 0; y < dst_h; ++y) {
    float fy = (static_cast<float>(y) + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < src_h ? y0 + 1 : src_h - 1;
    const float wy = fy - static_cast<float>(y0);
    for (int x = 0; x < dst_w; ++x) {
      float fx = (static_cast<float>(x) + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < src_w ? x0 + 1 : src_w - 1;
      const float wx = fx - static_cast<float>(x0);
      const float top = src[y0 * src_w + x0] * (1 - wx) + src[y0 * src_w + x1] * wx;
      const float bot = src[y1 * src_w + x0] * (1 - wx) + src[y1 * src_w + x1] * wx;
      dst[y * dst_w + x] = top * (1 - wy) + bot * wy;
    }
  }
}

void ReplicateChannels(const float* gray, int h, int w, int c, float* out) {
  for (int i = 0; i < h * w; ++i) {
    for (int ch = 0; ch < c; ++ch) out[i * c + ch] = gray[i];
  }
}

// --- synthetic ---------------------------------------------------------------

bool SyntheticSource::GetFrame(float* dst, int h, int w, int c) {
  const double t = 0.15 * static_cast<double>(frame_++);
  const double dx = 40.0 * std::sin(t), dy = 25.0 * std::cos(0.7 * t);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int board = (static_cast<int>((x + dx) / 40.0 + 1000.0) +
                   static_cast<int>((y + dy) / 40.0 + 1000.0)) %
                  2;
      float v = 0.25f + 0.55f * static_cast<float>(board);
      for (int ch = 0; ch < c; ++ch) dst[(y * w + x) * c + ch] = v;
    }
  }
  return true;
}

// --- raw file ----------------------------------------------------------------

RawFileSource::RawFileSource(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open frame file: " + path);
  data_.assign(std::istreambuf_iterator<char>(f),
               std::istreambuf_iterator<char>());
}

bool RawFileSource::GetFrame(float* dst, int h, int w, int c) {
  const size_t frame_bytes = sizeof(float) * static_cast<size_t>(h) * w * c;
  if (offset_ + frame_bytes > data_.size()) return false;
  std::memcpy(dst, data_.data() + offset_, frame_bytes);
  offset_ += frame_bytes;
  return true;
}

// --- V4L2 --------------------------------------------------------------------

namespace {
int xioctl(int fd, unsigned long request, void* arg) {
  int r;
  do {
    r = ioctl(fd, request, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}
}  // namespace

V4l2Camera::V4l2Camera(const std::string& device) {
  fd_ = open(device.c_str(), O_RDWR | O_NONBLOCK);
  if (fd_ < 0) {
    throw std::runtime_error("cannot open camera device: " + device + ": " +
                             std::strerror(errno));
  }
  v4l2_capability cap{};
  if (xioctl(fd_, VIDIOC_QUERYCAP, &cap) < 0 ||
      !(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE)) {
    close(fd_);
    throw std::runtime_error(device + " is not a V4L2 capture device");
  }

  // Negotiate format: prefer YUYV (ubiquitous webcam default), fall back to
  // 8-bit GREY; keep the driver's native resolution and resize on read.
  v4l2_format fmt{};
  fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  for (uint32_t want : {static_cast<uint32_t>(V4L2_PIX_FMT_YUYV),
                        static_cast<uint32_t>(V4L2_PIX_FMT_GREY)}) {
    fmt.fmt.pix.pixelformat = want;
    fmt.fmt.pix.width = 640;
    fmt.fmt.pix.height = 480;
    fmt.fmt.pix.field = V4L2_FIELD_NONE;
    if (xioctl(fd_, VIDIOC_S_FMT, &fmt) == 0 &&
        fmt.fmt.pix.pixelformat == want) {
      pixel_format_ = want;
      break;
    }
  }
  if (pixel_format_ == 0) {
    close(fd_);
    throw std::runtime_error(device + ": no YUYV/GREY format available");
  }
  width_ = static_cast<int>(fmt.fmt.pix.width);
  height_ = static_cast<int>(fmt.fmt.pix.height);
  gray_native_.resize(static_cast<size_t>(width_) * height_);

  v4l2_requestbuffers req{};
  req.count = 4;
  req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  req.memory = V4L2_MEMORY_MMAP;
  if (xioctl(fd_, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
    close(fd_);
    throw std::runtime_error(device + ": mmap streaming unsupported");
  }
  buffers_.resize(req.count);
  for (uint32_t i = 0; i < req.count; ++i) {
    v4l2_buffer buf{};
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = i;
    if (xioctl(fd_, VIDIOC_QUERYBUF, &buf) < 0) {
      throw std::runtime_error(device + ": QUERYBUF failed");
    }
    buffers_[i].length = buf.length;
    buffers_[i].start = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                             MAP_SHARED, fd_, buf.m.offset);
    if (buffers_[i].start == MAP_FAILED) {
      throw std::runtime_error(device + ": mmap failed");
    }
    if (xioctl(fd_, VIDIOC_QBUF, &buf) < 0) {
      throw std::runtime_error(device + ": QBUF failed");
    }
  }
  v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(fd_, VIDIOC_STREAMON, &type) < 0) {
    throw std::runtime_error(device + ": STREAMON failed");
  }
}

V4l2Camera::~V4l2Camera() {
  if (fd_ >= 0) {
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(fd_, VIDIOC_STREAMOFF, &type);
    for (auto& b : buffers_) {
      if (b.start != nullptr && b.start != MAP_FAILED) munmap(b.start, b.length);
    }
    close(fd_);
  }
}

bool V4l2Camera::GetFrame(float* dst, int h, int w, int c) {
  fd_set fds;
  FD_ZERO(&fds);
  FD_SET(fd_, &fds);
  timeval tv{};
  tv.tv_sec = 2;
  if (select(fd_ + 1, &fds, nullptr, nullptr, &tv) <= 0) return false;

  v4l2_buffer buf{};
  buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  buf.memory = V4L2_MEMORY_MMAP;
  if (xioctl(fd_, VIDIOC_DQBUF, &buf) < 0) return false;

  const uint8_t* raw = static_cast<const uint8_t*>(buffers_[buf.index].start);
  if (pixel_format_ == V4L2_PIX_FMT_YUYV) {
    YuyvToGrayF32(raw, width_, height_, gray_native_.data());
  } else {
    GreyToGrayF32(raw, width_, height_, gray_native_.data());
  }
  xioctl(fd_, VIDIOC_QBUF, &buf);

  std::vector<float> resized(static_cast<size_t>(h) * w);
  ResizeBilinear(gray_native_.data(), height_, width_, resized.data(), h, w);
  ReplicateChannels(resized.data(), h, w, c, dst);
  return true;
}

// --- factory -----------------------------------------------------------------

std::unique_ptr<FrameSource> OpenSource(const std::string& spec) {
  if (spec.empty() || spec == "synthetic") {
    return std::make_unique<SyntheticSource>();
  }
  if (spec.rfind("/dev/video", 0) == 0) {
    return std::make_unique<V4l2Camera>(spec);
  }
  // bare camera index, like the reference CLI's `--source 0`
  if (spec.find_first_not_of("0123456789") == std::string::npos) {
    return std::make_unique<V4l2Camera>("/dev/video" + spec);
  }
  return std::make_unique<RawFileSource>(spec);
}

}  // namespace fpc
