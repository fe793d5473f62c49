// Hardware-free unit checks for the camera/frame-source module (built by
// inference/native.py and run by tests/test_torch_export.py).  Exits 0 on success.

#include "camera.h"

#include <unistd.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::fprintf(stderr, "FAILED %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      return 1;                                                       \
    }                                                                 \
  } while (0)

int main() {
  // YUYV → gray: luma bytes at even offsets, chroma ignored
  {
    const uint8_t yuyv[] = {0, 128, 255, 128, 51, 0, 102, 255};  // 4 px
    float gray[4];
    fpc::YuyvToGrayF32(yuyv, 4, 1, gray);
    CHECK(gray[0] == 0.0f && gray[1] == 1.0f);
    CHECK(std::fabs(gray[2] - 0.2f) < 1e-6 && std::fabs(gray[3] - 0.4f) < 1e-6);
  }

  // GREY → gray
  {
    const uint8_t grey[] = {0, 255, 128};
    float gray[3];
    fpc::GreyToGrayF32(grey, 3, 1, gray);
    CHECK(gray[0] == 0.0f && gray[1] == 1.0f);
    CHECK(std::fabs(gray[2] - 128.0f / 255.0f) < 1e-6);
  }

  // resize: constant image stays constant at any scale
  {
    std::vector<float> src(17 * 23, 0.625f), dst(480 * 640);
    fpc::ResizeBilinear(src.data(), 17, 23, dst.data(), 480, 640);
    for (float v : dst) CHECK(std::fabs(v - 0.625f) < 1e-6);
  }

  // resize: identity size is an exact copy; 2x down of a linear ramp keeps
  // values inside the source range and monotone along the ramp
  {
    std::vector<float> src(8 * 8);
    for (int i = 0; i < 64; ++i) src[i] = static_cast<float>(i % 8) / 7.0f;
    std::vector<float> same(8 * 8);
    fpc::ResizeBilinear(src.data(), 8, 8, same.data(), 8, 8);
    CHECK(std::memcmp(src.data(), same.data(), sizeof(float) * 64) == 0);
    std::vector<float> half(4 * 4);
    fpc::ResizeBilinear(src.data(), 8, 8, half.data(), 4, 4);
    for (int y = 0; y < 4; ++y)
      for (int x = 1; x < 4; ++x) {
        CHECK(half[y * 4 + x] > half[y * 4 + x - 1]);
        CHECK(half[y * 4 + x] >= 0.0f && half[y * 4 + x] <= 1.0f);
      }
  }

  // channel replication
  {
    const float gray[] = {0.25f, 0.75f};
    float out[6];
    fpc::ReplicateChannels(gray, 1, 2, 3, out);
    for (int ch = 0; ch < 3; ++ch) {
      CHECK(out[ch] == 0.25f && out[3 + ch] == 0.75f);
    }
  }

  // synthetic source produces in-range frames and advances in time
  {
    fpc::SyntheticSource s;
    std::vector<float> a(32 * 32 * 3), b(32 * 32 * 3);
    CHECK(s.GetFrame(a.data(), 32, 32, 3));
    for (int i = 0; i < 10; ++i) CHECK(s.GetFrame(b.data(), 32, 32, 3));
    for (float v : a) CHECK(v >= 0.0f && v <= 1.0f);
    CHECK(std::memcmp(a.data(), b.data(), a.size() * sizeof(float)) != 0);
  }

  // raw-file source round trip + exhaustion, in a file of its own under
  // $TMPDIR, so that runs side by side do not share it
  {
    const char* dir = std::getenv("TMPDIR");
    std::string name = std::string(dir && *dir ? dir : P_tmpdir) +
                       "/fpc_camera_selftest_XXXXXX";
    const int fd = mkstemp(name.data());
    CHECK(fd >= 0);
    close(fd);
    const char* path = name.c_str();
    std::vector<float> frames(2 * 4 * 4 * 1);
    for (size_t i = 0; i < frames.size(); ++i)
      frames[i] = static_cast<float>(i) * 0.01f;
    std::ofstream(path, std::ios::binary)
        .write(reinterpret_cast<const char*>(frames.data()),
               static_cast<long>(frames.size() * sizeof(float)));
    auto src = fpc::OpenSource(path);
    std::vector<float> got(4 * 4);
    CHECK(src->GetFrame(got.data(), 4, 4, 1));
    CHECK(std::memcmp(got.data(), frames.data(), 16 * sizeof(float)) == 0);
    CHECK(src->GetFrame(got.data(), 4, 4, 1));
    CHECK(!src->GetFrame(got.data(), 4, 4, 1));  // exhausted
    std::remove(path);
  }

  // factory: "synthetic" and numeric specs route correctly; a missing
  // camera device fails with a clear error instead of crashing
  {
    CHECK(dynamic_cast<fpc::SyntheticSource*>(
              fpc::OpenSource("synthetic").get()) != nullptr);
    bool threw = false;
    try {
      fpc::OpenSource("/dev/video99");
    } catch (const std::exception& e) {
      threw = std::string(e.what()).find("/dev/video99") != std::string::npos;
    }
    CHECK(threw);
  }

  std::printf("camera selftest OK\n");
  return 0;
}
