// superpoint_serve: native real-time feature serving over LibTorch.
//
// The port's counterpart of the JAX package's csrc/superpoint_serve.cc.  It
// loads the AOTInductor package of the frame program (detect + describe +
// match against a fed-back keyframe; `SuperPointFrontend.export_native`
// writes model.pt2 and meta.json) and streams frames through it.  Matching
// happens inside the program, so the host only feeds frames and reads
// fixed-size results.  On the card the package reaches the decode and NMS
// kernels through the fpc operators, which the op library (fpc_ops.cc,
// linked in) registers; a CPU package holds their plain versions inline.
//
// Frame sources (camera.{h,cc}):
//   --source synthetic      drifting checkerboard (default; no hardware)
//   --source /dev/videoN    live V4L2 capture (also a bare camera index "N")
//   --source frames.raw     replay of concatenated raw float32 HWC frames
//   --input frame.raw       one static raw frame repeated every iteration
//
// The frame loop is a software pipeline (--pipeline N, default 2): frame
// f+1 is staged in pinned host memory, uploaded and executed on the stream
// BEFORE the host waits for frame f's readback, so consecutive frames'
// copies and host work overlap.  The keyframe's descriptors and count stay
// on the device and feed the next executes without a host round trip.
//
// Usage:
//   superpoint_serve --model DIR [--device cuda|cpu] [--frames 20]
//                    [--source SPEC] [--input frame.raw] [--pipeline N[,N...]]
//
// --device cuda (the default) exits non-zero when no GPU is visible; the
// host never falls back to the CPU on its own.

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#ifdef FPC_WITH_CUDA
#include <ATen/cuda/CUDAEvent.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <optional>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "camera.h"

namespace {

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// --- minimal parsing of the known meta.json layout ---------------------------

long json_int(const std::string& s, const std::string& key) {
  auto pos = s.find("\"" + key + "\"");
  if (pos == std::string::npos) throw std::runtime_error("meta missing " + key);
  pos = s.find(':', pos);
  return std::strtol(s.c_str() + pos + 1, nullptr, 10);
}

std::vector<long> json_int_list(const std::string& s, const std::string& key) {
  auto pos = s.find("\"" + key + "\"");
  if (pos == std::string::npos) throw std::runtime_error("meta missing " + key);
  auto open = s.find('[', pos);
  auto close = s.find(']', open);
  std::vector<long> out;
  const char* p = s.c_str() + open + 1;
  while (p < s.c_str() + close) {
    char* end = nullptr;
    long v = std::strtol(p, &end, 10);
    if (end == p) break;
    out.push_back(v);
    p = end + 1;
  }
  return out;
}

std::string json_str(const std::string& s, const std::string& key) {
  auto pos = s.find("\"" + key + "\"");
  if (pos == std::string::npos) throw std::runtime_error("meta missing " + key);
  auto q1 = s.find('"', s.find(':', pos));
  auto q2 = s.find('"', q1 + 1);
  return s.substr(q1 + 1, q2 - q1 - 1);
}

at::ScalarType dtype_of(const std::string& name) {
  if (name == "f32") return at::kFloat;
  if (name == "f16") return at::kHalf;
  if (name == "s32") return at::kInt;
  if (name == "s16") return at::kShort;
  if (name == "u8") return at::kByte;
  if (name == "pred") return at::kBool;
  throw std::runtime_error("unknown dtype " + name);
}

struct Spec {
  std::string name;
  std::vector<int64_t> shape;
  at::ScalarType type;
};

// Parse the "inputs"/"outputs" arrays of meta.json.
std::vector<Spec> parse_specs(const std::string& s, const std::string& section) {
  std::vector<Spec> specs;
  const auto pos = s.find("\"" + section + "\"");
  if (pos == std::string::npos) throw std::runtime_error("meta missing " + section);
  size_t section_end = s.find('[', pos);
  for (int depth = 0; section_end < s.size(); ++section_end) {
    if (s[section_end] == '[') depth++;
    if (s[section_end] == ']' && --depth == 0) break;
  }
  for (auto obj = s.find('{', pos); obj != std::string::npos && obj < section_end;
       obj = s.find('{', obj + 1)) {
    const std::string body = s.substr(obj, s.find('}', obj) - obj + 1);
    Spec spec;
    spec.name = json_str(body, "name");
    for (long d : json_int_list(body, "shape")) spec.shape.push_back(d);
    spec.type = dtype_of(json_str(body, "dtype"));
    specs.push_back(spec);
  }
  return specs;
}

// A frame's readback is complete once its fence is waited on: a CUDA event
// recorded after the copies on the card; on the CPU every copy is already
// synchronous.
class Fence {
 public:
  void record(const at::Device& device) {
#ifdef FPC_WITH_CUDA
    if (device.is_cuda()) {
      event_ = std::make_shared<at::cuda::CUDAEvent>();
      event_->record();
    }
#else
    (void)device;
#endif
  }
  void wait() {
#ifdef FPC_WITH_CUDA
    if (event_) event_->synchronize();
#endif
  }

 private:
#ifdef FPC_WITH_CUDA
  std::shared_ptr<at::cuda::CUDAEvent> event_;
#endif
};

}  // namespace

int main(int argc, char** argv) {
  setvbuf(stdout, nullptr, _IOLBF, 0);
  std::string model_dir;
  std::string device_name = "cuda";
  std::string input_file;
  std::string source = "synthetic";
  int frames = 20;
  std::string pipeline = "2";
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) throw std::runtime_error("missing value for " + a);
      return argv[++i];
    };
    if (a == "--model") model_dir = next();
    else if (a == "--device") device_name = next();
    else if (a == "--frames") frames = std::atoi(next().c_str());
    else if (a == "--input") input_file = next();
    else if (a == "--source") source = next();
    else if (a == "--pipeline") pipeline = next();
    else {
      std::fprintf(stderr,
                   "usage: %s --model DIR [--device cuda|cpu] [--frames N] "
                   "[--input frame.raw] [--pipeline N[,N,...]] "
                   "[--source synthetic|N|/dev/videoN|frames.raw]\n",
                   argv[0]);
      return 2;
    }
  }
  if (model_dir.empty()) {
    std::fprintf(stderr, "error: --model is required\n");
    return 2;
  }

  try {
    const std::string meta = read_file(model_dir + "/meta.json");
    const long h = json_int_list(meta, "image_size")[0];
    const long w = json_int_list(meta, "image_size")[1];
    const long c = json_int(meta, "channels");
    const long k = json_int(meta, "max_keypoints");
    // "packed": num_valid + the top-N rows (f32 coordinates, f16
    // descriptors) instead of the full fixed-K f32 arrays
    const bool packed = json_str(meta, "abi") == "packed";
    const long top_n = packed ? json_int(meta, "top_n") : k;
    const long batch = json_int(meta, "batch");
    const auto in_specs = parse_specs(meta, "inputs");
    if (!packed && batch != 1) {
      // the full-ABI retire path counts over fixed k with no padding mask
      throw std::runtime_error("the full ABI takes batch 1 (got " +
                               std::to_string(batch) + ")");
    }

    if (device_name != "cuda" && device_name != "cpu") {
      throw std::runtime_error("--device must be cuda or cpu, got " + device_name);
    }
    const bool cuda = device_name == "cuda";
#ifndef FPC_WITH_CUDA
    if (cuda) {
      throw std::runtime_error(
          "this host was built without CUDA; build it for the card, or pass "
          "--device cpu with a CPU package");
    }
#endif
    if (cuda && !torch::cuda::is_available()) {
      throw std::runtime_error(
          "no CUDA device is available; pass --device cpu to run a CPU package");
    }
    const at::Device device = cuda ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);
#ifdef FPC_WITH_CUDA
    // every copy and execute of this process runs on one stream of the pool
    std::optional<c10::cuda::CUDAStreamGuard> stream_guard;
    if (cuda) stream_guard.emplace(c10::cuda::getStreamFromPool(false, 0));
    void* stream = cuda ? c10::cuda::getCurrentCUDAStream(0).stream() : nullptr;
#else
    void* stream = nullptr;
#endif
    std::printf("[serve] device=%s\n", device.str().c_str());

    auto t0 = std::chrono::steady_clock::now();
    torch::inductor::AOTIModelPackageLoader loader(model_dir + "/model.pt2", "model",
                                                   false, 1, cuda ? 0 : -1);
    auto t1 = std::chrono::steady_clock::now();
    std::printf("[serve] loaded %s in %.1fs\n", model_dir.c_str(),
                std::chrono::duration<double>(t1 - t0).count());

    // inputs: image + keyframe feedback pair
    //   full:   (key_desc (K,D) f32, key_valid (K) pred)
    //   packed: (key_desc (N,D) f16, key_num s32 scalar)
    auto host_array = [&](const Spec& spec) {
      return at::zeros(spec.shape, at::TensorOptions().dtype(spec.type).pinned_memory(cuda));
    };
    // u8 bundles (export --input-dtype u8 [--gray]) take raw uint8 pixels and
    // normalize on the device; frame sources produce float [0,1], quantized
    // here at staging time (exact for camera frames, which are u8)
    const bool u8_input = in_specs[0].type == at::kByte;
    const long frame_elems = h * w * c;
    std::vector<float> fframe(static_cast<size_t>(frame_elems));
    auto stage_frame = [&](const float* src, long b, at::Tensor& image) {
      if (u8_input) {
        uint8_t* dst = image.data_ptr<uint8_t>() + b * frame_elems;
        for (long i = 0; i < frame_elems; ++i) {
          float v = src[i] * 255.0f + 0.5f;
          dst[i] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
        }
      } else {
        std::memcpy(image.data_ptr<float>() + b * frame_elems, src,
                    sizeof(float) * frame_elems);
      }
    };

    std::optional<at::Tensor> fixed_image;  // --input: staged once
    std::unique_ptr<fpc::FrameSource> frame_source;
    if (!input_file.empty()) {
      const std::string raw = read_file(input_file);
      const size_t f32_frame_bytes = sizeof(float) * frame_elems;
      const float* src = reinterpret_cast<const float*>(raw.data());
      fixed_image = host_array(in_specs[0]);
      if (raw.size() == f32_frame_bytes) {  // one frame: replicate per batch
        for (long b = 0; b < batch; ++b) stage_frame(src, b, *fixed_image);
      } else if (raw.size() == f32_frame_bytes * batch) {
        for (long b = 0; b < batch; ++b) stage_frame(src + b * frame_elems, b, *fixed_image);
      } else {
        throw std::runtime_error("--input size mismatch: want " +
                                 std::to_string(f32_frame_bytes) + " or " +
                                 std::to_string(f32_frame_bytes * batch) +
                                 " bytes of raw f32 HWC");
      }
    } else {
      frame_source = fpc::OpenSource(source);
    }

    // per-frame host readback: what a consumer needs (keypoint coordinates
    // and scores, match indices); descriptors stay on the device
    const std::vector<size_t> fetch_idx =
        packed ? std::vector<size_t>{0, 1, 2}           // num_valid, kp_packed, match
               : std::vector<size_t>{0, 1, 2, 3, 4, 5};  // y, x, score, valid, m, mv
    const auto out_specs = parse_specs(meta, "outputs");
    size_t fetch_bytes = 0;
    for (size_t i : fetch_idx) {
      size_t n = at::elementSize(out_specs[i].type);
      for (int64_t d : out_specs[i].shape) n *= d;
      fetch_bytes += n;
    }
    std::printf("[serve] abi=%s top_n=%ld batch=%ld readback=%zu bytes/exec\n",
                packed ? "packed" : "full", top_n, batch, fetch_bytes);

    // --pipeline takes a comma list ("1,2,4,8"): every depth runs in this
    // process, on the package loaded once
    std::vector<int> depths;
    for (const char* p = pipeline.c_str(); *p != 0;) {
      char* end = nullptr;
      long v = std::strtol(p, &end, 10);
      if (end == p || (*end != 0 && *end != ',')) {
        std::fprintf(stderr, "[serve] bad --pipeline value %s (want e.g. 1,2,4,8)\n",
                     pipeline.c_str());
        return 2;
      }
      depths.push_back(static_cast<int>(v));
      p = (*end == ',') ? end + 1 : end;
    }
    if (depths.empty()) depths.push_back(2);
    // the keyframe outputs: packed (desc, num_valid), or at batch > 1
    // (key_desc_out, key_num_out); full (desc, valid)
    const size_t desc_i = packed ? (batch > 1 ? 4 : 3) : 6;
    const size_t num_i = packed ? (batch > 1 ? 5 : 0) : 3;
    bool src_drained = false;
    for (size_t di = 0; di < depths.size(); ++di) {
      if (src_drained) {
        std::string rest;
        for (size_t j = di; j < depths.size(); ++j)
          rest += (j > di ? "," : "") + std::to_string(depths[j]);
        std::printf("[serve] source drained; skipping remaining depths %s\n", rest.c_str());
        break;
      }
      const int depth = depths[di] < 1 ? 1 : depths[di];
      if (depths.size() > 1) std::printf("[serve] === pipeline depth %d ===\n", depth);
      long total_matches = 0;
      long steady_frames = 0;  // real (non-padding) frames past the keyframe
      int done = 0;
      // device-resident keyframe state, re-seeded per depth so every sweep
      // point starts from the same state
      at::Tensor key_desc_dev = host_array(in_specs[1]).to(device);
      at::Tensor key_valid_dev = host_array(in_specs[2]).to(device);
      // one pinned staging buffer per frame that can be in flight: frame f
      // reuses f - depth's, which has been retired by then
      std::vector<at::Tensor> staging;
      for (int s = 0; s < depth && frame_source; ++s) staging.push_back(host_array(in_specs[0]));

      struct InFlight {
        int index = 0;
        long real = 0;  // real frames staged (< batch when the source drained)
        std::vector<at::Tensor> outs;
        std::vector<at::Tensor> fetched;  // host copies, complete once waited
        Fence fence;
        std::chrono::steady_clock::time_point issued;
      };
      std::deque<InFlight> in_flight;

      auto retire = [&](InFlight& fl) {
        fl.fence.wait();
        auto s1 = std::chrono::steady_clock::now();
        long n_kp = 0, n_match = 0;
        if (packed) {
          const int32_t* nv = fl.fetched[0].data_ptr<int32_t>();
          for (long b = 0; b < fl.real; ++b) n_kp += nv[b];
          const int32_t* mi = fl.fetched[2].data_ptr<int32_t>();
          for (long i = 0; i < fl.real * top_n; ++i) n_match += mi[i] >= 0;
        } else {
          const bool* valid = fl.fetched[3].data_ptr<bool>();
          const bool* match_valid = fl.fetched[5].data_ptr<bool>();
          for (long i = 0; i < k; ++i) {
            n_kp += valid[i];
            n_match += match_valid[i];
          }
        }
        if (fl.index > 0) {
          total_matches += n_match;
          steady_frames += fl.real;
        }
        if (fl.index < 3 || fl.index + 1 == frames) {
          std::printf("[serve] exec %3d: keypoints=%4ld matches=%4ld (latency %.2f ms)\n",
                      fl.index, n_kp, n_match,
                      1e3 * std::chrono::duration<double>(s1 - fl.issued).count());
        }
        done = fl.index + 1;
      };

      std::chrono::steady_clock::time_point steady_t0;
      bool exhausted = false;
      for (int f = 0; f < frames && !exhausted; ++f) {
        at::Tensor image = fixed_image ? *fixed_image : staging[f % depth];
        long staged = frame_source ? 0 : batch;
        for (long b = 0; frame_source && b < batch; ++b) {
          if (!frame_source->GetFrame(fframe.data(), static_cast<int>(h),
                                      static_cast<int>(w), static_cast<int>(c))) {
            std::printf("[serve] frame source exhausted after %d executes\n", f);
            exhausted = true;
            break;
          }
          stage_frame(fframe.data(), b, image);
          staged = b + 1;
        }
        if (exhausted) {
          if (staged == 0) break;
          // pad the tail with the last real frame so the partial batch still
          // executes; retire() counts only the `real` slots
          for (long b = staged; b < batch; ++b) image[b].copy_(image[staged - 1]);
        }
        InFlight fl;
        fl.index = f;
        fl.real = staged;
        fl.issued = std::chrono::steady_clock::now();
        fl.outs = loader.run({image.to(device, /*non_blocking=*/true), key_desc_dev,
                              key_valid_dev},
                             stream);
        for (size_t i : fetch_idx) {
          // a non-blocking copy to the host lands in pinned memory
          fl.fetched.push_back(fl.outs[i].to(at::kCPU, /*non_blocking=*/true));
        }
        fl.fence.record(device);

        if (f == 0) {
          // the first frame becomes the keyframe: its descriptors and count
          // feed the later executes as device tensors.  Retired at once, so
          // the steady-state clock starts clean.
          key_desc_dev = fl.outs[desc_i];
          key_valid_dev = fl.outs[num_i];
          retire(fl);
          steady_t0 = std::chrono::steady_clock::now();
          continue;
        }
        in_flight.push_back(std::move(fl));
        while (static_cast<int>(in_flight.size()) >= depth) {
          retire(in_flight.front());
          in_flight.pop_front();
        }
      }
      while (!in_flight.empty()) {
        retire(in_flight.front());
        in_flight.pop_front();
      }
      if (done > 1) {
        const double steady_s =
            std::chrono::duration<double>(std::chrono::steady_clock::now() - steady_t0)
                .count();
        std::printf(
            "[serve] steady-state: %.1f FPS (pipeline depth %d, batch %ld), "
            "mean matches/frame %.1f\n",
            steady_frames / steady_s, depth, batch,
            static_cast<double>(total_matches) / steady_frames);
      }
      src_drained = src_drained || exhausted;
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "[serve] FATAL: %s\n", e.what());
    return 1;
  }
  return 0;
}
