// Native batch WAV loader for the training input pipeline (the port's own
// copy of the JAX package's native/wavio.cpp).
//
// Role: the equivalent of the reference's DataLoader(num_workers=8..16)
// decode workers (ref: py/main14.py:383-385): the host-side decode path
// must outrun the device.  A std::thread pool
// reads and decodes WAV files (PCM 8/16/24/32 + IEEE float, mono-mix),
// resamples to the target rate (linear interpolation; corpus clips are
// normally already 16 kHz), and truncates/zero-pads each clip to a fixed
// length directly into the caller's batch buffer — one C call per batch,
// zero Python-loop overhead.
//
// Exposed via ctypes from awm_tpu_torch/data/native.py, which builds it on
// first use (g++ -O3 -shared) into awm_tpu_torch/data/_native/.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

// Returns false on any parse failure.
bool decode_wav(const uint8_t* data, size_t len, WavData* out) {
  if (len < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  while (pos + 8 <= len) {
    uint32_t chunk_size;
    std::memcpy(&chunk_size, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (std::memcmp(data + pos, "fmt ", 4) == 0 && chunk_size >= 16) {
      // Truncated fmt chunk: the declared size runs past EOF — reading the
      // fields below would be an out-of-bounds heap read.  Decode failure.
      if (pos + 8 + static_cast<size_t>(chunk_size) > len) return false;
      std::memcpy(&fmt_code, body, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(&sr, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
      if (fmt_code == 0xFFFE && chunk_size >= 26)  // EXTENSIBLE
        std::memcpy(&fmt_code, body + 24, 2);
    } else if (std::memcmp(data + pos, "data", 4) == 0) {
      pcm = body;
      pcm_len = std::min<size_t>(chunk_size, len - (pos + 8));
      break;
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!pcm || !channels || !sr) return false;

  size_t n = 0;
  out->channels = channels;
  out->sample_rate = static_cast<int>(sr);
  if (fmt_code == 1 && bits == 16) {
    n = pcm_len / 2;
    out->samples.resize(n);
    const int16_t* p = reinterpret_cast<const int16_t*>(pcm);
    for (size_t i = 0; i < n; ++i) out->samples[i] = p[i] / 32768.0f;
  } else if (fmt_code == 1 && bits == 32) {
    n = pcm_len / 4;
    out->samples.resize(n);
    const int32_t* p = reinterpret_cast<const int32_t*>(pcm);
    for (size_t i = 0; i < n; ++i)
      out->samples[i] = static_cast<float>(p[i] / 2147483648.0);
  } else if (fmt_code == 1 && bits == 24) {
    n = pcm_len / 3;
    out->samples.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v = pcm[3 * i] | (pcm[3 * i + 1] << 8) | (pcm[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out->samples[i] = v / 8388608.0f;
    }
  } else if (fmt_code == 1 && bits == 8) {
    n = pcm_len;
    out->samples.resize(n);
    for (size_t i = 0; i < n; ++i)
      out->samples[i] = (static_cast<int>(pcm[i]) - 128) / 128.0f;
  } else if (fmt_code == 3 && bits == 32) {
    n = pcm_len / 4;
    out->samples.resize(n);
    std::memcpy(out->samples.data(), pcm, n * 4);
  } else if (fmt_code == 3 && bits == 64) {
    n = pcm_len / 8;
    out->samples.resize(n);
    const double* p = reinterpret_cast<const double*>(pcm);
    for (size_t i = 0; i < n; ++i) out->samples[i] = static_cast<float>(p[i]);
  } else {
    return false;
  }
  n = (n / channels) * channels;
  out->samples.resize(n);
  return true;
}

// Decode one file into out[clip_len]: mono-mix, linear resample to
// target_sr, truncate / zero-pad to clip_len.  Returns 1 on success.
int load_clip_file(const char* path, float* out, long clip_len,
                   int target_sr) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return 0;
  std::streamsize size = f.tellg();
  f.seekg(0);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (!f.read(reinterpret_cast<char*>(buf.data()), size)) return 0;

  WavData wav;
  if (!decode_wav(buf.data(), buf.size(), &wav)) return 0;

  const long frames = static_cast<long>(wav.samples.size() / wav.channels);
  // mono mix in place
  std::vector<float> mono(frames);
  if (wav.channels == 1) {
    std::memcpy(mono.data(), wav.samples.data(), frames * sizeof(float));
  } else {
    const float inv = 1.0f / wav.channels;
    for (long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < wav.channels; ++c)
        acc += wav.samples[i * wav.channels + c];
      mono[i] = acc * inv;
    }
  }

  std::memset(out, 0, clip_len * sizeof(float));
  if (frames == 0) return 1;
  if (wav.sample_rate == target_sr) {
    const long n = std::min<long>(frames, clip_len);
    std::memcpy(out, mono.data(), n * sizeof(float));
  } else {
    const double step =
        static_cast<double>(wav.sample_rate) / static_cast<double>(target_sr);
    const long out_frames = std::min<long>(
        clip_len, static_cast<long>(frames / step));
    for (long i = 0; i < out_frames; ++i) {
      const double pos = i * step;
      const long i0 = static_cast<long>(pos);
      const long i1 = std::min(i0 + 1, frames - 1);
      const float frac = static_cast<float>(pos - i0);
      out[i] = mono[i0] * (1.0f - frac) + mono[i1] * frac;
    }
  }
  return 1;
}

}  // namespace

extern "C" {

// Load n clips in parallel into out[n * clip_len] (row-major).
// ok[i] is set 1/0 per file.  Returns the number of successes.
long awm_load_clips(const char** paths, long n, float* out, long clip_len,
                    int target_sr, int n_threads, int* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<long> next(0), good(0);
  auto worker = [&]() {
    while (true) {
      const long i = next.fetch_add(1);
      if (i >= n) break;
      const int r = load_clip_file(paths[i], out + i * clip_len, clip_len,
                                   target_sr);
      ok[i] = r;
      if (r) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  const int t = static_cast<int>(std::min<long>(n_threads, n));
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return good.load();
}

// Single-file decode for probing: returns frames written, -1 on failure.
long awm_load_clip(const char* path, float* out, long clip_len,
                   int target_sr) {
  return load_clip_file(path, out, clip_len, target_sr) ? clip_len : -1;
}

}  // extern "C"
