// WAV read/write + linear resampler — native host I/O.
//
// Capability parity with the reference's io/wav_reader.{h,cpp} and
// wav_writer.cpp / main_onnx.cpp:15-58: chunked RIFF parsing, PCM 8/16/24/32
// and float32/float64 input, multi-channel -> mono mixdown, 16-bit PCM mono
// output with optional peak normalization (the reference ships BOTH writer
// variants: the CLI's non-normalizing one and the library's 0.95-peak one).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace qtts {

struct WavData {
  std::vector<float> samples;  // mono, [-1, 1]
  int sample_rate = 0;
};

// Returns false on parse/open failure; *error gets a reason.
bool read_wav(const std::string& path, WavData* out, std::string* error);

// Writes mono 16-bit PCM.  normalize_peak <= 0 disables normalization
// (CLI-compatible clamp path, main_onnx.cpp:47-54); > 0 scales the peak to
// that value first (library path, wav_writer.cpp:37-48 uses 0.95).
bool write_wav(const std::string& path, const float* samples, size_t count,
               int sample_rate, float normalize_peak, std::string* error);

// Linear-interpolation resampler (reference wav_reader.cpp:145-164 semantics).
std::vector<float> resample_linear(const std::vector<float>& audio, int src_sr,
                                   int dst_sr);

}  // namespace qtts
