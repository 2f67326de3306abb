// Shared decode-result type for the akx native audio runtime.
#pragma once

#include <string>
#include <vector>

namespace akx {

struct Decoded {
  std::vector<float> samples;  // channel 0
  int sample_rate = 0;
  std::string error;
};

// MPEG-1 Layer III decoder (akx_mp3.cpp). Returns false with out->error
// set on failure; "MPEG-2" in the error marks an LSF stream the caller
// may transcode externally.
bool decode_mp3_file(const char* path, Decoded* out);
bool decode_mp3_buffer(const uint8_t* buf, size_t len, Decoded* out);

}  // namespace akx
