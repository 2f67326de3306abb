// akx_native — host-side audio runtime for audio_key_estimation_tpu.
//
// TPU-native replacement for the reference's native dependencies:
//   * torchaudio.load (C++ decoders)          -> decode_wav / decode_first_channel
//   * ThreadPoolExecutor preprocessing fan-out -> DecodePool (lock-free-ish
//     work queue + worker threads), feeding the feature pipeline
// (reference KeyDataset.py:341 and :127-136).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Build: make -C audio_key_estimation_tpu/native
//
// Supported WAV encodings: PCM u8/s16/s24/s32 and IEEE float32/float64,
// arbitrary channel count (channel 0 is returned, matching the reference's
// waveform[0] at KeyDataset.py:481).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "akx_decoded.h"

namespace {

using akx::Decoded;

bool has_suffix_ci(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i)
    if (tolower((unsigned char)s[s.size() - n + i]) != suf[i]) return false;
  return true;
}

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool decode_wav_buffer(const uint8_t* buf, size_t len, Decoded* out) {
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0) {
    out->error = "not a RIFF/WAVE file";
    return false;
  }
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && chunk_len >= 40) fmt = rd_u16(body + 24);  // extensible
    } else if (memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!data || channels == 0 || rate == 0) {
    out->error = "missing fmt/data chunk";
    return false;
  }
  const size_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) {
    out->error = "bad bits_per_sample";
    return false;
  }
  const size_t frame_bytes = bytes_per_sample * channels;
  const size_t n = data_len / frame_bytes;
  out->samples.resize(n);
  out->sample_rate = (int)rate;
  float* dst = out->samples.data();
  if (fmt == 1 && bits == 16) {
    for (size_t i = 0; i < n; ++i) {
      int16_t v;
      memcpy(&v, data + i * frame_bytes, 2);
      dst[i] = (float)v / 32768.0f;
    }
  } else if (fmt == 1 && bits == 24) {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = data + i * frame_bytes;
      int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                            (uint32_t)p[2] << 24) >> 8;
      dst[i] = (float)v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    for (size_t i = 0; i < n; ++i) {
      int32_t v;
      memcpy(&v, data + i * frame_bytes, 4);
      dst[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt == 1 && bits == 8) {
    for (size_t i = 0; i < n; ++i)
      dst[i] = ((float)data[i * frame_bytes] - 128.0f) / 128.0f;
  } else if (fmt == 3 && bits == 32) {
    for (size_t i = 0; i < n; ++i)
      memcpy(&dst[i], data + i * frame_bytes, 4);
  } else if (fmt == 3 && bits == 64) {
    for (size_t i = 0; i < n; ++i) {
      double v;
      memcpy(&v, data + i * frame_bytes, 8);
      dst[i] = (float)v;
    }
  } else {
    char msg[96];
    snprintf(msg, sizeof msg, "unsupported wav encoding fmt=%u bits=%u", fmt, bits);
    out->error = msg;
    return false;
  }
  return true;
}

bool decode_wav_file(const char* path, Decoded* out) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    out->error = std::string("cannot open ") + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  size_t got = fread(buf.data(), 1, (size_t)sz, f);
  fclose(f);
  if (got != (size_t)sz) {
    out->error = "short read";
    return false;
  }
  return decode_wav_buffer(buf.data(), buf.size(), out);
}

// extension dispatch shared by the pool and the one-shot entry points
bool decode_any_file(const char* path, Decoded* out) {
  if (has_suffix_ci(path, ".mp3")) return akx::decode_mp3_file(path, out);
  return decode_wav_file(path, out);
}

// ---------------------------------------------------------------------------
// DecodePool: worker threads decode submitted paths; results are polled.
// ---------------------------------------------------------------------------

struct Job {
  int64_t id;
  std::string path;
};

struct Result {
  int64_t id;
  Decoded decoded;
  bool ok;
};

class DecodePool {
 public:
  explicit DecodePool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }
  ~DecodePool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(int64_t id, const char* path) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push_back({id, path});
    }
    cv_.notify_one();
  }
  // returns nullptr if nothing ready
  Result* poll() {
    std::lock_guard<std::mutex> lk(mu_);
    if (done_.empty()) return nullptr;
    Result* r = new Result(std::move(done_.front()));
    done_.pop_front();
    return r;
  }

 private:
  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop_front();
      }
      Result r;
      r.id = job.id;
      r.ok = decode_any_file(job.path.c_str(), &r.decoded);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_.push_back(std::move(r));
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Job> jobs_;
  std::deque<Result> done_;
  std::vector<std::thread> workers_;
  bool stop_;
};

// ---------------------------------------------------------------------------
// Batch ingest: one C call that parses every file's RIFF layout and preads
// its PCM16 data chunk STRAIGHT into the caller's int16 batch buffer — the
// native fast path of data/audio_io.ingest_batch. The round-1 residual was
// per-file Python (header parse + open/seek/readinto) on a 1-core host;
// here the whole batch is header-walk + pread per file with zero Python in
// the loop, and worker threads when cores exist.
// ---------------------------------------------------------------------------

struct WavLayout {
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t data_off = -1, data_len = 0;
};

// RIFF chunk walk with preads only (mirrors audio_io._wav_layout).
bool wav_layout_fd(int fd, int64_t fsize, WavLayout* L) {
  uint8_t head[12];
  if (pread(fd, head, 12, 0) != 12 || memcmp(head, "RIFF", 4) != 0 ||
      memcmp(head + 8, "WAVE", 4) != 0)
    return false;
  int64_t pos = 12;
  while (pos + 8 <= fsize) {
    uint8_t hdr[8];
    if (pread(fd, hdr, 8, pos) != 8) break;
    uint32_t clen = rd_u32(hdr + 4);
    int64_t body = pos + 8;
    if (memcmp(hdr, "fmt ", 4) == 0 && clen >= 16) {
      uint8_t b[64];
      size_t want = clen < 64 ? clen : 64;
      if (pread(fd, b, want, body) != (ssize_t)want) return false;
      L->fmt = rd_u16(b);
      L->channels = rd_u16(b + 2);
      L->rate = rd_u32(b + 4);
      L->bits = rd_u16(b + 14);
      if (L->fmt == 0xFFFE && clen >= 40) L->fmt = rd_u16(b + 24);
    } else if (memcmp(hdr, "data", 4) == 0) {
      int64_t avail = fsize - body;
      L->data_off = body;
      L->data_len = (int64_t)clen < avail ? (int64_t)clen : avail;
    }
    pos = body + clen + (clen & 1);  // chunks are word-aligned
  }
  return L->data_off >= 0 && L->channels != 0;
}

// Ingest file i: data chunk -> batch row i, zero tail. Returns true when the
// file is a little-endian mono PCM16 WAV and the read succeeded.
bool ingest_one(const char* path, int16_t* row, int64_t pad_len,
                int64_t* length, int32_t* rate) {
  *length = 0;
  *rate = 0;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return false;
  }
  WavLayout L;
  bool ok = wav_layout_fd(fd, (int64_t)st.st_size, &L) && L.fmt == 1 &&
            L.channels == 1 && L.bits == 16;
  int64_t m = 0;
  if (ok) {
    m = L.data_len / 2;
    if (m > pad_len) m = pad_len;
    uint8_t* dst = (uint8_t*)row;
    int64_t want = 2 * m, done = 0;
    while (done < want) {
      ssize_t got = pread(fd, dst + done, want - done, L.data_off + done);
      if (got <= 0) break;
      done += got;
    }
    m = done / 2;  // short file: keep what arrived
  }
  close(fd);
  if (m < pad_len) memset(row + m, 0, (size_t)(pad_len - m) * 2);
  *length = m;
  *rate = (int32_t)L.rate;
  return ok;
}

}  // namespace

extern "C" {

// Batch PCM16 ingest. batch is (n_rows, pad_len) int16, C-contiguous;
// lengths/rates/ok are caller buffers of n_files entries. Rows beyond
// n_files are zero-filled. Returns the number of files ingested OK (the
// caller falls back to the Python decode path unless all succeeded).
int64_t akx_ingest_batch(const char** paths, int64_t n_files, int16_t* batch,
                         int64_t n_rows, int64_t pad_len, int n_threads,
                         int64_t* lengths, int32_t* rates, uint8_t* ok) {
  if (n_files > n_rows) return -1;  // would write past the batch buffer
  std::atomic<int64_t> next(0), n_ok(0);
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) return;
      bool good = ingest_one(paths[i], batch + i * pad_len, pad_len,
                             &lengths[i], &rates[i]);
      ok[i] = good ? 1 : 0;
      if (good) n_ok.fetch_add(1);
    }
  };
  int threads = n_threads;
  if (threads > n_files) threads = (int)n_files;
  if (threads > 1) {
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  } else {
    work();
  }
  for (int64_t i = n_files; i < n_rows; ++i)
    memset(batch + i * pad_len, 0, (size_t)pad_len * 2);
  return n_ok.load();
}

// Decode channel 0 of a WAV file. Returns a handle (>0) or 0 on failure.
// Use akx_samples/akx_sample_rate/akx_error to inspect, akx_free to release.
void* akx_decode_wav(const char* path) {
  auto* d = new Decoded();
  decode_wav_file(path, d);
  return d;
}

// Decode channel 0 of an MPEG-1 Layer III file (akx_mp3.cpp). Same handle
// protocol as akx_decode_wav; an error containing "MPEG-2" marks an LSF
// stream the caller may transcode externally.
void* akx_decode_mp3(const char* path) {
  auto* d = new Decoded();
  akx::decode_mp3_file(path, d);
  return d;
}

const float* akx_samples(void* h) { return ((Decoded*)h)->samples.data(); }
int64_t akx_num_samples(void* h) { return (int64_t)((Decoded*)h)->samples.size(); }
int akx_sample_rate(void* h) { return ((Decoded*)h)->sample_rate; }
const char* akx_error(void* h) { return ((Decoded*)h)->error.c_str(); }
void akx_free(void* h) { delete (Decoded*)h; }

void* akx_pool_create(int n_threads) { return new DecodePool(n_threads); }
void akx_pool_destroy(void* p) { delete (DecodePool*)p; }
void akx_pool_submit(void* p, int64_t id, const char* path) {
  ((DecodePool*)p)->submit(id, path);
}
// Returns a Result handle or nullptr.
void* akx_pool_poll(void* p) { return ((DecodePool*)p)->poll(); }
int64_t akx_result_id(void* r) { return ((Result*)r)->id; }
int akx_result_ok(void* r) { return ((Result*)r)->ok ? 1 : 0; }
const float* akx_result_samples(void* r) {
  return ((Result*)r)->decoded.samples.data();
}
int64_t akx_result_num_samples(void* r) {
  return (int64_t)((Result*)r)->decoded.samples.size();
}
int akx_result_sample_rate(void* r) { return ((Result*)r)->decoded.sample_rate; }
const char* akx_result_error(void* r) {
  return ((Result*)r)->decoded.error.c_str();
}
void akx_result_free(void* r) { delete (Result*)r; }

}  // extern "C"
