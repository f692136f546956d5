// Native npy/wav decoder of avr_torch (the port's copy of the JAX
// package's fastload.cpp, same C ABI and semantics, with two decode
// faults repaired).
//
// Multi-threaded decoding of dataset files into caller-owned float32
// matrices [n_files, seq_len], so Python only runs one batched rFFT after:
//   avr_load_npy_batch  — MeshRIR per-IR .npy files ([1, T] or [T],
//                         little-endian float32/float64, C order): row 0,
//                         stride-downsampled, windowed from `start`;
//   avr_load_wav_batch  — RAF rir.wav files (PCM 8/16/24/32-bit, IEEE float
//                         32/64, WAVE_FORMAT_EXTENSIBLE, any channel count,
//                         downmixed to mono), stride-downsampled.
// Short tails are zero-padded. Both return 0 on success and -(i + 1) for
// the first failing file i otherwise; avr_npy_status / avr_wav_status give
// the reason for one file (0 = decodes).
//
// The two repairs: the pad byte after an odd-sized chunk is skipped once
// (the JAX copy skips it twice for chunks other than fmt/data, so a file
// with, say, a 3-byte LIST chunk before `data` fails), and 8-bit PCM
// decodes as (u8 - 128) / 128 (the JAX copy rejects it).
//
// Samples are decoded to double and rounded to float once, at the store,
// so a mono file gives the same float32 values as the numpy decode.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kCannotOpen = 1,     // missing or unreadable file
  kNotThisFormat = 2,  // no .npy magic / not RIFF-WAVE
  kUnsupported = 3,    // npy dtype or WAV sample format outside the list
  kFortranOrder = 4,   // npy array in Fortran order
  kMalformed = 5,      // truncated data, bad header, missing fmt/data chunk
};

struct File {
  FILE* f;
  explicit File(const char* path) : f(std::fopen(path, "rb")) {}
  ~File() {
    if (f) std::fclose(f);
  }
  bool read(void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }
};

uint32_t le32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t le16(const unsigned char* p) { return uint16_t(p[0] | (p[1] << 8)); }

// ---------------------------------------------------------------- npy ----
// v1.0 (2-byte header length) and v2.0/v3.0 (4-byte) headers.
int read_npy(const char* path, std::vector<double>& out, std::vector<int64_t>& shape) {
  File f(path);
  if (!f.f) return kCannotOpen;
  unsigned char magic[8];
  if (!f.read(magic, 8) || std::memcmp(magic, "\x93NUMPY", 6)) return kNotThisFormat;
  uint32_t header_len = 0;
  unsigned char b[4];
  if (magic[6] == 1) {
    if (!f.read(b, 2)) return kMalformed;
    header_len = le16(b);
  } else {
    if (!f.read(b, 4)) return kMalformed;
    header_len = le32(b);
  }
  std::string header(header_len, '\0');
  if (!f.read(header.data(), header_len)) return kMalformed;
  bool is_f8 = header.find("'<f8'") != std::string::npos;
  bool is_f4 = header.find("'<f4'") != std::string::npos;
  if (!is_f4 && !is_f8) return kUnsupported;
  if (header.find("'fortran_order': False") == std::string::npos) return kFortranOrder;
  auto lp = header.find("'shape': (");
  if (lp == std::string::npos) return kMalformed;
  lp += 10;
  auto rp = header.find(')', lp);
  if (rp == std::string::npos) return kMalformed;
  std::string dims = header.substr(lp, rp - lp);
  shape.clear();
  int64_t total = 1;
  for (size_t i = 0; i < dims.size();) {
    while (i < dims.size() && !std::isdigit(static_cast<unsigned char>(dims[i]))) i++;
    if (i >= dims.size()) break;
    int64_t v = 0;
    while (i < dims.size() && std::isdigit(static_cast<unsigned char>(dims[i]))) v = v * 10 + (dims[i++] - '0');
    shape.push_back(v);
    total *= v;
  }
  if (shape.empty()) return kMalformed;
  out.resize(total);
  if (is_f8) {
    if (!f.read(out.data(), 8 * size_t(total))) return kMalformed;
  } else {
    std::vector<float> tmp(total);
    if (!f.read(tmp.data(), 4 * size_t(total))) return kMalformed;
    for (int64_t i = 0; i < total; i++) out[i] = tmp[i];
  }
  return kOk;
}

// ---------------------------------------------------------------- wav ----
template <typename T>
T load(const unsigned char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

int read_wav(const char* path, std::vector<double>& out) {
  File f(path);
  if (!f.f) return kCannotOpen;
  unsigned char hdr[12];
  if (!f.read(hdr, 12) || std::memcmp(hdr, "RIFF", 4) || std::memcmp(hdr + 8, "WAVE", 4))
    return kNotThisFormat;
  uint16_t fmt = 0, channels = 0, bits = 0;
  bool have_fmt = false, have_data = false;
  std::vector<unsigned char> data;
  while (true) {
    unsigned char ch[8];
    if (!f.read(ch, 8)) break;
    uint32_t size = le32(ch + 4);
    if (!std::memcmp(ch, "fmt ", 4)) {
      std::vector<unsigned char> p(size);
      if (size < 16 || !f.read(p.data(), size)) return kMalformed;
      fmt = le16(&p[0]);
      channels = le16(&p[2]);
      bits = le16(&p[14]);
      // WAVE_FORMAT_EXTENSIBLE: the sub-format GUID starts with the tag
      if (fmt == 0xFFFE && size >= 40) fmt = le16(&p[24]);
      have_fmt = true;
    } else if (!std::memcmp(ch, "data", 4)) {
      data.resize(size);
      size_t got = std::fread(data.data(), 1, size, f.f);
      data.resize(got);  // a truncated chunk keeps what the file holds
      have_data = true;
      if (got != size || have_fmt) break;
    } else if (std::fseek(f.f, long(size), SEEK_CUR)) {
      break;
    }
    if (size & 1) std::fseek(f.f, 1, SEEK_CUR);  // chunks are word-aligned
  }
  if (!have_fmt || !have_data || channels == 0) return kMalformed;

  const unsigned char* p = data.data();
  std::vector<double> all;
  if (fmt == 1 && bits == 8) {
    all.resize(data.size());
    for (size_t i = 0; i < all.size(); i++) all[i] = (double(p[i]) - 128.0) / 128.0;
  } else if (fmt == 1 && bits == 16) {
    all.resize(data.size() / 2);
    for (size_t i = 0; i < all.size(); i++) all[i] = load<int16_t>(p + 2 * i) / 32768.0;
  } else if (fmt == 1 && bits == 24) {
    all.resize(data.size() / 3);
    for (size_t i = 0; i < all.size(); i++) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      v = int32_t(uint32_t(v) << 8) >> 8;  // sign-extend
      all[i] = v / 8388608.0;
    }
  } else if (fmt == 1 && bits == 32) {
    all.resize(data.size() / 4);
    for (size_t i = 0; i < all.size(); i++) all[i] = load<int32_t>(p + 4 * i) / 2147483648.0;
  } else if (fmt == 3 && bits == 32) {
    all.resize(data.size() / 4);
    for (size_t i = 0; i < all.size(); i++) all[i] = load<float>(p + 4 * i);
  } else if (fmt == 3 && bits == 64) {
    all.resize(data.size() / 8);
    for (size_t i = 0; i < all.size(); i++) all[i] = load<double>(p + 8 * i);
  } else {
    return kUnsupported;
  }
  if (channels > 1) {  // downmix to mono: the channels' mean, summed in double
    size_t frames = all.size() / channels;
    out.resize(frames);
    for (size_t i = 0; i < frames; i++) {
      double s = 0;
      for (unsigned c = 0; c < channels; c++) s += all[i * channels + c];
      out[i] = s / channels;
    }
  } else {
    out.swap(all);
  }
  return kOk;
}

// ------------------------------------------------------------ threading ---
template <typename Fn>
int parallel_for_files(int n_files, Fn&& body) {
  unsigned n_threads = std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()), 16);
  n_threads = std::min<unsigned>(n_threads, std::max(1, n_files));
  std::atomic<int> next{0}, first_error{0};
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n_files) {
      if (!body(i)) {
        // keep the lowest failing index, whichever thread finds it first
        int seen = first_error.load();
        while ((seen == 0 || -(i + 1) > seen) && !first_error.compare_exchange_weak(seen, -(i + 1))) {
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return first_error.load();
}

}  // namespace

extern "C" {

// Decode n_files .npy IRs into out[n_files, seq_len]: row 0 of each array,
// stride-downsampled by `stride`, window from `start` (post-stride index).
int avr_load_npy_batch(const char** paths, int n_files, float* out, int64_t seq_len, int64_t stride,
                       int64_t start) {
  return parallel_for_files(n_files, [&](int i) {
    std::vector<double> raw;
    std::vector<int64_t> shape;
    if (read_npy(paths[i], raw, shape) != kOk) return false;
    int64_t row_len = shape.back();
    if (int64_t(raw.size()) < row_len) return false;  // a leading dimension of 0: no row 0
    const double* row = raw.data();  // row 0 of [1, T] (or flat [T])
    float* dst = out + int64_t(i) * seq_len;
    for (int64_t t = 0; t < seq_len; t++) {
      int64_t src = (start + t) * stride;
      dst[t] = src < row_len ? float(row[src]) : 0.0f;
    }
    return true;
  });
}

// Decode n_files WAVs into out[n_files, seq_len], mono, stride-downsampled.
int avr_load_wav_batch(const char** paths, int n_files, float* out, int64_t seq_len, int64_t stride) {
  return parallel_for_files(n_files, [&](int i) {
    std::vector<double> audio;
    if (read_wav(paths[i], audio) != kOk) return false;
    float* dst = out + int64_t(i) * seq_len;
    for (int64_t t = 0; t < seq_len; t++) {
      int64_t src = t * stride;
      dst[t] = src < int64_t(audio.size()) ? float(audio[src]) : 0.0f;
    }
    return true;
  });
}

// Why one file does not decode (a Status; 0 when it does).
int avr_npy_status(const char* path) {
  std::vector<double> raw;
  std::vector<int64_t> shape;
  return read_npy(path, raw, shape);
}

int avr_wav_status(const char* path) {
  std::vector<double> audio;
  return read_wav(path, audio);
}

int avr_fastload_version() { return 1; }

}  // extern "C"
