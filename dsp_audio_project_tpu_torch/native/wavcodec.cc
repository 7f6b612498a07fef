// Native audio codec engine: WAV parse/decode/convert/encode.
//
// The port's copy of the JAX package's native/wavcodec.cc.  The host-side
// I/O layer (the part of the runtime that runs on no GPU) in C++: RIFF parsing, PCM 8/16/24/32 + IEEE float decode with
// libsndfile-compatible scaling, double-accumulated mono mix and peak scan,
// and the reference's output contract (NaN scrub -> peak normalize ->
// int16, app.py:349-354).  Exposed through a minimal C ABI consumed via
// ctypes (io/native.py); the pure-numpy codec (io/wavio.py) remains the
// behavioral oracle and fallback.
//
// Build: io/native.py runs `make -C native OUT=<library>` at first use into
// the package's _build/ (g++ -O3 -shared -fPIC, no -march=native: a tree
// copied to another host must never load code built for the first one).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct FmtInfo {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t block_align = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;
  uint64_t data_len = 0;
};

constexpr uint16_t kPcm = 1;
constexpr uint16_t kFloat = 3;
constexpr uint16_t kExtensible = 0xFFFE;

uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Returns 0 on success, negative error code otherwise.
int parse(const uint8_t* buf, uint64_t len, FmtInfo* out) {
  if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0) {
    return -1;
  }
  uint64_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* cid = buf + pos;
    uint32_t csize = rd32(buf + pos + 4);
    pos += 8;
    if (pos + csize > len) csize = static_cast<uint32_t>(len - pos);
    if (std::memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      out->tag = rd16(buf + pos);
      out->channels = rd16(buf + pos + 2);
      out->sample_rate = rd32(buf + pos + 4);
      out->block_align = rd16(buf + pos + 12);
      out->bits = rd16(buf + pos + 14);
      if (out->tag == kExtensible && csize >= 26) {
        out->tag = rd16(buf + pos + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      out->data = buf + pos;
      out->data_len = csize;
    }
    pos += csize + (csize & 1);
    if (have_fmt && out->data != nullptr) break;
  }
  if (!have_fmt || out->data == nullptr || out->block_align == 0) return -2;
  if (out->tag != kPcm && out->tag != kFloat) return -3;
  if (out->tag == kPcm && out->bits != 8 && out->bits != 16 &&
      out->bits != 24 && out->bits != 32) {
    return -4;
  }
  if (out->tag == kFloat && out->bits != 32 && out->bits != 64) return -4;
  // Frame-geometry guard: a block_align smaller than channels * bytes would
  // make decode_sample read past the data chunk (heap over-read on fuzzed
  // input); zero channels would divide by zero in the mono mix.  Strict
  // equality keeps verdict parity with the numpy codec (io/wavio.py).
  if (out->channels == 0) return -5;
  if (static_cast<uint32_t>(out->block_align) !=
      static_cast<uint32_t>(out->channels) * (out->bits / 8)) {
    return -5;
  }
  return 0;
}

inline double decode_sample(const FmtInfo& f, const uint8_t* p) {
  if (f.tag == kFloat) {
    if (f.bits == 32) {
      float v;
      std::memcpy(&v, p, 4);
      return static_cast<double>(v);
    }
    double v;
    std::memcpy(&v, p, 8);
    return v;
  }
  switch (f.bits) {
    case 8:
      return (static_cast<int>(p[0]) - 128) / 128.0;
    case 16: {
      int16_t v;
      std::memcpy(&v, p, 2);
      return v / 32768.0;
    }
    case 24: {
      int32_t v = static_cast<int32_t>(
          (static_cast<uint32_t>(p[0]) << 8) |
          (static_cast<uint32_t>(p[1]) << 16) |
          (static_cast<uint32_t>(p[2]) << 24));
      return (v >> 8) / 8388608.0;
    }
    default: {  // 32
      int32_t v;
      std::memcpy(&v, p, 4);
      return v / 2147483648.0;
    }
  }
}

// numpy's nan_to_num of one sample, in double.
inline double scrub(float v) {
  if (std::isnan(v)) return 0.0;
  if (std::isinf(v)) return v > 0 ? DBL_MAX : -DBL_MAX;
  return static_cast<double>(v);
}

}  // namespace

extern "C" {

// Probe a WAV buffer: fills channels/frames/sample_rate.  Returns 0 on
// success.
int wav_probe(const uint8_t* buf, uint64_t len, int32_t* channels,
              int64_t* frames, int32_t* sample_rate) {
  FmtInfo f;
  int rc = parse(buf, len, &f);
  if (rc != 0) return rc;
  *channels = f.channels;
  *frames = static_cast<int64_t>(f.data_len / f.block_align);
  *sample_rate = static_cast<int32_t>(f.sample_rate);
  return 0;
}

// Decode to channel-major float32 (C x N).  `out` must hold channels*frames.
// mode: 0 = deinterleave channel-major; 1 = mono mix (mean across channels,
// double accumulation) into out[0..frames).
// When normalize != 0, scale so peak <= 1 if peak > 1e-6 (dsp_core.py:29-31).
int wav_decode_f32(const uint8_t* buf, uint64_t len, int mode, int normalize,
                   float* out) {
  FmtInfo f;
  int rc = parse(buf, len, &f);
  if (rc != 0) return rc;
  const int64_t frames = static_cast<int64_t>(f.data_len / f.block_align);
  const int c = f.channels;
  const int bytes = f.bits / 8;
  double peak = 0.0;
  if (mode == 1) {
    for (int64_t i = 0; i < frames; ++i) {
      const uint8_t* row = f.data + i * f.block_align;
      double acc = 0.0;
      for (int ch = 0; ch < c; ++ch) {
        acc += decode_sample(f, row + ch * bytes);
      }
      float v = static_cast<float>(acc / c);
      out[i] = v;
      double a = std::fabs(static_cast<double>(v));
      if (a > peak) peak = a;
    }
    if (normalize && peak > 1e-6) {
      float inv = static_cast<float>(1.0 / peak);
      // Match numpy's float32 division semantics: x / peak in f32.
      for (int64_t i = 0; i < frames; ++i) {
        out[i] = static_cast<float>(out[i] / static_cast<float>(peak));
      }
      (void)inv;
    }
  } else {
    for (int64_t i = 0; i < frames; ++i) {
      const uint8_t* row = f.data + i * f.block_align;
      for (int ch = 0; ch < c; ++ch) {
        float v = static_cast<float>(decode_sample(f, row + ch * bytes));
        out[static_cast<int64_t>(ch) * frames + i] = v;
        double a = std::fabs(static_cast<double>(v));
        if (a > peak) peak = a;
      }
    }
    if (normalize && peak > 1e-6) {
      const int64_t total = frames * c;
      for (int64_t i = 0; i < total; ++i) {
        out[i] = static_cast<float>(out[i] / static_cast<float>(peak));
      }
    }
  }
  return 0;
}

// Output stage (app.py:349-354): NaN scrub, peak normalize when peak > 0,
// scale by 32767 and truncate toward zero into int16.  `in` is channel-major
// (C x N); `out` is interleaved N x C (WAV frame order).  The arithmetic is
// export_wav's, step for step, so the two agree bit for bit: the scrub is
// numpy's nan_to_num (NaN -> 0, +-inf -> +-DBL_MAX), then (d / peak) * 32767
// in double.  (The JAX package's copy computes d * (32767 / peak), which
// rounds differently and misses export_wav by one LSB now and then.)
void encode_pcm16(const float* in, int64_t frames, int32_t channels,
                  int16_t* out) {
  double peak = 0.0;
  const int64_t total = frames * channels;
  for (int64_t i = 0; i < total; ++i) {
    double a = std::fabs(scrub(in[i]));
    if (a > peak) peak = a;
  }
  for (int64_t i = 0; i < frames; ++i) {
    for (int32_t ch = 0; ch < channels; ++ch) {
      double d = scrub(in[static_cast<int64_t>(ch) * frames + i]);
      if (peak > 0.0) d = d / peak;
      out[i * channels + ch] = static_cast<int16_t>(d * 32767.0);
    }
  }
}

}  // extern "C"
