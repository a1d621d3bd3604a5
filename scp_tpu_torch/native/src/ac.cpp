// Range (arithmetic) coder with 16-bit probability precision and 32-bit
// state, after the classic construction described in Mark Nelson's
// "Data Compression With Arithmetic Coding" (2014).  Stream-compatible with
// the reference codec's coder (reference numpyAc/backend/numpyAc_backend.cpp)
// so that rate accounting matches:
//   * per-symbol CDF rows of Lp uint16 entries, strictly increasing,
//     cdf[0] == 0; the top of the last interval is implicitly 1<<16;
//   * encoder renormalizes with the pending-bit (E3) scheme and finishes by
//     emitting the second MSB of `low` plus pending complements, zero-padded
//     to a byte;
//   * decoder primes a 32-bit window and shifts in zeros past end-of-stream.
//
// The API is a plain C ABI for ctypes.  The decoder is a stateful handle so
// a single bitstream can be consumed across many batched model calls
// (batching removes the reference's per-symbol Python round trip).
//
// A copy of the JAX package's scp_tpu/native/src/ac.cpp: the port builds
// and loads its own library (scp_tpu_torch/native/build.py), and its
// streams are byte-identical to the JAX package's on the same rows.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 0x80000000u;
constexpr uint32_t kQuarter1 = 0x40000000u;
constexpr uint32_t kQuarter3 = 0xC0000000u;
constexpr uint32_t kProbScale = 1u << 16;

class BitWriter {
 public:
  void push(int bit) {
    acc_ = static_cast<uint8_t>((acc_ << 1) | (bit & 1));
    if (++nbits_ == 8) {
      bytes_.push_back(acc_);
      acc_ = 0;
      nbits_ = 0;
    }
  }
  void push_with_pending(int bit, uint64_t& pending) {
    push(bit);
    while (pending > 0) {
      push(!bit);
      --pending;
    }
  }
  void pad_to_byte() {
    while (nbits_ != 0) push(0);
  }
  const std::vector<uint8_t>& bytes() const { return bytes_; }

 private:
  std::vector<uint8_t> bytes_;
  uint8_t acc_ = 0;
  int nbits_ = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t len) : data_(data), len_(len) {}
  // Shift one bit into `v`; zeros once the stream is exhausted.
  void shift_into(uint32_t& v) {
    v <<= 1;
    if (pos_ >= len_ * 8) return;
    const uint8_t byte = data_[pos_ >> 3];
    v |= (byte >> (7 - (pos_ & 7))) & 1;
    ++pos_;
  }

 private:
  const uint8_t* data_;
  int64_t len_;
  int64_t pos_ = 0;
};

// Largest symbol s in [0, Lp-2] with cdf[s] <= target (cdf strictly
// increasing, cdf[0] == 0, so the result is well-defined).
inline int find_symbol(const uint16_t* cdf, int Lp, uint32_t target) {
  int lo = 0, hi = Lp - 1;  // invariant: cdf[lo] <= target < implicit top
  while (lo + 1 < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= target) {
      lo = mid;
      if (cdf[mid] == target) break;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Encoder {
  uint32_t low = 0;
  uint32_t high = 0xFFFFFFFFu;
  uint64_t pending = 0;
  bool finished = false;
  BitWriter out;

  void encode(uint32_t c_low, uint32_t c_high) {
    const uint64_t span =
        static_cast<uint64_t>(high) - static_cast<uint64_t>(low) + 1;
    high = (low - 1) + static_cast<uint32_t>((span * c_high) >> 16);
    low = low + static_cast<uint32_t>((span * c_low) >> 16);
    for (;;) {
      if (high < kTop) {
        out.push_with_pending(0, pending);
      } else if (low >= kTop) {
        out.push_with_pending(1, pending);
      } else if (low >= kQuarter1 && high < kQuarter3) {
        ++pending;
        low = (low << 1) & 0x7FFFFFFFu;
        high = (high << 1) | 0x80000001u;
        continue;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1u;
    }
  }

  void finish() {
    ++pending;
    out.push_with_pending(low < kQuarter1 ? 0 : 1, pending);
    out.pad_to_byte();
  }
};

struct Decoder {
  std::vector<uint8_t> stream;
  BitReader reader{nullptr, 0};
  uint32_t low = 0;
  uint32_t high = 0xFFFFFFFFu;
  uint32_t value = 0;
  int64_t n_sym = 0;
  int64_t decoded = 0;

  Decoder(const uint8_t* data, int64_t len, int64_t n)
      : stream(data, data + len), reader(stream.data(), len), n_sym(n) {
    for (int i = 0; i < 32; ++i) reader.shift_into(value);
  }

  int decode_one(const uint16_t* cdf, int Lp) {
    const uint64_t span =
        static_cast<uint64_t>(high) - static_cast<uint64_t>(low) + 1;
    const uint32_t target = static_cast<uint32_t>(
        ((static_cast<uint64_t>(value) - low + 1) * kProbScale - 1) / span);
    const int sym = find_symbol(cdf, Lp, target);
    ++decoded;
    if (decoded >= n_sym) return sym;  // final symbol: no state update needed

    const uint32_t c_low = cdf[sym];
    const uint32_t c_high = (sym == Lp - 2) ? kProbScale : cdf[sym + 1];
    high = (low - 1) + static_cast<uint32_t>((span * c_high) >> 16);
    low = low + static_cast<uint32_t>((span * c_low) >> 16);
    for (;;) {
      if (low >= kTop || high < kTop) {
        low <<= 1;
        high = (high << 1) | 1u;
        reader.shift_into(value);
      } else if (low >= kQuarter1 && high < kQuarter3) {
        low = (low << 1) & 0x7FFFFFFFu;
        high = (high << 1) | 0x80000001u;
        value -= kQuarter1;
        reader.shift_into(value);
      } else {
        break;
      }
    }
    return sym;
  }
};

// Quantize one float32 pdf row (L entries) into the uint16 CDF row
// (L+1 entries) with semantics identical to the numpy path
// (scp_tpu_torch/ac/__init__.py quantize_cdf): sequential float32 cumsum,
// float32 divide by the total, scale by 2^16 - L, round half-to-even,
// add the index ramp, wrap mod 2^16.
inline void quantize_pdf_row(const float* pdf, int L, uint16_t* cdf) {
  // float32 cumsum + divide, then float64 scale + round-half-even: matches
  // numpy's quantize_cdf (and the reference coder's upcast) bit for bit.
  const double scale = static_cast<double>((1u << 16) - L);
  cdf[0] = 0;
  float acc = 0.0f;
  for (int i = 0; i < L; ++i) acc += pdf[i];
  const float total = acc;
  acc = 0.0f;
  for (int i = 0; i < L; ++i) {
    acc += pdf[i];
    const float v = acc / total;
    const long long q = llrint(static_cast<double>(v) * scale) + (i + 1);
    cdf[i + 1] = static_cast<uint16_t>(q & 0xFFFF);
  }
}

}  // namespace

extern "C" {

// ---- streaming encoder: append chunks, finish once ----------------------

void* ac_encoder_new() { return new Encoder(); }

void ac_encoder_append(void* enc_ptr, const uint16_t* cdf, int64_t m,
                       int32_t Lp, const int16_t* syms) {
  Encoder* enc = static_cast<Encoder*>(enc_ptr);
  for (int64_t i = 0; i < m; ++i) {
    const uint16_t* row = cdf + i * Lp;
    const int s = syms[i];
    const uint32_t c_low = row[s];
    const uint32_t c_high = (s == Lp - 2) ? kProbScale : row[s + 1];
    enc->encode(c_low, c_high);
  }
}

// Append m pre-gathered coding intervals (m x 2 uint16: c_low, c_high).
// A stored c_high of 0 means the wrapped CDF top (1<<16) — the only entry
// of a strictly-increasing quantized CDF that can wrap.  This is the
// device-side staged-coding hand-off: the symbol is known at encode time,
// so only its interval crosses the host link (scp_tpu's codec/staged.py).
void ac_encoder_append_intervals(void* enc_ptr, const uint16_t* iv,
                                 int64_t m) {
  Encoder* enc = static_cast<Encoder*>(enc_ptr);
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t c_low = iv[2 * i];
    uint32_t c_high = iv[2 * i + 1];
    if (c_high == 0) c_high = kProbScale;
    enc->encode(c_low, c_high);
  }
}

// Append straight from float32 pdf rows (m x L): quantization fused in.
void ac_encoder_append_pdf(void* enc_ptr, const float* pdf, int64_t m,
                           int32_t L, const int16_t* syms) {
  Encoder* enc = static_cast<Encoder*>(enc_ptr);
  std::vector<uint16_t> cdf(L + 1);
  for (int64_t i = 0; i < m; ++i) {
    quantize_pdf_row(pdf + i * L, L, cdf.data());
    const int s = syms[i];
    const uint32_t c_low = cdf[s];
    const uint32_t c_high = (s == L - 1) ? kProbScale : cdf[s + 1];
    enc->encode(c_low, c_high);
  }
}

// Finish and copy the stream out; returns length. Call with buf=null to
// query the size first (idempotent: finish() runs once).
int64_t ac_encoder_finish(void* enc_ptr, uint8_t* buf) {
  Encoder* enc = static_cast<Encoder*>(enc_ptr);
  if (!enc->finished) {
    enc->finish();
    enc->finished = true;
  }
  const auto& bytes = enc->out.bytes();
  if (buf) std::memcpy(buf, bytes.data(), bytes.size());
  return static_cast<int64_t>(bytes.size());
}

void ac_encoder_free(void* enc_ptr) { delete static_cast<Encoder*>(enc_ptr); }

// Encode n_sym symbols against per-symbol CDF rows (n_sym x Lp uint16).
// Returns a malloc'd byte buffer (caller frees with ac_free) and its length.
uint8_t* ac_encode_cdf(const uint16_t* cdf, int64_t n_sym, int32_t Lp,
                       const int16_t* syms, int64_t* out_len) {
  Encoder enc;
  for (int64_t i = 0; i < n_sym; ++i) {
    const uint16_t* row = cdf + i * Lp;
    const int s = syms[i];
    const uint32_t c_low = row[s];
    const uint32_t c_high = (s == Lp - 2) ? kProbScale : row[s + 1];
    enc.encode(c_low, c_high);
  }
  enc.finish();
  const auto& bytes = enc.out.bytes();
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(bytes.size()));
  std::memcpy(buf, bytes.data(), bytes.size());
  *out_len = static_cast<int64_t>(bytes.size());
  return buf;
}

void ac_free(void* p) { std::free(p); }

void* ac_decoder_new(const uint8_t* stream, int64_t len, int64_t n_sym) {
  return new Decoder(stream, len, n_sym);
}

void ac_decoder_free(void* dec) { delete static_cast<Decoder*>(dec); }

// Decode m symbols, row i of `cdfs` (m x Lp) gating symbol i.  Returns the
// number decoded (may be < m if the stream's symbol budget runs out).
int64_t ac_decode_batch(void* dec_ptr, const uint16_t* cdfs, int64_t m,
                        int32_t Lp, int16_t* out) {
  Decoder* dec = static_cast<Decoder*>(dec_ptr);
  int64_t i = 0;
  for (; i < m; ++i) {
    if (dec->decoded >= dec->n_sym) break;
    out[i] = static_cast<int16_t>(dec->decode_one(cdfs + i * Lp, Lp));
  }
  return i;
}

// Decode straight from float32 pdf rows (m x L): quantization fused in.
int64_t ac_decode_batch_pdf(void* dec_ptr, const float* pdf, int64_t m,
                            int32_t L, int16_t* out) {
  Decoder* dec = static_cast<Decoder*>(dec_ptr);
  std::vector<uint16_t> cdf(L + 1);
  int64_t i = 0;
  for (; i < m; ++i) {
    if (dec->decoded >= dec->n_sym) break;
    quantize_pdf_row(pdf + i * L, L, cdf.data());
    out[i] = static_cast<int16_t>(dec->decode_one(cdf.data(), L + 1));
  }
  return i;
}

}  // extern "C"
