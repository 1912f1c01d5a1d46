// rANS range coder for the tvc_torch entropy stack (a copy of the JAX
// package's tvc/entropy/cpp/rans_coder.cpp, byte-compatible streams).
//
// Host-side serial coder beside the PyTorch compute path. Stream layout is
// compatible with the coder used by the reference pipeline (compressai 1.1.5's
// rANS interface, itself derived from the public-domain ryg_rans rans64):
//   - 64-bit state, 32-bit renormalization words, lower bound 1<<31
//   - 16-bit quantized CDFs (precision = 16)
//   - out-of-range symbols escape through the last CDF bin and are coded as
//     sign-folded raw values in 4-bit bypass chunks
//   - symbols are buffered and encoded in reverse (rANS is LIFO); the byte
//     stream is the sequence of 32-bit words in native (little-endian) order.
//
// Exposed as a plain C API for ctypes; no Python.h dependency.
//
// Referenced behavior: Network.py:346-347,400-401,424-428 call
// entropy_bottleneck/gaussian_conditional compress/decompress which bottom out
// in this coder.

#include <cassert>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;

struct RansSymbol {
  uint16_t start;
  uint16_t range;  // range == 0 encodes "bypass raw bits" (value in start)
  bool bypass;
};

inline void enc_put(uint64_t &st, std::vector<uint32_t> &words, uint32_t start,
                    uint32_t freq) {
  // renormalize: emit low 32 bits when the state would overflow
  uint64_t x = st;
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    words.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  st = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t &st, std::vector<uint32_t> &words,
                         uint32_t val, uint32_t nbits) {
  assert(nbits <= 16);
  assert(val < (1u << nbits));
  uint64_t x = st;
  const uint32_t freq = 1u << (16 - nbits);
  const uint64_t x_max = ((kRansL >> 16) << 32) * freq;
  if (x >= x_max) {
    words.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  st = (x << nbits) | val;
}

struct RansDecoder {
  const uint32_t *ptr;
  const uint32_t *end;
  uint64_t state;

  void init(const uint32_t *p, const uint32_t *e) {
    ptr = p;
    end = e;
    state = (static_cast<uint64_t>(ptr[0]) << 32) | ptr[1];
    ptr += 2;
  }

  inline uint32_t get_cum() const {
    return static_cast<uint32_t>(state & ((1u << kPrecision) - 1));
  }

  inline void advance(uint32_t start, uint32_t freq) {
    const uint64_t mask = (1u << kPrecision) - 1;
    state = freq * (state >> kPrecision) + (state & mask) - start;
    if (state < kRansL && ptr < end) {
      state = (state << 32) | *ptr++;
    }
  }

  inline uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = static_cast<uint32_t>(state & ((1u << nbits) - 1));
    state = state >> nbits;
    if (state < kRansL && ptr < end) {
      state = (state << 32) | *ptr++;
    }
    return val;
  }
};

}  // namespace

extern "C" {

// Encode `n` symbols. cdfs: row-major (num_cdfs x cdf_stride) int32 quantized
// CDFs (each row: cdf_lengths[i] valid entries, cdf[0]=0, cdf[len-1]=1<<16).
// Returns the number of bytes written to `out`, or -1 if out_cap is too small.
long rans_encode_with_indexes(const int32_t *symbols, const int32_t *indexes,
                              long n, const int32_t *cdfs, long cdf_stride,
                              const int32_t *cdf_lengths,
                              const int32_t *offsets, uint8_t *out,
                              long out_cap) {
  std::vector<RansSymbol> syms;
  syms.reserve(static_cast<size_t>(n) + 16);

  for (long i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    int32_t value = symbols[i] - offsets[idx];

    uint32_t raw_val = 0;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
    }

    syms.push_back({static_cast<uint16_t>(cdf[value]),
                    static_cast<uint16_t>(cdf[value + 1] - cdf[value]), false});

    if (value == max_value) {
      // number of bypass chunks needed for raw_val
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;

      int32_t v = n_bypass;
      while (v >= static_cast<int32_t>(kMaxBypassVal)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypassVal), 0, true});
        v -= kMaxBypassVal;
      }
      syms.push_back({static_cast<uint16_t>(v), 0, true});
      for (int32_t j = 0; j < n_bypass; ++j) {
        const uint32_t chunk = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
        syms.push_back({static_cast<uint16_t>(chunk), 0, true});
      }
    }
  }

  uint64_t state = kRansL;
  std::vector<uint32_t> words;  // renorm words, chronologically (reverse order)
  words.reserve(syms.size() / 2 + 4);

  for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
    if (it->bypass) {
      enc_put_bits(state, words, it->start, kBypassPrecision);
    } else {
      enc_put(state, words, it->start, it->range);
    }
  }

  // flush: state emitted as two 32-bit words (hi first in the byte stream)
  const long n_words = static_cast<long>(words.size()) + 2;
  const long nbytes = n_words * 4;
  if (nbytes > out_cap) return -1;

  uint32_t *w = reinterpret_cast<uint32_t *>(out);
  w[0] = static_cast<uint32_t>(state >> 32);
  w[1] = static_cast<uint32_t>(state & 0xffffffffu);
  // renorm words were pushed most-recent-first relative to decode order:
  // decoder consumes them from w[2] onward in reverse push order.
  for (size_t j = 0; j < words.size(); ++j) {
    w[2 + j] = words[words.size() - 1 - j];
  }
  return nbytes;
}

// Decode `n` symbols from `data` (size bytes). Returns 0 on success.
long rans_decode_with_indexes(const uint8_t *data, long size,
                              const int32_t *indexes, long n,
                              const int32_t *cdfs, long cdf_stride,
                              const int32_t *cdf_lengths,
                              const int32_t *offsets, int32_t *out) {
  if (size < 8 || (size % 4) != 0) return -1;
  const uint32_t *words = reinterpret_cast<const uint32_t *>(data);
  RansDecoder dec;
  dec.init(words, words + size / 4);

  for (long i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;

    const uint32_t cum = dec.get_cum();
    // linear CDF search (rows are short: <= ~550 bins)
    int32_t s = 0;
    const int32_t len = cdf_lengths[idx];
    while (s < len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
    dec.advance(static_cast<uint32_t>(cdf[s]),
                static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec.get_bits(kBypassPrecision);
      int32_t n_bypass = static_cast<int32_t>(val);
      while (val == kMaxBypassVal) {
        val = dec.get_bits(kBypassPrecision);
        n_bypass += static_cast<int32_t>(val);
      }
      uint32_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec.get_bits(kBypassPrecision) << (j * kBypassPrecision);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out[i] = value + offsets[idx];
  }
  return 0;
}

// Batched variants: encode B independent streams in one call (amortizes the
// Python<->C boundary for the 10 serial rANS calls per keyframe,
// SURVEY.md §3.2). Streams are concatenated in `out`; sizes in out_sizes.
long rans_encode_batch(const int32_t *symbols, const int32_t *indexes,
                       const long *counts, long batch, const int32_t *cdfs,
                       long cdf_stride, const int32_t *cdf_lengths,
                       const int32_t *offsets, uint8_t *out, long out_cap,
                       long *out_sizes) {
  long written = 0;
  const int32_t *sym = symbols;
  const int32_t *ind = indexes;
  for (long b = 0; b < batch; ++b) {
    const long nbytes =
        rans_encode_with_indexes(sym, ind, counts[b], cdfs, cdf_stride,
                                 cdf_lengths, offsets, out + written,
                                 out_cap - written);
    if (nbytes < 0) return -1;
    out_sizes[b] = nbytes;
    written += nbytes;
    sym += counts[b];
    ind += counts[b];
  }
  return written;
}

long rans_decode_batch(const uint8_t *data, const long *sizes, long batch,
                       const int32_t *indexes, const long *counts,
                       const int32_t *cdfs, long cdf_stride,
                       const int32_t *cdf_lengths, const int32_t *offsets,
                       int32_t *out) {
  long off_in = 0;
  long off_out = 0;
  const int32_t *ind = indexes;
  for (long b = 0; b < batch; ++b) {
    const long rc = rans_decode_with_indexes(data + off_in, sizes[b], ind,
                                             counts[b], cdfs, cdf_stride,
                                             cdf_lengths, offsets,
                                             out + off_out);
    if (rc != 0) return rc;
    off_in += sizes[b];
    off_out += counts[b];
    ind += counts[b];
  }
  return 0;
}

}  // extern "C"
