// Canonical-Huffman decode for EXR PIZ chunks — the hot loop of 4K-HDRI
// skybox loading (25M+ symbols for a 4K half RGB map; the pure-Python
// fallback in models/piz.py is ~1000x slower). The JAX package's
// csrc/piz.cpp, kept as the port's own copy. Mirrors the canonical code
// convention of models/piz.py:_canonical_codes (OpenEXR ImfHuf layout):
// lengths 1..58; first code per length built longest-first via
// c' = (c + count[l]) >> 1; codes assigned in increasing symbol order;
// symbol `rlc` is the run-length escape (next 8 bits = repeat count of the
// previous output symbol). MSB-first bit stream.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// data: whole huffman blob; pos: byte offset where code bits start;
// n_bits: number of valid bits; lengths: per-symbol code lengths
// (HUF_ENCSIZE = 65537 entries); rlc: run-length escape symbol;
// out/n_out: decoded uint16 symbols. Returns 0 on success.
int urt_huf_decode(const uint8_t *data, int64_t pos, int64_t n_bits,
                   const int32_t *lengths, int32_t rlc,
                   uint16_t *out, int64_t n_out) {
  const int kMaxLen = 58;
  const int kEncSize = 65537;

  int64_t count[kMaxLen + 1] = {0};
  for (int s = 0; s < kEncSize; ++s) {
    int l = lengths[s];
    if (l < 0 || l > kMaxLen) return 1;
    if (l > 0) count[l]++;
  }
  int64_t first[kMaxLen + 1] = {0};
  int64_t base[kMaxLen + 1] = {0};  // index into symbol list per length
  {
    int64_t c = 0;
    for (int l = kMaxLen; l >= 1; --l) {
      first[l] = c;
      c = (c + count[l]) >> 1;
    }
    int64_t b = 0;
    for (int l = 1; l <= kMaxLen; ++l) {
      base[l] = b;
      b += count[l];
    }
  }
  std::vector<int32_t> syms((size_t)(base[kMaxLen] + count[kMaxLen]));
  {
    int64_t fill[kMaxLen + 1];
    std::memcpy(fill, base, sizeof(fill));
    for (int s = 0; s < kEncSize; ++s) {
      int l = lengths[s];
      if (l > 0) syms[(size_t)fill[l]++] = s;
    }
  }

  const uint8_t *p = data + pos;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t bits_left = n_bits;
  int64_t n = 0;
  uint64_t code = 0;
  int len = 0;

  auto next_bit = [&](uint32_t &bit) -> bool {
    if (bits_left <= 0) return false;
    if (nacc == 0) {
      acc = *p++;
      nacc = 8;
    }
    bit = (uint32_t)((acc >> (nacc - 1)) & 1);
    --nacc;
    --bits_left;
    return true;
  };

  while (n < n_out) {
    uint32_t bit;
    if (!next_bit(bit)) return 2;      // stream ended early
    code = (code << 1) | bit;
    if (++len > kMaxLen) return 3;     // corrupt stream
    int64_t k = (int64_t)code - first[len];
    if (k >= 0 && k < count[len]) {
      int32_t s = syms[(size_t)(base[len] + k)];
      if (s == rlc) {
        // 8-bit repeat count of the previous symbol.
        uint32_t cs = 0;
        for (int i = 0; i < 8; ++i) {
          if (!next_bit(bit)) return 2;
          cs = (cs << 1) | bit;
        }
        if (n == 0 || n + (int64_t)cs > n_out) return 4;
        uint16_t prev = out[n - 1];
        for (uint32_t i = 0; i < cs; ++i) out[n++] = prev;
      } else {
        out[n++] = (uint16_t)s;
      }
      code = 0;
      len = 0;
    }
  }
  return 0;
}

}  // extern "C"
