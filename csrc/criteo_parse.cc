// Native Criteo TSV batch parser (SURVEY.md C17 — the reference class feeds
// its tables from C++ data loaders; this is this build's native input
// path). Bit-compatible with the Python parser in
// meepoembedding_tpu/data/criteo.py:
//   - label  = strtod(field) (empty -> 0), cast to f32
//   - dense  = (float)log1p(max(strtod(field), 0))  [double math, f32 store]
//   - ids    = (feature << 44) | (fnv1a32(token bytes) & (2^44 - 1)),
//              empty token -> value 0
//   - short lines pad with empty fields; extra fields are ignored;
//   - only a trailing '\n' terminates a line ('\r' stays IN the last token,
//     matching Python's rstrip("\n")).
//
// ABI (ctypes, GIL released around the call):
//   criteo_parse_batch(buf, buf_len, max_rows, dense[rows*13],
//                      ids[rows*26], label[rows]) -> rows parsed
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see data/criteo_native.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kDense = 13;
constexpr int kSparse = 26;
constexpr int kShift = 44;
constexpr long long kValMask = (1LL << kShift) - 1;

inline uint32_t fnv1a32(const char* p, long n) {
  uint32_t h = 2166136261u;
  for (long i = 0; i < n; ++i) {
    h = (h ^ (uint8_t)p[i]) * 16777619u;
  }
  return h;
}

inline double to_double(const char* p, long n) {
  if (n <= 0) return 0.0;
  // strtod needs NUL termination; fields are short, copy to a stack buffer
  char tmp[64];
  long m = n < 63 ? n : 63;
  std::memcpy(tmp, p, m);
  tmp[m] = '\0';
  return std::strtod(tmp, nullptr);
}

}  // namespace

extern "C" long criteo_parse_batch(const char* buf, long buf_len,
                                   long max_rows, float* dense,
                                   long long* ids, float* label) {
  long row = 0;
  long pos = 0;
  while (row < max_rows && pos < buf_len) {
    // one line: [pos, eol)
    const char* nl =
        (const char*)std::memchr(buf + pos, '\n', (size_t)(buf_len - pos));
    long eol = nl ? (long)(nl - buf) : buf_len;

    long fstart = pos;
    int field = 0;
    float* drow = dense + row * kDense;
    long long* irow = ids + row * kSparse;
    for (long i = pos; i <= eol && field < 1 + kDense + kSparse; ++i) {
      if (i == eol || buf[i] == '\t') {
        const char* fp = buf + fstart;
        long fn = i - fstart;
        if (field == 0) {
          label[row] = (float)to_double(fp, fn);
        } else if (field <= kDense) {
          double x = fn ? to_double(fp, fn) : 0.0;
          drow[field - 1] = (float)std::log1p(x > 0.0 ? x : 0.0);
        } else {
          int s = field - 1 - kDense;
          long long val = fn ? (long long)(fnv1a32(fp, fn) & kValMask) : 0;
          irow[s] = ((long long)s << kShift) | val;
        }
        ++field;
        fstart = i + 1;
      }
    }
    // short line: remaining fields are empty
    for (; field < 1 + kDense + kSparse; ++field) {
      if (field == 0) {
        label[row] = 0.0f;
      } else if (field <= kDense) {
        drow[field - 1] = 0.0f;
      } else {
        int s = field - 1 - kDense;
        irow[s] = (long long)s << kShift;
      }
    }
    ++row;
    pos = eol + 1;
  }
  return row;
}
