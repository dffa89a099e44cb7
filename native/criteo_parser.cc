// Native Criteo TSV parser — the host-side data-plane hot path.
//
// Replacement for the C++ TFRecord reader + tf.Example parsing
// threads the reference leans on (every input_fn, e.g. xdeepfm/xdeepfm.py:
// 97-120) and the Spark ETL cast/impute stage (xdeepfm/gen_tfrecords.py:
// 12-40): raw Criteo TSV bytes go straight to dense arrays, one pass, zero
// Python-object overhead.
//
// Hash spec (MUST match recsys/data/hashing.py exactly): FNV-1a 64 over
// the raw bytes, then a splitmix64 finalizer, reduced mod the per-field
// bucket count. Missing categorical fields hash the literal token "NULL"
// (fm/fm.py:44). Missing continuous fields parse to NaN; mean-imputation
// stays in the (vectorized numpy) caller so pass-1 statistics live in one
// place.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcriteo_parser.so
//        criteo_parser.cc   (see recsys/data/native.py)

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t splitmix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

inline uint64_t fnv1a(const char* p, long n) {
  uint64_t h = kFnvOffset;
  for (long i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(static_cast<unsigned char>(p[i]));
    h *= kFnvPrime;
  }
  return h;
}

inline int32_t hash_bucket(const char* p, long n, int32_t buckets) {
  return static_cast<int32_t>(splitmix64(fnv1a(p, n)) %
                              static_cast<uint64_t>(buckets));
}

// fast float parse for criteo's plain integers (values are ints in the raw
// data; fall back to strtof for anything else)
inline float parse_num(const char* p, long n, bool* ok) {
  if (n == 0) {
    *ok = false;
    return 0.0f;
  }
  long i = 0;
  bool neg = false;
  if (p[0] == '-') {
    neg = true;
    i = 1;
  }
  long long v = 0;
  for (; i < n; ++i) {
    char c = p[i];
    if (c < '0' || c > '9') {  // non-integer: strtof fallback
      char buf[64];
      long m = n < 63 ? n : 63;
      memcpy(buf, p, m);
      buf[m] = 0;
      char* end = nullptr;
      float f = strtof(buf, &end);
      *ok = end != buf;
      return f;
    }
    v = v * 10 + (c - '0');
  }
  *ok = true;
  return neg ? -static_cast<float>(v) : static_cast<float>(v);
}

}  // namespace

extern "C" {

// Parse up to max_rows lines of Criteo TSV (label \t 13 ints \t 26 strings).
// Outputs: labels[max_rows], cont[max_rows*13] (NaN = missing),
// cat_ids[max_rows*26] hashed with cat_vocabs[26].
// Returns rows parsed; *consumed = bytes consumed (ends on a line boundary).
long parse_criteo_tsv(const char* data, long n_bytes, long max_rows,
                      const int32_t* cat_vocabs, float* labels, float* cont,
                      int32_t* cat_ids, long* consumed) {
  const float nanv = nanf("");
  long row = 0;
  long pos = 0;
  while (row < max_rows && pos < n_bytes) {
    // find end of line
    long eol = pos;
    while (eol < n_bytes && data[eol] != '\n') ++eol;
    if (eol == n_bytes && data[eol - 1] != '\n') break;  // incomplete line

    long field_start = pos;
    int field = 0;  // 0=label, 1..13 cont, 14..39 cat
    for (long i = pos; i <= eol; ++i) {
      if (i == eol || data[i] == '\t') {
        const char* f = data + field_start;
        long flen = i - field_start;
        if (field == 0) {
          bool ok;
          labels[row] = parse_num(f, flen, &ok);
        } else if (field <= 13) {
          bool ok;
          float v = parse_num(f, flen, &ok);
          cont[row * 13 + (field - 1)] = ok ? v : nanv;
        } else if (field <= 39) {
          int j = field - 14;
          if (flen == 0) {
            cat_ids[row * 26 + j] = hash_bucket("NULL", 4, cat_vocabs[j]);
          } else {
            cat_ids[row * 26 + j] = hash_bucket(f, flen, cat_vocabs[j]);
          }
        }
        ++field;
        field_start = i + 1;
      }
    }
    // fill any missing trailing fields
    for (; field <= 13; ++field) cont[row * 13 + (field - 1)] = nanv;
    for (; field <= 39; ++field) {
      int j = field - 14;
      cat_ids[row * 26 + j] = hash_bucket("NULL", 4, cat_vocabs[j]);
    }
    ++row;
    pos = eol + 1;
  }
  *consumed = pos;
  return row;
}

// Batch string hashing (serving / ad-hoc paths): hash n strings packed as
// offsets into a byte blob.
void hash_strings(const char* blob, const long* offsets, long n,
                  int32_t buckets, int32_t* out) {
  for (long i = 0; i < n; ++i) {
    out[i] = hash_bucket(blob + offsets[i], offsets[i + 1] - offsets[i],
                         buckets);
  }
}

}  // extern "C"
