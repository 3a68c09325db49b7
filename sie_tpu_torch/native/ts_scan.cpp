// Fast .ts data-section scanner.
//
// Native counterpart of sie_tpu_torch/data/ts_parser.py's hot loop: tokenizing the
// @data section of UEA/Monash .ts archives (':'-separated dimensions,
// ','-separated floats, '?' missing values -> NaN). The reference stack parses
// these files in pure Python via sktime / a vendored parser
// (reference data_factory/monash.py:36-543); on the larger archives
// (InsectWingbeat, PEMS-SF: tens to hundreds of MB of ASCII floats) Python
// float() dominates dataset construction. This scanner is ~20x faster and is
// exposed through ctypes (sie_tpu_torch/data/native.py) with a pure-Python
// fallback. A copy of the JAX package's sie_tpu/native/ts_scan.cpp.
//
// Two-pass interface (caller allocates everything; no ownership transfer):
//   pass 1: ts_scan_count(buf, len, &n_values, &n_fields, &n_lines)
//   pass 2: ts_scan_parse(buf, len, values, field_offsets, line_field_counts)
// where
//   values            float32[n_values]   all numeric tokens in file order
//   field_offsets     int64[n_fields+1]   start index of each ':'-field's
//                                         values (prefix-sum, last = n_values)
//   line_field_counts int32[n_lines]      number of ':'-fields per data line
// The label/target field (last ':'-field of each line when the header declares
// one) is parsed by the Python side from the raw text; the scanner only
// handles numeric series fields, so lines' trailing non-numeric fields yield
// zero-length value runs.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

static inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r';
}

static const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,
                                1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
                                1e14, 1e15, 1e16, 1e17, 1e18};

static inline double pow10i(int e) {
  bool neg = e < 0;
  if (neg) e = -e;
  double r = 1.0;
  while (e > 18) { r *= 1e18; e -= 18; }
  r *= kPow10[e];
  return neg ? 1.0 / r : r;
}

// Hand-rolled float scanner (strtod is ~6x slower due to locale handling and
// correct-rounding machinery; series data only needs float32 precision).
// Returns chars consumed (0 if not numeric), writes value.
static inline size_t scan_value(const char* p, const char* end, float* out) {
  const char* q = p;
  while (q < end && is_space(*q)) q++;
  if (q < end && *q == '?') {
    *out = NAN;
    q++;
    while (q < end && is_space(*q)) q++;
    return (size_t)(q - p);
  }
  const char* num_start = q;
  bool neg = false;
  if (q < end && (*q == '-' || *q == '+')) { neg = (*q == '-'); q++; }
  uint64_t mant = 0;
  int frac_digits = 0, n_digits = 0;
  while (q < end && *q >= '0' && *q <= '9') {
    if (n_digits < 19) { mant = mant * 10 + (uint64_t)(*q - '0'); n_digits++; }
    q++;
  }
  if (q < end && *q == '.') {
    q++;
    while (q < end && *q >= '0' && *q <= '9') {
      if (n_digits < 19) {
        mant = mant * 10 + (uint64_t)(*q - '0');
        n_digits++;
        frac_digits++;
      }
      q++;
    }
  }
  if (q == num_start || (n_digits == 0 && frac_digits == 0)) return 0;
  int exp10 = -frac_digits;
  if (q < end && (*q == 'e' || *q == 'E')) {
    const char* e_start = q;
    q++;
    bool eneg = false;
    if (q < end && (*q == '-' || *q == '+')) { eneg = (*q == '-'); q++; }
    int ev = 0;
    const char* d_start = q;
    while (q < end && *q >= '0' && *q <= '9') { ev = ev * 10 + (*q - '0'); q++; }
    if (q == d_start) q = e_start;  // bare 'e' — not an exponent
    else exp10 += eneg ? -ev : ev;
  }
  double v = (double)mant * pow10i(exp10);
  *out = (float)(neg ? -v : v);
  while (q < end && is_space(*q)) q++;
  return (size_t)(q - p);
}

// Find the start of the @data section; returns offset or -1.
static int64_t find_data(const char* buf, int64_t len) {
  for (int64_t i = 0; i + 5 <= len; i++) {
    if ((i == 0 || buf[i - 1] == '\n') && (buf[i] == '@' || buf[i] == '#')) {
      if (buf[i] == '@' && i + 5 <= len &&
          (strncmp(buf + i, "@data", 5) == 0 ||
           strncmp(buf + i, "@DATA", 5) == 0)) {
        int64_t j = i + 5;
        while (j < len && buf[j] != '\n') j++;
        return j < len ? j + 1 : len;
      }
    }
  }
  return -1;
}

// Pass 1: count values / fields / lines in the @data section.
int ts_scan_count(const char* buf, int64_t len, int64_t* n_values,
                  int64_t* n_fields, int64_t* n_lines) {
  int64_t pos = find_data(buf, len);
  if (pos < 0) return -1;
  int64_t nv = 0, nf = 0, nl = 0;
  const char* end = buf + len;
  const char* p = buf + pos;
  while (p < end) {
    // one line
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    bool empty = true;
    for (const char* q = p; q < line_end; q++)
      if (!is_space(*q)) { empty = false; break; }
    if (!empty) {
      nl++;
      nf++;  // first field
      const char* q = p;
      while (q < line_end) {
        if (*q == ':') { nf++; q++; continue; }
        float v;
        size_t used = scan_value(q, line_end, &v);
        if (used > 0) { nv++; q += used; }
        else q++;
        if (q < line_end && *q == ',') q++;
      }
    }
    p = line_end + 1;
  }
  *n_values = nv;
  *n_fields = nf;
  *n_lines = nl;
  return 0;
}

// Pass 2: fill the caller-allocated buffers (sizes from pass 1).
// label_starts/label_lens record the raw byte span of each line's LAST
// ':'-field (the class label / regression target when the header declares one).
int ts_scan_parse(const char* buf, int64_t len, float* values,
                  int64_t* field_offsets, int32_t* line_field_counts,
                  int64_t* label_starts, int32_t* label_lens) {
  int64_t pos = find_data(buf, len);
  if (pos < 0) return -1;
  int64_t vi = 0, fi = 0, li = 0;
  const char* end = buf + len;
  const char* p = buf + pos;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    bool empty = true;
    for (const char* q = p; q < line_end; q++)
      if (!is_space(*q)) { empty = false; break; }
    if (!empty) {
      int32_t fields_this_line = 1;
      field_offsets[fi++] = vi;
      const char* q = p;
      const char* last_field_start = p;
      while (q < line_end) {
        if (*q == ':') {
          field_offsets[fi++] = vi;
          fields_this_line++;
          q++;
          last_field_start = q;
          continue;
        }
        float v;
        size_t used = scan_value(q, line_end, &v);
        if (used > 0) { values[vi++] = v; q += used; }
        else q++;
        if (q < line_end && *q == ',') q++;
      }
      const char* ls = last_field_start;
      const char* le = line_end;
      while (ls < le && is_space(*ls)) ls++;
      while (le > ls && is_space(*(le - 1))) le--;
      label_starts[li] = (int64_t)(ls - buf);
      label_lens[li] = (int32_t)(le - ls);
      line_field_counts[li++] = fields_this_line;
    }
    p = line_end + 1;
  }
  field_offsets[fi] = vi;
  return 0;
}

}  // extern "C"
