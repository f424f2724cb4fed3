// Native numeric-table parser for the data-ingestion path.
//
// The Python loaders (scfgp/data/datasets.py::_parse_table) sniff
// delimiters/headers/comments with per-token Python float() calls — fine at
// UCI scale, minutes at the N=1e6 streaming-scale CSVs this framework
// targets (SURVEY.md §5 long-context: dataset size N is the scaling axis).
// This translation unit parses an ALL-NUMERIC table at memory-bandwidth-ish
// speed:
//
//   * line index built in one scan (skips blank lines and '#'/'%' comments),
//   * optional single header row auto-detected (line 0 fails strtod, line 1
//     parses),
//   * comma or whitespace delimiters (sniffed per line),
//   * OpenMP-parallel strtod fill over data lines,
//   * any non-numeric token / ragged row => returns -1 and the caller falls
//     back to the Python sniffing path (which handles categorical columns
//     like UCI abalone's sex).
//
// C ABI for ctypes (no pybind11 in this image).  Build: make -C native.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Line {
  const char* begin;
  const char* end;
};

bool is_comment_or_blank(const char* b, const char* e) {
  while (b < e && (*b == ' ' || *b == '\t' || *b == '\r')) ++b;
  return b == e || *b == '#' || *b == '%';
}

// Fast decimal float parse for the common CSV case (sign, digits, '.',
// digits, optional e-exponent) — strtod is locale-aware and several times
// slower; numbers with >17 mantissa digits or hex/inf/nan forms fall back
// to strtod for exactness.  Returns parse end, or ``p`` on failure.
const char* parse_double_fast(const char* p, const char* e, double* out) {
  const char* start = p;
  bool neg = false;
  if (p < e && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool any = false;
  while (p < e && *p >= '0' && *p <= '9') {
    mant = mant * 10 + static_cast<uint64_t>(*p - '0');
    ++digits; ++p; any = true;
  }
  if (p < e && *p == '.') {
    ++p;
    while (p < e && *p >= '0' && *p <= '9') {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++digits; ++frac; ++p; any = true;
    }
  }
  if (!any) return start;
  int exp10 = -frac;
  if (p < e && (*p == 'e' || *p == 'E')) {
    const char* q = p + 1;
    bool eneg = false;
    if (q < e && (*q == '-' || *q == '+')) eneg = (*q++ == '-');
    int ev = 0;
    bool eany = false;
    while (q < e && *q >= '0' && *q <= '9') {
      ev = ev * 10 + (*q - '0');
      ++q; eany = true;
    }
    if (!eany) return start;
    exp10 += eneg ? -ev : ev;
    p = q;
  }
  if (digits > 15 || exp10 < -22 || exp10 > 22) {
    // mant may exceed 2^53 (Clinger exactness bound) or the power-of-ten
    // window: strtod gives correct rounding
    char* endp = nullptr;
    double v = std::strtod(start, &endp);
    if (endp == start) return start;
    *out = v;
    return endp;
  }
  // exact: mant < 10^15 < 2^53, |exp10| <= 22 -> one correctly-rounded
  // multiply/divide (classic Clinger fast path)
  static const double kPow10[] = {
      1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
      1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
      1e22};
  double v = static_cast<double>(mant);
  v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
  *out = neg ? -v : v;
  return p;
}

// Parse one line into out[0..cols); returns the number of fields parsed, or
// -1 on a non-numeric token.  out may be null (count/validate only).
int64_t parse_line(const char* b, const char* e, double* out, int64_t cap) {
  int64_t k = 0;
  const char* p = b;
  while (p < e) {
    // skip delimiters (comma, whitespace, quotes)
    while (p < e && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r' ||
                     *p == '"')) ++p;
    if (p >= e) break;
    double v = 0.0;
    const char* endp = parse_double_fast(p, e, &v);
    if (endp == p) return -1;  // non-numeric token
    if (out) {
      if (k >= cap) return -1;
      out[k] = v;
    }
    ++k;
    p = endp;
    // after a number: only delimiters/quotes may follow before next token
    if (p < e && !(*p == ',' || *p == ' ' || *p == '\t' || *p == '\r' ||
                   *p == '"')) return -1;
  }
  return k;
}

}  // namespace

extern "C" {

// Pass 1 (out == nullptr): returns row count, sets *out_cols, sets
// *header_skipped (0/1).  Pass 2 (out != nullptr, out_cap = rows*cols):
// fills row-major float64, returns rows written.  Returns -1 whenever the
// table is not a clean all-numeric block (caller falls back to Python).
int64_t scfgp_parse_numeric_table(const char* buf, int64_t len, double* out,
                                  int64_t out_cap, int64_t* out_cols,
                                  int64_t* header_skipped) {
  std::vector<Line> lines;
  lines.reserve(1024);
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* e = nl ? nl : end;
    if (!is_comment_or_blank(p, e)) lines.push_back({p, e});
    p = nl ? nl + 1 : end;
  }
  if (lines.empty()) return -1;

  // Column count from the first line; header if line 0 fails but line 1
  // parses.
  int64_t skip = 0;
  int64_t cols = parse_line(lines[0].begin, lines[0].end, nullptr, 0);
  if (cols <= 0) {
    if (lines.size() < 2) return -1;
    cols = parse_line(lines[1].begin, lines[1].end, nullptr, 0);
    if (cols <= 0) return -1;
    skip = 1;
  }
  int64_t rows = static_cast<int64_t>(lines.size()) - skip;
  if (out_cols) *out_cols = cols;
  if (header_skipped) *header_skipped = skip;

  if (!out) {
    // count-only pass: full validation happens in the fill pass (parsing
    // twice doubled ingestion cost for zero information)
    return rows;
  }

  if (out_cap < rows * cols) return -1;
  bool ok = true;
#pragma omp parallel for schedule(static) reduction(&& : ok)
  for (int64_t i = 0; i < rows; ++i) {
    const Line& L = lines[static_cast<size_t>(i + skip)];
    ok = ok && (parse_line(L.begin, L.end, out + i * cols, cols) == cols);
  }
  return ok ? rows : -1;
}

}  // extern "C"
