// Threaded TSV checkpoint writer.
//
// Native counterpart of the reference's native matrix writer
// (matrix.hh:1140-1166: rows "seq \t externalID \t v0 ... vK-1" at
// %.8f). Checkpoints are written every rfreq iterations
// (hgaprec.cc:2137-2158); at Netflix scale one family is 480189 x 100
// floats x 3 files, which a Python formatting loop turns into the
// dominant cost of the whole run. Here rows are formatted in parallel
// blocks and written sequentially.
//
// Exposed via ctypes from hgaprec_jax/data/native.py; falls back to the
// Python writer when the toolchain is unavailable.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlockRows = 16384;

// Unsigned integer to decimal, returns chars written.
inline int utoa_ll(char* p, unsigned long long v) {
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  for (int i = 0; i < n; ++i) p[i] = tmp[n - 1 - i];
  return n;
}

// Fixed-point "%.8f" without glibc printf (which costs ~700ns/value on
// this host — the dominant checkpoint cost). Values representable in a
// 64-bit 1e8-scaled integer take the fast path; |v| >= 9e9 (never seen
// in Gamma posteriors) falls back to snprintf. Last-digit rounding can
// differ from printf by 1 ulp of the 8th decimal; the parsed value is
// within 1e-8 either way.
inline int fmt_fixed8(char* p, double v) {
  char* q = p;
  if (v < 0) {
    *q++ = '-';
    v = -v;
  }
  if (!(v < 9e9)) {  // also catches NaN
    return static_cast<int>(q - p) +
           snprintf(q, 32, "%.8f", v);
  }
  unsigned long long s =
      static_cast<unsigned long long>(v * 1e8 + 0.5);
  unsigned long long ip = s / 100000000ULL;
  unsigned long long fp = s % 100000000ULL;
  q += utoa_ll(q, ip);
  *q++ = '.';
  for (int i = 7; i >= 0; --i) {
    q[i] = static_cast<char>('0' + fp % 10);
    fp /= 10;
  }
  q += 8;
  return static_cast<int>(q - p);
}

// Format rows [r0, r1) into out.
void format_rows(const float* x, int64_t cols, const int64_t* ext_ids,
                 int64_t r0, int64_t r1, std::string* out) {
  out->clear();
  out->reserve(static_cast<size_t>((r1 - r0) * (cols * 13 + 24)));
  char buf[48];
  for (int64_t r = r0; r < r1; ++r) {
    int n = utoa_ll(buf, static_cast<unsigned long long>(r));
    buf[n++] = '\t';
    long long e = ext_ids[r];
    if (e < 0) {
      buf[n++] = '-';
      e = -e;
    }
    n += utoa_ll(buf + n, static_cast<unsigned long long>(e));
    out->append(buf, n);
    const float* row = x + r * cols;
    for (int64_t c = 0; c < cols; ++c) {
      buf[0] = '\t';
      n = 1 + fmt_fixed8(buf + 1, static_cast<double>(row[c]));
      out->append(buf, n);
    }
    out->push_back('\n');
  }
}

}  // namespace

extern "C" {

// Writes rows x cols of f32 data as "seq\text\tv0...\n". Returns rows
// written, or -1 on open failure.
int64_t write_tsv_mat(const char* path, const float* x, int64_t rows,
                      int64_t cols, const int64_t* ext_ids) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 4;
  if (nthreads > 16) nthreads = 16;

  std::vector<std::string> parts(nthreads);
  for (int64_t blk = 0; blk < rows; blk += kBlockRows * nthreads) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nthreads; ++t) {
      int64_t r0 = blk + static_cast<int64_t>(t) * kBlockRows;
      int64_t r1 = r0 + kBlockRows;
      if (r0 > rows) r0 = rows;
      if (r1 > rows) r1 = rows;
      ts.emplace_back(format_rows, x, cols, ext_ids, r0, r1, &parts[t]);
    }
    for (auto& th : ts) th.join();
    for (unsigned t = 0; t < nthreads; ++t) {
      if (!parts[t].empty() &&
          fwrite(parts[t].data(), 1, parts[t].size(), f) != parts[t].size()) {
        fclose(f);
        return -1;
      }
    }
  }
  if (fclose(f) != 0) return -1;
  return rows;
}

}  // extern "C"
