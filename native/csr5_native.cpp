// Native runtime components of the CSR5 framework.
//
// The reference implements its host-side runtime in C (NIST mmio.{h,c},
// ~620 LoC per backend copy) and C++ (the benchmark drivers' COO->CSR
// build, CSR5_cuda/main.cu:157-312, and the serial golden-model SpMV,
// main.cu:336-355). This file provides the same capabilities as one
// shared library consumed from Python over ctypes:
//
//   * mm_load(path)            -- Matrix Market parse (coordinate
//     real/integer/pattern, general/symmetric/skew-symmetric/hermitian),
//     1->0 based indexing, symmetric expansion, stable CSR build that
//     keeps duplicates and file order within a row (exact behavioural
//     parity with utils/mmio.py, which is the Python oracle for this
//     code).
//   * csr_spmv_f64/f32         -- serial CSR SpMV (the golden model).
//   * csr5_tile_ptr            -- binary-search tile partition pointer
//     (generate_partition_pointer_s1_kernel, format_cuda.h:21-42) as a
//     native fast path for huge conversions.
//
// No external dependencies; C++17; built by native/Makefile into
// libcsr5native.so.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Loaded {
  int64_t m = 0, n = 0, nnz = 0;
  std::vector<int64_t> row_ptr;
  std::vector<int32_t> col_idx;
  std::vector<double> values;
  std::string error;
};

// thread-unsafe simple error slot for the last failed load
thread_local std::string g_last_error;

bool starts_with(const std::string& s, const char* p) {
  return s.rfind(p, 0) == 0;
}

void lower(std::string& s) {
  for (auto& c : s) c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
}

// fast float parse fallback to strtod; fast paths for plain ints
double parse_value(const char*& p) {
  char* end = nullptr;
  double v = std::strtod(p, &end);
  p = end;
  return v;
}

int64_t parse_int(const char*& p) {
  while (*p == ' ' || *p == '\t') ++p;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  int64_t v = 0;
  while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

Loaded* load_impl(const char* path) {
  auto out = new Loaded();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = std::string("cannot open: ") + path + ": " + std::strerror(errno);
    return out;
  }
  // read whole file (mtx files are line-oriented ASCII)
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(fsize));
  if (fsize > 0 && std::fread(buf.data(), 1, static_cast<size_t>(fsize), f) !=
                        static_cast<size_t>(fsize)) {
    out->error = "short read";
    std::fclose(f);
    return out;
  }
  std::fclose(f);

  const char* p = buf.c_str();
  const char* bufend = p + buf.size();

  auto next_line = [&](std::string& line) -> bool {
    if (p >= bufend) return false;
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', bufend - p));
    if (!nl) nl = bufend;
    line.assign(p, nl - p);
    p = (nl < bufend) ? nl + 1 : bufend;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    return true;
  };

  // banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  std::string line;
  if (!next_line(line) || !starts_with(line, "%%MatrixMarket")) {
    out->error = "missing %%MatrixMarket banner";
    return out;
  }
  lower(line);
  bool is_pattern = line.find("pattern") != std::string::npos;
  bool is_real = line.find("real") != std::string::npos;
  bool is_integer = line.find("integer") != std::string::npos;
  bool is_complex = line.find("complex") != std::string::npos;
  bool sym = line.find(" symmetric") != std::string::npos &&
             line.find("skew-symmetric") == std::string::npos;
  bool skew = line.find("skew-symmetric") != std::string::npos;
  bool herm = line.find("hermitian") != std::string::npos;
  if (line.find("coordinate") == std::string::npos) {
    out->error = "only coordinate (sparse) Matrix Market supported";
    return out;
  }
  if (is_complex) {
    out->error = "complex matrices unsupported (main.cu:180-184 parity)";
    return out;
  }
  if (!is_pattern && !is_real && !is_integer) {
    out->error = "unknown field in banner";
    return out;
  }

  // comments then size line
  for (;;) {
    if (!next_line(line)) { out->error = "missing size line"; return out; }
    if (!line.empty() && line[0] != '%') break;
  }
  {
    const char* q = line.c_str();
    out->m = parse_int(q);
    out->n = parse_int(q);
    out->nnz = parse_int(q);
  }
  if (out->m <= 0 || out->n <= 0 || out->nnz < 0) {
    out->error = "bad size line";
    return out;
  }

  const bool mirror = sym || skew || herm;
  int64_t declared = out->nnz;
  std::vector<int32_t> rows, cols;
  std::vector<double> vals;
  rows.reserve(static_cast<size_t>(declared) * (mirror ? 2 : 1));
  cols.reserve(rows.capacity());
  vals.reserve(rows.capacity());

  for (int64_t k = 0; k < declared; ++k) {
    const char* q;
    do {
      if (!next_line(line)) { out->error = "truncated data section"; return out; }
      q = line.c_str();
      while (*q == ' ' || *q == '\t') ++q;
    } while (*q == '\0' || *q == '%');
    int64_t i = parse_int(q) - 1;  // 1 -> 0 based (main.cu:227-228)
    int64_t j = parse_int(q) - 1;
    double v = 1.0;  // pattern value (main.cu:219-222)
    if (!is_pattern) v = parse_value(q);
    if (i < 0 || i >= out->m || j < 0 || j >= out->n) {
      out->error = "index out of range at entry " + std::to_string(k + 1);
      return out;
    }
    rows.push_back(static_cast<int32_t>(i));
    cols.push_back(static_cast<int32_t>(j));
    vals.push_back(v);
    if (mirror && i != j) {  // symmetric expansion (main.cu:243-270)
      rows.push_back(static_cast<int32_t>(j));
      cols.push_back(static_cast<int32_t>(i));
      vals.push_back(skew ? -v : v);
    }
  }

  // stable counting-sort CSR build (main.cu:276-312): keeps duplicates,
  // within-row order follows (expanded) file order
  const int64_t nnz = static_cast<int64_t>(rows.size());
  out->nnz = nnz;
  out->row_ptr.assign(static_cast<size_t>(out->m) + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) out->row_ptr[rows[k] + 1]++;
  for (int64_t r = 0; r < out->m; ++r) out->row_ptr[r + 1] += out->row_ptr[r];
  out->col_idx.resize(static_cast<size_t>(nnz));
  out->values.resize(static_cast<size_t>(nnz));
  std::vector<int64_t> next(out->row_ptr.begin(), out->row_ptr.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t dst = next[rows[k]]++;
    out->col_idx[static_cast<size_t>(dst)] = cols[k];
    out->values[static_cast<size_t>(dst)] = vals[k];
  }
  return out;
}

}  // namespace

extern "C" {

// ---- loader handle API ------------------------------------------------

void* mm_load(const char* path) {
  Loaded* l = load_impl(path);
  if (!l->error.empty()) {
    g_last_error = l->error;
    delete l;
    return nullptr;
  }
  return l;
}

const char* mm_last_error() { return g_last_error.c_str(); }

int64_t mm_rows(void* h) { return static_cast<Loaded*>(h)->m; }
int64_t mm_cols(void* h) { return static_cast<Loaded*>(h)->n; }
int64_t mm_nnz(void* h) { return static_cast<Loaded*>(h)->nnz; }

void mm_fill(void* h, int64_t* row_ptr, int32_t* col_idx, double* values) {
  Loaded* l = static_cast<Loaded*>(h);
  std::memcpy(row_ptr, l->row_ptr.data(), l->row_ptr.size() * sizeof(int64_t));
  std::memcpy(col_idx, l->col_idx.data(), l->col_idx.size() * sizeof(int32_t));
  std::memcpy(values, l->values.data(), l->values.size() * sizeof(double));
}

void mm_free(void* h) { delete static_cast<Loaded*>(h); }

// ---- golden-model serial SpMV (main.cu:336-355) -------------------------

void csr_spmv_f64(int64_t m, const int64_t* row_ptr, const int32_t* col_idx,
                  const double* values, const double* x, double alpha,
                  double* y) {
  for (int64_t r = 0; r < m; ++r) {
    double acc = 0.0;
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k)
      acc += values[k] * x[col_idx[k]];
    y[r] = alpha * acc;
  }
}

void csr_spmv_f32(int64_t m, const int64_t* row_ptr, const int32_t* col_idx,
                  const float* values, const float* x, float alpha, float* y) {
  for (int64_t r = 0; r < m; ++r) {
    float acc = 0.0f;
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k)
      acc += values[k] * x[col_idx[k]];
    y[r] = alpha * acc;
  }
}

// ---- native conversion fast paths ---------------------------------------

// tile_ptr[t] = row containing nonzero t*tile_nnz: binary search of the
// right boundary (generate_partition_pointer_s1_kernel, format_cuda.h:21-42)
void csr5_tile_ptr(int64_t m, int64_t p, int64_t tile_nnz,
                   const int64_t* row_ptr, int32_t* tile_ptr) {
  for (int64_t t = 0; t <= p; ++t) {
    int64_t target = t * tile_nnz;
    int64_t lo = 0, hi = m;  // find last r with row_ptr[r] <= target
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) >> 1;
      if (row_ptr[mid] <= target) lo = mid;
      else hi = mid - 1;
    }
    tile_ptr[t] = static_cast<int32_t>(lo);  // == clip(searchsorted-1, 0, m)
  }
}

// ---- execution-plan fast paths ------------------------------------------
//
// Per-tile distinct x-page statistics and page lists (see ops/convert.py
// "execution plan"). One linear pass with a page bitmap per tile; avoids
// nnz-scale numpy temporaries.

// Phase 1: per-tile page_lo, page_cnt (distinct col>>7 pages) and the
// global maxima. col_flat has p*tile_nnz entries (tail padded).
void csr5_page_stats(int64_t p, int64_t tile_nnz, const int32_t* col_flat,
                     int64_t n_pages, int32_t* page_lo, int32_t* page_cnt,
                     int32_t* out_span_max, int32_t* out_cnt_max) {
  std::vector<uint8_t> seen(static_cast<size_t>(n_pages), 0);
  std::vector<int32_t> touched;
  touched.reserve(4096);
  int32_t span_max = 0, cnt_max = 0;
  for (int64_t t = 0; t < p; ++t) {
    const int32_t* c = col_flat + t * tile_nnz;
    int32_t lo = INT32_MAX, hi = -1, cnt = 0;
    for (int64_t k = 0; k < tile_nnz; ++k) {
      int32_t pg = c[k] >> 7;
      if (pg < lo) lo = pg;
      if (pg > hi) hi = pg;
      if (!seen[pg]) {
        seen[pg] = 1;
        touched.push_back(pg);
        ++cnt;
      }
    }
    for (int32_t pg : touched) seen[pg] = 0;
    touched.clear();
    page_lo[t] = lo;
    page_cnt[t] = cnt;
    int32_t span = hi - lo + 1;
    if (span > span_max) span_max = span;
    if (cnt > cnt_max) cnt_max = cnt;
  }
  *out_span_max = span_max;
  *out_cnt_max = cnt_max;
}

// Phase 2 (non-contiguous mode): fill the (p, pmax) page lists, sorted
// ascending, dead slots = sentinel.
void csr5_page_lists(int64_t p, int64_t tile_nnz, const int32_t* col_flat,
                     int64_t n_pages, int64_t pmax, int32_t sentinel,
                     int32_t* pages) {
  std::vector<uint8_t> seen(static_cast<size_t>(n_pages), 0);
  std::vector<int32_t> touched;
  touched.reserve(static_cast<size_t>(pmax));
  for (int64_t t = 0; t < p; ++t) {
    const int32_t* c = col_flat + t * tile_nnz;
    for (int64_t k = 0; k < tile_nnz; ++k) {
      int32_t pg = c[k] >> 7;
      if (!seen[pg]) {
        seen[pg] = 1;
        touched.push_back(pg);
      }
    }
    std::sort(touched.begin(), touched.end());
    int32_t* row = pages + t * pmax;
    size_t i = 0;
    for (; i < touched.size() && i < static_cast<size_t>(pmax); ++i)
      row[i] = touched[i];
    for (; i < static_cast<size_t>(pmax); ++i) row[i] = sentinel;
    for (int32_t pg : touched) seen[pg] = 0;
    touched.clear();
  }
}

// Phase 3 (packed-column plane): per-element local page index = rank of
// the element's page within its tile's sorted distinct-page list. Emitted
// as uint16 "lane | local<<7" (valid while pmax <= 512), the packed
// column encoding of CSR5Matrix.col_packed (models/formats.py).
void csr5_col_local(int64_t p, int64_t tile_nnz, const int32_t* col_flat,
                    int64_t n_pages, uint16_t* packed) {
  std::vector<int32_t> rank(static_cast<size_t>(n_pages), -1);
  std::vector<int32_t> touched;
  touched.reserve(4096);
  for (int64_t t = 0; t < p; ++t) {
    const int32_t* c = col_flat + t * tile_nnz;
    for (int64_t k = 0; k < tile_nnz; ++k) {
      int32_t pg = c[k] >> 7;
      if (rank[pg] < 0) {
        rank[pg] = 0;
        touched.push_back(pg);
      }
    }
    std::sort(touched.begin(), touched.end());
    for (size_t i = 0; i < touched.size(); ++i) rank[touched[i]] = static_cast<int32_t>(i);
    uint16_t* o = packed + t * tile_nnz;
    for (int64_t k = 0; k < tile_nnz; ++k) {
      int32_t pg = c[k] >> 7;
      o[k] = static_cast<uint16_t>((c[k] & 127) | (rank[pg] << 7));
    }
    for (int32_t pg : touched) rank[pg] = -1;
    touched.clear();
  }
}

// CSR5 partition descriptor (format_cuda.h:129-267 parity), host-side:
// one walk over rows computes, per tile, the packed bit_flag words
// (head bits along sigma, little-endian within each 32-bit word),
// y_offset (exclusive per-lane segment-count prefix), seg_offset
// (distance-1 to the next flagged lane right, omega-l-1 if none) and
// nseg (total segments). Element (t, s, l) = flat t*T + l*sigma + s.
void csr5_descriptor(int64_t m, int64_t p, int64_t sigma, int64_t omega,
                     const int64_t* row_ptr, uint32_t* bit_flag,
                     int32_t* y_offset, int32_t* seg_offset, int64_t* nseg) {
  const int64_t T = sigma * omega;
  const int64_t nwords = (sigma + 31) / 32;
  const int64_t nnz_pad = p * T;
  std::vector<int32_t> lane_cnt(static_cast<size_t>(omega));
  int64_t r = 0;  // row cursor over head positions
  for (int64_t t = 0; t < p; ++t) {
    uint32_t* bf = bit_flag + t * nwords * omega;  // (nwords, omega)
    std::fill(bf, bf + nwords * omega, 0u);
    std::fill(lane_cnt.begin(), lane_cnt.end(), 0);
    const int64_t e0 = t * T, e1 = e0 + T;
    auto mark = [&](int64_t local) {
      const int64_t l = local / sigma, s = local % sigma;
      uint32_t& w = bf[(s >> 5) * omega + l];
      const uint32_t bit = 1u << (s & 31);
      if (!(w & bit)) {
        w |= bit;
        ++lane_cnt[static_cast<size_t>(l)];
      }
    };
    mark(0);  // forced tile-leading bit (format_cuda.h:171-175)
    while (r < m && row_ptr[r] < e1) {
      // skip empty rows (they start no element)
      if (row_ptr[r + 1] > row_ptr[r] && row_ptr[r] >= e0) mark(row_ptr[r] - e0);
      if (row_ptr[r + 1] > e1) break;  // row continues into next tile
      ++r;
    }
    int32_t* yo = y_offset + t * omega;
    int64_t acc = 0;
    for (int64_t l = 0; l < omega; ++l) {
      yo[l] = static_cast<int32_t>(acc);
      acc += lane_cnt[static_cast<size_t>(l)];
    }
    nseg[t] = acc;
    int32_t* so = seg_offset + t * omega;
    int32_t next = static_cast<int32_t>(omega);  // no flagged lane right
    for (int64_t l = omega - 1; l >= 0; --l) {
      int32_t d = next - static_cast<int32_t>(l) - 1;
      so[l] = d < 0 ? 0 : (d > omega ? static_cast<int32_t>(omega) : d);
      if (lane_cnt[static_cast<size_t>(l)] > 0) next = static_cast<int32_t>(l);
    }
  }
  (void)nnz_pad;
}

// Empty-row indirection table (format_cuda.h:362-523 parity): for the
// k-th segment head of each dirty tile, the row offset from tile_ptr[t].
// eo_ptr must hold the exclusive prefix of (dirty ? nseg : 0).
void csr5_empty_offsets(int64_t m, int64_t p, int64_t tile_nnz,
                        const int64_t* row_ptr, const int32_t* tile_ptr,
                        const uint8_t* dirty, const int64_t* eo_ptr,
                        int32_t* eo) {
  int64_t r = 0;
  for (int64_t t = 0; t < p; ++t) {
    const int64_t e0 = t * tile_nnz, e1 = e0 + tile_nnz;
    // advance the row cursor to the row owning element e0
    while (r + 1 < m && row_ptr[r + 1] <= e0) ++r;
    if (!dirty[t]) continue;
    int32_t* out = eo + eo_ptr[t];
    int64_t k = 0;
    // forced head at e0 belongs to the row owning e0
    out[k++] = static_cast<int32_t>(r - tile_ptr[t]);
    int64_t rr = r;
    while (rr < m && row_ptr[rr] < e1) {
      if (row_ptr[rr + 1] > row_ptr[rr] && row_ptr[rr] > e0)
        out[k++] = static_cast<int32_t>(rr - tile_ptr[t]);
      if (row_ptr[rr + 1] > e1) break;
      ++rr;
    }
  }
}

}  // extern "C"

// AoS->SoA tile transpose (format_cuda.h:525-744 parity), host-side:
// src (p, omega, sigma) element order -> dst (p, sigma, omega). Done in
// C++ because numpy's strided copy of this permutation is slow; each (omega*sigma*esize <= 32 KB) tile is
// L1-resident so the strided reads are cheap.
template <typename T>
static void transpose_tiles_t(int64_t p, int64_t omega, int64_t sigma,
                              const T* src, T* dst) {
  for (int64_t t = 0; t < p; ++t) {
    const T* s = src + t * omega * sigma;
    T* d = dst + t * omega * sigma;
    for (int64_t ss = 0; ss < sigma; ++ss) {
      const T* srow = s + ss;
      T* drow = d + ss * omega;
      for (int64_t l = 0; l < omega; ++l) drow[l] = srow[l * sigma];
    }
  }
}

extern "C" {

// esize in {2, 4, 8}; returns 0 on success, -1 on unsupported esize
int32_t csr5_tile_transpose(int64_t p, int64_t omega, int64_t sigma,
                            int64_t esize, const void* src, void* dst) {
  switch (esize) {
    case 2:
      transpose_tiles_t(p, omega, sigma, static_cast<const uint16_t*>(src),
                        static_cast<uint16_t*>(dst));
      return 0;
    case 4:
      transpose_tiles_t(p, omega, sigma, static_cast<const uint32_t*>(src),
                        static_cast<uint32_t*>(dst));
      return 0;
    case 8:
      transpose_tiles_t(p, omega, sigma, static_cast<const uint64_t*>(src),
                        static_cast<uint64_t*>(dst));
      return 0;
    default:
      return -1;
  }
}

// Stream-compressed column-plane combine: uint16 lane|local<<7 codes in
// (p, omega, sigma) element order -> int32 (p, sigma/2, omega) words
// pairing sigma-rows (s, s + sigma/2):  word = lo | hi << 16. Matches the
// former on-device combine in ops/convert.py (sigma must be even).
void csr5_pack_col16(int64_t p, int64_t omega, int64_t sigma,
                     const uint16_t* src, int32_t* dst) {
  const int64_t s2 = sigma / 2;
  for (int64_t t = 0; t < p; ++t) {
    const uint16_t* s = src + t * omega * sigma;
    int32_t* d = dst + t * s2 * omega;
    for (int64_t ss = 0; ss < s2; ++ss) {
      const uint16_t* lo = s + ss;
      const uint16_t* hi = s + s2 + ss;
      int32_t* drow = d + ss * omega;
      for (int64_t l = 0; l < omega; ++l)
        drow[l] = static_cast<int32_t>(lo[l * sigma]) |
                  (static_cast<int32_t>(hi[l * sigma]) << 16);
    }
  }
}

}  // extern "C"

extern "C" {

// Matrix Market coordinate writer (mm_write_* parity, mmio.h:29-31 --
// declared-but-unused in the reference; used here by the benchmark's
// real-matrix generation, where the Python per-line loop is far slower). Writes "coordinate real general", 1-based.
// Returns 0 on success, -1 on I/O error.
int32_t mm_write_csr(const char* path, int64_t m, int64_t n, int64_t nnz,
                     const int64_t* row_ptr, const int32_t* col_idx,
                     const double* values) {
  std::FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "%%%%MatrixMarket matrix coordinate real general\n");
  std::fprintf(f, "%lld %lld %lld\n", static_cast<long long>(m),
               static_cast<long long>(n), static_cast<long long>(nnz));
  char buf[64];
  std::string chunk;
  chunk.reserve(1 << 20);
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k) {
      double v = values[k];
      int len;
      if (v == static_cast<double>(static_cast<long long>(v)) &&
          std::fabs(v) < 1e15) {
        len = std::snprintf(buf, sizeof buf, "%lld %d %lld\n",
                            static_cast<long long>(r + 1), col_idx[k] + 1,
                            static_cast<long long>(v));
      } else {
        len = std::snprintf(buf, sizeof buf, "%lld %d %.17g\n",
                            static_cast<long long>(r + 1), col_idx[k] + 1, v);
      }
      chunk.append(buf, static_cast<size_t>(len));
      if (chunk.size() > (1 << 20) - 64) {
        if (std::fwrite(chunk.data(), 1, chunk.size(), f) != chunk.size()) {
          std::fclose(f);
          return -1;
        }
        chunk.clear();
      }
    }
  }
  bool ok = std::fwrite(chunk.data(), 1, chunk.size(), f) == chunk.size();
  ok = (std::fclose(f) == 0) && ok;
  return ok ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Dense band-block fill (ops/bandmm.py): zero the (m_pad, K) plane and
// scatter each nonzero into its 128-row block's column window. Plain
// row-major stores — the numpy route (repeat + fancy scatter) walks three
// nnz-scale int64 temps.
// ---------------------------------------------------------------------------

extern "C" {

void bandblock_fill(int64_t m, int64_t m_pad, int64_t K,
                    const int64_t* row_ptr, const int32_t* col_idx,
                    const double* val_f64, const float* val_f32,
                    const int32_t* c0_pages, float* dense) {
  std::memset(dense, 0, static_cast<size_t>(m_pad) * K * sizeof(float));
  for (int64_t r = 0; r < m; ++r) {
    const int64_t c0 = static_cast<int64_t>(c0_pages[r >> 7]) * 128;
    float* drow = dense + r * K;
    if (val_f32) {
      for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k)
        drow[col_idx[k] - c0] = val_f32[k];
    } else {
      for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k)
        drow[col_idx[k] - c0] = static_cast<float>(val_f64[k]);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DIA plan + interleaved fill (ops/dia.py). The numpy route materialises
// three nnz-scale int64 temps (repeat'd rows, offsets, unique's sort) and
// finishes with np.add.at; these are two plain passes over the CSR arrays.
// ---------------------------------------------------------------------------

extern "C" {

// Mark distinct diagonal offsets. marks: (m+n-1) zeroed bytes. Writes the
// ascending offsets into uniq (capacity cap) and returns their count, or
// -1 as soon as a (cap+1)-th distinct offset appears (the caller's
// max_diags gate — bail before scanning the rest).
int64_t dia_plan(int64_t m, int64_t n, const int64_t* row_ptr,
                 const int32_t* col_idx, uint8_t* marks, int64_t* uniq,
                 int64_t cap) {
  const int64_t base = m - 1;
  int64_t cnt = 0;
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k) {
      const int64_t off = static_cast<int64_t>(col_idx[k]) - r + base;
      if (!marks[off]) {
        marks[off] = 1;
        if (++cnt > cap) return -1;
      }
    }
  }
  int64_t w = 0;
  for (int64_t o = 0; o < m + n - 1; ++o)
    if (marks[o]) uniq[w++] = o - base;
  return cnt;
}

// Zero + scatter-fill the interleaved (m_pad/128, nd, 128) f32 plane,
// summing duplicates (scipy dia parity). diag_index maps off+m-1 -> d.
void dia_fill(int64_t m, int64_t m_pad, int64_t nd, const int64_t* row_ptr,
              const int32_t* col_idx, const double* val_f64,
              const float* val_f32, const int32_t* diag_index,
              float* data) {
  std::memset(data, 0,
              static_cast<size_t>(m_pad / 128) * nd * 128 * sizeof(float));
  const int64_t base = m - 1;
  for (int64_t r = 0; r < m; ++r) {
    float* blk = data + (r >> 7) * nd * 128 + (r & 127);
    for (int64_t k = row_ptr[r]; k < row_ptr[r + 1]; ++k) {
      const int64_t d =
          diag_index[static_cast<int64_t>(col_idx[k]) - r + base];
      const float v = val_f32 ? val_f32[k] : static_cast<float>(val_f64[k]);
      blk[d * 128] += v;
    }
  }
}

}  // extern "C"
