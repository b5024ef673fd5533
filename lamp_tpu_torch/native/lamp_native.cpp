// Native host-side components (C++), loaded via ctypes.
//
// A copy of lamp_tpu/native/lamp_native.cpp (the port imports nothing of the
// JAX package). None of it runs on the card; it covers host-side hot paths:
//   * greedy byte-segment BPE encoding and n-gram counting (corpus
//     preparation: the pure-Python loop is the bottleneck on large corpora)
//   * numeric CSV parsing
//   * extra-trees forest traversal (batch inference without Python dispatch)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 lamp_native.cpp -o lamp_native.so
// (lamp_tpu_torch/native/__init__.py builds it into lamp_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// byte-segment BPE: greedy longest-match encode
// ---------------------------------------------------------------------------

struct BpeTable {
  // segments packed into one buffer; offsets/lengths/tokens parallel arrays
  std::unordered_map<std::string, int32_t> map;
  int max_len = 1;
};

void* bpe_create(const uint8_t* seg_bytes, const int64_t* seg_offsets,
                 const int32_t* seg_tokens, int64_t n_segs) {
  auto* t = new BpeTable();
  for (int64_t i = 0; i < n_segs; ++i) {
    int64_t start = seg_offsets[i];
    int64_t end = seg_offsets[i + 1];
    std::string key(reinterpret_cast<const char*>(seg_bytes + start),
                    static_cast<size_t>(end - start));
    t->map.emplace(std::move(key), seg_tokens[i]);
    if (end - start > t->max_len) t->max_len = static_cast<int>(end - start);
  }
  return t;
}

void bpe_destroy(void* handle) { delete static_cast<BpeTable*>(handle); }

int64_t bpe_encode(void* handle, const uint8_t* corpus, int64_t n,
                   int32_t unknown_token, int32_t* out) {
  auto* t = static_cast<BpeTable*>(handle);
  int64_t i = 0;
  int64_t out_n = 0;
  std::string key;
  key.reserve(t->max_len);
  while (i < n) {
    int32_t tok = unknown_token;
    int used = 1;
    int max_try = static_cast<int>(std::min<int64_t>(t->max_len, n - i));
    for (int len = max_try; len >= 1; --len) {
      key.assign(reinterpret_cast<const char*>(corpus + i),
                 static_cast<size_t>(len));
      auto it = t->map.find(key);
      if (it != t->map.end()) {
        tok = it->second;
        used = len;
        break;
      }
    }
    out[out_n++] = tok;
    i += used;
  }
  return out_n;
}

// ---------------------------------------------------------------------------
// byte n-gram counting for BPE training (the hot loop of train_bpe):
// n-grams up to 7 bytes are packed into a uint64 (bytes little-endian,
// length in the top byte — the same packing trick as the reference's
// LongMap, bytesegmentencoding/package.scala:50-66)
// ---------------------------------------------------------------------------

struct NgramCounts {
  std::unordered_map<uint64_t, int64_t> map;
};

void* bpe_count_build(const uint8_t* corpus, int64_t n, int32_t max_len) {
  auto* c = new NgramCounts();
  c->map.reserve(1 << 20);
  int ml = max_len > 7 ? 7 : max_len;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = 0;
    int64_t lim = std::min<int64_t>(ml, n - i);
    for (int64_t l = 0; l < lim; ++l) {
      key |= static_cast<uint64_t>(corpus[i + l]) << (8 * l);
      uint64_t packed = key | (static_cast<uint64_t>(l + 1) << 56);
      ++c->map[packed];
    }
  }
  return c;
}

int64_t bpe_count_size(void* handle) {
  return static_cast<int64_t>(static_cast<NgramCounts*>(handle)->map.size());
}

void bpe_count_fill(void* handle, uint64_t* keys, int64_t* counts) {
  auto* c = static_cast<NgramCounts*>(handle);
  int64_t i = 0;
  for (const auto& kv : c->map) {
    keys[i] = kv.first;
    counts[i] = kv.second;
    ++i;
  }
}

void bpe_count_free(void* handle) { delete static_cast<NgramCounts*>(handle); }

// ---------------------------------------------------------------------------
// numeric CSV parsing: parse a buffer of delimiter-separated floats
// ---------------------------------------------------------------------------

// Parses up to max_rows x n_cols doubles from buf. Missing/invalid cells
// become NaN. Returns rows parsed; sets *cols_out from the first row when
// n_cols == 0.
int64_t csv_parse_numeric(const char* buf, int64_t n, char delimiter,
                          int32_t skip_rows, double* out, int64_t max_rows,
                          int32_t n_cols, int32_t* cols_out) {
  int64_t i = 0;
  int32_t row = -skip_rows;
  int32_t col = 0;
  int32_t ncols = n_cols;
  const char* p = buf;
  const char* end = buf + n;
  int64_t out_rows = 0;
  const char* cell_start = p;

  auto emit_cell = [&](const char* s, const char* e) {
    if (row < 0) return;
    if (ncols > 0 && col >= ncols) return;
    double v;
    if (s == e) {
      v = std::strtod("nan", nullptr);
    } else {
      char* pe = nullptr;
      std::string tmp(s, static_cast<size_t>(e - s));
      v = std::strtod(tmp.c_str(), &pe);
      if (pe == tmp.c_str()) v = std::strtod("nan", nullptr);
    }
    if (out_rows < max_rows && (ncols == 0 || col < ncols)) {
      int64_t stride = ncols > 0 ? ncols : 0;
      if (stride > 0) out[out_rows * stride + col] = v;
    }
  };

  while (p <= end) {
    if (p == end || *p == '\n' || *p == delimiter) {
      emit_cell(cell_start, p);
      ++col;
      if (p == end || *p == '\n') {
        if (row == 0 && ncols == 0) {
          ncols = col;
          *cols_out = ncols;
          // first data row was only counted; caller re-invokes with n_cols
        }
        if (row >= 0 && col > 0 && ncols > 0) ++out_rows;
        ++row;
        col = 0;
        if (p == end) break;
      }
      cell_start = p + 1;
    }
    ++p;
  }
  if (ncols > 0) *cols_out = ncols;
  return out_rows;
}

// ---------------------------------------------------------------------------
// extra-trees traversal: route a batch of rows through one tree
// ---------------------------------------------------------------------------

// missing_less[node] != 0 means a NaN feature value routes LEFT at that
// node (the split was scored with missing-on-the-less side during the
// build, mirroring the reference's missingIsLess direction choice —
// forest/package.scala:13-97). `v <= thr` is false for NaN, so the
// default without the flag is missing-routes-right.
static inline int32_t route(double v, double thr, unsigned char missing_less,
                            int32_t left, int32_t right) {
  if (v <= thr) return left;
  if (missing_less && std::isnan(v)) return left;
  return right;
}

void tree_apply(const double* x, int64_t n_rows, int64_t n_cols,
                const int32_t* feature, const double* threshold,
                const int32_t* left, const int32_t* right,
                const unsigned char* missing_less, int64_t* out_leaf) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const double* rowp = x + r * n_cols;
    int32_t node = 0;
    while (feature[node] >= 0) {
      node = route(rowp[feature[node]], threshold[node], missing_less[node],
                   left[node], right[node]);
    }
    out_leaf[r] = node;
  }
}

// forest version: accumulate leaf values (n_values per leaf) over all trees
void forest_predict(const double* x, int64_t n_rows, int64_t n_cols,
                    int64_t n_trees,
                    const int32_t** features, const double** thresholds,
                    const int32_t** lefts, const int32_t** rights,
                    const double** values, const unsigned char** missing,
                    int64_t n_values, double* out) {
  std::memset(out, 0, sizeof(double) * n_rows * n_values);
  for (int64_t t = 0; t < n_trees; ++t) {
    const int32_t* feature = features[t];
    const double* threshold = thresholds[t];
    const int32_t* left = lefts[t];
    const int32_t* right = rights[t];
    const double* value = values[t];
    const unsigned char* missing_less = missing[t];
    for (int64_t r = 0; r < n_rows; ++r) {
      const double* rowp = x + r * n_cols;
      int32_t node = 0;
      while (feature[node] >= 0) {
        node = route(rowp[feature[node]], threshold[node],
                     missing_less[node], left[node], right[node]);
      }
      const double* v = value + static_cast<int64_t>(node) * n_values;
      double* o = out + r * n_values;
      for (int64_t k = 0; k < n_values; ++k) o[k] += v[k];
    }
  }
  double inv = 1.0 / static_cast<double>(n_trees);
  for (int64_t i = 0; i < n_rows * n_values; ++i) out[i] *= inv;
}

}  // extern "C"
