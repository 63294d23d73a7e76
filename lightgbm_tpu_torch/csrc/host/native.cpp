// The host data plane of lightgbm_tpu_torch — see lgbm_tpu_native.h.
//
// The reference's host-side semantics (src/io/bin.cpp GreedyFindBin/
// FindBin, src/io/parser.cpp format autodetect, tree.h GetLeaf),
// structured for batch use from Python rather than the reference's
// per-object classes.  The package's own copy of the JAX package's
// native.cpp, built on first use by native.py (host compiler, no nvcc).

#include "lgbm_tpu_native.h"

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr double kMissingValueRange = 1e-20;
const double kInf = std::numeric_limits<double>::infinity();

// Greedy distinct-value packing (semantics of src/io/bin.cpp:66-137).
std::vector<double> GreedyFindBin(const double* distinct, const int* counts,
                                  int n_distinct, int max_bin, int total_cnt,
                                  int min_data_in_bin) {
  std::vector<double> bounds;
  if (n_distinct <= max_bin) {
    int cur = 0;
    for (int i = 0; i < n_distinct - 1; ++i) {
      cur += counts[i];
      if (cur >= min_data_in_bin) {
        bounds.push_back((distinct[i] + distinct[i + 1]) / 2.0);
        cur = 0;
      }
    }
    bounds.push_back(kInf);
    return bounds;
  }
  if (min_data_in_bin > 0) {
    max_bin = std::max(1, std::min(max_bin, total_cnt / min_data_in_bin));
  }
  double mean_bin_size = static_cast<double>(total_cnt) / max_bin;
  int rest_bins = max_bin;
  int rest_cnt = total_cnt;
  std::vector<char> is_big(n_distinct, 0);
  for (int i = 0; i < n_distinct; ++i) {
    if (counts[i] >= mean_bin_size) {
      is_big[i] = 1;
      --rest_bins;
      rest_cnt -= counts[i];
    }
  }
  mean_bin_size = static_cast<double>(rest_cnt) / std::max(rest_bins, 1);
  std::vector<double> uppers(max_bin, kInf), lowers(max_bin, kInf);
  int bin_cnt = 0;
  lowers[0] = distinct[0];
  int cur = 0;
  const double half = 0.5f;
  for (int i = 0; i < n_distinct - 1; ++i) {
    if (!is_big[i]) rest_cnt -= counts[i];
    cur += counts[i];
    if (is_big[i] || cur >= mean_bin_size ||
        (is_big[i + 1] && cur >= std::max(1.0, mean_bin_size * half))) {
      uppers[bin_cnt] = distinct[i];
      ++bin_cnt;
      lowers[bin_cnt] = distinct[i + 1];
      if (bin_cnt >= max_bin - 1) break;
      cur = 0;
      if (!is_big[i]) {
        --rest_bins;
        mean_bin_size = static_cast<double>(rest_cnt) / std::max(rest_bins, 1);
      }
    }
  }
  ++bin_cnt;
  std::vector<double> out(bin_cnt);
  for (int i = 0; i < bin_cnt - 1; ++i) out[i] = (uppers[i] + lowers[i + 1]) / 2.0;
  out[bin_cnt - 1] = kInf;
  return out;
}

int ValueToBinScalar(const double* bounds, int num_bin, double v) {
  if (std::isnan(v)) return num_bin - 1;
  int l = 0, r = num_bin - 1;
  while (l < r) {
    int m = (r + l - 1) / 2;
    if (v <= bounds[m]) r = m; else l = m + 1;
  }
  return l;
}

bool NeedFilterNumerical(const std::vector<long long>& cnt_in_bin,
                         int total_cnt, int filter_cnt) {
  long long sum_left = 0;
  for (size_t i = 0; i + 1 < cnt_in_bin.size(); ++i) {
    sum_left += cnt_in_bin[i];
    if (sum_left >= filter_cnt && total_cnt - sum_left >= filter_cnt)
      return false;
  }
  return true;
}

}  // namespace

extern "C" int LGBMTPU_FindBinNumerical(
    const double* values, int32_t num_values, int32_t total_cnt,
    int32_t max_bin, int32_t min_data_in_bin, int32_t min_split_data,
    double* out_upper_bounds, int32_t* out_num_bin, int32_t* out_is_trivial,
    double* out_min_val, double* out_max_val, int32_t* out_default_bin,
    double* out_sparse_rate) {
  std::vector<double> vals(values, values + num_values);
  vals.erase(std::remove_if(vals.begin(), vals.end(),
                            [](double v) { return std::isnan(v); }),
             vals.end());
  std::sort(vals.begin(), vals.end());
  const int n = static_cast<int>(vals.size());
  const int zero_cnt = total_cnt - n;

  // distinct values with the zero block spliced in (bin.cpp:150-176)
  std::vector<double> distinct;
  std::vector<int> counts;
  if (n == 0 || (vals[0] > 0.0 && zero_cnt > 0)) {
    distinct.push_back(0.0);
    counts.push_back(zero_cnt);
  }
  if (n > 0) {
    distinct.push_back(vals[0]);
    counts.push_back(1);
  }
  for (int i = 1; i < n; ++i) {
    if (vals[i] != vals[i - 1]) {
      if (vals[i - 1] < 0.0 && vals[i] > 0.0) {
        distinct.push_back(0.0);
        counts.push_back(zero_cnt);
      }
      distinct.push_back(vals[i]);
      counts.push_back(1);
    } else {
      ++counts.back();
    }
  }
  if (n > 0 && vals[n - 1] < 0.0 && zero_cnt > 0) {
    distinct.push_back(0.0);
    counts.push_back(zero_cnt);
  }
  const int n_distinct = static_cast<int>(distinct.size());
  *out_min_val = distinct.front();
  *out_max_val = distinct.back();

  // split distinct values around the zero range (bin.cpp:178-228)
  long long left_cnt_data = 0, missing_cnt_data = 0, right_cnt_data = 0;
  for (int i = 0; i < n_distinct; ++i) {
    if (distinct[i] <= -kMissingValueRange) left_cnt_data += counts[i];
    else if (distinct[i] > kMissingValueRange) right_cnt_data += counts[i];
    else missing_cnt_data += counts[i];
  }
  int left_cnt = 0;
  for (int i = 0; i < n_distinct; ++i) {
    if (distinct[i] > -kMissingValueRange) { left_cnt = i; break; }
  }
  std::vector<double> bounds;
  if (left_cnt > 0) {
    long long denom = std::max<long long>(total_cnt - missing_cnt_data, 1);
    int left_max_bin = static_cast<int>(
        static_cast<double>(left_cnt_data) / denom * (max_bin - 1));
    bounds = GreedyFindBin(distinct.data(), counts.data(), left_cnt,
                           left_max_bin, static_cast<int>(left_cnt_data),
                           min_data_in_bin);
    bounds.back() = -kMissingValueRange;
  }
  int right_start = -1;
  for (int i = left_cnt; i < n_distinct; ++i) {
    if (distinct[i] > kMissingValueRange) { right_start = i; break; }
  }
  if (right_start >= 0) {
    int right_max_bin = max_bin - 1 - static_cast<int>(bounds.size());
    auto rb = GreedyFindBin(distinct.data() + right_start,
                            counts.data() + right_start,
                            n_distinct - right_start, right_max_bin,
                            static_cast<int>(right_cnt_data), min_data_in_bin);
    bounds.push_back(kMissingValueRange);
    bounds.insert(bounds.end(), rb.begin(), rb.end());
  } else {
    bounds.push_back(kInf);
  }
  const int num_bin = static_cast<int>(bounds.size());
  if (num_bin > max_bin) return -1;
  std::copy(bounds.begin(), bounds.end(), out_upper_bounds);
  *out_num_bin = num_bin;

  std::vector<long long> cnt_in_bin(num_bin, 0);
  {
    int i_bin = 0;
    for (int i = 0; i < n_distinct; ++i) {
      if (distinct[i] > bounds[i_bin]) ++i_bin;
      cnt_in_bin[i_bin] += counts[i];
    }
  }
  int trivial = num_bin <= 1 ? 1 : 0;
  if (!trivial &&
      NeedFilterNumerical(cnt_in_bin, total_cnt, min_split_data)) {
    trivial = 1;
  }
  *out_is_trivial = trivial;
  int default_bin = 0;
  if (!trivial) default_bin = ValueToBinScalar(bounds.data(), num_bin, 0.0);
  *out_default_bin = default_bin;
  *out_sparse_rate =
      static_cast<double>(cnt_in_bin[default_bin]) / std::max(total_cnt, 1);
  return 0;
}

extern "C" int LGBMTPU_ValueToBin(const double* upper_bounds, int32_t num_bin,
                                  const double* values, int64_t n,
                                  uint16_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint16_t>(
        ValueToBinScalar(upper_bounds, num_bin, values[i]));
  }
  return 0;
}

// ----------------------------------------------------------- text parsing

namespace {

// format autodetect by separator counting (src/io/parser.cpp:10-70)
enum class Format { kCSV, kTSV, kSpace, kLibSVM };

Format DetectFormat(const std::vector<std::string>& lines) {
  int comma = INT32_MAX, tab = INT32_MAX, colon = INT32_MAX;
  int seen = 0;
  for (const auto& l : lines) {
    if (l.empty()) continue;
    int c = 0, t = 0, co = 0;
    for (char ch : l) {
      if (ch == ',') ++c;
      else if (ch == '\t') ++t;
      else if (ch == ':') ++co;
    }
    comma = std::min(comma, c);
    tab = std::min(tab, t);
    colon = std::min(colon, co);
    if (++seen == 2) break;
  }
  if (seen == 0) return Format::kCSV;
  if (colon > 0 && colon >= std::max(comma, tab)) return Format::kLibSVM;
  if (tab > 0 && tab >= comma) return Format::kTSV;
  if (comma > 0) return Format::kCSV;
  return Format::kSpace;
}

inline double FastAtof(const char* p, const char** end) {
  return std::strtod(p, const_cast<char**>(end));
}

}  // namespace

extern "C" int LGBMTPU_ParseFile(const char* path, int32_t has_header,
                                 int32_t label_idx, int64_t* out_rows,
                                 int32_t* out_cols, double** out_features,
                                 double** out_label) {
  std::ifstream in(path);
  if (!in.good()) return -1;
  std::vector<std::string> lines;
  std::string line;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty()) lines.push_back(std::move(line));
  }
  if (has_header && !lines.empty()) lines.erase(lines.begin());
  if (lines.empty()) return -2;
  Format fmt = DetectFormat(lines);
  const int64_t rows = static_cast<int64_t>(lines.size());

  if (fmt == Format::kLibSVM) {
    std::vector<double> labels(rows, 0.0);
    std::vector<std::vector<std::pair<int, double>>> pairs(rows);
    int max_feat = -1;
    for (int64_t r = 0; r < rows; ++r) {
      const char* p = lines[r].c_str();
      const char* end = p;
      // leading label (no colon before whitespace)
      const char* q = p;
      bool has_colon_first = false;
      while (*q && !std::isspace(static_cast<unsigned char>(*q))) {
        if (*q == ':') { has_colon_first = true; break; }
        ++q;
      }
      if (!has_colon_first) {
        labels[r] = FastAtof(p, &end);
        p = end;
      }
      while (*p) {
        while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (!*p) break;
        char* colon = const_cast<char*>(std::strchr(p, ':'));
        if (!colon) break;
        int fi = std::atoi(p);
        double v = FastAtof(colon + 1, &end);
        pairs[r].emplace_back(fi, v);
        if (fi > max_feat) max_feat = fi;
        p = end;
      }
    }
    const int cols = max_feat + 1;
    double* feat = static_cast<double*>(
        std::calloc(static_cast<size_t>(rows) * cols, sizeof(double)));
    double* lab = static_cast<double*>(std::malloc(rows * sizeof(double)));
    if (!feat || !lab) return -3;
    std::memcpy(lab, labels.data(), rows * sizeof(double));
    for (int64_t r = 0; r < rows; ++r)
      for (auto& kv : pairs[r]) feat[r * cols + kv.first] = kv.second;
    *out_rows = rows;
    *out_cols = cols;
    *out_features = feat;
    *out_label = lab;
    return 0;
  }

  const char sep = fmt == Format::kCSV ? ',' : (fmt == Format::kTSV ? '\t' : ' ');
  // column count from the first line
  int cols_total = 1;
  {
    const char* p = lines[0].c_str();
    if (fmt == Format::kSpace) {
      cols_total = 0;
      bool in_tok = false;
      for (; *p; ++p) {
        bool sp = std::isspace(static_cast<unsigned char>(*p));
        if (!sp && !in_tok) { ++cols_total; in_tok = true; }
        else if (sp) in_tok = false;
      }
    } else {
      for (; *p; ++p) if (*p == sep) ++cols_total;
    }
  }
  const bool has_label = label_idx >= 0 && label_idx < cols_total;
  const int cols = cols_total - (has_label ? 1 : 0);
  double* feat = static_cast<double*>(
      std::malloc(static_cast<size_t>(rows) * cols * sizeof(double)));
  double* lab = static_cast<double*>(std::calloc(rows, sizeof(double)));
  if (!feat || !lab) return -3;
  for (int64_t r = 0; r < rows; ++r) {
    const char* p = lines[r].c_str();
    const char* end;
    int out_c = 0;
    for (int c = 0; c < cols_total && *p; ++c) {
      while (*p == ' ' && fmt != Format::kSpace) ++p;
      double v = FastAtof(p, &end);
      if (end == p) {  // na / non-numeric token
        v = std::numeric_limits<double>::quiet_NaN();
        while (*p && *p != sep &&
               !(fmt == Format::kSpace &&
                 std::isspace(static_cast<unsigned char>(*p)))) ++p;
        end = p;
      }
      if (has_label && c == label_idx) lab[r] = std::isnan(v) ? 0.0 : v;
      else feat[r * cols + out_c++] = v;
      p = end;
      if (fmt == Format::kSpace) {
        while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
      } else {
        if (*p == sep) ++p;
      }
    }
    for (; out_c < cols; ++out_c) feat[r * cols + out_c] = 0.0;
  }
  *out_rows = rows;
  *out_cols = cols;
  *out_features = feat;
  *out_label = lab;
  return 0;
}

extern "C" void LGBMTPU_Free(void* ptr) { std::free(ptr); }

// ------------------------------------------------------------- prediction

extern "C" int LGBMTPU_PredictRaw(
    int32_t n_trees, const int64_t* node_offsets, const int64_t* leaf_offsets,
    const int32_t* split_feature, const double* threshold,
    const int8_t* decision_type, const double* default_value,
    const int32_t* left_child, const int32_t* right_child,
    const double* leaf_value, const int32_t* tree_class, int32_t n_class,
    const double* features, int64_t n_rows, int32_t n_cols, double* out) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const double* row = features + r * n_cols;
    double* orow = out + r * n_class;
    for (int t = 0; t < n_trees; ++t) {
      const int64_t no = node_offsets[t];
      const int64_t n_nodes = node_offsets[t + 1] - no;
      if (n_nodes <= 0) continue;  // single-leaf tree contributes 0
      const int64_t lo = leaf_offsets[t];
      int node = 0;
      while (node >= 0) {
        const int64_t k = no + node;
        double fv = row[split_feature[k]];
        if (fv > -kMissingValueRange && fv <= kMissingValueRange)
          fv = default_value[k];
        bool left;
        if (decision_type[k] == 0) {
          left = fv <= threshold[k];
        } else {
          left = static_cast<int64_t>(fv) ==
                 static_cast<int64_t>(threshold[k]);
        }
        node = left ? left_child[k] : right_child[k];
      }
      orow[tree_class[t]] += leaf_value[lo + (~node)];
    }
  }
  return 0;
}
