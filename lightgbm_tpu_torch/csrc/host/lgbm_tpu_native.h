/* C ABI for the host data plane of lightgbm_tpu_torch.
 *
 * The reference implements its host-side data plane in C++ (text parsing
 * src/io/parser.cpp, bin finding src/io/bin.cpp, row-wise prediction
 * src/application/predictor.hpp); this library provides the same hot paths
 * to the port, consumed from Python via ctypes (lightgbm_tpu_torch/
 * native.py).  The device plane (histograms, splits, partitions) is torch
 * and the CUDA kernels of csrc/; this is the host side: text ingest,
 * per-feature greedy binning, and ensemble prediction on raw features.
 */
#ifndef LGBM_TPU_NATIVE_H_
#define LGBM_TPU_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- bin finding (semantics of BinMapper::FindBin, src/io/bin.cpp:139) */

/* values: the non-zero sample values (unsorted, NaN allowed -> dropped).
 * Outputs the numerical upper-bound array (<= max_bin entries) plus the
 * bookkeeping fields.  Returns 0 on success. */
int LGBMTPU_FindBinNumerical(const double* values, int32_t num_values,
                             int32_t total_cnt, int32_t max_bin,
                             int32_t min_data_in_bin, int32_t min_split_data,
                             double* out_upper_bounds, int32_t* out_num_bin,
                             int32_t* out_is_trivial, double* out_min_val,
                             double* out_max_val, int32_t* out_default_bin,
                             double* out_sparse_rate);

/* Batch value->bin via binary search over upper bounds
 * (BinMapper::ValueToBin, include/LightGBM/bin.h:419). out is uint16. */
int LGBMTPU_ValueToBin(const double* upper_bounds, int32_t num_bin,
                       const double* values, int64_t n, uint16_t* out);

/* ---- text parsing (CSV/TSV/space/LibSVM autodetect, src/io/parser.cpp) */

/* Parses the file into a dense row-major feature matrix + label column.
 * The function allocates *out_features ((*out_rows) x (*out_cols)) and
 * *out_label; free both with LGBMTPU_Free.  Returns 0 on success. */
int LGBMTPU_ParseFile(const char* path, int32_t has_header,
                      int32_t label_idx, int64_t* out_rows,
                      int32_t* out_cols, double** out_features,
                      double** out_label);

void LGBMTPU_Free(void* ptr);

/* ---- ensemble prediction on raw features (Tree::GetLeaf semantics,
 *      include/LightGBM/tree.h:250-276; zero-range default redirect) */

/* Flat ensemble layout: trees concatenated; node_offsets[t] /
 * leaf_offsets[t] give tree t's start in the node/leaf arrays
 * (node_offsets[n_trees] = total nodes, same for leaves). */
int LGBMTPU_PredictRaw(int32_t n_trees, const int64_t* node_offsets,
                       const int64_t* leaf_offsets,
                       const int32_t* split_feature, const double* threshold,
                       const int8_t* decision_type,
                       const double* default_value, const int32_t* left_child,
                       const int32_t* right_child, const double* leaf_value,
                       const int32_t* tree_class, int32_t n_class,
                       const double* features, int64_t n_rows,
                       int32_t n_cols, double* out /* n_rows x n_class */);

#ifdef __cplusplus
}
#endif

#endif /* LGBM_TPU_NATIVE_H_ */
