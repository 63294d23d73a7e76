// LGBM_* C ABI as a shared library of the port: liblgbm_tpu_torch_capi.so.
//
// Parity target: include/LightGBM/c_api.h:37-719 (the reference exports
// its C API from lib_lightgbm.so so every non-Python binding can link).
// The data plane and training run in the Python/torch runtime, so the
// ABI is a thin embedding bridge: each exported symbol takes the CPython
// GIL (starting an interpreter if the host process has none), wraps the
// caller's raw buffers as memoryviews, and forwards to the _abi_*
// adapters of lightgbm_tpu_torch/c_api.py.  Handles are the registry's
// integers cast through void*.
//
// lightgbm_tpu_torch/capi_lib.py builds this file with the host C++
// compiler on first use (into lightgbm_tpu_torch/_build/).  A standalone
// (non-Python) host needs lightgbm_tpu_torch importable (PYTHONPATH), as
// the reference needs its library on LD_LIBRARY_PATH.  Loaded into a
// Python process with ctypes.CDLL, it attaches to the running interpreter
// through the GIL.  Boosters train on the card unless the caller asks
// for the CPU: device_type=cpu in their parameters, or LGBM_SetDevice.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#define LGBM_EXPORT extern "C" __attribute__((visibility("default")))

typedef void* DatasetHandle;
typedef void* BoosterHandle;

static thread_local std::string g_last_error;

namespace {

std::once_flag g_py_init_once;

struct Gil {
  PyGILState_STATE state;
  Gil() {
    // first caller wins the interpreter bootstrap; concurrent first calls
    // from a threaded C host must not double-initialize
    std::call_once(g_py_init_once, [] {
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        // drop the GIL acquired by initialization so Ensure below nests
        PyEval_SaveThread();
      }
    });
    state = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state); }
};

PyObject* api_module() {
  static PyObject* mod = nullptr;   // borrowed forever (GIL-protected init)
  if (!mod) {
    mod = PyImport_ImportModule("lightgbm_tpu_torch.c_api");
  }
  return mod;
}

void capture_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = where;
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* text = PyUnicode_AsUTF8(s);
      if (text) {
        msg += ": ";
        msg += text;
      }
      Py_DECREF(s);
    }
  }
  g_last_error = msg;
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

// call adapter fn; returns new reference or nullptr (error captured)
PyObject* call(const char* fn, PyObject* args) {
  PyObject* mod = api_module();
  if (!mod) {
    capture_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (!f) {
    capture_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!r) capture_error(fn);
  return r;
}

PyObject* mv(const void* ptr, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory((char*)ptr, nbytes, PyBUF_READ);
}

Py_ssize_t dtype_size(int code) {
  switch (code) {
    case 0: return 4;   // float32
    case 1: return 8;   // float64
    case 2: return 4;   // int32
    default: return 8;  // int64
  }
}

int handle_of(PyObject* r, void** out) {
  if (!r) return -1;
  long h = PyLong_AsLong(r);
  Py_DECREF(r);
  if (h == -1 && PyErr_Occurred()) {
    capture_error("handle");
    return -1;
  }
  *out = (void*)(intptr_t)h;
  return 0;
}

long as_handle(void* h) { return (long)(intptr_t)h; }

// copy a float64 ndarray (buffer protocol) into out, set out_len
int copy_f64(PyObject* r, int64_t* out_len, double* out_result) {
  if (!r) return -1;
  Py_buffer view;
  if (PyObject_GetBuffer(r, &view, PyBUF_CONTIG_RO) != 0) {
    capture_error("result buffer");
    Py_DECREF(r);
    return -1;
  }
  Py_ssize_t n = view.len / (Py_ssize_t)sizeof(double);
  std::memcpy(out_result, view.buf, (size_t)view.len);
  if (out_len) *out_len = (int64_t)n;
  PyBuffer_Release(&view);
  Py_DECREF(r);
  return 0;
}

int ret_ok(PyObject* r) {
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

// copy a Python str into a caller buffer (reference SaveModelToString /
// DumpModel contract: out_len includes the NUL; truncate to buffer_len)
int copy_str(PyObject* r, int64_t buffer_len, int64_t* out_len,
             char* out_str) {
  if (!r) return -1;
  Py_ssize_t n = 0;
  const char* s = PyUnicode_AsUTF8AndSize(r, &n);
  if (!s) {
    capture_error("string result");
    Py_DECREF(r);
    return -1;
  }
  if (out_len) *out_len = (int64_t)n + 1;
  if (out_str && buffer_len > 0) {
    Py_ssize_t c = n + 1 <= buffer_len ? n + 1 : (Py_ssize_t)buffer_len;
    std::memcpy(out_str, s, (size_t)(c - 1));
    out_str[c - 1] = '\0';
  }
  Py_DECREF(r);
  return 0;
}

// copy a Python list[str] into caller-pre-allocated char** — the
// GetEvalNames/GetFeatureNames contract of this vintage: the caller
// allocates fixed-width slots of at least kNameSlotWidth bytes each (the
// reference's Python wrapper uses 255-byte buffers and its C side strcpy's
// with no bound). We keep the ABI but cap each write at kNameSlotWidth
// bytes including the NUL, so an under-allocating caller gets a truncated
// name instead of a silent overflow.
static const size_t kNameSlotWidth = 255;
int copy_strs(PyObject* r, int* out_len, char** out_strs) {
  if (!r) return -1;
  if (!PyList_Check(r)) {
    g_last_error = "expected list of strings";
    Py_DECREF(r);
    return -1;
  }
  Py_ssize_t n = PyList_Size(r);
  if (out_len) *out_len = (int)n;
  if (out_strs) {
    for (Py_ssize_t i = 0; i < n; ++i) {
      const char* s = PyUnicode_AsUTF8(PyList_GetItem(r, i));
      if (!s) {
        capture_error("string list");
        Py_DECREF(r);
        return -1;
      }
      size_t len = strnlen(s, kNameSlotWidth - 1);
      std::memcpy(out_strs[i], s, len);
      out_strs[i][len] = '\0';
    }
  }
  Py_DECREF(r);
  return 0;
}

int int_of(PyObject* r, int* out) {
  if (!r) return -1;
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  if (v == -1 && PyErr_Occurred()) {
    capture_error("int result");
    return -1;
  }
  if (out) *out = (int)v;
  return 0;
}

int i64_of(PyObject* r, int64_t* out) {
  if (!r) return -1;
  long long v = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (v == -1 && PyErr_Occurred()) {
    capture_error("int64 result");
    return -1;
  }
  if (out) *out = (int64_t)v;
  return 0;
}

}  // namespace

LGBM_EXPORT const char* LGBM_GetLastError() { return g_last_error.c_str(); }

LGBM_EXPORT void LGBM_SetLastError(const char* msg) {
  g_last_error = msg ? msg : "";
}

// not in the reference C API: the device ("cuda", "cuda:N" or "cpu") of
// the boosters created after it whose parameters name none
LGBM_EXPORT int LGBM_SetDevice(const char* device) {
  Gil gil;
  return ret_ok(call("LGBM_SetDevice",
                     Py_BuildValue("(s)", device ? device : "cuda")));
}

LGBM_EXPORT int LGBM_DatasetCreateFromFile(const char* filename,
                                           const char* parameters,
                                           const DatasetHandle reference,
                                           DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue("(ssl)", filename, parameters ? parameters : "",
                                 as_handle((void*)reference));
  return handle_of(call("_abi_dataset_from_file", args), out);
}

LGBM_EXPORT int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                          int32_t nrow, int32_t ncol,
                                          int is_row_major,
                                          const char* parameters,
                                          const DatasetHandle reference,
                                          DatasetHandle* out) {
  Gil gil;
  Py_ssize_t nbytes = (Py_ssize_t)nrow * ncol * dtype_size(data_type);
  PyObject* args = Py_BuildValue(
      "(Niiiisl)", mv(data, nbytes), (int)nrow, (int)ncol, data_type,
      is_row_major, parameters ? parameters : "",
      as_handle((void*)reference));
  return handle_of(call("_abi_dataset_from_mat", args), out);
}

LGBM_EXPORT int LGBM_DatasetCreateFromCSR(
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col, const char* parameters, const DatasetHandle reference,
    DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NLiNNLiLsl)", mv(indptr, nindptr * dtype_size(indptr_type)),
      (long long)nindptr, indptr_type,
      mv(indices, nelem * (Py_ssize_t)sizeof(int32_t)),
      mv(data, nelem * dtype_size(data_type)), (long long)nelem, data_type,
      (long long)num_col, parameters ? parameters : "",
      as_handle((void*)reference));
  return handle_of(call("_abi_dataset_from_csr", args), out);
}

LGBM_EXPORT int LGBM_DatasetCreateFromCSC(
    const void* col_ptr, int col_ptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t ncol_ptr, int64_t nelem,
    int64_t num_row, const char* parameters, const DatasetHandle reference,
    DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NLiNNLiLsl)", mv(col_ptr, ncol_ptr * dtype_size(col_ptr_type)),
      (long long)ncol_ptr, col_ptr_type,
      mv(indices, nelem * (Py_ssize_t)sizeof(int32_t)),
      mv(data, nelem * dtype_size(data_type)), (long long)nelem, data_type,
      (long long)num_row, parameters ? parameters : "",
      as_handle((void*)reference));
  return handle_of(call("_abi_dataset_from_csc", args), out);
}

LGBM_EXPORT int LGBM_DatasetFree(DatasetHandle handle) {
  Gil gil;
  return ret_ok(call("LGBM_DatasetFree",
                     Py_BuildValue("(l)", as_handle(handle))));
}

LGBM_EXPORT int LGBM_DatasetSetField(DatasetHandle handle,
                                     const char* field_name,
                                     const void* field_data,
                                     int64_t num_element, int type) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(lsNLi)", as_handle(handle), field_name,
      mv(field_data, num_element * dtype_size(type)),
      (long long)num_element, type);
  return ret_ok(call("_abi_dataset_set_field", args));
}

LGBM_EXPORT int LGBM_DatasetGetNumData(DatasetHandle handle, int* out) {
  Gil gil;
  return int_of(call("LGBM_DatasetGetNumData",
                     Py_BuildValue("(l)", as_handle(handle))), out);
}

LGBM_EXPORT int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out) {
  Gil gil;
  return int_of(call("LGBM_DatasetGetNumFeature",
                     Py_BuildValue("(l)", as_handle(handle))), out);
}

LGBM_EXPORT int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                       const char* filename) {
  Gil gil;
  return ret_ok(call("LGBM_DatasetSaveBinary",
                     Py_BuildValue("(ls)", as_handle(handle), filename)));
}

LGBM_EXPORT int LGBM_BoosterCreate(const DatasetHandle train_data,
                                   const char* parameters,
                                   BoosterHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue("(ls)", as_handle((void*)train_data),
                                 parameters ? parameters : "");
  return handle_of(call("LGBM_BoosterCreate", args), out);
}

LGBM_EXPORT int LGBM_BoosterCreateFromModelfile(const char* filename,
                                                int* out_num_iterations,
                                                BoosterHandle* out) {
  Gil gil;
  if (handle_of(call("LGBM_BoosterCreateFromModelfile",
                     Py_BuildValue("(s)", filename)), out) != 0)
    return -1;
  PyObject* r = call("LGBM_BoosterGetCurrentIteration",
                     Py_BuildValue("(l)", as_handle(*out)));
  if (!r) return -1;
  if (out_num_iterations) *out_num_iterations = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterLoadModelFromString(const char* model_str,
                                                int* out_num_iterations,
                                                BoosterHandle* out) {
  Gil gil;
  if (handle_of(call("LGBM_BoosterLoadModelFromString",
                     Py_BuildValue("(s)", model_str)), out) != 0)
    return -1;
  PyObject* r = call("LGBM_BoosterGetCurrentIteration",
                     Py_BuildValue("(l)", as_handle(*out)));
  if (!r) return -1;
  if (out_num_iterations) *out_num_iterations = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterFree(BoosterHandle handle) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterFree",
                     Py_BuildValue("(l)", as_handle(handle))));
}

LGBM_EXPORT int LGBM_BoosterAddValidData(BoosterHandle handle,
                                         const DatasetHandle valid_data) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterAddValidData",
                     Py_BuildValue("(ll)", as_handle(handle),
                                   as_handle((void*)valid_data))));
}

LGBM_EXPORT int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                          int* is_finished) {
  Gil gil;
  PyObject* r = call("LGBM_BoosterUpdateOneIter",
                     Py_BuildValue("(l)", as_handle(handle)));
  if (!r) return -1;
  if (is_finished) *is_finished = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterRollbackOneIter",
                     Py_BuildValue("(l)", as_handle(handle))));
}

LGBM_EXPORT int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                                int* out_iteration) {
  Gil gil;
  PyObject* r = call("LGBM_BoosterGetCurrentIteration",
                     Py_BuildValue("(l)", as_handle(handle)));
  if (!r) return -1;
  *out_iteration = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetNumClasses(BoosterHandle handle,
                                          int* out_len) {
  Gil gil;
  PyObject* r = call("LGBM_BoosterGetNumClasses",
                     Py_BuildValue("(l)", as_handle(handle)));
  if (!r) return -1;
  *out_len = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetEvalCounts(BoosterHandle handle,
                                          int* out_len) {
  Gil gil;
  PyObject* r = call("LGBM_BoosterGetEvalCounts",
                     Py_BuildValue("(l)", as_handle(handle)));
  if (!r) return -1;
  *out_len = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                    int* out_len, double* out_results) {
  Gil gil;
  int64_t n = 0;
  PyObject* r = call("_abi_booster_get_eval",
                     Py_BuildValue("(li)", as_handle(handle), data_idx));
  if (copy_f64(r, &n, out_results) != 0) return -1;
  if (out_len) *out_len = (int)n;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterSaveModel(BoosterHandle handle,
                                      int num_iteration,
                                      const char* filename) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterSaveModel",
                     Py_BuildValue("(lis)", as_handle(handle),
                                   num_iteration, filename)));
}

LGBM_EXPORT int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                              int num_iteration,
                                              int64_t buffer_len,
                                              int64_t* out_len,
                                              char* out_str) {
  Gil gil;
  PyObject* r = call("_abi_booster_save_model_string",
                     Py_BuildValue("(li)", as_handle(handle),
                                   num_iteration));
  if (!r) return -1;
  Py_ssize_t n = 0;
  const char* s = PyUnicode_AsUTF8AndSize(r, &n);
  if (!s) {
    capture_error("model string");
    Py_DECREF(r);
    return -1;
  }
  if (out_len) *out_len = (int64_t)n + 1;
  if (out_str && buffer_len > 0) {
    Py_ssize_t c = n + 1 <= buffer_len ? n + 1 : buffer_len;
    std::memcpy(out_str, s, (size_t)(c - 1));
    out_str[c - 1] = '\0';
  }
  Py_DECREF(r);
  return 0;
}

LGBM_EXPORT int LGBM_BoosterPredictForMat(
    BoosterHandle handle, const void* data, int data_type, int32_t nrow,
    int32_t ncol, int is_row_major, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result) {
  Gil gil;
  (void)parameter;  // reference reads only early-stop knobs from it
  Py_ssize_t nbytes = (Py_ssize_t)nrow * ncol * dtype_size(data_type);
  PyObject* args = Py_BuildValue(
      "(lNiiiiii)", as_handle(handle), mv(data, nbytes), (int)nrow,
      (int)ncol, data_type, is_row_major, predict_type, num_iteration);
  return copy_f64(call("_abi_booster_predict_mat", args), out_len,
                  out_result);
}

LGBM_EXPORT int LGBM_BoosterPredictForCSR(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  Gil gil;
  (void)parameter;
  PyObject* args = Py_BuildValue(
      "(lNLiNNLiLii)", as_handle(handle),
      mv(indptr, nindptr * dtype_size(indptr_type)), (long long)nindptr,
      indptr_type, mv(indices, nelem * (Py_ssize_t)sizeof(int32_t)),
      mv(data, nelem * dtype_size(data_type)), (long long)nelem, data_type,
      (long long)num_col, predict_type, num_iteration);
  return copy_f64(call("_abi_booster_predict_csr", args), out_len,
                  out_result);
}

LGBM_EXPORT int LGBM_BoosterPredictForCSC(
    BoosterHandle handle, const void* col_ptr, int col_ptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t ncol_ptr, int64_t nelem, int64_t num_row, int predict_type,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  Gil gil;
  (void)parameter;  // the reference ignores it for CSC too
  PyObject* args = Py_BuildValue(
      "(lNLiNNLiLii)", as_handle(handle),
      mv(col_ptr, ncol_ptr * dtype_size(col_ptr_type)), (long long)ncol_ptr,
      col_ptr_type, mv(indices, nelem * (Py_ssize_t)sizeof(int32_t)),
      mv(data, nelem * dtype_size(data_type)), (long long)nelem, data_type,
      (long long)num_row, predict_type, num_iteration);
  return copy_f64(call("_abi_booster_predict_csc", args), out_len,
                  out_result);
}

LGBM_EXPORT int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                              int64_t num_total_row,
                                              DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue("(lL)", as_handle((void*)reference),
                                 (long long)num_total_row);
  return handle_of(call("LGBM_DatasetCreateByReference", args), out);
}

LGBM_EXPORT int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                                     int data_type, int32_t nrow,
                                     int32_t ncol, int32_t start_row) {
  Gil gil;
  Py_ssize_t nbytes = (Py_ssize_t)nrow * ncol * dtype_size(data_type);
  PyObject* args = Py_BuildValue("(lNiiii)", as_handle(dataset),
                                 mv(data, nbytes), (int)nrow, (int)ncol,
                                 data_type, (int)start_row);
  return ret_ok(call("_abi_dataset_push_rows", args));
}

LGBM_EXPORT int LGBM_DatasetPushRowsByCSR(
    DatasetHandle dataset, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int64_t start_row) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(lNLiNNLiLL)", as_handle(dataset),
      mv(indptr, nindptr * dtype_size(indptr_type)), (long long)nindptr,
      indptr_type, mv(indices, nelem * (Py_ssize_t)sizeof(int32_t)),
      mv(data, nelem * dtype_size(data_type)), (long long)nelem, data_type,
      (long long)num_col, (long long)start_row);
  return ret_ok(call("_abi_dataset_push_rows_csr", args));
}

LGBM_EXPORT int LGBM_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int* num_per_col, int32_t num_sample_row, int32_t num_total_row,
    const char* parameters, DatasetHandle* out) {
  Gil gil;
  PyObject* cols = PyList_New(ncol);
  PyObject* idxs = PyList_New(ncol);
  if (!cols || !idxs) {
    capture_error("sampled column lists");
    Py_XDECREF(cols);
    Py_XDECREF(idxs);
    return -1;
  }
  for (int32_t c = 0; c < ncol; ++c) {
    PyList_SET_ITEM(cols, c,
                    mv(sample_data[c],
                       (Py_ssize_t)num_per_col[c] * sizeof(double)));
    PyList_SET_ITEM(idxs, c,
                    mv(sample_indices[c],
                       (Py_ssize_t)num_per_col[c] * sizeof(int)));
  }
  PyObject* args = Py_BuildValue("(NNiiis)", cols, idxs, (int)ncol,
                                 (int)num_sample_row, (int)num_total_row,
                                 parameters ? parameters : "");
  return handle_of(call("_abi_dataset_from_sampled", args), out);
}

LGBM_EXPORT int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                      const int32_t* used_row_indices,
                                      int32_t num_used_row_indices,
                                      const char* parameters,
                                      DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(lNis)", as_handle((void*)handle),
      mv(used_row_indices,
         (Py_ssize_t)num_used_row_indices * sizeof(int32_t)),
      (int)num_used_row_indices, parameters ? parameters : "");
  return handle_of(call("_abi_dataset_get_subset", args), out);
}

LGBM_EXPORT int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                            const char** feature_names,
                                            int num_feature_names) {
  Gil gil;
  PyObject* names = PyList_New(num_feature_names);
  if (!names) {
    capture_error("feature name list");
    return -1;
  }
  for (int i = 0; i < num_feature_names; ++i) {
    PyObject* u = feature_names[i] ? PyUnicode_FromString(feature_names[i])
                                   : nullptr;
    if (!u) {
      if (!PyErr_Occurred()) g_last_error = "feature name is NULL";
      else capture_error("feature name");
      Py_DECREF(names);
      return -1;
    }
    PyList_SET_ITEM(names, i, u);
  }
  PyObject* args = Py_BuildValue("(lN)", as_handle(handle), names);
  return ret_ok(call("LGBM_DatasetSetFeatureNames", args));
}

LGBM_EXPORT int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                            char** feature_names,
                                            int* num_feature_names) {
  Gil gil;
  return copy_strs(call("LGBM_DatasetGetFeatureNames",
                        Py_BuildValue("(l)", as_handle(handle))),
                   num_feature_names, feature_names);
}

LGBM_EXPORT int LGBM_DatasetGetField(DatasetHandle handle,
                                     const char* field_name, int* out_len,
                                     const void** out_ptr, int* out_type) {
  Gil gil;
  PyObject* r = call("_abi_dataset_get_field",
                     Py_BuildValue("(ls)", as_handle(handle), field_name));
  if (!r) return -1;
  long long addr = 0, n = 0;
  int code = 1;
  if (!PyArg_ParseTuple(r, "LLi", &addr, &n, &code)) {
    capture_error("GetField result");
    Py_DECREF(r);
    return -1;
  }
  Py_DECREF(r);
  if (out_ptr) *out_ptr = (const void*)(intptr_t)addr;
  if (out_len) *out_len = (int)n;
  if (out_type) *out_type = code;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterMerge(BoosterHandle handle,
                                  BoosterHandle other_handle) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterMerge",
                     Py_BuildValue("(ll)", as_handle(handle),
                                   as_handle(other_handle))));
}

LGBM_EXPORT int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                              const DatasetHandle train_data) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterResetTrainingData",
                     Py_BuildValue("(ll)", as_handle(handle),
                                   as_handle((void*)train_data))));
}

LGBM_EXPORT int LGBM_BoosterResetParameter(BoosterHandle handle,
                                           const char* parameters) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterResetParameter",
                     Py_BuildValue("(ls)", as_handle(handle),
                                   parameters ? parameters : "")));
}

LGBM_EXPORT int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                                const float* grad,
                                                const float* hess,
                                                int* is_finished) {
  Gil gil;
  int64_t n = 0;
  if (i64_of(call("_abi_booster_train_size",
                  Py_BuildValue("(l)", as_handle(handle))), &n) != 0)
    return -1;
  PyObject* args = Py_BuildValue(
      "(lNNL)", as_handle(handle),
      mv(grad, (Py_ssize_t)n * (Py_ssize_t)sizeof(float)),
      mv(hess, (Py_ssize_t)n * (Py_ssize_t)sizeof(float)), (long long)n);
  return int_of(call("_abi_booster_update_custom", args), is_finished);
}

LGBM_EXPORT int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                                         char** out_strs) {
  Gil gil;
  return copy_strs(call("LGBM_BoosterGetEvalNames",
                        Py_BuildValue("(l)", as_handle(handle))),
                   out_len, out_strs);
}

LGBM_EXPORT int LGBM_BoosterGetFeatureNames(BoosterHandle handle,
                                            int* out_len, char** out_strs) {
  Gil gil;
  return copy_strs(call("LGBM_BoosterGetFeatureNames",
                        Py_BuildValue("(l)", as_handle(handle))),
                   out_len, out_strs);
}

LGBM_EXPORT int LGBM_BoosterGetNumFeature(BoosterHandle handle,
                                          int* out_len) {
  Gil gil;
  return int_of(call("LGBM_BoosterGetNumFeature",
                     Py_BuildValue("(l)", as_handle(handle))), out_len);
}

LGBM_EXPORT int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                                          int64_t* out_len) {
  Gil gil;
  return i64_of(call("LGBM_BoosterGetNumPredict",
                     Py_BuildValue("(li)", as_handle(handle), data_idx)),
                out_len);
}

LGBM_EXPORT int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                                           int predict_type,
                                           int num_iteration,
                                           int64_t* out_len) {
  Gil gil;
  return i64_of(call("LGBM_BoosterCalcNumPredict",
                     Py_BuildValue("(liii)", as_handle(handle), num_row,
                                   predict_type, num_iteration)),
                out_len);
}

LGBM_EXPORT int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                       int64_t* out_len,
                                       double* out_result) {
  Gil gil;
  return copy_f64(call("_abi_booster_get_predict",
                       Py_BuildValue("(li)", as_handle(handle), data_idx)),
                  out_len, out_result);
}

LGBM_EXPORT int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                           const char* data_filename,
                                           int data_has_header,
                                           int predict_type,
                                           int num_iteration,
                                           const char* parameter,
                                           const char* result_filename) {
  Gil gil;
  (void)parameter;  // CLI-only extras; the Python path reads the model's
  return ret_ok(call(
      "LGBM_BoosterPredictForFile",
      Py_BuildValue("(lsisii)", as_handle(handle), data_filename,
                    data_has_header, result_filename, predict_type,
                    num_iteration)));
}

LGBM_EXPORT int LGBM_BoosterDumpModel(BoosterHandle handle,
                                      int num_iteration, int buffer_len,
                                      int* out_len, char* out_str) {
  Gil gil;
  int64_t n = 0;
  int rc = copy_str(call("_abi_booster_dump_model",
                         Py_BuildValue("(li)", as_handle(handle),
                                       num_iteration)),
                    (int64_t)buffer_len, &n, out_str);
  if (out_len) *out_len = (int)n;
  return rc;
}

LGBM_EXPORT int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                         int leaf_idx, double* out_val) {
  Gil gil;
  PyObject* r = call("LGBM_BoosterGetLeafValue",
                     Py_BuildValue("(lii)", as_handle(handle), tree_idx,
                                   leaf_idx));
  if (!r) return -1;
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  if (v == -1.0 && PyErr_Occurred()) {
    capture_error("leaf value");
    return -1;
  }
  if (out_val) *out_val = v;
  return 0;
}

LGBM_EXPORT int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                         int leaf_idx, double val) {
  Gil gil;
  return ret_ok(call("LGBM_BoosterSetLeafValue",
                     Py_BuildValue("(liid)", as_handle(handle), tree_idx,
                                   leaf_idx, val)));
}
