// clp_c_api.cpp — C API implementation embedding CPython.
//
// The reference exposes its solver to C through Clp_C_Interface.cpp (an
// opaque handle + flat functions); here the same surface drives the
// clp_tpu_torch Python package through the CPython embedding API. Built
// by clp_tpu_torch.io.native.build_capi (g++, links libpython); exercised
// end-to-end by tests/test_torch_cli.py and chip_smoke.py, which compile
// and run the C client test_capi.c.

#include "ClpTpu_C_Interface.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

std::once_flag g_init_once;
bool g_initialized = false;
bool g_we_own_interp = false;

struct Handle {
  PyObject *model;  // clp_tpu_torch.Model instance
  void *user_pointer = nullptr;
  clptpu_callback callback = nullptr;  // registerCallBack target
  // handle-owned buffers backing the pointer-returning accessors (the
  // reference returns live internal arrays; an embedded runtime copies —
  // buffers stay valid until the next call on the same handle)
  std::map<std::string, std::vector<double>> dbl_bufs;
  std::vector<long long> starts_buf;
  std::vector<int> indices_buf, lengths_buf;
  std::vector<unsigned char> status_buf;
  std::string name_buf, intinfo_buf;
};

// ClpSolve-options analogue (reference: Clp_Solve wrapping ClpSolve)
struct CSolve {
  int method = 4;      // SolveMethod.AUTOMATIC
  int presolve = 0;    // 0 on (ClpSolve::presolveOn), 1 off
  int passes = 5;
  int substitution = 3;
  int do_dual = 1;
  std::map<std::string, int> transforms;  // presolve per-transform toggles
};

PyObject *import_attr(const char *mod, const char *attr) {
  PyObject *m = PyImport_ImportModule(mod);
  if (!m) return nullptr;
  PyObject *a = PyObject_GetAttrString(m, attr);
  Py_DECREF(m);
  return a;
}

bool report_if_error() {
  if (PyErr_Occurred()) {
    PyErr_Print();
    return true;
  }
  return false;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *np_array_1d(const double *data, long long n) {
  // Build a Python list (avoids a NumPy C-API dependency in this shim; the
  // copies happen once per model load, not per iteration).
  PyObject *lst = PyList_New(n);
  for (long long i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(data[i]));
  return lst;
}

PyObject *np_array_1d_or(const double *data, long long n, double dflt) {
  // Like np_array_1d but accepts NULL rim pointers with a fill default
  // (reference: Clp_loadProblem accepts NULL collb/colub/obj/rowlb/rowub,
  // Clp_C_Interface.cpp loadProblem defaults).
  if (data) return np_array_1d(data, n);
  PyObject *lst = PyList_New(n);
  for (long long i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(dflt));
  return lst;
}

int copy_out(PyObject *seq_obj, double *out, int len) {
  if (!seq_obj || seq_obj == Py_None) return -1;
  PyObject *fast = PySequence_Fast(seq_obj, "expected a sequence");
  if (!fast) return -1;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  int count = static_cast<int>(n < len ? n : len);
  for (int i = 0; i < count; ++i) {
    out[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fast, i));
  }
  Py_DECREF(fast);
  return count;
}

#define H(model) static_cast<Handle *>(model)

int solve_with(Handle *h, const char *method) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  if (!r) {
    report_if_error();
    return -1;
  }
  Py_DECREF(r);
  return ClpTpu_status(h);
}

// ---- small attribute helpers (all assume the GIL is NOT held) ----

double get_attr_double(Handle *h, const char *attr, double dflt = 0.0) {
  Gil gil;
  PyObject *r = PyObject_GetAttrString(h->model, attr);
  double v = r ? PyFloat_AsDouble(r) : dflt;
  Py_XDECREF(r);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return dflt;
  }
  return v;
}

void set_attr_double(Handle *h, const char *attr, double v) {
  Gil gil;
  PyObject *o = PyFloat_FromDouble(v);
  PyObject_SetAttrString(h->model, attr, o);
  Py_DECREF(o);
  PyErr_Clear();
}

long get_attr_long(Handle *h, const char *attr, long dflt = 0) {
  Gil gil;
  PyObject *r = PyObject_GetAttrString(h->model, attr);
  long v = r ? PyLong_AsLong(r) : dflt;
  Py_XDECREF(r);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return dflt;
  }
  return v;
}

void set_attr_long(Handle *h, const char *attr, long v) {
  Gil gil;
  PyObject *o = PyLong_FromLong(v);
  PyObject_SetAttrString(h->model, attr, o);
  Py_DECREF(o);
  PyErr_Clear();
}

// call a no-arg method returning a float/int scalar
double call_double(Handle *h, const char *method, double dflt = 0.0) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  if (!r) {
    report_if_error();
    return dflt;
  }
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return dflt;
  }
  return v;
}

long call_long(Handle *h, const char *method, long dflt = 0) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  if (!r) {
    report_if_error();
    return dflt;
  }
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return dflt;
  }
  return v;
}

// fetch a float array (numpy array / list / None) into a vector; returns ok
bool fetch_doubles(PyObject *obj, std::vector<double> &out) {
  if (!obj || obj == Py_None) return false;
  PyObject *lst = PyObject_HasAttrString(obj, "tolist")
                      ? PyObject_CallMethod(obj, "tolist", nullptr)
                      : (Py_INCREF(obj), obj);
  if (!lst) {
    PyErr_Clear();
    return false;
  }
  PyObject *fast = PySequence_Fast(lst, "expected a sequence");
  Py_DECREF(lst);
  if (!fast) {
    PyErr_Clear();
    return false;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  out.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    out[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fast, i));
  Py_DECREF(fast);
  PyErr_Clear();
  return true;
}

// model attribute array -> handle-owned buffer, returns data pointer
double *attr_buffer(Handle *h, const char *attr) {
  Gil gil;
  PyObject *a = PyObject_GetAttrString(h->model, attr);
  auto &buf = h->dbl_bufs[attr];
  if (!fetch_doubles(a, buf)) buf.clear();
  Py_XDECREF(a);
  PyErr_Clear();
  return buf.empty() ? nullptr : buf.data();
}

// solution-method array -> handle-owned buffer
double *method_buffer(Handle *h, const char *method) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  auto &buf = h->dbl_bufs[method];
  if (!fetch_doubles(r, buf)) buf.clear();
  Py_XDECREF(r);
  PyErr_Clear();
  return buf.empty() ? nullptr : buf.data();
}

// write a double array into a model attribute
void set_attr_array(Handle *h, const char *attr, const double *v, long n) {
  if (!v) return;
  Gil gil;
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) {
    report_if_error();
    return;
  }
  PyObject *lst = np_array_1d(v, n);
  PyObject *arr = PyObject_CallMethod(np, "asarray", "O", lst);
  Py_DECREF(np);
  Py_DECREF(lst);
  if (!arr) {
    report_if_error();
    return;
  }
  PyObject_SetAttrString(h->model, attr, arr);
  Py_DECREF(arr);
  PyErr_Clear();
}

PyObject *get_solution(Handle *h) {  // borrowed-model, new-ref solution|NULL
  PyObject *sol = PyObject_GetAttrString(h->model, "solution");
  if (sol == Py_None) {
    Py_DECREF(sol);
    return nullptr;
  }
  PyErr_Clear();
  return sol;
}

}  // namespace

extern "C" {

int ClpTpu_initialize(void) {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      g_we_own_interp = true;
    }
    Gil gil;
    // make sure the repo root is importable when running from a build tree
    PyRun_SimpleString(
        "import sys, os\n"
        "root = os.environ.get('CLPTPU_ROOT')\n"
        "if root and root not in sys.path: sys.path.insert(0, root)\n");
    PyObject *mod = PyImport_ImportModule("clp_tpu_torch");
    if (!mod) {
      PyErr_Print();
      return;
    }
    Py_DECREF(mod);
    g_initialized = true;
  });
  return g_initialized ? 0 : 1;
}

void ClpTpu_finalize(void) {
  // Embedded torch/CUDA runtimes do not tear down cleanly mid-process; keep the
  // interpreter alive for the process lifetime (matches common practice).
}

ClpTpuModel *ClpTpu_newModel(void) {
  if (ClpTpu_initialize() != 0) return nullptr;
  Gil gil;
  PyObject *cls = import_attr("clp_tpu_torch", "Model");
  if (!cls) {
    report_if_error();
    return nullptr;
  }
  PyObject *obj = PyObject_CallObject(cls, nullptr);
  Py_DECREF(cls);
  if (!obj) {
    report_if_error();
    return nullptr;
  }
  Handle *h = new Handle{obj};
  return h;
}

void ClpTpu_deleteModel(ClpTpuModel *model) {
  if (!model) return;
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  Py_XDECREF(h->model);
  delete h;
}

int ClpTpu_loadProblem(ClpTpuModel *model, int numcols, int numrows,
                       const long long *start, const int *index,
                       const double *value, const double *collb,
                       const double *colub, const double *obj,
                       const double *rowlb, const double *rowub) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  long long nnz = start[numcols];
  PyObject *scipy = PyImport_ImportModule("scipy.sparse");
  if (!scipy) {
    report_if_error();
    return 1;
  }
  PyObject *csc = PyObject_GetAttrString(scipy, "csc_matrix");
  Py_DECREF(scipy);

  PyObject *data = np_array_1d(value, nnz);
  PyObject *indices = PyList_New(nnz);
  for (long long i = 0; i < nnz; ++i)
    PyList_SET_ITEM(indices, i, PyLong_FromLong(index[i]));
  PyObject *indptr = PyList_New(numcols + 1);
  for (int j = 0; j <= numcols; ++j)
    PyList_SET_ITEM(indptr, j, PyLong_FromLongLong(start[j]));
  PyObject *triple = PyTuple_Pack(3, data, indices, indptr);
  PyObject *shape = Py_BuildValue("(ii)", numrows, numcols);
  PyObject *args = PyTuple_Pack(1, triple);
  PyObject *kw = Py_BuildValue("{s:O}", "shape", shape);
  PyObject *A = PyObject_Call(csc, args, kw);
  Py_DECREF(csc);
  Py_DECREF(data);
  Py_DECREF(indices);
  Py_DECREF(indptr);
  Py_DECREF(triple);
  Py_DECREF(shape);
  Py_DECREF(args);
  Py_DECREF(kw);
  if (!A) {
    report_if_error();
    return 1;
  }
  // NULL rim pointers take the reference's defaults (Clp_loadProblem):
  // collb=0, colub=+inf, obj=0, rowlb=-inf, rowub=+inf
  PyObject *cl = np_array_1d_or(collb, numcols, 0.0);
  PyObject *cu = np_array_1d_or(colub, numcols, 1e30);
  PyObject *ob = np_array_1d_or(obj, numcols, 0.0);
  PyObject *rl = np_array_1d_or(rowlb, numrows, -1e30);
  PyObject *ru = np_array_1d_or(rowub, numrows, 1e30);
  PyObject *r = PyObject_CallMethod(h->model, "load_problem", "OOOOOO", A, cl,
                                    cu, ob, rl, ru);
  Py_DECREF(A);
  Py_DECREF(cl);
  Py_DECREF(cu);
  Py_DECREF(ob);
  Py_DECREF(rl);
  Py_DECREF(ru);
  if (!r) {
    report_if_error();
    return 1;
  }
  Py_DECREF(r);
  return 0;
}

int ClpTpu_readMps(ClpTpuModel *model, const char *filename) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, "read_mps", "s", filename);
  if (!r) {
    report_if_error();
    return -1;
  }
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  return static_cast<int>(rc);
}

int ClpTpu_writeMps(ClpTpuModel *model, const char *filename) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, "write_mps", "s", filename);
  if (!r) {
    report_if_error();
    return -1;
  }
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  return static_cast<int>(rc);
}

void ClpTpu_setObjSense(ClpTpuModel *model, double sense) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *v = PyFloat_FromDouble(sense);
  PyObject_SetAttrString(h->model, "optimization_direction", v);
  Py_DECREF(v);
}

void ClpTpu_setLogLevel(ClpTpuModel *model, int level) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *v = PyLong_FromLong(level);
  PyObject_SetAttrString(h->model, "log_level", v);
  Py_DECREF(v);
}

int ClpTpu_initialSolve(ClpTpuModel *model) {
  return solve_with(static_cast<Handle *>(model), "initial_solve");
}
int ClpTpu_dual(ClpTpuModel *model) {
  return solve_with(static_cast<Handle *>(model), "dual");
}
int ClpTpu_primal(ClpTpuModel *model) {
  return solve_with(static_cast<Handle *>(model), "primal");
}
int ClpTpu_barrier(ClpTpuModel *model) {
  return solve_with(static_cast<Handle *>(model), "barrier");
}

int ClpTpu_status(ClpTpuModel *model) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *sol = PyObject_GetAttrString(h->model, "solution");
  if (!sol) return 4;
  PyObject *st = PyObject_GetAttrString(sol, "status");
  Py_DECREF(sol);
  if (!st) return 4;
  PyObject *v = PyObject_GetAttrString(st, "value");
  long rc = v ? PyLong_AsLong(v) : PyLong_AsLong(st);
  Py_XDECREF(v);
  Py_DECREF(st);
  PyErr_Clear();
  return static_cast<int>(rc);
}

double ClpTpu_objectiveValue(ClpTpuModel *model) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, "objective_value", nullptr);
  if (!r) {
    report_if_error();
    return 0.0;
  }
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return v;
}

int ClpTpu_numberRows(ClpTpuModel *model) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_GetAttrString(h->model, "num_rows");
  long v = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  return static_cast<int>(v);
}

int ClpTpu_numberColumns(ClpTpuModel *model) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_GetAttrString(h->model, "num_cols");
  long v = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  return static_cast<int>(v);
}

int ClpTpu_numberIterations(ClpTpuModel *model) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *sol = PyObject_GetAttrString(h->model, "solution");
  if (!sol) return -1;
  PyObject *it = PyObject_GetAttrString(sol, "iterations");
  Py_DECREF(sol);
  long v = it ? PyLong_AsLong(it) : -1;
  Py_XDECREF(it);
  return static_cast<int>(v);
}

static int copy_solution_field(ClpTpuModel *model, const char *method,
                               double *out, int len) {
  Handle *h = static_cast<Handle *>(model);
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  if (!r) {
    report_if_error();
    return -1;
  }
  PyObject *lst = PyObject_CallMethod(r, "tolist", nullptr);
  Py_DECREF(r);
  int rc = copy_out(lst ? lst : Py_None, out, len);
  Py_XDECREF(lst);
  PyErr_Clear();
  return rc;
}

int ClpTpu_primalColumnSolution(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "primal_column_solution", out, len);
}
int ClpTpu_dualRowSolution(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "dual_row_solution", out, len);
}
int ClpTpu_reducedCosts(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "dual_column_solution", out, len);
}
int ClpTpu_rowActivity(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "primal_row_solution", out, len);
}
/* reference-name aliases (Clp_dualColumnSolution / Clp_primalRowSolution) */
int ClpTpu_dualColumnSolution(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "dual_column_solution", out, len);
}
int ClpTpu_primalRowSolution(ClpTpuModel *model, double *out, int len) {
  return copy_solution_field(model, "primal_row_solution", out, len);
}

/* --- message callback (Clp_registerCallBack / Clp_clearCallBack) --- */
extern "C" PyObject *clptpu_cb_trampoline(PyObject *self, PyObject *args) {
  Handle *h = static_cast<Handle *>(PyCapsule_GetPointer(self, "ClpTpuHandle"));
  int num = 0;
  const char *text = nullptr;
  if (!PyArg_ParseTuple(args, "is", &num, &text)) return nullptr;
  if (h && h->callback) {
    char *strs[1] = {const_cast<char *>(text)};
    h->callback(static_cast<ClpTpuModel *>(static_cast<void *>(h)), num, 0,
                nullptr, 0, nullptr, 1, strs);
  }
  Py_RETURN_NONE;
}

static PyMethodDef g_cb_def = {"_clptpu_callback", clptpu_cb_trampoline,
                               METH_VARARGS, "C callback trampoline"};

void ClpTpu_registerCallBack(ClpTpuModel *model, clptpu_callback userCallBack) {
  Handle *h = H(model);
  Gil gil;
  h->callback = userCallBack;
  PyObject *capsule = PyCapsule_New(h, "ClpTpuHandle", nullptr);
  PyObject *fn = PyCFunction_New(&g_cb_def, capsule);
  Py_DECREF(capsule);  // fn holds its own reference
  PyObject *handler_cls = import_attr("clp_tpu_torch.events", "CallbackHandler");
  PyObject *handler =
      handler_cls ? PyObject_CallFunctionObjArgs(handler_cls, fn, nullptr)
                  : nullptr;
  if (handler) PyObject_SetAttrString(h->model, "message_handler", handler);
  Py_XDECREF(handler);
  Py_XDECREF(handler_cls);
  Py_XDECREF(fn);
  report_if_error();
}

void ClpTpu_clearCallBack(ClpTpuModel *model) {
  Handle *h = H(model);
  Gil gil;
  h->callback = nullptr;
  PyObject_SetAttrString(h->model, "message_handler", Py_None);
  report_if_error();
}

/* --- quadratic objective (Clp_loadQuadraticObjective) --- */
int ClpTpu_loadQuadraticObjective(ClpTpuModel *model, int numberColumns,
                                  const long long *start, const int *column,
                                  const double *element) {
  Handle *h = H(model);
  Gil gil;
  long long nnz = start[numberColumns];
  PyObject *scipy = PyImport_ImportModule("scipy.sparse");
  if (!scipy) {
    report_if_error();
    return 1;
  }
  PyObject *csc = PyObject_GetAttrString(scipy, "csc_matrix");
  Py_DECREF(scipy);
  PyObject *data = np_array_1d(element, nnz);
  PyObject *indices = PyList_New(nnz);
  for (long long i = 0; i < nnz; ++i)
    PyList_SET_ITEM(indices, i, PyLong_FromLong(column[i]));
  PyObject *indptr = PyList_New(numberColumns + 1);
  for (int j = 0; j <= numberColumns; ++j)
    PyList_SET_ITEM(indptr, j, PyLong_FromLongLong(start[j]));
  PyObject *triple = PyTuple_Pack(3, data, indices, indptr);
  PyObject *shape = Py_BuildValue("(ii)", numberColumns, numberColumns);
  PyObject *args2 = PyTuple_Pack(1, triple);
  PyObject *kw = Py_BuildValue("{s:O}", "shape", shape);
  PyObject *Q = PyObject_Call(csc, args2, kw);
  Py_DECREF(csc);
  Py_DECREF(data);
  Py_DECREF(indices);
  Py_DECREF(indptr);
  Py_DECREF(triple);
  Py_DECREF(shape);
  Py_DECREF(args2);
  Py_DECREF(kw);
  if (!Q) {
    report_if_error();
    return 1;
  }
  PyObject *r = PyObject_CallMethod(h->model, "load_quadratic_objective", "O", Q);
  Py_DECREF(Q);
  if (!r) {
    report_if_error();
    return 1;
  }
  Py_DECREF(r);
  return 0;
}

void ClpTpu_setNumberIterations(ClpTpuModel *model, int n) {
  Gil gil;
  PyObject *sol = PyObject_GetAttrString(H(model)->model, "solution");
  if (sol) {
    PyObject *v = PyLong_FromLong(n);
    PyObject_SetAttrString(sol, "iterations", v);
    Py_DECREF(v);
    Py_DECREF(sol);
  }
  report_if_error();
}

/* ------------------------------------------------------------------ */
/* Full Clp_C_Interface surface (see header)                           */
/* ------------------------------------------------------------------ */

const char *ClpTpu_Version(void) { return "0.1.0"; }
int ClpTpu_VersionMajor(void) { return 0; }
int ClpTpu_VersionMinor(void) { return 1; }
int ClpTpu_VersionRelease(void) { return 0; }


void ClpTpu_resize(ClpTpuModel *model, int nr, int nc) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(model)->model, "resize", "ii", nr, nc);
  Py_XDECREF(r);
  PyErr_Clear();
}

static PyObject *int_list(const int *v, long n) {
  PyObject *lst = PyList_New(n);
  for (long i = 0; i < n; ++i) PyList_SET_ITEM(lst, i, PyLong_FromLong(v[i]));
  return lst;
}

void ClpTpu_deleteRows(ClpTpuModel *model, int number, const int *which) {
  Gil gil;
  PyObject *w = int_list(which, number);
  PyObject *r = PyObject_CallMethod(H(model)->model, "delete_rows", "O", w);
  Py_DECREF(w);
  Py_XDECREF(r);
  PyErr_Clear();
}

void ClpTpu_deleteColumns(ClpTpuModel *model, int number, const int *which) {
  Gil gil;
  PyObject *w = int_list(which, number);
  PyObject *r = PyObject_CallMethod(H(model)->model, "delete_columns", "O", w);
  Py_DECREF(w);
  Py_XDECREF(r);
  PyErr_Clear();
}

static PyObject *make_csr_like(const char *ctor, long n_outer, long n_inner,
                               const long long *starts, const int *idx,
                               const double *elems, bool row_major) {
  // build scipy csr (row_major) or csc matrix of shape derived by caller
  PyObject *scipy = PyImport_ImportModule("scipy.sparse");
  if (!scipy) return nullptr;
  PyObject *cls = PyObject_GetAttrString(scipy, ctor);
  Py_DECREF(scipy);
  long long nnz = (starts && idx && elems) ? starts[n_outer] : 0;
  PyObject *data = np_array_1d(elems, nnz);
  PyObject *indices = PyList_New(nnz);
  for (long long i = 0; i < nnz; ++i)
    PyList_SET_ITEM(indices, i, PyLong_FromLong(idx[i]));
  PyObject *indptr = PyList_New(n_outer + 1);
  for (long j = 0; j <= n_outer; ++j)
    PyList_SET_ITEM(indptr, j, PyLong_FromLongLong(starts ? starts[j] : 0));
  PyObject *triple = PyTuple_Pack(3, data, indices, indptr);
  PyObject *shape = row_major ? Py_BuildValue("(ll)", n_outer, n_inner)
                              : Py_BuildValue("(ll)", n_inner, n_outer);
  PyObject *args = PyTuple_Pack(1, triple);
  PyObject *kw = Py_BuildValue("{s:O}", "shape", shape);
  PyObject *A = PyObject_Call(cls, args, kw);
  Py_DECREF(cls);
  Py_DECREF(data);
  Py_DECREF(indices);
  Py_DECREF(indptr);
  Py_DECREF(triple);
  Py_DECREF(shape);
  Py_DECREF(args);
  Py_DECREF(kw);
  return A;
}

void ClpTpu_addRows(ClpTpuModel *model, int number, const double *rowLower,
                    const double *rowUpper, const long long *rowStarts,
                    const int *columns, const double *elements) {
  Handle *h = H(model);
  int ncols = ClpTpu_numberColumns(model);
  Gil gil;
  PyObject *A = make_csr_like("csr_matrix", number, ncols, rowStarts, columns,
                              elements, true);
  if (!A) {
    report_if_error();
    return;
  }
  PyObject *lo = np_array_1d_or(rowLower, number, -1e30);
  PyObject *up = np_array_1d_or(rowUpper, number, 1e30);
  PyObject *r = PyObject_CallMethod(h->model, "add_rows", "OOO", A, lo, up);
  Py_DECREF(A);
  Py_DECREF(lo);
  Py_DECREF(up);
  Py_XDECREF(r);
  if (PyErr_Occurred()) PyErr_Print();
}

void ClpTpu_addColumns(ClpTpuModel *model, int number, const double *columnLower,
                       const double *columnUpper, const double *objective,
                       const long long *columnStarts, const int *rows,
                       const double *elements) {
  Handle *h = H(model);
  int nrows = ClpTpu_numberRows(model);
  Gil gil;
  PyObject *A = make_csr_like("csc_matrix", number, nrows, columnStarts, rows,
                              elements, false);
  if (!A) {
    report_if_error();
    return;
  }
  PyObject *lo = np_array_1d_or(columnLower, number, 0.0);
  PyObject *up = np_array_1d_or(columnUpper, number, 1e30);
  PyObject *ob = np_array_1d_or(objective, number, 0.0);
  PyObject *r =
      PyObject_CallMethod(h->model, "add_columns", "OOOO", A, lo, up, ob);
  Py_DECREF(A);
  Py_DECREF(lo);
  Py_DECREF(up);
  Py_DECREF(ob);
  Py_XDECREF(r);
  if (PyErr_Occurred()) PyErr_Print();
}

void ClpTpu_chgRowLower(ClpTpuModel *model, const double *v) {
  set_attr_array(H(model), "row_lower", v, ClpTpu_numberRows(model));
}
void ClpTpu_chgRowUpper(ClpTpuModel *model, const double *v) {
  set_attr_array(H(model), "row_upper", v, ClpTpu_numberRows(model));
}
void ClpTpu_chgColumnLower(ClpTpuModel *model, const double *v) {
  set_attr_array(H(model), "col_lower", v, ClpTpu_numberColumns(model));
}
void ClpTpu_chgColumnUpper(ClpTpuModel *model, const double *v) {
  set_attr_array(H(model), "col_upper", v, ClpTpu_numberColumns(model));
}
void ClpTpu_chgObjCoefficients(ClpTpuModel *model, const double *v) {
  set_attr_array(H(model), "objective", v, ClpTpu_numberColumns(model));
}

void ClpTpu_modifyCoefficient(ClpTpuModel *model, int row, int column,
                              double newElement, int keepZero) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(model)->model, "modify_coefficient",
                                    "iidi", row, column, newElement, keepZero);
  Py_XDECREF(r);
  PyErr_Clear();
}

void ClpTpu_copyInIntegerInformation(ClpTpuModel *model, const char *info) {
  Handle *h = H(model);
  int n = ClpTpu_numberColumns(model);
  Gil gil;
  for (int j = 0; j < n; ++j) {
    if (info && info[j]) {
      PyObject *r = PyObject_CallMethod(h->model, "set_integer", "i", j);
      Py_XDECREF(r);
    }
  }
  PyErr_Clear();
}

void ClpTpu_deleteIntegerInformation(ClpTpuModel *model) {
  Gil gil;
  PyObject_SetAttrString(H(model)->model, "integer_mask", Py_None);
  PyErr_Clear();
}

char *ClpTpu_integerInformation(ClpTpuModel *model) {
  Handle *h = H(model);
  int n = ClpTpu_numberColumns(model);
  Gil gil;
  PyObject *mask = PyObject_GetAttrString(h->model, "integer_mask");
  if (!mask || mask == Py_None) {
    Py_XDECREF(mask);
    PyErr_Clear();
    return nullptr;
  }
  h->intinfo_buf.assign(n, 0);
  PyObject *lst = PyObject_CallMethod(mask, "tolist", nullptr);
  Py_DECREF(mask);
  if (lst) {
    for (int j = 0; j < n && j < PyList_GET_SIZE(lst); ++j)
      h->intinfo_buf[j] = PyObject_IsTrue(PyList_GET_ITEM(lst, j)) ? 1 : 0;
    Py_DECREF(lst);
  }
  PyErr_Clear();
  return h->intinfo_buf.data();
}

/* ---- names ---- */

void ClpTpu_dropNames(ClpTpuModel *model) {
  Gil gil;
  PyObject_SetAttrString(H(model)->model, "row_names", Py_None);
  PyObject_SetAttrString(H(model)->model, "col_names", Py_None);
  PyErr_Clear();
}

void ClpTpu_copyNames(ClpTpuModel *model, const char *const *rowNames,
                      const char *const *columnNames) {
  Handle *h = H(model);
  int m = ClpTpu_numberRows(model), n = ClpTpu_numberColumns(model);
  Gil gil;
  if (rowNames) {
    PyObject *lst = PyList_New(m);
    for (int i = 0; i < m; ++i)
      PyList_SET_ITEM(lst, i, PyUnicode_FromString(rowNames[i]));
    PyObject_SetAttrString(h->model, "row_names", lst);
    Py_DECREF(lst);
  }
  if (columnNames) {
    PyObject *lst = PyList_New(n);
    for (int j = 0; j < n; ++j)
      PyList_SET_ITEM(lst, j, PyUnicode_FromString(columnNames[j]));
    PyObject_SetAttrString(h->model, "col_names", lst);
    Py_DECREF(lst);
  }
  PyErr_Clear();
}

int ClpTpu_lengthNames(ClpTpuModel *model) {
  Handle *h = H(model);
  Gil gil;
  size_t best = 0;
  for (const char *attr : {"row_names", "col_names"}) {
    PyObject *names = PyObject_GetAttrString(h->model, attr);
    if (names && names != Py_None && PyList_Check(names)) {
      for (Py_ssize_t i = 0; i < PyList_GET_SIZE(names); ++i) {
        Py_ssize_t ln = 0;
        const char *s =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(names, i), &ln);
        if (s && (size_t)ln > best) best = ln;
      }
    }
    Py_XDECREF(names);
  }
  PyErr_Clear();
  return (int)best;
}

static void copy_name(Handle *h, const char *attr, int i, char *out) {
  Gil gil;
  out[0] = '\0';
  PyObject *names = PyObject_GetAttrString(h->model, attr);
  if (names && names != Py_None && PyList_Check(names) && i >= 0 &&
      i < PyList_GET_SIZE(names)) {
    const char *s = PyUnicode_AsUTF8(PyList_GET_ITEM(names, i));
    if (s) strcpy(out, s);
  }
  Py_XDECREF(names);
  PyErr_Clear();
}

void ClpTpu_rowName(ClpTpuModel *model, int iRow, char *name) {
  copy_name(H(model), "row_names", iRow, name);
}
void ClpTpu_columnName(ClpTpuModel *model, int iColumn, char *name) {
  copy_name(H(model), "col_names", iColumn, name);
}

static void set_name(Handle *h, const char *attr, int count, int i,
                     const char *name) {
  Gil gil;
  PyObject *names = PyObject_GetAttrString(h->model, attr);
  if (!names || names == Py_None || !PyList_Check(names)) {
    Py_XDECREF(names);
    names = PyList_New(count);
    for (int k = 0; k < count; ++k)
      PyList_SET_ITEM(names, k, PyUnicode_FromFormat("%d", k));
    PyObject_SetAttrString(h->model, attr, names);
  }
  if (i >= 0 && i < PyList_GET_SIZE(names))
    PyList_SetItem(names, i, PyUnicode_FromString(name));
  Py_DECREF(names);
  PyErr_Clear();
}

void ClpTpu_setRowName(ClpTpuModel *model, int iRow, const char *name) {
  set_name(H(model), "row_names", ClpTpu_numberRows(model), iRow, name);
}
void ClpTpu_setColumnName(ClpTpuModel *model, int iColumn, const char *name) {
  set_name(H(model), "col_names", ClpTpu_numberColumns(model), iColumn, name);
}

void ClpTpu_problemName(ClpTpuModel *model, int maxNumberCharacters,
                        char *array) {
  Handle *h = H(model);
  Gil gil;
  array[0] = '\0';
  PyObject *nm = PyObject_GetAttrString(h->model, "problem_name");
  if (nm && nm != Py_None) {
    const char *s = PyUnicode_AsUTF8(nm);
    if (s) {
      strncpy(array, s, maxNumberCharacters - 1);
      array[maxNumberCharacters - 1] = '\0';
    }
  }
  Py_XDECREF(nm);
  PyErr_Clear();
}

int ClpTpu_setProblemName(ClpTpuModel *model, int, const char *array) {
  Gil gil;
  PyObject *s = PyUnicode_FromString(array);
  PyObject_SetAttrString(H(model)->model, "problem_name", s);
  Py_DECREF(s);
  PyErr_Clear();
  return 0;
}

/* ---- parameters ---- */

double ClpTpu_primalTolerance(ClpTpuModel *m) { return get_attr_double(H(m), "primal_tolerance", 1e-7); }
void ClpTpu_setPrimalTolerance(ClpTpuModel *m, double v) { set_attr_double(H(m), "primal_tolerance", v); }
double ClpTpu_dualTolerance(ClpTpuModel *m) { return get_attr_double(H(m), "dual_tolerance", 1e-7); }
void ClpTpu_setDualTolerance(ClpTpuModel *m, double v) { set_attr_double(H(m), "dual_tolerance", v); }
double ClpTpu_dualObjectiveLimit(ClpTpuModel *m) { return get_attr_double(H(m), "dual_objective_limit", 1e30); }
void ClpTpu_setDualObjectiveLimit(ClpTpuModel *m, double v) { set_attr_double(H(m), "dual_objective_limit", v); }
double ClpTpu_objectiveOffset(ClpTpuModel *m) { return get_attr_double(H(m), "objective_offset", 0.0); }
void ClpTpu_setObjectiveOffset(ClpTpuModel *m, double v) { set_attr_double(H(m), "objective_offset", v); }
int ClpTpu_maximumIterations(ClpTpuModel *m) { return (int)get_attr_long(H(m), "maximum_iterations", 2147483647); }
void ClpTpu_setMaximumIterations(ClpTpuModel *m, int v) { set_attr_long(H(m), "maximum_iterations", v); }
double ClpTpu_maximumSeconds(ClpTpuModel *m) { return get_attr_double(H(m), "maximum_seconds", -1.0); }
void ClpTpu_setMaximumSeconds(ClpTpuModel *m, double v) { set_attr_double(H(m), "maximum_seconds", v); }
int ClpTpu_hitMaximumIterations(ClpTpuModel *m) { return ClpTpu_status(m) == 3 ? 1 : 0; }
double ClpTpu_optimizationDirection(ClpTpuModel *m) { return get_attr_double(H(m), "optimization_direction", 1.0); }
void ClpTpu_setOptimizationDirection(ClpTpuModel *m, double v) { set_attr_double(H(m), "optimization_direction", v); }
double ClpTpu_getObjSense(ClpTpuModel *m) { return ClpTpu_optimizationDirection(m); }
double ClpTpu_dualBound(ClpTpuModel *m) { return get_attr_double(H(m), "dual_bound", 1e10); }
void ClpTpu_setDualBound(ClpTpuModel *m, double v) { set_attr_double(H(m), "dual_bound", v); }
double ClpTpu_infeasibilityCost(ClpTpuModel *m) { return get_attr_double(H(m), "infeasibility_cost", 1e10); }
void ClpTpu_setInfeasibilityCost(ClpTpuModel *m, double v) { set_attr_double(H(m), "infeasibility_cost", v); }
int ClpTpu_perturbation(ClpTpuModel *m) { return (int)get_attr_long(H(m), "perturbation", 100); }
void ClpTpu_setPerturbation(ClpTpuModel *m, int v) { set_attr_long(H(m), "perturbation", v); }
int ClpTpu_algorithm(ClpTpuModel *m) { return (int)get_attr_long(H(m), "algorithm", 0); }
void ClpTpu_setAlgorithm(ClpTpuModel *m, int v) { set_attr_long(H(m), "algorithm", v); }
int ClpTpu_logLevel(ClpTpuModel *m) { return (int)get_attr_long(H(m), "log_level", 1); }
double ClpTpu_getSmallElementValue(ClpTpuModel *m) { return get_attr_double(H(m), "small_element_value", 1e-20); }
void ClpTpu_setSmallElementValue(ClpTpuModel *m, double v) { set_attr_double(H(m), "small_element_value", v); }
void ClpTpu_setRandomSeed(ClpTpuModel *m, int v) { set_attr_long(H(m), "random_seed", v); }
void ClpTpu_scaling(ClpTpuModel *m, int mode) { set_attr_long(H(m), "scaling_mode", mode); }
int ClpTpu_scalingFlag(ClpTpuModel *m) { return (int)get_attr_long(H(m), "scaling_mode", 3); }

/* ---- matrix / rim queries ---- */

static bool refresh_matrix(Handle *h) {
  Gil gil;
  PyObject *A = PyObject_GetAttrString(h->model, "matrix");
  if (!A) {
    PyErr_Clear();
    return false;
  }
  PyObject *indptr = PyObject_GetAttrString(A, "indptr");
  PyObject *indices = PyObject_GetAttrString(A, "indices");
  PyObject *data = PyObject_GetAttrString(A, "data");
  Py_DECREF(A);
  std::vector<double> tmp;
  bool ok = indptr && indices && data;
  if (ok && fetch_doubles(indptr, tmp)) {
    h->starts_buf.assign(tmp.begin(), tmp.end());
  } else {
    ok = false;
  }
  if (ok && fetch_doubles(indices, tmp)) {
    h->indices_buf.assign(tmp.begin(), tmp.end());
  } else {
    ok = false;
  }
  if (ok) ok = fetch_doubles(data, h->dbl_bufs["elements"]);
  h->lengths_buf.clear();
  for (size_t j = 0; ok && j + 1 < h->starts_buf.size(); ++j)
    h->lengths_buf.push_back((int)(h->starts_buf[j + 1] - h->starts_buf[j]));
  Py_XDECREF(indptr);
  Py_XDECREF(indices);
  Py_XDECREF(data);
  PyErr_Clear();
  return ok;
}

long long ClpTpu_getNumElements(ClpTpuModel *m) {
  return (long long)get_attr_long(H(m), "num_elements", 0);
}
const long long *ClpTpu_getVectorStarts(ClpTpuModel *m) {
  Handle *h = H(m);
  return refresh_matrix(h) ? h->starts_buf.data() : nullptr;
}
const int *ClpTpu_getIndices(ClpTpuModel *m) {
  Handle *h = H(m);
  return refresh_matrix(h) ? h->indices_buf.data() : nullptr;
}
const int *ClpTpu_getVectorLengths(ClpTpuModel *m) {
  Handle *h = H(m);
  return refresh_matrix(h) ? h->lengths_buf.data() : nullptr;
}
const double *ClpTpu_getElements(ClpTpuModel *m) {
  Handle *h = H(m);
  return refresh_matrix(h) ? h->dbl_bufs["elements"].data() : nullptr;
}

double *ClpTpu_rowLower(ClpTpuModel *m) { return attr_buffer(H(m), "row_lower"); }
double *ClpTpu_rowUpper(ClpTpuModel *m) { return attr_buffer(H(m), "row_upper"); }
double *ClpTpu_objective(ClpTpuModel *m) { return attr_buffer(H(m), "objective"); }
double *ClpTpu_columnLower(ClpTpuModel *m) { return attr_buffer(H(m), "col_lower"); }
double *ClpTpu_columnUpper(ClpTpuModel *m) { return attr_buffer(H(m), "col_upper"); }
const double *ClpTpu_getRowLower(ClpTpuModel *m) { return ClpTpu_rowLower(m); }
const double *ClpTpu_getRowUpper(ClpTpuModel *m) { return ClpTpu_rowUpper(m); }
const double *ClpTpu_getObjCoefficients(ClpTpuModel *m) { return ClpTpu_objective(m); }
const double *ClpTpu_getColLower(ClpTpuModel *m) { return ClpTpu_columnLower(m); }
const double *ClpTpu_getColUpper(ClpTpuModel *m) { return ClpTpu_columnUpper(m); }
int ClpTpu_getNumRows(ClpTpuModel *m) { return ClpTpu_numberRows(m); }
int ClpTpu_getNumCols(ClpTpuModel *m) { return ClpTpu_numberColumns(m); }

/* ---- solves ---- */

int ClpTpu_initialDualSolve(ClpTpuModel *m) { return solve_with(H(m), "dual"); }
int ClpTpu_initialPrimalSolve(ClpTpuModel *m) { return solve_with(H(m), "primal"); }
int ClpTpu_initialBarrierSolve(ClpTpuModel *m) { return solve_with(H(m), "barrier"); }
int ClpTpu_initialBarrierNoCrossSolve(ClpTpuModel *m) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(m)->model, "barrier", "i", 0);
  Py_XDECREF(r);
  if (PyErr_Occurred()) PyErr_Print();
  return ClpTpu_status(m);
}
// ifValuesPass != 0 starts the simplex from the current solution values
// (reference: Clp_dual/Clp_primal second argument -> ClpSimplex::dual(1))
static int solve_with_values(Handle *h, const char *method, int ifValuesPass) {
  if (!ifValuesPass) return solve_with(h, method);
  Gil gil;
  PyObject *fn = PyObject_GetAttrString(h->model, method);
  if (!fn) {
    report_if_error();
    return -1;
  }
  PyObject *args = PyTuple_New(0);
  PyObject *kw = Py_BuildValue("{s:i}", "values_pass", ifValuesPass);
  PyObject *r = (args && kw) ? PyObject_Call(fn, args, kw) : nullptr;
  Py_DECREF(fn);
  Py_XDECREF(args);
  Py_XDECREF(kw);
  if (!r) {
    report_if_error();
    return -1;
  }
  Py_DECREF(r);
  return ClpTpu_status(h);
}
int ClpTpu_dualWithValuesPass(ClpTpuModel *m, int v) {
  return solve_with_values(H(m), "dual", v);
}
int ClpTpu_primalWithValuesPass(ClpTpuModel *m, int v) {
  return solve_with_values(H(m), "primal", v);
}

void ClpTpu_idiot(ClpTpuModel *m, int tryhard) {
  // run the idiot crash and leave the point on the model so the next
  // values-pass solve starts from it. Clp_idiot encodes its argument as
  // (passes << 3) | lightweight-mode (ClpMain's -idiotCrash plumbing),
  // so reference-conditioned values above 7 are decoded the same way
  // here; small raw values are taken as pass counts directly.
  int passes = tryhard > 7 ? (tryhard >> 3) : tryhard;
  Gil gil;
  PyObject *mod = PyImport_ImportModule("clp_tpu_torch.crash");
  if (!mod) {
    PyErr_Clear();
    return;
  }
  PyObject *fn = PyObject_GetAttrString(mod, "apply_idiot_crash");
  Py_DECREF(mod);
  if (fn) {
    PyObject *r =
        PyObject_CallFunction(fn, "Oi", H(m)->model, passes > 0 ? passes : 50);
    if (!r) PyErr_Clear();
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyErr_Clear();
}

int ClpTpu_crash(ClpTpuModel *m, double, int pivot) {
  // Clp_crash: `pivot` selects the PIVOTING strategy in the reference,
  // not the algorithm — every value builds a crash basis. Here all
  // values build the structural triangular basis and load it as the
  // pending warm start (ClpSimplex::crash role); the idiot descent
  // stays behind ClpTpu_idiot, matching the reference split.
  (void)pivot;
  Gil gil;
  PyObject *mod = PyImport_ImportModule("clp_tpu_torch.crash");
  if (!mod) {
    PyErr_Clear();
    return -1;
  }
  PyObject *fn = PyObject_GetAttrString(mod, "apply_triangular_crash");
  Py_DECREF(mod);
  if (!fn) {
    PyErr_Clear();
    return -1;
  }
  PyObject *r = PyObject_CallFunction(fn, "O", H(m)->model);
  if (!r) PyErr_Clear();
  Py_XDECREF(r);
  Py_DECREF(fn);
  return 0;
}

/* ---- status / feasibility queries ---- */

static long solution_long(Handle *h, const char *attr, long dflt) {
  Gil gil;
  PyObject *sol = get_solution(h);
  if (!sol) return dflt;
  PyObject *v = PyObject_GetAttrString(sol, attr);
  Py_DECREF(sol);
  if (!v) {
    PyErr_Clear();
    return dflt;
  }
  PyObject *iv = PyNumber_Long(v);
  Py_DECREF(v);
  long out = iv ? PyLong_AsLong(iv) : dflt;
  Py_XDECREF(iv);
  PyErr_Clear();
  return out;
}

int ClpTpu_secondaryStatus(ClpTpuModel *m) { return (int)solution_long(H(m), "secondary_status", 0); }
void ClpTpu_setProblemStatus(ClpTpuModel *, int) { /* statuses are solve results here */ }
void ClpTpu_setSecondaryStatus(ClpTpuModel *, int) { /* statuses are solve results here */ }
int ClpTpu_getIterationCount(ClpTpuModel *m) { return ClpTpu_numberIterations(m); }
int ClpTpu_isAbandoned(ClpTpuModel *m) { return ClpTpu_status(m) == 4 ? 1 : 0; }
int ClpTpu_isProvenOptimal(ClpTpuModel *m) { return ClpTpu_status(m) == 0 ? 1 : 0; }
int ClpTpu_isProvenPrimalInfeasible(ClpTpuModel *m) { return ClpTpu_status(m) == 1 ? 1 : 0; }
int ClpTpu_isProvenDualInfeasible(ClpTpuModel *m) { return ClpTpu_status(m) == 2 ? 1 : 0; }
int ClpTpu_isPrimalObjectiveLimitReached(ClpTpuModel *m) {
  return ClpTpu_secondaryStatus(m) == 3 ? 1 : 0;
}
int ClpTpu_isDualObjectiveLimitReached(ClpTpuModel *m) {
  return ClpTpu_secondaryStatus(m) == 1 ? 1 : 0;
}
int ClpTpu_isIterationLimitReached(ClpTpuModel *m) { return ClpTpu_status(m) == 3 ? 1 : 0; }
int ClpTpu_primalFeasible(ClpTpuModel *m) { return (int)call_long(H(m), "primal_feasible", 0); }
int ClpTpu_dualFeasible(ClpTpuModel *m) { return (int)call_long(H(m), "dual_feasible", 0); }
double ClpTpu_getObjValue(ClpTpuModel *m) { return ClpTpu_objectiveValue(m); }
const double *ClpTpu_getRowActivity(ClpTpuModel *m) { return method_buffer(H(m), "primal_row_solution"); }
const double *ClpTpu_getColSolution(ClpTpuModel *m) { return method_buffer(H(m), "primal_column_solution"); }
const double *ClpTpu_getRowPrice(ClpTpuModel *m) { return method_buffer(H(m), "dual_row_solution"); }
const double *ClpTpu_getReducedCost(ClpTpuModel *m) { return method_buffer(H(m), "dual_column_solution"); }
double ClpTpu_sumDualInfeasibilities(ClpTpuModel *m) { return call_double(H(m), "sum_dual_infeasibilities", 0.0); }
int ClpTpu_numberDualInfeasibilities(ClpTpuModel *m) { return (int)call_long(H(m), "number_dual_infeasibilities", 0); }
double ClpTpu_sumPrimalInfeasibilities(ClpTpuModel *m) { return call_double(H(m), "sum_primal_infeasibilities", 0.0); }
int ClpTpu_numberPrimalInfeasibilities(ClpTpuModel *m) { return (int)call_long(H(m), "number_primal_infeasibilities", 0); }
void ClpTpu_checkSolution(ClpTpuModel *m) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(m)->model, "check_solution", nullptr);
  Py_XDECREF(r);
  PyErr_Clear();
}

void ClpTpu_setColSolution(ClpTpuModel *m, const double *input) {
  // values-pass starting point: install as the current solution's primal
  Handle *h = H(m);
  int n = ClpTpu_numberColumns(m);
  Gil gil;
  PyObject *lst = np_array_1d(input, n);
  PyObject *mod = PyImport_ImportModule("clp_tpu_torch.model");
  if (mod) {
    PyObject *cls = PyObject_GetAttrString(mod, "Solution");
    Py_DECREF(mod);
    if (cls) {
      PyObject *kw = Py_BuildValue("{s:O}", "primal", lst);
      PyObject *args = PyTuple_New(0);
      PyObject *sol = PyObject_Call(cls, args, kw);
      Py_DECREF(cls);
      Py_DECREF(kw);
      Py_DECREF(args);
      if (sol) {
        PyObject_SetAttrString(h->model, "solution", sol);
        Py_DECREF(sol);
      }
    }
  }
  Py_DECREF(lst);
  PyErr_Clear();
  ClpTpu_checkSolution(m);
}

/* ---- rays ---- */

static double *ray_out(Handle *h, const char *method, int len) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(h->model, method, nullptr);
  std::vector<double> tmp;
  if (!fetch_doubles(r, tmp)) {
    Py_XDECREF(r);
    PyErr_Clear();
    return nullptr;
  }
  Py_XDECREF(r);
  double *out = (double *)malloc(sizeof(double) * tmp.size());
  memcpy(out, tmp.data(), sizeof(double) * tmp.size());
  (void)len;
  return out;
}

double *ClpTpu_infeasibilityRay(ClpTpuModel *m) {
  return ray_out(H(m), "infeasibility_ray", ClpTpu_numberRows(m));
}
double *ClpTpu_unboundedRay(ClpTpuModel *m) {
  return ray_out(H(m), "unbounded_ray", ClpTpu_numberColumns(m));
}
void ClpTpu_freeRay(ClpTpuModel *, double *ray) { free(ray); }

/* ---- basis status ---- */

static PyObject *status_pair(Handle *h) {  // new ref (cstat, rstat) or NULL
  PyObject *r = PyObject_CallMethod(h->model, "get_basis_status", nullptr);
  if (!r || r == Py_None) {
    Py_XDECREF(r);
    PyErr_Clear();
    return nullptr;
  }
  return r;
}

int ClpTpu_statusExists(ClpTpuModel *m) {
  Gil gil;
  PyObject *p = status_pair(H(m));
  if (!p) return 0;
  int ok = PyTuple_Check(p) && PyTuple_GET_ITEM(p, 0) != Py_None;
  Py_DECREF(p);
  return ok;
}

unsigned char *ClpTpu_statusArray(ClpTpuModel *m) {
  Handle *h = H(m);
  int n = ClpTpu_numberColumns(m), mr = ClpTpu_numberRows(m);
  Gil gil;
  PyObject *p = status_pair(h);
  if (!p) return nullptr;
  std::vector<double> cs, rs;
  bool ok = PyTuple_Check(p) && fetch_doubles(PyTuple_GET_ITEM(p, 0), cs) &&
            fetch_doubles(PyTuple_GET_ITEM(p, 1), rs);
  Py_DECREF(p);
  if (!ok) return nullptr;
  h->status_buf.resize(n + mr);
  for (int j = 0; j < n && j < (int)cs.size(); ++j)
    h->status_buf[j] = (unsigned char)cs[j];
  for (int i = 0; i < mr && i < (int)rs.size(); ++i)
    h->status_buf[n + i] = (unsigned char)rs[i];
  return h->status_buf.data();
}

void ClpTpu_copyinStatus(ClpTpuModel *m, const unsigned char *statusArray) {
  Handle *h = H(m);
  int n = ClpTpu_numberColumns(m), mr = ClpTpu_numberRows(m);
  Gil gil;
  PyObject *cs = PyList_New(n);
  for (int j = 0; j < n; ++j)
    PyList_SET_ITEM(cs, j, PyLong_FromLong(statusArray[j]));
  PyObject *rs = PyList_New(mr);
  for (int i = 0; i < mr; ++i)
    PyList_SET_ITEM(rs, i, PyLong_FromLong(statusArray[n + i]));
  PyObject *r =
      PyObject_CallMethod(h->model, "set_basis_status", "OO", cs, rs);
  Py_DECREF(cs);
  Py_DECREF(rs);
  Py_XDECREF(r);
  PyErr_Clear();
}

static int one_status(Handle *h, int which, int seq) {
  Gil gil;
  PyObject *p = status_pair(h);
  if (!p) return 1;  // basic default
  std::vector<double> v;
  int out = 1;
  if (PyTuple_Check(p) && fetch_doubles(PyTuple_GET_ITEM(p, which), v) &&
      seq >= 0 && seq < (int)v.size())
    out = (int)v[seq];
  Py_DECREF(p);
  return out;
}

int ClpTpu_getColumnStatus(ClpTpuModel *m, int seq) { return one_status(H(m), 0, seq); }
int ClpTpu_getRowStatus(ClpTpuModel *m, int seq) { return one_status(H(m), 1, seq); }

static void set_one_status(ClpTpuModel *m, int which, int seq, int value) {
  unsigned char *arr = ClpTpu_statusArray(m);
  int n = ClpTpu_numberColumns(m), mr = ClpTpu_numberRows(m);
  Handle *h = H(m);
  if (!arr) {
    h->status_buf.assign(n + mr, 3);
    for (int i = 0; i < mr; ++i) h->status_buf[n + i] = 1;
    arr = h->status_buf.data();
  }
  int idx = which == 0 ? seq : n + seq;
  if (idx >= 0 && idx < (int)h->status_buf.size()) arr[idx] = (unsigned char)value;
  ClpTpu_copyinStatus(m, arr);
}

void ClpTpu_setColumnStatus(ClpTpuModel *m, int seq, int value) { set_one_status(m, 0, seq, value); }
void ClpTpu_setRowStatus(ClpTpuModel *m, int seq, int value) { set_one_status(m, 1, seq, value); }

/* ---- user pointer / save-restore / print ---- */

void ClpTpu_setUserPointer(ClpTpuModel *m, void *pointer) { H(m)->user_pointer = pointer; }
void *ClpTpu_getUserPointer(ClpTpuModel *m) { return H(m)->user_pointer; }

int ClpTpu_saveModel(ClpTpuModel *m, const char *fileName) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(m)->model, "save_model", "s", fileName);
  long rc = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  PyErr_Clear();
  return (int)rc;
}

int ClpTpu_restoreModel(ClpTpuModel *m, const char *fileName) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(H(m)->model, "restore_model", "s", fileName);
  long rc = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  PyErr_Clear();
  return (int)rc;
}

void ClpTpu_printModel(ClpTpuModel *m, const char *prefix) {
  Gil gil;
  PyObject *r = PyObject_Repr(H(m)->model);
  if (r) {
    printf("%s %s\n", prefix ? prefix : "", PyUnicode_AsUTF8(r));
    Py_DECREF(r);
  }
  PyErr_Clear();
}

/* ---- ClpSolve options object ---- */

ClpTpuSolve *ClpTpuSolve_new(void) { return new CSolve(); }
void ClpTpuSolve_delete(ClpTpuSolve *s) { delete static_cast<CSolve *>(s); }

#define CS(s) static_cast<CSolve *>(s)

void ClpTpuSolve_setSolveType(ClpTpuSolve *s, int method, int) { CS(s)->method = method; }
int ClpTpuSolve_getSolveType(ClpTpuSolve *s) { return CS(s)->method; }
void ClpTpuSolve_setPresolveType(ClpTpuSolve *s, int amount, int) { CS(s)->presolve = amount; }
int ClpTpuSolve_getPresolveType(ClpTpuSolve *s) { return CS(s)->presolve; }
int ClpTpuSolve_getPresolvePasses(ClpTpuSolve *s) { return CS(s)->passes; }
void ClpTpuSolve_setSubstitution(ClpTpuSolve *s, int v) { CS(s)->substitution = v; }
int ClpTpuSolve_substitution(ClpTpuSolve *s) { return CS(s)->substitution; }
void ClpTpuSolve_setDoDual(ClpTpuSolve *s, int v) { CS(s)->do_dual = v; }
int ClpTpuSolve_doDual(ClpTpuSolve *s) { return CS(s)->do_dual; }

#define CS_FLAG(NAME, KEY)                                              \
  void ClpTpuSolve_setDo##NAME(ClpTpuSolve *s, int v) {                 \
    CS(s)->transforms[KEY] = v;                                         \
  }                                                                     \
  int ClpTpuSolve_do##NAME(ClpTpuSolve *s) {                            \
    auto it = CS(s)->transforms.find(KEY);                              \
    return it == CS(s)->transforms.end() ? 1 : it->second;              \
  }

CS_FLAG(Singleton, "singleton_rows")
CS_FLAG(Doubleton, "doubleton")
CS_FLAG(Tripleton, "tripleton")
CS_FLAG(Forcing, "forcing")
CS_FLAG(ImpliedFree, "implied_free")
CS_FLAG(Dupcol, "duplicate_cols")
CS_FLAG(Duprow, "duplicate_rows")
CS_FLAG(SingletonColumn, "singleton_cols")
#undef CS_FLAG

int ClpTpu_initialSolveWithOptions(ClpTpuModel *m, ClpTpuSolve *s) {
  Handle *h = H(m);
  CSolve *cs = CS(s);
  Gil gil;
  PyObject *mod = PyImport_ImportModule("clp_tpu_torch");
  if (!mod) {
    report_if_error();
    return -1;
  }
  PyObject *opts_cls = PyObject_GetAttrString(mod, "SolveOptions");
  Py_DECREF(mod);
  if (!opts_cls) {
    report_if_error();
    return -1;
  }
  PyObject *opts = PyObject_CallObject(opts_cls, nullptr);
  Py_DECREF(opts_cls);
  if (!opts) {
    report_if_error();
    return -1;
  }
  // method: ClpSolve SolveType codes map onto SolveMethod where they exist
  // (0 dual, 1 primal, 2 sprint, 3 barrier, 4 barrierNoCross, 5 automatic)
  int method_map[] = {0, 1, 6, 2, 3, 4};
  int mcode = (cs->method >= 0 && cs->method <= 5) ? method_map[cs->method] : 4;
  PyObject *mv = PyLong_FromLong(mcode);
  PyObject_SetAttrString(opts, "method", mv);
  Py_DECREF(mv);
  PyObject *pres = PyObject_GetAttrString(opts, "presolve");
  if (pres) {
    PyObject *en = PyBool_FromLong(cs->presolve == 0 ? 1 : 0);
    PyObject_SetAttrString(pres, "enabled", en);
    Py_DECREF(en);
    PyObject *pp = PyLong_FromLong(cs->passes);
    PyObject_SetAttrString(pres, "passes", pp);
    Py_DECREF(pp);
    for (auto &kv : cs->transforms) {
      PyObject *b = PyBool_FromLong(kv.second ? 1 : 0);
      PyObject_SetAttrString(pres, kv.first.c_str(), b);
      Py_DECREF(b);
    }
    // substitution level semantics (ClpSolve.hpp:264-272)
    if (cs->substitution < 1) {
      PyObject_SetAttrString(pres, "doubleton", Py_False);
      PyObject_SetAttrString(pres, "tripleton", Py_False);
    }
    if (cs->substitution < 2) PyObject_SetAttrString(pres, "tripleton", Py_False);
    if (cs->substitution < 3) PyObject_SetAttrString(pres, "singleton_cols", Py_False);
    Py_DECREF(pres);
  }
  PyObject *r = PyObject_CallMethod(h->model, "initial_solve", "O", opts);
  Py_DECREF(opts);
  if (!r) {
    report_if_error();
    return -1;
  }
  Py_DECREF(r);
  return ClpTpu_status(m);
}

}  // extern "C"
