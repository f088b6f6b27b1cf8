/* Inference C API over export_serialized() artifacts of paddle_tpu_torch.
 *
 * A copy of the JAX package's csrc/capi.cc, the analog of the reference's
 * inference C API (paddle/fluid/inference/capi/c_api.cc,
 * paddle_c_api.h PD_NewPredictor/PD_PredictorRun). It embeds a CPython
 * interpreter and drives the framework-free `serving_core.py` that
 * export_serialized() ships inside the artifact directory, which loads
 * the artifact's torch.export program and its kernel ops by path: a C host
 * needs this .so, libpython, torch, and the artifact. The header,
 * pt_c_api.h, is the JAX package's unchanged, so a client links against
 * either package's library.
 *
 * The embedded interpreter finds torch through the Python it was built
 * for: its executable (PT_PYTHON_EXECUTABLE, defined at build time by
 * paddle_tpu_torch/capi.py, or the PADDLE_TPU_PYTHON environment
 * variable) is the program name the interpreter computes its prefix and
 * site-packages from, a virtual environment's included. The device is
 * SerializedCore's: the card unless PADDLE_TPU_SERVING_DEVICE=cpu. A
 * PT_BFLOAT16 tensor crosses the ABI as raw 2-byte words, bit for bit.
 *
 * ABI (pt_c_api.h):
 *   PT_Predictor* PT_NewPredictor(const char* artifact_dir);
 *   int  PT_GetInputNum / PT_GetOutputNum(p);
 *   const char* PT_GetInputName / PT_GetOutputName(p, i);
 *   int  PT_PredictorRun(p, const PT_Tensor* ins, int n_in,
 *                        PT_Tensor* outs, int max_out);  // -> n_out
 *   const char* PT_GetLastError(void);
 *   void PT_DeletePredictor(p);
 * Output buffers are owned by the predictor and valid until the next
 * Run or Delete (the reference's output-tensor lifetime contract).
 */
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "pt_c_api.h" /* single source of the ABI: PT_Tensor, dtypes */

struct PT_Predictor {
  PyObject *core;                       /* SerializedCore instance */
  std::vector<std::string> in_names, out_names;
  std::vector<std::vector<char>> out_bufs; /* last-run output storage */
};

/* thread_local: concurrent host threads each get their own error slot
 * (unsynchronized writes to one global std::string would be UB) */
static thread_local std::string g_last_error;

static const size_t kItemSize[] = {4, 4, 8, 8, 1, 2, 2, 1};
static const int kNumDtypes = 8;

static void set_err_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

#ifndef PT_PYTHON_EXECUTABLE
#define PT_PYTHON_EXECUTABLE ""
#endif

/* Initialize the embedded interpreter exactly once (thread-safe: a
 * multithreaded host may create predictors concurrently), with the
 * build's Python executable as its program name, so that it finds the
 * site-packages that hold torch. */
static std::once_flag g_py_once;
static std::string g_init_error;
static void ensure_python() {
  std::call_once(g_py_once, [] {
    if (Py_IsInitialized()) return;
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    const char *exe = getenv("PADDLE_TPU_PYTHON");
    if (!exe || !*exe) exe = PT_PYTHON_EXECUTABLE;
    PyStatus st = PyStatus_Ok();
    if (*exe)
      st = PyConfig_SetBytesString(&config, &config.program_name, exe);
    if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) {
      g_init_error = std::string("embedded Python failed to start: ") +
                     (st.err_msg ? st.err_msg : "unknown error");
      return;
    }
    /* release the GIL acquired by initialization so PyGILState_Ensure
     * nests correctly from any host thread afterwards */
    PyEval_SaveThread();
  });
}

static PyObject *load_core_class(const char *artifact_dir) {
  /* importlib.util.spec_from_file_location("pt_serving_core",
   * "<artifact>/serving_core.py") — loads by path, no package import */
  PyObject *importlib = PyImport_ImportModule("importlib.util");
  if (!importlib) return nullptr;
  std::string py = std::string(artifact_dir) + "/serving_core.py";
  PyObject *spec = PyObject_CallMethod(importlib, "spec_from_file_location",
                                       "ss", "pt_serving_core", py.c_str());
  if (!spec || spec == Py_None) {
    Py_XDECREF(spec);
    Py_DECREF(importlib);
    g_last_error = "artifact has no serving_core.py: " + py;
    return nullptr;
  }
  PyObject *mod = PyObject_CallMethod(importlib, "module_from_spec", "O",
                                      spec);
  PyObject *cls = nullptr;
  if (mod) {
    PyObject *loader = PyObject_GetAttrString(spec, "loader");
    PyObject *ok = loader ? PyObject_CallMethod(loader, "exec_module", "O",
                                                mod)
                          : nullptr;
    if (ok) cls = PyObject_GetAttrString(mod, "SerializedCore");
    Py_XDECREF(ok);
    Py_XDECREF(loader);
    Py_DECREF(mod);
  }
  Py_DECREF(spec);
  Py_DECREF(importlib);
  return cls;
}

static bool fill_names(PyObject *core, const char *attr,
                       std::vector<std::string> *out) {
  PyObject *names = PyObject_GetAttrString(core, attr);
  if (!names) return false;
  Py_ssize_t n = PySequence_Size(names);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(names, i);
    const char *c = it ? PyUnicode_AsUTF8(it) : nullptr;
    if (c) out->push_back(c);
    Py_XDECREF(it);
  }
  Py_DECREF(names);
  return true;
}

extern "C" {

const char *PT_GetLastError(void) { return g_last_error.c_str(); }

PT_Predictor *PT_NewPredictor(const char *artifact_dir) {
  if (!artifact_dir) {
    g_last_error = "artifact_dir is null";
    return nullptr;
  }
  ensure_python();
  if (!Py_IsInitialized()) {
    g_last_error = g_init_error;
    return nullptr;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PT_Predictor *p = nullptr;
  PyObject *cls = load_core_class(artifact_dir);
  if (cls) {
    PyObject *core = PyObject_CallFunction(cls, "s", artifact_dir);
    Py_DECREF(cls);
    if (core) {
      p = new PT_Predictor();
      p->core = core;
      if (!fill_names(core, "feed_names", &p->in_names) ||
          !fill_names(core, "fetch_names", &p->out_names)) {
        set_err_from_python();
        Py_DECREF(core);
        delete p;
        p = nullptr;
      }
    } else {
      set_err_from_python();
    }
  } else if (g_last_error.empty() || PyErr_Occurred()) {
    set_err_from_python();
  }
  PyGILState_Release(gil);
  return p;
}

int PT_GetInputNum(PT_Predictor *p) {
  return p ? (int)p->in_names.size() : -1;
}

int PT_GetOutputNum(PT_Predictor *p) {
  return p ? (int)p->out_names.size() : -1;
}

const char *PT_GetInputName(PT_Predictor *p, int i) {
  if (!p || i < 0 || i >= (int)p->in_names.size()) return nullptr;
  return p->in_names[i].c_str();
}

const char *PT_GetOutputName(PT_Predictor *p, int i) {
  if (!p || i < 0 || i >= (int)p->out_names.size()) return nullptr;
  return p->out_names[i].c_str();
}

int PT_PredictorRun(PT_Predictor *p, const PT_Tensor *ins, int n_in,
                    PT_Tensor *outs, int max_out) {
  if (!p || !p->core) {
    g_last_error = "null predictor";
    return -1;
  }
  if (n_in != (int)p->in_names.size()) {
    g_last_error = "expected " + std::to_string(p->in_names.size()) +
                   " inputs, got " + std::to_string(n_in);
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int result = -1;
  PyObject *feeds = PyList_New(n_in);
  bool feed_ok = feeds != nullptr;
  for (int i = 0; feed_ok && i < n_in; ++i) {
    const PT_Tensor &t = ins[i];
    if (t.dtype < 0 || t.dtype >= kNumDtypes || t.ndim < 0 ||
        t.ndim > PT_MAX_DIMS) {
      g_last_error = "bad input tensor " + std::to_string(i);
      feed_ok = false;
      break;
    }
    const size_t kMaxElems = (size_t)1 << 40;
    size_t count = 1;
    bool shape_ok = true;
    for (int d = 0; d < t.ndim; ++d) {
      /* reject negative/overflowing extents before sizing the copy */
      if (t.shape[d] < 0 ||
          (t.shape[d] > 0 && count > kMaxElems / (size_t)t.shape[d])) {
        shape_ok = false;
        break;
      }
      count *= (size_t)t.shape[d];
    }
    if (!shape_ok) {
      g_last_error = "bad shape in input tensor " + std::to_string(i);
      feed_ok = false;
      break;
    }
    PyObject *shape = PyList_New(t.ndim);
    for (int d = 0; d < t.ndim; ++d)
      PyList_SetItem(shape, d, PyLong_FromLongLong(t.shape[d]));
    PyObject *buf = PyBytes_FromStringAndSize(
        (const char *)t.data, (Py_ssize_t)(count * kItemSize[t.dtype]));
    PyObject *arr = buf ? PyObject_CallMethod(p->core, "from_flat", "OiO",
                                              buf, t.dtype, shape)
                        : nullptr;
    Py_XDECREF(buf);
    Py_XDECREF(shape);
    if (!arr) {
      set_err_from_python();
      feed_ok = false;
      break;
    }
    PyList_SetItem(feeds, i, arr); /* steals */
  }
  PyObject *res = feed_ok ? PyObject_CallMethod(p->core, "run", "O", feeds)
                          : nullptr;
  Py_XDECREF(feeds);
  if (res) {
    Py_ssize_t n_out = PySequence_Size(res);
    if (n_out > max_out) {
      g_last_error = "output buffer too small: need " +
                     std::to_string(n_out);
    } else {
      p->out_bufs.assign((size_t)n_out, {});
      bool ok = true;
      for (Py_ssize_t i = 0; ok && i < n_out; ++i) {
        PyObject *arr = PySequence_GetItem(res, i);
        PyObject *code = arr ? PyObject_CallMethod(p->core, "dtype_code",
                                                   "O", arr)
                             : nullptr;
        PyObject *shape = arr ? PyObject_GetAttrString(arr, "shape")
                              : nullptr;
        PyObject *bytes = arr ? PyObject_CallMethod(arr, "tobytes", nullptr)
                              : nullptr;
        if (code && shape && (int)PyTuple_Size(shape) > PT_MAX_DIMS) {
          g_last_error = "output " + std::to_string(i) + " has rank " +
                         std::to_string(PyTuple_Size(shape)) +
                         " > PT_MAX_DIMS";
          ok = false;
        } else if (code && shape && bytes) {
          PT_Tensor &o = outs[i];
          o.dtype = (int)PyLong_AsLong(code);
          o.ndim = (int)PyTuple_Size(shape);
          for (int d = 0; d < o.ndim; ++d)
            o.shape[d] = PyLong_AsLongLong(PyTuple_GetItem(shape, d));
          char *raw = nullptr;
          Py_ssize_t len = 0;
          PyBytes_AsStringAndSize(bytes, &raw, &len);
          p->out_bufs[i].assign(raw, raw + len);
          o.data = p->out_bufs[i].data();
        } else {
          set_err_from_python();
          ok = false;
        }
        Py_XDECREF(bytes);
        Py_XDECREF(shape);
        Py_XDECREF(code);
        Py_XDECREF(arr);
      }
      if (ok) result = (int)n_out;
    }
    Py_DECREF(res);
  } else if (feed_ok) {
    set_err_from_python();
  }
  PyGILState_Release(gil);
  return result;
}

void PT_DeletePredictor(PT_Predictor *p) {
  if (!p) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(p->core);
  PyGILState_Release(gil);
  delete p;
}

} /* extern "C" */
