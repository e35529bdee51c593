// _sphinxsys_fastio — native IO formatting for the VTP/body-state writers.
//
// The reference's IO stack is native C++ (io_vtk.h hand-rolled XML); here
// the compute path is JAX but the text-serialization hot path (millions of
// "%.7g" floats per output frame) is genuinely CPU-bound, so it is native
// too.  CPython C API only (no pybind11 in the image).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <vector>

// Format a contiguous float32/float64 2D buffer as ASCII rows:
// "v v v\n" per row with %.7g. Returns bytes.
static PyObject *format_rows(PyObject *self, PyObject *args) {
  PyObject *obj;
  int is_double = 0;
  if (!PyArg_ParseTuple(args, "Oi", &obj, &is_double)) return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_RECORDS_RO) != 0) return nullptr;

  if (view.ndim != 2) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "expected a 2D buffer");
    return nullptr;
  }
  const Py_ssize_t rows = view.shape[0];
  const Py_ssize_t cols = view.shape[1];
  const char *data = static_cast<const char *>(view.buf);
  const Py_ssize_t rstride = view.strides[0];
  const Py_ssize_t cstride = view.strides[1];

  std::vector<char> out;
  out.reserve(static_cast<size_t>(rows) * cols * 14);
  char tmp[64];

  for (Py_ssize_t i = 0; i < rows; ++i) {
    const char *rp = data + i * rstride;
    for (Py_ssize_t j = 0; j < cols; ++j) {
      double v;
      if (is_double) {
        v = *reinterpret_cast<const double *>(rp + j * cstride);
      } else {
        v = static_cast<double>(
            *reinterpret_cast<const float *>(rp + j * cstride));
      }
      int n = snprintf(tmp, sizeof(tmp), "%.7g", v);
      if (j > 0) out.push_back(' ');
      out.insert(out.end(), tmp, tmp + n);
    }
    out.push_back('\n');
  }
  PyBuffer_Release(&view);
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

static PyMethodDef Methods[] = {
    {"format_rows", format_rows, METH_VARARGS,
     "format a 2D float buffer as ASCII rows (is_double flag)"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_sphinxsys_fastio",
    "native IO formatting for sphinxsys_jax", -1, Methods,
};

PyMODINIT_FUNC PyInit__sphinxsys_fastio(void) {
  return PyModule_Create(&moduledef);
}
