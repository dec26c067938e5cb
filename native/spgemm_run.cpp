// spgemm-run — native driver binary embedding CPython.
//
// The reference is a C++ main that embeds the Python interpreter to call
// its ML selector (IA-SPGEMM-CPU_release/main.cpp:682-704: Py_Initialize,
// sys.path.append, import MatNet, PyEval_CallObject). This framework
// inverts the ratio — the compute pipeline is JAX Python, the
// driver is native — but the bridge is the same embedded-CPython C API:
// initialize the interpreter against the project's venv, import
// ia_spgemm_tpu.cli.main, call main(argv[1:]) and return its exit code.
//
// Build:  make -C native spgemm-run
// Usage:  ./native/spgemm-run A.mtx [B.mtx] [--mode all|autotune|ALG] ...
#include <Python.h>

#include <cstdio>
#include <cstdlib>

#ifndef SPGEMM_PYTHON_EXE
#define SPGEMM_PYTHON_EXE "/opt/venv/bin/python3"
#endif

int main(int argc, char** argv) {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.parse_argv = 0;  // argv is OURS — don't let the runtime eat it

  // point the runtime at the venv interpreter so its site-packages (jax,
  // ia_spgemm_tpu deps) resolve, exactly like running the CLI directly
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        SPGEMM_PYTHON_EXE);
  if (!PyStatus_Exception(st)) {
    st = PyConfig_SetBytesArgv(&config, argc, argv);
  }
  if (!PyStatus_Exception(st)) {
    st = Py_InitializeFromConfig(&config);
  }
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    Py_ExitStatusException(st);
  }

  int rc = 1;
  // sys.path[0] is the binary's directory; the package imports from the
  // repo root (the reference appends './', main.cpp:684)
  PyRun_SimpleString("import sys, os; sys.path.insert(0, os.getcwd())");

  PyObject* mod = PyImport_ImportModule("ia_spgemm_tpu.cli.main");
  if (mod == nullptr) {
    PyErr_Print();
    std::fprintf(stderr,
                 "spgemm-run: cannot import ia_spgemm_tpu.cli.main "
                 "(run from the repo root)\n");
    Py_Finalize();
    return 1;
  }
  PyObject* fn = PyObject_GetAttrString(mod, "main");
  Py_DECREF(mod);
  if (fn == nullptr || !PyCallable_Check(fn)) {
    PyErr_Print();
    Py_XDECREF(fn);
    Py_Finalize();
    return 1;
  }

  // main(argv[1:]) — the reference passes its doubles through
  // Py_BuildValue (main.cpp:697-703); here the CLI args pass as a list
  PyObject* args = PyList_New(argc - 1);
  for (int i = 1; i < argc; ++i) {
    PyList_SetItem(args, i - 1, PyUnicode_FromString(argv[i]));
  }
  PyObject* result = PyObject_CallFunctionObjArgs(fn, args, nullptr);
  Py_DECREF(args);
  Py_DECREF(fn);
  if (result == nullptr) {
    PyErr_Print();
  } else {
    rc = static_cast<int>(PyLong_AsLong(result));
    if (PyErr_Occurred()) {
      PyErr_Print();
      rc = 1;
    }
    Py_DECREF(result);
  }
  if (Py_FinalizeEx() < 0) {
    rc = 120;
  }
  return rc;
}
