// Launch context shared by the port's kernel sources (csrc/*.cu).
//
// Every entry point takes the CUDA device ordinal of its tensors and the
// stream to launch on (PyTorch's current stream on that device, looked up
// by the wrapper at each call), and returns the launch's cudaError as an
// int. The guard makes that device current only when it is not already
// (one cudaGetDevice per call otherwise), and restores the caller's device
// on the way out, so the Python wrappers need no torch.cuda.device context.
//
// Each source is built as a Python extension module (ops/_build.py) that
// exposes its entry points as Python functions through `method`: a
// METH_FASTCALL function that converts its positional Python arguments to
// the entry point's parameter types (pointers and the stream from ints,
// integers, floating point) and calls it with the GIL released. That
// costs about a tenth of a microsecond a call, where a ctypes call with
// argtypes costs about one; no PyTorch header is included, so a source
// builds in seconds.

#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cuda_runtime.h>

#include <cstddef>
#include <tuple>
#include <type_traits>
#include <utility>

namespace turbomesh {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess once `device` is current
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = -1;
  cudaError_t err_;
};

// One Python argument as the parameter type T; false with a Python error
// set when it does not convert.
template <typename T>
bool from_python(PyObject* obj, T& out) {
  if constexpr (std::is_pointer_v<T>) {
    out = static_cast<T>(PyLong_AsVoidPtr(obj));
  } else if constexpr (std::is_floating_point_v<T>) {
    out = static_cast<T>(PyFloat_AsDouble(obj));
  } else {
    out = static_cast<T>(PyLong_AsLong(obj));
  }
  return !PyErr_Occurred();
}

template <auto Fn, typename... A, std::size_t... I>
PyObject* call(int (*)(A...), PyObject* const* args,
               std::index_sequence<I...>) {
  std::tuple<A...> values;
  if (!(from_python(args[I], std::get<I>(values)) && ...)) return nullptr;
  int err;
  Py_BEGIN_ALLOW_THREADS
  err = std::apply(Fn, values);
  Py_END_ALLOW_THREADS
  return PyLong_FromLong(err);
}

template <typename... A>
constexpr std::size_t arity(int (*)(A...)) {
  return sizeof...(A);
}

template <auto Fn>
PyObject* fastcall(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  constexpr std::size_t n = arity(Fn);
  if (nargs != static_cast<Py_ssize_t>(n)) {
    PyErr_Format(PyExc_TypeError, "takes %zu arguments, got %zd", n, nargs);
    return nullptr;
  }
  return call<Fn>(Fn, args, std::make_index_sequence<n>{});
}

// The method-table entry that exposes the entry point Fn as `name`.
template <auto Fn>
PyMethodDef method(const char* name) {
  return {name, reinterpret_cast<PyCFunction>(
                    reinterpret_cast<void (*)(void)>(&fastcall<Fn>)),
          METH_FASTCALL, nullptr};
}

}  // namespace turbomesh

// PyInit_<name> of a source's extension module with the method table
// `methods` (ending in a zeroed entry).
#define TURBOMESH_MODULE(name, methods)                                  \
  static PyModuleDef name##_module = {PyModuleDef_HEAD_INIT, #name,     \
                                      nullptr, -1, methods};            \
  PyMODINIT_FUNC PyInit_##name() { return PyModule_Create(&name##_module); }
