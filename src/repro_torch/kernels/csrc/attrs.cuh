// The attributes of the compiled kernels, for the card-side check of the
// launch models (analysis/verify/kernel_check.py::check_attributes). Each
// .cu exports
//
//   extern "C" int repro_attrs_<file>(int i, int* out, char* label, int cap)
//
// which fills out[0..3] with its i-th kernel instance's registers a
// thread, static shared bytes a block, local (spill) bytes a thread and
// the most threads a block may have (cudaFuncGetAttributes), and label
// with "<model names>|<input dtype>|<template arguments>": the launch
// models (comma-separated) the instance runs, and the dtype of their first
// input. Returns 0, -1 past the last instance, or the CUDA error. No
// launch changes: the query only reads what the compiler produced.
#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

namespace repro_attrs {

template <typename F>
inline int query(F* kern, const char* label, int* out, char* buf, int cap) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  snprintf(buf, static_cast<size_t>(cap), "%s", label);
  return 0;
}

}  // namespace repro_attrs
