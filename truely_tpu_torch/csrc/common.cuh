// Shared by every kernel library of the package: each .cu is built into
// its own shared library with a plain C interface, loaded with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floor and ceiling division for a positive divisor (C++ '/' truncates).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int ceil_div(int a, int b) {
  return -floor_div(-a, b);
}
