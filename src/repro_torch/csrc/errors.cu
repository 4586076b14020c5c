// The CUDA runtime's message for an error code returned by the kernels'
// C entry points, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
