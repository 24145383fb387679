// Runtime helpers shared by the kernel wrappers (no kernel of its own).
#include <cuda_runtime.h>

extern "C" const char* gofr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
