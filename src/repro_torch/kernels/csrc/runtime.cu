// Error text for the codes the kernel launchers return, so the Python
// wrappers can name a refused launch.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
