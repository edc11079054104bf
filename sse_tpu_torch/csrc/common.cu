// C entry points shared by every kernel of the library.
#include <cuda_runtime.h>

extern "C" const char* sse_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
