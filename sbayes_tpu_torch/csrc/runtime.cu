// Small entry points beside the kernels: the text of a CUDA error code, and
// an empty kernel whose time through the same launch path is the floor
// under every kernel time measured from the host.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* sbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one empty block; returns the cudaError_t of the launch.
extern "C" int sbt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
