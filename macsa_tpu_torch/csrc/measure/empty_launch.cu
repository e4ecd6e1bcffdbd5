// One launch of a kernel that does nothing: the floor under any small
// kernel's time.  For the measurement scripts only (chip_smoke.py and
// csrc/ablate_pixels_and_boxes.py build it into a library of their own);
// it is no part of the port's kernel library.
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int macsa_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
