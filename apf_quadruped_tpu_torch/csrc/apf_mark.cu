// Stage marks for the device trace (runtime/profiling.py::mark).
//
// apf_mark_kernel<ID> does no work: one thread that returns.  Launched on
// the current stream at a stage boundary (eagerly, or recorded into a
// captured CUDA graph as a node of its own), it shows in a profiler's
// device trace as a zero-work kernel whose template argument names the
// stage, on the same clock as every other kernel.  The stage IDs are
// profiling.STAGES; MARK_COUNT must be at least their number.

#include <cuda_runtime.h>

constexpr int MARK_COUNT = 13;

// outside any namespace, so that a trace names it `apf_mark_kernel<ID>()`
template <int ID>
__global__ void apf_mark_kernel() {}

namespace {

template <int ID>
void launch_if(int id, cudaStream_t st) {
  if (id == ID) {
    apf_mark_kernel<ID><<<1, 1, 0, st>>>();
  }
  if constexpr (ID + 1 < MARK_COUNT) {
    launch_if<ID + 1>(id, st);
  }
}

}  // namespace

extern "C" {

// Launch apf_mark_kernel<id> on `stream`; returns cudaGetLastError()
// (0 = launched).
int apf_mark_launch(int id, void* stream) {
  if (id < 0 || id >= MARK_COUNT) return (int)cudaErrorInvalidValue;
  launch_if<0>(id, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
