// The stage markers of utils/trace.py: empty one-thread kernels, one per
// marker id, so that a profiler's kernel records carry the bounds of each
// stage on the device's own timeline. Marker 2 i opens STAGES[i] of
// utils/trace.py and marker 2 i + 1 closes it; the profiler names each
// launch `omni3d_stage_mark<id>`, and a stage's device time is the busy
// time of the kernels between its two markers on the stream. A marker
// reads and writes nothing.
#include <cuda_runtime.h>

#include <utility>

constexpr int kMarks = 64;   // ids 0 .. kMarks - 1 (utils/trace.py MARKS): 32 stages

template <int ID>
__global__ void omni3d_stage_mark() {}

template <int... I>
static cudaError_t launch_mark(int id, cudaStream_t stream, std::integer_sequence<int, I...>) {
  static void (*const kernels[])() = {omni3d_stage_mark<I>...};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernels[id]), dim3(1), dim3(1),
                          nullptr, 0, stream);
}

extern "C" int stage_mark(int id, void* stream) {
  if (id < 0 || id >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mark(id, static_cast<cudaStream_t>(stream),
                                      std::make_integer_sequence<int, kMarks>{}));
}
