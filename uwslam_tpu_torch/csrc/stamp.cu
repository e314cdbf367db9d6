// Stage stamps: the device's clock at a point of a stream, from inside a
// captured CUDA graph.
//
// One thread reads %globaltimer (nanoseconds) and stores it in clock[slot].
// Launched on the stream between two stages, it runs when the stage before
// it has finished, so consecutive stamps bound each stage's device time.
// Given `ms`, the stamp also writes the milliseconds between each pair of
// consecutive stamps before it, ms[i] = (clock[i + 1] - clock[i]) * 1e-6
// for i < slot: the last stamp of a step turns the step's stamps into its
// stage times, in the row that the host already reads (no transfer and no
// synchronization of their own).
//
// CUDA events captured into a graph would be overwritten by the next
// replay before the host reads them; these stamps travel with the frame's
// own diagnostics. Cost: one launch of one thread per stamp.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* clock, float* ms, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  clock[slot] = now;
  if (ms != nullptr) {
    for (int i = 0; i < slot; ++i) {
      ms[i] = static_cast<float>(static_cast<long long>(clock[i + 1] - clock[i])) * 1e-6f;
    }
  }
}

}  // namespace

extern "C" int uws_stamp(unsigned long long* clock, float* ms, int slot, void* stream) {
  if (slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(clock, ms, slot);
  return static_cast<int>(cudaGetLastError());
}
