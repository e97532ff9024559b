// Stage mark: one thread stores the card's %globaltimer into one slot.
//
// Replaces no TPU kernel.  The JAX package splits a frame by stage from
// the profiler's HLO ops; here a frame is one CUDA graph replay, whose
// kernels the profiler ties to the one graph launch, and whose Python
// stage labels ran once, during the capture.  While the port's tracer is
// on (runtime/profiler.py: enable_spans), its hook launches this kernel on
// entry to each detector stage and once after the last one; inside a
// capture each launch becomes a graph node, so every replay stamps its
// own frame in stream order: a mark runs when the stage before it has
// finished.  The slots go to the host with the frame's boxes, in one copy
// the engine enqueues after the replay.
//
// Contract: marks [>= slot + 1] int64 on the card, 0 <= slot.  Writes
// marks[slot] = %globaltimer (ns on the card's global clock) and nothing
// else.
//
// What bounds it on the H100: the launch.  One thread, one 8-byte store;
// in a graph a node costs about a microsecond of the stream's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_mark_kernel(unsigned long long* marks, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  marks[slot] = now;
}

}  // namespace

extern "C" int dsvt_stage_mark(void* marks, int slot, void* stream) {
  stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(marks), slot);
  return static_cast<int>(cudaGetLastError());
}
