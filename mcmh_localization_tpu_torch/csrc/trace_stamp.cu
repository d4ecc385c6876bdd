// Stage stamps inside the captured filter step (utils/profiling.py::stamp).
//
// The JAX package times a step only from outside (jax.profiler).  Here,
// where tracing is on when a step is captured, filter/step.py::_correct
// places a stamp after each stage, and each stamp is one launch of this
// kernel, a node of the graph: it reads the card's global nanosecond timer
// (%globaltimer) when the work before it on the stream has finished, adds
// the time since the previous stamp to its stage's total, counts the
// stamp and keeps the time.  Stage 0 opens a scan: it only counts and
// keeps the time.  A stamp inside a conditional body runs where the body
// runs.
//
// buf (int64): [0, stages) the totals in ns, [stages, 2 stages) the
// stamps, [2 stages] the time of the last stamp.
//
// Bound: one thread, 24 bytes read and written; what counts is the node's
// launch, about the cost of an empty kernel.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(long long* __restrict__ buf, int stage,
                                   int stages) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (stage > 0) buf[stage] += t - buf[2 * stages];
  buf[stages + stage] += 1;
  buf[2 * stages] = t;
}

}  // namespace

extern "C" int mcmh_trace_stamp(long long* buf, int stage, int stages,
                                void* stream) {
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, stage, stages);
  return static_cast<int>(cudaGetLastError());
}
