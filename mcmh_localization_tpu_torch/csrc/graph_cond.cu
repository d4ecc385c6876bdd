// Conditional nodes for the captured filter step (ops/graph.py::run_if).
//
// The JAX step decides four things on the device and skips the untaken
// branch: the injection lax.cond (filter/step.py:529), the ESS gate's
// 0/1-iteration while_loop (:719-752) and the KLD escalation's
// while_loop (ops/resampling.py:425-464).  A CUDA graph of the port's step
// holds each such branch as an IF conditional node (CUDA 12.4 and later):
//
//  - mcmh_cond_begin, called while `stream` is being captured, creates a
//    conditional handle in the graph `stream` captures into, captures one
//    launch of cond_set_kernel (it reads the predicate from device memory,
//    sets the handle and counts the scans that took the branch), adds an
//    IF node after it and starts capturing `body_stream` into the node's
//    body graph;
//  - the caller issues the branch's work on `body_stream`;
//  - mcmh_cond_end ends the body's capture.
// Work captured on `stream` after mcmh_cond_begin depends on the node, so
// it sees the branch's writes when the branch runs.  A body may hold
// conditional nodes of its own (the nesting uses one body stream a level).
//
// Bound: cond_set_kernel is one thread reading one byte; what counts is the
// node's launch, about the cost of an empty kernel.

#include <cuda_runtime.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* __restrict__ pred,
                                unsigned long long* __restrict__ taken) {
  const unsigned int go = pred[0] != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, go);
  if (taken != nullptr) taken[0] += go;
}

}  // namespace

// pred: one byte (a bool tensor), the branch runs where it is not 0;
// taken: one 64-bit counter the kernel adds 1 to when the branch runs (or
// null); body_graph_out: the body graph that body_stream now captures into.
extern "C" int mcmh_cond_begin(void* stream, const unsigned char* pred,
                               unsigned long long* taken,
                               void* body_stream, void** body_graph_out) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cond_set_kernel<<<1, 1, 0, s>>>(handle, pred, taken);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                      body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return static_cast<int>(err);
  *body_graph_out = body;
  return 0;
}

extern "C" int mcmh_cond_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
