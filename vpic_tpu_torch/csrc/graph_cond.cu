// graph_cond.cu -- a conditional (IF) node in a CUDA graph under stream
// capture, and the kernel that sets its condition from a device bool,
// written by hand for Hopper (sm_90a).
//
// Replaces: the JAX package's lax.cond between the residency step's
// rebucket and merge (vpic_tpu/deck.py:1360-1419), which XLA decides on the
// TPU.  No TPU kernel corresponds to it.  Its plain version is the eager
// step's host read of the same bool (vpic_tpu_torch/deck.py, push3): the
// eager step reads it and runs one branch; the captured step runs
// graph_if_begin / graph_if_end around each branch, the rebucket on the
// bool and the merge on its negation, so a replay reads nothing on the host.
//
// graph_if_begin, on a stream that is capturing: creates a conditional
// handle in the graph being captured, captures set_condition_kernel (one
// thread: reads the bool, cudaGraphSetConditional) on that stream, adds an
// IF node after it and makes the node the stream's capture dependency, then
// starts capturing `body_stream` into the node's body graph.  Everything
// issued to body_stream until graph_if_end runs only when the bool was true
// at that point of the replay.  CUDA 12.4 or later.
//
// What bounds it: the launch (one byte read).  Built with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3.  Each entry point returns
// a cudaError_t code, 0 on success.

#include <cuda_runtime.h>

namespace {

// CUDA 13 added the edge data to the capture-info and node calls.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, ndeps);
#endif
}

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(void* stream, void* body_stream,
                              const void* pred) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

extern "C" const char* graph_cond_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
