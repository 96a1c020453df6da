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
// graph_capture_nodes, on a stream that is capturing (the main graph or an
// IF body): lists the nodes of the graph being captured into from the
// start-th on, in the order cuGraphGetNodes gives them (the order the
// capture added them), each as a kind (kernel, memcpy, memset, other) and,
// for a kernel, its (mangled) name.  It adds nothing to the graph; the
// compiled step's stage map (step_graph._Capture.stage) is written from
// it.  It calls the low-level cu* API (cuStreamGetCaptureInfo,
// cuGraphGetNodes, cuGraphKernelNodeGetParams, cuFuncGetName), reached
// through the runtime's entry-point query: the graph and the kernels in it
// belong to PyTorch's and the other csrc libraries' copies of the runtime.
//
// What bounds set_condition_kernel: the launch (one byte read).  Built with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3.  graph_if_begin and
// graph_if_end return a cudaError_t code, graph_capture_nodes a CUresult
// code, 0 on success.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>
#include <vector>

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

// The cu* calls graph_capture_nodes makes, reached through the runtime's
// entry-point query once (CuApi::get), each at the ABI of the
// CUDA version given: 12.0's (cuStreamGetCaptureInfo without the edge data
// of 12.3) and, for the names, 12.3's.
struct CuApi {
  CUresult (*capture_info)(CUstream, CUstreamCaptureStatus*, cuuint64_t*,
                           CUgraph*, const CUgraphNode**, size_t*) = nullptr;
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*) = nullptr;
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*) = nullptr;
  CUresult (*kernel_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*) = nullptr;
  CUresult (*func_name)(const char**, CUfunction) = nullptr;
  CUresult (*kernel_name)(const char**, CUkernel) = nullptr;
  CUresult (*error_string)(CUresult, const char**) = nullptr;
  bool ok = false;

  static const CuApi& get() {
    static const CuApi d = make();
    return d;
  }

 private:
  static bool entry(const char* symbol, void** fn, int version = 12000) {
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        symbol, fn, version, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess;
#else
    // before 12.5 the query gives the ABI of the runtime built against
    (void)symbol, (void)fn, (void)version;
    return false;
#endif
  }

  static CuApi make() {
    CuApi d;
    d.ok = entry("cuStreamGetCaptureInfo", (void**)&d.capture_info) &&
           entry("cuGraphGetNodes", (void**)&d.get_nodes) &&
           entry("cuGraphNodeGetType", (void**)&d.node_type) &&
           entry("cuGraphKernelNodeGetParams", (void**)&d.kernel_params) &&
           entry("cuGetErrorString", (void**)&d.error_string);
    // the names are best effort: a kernel without one is listed as ""
    entry("cuFuncGetName", (void**)&d.func_name, 12030);
    entry("cuKernelGetName", (void**)&d.kernel_name, 12030);
    return d;
  }
};

// the kernel node's name into out (len bytes), or "" where cuFuncGetName
// and cuKernelGetName give none
void kernel_name(const CuApi& d, CUgraphNode node, char* out, int len) {
  out[0] = 0;
  CUDA_KERNEL_NODE_PARAMS p;
  std::memset(&p, 0, sizeof(p));
  if (d.kernel_params(node, &p) != CUDA_SUCCESS) return;
  const char* name = nullptr;
  if (p.func != nullptr && d.func_name != nullptr &&
      d.func_name(&name, p.func) != CUDA_SUCCESS)
    name = nullptr;
  if (name == nullptr && d.kernel_name != nullptr) {
    CUkernel k = p.kern != nullptr ? p.kern : (CUkernel)p.func;
    if (k == nullptr || d.kernel_name(&name, k) != CUDA_SUCCESS)
      name = nullptr;
  }
  if (name != nullptr) {
    std::strncpy(out, name, len - 1);
    out[len - 1] = 0;
  }
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

// The nodes of the graph `stream` is capturing into: their number in
// *count, and for nodes [start, start + cap) their kinds in `kinds` ('k' a
// kernel, 'c' a memcpy, 's' a memset, 'o' any other node, such as an IF
// node) and the kernels' names in `names` (name_len bytes each, "" for the
// other kinds).  With cap 0 only the count is written.  Returns a CUresult
// code (graph_cond_cu_error_string), 0 on success; CUDA_ERROR_NOT_FOUND
// where the cu* calls cannot be reached (a toolkit before CUDA 12.5).
extern "C" int graph_capture_nodes(void* stream, size_t start, char* kinds,
                                   char* names, int name_len, size_t cap,
                                   size_t* count) {
  const CuApi& d = CuApi::get();
  if (!d.ok) return (int)CUDA_ERROR_NOT_FOUND;
  CUstreamCaptureStatus status;
  CUgraph graph = nullptr;
  const CUgraphNode* deps = nullptr;
  size_t ndeps = 0;
  CUresult err = d.capture_info((CUstream)stream, &status, nullptr, &graph,
                                &deps, &ndeps);
  if (err != CUDA_SUCCESS) return (int)err;
  if (status != CU_STREAM_CAPTURE_STATUS_ACTIVE)
    return (int)CUDA_ERROR_STREAM_CAPTURE_UNMATCHED;
  size_t n = 0;
  err = d.get_nodes(graph, nullptr, &n);
  if (err != CUDA_SUCCESS) return (int)err;
  *count = n;
  if (cap == 0 || start >= n) return 0;
  std::vector<CUgraphNode> nodes(n);
  err = d.get_nodes(graph, nodes.data(), &n);
  if (err != CUDA_SUCCESS) return (int)err;
  for (size_t i = start; i < n && i - start < cap; ++i) {
    CUgraphNodeType type;
    err = d.node_type(nodes[i], &type);
    if (err != CUDA_SUCCESS) return (int)err;
    char* name = names + (i - start) * (size_t)name_len;
    name[0] = 0;
    switch (type) {
      case CU_GRAPH_NODE_TYPE_KERNEL:
        kinds[i - start] = 'k';
        kernel_name(d, nodes[i], name, name_len);
        break;
      case CU_GRAPH_NODE_TYPE_MEMCPY:
        kinds[i - start] = 'c';
        break;
      case CU_GRAPH_NODE_TYPE_MEMSET:
        kinds[i - start] = 's';
        break;
      default:
        kinds[i - start] = 'o';
    }
  }
  return 0;
}

extern "C" const char* graph_cond_cu_error_string(int code) {
  const CuApi& d = CuApi::get();
  const char* msg = nullptr;
  if (d.error_string == nullptr ||
      d.error_string((CUresult)code, &msg) != CUDA_SUCCESS || msg == nullptr)
    return "unknown CUresult";
  return msg;
}
