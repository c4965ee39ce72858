// Conditional WHILE and IF nodes inside a CUDA graph that PyTorch is
// capturing.
//
// No TPU kernel: the counterparts of XLA's control flow inside a jitted
// program. The while node keeps pyaudiodsptools_tpu/kernels/dynamics_pallas.py's
// fixpoint (the speculative walks repeated until the segments' entry states
// settle) inside the captured render; the if node lets a captured sharded
// render skip dynspec's walks once its rounds have settled
// (parallel/dynspec.py). PyTorch's CUDAGraph builds IF nodes only
// (CUDAGraph::begin_capture_to_if_node), on a handle of its own; this file
// builds both kinds, the handle made apart, so that a kernel captured BEFORE
// an if node can set it:
//
//   graph_cond_handle(stream, default, &handle)
//     finds the graph `stream` is capturing (cudaStreamGetCaptureInfo) and
//     creates a conditional handle in it whose value is reset to `default` at
//     every launch of the graph;
//   graph_cond_begin(stream, body_stream, handle, is_while)
//     adds a cudaGraphCondTypeWhile (or If) node on the nodes the capture's
//     next node would depend on; makes the node the capture's only
//     dependency, so whatever `stream` captures next runs after it; and begins
//     capturing `body_stream` into the node's body graph.
//   ... the body's launches on body_stream; a while node's body calls
//     cudaGraphSetConditional(handle, more) on the device (the settle step in
//     dynamics.cu); an if node's handle is set before the node (dynamics.cu's
//     round gate) ...
//   graph_cond_end(body_stream)
//     ends the body's capture.
//
// A while node's handle defaults to 1 (the body runs at least once, as the
// JAX loop's first audio walk always runs); an if node's to 0. Nothing here
// allocates device memory; the body must not either (the Python side checks
// PyTorch's allocator around the body: a tensor made there would come from
// outside the graph's private pool). Conditional nodes need a CUDA 12.4
// driver and runtime (cudaStreamBeginCaptureToGraph, conditional handles set
// from a kernel); graph_cond_handle refuses older ones with
// cudaErrorNotSupported, and the caller raises. CUDA on the H100 refused a
// body that holds NCCL's work (PERF.md), so bodies hold our kernels only.
//
// Plain C interface; each function returns a cudaError_t as an int.

#include <cuda_runtime.h>

#define GRAPH_COND_MIN_VERSION 12040

extern "C" int graph_cond_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaRuntimeGetVersion(runtime);
}

// A stream of its own for the bodies (non-blocking, never destroyed): a
// stream from PyTorch's pool may be handed to other code, whose launches
// would then be captured into the body.
extern "C" int graph_body_stream_create(void** stream_out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream_out = (void*)s;
  return (int)err;
}

static int capturing_graph(cudaStream_t st, cudaGraph_t* graph,
                           const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph, deps,
                                             nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, graph, deps,
                                             n_deps);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || *graph == nullptr)
    return (int)cudaErrorIllegalState;
  return 0;
}

extern "C" int graph_cond_handle(void* stream, unsigned int default_value,
                                 unsigned long long* handle_out) {
  int driver = 0, runtime = 0;
  cudaError_t err = (cudaError_t)graph_cond_versions(&driver, &runtime);
  if (err != cudaSuccess) return (int)err;
  if (driver < GRAPH_COND_MIN_VERSION || runtime < GRAPH_COND_MIN_VERSION)
    return (int)cudaErrorNotSupported;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  int rc = capturing_graph((cudaStream_t)stream, &graph, &deps, &n_deps);
  if (rc != 0) return rc;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, default_value,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

extern "C" int graph_cond_begin(void* stream, void* body_stream,
                                unsigned long long handle, int is_while) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  int rc = capturing_graph(st, &graph, &deps, &n_deps);
  if (rc != 0) return rc;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps,
                                     &params);
#else
  cudaError_t err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body,
                                            nullptr, nullptr, 0,
                                            cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_cond_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
