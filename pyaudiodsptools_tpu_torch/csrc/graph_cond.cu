// A conditional WHILE node inside a CUDA graph that PyTorch is capturing.
//
// No TPU kernel: the counterpart of XLA's while loop, which keeps
// pyaudiodsptools_tpu/kernels/dynamics_pallas.py's fixpoint (the speculative
// walks repeated until the segments' entry states settle) inside the jitted
// render. PyTorch's CUDAGraph builds IF nodes only
// (CUDAGraph::begin_capture_to_if_node); this file builds a while node the
// same way, so that the offline render's fixpoint runs inside one captured
// graph with no host read-back:
//
//   graph_while_begin(stream, body_stream, &handle)
//     finds the graph `stream` is capturing and the nodes its next node would
//     depend on (cudaStreamGetCaptureInfo); creates a conditional handle whose
//     value is reset to 1 at every launch of the graph (the body runs at least
//     once, as the JAX loop's first audio walk always runs); adds a
//     cudaGraphCondTypeWhile node on those dependencies; makes the node the
//     capture's only dependency, so whatever `stream` captures next runs after
//     the loop; and begins capturing `body_stream` into the node's body graph.
//   ... the body's launches on body_stream; one of them calls
//     cudaGraphSetConditional(handle, more) on the device (the settle step in
//     dynamics.cu) ...
//   graph_while_end(body_stream)
//     ends the body's capture.
//
// Nothing here allocates device memory; the body must not either (the Python
// side checks PyTorch's allocator around the body: a tensor made there would
// come from outside the graph's private pool). Conditional nodes need a CUDA
// 12.4 driver and runtime (cudaStreamBeginCaptureToGraph, conditional handles
// set from a kernel); graph_while_begin refuses older ones with
// cudaErrorNotSupported, and the caller raises.
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

extern "C" int graph_while_begin(void* stream, void* body_stream,
                                 unsigned long long* handle_out) {
  int driver = 0, runtime = 0;
  cudaError_t err = (cudaError_t)graph_cond_versions(&driver, &runtime);
  if (err != cudaSuccess) return (int)err;
  if (driver < GRAPH_COND_MIN_VERSION || runtime < GRAPH_COND_MIN_VERSION)
    return (int)cudaErrorNotSupported;
  cudaStream_t st = (cudaStream_t)stream;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph, &deps, nullptr,
                                 &n_deps);
#else
  err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph, &deps, &n_deps);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
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
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body,
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

extern "C" int graph_while_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
