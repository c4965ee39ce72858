// The stage mark of a traced CUDA graph: an empty kernel of one thread.
//
// No TPU kernel: the JAX package's profiler reads XLA's own op names off the
// TPU's trace. A CUDA graph's replay is one cudaGraphLaunch on the host, so
// nothing on the host can say where inside a replay the card spends its
// time. pyaudiodsptools_tpu_torch/profiling.py's mark() launches this kernel
// at each stage boundary of a graph captured with tracing on (between the
// executed effects, after the streaming step's state write-back, around a
// sharded program's exchanges); CUPTI stamps each launch on the trace's
// device clock, and profiling.attribute() puts every operation and every
// idle gap between two marks in the stage they bound. It reads and writes
// nothing: bound by the launch alone (a few microseconds in a graph).
//
// Plain C interface; returns a cudaError_t as an int.

#include <cuda_runtime.h>

__global__ void trace_mark_kernel() {}

extern "C" int trace_mark_launch(void* stream) {
  trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
