// CUDA-graph IF nodes for stream capture: the accelerate branch and the
// Alg. 2 trips of the chunked engine run inside a captured graph, decided
// on the device at each replay.
//
// Not the port of a TPU kernel: it is what `lax.cond` around the Alg. 2
// `lax.while_loop` (src/repro/core/isgd.py) becomes under a CUDA graph.
// PyTorch builds that expose CUDAGraph.begin_capture_to_if_node do the same
// inside PyTorch; this file does it for any build on CUDA 12.4 or later.
//
// A body is captured first, as a graph of its own (repro_capture_begin /
// repro_capture_end on a stream of its own, while no other capture is
// under way), and put into the step's graph later, while the step is
// captured on `outer`: repro_if_node(pred, outer, body)
//   1. creates a conditional handle in the graph `outer` is capturing;
//   2. captures set_if_kernel on `outer`: one thread reads the bool at
//      `pred` and sets the handle (cudaGraphSetConditional), so the
//      predicate is read where and when the replay reaches it;
//   3. adds an IF node after it whose body holds `body` as a child graph,
//      and makes `outer`'s capture continue after that node.
// A body captured while the step's capture is under way (into the node's
// body, or as a graph of its own) fails on cuDNN's convolution engines that
// run an auxiliary engine beside the core one (CUDNN_STATUS_INTERNAL_ERROR
// in cudnnBackendExecute, alexnet-small at batch 256); captured with no
// other capture under way, the same convolutions capture. A body may hold
// kernels, memsets, copies and conditional nodes, not event nodes.
#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int repro_capture_begin(cudaStream_t stream) {
  return cudaStreamBeginCapture(stream, cudaStreamCaptureModeRelaxed);
}

extern "C" int repro_capture_end(cudaStream_t stream, cudaGraph_t* graph) {
  return cudaStreamEndCapture(stream, graph);
}

extern "C" int repro_graph_destroy(cudaGraph_t graph) {
  return cudaGraphDestroy(graph);
}

extern "C" int repro_if_node(const bool* pred, cudaStream_t outer,
                             cudaGraph_t body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph,
                                             &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, outer>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps,
                                 &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node, child;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, body);
  if (err != cudaSuccess) return err;
  return cudaStreamUpdateCaptureDependencies(outer, &node, 1,
                                             cudaStreamSetCaptureDependencies);
}

// The CUDA driver's and this library's runtime versions (e.g. 12080).
extern "C" int repro_if_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return err;
  return cudaRuntimeGetVersion(runtime);
}

extern "C" const char* repro_if_error(int err) {
  return err < 0 ? "stream is not capturing"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}
