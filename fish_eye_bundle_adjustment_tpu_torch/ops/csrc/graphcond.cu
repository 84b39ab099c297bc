// Conditional IF nodes inside a CUDA graph that PyTorch is capturing, bound
// to PyTorch with ctypes (utils/cudagraph.py).
//
// No TPU kernel stands behind this file.  The JAX package's device loop
// (fish_eye_bundle_adjustment_tpu/solver/device_loop.py) and its CG
// (solver/schur.py `_pcg`) are lax.while_loops: a step or a block of CG
// iterations that the loop's condition rules out is never run.  The port
// captures one GN step as a CUDA graph and replays it; CUDA 12.3+ expresses
// "run this part only if a flag on the device is set" as a conditional node,
// whose body is a graph of its own.  PyTorch 2.11, the card's, has no Python
// API for conditional nodes, so this file adds the two calls that are needed,
// as later PyTorch releases do in CUDAGraph::begin_capture_to_if_node:
//
//   graphcond_begin_if(stream, pred, child, mode): `stream` is capturing.
//     Create a conditional handle in the graph being captured, launch
//     set_cond_kernel on `stream` (at replay it sets the handle from the
//     device bool *pred), add an IF node after it, make the IF node the
//     capture's only dependency, and start capturing `child` into the IF
//     node's body graph.  Work issued on `child` until graphcond_end runs in
//     the body: only when *pred is true at that point of the replay.
//   graphcond_end(child): end the body's capture.
//
// The launch of set_cond_kernel is the only device work here: one thread,
// one byte read.

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int graphcond_abi_version() { return 1; }

int graphcond_begin_if(void* stream, const void* pred, void* child, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_cond_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end at set_cond_kernel
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), body, nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode)));
}

int graphcond_end(void* child) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body));
}

}  // extern "C"
