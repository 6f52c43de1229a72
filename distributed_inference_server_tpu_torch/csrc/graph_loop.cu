// One CUDA graph launch per run-to-completion decode block (kernel looping).
//
// The JAX engine runs a looped decode block as one lax.while_loop whose trip
// count the device decides (distributed_inference_server_tpu/engine/
// engine.py _build_loop_block): every row steps until EOS, its budget, an
// empty device page free-list or the iteration cap. A CUDA graph captured
// from a stream holds no data-dependent loop, so this file builds one around
// two graphs that PyTorch captured (CUDAGraph(keep_graph=True)):
//
//   outer graph:  [prologue]  ->  [set condition]  ->  WHILE {
//                                                        [body]
//                                                        [set condition]
//                                                      }
//
// - prologue: merges the host's carry overrides, resets the loop state and
//   writes the continue flag (any row active);
// - body: one loop iteration (the device page append, one decode step, the
//   freeze law, the output write at the device counter k), ending with the
//   continue flag (k < cap and any row active);
// - set condition: a one-thread kernel that copies the flag into the WHILE
//   node's condition (cudaGraphSetConditional). The condition is tested
//   before the first iteration, so a block with no active row runs none.
//
// Both captured graphs enter as child graph nodes (cloned at insertion), so
// the caller keeps the PyTorch graphs alive only for their memory pool. The
// instantiated outer graph is one cudaGraphLaunch on the engine's stream.
// Conditional WHILE nodes need CUDA 12.4 or later and a body made only of
// kernel, memset, memcpy, empty, child-graph and conditional nodes: the
// instantiate below reports what CUDA refuses.
//
// Plain C interface, bound with ctypes (ops/kernels/_build.py); every
// function returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void loop_set_condition(cudaGraphConditionalHandle handle,
                                   const int* flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

struct LoopGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

cudaError_t add_set_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                              const cudaGraphNode_t* dep,
                              cudaGraphConditionalHandle handle,
                              const int* flag) {
  void* args[2] = {&handle, &flag};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(loop_set_condition);
  kp.gridDim = dim3(1, 1, 1);
  kp.blockDim = dim3(1, 1, 1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &kp);
}

}  // namespace

// Build and instantiate the outer graph from the captured ``prologue`` and
// ``body`` (cudaGraph_t handles) and the device int ``flag`` both write.
// On success ``*out`` holds the loop graph; ``*instantiate_result`` the
// cudaGraphInstantiateResult (0 = success), which says why an
// instantiate was refused.
extern "C" int graph_loop_build(void* prologue, void* body, const int* flag,
                                void** out, int* instantiate_result) {
  *out = nullptr;
  *instantiate_result = -1;
  LoopGraph* lg = new LoopGraph();
  cudaError_t err = cudaGraphCreate(&lg->graph, 0);
  cudaGraphNode_t pro = nullptr, init = nullptr, loop = nullptr;
  cudaGraphNode_t child = nullptr, again = nullptr;
  cudaGraphConditionalHandle handle = 0;
  cudaGraph_t body_graph = nullptr;
  if (err != cudaSuccess) goto fail;
  err = cudaGraphAddChildGraphNode(&pro, lg->graph, nullptr, 0,
                                   static_cast<cudaGraph_t>(prologue));
  if (err != cudaSuccess) goto fail;
  err = cudaGraphConditionalHandleCreate(&handle, lg->graph, 0, 0);
  if (err != cudaSuccess) goto fail;
  err = add_set_condition(&init, lg->graph, &pro, handle, flag);
  if (err != cudaSuccess) goto fail;
  {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&loop, lg->graph, &init, 1, &cp);
    if (err != cudaSuccess) goto fail;
    body_graph = cp.conditional.phGraph_out[0];
  }
  err = cudaGraphAddChildGraphNode(&child, body_graph, nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) goto fail;
  err = add_set_condition(&again, body_graph, &child, handle, flag);
  if (err != cudaSuccess) goto fail;
  {
    cudaGraphInstantiateParams ip = {};
    ip.flags = 0;
    err = cudaGraphInstantiateWithParams(&lg->exec, lg->graph, &ip);
    *instantiate_result = static_cast<int>(ip.result_out);
    if (err != cudaSuccess) goto fail;
  }
  *out = lg;
  return cudaSuccess;
fail:
  if (lg->exec) cudaGraphExecDestroy(lg->exec);
  if (lg->graph) cudaGraphDestroy(lg->graph);
  delete lg;
  cudaGetLastError();  // the error is returned, not left pending
  return err;
}

extern "C" int graph_loop_launch(void* loop_graph, void* stream) {
  LoopGraph* lg = static_cast<LoopGraph*>(loop_graph);
  cudaError_t err =
      cudaGraphLaunch(lg->exec, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int graph_loop_destroy(void* loop_graph) {
  LoopGraph* lg = static_cast<LoopGraph*>(loop_graph);
  cudaError_t err = cudaSuccess;
  if (lg->exec) err = cudaGraphExecDestroy(lg->exec);
  if (lg->graph) {
    cudaError_t e2 = cudaGraphDestroy(lg->graph);
    if (err == cudaSuccess) err = e2;
  }
  delete lg;
  return err;
}

// The installed CUDA version and the runtime's (e.g. 12080), for the
// message when a WHILE node is refused.
extern "C" int graph_loop_versions(int* installed, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(installed);
  if (err != cudaSuccess) return err;
  return cudaRuntimeGetVersion(runtime);
}

extern "C" const char* graph_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
