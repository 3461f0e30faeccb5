// The steps of a solve loop's chunk as one executable CUDA graph that stops
// at the loop's verdict: the steps after the first are the body of a WHILE
// conditional node (CUDA >= 12.4).
//
// This is the device half of the port's counterpart of the reference's
// lax.while_loop (its cond at simplex_tpu/ops/tableau.py:238-241 and the
// conds of the other loops): once a step leaves its flag false, no further
// kernel runs.  runtime/graphs.py captures a chunk as an ordered list of
// parts, each one torch CUDA graph: the stretches of the chunk outside any
// step, the first step, and one more step.  graph_chain_build chains them
// in their order.  A part with a flag is a loop: it goes inside a WHILE
// node that runs it while the flag (a 0-d bool on the device, written by
// each step) is true and the step count (a 0-d int64 on the device,
// raised by each step) is below the chunk's length.  A one-thread kernel
// sets the node's condition before the node and again at the end of each
// pass.  A part with no node is left out.  The host reads nothing.
//
// The parts are cloned into the chain (child graph nodes), so the caller
// may destroy them; the memory they address (torch's graph pool) must
// outlive the chain.  Every entry point returns a cudaError_t.
//
// graph_stream_create makes the streams runtime/graphs.py warms up and
// captures on: its own, outside torch's pool of streams, which hands every
// caller the same 32 a device in turn.
//
// graph_node_counts lists what a captured part holds, by node type: a
// conditional node's body takes only some types (kernels, memsets,
// memcopies, empty, child graph and conditional nodes), so a part with,
// say, an event or host node cannot be a loop's body.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag, const int64_t* count,
                              int64_t limit) {
  cudaGraphSetConditional(handle, (*flag && *count < limit) ? 1u : 0u);
}

// Adds the kernel node that sets `handle` from the loop's flag and count,
// after `deps`.
cudaError_t add_set(cudaGraphNode_t* node, cudaGraph_t graph,
                    const cudaGraphNode_t* deps, size_t n_deps,
                    cudaGraphConditionalHandle handle, const bool* flag,
                    const int64_t* count, int64_t limit) {
  void* args[] = {&handle, &flag, &count, &limit};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

// Appends one part after *last (none when *last is null).
cudaError_t append(cudaGraph_t chain, cudaGraphNode_t* last,
                   cudaGraph_t part, const bool* flag, const int64_t* count,
                   int64_t limit) {
  size_t nodes = 0;
  cudaError_t err = cudaGraphGetNodes(part, nullptr, &nodes);
  if (err != cudaSuccess || nodes == 0) return err;
  const size_t n_deps = *last ? 1 : 0;
  cudaGraphNode_t node;
  if (flag == nullptr) {
    err = cudaGraphAddChildGraphNode(&node, chain, last, n_deps, part);
    *last = node;
    return err;
  }

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, chain, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t set;
  err = add_set(&set, chain, last, n_deps, handle, flag, count, limit);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  err = cudaGraphAddNode(last, chain, &set, 1, &cp);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&node, body, nullptr, 0, part);
  if (err != cudaSuccess) return err;
  return add_set(&set, body, &node, 1, handle, flag, count, limit);
}

// Adds the nodes of `graph` to counts[type], recursing into child graphs.
cudaError_t count_nodes(cudaGraph_t graph, int64_t n_types, int64_t* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    if (static_cast<int64_t>(type) < n_types) ++counts[type];
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_nodes(child, n_types, counts);
    }
  }
  return err;
}

}  // namespace

// parts[i] is a cudaGraph_t.  flags[i] is 0 for a part that runs once, or
// the device address of the loop's 0-d bool flag, with counts[i] that of
// its 0-d int64 step count and limits[i] the chunk's length.  Instantiates
// the chain, uploads it on `stream` and writes the executable graph to
// *exec_out.
extern "C" int graph_chain_build(int64_t n, const uint64_t* parts,
                                 const uint64_t* flags,
                                 const uint64_t* counts,
                                 const int64_t* limits, void** exec_out,
                                 void* stream) {
  cudaGraph_t chain;
  cudaError_t err = cudaGraphCreate(&chain, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t last = nullptr;
  for (int64_t i = 0; i < n && err == cudaSuccess; ++i)
    err = append(chain, &last, reinterpret_cast<cudaGraph_t>(parts[i]),
                 reinterpret_cast<const bool*>(flags[i]),
                 reinterpret_cast<const int64_t*>(counts[i]), limits[i]);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, chain, 0);
  if (err == cudaSuccess)
    err = cudaGraphUpload(exec, static_cast<cudaStream_t>(stream));
  cudaGraphDestroy(chain);
  if (err != cudaSuccess) {
    if (exec != nullptr) cudaGraphExecDestroy(exec);
    return err;
  }
  *exec_out = exec;
  return cudaSuccess;
}

extern "C" int graph_chain_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

// Waits for `stream` (the chain's last launch), then frees the chain.
extern "C" int graph_chain_destroy(void* exec, void* stream) {
  cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  cudaError_t err2 = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  return err != cudaSuccess ? err : err2;
}

// Makes a stream on the current device that does not wait for the legacy
// default stream (work that other threads enqueue there must not join a
// capture on it), and writes it to *stream_out.  The caller keeps it for
// the process's life.
extern "C" int graph_stream_create(void** stream_out) {
  cudaStream_t stream = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  *stream_out = stream;
  return err;
}

// Counts the nodes of the cudaGraph_t `graph` by cudaGraphNodeType into
// counts[0 .. n_types) (zeroed first), the nodes of child graphs included.
extern "C" int graph_node_counts(uint64_t graph, int64_t n_types,
                                 int64_t* counts) {
  for (int64_t t = 0; t < n_types; ++t) counts[t] = 0;
  return count_nodes(reinterpret_cast<cudaGraph_t>(graph), n_types, counts);
}
