// CUDA graphs of a driver's launch chain (ops/graph.py): capture the
// launches a driver call makes, hand each kernel node's argument block to
// Python, which finds the words that point into the call's buffers, and
// on a later call of the same signature write the call's buffer addresses
// into those words and launch the whole graph with one call.
//
// A node's argument block is its kernel's parameters laid out at the
// offsets the driver gives (cuFuncGetParamInfo), as the kernel reads them.
// A patch is one 8-byte word of a block: (node, byte offset, buffer,
// delta), written as the buffer's base plus delta.
//
// Host code only: no kernel here.
#include <cstdint>
#include <cstring>
#include <vector>
#include <dlfcn.h>
#include <cuda_runtime.h>

namespace {

// Statuses of the graph entries that are not CUDA errors (ops/graph.py
// mirrors them).
constexpr int CAPTURING = -1;   // the stream is being captured: run the chain
constexpr int MISALIGNED = -2;  // a buffer's address differs mod 16
constexpr int NOT_KERNEL = -3;  // the capture holds a node other than a kernel
constexpr int NO_PARAMS = -4;   // the driver gives no parameter layout

// cuFuncGetParamInfo (CUDA 12.4 drivers on), found in the driver library
// that the runtime has loaded; null where the driver lacks it.
using ParamInfo = int (*)(void* fn, size_t index, size_t* offset, size_t* size);

ParamInfo param_info() {
  static const ParamInfo fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<ParamInfo>(dlsym(lib, "cuFuncGetParamInfo"));
  }();
  return fn;
}

struct Node {
  cudaGraphNode_t node;
  cudaKernelNodeParams params;  // kernelParams points into `ptrs`
  std::vector<unsigned char> block;
  std::vector<void*> ptrs;      // each parameter's place in `block`
  int first = 0, count = 0;     // this node's patches
};

struct Patch {
  int64_t node, offset, buffer, delta;
};

struct Graph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaEvent_t done = nullptr;  // recorded after every launch
  std::vector<Node> nodes;
  std::vector<Patch> patches;
  std::vector<uint64_t> bases;  // the addresses the blocks hold now
  bool stale = false;           // a failed update left the blocks unsure
};

int status(cudaError_t e) { return static_cast<int>(e); }

// Read a kernel node's parameters into its block.
int read_node(Node& n) {
  cudaError_t e = cudaGraphKernelNodeGetParams(n.node, &n.params);
  if (e != cudaSuccess) return status(e);
  const ParamInfo info = param_info();
  if (info == nullptr) return NO_PARAMS;
  cudaFunction_t fn = nullptr;
  e = cudaGetFuncBySymbol(&fn, n.params.func);
  if (e != cudaSuccess) return status(e);
  std::vector<size_t> offs, sizes;
  size_t end = 0;
  for (size_t i = 0;; ++i) {
    size_t off = 0, size = 0;
    if (info(fn, i, &off, &size) != 0) break;
    offs.push_back(off);
    sizes.push_back(size);
    end = off + size > end ? off + size : end;
  }
  if (n.params.kernelParams == nullptr && !offs.empty()) return NO_PARAMS;
  n.block.assign(end, 0);
  n.ptrs.resize(offs.size());
  for (size_t i = 0; i < offs.size(); ++i) {
    std::memcpy(n.block.data() + offs[i], n.params.kernelParams[i], sizes[i]);
    n.ptrs[i] = n.block.data() + offs[i];
  }
  n.params.kernelParams = n.ptrs.data();
  n.params.extra = nullptr;
  return 0;
}

}  // namespace

extern "C" {

// Start capturing the launches made on `stream` from this thread.
int wtt_graph_begin(void* stream) {
  return status(cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                       cudaStreamCaptureModeThreadLocal));
}

// End the capture on `stream`.  *handle: the captured graph with each
// node's argument block read (free it with wtt_graph_free), or null;
// *nodes: its node count.  A node other than a kernel, or a kernel whose
// parameters the driver cannot lay out, refuses the capture.
int wtt_graph_end(void* stream, void** handle, int* nodes) {
  *handle = nullptr;
  *nodes = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (e != cudaSuccess) {
    if (graph != nullptr) cudaGraphDestroy(graph);
    return status(e);
  }
  auto* g = new Graph;
  g->graph = graph;
  size_t count = 0;
  e = cudaGraphGetNodes(graph, nullptr, &count);
  std::vector<cudaGraphNode_t> found(count);
  if (e == cudaSuccess && count) e = cudaGraphGetNodes(graph, found.data(), &count);
  int st = status(e);
  g->nodes.resize(count);
  for (size_t i = 0; st == 0 && i < count; ++i) {
    cudaGraphNodeType type;
    st = status(cudaGraphNodeGetType(found[i], &type));
    if (st == 0 && type != cudaGraphNodeTypeKernel) st = NOT_KERNEL;
    g->nodes[i].node = found[i];
    if (st == 0) st = read_node(g->nodes[i]);
  }
  if (st != 0) {
    cudaGraphDestroy(graph);
    delete g;
    return st;
  }
  *handle = g;
  *nodes = static_cast<int>(count);
  return 0;
}

// Copy node `node`'s argument block into `out` (at most `cap` bytes);
// returns its size in bytes, or -1 for a node that is not there.
int wtt_graph_block(void* handle, int node, void* out, int64_t cap) {
  auto* g = static_cast<Graph*>(handle);
  if (node < 0 || node >= static_cast<int>(g->nodes.size())) return -1;
  const std::vector<unsigned char>& b = g->nodes[node].block;
  if (static_cast<int64_t>(b.size()) <= cap) std::memcpy(out, b.data(), b.size());
  return static_cast<int>(b.size());
}

// out[i] = 1 where words[i] is the address of device (or managed) memory.
int wtt_device_pointers(const uint64_t* words, int n, unsigned char* out) {
  for (int i = 0; i < n; ++i) {
    cudaPointerAttributes a;
    const cudaError_t e =
        cudaPointerGetAttributes(&a, reinterpret_cast<const void*>(words[i]));
    out[i] = e == cudaSuccess &&
             (a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged);
    if (e != cudaSuccess) cudaGetLastError();  // not a pointer the runtime knows
  }
  return 0;
}

// Instantiate the captured graph with its patch table: `patches` rows of
// (node, offset, buffer, delta), sorted by node, and the `nbases`
// buffer addresses the blocks hold now.
int wtt_graph_instantiate(void* handle, const int64_t* patches, int npatches,
                          const uint64_t* bases, int nbases) {
  auto* g = static_cast<Graph*>(handle);
  for (int i = 0; i < npatches; ++i) {
    const Patch p{patches[4 * i], patches[4 * i + 1], patches[4 * i + 2],
                  patches[4 * i + 3]};
    if (p.node < 0 || p.node >= static_cast<int64_t>(g->nodes.size()) ||
        p.buffer < 0 || p.buffer >= nbases || p.offset < 0 ||
        p.offset + 8 > static_cast<int64_t>(g->nodes[p.node].block.size()) ||
        (i && p.node < g->patches.back().node))
      return status(cudaErrorInvalidValue);
    Node& n = g->nodes[p.node];
    if (!n.count) n.first = i;
    ++n.count;
    g->patches.push_back(p);
  }
  g->bases.assign(bases, bases + nbases);
  cudaError_t e = cudaGraphInstantiate(&g->exec, g->graph, 0);
  if (e == cudaSuccess) e = cudaEventCreateWithFlags(&g->done, cudaEventDisableTiming);
  return status(e);
}

// Launch the graph on `stream` for buffers at `bases` (as many as at
// instantiation).  The words of every node that reads a moved buffer are
// rewritten and handed to cudaGraphExecKernelNodeSetParams, which applies
// to the launches that follow it and not to those already enqueued: so
// the jobs in flight keep the addresses they were launched with.  A
// stream under capture (CAPTURING) or a buffer whose address differs mod
// 16 from the captured one (MISALIGNED: the kernels chose their staging
// path from it) launches nothing.
int wtt_graph_replay(void* handle, const uint64_t* bases, void* stream) {
  auto* g = static_cast<Graph*>(handle);
  auto s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  cudaError_t e = cudaStreamIsCapturing(s, &capturing);
  if (e != cudaSuccess) return status(e);
  if (capturing != cudaStreamCaptureStatusNone) return CAPTURING;
  const size_t nb = g->bases.size();
  for (size_t b = 0; b < nb; ++b)
    if ((bases[b] ^ g->bases[b]) & 15) return MISALIGNED;
  for (Node& n : g->nodes) {
    bool moved = false;
    for (int i = n.first; i < n.first + n.count; ++i) {
      const Patch& p = g->patches[i];
      if (!g->stale && bases[p.buffer] == g->bases[p.buffer]) continue;
      const uint64_t word = bases[p.buffer] + static_cast<uint64_t>(p.delta);
      std::memcpy(n.block.data() + p.offset, &word, sizeof word);
      moved = true;
    }
    if (moved) {
      e = cudaGraphExecKernelNodeSetParams(g->exec, n.node, &n.params);
      if (e != cudaSuccess) {
        g->stale = true;  // the next call rewrites every node
        return status(e);
      }
    }
  }
  std::memcpy(g->bases.data(), bases, nb * sizeof(uint64_t));
  g->stale = false;
  e = cudaGraphLaunch(g->exec, s);
  if (e == cudaSuccess) e = cudaEventRecord(g->done, s);
  return status(e);
}

// Free the graph once its last launch has completed: returns 1 (and frees
// nothing) while it may still run, else 0.
int wtt_graph_free(void* handle) {
  auto* g = static_cast<Graph*>(handle);
  if (g->done != nullptr && cudaEventQuery(g->done) == cudaErrorNotReady) return 1;
  cudaGetLastError();
  if (g->done != nullptr) cudaEventDestroy(g->done);
  if (g->exec != nullptr) cudaGraphExecDestroy(g->exec);
  cudaGraphDestroy(g->graph);
  delete g;
  return 0;
}

// End a capture that failed part way, dropping what it recorded.
int wtt_graph_abort(void* stream) {
  cudaGraph_t graph = nullptr;
  const cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaGetLastError();
  return status(e);
}

}  // extern "C"
