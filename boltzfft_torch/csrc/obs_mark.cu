// Device marks of boltzfft_torch.obs: one thread stamps a span's begin or
// end on the device clock, so that a span inside a CUDA graph is timed on
// every replay with no host synchronise.
//
// obs_mark_kernel reads %globaltimer (ns) and appends (code, ns) to a ring
// of `cap` int64 pairs through a device-wide atomic head: entry head % cap,
// so a ring that wraps keeps the newest marks and the host counts the lost
// ones from the head.  code = 2 * span id + (1 at the end).  A mark launched
// under stream capture is a kernel node of the graph; its arguments (the
// ring, the head, the code) are fixed in the node, and the ring lives as
// long as the process.
//
// bfft_capture_nodes counts the nodes of the graph being captured on a
// stream (cudaStreamGetCaptureInfo, then cudaGraphGetNodes): called last in
// a capture, that is the count the captured graph has.  bfft_graph_nodes
// counts a kept graph's nodes.  Both write -1 where there is nothing to
// count (a stream not capturing).
//
// The entry points return cudaGetLastError() of their launch or the status
// of their query; they do not synchronise and allocate nothing.

#include <cuda_runtime.h>

namespace {

__global__ void obs_mark_kernel(long long* ring, unsigned long long* head, int cap, int code) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long i = atomicAdd(head, 1ULL);
  long long* e = ring + 2 * (i % (unsigned long long)cap);
  e[0] = code;
  e[1] = (long long)t;
}

}  // namespace

extern "C" int bfft_obs_mark(void* ring, void* head, int cap, int code, void* stream) {
  obs_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (unsigned long long*)head, cap, code);
  return (int)cudaGetLastError();
}

extern "C" int bfft_graph_nodes(void* graph, void* out) {
  size_t n = 0;
  cudaError_t rc = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *(long long*)out = rc == cudaSuccess ? (long long)n : -1;
  return (int)rc;
}

extern "C" int bfft_capture_nodes(void* stream, void* out) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t rc = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph);
  long long n = -1;
  if (rc == cudaSuccess && status == cudaStreamCaptureStatusActive && graph != nullptr) {
    size_t k = 0;
    rc = cudaGraphGetNodes(graph, nullptr, &k);
    if (rc == cudaSuccess) n = (long long)k;
  }
  *(long long*)out = n;
  return (int)rc;
}
