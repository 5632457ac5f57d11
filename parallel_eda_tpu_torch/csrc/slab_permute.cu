// Halo-slab neighbour shift for Hopper (sm_90a), bound to PyTorch through a
// plain C interface loaded with ctypes (route/shard_kernels.py).
//
// Replaces the TPU kernel remote_slab_permute
// (parallel_eda_tpu/route/planes_pallas.py:597, pallas_call :652): the
// non-wrapping one-hop shift of a dist halo slab between the column-block
// shards of the row-sharded relaxation.  fwd: shard i -> i+1; bwd: shard
// i -> i-1; the edge shard with no sender receives zeros.
//
// A sender's slab is a strided view of its block's dist canvas: nseg rows
// (B * W) of seg_len contiguous floats (1 or 2 canvas columns of Y cells)
// with src_stride floats between rows.  Receivers get contiguous buffers
// [B, W, cols, Y].  One thread block row (blockIdx.y) serves one receiver
// r = r0 + blockIdx.y; its threads copy its sender's slab grid-stride, or
// write zeros where it has no sender.
//
//   * all shards on one card: one launch, grid.y = n_shards, covers every
//     receiver (the TPU kernel's per-device instances side by side);
//   * shards on several cards: the sending card launches (grid.y = 1) and
//     writes the receiver's buffer through a peer pointer over NVLink
//     (peer access enabled once, slab_permute_enable_peer); the wrapper
//     records an event on the sender's stream that the receiver's stream
//     waits on — the TPU kernel's receive semaphore.
//
// What bounds it on the H100: bytes, and at the route's slab sizes
// (~20 KB) launch latency far more.  A slab is one read and one write
// of each element; the copy is coalesced along each row (neighbouring
// threads on neighbouring addresses).

#include <cuda_runtime.h>

#define MAX_SHARDS 16

namespace {

struct SlabArgs {
  const float* src[MAX_SHARDS];      // sender slab of shard i (strided)
  float* dst[MAX_SHARDS];            // receive buffer of shard i
  long long nseg, seg_len, src_stride;
  int n_shards, fwd, r0;
};

__global__ void slab_permute_kernel(SlabArgs a) {
  const int r = a.r0 + blockIdx.y;
  const int snd = a.fwd ? r - 1 : r + 1;
  const bool has = snd >= 0 && snd < a.n_shards;
  const float* s = has ? a.src[snd] : nullptr;
  float* d = a.dst[r];
  const long long n = a.nseg * a.seg_len;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const long long row = k / a.seg_len, col = k - row * a.seg_len;
    d[k] = has ? s[row * a.src_stride + col] : 0.0f;
  }
}

}  // namespace

// p: src[0..n), dst[0..n) (n = n_shards pointers each; unused entries 0);
// v: nseg, seg_len, src_stride, n_shards, fwd, r0, n_recv, threads, blocks
extern "C" int slab_permute_launch(const void* const* p, const long long* v,
                                   void* stream) {
  const int n = (int)v[3], n_recv = (int)v[6];
  if (n < 2 || n > MAX_SHARDS || v[5] < 0 || v[5] + n_recv > n)
    return (int)cudaErrorInvalidValue;
  SlabArgs a;
  for (int i = 0; i < MAX_SHARDS; ++i) {
    a.src[i] = i < n ? (const float*)p[i] : nullptr;
    a.dst[i] = i < n ? (float*)p[n + i] : nullptr;
  }
  a.nseg = v[0]; a.seg_len = v[1]; a.src_stride = v[2];
  a.n_shards = n; a.fwd = (int)v[4]; a.r0 = (int)v[5];
  if (a.nseg * a.seg_len == 0) return 0;
  dim3 grid((unsigned)v[8], (unsigned)n_recv);
  slab_permute_kernel<<<grid, (unsigned)v[7], 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Enable peer access between every pair of the given cards (once per
// process).  An already enabled pair is not an error.  Returns a CUDA error
// code, or cudaErrorPeerAccessUnsupported when a pair cannot reach each
// other; restores the calling thread's current device.
extern "C" int slab_permute_enable_peer(const int* devs, int n) {
  int cur = 0;
  cudaGetDevice(&cur);
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i) {
    for (int j = 0; j < n && rc == 0; ++j) {
      if (devs[i] == devs[j]) continue;
      int ok = 0;
      rc = (int)cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]);
      if (rc != 0) break;
      if (!ok) { rc = (int)cudaErrorPeerAccessUnsupported; break; }
      rc = (int)cudaSetDevice(devs[i]);
      if (rc != 0) break;
      cudaError_t e = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();            // clear the sticky-free status
        e = cudaSuccess;
      }
      rc = (int)e;
    }
  }
  cudaSetDevice(cur);
  return rc;
}
