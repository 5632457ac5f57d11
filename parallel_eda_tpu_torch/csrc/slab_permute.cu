// Halo moves for Hopper (sm_90a), bound to PyTorch through a plain C
// interface loaded with ctypes (route/shard_kernels.py).
//
// Replaces the TPU kernel remote_slab_permute
// (parallel_eda_tpu/route/planes_pallas.py:597, pallas_call :652) together
// with the install that followed it (parallel_eda_tpu/route/
// planes_shard.py:317-355): the non-wrapping one-hop shift of the dist
// halo columns between the column-block shards of the row-sharded
// relaxation, written straight into the receivers' halo columns.
//
// One launch executes a table of moves.  A move copies nseg rows of
// seg_len contiguous elements from a source (row stride src_stride) to a
// destination (row stride dst_stride), or writes `fill` where it has no
// source (the edge shard with no sender).  The elements of one launch are
// 4-byte (f32 dist) or 2-byte (the bf16 plane mode's dist): the kernel
// copies their bits, so the bf16 mode moves half the bytes.  Both sides are strided views of
// the shards' block canvases, so a sender's owned boundary columns go
// straight into its neighbour's halo columns: no receive buffer, no
// install copy.  blockIdx.y selects the move; the threads of a block row
// walk its elements grid-stride.
//
//   * all shards on one card: one launch per exchange covers every move
//     (four slabs per receiver, 4 * n_shards moves);
//   * shards on several cards: each card launches once for the moves it
//     sends (and the fills of its own edge halos), writing the receivers'
//     halo columns through peer pointers over NVLink (peer access enabled
//     once, slab_permute_enable_peer); the wrapper orders the launch after
//     the receivers' streams and the receivers after it with events (the
//     TPU kernel's semaphores).
//
// What bounds it on the H100: bytes, and at the route's slab sizes (a few
// to a few hundred KB per exchange) launch latency far more.  Each element
// is one read and one write; the copy is coalesced along each row.  The
// design's answer to latency is one launch per exchange, from argument
// tables the caller builds once per relaxation.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_MOVES 64          // 4 slabs x 16 shards
#define THREADS 256
#define MAX_BLOCKS 1024

namespace {

struct Move {
  const void* src;           // null: write `fill`
  void* dst;
  int src_stride, dst_stride, nseg, seg_len;   // in elements
  uint32_t fill;             // the fill element's bits (low 16: 2-byte)
  int pad;
};

struct MoveTable {
  Move m[MAX_MOVES];
};

// E: the element, as an unsigned integer of its width
template <class E>
__global__ void __launch_bounds__(THREADS) slab_permute_kernel(MoveTable t) {
  const Move& mv = t.m[blockIdx.y];
  const E* src = (const E*)mv.src;
  E* dst = (E*)mv.dst;
  const E fill = (E)mv.fill;
  const int n = mv.nseg * mv.seg_len;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const int row = k / mv.seg_len, col = k - row * mv.seg_len;
    dst[(long long)row * mv.dst_stride + col] =
        src ? src[(long long)row * mv.src_stride + col] : fill;
  }
}

}  // namespace

// tab: n_moves rows of 7 long longs
//   src ptr (0: fill), src row stride, dst ptr, dst row stride (elements),
//   nseg, seg_len, fill (the element's bits in the low 32 bits)
// elem_bytes: 4 or 2, for every move of the table.
// Launches on `stream` with card `device` current (restored after).
extern "C" int slab_permute_launch(const long long* tab, int n_moves,
                                   int elem_bytes, int device,
                                   void* stream) {
  if (n_moves < 1 || n_moves > MAX_MOVES) return (int)cudaErrorInvalidValue;
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  MoveTable t;
  memset(&t, 0, sizeof(t));
  long long most = 0;
  for (int i = 0; i < n_moves; ++i) {
    const long long* r = tab + 7 * i;
    const long long n = r[4] * r[5];
    if (r[1] < 0 || r[3] < 0 || r[1] > 0x7fffffffLL || r[3] > 0x7fffffffLL
        || r[4] < 0 || r[5] < 1 || n > 0x7fffffffLL || r[2] == 0)
      return (int)cudaErrorInvalidValue;
    Move& m = t.m[i];
    m.src = (const void*)(uintptr_t)r[0];
    m.dst = (void*)(uintptr_t)r[2];
    m.src_stride = (int)r[1];
    m.dst_stride = (int)r[3];
    m.nseg = (int)r[4];
    m.seg_len = (int)r[5];
    m.fill = (uint32_t)r[6];
    if (n > most) most = n;
  }
  if (most == 0) return 0;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (most + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  dim3 grid((unsigned)blocks, (unsigned)n_moves);
  if (elem_bytes == 4)
    slab_permute_kernel<uint32_t>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(t);
  else
    slab_permute_kernel<uint16_t>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(t);
  e = cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return (int)e;
}

extern "C" int slab_permute_max_moves() { return MAX_MOVES; }

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
