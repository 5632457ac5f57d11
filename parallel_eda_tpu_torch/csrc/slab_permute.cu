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
// seg_len contiguous floats from a source (row stride src_stride) to a
// destination (row stride dst_stride), or writes `fill` where it has no
// source (the edge shard with no sender).  Both sides are strided views of
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
  const float* src;          // null: write `fill`
  float* dst;
  int src_stride, dst_stride, nseg, seg_len;
  float fill;
  int pad;
};

struct MoveTable {
  Move m[MAX_MOVES];
};

__global__ void __launch_bounds__(THREADS) slab_permute_kernel(MoveTable t) {
  const Move& mv = t.m[blockIdx.y];
  const int n = mv.nseg * mv.seg_len;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const int row = k / mv.seg_len, col = k - row * mv.seg_len;
    mv.dst[(long long)row * mv.dst_stride + col] =
        mv.src ? mv.src[(long long)row * mv.src_stride + col] : mv.fill;
  }
}

}  // namespace

// tab: n_moves rows of 7 long longs
//   src ptr (0: fill), src row stride, dst ptr, dst row stride (floats),
//   nseg, seg_len, fill (float bits in the low 32 bits)
// Launches on `stream` with card `device` current (restored after).
extern "C" int slab_permute_launch(const long long* tab, int n_moves,
                                   int device, void* stream) {
  if (n_moves < 1 || n_moves > MAX_MOVES) return (int)cudaErrorInvalidValue;
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
    m.src = (const float*)(uintptr_t)r[0];
    m.dst = (float*)(uintptr_t)r[2];
    m.src_stride = (int)r[1];
    m.dst_stride = (int)r[3];
    m.nseg = (int)r[4];
    m.seg_len = (int)r[5];
    const uint32_t bits = (uint32_t)r[6];
    memcpy(&m.fill, &bits, sizeof(float));
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
  slab_permute_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(t);
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
