// Planes relaxation kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface loaded with ctypes (route/planes_kernels.py).
//
// Replaces the two TPU kernels of parallel_eda_tpu/route/planes_pallas.py:
//   planes_relax_full_kernel    <- planes_relax_pallas / _sweep_kernel
//                                  (planes_pallas.py:308 / :218, call :389)
//   planes_relax_cropped_kernel <- planes_relax_cropped_pallas /
//                                  _crop_sweep_kernel (:477 / :417, call :571)
// and serves the row-sharded relaxation (parallel_eda_tpu/route/
// planes_shard.py planes_relax_sharded, its sweep at :369, where the TPU
// runs K2's kernel once per shard per sweep and remote_slab_permute,
// planes_pallas.py:597, between sweeps) in two forms:
//   planes_relax_block_kernel   one sweep of each shard's column block
//                               (planes_sweep_block_launch): pred carried
//                               in (p0x/p0y), block geometry shared across
//                               nets (stride 0), the change flag restricted
//                               to the owned local x columns, so that
//                               stats[b, 1] is net b's owned-changed flag;
//                               the per-sweep loop across cards and under
//                               the lag-2 schedule;
//   planes_relax_cluster_kernel the whole lag-1 relaxation of every shard
//                               on one card in one launch: net b is a
//                               thread-block cluster of s CTAs, CTA r holds
//                               shard r's column block, and the dist halo
//                               columns move between neighbouring CTAs'
//                               shared memory every sweep.
//
// What they compute: the bounded planes relaxation of one net per thread
// block (per cluster), to the exact fixpoint or `nsweeps` sweeps.  One
// sweep is
//   x-scans forward then backward    (lines (track, row) along x)
//   turn into y                      (one thread per target chany cell)
//   y-scans forward then backward    (lines (track, col) along y)
//   turn into x                      (one thread per target chanx cell)
// with a block barrier between the phases.  The fixpoint test is
// __syncthreads_or of "some distance improved" (updates are strict
// improvements of a monotone state, so it is exact), so a whole
// relaxation is one launch with no host sync per sweep.  Each block
// writes its own [executed, useful] sweep counts; the wrapper takes the
// max over nets, which equals the batch-level counts of the JAX
// while_loop because sweeps after a net's fixpoint are identities.
//
// How each kernel addresses its net (Kind below; the sweep body is one):
//   FULL    the net's [B, ncells] rows; ids and parity from position.
//   TILE    K2: the FULL flats and the shared geometry, read at the net's
//           origin (ox[b], oy[b]), clamped here as lax.dynamic_slice
//           clamps (one range serves every plane and array); ids
//           (t*NX + ox+x)*(NY+1) + oy+y and parity (ox+x + oy+y) & 1 from
//           coordinates.  The block first writes its net's whole output
//           row as d0 / own id / wenter0, then relaxes the tile on top:
//           no crop, no scatter and no per-net geometry copy outside it.
//   BLOCK   per-shard block tensors; ids and parity from the block
//           geometry's arrays.
//   CLUSTER the block geometry of shard r (stacked, stride g_sx per rank;
//           ids and parity from the padded position, as _geom_blocks
//           makes them) with the FULL flats read at padded columns
//           r*kx .. r*kx+kx+ext
//           (pad columns: dist and congestion INF, wenter 0, as
//           planes_shard.shard_blocks fills them); each CTA writes its
//           owned real columns straight into the output flats.  Per
//           sweep: cluster barrier, dist halo columns copied from the
//           neighbours' shared memory (map_shared_rank; INF at the edge
//           shards), cluster barrier, one sweep, then the OR of the CTAs'
//           owned-change flags through rank-indexed shared flags.  A net
//           stops at its first sweep with no owned change: its later
//           sweeps in the batch-wide loop would be identities on every
//           returned value (owned dist unchanged, halos re-copied from
//           unchanged columns; pred and wenter move only on a strict
//           improvement), so per-net termination is exact and the
//           batch's counts are the max over nets, as for FULL.
//
// Design (what bounds the kernel, and what the design does about it).
// A relaxation is a chain of dependent sweeps, each a chain of four
// phases over one net's few-KB-to-200-KB state, on one SM: it is bound by
// the latency of those chains, not by bytes or operations (PERF.md: K1
// runs tens of times its bound).  So:
//   * the net's state lives in dynamic shared memory for the whole launch,
//     as much of it as fits the block's opt-in limit (the mode, picked per
//     launch): 2 dist and the per-cell scan cost crit*delay + cc (computed
//     once: the same f32 bits as every sweep); 1 dist; 0 nothing (a canvas
//     whose dist does not fit; no size up to the MAXL line limit loses the
//     kernel).  pred and wenter are only written, on a strict improvement,
//     and stay in global memory; the geometry and congestion are read
//     through the read-only path;
//   * each min-plus line scan runs in parallel on a group of G lanes of
//     one warp (line_lanes: G = the power of two >= len / 8, at least 2;
//     32 / G lines per warp at once), level by level through
//     lax.associative_scan's odd/even tree in shared scratch, with
//     __syncwarp between levels.  The forward and the backward scan of a
//     line run on the same lanes, so they need no block barrier between
//     them.  Each line's scratch is padded to an odd length so that the
//     lines of a warp start in different banks;
//   * 512-1024 threads per block; the fixpoint flag is __syncthreads_or;
//   * the work around the sweeps stays in the launch: K2 reads and writes
//     the full flats itself, and the sharded relaxation on one card is one
//     cluster launch (no host loop, no per-sweep launches or host reads).
// What bounds it now (PERF.md): latency.  The two scan phases take most of
// a sweep's cycles, the turn stencils the rest; each scan step is a few
// dependent shared-memory round trips and a __syncwarp.  One net per block
// fills B of 132 SMs.

// Bit-exactness with the plain PyTorch version (and the JAX package):
//   * the scan's tree is laid out in place: up level k combines positions
//     ((2i+1)2^k - 1, (2i+2)2^k - 1) into the second, down level k combines
//     (2i 2^k - 1, (2i+1)2^k - 1) into the second, for i >= 1 — exactly the
//     operand pairs, in the same operand order, of lax.associative_scan's
//     pairwise reduce / recurse / fill-the-evens (planes.py _assoc_scan);
//     the grouping, not the parallelism, fixes the f32 bits;
//   * every add/multiply is an explicit __fadd_rn/__fmul_rn (and the build
//     passes -fmad=false), so crit*delay + cc is computed as the plain
//     version computes it: no FMA contraction;
//   * the turn candidates are folded in the plain version's order with a
//     strict `<`, so ties keep the same predecessor.
//
// The bf16 plane mode (template flag Q; planes_relax_pallas's
// plane_dtype="bf16", the plain version's _run_relax): dist and wenter are
// carried in bfloat16 BETWEEN sweeps while every sweep runs in f32, as the
// TPU kernel does.  The congestion input is rounded once through bfloat16
// where it is read, the entry dist and wenter once at load; a sweep runs
// on f32 working state and ends with one rounding pass (round to nearest
// even, __float2bfloat16_rn): dx inside the turn into x, its last writer,
// dy after the barrier that follows it; every wenter is rounded where it
// is written.  Rounding between the phases of a sweep would change bits.
// The fixpoint test compares the rounded end-of-sweep dist with the
// rounded sweep-entry dist E.  A cell's values within a sweep form a
// strictly decreasing chain E = v0 > v1 > ... > vk, and rounding is
// monotone, so round(vk) < E exactly when some write has round(v_j) <
// round(v_j-1): each improving write compares the two roundings, and no
// copy of E is kept (no extra memory; the shared-memory modes are the
// f32 ones).  Per-net termination stays exact: a sweep whose rounded dist
// equals its entry dist makes the same f32 improvements as the next sweep
// would (they depend on dist alone), so later sweeps are identities on
// dist, pred and wenter.  Global I/O: K1, K2 and the cluster kernel read
// and write the f32 [B, ncells] flats (the bf16 values as f32: 4 bytes a
// cell, the route's tensors, no conversion launch); the step kernel
// (BLOCK) reads and writes bfloat16 dist, wenter and congestion blocks, 2
// bytes a cell, so that the halo exchange between its sweeps moves 2-byte
// elements; in its mode 0 the f32 working dist is the workspace `ws`.
//
// K2's origins: each array is cut where lax.dynamic_slice cuts it, a
// negative origin wrapping once by THAT array's extent before the clamp,
// so the chanx family (x extent NX, y extent NY+1) and the chany family
// (NX+1, NY) can land one apart; the corner parity [NX+1, NY+1] takes the
// chany family's x origin and the chanx family's y origin.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAXL 64            // longest scan line (grid side) the kernels take
#define MAX_THREADS 1024
#define MAX_DEVICES 64
#define MAX_CLUSTER 16     // the H100's non-portable cluster size
#define PORTABLE_CLUSTER 8

namespace {

enum Kind { FULL = 0, BLOCK = 1, TILE = 2, CLUSTER = 3 };

struct Args {
  // inputs (per-net strides in_sx / in_sy, in elements); the plane arrays
  // (dist, congestion, wenter) are float, or bfloat16 for BLOCK in the
  // bf16 plane mode (Net::T)
  const void* d0x; const void* d0y;
  const void* ccx; const void* ccy;
  const void* w0x; const void* w0y;
  const float* crit;                 // [B]
  // state / outputs (per-net strides st_sx / st_sy)
  void* dx; void* dy;
  int32_t* px; int32_t* py;
  void* wx; void* wy;
  int32_t* stats;                    // [B, 2]
  int32_t* total;                    // [2]: max over nets (null: none)
  // geometry (per-net, or per-rank for CLUSTER, strides g_sx / g_sy /
  // g_sp; 0 = shared)
  const uint8_t* brk_before_x; const uint8_t* brk_after_x;
  const uint8_t* first_x; const uint8_t* last_x;
  const uint8_t* brk_before_y; const uint8_t* brk_after_y;
  const uint8_t* first_y; const uint8_t* last_y;
  const float* delay_x; const float* delay_y;
  const float* delay_y_rot0; const float* delay_y_rot1;
  const uint8_t* inc_track;          // [W] (directional only)
  const int32_t* idxx; const int32_t* idxy;   // BLOCK
  const int32_t* base_par;                    // BLOCK [X+1, Y+1]
  const int32_t* p0x; const int32_t* p0y;     // pred in (null: own ids)
  const int32_t* ox; const int32_t* oy;       // TILE: origins [B]
  float* ws;            // mode 0, CLUSTER and bf16 BLOCK: f32 dist blocks
  int W, X, Y;                       // x plane [W, X, Y+1]; y plane [W, X+1, Y]
  int stride_x;                      // global NY+1
  int NX;                            // global NX (TILE, CLUSTER)
  int ncx;                           // global chanx cells (TILE ids)
  int nc;                            // global cells per net (TILE row)
  int directional;
  int nsweeps;
  long long in_sx, in_sy, st_sx, st_sy, g_sx, g_sy, g_sp;
  int own_lo, own_hi;                // local x columns the change flag covers
  int cost_smem;                     // scan costs precomputed in shared
  int ox_hi, oy_hi;                  // TILE: largest origin
  int shards, kx;                    // CLUSTER: CTAs per net, owned columns
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}

// the bf16 plane mode's rounding: f32 -> bfloat16 (nearest even) -> f32
__device__ __forceinline__ float rnd16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// plane storage: float, or bfloat16 (BLOCK in the bf16 plane mode)
template <bool H> struct Plane { using T = float; };
template <> struct Plane<true> { using T = __nv_bfloat16; };

// read-only loads and stores of a plane element, as f32
__device__ __forceinline__ float ldp(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldp(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void stp(float* p, float v) { *p = v; }
__device__ __forceinline__ void stp(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K2: an origin placed as lax.dynamic_slice places a start into an axis of
// `extent` cells: a negative one wraps once, then it is clamped
__device__ __forceinline__ int place_origin(int o, int extent, int hi) {
  if (o < 0) o += extent;
  return min(max(o, 0), hi);
}

// one combine of the min-plus pair scan:
// (ca, ma) . (cb, mb) = (ca + cb, min(ma + cb, mb))
__device__ __forceinline__ void comb(float ca, float ma, float cb, float mb,
                                     float* c, float* m) {
  *c = fadd(ca, cb);
  *m = fminf(fadd(ma, cb), mb);
}

// In-place inclusive min-plus scan of (c, m)[0:n] in lax.associative_scan's
// combine order, on the G lanes q = 0..G-1 of a lane group (lane q takes
// every G-th combine of a level).  Every lane of the warp calls it with
// the same n (inactive groups with act = false) for the __syncwarp.
__device__ __forceinline__ void warp_scan(float* c, float* m, int n, int q,
                                          int G, bool act) {
  int span = 1;
  for (; 2 * span <= n; span *= 2) {           // pairwise reduce
    const int cnt = n / (2 * span);
    if (act)
      for (int i = q; i < cnt; i += G) {
        const int lo = (2 * i + 1) * span - 1, hi = lo + span;
        comb(c[lo], m[lo], c[hi], m[hi], &c[hi], &m[hi]);
      }
    __syncwarp();
  }
  for (span /= 2; span >= 1; span /= 2) {      // evens <- prefix . elem
    const int cnt = (n / span - 1) / 2;
    if (act)
      for (int i = q + 1; i <= cnt; i += G) {
        const int hi = (2 * i + 1) * span - 1, lo = 2 * i * span - 1;
        comb(c[lo], m[lo], c[hi], m[hi], &c[hi], &m[hi]);
      }
    __syncwarp();
  }
}

// The lanes that scan a line of n cells: the power of two >= n / 8, at
// least 2 (PERF.md has the rules measured against it).  It stays a
// run-time value: a constant count lets the compiler unroll the scan loops
// into spills.
__host__ __device__ __forceinline__ int line_lanes(int n) {
  int G = 2;
  while (G * 8 < n && G < 32) G *= 2;
  return G;
}

// Scan scratch of one line: (c, m) of the longest line and one float of
// padding, so that the lines of a warp start in different banks.
__host__ __device__ __forceinline__ int line_scratch(int X, int Y) {
  return 2 * (X > Y ? X : Y) + 1;
}

// Scan scratch floats per warp: one line's for each of the lines a warp
// scans at once (most on the plane of shorter lines).
__host__ __device__ __forceinline__ int scratch_per_warp(int X, int Y) {
  return line_scratch(X, Y) * (32 / line_lanes(X < Y ? X : Y));
}

// Per-net views of what a sweep reads besides dist: the geometry (flags,
// switch delays, parity, track directions) and the congestion, in global
// memory, offset to the net's own rows.
struct Geo {
  const uint8_t *bbx, *bax, *fsx, *lsx;      // x plane: brk before / after,
  const uint8_t *bby, *bay, *fsy, *lsy;      //   first, last; y plane
  const float *dlx, *dly, *rot0, *rot1;      // delays
  const int32_t* par;                        // BLOCK: [X+1, Y+1]
  const uint8_t* inc;                        // [W] (directional only)
};

// One net's addressing.  A cell is named by its local coordinates (t, x,
// y) on the net's own planes (the canvas, the tile or the shard's block);
// lx / ly index the state in shared memory (or the block), ix / iy the
// net's input and output rows, gx / gy the geometry.  Q: the bf16 plane
// mode; T: the plane arrays' element type.
template <int K, bool SMEM, bool Q>
struct Net {
  using T = typename Plane<K == BLOCK && Q>::T;
  // the inputs and outputs are the full [B, ncells] flats
  static constexpr bool FLATS = K == TILE || K == CLUSTER;
  const Args& a;
  int b, r;
  float crit;
  long long ix0, iy0, sx0, sy0, gx0, gy0;
  // origins of the chanx planes (ox, oy) and of the chany planes (ox2,
  // oy2): TILE the placed origins; CLUSTER ox = ox2 = r*kx - 1, oy = 0
  int ox, oy, ox2, oy2;
  // the net's rows of the plane arrays: inputs, congestion, outputs
  const T *d0x, *d0y, *w0x, *w0y, *ccxp, *ccyp;
  T *odx, *ody, *owx, *owy;
  Geo g;

  __device__ Net(const Args& a_, int b_, int r_) : a(a_), b(b_), r(r_) {
    crit = a.crit[b];
    ix0 = (long long)b * a.in_sx;
    iy0 = (long long)b * a.in_sy;
    sx0 = (long long)b * a.st_sx;
    sy0 = (long long)b * a.st_sy;
    const long long gi = K == CLUSTER ? r : b;
    gx0 = gi * a.g_sx;
    gy0 = gi * a.g_sy;
    ox = oy = 0;
    if (K == TILE) {
      const int o = __ldg(a.ox + b), p = __ldg(a.oy + b);
      ox = place_origin(o, a.NX, a.ox_hi);
      ox2 = place_origin(o, a.NX + 1, a.ox_hi);
      oy = place_origin(p, a.stride_x, a.oy_hi);
      oy2 = place_origin(p, a.stride_x - 1, a.oy_hi);
    } else if (K == CLUSTER) {
      ox = r * a.kx - 1;           // local column 0 is padded column r*kx
    }
    if (K != TILE) {
      ox2 = ox;
      oy2 = oy;
    }
    d0x = (const T*)a.d0x + ix0; d0y = (const T*)a.d0y + iy0;
    w0x = (const T*)a.w0x + ix0; w0y = (const T*)a.w0y + iy0;
    ccxp = (const T*)a.ccx + ix0; ccyp = (const T*)a.ccy + iy0;
    odx = (T*)a.dx + sx0; ody = (T*)a.dy + sy0;
    owx = (T*)a.wx + sx0; owy = (T*)a.wy + sy0;
    g.bbx = a.brk_before_x + gx0; g.bax = a.brk_after_x + gx0;
    g.fsx = a.first_x + gx0; g.lsx = a.last_x + gx0;
    g.bby = a.brk_before_y + gy0; g.bay = a.brk_after_y + gy0;
    g.fsy = a.first_y + gy0; g.lsy = a.last_y + gy0;
    g.dlx = a.delay_x + gx0; g.dly = a.delay_y + gy0;
    g.rot0 = a.delay_y_rot0 + gy0; g.rot1 = a.delay_y_rot1 + gy0;
    g.par = K == BLOCK ? a.base_par + gi * a.g_sp : nullptr;
    g.inc = a.inc_track;
  }
  // a read of g, through the read-only path
  template <class U>
  __device__ U rd(const U* p) const { return __ldg(p); }
  // the bf16 plane mode's rounding (identity in the f32 mode)
  __device__ float q(float v) const { return Q ? rnd16(v) : v; }
  // local linear cell indices (state, scan costs)
  __device__ int lx(int t, int x, int y) const {
    return (t * a.X + x) * (a.Y + 1) + y;
  }
  __device__ int ly(int t, int x, int y) const {
    return (t * (a.X + 1) + x) * a.Y + y;
  }
  // index in the plane of the net's input / output rows
  __device__ int ix(int t, int x, int y) const {
    return FLATS ? (t * a.NX + ox + x) * a.stride_x + oy + y : lx(t, x, y);
  }
  __device__ int iy(int t, int x, int y) const {
    return FLATS ? (t * (a.NX + 1) + ox2 + x) * (a.stride_x - 1) + oy2 + y
                 : ly(t, x, y);
  }
  // index in the geometry arrays
  __device__ int gx(int t, int x, int y) const {
    return K == TILE ? ix(t, x, y) : lx(t, x, y);
  }
  __device__ int gy(int t, int x, int y) const {
    return K == TILE ? iy(t, x, y) : ly(t, x, y);
  }
  // CLUSTER: local column x is a real canvas column, not padding
  __device__ bool realx(int x) const {
    return K != CLUSTER || (unsigned)(ox + x) < (unsigned)a.NX;
  }
  __device__ bool realy(int x) const {
    return K != CLUSTER || (unsigned)(ox + x) <= (unsigned)a.NX;
  }
  // global flat cell ids (pred payload); CLUSTER clamps a pad column's
  // into the canvas, as planes_shard._geom_blocks does (a pad cell stays
  // INF, so its id never surfaces)
  __device__ int idx(int t, int x, int y) const {
    if (K == FULL || K == TILE) return ix(t, x, y);
    if (K == CLUSTER)
      return (t * a.NX + min(max(ox + x, 0), a.NX - 1)) * a.stride_x + y;
    return __ldg(a.idxx + gx0 + lx(t, x, y));
  }
  __device__ int idy(int t, int x, int y) const {
    if (K == FULL || K == TILE) return a.ncx + iy(t, x, y);
    if (K == CLUSTER)
      return a.ncx + (t * (a.NX + 1) + min(max(ox + x, 0), a.NX)) *
                         (a.stride_x - 1) + y;
    return __ldg(a.idxy + gy0 + ly(t, x, y));
  }
  __device__ int par(int x, int y) const {
    if (K == FULL) return (x + y) & 1;
    if (K == TILE || K == CLUSTER) return (ox2 + x + oy + y) & 1;
    return rd(g.par + x * (a.Y + 1) + y);
  }
  // where a cell's dist lives (local index l): TILE without shared state
  // relaxes in the output flats themselves
  __device__ int dxi(int l, int t, int x, int y) const {
    return K == TILE && !SMEM ? ix(t, x, y) : l;
  }
  __device__ int dyi(int l, int t, int x, int y) const {
    return K == TILE && !SMEM ? iy(t, x, y) : l;
  }
  __device__ float ccx(int t, int x, int y) const {
    return realx(x) ? q(ldp(ccxp + ix(t, x, y))) : __int_as_float(0x7f800000);
  }
  __device__ float ccy(int t, int x, int y) const {
    return realy(x) ? q(ldp(ccyp + iy(t, x, y))) : __int_as_float(0x7f800000);
  }
  __device__ bool inc(int t) const { return rd(g.inc + t) != 0; }
  __device__ bool own(int x) const { return x >= a.own_lo && x < a.own_hi; }
  __device__ float cost_x(int t, int x, int y) const {
    return fadd(__fmul_rn(crit, rd(g.dlx + gx(t, x, y))), ccx(t, x, y));
  }
  __device__ float cost_y(int t, int x, int y) const {
    return fadd(__fmul_rn(crit, rd(g.dly + gy(t, x, y))), ccy(t, x, y));
  }
  // the cell's pred / wenter are returned (CLUSTER: owned real columns;
  // no other cell's payload is ever read)
  __device__ bool keeps_x(int x) const {
    return K != CLUSTER || (own(x) && realx(x));
  }
  __device__ bool keeps_y(int x) const {
    return K != CLUSTER || (own(x) && realy(x));
  }
  __device__ void put_x(int t, int x, int y, int p, float w) const {
    if (keeps_x(x)) {
      const int i = ix(t, x, y);
      a.px[sx0 + i] = p;
      stp(owx + i, q(w));
    }
  }
  __device__ void put_y(int t, int x, int y, int p, float w) const {
    if (keeps_y(x)) {
      const int i = iy(t, x, y);
      a.py[sy0 + i] = p;
      stp(owy + i, q(w));
    }
  }
  // whether an improving write old -> v changes the sweep's result at a
  // cell the change flag covers: any improvement in the f32 mode, one
  // that changes the rounded value in the bf16 plane mode
  __device__ bool changes(int x, float v, float old) const {
    return own(x) && (!Q || rnd16(v) < rnd16(old));
  }
};

// Both scans of one plane (XAX: the x plane, lines (t, y) along x; else
// the y plane, lines (t, x) along y) over dist `d`, with scan costs from
// `cs` (null: computed) and this warp's scratch.  Returns "an owned cell
// improved" for this thread.
template <int K, bool SMEM, bool Q, bool XAX>
__device__ bool scan_phase(const Net<K, SMEM, Q>& n, const Args& a, float* d,
                           const float* cs, float* scr) {
  const float INF = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = XAX ? a.X : a.Y;
  const int per = XAX ? a.Y + 1 : a.X + 1;     // lines per track
  const int nlines = a.W * per;
  const int G = line_lanes(len), L = a.X > a.Y ? a.X : a.Y;
  const int gpw = 32 / G, q = lane & (G - 1), grp = lane / G;
  float* c = scr + warp * scratch_per_warp(a.X, a.Y) +
             grp * line_scratch(a.X, a.Y);
  float* m = c + L;
  const uint8_t* bb = XAX ? n.g.bbx : n.g.bby;
  const uint8_t* ba = XAX ? n.g.bax : n.g.bay;
  const float* dl = XAX ? n.g.dlx : n.g.dly;
  const int step = XAX ? a.stride_x : 1;
  bool mine = false;
  for (int base = warp * gpw; base < nlines; base += nwarps * gpw) {
    const int ln = base + grp;
    const bool act = ln < nlines;
    const int t = ln / per, o = ln - t * per;
    const bool inc = act && a.directional ? n.inc(t) : false;
    for (int rev = 0; rev < 2; ++rev) {
      const uint8_t* brk = rev ? ba : bb;
      const bool blocked = a.directional && (rev ? inc : !inc);
      if (act)
        for (int k = q; k < len; k += G) {
          const int p = rev ? len - 1 - k : k;
          const int x = XAX ? p : o, y = XAX ? o : p;
          const int l = XAX ? n.lx(t, x, y) : n.ly(t, x, y);
          const int gl = XAX ? n.gx(t, x, y) : n.gy(t, x, y);
          float cv = 0.0f;
          if (n.rd(brk + gl))
            cv = blocked ? INF
                         : (cs ? cs[l]
                               : (XAX ? n.cost_x(t, x, y)
                                      : n.cost_y(t, x, y)));
          c[k] = cv;
          m[k] = d[XAX ? n.dxi(l, t, x, y) : n.dyi(l, t, x, y)];
        }
      __syncwarp();
      warp_scan(c, m, len, q, G, act);
      if (act)
        for (int k = q; k < len; k += G) {
          const int p = rev ? len - 1 - k : k;
          const int x = XAX ? p : o, y = XAX ? o : p;
          const int l = XAX ? n.lx(t, x, y) : n.ly(t, x, y);
          const int di = XAX ? n.dxi(l, t, x, y) : n.dyi(l, t, x, y);
          const float old = d[di];
          if (m[k] < old) {
            d[di] = m[k];
            const int gl = XAX ? n.gx(t, x, y) : n.gy(t, x, y);
            const int id = (XAX ? n.idx(t, x, y) : n.idy(t, x, y)) +
                           (rev ? step : -step);
            const float w = n.rd(brk + gl) ? n.rd(dl + gl) : 0.0f;
            if (XAX)
              n.put_x(t, x, y, id, w);
            else
              n.put_y(t, x, y, id, w);
            mine |= n.changes(x, m[k], old);
          }
        }
      __syncwarp();
    }
  }
  return mine;
}

// A walk over the cells l = (t * R + r) * C + c of a plane in steps of
// blockDim.x, carrying (t, r, c) along: the divisions run once per launch.
struct Walk {
  int t0, r0, c0, dt, dr, dc;
  __device__ Walk(int R, int C) {
    const int nth = blockDim.x, row = threadIdx.x / C, drow = nth / C;
    c0 = threadIdx.x - row * C;
    t0 = row / R;
    r0 = row - t0 * R;
    dc = nth % C;
    dt = drow / R;
    dr = drow - dt * R;
  }
  __device__ void next(int R, int C, int& t, int& r, int& c) const {
    c += dc;
    const int carry = c >= C;
    if (carry) c -= C;
    r += dr + carry;
    t += dt;
    if (r >= R) { r -= R; ++t; }
  }
};

// The turn stencils fold their candidates in the plain version's order
// with a strict `<`.  A candidate that is INF can never win the fold, so
// the ones that are INF by construction are not evaluated: a source
// outside the canvas, a directional turn whose target gate is closed, and
// the rotated turn whose parity differs from the corner's (of the two
// rotated turns p = 0, 1 only p = parity survives).  The rest are the same
// operations on the same operands as the plain version's.  Cells are
// walked with a Walk and rotated tracks wrap by one add, so no integer
// division runs per cell or per sweep.

// turn into y: target chany (t', x, v); sources chanx (x+a-1, v+1-b)
template <int K, bool SMEM, bool Q>
__device__ bool turn_into_y(const Net<K, SMEM, Q>& n, const Args& a,
                            const Walk& wk, const float* dx, float* dy) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, nth = blockDim.x;
  const int nyc = W * (X + 1) * Y;
  // the rotated turn of parity p exists unless (1 + p) % W == 0
  const bool rot0 = W > 1, rot1 = W > 2;
  // l = (tp * (X + 1) + x) * Y + v
  int tp = wk.t0, x = wk.r0, v = wk.c0;
  bool mine = false;
  for (int l = threadIdx.x; l < nyc; l += nth) {
    const int gl = n.gy(tp, x, v);
    const float cc = n.ccy(tp, x, v);
    const float dly = n.rd(n.g.dly + gl);
    const float cd = __fmul_rn(n.crit, dly);
    float d0 = dly, d1 = dly, cd0 = cd, cd1 = cd;
    if (!a.directional) {
      d0 = n.rd(n.g.rot0 + gl);
      d1 = n.rd(n.g.rot1 + gl);
      cd0 = __fmul_rn(n.crit, d0);
      cd1 = __fmul_rn(n.crit, d1);
    }
    const bool incp = a.directional && n.inc(tp);
    float best = INF, bw = 0.0f;
    int bsrc = 0;
    for (int boff = 0; boff < 2; ++boff) {
      const int sy = v + 1 - boff;
      const int pr = n.par(x, sy);
      bool gate = boff == 0 ? n.rd(n.g.lsy + gl) : n.rd(n.g.fsy + gl);
      if (a.directional) {
        gate = gate && (boff == 0 ? !incp : incp);
        if (!gate) continue;
      }
      const bool rot = pr == 0 ? rot0 : rot1;
      int trot = tp - 1 - pr;
      if (trot < 0) trot += W;
      const float drot = pr == 0 ? d0 : d1, cdrot = pr == 0 ? cd0 : cd1;
      for (int aoff = 0; aoff < 2; ++aoff) {
        const int sx = x + aoff - 1;
        if (sx < 0 || sx >= X) continue;
        for (int r = 0; r < 2; ++r) {     // straight, rotated of parity pr
          if (r == 1 && !rot) break;
          const int t = r == 0 ? tp : trot;
          const int ls = n.lx(t, sx, sy);
          const float dvs = dx[n.dxi(ls, t, sx, sy)];
          const int gs = n.gx(t, sx, sy);
          bool sg = aoff == 0 ? n.rd(n.g.lsx + gs) : n.rd(n.g.fsx + gs);
          float cand, d, cdl;
          if (a.directional) {
            sg = sg && (aoff == 0 ? n.inc(t) : !n.inc(t));
            cand = sg ? dvs : INF;
            d = dly;
            cdl = cd;
          } else {
            cand = fminf(sg ? dvs : INF, gate ? dvs : INF);
            d = r == 0 ? dly : drot;
            cdl = r == 0 ? cd : cdrot;
          }
          cand = fadd(fadd(cand, cdl), cc);
          if (cand < best) { best = cand; bsrc = n.idx(t, sx, sy); bw = d; }
        }
      }
    }
    const int di = n.dyi(l, tp, x, v);
    const float old = dy[di];
    if (best < old) {
      dy[di] = best;
      n.put_y(tp, x, v, bsrc, bw);
      mine |= n.changes(x, best, old);
    }
    wk.next(X + 1, Y, tp, x, v);
  }
  return mine;
}

// turn into x: target chanx (t, u, y); sources chany (u+1-a, y+b-1).  The
// last writer of dx in a sweep: in the bf16 plane mode it also rounds
// every dx cell it visits (the sweep's rounding pass of dx).
template <int K, bool SMEM, bool Q>
__device__ bool turn_into_x(const Net<K, SMEM, Q>& n, const Args& a,
                            const Walk& wk, const float* dy, float* dx) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, nth = blockDim.x;
  const int nxc = W * X * (Y + 1);
  const bool rot0 = W > 1, rot1 = W > 2;
  // l = (t * X + u) * (Y + 1) + y
  int t = wk.t0, u = wk.r0, y = wk.c0;
  bool mine = false;
  for (int l = threadIdx.x; l < nxc; l += nth) {
    const int gl = n.gx(t, u, y);
    const float cc = n.ccx(t, u, y);
    const float dly = n.rd(n.g.dlx + gl);
    const float cd = __fmul_rn(n.crit, dly);
    const bool inct = a.directional && n.inc(t);
    float best = INF, bw = 0.0f;
    int bsrc = 0;
    for (int aoff = 0; aoff < 2; ++aoff) {
      const int sx = u + 1 - aoff;
      const int pr = n.par(sx, y);
      bool gate = aoff == 0 ? n.rd(n.g.lsx + gl) : n.rd(n.g.fsx + gl);
      if (a.directional) {
        gate = gate && (aoff == 0 ? !inct : inct);
        if (!gate) continue;
      }
      const bool rot = pr == 0 ? rot0 : rot1;
      int trot = t + 1 + pr;
      if (trot >= W) trot -= W;
      for (int boff = 0; boff < 2; ++boff) {
        const int sy = y + boff - 1;
        if (sy < 0 || sy >= Y) continue;
        for (int r = 0; r < 2; ++r) {     // straight, rotated of parity pr
          if (r == 1 && !rot) break;
          const int ts = r == 0 ? t : trot;
          const int ls = n.ly(ts, sx, sy);
          const float dvs = dy[n.dyi(ls, ts, sx, sy)];
          const int gs = n.gy(ts, sx, sy);
          bool sg = boff == 0 ? n.rd(n.g.lsy + gs) : n.rd(n.g.fsy + gs);
          float cand;
          if (a.directional) {
            sg = sg && (boff == 0 ? n.inc(ts) : !n.inc(ts));
            cand = sg ? dvs : INF;
          } else {
            cand = fminf(sg ? dvs : INF, gate ? dvs : INF);
          }
          cand = fadd(fadd(cand, cd), cc);
          if (cand < best) {
            best = cand; bsrc = n.idy(ts, sx, sy); bw = dly;
          }
        }
      }
    }
    const int di = n.dxi(l, t, u, y);
    const float old = dx[di];
    const bool imp = best < old;
    if (imp) {
      n.put_x(t, u, y, bsrc, bw);
      mine |= n.changes(u, best, old);
    }
    if (Q)
      dx[di] = rnd16(imp ? best : old);
    else if (imp)
      dx[di] = best;
    wk.next(X, Y + 1, t, u, y);
  }
  return mine;
}

// CLUSTER: write this CTA's dist halo columns from its neighbours' owned
// columns (planes_shard's exchange: dx col 0 <- left's col kx, dx col kx+1
// <- right's col 1, dy col 0 <- left's col kx, dy cols kx+1..kx+2 <-
// right's cols 1..2; INF where the edge shard has no neighbour).  With
// the state in shared memory the neighbours' blocks are read through
// distributed shared memory; in mode 0 from their workspace blocks, which
// sit `cells` floats before and after this CTA's.
template <bool SMEM>
__device__ void halo_copy(const Args& a, float* dx, float* dy, int r,
                          long long cells) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, kx = a.kx;
  const float *lx = nullptr, *ly = nullptr, *rx = nullptr, *ry = nullptr;
  cg::cluster_group cl = cg::this_cluster();
  if (r > 0) {
    lx = SMEM ? cl.map_shared_rank(dx, r - 1) : dx - cells;
    ly = SMEM ? cl.map_shared_rank(dy, r - 1) : dy - cells;
  }
  if (r + 1 < a.shards) {
    rx = SMEM ? cl.map_shared_rank(dx, r + 1) : dx + cells;
    ry = SMEM ? cl.map_shared_rank(dy, r + 1) : dy + cells;
  }
  const int nx = W * (Y + 1), ny = W * Y;
  for (int k = threadIdx.x; k < 2 * nx + 3 * ny; k += blockDim.x) {
    if (k < 2 * nx) {
      const int side = k >= nx, q = k - side * nx;
      const int t = q / (Y + 1), y = q - t * (Y + 1);
      const float* src = side ? rx : lx;
      dx[(t * X + (side ? kx + 1 : 0)) * (Y + 1) + y] =
          src ? src[(t * X + (side ? 1 : kx)) * (Y + 1) + y] : INF;
    } else {
      const int k2 = k - 2 * nx, j = k2 / ny, q = k2 - j * ny;
      const int t = q / Y, y = q - t * Y;
      const float* src = j ? ry : ly;
      dy[(t * (X + 1) + (j ? kx + j : 0)) * Y + y] =
          src ? src[(t * (X + 1) + (j ? j : kx)) * Y + y] : INF;
    }
  }
}

// The bf16 plane mode's rounding pass of dy (dx is rounded in
// turn_into_x): each thread rounds the dy cells of its Walk, the cells it
// also writes in turn_into_y and writes back, so no barrier is needed
// before those; the caller holds one between the turn into x, which reads
// dy, and this pass.
template <int K, bool SMEM, bool Q>
__device__ void round_dy(const Net<K, SMEM, Q>& n, const Args& a,
                         const Walk& wk, float* dy) {
  const int nyc = a.W * (a.X + 1) * a.Y;
  int t = wk.t0, x = wk.r0, y = wk.c0;
  for (int l = threadIdx.x; l < nyc; l += blockDim.x) {
    const int di = n.dyi(l, t, x, y);
    dy[di] = rnd16(dy[di]);
    wk.next(a.X + 1, a.Y, t, x, y);
  }
}

// Shared-memory modes: 0 all state in global memory (only the scan
// scratch in shared); 1 dist in shared; 2 dist and scan costs.  SMEM =
// mode >= 1; a.cost_smem = mode == 2.  Layout: floats [dx | dy | cost_x |
// cost_y | scratch], then (CLUSTER) two ints of owned-change flags.  In
// mode 0 the f32 working dist is the output (FULL, f32 BLOCK; TILE: the
// output flats themselves) or the workspace ws (CLUSTER, bf16 BLOCK,
// whose output is bfloat16).
template <int K, bool SMEM, bool Q>
__device__ void relax_net(const Args& a) {
  extern __shared__ float smem[];
  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x, nth = blockDim.x;
  int b = blockIdx.x, r = 0;
  if (K == CLUSTER) {
    b = blockIdx.x / a.shards;
    r = blockIdx.x - b * a.shards;
  }
  const Net<K, SMEM, Q> n(a, b, r);
  const int W = a.W, X = a.X, Y = a.Y;
  const int nxc = W * X * (Y + 1), nyc = W * (X + 1) * Y;
  // the output planes are bfloat16 (bf16 BLOCK) and the working dist f32
  constexpr bool WS16 = K == BLOCK && Q;
  float* f = smem;
  float *dx = nullptr, *dy = nullptr, *cx = nullptr, *cy = nullptr;
  if (SMEM) {
    dx = f; f += nxc;
    dy = f; f += nyc;
    if (a.cost_smem) {
      cx = f; f += nxc;
      cy = f; f += nyc;
    }
  } else if (K == CLUSTER || WS16) {
    dx = a.ws + (long long)blockIdx.x * (nxc + nyc);
    dy = dx + nxc;
  } else {
    dx = (float*)a.dx + n.sx0;
    dy = (float*)a.dy + n.sy0;
  }
  float* scr = f;
  int* flag = (int*)(scr + (nth >> 5) * scratch_per_warp(X, Y));

  if constexpr (K == TILE) {
    // the net's whole output row: d0, the cell's own id, wenter0 (as
    // given, in either plane mode: cells outside the tile are returned
    // unchanged); the tile is relaxed on top of it.  Four cells per
    // thread per round, loads first, so the row costs a quarter of the
    // load latencies.  TILE's input and output rows share one stride.
    for (int l0 = tid; l0 < a.nc; l0 += 4 * nth) {
      float d[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * nth;
        if (l < a.nc) {
          d[k] = ldp(n.d0x + l);
          w[k] = ldp(n.w0x + l);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * nth;
        if (l < a.nc) {
          n.odx[l] = d[k];
          a.px[n.sx0 + l] = l;
          n.owx[l] = w[k];
        }
      }
    }
    __syncthreads();
  }
  const Walk walk_y(X + 1, Y), walk_x(X, Y + 1);
  {
    int t = walk_x.t0, x = walk_x.r0, y = walk_x.c0;
    for (int l = tid; l < nxc; l += nth) {
      const int i = n.ix(t, x, y);
      if (K != TILE || SMEM)
        dx[l] = n.realx(x) ? n.q(ldp(n.d0x + i)) : INF;
      else if (Q)
        dx[i] = n.q(ldp(n.d0x + i));   // TILE mode 0: the output row
      if (K == FULL || K == BLOCK) {
        stp(n.owx + l, n.q(ldp(n.w0x + l)));
        a.px[n.sx0 + l] = a.p0x ? a.p0x[n.ix0 + l] : n.idx(t, x, y);
      } else if (K == CLUSTER && n.keeps_x(x)) {
        stp(n.owx + i, n.q(ldp(n.w0x + i)));
        a.px[n.sx0 + i] = n.idx(t, x, y);
      } else if (K == TILE && Q) {
        stp(n.owx + i, n.q(ldp(n.w0x + i)));
      }
      if (cx) cx[l] = n.cost_x(t, x, y);
      walk_x.next(X, Y + 1, t, x, y);
    }
  }
  {
    int t = walk_y.t0, x = walk_y.r0, y = walk_y.c0;
    for (int l = tid; l < nyc; l += nth) {
      const int i = n.iy(t, x, y);
      if (K != TILE || SMEM)
        dy[l] = n.realy(x) ? n.q(ldp(n.d0y + i)) : INF;
      else if (Q)
        dy[i] = n.q(ldp(n.d0y + i));
      if (K == FULL || K == BLOCK) {
        stp(n.owy + l, n.q(ldp(n.w0y + l)));
        a.py[n.sy0 + l] = a.p0y ? a.p0y[n.iy0 + l] : n.idy(t, x, y);
      } else if (K == CLUSTER && n.keeps_y(x)) {
        stp(n.owy + i, n.q(ldp(n.w0y + i)));
        a.py[n.sy0 + i] = n.idy(t, x, y);
      } else if (K == TILE && Q) {
        stp(n.owy + i, n.q(ldp(n.w0y + i)));
      }
      if (cy) cy[l] = n.cost_y(t, x, y);
      walk_y.next(X + 1, Y, t, x, y);
    }
  }
  if constexpr (K == CLUSTER)
    cg::this_cluster().sync();       // every block initialised
  else
    __syncthreads();

  int i = 0;
  bool go = true;
  while (go && i < a.nsweeps) {
    if constexpr (K == CLUSTER) {
      halo_copy<SMEM>(a, dx, dy, r, (long long)nxc + nyc);
      cg::this_cluster().sync();     // halos in before any owned write
    }
    bool mine = scan_phase<K, SMEM, Q, true>(n, a, dx, cx, scr);
    __syncthreads();
    mine |= turn_into_y<K, SMEM, Q>(n, a, walk_y, dx, dy);
    __syncthreads();
    mine |= scan_phase<K, SMEM, Q, false>(n, a, dy, cy, scr);
    __syncthreads();
    mine |= turn_into_x<K, SMEM, Q>(n, a, walk_x, dy, dx);
    if constexpr (K == CLUSTER) {
      // slot i & 1 is rewritten two sweeps later, after every CTA has
      // passed the next halo barrier, so no CTA can still be reading it;
      // dy is rounded before the barrier after which the neighbours read
      // its halo columns
      const int any = __syncthreads_or(mine);
      if (Q) round_dy(n, a, walk_y, dy);
      if (tid == 0) flag[i & 1] = any;
      cg::this_cluster().sync();
      cg::cluster_group cl = cg::this_cluster();
      go = __syncthreads_or(tid < a.shards &&
                            *cl.map_shared_rank(flag + (i & 1), tid)) != 0;
    } else {
      go = __syncthreads_or(mine) != 0;
      if (Q) round_dy(n, a, walk_y, dy);
    }
    ++i;
  }
  if constexpr (K == CLUSTER)
    cg::this_cluster().sync();       // no CTA leaves while read remotely

  if (SMEM || K == CLUSTER || WS16) {
    int t = walk_x.t0, x = walk_x.r0, y = walk_x.c0;
    for (int l = tid; l < nxc; l += nth) {
      if (n.keeps_x(x)) stp(n.odx + n.ix(t, x, y), dx[l]);
      walk_x.next(X, Y + 1, t, x, y);
    }
    t = walk_y.t0; x = walk_y.r0; y = walk_y.c0;
    for (int l = tid; l < nyc; l += nth) {
      if (n.keeps_y(x)) stp(n.ody + n.iy(t, x, y), dy[l]);
      walk_y.next(X + 1, Y, t, x, y);
    }
  }
  if (tid == 0 && r == 0) {
    const int useful = i - (go ? 0 : 1) > 0 ? i - (go ? 0 : 1) : 0;
    a.stats[2 * b] = i;
    a.stats[2 * b + 1] = useful;
    if (a.total) {
      atomicMax(&a.total[0], i);
      atomicMax(&a.total[1], useful);
    }
  }
}

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_full_kernel(Args a) { relax_net<FULL, SMEM, Q>(a); }

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_block_kernel(Args a) { relax_net<BLOCK, SMEM, Q>(a); }

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_cropped_kernel(Args a) { relax_net<TILE, SMEM, Q>(a); }

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_cluster_kernel(Args a) { relax_net<CLUSTER, SMEM, Q>(a); }

// the launch tables: p[NPTR] pointers, v[NINT] integers (the wrapper's
// layout, route/planes_kernels.py)
//   p: 0..5 d0x d0y ccx ccy w0x w0y, 6 crit, 7..12 dx dy px py wx wy,
//      13 stats, 14..25 geometry, 26 inc_track, 27 idxx, 28 idxy,
//      29 base_par, 30 p0x, 31 p0y, 32 total [2] (zeroed here, or 0),
//      33 ox, 34 oy, 35 ws
//   v: 0 B, 1 W, 2 X, 3 Y, 4 stride_x, 5 directional, 6 nsweeps,
//      7..10 in_sx in_sy st_sx st_sy, 11..13 g_sx g_sy g_sp, 14 threads,
//      15 own_lo, 16 own_hi, 17 mode (-1: auto), 18 device, 19 NX,
//      20 ncx, 21 nc, 22 ox_hi, 23 oy_hi, 24 shards, 25 kx, 26 plane
//      mode (0 f32, 1 bf16)
Args unpack(const void* const* p, const long long* v) {
  Args a;
  a.d0x = p[0]; a.d0y = p[1];
  a.ccx = p[2]; a.ccy = p[3];
  a.w0x = p[4]; a.w0y = p[5];
  a.crit = (const float*)p[6];
  a.dx = (void*)p[7]; a.dy = (void*)p[8];
  a.px = (int32_t*)p[9]; a.py = (int32_t*)p[10];
  a.wx = (void*)p[11]; a.wy = (void*)p[12];
  a.stats = (int32_t*)p[13];
  a.brk_before_x = (const uint8_t*)p[14]; a.brk_after_x = (const uint8_t*)p[15];
  a.first_x = (const uint8_t*)p[16]; a.last_x = (const uint8_t*)p[17];
  a.brk_before_y = (const uint8_t*)p[18]; a.brk_after_y = (const uint8_t*)p[19];
  a.first_y = (const uint8_t*)p[20]; a.last_y = (const uint8_t*)p[21];
  a.delay_x = (const float*)p[22]; a.delay_y = (const float*)p[23];
  a.delay_y_rot0 = (const float*)p[24]; a.delay_y_rot1 = (const float*)p[25];
  a.inc_track = (const uint8_t*)p[26];
  a.idxx = (const int32_t*)p[27]; a.idxy = (const int32_t*)p[28];
  a.base_par = (const int32_t*)p[29];
  a.p0x = (const int32_t*)p[30]; a.p0y = (const int32_t*)p[31];
  a.total = (int32_t*)p[32];
  a.ox = (const int32_t*)p[33]; a.oy = (const int32_t*)p[34];
  a.ws = (float*)p[35];
  a.W = (int)v[1]; a.X = (int)v[2]; a.Y = (int)v[3];
  a.stride_x = (int)v[4]; a.directional = (int)v[5]; a.nsweeps = (int)v[6];
  a.in_sx = v[7]; a.in_sy = v[8]; a.st_sx = v[9]; a.st_sy = v[10];
  a.g_sx = v[11]; a.g_sy = v[12]; a.g_sp = v[13];
  a.own_lo = (int)v[15]; a.own_hi = (int)v[16];
  a.cost_smem = 0;
  a.NX = (int)v[19]; a.ncx = (int)v[20]; a.nc = (int)v[21];
  a.ox_hi = (int)v[22]; a.oy_hi = (int)v[23];
  a.shards = (int)v[24]; a.kx = (int)v[25];
  return a;
}

int smem_optin(int dev) {
  static int cache[MAX_DEVICES] = {0};
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (!cache[dev] &&
      cudaDeviceGetAttribute(&cache[dev],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    cache[dev] = 0;
  return cache[dev];
}

// dynamic shared bytes of a mode (relax_net's layout)
long long smem_bytes(int kind, int mode, const long long* v) {
  const long long W = v[1], X = v[2], Y = v[3], threads = v[14];
  const long long ncells = W * X * (Y + 1) + W * (X + 1) * Y;
  return 4 * (mode * ncells +
              threads / 32 * scratch_per_warp((int)X, (int)Y)) +
         (kind == CLUSTER ? 2 * sizeof(int) : 0);
}

// The mode the launch takes for v[17] = -1: the most shared state that
// fits the card's per-block opt-in limit.
int auto_mode(int kind, const long long* v) {
  const long long cap = smem_optin((int)v[18]);
  for (int mode = 2; mode > 0; --mode)
    if (smem_bytes(kind, mode, v) <= cap) return mode;
  return 0;
}

int mode_of(int kind, const long long* v) {
  return v[17] < 0 ? auto_mode(kind, v) : (int)v[17];
}

#define PICK(k)                                                   \
  (q ? (s ? (const void*)k<true, true> : (const void*)k<false, true>) \
     : (s ? (const void*)k<true, false> : (const void*)k<false, false>))

// the kernel of a kind, shared-memory mode and plane mode (q: bf16)
const void* kernel_of(int kind, int mode, bool q) {
  const bool s = mode != 0;
  switch (kind) {
    case FULL: return PICK(planes_relax_full_kernel);
    case BLOCK: return PICK(planes_relax_block_kernel);
    case TILE: return PICK(planes_relax_cropped_kernel);
    default: return PICK(planes_relax_cluster_kernel);
  }
}
#undef PICK

// Checks a table, makes its card current (the previous one in *cur) and
// sets the kernel's attributes: its dynamic shared memory above the
// default 48 KB (the largest size set so far, per kernel and card) and,
// for a cluster above the portable size, the non-portable cluster size.
cudaError_t prepare(int kind, const long long* v, int* cur, int* mode,
                    long long* bytes, const void** k) {
  const int threads = (int)v[14], dev = (int)v[18];
  if (v[2] > MAXL || v[3] + 1 > MAXL || v[2] < 1 || v[3] < 1)
    return cudaErrorInvalidValue;
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return cudaErrorInvalidValue;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (kind == CLUSTER && (v[24] < 2 || v[24] > MAX_CLUSTER))
    return cudaErrorInvalidValue;
  if (v[26] != 0 && v[26] != 1) return cudaErrorInvalidValue;
  const bool q = v[26] == 1;
  cudaError_t e = cudaGetDevice(cur);
  if (e == cudaSuccess && *cur != dev) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  *mode = mode_of(kind, v);
  *bytes = smem_bytes(kind, *mode, v);
  *k = kernel_of(kind, *mode, q);
  if (*mode < 0 || *mode > 2 || *bytes > smem_optin(dev))
    return cudaErrorInvalidValue;
  static long long set[16][MAX_DEVICES] = {{0}};
  long long& done = set[4 * kind + 2 * q + (*mode == 0 ? 0 : 1)][dev];
  if (*bytes > 48 * 1024 && *bytes > done) {
    e = cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*bytes);
    if (e != cudaSuccess) return e;
    done = *bytes;
  }
  static bool wide[4][MAX_DEVICES] = {{false}};
  bool& wd = wide[2 * q + (*mode == 0 ? 0 : 1)][dev];
  if (kind == CLUSTER && v[24] > PORTABLE_CLUSTER && !wd) {
    e = cudaFuncSetAttribute(
        *k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wd = true;
  }
  return cudaSuccess;
}

// a cluster launch's configuration: B clusters of `shards` CTAs
void cluster_config(const long long* v, long long bytes, void* stream,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(v[0] * v[24]));
  cfg->blockDim = dim3((unsigned)v[14]);
  cfg->dynamicSmemBytes = (size_t)bytes;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)v[24];
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

int launch(int kind, const void* const* p, const long long* v,
           void* stream) {
  const int B = (int)v[0], dev = (int)v[18];
  if (B <= 0) return 0;
  int cur = dev, mode = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(kind, v, &cur, &mode, &bytes, &k);
  Args a = unpack(p, v);
  a.cost_smem = mode == 2;
  const bool ws_needed = kind == CLUSTER || (kind == BLOCK && v[26] == 1);
  if (e == cudaSuccess && ws_needed && mode == 0 && !a.ws)
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && kind == TILE && (!a.ox || !a.oy))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && a.total)
    e = cudaMemsetAsync(a.total, 0, 2 * sizeof(int32_t),
                        (cudaStream_t)stream);
  if (e == cudaSuccess) {
    void* args[] = {&a};
    if (kind == CLUSTER) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      cluster_config(v, bytes, stream, &cfg, &attr);
      e = cudaLaunchKernelExC(&cfg, k, args);
    } else {
      e = cudaLaunchKernel(k, dim3(B), dim3((unsigned)v[14]), args,
                           (size_t)bytes, (cudaStream_t)stream);
    }
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return (int)e;
}

}  // namespace

extern "C" int planes_relax_full_launch(const void* const* p,
                                        const long long* v, void* stream) {
  return launch(FULL, p, v, stream);
}

extern "C" int planes_relax_cropped_launch(const void* const* p,
                                           const long long* v, void* stream) {
  return launch(TILE, p, v, stream);
}

// the one-sweep step of a shard's block: nsweeps = 1, pred in
extern "C" int planes_sweep_block_launch(const void* const* p,
                                         const long long* v, void* stream) {
  if (!p[30] || !p[31] || v[6] != 1) return (int)cudaErrorInvalidValue;
  return launch(BLOCK, p, v, stream);
}

// the whole sharded relaxation of every net, one cluster per net
extern "C" int planes_relax_cluster_launch(const void* const* p,
                                           const long long* v, void* stream) {
  return launch(CLUSTER, p, v, stream);
}

// How many clusters of this table the card can hold at once (0: it cannot
// schedule one), or minus the CUDA error that prevented the query.
extern "C" int planes_relax_cluster_fit(const long long* v) {
  int cur = (int)v[18], mode = 0, n = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(CLUSTER, v, &cur, &mode, &bytes, &k);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(v, bytes, nullptr, &cfg, &attr);
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  }
  if (cur != (int)v[18]) cudaSetDevice(cur);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int planes_relax_max_line() { return MAXL; }

// the shared-memory mode a launch of this kind with this table takes
// (kind: 0 full, 1 step, 2 cropped, 3 cluster)
extern "C" int planes_relax_mode(int kind, const long long* v) {
  return mode_of(kind, v);
}
