// Planes relaxation kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface loaded with ctypes (route/planes_kernels.py).
//
// Replaces the two TPU kernels of parallel_eda_tpu/route/planes_pallas.py:
//   planes_relax_full_kernel    <- planes_relax_pallas / _sweep_kernel
//                                  (planes_pallas.py:308 / :218, call :389)
//   planes_relax_cropped_kernel <- planes_relax_cropped_pallas /
//                                  _crop_sweep_kernel (:477 / :417, call :571)
// and runs the row-sharded relaxation (parallel_eda_tpu/route/
// planes_shard.py planes_relax_sharded :268, its loops :376-417, where the
// TPU runs K2's kernel once per shard per sweep and remote_slab_permute,
// planes_pallas.py:597, between sweeps) whole, in one launch, in two forms:
//   planes_relax_cluster_kernel the lag-1 schedule with every shard on one
//                               card: net b is a thread-block cluster of s
//                               CTAs, CTA r holds shard r's column block,
//                               and the dist halo columns move between
//                               neighbouring CTAs' shared memory every
//                               sweep;
//   planes_relax_peer_kernel    every other mesh (shards across cards, the
//                               lag-2 schedule, the resilience ladder's
//                               per-sweep mesh): one persistent cooperative
//                               launch per card, a block per (shard, net
//                               slot), the halos stored straight into the
//                               neighbours' mailboxes (through peer
//                               pointers over NVLink on another card) and
//                               the fixpoint decided on the card.
// and the node axis of the (net, node) mesh (the JAX package's planes_relax
// with the canvases' X axis on the mesh's "node" axis, parallel_eda_tpu/
// route/planes.py:906-975, which GSPMD splits; no pallas_call), exact:
//   planes_relax_node_kernel    each net's canvases split by columns over
//                               the members of a node row
//                               (route/nodesplit.py), one persistent
//                               cooperative launch per card as the peer
//                               kernel's, the x-scans run across the
//                               members in lax.associative_scan's grouping
//                               and the halos of the same sweep: the
//                               result is bit-identical to one device.
//
// What they compute: the bounded planes relaxation of one net per thread
// block (per cluster, per set of partner blocks), to the exact fixpoint or
// `nsweeps` sweeps.  One sweep is
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
//   CLUSTER the block geometry of shard r (stacked, stride g_sx per rank;
//   PEER    ids and parity from the padded position, as _geom_blocks
//           makes them) with the FULL flats read at padded columns
//           r*kx .. r*kx+kx+ext
//           (pad columns: dist and congestion INF, wenter 0, as
//           planes_shard.shard_blocks fills them); each block writes its
//           owned real columns straight into the output flats.  A net
//           stops at its own fixpoint: its later sweeps in the batch-wide
//           loop would be identities on every returned value (owned dist
//           unchanged, halos re-copied from unchanged columns; pred and
//           wenter move only on a strict improvement), so per-net
//           termination is exact and the batch's counts are the max over
//           nets, as for FULL.
//     CLUSTER per sweep: cluster barrier, dist halo columns copied from
//           the neighbours' shared memory (map_shared_rank; INF at the
//           edge shards), cluster barrier, one sweep, then the OR of the
//           CTAs' owned-change flags through rank-indexed shared flags.
//           Lag 1 only: a net stops at its first sweep with no owned
//           change.
//     NODE  the PEER layout and launch plan, with per sweep, exact (lag 0):
//           x-scans forward then backward, each member's phase 1 of the
//           cross-segment scan (nodesplit.py: a serial pass per line, one
//           thread a line, in a global workspace), its published values
//           stored into the readers' inboxes, one flag round, phase 2
//           (the crossing combines it needs, then its own cells); the dx
//           halo (its column kx, after the x-scans, into the right
//           member's column 0); the turn into y and the y-scans; the dy
//           halo (its column 1 into the left member's column kx+1); the
//           turn into x.  Four flag rounds a sweep; the first carries the
//           owned-changed flag of the sweep before, whose OR decides the
//           net, so [executed, useful] is K1's.  Generation g's inbox
//           slot and flag slot are g & 1: a member writes generation g+2
//           only after every member has published g+1, which each does
//           after reading g.  The inboxes carry f32 working values (in the
//           bf16 plane mode too: one device rounds only at the end of a
//           sweep).
//     PEER  block (r, j) of a card holds shard r and walks the nets j,
//           j+G, j+2G, ... (planes_kernels.peer_launch_plan: G blocks per
//           shard, what the card holds at once, the same on every card).
//           A net's s partner blocks therefore always run at the same
//           time, and the launch is cooperative, so none waits for a block
//           that cannot be scheduled.  After sweep i-1 (i = 0: the loaded
//           state) a block stores generation i of its owned boundary
//           columns (dx col kx and dy col kx for the right neighbour, dx
//           col 1 and dy cols 1..2 for the left one: JAX planes_shard.py
//           :336-356) into the neighbours' halo mailboxes on their cards,
//           then publishes the word (epoch, i, owned-changed) into every
//           card's copy of the net's flag words (fence, st.release at
//           system scope across cards).  Before sweep i it waits
//           (ld.acquire) until every shard's word says i: the OR of
//           their flags decides the net, the same at every partner —
//           lag 1 stops at the first sweep with no owned change, lag 2
//           after two consecutive stable sweeps (a net's third sweep
//           after two stable ones would be an identity: its owned
//           columns and the halos it would install are those of the
//           sweep before) — and it installs the halos of generation i
//           (lag 1) or i-1 (lag 2: halos extracted before the sweep
//           before; generation 0 for sweeps 0 and 1), INF at the edge
//           shards.  The mailboxes are a ring of three generations: the
//           lag-2 read of generation i-1 can trail a neighbour's write of
//           generation i+1, never of i+2 (that write needs this block's
//           flag i+1, given after the read).  Two slots of flag words
//           suffice (a word of sweep i+2 needs every shard past sweep i).
//           The words carry a per-call epoch, so no memset runs between
//           calls and a late reader never takes an earlier call's word.
//           Every spin is bounded (clock64) and traps past the bound: a
//           lost peer is a fault, not a hang.  In the bf16 plane mode the
//           mailboxes carry the rounded values, as the cluster's halos.
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
//     whose dist does not fit).  pred and wenter are only written, on a
//     strict improvement, and stay in global memory; the geometry and
//     congestion are read through the read-only path;
//   * each min-plus line scan runs in parallel on a group of G lanes of
//     one warp (line_lanes: G = the power of two >= len / 8, at least 2,
//     at most 32; 32 / G lines per warp at once), level by level through
//     lax.associative_scan's odd/even tree in shared scratch, with
//     __syncwarp between levels.  The forward and the backward scan of a
//     line run on the same lanes, so they need no block barrier between
//     them.  Each line's scratch holds its own plane's line (2 len + 1
//     floats, the odd length starting the lines of a warp in different
//     banks); a warp's scratch is the larger of the two planes' 32 / G
//     lines (scratch_per_warp), so a thin canvas pays for its long lines
//     only at their own group count;
//   * 512-1024 threads per block (plan_threads): 1024 above 4096 cells,
//     and 512 where the scratch alone at 1024 would not fit (lines longer
//     than ~900 cells, one per warp).  So mode 0 fits every shape up to
//     the MAX_LINE scan line limit (1815 cells); a longer line or a net of
//     more than MAX_CELLS cells is refused before any launch (the
//     wrappers' and the Router's check_kernel_shape).  The fixpoint flag
//     is __syncthreads_or;
//   * the work around the sweeps stays in the launch: K2 reads and writes
//     the full flats itself, and the sharded relaxation is one launch per
//     card (no host loop, no per-sweep launches, exchange launches or host
//     reads); its halos cost one store of five columns a sweep and a
//     spin on a few flag words, against the cluster's distributed shared
//     memory.
// What bounds it now (PERF.md): latency.  The two scan phases take most of
// a sweep's cycles, the turn stencils the rest; each scan step is a few
// dependent shared-memory round trips and a __syncwarp.  One net per block
// fills B of 132 SMs; the peer kernel adds a fence and a flag round trip
// through L2 (NVLink across cards) per sweep.

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
// dist, pred and wenter.  Global I/O: every kernel reads and writes the
// f32 [B, ncells] flats (the bf16 values as f32: 4 bytes a cell, the
// route's tensors, no conversion launch).
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
#include <string.h>

namespace cg = cooperative_groups;

#define MAX_THREADS 1024
#define MIN_THREADS 512    // the fewest threads the planner gives a block
// Hopper's per-block opt-in shared memory (227 KB on the H100 and H200,
// the only cards sm_90a runs on): the limit the planner plans threads with
#define SMEM_PLAN 232448
// The longest scan line (canvas or block side) the kernels take: a line
// of n > 128 cells holds a whole warp (line_lanes = 32), one line of 2n+1
// floats of scratch a warp, so mode 0 (scratch alone, and CLUSTER's two
// flags) fits SMEM_PLAN at MIN_THREADS up to this n (route/
// planes_kernels.py MAX_LINE).
#define MAX_LINE (((SMEM_PLAN - 8) / (4 * (MIN_THREADS / 32)) - 1) / 2)
// The most cells a net's flats row may hold: cell ids (pred) are int32,
// and the cell loops step up to four blocks of threads past the end.
#define MAX_CELLS (0x7fffffffLL - 4LL * MAX_THREADS)
static_assert(MAX_LINE >= 1024, "the scan line limit is at least 1024");
#define MAX_DEVICES 64
#define MAX_CLUSTER 16     // the H100's non-portable cluster size
#define PORTABLE_CLUSTER 8
#define MAX_SHARDS 16      // PEER: shards of a mesh (route/shard_kernels.py)
// PEER: clock64 cycles a block waits for a partner's flag before it traps
// (about 35 s at the H100's 1.98 GHz)
#define SPIN_LIMIT (1LL << 36)

namespace {

enum Kind { FULL = 0, PEER = 1, TILE = 2, CLUSTER = 3, NODE = 4 };

struct Args {
  // inputs and outputs: [B, nc] f32 flats (the x plane's cells first)
  const float* d0x; const float* d0y;
  const float* ccx; const float* ccy;
  const float* w0x; const float* w0y;
  const float* crit;                 // [B]
  float* dx; float* dy;
  int32_t* px; int32_t* py;
  float* wx; float* wy;
  int32_t* stats;                    // [B, 2]
  int32_t* total;                    // [2]: max over nets (null: none)
  // geometry (per-rank for CLUSTER and PEER, strides g_sx / g_sy; 0 =
  // shared)
  const uint8_t* brk_before_x; const uint8_t* brk_after_x;
  const uint8_t* first_x; const uint8_t* last_x;
  const uint8_t* brk_before_y; const uint8_t* brk_after_y;
  const uint8_t* first_y; const uint8_t* last_y;
  const float* delay_x; const float* delay_y;
  const float* delay_y_rot0; const float* delay_y_rot1;
  const uint8_t* inc_track;          // [W] (directional only)
  const int32_t* ox; const int32_t* oy;       // TILE: origins [B]
  float* ws;            // mode 0 of CLUSTER and PEER: f32 dist blocks
  int B;                             // nets
  int W, X, Y;                       // x plane [W, X, Y+1]; y plane [W, X+1, Y]
  int stride_x;                      // global NY+1
  int NX;                            // global NX (TILE, CLUSTER, PEER)
  int ncx;                           // global chanx cells (TILE ids)
  int nc;                            // global cells per net (a flats row)
  int directional;
  int nsweeps;
  long long g_sx, g_sy;
  int cost_smem;                     // scan costs precomputed in shared
  int ox_hi, oy_hi;                  // TILE: largest origin
  int shards, kx;                    // CLUSTER, PEER: shards, owned columns
};

// PEER: where a net's partner blocks meet (planes_relax_peer_launch)
struct Peer {
  // rank r's halo mailboxes, on rank r's card: [B][3][halo_len] floats,
  // a ring of three generations per net
  float* mbox[MAX_SHARDS];
  // every card's copy of the flag words [B][shards][2] (one per sweep
  // parity): (epoch << 32) | (generation << 1) | owned-changed
  unsigned long long* flags[MAX_SHARDS];
  unsigned long long* mine;          // this card's copy
  int ranks[MAX_SHARDS];             // the shards this card holds
  int G;                             // blocks per shard (net slots)
  int ncopies;                       // cards of the mesh (flag copies)
  int lag2;                          // the lag-2 schedule
  int sys;                           // the mesh spans cards: system scope
  unsigned epoch;                    // this call's tag, from 1
};

// NODE: where a net's members meet (planes_relax_node_launch)
struct Node {
  // member r's inbox, on its card: [B][2][payload] floats, generation g
  // in slot g & 1
  float* inbox[MAX_SHARDS];
  // every card's copy of the flag words [B][members][2], as Peer's
  unsigned long long* flags[MAX_SHARDS];
  unsigned long long* mine;          // this card's copy
  // the cross-segment scan schedules (route/planes_kernels.py
  // node_tables): at [2 r + dir] the offset of member r's table of
  // direction dir (0 forward, 1 backward): nslots, len, ops1, ops2, npub,
  // ninj, in_slot[len], out_slot[len], ops1 and ops2 (left, right, out
  // slot triples), pub (slot, atom, reader mask), inj (slot, atom)
  const int* sched;
  float* xs;                         // scan workspace: [grid][2][nslots][lines]
  int ranks[MAX_SHARDS];             // the members this card holds
  int G;                             // blocks per member (net slots)
  int ncopies;                       // cards of the row (flag copies)
  int sys;                           // the row spans cards: system scope
  unsigned epoch;                    // this call's tag, from 1
  long long payload;                 // floats of one inbox generation
  int nslots;                        // the most slots of a member's line
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}

// the bf16 plane mode's rounding: f32 -> bfloat16 (nearest even) -> f32
__device__ __forceinline__ float rnd16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a read-only load of an input plane element
__device__ __forceinline__ float ldp(const float* p) { return __ldg(p); }

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

// Scan scratch of one line of n cells: (c, m) and one float of padding,
// so that the lines of a warp start in different banks.
__host__ __device__ __forceinline__ int line_scratch(int n) {
  return 2 * n + 1;
}

// Scan scratch floats of one plane's lines in a warp: 32 / G lines of n
// cells at once.
__host__ __device__ __forceinline__ int plane_scratch(int n) {
  return line_scratch(n) * (32 / line_lanes(n));
}

// Scan scratch floats per warp: the more of the two planes' (the chanx
// plane's lines have X cells, the chany plane's Y).
__host__ __device__ __forceinline__ int scratch_per_warp(int X, int Y) {
  const int sx = plane_scratch(X), sy = plane_scratch(Y);
  return sx > sy ? sx : sy;
}

// Per-net views of what a sweep reads besides dist: the geometry (flags,
// switch delays, track directions) and the congestion, in global memory,
// offset to the net's own rows.
struct Geo {
  const uint8_t *bbx, *bax, *fsx, *lsx;      // x plane: brk before / after,
  const uint8_t *bby, *bay, *fsy, *lsy;      //   first, last; y plane
  const float *dlx, *dly, *rot0, *rot1;      // delays
  const uint8_t* inc;                        // [W] (directional only)
};

// One net's addressing.  A cell is named by its local coordinates (t, x,
// y) on the net's own planes (the canvas, the tile or the shard's block);
// lx / ly index the state in shared memory (or the workspace), ix / iy
// the net's input and output rows, gx / gy the geometry.  Q: the bf16
// plane mode.
template <int K, bool SMEM, bool Q>
struct Net {
  // the block is one shard of the net (its column block)
  static constexpr bool SHARD = K == CLUSTER || K == PEER || K == NODE;
  const Args& a;
  int b, r;
  float crit;
  long long row, gx0, gy0;
  // origins of the chanx planes (ox, oy) and of the chany planes (ox2,
  // oy2): TILE the placed origins; SHARD ox = ox2 = r*kx - 1, oy = 0
  int ox, oy, ox2, oy2;
  // the net's rows of the plane arrays: inputs, congestion, outputs
  const float *d0x, *d0y, *w0x, *w0y, *ccxp, *ccyp;
  float *odx, *ody, *owx, *owy;
  Geo g;

  __device__ Net(const Args& a_, int b_, int r_) : a(a_), b(b_), r(r_) {
    crit = a.crit[b];
    row = (long long)b * a.nc;
    const long long gi = SHARD ? r : b;
    gx0 = gi * a.g_sx;
    gy0 = gi * a.g_sy;
    ox = oy = 0;
    if (K == TILE) {
      const int o = __ldg(a.ox + b), p = __ldg(a.oy + b);
      ox = place_origin(o, a.NX, a.ox_hi);
      ox2 = place_origin(o, a.NX + 1, a.ox_hi);
      oy = place_origin(p, a.stride_x, a.oy_hi);
      oy2 = place_origin(p, a.stride_x - 1, a.oy_hi);
    } else if (SHARD) {
      ox = r * a.kx - 1;           // local column 0 is padded column r*kx
    }
    if (K != TILE) {
      ox2 = ox;
      oy2 = oy;
    }
    d0x = a.d0x + row; d0y = a.d0y + row;
    w0x = a.w0x + row; w0y = a.w0y + row;
    ccxp = a.ccx + row; ccyp = a.ccy + row;
    odx = a.dx + row; ody = a.dy + row;
    owx = a.wx + row; owy = a.wy + row;
    g.bbx = a.brk_before_x + gx0; g.bax = a.brk_after_x + gx0;
    g.fsx = a.first_x + gx0; g.lsx = a.last_x + gx0;
    g.bby = a.brk_before_y + gy0; g.bay = a.brk_after_y + gy0;
    g.fsy = a.first_y + gy0; g.lsy = a.last_y + gy0;
    g.dlx = a.delay_x + gx0; g.dly = a.delay_y + gy0;
    g.rot0 = a.delay_y_rot0 + gy0; g.rot1 = a.delay_y_rot1 + gy0;
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
    return K != FULL ? (t * a.NX + ox + x) * a.stride_x + oy + y
                     : lx(t, x, y);
  }
  __device__ int iy(int t, int x, int y) const {
    return K != FULL
               ? (t * (a.NX + 1) + ox2 + x) * (a.stride_x - 1) + oy2 + y
               : ly(t, x, y);
  }
  // index in the geometry arrays
  __device__ int gx(int t, int x, int y) const {
    return K == TILE ? ix(t, x, y) : lx(t, x, y);
  }
  __device__ int gy(int t, int x, int y) const {
    return K == TILE ? iy(t, x, y) : ly(t, x, y);
  }
  // SHARD: local column x is a real canvas column, not padding
  __device__ bool realx(int x) const {
    return !SHARD || (unsigned)(ox + x) < (unsigned)a.NX;
  }
  __device__ bool realy(int x) const {
    return !SHARD || (unsigned)(ox + x) <= (unsigned)a.NX;
  }
  // global flat cell ids (pred payload); SHARD clamps a pad column's
  // into the canvas, as planes_shard._geom_blocks does (a pad cell stays
  // INF, so its id never surfaces)
  __device__ int idx(int t, int x, int y) const {
    if (!SHARD) return ix(t, x, y);
    return (t * a.NX + min(max(ox + x, 0), a.NX - 1)) * a.stride_x + y;
  }
  __device__ int idy(int t, int x, int y) const {
    if (!SHARD) return a.ncx + iy(t, x, y);
    return a.ncx + (t * (a.NX + 1) + min(max(ox + x, 0), a.NX)) *
                       (a.stride_x - 1) + y;
  }
  __device__ int par(int x, int y) const {
    if (K == FULL) return (x + y) & 1;
    return (ox2 + x + oy + y) & 1;
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
  // the local x columns the change flag covers: SHARD the owned 1..kx
  __device__ bool own(int x) const {
    return !SHARD || (x >= 1 && x <= a.kx);
  }
  __device__ float cost_x(int t, int x, int y) const {
    return fadd(__fmul_rn(crit, rd(g.dlx + gx(t, x, y))), ccx(t, x, y));
  }
  __device__ float cost_y(int t, int x, int y) const {
    return fadd(__fmul_rn(crit, rd(g.dly + gy(t, x, y))), ccy(t, x, y));
  }
  // the cell's pred / wenter are returned (SHARD: owned real columns;
  // no other cell's payload is ever read)
  __device__ bool keeps_x(int x) const { return own(x) && realx(x); }
  __device__ bool keeps_y(int x) const { return own(x) && realy(x); }
  __device__ void put_x(int t, int x, int y, int p, float w) const {
    if (keeps_x(x)) {
      const int i = ix(t, x, y);
      a.px[row + i] = p;
      owx[i] = q(w);
    }
  }
  __device__ void put_y(int t, int x, int y, int p, float w) const {
    if (keeps_y(x)) {
      const int i = iy(t, x, y);
      a.py[row + i] = p;
      owy[i] = q(w);
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
  const int G = line_lanes(len);
  const int gpw = 32 / G, q = lane & (G - 1), grp = lane / G;
  float* c = scr + warp * scratch_per_warp(a.X, a.Y) +
             grp * line_scratch(len);
  float* m = c + len;
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
// Any row length: dc = blockDim.x % C < C and dr < R, so a step wraps c
// and r at most once each (a row longer than the block has dc =
// blockDim.x, drow = 0).
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

// One sweep's four phases over dist (dx, dy); cx / cy the scan costs in
// shared memory (null: computed).  Returns "an owned cell improved" for
// this thread; the caller holds the barrier after the turn into x.
template <int K, bool SMEM, bool Q>
__device__ bool sweep(const Net<K, SMEM, Q>& n, const Args& a,
                      const Walk& walk_y, const Walk& walk_x, float* dx,
                      float* dy, const float* cx, const float* cy,
                      float* scr) {
  bool mine = scan_phase<K, SMEM, Q, true>(n, a, dx, cx, scr);
  __syncthreads();
  mine |= turn_into_y<K, SMEM, Q>(n, a, walk_y, dx, dy);
  __syncthreads();
  mine |= scan_phase<K, SMEM, Q, false>(n, a, dy, cy, scr);
  __syncthreads();
  mine |= turn_into_x<K, SMEM, Q>(n, a, walk_x, dy, dx);
  return mine;
}

// PEER: the flag words, read with acquire and written with release at
// system scope across cards (GPU scope when the mesh is one card)
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p, bool sys) {
  unsigned long long v;
  if (sys)
    asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v, bool sys) {
  if (sys)
    asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

// PEER, NODE: thread 0 publishes the word (epoch, gen, changed) of net
// b's shard (member) r into every card's copy of the flag words [B][s][2],
// after a fence at the mesh's scope (the caller's barrier first: the
// block's stores of generation gen are out)
__device__ void flag_publish(const Args& a, unsigned long long* const* flags,
                             int ncopies, bool sys, unsigned epoch, int b,
                             int r, int gen, bool changed) {
  if (threadIdx.x != 0) return;
  if (sys)
    __threadfence_system();
  else
    __threadfence();
  const unsigned long long w = ((unsigned long long)epoch << 32) |
                               ((unsigned long long)gen << 1) |
                               (changed ? 1ULL : 0ULL);
  const long long at = ((long long)b * a.shards + r) * 2 + (gen & 1);
  for (int c = 0; c < ncopies; ++c) st_release(flags[c] + at, w, sys);
}

// PEER, NODE: wait until every shard (member) of net b has published
// generation gen into this card's copy ``mine``; returns the OR of their
// flags, the same at every partner.  Thread k < shards spins on shard
// k's word, bounded: past SPIN_LIMIT cycles it traps.
__device__ bool flag_wait(const Args& a, const unsigned long long* mine,
                          unsigned epoch, bool sys, int b, int gen) {
  bool ch = false;
  if (threadIdx.x < a.shards) {
    const unsigned long long* w =
        mine + ((long long)b * a.shards + threadIdx.x) * 2 + (gen & 1);
    const unsigned long long want =
        ((unsigned long long)epoch << 31) | (unsigned long long)gen;
    const long long t0 = clock64();
    unsigned long long v;
    while (((v = ld_acquire(w, sys)) >> 1) != want)
      if (clock64() - t0 > SPIN_LIMIT) __trap();
    ch = (v & 1) != 0;
  }
  return __syncthreads_or(ch) != 0;
}

// PEER: floats of one net's halo mailbox generation: [left dx column |
// left dy column | right dx column | right dy columns 1, 2], each column
// [W, Y+1] (dx) or [W, Y] (dy)
__device__ __forceinline__ long long halo_len(const Args& a) {
  return 2LL * a.W * (a.Y + 1) + 3LL * a.W * a.Y;
}

// PEER: store generation `gen` of this block's owned boundary columns
// into its neighbours' mailboxes (the right one's left part: dx and dy
// column kx; the left one's right part: dx column 1, dy columns 1..2),
// then publish (epoch, gen, changed) into every card's flag words.
__device__ void peer_publish(const Args& a, const Peer& p, const float* dx,
                             const float* dy, int b, int r, int gen,
                             bool changed) {
  const int W = a.W, X = a.X, Y = a.Y, kx = a.kx;
  const int nx = W * (Y + 1), ny = W * Y;
  const long long slot = ((long long)b * 3 + gen % 3) * halo_len(a);
  float* L = r + 1 < a.shards ? p.mbox[r + 1] + slot : nullptr;
  float* R = r > 0 ? p.mbox[r - 1] + slot + nx + ny : nullptr;
  for (int k = threadIdx.x; k < 2 * nx + 3 * ny; k += blockDim.x) {
    if (k < nx + ny) {
      if (!L) continue;
      if (k < nx) {
        const int t = k / (Y + 1), y = k - t * (Y + 1);
        L[k] = dx[(t * X + kx) * (Y + 1) + y];
      } else {
        const int q = k - nx, t = q / Y, y = q - t * Y;
        L[k] = dy[(t * (X + 1) + kx) * Y + y];
      }
    } else {
      if (!R) continue;
      const int q = k - nx - ny;
      if (q < nx) {
        const int t = q / (Y + 1), y = q - t * (Y + 1);
        R[q] = dx[(t * X + 1) * (Y + 1) + y];
      } else {
        const int q2 = q - nx, j = q2 / ny, c = q2 - j * ny;
        const int t = c / Y, y = c - t * Y;
        R[q] = dy[(t * (X + 1) + 1 + j) * Y + y];
      }
    }
  }
  __syncthreads();
  flag_publish(a, p.flags, p.ncopies, p.sys, p.epoch, b, r, gen, changed);
}

// PEER: wait until every shard of net b has published generation `gen`;
// returns the OR of their owned-changed flags (of sweep gen - 1).
__device__ bool peer_wait(const Args& a, const Peer& p, int b, int gen) {
  return flag_wait(a, p.mine, p.epoch, p.sys, b, gen);
}

// PEER: write this block's dist halo columns from its mailbox generation
// `gen` (dx col 0, dy col 0 from the left neighbour; dx col kx+1, dy cols
// kx+1..kx+2 from the right one), INF at the edge shards.  The mailbox
// was written by other blocks, other cards: read through L2.
__device__ void peer_install(const Args& a, const Peer& p, float* dx,
                             float* dy, int b, int r, int gen) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, kx = a.kx;
  const int nx = W * (Y + 1), ny = W * Y;
  const float* M = p.mbox[r] + ((long long)b * 3 + gen % 3) * halo_len(a);
  const bool left = r > 0, right = r + 1 < a.shards;
  for (int k = threadIdx.x; k < 2 * nx + 3 * ny; k += blockDim.x) {
    if (k < nx) {
      const int t = k / (Y + 1), y = k - t * (Y + 1);
      dx[(t * X) * (Y + 1) + y] = left ? __ldcg(M + k) : INF;
    } else if (k < nx + ny) {
      const int q = k - nx, t = q / Y, y = q - t * Y;
      dy[(t * (X + 1)) * Y + y] = left ? __ldcg(M + k) : INF;
    } else if (k < 2 * nx + ny) {
      const int q = k - nx - ny, t = q / (Y + 1), y = q - t * (Y + 1);
      dx[(t * X + kx + 1) * (Y + 1) + y] = right ? __ldcg(M + k) : INF;
    } else {
      const int q = k - 2 * nx - ny, j = q / ny, c = q - j * ny;
      const int t = c / Y, y = c - t * Y;
      dy[(t * (X + 1) + kx + 1 + j) * Y + y] = right ? __ldcg(M + k) : INF;
    }
  }
}

// NODE: one combine of the cross-segment scan on line ln of the slot
// workspace (C, M: [slot][line]); op = (left slot, right slot, out slot)
__device__ __forceinline__ void node_comb(float* C, float* M, int nl, int ln,
                                          const int* op) {
  const long long l = (long long)__ldg(op) * nl + ln;
  const long long h = (long long)__ldg(op + 1) * nl + ln;
  const long long o = (long long)__ldg(op + 2) * nl + ln;
  const float cb = C[h];
  C[o] = fadd(C[l], cb);
  M[o] = fminf(fadd(M[l], cb), M[h]);
}

// NODE: member r's scan table of direction dir (Node.sched)
__device__ __forceinline__ const int* node_table(const Node& p, int r,
                                                 int dir) {
  return p.sched + __ldg(p.sched + 2 * r + dir);
}

// NODE: the inbox floats of net b's generation gen
__device__ __forceinline__ long long node_slot(const Node& p, int b,
                                               int gen) {
  return ((long long)b * 2 + (gen & 1)) * p.payload;
}

// NODE: phase 1 of the x-scan in direction rev over this thread's lines
// (line ln = t * (Y+1) + y, one thread a line): the member's cells (local
// columns 1..len) loaded as scan_phase loads them, its local combines,
// and its published values stored into the reading members' inboxes at
// generation gen.
template <int K, bool SMEM, bool Q>
__device__ void node_phase1(const Net<K, SMEM, Q>& n, const Args& a,
                            const Node& p, const float* d, const float* cs,
                            int rev, int gen) {
  const float INF = __int_as_float(0x7f800000);
  const int* T = node_table(p, n.r, rev);
  const int len = __ldg(T + 1), n1 = __ldg(T + 2), n2 = __ldg(T + 3);
  const int npub = __ldg(T + 4);
  const int* in_slot = T + 6;
  const int* ops1 = T + 6 + 2 * len;
  const int* pub = ops1 + 3 * (n1 + n2);
  const int nl = a.W * (a.Y + 1);
  float* C = p.xs + (long long)blockIdx.x * 2 * p.nslots * nl;
  float* M = C + (long long)p.nslots * nl;
  const long long slot = node_slot(p, n.b, gen);
  const uint8_t* brk = rev ? n.g.bax : n.g.bbx;
  for (int ln = threadIdx.x; ln < nl; ln += blockDim.x) {
    const int t = ln / (a.Y + 1), y = ln - t * (a.Y + 1);
    const bool inc = a.directional ? n.inc(t) : false;
    const bool blocked = a.directional && (rev ? inc : !inc);
    for (int i = 0; i < len; ++i) {
      const int x = 1 + i, l = n.lx(t, x, y);
      float cv = 0.0f;
      if (n.rd(brk + n.gx(t, x, y)))
        cv = blocked ? INF : (cs ? cs[l] : n.cost_x(t, x, y));
      const long long s = (long long)__ldg(in_slot + i) * nl + ln;
      C[s] = cv;
      M[s] = d[n.dxi(l, t, x, y)];
    }
    for (int k = 0; k < n1; ++k) node_comb(C, M, nl, ln, ops1 + 3 * k);
    for (int k = 0; k < npub; ++k) {
      const long long s = (long long)__ldg(pub + 3 * k) * nl + ln;
      const int at = __ldg(pub + 3 * k + 1), mask = __ldg(pub + 3 * k + 2);
      const long long o = slot + ((long long)at * nl + ln) * 2;
      const float cv = C[s], mv = M[s];
      for (int q = 0; q < a.shards; ++q)
        if ((mask >> q) & 1) {
          p.inbox[q][o] = cv;
          p.inbox[q][o + 1] = mv;
        }
    }
  }
}

// NODE: phase 2 of the x-scan in direction rev: the other members' values
// of generation gen read from this member's inbox, the crossing combines,
// and the member's own cells updated as scan_phase updates them.  Returns
// "an owned cell improved" for this thread.
template <int K, bool SMEM, bool Q>
__device__ bool node_phase2(const Net<K, SMEM, Q>& n, const Args& a,
                            const Node& p, float* d, int rev, int gen) {
  const int* T = node_table(p, n.r, rev);
  const int len = __ldg(T + 1), n1 = __ldg(T + 2), n2 = __ldg(T + 3);
  const int npub = __ldg(T + 4), ninj = __ldg(T + 5);
  const int* out_slot = T + 6 + len;
  const int* ops2 = T + 6 + 2 * len + 3 * n1;
  const int* inj = ops2 + 3 * n2 + 3 * npub;
  const int nl = a.W * (a.Y + 1);
  float* C = p.xs + (long long)blockIdx.x * 2 * p.nslots * nl;
  float* M = C + (long long)p.nslots * nl;
  const float* box = p.inbox[n.r] + node_slot(p, n.b, gen);
  const uint8_t* brk = rev ? n.g.bax : n.g.bbx;
  const int step = a.stride_x;
  bool mine = false;
  for (int ln = threadIdx.x; ln < nl; ln += blockDim.x) {
    const int t = ln / (a.Y + 1), y = ln - t * (a.Y + 1);
    for (int k = 0; k < ninj; ++k) {
      const long long s = (long long)__ldg(inj + 2 * k) * nl + ln;
      const long long o = ((long long)__ldg(inj + 2 * k + 1) * nl + ln) * 2;
      C[s] = __ldcg(box + o);
      M[s] = __ldcg(box + o + 1);
    }
    for (int k = 0; k < n2; ++k) node_comb(C, M, nl, ln, ops2 + 3 * k);
    for (int i = 0; i < len; ++i) {
      const int x = 1 + i, l = n.lx(t, x, y);
      const int di = n.dxi(l, t, x, y);
      const float old = d[di];
      const float v = M[(long long)__ldg(out_slot + i) * nl + ln];
      if (v < old) {
        d[di] = v;
        const int gl = n.gx(t, x, y);
        const int id = n.idx(t, x, y) + (rev ? step : -step);
        const float w = n.rd(brk + gl) ? n.rd(n.g.dlx + gl) : 0.0f;
        n.put_x(t, x, y, id, w);
        mine |= n.changes(x, v, old);
      }
    }
  }
  return mine;
}

// NODE: publish generation gen of net b's member r, after this block's
// stores of it
__device__ void node_signal(const Args& a, const Node& p, int b, int r,
                            int gen, bool changed) {
  __syncthreads();
  flag_publish(a, p.flags, p.ncopies, p.sys, p.epoch, b, r, gen, changed);
}

// NODE: wait for generation gen of every member of net b; the OR of their
// flags
__device__ bool node_wait(const Args& a, const Node& p, int b, int gen) {
  return flag_wait(a, p.mine, p.epoch, p.sys, b, gen);
}

// NODE: the dx halo.  Member r stores its column kx into member r+1's
// inbox; member r > 0 reads its column 0 from its own.
__device__ void node_send_dx(const Args& a, const Node& p, const float* dx,
                             int b, int r, int gen) {
  if (r + 1 >= a.shards) return;
  const int X = a.X, Y = a.Y, kx = a.kx, nx = a.W * (Y + 1);
  float* L = p.inbox[r + 1] + node_slot(p, b, gen);
  for (int k = threadIdx.x; k < nx; k += blockDim.x) {
    const int t = k / (Y + 1), y = k - t * (Y + 1);
    L[k] = dx[(t * X + kx) * (Y + 1) + y];
  }
}

__device__ void node_recv_dx(const Args& a, const Node& p, float* dx, int b,
                             int r, int gen) {
  if (r == 0) return;
  const int X = a.X, Y = a.Y, nx = a.W * (Y + 1);
  const float* M = p.inbox[r] + node_slot(p, b, gen);
  for (int k = threadIdx.x; k < nx; k += blockDim.x) {
    const int t = k / (Y + 1), y = k - t * (Y + 1);
    dx[(t * X) * (Y + 1) + y] = __ldcg(M + k);
  }
}

// NODE: the dy halo.  Member r > 0 stores its column 1 into member r-1's
// inbox; member r reads its column kx+1 from its own.
__device__ void node_send_dy(const Args& a, const Node& p, const float* dy,
                             int b, int r, int gen) {
  if (r == 0) return;
  const int X = a.X, Y = a.Y, ny = a.W * Y;
  float* R = p.inbox[r - 1] + node_slot(p, b, gen);
  for (int k = threadIdx.x; k < ny; k += blockDim.x) {
    const int t = k / Y, y = k - t * Y;
    R[k] = dy[(t * (X + 1) + 1) * Y + y];
  }
}

__device__ void node_recv_dy(const Args& a, const Node& p, float* dy, int b,
                             int r, int gen) {
  if (r + 1 >= a.shards) return;
  const int X = a.X, Y = a.Y, kx = a.kx, ny = a.W * Y;
  const float* M = p.inbox[r] + node_slot(p, b, gen);
  for (int k = threadIdx.x; k < ny; k += blockDim.x) {
    const int t = k / Y, y = k - t * Y;
    dy[(t * (X + 1) + kx + 1) * Y + y] = __ldcg(M + k);
  }
}

// Shared-memory modes: 0 all state in global memory (only the scan
// scratch in shared); 1 dist in shared; 2 dist and scan costs.  SMEM =
// mode >= 1; a.cost_smem = mode == 2.  Layout: floats [dx | dy | cost_x |
// cost_y | scratch], then (CLUSTER) two ints of owned-change flags.  In
// mode 0 the f32 working dist is the output (FULL; TILE: the output
// flats themselves) or the block's workspace in ws (CLUSTER, PEER).
// Net b, shard r; pp: PEER's meeting place, np NODE's (null for the other
// kinds).
template <int K, bool SMEM, bool Q>
__device__ void relax_net(const Args& a, int b, int r, const Peer* pp,
                          const Node* np = nullptr) {
  extern __shared__ float smem[];
  const float INF = __int_as_float(0x7f800000);
  constexpr bool SHARD = Net<K, SMEM, Q>::SHARD;
  const int tid = threadIdx.x, nth = blockDim.x;
  const Net<K, SMEM, Q> n(a, b, r);
  const int W = a.W, X = a.X, Y = a.Y;
  const int nxc = W * X * (Y + 1), nyc = W * (X + 1) * Y;
  float* f = smem;
  float *dx = nullptr, *dy = nullptr, *cx = nullptr, *cy = nullptr;
  if (SMEM) {
    dx = f; f += nxc;
    dy = f; f += nyc;
    if (a.cost_smem) {
      cx = f; f += nxc;
      cy = f; f += nyc;
    }
  } else if (SHARD) {
    dx = a.ws + (long long)blockIdx.x * (nxc + nyc);
    dy = dx + nxc;
  } else {
    dx = a.dx + n.row;
    dy = a.dy + n.row;
  }
  float* scr = f;
  int* flag = (int*)(scr + (nth >> 5) * scratch_per_warp(X, Y));

  if constexpr (K == PEER || K == NODE)
    __syncthreads();                 // the block's previous net is out
  if constexpr (K == TILE) {
    // the net's whole output row: d0, the cell's own id, wenter0 (as
    // given, in either plane mode: cells outside the tile are returned
    // unchanged); the tile is relaxed on top of it.  Four cells per
    // thread per round, loads first, so the row costs a quarter of the
    // load latencies.
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
          a.px[n.row + l] = l;
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
      if (K == FULL) {
        n.owx[l] = n.q(ldp(n.w0x + l));
        a.px[n.row + l] = n.idx(t, x, y);
      } else if (SHARD && n.keeps_x(x)) {
        n.owx[i] = n.q(ldp(n.w0x + i));
        a.px[n.row + i] = n.idx(t, x, y);
      } else if (K == TILE && Q) {
        n.owx[i] = n.q(ldp(n.w0x + i));
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
      if (K == FULL) {
        n.owy[l] = n.q(ldp(n.w0y + l));
        a.py[n.row + l] = n.idy(t, x, y);
      } else if (SHARD && n.keeps_y(x)) {
        n.owy[i] = n.q(ldp(n.w0y + i));
        a.py[n.row + i] = n.idy(t, x, y);
      } else if (K == TILE && Q) {
        n.owy[i] = n.q(ldp(n.w0y + i));
      }
      if (cy) cy[l] = n.cost_y(t, x, y);
      walk_y.next(X + 1, Y, t, x, y);
    }
  }
  if constexpr (K == CLUSTER)
    cg::this_cluster().sync();       // every block initialised
  else
    __syncthreads();

  int i = 0, streak = 0;
  bool go = true;
  if constexpr (K == NODE) {
    const Node& p = *np;
    bool ch = true;                  // sweep -1: go
    for (;;) {
      // generations 4i .. 4i+3: the forward and backward x-scans' values,
      // the dx halo, the dy halo; the first carries sweep i-1's flag
      const int g0 = 4 * i;
      if (i < a.nsweeps) node_phase1(n, a, p, dx, cx, 0, g0);
      node_signal(a, p, b, r, g0, ch);
      const bool any = node_wait(a, p, b, g0);
      if (i > 0) go = any;
      if (!go || i >= a.nsweeps) break;
      bool mine = node_phase2(n, a, p, dx, 0, g0);
      node_phase1(n, a, p, dx, cx, 1, g0 + 1);
      node_signal(a, p, b, r, g0 + 1, false);
      node_wait(a, p, b, g0 + 1);
      mine |= node_phase2(n, a, p, dx, 1, g0 + 1);
      __syncthreads();               // the x-scanned column kx is out
      node_send_dx(a, p, dx, b, r, g0 + 2);
      node_signal(a, p, b, r, g0 + 2, false);
      node_wait(a, p, b, g0 + 2);
      node_recv_dx(a, p, dx, b, r, g0 + 2);
      __syncthreads();
      mine |= turn_into_y<K, SMEM, Q>(n, a, walk_y, dx, dy);
      __syncthreads();
      mine |= scan_phase<K, SMEM, Q, false>(n, a, dy, cy, scr);
      __syncthreads();
      node_send_dy(a, p, dy, b, r, g0 + 3);
      node_signal(a, p, b, r, g0 + 3, false);
      node_wait(a, p, b, g0 + 3);
      node_recv_dy(a, p, dy, b, r, g0 + 3);
      __syncthreads();
      mine |= turn_into_x<K, SMEM, Q>(n, a, walk_x, dy, dx);
      ch = __syncthreads_or(mine) != 0;
      if (Q) {
        round_dy(n, a, walk_y, dy);
        __syncthreads();
      }
      ++i;
    }
  } else if constexpr (K == PEER) {
    const Peer& p = *pp;
    peer_publish(a, p, dx, dy, b, r, 0, false);
    for (;;) {
      // every shard's generation i is out, with its sweep i-1's flag
      const bool any = peer_wait(a, p, b, i);
      if (i > 0) {
        if (p.lag2) {
          streak = any ? 0 : streak + 1;
          go = streak < 2;
        } else {
          go = any;
        }
      }
      if (!go || i >= a.nsweeps) break;
      peer_install(a, p, dx, dy, b, r, p.lag2 && i > 0 ? i - 1 : i);
      __syncthreads();
      const bool mine = sweep(n, a, walk_y, walk_x, dx, dy, cx, cy, scr);
      const bool ch = __syncthreads_or(mine) != 0;
      if (Q) {
        round_dy(n, a, walk_y, dy);
        __syncthreads();             // the rounded dy before its export
      }
      ++i;
      peer_publish(a, p, dx, dy, b, r, i, ch);
    }
  } else {
    while (go && i < a.nsweeps) {
      if constexpr (K == CLUSTER) {
        halo_copy<SMEM>(a, dx, dy, r, (long long)nxc + nyc);
        cg::this_cluster().sync();   // halos in before any owned write
      }
      const bool mine = sweep(n, a, walk_y, walk_x, dx, dy, cx, cy, scr);
      if constexpr (K == CLUSTER) {
        // slot i & 1 is rewritten two sweeps later, after every CTA has
        // passed the next halo barrier, so no CTA can still be reading
        // it; dy is rounded before the barrier after which the
        // neighbours read its halo columns
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
  }
  if constexpr (K == CLUSTER)
    cg::this_cluster().sync();       // no CTA leaves while read remotely

  if (SMEM || SHARD) {
    int t = walk_x.t0, x = walk_x.r0, y = walk_x.c0;
    for (int l = tid; l < nxc; l += nth) {
      if (n.keeps_x(x)) n.odx[n.ix(t, x, y)] = dx[l];
      walk_x.next(X, Y + 1, t, x, y);
    }
    t = walk_y.t0; x = walk_y.r0; y = walk_y.c0;
    for (int l = tid; l < nyc; l += nth) {
      if (n.keeps_y(x)) n.ody[n.iy(t, x, y)] = dy[l];
      walk_y.next(X + 1, Y, t, x, y);
    }
  }
  if (tid == 0 && r == 0) {
    const int drop = K == PEER && pp->lag2 ? streak : (go ? 0 : 1);
    const int useful = i - drop > 0 ? i - drop : 0;
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
planes_relax_full_kernel(Args a) {
  relax_net<FULL, SMEM, Q>(a, blockIdx.x, 0, nullptr);
}

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_cropped_kernel(Args a) {
  relax_net<TILE, SMEM, Q>(a, blockIdx.x, 0, nullptr);
}

template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_cluster_kernel(Args a) {
  const int b = blockIdx.x / a.shards;
  relax_net<CLUSTER, SMEM, Q>(a, b, blockIdx.x - b * a.shards, nullptr);
}

// block k of a card: shard ranks[k / G], net slot j = k % G, the nets
// j, j+G, j+2G, ... in order
template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_peer_kernel(Args a, Peer p) {
  const int j = blockIdx.x % p.G, r = p.ranks[blockIdx.x / p.G];
  for (int b = j; b < a.B; b += p.G) relax_net<PEER, SMEM, Q>(a, b, r, &p);
}

// block k of a card: member ranks[k / G], net slot j = k % G (the peer
// kernel's plan)
template <bool SMEM, bool Q>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_node_kernel(Args a, Node p) {
  const int j = blockIdx.x % p.G, r = p.ranks[blockIdx.x / p.G];
  for (int b = j; b < a.B; b += p.G)
    relax_net<NODE, SMEM, Q>(a, b, r, nullptr, &p);
}

// the launch tables: p[NPTR] pointers, v[NINT] integers (the wrapper's
// layout, route/planes_kernels.py)
//   p: 0..5 d0x d0y ccx ccy w0x w0y, 6 crit, 7..12 dx dy px py wx wy,
//      13 stats, 14..25 geometry, 26 inc_track, 27 total [2] (zeroed
//      here, or 0), 28 ox, 29 oy, 30 ws
//   v: 0 B, 1 W, 2 X, 3 Y, 4 stride_x, 5 directional, 6 nsweeps,
//      7 g_sx, 8 g_sy, 9 threads, 10 mode (-1: auto), 11 device, 12 NX,
//      13 ncx, 14 nc, 15 ox_hi, 16 oy_hi, 17 shards, 18 kx, 19 plane
//      mode (0 f32, 1 bf16)
Args unpack(const void* const* p, const long long* v) {
  Args a;
  a.d0x = (const float*)p[0]; a.d0y = (const float*)p[1];
  a.ccx = (const float*)p[2]; a.ccy = (const float*)p[3];
  a.w0x = (const float*)p[4]; a.w0y = (const float*)p[5];
  a.crit = (const float*)p[6];
  a.dx = (float*)p[7]; a.dy = (float*)p[8];
  a.px = (int32_t*)p[9]; a.py = (int32_t*)p[10];
  a.wx = (float*)p[11]; a.wy = (float*)p[12];
  a.stats = (int32_t*)p[13];
  a.brk_before_x = (const uint8_t*)p[14]; a.brk_after_x = (const uint8_t*)p[15];
  a.first_x = (const uint8_t*)p[16]; a.last_x = (const uint8_t*)p[17];
  a.brk_before_y = (const uint8_t*)p[18]; a.brk_after_y = (const uint8_t*)p[19];
  a.first_y = (const uint8_t*)p[20]; a.last_y = (const uint8_t*)p[21];
  a.delay_x = (const float*)p[22]; a.delay_y = (const float*)p[23];
  a.delay_y_rot0 = (const float*)p[24]; a.delay_y_rot1 = (const float*)p[25];
  a.inc_track = (const uint8_t*)p[26];
  a.total = (int32_t*)p[27];
  a.ox = (const int32_t*)p[28]; a.oy = (const int32_t*)p[29];
  a.ws = (float*)p[30];
  a.B = (int)v[0];
  a.W = (int)v[1]; a.X = (int)v[2]; a.Y = (int)v[3];
  a.stride_x = (int)v[4]; a.directional = (int)v[5]; a.nsweeps = (int)v[6];
  a.g_sx = v[7]; a.g_sy = v[8];
  a.cost_smem = 0;
  a.NX = (int)v[12]; a.ncx = (int)v[13]; a.nc = (int)v[14];
  a.ox_hi = (int)v[15]; a.oy_hi = (int)v[16];
  a.shards = (int)v[17]; a.kx = (int)v[18];
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

long long block_cells(const long long* v) {
  const long long W = v[1], X = v[2], Y = v[3];
  return W * X * (Y + 1) + W * (X + 1) * Y;
}

// dynamic shared bytes of a mode at `threads` threads (relax_net's
// layout)
long long smem_at(int kind, int mode, const long long* v, long long threads) {
  return 4 * (mode * block_cells(v) +
              threads / 32 * scratch_per_warp((int)v[2], (int)v[3])) +
         (kind == CLUSTER ? 2 * sizeof(int) : 0);
}

long long smem_bytes(int kind, int mode, const long long* v) {
  return smem_at(kind, mode, v, v[9]);
}

// The threads of a block (route/planes_kernels.py plan_threads): 1024 on
// a block of more than 4096 cells, else 512 (fewer warps at each
// barrier), halved while mode 0 would not fit SMEM_PLAN (lines longer
// than ~900 cells, one line of scratch per warp), so that every shape up
// to MAX_LINE has a mode that fits.  The table's v[9] must be this.
int plan_threads(int kind, const long long* v) {
  int t = block_cells(v) > 4096 ? MAX_THREADS : MIN_THREADS;
  while (t > MIN_THREADS && smem_at(kind, 0, v, t) > SMEM_PLAN) t /= 2;
  return t;
}

// The mode the launch takes for v[10] = -1: the most shared state that
// fits the card's per-block opt-in limit.
int auto_mode(int kind, const long long* v) {
  const long long cap = smem_optin((int)v[11]);
  for (int mode = 2; mode > 0; --mode)
    if (smem_bytes(kind, mode, v) <= cap) return mode;
  return 0;
}

int mode_of(int kind, const long long* v) {
  return v[10] < 0 ? auto_mode(kind, v) : (int)v[10];
}

#define PICK(k)                                                   \
  (q ? (s ? (const void*)k<true, true> : (const void*)k<false, true>) \
     : (s ? (const void*)k<true, false> : (const void*)k<false, false>))

// the kernel of a kind, shared-memory mode and plane mode (q: bf16)
const void* kernel_of(int kind, int mode, bool q) {
  const bool s = mode != 0;
  switch (kind) {
    case FULL: return PICK(planes_relax_full_kernel);
    case PEER: return PICK(planes_relax_peer_kernel);
    case TILE: return PICK(planes_relax_cropped_kernel);
    case NODE: return PICK(planes_relax_node_kernel);
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
  const int dev = (int)v[11];
  // the lines, the cells (route/planes_kernels.py check_kernel_shape
  // raises first) and the planner's threads
  if (v[2] < 1 || v[3] < 1 || v[2] > MAX_LINE || v[3] > MAX_LINE)
    return cudaErrorInvalidValue;
  if (block_cells(v) > MAX_CELLS || v[14] > MAX_CELLS)
    return cudaErrorInvalidValue;
  if (v[9] != plan_threads(kind, v)) return cudaErrorInvalidValue;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (kind == CLUSTER && (v[17] < 2 || v[17] > MAX_CLUSTER))
    return cudaErrorInvalidValue;
  if (kind == PEER && (v[17] < 2 || v[17] > MAX_SHARDS))
    return cudaErrorInvalidValue;
  if (kind == NODE && (v[17] < 1 || v[17] > MAX_SHARDS))
    return cudaErrorInvalidValue;
  if (v[19] != 0 && v[19] != 1) return cudaErrorInvalidValue;
  const bool q = v[19] == 1;
  cudaError_t e = cudaGetDevice(cur);
  if (e == cudaSuccess && *cur != dev) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  *mode = mode_of(kind, v);
  *bytes = smem_bytes(kind, *mode, v);
  *k = kernel_of(kind, *mode, q);
  if (*mode < 0 || *mode > 2 || *bytes > smem_optin(dev))
    return cudaErrorInvalidValue;
  static long long set[20][MAX_DEVICES] = {{0}};
  long long& done = set[4 * kind + 2 * q + (*mode == 0 ? 0 : 1)][dev];
  if (*bytes > 48 * 1024 && *bytes > done) {
    e = cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*bytes);
    if (e != cudaSuccess) return e;
    done = *bytes;
  }
  static bool wide[4][MAX_DEVICES] = {{false}};
  bool& wd = wide[2 * q + (*mode == 0 ? 0 : 1)][dev];
  if (kind == CLUSTER && v[17] > PORTABLE_CLUSTER && !wd) {
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
  cfg->gridDim = dim3((unsigned)(v[0] * v[17]));
  cfg->blockDim = dim3((unsigned)v[9]);
  cfg->dynamicSmemBytes = (size_t)bytes;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)v[17];
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

int launch(int kind, const void* const* p, const long long* v,
           void* stream) {
  const int B = (int)v[0], dev = (int)v[11];
  if (B <= 0) return 0;
  int cur = dev, mode = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(kind, v, &cur, &mode, &bytes, &k);
  Args a = unpack(p, v);
  a.cost_smem = mode == 2;
  if (e == cudaSuccess && kind == CLUSTER && mode == 0 && !a.ws)
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
      e = cudaLaunchKernel(k, dim3(B), dim3((unsigned)v[9]), args,
                           (size_t)bytes, (cudaStream_t)stream);
    }
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return (int)e;
}

// How many blocks of this PEER (or NODE) table the card holds at once (0:
// none, or no cooperative launch), or minus the CUDA error of the query.
int peer_fit(const long long* v, int kind = PEER) {
  const int dev = (int)v[11];
  int cur = dev, mode = 0, per_sm = 0, sms = 0, coop = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(kind, v, &cur, &mode, &bytes, &k);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k, (int)v[9], (size_t)bytes);
  if (cur != dev) cudaSetDevice(cur);
  if (e != cudaSuccess) return -(int)e;
  return coop ? per_sm * sms : 0;
}

// the PEER tables beside p and v:
//   q: 0..15 the mailboxes of ranks 0..shards-1, 16..31 the flag words'
//      copies (one per card of the mesh), 32 this card's copy
//   w: 0 G, 1 local shards n, 2..17 their ranks, 18 copies, 19 epoch,
//      20 lag2, 21 system scope, 22 zero the total here before the launch
int launch_peer(const void* const* p, const long long* v,
                const void* const* q, const long long* w, void* stream) {
  const int B = (int)v[0], dev = (int)v[11], s = (int)v[17];
  const long long G = w[0], nl = w[1], nc = w[18];
  if (B <= 0) return 0;
  if (G < 1 || G > B || nl < 1 || nl > s || nc < 1 || nc > MAX_SHARDS ||
      w[19] < 1 || w[19] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int cur = dev, mode = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(PEER, v, &cur, &mode, &bytes, &k);
  Args a = unpack(p, v);
  a.cost_smem = mode == 2;
  Peer pe;
  memset(&pe, 0, sizeof(pe));
  for (int r = 0; r < s && r < MAX_SHARDS; ++r) {
    pe.mbox[r] = (float*)q[r];
    if (!pe.mbox[r]) e = cudaErrorInvalidValue;
  }
  for (int c = 0; c < nc; ++c) {
    pe.flags[c] = (unsigned long long*)q[16 + c];
    if (!pe.flags[c]) e = cudaErrorInvalidValue;
  }
  pe.mine = (unsigned long long*)q[32];
  for (int i = 0; i < nl; ++i) {
    pe.ranks[i] = (int)w[2 + i];
    if (pe.ranks[i] < 0 || pe.ranks[i] >= s) e = cudaErrorInvalidValue;
  }
  pe.G = (int)G;
  pe.ncopies = (int)nc;
  pe.epoch = (unsigned)w[19];
  pe.lag2 = w[20] != 0;
  pe.sys = w[21] != 0;
  if (e == cudaSuccess && (!pe.mine || (mode == 0 && !a.ws)))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && w[22] && a.total)
    e = cudaMemsetAsync(a.total, 0, 2 * sizeof(int32_t),
                        (cudaStream_t)stream);
  if (e == cudaSuccess) {
    void* args[] = {&a, &pe};
    // cooperative: every block of the grid resident at once, or refused
    e = cudaLaunchCooperativeKernel(k, dim3((unsigned)(G * nl)),
                                    dim3((unsigned)v[9]), args,
                                    (size_t)bytes, (cudaStream_t)stream);
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return (int)e;
}

// the NODE tables beside p and v:
//   q: 0..15 the inboxes of members 0..shards-1, 16..31 the flag words'
//      copies (one per card of the row), 32 this card's copy, 33 the
//      schedule tables (this card's copy), 34 the scan workspace
//   w: 0 G, 1 local members n, 2..17 their ranks, 18 copies, 19 epoch,
//      20 unused, 21 system scope, 22 zero the total here before the
//      launch, 23 inbox floats of a generation, 24 the most slots of a line
int launch_node(const void* const* p, const long long* v,
                const void* const* q, const long long* w, void* stream) {
  const int B = (int)v[0], dev = (int)v[11], s = (int)v[17];
  const long long G = w[0], nl = w[1], nc = w[18];
  if (B <= 0) return 0;
  if (G < 1 || G > B || nl < 1 || nl > s || nc < 1 || nc > MAX_SHARDS ||
      w[19] < 1 || w[19] > 0x7fffffffLL || w[23] < 1 || w[24] < 1)
    return (int)cudaErrorInvalidValue;
  int cur = dev, mode = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(NODE, v, &cur, &mode, &bytes, &k);
  Args a = unpack(p, v);
  a.cost_smem = mode == 2;
  Node nd;
  memset(&nd, 0, sizeof(nd));
  for (int r = 0; r < s && r < MAX_SHARDS; ++r) {
    nd.inbox[r] = (float*)q[r];
    if (!nd.inbox[r]) e = cudaErrorInvalidValue;
  }
  for (int c = 0; c < nc; ++c) {
    nd.flags[c] = (unsigned long long*)q[16 + c];
    if (!nd.flags[c]) e = cudaErrorInvalidValue;
  }
  nd.mine = (unsigned long long*)q[32];
  nd.sched = (const int*)q[33];
  nd.xs = (float*)q[34];
  for (int i = 0; i < nl; ++i) {
    nd.ranks[i] = (int)w[2 + i];
    if (nd.ranks[i] < 0 || nd.ranks[i] >= s) e = cudaErrorInvalidValue;
  }
  nd.G = (int)G;
  nd.ncopies = (int)nc;
  nd.epoch = (unsigned)w[19];
  nd.sys = w[21] != 0;
  nd.payload = w[23];
  nd.nslots = (int)w[24];
  if (e == cudaSuccess &&
      (!nd.mine || !nd.sched || !nd.xs || (mode == 0 && !a.ws)))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && w[22] && a.total)
    e = cudaMemsetAsync(a.total, 0, 2 * sizeof(int32_t),
                        (cudaStream_t)stream);
  if (e == cudaSuccess) {
    void* args[] = {&a, &nd};
    e = cudaLaunchCooperativeKernel(k, dim3((unsigned)(G * nl)),
                                    dim3((unsigned)v[9]), args,
                                    (size_t)bytes, (cudaStream_t)stream);
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

// the whole sharded relaxation of every net, one cluster per net
extern "C" int planes_relax_cluster_launch(const void* const* p,
                                           const long long* v, void* stream) {
  return launch(CLUSTER, p, v, stream);
}

// one card's launch of the whole sharded relaxation of every net
extern "C" int planes_relax_peer_launch(const void* const* p,
                                        const long long* v,
                                        const void* const* q,
                                        const long long* w, void* stream) {
  return launch_peer(p, v, q, w, stream);
}

// How many clusters of this table the card can hold at once (0: it cannot
// schedule one), or minus the CUDA error that prevented the query.
extern "C" int planes_relax_cluster_fit(const long long* v) {
  int cur = (int)v[11], mode = 0, n = 0;
  long long bytes = 0;
  const void* k = nullptr;
  cudaError_t e = prepare(CLUSTER, v, &cur, &mode, &bytes, &k);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(v, bytes, nullptr, &cfg, &attr);
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  }
  if (cur != (int)v[11]) cudaSetDevice(cur);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int planes_relax_peer_fit(const long long* v) {
  return peer_fit(v);
}

// one card's launch of the node-axis relaxation of every net
extern "C" int planes_relax_node_launch(const void* const* p,
                                        const long long* v,
                                        const void* const* q,
                                        const long long* w, void* stream) {
  return launch_node(p, v, q, w, stream);
}

extern "C" int planes_relax_node_fit(const long long* v) {
  return peer_fit(v, NODE);
}

// zero a [2] int32 total on `stream` of card `device` (the peer
// relaxation across cards, before any card's launch)
extern "C" int planes_relax_zero_total(void* total, int device,
                                       void* stream) {
  int cur = device;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(total, 0, 2 * sizeof(int32_t), (cudaStream_t)stream);
  if (cur != device) cudaSetDevice(cur);
  return (int)e;
}

extern "C" int planes_relax_max_line() { return MAX_LINE; }

extern "C" long long planes_relax_max_cells() { return MAX_CELLS; }

// the planner's threads and dynamic shared bytes of a table (the Python
// mirror, route/planes_kernels.py plan_threads and smem_bytes, is held
// against these on the card)
extern "C" int planes_relax_threads(int kind, const long long* v) {
  return plan_threads(kind, v);
}

extern "C" long long planes_relax_smem(int kind, int mode,
                                       const long long* v) {
  return smem_at(kind, mode, v, plan_threads(kind, v));
}

// the shared-memory mode a launch of this kind with this table takes
// (kind: 0 full, 1 peer, 2 cropped, 3 cluster, 4 node)
extern "C" int planes_relax_mode(int kind, const long long* v) {
  return mode_of(kind, v);
}
