// Planes relaxation kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface loaded with ctypes (route/planes_kernels.py).
//
// Replaces the two TPU kernels of parallel_eda_tpu/route/planes_pallas.py:
//   planes_relax_full_kernel    <- planes_relax_pallas / _sweep_kernel
//                                  (planes_pallas.py:308 / :218, call :389)
//   planes_relax_cropped_kernel <- planes_relax_cropped_pallas /
//                                  _crop_sweep_kernel (:477 / :417, call :571)
// and, through planes_sweep_block_launch, the cropped kernel serves as the
// one-sweep step of each shard's column block in the row-sharded relaxation
// (parallel_eda_tpu/route/planes_shard.py planes_relax_sharded, its sweep
// at :369): nsweeps = 1, pred carried in (p0x/p0y), block geometry shared
// across nets (geometry stride 0), and the change flag restricted to the
// owned local x columns [own_lo, own_hi), so that with one sweep
// stats[b, 1] is net b's owned-changed flag.
//
// What they compute: the bounded planes relaxation of one net per thread
// block, to the exact fixpoint or `nsweeps` sweeps.  One sweep is
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
//   * 512-1024 threads per block; the fixpoint flag is __syncthreads_or.
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

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXL 64            // longest scan line (grid side) the kernels take
#define MAX_THREADS 1024
#define MAX_DEVICES 64

namespace {

struct Args {
  // inputs (per-net strides in_sx / in_sy, in elements)
  const float* d0x; const float* d0y;
  const float* ccx; const float* ccy;
  const float* w0x; const float* w0y;
  const float* crit;                 // [B]
  // state / outputs (per-net strides st_sx / st_sy)
  float* dx; float* dy;
  int32_t* px; int32_t* py;
  float* wx; float* wy;
  int32_t* stats;                    // [B, 2]
  int32_t* total;                    // [2]: max over nets (null: none)
  // geometry (per-net strides g_sx / g_sy / g_sp; 0 = shared)
  const uint8_t* brk_before_x; const uint8_t* brk_after_x;
  const uint8_t* first_x; const uint8_t* last_x;
  const uint8_t* brk_before_y; const uint8_t* brk_after_y;
  const uint8_t* first_y; const uint8_t* last_y;
  const float* delay_x; const float* delay_y;
  const float* delay_y_rot0; const float* delay_y_rot1;
  const uint8_t* inc_track;          // [W] (directional only)
  const int32_t* idxx; const int32_t* idxy;   // cropped only
  const int32_t* base_par;                    // cropped only [X+1, Y+1]
  const int32_t* p0x; const int32_t* p0y;     // pred in (null: own ids)
  int W, X, Y;                       // x plane [W, X, Y+1]; y plane [W, X+1, Y]
  int stride_x;                      // global NY+1
  int directional;
  int nsweeps;
  long long in_sx, in_sy, st_sx, st_sy, g_sx, g_sy, g_sp;
  int own_lo, own_hi;                // local x columns the change flag covers
  int cost_smem;                     // scan costs precomputed in shared
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
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
  const float *ccx, *ccy;                    // congestion
  const int32_t* par;                        // cropped only: [X+1, Y+1]
  const uint8_t* inc;                        // [W] (directional only)
};

template <bool CROP>
struct Net {
  const Args& a;
  int b;
  float crit;
  long long ix0, iy0, sx0, sy0, gx0, gy0;
  int ncx;
  Geo g;

  __device__ Net(const Args& a_, int b_) : a(a_), b(b_) {
    crit = a.crit[b];
    ix0 = (long long)b * a.in_sx;
    iy0 = (long long)b * a.in_sy;
    sx0 = (long long)b * a.st_sx;
    sy0 = (long long)b * a.st_sy;
    gx0 = (long long)b * a.g_sx;
    gy0 = (long long)b * a.g_sy;
    ncx = a.W * a.X * (a.Y + 1);
    g.bbx = a.brk_before_x + gx0; g.bax = a.brk_after_x + gx0;
    g.fsx = a.first_x + gx0; g.lsx = a.last_x + gx0;
    g.bby = a.brk_before_y + gy0; g.bay = a.brk_after_y + gy0;
    g.fsy = a.first_y + gy0; g.lsy = a.last_y + gy0;
    g.dlx = a.delay_x + gx0; g.dly = a.delay_y + gy0;
    g.rot0 = a.delay_y_rot0 + gy0; g.rot1 = a.delay_y_rot1 + gy0;
    g.ccx = a.ccx + ix0; g.ccy = a.ccy + iy0;
    g.par = CROP ? a.base_par + (long long)b * a.g_sp : nullptr;
    g.inc = a.inc_track;
  }
  // a read of g, through the read-only path
  template <class T>
  __device__ T rd(const T* p) const { return __ldg(p); }
  // crop-local linear cell indices
  __device__ int lx(int t, int x, int y) const {
    return (t * a.X + x) * (a.Y + 1) + y;
  }
  __device__ int ly(int t, int x, int y) const {
    return (t * (a.X + 1) + x) * a.Y + y;
  }
  // global flat cell ids (pred payload)
  __device__ int gidx(int l) const {
    return CROP ? __ldg(a.idxx + gx0 + l) : l;
  }
  __device__ int gidy(int l) const {
    return CROP ? __ldg(a.idxy + gy0 + l) : ncx + l;
  }
  __device__ int par(int x, int y) const {
    return CROP ? rd(g.par + x * (a.Y + 1) + y) : ((x + y) & 1);
  }
  __device__ bool inc(int t) const { return rd(g.inc + t) != 0; }
  __device__ bool own(int x) const { return x >= a.own_lo && x < a.own_hi; }
  __device__ float cost_x(int l) const {
    return fadd(__fmul_rn(crit, rd(g.dlx + l)), rd(g.ccx + l));
  }
  __device__ float cost_y(int l) const {
    return fadd(__fmul_rn(crit, rd(g.dly + l)), rd(g.ccy + l));
  }
};

// Both scans of one plane (XAX: the x plane, lines (t, y) along x; else
// the y plane, lines (t, x) along y) over dist `d`, with scan costs from
// `cs` (null: computed) and this warp's scratch.  Returns "an owned cell
// improved" for this thread.
template <bool CROP, bool XAX>
__device__ bool scan_phase(const Net<CROP>& n, const Args& a, float* d,
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
  int32_t* gp = XAX ? a.px + n.sx0 : a.py + n.sy0;
  float* gw = XAX ? a.wx + n.sx0 : a.wy + n.sy0;
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
          const int l = XAX ? n.lx(t, p, o) : n.ly(t, o, p);
          float cv = 0.0f;
          if (n.rd(brk + l))
            cv = blocked ? INF
                         : (cs ? cs[l] : (XAX ? n.cost_x(l) : n.cost_y(l)));
          c[k] = cv;
          m[k] = d[l];
        }
      __syncwarp();
      warp_scan(c, m, len, q, G, act);
      if (act)
        for (int k = q; k < len; k += G) {
          const int p = rev ? len - 1 - k : k;
          const int l = XAX ? n.lx(t, p, o) : n.ly(t, o, p);
          if (m[k] < d[l]) {
            d[l] = m[k];
            gp[l] = (XAX ? n.gidx(l) : n.gidy(l)) + (rev ? step : -step);
            gw[l] = n.rd(brk + l) ? n.rd(dl + l) : 0.0f;
            mine |= n.own(XAX ? p : o);
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
template <bool CROP>
__device__ bool turn_into_y(const Net<CROP>& n, const Args& a,
                            const Walk& wk, const float* dx, float* dy) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, nth = blockDim.x;
  const int nyc = W * (X + 1) * Y;
  int32_t* py = a.py + n.sy0;
  float* wy = a.wy + n.sy0;
  // the rotated turn of parity p exists unless (1 + p) % W == 0
  const bool rot0 = W > 1, rot1 = W > 2;
  // l = (tp * (X + 1) + x) * Y + v
  int tp = wk.t0, x = wk.r0, v = wk.c0;
  bool mine = false;
  for (int l = threadIdx.x; l < nyc; l += nth) {
    const float cc = n.rd(n.g.ccy + l);
    const float dly = n.rd(n.g.dly + l);
    const float cd = __fmul_rn(n.crit, dly);
    float d0 = dly, d1 = dly, cd0 = cd, cd1 = cd;
    if (!a.directional) {
      d0 = n.rd(n.g.rot0 + l);
      d1 = n.rd(n.g.rot1 + l);
      cd0 = __fmul_rn(n.crit, d0);
      cd1 = __fmul_rn(n.crit, d1);
    }
    const bool incp = a.directional && n.inc(tp);
    float best = INF, bw = 0.0f;
    int bsrc = 0;
    for (int boff = 0; boff < 2; ++boff) {
      const int sy = v + 1 - boff;
      const int pr = n.par(x, sy);
      bool gate = boff == 0 ? n.rd(n.g.lsy + l) : n.rd(n.g.fsy + l);
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
          const float dvs = dx[ls];
          bool sg = aoff == 0 ? n.rd(n.g.lsx + ls) : n.rd(n.g.fsx + ls);
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
          if (cand < best) { best = cand; bsrc = n.gidx(ls); bw = d; }
        }
      }
    }
    if (best < dy[l]) {
      dy[l] = best; py[l] = bsrc; wy[l] = bw; mine |= n.own(x);
    }
    wk.next(X + 1, Y, tp, x, v);
  }
  return mine;
}

// turn into x: target chanx (t, u, y); sources chany (u+1-a, y+b-1)
template <bool CROP>
__device__ bool turn_into_x(const Net<CROP>& n, const Args& a,
                            const Walk& wk, const float* dy, float* dx) {
  const float INF = __int_as_float(0x7f800000);
  const int W = a.W, X = a.X, Y = a.Y, nth = blockDim.x;
  const int nxc = W * X * (Y + 1);
  int32_t* px = a.px + n.sx0;
  float* wx = a.wx + n.sx0;
  const bool rot0 = W > 1, rot1 = W > 2;
  // l = (t * X + u) * (Y + 1) + y
  int t = wk.t0, u = wk.r0, y = wk.c0;
  bool mine = false;
  for (int l = threadIdx.x; l < nxc; l += nth) {
    const float cc = n.rd(n.g.ccx + l);
    const float dly = n.rd(n.g.dlx + l);
    const float cd = __fmul_rn(n.crit, dly);
    const bool inct = a.directional && n.inc(t);
    float best = INF, bw = 0.0f;
    int bsrc = 0;
    for (int aoff = 0; aoff < 2; ++aoff) {
      const int sx = u + 1 - aoff;
      const int pr = n.par(sx, y);
      bool gate = aoff == 0 ? n.rd(n.g.lsx + l) : n.rd(n.g.fsx + l);
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
          const float dvs = dy[ls];
          bool sg = boff == 0 ? n.rd(n.g.lsy + ls) : n.rd(n.g.fsy + ls);
          float cand;
          if (a.directional) {
            sg = sg && (boff == 0 ? n.inc(ts) : !n.inc(ts));
            cand = sg ? dvs : INF;
          } else {
            cand = fminf(sg ? dvs : INF, gate ? dvs : INF);
          }
          cand = fadd(fadd(cand, cd), cc);
          if (cand < best) { best = cand; bsrc = n.gidy(ls); bw = dly; }
        }
      }
    }
    if (best < dx[l]) {
      dx[l] = best; px[l] = bsrc; wx[l] = bw; mine |= n.own(u);
    }
    wk.next(X, Y + 1, t, u, y);
  }
  return mine;
}

// Shared-memory modes: 0 all state in global memory (only the scan
// scratch in shared); 1 dist in shared; 2 dist and scan costs.  SMEM =
// mode >= 1; a.cost_smem = mode == 2.  Layout: floats [dx | dy | cost_x |
// cost_y | scratch].
template <bool CROP, bool SMEM>
__device__ void relax_net(const Args& a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const Net<CROP> n(a, b);
  const int W = a.W, X = a.X, Y = a.Y;
  const int nxc = W * X * (Y + 1), nyc = W * (X + 1) * Y;
  float* gdx = a.dx + n.sx0; float* gdy = a.dy + n.sy0;
  int32_t* px = a.px + n.sx0; int32_t* py = a.py + n.sy0;
  float* wx = a.wx + n.sx0; float* wy = a.wy + n.sy0;
  float* f = smem;
  float *dx = gdx, *dy = gdy, *cx = nullptr, *cy = nullptr;
  if (SMEM) {
    dx = f; f += nxc;
    dy = f; f += nyc;
    if (a.cost_smem) {
      cx = f; f += nxc;
      cy = f; f += nyc;
    }
  }
  float* scr = f;

  for (int l = tid; l < nxc; l += nth) {
    dx[l] = a.d0x[n.ix0 + l];
    wx[l] = a.w0x[n.ix0 + l];
    px[l] = a.p0x ? a.p0x[n.ix0 + l] : n.gidx(l);
    if (cx) cx[l] = n.cost_x(l);
  }
  for (int l = tid; l < nyc; l += nth) {
    dy[l] = a.d0y[n.iy0 + l];
    wy[l] = a.w0y[n.iy0 + l];
    py[l] = a.p0y ? a.p0y[n.iy0 + l] : n.gidy(l);
    if (cy) cy[l] = n.cost_y(l);
  }
  __syncthreads();

  const Walk walk_y(X + 1, Y), walk_x(X, Y + 1);
  int i = 0;
  bool go = true;
  while (go && i < a.nsweeps) {
    bool mine = scan_phase<CROP, true>(n, a, dx, cx, scr);
    __syncthreads();
    mine |= turn_into_y<CROP>(n, a, walk_y, dx, dy);
    __syncthreads();
    mine |= scan_phase<CROP, false>(n, a, dy, cy, scr);
    __syncthreads();
    mine |= turn_into_x<CROP>(n, a, walk_x, dy, dx);
    go = __syncthreads_or(mine) != 0;
    ++i;
  }
  if (SMEM) {
    for (int l = tid; l < nxc; l += nth) gdx[l] = dx[l];
    for (int l = tid; l < nyc; l += nth) gdy[l] = dy[l];
  }
  if (tid == 0) {
    const int useful = i - (go ? 0 : 1) > 0 ? i - (go ? 0 : 1) : 0;
    a.stats[2 * b] = i;
    a.stats[2 * b + 1] = useful;
    if (a.total) {
      atomicMax(&a.total[0], i);
      atomicMax(&a.total[1], useful);
    }
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_full_kernel(Args a) { relax_net<false, SMEM>(a); }

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
planes_relax_cropped_kernel(Args a) { relax_net<true, SMEM>(a); }

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
  a.idxx = (const int32_t*)p[27]; a.idxy = (const int32_t*)p[28];
  a.base_par = (const int32_t*)p[29];
  a.p0x = (const int32_t*)p[30]; a.p0y = (const int32_t*)p[31];
  a.total = (int32_t*)p[32];
  a.W = (int)v[1]; a.X = (int)v[2]; a.Y = (int)v[3];
  a.stride_x = (int)v[4]; a.directional = (int)v[5]; a.nsweeps = (int)v[6];
  a.in_sx = v[7]; a.in_sy = v[8]; a.st_sx = v[9]; a.st_sy = v[10];
  a.g_sx = v[11]; a.g_sy = v[12]; a.g_sp = v[13];
  a.own_lo = (int)v[15]; a.own_hi = (int)v[16];
  a.cost_smem = 0;
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
long long smem_bytes(int mode, const long long* v) {
  const long long W = v[1], X = v[2], Y = v[3], threads = v[14];
  const long long ncells = W * X * (Y + 1) + W * (X + 1) * Y;
  return 4 * (mode * ncells +
              threads / 32 * scratch_per_warp((int)X, (int)Y));
}

// The mode the launch takes for v[17] = -1: the most shared state that
// fits the card's per-block opt-in limit.
int auto_mode(const long long* v) {
  const long long cap = smem_optin((int)v[18]);
  for (int mode = 2; mode > 0; --mode)
    if (smem_bytes(mode, v) <= cap) return mode;
  return 0;
}

const void* kernel_of(bool crop, int mode) {
  if (crop)
    return mode == 0 ? (const void*)planes_relax_cropped_kernel<false>
                     : (const void*)planes_relax_cropped_kernel<true>;
  return mode == 0 ? (const void*)planes_relax_full_kernel<false>
                   : (const void*)planes_relax_full_kernel<true>;
}

// p: 33 pointers (30, 31: pred in, or 0 for the own ids; 32: the [2]
// max-over-nets stats, zeroed here, or 0); v: B, W, X, Y,
// stride_x, directional, nsweeps, in_sx, in_sy, st_sx, st_sy, g_sx, g_sy,
// g_sp, threads, own_lo, own_hi, mode (-1: auto), device
int launch(bool crop, const void* const* p, const long long* v,
           void* stream) {
  const int B = (int)v[0], threads = (int)v[14], dev = (int)v[18];
  if (B <= 0) return 0;
  if (v[2] > MAXL || v[3] + 1 > MAXL || v[2] < 1 || v[3] < 1)
    return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != dev) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int mode = v[17] < 0 ? auto_mode(v) : (int)v[17];
  const long long bytes = smem_bytes(mode, v);
  Args a = unpack(p, v);
  a.cost_smem = mode == 2;
  const void* k = kernel_of(crop, mode);
  if (mode < 0 || mode > 2 || bytes > smem_optin(dev)) {
    e = cudaErrorInvalidValue;
  } else {
    // opt in above the default 48 KB (the largest size set so far, per
    // kernel and card)
    static long long set[4][MAX_DEVICES] = {{0}};
    long long& done = set[(crop ? 2 : 0) + (mode == 0 ? 0 : 1)][dev];
    if (bytes > 48 * 1024 && bytes > done) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
      if (e == cudaSuccess) done = bytes;
    }
  }
  if (e == cudaSuccess && a.total)
    e = cudaMemsetAsync(a.total, 0, 2 * sizeof(int32_t),
                        (cudaStream_t)stream);
  if (e == cudaSuccess) {
    void* args[] = {&a};
    e = cudaLaunchKernel(k, dim3(B), dim3(threads), args, (size_t)bytes,
                         (cudaStream_t)stream);
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (cur != dev) cudaSetDevice(cur);
  return (int)e;
}

}  // namespace

extern "C" int planes_relax_full_launch(const void* const* p,
                                        const long long* v, void* stream) {
  return launch(false, p, v, stream);
}

extern "C" int planes_relax_cropped_launch(const void* const* p,
                                           const long long* v, void* stream) {
  return launch(true, p, v, stream);
}

// the one-sweep step: the cropped kernel with nsweeps = 1, pred in
extern "C" int planes_sweep_block_launch(const void* const* p,
                                         const long long* v, void* stream) {
  if (!p[30] || !p[31] || v[6] != 1) return (int)cudaErrorInvalidValue;
  return launch(true, p, v, stream);
}

extern "C" int planes_relax_max_line() { return MAXL; }

// the shared-memory mode a launch with this table takes (v as launch's)
extern "C" int planes_relax_mode(const long long* v) {
  return v[17] < 0 ? auto_mode(v) : (int)v[17];
}
