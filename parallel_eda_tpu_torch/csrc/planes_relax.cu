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
//   x-scan forward, x-scan backward      (one thread per (track, row) line)
//   turn into y                          (one thread per target chany cell)
//   y-scan forward, y-scan backward      (one thread per (track, col) line)
//   turn into x                          (one thread per target chanx cell)
// with __syncthreads() between the phases, over the (dist, pred, wenter)
// state.  The fixpoint test is a block-wide OR of "some distance improved"
// (updates are strict improvements of a monotone state, so it is exact),
// so a whole relaxation is one launch with no host sync per sweep.  Each
// block writes its own [executed, useful] sweep counts; the wrapper takes
// the max over nets, which equals the batch-level counts of the JAX
// while_loop because sweeps after a net's fixpoint are identities.
//
// Bit-exactness with the plain PyTorch version (and the JAX package):
//   * each min-plus line scan walks lax.associative_scan's odd/even combine
//     tree serially in thread-local memory (pairwise reduce, recurse, fill
//     the evens) — the grouping, not the parallelism, fixes the f32 bits;
//   * every add/multiply is an explicit __fadd_rn/__fmul_rn (and the build
//     passes -fmad=false), so crit*delay + cc is computed as the plain
//     version computes it: no FMA contraction;
//   * the turn candidates are folded in the plain version's order with a
//     strict `<`, so ties keep the same predecessor.
//
// What bounds it on the H100: neither bytes nor operations.  The state of
// one net is walked ~6 times per sweep from global memory (L1/L2
// resident: a bench net is 16 KB, 64 scale nets ~27 MB < 50 MB L2), the
// serial tree scan is latency-bound, and only B blocks run (64 of 132
// SMs at B=64).  The design keeps the whole sweep loop in one launch and
// the state on chip-near memory; packing several small nets per block and
// shared-memory state are the next steps (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXL 64          // longest scan line (grid side) the kernels take
#define MAXLV 8          // levels of the scan tree for MAXL

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
// combine order.  c and m hold at least 2n entries (the tree's levels are
// stacked after level 0).
__device__ void tree_scan(float* c, float* m, int n) {
  int off[MAXLV], len[MAXLV];
  int L = 0;
  off[0] = 0;
  len[0] = n;
  while (len[L] >= 2) {                       // pairwise reduce
    int o = off[L], n2 = len[L] / 2, o2 = o + len[L];
    for (int i = 0; i < n2; ++i)
      comb(c[o + 2 * i], m[o + 2 * i], c[o + 2 * i + 1], m[o + 2 * i + 1],
           &c[o2 + i], &m[o2 + i]);
    ++L;
    off[L] = o2;
    len[L] = n2;
  }
  for (int k = L - 1; k >= 0; --k) {          // odd <- scan of the half,
    int o = off[k], o1 = off[k + 1], nk = len[k];   // even <- odd . elem
    for (int i = 0; 2 * i + 1 < nk; ++i) {
      c[o + 2 * i + 1] = c[o1 + i];
      m[o + 2 * i + 1] = m[o1 + i];
    }
    for (int i = 1; 2 * i < nk; ++i)
      comb(c[o + 2 * i - 1], m[o + 2 * i - 1], c[o + 2 * i], m[o + 2 * i],
           &c[o + 2 * i], &m[o + 2 * i]);
  }
}

template <bool CROP>
struct Net {
  const Args& a;
  int b;
  float crit;
  long long ix0, iy0, sx0, sy0, gx0, gy0, gp0;
  int ncx;

  __device__ Net(const Args& a_, int b_) : a(a_), b(b_) {
    crit = a.crit[b];
    ix0 = (long long)b * a.in_sx;
    iy0 = (long long)b * a.in_sy;
    sx0 = (long long)b * a.st_sx;
    sy0 = (long long)b * a.st_sy;
    gx0 = (long long)b * a.g_sx;
    gy0 = (long long)b * a.g_sy;
    gp0 = (long long)b * a.g_sp;
    ncx = a.W * a.X * (a.Y + 1);
  }
  // crop-local linear cell indices
  __device__ int lx(int t, int x, int y) const {
    return (t * a.X + x) * (a.Y + 1) + y;
  }
  __device__ int ly(int t, int x, int y) const {
    return (t * (a.X + 1) + x) * a.Y + y;
  }
  // global flat cell ids (pred payload)
  __device__ int gidx(int l) const { return CROP ? a.idxx[gx0 + l] : l; }
  __device__ int gidy(int l) const { return CROP ? a.idxy[gy0 + l] : ncx + l; }
  __device__ int par(int x, int y) const {
    return CROP ? a.base_par[gp0 + (long long)x * (a.Y + 1) + y] : ((x + y) & 1);
  }
  __device__ bool inc(int t) const { return a.inc_track[t] != 0; }
  __device__ bool own(int x) const { return x >= a.own_lo && x < a.own_hi; }
  __device__ float cost_x(int l) const {
    return fadd(__fmul_rn(crit, a.delay_x[gx0 + l]), a.ccx[ix0 + l]);
  }
  __device__ float cost_y(int l) const {
    return fadd(__fmul_rn(crit, a.delay_y[gy0 + l]), a.ccy[iy0 + l]);
  }
};

template <bool CROP>
__device__ void relax_net(const Args& a) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  Net<CROP> n(a, b);
  const int W = a.W, X = a.X, Y = a.Y;
  const int nxc = W * X * (Y + 1), nyc = W * (X + 1) * Y;
  float* dx = a.dx + n.sx0; float* dy = a.dy + n.sy0;
  int32_t* px = a.px + n.sx0; int32_t* py = a.py + n.sy0;
  float* wx = a.wx + n.sx0; float* wy = a.wy + n.sy0;
  const float INF = __int_as_float(0x7f800000);
  __shared__ int changed_s;

  for (int l = tid; l < nxc; l += nth) {
    dx[l] = a.d0x[n.ix0 + l];
    wx[l] = a.w0x[n.ix0 + l];
    px[l] = a.p0x ? a.p0x[n.ix0 + l] : n.gidx(l);
  }
  for (int l = tid; l < nyc; l += nth) {
    dy[l] = a.d0y[n.iy0 + l];
    wy[l] = a.w0y[n.iy0 + l];
    py[l] = a.p0y ? a.p0y[n.iy0 + l] : n.gidy(l);
  }

  float cbuf[2 * MAXL], mbuf[2 * MAXL];
  int i = 0;
  bool go = true;
  while (go && i < a.nsweeps) {
    if (tid == 0) changed_s = 0;
    __syncthreads();
    bool mine = false;

    // ---- x-scans: lines (t, y) along x, length X, neighbour stride_x
    for (int rev = 0; rev < 2; ++rev) {
      for (int ln = tid; ln < W * (Y + 1); ln += nth) {
        const int t = ln / (Y + 1), y = ln % (Y + 1);
        for (int k = 0; k < X; ++k) {
          const int x = rev ? X - 1 - k : k;
          const int l = n.lx(t, x, y);
          const bool brk = rev ? a.brk_after_x[n.gx0 + l]
                               : a.brk_before_x[n.gx0 + l];
          float c = 0.0f;
          if (brk) {
            c = n.cost_x(l);
            if (a.directional && (rev ? n.inc(t) : !n.inc(t))) c = INF;
          }
          cbuf[k] = c;
          mbuf[k] = dx[l];
        }
        tree_scan(cbuf, mbuf, X);
        for (int k = 0; k < X; ++k) {
          const int x = rev ? X - 1 - k : k;
          const int l = n.lx(t, x, y);
          if (mbuf[k] < dx[l]) {
            const bool brk = rev ? a.brk_after_x[n.gx0 + l]
                                 : a.brk_before_x[n.gx0 + l];
            dx[l] = mbuf[k];
            px[l] = n.gidx(l) + (rev ? a.stride_x : -a.stride_x);
            wx[l] = brk ? a.delay_x[n.gx0 + l] : 0.0f;
            mine |= n.own(x);
          }
        }
      }
      __syncthreads();
    }

    // ---- turn into y: target chany (t', x, v); sources chanx (x+a-1, v+1-b)
    for (int l = tid; l < nyc; l += nth) {
      const int tp = l / ((X + 1) * Y), rem = l % ((X + 1) * Y);
      const int x = rem / Y, v = rem % Y;
      const float cc = a.ccy[n.iy0 + l];
      const float dly = a.delay_y[n.gy0 + l];
      float best = INF, bw = 0.0f;
      int bsrc = 0;
      for (int boff = 0; boff < 2; ++boff) {
        const int sy = v + 1 - boff;
        const int pr = n.par(x, sy);
        bool gate;
        if (a.directional)
          gate = boff == 0 ? (a.last_y[n.gy0 + l] && !n.inc(tp))
                           : (a.first_y[n.gy0 + l] && n.inc(tp));
        else
          gate = boff == 0 ? a.last_y[n.gy0 + l] : a.first_y[n.gy0 + l];
        for (int aoff = 0; aoff < 2; ++aoff) {
          const int sx = x + aoff - 1;
          const bool ok = sx >= 0 && sx < X;
          for (int r = 0; r < 3; ++r) {          // straight, p = 0, p = 1
            const int p = r - 1;
            if (r > 0 && (1 + p) % W == 0) continue;
            const int t = r == 0 ? tp : ((tp - 1 - p) % W + W) % W;
            float vsrc = INF, vany = INF;
            int src = 0;
            if (ok) {
              const int ls = n.lx(t, sx, sy);
              const float dv = dx[ls];
              src = n.gidx(ls);
              bool sg;
              if (a.directional)
                sg = aoff == 0 ? (a.last_x[n.gx0 + ls] && n.inc(t))
                               : (a.first_x[n.gx0 + ls] && !n.inc(t));
              else
                sg = aoff == 0 ? a.last_x[n.gx0 + ls] : a.first_x[n.gx0 + ls];
              vsrc = sg ? dv : INF;
              vany = dv;
            }
            float cand, d = dly;
            if (a.directional) {
              cand = gate ? vsrc : INF;
            } else {
              cand = fminf(vsrc, gate ? vany : INF);
              if (r > 0) d = p == 0 ? a.delay_y_rot0[n.gy0 + l]
                                    : a.delay_y_rot1[n.gy0 + l];
            }
            cand = fadd(fadd(cand, __fmul_rn(n.crit, d)), cc);
            if (r > 0 && pr != p) cand = INF;
            if (cand < best) { best = cand; bsrc = src; bw = d; }
          }
        }
      }
      if (best < dy[l]) {
        dy[l] = best; py[l] = bsrc; wy[l] = bw; mine |= n.own(x);
      }
    }
    __syncthreads();

    // ---- y-scans: lines (t, x) along y, length Y, neighbour stride 1
    for (int rev = 0; rev < 2; ++rev) {
      for (int ln = tid; ln < W * (X + 1); ln += nth) {
        const int t = ln / (X + 1), x = ln % (X + 1);
        for (int k = 0; k < Y; ++k) {
          const int y = rev ? Y - 1 - k : k;
          const int l = n.ly(t, x, y);
          const bool brk = rev ? a.brk_after_y[n.gy0 + l]
                               : a.brk_before_y[n.gy0 + l];
          float c = 0.0f;
          if (brk) {
            c = n.cost_y(l);
            if (a.directional && (rev ? n.inc(t) : !n.inc(t))) c = INF;
          }
          cbuf[k] = c;
          mbuf[k] = dy[l];
        }
        tree_scan(cbuf, mbuf, Y);
        for (int k = 0; k < Y; ++k) {
          const int y = rev ? Y - 1 - k : k;
          const int l = n.ly(t, x, y);
          if (mbuf[k] < dy[l]) {
            const bool brk = rev ? a.brk_after_y[n.gy0 + l]
                                 : a.brk_before_y[n.gy0 + l];
            dy[l] = mbuf[k];
            py[l] = n.gidy(l) + (rev ? 1 : -1);
            wy[l] = brk ? a.delay_y[n.gy0 + l] : 0.0f;
            mine |= n.own(x);
          }
        }
      }
      __syncthreads();
    }

    // ---- turn into x: target chanx (t, u, y); sources chany (u+1-a, y+b-1)
    for (int l = tid; l < nxc; l += nth) {
      const int t = l / (X * (Y + 1)), rem = l % (X * (Y + 1));
      const int u = rem / (Y + 1), y = rem % (Y + 1);
      const float cc = a.ccx[n.ix0 + l];
      const float dly = a.delay_x[n.gx0 + l];
      float best = INF, bw = 0.0f;
      int bsrc = 0;
      for (int aoff = 0; aoff < 2; ++aoff) {
        const int sx = u + 1 - aoff;
        const int pr = n.par(sx, y);
        bool gate;
        if (a.directional)
          gate = aoff == 0 ? (a.last_x[n.gx0 + l] && !n.inc(t))
                           : (a.first_x[n.gx0 + l] && n.inc(t));
        else
          gate = aoff == 0 ? a.last_x[n.gx0 + l] : a.first_x[n.gx0 + l];
        for (int boff = 0; boff < 2; ++boff) {
          const int sy = y + boff - 1;
          const bool ok = sy >= 0 && sy < Y;
          for (int r = 0; r < 3; ++r) {
            const int p = r - 1;
            if (r > 0 && (1 + p) % W == 0) continue;
            const int ts = r == 0 ? t : (t + 1 + p) % W;
            float vsrc = INF, vany = INF;
            int src = 0;
            if (ok) {
              const int ls = n.ly(ts, sx, sy);
              const float dv = dy[ls];
              src = n.gidy(ls);
              bool sg;
              if (a.directional)
                sg = boff == 0 ? (a.last_y[n.gy0 + ls] && n.inc(ts))
                               : (a.first_y[n.gy0 + ls] && !n.inc(ts));
              else
                sg = boff == 0 ? a.last_y[n.gy0 + ls] : a.first_y[n.gy0 + ls];
              vsrc = sg ? dv : INF;
              vany = dv;
            }
            float cand = a.directional ? (gate ? vsrc : INF)
                                       : fminf(vsrc, gate ? vany : INF);
            cand = fadd(fadd(cand, __fmul_rn(n.crit, dly)), cc);
            if (r > 0 && pr != p) cand = INF;
            if (cand < best) { best = cand; bsrc = src; bw = dly; }
          }
        }
      }
      if (best < dx[l]) {
        dx[l] = best; px[l] = bsrc; wx[l] = bw; mine |= n.own(u);
      }
    }
    if (mine) changed_s = 1;
    __syncthreads();
    go = changed_s != 0;
    ++i;
    __syncthreads();            // everyone has read the flag before reset
  }
  if (tid == 0) {
    a.stats[2 * b] = i;
    a.stats[2 * b + 1] = i - (go ? 0 : 1) > 0 ? i - (go ? 0 : 1) : 0;
  }
}

__global__ void planes_relax_full_kernel(Args a) { relax_net<false>(a); }
__global__ void planes_relax_cropped_kernel(Args a) { relax_net<true>(a); }

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
  a.p0x = nullptr; a.p0y = nullptr;
  a.W = (int)v[1]; a.X = (int)v[2]; a.Y = (int)v[3];
  a.stride_x = (int)v[4]; a.directional = (int)v[5]; a.nsweeps = (int)v[6];
  a.in_sx = v[7]; a.in_sy = v[8]; a.st_sx = v[9]; a.st_sy = v[10];
  a.g_sx = v[11]; a.g_sy = v[12]; a.g_sp = v[13];
  a.own_lo = 0; a.own_hi = 0x7fffffff;
  return a;
}

// step: the table carries two more pointers (p[30] p0x, p[31] p0y) and two
// more ints (v[15] own_lo, v[16] own_hi)
int launch(bool crop, bool step, const void* const* p, const long long* v,
           void* stream) {
  const int B = (int)v[0], threads = (int)v[14];
  if (B <= 0) return 0;
  if (v[2] > MAXL || v[3] + 1 > MAXL) return (int)cudaErrorInvalidValue;
  Args a = unpack(p, v);
  if (step) {
    a.p0x = (const int32_t*)p[30]; a.p0y = (const int32_t*)p[31];
    a.own_lo = (int)v[15]; a.own_hi = (int)v[16];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (crop)
    planes_relax_cropped_kernel<<<B, threads, 0, s>>>(a);
  else
    planes_relax_full_kernel<<<B, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int planes_relax_full_launch(const void* const* p,
                                        const long long* v, void* stream) {
  return launch(false, false, p, v, stream);
}

extern "C" int planes_relax_cropped_launch(const void* const* p,
                                           const long long* v, void* stream) {
  return launch(true, false, p, v, stream);
}

extern "C" int planes_sweep_block_launch(const void* const* p,
                                         const long long* v, void* stream) {
  return launch(true, true, p, v, stream);
}

extern "C" int planes_relax_max_line() { return MAXL; }
