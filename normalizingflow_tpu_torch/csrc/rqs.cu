// Rational-quadratic spline transform with identity tails, and its VJP,
// for sm_90a.
//
// nf_rqs_f32 replaces normalizingflow_tpu/ops/rqs_pallas.py::_rqs_kernel.
// nf_rqs_vjp_f32 replaces the backward of that file's custom_vjp
// (`_fused_bwd`, autodiff of the jnp path): it computes the same VJP in
// closed form. Both compute the jnp function
// normalizingflow_tpu/bijectors/rqs.py::unconstrained_rqs (the authority
// where the Pallas block departs from it): per scalar x with K width
// logits w, K height logits h and K-1 inner derivative logits d,
//   widths, heights : softmax, floor 1e-3, prefix sums onto [lo, hi]; the
//                     K+1 knots have knot[0] = lo and knot[K] = hi exactly,
//                     and each size is the difference of its two knots
//   derivatives     : 1e-3 + softplus(raw), softplus = logaddexp(raw, 0);
//                     the two boundary knots use the raw value
//                     log(e^{1-1e-3} - 1), i.e. slope 1
//   bin             : idx = clamp(#(xs >= knot) - 1, 0, K-1) on the width
//                     knots (forward) or height knots (inverse), where xs is
//                     x clamped into the domain (NaN stays NaN)
//   y, log|det|     : the rational-quadratic map or its inverse by the
//                     stable root 2c / (-b - sqrt(disc))
//   outside [lo, hi]: y = x and log|det| = 0; a NaN x fails both bound
//                     tests and gives (NaN, 0), an infinite x gives (x, 0).
// The VJP takes cotangents gy, gld and writes gx, gw, gh, gd: reverse mode
// of the map's explicit formulas on the bin (the same sequence as
// ops/rqs.py::_map_vjp), spread onto the logits by the cumsum's and the
// softmax's VJPs (ops/rqs.py::_knot_logit_vjp; the pinned knots 0 and K get
// nothing), softplus' onto the bin's two derivative logits. x gets
// gy outside the domain and half its in-domain gradient at x == lo or hi
// (jnp.clip's minimum/maximum tie); a NaN x propagates NaN as jax.vjp does.
//
// Precision: float32 in and out, float64 inside for everything that places
// a knot (the exps, the softmax sum, the prefix sum) and for the map and its
// reverse. In float32 a knot lands a few ulps of the domain (~1e-6 at
// B = 6) from its exact place, and where the slope is small that moves the
// inverse by 1e-4, beyond the tolerance the JAX package holds its own
// kernel to. Evaluated in float64, the kernels return the function's value
// rounded to float32, and are held against the plain versions evaluated in
// float64 on the same inputs.
//
// Bound: memory, and it depends on the data. A row outside the domain needs
// only x. A row inside needs x, w and h (4 (1 + 2K) bytes) and the 32-byte
// sectors that hold its bin's two derivative logits (about 36 bytes at
// K = 32: the two share a sector but for about one row in eight). The
// forward writes y and log|det| for every row. The VJP reads gy for every
// row and gld for the rows inside, and writes gx, gw, gh and all of gd.
// chip_smoke.py counts these sectors on its inputs. The jnp function's
// arithmetic at the fp32 rate stays under that. These kernels read w and h
// (and the bin's d) on every row, inside or not.
//
// Design: a group of G lanes per row, G = K/4 rounded up to a power of two
// (8 at K = 32, so 4 rows at a time per warp). Lane `sub` of a group owns
// the 4 consecutive bins 4 sub .. 4 sub + 3 and reads them as one 16-byte
// load per array (scalar loads when K is not a multiple of 4); the group
// covers the row, and every per-bin value lives in registers, never in an
// array indexed at run time. The softmax max and sum, the prefix scan of
// lane totals and the bin count take log2(G) shuffle steps (3 at K = 32).
// The map and its reverse are most of the float64 work but need one lane,
// so each warp takes 32 rows and each group walks its G rows: per row it
// finds the bin, and the lane owning the bin hands the bin's four knots to
// the lane that maps that row. Then every lane evaluates one map: it reads
// its bin's two derivative logits from d (softplus on those two only) and
// stores y and log|det|, 32 rows a warp, coalesced. The VJP does the same
// and runs the map's reverse mode on every lane, writes gx, then walks the
// group's rows again: it recomputes each row's softmax, takes the row's
// knot and derivative-logit cotangents from the lane that mapped it, and
// writes the row's gw and gh (16-byte stores) and gd (zero but for two
// entries). No fast math: the NaN and inf rules depend on IEEE semantics.
//
// Circular mode (nf_crqs_f32, nf_crqs_vjp_f32; kernels rqs_circular_fwd and
// rqs_circular_vjp): the spline of a periodic coordinate, as the coupling
// layers of bijectors/transformer.py use it. d holds K derivative logits a
// row, not K-1: knot j (0 <= j < K) has slope min_d + softplus(d[j]) and
// knot K shares knot 0's, so both ends are learned and equal. Inputs are
// wrapped into the domain by the caller; the tail rule stays but no row
// meets it. The VJP writes all K entries of gd, the bin's two nonzero. It
// is a compile-time specialisation (kCircular) of the same bodies: the
// instantiations above compile as they did without it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;  // 4 warps, 128 rows
constexpr int kBPL = 4;  // bins per lane: one 16-byte load per array
constexpr unsigned kFull = 0xffffffffu;

struct SplineConsts {
  double lo_w, hi_w, span_w;   // width knots: left, right, right - left
  double lo_h, hi_h, span_h;   // height knots: bottom, top, top - bottom
  double min_bw, scale_w;      // floor and 1 - floor * K, for widths
  double min_bh, scale_h;      // the same for heights
  double min_d, edge_d;        // derivative floor, slope at the pinned ends
};

struct Args {
  const float* x;
  const float* w;
  const float* h;
  const float* d;
  const float* gy;   // cotangents (VJP only)
  const float* gld;
  float* y;          // forward: y, log|det|; VJP: gx, gw, gh, gd
  float* ld;
  float* gw;
  float* gh;
  float* gd;
  int64_t n;
  int k;
  bool vec;          // K % 4 == 0 and w, h (and gw, gh) 16-byte aligned
  SplineConsts c;
};

template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// jax.nn.softplus: logaddexp(x, 0), NaN propagating.
__device__ __forceinline__ double softplus(double x) {
  return isnan(x) ? x : fmax(x, 0.0) + log1p(exp(-fabs(x)));
}


// v[slot] of a register array; slot is uniform only within a group.
__device__ __forceinline__ double pick(const double (&v)[kBPL], int slot) {
  double out = v[0];
#pragma unroll
  for (int j = 1; j < kBPL; ++j) {
    if (slot == j) out = v[j];
  }
  return out;
}

// The 4 values of `row` at bins b0 .. b0 + 3; `fill` past K.
__device__ __forceinline__ void load_bins(const float* __restrict__ row,
                                          int k, int b0, bool vec,
                                          float fill, float (&v)[kBPL]) {
  if (vec && b0 < k) {
    const float4 q = *reinterpret_cast<const float4*>(row + b0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    v[j] = b0 + j < k ? row[b0 + j] : fill;
  }
}

__device__ __forceinline__ void store_bins(float* __restrict__ row, int k,
                                           int b0, bool vec,
                                           const float (&v)[kBPL]) {
  if (vec && b0 < k) {
    *reinterpret_cast<float4*>(row + b0) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    if (b0 + j < k) row[b0 + j] = v[j];
  }
}

// Softmax of one row's K logits on a group of G lanes, in fp64: p[j] is
// the probability of bin 4 sub + j (0 past K).
template <int G>
__device__ __forceinline__ void softmax(const float (&v)[kBPL], int k,
                                        int sub, double (&p)[kBPL]) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < kBPL; ++j) m = fmaxf(m, v[j]);
  const double mx = static_cast<double>(group_max<G>(m));
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    p[j] = sub * kBPL + j < k ? exp(static_cast<double>(v[j]) - mx) : 0.0;
    s += p[j];
  }
  const double inv_s = 1.0 / group_sum<G>(s);
#pragma unroll
  for (int j = 0; j < kBPL; ++j) p[j] *= inv_s;
}

// Knots from the softmax: floor, prefix sum mapped onto [lo, hi], in fp64.
// On return rk[j] is the right knot of bin 4 sub + j (pinned to hi at
// K-1) and lk0 the left knot of bin 4 sub (lo for sub 0).
template <int G>
__device__ __forceinline__ void knots(const double (&p)[kBPL], int k,
                                      int sub, double min_size, double scale,
                                      double lo, double hi, double span,
                                      double (&rk)[kBPL], double& lk0) {
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    run += sub * kBPL + j < k ? min_size + scale * p[j] : 0.0;
    rk[j] = run;
  }
  // exclusive scan of the lane totals across the group
  double incl = run;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const double up = __shfl_up_sync(kFull, incl, off, G);
    if (sub >= off) incl += up;
  }
  double offset = __shfl_up_sync(kFull, incl, 1, G);
  if (sub == 0) offset = 0.0;
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    rk[j] = span * (offset + rk[j]) + lo;
    if (sub * kBPL + j == k - 1) rk[j] = hi;
  }
  lk0 = __shfl_up_sync(kFull, rk[kBPL - 1], 1, G);
  if (sub == 0) lk0 = lo;
}

// The bin one scalar falls in: its left knots, sizes and knot derivatives.
struct Bin {
  double xs, cw, wb, ch, hb, dl, dr;
};

// y and log|det| of the rational-quadratic map (or its inverse) on a bin.
template <bool kInverse>
__device__ __forceinline__ void rq_map(const Bin& s, double& out,
                                       double& logdet) {
  const double delta = s.hb / s.wb;
  const double sp = s.dl + s.dr - 2.0 * delta;
  if (kInverse) {
    const double dy = s.xs - s.ch;
    const double a = dy * sp + s.hb * (delta - s.dl);
    const double b = s.hb * s.dl - dy * sp;
    const double c = -delta * dy;
    const double disc = b * b - 4.0 * a * c;
    const double root = (2.0 * c) / (-b - sqrt(disc));
    out = root * s.wb + s.cw;
    const double t1m = root * (1.0 - root);
    const double den = delta + sp * t1m;
    const double num = (delta * delta) *
                       (s.dr * root * root + 2.0 * delta * t1m +
                        s.dl * (1.0 - root) * (1.0 - root));
    logdet = -(log(num) - 2.0 * log(den));
  } else {
    const double theta = (s.xs - s.cw) / s.wb;
    const double t1m = theta * (1.0 - theta);
    const double num_y = s.hb * (delta * theta * theta + s.dl * t1m);
    const double den = delta + sp * t1m;
    out = s.ch + num_y / den;
    const double num = (delta * delta) *
                       (s.dr * theta * theta + 2.0 * delta * t1m +
                        s.dl * (1.0 - theta) * (1.0 - theta));
    logdet = log(num) - 2.0 * log(den);
  }
}

// Reverse mode of rq_map for cotangents (gy, gld): the cotangents of the
// Bin's fields, in ops/rqs.py::_map_vjp's order of operations.
template <bool kInverse>
__device__ __forceinline__ Bin map_vjp(const Bin& s, double gy, double gld) {
  const double delta = s.hb / s.wb;
  const double sp = s.dl + s.dr - 2.0 * delta;
  double t, dy = 0.0, a = 0.0, bq = 0.0, c = 0.0, sq = 0.0, den_r = 0.0;
  if (kInverse) {
    dy = s.xs - s.ch;
    a = dy * sp + s.hb * (delta - s.dl);
    bq = s.hb * s.dl - dy * sp;
    c = -delta * dy;
    sq = sqrt(bq * bq - 4.0 * a * c);
    den_r = -bq - sq;
    t = (2.0 * c) / den_r;
  } else {
    t = (s.xs - s.cw) / s.wb;
  }
  const double omt = 1.0 - t;
  const double t1m = t * omt;
  const double den = delta + sp * t1m;
  const double q = s.dr * t * t + 2.0 * delta * t1m + s.dl * omt * omt;
  const double dnum = delta * delta * q;

  const double g_dnum = (kInverse ? -1.0 : 1.0) * gld / dnum;
  double g_den = (kInverse ? 2.0 : -2.0) * gld / den;
  const double g_q = g_dnum * delta * delta;
  double g_delta = g_dnum * 2.0 * delta * q + g_q * 2.0 * t1m;
  double g_dr = g_q * t * t;
  double g_t = g_q * (2.0 * s.dr * t - 2.0 * s.dl * omt);
  double g_dl = g_q * omt * omt;
  double g_wb = 0.0, g_cw = 0.0, g_hb = 0.0, g_numy = 0.0;
  if (kInverse) {
    g_t = g_t + gy * s.wb;
    g_wb = gy * t;
    g_cw = gy;
  } else {
    const double num_y = s.hb * (delta * t * t + s.dl * t1m);
    g_numy = gy / den;
    g_den = g_den - gy * num_y / (den * den);
    g_hb = g_numy * (delta * t * t + s.dl * t1m);
    g_delta = g_delta + g_numy * s.hb * t * t;
    g_t = g_t + g_numy * s.hb * 2.0 * delta * t;
    g_dl = g_dl + g_numy * s.hb * t1m;
  }
  g_delta = g_delta + g_den;
  double g_sp = g_den * t1m;
  double g_t1m = g_q * 2.0 * delta + g_den * sp;
  if (!kInverse) g_t1m = g_t1m + g_numy * s.hb * s.dl;
  g_t = g_t + g_t1m * (1.0 - 2.0 * t);
  Bin g;
  if (kInverse) {
    double g_c = g_t * 2.0 / den_r;
    const double g_denr = -g_t * t / den_r;
    const double g_disc = -g_denr / (2.0 * sq);
    const double g_bq = -g_denr + g_disc * 2.0 * bq;
    const double g_a = -g_disc * 4.0 * c;
    g_c = g_c - g_disc * 4.0 * a;
    g_delta = g_delta - g_c * dy + g_a * s.hb;
    g_hb = g_bq * s.dl + g_a * (delta - s.dl);
    g_dl = g_dl + g_bq * s.hb - g_a * s.hb;
    g_sp = g_sp - g_bq * dy + g_a * dy;
    const double g_dy = -g_c * delta - g_bq * sp + g_a * sp;
    g.xs = g_dy;
    g.ch = -g_dy;
  } else {
    g.xs = g_t / s.wb;
    g_cw = -g_t / s.wb;
    g_wb = -g_t * t / s.wb;
    g.ch = gy;
  }
  g.dl = g_dl + g_sp;
  g.dr = g_dr + g_sp;
  g_delta = g_delta - 2.0 * g_sp;
  g.hb = g_hb + g_delta / s.wb;
  g.wb = g_wb - g_delta * delta / s.wb;
  g.cw = g_cw;
  return g;
}

// The lane's own scalar: its row, and the bin its x falls in.
struct Scalar {
  int64_t row;    // clamped to n - 1 where the warp overhangs n
  bool valid;     // the row exists
  float xv;
  bool inside;    // lo <= x <= hi
  int idx;
  Bin bin;
};

// Each warp takes 32 rows, and lane l maps row base + l. A group of G lanes
// walks its G rows: for each, the group computes the knots and finds the
// bin, and the lane that owns the bin hands the bin's knots to the lane
// that maps the row. So every lane then evaluates one map.
template <int G, bool kInverse>
__device__ __forceinline__ Scalar find_bin(const Args& a) {
  const SplineConsts& c = a.c;
  const int k = a.k;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane;
  const double lo = kInverse ? c.lo_h : c.lo_w;
  const double hi = kInverse ? c.hi_h : c.hi_w;
  Scalar me;
#pragma unroll 1
  for (int r = 0; r < G; ++r) {
    const int64_t want = base + lane - sub + r;
    const int64_t row = want < a.n ? want : a.n - 1;
    float wv[kBPL], hv[kBPL];
    load_bins(a.w + row * k, k, sub * kBPL, a.vec, -INFINITY, wv);
    load_bins(a.h + row * k, k, sub * kBPL, a.vec, -INFINITY, hv);
    double p[kBPL], rkw[kBPL], rkh[kBPL], lkw, lkh;
    softmax<G>(wv, k, sub, p);
    knots<G>(p, k, sub, c.min_bw, c.scale_w, c.lo_w, c.hi_w, c.span_w, rkw,
             lkw);
    softmax<G>(hv, k, sub, p);
    knots<G>(p, k, sub, c.min_bh, c.scale_h, c.lo_h, c.hi_h, c.span_h, rkh,
             lkh);
    const double xd = static_cast<double>(a.x[row]);
    const double xs = isnan(xd) ? xd : fmin(fmax(xd, lo), hi);
    // #(xs >= knot) - 1 over knots 0..K: knot 0 = lo <= xs always counts
    // (a NaN counts nothing, as in jnp), so idx = #(xs >= right knot of
    // bin b), clamped to K-1.
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kBPL; ++j) {
      const double knot = kInverse ? rkh[j] : rkw[j];
      cnt += (sub * kBPL + j < k && xs >= knot) ? 1 : 0;
    }
    const int idx = min(group_sum<G>(cnt), k - 1);
    const int owner = idx / kBPL;
    const int slot = idx - owner * kBPL;
    const double cw = __shfl_sync(
        kFull, slot == 0 ? lkw : pick(rkw, slot - 1), owner, G);
    const double rw = __shfl_sync(kFull, pick(rkw, slot), owner, G);
    const double ch = __shfl_sync(
        kFull, slot == 0 ? lkh : pick(rkh, slot - 1), owner, G);
    const double rh = __shfl_sync(kFull, pick(rkh, slot), owner, G);
    if (sub == r) {
      me.row = row;
      me.xv = static_cast<float>(xd);
      me.idx = idx;
      me.bin.xs = xs;
      me.bin.cw = cw;
      me.bin.wb = rw - cw;
      me.bin.ch = ch;
      me.bin.hb = rh - ch;
    }
  }
  me.valid = base + lane < a.n;
  me.inside = (me.xv >= lo) && (me.xv <= hi);
  return me;
}

// The circular bin's two knot slopes: knot idx reads d[idx], knot idx + 1
// reads d[idx + 1], which is d[0] at idx = K - 1.
__device__ __forceinline__ int circular_right(int idx, int k) {
  return idx + 1 == k ? 0 : idx + 1;
}

template <int G, bool kInverse, bool kCircular>
__device__ __forceinline__ void fwd_body(const Args& a) {
  Scalar me = find_bin<G, kInverse>(a);
  if (!me.valid) return;
  const SplineConsts& c = a.c;
  const int k = a.k;
  if (kCircular) {
    const float* drow = a.d + me.row * k;
    me.bin.dl = c.min_d + softplus(static_cast<double>(drow[me.idx]));
    me.bin.dr = c.min_d + softplus(static_cast<double>(
                              drow[circular_right(me.idx, k)]));
  } else {
    const float* drow = a.d + me.row * (k - 1);
    me.bin.dl = me.idx == 0 ? c.edge_d
                            : c.min_d + softplus(static_cast<double>(
                                            drow[me.idx - 1]));
    me.bin.dr = me.idx == k - 1 ? c.edge_d
                                : c.min_d + softplus(static_cast<double>(
                                                drow[me.idx]));
  }
  double out, logdet;
  rq_map<kInverse>(me.bin, out, logdet);
  a.y[me.row] = me.inside ? static_cast<float>(out) : me.xv;
  a.ld[me.row] = me.inside ? static_cast<float>(logdet) : 0.f;
}

template <int G, bool kInverse>
__global__ void __launch_bounds__(kThreads) rqs_fwd(Args a) {
  fwd_body<G, kInverse, false>(a);
}

template <int G, bool kInverse>
__global__ void __launch_bounds__(kThreads) rqs_circular_fwd(Args a) {
  fwd_body<G, kInverse, true>(a);
}

// gw (or gh) for one row on the group, as ops/rqs.py::_knot_logit_vjp:
// the scaled knot cotangents g_b (knot idx) and g_b1 (knot idx + 1)
// through the cumsum's VJP (bin m gets the sum of those at knots j > m),
// the floor's scale, and the softmax's VJP p_m (g_m - sum_i p_i g_i).
template <int G>
__device__ __forceinline__ void spread(const double (&p)[kBPL], int idx,
                                       int sub, double g_b, double g_b1,
                                       double scale, float* row, int k,
                                       bool vec, bool valid) {
  double g[kBPL];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    const int m = sub * kBPL + j;
    g[j] = scale * ((m < idx ? g_b : 0.0) + (m < idx + 1 ? g_b1 : 0.0));
    s += g[j] * p[j];
  }
  s = group_sum<G>(s);
  float out[kBPL];
#pragma unroll
  for (int j = 0; j < kBPL; ++j) {
    out[j] = static_cast<float>(p[j] * (g[j] - s));
  }
  if (valid) store_bins(row, k, sub * kBPL, vec, out);
}

// Two passes over the warp's 32 rows: the first finds each lane's bin, and
// each lane runs the map's reverse mode for its row and writes gx; the
// second walks each group's G rows again, recomputes the softmax (the
// probabilities are not kept: they would take 8 registers a row), takes the
// row's knot and derivative-logit cotangents from the lane that mapped it,
// and writes the row's gw, gh and gd. Six blocks an SM (at most 85
// registers) ran 10% faster at (262144, 32) than the compiler's own 84-86
// registers, on an H100 80GB HBM3 at 700 W.
template <int G, bool kInverse, bool kCircular>
__device__ __forceinline__ void vjp_body(const Args& a) {
  Scalar me = find_bin<G, kInverse>(a);
  const SplineConsts& c = a.c;
  const int k = a.k;
  double raw_l, raw_r;
  if (kCircular) {
    const float* drow = a.d + me.row * k;
    raw_l = drow[me.idx];
    raw_r = drow[circular_right(me.idx, k)];
    me.bin.dl = c.min_d + softplus(raw_l);
    me.bin.dr = c.min_d + softplus(raw_r);
  } else {
    const float* drow = a.d + me.row * (k - 1);
    raw_l = me.idx == 0 ? 0.0 : drow[me.idx - 1];
    raw_r = me.idx == k - 1 ? 0.0 : drow[me.idx];
    me.bin.dl = me.idx == 0 ? c.edge_d : c.min_d + softplus(raw_l);
    me.bin.dr = me.idx == k - 1 ? c.edge_d : c.min_d + softplus(raw_r);
  }
  const double gyv = a.gy[me.row];
  const Bin g = map_vjp<kInverse>(me.bin, me.inside ? gyv : 0.0,
                                  me.inside ? a.gld[me.row] : 0.0);
  // knot cotangents times the span (the pinned knot K gets none), and
  // softplus' = 1 / (1 + exp(-raw)) on the bin's two derivative logits
  const double gkw_b = c.span_w * (g.cw - g.wb);
  const double gkh_b = c.span_h * (g.ch - g.hb);
  const double gkw_b1 = me.idx + 1 < k ? c.span_w * g.wb : 0.0;
  const double gkh_b1 = me.idx + 1 < k ? c.span_h * g.hb : 0.0;
  const float gdl = (kCircular || me.idx >= 1)
                        ? static_cast<float>(g.dl / (1.0 + exp(-raw_l)))
                        : 0.f;
  const float gdr = (kCircular || me.idx <= k - 2)
                        ? static_cast<float>(g.dr / (1.0 + exp(-raw_r)))
                        : 0.f;
  if (me.valid) {
    const double lo = kInverse ? c.lo_h : c.lo_w;
    const double hi = kInverse ? c.hi_h : c.hi_w;
    const double xd = static_cast<double>(me.xv);
    const double factor =
        me.inside ? ((xd == lo || xd == hi) ? 0.5 : 1.0) : 0.0;
    a.y[me.row] = static_cast<float>((me.inside ? 0.0 : gyv) +
                                     factor * g.xs);
  }

  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - sub;
#pragma unroll 1
  for (int r = 0; r < G; ++r) {
    const bool valid = first + r < a.n;
    const int64_t row = valid ? first + r : a.n - 1;
    float wv[kBPL], hv[kBPL];
    load_bins(a.w + row * k, k, sub * kBPL, a.vec, -INFINITY, wv);
    load_bins(a.h + row * k, k, sub * kBPL, a.vec, -INFINITY, hv);
    const int idx = __shfl_sync(kFull, me.idx, r, G);
    double p[kBPL];
    softmax<G>(wv, k, sub, p);
    spread<G>(p, idx, sub, __shfl_sync(kFull, gkw_b, r, G),
              __shfl_sync(kFull, gkw_b1, r, G), c.scale_w, a.gw + row * k, k,
              a.vec, valid);
    softmax<G>(hv, k, sub, p);
    spread<G>(p, idx, sub, __shfl_sync(kFull, gkh_b, r, G),
              __shfl_sync(kFull, gkh_b1, r, G), c.scale_h, a.gh + row * k, k,
              a.vec, valid);
    const float row_gdl = __shfl_sync(kFull, gdl, r, G);
    const float row_gdr = __shfl_sync(kFull, gdr, r, G);
    if (valid && kCircular) {
      float* gdrow = a.gd + row * k;
      const int right = circular_right(idx, k);
#pragma unroll
      for (int j = 0; j < kBPL; ++j) {
        const int m = sub * kBPL + j;
        if (m < k) {
          gdrow[m] = m == idx ? row_gdl : (m == right ? row_gdr : 0.f);
        }
      }
    } else if (valid) {
      float* gdrow = a.gd + row * (k - 1);
#pragma unroll
      for (int j = 0; j < kBPL; ++j) {
        const int m = sub * kBPL + j;
        if (m < k - 1) {
          gdrow[m] = m == idx - 1 ? row_gdl : (m == idx ? row_gdr : 0.f);
        }
      }
    }
  }
}

template <int G, bool kInverse>
__global__ void __launch_bounds__(kThreads, 6) rqs_vjp(Args a) {
  vjp_body<G, kInverse, false>(a);
}

template <int G, bool kInverse>
__global__ void __launch_bounds__(kThreads, 6) rqs_circular_vjp(Args a) {
  vjp_body<G, kInverse, true>(a);
}

template <int G>
void launch(bool vjp, bool inverse, bool circular, dim3 grid, cudaStream_t s,
            const Args& a) {
  if (circular) {
    if (vjp) {
      if (inverse) {
        rqs_circular_vjp<G, true><<<grid, kThreads, 0, s>>>(a);
      } else {
        rqs_circular_vjp<G, false><<<grid, kThreads, 0, s>>>(a);
      }
    } else {
      if (inverse) {
        rqs_circular_fwd<G, true><<<grid, kThreads, 0, s>>>(a);
      } else {
        rqs_circular_fwd<G, false><<<grid, kThreads, 0, s>>>(a);
      }
    }
    return;
  }
  if (vjp) {
    if (inverse) {
      rqs_vjp<G, true><<<grid, kThreads, 0, s>>>(a);
    } else {
      rqs_vjp<G, false><<<grid, kThreads, 0, s>>>(a);
    }
  } else {
    if (inverse) {
      rqs_fwd<G, true><<<grid, kThreads, 0, s>>>(a);
    } else {
      rqs_fwd<G, false><<<grid, kThreads, 0, s>>>(a);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int run(bool vjp, bool circular, Args a, int inverse, double left,
        double right, double bottom, double top, double min_bw,
        double min_bh, double min_d, void* stream) {
  const int k = a.k;
  if (k < 2 || k > 128 || a.n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SplineConsts& c = a.c;
  c.lo_w = left;
  c.hi_w = right;
  c.span_w = right - left;
  c.lo_h = bottom;
  c.hi_h = top;
  c.span_h = top - bottom;
  c.min_bw = min_bw;
  c.scale_w = 1.0 - min_bw * k;
  c.min_bh = min_bh;
  c.scale_h = 1.0 - min_bh * k;
  c.min_d = min_d;
  const double edge_raw = std::log(std::expm1(1.0 - min_d));
  c.edge_d = min_d + std::fmax(edge_raw, 0.0) +
             std::log1p(std::exp(-std::fabs(edge_raw)));
  a.vec = k % kBPL == 0 && aligned16(a.w) && aligned16(a.h) &&
          (!vjp || (aligned16(a.gw) && aligned16(a.gh)));
  const int groups = k <= 8 ? 2 : k <= 16 ? 4 : k <= 32 ? 8 : k <= 64 ? 16
                                                                       : 32;
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  switch (groups) {
    case 2: launch<2>(vjp, inv, circular, grid, s, a); break;
    case 4: launch<4>(vjp, inv, circular, grid, s, a); break;
    case 8: launch<8>(vjp, inv, circular, grid, s, a); break;
    case 16: launch<16>(vjp, inv, circular, grid, s, a); break;
    default: launch<32>(vjp, inv, circular, grid, s, a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and returns
// the cudaError_t of the launch (0 on success). Pointers are device
// pointers to contiguous float32 arrays: x, y, ld, gy, gld, gx (n,); w, h,
// gw, gh (n, k); d, gd (n, k-1). Takes 2 <= k <= 128 and n >= 1; the bounds
// and floors are used as the doubles they are, as the plain versions in
// float64 use them.
extern "C" int nf_rqs_f32(const float* x, const float* w, const float* h,
                          const float* d, float* y, float* ld, int64_t n,
                          int k, int inverse, double left, double right,
                          double bottom, double top, double min_bw,
                          double min_bh, double min_d, void* stream) {
  Args a = {};
  a.x = x;
  a.w = w;
  a.h = h;
  a.d = d;
  a.y = y;
  a.ld = ld;
  a.n = n;
  a.k = k;
  return run(false, false, a, inverse, left, right, bottom, top, min_bw,
             min_bh, min_d, stream);
}

extern "C" int nf_rqs_vjp_f32(const float* x, const float* w,
                              const float* h, const float* d,
                              const float* gy, const float* gld, float* gx,
                              float* gw, float* gh, float* gd, int64_t n,
                              int k, int inverse, double left, double right,
                              double bottom, double top, double min_bw,
                              double min_bh, double min_d, void* stream) {
  Args a = {};
  a.x = x;
  a.w = w;
  a.h = h;
  a.d = d;
  a.gy = gy;
  a.gld = gld;
  a.y = gx;
  a.gw = gw;
  a.gh = gh;
  a.gd = gd;
  a.n = n;
  a.k = k;
  return run(true, false, a, inverse, left, right, bottom, top, min_bw,
             min_bh, min_d, stream);
}

// The circular mode: the same arguments, with d and gd (n, k).
extern "C" int nf_crqs_f32(const float* x, const float* w, const float* h,
                           const float* d, float* y, float* ld, int64_t n,
                           int k, int inverse, double left, double right,
                           double bottom, double top, double min_bw,
                           double min_bh, double min_d, void* stream) {
  Args a = {};
  a.x = x;
  a.w = w;
  a.h = h;
  a.d = d;
  a.y = y;
  a.ld = ld;
  a.n = n;
  a.k = k;
  return run(false, true, a, inverse, left, right, bottom, top, min_bw,
             min_bh, min_d, stream);
}

extern "C" int nf_crqs_vjp_f32(const float* x, const float* w,
                               const float* h, const float* d,
                               const float* gy, const float* gld, float* gx,
                               float* gw, float* gh, float* gd, int64_t n,
                               int k, int inverse, double left, double right,
                               double bottom, double top, double min_bw,
                               double min_bh, double min_d, void* stream) {
  Args a = {};
  a.x = x;
  a.w = w;
  a.h = h;
  a.d = d;
  a.gy = gy;
  a.gld = gld;
  a.y = gx;
  a.gw = gw;
  a.gh = gh;
  a.gd = gd;
  a.n = n;
  a.k = k;
  return run(true, true, a, inverse, left, right, bottom, top, min_bw,
             min_bh, min_d, stream);
}
