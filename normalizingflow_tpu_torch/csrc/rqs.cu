// Rational-quadratic spline transform with identity tails, for sm_90a.
//
// Replaces normalizingflow_tpu/ops/rqs_pallas.py::_rqs_kernel. It computes
// the jnp function normalizingflow_tpu/bijectors/rqs.py::unconstrained_rqs
// (the authority where the Pallas block departs from it): per scalar x with
// K width logits w, K height logits h and K-1 inner derivative logits d,
//   widths, heights : softmax, floor 1e-3, prefix sums onto [lo, hi]; the
//                     K+1 knots have knot[0] = lo and knot[K] = hi exactly,
//                     and each size is the difference of its two knots
//   derivatives     : 1e-3 + softplus(raw), softplus = logaddexp(raw, 0);
//                     the two boundary knots use the raw value
//                     log(e^{1-1e-3} - 1), i.e. slope 1
//   bin             : idx = clamp(#(xs >= knot) - 1, 0, K-1) on the width
//                     knots (forward) or height knots (inverse), where xs is
//                     x clamped into the domain
//   y, log|det|     : the rational-quadratic map or its inverse by the
//                     stable root 2c / (-b - sqrt(disc))
//   outside [lo, hi]: y = x and log|det| = 0; a NaN x fails both bound
//                     tests and gives (NaN, 0), an infinite x gives (x, 0).
//
// Precision: float32 in and out, float64 inside. In float32 a knot lands
// a few ulps of the domain (~1e-6 at B = 6) from its exact place, and where
// the slope is small that moves the inverse by 1e-4, beyond the tolerance
// the JAX package holds its own kernel to; two float32 evaluations that
// sum in different orders (this kernel's warp scan, torch.cumsum) disagree
// by that much. Evaluated in float64, the kernel returns the function's
// value rounded to float32, and is held against the plain version
// evaluated in float64 on the same inputs.
//
// Bound: memory. Per scalar the function reads 4 * (1 + 2K + (K-1)) bytes
// and writes 8; at N = 262144, K = 32 that is 102.8 MB, 30.7 us at
// 3.35 TB/s. The arithmetic, about 28K + 50 flops per scalar, stays
// under that even at the card's fp64 rate.
//
// Design: one warp per scalar, 8 scalars per 256-thread block. Lane l owns
// BPL consecutive bins (BPL = 1 for K <= 32, 2 for K <= 64, 4 for
// K <= 128), so the row's w, h and d arrive in one coalesced read each and
// every per-bin value lives in registers, never in an array indexed at run
// time. Softmax max and sum are xor-shuffle reductions; the knot prefix sum
// is a serial sum inside the lane, then an up-shuffle scan across lanes, in
// fp64 (no tensor cores, no TF32: rounded knots flip bins); the bin search
// is a ballot + popcount per owned slot; the gathers are shuffles from the
// owning lane. Lane 0 writes y and log|det|. No fast math: the NaN and inf
// rules depend on IEEE semantics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

struct SplineConsts {
  double lo_w, hi_w, span_w;   // width knots: left, right, right - left
  double lo_h, hi_h, span_h;   // height knots: bottom, top, top - bottom
  double min_bw, scale_w;      // floor and 1 - floor * K, for widths
  double min_bh, scale_h;      // the same for heights
  double min_d, edge_raw;      // derivative floor, boundary raw value
};

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmax(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// jax.nn.softplus: logaddexp(x, 0), NaN propagating.
__device__ __forceinline__ double softplus(double x) {
  return isnan(x) ? x : fmax(x, 0.0) + log1p(exp(-fabs(x)));
}

// value[slot] of a register array, with slot uniform across the warp.
template <int BPL>
__device__ __forceinline__ double pick(const double (&v)[BPL], int slot) {
  double out = v[0];
#pragma unroll
  for (int j = 1; j < BPL; ++j) {
    if (slot == j) out = v[j];
  }
  return out;
}

// Knots of one row: softmax, floor, prefix sum mapped onto [lo, hi].
// On return lk[j] and rk[j] are the left and right knots of bin
// lane * BPL + j, pinned to lo and hi at the two ends.
template <int BPL>
__device__ __forceinline__ void knots(const float* __restrict__ raw, int k,
                                      int lane, double min_size,
                                      double scale, double lo, double hi,
                                      double span, double (&lk)[BPL],
                                      double (&rk)[BPL]) {
  double v[BPL];
  double m = -INFINITY;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    v[j] = b < k ? static_cast<double>(raw[b]) : -INFINITY;
    m = fmax(m, v[j]);
  }
  m = warp_max(m);
  double e[BPL];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    e[j] = b < k ? exp(v[j] - m) : 0.0;
    s += e[j];
  }
  s = warp_sum(s);
  // serial prefix inside the lane, then the scan of lane totals
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    run += b < k ? min_size + scale * (e[j] / s) : 0.0;
    rk[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  double offset = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) offset = 0.0;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    rk[j] = span * (offset + rk[j]) + lo;
    if (b == k - 1) rk[j] = hi;
  }
  const double prev = __shfl_up_sync(kFull, rk[BPL - 1], 1);
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    lk[j] = j > 0 ? rk[j - 1] : (lane == 0 ? lo : prev);
  }
}

template <int BPL, bool kInverse>
__global__ void __launch_bounds__(kThreads)
rqs_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ h, const float* __restrict__ d,
           float* __restrict__ y, float* __restrict__ ld, int64_t n, int k,
           SplineConsts c) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together

  double lkw[BPL], rkw[BPL], lkh[BPL], rkh[BPL];
  knots<BPL>(w + row * k, k, lane, c.min_bw, c.scale_w, c.lo_w, c.hi_w,
             c.span_w, lkw, rkw);
  knots<BPL>(h + row * k, k, lane, c.min_bh, c.scale_h, c.lo_h, c.hi_h,
             c.span_h, lkh, rkh);

  // derivative at the right knot of each owned bin, then at its left knot
  const double edge = c.min_d + softplus(c.edge_raw);
  const float* dr = d + row * (k - 1);
  double der_r[BPL], der_l[BPL];
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    der_r[j] = b < k - 1 ? c.min_d + softplus(static_cast<double>(dr[b]))
                         : edge;
  }
  const double prev_d = __shfl_up_sync(kFull, der_r[BPL - 1], 1);
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    der_l[j] = j > 0 ? der_r[j - 1] : (lane == 0 ? edge : prev_d);
  }

  const float xv = x[row];
  const double lo = kInverse ? c.lo_h : c.lo_w;
  const double hi = kInverse ? c.hi_h : c.hi_w;
  const bool inside = (xv >= lo) && (xv <= hi);
  const double xs = fmin(fmax(static_cast<double>(xv), lo), hi);

  // #(xs >= knot) - 1 over knots 0..K: knot 0 = lo <= xs always counts, so
  // idx = #(xs >= right knot of bin b), clamped to K-1.
  int idx = 0;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = lane * BPL + j;
    const double knot = kInverse ? rkh[j] : rkw[j];
    idx += __popc(__ballot_sync(kFull, b < k && xs >= knot));
  }
  idx = min(idx, k - 1);
  const int owner = idx / BPL;
  const int slot = idx - owner * BPL;

  const double in_cw = __shfl_sync(kFull, pick<BPL>(lkw, slot), owner);
  const double in_rw = __shfl_sync(kFull, pick<BPL>(rkw, slot), owner);
  const double in_ch = __shfl_sync(kFull, pick<BPL>(lkh, slot), owner);
  const double in_rh = __shfl_sync(kFull, pick<BPL>(rkh, slot), owner);
  const double in_d = __shfl_sync(kFull, pick<BPL>(der_l, slot), owner);
  const double in_d1 = __shfl_sync(kFull, pick<BPL>(der_r, slot), owner);
  if (lane != 0) return;

  const double in_w = in_rw - in_cw;
  const double in_h = in_rh - in_ch;
  const double in_delta = in_h / in_w;
  const double s_pm = in_d + in_d1 - 2.0 * in_delta;
  double out, logdet;
  if (kInverse) {
    const double dy = xs - in_ch;
    const double a = dy * s_pm + in_h * (in_delta - in_d);
    const double b = in_h * in_d - dy * s_pm;
    const double cc = -in_delta * dy;
    const double disc = b * b - 4.0 * a * cc;
    const double root = (2.0 * cc) / (-b - sqrt(disc));
    out = root * in_w + in_cw;
    const double t1m = root * (1.0 - root);
    const double den = in_delta + s_pm * t1m;
    const double num = (in_delta * in_delta) *
                       (in_d1 * root * root + 2.0 * in_delta * t1m +
                        in_d * (1.0 - root) * (1.0 - root));
    logdet = -(log(num) - 2.0 * log(den));
  } else {
    const double theta = (xs - in_cw) / in_w;
    const double t1m = theta * (1.0 - theta);
    const double num_y = in_h * (in_delta * theta * theta + in_d * t1m);
    const double den = in_delta + s_pm * t1m;
    out = in_ch + num_y / den;
    const double num = (in_delta * in_delta) *
                       (in_d1 * theta * theta + 2.0 * in_delta * t1m +
                        in_d * (1.0 - theta) * (1.0 - theta));
    logdet = log(num) - 2.0 * log(den);
  }
  y[row] = inside ? static_cast<float>(out) : xv;
  ld[row] = inside ? static_cast<float>(logdet) : 0.f;
}

template <int BPL>
void launch(bool inverse, dim3 grid, cudaStream_t s, const float* x,
            const float* w, const float* h, const float* d, float* y,
            float* ld, int64_t n, int k, const SplineConsts& c) {
  if (inverse) {
    rqs_kernel<BPL, true><<<grid, kThreads, 0, s>>>(x, w, h, d, y, ld, n, k,
                                                    c);
  } else {
    rqs_kernel<BPL, false><<<grid, kThreads, 0, s>>>(x, w, h, d, y, ld, n,
                                                     k, c);
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers
// to contiguous float32 arrays: x, y, ld (n,); w, h (n, k); d (n, k-1).
// Takes 2 <= k <= 128 and n >= 1; the bounds and floors are used as the
// doubles they are, as the plain version in float64 uses them.
extern "C" int nf_rqs_f32(const float* x, const float* w, const float* h,
                          const float* d, float* y, float* ld, int64_t n,
                          int k, int inverse, double left, double right,
                          double bottom, double top, double min_bw,
                          double min_bh, double min_d, void* stream) {
  if (k < 2 || k > 128 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SplineConsts c;
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
  c.edge_raw = std::log(std::expm1(1.0 - min_d));
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  if (k <= 32) {
    launch<1>(inv, grid, s, x, w, h, d, y, ld, n, k, c);
  } else if (k <= 64) {
    launch<2>(inv, grid, s, x, w, h, d, y, ld, n, k, c);
  } else {
    launch<4>(inv, grid, s, x, w, h, d, y, ld, n, k, c);
  }
  return static_cast<int>(cudaGetLastError());
}
