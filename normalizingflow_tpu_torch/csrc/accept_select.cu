// HMC Metropolis accept + state select over a chain batch, for sm_90a.
//
// Replaces normalizingflow_tpu/ops/hmc_pallas.py::_accept_kernel. Per chain
// row r of the (N, D) state:
//   kin      = 0.5 * sum_j inv_mass[j] * p[r,j]^2
//   h_new    = -lp_new[r] + kin
//   dE       = h_old[r] - h_new
//   log_acc  = min(0, dE), NaN propagating as jnp.minimum does
//   accepted = log_u[r] < log_acc && isfinite(h_new)
//   pos, g   = accepted ? (q, g_new) : (pos_old, g_old)     rows of D
//   lp       = accepted ? lp_new : lp_old
//   accept_prob = isfinite(h_new) ? exp(log_acc) : 0
//
// Bound: memory. At N=8192, D=64 the function's inputs are 5*N*D*4 B +
// 4*N*4 B and its outputs 2*N*D*4 B + 3*N*4 B + N B, about 14.9 MB per
// call; a handful of flops per element is nothing beside that. Since a row
// needs only one side of each select, this kernel reads p plus the selected
// position and gradient rows, 3*N*D*4 B, and about 10.7 MB move per call.
// Its bound is those bytes over the card's HBM bandwidth.
//
// Design: one warp per chain row, 8 rows per 256-thread block. The warp
// reads p once (16-byte loads when D % 4 == 0 and every row is 16-byte
// aligned, else 4-byte loads), reduces the kinetic energy with shuffles,
// takes the decision in every lane, then copies the selected rows. Each
// chain's state is read once and written once, where the plain PyTorch
// version makes about a dozen eager passes over (N, D) arrays. Any N >= 1
// and D >= 1 are taken; a ragged last block exits its idle warps.
//
// IEEE semantics matter here (no fast math): fminf(0, NaN) is 0, which
// would accept a row that JAX rejects, so the min is written out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
accept_select_kernel(const float* __restrict__ q,
                     const float* __restrict__ p,
                     const float* __restrict__ g_new,
                     const float* __restrict__ pos_old,
                     const float* __restrict__ g_old,
                     const float* __restrict__ lp_new,
                     const float* __restrict__ lp_old,
                     const float* __restrict__ h_old,
                     const float* __restrict__ log_u,
                     const float* __restrict__ inv_mass,
                     float* __restrict__ out_pos,
                     float* __restrict__ out_lp,
                     float* __restrict__ out_g,
                     float* __restrict__ out_accept_prob,
                     uint8_t* __restrict__ out_accepted,
                     float* __restrict__ out_d_energy,
                     int n, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const int64_t base = row * d;

  float kin = 0.f;
  if (kVec4) {
    const float4* p4 = reinterpret_cast<const float4*>(p + base);
    const float4* m4 = reinterpret_cast<const float4*>(inv_mass);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 a = p4[j];
      const float4 m = m4[j];
      kin += m.x * a.x * a.x + m.y * a.y * a.y + m.z * a.z * a.z +
             m.w * a.w * a.w;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float a = p[base + j];
      kin += inv_mass[j] * a * a;
    }
  }
  kin = 0.5f * warp_sum(kin);

  const float lp_n = lp_new[row];
  const float h_new = -lp_n + kin;
  const float d_e = h_old[row] - h_new;
  const float log_acc = isnan(d_e) ? d_e : fminf(0.f, d_e);
  const bool finite = isfinite(h_new);
  const bool accepted = (log_u[row] < log_acc) && finite;

  const float* src_pos = (accepted ? q : pos_old) + base;
  const float* src_g = (accepted ? g_new : g_old) + base;
  if (kVec4) {
    const float4* sp = reinterpret_cast<const float4*>(src_pos);
    const float4* sg = reinterpret_cast<const float4*>(src_g);
    float4* dp = reinterpret_cast<float4*>(out_pos + base);
    float4* dg = reinterpret_cast<float4*>(out_g + base);
    for (int j = lane; j < d / 4; j += 32) {
      dp[j] = sp[j];
      dg[j] = sg[j];
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      out_pos[base + j] = src_pos[j];
      out_g[base + j] = src_g[j];
    }
  }
  if (lane == 0) {
    out_lp[row] = accepted ? lp_n : lp_old[row];
    out_accept_prob[row] = finite ? expf(log_acc) : 0.f;
    out_accepted[row] = accepted ? 1 : 0;
    out_d_energy[row] = d_e;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers;
// vec4 != 0 promises D % 4 == 0 and 16-byte aligned (N, D) and (D,) arrays.
extern "C" int nf_accept_select_f32(
    const float* q, const float* p, const float* g_new, const float* pos_old,
    const float* g_old, const float* lp_new, const float* lp_old,
    const float* h_old, const float* log_u, const float* inv_mass,
    float* out_pos, float* out_lp, float* out_g, float* out_accept_prob,
    uint8_t* out_accepted, float* out_d_energy, int n, int d, int vec4,
    void* stream) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    accept_select_kernel<true><<<grid, kThreads, 0, s>>>(
        q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_mass,
        out_pos, out_lp, out_g, out_accept_prob, out_accepted, out_d_energy,
        n, d);
  } else {
    accept_select_kernel<false><<<grid, kThreads, 0, s>>>(
        q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_mass,
        out_pos, out_lp, out_g, out_accept_prob, out_accepted, out_d_energy,
        n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
