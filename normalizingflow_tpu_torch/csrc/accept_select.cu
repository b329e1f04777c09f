// The tail of an HMC transition over a chain batch, for sm_90a: the last
// half-kick of the leapfrog, both kinetic energies, the Metropolis test and
// the state select, in one pass over each chain's rows.
//
// Replaces normalizingflow_tpu/ops/hmc_pallas.py::_accept_kernel together
// with the tensor ops the transition ran around it: the last half-kick
// (normalizingflow_tpu/mcmc/hmc.py:77, the port's mcmc/hmc.py leapfrog) and
// h_old (normalizingflow_tpu/mcmc/hmc.py:253-255). Per chain row r:
//   p        = p_half + (0.5 * eps[r]) * g_new   (two roundings, no FMA,
//                                                 as torch computes it)
//   h_old    = -lp_old[r] + 0.5 * sum_j inv_mass[j] * momentum0[r,j]^2
//   h_new    = -lp_new[r] + 0.5 * sum_j inv_mass[j] * p[j]^2
//   dE       = h_old - h_new
//   log_acc  = min(0, dE), NaN propagating as jnp.minimum does
//   accepted = log_u[r] < log_acc && isfinite(h_new)
//   pos, g, lp  = accepted ? (q, g_new, lp_new) : (pos_old, g_old, lp_old)
//   accept_prob = isfinite(h_new) ? exp(log_acc) : 0
// The unfused form (kFused = false) takes p and h_old as given: the JAX
// kernel's own function, ops/hmc.py::accept_select.
//
// In place (old_pos == nullptr, out_* = the state): an accepted row stores q,
// g_new and lp_new over the state; a rejected row stores only its three
// scalars (accept_prob, accepted, dE). With fresh outputs a rejected row
// copies the old state.
//
// Bound: memory. The fused function must read momentum0, p_half and g_new
// rows, q rows of accepted chains, four scalars a row and inv_mass, and
// write pos and grad rows and lp of accepted chains and three scalars a row:
// at N = 8192, D = 64 and 0.8 accepts about 11.6 MB, 3.5 us at 3.35 TB/s. A
// few flops an element are nothing beside that. At these sizes one row is
// a few hundred bytes and the whole batch one wave on the card: the time is
// a launch, the dependent trips to device memory a row makes, and the
// bytes.
//
// Design:
//   * A team of T threads owns a row, T a power of two picked by plan_team
//     from the row's units (float4s when D % 4 == 0 and every pointer is
//     16-byte aligned, else floats): one unit a lane up to 32 units, so that
//     at D = 64 two rows share a warp and every lane loads; for rows of more
//     than 128 units a block of 64-256 threads, so (300, 2048) launches 300
//     blocks. Teams reduce by shuffles, blocks through shared memory. At
//     D = 96 a whole warp with 8 lanes idle measured faster than 8 lanes
//     loading 3 units each (tools/torch_accept_ablation.py): more loads are
//     in flight at once.
//   * One trip before the decision: each thread issues every load that does
//     not depend on it (its units of p_half, g_new, momentum0 and, while
//     speculating, q, a tensor at a time, plus the row's scalars) before any
//     arithmetic, keeping up to kPer units of each in registers (kPer, a
//     template parameter, is what the row needs, so registers and occupancy
//     follow D). Rows wider than kMaxPer units a thread stream the rest and
//     reload q and g_new to store them.
//   * q is needed only by accepted rows (about 0.8 on the main path) and is
//     loaded with the rest (kSpeculativeQ); tools/torch_accept_ablation.py
//     prices the other order.
//   * The stores of an accepted row come from registers; a rejected row in
//     place stores 9 bytes.
//
// IEEE semantics matter here (no fast math): fminf(0, NaN) is 0, which
// would accept a row that JAX rejects, so the min is written out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPer = 4;      // most units a thread keeps in registers
constexpr int kMaxTeam = 256;   // threads of a row's team, and of a block
constexpr int kMinBlock = 64;   // threads of the smallest block of small teams
constexpr int kBlocksPerSM = 2; // small teams: shrink blocks below this grid
constexpr bool kSpeculativeQ = true;  // load q before the decision

struct Args {
  const float* q;
  const float* p;         // p_half when fused, p when not
  const float* g_new;
  const float* mom0;      // fused only
  const float* eps;       // fused only, one a row
  const float* h_old;     // unfused only
  const float* lp_new;
  const float* lp_old;    // may be out_lp (in place): plain loads
  const float* log_u;
  const float* inv_mass;
  const float* old_pos;   // nullptr in place
  const float* old_g;
  float* out_pos;
  float* out_g;
  float* out_lp;
  float* out_accept_prob;
  uint8_t* out_accepted;
  float* out_d_energy;
  int64_t n;
  int nu;          // units a row
  int team;        // threads a row
  int team_shift;  // log2(team)
};

template <typename U>
__device__ __forceinline__ U ld(const float* p, int64_t i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, int64_t i) {
  return __ldg(p + i);
}
template <>
__device__ __forceinline__ float4 ld<float4>(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ void st(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// p_half + (0.5 * eps) * g, rounded as torch rounds it
__device__ __forceinline__ float kick(float ph, float half, float g) {
  return __fadd_rn(ph, __fmul_rn(half, g));
}
__device__ __forceinline__ float4 kick(float4 ph, float half, float4 g) {
  return make_float4(kick(ph.x, half, g.x), kick(ph.y, half, g.y),
                     kick(ph.z, half, g.z), kick(ph.w, half, g.w));
}

__device__ __forceinline__ float energy(float m, float a) { return m * a * a; }
__device__ __forceinline__ float energy(float4 m, float4 a) {
  return m.x * a.x * a.x + m.y * a.y * a.y + m.z * a.z * a.z +
         m.w * a.w * a.w;
}

// kPer: units of each row a thread keeps in registers (a template
// parameter, so that registers are spent only where a row needs them).
template <typename U, bool kFused, int kPer>
__global__ void __launch_bounds__(kMaxTeam) hmc_accept_kernel(const Args a) {
  const int team = a.team;
  int64_t row;
  int t;
  if (team > 32) {
    row = blockIdx.x;
    t = threadIdx.x;
  } else {
    row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> a.team_shift) +
          (threadIdx.x >> a.team_shift);
    t = threadIdx.x & (team - 1);
  }
  const bool valid = row < a.n;  // a ragged last block: idle teams still
                                 // take part in the shuffles
  const int nu = a.nu;
  const int64_t base = row * nu;

  // 1. Every load that does not depend on the decision, issued together.
  U pv[kPer], gv[kPer], mv[kPer], qv[kPer];
  float lp_n = 0.f, lp_o = 0.f, lu = 0.f, e = 0.f;
  if (valid) {
    lp_n = __ldg(a.lp_new + row);
    lp_o = a.lp_old[row];
    lu = __ldg(a.log_u + row);
    e = __ldg((kFused ? a.eps : a.h_old) + row);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (j < nu) pv[i] = ld<U>(a.p, base + j);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (j < nu) gv[i] = ld<U>(a.g_new, base + j);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (kFused && j < nu) mv[i] = ld<U>(a.mom0, base + j);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (kSpeculativeQ && j < nu) qv[i] = ld<U>(a.q, base + j);
    }
  }

  // 2. Both kinetic energies, each thread over its units in order.
  const float half = 0.5f * e;
  float kn = 0.f, ko = 0.f;
  if (valid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (j < nu) {
        const U m = ld<U>(a.inv_mass, j);
        kn += energy(m, kFused ? kick(pv[i], half, gv[i]) : pv[i]);
        if (kFused) ko += energy(m, mv[i]);
      }
    }
    // rows wider than the registers hold stream the rest
    for (int j = t + kPer * team; j < nu; j += team) {
      const U m = ld<U>(a.inv_mass, j);
      const U p = ld<U>(a.p, base + j);
      kn += energy(m, kFused ? kick(p, half, ld<U>(a.g_new, base + j)) : p);
      if (kFused) ko += energy(m, ld<U>(a.mom0, base + j));
    }
  }

  // 3. Reduce over the team: shuffles, then shared memory across warps.
  if (team > 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kn += __shfl_xor_sync(0xffffffffu, kn, off);
      if (kFused) ko += __shfl_xor_sync(0xffffffffu, ko, off);
    }
    __shared__ float2 part[kMaxTeam / 32];
    if ((t & 31) == 0) part[t >> 5] = make_float2(kn, ko);
    __syncthreads();
    kn = 0.f;
    ko = 0.f;
    for (int w = 0; w < (team >> 5); ++w) {
      kn += part[w].x;
      ko += part[w].y;
    }
  } else {
    for (int off = team >> 1; off > 0; off >>= 1) {
      kn += __shfl_xor_sync(0xffffffffu, kn, off);
      if (kFused) ko += __shfl_xor_sync(0xffffffffu, ko, off);
    }
  }
  if (!valid) return;

  // 4. The decision, in every thread of the team.
  const float h_old = kFused ? -lp_o + 0.5f * ko : e;
  const float h_new = -lp_n + 0.5f * kn;
  const float d_e = h_old - h_new;
  const float log_acc = isnan(d_e) ? d_e : fminf(0.f, d_e);
  const bool finite = isfinite(h_new);
  const bool accepted = (lu < log_acc) && finite;

  // 5. Stores: an accepted row from registers, a rejected row only when the
  // outputs are fresh.
  const bool copy_rejected = a.old_pos != nullptr;
  if (accepted) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * team;
      if (j < nu) {
        st(a.out_pos, base + j, kSpeculativeQ ? qv[i] : ld<U>(a.q, base + j));
        st(a.out_g, base + j, gv[i]);
      }
    }
    for (int j = t + kPer * team; j < nu; j += team) {
      st(a.out_pos, base + j, ld<U>(a.q, base + j));
      st(a.out_g, base + j, ld<U>(a.g_new, base + j));
    }
  } else if (copy_rejected) {
    for (int j = t; j < nu; j += team) {
      st(a.out_pos, base + j, ld<U>(a.old_pos, base + j));
      st(a.out_g, base + j, ld<U>(a.old_g, base + j));
    }
  }
  if (t == 0) {
    if (accepted) {
      a.out_lp[row] = lp_n;
    } else if (copy_rejected) {
      a.out_lp[row] = lp_o;
    }
    a.out_accept_prob[row] = finite ? expf(log_acc) : 0.f;
    a.out_accepted[row] = accepted ? 1 : 0;
    a.out_d_energy[row] = d_e;
  }
}

// Threads a row for `nu` units: one unit a lane while the row fits in a
// warp (the power of two at or above nu, so at D = 96 a row takes 32 lanes
// of which 24 load), a warp with up to kMaxPer units a lane up to 128 units,
// and beyond that a block of a power of two of threads, 64 to kMaxTeam, with
// at most kMaxPer units a thread where that fits.
int plan_team(int nu) {
  if (nu <= 32) {
    int team = 1;
    while (team < nu) team <<= 1;
    return team;
  }
  if (nu <= 32 * kMaxPer) return 32;
  int team = 64;
  while (team < kMaxTeam && team * kMaxPer < nu) team <<= 1;
  return team;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

template <typename U, bool kFused, int kPer>
void launch(const Args& a, cudaStream_t s) {
  if (a.team > 32) {
    hmc_accept_kernel<U, kFused, kPer>
        <<<static_cast<unsigned>(a.n), a.team, 0, s>>>(a);
    return;
  }
  // Small teams: 256-thread blocks, halved (to 64) while the grid would not
  // give every SM kBlocksPerSM blocks.
  int threads = kMaxTeam;
  auto blocks = [&](int th) {
    const int64_t rows = th >> a.team_shift;
    return (a.n + rows - 1) / rows;
  };
  while (threads > kMinBlock &&
         blocks(threads) < kBlocksPerSM * sm_count()) {
    threads >>= 1;
  }
  hmc_accept_kernel<U, kFused, kPer>
      <<<static_cast<unsigned>(blocks(threads)), threads, 0, s>>>(a);
}

template <typename U, bool kFused>
void launch(const Args& a, cudaStream_t s) {
  const int per = (a.nu + a.team - 1) / a.team;
  if (per <= 1) {
    launch<U, kFused, 1>(a, s);
  } else if (per == 2) {
    launch<U, kFused, 2>(a, s);
  } else if (per == 3) {
    launch<U, kFused, 3>(a, s);
  } else {
    launch<U, kFused, kMaxPer>(a, s);
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers.
// mom0 != nullptr selects the fused form (p is p_half, eps is read, h_old
// is not); else p and h_old are given. old_pos == nullptr (with old_g)
// means in place: out_pos, out_g and out_lp are the state, and only
// accepted rows are written there. vec4 != 0 promises D % 4 == 0 and
// 16-byte aligned (N, D) and (D,) arrays.
extern "C" int nf_hmc_accept_f32(
    const float* q, const float* p, const float* g_new, const float* mom0,
    const float* eps, const float* h_old, const float* lp_new,
    const float* lp_old, const float* log_u, const float* inv_mass,
    const float* old_pos, const float* old_g, float* out_pos, float* out_g,
    float* out_lp, float* out_accept_prob, uint8_t* out_accepted,
    float* out_d_energy, int64_t n, int d, int vec4, void* stream) {
  Args a{q, p, g_new, mom0, eps, h_old, lp_new, lp_old, log_u, inv_mass,
         old_pos, old_g, out_pos, out_g, out_lp, out_accept_prob,
         out_accepted, out_d_energy, n, vec4 ? d / 4 : d, 0, 0};
  a.team = plan_team(a.nu);
  while ((1 << a.team_shift) < a.team) ++a.team_shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = mom0 != nullptr;
  if (vec4) {
    if (fused) {
      launch<float4, true>(a, s);
    } else {
      launch<float4, false>(a, s);
    }
  } else {
    if (fused) {
      launch<float, true>(a, s);
    } else {
      launch<float, false>(a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
