// Resident Riccati interior point for batched stage QPs, one CUDA kernel.
//
// Replaces the TPU kernel apf_quadruped_tpu/ops/pallas_riccati.py::_ipm_kernel
// (reached through _ipm_call and solve_stage_qp_resident).  It runs the whole
// fixed-iteration Mehrotra predictor-corrector of
// apf_quadruped_tpu/ops/riccati.py::solve_stage_qp for a batch of MPC stage QPs
// in one launch: init (cold or per-lane warm), then per iteration the rollout,
// the costate/residual sweep, the barrier Hessians R + reg I + G' W G, the
// 12x12 Cholesky of M_k = R_k + B_k' P B_k, the gains K_k, the P update, the
// predictor's backward and forward vector passes, sigma = clamp(mu_aff /
// mu)^sigma_pow, the corrector passes, the fraction-to-boundary step and the
// update clamped at min_slack.  Optional rows: state rows Cx x_{k+1} <= cx
// (mc > 0, base_box) and 12 accel rows +-B_k[6:12] u <= acc -+ A_k[6:12,12]
// (acc != nullptr, base_acc), which sit after the input rows exactly as in
// the scan's layout.  Semantics follow the scan IPM (the port's plain
// version, apf_quadruped_tpu_torch/ops/riccati.py), including its cold init,
// which takes one slack shift over the input and accel rows together.
//
// Design for Hopper: one warp per scenario, eight scenarios a block.  The
// Riccati recursion is serial over the horizon, so a scenario's time is the
// latency of its per-knot chain; the design keeps that chain off device
// memory and short:
//  - Staging.  The wrapper packs each knot's inputs (A_k, B_k', q, mask, h,
//    cx, mask_x) into one 16-byte aligned record; the iterate (u, x, z, s,
//    zx, sx) and the per-knot scratch (L^-1, K', kff, rx, rz, the step
//    directions) live in records of the same kind.  Every horizon sweep
//    stages knot k +- 1's records into a two-slot shared-memory ring with
//    16-byte cp.async while the warp works on knot k, so the chain never
//    waits on L2 or HBM; results go out as plain stores.
//  - Five sweeps an iteration: the rollout; one backward sweep that does
//    the costates and residuals, the factorization and the predictor's
//    backward vector pass (a lane that turns out converged drops that
//    sweep's factors); the predictor's forward pass; the corrector's
//    backward and forward passes; and a short staged sweep for mu_aff.  The
//    step is applied to u while the next rollout reads it and to z, s while
//    the next backward sweep reads them, so no sweep only updates.
//  - Compile-time widths: 13 states and 12 inputs (the wrapper pads smaller
//    problems with exact zeros and an identity input block), so every index
//    is a constant and the 13-wide products unroll: lanes (column, half of
//    the rows) hold a column of P or A in registers; the Cholesky keeps one
//    row of M per lane and broadcasts pivots by shuffles; K is solved for
//    its 13 columns at once in registers while the other half-warp forms
//    L^-1 from the identity's columns, so the vector passes apply M^-1 as
//    two triangular products in place of two 12-step substitutions.
//  - M's barrier Gram is summed per entry as (G_ri w_r) G_rj, in the plain
//    version's order, the accel rows' + and - halves apart.  A per-block
//    table GG_r = G_ri G_rj (the TPU kernel's GG) rounds in another order:
//    it moved a lane of the 130-scenario gate past 1e-4, so it went.
//  - bf16 storage (SolverConfig.stage_bf16; the TPU kernel's A/B streams
//    cast to bfloat16 by its wrapper, pallas_riccati.py:1403-1405): the
//    instance for __nv_bfloat16 reads each knot's A and B' from a bf16
//    block of their own (AB_REC elements, 672 bytes, padded to whole
//    16-byte pieces) and the rest of the record (IN_Q on) from a shorter
//    float32 record.  Both are staged in the same cp.async group; after
//    the wait the warp widens the block in place into the slot's float32
//    IN_A / IN_BT fields (each lane takes its pairs into registers before
//    any lane writes), so every use site reads float32 as in the float32
//    instance, and all the algebra stays float32.
// Not tensor cores: the products are 13x13 and 12x13, and the port keeps
// float32 without TF32, which mma / wgmma would need here (the parity gates
// are float32 gates).
//
// What bounds it on the H100: the serial chain of each warp's knots, and
// at one wave of B = 2048 (15.5 warps an SM) the instruction slots the
// SM's warps share; PERF.md has the phase shares and the time against the
// bound (ipm_phases.py, chip_smoke.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math (approximate division and flush-to-zero
// change the IPM's late iterations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NX = 13;      // states (smaller problems are padded)
constexpr int NU = 12;      // inputs (padded likewise)
constexpr int NL = NU * (NU + 1) / 2;
constexpr int M_MAX = 24;   // input rows per knot
constexpr int MC_MAX = 8;   // state rows per knot
constexpr int MACC = 12;    // accel rows per knot when enabled
constexpr int MT_MAX = M_MAX + MACC;
constexpr int WARPS = 8;    // scenarios per block
constexpr unsigned FULL = 0xffffffffu;

// Per-knot records, offsets in floats; every field starts on 16 bytes.
// inputs, packed by the wrapper: A (13x13), B' (12x13), q, mask, h (masked
// rows 1), cx (masked rows 1), mask_x
constexpr int IN_A = 0, IN_BT = 172, IN_Q = 328, IN_MASK = 344, IN_H = 368,
              IN_CX = 392, IN_MX = 400, IN_REC = 408;
// the bf16 instance's block of A (13x13) and B' (12x13), offsets in bf16
// elements, each padded to whole 16-byte pieces; its float32 record holds
// the fields from IN_Q on
constexpr int AB_A = 0, AB_BT = 176, AB_REC = 336;
static_assert(AB_BT >= NX * NX && AB_REC >= AB_BT + NU * NX && AB_BT % 8 == 0
              && AB_REC % 8 == 0 && AB_REC / 2 <= IN_Q,
              "whole 16-byte pieces, widened within the slot's A and B'");
// the iterate: u, x, z, s, zx, sx (the outputs)
constexpr int ST_U = 0, ST_X = 12, ST_Z = 28, ST_S = 64, ST_ZX = 100,
              ST_SX = 108, ST_REC = 116;
// scratch: L^-1 (12 rows of 12), K' (13 rows of 12), kff, rx, rz, du, dz,
// ds, rzx, dzx, dsx
constexpr int SC_LI = 0, SC_KT = 144, SC_KFF = 300, SC_RX = 312, SC_RZ = 324,
              SC_DU = 360, SC_DZ = 372, SC_DS = 408, SC_RZX = 444,
              SC_DZX = 452, SC_DSX = 460, SC_REC = 468;
// a ring slot holds one knot's three records
constexpr int SL_IN = 0, SL_ST = IN_REC, SL_SC = IN_REC + ST_REC,
              SLOT = SL_SC + SC_REC;

// a warp's working set beside its ring
struct Work {
  float P[172];     // cost-to-go Hessian (13x13); Pb, then the next P
  float AtP[172];   // A' Pb
  float BtP[156];   // B' Pb (12x13); then L, then L^-1 (12 rows of 12)
  float BtPA[156];  // B' Pb A (12x13)
  float Kt[156];    // M's lower triangle (12 rows of 12), then K' (13x12)
  float dinv[16], w[MT_MAX], rz[MT_MAX], rx[16], rzx[MC_MAX], vx[MC_MAX];
  float xv[16], lam[16], lamk[16], sv[16], uv[16], gu[16];
  // the scenario's scalars that live across sweeps, here rather than in
  // registers, which the knot bodies need: the residual scales, the
  // number of real rows, the pending step and sigma mu
  float qnorm, hnorm, meff, step, sig_mu, pad[3];
};
constexpr int WORK = sizeof(Work) / sizeof(float);
constexpr int WARP_FLOATS = 2 * SLOT + WORK;
static_assert(SLOT % 4 == 0 && WORK % 4 == 0, "16-byte aligned slots");

// block-shared constants
struct Consts {
  float G[M_MAX * NU], R[NU * NU], Q[172], C[MC_MAX * NX], acc[8];
  int tri[80];            // entry e of a packed lower triangle -> 16 i + j
};

// max and min that return a NaN operand, as torch.maximum, torch.clamp and
// amax do (fmaxf and fminf drop it): a poisoned scenario must carry NaN
// into mu and res, so that it never counts as converged and its gap and
// residual come back as inf, as in the scan
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// sum over t < N of X[t xs] Y[t], one accumulator
template <int N>
__device__ __forceinline__ float dotn(const float* X, int xs, const float* Y) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < N; ++t) acc += X[t * xs] * Y[t];
  return acc;
}

// a compiler-only barrier: loads after it are not hoisted above it, which
// bounds how many operands an unrolled loop holds in registers at once
__device__ __forceinline__ void reg_fence() { asm volatile("" ::: "memory"); }

// 16 bytes from device memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int j = 0; j < 4; ++j) dst[j] = src[j];
#endif
}
__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}
// a value the compiler cannot see through: what is computed from it is
// computed after this point, not hoisted above it
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// N floats (a multiple of 4, both ends 16-byte aligned), lanes over the
// 16-byte pieces; N is a constant, so no lane computes a trip count
template <int N>
__device__ __forceinline__ void stage(float* dst, const float* src, int lane) {
  static_assert(N % 4 == 0, "whole 16-byte pieces");
#pragma unroll
  for (int t = 0; t < (N / 4 + 31) / 32; ++t) {
    const int i = (t * 32 + lane) * 4;
    if (N % 128 == 0 || i < N) cp16(dst + i, src + i);
  }
}

}  // namespace

extern "C" {

struct IpmArgs {
  const float* knots;  // (B, H, IN_REC) knot records
  const float* x0;     // (B, 13)
  const float* G;      // (m, 12)
  const float* R;      // (12, 12)
  const float* Q;      // (13, 13)
  // warm start, or all null
  const float* wu;     // (B, H, 12)
  const float* wz;     // (B, H, mt)
  const float* ws;     // (B, H, mt)
  const float* wvalid; // (B,) 1.0 = warm lane
  const float* Cx;     // (mc, 13), or null (mc = 0)
  const float* acc;    // accel-row bounds (6,), or null
  float* st;           // (B, H, ST_REC) the iterate, the outputs
  float* stat;         // (B, 4): converged, iters, mu, res
  float* scratch;      // (B, H, SC_REC)
  int B, H, m, mc, iters;
  float reltol, abstol, sigma_pow, frac, w_clip, min_slack, warm_floor, reg;
};

}  // extern "C"

namespace {

// T: the storage type of A and B' (float, or __nv_bfloat16 in `ab`)
template <class T>
__global__ void __launch_bounds__(WARPS * 32, 2)
    resident_ipm_kernel(IpmArgs a, const T* __restrict__ ab) {
  constexpr bool BF = !std::is_same<T, float>::value;
  // the first field of a.knots' records: A on, or q on beside `ab`
  constexpr int IN_LO = BF ? IN_Q : 0;
  constexpr int IN_LEN = IN_REC - IN_LO;
  __shared__ Consts c;
  extern __shared__ __align__(16) float dsm[];

  const int H = a.H, m = a.m, mc = a.mc;
  const bool macc = a.acc != nullptr;
  const bool warm = a.wu != nullptr;
  const int mt = m + (macc ? MACC : 0);
  const float ms = a.min_slack, wclip = a.w_clip;

  for (int i = threadIdx.x; i < m * NU; i += blockDim.x) c.G[i] = a.G[i];
  for (int i = threadIdx.x; i < NU * NU; i += blockDim.x) c.R[i] = a.R[i];
  for (int i = threadIdx.x; i < NX * NX; i += blockDim.x) c.Q[i] = a.Q[i];
  for (int i = threadIdx.x; i < mc * NX; i += blockDim.x) c.C[i] = a.Cx[i];
  if (macc && threadIdx.x < 6) c.acc[threadIdx.x] = a.acc[threadIdx.x];
  if (threadIdx.x < NL) {
    const int e = threadIdx.x;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    c.tri[e] = 16 * i + (e - i * (i + 1) / 2);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;   // whole warps only: no block barrier below
  float* ring = dsm + warp * WARP_FLOATS;
  Work& W = *reinterpret_cast<Work*>(ring + 2 * SLOT);
  // lanes of the 13-wide products: column `col` of the right-hand operand,
  // `half` of the rows
  int col = lane & 15, half = lane >> 4;
  bool colok = col < NX;

  // knot k's record from field f on
  auto in_k = [&](int k, int f) {
    return a.knots + ((size_t)b * H + k) * IN_LEN + (f - IN_LO);
  };
  auto st_k = [&](int k) { return a.st + ((size_t)b * H + k) * ST_REC; };
  auto sc_k = [&](int k) { return a.scratch + ((size_t)b * H + k) * SC_REC; };
  // knot k's A and B' into a slot: the bf16 instance's block lands at the
  // slot's start, to be widened once it has arrived
  auto stage_ab = [&](int k, float* S) {
    if constexpr (BF)
      stage<AB_REC / 2>(S + SL_IN, reinterpret_cast<const float*>(
                                       ab + ((size_t)b * H + k) * AB_REC),
                        lane);
    else
      stage<IN_Q>(S + SL_IN, in_k(k, 0), lane);
  };
  // knot k's whole input record
  auto stage_in = [&](int k, float* S) {
    if constexpr (BF) {
      stage_ab(k, S);
      stage<IN_LEN>(S + SL_IN + IN_LO, in_k(k, IN_LO), lane);
    } else {
      stage<IN_REC>(S + SL_IN, in_k(k, 0), lane);
    }
  };
  // the bf16 block at the slot's start -> float32 A and B' in place: every
  // lane reads its pairs before any lane writes (the block overlaps A)
  auto widen = [&](float* S) {
    constexpr int NP = AB_REC / 2, T2 = (NP + 31) / 32;
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(S + SL_IN);
    float2 v[T2];
#pragma unroll
    for (int t = 0; t < T2; ++t) {
      const int p = t * 32 + lane;
      if (NP % 32 == 0 || p < NP) v[t] = __bfloat1622float2(src[p]);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < T2; ++t) {
      const int e = 2 * (t * 32 + lane);   // even: no pair spans A and B'
      if (e < AB_BT) {
        if (e < NX * NX) S[SL_IN + IN_A + e] = v[t].x;
        if (e + 1 < NX * NX) S[SL_IN + IN_A + e + 1] = v[t].y;
      } else if (e < AB_BT + NU * NX) {
        S[SL_IN + IN_BT + e - AB_BT] = v[t].x;
        S[SL_IN + IN_BT + e + 1 - AB_BT] = v[t].y;
      }
    }
  };

  // One sweep over the horizon, forward or backward.  request(k, slot)
  // stages knot k's records; knot k + 1 (k - 1) is requested before the
  // warp starts on knot k, whose slot alternates with it.  `with_ab`: the
  // requests stage A and B' (which the bf16 instance widens on arrival).
  auto sweep = [&](bool fwd, auto request, auto body, bool with_ab = true) {
    auto knot = [&](int step) { return fwd ? step : H - 1 - step; };
    // the addresses and indices each lane derives from `lane` and `b` are
    // computed anew for each sweep: hoisted above all of them, they would
    // hold registers through the whole kernel
    lane = opaque(lane);
    b = opaque(b);
    col = lane & 15;
    half = lane >> 4;
    colok = col < NX;
    __syncwarp();
    request(knot(0), ring);
    cp_commit();
    for (int step = 0; step < H; ++step) {
      if (step + 1 < H) {
        request(knot(step + 1), ring + ((step + 1) & 1) * SLOT);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncwarp();
      if constexpr (BF) {
        if (with_ab) {
          widen(ring + (step & 1) * SLOT);
          __syncwarp();
        }
      }
      body(knot(step), ring + (step & 1) * SLOT);
      __syncwarp();   // the slot is free for the next request
    }
  };
  auto put = [&](float* dst, const float* src, int n) {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  };

  auto barrier_w = [&](float zv, float sv) {
    return nmin(nmax(nmax(zv, ms) / nmax(sv, ms), 0.f), wclip);
  };
  // row r's mask (accel rows 1) and right-hand side at a staged knot
  auto row_mask = [&](const float* S, int r) {
    return r < m ? S[SL_IN + IN_MASK + r] : 1.f;
  };
  auto row_h = [&](const float* S, int r) -> float {
    if (r < m) return S[SL_IN + IN_H + r];
    const int d = (r - m) % 6;
    const float off = S[SL_IN + IN_A + (6 + d) * NX + 12];
    return (r - m) < 6 ? c.acc[d] - off : c.acc[d] + off;
  };
  // g_r . v for row r: mask G[r] for the input rows, +-B[6+d] for the
  // accel rows
  auto row_dot = [&](const float* S, int r, const float* v) {
    float acc = 0.f;
    if (r < m) {
      const float mk = S[SL_IN + IN_MASK + r];
#pragma unroll
      for (int j = 0; j < NU; ++j) acc += mk * c.G[r * NU + j] * v[j];
    } else {
      const int d = (r - m) % 6;
      const float sg = (r - m) < 6 ? 1.f : -1.f;
#pragma unroll
      for (int j = 0; j < NU; ++j)
        acc += sg * S[SL_IN + IN_BT + j * NX + 6 + d] * v[j];
    }
    return acc;
  };
  // column j of G_m' w (input rows masked, then the accel rows)
  auto gt_dot = [&](const float* S, int j, const float* w) {
    float acc = 0.f;
    for (int r = 0; r < m; ++r)
      acc += S[SL_IN + IN_MASK + r] * c.G[r * NU + j] * w[r];
    if (macc) {
      const float* bj = S + SL_IN + IN_BT + j * NX + 6;
#pragma unroll
      for (int d = 0; d < 6; ++d) acc += bj[d] * w[m + d];
#pragma unroll
      for (int d = 0; d < 6; ++d) acc += -bj[d] * w[m + 6 + d];
    }
    return acc;
  };
  // out[i] = A[i] . x + B[i] . u for lanes i < 13, as two half-warp sums
  auto a_x_b_u = [&](const float* S, const float* x, const float* u) {
    const float* A = S + SL_IN + IN_A;
    const float* X = half ? S + SL_IN + IN_BT + col : A + col * NX;
    const float* Y = half ? u : x;
    float p = colok ? dotn<NU>(X, half ? NX : 1, Y) : 0.f;
    if (colok && !half) p += A[col * NX + 12] * x[12];
    return p + __shfl_xor_sync(FULL, p, 16);
  };

  // ---- init ---------------------------------------------------------------
  const bool valid = warm && a.wvalid[b] > 0.5f;
  float qn2 = 0.f, hn2 = 0.f, meff = 0.f, shift = 0.f, shiftx = 0.f;
  if (lane < 16) W.xv[lane] = lane < NX ? a.x0[(size_t)b * NX + lane] : 0.f;
  sweep(true, [&](int k, float* S) { stage_in(k, S); },
        [&](int k, float* S) {
    if (lane < NX) {
      const float qv = S[SL_IN + IN_Q + lane];
      qn2 += qv * qv;
    }
    for (int r = lane; r < mt; r += 32) {
      const float hv = row_h(S, r);
      hn2 += hv * hv;
      meff += row_mask(S, r);
      shift = nmax(shift, -hv);
    }
    if (lane < NU)
      st_k(k)[ST_U + lane] =
          valid ? a.wu[((size_t)b * H + k) * NU + lane] : 0.f;
    if (mc > 0) {
      // the state rows' init from the zero-control rollout, warm lanes too
      const float* A = S + SL_IN + IN_A;
      float xn = 0.f;
      if (lane < NX)
        for (int j = 0; j < NX; ++j) xn += A[lane * NX + j] * W.xv[j];
      __syncwarp();
      if (lane < NX) W.xv[lane] = xn;
      __syncwarp();
      if (lane < mc) {
        const float mk = S[SL_IN + IN_MX + lane];
        float r0 = 0.f;
        for (int i = 0; i < NX; ++i) r0 += mk * c.C[lane * NX + i] * W.xv[i];
        const float cxv = S[SL_IN + IN_CX + lane];
        r0 -= cxv;
        sc_k(k)[SC_RZX + lane] = r0;
        shiftx = nmax(shiftx, r0);
        hn2 += cxv * cxv;
        meff += mk;
      }
    }
  });
  shift = warp_max(shift) + 1.f;
  shiftx = warp_max(shiftx) + 1.f;
  sweep(true, [&](int k, float* S) {
    stage_in(k, S);
    if (mc > 0) stage<8>(S + SL_SC + SC_RZX, sc_k(k) + SC_RZX, lane);
  }, [&](int k, float* S) {
    float* stg = st_k(k);
    const size_t wrow = ((size_t)b * H + k) * mt;
    for (int r = lane; r < mt; r += 32) {
      const float hv = row_h(S, r);
      float sv = hv + shift, zv = nmax(-hv, 0.f) + 1.f;
      if (valid) {
        sv = nmax(a.ws[wrow + r], a.warm_floor);
        zv = nmax(a.wz[wrow + r], a.warm_floor);
      }
      stg[ST_S + r] = sv;
      stg[ST_Z + r] = zv;
    }
    if (lane < mc) {
      const float r0 = S[SL_SC + SC_RZX + lane];
      stg[ST_SX + lane] = -r0 + shiftx;
      stg[ST_ZX + lane] = nmax(r0, 0.f) + 1.f;
    }
  });
  qn2 = warp_sum(qn2);
  hn2 = warp_sum(hn2);
  meff = warp_sum(meff);
  W.qnorm = 1.f + sqrtf(qn2);
  W.hnorm = 1.f + sqrtf(hn2);
  W.meff = nmax(meff, 1.f);

  // ---- the factorization at a staged knot ---------------------------------
  // W.P holds Pbar_{k+1} on entry and Pbar_k on exit; W.BtP then holds
  // L_k^-1 (rows of 12) and W.Kt K_k' (rows of 12).
  auto factor_knot = [&](const float* S) {
    const float* A = S + SL_IN + IN_A;
    const float* Bt = S + SL_IN + IN_BT;
    // barrier weights; an input row's carries its mask twice, as Gm' W Gm
    for (int r = lane; r < mt; r += 32) {
      float wr = barrier_w(S[SL_ST + ST_Z + r], S[SL_ST + ST_S + r]);
      if (r < m) {
        const float mk = S[SL_IN + IN_MASK + r];
        wr *= mk * mk;
      }
      W.w[r] = wr;
    }
    if (mc > 0) {   // Pb = Pbar + Cm' diag(Wx) Cm
      if (lane < mc) {
        const float mk = S[SL_IN + IN_MX + lane];
        W.vx[lane] = mk * mk * barrier_w(S[SL_ST + ST_ZX + lane],
                                         S[SL_ST + ST_SX + lane]);
      }
      __syncwarp();
      if (colok) {
#pragma unroll 1
        for (int ii = 0; ii < 7; ++ii) {
          const int i = half * 7 + ii;
          if (i < NX) {
            float acc = 0.f;
            for (int j = 0; j < mc; ++j)
              acc += c.C[j * NX + i] * W.vx[j] * c.C[j * NX + col];
            W.P[i * NX + col] += acc;
          }
        }
      }
    }
    __syncwarp();
    // B'Pb and A'Pb: a lane holds column `col` of Pb, its half of the rows
    if (colok) {
      float pc[NX];
#pragma unroll
      for (int t = 0; t < NX; ++t) pc[t] = W.P[t * NX + col];
#pragma unroll 1
      for (int jj = 0; jj < 6; ++jj) {
        const int j = half * 6 + jj;
        W.BtP[j * NX + col] = dotn<NX>(Bt + j * NX, 1, pc);
      }
#pragma unroll 1
      for (int ii = 0; ii < 7; ++ii) {
        const int i = half * 7 + ii;
        if (i < NX) W.AtP[i * NX + col] = dotn<NX>(A + i, NX, pc);
      }
    }
    __syncwarp();
    // B'PbA (a lane holds column `col` of A) and the lower triangle of
    // M = R + reg I + Gm' W Gm + B'Pb B, one entry a lane
    if (colok) {
      float ac[NX];
#pragma unroll
      for (int t = 0; t < NX; ++t) ac[t] = A[t * NX + col];
#pragma unroll 1
      for (int jj = 0; jj < 6; ++jj) {
        const int j = half * 6 + jj;
        W.BtPA[j * NX + col] = dotn<NX>(W.BtP + j * NX, 1, ac);
      }
    }
    float* Mb = W.Kt;
#pragma unroll 1
    for (int e = lane; e < NL; e += 32) {
      const int ij = c.tri[e], i = ij >> 4, j = ij & 15;
      float acc = c.R[i * NU + j] + (i == j ? a.reg : 0.f);
#pragma unroll 4
      for (int r = 0; r < m; ++r)
        acc += (c.G[r * NU + i] * W.w[r]) * c.G[r * NU + j];
      if (macc) {   // the + rows, then the - rows
#pragma unroll
        for (int d = 0; d < 6; ++d)
          acc += (Bt[i * NX + 6 + d] * W.w[m + d]) * Bt[j * NX + 6 + d];
#pragma unroll
        for (int d = 0; d < 6; ++d)
          acc += (Bt[i * NX + 6 + d] * W.w[m + 6 + d]) * Bt[j * NX + 6 + d];
      }
      acc += dotn<NX>(W.BtP + i * NX, 1, Bt + j * NX);
      Mb[i * NU + j] = acc;
    }
    __syncwarp();
    // Cholesky of M, right-looking, lane i holding row i; the pivot and
    // the column below it reach the other lanes by shuffles.  NaN if M is
    // not positive definite.
    float rw[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j)
      rw[j] = (lane < NU && j <= lane) ? Mb[lane * NU + j] : 0.f;
    float mydi = 0.f;
    float piv = rw[0];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float d = __shfl_sync(FULL, piv, j);
      const float lj = d > 0.f ? sqrtf(d) : NAN;
      const float di = 1.f / lj;
      if (lane == j) {
        rw[j] = lj;
        mydi = di;
      } else if (lane > j) {
        rw[j] *= di;
      }
      if (j + 1 < NU) piv = rw[j + 1] - rw[j] * rw[j];
#pragma unroll
      for (int cc = j + 1; cc < NU; ++cc) {
        const float lc = __shfl_sync(FULL, rw[j], cc);
        if (lane >= cc) rw[cc] -= rw[j] * lc;
      }
    }
    float* L = W.BtP;   // B'Pb is spent
    if (lane < NU) {
#pragma unroll
      for (int j = 0; j < NU; ++j) L[lane * NU + j] = rw[j];
      W.dinv[lane] = mydi;
    }
    __syncwarp();
    // K = M^-1 B'PbA, all 13 columns at once (lane = column): 12 forward
    // and 12 backward steps, in registers.  The other half-warp runs the
    // same forward steps on the columns of the identity: L^-1, with which
    // the vector passes apply M^-1 as two products
    float kc[NU];
    const bool kcol = half ? col < NU : colok;   // K's columns; L^-1's
    if (kcol) {
#pragma unroll
      for (int j = 0; j < NU; ++j)
        kc[j] = half ? (j == col ? 1.f : 0.f) : W.BtPA[j * NX + col];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        reg_fence();
        kc[i] *= W.dinv[i];
#pragma unroll
        for (int r = i + 1; r < NU; ++r) kc[r] -= L[r * NU + i] * kc[i];
      }
    }
    if (kcol && !half) {
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        reg_fence();
        kc[i] *= W.dinv[i];
#pragma unroll
        for (int t = 0; t < i; ++t) kc[t] -= L[i * NU + t] * kc[i];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) W.Kt[col * NU + j] = kc[j];
    }
    __syncwarp();
    if (kcol && half) {   // L^-1 in place of L, which is spent
#pragma unroll
      for (int i = 0; i < NU; ++i) L[i * NU + col] = kc[i];
    }
    __syncwarp();
    // P <- sym(Q + A'Pb A - K' B'PbA)
    if (colok) {
      float ac[NX], bc[NU];
#pragma unroll
      for (int t = 0; t < NX; ++t) ac[t] = A[t * NX + col];
#pragma unroll
      for (int j = 0; j < NU; ++j) bc[j] = W.BtPA[j * NX + col];
#pragma unroll 1
      for (int ii = 0; ii < 7; ++ii) {
        const int i = half * 7 + ii;
        if (i < NX) {
          float acc = c.Q[i * NX + col];
#pragma unroll
          for (int t = 0; t < NX; ++t) acc += W.AtP[i * NX + t] * ac[t];
#pragma unroll
          for (int j = 0; j < NU; ++j) acc -= W.Kt[i * NU + j] * bc[j];
          W.P[i * NX + col] = acc;
        }
      }
    }
    __syncwarp();
    if (colok) {   // each pair (i, col < i) by the lane of column col
#pragma unroll 1
      for (int ii = 0; ii < 7; ++ii) {
        const int i = half * 7 + ii;
        if (i < NX && col < i) {
          const float v = 0.5f * (W.P[i * NX + col] + W.P[col * NX + i]);
          W.P[i * NX + col] = v;
          W.P[col * NX + i] = v;
        }
      }
    }
    __syncwarp();
  };

  // ---- the backward vector pass at a staged knot ----------------------------
  // sv (the value gradient at x_{k+1}) gains the state rows' term, then
  // kff_k = M_k^-1 g_u and sv <- A' sv - K' g_u.  rc(S, r) / rcx(S, j) give
  // the complementarity right-hand sides (predictor or corrector).
  auto vector_bwd = [&](const float* S, const float* Li, const float* Kt,
                        const float* rx, const float* rz, const float* rzx,
                        auto rc, auto rcx, float* kff) {
    const float* A = S + SL_IN + IN_A;
    const float* Bt = S + SL_IN + IN_BT;
    if (mc > 0) {
      if (lane < mc) {
        const float zxv = S[SL_ST + ST_ZX + lane];
        const float sxv = S[SL_ST + ST_SX + lane];
        W.vx[lane] = S[SL_IN + IN_MX + lane]
                     * (barrier_w(zxv, sxv) * rzx[lane]
                        + rcx(S, lane) / nmax(sxv, ms));
      }
      __syncwarp();
      if (lane < NX) {
        float add = 0.f;
        for (int j = 0; j < mc; ++j)
          add += S[SL_IN + IN_MX + j] * c.C[j * NX + lane] * W.vx[j];
        W.sv[lane] += add;
      }
    }
    for (int r = lane; r < mt; r += 32) {
      const float svr = S[SL_ST + ST_S + r];
      W.w[r] = barrier_w(S[SL_ST + ST_Z + r], svr) * rz[r]
               + rc(S, r) / nmax(svr, ms);
    }
    __syncwarp();
    // g_u = rx + B' sv + Gm' w
    float g = 0.f;
    if (lane < NU) {
      g = rx[lane] + dotn<NX>(Bt + lane * NX, 1, W.sv);
      g += gt_dot(S, lane, W.w);
      W.gu[lane] = g;
    }
    __syncwarp();
    // kff = (L L')^-1 g = L^-T (L^-1 g): two triangular products, a row a
    // lane, in place of two substitutions of 12 dependent steps each
    float v = 0.f;
    if (lane < NU) {
#pragma unroll
      for (int t = 0; t < NU; ++t) v += Li[lane * NU + t] * W.gu[t];
      W.uv[lane] = v;
    }
    __syncwarp();
    v = 0.f;
    if (lane < NU) {
#pragma unroll
      for (int t = 0; t < NU; ++t) v += Li[t * NU + lane] * W.uv[t];
    }
    if (lane < NU) kff[lane] = v;
    __syncwarp();
    float svn = 0.f;
    if (lane < NX) {
      svn = dotn<NX>(A + lane, NX, W.sv);
#pragma unroll
      for (int j = 0; j < NU; ++j) svn -= Kt[lane * NU + j] * W.gu[j];
    }
    __syncwarp();
    if (lane < NX) W.sv[lane] = svn;
  };

  // ---- the sweeps of an iteration -----------------------------------------
  // The pending step W.step of the previous iteration (pend: every
  // iteration but the first) is applied to u here, and to z, s (zx, sx) in
  // `backward`, as each knot is read.
  auto rollout = [&](bool pend) {
    if (lane < 16) W.xv[lane] = lane < NX ? a.x0[(size_t)b * NX + lane] : 0.f;
    sweep(true, [&](int k, float* S) {
      stage_ab(k, S);                                      // A, B'
      stage<ST_X>(S + SL_ST, st_k(k), lane);               // u
      if (pend) stage<12>(S + SL_SC + SC_DU, sc_k(k) + SC_DU, lane);
    }, [&](int k, float* S) {
      if (lane < NU) {
        float u = S[SL_ST + ST_U + lane];
        if (pend) {
          u += W.step * S[SL_SC + SC_DU + lane];
          st_k(k)[ST_U + lane] = u;
        }
        W.uv[lane] = u;
      }
      __syncwarp();
      const float xn = a_x_b_u(S, W.xv, W.uv);
      __syncwarp();
      if (lane < NX) {
        W.xv[lane] = xn;
        st_k(k)[ST_X + lane] = xn;
      }
    });
  };

  auto rc_aff = [&](const float* S, int r) {
    return -S[SL_ST + ST_S + r] * S[SL_ST + ST_Z + r];
  };
  auto rcx_aff = [&](const float* S, int j) {
    return -S[SL_ST + ST_SX + j] * S[SL_ST + ST_ZX + j];
  };

  // Costates and residuals, backward, giving (mu, res); with `factor`, at
  // each knot also the factorization and the predictor's backward vector
  // pass, whose L^-1, K', kff go to scratch with rx, rz, rzx.
  auto backward = [&](bool pend, bool factor, float& mu, float& res) {
    float rx2 = 0.f, rz2 = 0.f, sz = 0.f;
    if (lane < 16) {
      W.lam[lane] = 0.f;
      W.sv[lane] = 0.f;
    }
    for (int e = lane; e < NX * NX; e += 32) W.P[e] = c.Q[e];
    sweep(false, [&](int k, float* S) {
      stage_in(k, S);
      stage<ST_REC>(S + SL_ST, st_k(k), lane);
      if (pend) stage<SC_REC - SC_DZ>(S + SL_SC + SC_DZ, sc_k(k) + SC_DZ, lane);
    }, [&](int k, float* S) {
      const float* A = S + SL_IN + IN_A;
      const float* Bt = S + SL_IN + IN_BT;
      float* stg = st_k(k);
      float* scg = sc_k(k);
      if (pend) {   // the step on z, s and zx, sx, clamped at min_slack
        const float step = W.step;
        for (int r = lane; r < mt; r += 32) {
          const float zv = nmax(S[SL_ST + ST_Z + r] + step * S[SL_SC + SC_DZ + r], ms);
          const float sv = nmax(S[SL_ST + ST_S + r] + step * S[SL_SC + SC_DS + r], ms);
          S[SL_ST + ST_Z + r] = zv;
          S[SL_ST + ST_S + r] = sv;
          stg[ST_Z + r] = zv;
          stg[ST_S + r] = sv;
        }
        if (lane < mc) {
          const float zv = nmax(S[SL_ST + ST_ZX + lane] + step * S[SL_SC + SC_DZX + lane], ms);
          const float sv = nmax(S[SL_ST + ST_SX + lane] + step * S[SL_SC + SC_DSX + lane], ms);
          S[SL_ST + ST_ZX + lane] = zv;
          S[SL_ST + ST_SX + lane] = sv;
          stg[ST_ZX + lane] = zv;
          stg[ST_SX + lane] = sv;
        }
        __syncwarp();
      }
      const float* xk = S + SL_ST + ST_X;
      const float* uk = S + SL_ST + ST_U;
      const float* zk = S + SL_ST + ST_Z;
      if (lane < NX) {
        float lk = S[SL_IN + IN_Q + lane] + W.lam[lane];
        lk += dotn<NX>(c.Q + lane * NX, 1, xk);
        for (int j = 0; j < mc; ++j)
          lk += S[SL_IN + IN_MX + j] * c.C[j * NX + lane] * S[SL_ST + ST_ZX + j];
        W.lamk[lane] = lk;
      }
      if (lane < mc) {
        const float zxv = S[SL_ST + ST_ZX + lane], sxv = S[SL_ST + ST_SX + lane];
        const float mk = S[SL_IN + IN_MX + lane];
        float r = sxv - S[SL_IN + IN_CX + lane];
        for (int i = 0; i < NX; ++i) r += mk * c.C[lane * NX + i] * xk[i];
        W.rzx[lane] = r;
        scg[SC_RZX + lane] = r;
        rz2 += (r * mk) * (r * mk);
        sz += sxv * zxv * mk;
      }
      for (int r = lane; r < mt; r += 32) {
        const float sv = S[SL_ST + ST_S + r], mk = row_mask(S, r);
        const float rr = row_dot(S, r, uk) + sv - row_h(S, r);
        W.rz[r] = rr;
        scg[SC_RZ + r] = rr;
        rz2 += (rr * mk) * (rr * mk);
        sz += sv * zk[r] * mk;
      }
      __syncwarp();
      // rx = R u + B' lam_k + Gm' z;  lam <- A' lam_k
      if (lane < NU) {
        float acc = dotn<NU>(c.R + lane * NU, 1, uk);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc += Bt[lane * NX + i] * W.lamk[i];
        acc += gt_dot(S, lane, zk);
        W.rx[lane] = acc;
        scg[SC_RX + lane] = acc;
        rx2 += acc * acc;
      }
      const float ln = lane < NX ? dotn<NX>(A + lane, NX, W.lamk) : 0.f;
      __syncwarp();
      if (lane < NX) W.lam[lane] = ln;
      if (factor) {
        factor_knot(S);
        vector_bwd(S, W.BtP, W.Kt, W.rx, W.rz, W.rzx, rc_aff,
                   rcx_aff, scg + SC_KFF);
        put(scg + SC_LI, W.BtP, NU * NU);
        put(scg + SC_KT, W.Kt, NX * NU);
      }
    });
    mu = warp_sum(sz) / W.meff;
    res = nmax(sqrtf(warp_sum(rx2)) / W.qnorm, sqrtf(warp_sum(rz2)) / W.hnorm);
  };

  // Forward vector pass: du_k = -K_k dx - kff_k, the row steps ds/dz (and
  // dsx/dzx from dx_{k+1}); returns the largest step in (0, inf] that keeps
  // every real row's s and z nonnegative.  The slot holds the previous
  // directions, which the corrector's rc reads, while the new ones are
  // stored.
  auto vector_fwd = [&](auto rc, auto rcx) -> float {
    float amax = INFINITY;
    auto ratio = [&](float v, float dv, float mk) {
      if (dv < 0.f && mk > 0.f) amax = nmin(amax, -v / dv);
    };
    if (lane < 16) W.xv[lane] = 0.f;
    sweep(true, [&](int k, float* S) {
      stage_in(k, S);
      stage<ST_REC - ST_Z>(S + SL_ST + ST_Z, st_k(k) + ST_Z, lane);
      stage<SC_DU - SC_KT>(S + SL_SC + SC_KT, sc_k(k) + SC_KT, lane);
      stage<SC_REC - SC_DZ>(S + SL_SC + SC_DZ, sc_k(k) + SC_DZ, lane);
    }, [&](int k, float* S) {
      const float* Kt = S + SL_SC + SC_KT;
      float* scg = sc_k(k);
      if (lane < NU) {
        const float d = -dotn<NX>(Kt + lane, NU, W.xv) - S[SL_SC + SC_KFF + lane];
        W.uv[lane] = d;
        scg[SC_DU + lane] = d;
      }
      __syncwarp();
      for (int r = lane; r < mt; r += 32) {
        const float zv = S[SL_ST + ST_Z + r], sv = S[SL_ST + ST_S + r];
        const float rcv = rc(S, r);
        const float dsv = -S[SL_SC + SC_RZ + r] - row_dot(S, r, W.uv);
        const float dzv = (rcv - zv * dsv) / nmax(sv, ms);
        scg[SC_DS + r] = dsv;
        scg[SC_DZ + r] = dzv;
        const float mk = row_mask(S, r);
        ratio(sv, dsv, mk);
        ratio(zv, dzv, mk);
      }
      const float dxn = a_x_b_u(S, W.xv, W.uv);
      __syncwarp();
      if (lane < NX) W.xv[lane] = dxn;
      __syncwarp();
      if (lane < mc) {
        const float zxv = S[SL_ST + ST_ZX + lane], sxv = S[SL_ST + ST_SX + lane];
        const float rcv = rcx(S, lane);
        const float mk = S[SL_IN + IN_MX + lane];
        float cdx = 0.f;
        for (int i = 0; i < NX; ++i) cdx += mk * c.C[lane * NX + i] * W.xv[i];
        const float dsv = -S[SL_SC + SC_RZX + lane] - cdx;
        const float dzv = (rcv - zxv * dsv) / nmax(sxv, ms);
        scg[SC_DSX + lane] = dsv;
        scg[SC_DZX + lane] = dzv;
        ratio(sxv, dsv, mk);
        ratio(zxv, dzv, mk);
      }
    });
    return warp_min(amax);
  };

  // mu_aff: the duality measure after the predictor's step a_aff
  auto mu_affine = [&](float a_aff) {
    float sz = 0.f;
    sweep(true, [&](int k, float* S) {
      stage<IN_REC - IN_MASK>(S + SL_IN + IN_MASK, in_k(k, IN_MASK), lane);
      stage<ST_REC - ST_Z>(S + SL_ST + ST_Z, st_k(k) + ST_Z, lane);
      stage<SC_REC - SC_DZ>(S + SL_SC + SC_DZ, sc_k(k) + SC_DZ, lane);
    }, [&](int, float* S) {
      for (int r = lane; r < mt; r += 32)
        sz += (S[SL_ST + ST_S + r] + a_aff * S[SL_SC + SC_DS + r])
              * (S[SL_ST + ST_Z + r] + a_aff * S[SL_SC + SC_DZ + r])
              * row_mask(S, r);
      if (lane < mc)
        sz += (S[SL_ST + ST_SX + lane] + a_aff * S[SL_SC + SC_DSX + lane])
              * (S[SL_ST + ST_ZX + lane] + a_aff * S[SL_SC + SC_DZX + lane])
              * S[SL_IN + IN_MX + lane];
    }, false);
    return warp_sum(sz) / W.meff;
  };

  // ---- IPM iterations -------------------------------------------------------
  // corrector: rc = -(s z + ds_a dz_a - sigma mu), the predictor's
  // directions read from the slot
  auto rc_cor = [&](const float* S, int r) {
    return -(S[SL_ST + ST_S + r] * S[SL_ST + ST_Z + r]
             + S[SL_SC + SC_DS + r] * S[SL_SC + SC_DZ + r] - W.sig_mu);
  };
  auto rcx_cor = [&](const float* S, int j) {
    return -(S[SL_ST + ST_SX + j] * S[SL_ST + ST_ZX + j]
             + S[SL_SC + SC_DSX + j] * S[SL_SC + SC_DZX + j] - W.sig_mu);
  };
  // Iteration `it` measures the iterate (with its factorization unless it
  // is the last measure, it == iters); a converged lane stops there with
  // its last measure as it is.
  for (int it = 0;; ++it) {
    rollout(it > 0);
    const bool last = it == a.iters;
    float mu, res;
    backward(it > 0, !last, mu, res);
    const bool conv = res < a.reltol && mu < a.abstol;   // warp-uniform
    if (conv || last) {
      if (lane == 0) {
        float* st = a.stat + (size_t)b * 4;
        st[0] = conv ? 1.f : 0.f;
        st[1] = (float)it;
        st[2] = mu;
        st[3] = res;
      }
      return;
    }
    const float a_aff = nmin(vector_fwd(rc_aff, rcx_aff), 1.f);
    const float mu_aff = mu_affine(a_aff);
    const float sigma =
        powf(nmin(nmax(mu_aff / nmax(mu, ms), 0.f), 1.f), a.sigma_pow);
    W.sig_mu = sigma * mu;
    if (lane < 16) W.sv[lane] = 0.f;
    sweep(false, [&](int k, float* S) {
      stage_in(k, S);
      stage<ST_REC - ST_Z>(S + SL_ST + ST_Z, st_k(k) + ST_Z, lane);
      stage<SC_DU>(S + SL_SC, sc_k(k), lane);
      stage<SC_REC - SC_DZ>(S + SL_SC + SC_DZ, sc_k(k) + SC_DZ, lane);
    }, [&](int k, float* S) {
      const float* sc = S + SL_SC;
      vector_bwd(S, sc + SC_LI, sc + SC_KT, sc + SC_RX,
                 sc + SC_RZ, sc + SC_RZX, rc_cor, rcx_cor, sc_k(k) + SC_KFF);
    });
    const float step = nmin(a.frac * vector_fwd(rc_cor, rcx_cor), 1.f);
    __syncwarp();
    W.step = step;
  }
}

template <class T>
int launch(const IpmArgs& args, const T* ab, cudaStream_t stream) {
  const int dyn = WARPS * WARP_FLOATS * (int)sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      resident_ipm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn);
  if (err != 0) return err;
  const int blocks = (args.B + WARPS - 1) / WARPS;
  resident_ipm_kernel<T><<<blocks, WARPS * 32, dyn, stream>>>(args, ab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widths and record layout compiled into the kernel, for the wrapper:
// NX, NU, M_MAX, MC_MAX, IN_REC, IN_A, IN_BT, IN_Q, IN_MASK, IN_H, IN_CX,
// IN_MX, ST_REC, ST_U, ST_X, ST_Z, ST_S, ST_ZX, ST_SX, SC_REC, and the bf16
// instance's block (AB_A, AB_BT, AB_REC, in bf16 elements) and the first
// field of its float32 record (IN_Q).
int resident_ipm_layout(int* v, int n) {
  const int vals[] = {NX, NU, M_MAX, MC_MAX, IN_REC, IN_A, IN_BT, IN_Q,
                      IN_MASK, IN_H, IN_CX, IN_MX, ST_REC, ST_U, ST_X, ST_Z,
                      ST_S, ST_ZX, ST_SX, SC_REC, AB_A, AB_BT, AB_REC, IN_Q};
  const int count = (int)(sizeof(vals) / sizeof(vals[0]));
  for (int i = 0; i < n && i < count; ++i) v[i] = vals[i];
  return count;
}

// Launch on `stream`, one warp per scenario; returns the CUDA error of the
// attribute calls or the launch (0 = launched).  The float32 instance reads
// A and B' from the knot records; the bf16 instance from `ab`, (B, H,
// AB_REC) bf16 blocks, its knot records holding the fields from IN_Q on.
int resident_ipm_launch(const IpmArgs* args, void* stream) {
  return launch<float>(*args, nullptr, (cudaStream_t)stream);
}

int resident_ipm_bf16_launch(const IpmArgs* args, const void* ab,
                             void* stream) {
  return launch<__nv_bfloat16>(*args,
                               static_cast<const __nv_bfloat16*>(ab),
                               (cudaStream_t)stream);
}

}  // extern "C"
