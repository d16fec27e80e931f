// The three passes of the fused Riccati interior point, three CUDA kernels.
//
// Replace the TPU kernels of apf_quadruped_tpu/ops/pallas_riccati.py that
// solve_stage_qp_fused (MpcConfig.backend "riccati_fused") launches in every
// Mehrotra iteration:
//   rollout  <- _rollout_kernel (via _rollout_call): x_{k+1} = A_k x_k + B_k u_k
//               forward; lam_k = Q x_{k+1} + q_k + A_{k+1}' lam_{k+1} backward;
//               rx_k = R u_k + B_k' lam_k + G' zm_k, gu_k = G u_k.  Once an
//               iteration, plus once after the loop.
//   factor   <- _factor_kernel (via _factor_call): per knot, backward,
//               M_k = R + G' diag(W_k) G + B_k' P B_k, its Cholesky factor
//               L_k (lower, zeros above) and 1 / diag(L_k), the gains
//               K_k = M_k^-1 B_k' P A_k and P <- sym(Q + A_k' P A_k - K_k' B_k' P A_k),
//               P starting at Q.  R here already holds the regularisation.
//               Once an iteration.
//   vector   <- _vector_kernel (via _vector_call): the affine LQR pass against
//               the stored factors: backward g = rx_k + G' vm_k + B_k' sv,
//               kff_k = M_k^-1 g, sv <- A_k' sv - K_k' g; forward
//               du_k = -K_k dx - kff_k, gdu_k = G du_k,
//               dx <- A_k dx + B_k du_k.  Twice an iteration (predictor and
//               corrector).
// Arrays are batch-first and contiguous per scenario: A (B, H, nx, nx),
// Bm (B, H, nx, nu), vectors (B, H, rows), L (B, H, nu, nu), K (B, H, nu, nx);
// G (m, nu), R (nu, nu), Q (nx, nx) are shared by the batch.
//
// Design: one warp per scenario, four scenarios a block; the horizon is a
// loop inside the warp (the TPU's sequential fori_loop).  The rollout
// copies each knot's A_k and B_k into shared memory with plain loads and
// keeps its x_k history there for the backward sweep (H * nx floats a
// warp).  The factor and vector passes follow the resident kernel
// (resident_ipm.cu, whose per-knot algebra they repeat in their own copy):
//  - Compile-time widths: 13 states, 12 inputs, 24 or 32 constraint rows
//    (two instances).  A smaller problem is padded as it is staged: zero
//    rows and columns of A, B, Q, G and W, an identity block of R, so M is
//    diag(M, I), L diag(L, I), 1 / diag(L) 1 and K 0 on the padding, and
//    only the real block is written out.  Every index of the products is a
//    constant and the 13-wide products unroll.
//  - Staging: a sweep over the horizon stages knot k -+ 1's inputs into a
//    two-slot shared-memory ring a warp by 4-byte cp.async (a knot's A_k is
//    676 bytes, so its arrays start on 4-byte boundaries only) while the
//    warp works on knot k.  The factor pass stages A_k and B_k transposed,
//    rows of 16, so that its products read them as float4s.
//  - The factor's chain in registers: a lane holds a column of P (or of
//    A) across the 13-wide products, half of the rows a lane; M's lower
//    triangle is one entry a lane, its Gram in the plain version's order,
//    (G_ri w_r) G_rj over r; the Cholesky keeps a row of M a lane and
//    broadcasts each pivot and column by shuffles; K is solved for its 13
//    columns at once in registers; P is read symmetrised as the next knot
//    loads it.  A knot whose M is not positive definite (!(d > 0), NaN
//    included) writes NaN L, dinv and K, and so does every earlier knot, as
//    the plain version (cholesky_ex with a NaN fill) does: the interior
//    point quarantines the lane.
//  - The vector pass's substitutions by shuffles: a lane holds row `lane`
//    and column `lane` of L_k, so (L L') kff = g is 2 x 12 steps of one
//    shuffle and one FMA; kff stays in shared memory (H x 12 floats a warp)
//    for the forward sweep.
//
// What bounds them on the H100: each pass moves 70-120 MB at B = 2048,
// H = 20 (20-35 us at 3.35 TB/s, which sets their bound: the operations
// take less), but runs H dependent knots, each a chain of dependent
// shuffles, shared-memory round trips and FMAs, so the latency of that
// chain, and at one wave (15.5 warps an SM) the issue slots the SM's warps
// share, set their time.  PERF.md has their times against the bound
// (chip_smoke.py, fused_turns.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NX_MAX = 13;
constexpr int NU_MAX = 12;
constexpr int M_MAX = 32;
constexpr int WARPS = 4;    // scenarios per block
// dynamic shared memory of the rollout (x history), under the 48 KB a
// block gets without an opt-in, beside the static arrays
constexpr size_t DYN_MAX = 36 * 1024;

struct Dims {
  int B, H, nx, nu, m;
};

// block-shared constants, loaded by every thread before the warps split
struct Consts {
  float G[M_MAX * NU_MAX], R[NU_MAX * NU_MAX], Q[NX_MAX * NX_MAX];
};

__device__ void load_consts(Consts& c, const float* G, const float* R,
                            const float* Q, const Dims& d) {
  if (G)
    for (int i = threadIdx.x; i < d.m * d.nu; i += blockDim.x) c.G[i] = G[i];
  if (R)
    for (int i = threadIdx.x; i < d.nu * d.nu; i += blockDim.x) c.R[i] = R[i];
  if (Q)
    for (int i = threadIdx.x; i < d.nx * d.nx; i += blockDim.x) c.Q[i] = Q[i];
  __syncthreads();
}

// copy n floats from device memory to shared memory, lanes over entries
__device__ void copy(float* dst, const float* __restrict__ src, int n,
                     int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// rollout + adjoint + stationarity pieces
// ---------------------------------------------------------------------------

struct RolloutSmem {
  float A[NX_MAX * NX_MAX], Bm[NX_MAX * NU_MAX];
  float u[NU_MAX], zm[M_MAX], v[NX_MAX], lamk[NX_MAX];
};

__global__ void __launch_bounds__(WARPS * 32)
    rollout_kernel(const float* G, const float* R, const float* Q,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ q, const float* __restrict__ u,
                   const float* __restrict__ zm, const float* __restrict__ x0,
                   float* __restrict__ x, float* __restrict__ rx,
                   float* __restrict__ gu, Dims d) {
  __shared__ Consts c;
  __shared__ RolloutSmem smem[WARPS];
  extern __shared__ float xhist[];   // (WARPS, H, nx)
  load_consts(c, G, R, Q, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;   // whole warps only: no block barrier below
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  RolloutSmem& S = smem[warp];
  float* X = xhist + (size_t)warp * H * nx;
  const size_t bH = (size_t)b * H;

  // forward: x_{k+1} = A_k x_k + B_k u_k
  if (lane < nx) S.v[lane] = x0[(size_t)b * nx + lane];
  for (int k = 0; k < H; ++k) {
    __syncwarp();
    copy(S.A, A + (bH + k) * nx * nx, nx * nx, lane);
    copy(S.Bm, Bm + (bH + k) * nx * nu, nx * nu, lane);
    copy(S.u, u + (bH + k) * nu, nu, lane);
    __syncwarp();
    float xn = 0.f;
    if (lane < nx) {
      for (int j = 0; j < nx; ++j) xn += S.A[lane * nx + j] * S.v[j];
      for (int j = 0; j < nu; ++j) xn += S.Bm[lane * nu + j] * S.u[j];
    }
    __syncwarp();
    if (lane < nx) {
      S.v[lane] = xn;
      X[k * nx + lane] = xn;
      x[(bH + k) * nx + lane] = xn;
    }
  }

  // backward: costates, rx and gu; S.v carries A_{k+1}' lam_{k+1}
  __syncwarp();
  if (lane < nx) S.v[lane] = 0.f;
  for (int k = H - 1; k >= 0; --k) {
    __syncwarp();
    copy(S.A, A + (bH + k) * nx * nx, nx * nx, lane);
    copy(S.Bm, Bm + (bH + k) * nx * nu, nx * nu, lane);
    copy(S.u, u + (bH + k) * nu, nu, lane);
    copy(S.zm, zm + (bH + k) * m, m, lane);
    __syncwarp();
    if (lane < nx) {
      float lk = q[(bH + k) * nx + lane] + S.v[lane];
      for (int j = 0; j < nx; ++j) lk += c.Q[lane * nx + j] * X[k * nx + j];
      S.lamk[lane] = lk;
    }
    for (int r = lane; r < m; r += 32) {
      float acc = 0.f;
      for (int j = 0; j < nu; ++j) acc += c.G[r * nu + j] * S.u[j];
      gu[(bH + k) * m + r] = acc;
    }
    __syncwarp();
    if (lane < nu) {
      float acc = 0.f;
      for (int i = 0; i < nu; ++i) acc += c.R[lane * nu + i] * S.u[i];
      for (int i = 0; i < nx; ++i) acc += S.Bm[i * nu + lane] * S.lamk[i];
      for (int r = 0; r < m; ++r) acc += c.G[r * nu + lane] * S.zm[r];
      rx[(bH + k) * nu + lane] = acc;
    }
    if (lane < nx) {
      float ln = 0.f;
      for (int l = 0; l < nx; ++l) ln += S.A[l * nx + lane] * S.lamk[l];
      S.v[lane] = ln;   // S.v is read above only, before the last barrier
    }
  }
}

// ---------------------------------------------------------------------------
// factor and vector passes: compile-time widths, knots staged by cp.async
// ---------------------------------------------------------------------------

constexpr int NX = NX_MAX;   // states and inputs of the factor and vector
constexpr int NU = NU_MAX;   // kernels; smaller problems are padded as staged
constexpr int RS = 16;       // row stride of a staged 13-wide row: 4 float4s
constexpr int NL = NU * (NU + 1) / 2;
constexpr unsigned FULL = 0xffffffffu;

// 4 bytes from device memory into shared memory, asynchronously: a knot's
// A_k (676 bytes) and B_k (624) start on 4-byte boundaries only
__device__ __forceinline__ void cp4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
#else
  *dst = *src;
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
// a compiler-only barrier: loads after it are not hoisted above it, which
// bounds how many operands an unrolled loop holds in registers at once
__device__ __forceinline__ void reg_fence() { asm volatile("" ::: "memory"); }

// a value the compiler cannot see through: what is computed from it is
// computed after this point, not hoisted above it
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Stage the rows x cols row-major matrix at src (rows <= R, cols <= C) into
// dst[i * DS + j], or transposed into dst[j * DS + i] (TR), lanes over its
// entries.  Entries of the R x C frame outside rows x cols are not written:
// they keep the zeros the kernel puts there first (the padding).
template <int R, int C, int DS, bool TR>
__device__ __forceinline__ void stage_mat(float* dst, const float* src,
                                          int rows, int cols, int lane) {
  if (rows == R && cols == C) {   // the production widths: no division
#pragma unroll
    for (int t = 0; t < (R * C + 31) / 32; ++t) {
      const int e = t * 32 + lane;
      if (e < R * C) {
        if (!TR && DS == C) {
          cp4(dst + e, src + e);
        } else {
          const int i = e / C, j = e % C;
          cp4(dst + (TR ? j * DS + i : i * DS + j), src + e);
        }
      }
    }
  } else {
    for (int e = lane; e < rows * cols; e += 32) {
      const int i = e / cols, j = e % cols;
      cp4(dst + (TR ? j * DS + i : i * DS + j), src + e);
    }
  }
}
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n,
                                          int lane) {
  if (lane < n) cp4(dst + lane, src + lane);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// acc + the sum over t < N of x[t] y[t] in ascending t, one accumulator
// (the plain loops' order).  x: a 16-byte aligned row in shared memory;
// y: registers (dot_sr) or another such row (dot_ss).
template <int N>
__device__ __forceinline__ float dot_sr(const float* x, const float* y,
                                        float acc) {
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const float4 v = ld4(x + t);
    acc += v.x * y[t];
    if (t + 1 < N) acc += v.y * y[t + 1];
    if (t + 2 < N) acc += v.z * y[t + 2];
    if (t + 3 < N) acc += v.w * y[t + 3];
  }
  return acc;
}
template <int N>
__device__ __forceinline__ float dot_ss(const float* x, const float* y,
                                        float acc) {
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const float4 v = ld4(x + t), u = ld4(y + t);
    acc += v.x * u.x;
    if (t + 1 < N) acc += v.y * u.y;
    if (t + 2 < N) acc += v.z * u.z;
    if (t + 3 < N) acc += v.w * u.w;
  }
  return acc;
}
// the same with x strided by XS in shared memory (a column)
template <int N, int XS>
__device__ __forceinline__ float dot_cs(const float* x, const float* y,
                                        float acc) {
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const float4 u = ld4(y + t);
    acc += x[t * XS] * u.x;
    if (t + 1 < N) acc += x[(t + 1) * XS] * u.y;
    if (t + 2 < N) acc += x[(t + 2) * XS] * u.z;
    if (t + 3 < N) acc += x[(t + 3) * XS] * u.w;
  }
  return acc;
}
template <int N>
__device__ __forceinline__ void load_row(float* out, const float* x) {
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const float4 v = ld4(x + t);
    out[t] = v.x;
    if (t + 1 < N) out[t + 1] = v.y;
    if (t + 2 < N) out[t + 2] = v.z;
    if (t + 3 < N) out[t + 3] = v.w;
  }
}

// block-shared constants of the factor and vector passes, padded: G with
// zero rows (m < MP) and zero columns, R with an identity block on the
// padded inputs, Q with zeros
template <int MP>
struct __align__(16) PassConsts {
  float GT[NU * MP];   // G': row j is input j's column of G
  float G[MP * NU];    // G's rows
  float R[NU * NU];
  float Q[NX * NX];
  int tri[NL];         // entry e of a packed lower triangle -> 16 i + j
};

template <int MP>
__device__ void load_pass_consts(PassConsts<MP>& c, const float* G,
                                 const float* R, const float* Q,
                                 const Dims& d) {
  for (int e = threadIdx.x; e < NU * MP; e += blockDim.x) {
    const int j = e / MP, r = e % MP;
    const float v = (j < d.nu && r < d.m) ? G[r * d.nu + j] : 0.f;
    c.GT[e] = v;
    c.G[r * NU + j] = v;
  }
  if (R)
    for (int e = threadIdx.x; e < NU * NU; e += blockDim.x) {
      const int i = e / NU, j = e % NU;
      c.R[e] = (i < d.nu && j < d.nu) ? R[i * d.nu + j] : (i == j ? 1.f : 0.f);
    }
  if (Q)
    for (int e = threadIdx.x; e < NX * NX; e += blockDim.x) {
      const int i = e / NX, j = e % NX;
      c.Q[e] = (i < d.nx && j < d.nx) ? Q[i * d.nx + j] : 0.f;
    }
  if (threadIdx.x < NL) {
    const int e = threadIdx.x;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    c.tri[e] = 16 * i + (e - i * (i + 1) / 2);
  }
  __syncthreads();
}

// One sweep of a warp over the horizon, forward or backward: request(k,
// slot) stages knot k's inputs by cp.async; knot k + 1 (k - 1) is
// requested into the other slot of the ring before the warp starts on
// knot k.  The first __syncwarp of a step orders the previous step's
// shared-memory work before the slot it read is staged again.
template <class Request, class Body>
__device__ __forceinline__ void sweep(int H, bool fwd, float* ring, int slot,
                                      Request request, Body body) {
  auto knot = [&](int step) { return fwd ? step : H - 1 - step; };
  __syncwarp();
  request(knot(0), ring);
  cp_commit();
  for (int step = 0; step < H; ++step) {
    __syncwarp();
    if (step + 1 < H) {
      request(knot(step + 1), ring + ((step + 1) & 1) * slot);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    body(knot(step), ring + (step & 1) * slot);
  }
}

// ---------------------------------------------------------------------------
// Riccati factor pass
// ---------------------------------------------------------------------------

template <int MP>
struct FactorSlot {    // one knot's inputs, staged transposed
  float At[NX * RS];   // A_k': At[i * RS + t] = A_k[t][i]
  float Bt[NU * RS];   // B_k': Bt[j * RS + i] = B_k[i][j]
  float w[MP];         // W_k, zeros past m
};
struct FactorWork {
  float Pn[NX * RS];   // P before its symmetrisation (Q at the last knot)
  float BtP[NU * RS];  // B' P
  float AtP[NX * RS];  // A' P
  float M[NU * NU];    // M's lower triangle (rows of 12), then L
  float Kt[NX * NU];   // K' (rows of 12)
  float BtPAt[NX * NU];  // (B'PA)' (rows of 12)
  float dinv[16];
};
template <int MP>
__host__ __device__ constexpr int factor_slot() {
  return (int)(sizeof(FactorSlot<MP>) / 4);
}
template <int MP>
__host__ __device__ constexpr int factor_warp_floats() {
  return 2 * factor_slot<MP>() + (int)(sizeof(FactorWork) / 4);
}

template <int MP>
__global__ void __launch_bounds__(WARPS * 32, 4)
    factor_kernel(const float* G, const float* R, const float* Q,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ W, float* __restrict__ L,
                  float* __restrict__ dinv, float* __restrict__ K, Dims d) {
  __shared__ PassConsts<MP> c;
  extern __shared__ __align__(16) float dsm[];
  load_pass_consts(c, G, R, Q, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;   // whole warps only: no block barrier below
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  constexpr int SLOT = factor_slot<MP>();
  float* ring = dsm + warp * factor_warp_floats<MP>();
  FactorWork& S = *reinterpret_cast<FactorWork*>(ring + 2 * SLOT);
  const size_t bH = (size_t)b * H;
  const float nan = __int_as_float(0x7fc00000);
  // lanes of the 13-wide products: column `col` of the right-hand operand,
  // `half` of the rows
  const int col = lane & 15, half = lane >> 4;
  const bool colok = col < NX;

  for (int e = lane; e < 2 * SLOT; e += 32) ring[e] = 0.f;
  for (int e = lane; e < NX * NX; e += 32)
    S.Pn[(e / NX) * RS + e % NX] = c.Q[e];
  bool bad = false;   // uniform: a NaN factor poisons every earlier knot
  bool last = true;   // at the last knot P is Q as it is, unsymmetrised

  auto request = [&](int k, float* slot) {
    FactorSlot<MP>& X = *reinterpret_cast<FactorSlot<MP>*>(slot);
    const size_t kk = bH + k;
    const int ln = opaque(lane);   // offsets anew each knot, not held
    stage_mat<NX, NX, RS, true>(X.At, A + kk * nx * nx, nx, nx, ln);
    stage_mat<NX, NU, RS, true>(X.Bt, Bm + kk * nx * nu, nx, nu, ln);
    stage_vec(X.w, W + kk * m, m, ln);
  };

  auto body = [&](int k, const float* slot) {
    const FactorSlot<MP>& X = *reinterpret_cast<const FactorSlot<MP>*>(slot);
    // B'P and A'P: a lane holds column `col` of P (symmetrised as it is
    // read), its half of the rows
    if (colok) {
      float pc[NX];
#pragma unroll
      for (int t = 0; t < NX; ++t) {
        const float a = S.Pn[t * RS + col];
        pc[t] = (last || t == col) ? a : 0.5f * (a + S.Pn[col * RS + t]);
      }
#pragma unroll 1
      for (int jj = 0; jj < 6; ++jj) {
        const int j = half * 6 + jj;
        S.BtP[j * RS + col] = dot_sr<NX>(X.Bt + j * RS, pc, 0.f);
      }
#pragma unroll 1
      for (int ii = 0; ii < 7; ++ii) {
        const int i = half * 7 + ii;
        if (i < NX) S.AtP[i * RS + col] = dot_sr<NX>(X.At + i * RS, pc, 0.f);
      }
    }
    last = false;
    __syncwarp();
    // B'PA: a lane holds column `col` of A and forms its half of the rows,
    // stored as rows of (B'PA)' for the K solve and the P update
    if (colok) {
      float ac[NX];
      load_row<NX>(ac, X.At + col * RS);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj)
        S.BtPAt[col * NU + half * 6 + jj] =
            dot_sr<NX>(S.BtP + (half * 6 + jj) * RS, ac, 0.f);
    }
    // the lower triangle of M = R + G' diag(w) G + B'P B, one entry a lane;
    // the Gram in the plain version's order, (G_ri w_r) G_rj over r.  The
    // fence every 8 rows bounds the float4s in flight: with all of them
    // hoisted, the kernel spilled at its 128 registers.
#pragma unroll 1
    for (int e = lane; e < NL; e += 32) {
      const int ij = c.tri[e], i = ij >> 4, j = ij & 15;
      float acc = c.R[i * NU + j];
#pragma unroll
      for (int r = 0; r < MP; r += 4) {
        if (r % 8 == 0) reg_fence();
        const float4 gi = ld4(c.GT + i * MP + r), wr = ld4(X.w + r),
                     gj = ld4(c.GT + j * MP + r);
        acc += (gi.x * wr.x) * gj.x;
        acc += (gi.y * wr.y) * gj.y;
        acc += (gi.z * wr.z) * gj.z;
        acc += (gi.w * wr.w) * gj.w;
      }
      S.M[i * NU + j] = dot_ss<NX>(S.BtP + i * RS, X.Bt + j * RS, acc);
    }
    __syncwarp();
    // Cholesky of M, right-looking, lane i holding row i; the pivot and
    // the column below it reach the other lanes by shuffles.  A column's
    // chain is the pivot's shuffle, rsqrt, the scale and one FMA: the next
    // pivot, fma(-l, l, a[j + 1]) on lane j + 1, is shuffled before the
    // rest of the column's update.  L_jj = piv rsqrt(piv) and dinv_j =
    // rsqrt(piv) (sqrtf and an IEEE division cost 20% of the kernel at
    // B = 256, PERF.md); the update also runs above the diagonal, which
    // the store masks.
    const int row = lane < NU ? lane : 0;
    float rw[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float v = S.M[row * NU + j];
      rw[j] = (lane < NU && j <= lane) ? v : 0.f;
    }
    float mydi = 0.f;
    float piv = __shfl_sync(FULL, rw[0], 0);   // column 0's pivot
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float di = rsqrtf(piv);
      bad |= !(piv > 0.f);
      if (lane == j) mydi = di;
      const float l = rw[j] * di;   // lane > j: L_rj; lane j: L_jj
      rw[j] = l;
      const float lu = lane > j ? l : 0.f;   // the rows below j update
      if (j + 1 < NU)   // the next pivot, ahead of the rest of the column
        piv = __shfl_sync(FULL, fmaf(-l, l, rw[j + 1]), j + 1);
#pragma unroll
      for (int cc = j + 1; cc < NU; ++cc)
        rw[cc] = fmaf(-lu, __shfl_sync(FULL, lu, cc), rw[cc]);
    }
    if (lane < NU) {   // L's row in place of M's, which only this lane read
#pragma unroll
      for (int j = 0; j < NU; ++j)
        S.M[lane * NU + j] = j <= lane ? rw[j] : 0.f;
      S.dinv[lane] = mydi;
      if (lane < nu) dinv[(bH + k) * nu + lane] = bad ? nan : mydi;
    }
    __syncwarp();
    // L to device memory, coalesced; zeros above the diagonal
    float* Lk = L + (bH + k) * nu * nu;
    if (nu == NU) {
#pragma unroll
      for (int t = 0; t < (NU * NU + 31) / 32; ++t) {
        const int e = t * 32 + lane;
        if (e < NU * NU) Lk[e] = bad ? nan : S.M[e];
      }
    } else {
      for (int e = lane; e < nu * nu; e += 32)
        Lk[e] = bad ? nan : S.M[(e / nu) * NU + e % nu];
    }
    // K = M^-1 B'PA, its 13 columns at once (lane = column): 12 forward
    // and 12 backward steps, in registers
    if (lane < NX) {
      float kc[NU];
      load_row<NU>(kc, S.BtPAt + lane * NU);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        reg_fence();
        kc[i] *= S.dinv[i];
#pragma unroll
        for (int r = i + 1; r < NU; ++r) kc[r] -= S.M[r * NU + i] * kc[i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        reg_fence();
        kc[i] *= S.dinv[i];
#pragma unroll
        for (int t = 0; t < i; ++t) kc[t] -= S.M[i * NU + t] * kc[i];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) S.Kt[lane * NU + j] = kc[j];
      if (lane < nx) {
        float* Kk = K + (bH + k) * nu * nx + lane;
#pragma unroll
        for (int j = 0; j < NU; ++j)
          if (j < nu) Kk[j * nx] = bad ? nan : kc[j];
      }
    }
    __syncwarp();
    // P <- Q + A'P A - K' B'PA, a lane's column `col`, its half of the rows
    // (symmetrised as the next knot reads it)
    if (colok) {
      float ac[NX], bc[NU];
      load_row<NX>(ac, X.At + col * RS);
      load_row<NU>(bc, S.BtPAt + col * NU);
#pragma unroll 1
      for (int ii = 0; ii < 7; ++ii) {
        const int i = half * 7 + ii;
        if (i < NX) {
          float acc = dot_sr<NX>(S.AtP + i * RS, ac, c.Q[i * NX + col]);
          const float* kt = S.Kt + i * NU;
#pragma unroll
          for (int j = 0; j < NU; j += 4) {
            const float4 v = ld4(kt + j);
            acc -= v.x * bc[j];
            acc -= v.y * bc[j + 1];
            acc -= v.z * bc[j + 2];
            acc -= v.w * bc[j + 3];
          }
          S.Pn[i * RS + col] = acc;
        }
      }
    }
  };

  sweep(H, false, ring, SLOT, request, body);
}

// ---------------------------------------------------------------------------
// vector (affine LQR) pass against the stored factors
// ---------------------------------------------------------------------------

template <int MP>
struct VectorSlot {     // one knot's inputs in their own layouts, padded
  float A[NX * NX + 3];  // A_k (rows of 13)
  float Bm[NX * NU];     // B_k (rows of 12)
  float L[NU * NU];      // L_k (backward)
  float K[NU * NX];      // K_k (rows of 13)
  float dinv[NU], rx[NU];  // (backward)
  float vm[MP];            // (backward)
};
struct VectorWork {
  float v[2][16];   // sv (backward) or dx (forward), one buffer a knot
  float g[16];      // the knot's g (backward) or du (forward)
};
template <int MP>
__host__ __device__ constexpr int vector_slot() {
  return (int)(sizeof(VectorSlot<MP>) / 4);
}
template <int MP>
__host__ __device__ int vector_warp_floats(int H) {   // ring, work, kff
  return 2 * vector_slot<MP>() + (int)(sizeof(VectorWork) / 4) + H * NU;
}

template <int MP>
__global__ void __launch_bounds__(WARPS * 32, 4)
    vector_kernel(const float* G, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ L,
                  const float* __restrict__ dinv, const float* __restrict__ K,
                  const float* __restrict__ rx, const float* __restrict__ vm,
                  float* __restrict__ du, float* __restrict__ gdu, Dims d) {
  __shared__ PassConsts<MP> c;
  extern __shared__ __align__(16) float dsm[];
  load_pass_consts(c, G, nullptr, nullptr, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  constexpr int SLOT = vector_slot<MP>();
  float* ring = dsm + (size_t)warp * vector_warp_floats<MP>(H);
  VectorWork& S = *reinterpret_cast<VectorWork*>(ring + 2 * SLOT);
  float* kff = ring + 2 * SLOT + sizeof(VectorWork) / 4;   // (H, 12)
  const size_t bH = (size_t)b * H;

  for (int e = lane; e < 2 * SLOT; e += 32) ring[e] = 0.f;
  if (lane < 16) S.v[0][lane] = 0.f;
  int p = 0;   // S.v[p] holds this knot's sv (dx); S.v[p ^ 1] gets the next

  auto stage_ab = [&](VectorSlot<MP>& X, size_t kk) {
    stage_mat<NX, NX, NX, false>(X.A, A + kk * nx * nx, nx, nx, lane);
    stage_mat<NX, NU, NU, false>(X.Bm, Bm + kk * nx * nu, nx, nu, lane);
    stage_mat<NU, NX, NX, false>(X.K, K + kk * nu * nx, nu, nx, lane);
  };

  // backward: g = rx_k + G' vm_k + B_k' sv, kff_k = M_k^-1 g (kept in
  // shared memory for the forward sweep), sv <- A_k' sv - K_k' g.  The
  // padded inputs' g is 0, so their kff is 0 too.
  sweep(H, false, ring, SLOT, [&](int k, float* slot) {
    VectorSlot<MP>& X = *reinterpret_cast<VectorSlot<MP>*>(slot);
    const size_t kk = bH + k;
    stage_ab(X, kk);
    stage_mat<NU, NU, NU, false>(X.L, L + kk * nu * nu, nu, nu, lane);
    stage_vec(X.dinv, dinv + kk * nu, nu, lane);
    stage_vec(X.rx, rx + kk * nu, nu, lane);
    stage_vec(X.vm, vm + kk * m, m, lane);
  }, [&](int k, const float* slot) {
    const VectorSlot<MP>& X = *reinterpret_cast<const VectorSlot<MP>*>(slot);
    const float* sv = S.v[p];
    float g = 0.f;
    if (lane < NU) {
      g = dot_ss<MP>(c.GT + lane * MP, X.vm, X.rx[lane]);
      g = dot_cs<NX, NU>(X.Bm + lane, sv, g);
      S.g[lane] = g;
    }
    __syncwarp();
    if (lane < NX) {
      float s = dot_cs<NX, NX>(X.A + lane, sv, 0.f);
#pragma unroll
      for (int j = 0; j < NU; ++j) s -= X.K[j * NX + lane] * S.g[j];
      S.v[p ^ 1][lane] = s;
    }
    // (L L') kff = g: a lane holds row `lane` and column `lane` of L, so
    // each of the 2 x 12 steps is one shuffle and one FMA
    const int r = lane < NU ? lane : 0;
    float lrow[NU], lcol[NU];
    load_row<NU>(lrow, X.L + r * NU);
#pragma unroll
    for (int t = 0; t < NU; ++t) lcol[t] = X.L[t * NU + r];
    const float di = X.dinv[r];
    float v = g;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const float y = __shfl_sync(FULL, v * di, i);
      if (lane == i) v = y;
      else if (lane > i) v -= lrow[i] * y;
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
      const float x = __shfl_sync(FULL, v * di, i);
      if (lane == i) v = x;
      else if (lane < i) v -= lcol[i] * x;
    }
    if (lane < NU) kff[k * NU + lane] = v;   // read by this lane only
    p ^= 1;
  });

  // forward: du_k = -K_k dx - kff_k, gdu_k = G du_k, dx <- A_k dx + B_k du_k
  if (lane < 16) S.v[p][lane] = 0.f;
  sweep(H, true, ring, SLOT, [&](int k, float* slot) {
    stage_ab(*reinterpret_cast<VectorSlot<MP>*>(slot), bH + k);
  }, [&](int k, const float* slot) {
    const VectorSlot<MP>& X = *reinterpret_cast<const VectorSlot<MP>*>(slot);
    const float* dx = S.v[p];
    if (lane < NU) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += X.K[lane * NX + i] * dx[i];
      const float dv = -acc - kff[k * NU + lane];
      S.g[lane] = dv;
      if (lane < nu) du[(bH + k) * nu + lane] = dv;
    }
    __syncwarp();
    if (lane < m)
      gdu[(bH + k) * m + lane] = dot_ss<NU>(c.G + lane * NU, S.g, 0.f);
    if (lane < NX) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NX; ++i) s += X.A[lane * NX + i] * dx[i];
      S.v[p ^ 1][lane] = dot_ss<NU>(X.Bm + lane * NU, S.g, s);
    }
    p ^= 1;
  });
}

bool bad_dims(const Dims& d) {
  return d.B < 1 || d.H < 1 || d.nx < 1 || d.nx > NX_MAX || d.nu < 1 ||
         d.nu > NU_MAX || d.m < 1 || d.m > M_MAX;
}

int blocks(const Dims& d) { return (d.B + WARPS - 1) / WARPS; }

// the largest H of the rollout's x history and the vector pass's kff
constexpr int H_MAX = (int)(DYN_MAX / (WARPS * NX_MAX * sizeof(float)));

template <int MP>
int launch_factor(const float* G, const float* R, const float* Q,
                  const float* A, const float* Bm, const float* W, float* L,
                  float* dinv, float* K, const Dims& d, cudaStream_t stream) {
  const size_t dyn = (size_t)WARPS * factor_warp_floats<MP>() * sizeof(float);
  factor_kernel<MP><<<blocks(d), WARPS * 32, dyn, stream>>>(
      G, R, Q, A, Bm, W, L, dinv, K, d);
  return (int)cudaGetLastError();
}

template <int MP>
int launch_vector(const float* G, const float* A, const float* Bm,
                  const float* L, const float* dinv, const float* K,
                  const float* rx, const float* vm, float* du, float* gdu,
                  const Dims& d, cudaStream_t stream) {
  const size_t dyn = (size_t)WARPS * vector_warp_floats<MP>(d.H) *
                     sizeof(float);
  if (dyn > 32 * 1024) {   // a long horizon's kff: above the default 48 KB
    const int err = (int)cudaFuncSetAttribute(
        vector_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != 0) return err;
  }
  vector_kernel<MP><<<blocks(d), WARPS * 32, dyn, stream>>>(
      G, A, Bm, L, dinv, K, rx, vm, du, gdu, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dimension limits compiled into the kernels; the wrappers raise above them.
void fused_riccati_limits(int* nx_max, int* nu_max, int* m_max, int* h_max) {
  *nx_max = NX_MAX;
  *nu_max = NU_MAX;
  *m_max = M_MAX;
  *h_max = H_MAX;
}

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
int fused_rollout_launch(const float* G, const float* R, const float* Q,
                         const float* A, const float* Bm, const float* q,
                         const float* u, const float* zm, const float* x0,
                         float* x, float* rx, float* gu, int B, int H, int nx,
                         int nu, int m, void* stream) {
  const Dims d{B, H, nx, nu, m};
  const size_t dyn = (size_t)WARPS * H * nx * sizeof(float);
  if (bad_dims(d) || dyn > DYN_MAX) return (int)cudaErrorInvalidValue;
  rollout_kernel<<<blocks(d), WARPS * 32, dyn, (cudaStream_t)stream>>>(
      G, R, Q, A, Bm, q, u, zm, x0, x, rx, gu, d);
  return (int)cudaGetLastError();
}

int fused_factor_launch(const float* G, const float* R, const float* Q,
                        const float* A, const float* Bm, const float* W,
                        float* L, float* dinv, float* K, int B, int H, int nx,
                        int nu, int m, void* stream) {
  const Dims d{B, H, nx, nu, m};
  if (bad_dims(d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return m <= 24 ? launch_factor<24>(G, R, Q, A, Bm, W, L, dinv, K, d, s)
                 : launch_factor<32>(G, R, Q, A, Bm, W, L, dinv, K, d, s);
}

int fused_vector_launch(const float* G, const float* A, const float* Bm,
                        const float* L, const float* dinv, const float* K,
                        const float* rx, const float* vm, float* du,
                        float* gdu, int B, int H, int nx, int nu, int m,
                        void* stream) {
  const Dims d{B, H, nx, nu, m};
  if (bad_dims(d) || H > H_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return m <= 24
             ? launch_vector<24>(G, A, Bm, L, dinv, K, rx, vm, du, gdu, d, s)
             : launch_vector<32>(G, A, Bm, L, dinv, K, rx, vm, du, gdu, d, s);
}

}  // extern "C"
