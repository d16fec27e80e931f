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
// loop inside the warp (the TPU's sequential fori_loop).  The factor and
// vector passes follow the resident kernel (resident_ipm.cu, whose
// per-knot algebra they repeat in their own copy), and the rollout the
// factor and vector passes:
//  - Compile-time widths: 13 states, 12 inputs, 24 or 32 constraint rows
//    (two instances).  A smaller problem is padded as it is staged: zero
//    rows and columns of A, B, Q, G and W (and zero u, zm, q, rx, vm), an
//    identity block of R, so M is diag(M, I), L diag(L, I), 1 / diag(L) 1
//    and K 0 on the padding, the padded x, rx and gu are 0, and only the
//    real block is written out.  Every index of the products is a
//    constant and the 13-wide products unroll.
//  - Staging (factor and vector): a sweep over the horizon stages knot
//    k -+ 1's inputs into a two-slot shared-memory ring a warp by 4-byte
//    cp.async (a knot's A_k is 676 bytes, so its arrays start on 4-byte
//    boundaries only) while the warp works on knot k.  The factor pass
//    stages A_k and B_k transposed, rows of 16, so that its products read
//    them as float4s.
//  - Staging (rollout): knot k -+ 2's inputs are loaded into registers
//    (coalesced, lanes over entries) as the warp starts on knot k, and
//    stored into the two-slot ring when it is done with knot k + 1, in the
//    arrays' own layouts.  With its two-accumulator products, this takes
//    10% less time at B = 2048 and 11% less at B = 256 than a build with
//    the 4-byte cp.async ring and one accumulator (fused_turns.py against
//    that build; a ring of 4-8 knots was slower still); PERF.md section 6.
//  - The rollout's chains: forward, lane i holds row i of A_k in registers
//    and x_k on every lane (13 shuffles of x_{k+1} end a knot), so a knot's
//    chain is the shuffles and 13 FMAs in two accumulators; B_k u_k,
//    gu_k = G u_k and the costate's bracket Q x_{k+1} + q_k (Q's row in
//    registers, from the same shuffled values) are off it, the bracket
//    kept on chip (H x 13 floats a warp) for the backward sweep.
//    Backward, lam_k = bracket + carry reaches every lane by 13 shuffles;
//    lane j reads column j of A_k and of B_k and forms the carry
//    (A_k' lam_k)_j and rx_k's B_k' lam_k from those values; R u_k +
//    G' zm_k is off the chain.  A_k and B_k are read from device memory in
//    both sweeps: kept on chip from one sweep to the other (26 KB a
//    scenario at H = 20) they would fit 8 scenarios an SM, two waves at
//    B = 2048, each as long as one warp's chain alone (the rollout's time
//    at B = 256), which is longer than the whole two-read kernel.
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
//  - bf16 storage of A and B (SolverConfig.stage_bf16; the TPU kernels
//    widen bf16 A/B on load, pallas_riccati.py:144-159, 193-194, 247-267):
//    each kernel has an instance for __nv_bfloat16 A and B, the rest
//    float32.  In device memory each knot's A_k and B_k start on 16 bytes
//    (their nx nx and nx nu elements padded to a multiple of 8, which the
//    wrapper lays out; at nx = 13 an unpadded A_k would start on 2 bytes
//    at every odd k, which no cp.async takes).  The factor and vector
//    passes stage both by 16-byte cp.async into a bf16 area of the slot,
//    in the same group as the knot's other inputs, and after the wait
//    widen them (the factor transposing, as its float32 staging does) into
//    the slot's float32 frames in one warp pass; the rollout loads a
//    knot's bf16 pairs into registers as 32-bit words (half the loads of
//    its float32 instance) and widens them as it stores the knot into its
//    slot.  Every product then reads float32, as in the float32 instances.
//
// What bounds them on the H100: each pass moves 70-120 MB at B = 2048,
// H = 20 (20-35 us at 3.35 TB/s, which sets their bound: the operations
// take less; the rollout reads A_k and B_k, 53 MB, in both sweeps, 123 MB
// in all where its bound counts 69), but runs H dependent knots, each a
// chain of dependent shuffles and FMAs, so the latency of that chain, and
// at one wave (15.5 warps an SM) the issue slots the SM's warps share, set
// their time.  PERF.md has their times against the bound (chip_smoke.py,
// fused_turns.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int NX_MAX = 13;
constexpr int NU_MAX = 12;
constexpr int M_MAX = 32;
constexpr int WARPS = 4;    // scenarios per block
// the per-knot history the rollout (13 floats) and the vector pass (kff,
// 12) keep on chip sets their horizon limit, H_MAX = 177 knots
constexpr size_t DYN_MAX = 36 * 1024;

struct Dims {
  int B, H, nx, nu, m;
};

// ---------------------------------------------------------------------------
// the three passes: compile-time widths, knots staged by cp.async
// ---------------------------------------------------------------------------

constexpr int NX = NX_MAX;   // states and inputs of the kernels; smaller
constexpr int NU = NU_MAX;   // problems are padded as staged
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
// 16 bytes likewise (L2 only): a bf16 knot's A_k and B_k, 16-byte aligned
__device__ __forceinline__ void cp16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int j = 0; j < 4; ++j)
    static_cast<float*>(dst)[j] = static_cast<const float*>(src)[j];
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

// ---- bf16 storage of A and B -----------------------------------------------
// knot kk's r x c bf16 matrix in device memory: knots start on 16 bytes,
// their r c elements padded to a multiple of 8
__device__ __forceinline__ const __nv_bfloat16* bf16_knot(
    const __nv_bfloat16* base, size_t kk, int r, int c) {
  return base + kk * (size_t)((r * c + 7) & ~7);
}
// the bf16 area a slot carries for its knot's A_k and B_k: A at element 0,
// B at AB_B, each at most the padded 13 x 13 and 13 x 12
constexpr int AB_B = 176, AB_ELEMS = 336;
template <class T>
__host__ __device__ constexpr int ab_floats() {
  return std::is_same<T, float>::value ? 0 : AB_ELEMS / 2;
}
// stage knot kk's bf16 A_k and B_k whole into the area, lanes over their
// 16-byte pieces (at most 22 and 20)
__device__ __forceinline__ void stage_ab16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* A,
                                           const __nv_bfloat16* Bm, size_t kk,
                                           int nx, int nu, int lane) {
  const int na = (nx * nx + 7) / 8, nb = (nx * nu + 7) / 8;
  if (lane < na) cp16(dst + 8 * lane, bf16_knot(A, kk, nx, nx) + 8 * lane);
  if (lane < nb)
    cp16(dst + AB_B + 8 * lane, bf16_knot(Bm, kk, nx, nu) + 8 * lane);
}
// widen the staged rows x cols bf16 matrix at src into dst as stage_mat
// places a float32 one (transposed for TR); entries outside rows x cols
// are not written
template <int R, int C, int DS, bool TR>
__device__ __forceinline__ void widen_mat(float* dst, const __nv_bfloat16* src,
                                          int rows, int cols, int lane) {
  if (rows == R && cols == C) {   // the production widths: no division
#pragma unroll
    for (int t = 0; t < (R * C + 31) / 32; ++t) {
      const int e = t * 32 + lane;
      if (e < R * C) {
        const int i = e / C, j = e % C;
        dst[TR ? j * DS + i : i * DS + j] = __bfloat162float(src[e]);
      }
    }
  } else {
    for (int e = lane; e < rows * cols; e += 32) {
      const int i = e / cols, j = e % cols;
      dst[TR ? j * DS + i : i * DS + j] = __bfloat162float(src[e]);
    }
  }
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
// sum over t < N of x[t] y[t] in two accumulators, even and odd t, added at
// the end: half the dependent chain of dot_ss (x, y as dot_ss's)
template <int N>
__device__ __forceinline__ float dot2_ss(const float* x, const float* y) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int t = 0; t < N; t += 4) {
    const float4 v = ld4(x + t), u = ld4(y + t);
    a0 = fmaf(v.x, u.x, a0);
    a1 = fmaf(v.y, u.y, a1);
    a0 = fmaf(v.z, u.z, a0);
    a1 = fmaf(v.w, u.w, a1);
  }
  return a0 + a1;
}
// the same for x and y in registers
template <int N>
__device__ __forceinline__ float dot2_rr(const float* x, const float* y) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t % 2) a1 = fmaf(x[t], y[t], a1);
    else a0 = fmaf(x[t], y[t], a0);
  }
  return a0 + a1;
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

// block-shared constants of the passes, padded: G with
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
// shared-memory work before the slot it read is staged again.  land(slot),
// where given, runs on a knot's slot once it has arrived, before body
// (the bf16 instances' widening).
struct NoLand {
  __device__ void operator()(float*) const {}
};
template <class Request, class Body, class Land = NoLand>
__device__ __forceinline__ void sweep(int H, bool fwd, float* ring, int slot,
                                      Request request, Body body,
                                      Land land = Land()) {
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
    if constexpr (!std::is_same<Land, NoLand>::value) {
      land(ring + (step & 1) * slot);
      __syncwarp();
    }
    body(knot(step), ring + (step & 1) * slot);
  }
}

// ---------------------------------------------------------------------------
// rollout + adjoint + stationarity pieces
// ---------------------------------------------------------------------------

template <int MP>
struct RolloutSlot {       // one knot's inputs, padded with zeros
  float A[NX * NX + 3];    // A_k, rows of 13
  float Bm[NX * NU];       // B_k, rows of 12
  float u[16];             // u_k
  float v[MP];             // q_k (forward) or zm_k (backward)
};
template <int MP>
__host__ __device__ constexpr int rollout_slot() {
  return (int)(sizeof(RolloutSlot<MP>) / 4);
}
template <int MP>
__host__ __device__ int rollout_warp_floats(int H) {   // ring, history
  return 2 * rollout_slot<MP>() + ((H * NX + 3) & ~3);
}

// One knot's inputs on their way from device memory, in registers: lane l
// holds entries 32 t + l of A_k (169 floats at most) and B_k (156), entry
// l of u_k and of q_k or zm_k; zeros past the problem's sizes.
struct KnotRegs {
  float a[(NX * NX + 31) / 32], b[(NX * NU + 31) / 32], u, v;
};

// Load knot k's inputs (coalesced, 128 bytes an instruction), to be
// stored into a slot once the warp is done with the knot before.
__device__ __forceinline__ void load_knot(KnotRegs& g, const float* A,
                                          const float* Bm, const float* u,
                                          const float* v, int nx, int nu,
                                          int nv, int lane) {
#pragma unroll
  for (int t = 0; t < (NX * NX + 31) / 32; ++t) {
    const int e = 32 * t + lane;
    g.a[t] = e < nx * nx ? A[e] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < (NX * NU + 31) / 32; ++t) {
    const int e = 32 * t + lane;
    g.b[t] = e < nx * nu ? Bm[e] : 0.f;
  }
  g.u = lane < nu ? u[lane] : 0.f;
  g.v = lane < nv ? v[lane] : 0.f;
}

// The same for bf16 A_k and B_k, kept as they come: lane l holds the
// 32-bit words w = 32 t + l (entries 2 w and 2 w + 1), widened as they are
// stored.  A knot's block starts on 16 bytes and its pad is zeros, so each
// word is aligned and the last one's second half is 0.
struct KnotRegs16 {
  unsigned a[(NX * NX + 63) / 64], b[(NX * NU + 63) / 64];
  float u, v;
};
__device__ __forceinline__ void load_knot(KnotRegs16& g,
                                          const __nv_bfloat16* A,
                                          const __nv_bfloat16* Bm,
                                          const float* u, const float* v,
                                          int nx, int nu, int nv, int lane) {
  const unsigned* a = reinterpret_cast<const unsigned*>(A);
  const unsigned* b = reinterpret_cast<const unsigned*>(Bm);
#pragma unroll
  for (int t = 0; t < (NX * NX + 63) / 64; ++t) {
    const int w = 32 * t + lane;
    g.a[t] = w < (nx * nx + 1) / 2 ? a[w] : 0u;
  }
#pragma unroll
  for (int t = 0; t < (NX * NU + 63) / 64; ++t) {
    const int w = 32 * t + lane;
    g.b[t] = w < (nx * nu + 1) / 2 ? b[w] : 0u;
  }
  g.u = lane < nu ? u[lane] : 0.f;
  g.v = lane < nv ? v[lane] : 0.f;
}

// Store them in the slot's padded layout; entries past the problem's
// sizes are never written (the zeros the ring starts with stay).
template <int MP>
__device__ __forceinline__ void store_knot(RolloutSlot<MP>& X,
                                           const KnotRegs& g, int nx, int nu,
                                           int lane) {
  if (nx == NX && nu == NU) {   // the production widths: no division
#pragma unroll
    for (int t = 0; t < (NX * NX + 31) / 32; ++t) {
      const int e = 32 * t + lane;
      if (e < NX * NX) X.A[e] = g.a[t];
    }
#pragma unroll
    for (int t = 0; t < (NX * NU + 31) / 32; ++t) {
      const int e = 32 * t + lane;
      if (e < NX * NU) X.Bm[e] = g.b[t];
    }
  } else {
#pragma unroll
    for (int t = 0; t < (NX * NX + 31) / 32; ++t) {
      const int e = 32 * t + lane;
      if (e < nx * nx) X.A[(e / nx) * NX + e % nx] = g.a[t];
    }
#pragma unroll
    for (int t = 0; t < (NX * NU + 31) / 32; ++t) {
      const int e = 32 * t + lane;
      if (e < nx * nu) X.Bm[(e / nu) * NU + e % nu] = g.b[t];
    }
  }
  if (lane < 16) X.u[lane] = g.u;
  if (lane < MP) X.v[lane] = g.v;
}
// the same from bf16 words: entry 2 w is the low half of word w
template <int MP>
__device__ __forceinline__ void store_knot(RolloutSlot<MP>& X,
                                           const KnotRegs16& g, int nx,
                                           int nu, int lane) {
  auto put = [&](float* M, int ld, int rows, int cols, unsigned wd, int e) {
    const float v[2] = {__uint_as_float(wd << 16),
                        __uint_as_float(wd & 0xffff0000u)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = e + h;
      if (f < rows * cols) {
        if (cols == ld) M[f] = v[h];   // the production widths
        else M[(f / cols) * ld + f % cols] = v[h];
      }
    }
  };
  const bool full = nx == NX && nu == NU;
#pragma unroll
  for (int t = 0; t < (NX * NX + 63) / 64; ++t)
    put(X.A, NX, full ? NX : nx, full ? NX : nx, g.a[t], 2 * (32 * t + lane));
#pragma unroll
  for (int t = 0; t < (NX * NU + 63) / 64; ++t)
    put(X.Bm, NU, full ? NX : nx, full ? NU : nu, g.b[t],
        2 * (32 * t + lane));
  if (lane < 16) X.u[lane] = g.u;
  if (lane < MP) X.v[lane] = g.v;
}

// One sweep of the rollout over the horizon, forward or backward: knot
// k + 2's inputs (k - 2's) are loaded into registers as the warp starts on
// knot k, and knot k + 1's, loaded a knot earlier, are stored into the
// other slot of the ring when it is done with knot k: two knots' bodies
// cover a load's latency.  The register sets alternate, so the loop is
// unrolled by two.
template <int MP, class Regs, class Load, class Body>
__device__ __forceinline__ void sweep_regs(int H, bool fwd, float* ring,
                                           int nx, int nu, int lane,
                                           Load load, Body body) {
  constexpr int SLOT = rollout_slot<MP>();
  auto knot = [&](int step) { return fwd ? step : H - 1 - step; };
  Regs g[2];
  load(g[0], knot(0));
  if (H > 1) load(g[1], knot(1));
  __syncwarp();   // the ring's zeros, and the last sweep's reads, before
  store_knot(*reinterpret_cast<RolloutSlot<MP>*>(ring), g[0], nx, nu, lane);
  for (int step = 0; step < H; step += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // g[h] held this knot, slot h has it
      const int s = step + h;
      if (s < H) {
        if (s + 2 < H) load(g[h], knot(s + 2));
        __syncwarp();
        body(knot(s), ring + h * SLOT);
        if (s + 1 < H)
          store_knot(*reinterpret_cast<RolloutSlot<MP>*>(ring +
                                                         (1 - h) * SLOT),
                     g[1 - h], nx, nu, lane);
      }
    }
  }
}

template <int MP, class T>
__global__ void __launch_bounds__(WARPS * 32, 4)
    rollout_kernel(const float* G, const float* R, const float* Q,
                   const T* __restrict__ A, const T* __restrict__ Bm,
                   const float* __restrict__ q, const float* __restrict__ u,
                   const float* __restrict__ zm, const float* __restrict__ x0,
                   float* __restrict__ x, float* __restrict__ rx,
                   float* __restrict__ gu, Dims d) {
  __shared__ PassConsts<MP> c;
  extern __shared__ __align__(16) float dsm[];
  load_pass_consts(c, G, R, Q, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;   // whole warps only: no block barrier below
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  constexpr int SLOT = rollout_slot<MP>();
  float* ring = dsm + (size_t)warp * rollout_warp_floats<MP>(H);
  // (H, 13): Q x_{k+1} + q_k, entry i written and read by lane i only
  float* hist = ring + 2 * SLOT;
  const size_t bH = (size_t)b * H;
  const int r = lane < NX ? lane : 0;   // lane's row of the 13-wide products
  for (int e = lane; e < 2 * SLOT; e += 32) ring[e] = 0.f;
  // knots in registers: float32 entries, or bf16 words
  using Regs = typename std::conditional<std::is_same<T, float>::value,
                                         KnotRegs, KnotRegs16>::type;
  auto load = [&](Regs& g, int k, const float* v, int nv) {
    const size_t kk = bH + k;
    if constexpr (std::is_same<T, float>::value)
      load_knot(g, A + kk * nx * nx, Bm + kk * nx * nu, u + kk * nu,
                v + kk * nv, nx, nu, nv, lane);
    else
      load_knot(g, bf16_knot(A, kk, nx, nx), bf16_knot(Bm, kk, nx, nu),
                u + kk * nu, v + kk * nv, nx, nu, nv, lane);
  };

  // forward: x_{k+1} = A_k x_k + B_k u_k, lane i forming entry i with row
  // i of A_k in registers and x_k on every lane; B_k u_k, gu_k = G u_k and
  // the costate's bracket Q x_{k+1} + q_k are off the chain
  float qrow[NX], xs[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) qrow[j] = c.Q[r * NX + j];
  {
    const float v = lane < nx ? x0[(size_t)b * nx + lane] : 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) xs[j] = __shfl_sync(FULL, v, j);
  }
  sweep_regs<MP, Regs>(H, true, ring, nx, nu, lane, [&](Regs& g, int k) {
    load(g, k, q, nx);
  }, [&](int k, const float* slot) {
    const RolloutSlot<MP>& X = *reinterpret_cast<const RolloutSlot<MP>*>(slot);
    const size_t kk = bH + k;
    // every lane forms a row of G u (lanes >= MP row 0), so that no branch
    // splits the body; the store keeps lanes < m
    const float gv = dot2_ss<NU>(c.G + (lane < MP ? lane : 0) * NU, X.u);
    if (lane < m) gu[kk * m + lane] = gv;
    float ar[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) ar[j] = X.A[r * NX + j];
    const float xn = dot2_rr<NX>(ar, xs) + dot2_ss<NU>(X.Bm + r * NU, X.u);
    if (lane < nx) x[kk * nx + lane] = xn;
#pragma unroll
    for (int j = 0; j < NX; ++j) xs[j] = __shfl_sync(FULL, xn, j);
    if (lane < NX) hist[k * NX + lane] = X.v[r] + dot2_rr<NX>(qrow, xs);
  });

  // backward: lam_k = (Q x_{k+1} + q_k) + A_{k+1}' lam_{k+1}, broadcast
  // by shuffles; lane j carries (A_k' lam_k)_j with column j of A_k in
  // registers and forms rx_k = R u_k + G' zm_k + B_k' lam_k from the same
  // broadcast values, R u_k + G' zm_k off the chain
  float carry = 0.f;
  sweep_regs<MP, Regs>(H, false, ring, nx, nu, lane, [&](Regs& g, int k) {
    load(g, k, zm, m);
  }, [&](int k, const float* slot) {
    const RolloutSlot<MP>& X = *reinterpret_cast<const RolloutSlot<MP>*>(slot);
    const size_t kk = bH + k;
    const int j = lane < NU ? lane : 0;
    const float ru = dot2_ss<NU>(c.R + j * NU, X.u);
    const float gz = dot2_ss<MP>(c.GT + j * MP, X.v);
    float ac[NX], bc[NX];
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      ac[l] = X.A[l * NX + r];
      bc[l] = X.Bm[l * NU + j];
    }
    const float lam = hist[k * NX + r] + carry;
    float ls[NX];
#pragma unroll
    for (int l = 0; l < NX; ++l) ls[l] = __shfl_sync(FULL, lam, l);
    carry = dot2_rr<NX>(ac, ls);
    if (lane < nu) rx[kk * nu + lane] = (ru + dot2_rr<NX>(bc, ls)) + gz;
  });
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
// a slot: the knot's inputs, then (bf16) the area its A_k, B_k arrive in
template <int MP, class T>
__host__ __device__ constexpr int factor_stride() {
  return factor_slot<MP>() + ab_floats<T>();
}
template <int MP, class T>
__host__ __device__ constexpr int factor_warp_floats() {
  return 2 * factor_stride<MP, T>() + (int)(sizeof(FactorWork) / 4);
}

template <int MP, class T>
__global__ void __launch_bounds__(WARPS * 32, 4)
    factor_kernel(const float* G, const float* R, const float* Q,
                  const T* __restrict__ A, const T* __restrict__ Bm,
                  const float* __restrict__ W, float* __restrict__ L,
                  float* __restrict__ dinv, float* __restrict__ K, Dims d) {
  __shared__ PassConsts<MP> c;
  extern __shared__ __align__(16) float dsm[];
  load_pass_consts(c, G, R, Q, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;   // whole warps only: no block barrier below
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  constexpr int SLOT = factor_stride<MP, T>();
  float* ring = dsm + warp * factor_warp_floats<MP, T>();
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
    if constexpr (std::is_same<T, float>::value) {
      stage_mat<NX, NX, RS, true>(X.At, A + kk * nx * nx, nx, nx, ln);
      stage_mat<NX, NU, RS, true>(X.Bt, Bm + kk * nx * nu, nx, nu, ln);
    } else {
      stage_ab16(reinterpret_cast<__nv_bfloat16*>(slot + factor_slot<MP>()),
                 A, Bm, kk, nx, nu, ln);
    }
    stage_vec(X.w, W + kk * m, m, ln);
  };
  // (bf16) A_k, B_k from the slot's bf16 area into At, Bt, transposed
  auto land = [&](float* slot) {
    FactorSlot<MP>& X = *reinterpret_cast<FactorSlot<MP>*>(slot);
    const __nv_bfloat16* ab =
        reinterpret_cast<const __nv_bfloat16*>(slot + factor_slot<MP>());
    widen_mat<NX, NX, RS, true>(X.At, ab, nx, nx, lane);
    widen_mat<NX, NU, RS, true>(X.Bt, ab + AB_B, nx, nu, lane);
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

  if constexpr (std::is_same<T, float>::value)
    sweep(H, false, ring, SLOT, request, body);
  else
    sweep(H, false, ring, SLOT, request, body, land);
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
// a slot: the knot's inputs, then (bf16) the area its A_k, B_k arrive in
template <int MP, class T>
__host__ __device__ constexpr int vector_stride() {
  return vector_slot<MP>() + ab_floats<T>();
}
template <int MP, class T>
__host__ __device__ int vector_warp_floats(int H) {   // ring, work, kff
  return 2 * vector_stride<MP, T>() + (int)(sizeof(VectorWork) / 4) + H * NU;
}

template <int MP, class T>
__global__ void __launch_bounds__(WARPS * 32, 4)
    vector_kernel(const float* G, const T* __restrict__ A,
                  const T* __restrict__ Bm, const float* __restrict__ L,
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
  constexpr int SLOT = vector_stride<MP, T>();
  float* ring = dsm + (size_t)warp * vector_warp_floats<MP, T>(H);
  VectorWork& S = *reinterpret_cast<VectorWork*>(ring + 2 * SLOT);
  float* kff = ring + 2 * SLOT + sizeof(VectorWork) / 4;   // (H, 12)
  const size_t bH = (size_t)b * H;

  for (int e = lane; e < 2 * SLOT; e += 32) ring[e] = 0.f;
  if (lane < 16) S.v[0][lane] = 0.f;
  int p = 0;   // S.v[p] holds this knot's sv (dx); S.v[p ^ 1] gets the next

  auto stage_ab = [&](VectorSlot<MP>& X, size_t kk) {
    if constexpr (std::is_same<T, float>::value) {
      stage_mat<NX, NX, NX, false>(X.A, A + kk * nx * nx, nx, nx, lane);
      stage_mat<NX, NU, NU, false>(X.Bm, Bm + kk * nx * nu, nx, nu, lane);
    } else {
      stage_ab16(reinterpret_cast<__nv_bfloat16*>(
                     reinterpret_cast<float*>(&X) + vector_slot<MP>()),
                 A, Bm, kk, nx, nu, lane);
    }
    stage_mat<NU, NX, NX, false>(X.K, K + kk * nu * nx, nu, nx, lane);
  };
  // (bf16) A_k, B_k from the slot's bf16 area into their float32 frames
  auto land = [&](float* slot) {
    VectorSlot<MP>& X = *reinterpret_cast<VectorSlot<MP>*>(slot);
    const __nv_bfloat16* ab =
        reinterpret_cast<const __nv_bfloat16*>(slot + vector_slot<MP>());
    widen_mat<NX, NX, NX, false>(X.A, ab, nx, nx, lane);
    widen_mat<NX, NU, NU, false>(X.Bm, ab + AB_B, nx, nu, lane);
  };
  // the sweeps' knots land through `land` in the bf16 instance
  auto run = [&](bool fwd, auto request, auto body) {
    if constexpr (std::is_same<T, float>::value)
      sweep(H, fwd, ring, SLOT, request, body);
    else
      sweep(H, fwd, ring, SLOT, request, body, land);
  };

  // backward: g = rx_k + G' vm_k + B_k' sv, kff_k = M_k^-1 g (kept in
  // shared memory for the forward sweep), sv <- A_k' sv - K_k' g.  The
  // padded inputs' g is 0, so their kff is 0 too.
  run(false, [&](int k, float* slot) {
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
  run(true, [&](int k, float* slot) {
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

// the largest H of the rollout's history and the vector pass's kff
constexpr int H_MAX = (int)(DYN_MAX / (WARPS * NX_MAX * sizeof(float)));

template <int MP, class T>
int launch_rollout(const float* G, const float* R, const float* Q,
                   const T* A, const T* Bm, const float* q,
                   const float* u, const float* zm, const float* x0, float* x,
                   float* rx, float* gu, const Dims& d, cudaStream_t stream) {
  const size_t dyn = (size_t)WARPS * rollout_warp_floats<MP>(d.H) *
                     sizeof(float);
  if (dyn > 32 * 1024) {   // a long horizon's history: above 48 KB
    const int err = (int)cudaFuncSetAttribute(
        rollout_kernel<MP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != 0) return err;
  }
  rollout_kernel<MP, T><<<blocks(d), WARPS * 32, dyn, stream>>>(
      G, R, Q, A, Bm, q, u, zm, x0, x, rx, gu, d);
  return (int)cudaGetLastError();
}

template <int MP, class T>
int launch_factor(const float* G, const float* R, const float* Q,
                  const T* A, const T* Bm, const float* W, float* L,
                  float* dinv, float* K, const Dims& d, cudaStream_t stream) {
  // 30.1-30.4 KB a block (35.4-35.6 KB with the bf16 areas), under the
  // default 48 KB
  const size_t dyn =
      (size_t)WARPS * factor_warp_floats<MP, T>() * sizeof(float);
  factor_kernel<MP, T><<<blocks(d), WARPS * 32, dyn, stream>>>(
      G, R, Q, A, Bm, W, L, dinv, K, d);
  return (int)cudaGetLastError();
}

template <int MP, class T>
int launch_vector(const float* G, const T* A, const T* Bm,
                  const float* L, const float* dinv, const float* K,
                  const float* rx, const float* vm, float* du, float* gdu,
                  const Dims& d, cudaStream_t stream) {
  const size_t dyn = (size_t)WARPS * vector_warp_floats<MP, T>(d.H) *
                     sizeof(float);
  if (dyn > 32 * 1024) {   // a long horizon's kff: above the default 48 KB
    const int err = (int)cudaFuncSetAttribute(
        vector_kernel<MP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != 0) return err;
  }
  vector_kernel<MP, T><<<blocks(d), WARPS * 32, dyn, stream>>>(
      G, A, Bm, L, dinv, K, rx, vm, du, gdu, d);
  return (int)cudaGetLastError();
}

template <class T>
int rollout(const float* G, const float* R, const float* Q, const T* A,
            const T* Bm, const float* q, const float* u, const float* zm,
            const float* x0, float* x, float* rx, float* gu, const Dims& d,
            cudaStream_t s) {
  if (bad_dims(d) || d.H > H_MAX) return (int)cudaErrorInvalidValue;
  return d.m <= 24 ? launch_rollout<24>(G, R, Q, A, Bm, q, u, zm, x0, x, rx,
                                        gu, d, s)
                   : launch_rollout<32>(G, R, Q, A, Bm, q, u, zm, x0, x, rx,
                                        gu, d, s);
}

template <class T>
int factor(const float* G, const float* R, const float* Q, const T* A,
           const T* Bm, const float* W, float* L, float* dinv, float* K,
           const Dims& d, cudaStream_t s) {
  if (bad_dims(d)) return (int)cudaErrorInvalidValue;
  return d.m <= 24 ? launch_factor<24>(G, R, Q, A, Bm, W, L, dinv, K, d, s)
                   : launch_factor<32>(G, R, Q, A, Bm, W, L, dinv, K, d, s);
}

template <class T>
int vector(const float* G, const T* A, const T* Bm, const float* L,
           const float* dinv, const float* K, const float* rx,
           const float* vm, float* du, float* gdu, const Dims& d,
           cudaStream_t s) {
  if (bad_dims(d) || d.H > H_MAX) return (int)cudaErrorInvalidValue;
  return d.m <= 24
             ? launch_vector<24>(G, A, Bm, L, dinv, K, rx, vm, du, gdu, d, s)
             : launch_vector<32>(G, A, Bm, L, dinv, K, rx, vm, du, gdu, d, s);
}

using bf16 = __nv_bfloat16;

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
// The _bf16 entries take A and B as bfloat16, each knot's matrix starting
// on 16 bytes (its elements padded to a multiple of 8); the rest as the
// float32 entries.
int fused_rollout_launch(const float* G, const float* R, const float* Q,
                         const float* A, const float* Bm, const float* q,
                         const float* u, const float* zm, const float* x0,
                         float* x, float* rx, float* gu, int B, int H, int nx,
                         int nu, int m, void* stream) {
  return rollout(G, R, Q, A, Bm, q, u, zm, x0, x, rx, gu,
                 Dims{B, H, nx, nu, m}, (cudaStream_t)stream);
}

int fused_rollout_bf16_launch(const float* G, const float* R, const float* Q,
                              const void* A, const void* Bm, const float* q,
                              const float* u, const float* zm,
                              const float* x0, float* x, float* rx, float* gu,
                              int B, int H, int nx, int nu, int m,
                              void* stream) {
  return rollout(G, R, Q, static_cast<const bf16*>(A),
                 static_cast<const bf16*>(Bm), q, u, zm, x0, x, rx, gu,
                 Dims{B, H, nx, nu, m}, (cudaStream_t)stream);
}

int fused_factor_launch(const float* G, const float* R, const float* Q,
                        const float* A, const float* Bm, const float* W,
                        float* L, float* dinv, float* K, int B, int H, int nx,
                        int nu, int m, void* stream) {
  return factor(G, R, Q, A, Bm, W, L, dinv, K, Dims{B, H, nx, nu, m},
                (cudaStream_t)stream);
}

int fused_factor_bf16_launch(const float* G, const float* R, const float* Q,
                             const void* A, const void* Bm, const float* W,
                             float* L, float* dinv, float* K, int B, int H,
                             int nx, int nu, int m, void* stream) {
  return factor(G, R, Q, static_cast<const bf16*>(A),
                static_cast<const bf16*>(Bm), W, L, dinv, K,
                Dims{B, H, nx, nu, m}, (cudaStream_t)stream);
}

int fused_vector_launch(const float* G, const float* A, const float* Bm,
                        const float* L, const float* dinv, const float* K,
                        const float* rx, const float* vm, float* du,
                        float* gdu, int B, int H, int nx, int nu, int m,
                        void* stream) {
  return vector(G, A, Bm, L, dinv, K, rx, vm, du, gdu, Dims{B, H, nx, nu, m},
                (cudaStream_t)stream);
}

int fused_vector_bf16_launch(const float* G, const void* A, const void* Bm,
                             const float* L, const float* dinv,
                             const float* K, const float* rx, const float* vm,
                             float* du, float* gdu, int B, int H, int nx,
                             int nu, int m, void* stream) {
  return vector(G, static_cast<const bf16*>(A), static_cast<const bf16*>(Bm),
                L, dinv, K, rx, vm, du, gdu, Dims{B, H, nx, nu, m},
                (cudaStream_t)stream);
}

}  // extern "C"
