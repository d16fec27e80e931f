// Resident interior point for the batched whole-body QP, one CUDA kernel a
// solve.
//
// What it replaces: the op-by-op chain of ops/qpsolve.py::_solve_qp_impl on
// the card (the JAX package's solve_qp, apf_quadruped_tpu/ops/qpsolve.py,
// whose SPD factor and substitutions are the Pallas kernels of
// ops/pallas_chol.py).  At the WBC's sizes (n = 30 variables, p = 30
// equality rows, m = 68 inequality rows) that chain is 3,222 launches a
// solve: two 30 x 30 factors, H^-1 A' and a dozen k = 1 substitutions an
// iteration (csrc/spd_chol.cu), and the cuBLAS products and elementwise
// glue between them.  This kernel runs the whole solve in one launch:
//   the masks (a masked inequality row 0'x <= 1, a masked equality row
//   0'x = 0 with a unit Schur diagonal); the least-squares initial point
//   with W = I and its slack shift; `iters` fixed Mehrotra predictor-
//   corrector iterations with a per-lane `done` flag and a zero step once
//   converged (no early exit: a converged lane still takes eager's
//   alpha * dx, so a non-finite Newton step poisons it as it does there);
//   static_reg on H, eq_reg on S_eq, the w_clip clamp of z/s;
//   `refine_steps` rounds of refinement against the unregularized H; the
//   fraction-to-boundary step over real rows; the final residuals, the
//   iteration of convergence and `converged`; the NaN quarantine (a lane
//   whose x, y or z is not finite comes back zero and unconverged, gap and
//   residual NaN -> inf).  The CPU keeps _solve_qp_impl as the plain
//   version.
//
// The algebra is _solve_qp_impl's, the equalities eliminated through the
// factor of H = P + static_reg I + G' W G = L L':
//   V = L^-1 A' (forward substitution, p right-hand sides),
//   S_eq = V'V + diag(eq_reg + 1 - eq_mask) = A H^-1 A' + ..., factored,
//   and a KKT solve of (rx, ry) as u = L^-1 rx, dy = S_eq^-1 (V'u - ry),
//   dx = L^-T (u - V dy),
// which is H^-1 (rx - A'dy) with A H^-1 rx = V'u: two half substitutions
// with L and a solve with S_eq's factor, where the chain ran three solves
// with H and formed H^-1 A' by full substitutions.  Equal in exact
// arithmetic; in float32 the answers lie as far from float64 as the
// chain's own, which is what the card tests hold them to.
//
// Numerics.  Float32 throughout, no tensor cores (TF32 is off for the port),
// no --use_fast_math.  The two factors are csrc/spd_chol.cu's factor_rows
// (copied below): right-looking, every entry subtracting its terms in
// ascending order, an rsqrt pivot, and NaN for the whole factor and its
// 1/diag on a pivot that is not positive, never a clamp (the quarantine
// depends on the NaN).  The substitutions are spd_chol.cu's row forms.
// Sums elsewhere (the Grams, the matrix-vector products, the reductions)
// take this kernel's order; max, min and clamp propagate NaN as torch's do.
//
// Design for Hopper: one warp, alone in its block, a QP lane.
//  - Staging: the lane's P, A and G (15.4 KB of its 16 KB of inputs) are
//    copied into shared memory once with 16-byte cp.async, at the compiled
//    widths (P and A N x N, G an even number of rows of N, zero past n, p
//    and m: ops/cuda_qp.py pads a smaller QP and copies a misaligned one;
//    the WBC's come as they are); q, b, h and the masks by plain loads
//    beside them.  Nothing is read from device memory after that.
//  - Kept in shared memory for every iteration: P, A, G (masked), V,
//    H / L (lower triangle) and S_eq / L_s (transposed, in the strict upper
//    triangle of the same 30 x 31 array), both factors' 1/diag, the
//    iterate and the vectors the products broadcast; 27.4 KB a lane, under
//    the 27.5 KB that lets 8 blocks share an SM's 228 KB, so B = 1024 runs
//    in one wave (132 x 8 = 1,056).
//  - The warp runs everything: the two symmetric Grams, G'WG (120 2 x 2
//    tiles of H's lower triangle, 68 rows each) and V'V, a tile a lane;
//    both factors (lane r = row r in registers, pivots and columns
//    broadcast by shuffles: csrc/spd_chol.cu's factor_rows); V by lanes
//    over its columns; the KKT solves (the substitutions' steps one
//    shuffle and one multiply-add), residuals and steps with one vector
//    element a lane (the m rows three a lane), the products over vectors
//    broadcast from shared memory, the reductions by shuffles.
//  - One warp a block, so that no code runs under a warp test: a first
//    design gave the chains to warp 0 of a four-warp block (the others
//    shared the Grams), and ptxas then compiled every shuffle for a warp
//    that may have diverged (WARPSYNC.COLLECTIVE loops, 850 KB of SASS)
//    and the launch hung.  The block's size is the same for every B.
//  - Each piece is compiled once: the iteration's solves (the initial
//    point's, the predictor's, the corrector's) share one KKT solve, whose
//    refinement rounds share one pass of the substitutions, and both
//    factors share one factor_rows; the products and reductions loop at
//    run time: 128 registers, no spill.
//
// What bounds it on the H100: one warp's dependent chain, not operations
// or bytes (a solve of 1,024 lanes does ~3.7 GFLOP and moves 17 MB, 0.055
// ms at the card's float32 rate).  Clock marks in a copy of the kernel put
// a third of a B = 1 solve in the KKT solves' triangular steps (~54 cycles
// a step) and the rest in the refinement's products (11%), the Grams
// (17%), the factors (15%), the residuals and the steps; a B = 1024 lane
// runs 1.12x a B = 1 lane's cycles, 8 warps sharing an SM.  Explicit
// inverses of both factors, applied as products, ran 1.35x slower: their
// own column substitutions cost more than the products saved.  PERF.md
// has the times against the chain and the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// Mirror: apf_quadruped_tpu_torch/_kernels.py::QpArgs (same order).
struct QpArgs {
  // P (B, N, N), A (B, N, N) and G (B, m + m % 2, N), zero past n, p and
  // m, 16-byte aligned, then q (B, n), b (B, p), h (B, m), em (B, p) and
  // im (B, m)
  const float *P, *q, *A, *b, *G, *h, *em, *im;
  float *x, *y, *z, *s;                           // (B, n), (B, p), (B, m) x 2
  uint8_t* conv;                                  // (B,) bool
  int* iters;                                     // (B,) int32
  float *gap, *res;                               // (B,)
  int B, n, p, m, n_iter, refine;
  float reltol, abstol, frac, sigma_pow, static_reg, eq_reg, min_slack,
      w_clip;
};

}  // extern "C"

namespace {

constexpr int N = 30;            // n and p at most: H, S_eq, V are N x N
constexpr int M_MAX = 72;        // m at most
constexpr int MR = (M_MAX + 31) / 32;   // inequality rows a lane
constexpr int LS = N + 1;        // row stride of LL
constexpr int HALF = N / 2;
constexpr int TILES = HALF * (HALF + 1) / 2;   // 2 x 2 tiles, lower triangle
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float P[N * N];       // row-major, stride N, zero past n
  float A[N * N];       // p rows of n, masked, zero past p and n
  float G[M_MAX * N];   // m rows of n, masked
  float V[N * N];       // L^-1 A': n rows of p columns, zero past them
  float LL[N * LS];     // H, L at (i, j <= i); S_eq, L_s at (j, i + 1)
  // vectors of n or p, one entry a lane (zero past n, p)
  float q[32], b[32], sd[32], x[32], y[32], rx[32], ry[32], dh[32], ds[32],
      vx[32], vy[32];
  // vectors of m
  float h[M_MAX], im[M_MAX], z[M_MAX], s[M_MAX], w[M_MAX], rz[M_MAX],
      pa[M_MAX], dzv[M_MAX], dsv[M_MAX], vm[M_MAX];
};
static_assert(sizeof(Smem) <= 27 * 1024 + 512,
              "8 lanes an SM: 228 KB less 1 KB a block, over 8");
static_assert(N % 2 == 0 && N <= 32 && M_MAX <= 32 * MR,
              "one row a lane; 2 x 2 tiles");

// max and min that return a NaN operand, as torch.maximum, torch.clamp and
// amax do (fmaxf and fminf drop it)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float wmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float wmin(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// torch.nan_to_num(v): NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float v) {
  if (v != v) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}
// torch.nan_to_num(v, nan=inf)
__device__ __forceinline__ float nan_to_inf(float v) {
  if (v != v) return INFINITY;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// 16 bytes from device memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#endif
}
__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void cp_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ void stage(Smem& S, const QpArgs& a, size_t bi,
                                      int lane) {
  const int n = a.n, p = a.p, m = a.m, mp = m + (m & 1);
  const float* P = a.P + bi * N * N;
  const float* A = a.A + bi * N * N;
  const float* G = a.G + bi * mp * N;
  const float* em = a.em + bi * p;
  const float* im = a.im + bi * m;
  for (int c = lane; c < N * N / 4; c += 32) {
    cp16(S.P + 4 * c, P + 4 * c);
    cp16(S.A + 4 * c, A + 4 * c);
  }
  for (int c = lane; c < mp * N / 4; c += 32) cp16(S.G + 4 * c, G + 4 * c);
  cp_commit();
  // the vectors, during the copy: b masked, h = 1 on masked rows, the
  // Schur diagonal eq_reg + (1 - eq_mask) (1 on padding rows)
  const float e = lane < p ? em[lane] : 0.f;
  S.q[lane] = lane < n ? a.q[bi * n + lane] : 0.f;
  S.b[lane] = lane < p ? a.b[bi * p + lane] * e : 0.f;
  S.sd[lane] = lane < p ? a.eq_reg + (1.f - e) : 1.f;
  S.x[lane] = S.y[lane] = S.vx[lane] = S.vy[lane] = 0.f;
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    const int r = lane + 32 * k;
    if (r < M_MAX) {
      const float mr = r < m ? im[r] : 0.f;
      S.im[r] = mr;
      S.h[r] = r < m ? (mr > 0.f ? a.h[bi * m + r] : 1.f) : 0.f;
      S.w[r] = 1.f;                     // the initial point's W = I
    }
  }
  for (int i = lane; i < N * N; i += 32) S.V[i] = 0.f;
  cp_wait_all();
  __syncwarp();
  for (int i = lane; i < m * N; i += 32) S.G[i] = S.G[i] * S.im[i / N];
  for (int i = lane; i < p * N; i += 32) S.A[i] = S.A[i] * em[i / N];
  __syncwarp();
}

// ---- the factorization ---------------------------------------------------

// tile t of a lower triangle of HALF x HALF 2 x 2 tiles -> (I, J), J <= I
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  J = t - I * (I + 1) / 2;
}

constexpr int TL = (TILES + 31) / 32;   // tiles a lane

// The lane's tiles (lane + 32 k), their corners (2 I, 2 J), whether each is
// a tile (the last k of some lanes is not)
__device__ __forceinline__ void tiles_of(int lane, int (&i0)[TL],
                                         int (&j0)[TL], bool (&on)[TL]) {
#pragma unroll
  for (int k = 0; k < TL; ++k) {
    const int t = lane + 32 * k;
    on[k] = t < TILES;
    int I, J;
    tile_of(on[k] ? t : 0, I, J);
    i0[k] = 2 * I;
    j0[k] = 2 * J;
  }
}

// H = (P + static_reg I) + G' diag(w) G into LL's lower triangle; the
// padding block (i >= n) the identity.  A lane's tiles share each row's
// pass, so that their loads and sums run side by side.
__device__ __forceinline__ void gram_h(Smem& S, int n, int m, float reg,
                                       int lane) {
  int i0[TL], j0[TL];
  bool on[TL];
  tiles_of(lane, i0, j0, on);
  float acc[TL][4];
#pragma unroll
  for (int k = 0; k < TL; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
#pragma unroll 2
  for (int r = 0; r < m; ++r) {
    const float* g = S.G + r * N;
    const float wr = S.w[r];
#pragma unroll
    for (int k = 0; k < TL; ++k) {
      const float2 gi = *reinterpret_cast<const float2*>(g + i0[k]);
      const float2 gj = *reinterpret_cast<const float2*>(g + j0[k]);
      const float w0 = wr * gj.x, w1 = wr * gj.y;
      acc[k][0] = fmaf(gi.x, w0, acc[k][0]);
      acc[k][1] = fmaf(gi.x, w1, acc[k][1]);
      acc[k][2] = fmaf(gi.y, w0, acc[k][2]);
      acc[k][3] = fmaf(gi.y, w1, acc[k][3]);
    }
  }
#pragma unroll
  for (int k = 0; k < TL; ++k) {
    if (!on[k]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0[k] + e / 2, j = j0[k] + e % 2;
      if (j <= i)
        S.LL[i * LS + j] =
            i < n ? (S.P[i * N + j] + (i == j ? reg : 0.f)) + acc[k][e]
                  : (i == j ? 1.f : 0.f);
    }
  }
}

// V = L^-1 A' by lanes over its columns (lane c < p holds column c in
// registers), L and 1/diag read by broadcast: spd_chol.cu's
// spd_sub_cols_kernel forward pass, right-looking, each entry subtracting
// its terms in ascending order.  The reads are volatile: each step's loads
// issue in order, so the unrolled loop does not hold ~N^2 / 2 of them live.
__device__ __forceinline__ void lower_solve_v(Smem& S, int p, int lane) {
  if (lane < p) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = S.A[lane * N + i];
    const volatile float* L = S.LL;
    const volatile float* dv = S.dh;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] *= dv[i];
#pragma unroll
      for (int t = i + 1; t < N; ++t) x[t] = fmaf(-L[t * LS + i], x[i], x[t]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) S.V[i * N + lane] = x[i];
  }
}

// S_eq = V'V + diag(sd), its entry (j, k <= j) at LL[k * LS + j + 1]
__device__ __forceinline__ void gram_s(Smem& S, int n, int lane) {
  int j0[TL], k0[TL];
  bool on[TL];
  tiles_of(lane, j0, k0, on);
  float acc[TL][4];
#pragma unroll
  for (int k = 0; k < TL; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float* v = S.V + i * N;
#pragma unroll
    for (int k = 0; k < TL; ++k) {
      const float2 vj = *reinterpret_cast<const float2*>(v + j0[k]);
      const float2 vk = *reinterpret_cast<const float2*>(v + k0[k]);
      acc[k][0] = fmaf(vj.x, vk.x, acc[k][0]);
      acc[k][1] = fmaf(vj.x, vk.y, acc[k][1]);
      acc[k][2] = fmaf(vj.y, vk.x, acc[k][2]);
      acc[k][3] = fmaf(vj.y, vk.y, acc[k][3]);
    }
  }
#pragma unroll
  for (int k = 0; k < TL; ++k) {
    if (!on[k]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0[k] + e / 2, kk = k0[k] + e % 2;
      if (kk <= j)
        S.LL[kk * LS + j + 1] = acc[k][e] + (j == kk ? S.sd[j] : 0.f);
    }
  }
}

// csrc/spd_chol.cu::factor_rows (without the column gather): factor the
// N x N SPD matrix whose lower triangle lane r holds, row r, in a[]
// (zeros above the diagonal; lanes >= N all zeros), right-looking.  On
// return a[c] = L_rc for c <= r, dv = 1 / L_rr on lane r < N, and the
// result says whether a pivot was not positive or NaN.
__device__ __forceinline__ bool factor_rows(float (&a)[N], float& dv,
                                            int lane) {
  float s = __shfl_sync(FULL, a[0], 0);    // column 0's pivot
  bool bad = false;                        // uniform: s is broadcast
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = rsqrtf(s);
    bad |= !(s > 0.0f);
    if (lane == j) dv = d;
    const float l = a[j] * d;              // lane > j: L_rj; lane j: s d
    a[j] = l;
    const float lu = lane > j ? l : 0.0f;  // the rows below j update
    if (j + 1 < N)   // next pivot, ahead of the rest (lane j + 1's lu is l)
      s = __shfl_sync(FULL, fmaf(-l, l, a[j + 1]), j + 1);
#pragma unroll
    for (int c = j + 1; c < N; ++c) {
      const float lc = __shfl_sync(FULL, lu, c);   // L_cj
      a[c] = fmaf(-lu, lc, a[c]);
    }
  }
  return bad;
}

// Where factor `mat` keeps entry (r, c <= r): L (H's) at LL[r * LS + c],
// L_s (S_eq's) at LL[c * LS + r + 1].
__device__ __forceinline__ int at(int mat, int r, int c) {
  return mat == 0 ? r * LS + c : c * LS + r + 1;
}

// H from S.w, its factor L, V, S_eq and its factor L_s; every entry of a
// factor and its 1/diag NaN on a pivot that is not positive, never a clamp
__device__ __forceinline__ void factor_kkt(Smem& S, int n, int p, int m,
                                           float reg, int lane) {
  for (int mat = 0; mat < 2; ++mat) {
    if (mat == 0) {
      gram_h(S, n, m, reg, lane);
    } else {
      lower_solve_v(S, p, lane);
      __syncwarp();
      gram_s(S, n, lane);
    }
    __syncwarp();
    const int r = lane < N ? lane : N - 1;   // an address inside LL
    float a[N];
#pragma unroll
    for (int c = 0; c < N; ++c)
      a[c] = (c <= lane && lane < N) ? S.LL[at(mat, r, c)] : 0.f;
    float dv = 0.f;
    const bool bad = factor_rows(a, dv, lane);
    const float nan = __int_as_float(0x7fc00000);
    if (lane < N) {
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (c <= lane) S.LL[at(mat, r, c)] = bad ? nan : a[c];
      (mat == 0 ? S.dh : S.ds)[lane] = bad ? nan : dv;
    }
    __syncwarp();
  }
}

// ---- the KKT solve ---------------------------------------------------------

// y = L^-1 v (lane r holds v_r and gets y_r): spd_sub_rows_kernel's
// forward pass, the factor read from shared memory
__device__ __forceinline__ float fwd(const Smem& S, int mat, float v,
                                     int lane) {
  const int r = lane < N ? lane : N - 1;
  const float dvr = lane < N ? (mat == 0 ? S.dh : S.ds)[r] : 1.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float l = (i < lane && lane < N) ? S.LL[at(mat, r, i)] : 0.f;
    v = fmaf(-l, __shfl_sync(FULL, v * dvr, i), v);
  }
  return v * dvr;
}

// x = L^-T y: its back substitution
__device__ __forceinline__ float bwd(const Smem& S, int mat, float w,
                                     int lane) {
  const int r = lane < N ? lane : N - 1;
  const float dvr = lane < N ? (mat == 0 ? S.dh : S.ds)[r] : 1.f;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const float l = i > lane ? S.LL[at(mat, i, r)] : 0.f;
    w = fmaf(-l, __shfl_sync(FULL, w * dvr, i), w);
  }
  return w * dvr;
}

// sum_{j < len} M[j * stride] v[j] in four accumulators (j mod 4), summed
// pairwise at the end
__device__ __forceinline__ float dot4(const float* M, int stride,
                                      const float* v, int len) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
#pragma unroll 2
  for (; j + 3 < len; j += 4) {
    a0 = fmaf(M[j * stride], v[j], a0);
    a1 = fmaf(M[(j + 1) * stride], v[j + 1], a1);
    a2 = fmaf(M[(j + 2) * stride], v[j + 2], a2);
    a3 = fmaf(M[(j + 3) * stride], v[j + 3], a3);
  }
  for (; j < len; ++j) a0 = fmaf(M[j * stride], v[j], a0);
  return (a0 + a1) + (a2 + a3);
}

// lane i < rows: sum_{j < cols} M[i][j] v[j] (M row-major, stride N), 0
// past rows
__device__ __forceinline__ float mv(const float* M, const float* v, int rows,
                                    int cols, int lane) {
  return lane < rows ? dot4(M + lane * N, 1, v, cols) : 0.f;
}

// lane i < cols: sum_{j < rows} M[j][i] v[j], 0 past cols
__device__ __forceinline__ float mtv(const float* M, const float* v, int rows,
                                     int cols, int lane) {
  return lane < cols ? dot4(M + lane, N, v, rows) : 0.f;
}

// o[k] = (G v)_r for r = lane + 32 k < m, 0 past m: the rows' sums side
// by side, two accumulators each
__device__ __forceinline__ void gv(const Smem& S, const float* v, int n,
                                   int m, int lane, float (&o)[MR]) {
  float a[MR][2];
  const float* g[MR];
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    g[k] = S.G + min(lane + 32 * k, m - 1) * N;
    a[k][0] = a[k][1] = 0.f;
  }
  int j = 0;
#pragma unroll 2
  for (; j + 1 < n; j += 2) {
    const float v0 = v[j], v1 = v[j + 1];
#pragma unroll
    for (int k = 0; k < MR; ++k) {
      a[k][0] = fmaf(g[k][j], v0, a[k][0]);
      a[k][1] = fmaf(g[k][j + 1], v1, a[k][1]);
    }
  }
  if (j < n) {
#pragma unroll
    for (int k = 0; k < MR; ++k) a[k][0] = fmaf(g[k][j], v[j], a[k][0]);
  }
#pragma unroll
  for (int k = 0; k < MR; ++k)
    o[k] = lane + 32 * k < m ? a[k][0] + a[k][1] : 0.f;
}

// (dx, dy) with H dx + A'dy = rx, A dx = ry: u = L^-1 rx, dy = S_eq^-1
// (V'u - ry), dx = L^-T (u - V dy)
__device__ __forceinline__ void solve_once(Smem& S, int n, int p, float rx,
                                           float ry, int lane, float& dx,
                                           float& dy) {
  const float u = fwd(S, 0, rx, lane);
  S.vx[lane] = u;
  __syncwarp();
  const float g = lane < N ? mtv(S.V, S.vx, n, p, lane) - ry : 0.f;
  dy = bwd(S, 1, fwd(S, 1, g, lane), lane);
  S.vy[lane] = dy;
  __syncwarp();
  dx = bwd(S, 0, u - mv(S.V, S.vy, n, p, lane), lane);
  __syncwarp();
}

// solve_once, then `refine` rounds of refinement against the unregularized
// H = P + G' diag(w) G
__device__ __forceinline__ void kkt(Smem& S, int n, int p, int m, int refine,
                                    float rhs_x, float rhs_y, int lane,
                                    float& dx, float& dy) {
  dx = dy = 0.f;
  for (int round = 0; round <= refine; ++round) {
    float r1 = rhs_x, r2 = rhs_y;
    if (round > 0) {
      S.vx[lane] = dx;
      S.vy[lane] = dy;
      __syncwarp();
      float wg[MR];
      gv(S, S.vx, n, m, lane, wg);
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int r = lane + 32 * k;
        if (r < m) S.vm[r] = S.w[r] * wg[k];
      }
      __syncwarp();
      const float hmv = mv(S.P, S.vx, n, n, lane) + mtv(S.G, S.vm, m, n, lane);
      r1 = (rhs_x - hmv) - mtv(S.A, S.vy, p, n, lane);
      r2 = rhs_y - mv(S.A, S.vx, p, n, lane);
      __syncwarp();
    }
    float ddx, ddy;
    solve_once(S, n, p, r1, r2, lane, ddx, ddy);
    dx = round == 0 ? ddx : dx + ddx;
    dy = round == 0 ? ddy : dy + ddy;
  }
}

// the largest alpha in (0, 1] (times frac) keeping s + alpha ds and
// z + alpha dz positive over the real rows
__device__ __forceinline__ float steplen(const Smem& S, float frac, int m,
                                         int lane) {
  float ra = INFINITY, rb = INFINITY;
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    const int r = lane + 32 * k;
    if (r < m && S.im[r] > 0.f) {
      const float ds = S.dsv[r], dz = S.dzv[r];
      if (ds < 0.f) ra = nmin(ra, -S.s[r] / ds);
      if (dz < 0.f) rb = nmin(rb, -S.z[r] / dz);
    }
  }
  return nmin(frac * nmin(wmin(ra), wmin(rb)), 1.f);
}

__device__ __forceinline__ float pow_sigma(float v, float e) {
  // torch's pow by a scalar: x * x and x * x * x for 2 and 3
  if (e == 2.f) return v * v;
  if (e == 3.f) return v * v * v;
  return powf(v, e);
}

__global__ void __launch_bounds__(32, 8)
    resident_ipm_qp_kernel(const QpArgs a) {
  __shared__ __align__(16) Smem S;
  const int lane = threadIdx.x;
  const size_t bi = blockIdx.x;
  const int n = a.n, p = a.p, m = a.m;
  const float ms = a.min_slack;
  stage(S, a, bi, lane);

  float ims = 0.f, hs = 0.f;
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    const int r = lane + 32 * k;
    if (r < m) {
      ims += S.im[r];
      hs = fmaf(S.h[r], S.h[r], hs);
    }
  }
  const float meff = fmaxf(wsum(ims), 1.f);
  const float qn = 1.f + sqrtf(wsum(S.q[lane] * S.q[lane]));
  const float bn = 1.f + sqrtf(wsum(S.b[lane] * S.b[lane]));
  const float hn = 1.f + sqrtf(wsum(hs));

  float mu = 0.f, res = 0.f, smu = 0.f;
  bool done = false;
  int itc = a.n_iter;
  // it = -1: the initial point; it = n_iter: the final residuals only
  for (int it = -1; it <= a.n_iter; ++it) {
    if (it >= 0) {
      // residuals at the iterate: rx to S.rx, ry to S.ry, rz to S.rz
      S.vx[lane] = S.x[lane];
      S.vy[lane] = S.y[lane];
      __syncwarp();
      const float rx = ((mv(S.P, S.vx, n, n, lane) + S.q[lane])
                        + mtv(S.A, S.vy, p, n, lane))
                       + mtv(S.G, S.z, m, n, lane);
      const float ry = mv(S.A, S.vx, p, n, lane) - S.b[lane];
      float gx[MR];
      gv(S, S.vx, n, m, lane, gx);
      float mus = 0.f, rzs = 0.f;
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int r = lane + 32 * k;
        if (r < m) {
          const float rz = (gx[k] + S.s[r]) - S.h[r];
          S.rz[r] = rz;
          rzs = fmaf(rz, rz, rzs);
          mus += S.s[r] * S.z[r] * S.im[r];
        }
      }
      S.rx[lane] = rx;
      S.ry[lane] = ry;
      mu = wsum(mus) / meff;
      res = nmax(sqrtf(wsum(rx * rx)) / qn,
                 nmax(sqrtf(wsum(ry * ry)) / bn, sqrtf(wsum(rzs)) / hn));
      if (it == a.n_iter) break;
      const bool now = (res < a.reltol) && (mu < a.abstol);
      if (now && !done) itc = it;
      done = done || now;
      // the clip guards H's conditioning only: the step's primal and
      // complementarity rows stay exact
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int r = lane + 32 * k;
        if (r < m)
          S.w[r] = nmin(nmax(nmax(S.z[r], ms) / nmax(S.s[r], ms),
                             1.f / a.w_clip),
                        a.w_clip);
      }
      __syncwarp();
    }
    factor_kkt(S, n, p, m, a.static_reg, lane);

    // this pass's solves: the initial point's (pc = 2: least squares with
    // W = I), or the predictor's (0, sigma = 0) and the corrector's (1,
    // Mehrotra's second-order term)
    for (int pc = it < 0 ? 2 : 0; pc < (it < 0 ? 3 : 2); ++pc) {
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int r = lane + 32 * k;
        if (r < m) {
          const float sr = S.s[r], zr = S.z[r];
          const float rc = pc == 0 ? -(sr * zr) : -((sr * zr + S.pa[r]) - smu);
          S.vm[r] = pc == 2 ? S.h[r] : S.w[r] * S.rz[r] + rc / nmax(sr, ms);
        }
      }
      __syncwarp();
      const float gt = mtv(S.G, S.vm, m, n, lane);
      const float rhs_x = pc == 2 ? -S.q[lane] + gt : -S.rx[lane] - gt;
      const float rhs_y = pc == 2 ? S.b[lane] : -S.ry[lane];
      __syncwarp();
      float dx, dy;
      kkt(S, n, p, m, a.refine, rhs_x, rhs_y, lane, dx, dy);
      S.vx[lane] = dx;
      __syncwarp();
      float gd[MR];
      gv(S, S.vx, n, m, lane, gd);
      if (pc == 2) {
        // slacks and duals shifted in: s = -r0 + shift, z = max(r0, 0) + 1
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          gd[k] -= lane + 32 * k < m ? S.h[lane + 32 * k] : 0.f;
          if (lane + 32 * k < m) mx = nmax(mx, gd[k]);
        }
        const float shift = nmax(wmax(mx), 0.f) + 1.f;
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          const int r = lane + 32 * k;
          if (r < m) {
            S.s[r] = -gd[k] + shift;
            S.z[r] = nmax(gd[k], 0.f) + 1.f;
          }
        }
        S.x[lane] = dx;
        S.y[lane] = dy;
        __syncwarp();
        continue;
      }
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int r = lane + 32 * k;
        if (r < m) {
          const float sr = S.s[r], zr = S.z[r];
          const float rc = pc == 0 ? -(sr * zr) : -((sr * zr + S.pa[r]) - smu);
          const float ds = -S.rz[r] - gd[k];
          S.dsv[r] = ds;
          S.dzv[r] = (rc - zr * ds) / nmax(sr, ms);
        }
      }
      __syncwarp();
      const float al = steplen(S, pc == 0 ? 1.f : a.frac, m, lane);
      if (pc == 0) {
        float mas = 0.f;
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          const int r = lane + 32 * k;
          if (r < m) {
            const float ds = S.dsv[r], dz = S.dzv[r];
            mas += (S.s[r] + al * ds) * (S.z[r] + al * dz) * S.im[r];
            S.pa[r] = ds * dz;
          }
        }
        const float mu_aff = wsum(mas) / meff;
        smu = pow_sigma(nmin(nmax(mu_aff / nmax(mu, ms), 0.f), 1.f),
                        a.sigma_pow) * mu;
      } else {
        const float alpha = done ? 0.f : al;
        if (lane < N) {
          S.x[lane] = S.x[lane] + alpha * dx;
          S.y[lane] = S.y[lane] + alpha * dy;
        }
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          const int r = lane + 32 * k;
          if (r < m) {
            S.z[r] = nmax(S.z[r] + alpha * S.dzv[r], ms);
            S.s[r] = nmax(S.s[r] + alpha * S.dsv[r], ms);
          }
        }
      }
      __syncwarp();
    }
  }

  const bool conv = done || ((res < a.reltol) && (mu < a.abstol));
  // NaN quarantine: a blown-up lane comes back finite (zeros), flagged
  const float xv = S.x[lane], yv = S.y[lane];
  float bad = ((lane < n && !isfinite(xv)) || (lane < p && !isfinite(yv)))
                  ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    const int r = lane + 32 * k;
    if (r < m && !isfinite(S.z[r])) bad = 1.f;
  }
  const bool ok = wsum(bad) == 0.f;
  if (lane < n) a.x[bi * n + lane] = ok ? nan_to_num(xv) : 0.f;
  if (lane < p) a.y[bi * p + lane] = ok ? nan_to_num(yv) : 0.f;
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    const int r = lane + 32 * k;
    if (r < m) {
      a.z[bi * m + r] = ok ? nan_to_num(S.z[r]) : 0.f;
      a.s[bi * m + r] = ok ? nan_to_num(S.s[r]) : 0.f;
    }
  }
  if (lane == 0) {
    a.conv[bi] = (conv && ok) ? 1 : 0;
    a.iters[bi] = itc;
    a.gap[bi] = nan_to_inf(mu);
    a.res[bi] = nan_to_inf(res);
  }
}

}  // namespace

extern "C" {

// The kernel's limits, for the wrapper's route: n, p and m at most.
void resident_qp_limits(int* n_max, int* p_max, int* m_max) {
  *n_max = N;
  *p_max = N;
  *m_max = M_MAX;
}

// Prefer the largest shared-memory carveout for the kernel on the current
// device, so that 8 blocks share an SM; once a device, before its first
// launch.  Returns the CUDA error (0 = set).
int resident_qp_prefer_shared(void) {
  return (int)cudaFuncSetAttribute(
      resident_ipm_qp_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// Launch on `stream`, one warp a QP; returns the CUDA error of the launch
// (0 = launched).
int resident_qp_launch(const QpArgs* args, void* stream) {
  resident_ipm_qp_kernel<<<args->B, 32, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
