// Batched SPD Cholesky factor, substitution, and factor-and-solve: CUDA
// kernels for Hopper.
//
// What each body replaces (the JAX package's TPU kernels in
// apf_quadruped_tpu/ops/pallas_chol.py):
//   spd_factor_kernel<N>, spd_factor_wide_kernel <- ::_factor_kernel (via
//       chol_factor_blocked): H (B, n, n) SPD -> L (B, n, n) lower-
//       triangular with exact zeros above the diagonal, dinv (B, n) =
//       1 / diag(L).  s = H_jj - sum_t L_jt^2, d = rsqrt(s), L_jj = s d,
//       L_ij = (H_ij - sum_t L_it L_jt) d, every sum in ascending t.  A
//       pivot that is not positive (or NaN) makes the whole matrix and dinv
//       NaN, as the plain version (cholesky_ex + NaN fill) returns it: the
//       QP's lane quarantine depends on the NaN.  Never a clamp.  Only the
//       lower triangle of H is read.
//   spd_sub_rows_kernel<N> (k < COLS_MIN_K), spd_sub_cols_kernel<N>
//   (k >= COLS_MIN_K), spd_sub_wide_kernel <- ::_sub_kernel (via
//       chol_sub_blocked): L, dinv, rhs (B, n, k) -> X (B, n, k) with
//       L L' X = rhs: forward, then back substitution, both scaled by dinv.
//   spd_solve_kernel<N, COLS, W>, spd_solve_wide_kernel <- ::_chol_solve_kernel
//       (via chol_solve_blocked): M (B, n, n) SPD, rhs (B, n, k) -> X with
//       M X = rhs, the factor and the substitution in one launch; all of X
//       NaN where M is not positive definite.
// On the closed loop's path the first two factor the WBC QP's H = P + G' W G
// and its Schur complement S_eq (n = 30) twice per IPM iteration and the
// physics substep's mass matrix (n = 18), and substitute one right-hand
// side (k = 1: the Newton vectors, the mass-matrix solve) or thirty
// (k = 30: H^-1 A'): 36 factors and 206 substitutions a tick.  The third
// serves the scan IPM under SolverConfig.use_pallas (n = 12, B = 256 on the
// smoke run's path: k = 13 for the gains, k = 1 for the feed-forward, 540
// launches a plan).
//
// What bounds them on the H100: the dependent chain, not bytes.  A batch
// of 64 30 x 30 factors moves 0.36 MB and does 0.58 Mflop, 0.11 us at the
// card's memory rate; what no design avoids is 30 columns in turn, each a
// pivot that the next column waits on, and 2n dependent steps a k = 1
// substitution.  The yardstick is the launch floor, the device time of a
// kernel that does next to nothing (0.5-1 us on an H100 SXM at 700 W,
// chip_smoke.py phase 10), not the bytes.  The first design (one warp a
// matrix in shared memory, left-looking, runtime n) ran ~n^2 dependent
// shared-load -> FMA steps a factor and 2n shuffle steps with shared loads
// inside a k = 1 substitution: 0.0210 and 0.0093 ms at B = 64, n = 30;
// this one takes 0.0041 and 0.0026 (spd_turns.py; PERF.md, section 6).
//
// Design (N = 18, the mass matrix, and N = 30, H and S_eq, compile-time;
// n <= 18 runs at N = 18 and 19 <= n <= 30 at N = 30, the matrix padded
// with an identity block as it is staged: exact, since the first n columns
// of L depend only on the leading n x n block; 31 <= n <= 64 takes the wide
// bodies with runtime n; the factor-and-solve adds N = 12, the scan's M_k,
// for n <= 12).  One warp a matrix (at N = 12 in the factor-and-solve, two),
// one block a warp.
//   * staging: a matrix is one contiguous block of N*N floats (3,600 bytes
//     at n = 30, 1,296 at n = 18, both multiples of 16), copied into shared
//     memory with 16-byte cp.async while the warp loads its other operands,
//     then into registers; results go back through shared memory as 16-byte
//     stores.  A padded or unaligned matrix is staged row by row (lane c
//     copies column c, a coalesced load a row).  The row path alone runs
//     every case, but at B = 64 it took the factor 0.00465 ms against
//     0.00409 (n = 30) and 0.00254 against 0.00216 (n = 18), the k = 30
//     substitution 0.00495 against 0.00457 (H100 SXM at 700 W,
//     spd_turns.py in turns; PERF.md section 6); at B = 1024 the two are
//     within 3%.
//   * factor (factor_rows, shared by spd_factor_kernel and
//     spd_solve_kernel), right-looking, lane r = row r, the row in
//     registers (its lower triangle; zeros above).  Column j: the pivot
//     comes from lane j by one shuffle, then rsqrt; every lane scales its
//     own a[j]; the column's L_cj are broadcast by shuffles, independent
//     of each other, and every lane updates its remaining entries with
//     them.  The next
//     pivot, fma(-L_(j+1)j, L_(j+1)j, a[j+1]) on lane j+1, is shuffled out
//     before the rest of the update, so a column's chain is shuffle, rsqrt,
//     multiply, FMA: no shared memory and no __syncwarp in it.  Each entry
//     still subtracts its terms in ascending t, so the rounding is the
//     first design's.
//   * sub, k < COLS_MIN_K: lane r holds row r of L and column r of L (for
//     the back substitution) in registers, read once from shared memory,
//     and dinv_r in a register.  Each step of both substitutions is one
//     multiply on the owning lane, one shuffle and one FMA on the rest,
//     fully unrolled, nothing read from memory inside the chain.
//   * sub, k >= COLS_MIN_K: lane c holds its right-hand side in registers;
//     L and dinv come from shared memory by broadcast reads (every lane
//     reads the same word), unrolled so that a step's loads run ahead of
//     its FMAs; right-looking, so each step's updates are independent.
//     The reads are volatile: without that the compiler reuses the forward
//     pass's loads in the back substitution, keeps ~N^2 / 2 values live
//     and spills.
//   * factor-and-solve: the factor above, then the substitution from its
//     registers, L never written back: for k < COLS_MIN_K lane r holds row
//     r and column r of L (the column taken from the factor's column
//     broadcasts as they pass lane r) and each step is one shuffle and one
//     FMA; for k >= COLS_MIN_K lane c holds right-hand side c and each L_ti
//     reaches it by a shuffle from lane t's register i, independent of X.
//     M is staged as the factor stages H; the right-hand sides are loaded
//     straight into registers during the copy (each is read once, by one
//     lane).  At N = 12 a warp takes two matrices, 16 lanes each (shuffles
//     of width 16): half the warps for the same chains, the time 3-4%
//     shorter at B = 256 and 23-24% at B = 2048 than at one matrix a warp
//     (spd_turns.py against such a copy; PERF.md section 6).  The first design
//     (runtime n, left-looking in shared memory) took 0.0104 ms at
//     B = 256, n = 12, k = 13; this one 0.0027.
// The wide bodies keep the first design's device functions
// (factor_in_place, sub_cols, sub_rows: one warp a matrix in shared memory
// with an odd row stride, runtime n).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_MAX = 64;        // two rows a lane in the wide row paths
constexpr int N_SOLVE = 12;      // compile-time widths: the scan's M_k,
constexpr int N_SMALL = 18;      // the mass matrix,
constexpr int N_LARGE = 30;      // and the WBC's H and S_eq
constexpr int COLS_MIN_K = 8;    // sub: lanes over columns from this k on
constexpr int MAX_WARPS = 4;     // wide bodies: matrices per block
constexpr int SMEM_BUDGET = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// ---- staging ---------------------------------------------------------------

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

// wait for this thread's copies; a __syncwarp after it publishes them
__device__ __forceinline__ void cp_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Start copying the row-major n x n matrix g into sm (row stride N, the
// identity beyond n).  vec: n == N and g 16-byte aligned, so the matrix is
// N*N/4 contiguous 16-byte chunks, copied with cp.async (cp_wait_all and a
// __syncwarp complete it); otherwise the lanes copy it row by row.  W: the
// lanes that share the copy (lane < W).
template <int N, int W = 32>
__device__ __forceinline__ void stage(float* sm, const float* __restrict__ g,
                                      int n, bool vec, int lane) {
  static_assert(N <= W && (N * N) % 4 == 0,
                "one row a lane; the matrix whole 16-byte chunks");
  if (vec) {
    for (int q = lane; q < N * N / 4; q += W) cp16(sm + 4 * q, g + 4 * q);
    cp_commit();
  } else if (lane < N) {
    for (int i = 0; i < N; ++i)
      sm[i * N + lane] = (i < n && lane < n) ? g[i * n + lane]
                                             : (i == lane ? 1.0f : 0.0f);
  }
}

// Write the leading n x n block of sm (row stride N) to the row-major g, as
// `stage` read it (vec: 16-byte stores).
template <int N>
__device__ __forceinline__ void unstage(float* __restrict__ g, const float* sm,
                                        int n, bool vec, int lane) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(sm);
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int q = lane; q < N * N / 4; q += 32) g4[q] = s4[q];
  } else if (lane < n) {
    for (int i = 0; i < n; ++i) g[i * n + lane] = sm[i * N + lane];
  }
}

// ---- compile-time widths: rows in registers ---------------------------------

// Factor the N x N SPD matrix whose lower triangle lane r holds, row r, in
// a[] (zeros above the diagonal; lanes >= N all zeros), right-looking.  On
// return a[c] = L_rc for c <= r (the entries above the diagonal hold what
// the masked update left there), dv = 1 / L_rr on lane r < N, and the
// result says whether a pivot was not positive or NaN (uniform across the
// matrix's lanes).  COL: also gather lcol[i] = L_ir for i > r (zeros
// elsewhere) from the column broadcasts, so that lane r holds column r of L
// as well.  W: the lanes of the matrix (32, or 16: two matrices a warp,
// `lane` the lane within its half).
template <int N, bool COL, int W = 32>
__device__ __forceinline__ bool factor_rows(float (&a)[N], float (&lcol)[N],
                                            float& dv, int lane) {
  float s = __shfl_sync(FULL, a[0], 0, W);   // column 0's pivot
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
      s = __shfl_sync(FULL, fmaf(-l, l, a[j + 1]), j + 1, W);
#pragma unroll
    for (int c = j + 1; c < N; ++c) {
      const float lc = __shfl_sync(FULL, lu, c, W);   // L_cj
      a[c] = fmaf(-lu, lc, a[c]);
      if (COL && lane == j) lcol[c] = lc;
    }
  }
  return bad;
}

// lane r < N's row of the N x N matrix staged in sm (row stride N): its
// lower triangle, zeros above; lanes >= N zeros
template <int N>
__device__ __forceinline__ void load_rows(float (&a)[N], const float* sm,
                                          int lane) {
  const int r = lane < N ? lane : N - 1;   // an address inside sm
#pragma unroll
  for (int c = 0; c < N; ++c)
    a[c] = (c <= lane && lane < N) ? sm[r * N + c] : 0.0f;
}

template <int N>
__global__ void __launch_bounds__(32)
    spd_factor_kernel(const float* __restrict__ H, float* __restrict__ L,
                      float* __restrict__ dinv, int n, bool vec) {
  __shared__ __align__(16) float sm[N * N];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  stage<N>(sm, H + b * n * n, n, vec, lane);
  cp_wait_all();
  __syncwarp();

  float a[N], no_col[N];                   // no column wanted here
  load_rows<N>(a, sm, lane);
  float dv = 0.0f;                         // 1 / L_rr on lane r
  const bool bad = factor_rows<N, false>(a, no_col, dv, lane);

  const float nan = __int_as_float(0x7fc00000);
  __syncwarp();                            // every lane has read sm
  if (lane < N) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      sm[lane * N + c] = bad ? nan : (c <= lane ? a[c] : 0.0f);
  }
  __syncwarp();
  unstage<N>(L + b * n * n, sm, n, vec, lane);
  if (lane < n) dinv[b * n + lane] = bad ? nan : dv;
}

// X = (L L')^-1 rhs for k < COLS_MIN_K: lanes over rows.  Lane r holds
// row r of L (strictly lower) and column r (strictly below the diagonal);
// lanes >= N hold zeros.
template <int N>
__global__ void __launch_bounds__(32)
    spd_sub_rows_kernel(const float* __restrict__ L,
                        const float* __restrict__ dinv,
                        const float* __restrict__ rhs, float* __restrict__ X,
                        int n, int k, bool vec) {
  __shared__ __align__(16) float sm[N * N];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  stage<N>(sm, L + b * n * n, n, vec, lane);
  const float dvr = lane < n ? dinv[b * n + lane] : 1.0f;   // 1 beyond n
  const float* rb = rhs + b * n * k;
  float* xb = X + b * n * k;
  float v = lane < n ? rb[lane * k] : 0.0f;   // column 0, during the copy
  cp_wait_all();
  __syncwarp();
  const int r = lane < N ? lane : N - 1;      // an address inside sm
  float lrow[N], lcol[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lrow[i] = (i < lane && lane < N) ? sm[r * N + i] : 0.0f;
    lcol[i] = i > lane ? sm[i * N + r] : 0.0f;
  }
  for (int c = 0;;) {
    // L y = b: y_i = v_i dinv_i on lane i, broadcast, the rows below
    // subtract L_ri y_i; lane r's v stops changing after step r
#pragma unroll
    for (int i = 0; i < N; ++i)
      v = fmaf(-lrow[i], __shfl_sync(FULL, v * dvr, i), v);
    // L' x = y, from the last row up
    float w = v * dvr;
#pragma unroll
    for (int i = N - 1; i >= 0; --i)
      w = fmaf(-lcol[i], __shfl_sync(FULL, w * dvr, i), w);
    if (lane < n) xb[lane * k + c] = w * dvr;
    if (++c == k) break;
    v = lane < n ? rb[lane * k + c] : 0.0f;
  }
}

// The same for k >= COLS_MIN_K: lanes over the right-hand sides, 32 at a
// time, right-looking, L and dinv read by broadcast.
template <int N>
__global__ void __launch_bounds__(32)
    spd_sub_cols_kernel(const float* __restrict__ L,
                        const float* __restrict__ dinv,
                        const float* __restrict__ rhs, float* __restrict__ X,
                        int n, int k, bool vec) {
  __shared__ __align__(16) float sm[N * N + N];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  stage<N>(sm, L + b * n * n, n, vec, lane);
  if (lane < N) sm[N * N + lane] = lane < n ? dinv[b * n + lane] : 1.0f;
  // volatile: each step's loads are issued in program order, ahead of its
  // FMAs; the compiler neither reuses the forward pass's loads in the back
  // substitution nor hoists them all (either keeps ~N^2 / 2 values live
  // and spills)
  const volatile float* l = sm;
  const volatile float* dv = sm + N * N;
  const float* rb = rhs + b * n * k;
  float* xb = X + b * n * k;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < k;
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = (on && i < n) ? rb[i * k + c] : 0.0f;
    cp_wait_all();                         // L staged (once, in group 0)
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) {          // L y = b
      x[i] *= dv[i];
#pragma unroll
      for (int t = i + 1; t < N; ++t) x[t] = fmaf(-l[t * N + i], x[i], x[t]);
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {     // L' x = y
      x[i] *= dv[i];
#pragma unroll
      for (int t = 0; t < i; ++t) x[t] = fmaf(-l[i * N + t], x[i], x[t]);
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < n) xb[i * k + c] = x[i];
    }
  }
}

// a value the compiler cannot see through: what is computed from it is
// computed after this point (each substitution step's shuffles are issued
// in their step, not hoisted all together, and the back substitution's are
// not merged with the forward pass's: either keeps ~N^2 / 2 values live)
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// M X = rhs in one pass, compile-time width N >= n (the identity beyond n),
// W lanes a matrix (32, or 16: two matrices a warp): the factor as
// spd_factor_kernel's, then the substitution from the factor's registers,
// L never written back.
//   COLS false (k < COLS_MIN_K): lane r holds row r and column r of L (the
//     column gathered during the factor), as spd_sub_rows_kernel; each step
//     is one shuffle and one FMA, the right-hand sides one after another.
//   COLS true: lane c holds right-hand side c (W at a time); each L_ti
//     comes from lane t's register i by a shuffle, independent of X.
// A pivot that is not positive, or NaN, makes all of the matrix's X NaN
// (the substitution still runs: the warp's shuffles take every lane).
template <int N, bool COLS, int W>
__global__ void __launch_bounds__(32)
    spd_solve_kernel(const float* __restrict__ M,
                     const float* __restrict__ rhs, float* __restrict__ X,
                     int B, int n, int k, bool vec) {
  static_assert(W == 32 || (W == 16 && N <= 16), "a row a lane");
  constexpr int PER = 32 / W;              // matrices a warp
  __shared__ __align__(16) float sm[PER][N * N];
  const int lane = threadIdx.x % W, seg = threadIdx.x / W;
  const size_t bw = (size_t)blockIdx.x * PER + seg;
  const bool live = bw < (size_t)B;        // a last half past B computes
  const size_t b = live ? bw : 0;          // matrix 0 and writes nothing
  const float* rb = rhs + b * n * k;
  float* xb = X + b * n * k;
  stage<N, W>(sm[seg], M + b * n * n, n, vec, lane);
  // the first right-hand side(s) during the copy
  float x[COLS ? N : 1];
  if (COLS) {
    const bool on = lane < k;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = (on && i < n) ? rb[i * k + lane] : 0.0f;
  } else {
    x[0] = lane < n ? rb[lane * k] : 0.0f;
  }
  cp_wait_all();
  __syncwarp();

  float a[N], lcol[N];
  load_rows<N>(a, sm[seg], lane);
#pragma unroll
  for (int i = 0; i < N; ++i) lcol[i] = 0.0f;
  float dv = 1.0f;                         // 1 / L_rr on lane r < N
  const bool bad = factor_rows<N, !COLS, W>(a, lcol, dv, lane);
  const float nan = __int_as_float(0x7fc00000);

  if (!COLS) {
    float lrow[N];                         // L_ri for i < r, zeros after
#pragma unroll
    for (int i = 0; i < N; ++i) lrow[i] = i < lane ? a[i] : 0.0f;
    float v = x[0];
    for (int c = 0;;) {
      // L y = b: y_i = v_i dinv_i on lane i, broadcast, the rows below
      // subtract L_ri y_i
#pragma unroll
      for (int i = 0; i < N; ++i)
        v = fmaf(-lrow[i], __shfl_sync(FULL, v * dv, i, W), v);
      // L' x = y, from the last row up
      float w = v * dv;
#pragma unroll
      for (int i = N - 1; i >= 0; --i)
        w = fmaf(-lcol[i], __shfl_sync(FULL, w * dv, i, W), w);
      if (live && lane < n) xb[lane * k + c] = bad ? nan : w * dv;
      if (++c == k) break;
      v = lane < n ? rb[lane * k + c] : 0.0f;
    }
    return;
  }

  float di[N];                             // 1 / L_ii, on every lane
#pragma unroll
  for (int i = 0; i < N; ++i) di[i] = __shfl_sync(FULL, dv, i, W);
  for (int c0 = 0;;) {
    const int c = c0 + lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {          // L y = b, right-looking
      x[i] *= di[i];
      const float ai = __int_as_float(opaque(__float_as_int(a[i])));
#pragma unroll
      for (int t = i + 1; t < N; ++t)      // L_ti
        x[t] = fmaf(-__shfl_sync(FULL, ai, t, W), x[i], x[t]);
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {     // L' x = y
      x[i] *= di[i];
      const int src = opaque(i);
#pragma unroll
      for (int t = 0; t < i; ++t)          // L_it
        x[t] = fmaf(-__shfl_sync(FULL, a[t], src, W), x[i], x[t]);
    }
    if (live && c < k) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < n) xb[i * k + c] = bad ? nan : x[i];
    }
    c0 += W;
    if (c0 >= k) break;
    const bool on = c0 + lane < k;
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = (on && i < n) ? rb[i * k + c0 + lane] : 0.0f;
  }
}

// ---- runtime n (the wide bodies and the factor-and-solve) -------------------

__host__ __device__ int row_stride(int n) { return n | 1; }

int warps_for(size_t per_warp_bytes) {
  int w = (int)(SMEM_BUDGET / per_warp_bytes);
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
}

size_t factor_smem(int n) {
  return (size_t)(n * row_stride(n) + 2 * n) * sizeof(float);
}

size_t sub_smem(int n) {
  return (size_t)(n * row_stride(n) + n + n * 32) * sizeof(float);
}

size_t solve_smem(int n) {
  return (size_t)(n * row_stride(n) + 2 * n + n * 32) * sizeof(float);
}

// copy one row-major n x n matrix into shared memory with row stride ld
__device__ void load_matrix(float* dst, const float* __restrict__ src, int n,
                            int ld, int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    dst[i * ld + j] = src[e];
  }
}

// Factor the n x n matrix in `a` (row stride ld) in place: its strict lower
// triangle becomes L's, ldiag[j] = L_jj, dv[j] = 1 / L_jj.  Left-looking,
// lanes over rows, one __syncwarp a column.  Returns whether a pivot was
// not positive (uniform across the warp).
__device__ bool factor_in_place(float* a, float* ldiag, float* dv, int n,
                                int ld, int lane) {
  bool bad = false;
  for (int j = 0; j < n; ++j) {
    const float* rj = a + j * ld;
    float s = rj[j];
    for (int t = 0; t < j; ++t) s -= rj[t] * rj[t];
    const float d = rsqrtf(s);
    bad |= !(s > 0.0f);               // uniform: every lane has the same s
    for (int i = j + 1 + lane; i < n; i += 32) {
      float* ri = a + i * ld;
      float v = ri[j];
      for (int t = 0; t < j; ++t) v -= ri[t] * rj[t];
      ri[j] = v * d;
    }
    if (lane == 0) {
      ldiag[j] = s * d;
      dv[j] = d;
    }
    __syncwarp();
  }
  return bad;
}

// X = (L L')^-1 rhs for k >= COLS_MIN_K: lanes over the right-hand sides.
// l: L's strict lower triangle (row stride ld), dv: 1 / diag(L), x: an
// (n, 32) shared buffer.
__device__ void sub_cols(const float* l, const float* dv, int n, int ld,
                         const float* __restrict__ rb, float* __restrict__ xb,
                         int k, float* x, int lane) {
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < k;
    for (int i = 0; i < n; ++i) x[i * 32 + lane] = on ? rb[i * k + c] : 0.0f;
    for (int i = 0; i < n; ++i) {            // L y = b
      const float* li = l + i * ld;
      float v = x[i * 32 + lane];
      for (int t = 0; t < i; ++t) v -= li[t] * x[t * 32 + lane];
      x[i * 32 + lane] = v * dv[i];
    }
    for (int i = n - 1; i >= 0; --i) {       // L' x = y
      float v = x[i * 32 + lane];
      for (int t = i + 1; t < n; ++t) v -= l[t * ld + i] * x[t * 32 + lane];
      x[i * 32 + lane] = v * dv[i];
    }
    if (on)
      for (int i = 0; i < n; ++i) xb[i * k + c] = x[i * 32 + lane];
  }
}

// The same for k < COLS_MIN_K: lanes over rows (row r in register r / 32 of
// lane r % 32), right-looking, columns in turn.
__device__ void sub_rows(const float* l, const float* dv, int n, int ld,
                         const float* __restrict__ rb, float* __restrict__ xb,
                         int k, int lane) {
  const int r0 = lane, r1 = lane + 32;         // this lane's rows
  for (int c = 0; c < k; ++c) {
    float y0 = r0 < n ? rb[r0 * k + c] : 0.0f;
    float y1 = r1 < n ? rb[r1 * k + c] : 0.0f;
    for (int i = 0; i < n; ++i) {              // L y = b, right-looking
      const float own = (i < 32) ? y0 : y1;
      const float yi = __shfl_sync(FULL, own, i & 31) * dv[i];
      if (r0 == i) y0 = yi;
      else if (r0 > i && r0 < n) y0 -= l[r0 * ld + i] * yi;
      if (r1 == i) y1 = yi;
      else if (r1 > i && r1 < n) y1 -= l[r1 * ld + i] * yi;
    }
    for (int i = n - 1; i >= 0; --i) {         // L' x = y, right-looking
      const float own = (i < 32) ? y0 : y1;
      const float xi = __shfl_sync(FULL, own, i & 31) * dv[i];
      const float* li = l + i * ld;
      if (r0 == i) y0 = xi;
      else if (r0 < i) y0 -= li[r0] * xi;
      if (r1 == i) y1 = xi;
      else if (r1 < i) y1 -= li[r1] * xi;
    }
    if (r0 < n) xb[r0 * k + c] = y0;
    if (r1 < n) xb[r1 * k + c] = y1;
  }
}

__global__ void spd_factor_wide_kernel(const float* __restrict__ H,
                                       float* __restrict__ L,
                                       float* __restrict__ dinv, int B, int n,
                                       int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;                 // whole warps only; no block barrier
  const int ld = row_stride(n);
  float* a = smem + (size_t)warp * (n * ld + 2 * n);
  float* ldiag = a + n * ld;          // L_jj
  float* dv = ldiag + n;              // 1 / L_jj
  load_matrix(a, H + (size_t)b * n * n, n, ld, lane);
  __syncwarp();
  const bool bad = factor_in_place(a, ldiag, dv, n, ld, lane);

  const float nan = __int_as_float(0x7fc00000);
  float* Lb = L + (size_t)b * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    const float v = j < i ? a[i * ld + j] : (j == i ? ldiag[i] : 0.0f);
    Lb[e] = bad ? nan : v;
  }
  for (int i = lane; i < n; i += 32) dinv[(size_t)b * n + i] = bad ? nan : dv[i];
}

__global__ void spd_sub_wide_kernel(const float* __restrict__ L,
                                    const float* __restrict__ dinv,
                                    const float* __restrict__ rhs,
                                    float* __restrict__ X, int B, int n, int k,
                                    int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;
  const int ld = row_stride(n);
  float* l = smem + (size_t)warp * (n * ld + n + n * 32);
  float* dv = l + n * ld;
  float* x = dv + n;                  // (n, 32): column of lane c at x[i*32+c]
  load_matrix(l, L + (size_t)b * n * n, n, ld, lane);
  for (int i = lane; i < n; i += 32) dv[i] = dinv[(size_t)b * n + i];
  __syncwarp();
  const float* rb = rhs + (size_t)b * n * k;
  float* xb = X + (size_t)b * n * k;
  if (k >= COLS_MIN_K) sub_cols(l, dv, n, ld, rb, xb, k, x, lane);
  else sub_rows(l, dv, n, ld, rb, xb, k, lane);
}

__global__ void spd_solve_wide_kernel(const float* __restrict__ M,
                                      const float* __restrict__ rhs,
                                      float* __restrict__ X, int B, int n,
                                      int k, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;
  const int ld = row_stride(n);
  float* a = smem + (size_t)warp * (n * ld + 2 * n + n * 32);
  float* ldiag = a + n * ld;
  float* dv = ldiag + n;
  float* x = dv + n;
  load_matrix(a, M + (size_t)b * n * n, n, ld, lane);
  __syncwarp();
  const bool bad = factor_in_place(a, ldiag, dv, n, ld, lane);
  const float* rb = rhs + (size_t)b * n * k;
  float* xb = X + (size_t)b * n * k;
  if (bad) {
    const float nan = __int_as_float(0x7fc00000);
    for (int e = lane; e < n * k; e += 32) xb[e] = nan;
    return;
  }
  if (k >= COLS_MIN_K) sub_cols(a, dv, n, ld, rb, xb, k, x, lane);
  else sub_rows(a, dv, n, ld, rb, xb, k, lane);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// one matrix a block at a compile-time width N >= n; the 16-byte staging
// where the matrix is N x N and its buffers are 16-byte aligned
template <int N>
void factor_launch(const float* H, float* L, float* dinv, int B, int n,
                   cudaStream_t st) {
  const bool vec = n == N && aligned16(H) && aligned16(L);
  spd_factor_kernel<N><<<B, 32, 0, st>>>(H, L, dinv, n, vec);
}

template <int N>
void sub_launch(const float* L, const float* dinv, const float* rhs, float* X,
                int B, int n, int k, cudaStream_t st) {
  const bool vec = n == N && aligned16(L);
  if (k < COLS_MIN_K)
    spd_sub_rows_kernel<N><<<B, 32, 0, st>>>(L, dinv, rhs, X, n, k, vec);
  else
    spd_sub_cols_kernel<N><<<B, 32, 0, st>>>(L, dinv, rhs, X, n, k, vec);
}

template <int N, int W = 32>
void solve_launch(const float* M, const float* rhs, float* X, int B, int n,
                  int k, cudaStream_t st) {
  const bool vec = n == N && aligned16(M);
  const int grid = (B + 32 / W - 1) / (32 / W);
  if (k < COLS_MIN_K)
    spd_solve_kernel<N, false, W><<<grid, 32, 0, st>>>(M, rhs, X, B, n, k,
                                                       vec);
  else
    spd_solve_kernel<N, true, W><<<grid, 32, 0, st>>>(M, rhs, X, B, n, k,
                                                      vec);
}

}  // namespace

extern "C" {

// Largest n the kernels take; the wrapper raises above it.
int spd_chol_max_n() { return N_MAX; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int spd_factor_launch(const float* H, float* L, float* dinv, int B, int n,
                      void* stream) {
  if (B < 1 || n < 1 || n > N_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= N_SMALL) {
    factor_launch<N_SMALL>(H, L, dinv, B, n, st);
  } else if (n <= N_LARGE) {
    factor_launch<N_LARGE>(H, L, dinv, B, n, st);
  } else {
    const size_t per = factor_smem(n);
    const int warps = warps_for(per);
    const int grid = (B + warps - 1) / warps;
    spd_factor_wide_kernel<<<grid, 32 * warps, warps * per, st>>>(
        H, L, dinv, B, n, warps);
  }
  return (int)cudaGetLastError();
}

int spd_sub_launch(const float* L, const float* dinv, const float* rhs,
                   float* X, int B, int n, int k, void* stream) {
  if (B < 1 || n < 1 || n > N_MAX || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= N_SMALL) {
    sub_launch<N_SMALL>(L, dinv, rhs, X, B, n, k, st);
  } else if (n <= N_LARGE) {
    sub_launch<N_LARGE>(L, dinv, rhs, X, B, n, k, st);
  } else {
    const size_t per = sub_smem(n);
    const int warps = warps_for(per);
    const int grid = (B + warps - 1) / warps;
    spd_sub_wide_kernel<<<grid, 32 * warps, warps * per, st>>>(
        L, dinv, rhs, X, B, n, k, warps);
  }
  return (int)cudaGetLastError();
}

int spd_solve_launch(const float* M, const float* rhs, float* X, int B, int n,
                     int k, void* stream) {
  if (B < 1 || n < 1 || n > N_MAX || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= N_SOLVE) {   // two matrices a warp: a row a lane fits in 16
    solve_launch<N_SOLVE, 16>(M, rhs, X, B, n, k, st);
  } else if (n <= N_SMALL) {
    solve_launch<N_SMALL>(M, rhs, X, B, n, k, st);
  } else if (n <= N_LARGE) {
    solve_launch<N_LARGE>(M, rhs, X, B, n, k, st);
  } else {
    const size_t per = solve_smem(n);
    const int warps = warps_for(per);
    const int grid = (B + warps - 1) / warps;
    spd_solve_wide_kernel<<<grid, 32 * warps, warps * per, st>>>(
        M, rhs, X, B, n, k, warps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
