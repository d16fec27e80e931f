// Batched SPD Cholesky factor, substitution, and factor-and-solve: three
// CUDA kernels.
//
// Replaces the TPU kernels apf_quadruped_tpu/ops/pallas_chol.py::_factor_kernel
// (reached through chol_factor_blocked) and ::_sub_kernel (through
// chol_sub_blocked), which the JAX package routes its batched spd_factor /
// spd_solve through, and ::_chol_solve_kernel (through chol_solve_blocked),
// which its scan Riccati IPM calls for every 12 x 12 solve under
// SolverConfig.use_pallas.  On the closed loop's path the first two factor
// the WBC QP's H = P + G' W G and its Schur complement S_eq (n = 30) twice
// per IPM iteration and the physics substep's 18 x 18 mass matrix, and
// substitute one right-hand side (k = 1, the Newton vectors and the
// mass-matrix solve) or thirty (k = 30, H^-1 A').  The third factors
// M_k = R_k + B' P B (n = 12) and solves k = 13 right-hand sides (the gains
// K_k) or one (the feed-forward kff_k) in the same launch, per knot.
//
//   factor: H (B, n, n) SPD -> L (B, n, n) lower-triangular with exact zeros
//           above the diagonal, dinv (B, n) = 1 / diag(L).  Column by column,
//           as the TPU kernel: s = H_jj - sum_t L_jt^2, d = rsqrt(s),
//           L_jj = s d, L_ij = (H_ij - sum_t L_it L_jt) d.  A pivot that is
//           not positive (or NaN) makes the whole matrix and dinv NaN, as
//           the plain version (cholesky_ex + NaN fill) returns it: the QP's
//           lane quarantine depends on the NaN.  Never a clamp.
//   sub:    L, dinv, rhs (B, n, k) -> X (B, n, k) with L L' X = rhs: forward
//           substitution, then back substitution, both scaled by dinv.
//   solve:  M (B, n, n) SPD, rhs (B, n, k) -> X (B, n, k) with M X = rhs: the
//           factor, then the substitution, on the factor in shared memory;
//           all of X NaN where M is not positive definite (the TPU kernel's
//           rsqrt of a non-positive pivot, as the plain version returns it).
//
// Design.  The TPU put 128 scenarios on the vector lanes and unrolled the
// n^3 recurrence at trace time; here one warp owns one matrix, held in
// shared memory, so a batch of 64 still gives 64 warps of 32 threads.  The
// three kernels share one factor body and two substitution bodies.
//   * factor: lanes over rows.  Per column every lane forms the pivot from
//     broadcast reads; the lane of each row below it forms that row's dot
//     product (left-looking, the TPU kernel's summation order); one
//     __syncwarp per column.
//   * sub, k >= COLS_MIN_K: lanes over the right-hand sides, each lane runs
//     both substitutions of its column with L read by broadcast.
//   * sub, k < COLS_MIN_K: lanes over rows (row r in register r / 32 of lane
//     r % 32), right-looking: the finished y_i / x_i is broadcast with one
//     shuffle and every lane updates its rows; columns in turn.
// The row stride in shared memory is odd, so lanes reading one column of L
// hit distinct banks.
//
// What bounds it on the H100: latency.  A 30 x 30 factor is ~4.5k FMAs,
// run as 30 dependent columns of <= 30 FMAs a lane; a k = 1 substitution is
// 60 dependent shuffle-and-FMA steps.  At the loop's batch (64) the card is
// nearly empty and a launch costs more than the work; what would help is
// fewer launches (the whole WBC QP in one resident kernel, or a CUDA graph
// of a tick), not a faster factor.  The same holds for solve: under
// use_pallas the scan IPM launches it once per knot per pass (60 launches
// an iteration at H = 20) on ~1k FMAs of work each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_MAX = 64;        // two rows a lane in the row-parallel paths
constexpr int COLS_MIN_K = 8;    // sub: lanes over columns from this k on
constexpr int MAX_WARPS = 4;     // matrices per block
constexpr int SMEM_BUDGET = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

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
// triangle becomes L's, ldiag[j] = L_jj, dv[j] = 1 / L_jj.  Returns whether
// a pivot was not positive (uniform across the warp).
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

__global__ void spd_factor_kernel(const float* __restrict__ H,
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

__global__ void spd_sub_kernel(const float* __restrict__ L,
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

__global__ void spd_solve_kernel(const float* __restrict__ M,
                                 const float* __restrict__ rhs,
                                 float* __restrict__ X, int B, int n, int k,
                                 int warps) {
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

}  // namespace

extern "C" {

// Largest n the kernels take; the wrapper raises above it.
int spd_chol_max_n() { return N_MAX; }

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int spd_factor_launch(const float* H, float* L, float* dinv, int B, int n,
                      void* stream) {
  if (B < 1 || n < 1 || n > N_MAX) return (int)cudaErrorInvalidValue;
  const size_t per = factor_smem(n);
  const int warps = warps_for(per);
  const int grid = (B + warps - 1) / warps;
  spd_factor_kernel<<<grid, 32 * warps, warps * per,
                      (cudaStream_t)stream>>>(H, L, dinv, B, n, warps);
  return (int)cudaGetLastError();
}

int spd_sub_launch(const float* L, const float* dinv, const float* rhs,
                   float* X, int B, int n, int k, void* stream) {
  if (B < 1 || n < 1 || n > N_MAX || k < 1) return (int)cudaErrorInvalidValue;
  const size_t per = sub_smem(n);
  const int warps = warps_for(per);
  const int grid = (B + warps - 1) / warps;
  spd_sub_kernel<<<grid, 32 * warps, warps * per, (cudaStream_t)stream>>>(
      L, dinv, rhs, X, B, n, k, warps);
  return (int)cudaGetLastError();
}

int spd_solve_launch(const float* M, const float* rhs, float* X, int B, int n,
                     int k, void* stream) {
  if (B < 1 || n < 1 || n > N_MAX || k < 1) return (int)cudaErrorInvalidValue;
  const size_t per = solve_smem(n);
  const int warps = warps_for(per);
  const int grid = (B + warps - 1) / warps;
  spd_solve_kernel<<<grid, 32 * warps, warps * per, (cudaStream_t)stream>>>(
      M, rhs, X, B, n, k, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
