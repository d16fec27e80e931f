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
//               kff_k = M_k^-1 g, sv <- A_k' sv - K_k' g (kff is stashed in the
//               du output, as on the TPU); forward du_k = -K_k dx - kff_k,
//               gdu_k = G du_k, dx <- A_k dx + B_k du_k.  Twice an iteration
//               (predictor and corrector).
// Arrays are batch-first and contiguous per scenario: A (B, H, nx, nx),
// Bm (B, H, nx, nu), vectors (B, H, rows), L (B, H, nu, nu), K (B, H, nu, nx);
// G (m, nu), R (nu, nu), Q (nx, nx) are shared by the batch.
//
// Design: one warp per scenario, four scenarios a block, as in
// resident_ipm.cu, whose per-knot algebra these kernels repeat (they keep
// their own copy, so that the resident kernel's code and registers stay as
// they are).  The horizon is a loop inside the warp (the TPU's sequential
// fori_loop); the knot's A_k and B_k are read from device memory into
// shared memory once per knot, coalesced, and the 32 lanes share the
// entries of the small products.  The rollout keeps its x_k history in
// shared memory for the backward sweep (H * nx floats a warp); the factor
// pass keeps P in shared memory across the knots and factors M_k there; L,
// 1 / diag(L) and K go to device memory because the vector pass reads them.
// A matrix that is not positive definite makes that knot's L, dinv and K
// NaN, and with them every earlier knot, as the plain version
// (cholesky_ex with a NaN fill) does: the interior point quarantines the
// lane.
//
// What bounds them on the H100: on the TPU these passes were bound by the
// device-memory traffic between the kernels (L, D and K make a round trip
// every iteration).  At B = 2048, H = 20 each pass moves 70-120 MB
// (20-35 us at 3.35 TB/s, which sets their bound: the operations take
// less), but runs H dependent knots of ~0.1-1k dependent warp steps each,
// so the latency of that serial chain sets their time, as in the resident
// kernel.  The design keeps every knot's working set in shared
// memory and reads each device array once per pass; what would help is the
// resident kernel's fusion of the passes (L/D/K never leave the SM).
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
// Riccati factor pass
// ---------------------------------------------------------------------------

struct FactorSmem {
  float A[NX_MAX * NX_MAX], Bm[NX_MAX * NU_MAX];
  float P[NX_MAX * NX_MAX], BtP[NU_MAX * NX_MAX], M[NU_MAX * NU_MAX];
  float BtPA[NU_MAX * NX_MAX], AtP[NX_MAX * NX_MAX], K[NU_MAX * NX_MAX];
  float dinv[NU_MAX], w[M_MAX];
};

__global__ void __launch_bounds__(WARPS * 32)
    factor_kernel(const float* G, const float* R, const float* Q,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ W, float* __restrict__ L,
                  float* __restrict__ dinv, float* __restrict__ K, Dims d) {
  __shared__ Consts c;
  __shared__ FactorSmem smem[WARPS];
  load_consts(c, G, R, Q, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  FactorSmem& S = smem[warp];
  const size_t bH = (size_t)b * H;
  const float nan = __int_as_float(0x7fc00000);

  for (int e = lane; e < nx * nx; e += 32) S.P[e] = c.Q[e];
  bool bad = false;   // uniform: a NaN factor poisons every earlier knot
  for (int k = H - 1; k >= 0; --k) {
    __syncwarp();
    copy(S.A, A + (bH + k) * nx * nx, nx * nx, lane);
    copy(S.Bm, Bm + (bH + k) * nx * nu, nx * nu, lane);
    copy(S.w, W + (bH + k) * m, m, lane);
    __syncwarp();
    for (int e = lane; e < nu * nx; e += 32) {    // B'P
      const int j = e / nx, l = e % nx;
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc += S.Bm[i * nu + j] * S.P[i * nx + l];
      S.BtP[e] = acc;
    }
    for (int e = lane; e < nx * nx; e += 32) {    // A'P
      const int i = e / nx, l = e % nx;
      float acc = 0.f;
      for (int t = 0; t < nx; ++t) acc += S.A[t * nx + i] * S.P[t * nx + l];
      S.AtP[e] = acc;
    }
    __syncwarp();
    // M = R + G' diag(w) G + B'P B, lower triangle
    for (int e = lane; e < nu * nu; e += 32) {
      const int i = e / nu, j = e % nu;
      if (j > i) continue;
      float acc = c.R[e];
      for (int r = 0; r < m; ++r) acc += c.G[r * nu + i] * S.w[r] * c.G[r * nu + j];
      for (int l = 0; l < nx; ++l) acc += S.BtP[i * nx + l] * S.Bm[l * nu + j];
      S.M[e] = acc;
    }
    for (int e = lane; e < nu * nx; e += 32) {    // B'PA
      const int j = e / nx, l = e % nx;
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc += S.BtP[j * nx + i] * S.A[i * nx + l];
      S.BtPA[e] = acc;
    }
    // Cholesky of M, right-looking, in place
    for (int j = 0; j < nu; ++j) {
      __syncwarp();
      const float dj = S.M[j * nu + j];
      bad |= !(dj > 0.f);
      const float lj = sqrtf(dj);
      const float di = 1.f / lj;
      __syncwarp();
      if (lane == j) {
        S.M[j * nu + j] = lj;
        S.dinv[j] = di;
      } else if (lane > j && lane < nu) {
        S.M[lane * nu + j] *= di;
      }
      __syncwarp();
      for (int e = lane; e < nu * nu; e += 32) {
        const int i = e / nu, col = e % nu;
        if (col > j && col <= i) S.M[e] -= S.M[i * nu + j] * S.M[col * nu + j];
      }
    }
    __syncwarp();
    float* Lk = L + (bH + k) * nu * nu;
    for (int e = lane; e < nu * nu; e += 32) {
      const int i = e / nu, j = e % nu;
      Lk[e] = bad ? nan : (j <= i ? S.M[e] : 0.f);
    }
    if (lane < nu) dinv[(bH + k) * nu + lane] = bad ? nan : S.dinv[lane];
    // K = M^-1 B'PA, one column per lane
    if (lane < nx) {
      float col[NU_MAX];
      for (int j = 0; j < nu; ++j) col[j] = S.BtPA[j * nx + lane];
      for (int i = 0; i < nu; ++i) {
        float acc = col[i];
        for (int t = 0; t < i; ++t) acc -= S.M[i * nu + t] * col[t];
        col[i] = acc * S.dinv[i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        float acc = col[i];
        for (int t = i + 1; t < nu; ++t) acc -= S.M[t * nu + i] * col[t];
        col[i] = acc * S.dinv[i];
      }
      for (int j = 0; j < nu; ++j) S.K[j * nx + lane] = bad ? nan : col[j];
    }
    __syncwarp();
    for (int e = lane; e < nu * nx; e += 32) K[(bH + k) * nu * nx + e] = S.K[e];
    // P <- sym(Q + A'P A - K' B'PA)
    for (int e = lane; e < nx * nx; e += 32) {
      const int i = e / nx, l = e % nx;
      float acc = c.Q[e];
      for (int t = 0; t < nx; ++t) acc += S.AtP[i * nx + t] * S.A[t * nx + l];
      for (int j = 0; j < nu; ++j) acc -= S.K[j * nx + i] * S.BtPA[j * nx + l];
      S.P[e] = acc;
    }
    __syncwarp();
    for (int e = lane; e < nx * nx; e += 32) {
      const int i = e / nx, l = e % nx;
      if (l < i) {
        const float v = 0.5f * (S.P[e] + S.P[l * nx + i]);
        S.P[e] = v;
        S.P[l * nx + i] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// vector (affine LQR) pass against the stored factors
// ---------------------------------------------------------------------------

struct VectorSmem {
  float A[NX_MAX * NX_MAX], Bm[NX_MAX * NU_MAX];
  float L[NU_MAX * NU_MAX], K[NU_MAX * NX_MAX], dinv[NU_MAX];
  float vm[M_MAX], sv[NX_MAX], g[NU_MAX], v[NU_MAX];
};

__global__ void __launch_bounds__(WARPS * 32)
    vector_kernel(const float* G, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ L,
                  const float* __restrict__ dinv, const float* __restrict__ K,
                  const float* __restrict__ rx, const float* __restrict__ vm,
                  float* __restrict__ du, float* __restrict__ gdu, Dims d) {
  __shared__ Consts c;
  __shared__ VectorSmem smem[WARPS];
  load_consts(c, G, nullptr, nullptr, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= d.B) return;
  const int H = d.H, nx = d.nx, nu = d.nu, m = d.m;
  VectorSmem& S = smem[warp];
  const size_t bH = (size_t)b * H;

  // backward: kff_k into du (the forward pass reads it back)
  if (lane < nx) S.sv[lane] = 0.f;
  for (int k = H - 1; k >= 0; --k) {
    __syncwarp();
    copy(S.A, A + (bH + k) * nx * nx, nx * nx, lane);
    copy(S.Bm, Bm + (bH + k) * nx * nu, nx * nu, lane);
    copy(S.L, L + (bH + k) * nu * nu, nu * nu, lane);
    copy(S.K, K + (bH + k) * nu * nx, nu * nx, lane);
    copy(S.dinv, dinv + (bH + k) * nu, nu, lane);
    copy(S.vm, vm + (bH + k) * m, m, lane);
    __syncwarp();
    if (lane < nu) {
      float g = rx[(bH + k) * nu + lane];
      for (int r = 0; r < m; ++r) g += c.G[r * nu + lane] * S.vm[r];
      for (int i = 0; i < nx; ++i) g += S.Bm[i * nu + lane] * S.sv[i];
      S.g[lane] = g;
      S.v[lane] = g;
    }
    // (L L') v = g in place: nu steps of one broadcast and a lane update
    for (int i = 0; i < nu; ++i) {
      __syncwarp();
      const float yi = S.v[i] * S.dinv[i];
      __syncwarp();
      if (lane == i) S.v[i] = yi;
      else if (lane > i && lane < nu) S.v[lane] -= S.L[lane * nu + i] * yi;
    }
    for (int i = nu - 1; i >= 0; --i) {
      __syncwarp();
      const float xi = S.v[i] * S.dinv[i];
      __syncwarp();
      if (lane == i) S.v[i] = xi;
      else if (lane < i) S.v[lane] -= S.L[i * nu + lane] * xi;
    }
    __syncwarp();
    if (lane < nu) du[(bH + k) * nu + lane] = S.v[lane];
    float svn = 0.f;
    if (lane < nx) {
      for (int l = 0; l < nx; ++l) svn += S.A[l * nx + lane] * S.sv[l];
      for (int j = 0; j < nu; ++j) svn -= S.K[j * nx + lane] * S.g[j];
    }
    __syncwarp();
    if (lane < nx) S.sv[lane] = svn;
  }

  // forward: du_k = -K_k dx - kff_k, gdu_k = G du_k; S.sv carries dx,
  // S.v the knot's du
  __syncwarp();
  if (lane < nx) S.sv[lane] = 0.f;
  for (int k = 0; k < H; ++k) {
    __syncwarp();
    copy(S.A, A + (bH + k) * nx * nx, nx * nx, lane);
    copy(S.Bm, Bm + (bH + k) * nx * nu, nx * nu, lane);
    copy(S.K, K + (bH + k) * nu * nx, nu * nx, lane);
    __syncwarp();
    if (lane < nu) {
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc += S.K[lane * nx + i] * S.sv[i];
      const float dv = -acc - du[(bH + k) * nu + lane];   // this lane's kff
      S.v[lane] = dv;
      du[(bH + k) * nu + lane] = dv;
    }
    __syncwarp();
    for (int r = lane; r < m; r += 32) {
      float acc = 0.f;
      for (int j = 0; j < nu; ++j) acc += c.G[r * nu + j] * S.v[j];
      gdu[(bH + k) * m + r] = acc;
    }
    float dxn = 0.f;
    if (lane < nx) {
      for (int l = 0; l < nx; ++l) dxn += S.A[lane * nx + l] * S.sv[l];
      for (int j = 0; j < nu; ++j) dxn += S.Bm[lane * nu + j] * S.v[j];
    }
    __syncwarp();
    if (lane < nx) S.sv[lane] = dxn;
  }
}

bool bad_dims(const Dims& d) {
  return d.B < 1 || d.H < 1 || d.nx < 1 || d.nx > NX_MAX || d.nu < 1 ||
         d.nu > NU_MAX || d.m < 1 || d.m > M_MAX;
}

int blocks(const Dims& d) { return (d.B + WARPS - 1) / WARPS; }

}  // namespace

extern "C" {

// Dimension limits compiled into the kernels; the wrappers raise above them.
void fused_riccati_limits(int* nx_max, int* nu_max, int* m_max,
                          int* h_max_rollout) {
  *nx_max = NX_MAX;
  *nu_max = NU_MAX;
  *m_max = M_MAX;
  *h_max_rollout = (int)(DYN_MAX / (WARPS * NX_MAX * sizeof(float)));
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
  factor_kernel<<<blocks(d), WARPS * 32, 0, (cudaStream_t)stream>>>(
      G, R, Q, A, Bm, W, L, dinv, K, d);
  return (int)cudaGetLastError();
}

int fused_vector_launch(const float* G, const float* A, const float* Bm,
                        const float* L, const float* dinv, const float* K,
                        const float* rx, const float* vm, float* du,
                        float* gdu, int B, int H, int nx, int nu, int m,
                        void* stream) {
  const Dims d{B, H, nx, nu, m};
  if (bad_dims(d)) return (int)cudaErrorInvalidValue;
  vector_kernel<<<blocks(d), WARPS * 32, 0, (cudaStream_t)stream>>>(
      G, A, Bm, L, dinv, K, rx, vm, du, gdu, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
