// Resident Riccati interior point for batched stage QPs, one CUDA kernel.
//
// Replaces the TPU kernel apf_quadruped_tpu/ops/pallas_riccati.py::_ipm_kernel
// (reached through _ipm_call and solve_stage_qp_resident).  It runs the whole
// fixed-iteration Mehrotra predictor-corrector of
// apf_quadruped_tpu/ops/riccati.py::solve_stage_qp for a batch of MPC stage QPs
// in one launch: init (cold or per-lane warm), then per iteration the rollout,
// the costate/residual sweep, one backward sweep that builds the barrier
// Hessians R + reg I + G' W G, the 12x12 Cholesky of M_k = R_k + B_k' P B_k,
// the gains K_k, the P update and the predictor's backward vector pass, the
// predictor forward pass, sigma = clamp(mu_aff / mu)^sigma_pow, the corrector
// passes, the fraction-to-boundary step and the update clamped at min_slack.
// Optional rows: state rows Cx x_{k+1} <= cx (mc > 0, base_box) and 12 accel
// rows +-B_k[6:12] u <= acc -+ A_k[6:12,12] (acc != nullptr, base_acc), which
// sit after the input rows exactly as in the scan's layout.
//
// Semantics follow the scan IPM (the port's plain version,
// apf_quadruped_tpu_torch/ops/riccati.py), including its cold init, which
// takes one slack shift over the input and accel rows together.
//
// Design: one warp per scenario.  The Riccati recursion is serial over the
// horizon, so the parallelism inside a scenario is in the per-knot matrix
// algebra: the 32 lanes share the entries of B'P, M_k, B'PA, A'P and the P
// update, the rows of the barrier Gram and of the residuals, the 13 columns
// of K, and the substitutions column by column.  The current knot's A_k,
// B_k, P, M_k (then its Cholesky factor) and K sit in shared memory (~6 KB
// a warp).  Device arrays are batch-major, (B, H, rows), so a warp reads its
// scenario contiguously; the per-knot factors (L packed lower, 1/diag(L),
// K), residuals and step directions live in a scratch buffer the wrapper
// allocates.  A warp whose scenario has converged leaves the iteration
// loop: a converged lane takes a zero step in the scan, so its outputs are
// the same.
//
// What bounds it on the H100: latency of the serial per-knot chain.  A
// scenario's iteration is ~20 knots x ~16k FMAs, of which a warp runs ~1k
// dependent steps per knot with ~25 __syncwarp()s; at B = 2048 there are
// 2048 warps, ~15 per SM, to hide shared-memory and L2 latency.  HBM
// traffic is small (A_k/B_k/factors re-read from L2 each pass) and the FP32
// rate is far from its limit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, without --use_fast_math (approximate division and flush-to-zero
// change the IPM's late iterations).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NX_MAX = 13;
constexpr int NU_MAX = 12;
constexpr int M_MAX = 24;   // input rows per knot
constexpr int MC_MAX = 8;   // state rows per knot
constexpr int MACC = 12;    // accel rows per knot when enabled
constexpr int MT_MAX = M_MAX + MACC;
constexpr int WARPS = 4;    // scenarios per block
constexpr unsigned FULL = 0xffffffffu;

// one warp's shared working set: the current knot's matrices and vectors
struct WarpSmem {
  float A[NX_MAX * NX_MAX], Bm[NX_MAX * NU_MAX];
  float P[NX_MAX * NX_MAX], BtP[NU_MAX * NX_MAX], M[NU_MAX * NU_MAX];
  float BtPA[NU_MAX * NX_MAX], AtP[NX_MAX * NX_MAX], K[NU_MAX * NX_MAX];
  float dinv[NU_MAX];
  float mrow[MT_MAX];   // row masks (accel rows 1)
  float w[MT_MAX];      // barrier weights, or row values of a vector pass
  float zr[MT_MAX];     // z of the knot
  float xv[NX_MAX], lam[NX_MAX], lamk[NX_MAX], sv[NX_MAX];
  float uv[NU_MAX], gu[NU_MAX];
};

// max and min that return a NaN operand, as torch.maximum, torch.clamp and
// amax do (fmaxf and fminf drop it): a poisoned scenario must carry NaN
// into mu and res, so that it never counts as converged and its gap and
// residual come back as inf, as in the scan
__device__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }

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

}  // namespace

extern "C" {

struct IpmArgs {
  // problem data, batch-major (B, ..)
  const float* A;      // (B, H, nx, nx)
  const float* Bm;     // (B, H, nx, nu)
  const float* q;      // (B, H, nx)
  const float* mask;   // (B, H, m)
  const float* h;      // (B, H, m), masked rows already 1
  const float* x0;     // (B, nx)
  const float* G;      // (m, nu)
  const float* R;      // (nu, nu)
  const float* Q;      // (nx, nx)
  // warm start, or all null
  const float* wu;     // (B, H, nu)
  const float* wz;     // (B, H, mt)
  const float* ws;     // (B, H, mt)
  const float* wvalid; // (B,) 1.0 = warm lane
  // state rows, or all null (mc = 0)
  const float* Cx;     // (mc, nx)
  const float* cx;     // (B, H, mc), masked rows already 1
  const float* maskx;  // (B, H, mc)
  // accel-row bounds (6,), or null
  const float* acc;
  // outputs
  float* u;            // (B, H, nu)
  float* x;            // (B, H, nx)
  float* z;            // (B, H, mt)
  float* s;            // (B, H, mt)
  float* zx;           // (B, H, mc)
  float* sx;           // (B, H, mc)
  float* stat;         // (B, 4): converged, iters, mu, res
  float* scratch;      // (B, resident_ipm_scratch_rows(..))
  int B, H, nx, nu, m, mc, iters;
  float reltol, abstol, sigma_pow, frac, w_clip, min_slack, warm_floor, reg;
};

// Floats of scratch per scenario; the wrapper allocates (B, rows).
__host__ __device__ int resident_ipm_scratch_rows(int H, int nx, int nu,
                                              int mt, int mc) {
  int per_knot = nu * (nu + 1) / 2   // L, packed lower
                 + nu                // 1 / diag(L)
                 + nu * nx           // K
                 + nu                // kff
                 + nu                // rx
                 + mt                // rz
                 + nu                // du
                 + 2 * mt            // dz, ds
                 + 3 * mc;           // rzx, dzx, dsx
  return H * per_knot;
}

}  // extern "C"

namespace {

__global__ void __launch_bounds__(WARPS * 32) resident_ipm_kernel(IpmArgs a) {
  __shared__ float sG[M_MAX * NU_MAX];
  __shared__ float sR[NU_MAX * NU_MAX];
  __shared__ float sQ[NX_MAX * NX_MAX];
  __shared__ float sC[MC_MAX * NX_MAX];
  __shared__ float sAcc[6];
  __shared__ WarpSmem smem[WARPS];

  const int B = a.B, H = a.H, nx = a.nx, nu = a.nu, m = a.m, mc = a.mc;
  const bool macc = a.acc != nullptr;
  const bool warm = a.wu != nullptr;
  const int mt = m + (macc ? MACC : 0);
  const int nl = nu * (nu + 1) / 2;
  const float ms = a.min_slack, wclip = a.w_clip;

  for (int i = threadIdx.x; i < m * nu; i += blockDim.x) sG[i] = a.G[i];
  for (int i = threadIdx.x; i < nu * nu; i += blockDim.x) sR[i] = a.R[i];
  for (int i = threadIdx.x; i < nx * nx; i += blockDim.x) sQ[i] = a.Q[i];
  for (int i = threadIdx.x; i < mc * nx; i += blockDim.x) sC[i] = a.Cx[i];
  if (macc && threadIdx.x < 6) sAcc[threadIdx.x] = a.acc[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;   // whole warps only: no block barrier below
  WarpSmem& S = smem[threadIdx.x / 32];

  // knot k of this scenario's (B, H, rows) array, and of a (H, rows)
  // scratch array of this scenario
  auto kn = [&](auto* p, int k, int rows) { return p + ((size_t)b * H + k) * rows; };
  auto ks = [](float* p, int k, int rows) { return p + k * rows; };
  // scratch arrays, in the order of resident_ipm_scratch_rows
  float* sp = a.scratch + (size_t)b * resident_ipm_scratch_rows(H, nx, nu, mt, mc);
  float* L = sp;     sp += H * nl;
  float* dinv = sp;  sp += H * nu;
  float* K = sp;     sp += H * nu * nx;
  float* kff = sp;   sp += H * nu;
  float* rx = sp;    sp += H * nu;
  float* rz = sp;    sp += H * mt;
  float* du = sp;    sp += H * nu;
  float* dz = sp;    sp += H * mt;
  float* ds = sp;    sp += H * mt;
  float* rzx = sp;   sp += H * mc;
  float* dzx = sp;   sp += H * mc;
  float* dsx = sp;

  auto barrier_w = [&](float zv, float sv) {
    return nmin(nmax(nmax(zv, ms) / nmax(sv, ms), 0.f), wclip);
  };
  // A_k, B_k and the row masks of knot k into shared memory
  auto load_knot = [&](int k) {
    __syncwarp();
    const float* Ag = kn(a.A, k, nx * nx);
    const float* Bg = kn(a.Bm, k, nx * nu);
    const float* mg = kn(a.mask, k, m);
    for (int i = lane; i < nx * nx; i += 32) S.A[i] = Ag[i];
    for (int i = lane; i < nx * nu; i += 32) S.Bm[i] = Bg[i];
    for (int r = lane; r < mt; r += 32) S.mrow[r] = r < m ? mg[r] : 1.f;
    __syncwarp();
  };
  // coefficient j of row r at the loaded knot: mask * G[r], then +B[6+d],
  // -B[6+d] for the accel rows
  auto g_at = [&](int r, int j) -> float {
    if (r < m) return S.mrow[r] * sG[r * nu + j];
    const int d = (r - m) % 6;
    const float v = S.Bm[(6 + d) * nu + j];
    return (r - m) < 6 ? v : -v;
  };
  auto row_h = [&](int k, int r) -> float {
    if (r < m) return kn(a.h, k, m)[r];
    const int d = (r - m) % 6;
    const float off = S.A[(6 + d) * nx + 12];
    return (r - m) < 6 ? sAcc[d] - off : sAcc[d] + off;
  };
  // masked state row j, entry i
  auto c_at = [&](int k, int j, int i) {
    return kn(a.maskx, k, mc)[j] * sC[j * nx + i];
  };
  // (row, column) of entry e of a packed lower triangle
  auto tri = [](int e, int& i, int& j) {
    i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    j = e - i * (i + 1) / 2;
  };

  // ---- init ---------------------------------------------------------------
  const bool valid = warm && a.wvalid[b] > 0.5f;
  for (int e = lane; e < H * nu; e += 32)
    a.u[(size_t)b * H * nu + e] = valid ? a.wu[(size_t)b * H * nu + e] : 0.f;
  float qn2 = 0.f, hn2 = 0.f, meff = 0.f, shift = 0.f;
  for (int k = 0; k < H; ++k) {
    load_knot(k);
    for (int i = lane; i < nx; i += 32) {
      const float qv = kn(a.q, k, nx)[i];
      qn2 += qv * qv;
    }
    for (int r = lane; r < mt; r += 32) {
      const float hv = row_h(k, r);
      hn2 += hv * hv;
      meff += S.mrow[r];
      shift = nmax(shift, -hv);
    }
  }
  shift = warp_max(shift) + 1.f;
  for (int k = 0; k < H; ++k) {
    load_knot(k);
    for (int r = lane; r < mt; r += 32) {
      const float hv = row_h(k, r);
      float sv = hv + shift, zv = nmax(-hv, 0.f) + 1.f;
      if (valid) {
        sv = nmax(kn(a.ws, k, mt)[r], a.warm_floor);
        zv = nmax(kn(a.wz, k, mt)[r], a.warm_floor);
      }
      kn(a.s, k, mt)[r] = sv;
      kn(a.z, k, mt)[r] = zv;
    }
  }
  if (mc > 0) {
    // state-row init from the zero-control rollout, warm lanes included
    if (lane < nx) S.xv[lane] = a.x0[(size_t)b * nx + lane];
    float shiftx = 0.f;
    for (int k = 0; k < H; ++k) {
      load_knot(k);
      float xn = 0.f;
      if (lane < nx)
        for (int j = 0; j < nx; ++j) xn += S.A[lane * nx + j] * S.xv[j];
      __syncwarp();
      if (lane < nx) S.xv[lane] = xn;
      __syncwarp();
      if (lane < mc) {
        float r0 = 0.f;
        for (int i = 0; i < nx; ++i) r0 += c_at(k, lane, i) * S.xv[i];
        const float cxv = kn(a.cx, k, mc)[lane];
        r0 -= cxv;
        ks(rzx, k, mc)[lane] = r0;
        shiftx = nmax(shiftx, r0);
        hn2 += cxv * cxv;
        meff += kn(a.maskx, k, mc)[lane];
      }
    }
    shiftx = warp_max(shiftx) + 1.f;
    __syncwarp();
    for (int e = lane; e < H * mc; e += 32) {
      const float r0 = rzx[e];
      a.sx[(size_t)b * H * mc + e] = -r0 + shiftx;
      a.zx[(size_t)b * H * mc + e] = nmax(r0, 0.f) + 1.f;
    }
  }
  const float qnorm = 1.f + sqrtf(warp_sum(qn2));
  const float hnorm = 1.f + sqrtf(warp_sum(hn2));
  meff = nmax(warp_sum(meff), 1.f);
  __syncwarp();

  // ---- rollout + costates + residuals: (mu, res) ---------------------------
  auto measure = [&](float& mu, float& res) {
    if (lane < nx) S.xv[lane] = a.x0[(size_t)b * nx + lane];
    for (int k = 0; k < H; ++k) {
      load_knot(k);
      if (lane < nu) S.uv[lane] = kn(a.u, k, nu)[lane];
      __syncwarp();
      float xn = 0.f;
      if (lane < nx) {
        for (int j = 0; j < nx; ++j) xn += S.A[lane * nx + j] * S.xv[j];
        for (int j = 0; j < nu; ++j) xn += S.Bm[lane * nu + j] * S.uv[j];
      }
      __syncwarp();
      if (lane < nx) {
        S.xv[lane] = xn;
        kn(a.x, k, nx)[lane] = xn;
      }
    }
    float rx2 = 0.f, rz2 = 0.f, sz = 0.f;
    if (lane < nx) S.lam[lane] = 0.f;
    for (int k = H - 1; k >= 0; --k) {
      load_knot(k);
      if (lane < nx) S.xv[lane] = kn(a.x, k, nx)[lane];
      if (lane < nu) S.uv[lane] = kn(a.u, k, nu)[lane];
      for (int r = lane; r < mt; r += 32) S.zr[r] = kn(a.z, k, mt)[r];
      __syncwarp();
      if (lane < nx) {
        float lk = kn(a.q, k, nx)[lane] + S.lam[lane];
        for (int j = 0; j < nx; ++j) lk += sQ[lane * nx + j] * S.xv[j];
        for (int j = 0; j < mc; ++j) lk += c_at(k, j, lane) * kn(a.zx, k, mc)[j];
        S.lamk[lane] = lk;
      }
      if (lane < mc) {
        const float zxv = kn(a.zx, k, mc)[lane], sxv = kn(a.sx, k, mc)[lane];
        const float mk = kn(a.maskx, k, mc)[lane];
        float r = sxv - kn(a.cx, k, mc)[lane];
        for (int i = 0; i < nx; ++i) r += c_at(k, lane, i) * S.xv[i];
        ks(rzx, k, mc)[lane] = r;
        rz2 += (r * mk) * (r * mk);
        sz += sxv * zxv * mk;
      }
      for (int r = lane; r < mt; r += 32) {
        float gu = 0.f;
        for (int j = 0; j < nu; ++j) gu += g_at(r, j) * S.uv[j];
        const float sv = kn(a.s, k, mt)[r], mk = S.mrow[r];
        const float rr = gu + sv - row_h(k, r);
        ks(rz, k, mt)[r] = rr;
        rz2 += (rr * mk) * (rr * mk);
        sz += sv * S.zr[r] * mk;
      }
      __syncwarp();
      // rx = R u + B' lam_k + G' z
      if (lane < nu) {
        float acc = 0.f;
        for (int i = 0; i < nu; ++i) acc += sR[lane * nu + i] * S.uv[i];
        for (int i = 0; i < nx; ++i) acc += S.Bm[i * nu + lane] * S.lamk[i];
        for (int r = 0; r < mt; ++r) acc += g_at(r, lane) * S.zr[r];
        ks(rx, k, nu)[lane] = acc;
        rx2 += acc * acc;
      }
      // lam <- A' lam_k
      if (lane < nx) {
        float ln = 0.f;
        for (int l = 0; l < nx; ++l) ln += S.A[l * nx + lane] * S.lamk[l];
        S.lam[lane] = ln;
      }
    }
    mu = warp_sum(sz) / meff;
    res = nmax(sqrtf(warp_sum(rx2)) / qnorm, sqrtf(warp_sum(rz2)) / hnorm);
  };

  // (L L') v = v in place (S.M holds L, S.dinv its inverse diagonal),
  // column by column: nu steps of one broadcast and a lane-parallel update
  auto chol_solve = [&](float* v) {
    for (int i = 0; i < nu; ++i) {
      __syncwarp();
      const float yi = v[i] * S.dinv[i];
      __syncwarp();
      if (lane == i) v[i] = yi;
      else if (lane > i && lane < nu) v[lane] -= S.M[lane * nu + i] * yi;
    }
    for (int i = nu - 1; i >= 0; --i) {
      __syncwarp();
      const float xi = v[i] * S.dinv[i];
      __syncwarp();
      if (lane == i) v[i] = xi;
      else if (lane < i) v[lane] -= S.M[i * nu + lane] * xi;
    }
    __syncwarp();
  };

  // Backward vector pass at knot k (A_k/B_k, L_k, K_k in shared memory):
  // the value gradient sv at x_{k+1} gains the state rows' term, then
  // kff_k = M_k^-1 g_u and sv <- A' sv - K' g_u.  rc(k, r) / rcx(k, j) give
  // the complementarity right-hand sides (predictor or corrector).
  auto vector_bwd_knot = [&](int k, auto rc, auto rcx) {
    __syncwarp();
    if (lane < nx && mc > 0) {
      float add = 0.f;
      for (int j = 0; j < mc; ++j) {
        const float zxv = kn(a.zx, k, mc)[j], sxv = kn(a.sx, k, mc)[j];
        const float vmx = kn(a.maskx, k, mc)[j]
            * (barrier_w(zxv, sxv) * ks(rzx, k, mc)[j] + rcx(k, j) / nmax(sxv, ms));
        add += c_at(k, j, lane) * vmx;
      }
      S.sv[lane] += add;
    }
    for (int r = lane; r < mt; r += 32) {
      const float zv = kn(a.z, k, mt)[r], svr = kn(a.s, k, mt)[r];
      S.w[r] = barrier_w(zv, svr) * ks(rz, k, mt)[r] + rc(k, r) / nmax(svr, ms);
    }
    __syncwarp();
    // g_u = rx + B' sv + G' (W rz + rc / s)
    if (lane < nu) {
      float acc = 0.f;
      for (int i = 0; i < nx; ++i) acc += S.Bm[i * nu + lane] * S.sv[i];
      float gu = ks(rx, k, nu)[lane] + acc;
      for (int r = 0; r < mt; ++r) gu += g_at(r, lane) * S.w[r];
      S.gu[lane] = gu;
      S.uv[lane] = gu;
    }
    chol_solve(S.uv);
    if (lane < nu) ks(kff, k, nu)[lane] = S.uv[lane];
    float svn = 0.f;
    if (lane < nx) {
      for (int l = 0; l < nx; ++l) svn += S.A[l * nx + lane] * S.sv[l];
      for (int j = 0; j < nu; ++j) svn -= S.K[j * nx + lane] * S.gu[j];
    }
    __syncwarp();
    if (lane < nx) S.sv[lane] = svn;
  };

  // Forward vector pass: du_k = -K_k dx - kff_k, the row steps ds/dz (and
  // dsx/dzx from dx_{k+1}); returns the largest step in (0, inf] that keeps
  // every real row's s and z nonnegative.  Each row is read and written by
  // one lane, rc/rcx before ds/dz, so the corrector may read the
  // predictor's directions through them.
  auto vector_fwd = [&](auto rc, auto rcx) -> float {
    float amax = INFINITY;
    auto ratio = [&](float v, float dv, float mk) {
      if (dv < 0.f && mk > 0.f) amax = nmin(amax, -v / dv);
    };
    if (lane < nx) S.xv[lane] = 0.f;
    for (int k = 0; k < H; ++k) {
      load_knot(k);
      if (lane < nu) {
        const float* Kg = ks(K, k, nu * nx) + lane * nx;
        float acc = 0.f;
        for (int i = 0; i < nx; ++i) acc += Kg[i] * S.xv[i];
        const float d = -acc - ks(kff, k, nu)[lane];
        S.uv[lane] = d;
        ks(du, k, nu)[lane] = d;
      }
      __syncwarp();
      for (int r = lane; r < mt; r += 32) {
        float gdu = 0.f;
        for (int j = 0; j < nu; ++j) gdu += g_at(r, j) * S.uv[j];
        const float zv = kn(a.z, k, mt)[r], svr = kn(a.s, k, mt)[r];
        const float rcv = rc(k, r);
        const float dsv = -ks(rz, k, mt)[r] - gdu;
        const float dzv = (rcv - zv * dsv) / nmax(svr, ms);
        ks(ds, k, mt)[r] = dsv;
        ks(dz, k, mt)[r] = dzv;
        ratio(svr, dsv, S.mrow[r]);
        ratio(zv, dzv, S.mrow[r]);
      }
      float dxn = 0.f;
      if (lane < nx) {
        for (int l = 0; l < nx; ++l) dxn += S.A[lane * nx + l] * S.xv[l];
        for (int j = 0; j < nu; ++j) dxn += S.Bm[lane * nu + j] * S.uv[j];
      }
      __syncwarp();
      if (lane < nx) S.xv[lane] = dxn;
      __syncwarp();
      if (lane < mc) {
        const float zxv = kn(a.zx, k, mc)[lane], sxv = kn(a.sx, k, mc)[lane];
        const float rcv = rcx(k, lane);
        float cdx = 0.f;
        for (int i = 0; i < nx; ++i) cdx += c_at(k, lane, i) * S.xv[i];
        const float dsv = -ks(rzx, k, mc)[lane] - cdx;
        const float dzv = (rcv - zxv * dsv) / nmax(sxv, ms);
        ks(dsx, k, mc)[lane] = dsv;
        ks(dzx, k, mc)[lane] = dzv;
        const float mk = kn(a.maskx, k, mc)[lane];
        ratio(sxv, dsv, mk);
        ratio(zxv, dzv, mk);
      }
    }
    return warp_min(amax);
  };

  // ---- IPM iterations -------------------------------------------------------
  bool done = false;
  int it_conv = a.iters;
  for (int it = 0; it < a.iters; ++it) {
    float mu, res;
    measure(mu, res);
    if (res < a.reltol && mu < a.abstol) {   // uniform across the warp
      it_conv = it;
      done = true;
      break;
    }

    auto rc_aff = [&](int k, int r) { return -kn(a.s, k, mt)[r] * kn(a.z, k, mt)[r]; };
    auto rcx_aff = [&](int k, int j) { return -kn(a.sx, k, mc)[j] * kn(a.zx, k, mc)[j]; };

    // one backward sweep: Riccati factor + predictor backward vector pass
    __syncwarp();
    for (int e = lane; e < nx * nx; e += 32) S.P[e] = sQ[e];
    if (lane < nx) S.sv[lane] = 0.f;
    for (int k = H - 1; k >= 0; --k) {
      load_knot(k);
      for (int r = lane; r < mt; r += 32)
        S.w[r] = barrier_w(kn(a.z, k, mt)[r], kn(a.s, k, mt)[r]);
      // Pb = Pbar + Cm' diag(Wx) Cm
      for (int e = lane; e < nx * nx && mc > 0; e += 32) {
        const int i = e / nx, l = e % nx;
        float acc = 0.f;
        for (int j = 0; j < mc; ++j)
          acc += c_at(k, j, i)
                 * barrier_w(kn(a.zx, k, mc)[j], kn(a.sx, k, mc)[j]) * c_at(k, j, l);
        S.P[e] += acc;
      }
      __syncwarp();
      for (int e = lane; e < nu * nx; e += 32) {
        const int j = e / nx, l = e % nx;
        float acc = 0.f;
        for (int i = 0; i < nx; ++i) acc += S.Bm[i * nu + j] * S.P[i * nx + l];
        S.BtP[e] = acc;
      }
      __syncwarp();
      // M = R + reg I + Gm' diag(W) Gm + B' Pb B  (lower triangle)
      for (int e = lane; e < nu * nu; e += 32) {
        const int i = e / nu, j = e % nu;
        if (j > i) continue;
        float acc = sR[e] + (i == j ? a.reg : 0.f);
        for (int r = 0; r < mt; ++r) acc += g_at(r, i) * S.w[r] * g_at(r, j);
        for (int l = 0; l < nx; ++l) acc += S.BtP[i * nx + l] * S.Bm[l * nu + j];
        S.M[e] = acc;
      }
      // B'PA and A'P
      for (int e = lane; e < nu * nx; e += 32) {
        const int j = e / nx, l = e % nx;
        float acc = 0.f;
        for (int i = 0; i < nx; ++i) acc += S.BtP[j * nx + i] * S.A[i * nx + l];
        S.BtPA[e] = acc;
      }
      for (int e = lane; e < nx * nx; e += 32) {
        const int i = e / nx, l = e % nx;
        float acc = 0.f;
        for (int t = 0; t < nx; ++t) acc += S.A[t * nx + i] * S.P[t * nx + l];
        S.AtP[e] = acc;
      }
      // Cholesky of M, right-looking, in place; NaN if not SPD
      for (int j = 0; j < nu; ++j) {
        __syncwarp();
        const float d = S.M[j * nu + j];
        const float lj = d > 0.f ? sqrtf(d) : NAN;
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
          const int i = e / nu, c = e % nu;
          if (c > j && c <= i) S.M[e] -= S.M[i * nu + j] * S.M[c * nu + j];
        }
      }
      __syncwarp();
      for (int e = lane; e < nl; e += 32) {
        int i, j;
        tri(e, i, j);
        ks(L, k, nl)[e] = S.M[i * nu + j];
      }
      if (lane < nu) ks(dinv, k, nu)[lane] = S.dinv[lane];
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
        for (int j = 0; j < nu; ++j) S.K[j * nx + lane] = col[j];
      }
      __syncwarp();
      for (int e = lane; e < nu * nx; e += 32) ks(K, k, nu * nx)[e] = S.K[e];
      // P <- sym(Q + A' Pb A - K' B'PA)
      for (int e = lane; e < nx * nx; e += 32) {
        const int i = e / nx, l = e % nx;
        float acc = sQ[e];
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
      vector_bwd_knot(k, rc_aff, rcx_aff);
    }

    // predictor forward pass and its step
    const float a_aff = nmin(vector_fwd(rc_aff, rcx_aff), 1.f);
    __syncwarp();
    float sz_aff = 0.f;
    for (int k = 0; k < H; ++k) {
      const float* mg = kn(a.mask, k, m);
      for (int r = lane; r < mt; r += 32)
        sz_aff += (kn(a.s, k, mt)[r] + a_aff * ks(ds, k, mt)[r])
                  * (kn(a.z, k, mt)[r] + a_aff * ks(dz, k, mt)[r])
                  * (r < m ? mg[r] : 1.f);
      for (int j = lane; j < mc; j += 32)
        sz_aff += (kn(a.sx, k, mc)[j] + a_aff * ks(dsx, k, mc)[j])
                  * (kn(a.zx, k, mc)[j] + a_aff * ks(dzx, k, mc)[j])
                  * kn(a.maskx, k, mc)[j];
    }
    const float mu_aff = warp_sum(sz_aff) / meff;
    const float sigma = powf(nmin(nmax(mu_aff / nmax(mu, ms), 0.f), 1.f), a.sigma_pow);
    const float sig_mu = sigma * mu;

    // corrector: rc = -(s z + ds_a dz_a - sigma mu), read from the
    // predictor's directions before the forward pass overwrites them
    auto rc_cor = [&](int k, int r) {
      return -(kn(a.s, k, mt)[r] * kn(a.z, k, mt)[r]
               + ks(ds, k, mt)[r] * ks(dz, k, mt)[r] - sig_mu);
    };
    auto rcx_cor = [&](int k, int j) {
      return -(kn(a.sx, k, mc)[j] * kn(a.zx, k, mc)[j]
               + ks(dsx, k, mc)[j] * ks(dzx, k, mc)[j] - sig_mu);
    };
    __syncwarp();
    if (lane < nx) S.sv[lane] = 0.f;
    for (int k = H - 1; k >= 0; --k) {
      load_knot(k);
      for (int e = lane; e < nl; e += 32) {
        int i, j;
        tri(e, i, j);
        S.M[i * nu + j] = ks(L, k, nl)[e];
      }
      if (lane < nu) S.dinv[lane] = ks(dinv, k, nu)[lane];
      for (int e = lane; e < nu * nx; e += 32) S.K[e] = ks(K, k, nu * nx)[e];
      vector_bwd_knot(k, rc_cor, rcx_cor);
    }
    const float step = nmin(a.frac * vector_fwd(rc_cor, rcx_cor), 1.f);

    __syncwarp();
    for (int e = lane; e < H * nu; e += 32)
      a.u[(size_t)b * H * nu + e] += step * du[e];
    for (int e = lane; e < H * mt; e += 32) {
      const size_t g = (size_t)b * H * mt + e;
      a.z[g] = nmax(a.z[g] + step * dz[e], ms);
      a.s[g] = nmax(a.s[g] + step * ds[e], ms);
    }
    for (int e = lane; e < H * mc; e += 32) {
      const size_t g = (size_t)b * H * mc + e;
      a.zx[g] = nmax(a.zx[g] + step * dzx[e], ms);
      a.sx[g] = nmax(a.sx[g] + step * dsx[e], ms);
    }
    __syncwarp();
  }

  float mu, res;
  measure(mu, res);
  if (lane == 0) {
    const bool conv = done || (res < a.reltol && mu < a.abstol);
    float* st = a.stat + (size_t)b * 4;
    st[0] = conv ? 1.f : 0.f;
    st[1] = (float)it_conv;
    st[2] = mu;
    st[3] = res;
  }
}

}  // namespace

extern "C" {

// Dimension limits compiled into the kernel; the wrapper raises above them.
void resident_ipm_limits(int* nx_max, int* nu_max, int* m_max, int* mc_max) {
  *nx_max = NX_MAX;
  *nu_max = NU_MAX;
  *m_max = M_MAX;
  *mc_max = MC_MAX;
}

// Launch on `stream`, one warp per scenario; returns cudaGetLastError()
// (0 = launched).
int resident_ipm_launch(const IpmArgs* args, void* stream) {
  const int blocks = (args->B + WARPS - 1) / WARPS;
  resident_ipm_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
