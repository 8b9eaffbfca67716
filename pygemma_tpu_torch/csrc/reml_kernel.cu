// The REML kernel: the per-SNP small-matrix algebra of one evaluation of
// the lambda search, and the search's bisection or Newton step, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel.  The JAX package leaves this algebra to XLA,
// which fuses the per-SNP scalar work of an evaluation into a few device
// programs.  The port ran it as plain PyTorch: one (B,)-vector launch per
// scalar of each (c+2) x (c+2) Gram, about 240 launches an evaluation and
// some 4,100 a block of the dense scan.  The card then did almost nothing
// per launch and the host set the pace: 91-122 ms of host dispatch a block,
// the card idle 90% of a dense scan and 97.5% of that idle time inside the
// REML step (NVIDIA H100 80GB HBM3, the repository's benchmark, traced).
//
// What bounds it on the H100.  Each lane (one SNP, or one SNP at one lambda
// of a grid) reads a few hundred bytes of packed Gram parts and does O(t^3)
// floating-point operations on them, t = c + 2: at the main path's t = 5
// about 400 operations on ~300 bytes, so a block of 4,096 lanes is ~1.2 MB
// and ~2 MFLOP -- well under a microsecond of the card's bandwidth or FP32
// rate.  A launch's own latency (a few microseconds) bounds it.
//
// The design.
// - One launch an evaluation does all of the per-lane work that followed
//   the Gram builders: the implicit complement's correction, the [W, x, y]
//   permutation (by index), the Cholesky of G_1 with the MIN_VAL
//   pivot clamp, the Woodbury scalars, d1 / d2 / the likelihood of the
//   REML and ML families with every clamp of core/reml.py, and then the
//   search's own step: the bisection's bracket update, the safeguarded
//   Newton step with core/solver.py's stopping rules, the likelihood's -inf
//   for invalid lanes, or the Wald statistics at lambda*.  The lane state
//   never leaves the card between the Gram kernel and the next step.
// - One thread per lane, its Grams in registers: the Gram size t is a
//   compile-time constant (REML_T, one library per width and float type,
//   built at first use), so every loop unrolls and every array index is
//   known.  Up to T_MAX; a wider Gram (15 or more covariates) builds the
//   same code with its loops kept and its Gram entries read from memory
//   where they are used, so the lane holds only its Cholesky factor and
//   M G_2 in local memory, 2 (t - 1)^2 values.
// - One code for both float types (REML_F): float32, the card's path, and
//   float64, which the port also runs on the card.
// - Inputs are read in place through strides (View): K1's output rows, a
//   shared-lambda builder's (lambda, k) rows broadcast over the block with
//   stride 0, the per-SNP builders' (B, k, .) tensors.
// - The same operations in the same order and float type as the PyTorch
//   algebra, IEEE sqrt, division and log (no fast math, no flush to zero); the
//   compiler may contract a multiply and an add into one FMA, which the
//   PyTorch version, one launch per operation, never does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef REML_T
#define REML_T 5
#endif
#ifndef REML_F
#define REML_F float
#endif

// The widest Gram kept in registers: t = q + 1, up to 14 covariates with
// the predictor and the outcome.  Wider builds keep their loops.
#define REML_T_MAX 16
#if REML_T <= REML_T_MAX
#define UNROLL _Pragma("unroll")
#else
#define UNROLL _Pragma("unroll 1")
#endif

namespace {

constexpr int T_MAX = REML_T_MAX;
constexpr int THREADS = 128;
constexpr double MIN_VAL = 1e-35;  // config.MIN_VAL, the reference's clamp

static_assert(REML_T >= 2, "REML_T out of range");

// What a launch computes (ops/reml_kernel.py: MODES).
enum Mode { D1 = 0, BISECT = 1, NEWTON = 2, LIK = 3, WALD = 4 };

// Element (g, b, k, j) of a lane array: lane (g, b), Gram power k, entry j;
// the elements are REML_F.
struct View {
  const void* p;
  long long sg, sb, sk, sj;
};

// Every array holds REML_F, the masks bytes.
struct Args {
  View S, vS, vv;                 // packed Gram parts, one row per power
  View sum_d, sum_d2, sum_logh;   // eigenvalue-weight sums
  View lam;                       // the lane's lambda
  View R_S, R_vS, R_vv;           // complement residuals (when eps is set)
  const void* eps;                // () complement eigenvalue, or null
  void* lo;                       // BISECT: the bracket, in place
  void* hi;
  const void* flo;                // BISECT: sign of d1 at the low end
  const void* lo0;                // NEWTON: the bracket a step may not leave
  const void* hi0;
  unsigned char* done;            // NEWTON: stopped lanes, in place
  void* lam_out;                  // BISECT: next midpoint; NEWTON: lambda
  const unsigned char* valid;     // LIK: lanes kept (others -inf), or null
  void* out;                      // D1, LIK: (G, B); NEWTON: (2, G, B);
                                  // WALD: (5, B) beta, se, tau, lambda, F
  unsigned char* ok;              // WALD: x'P x > MIN_VAL
  int G, B, n, n_comp, mode, restricted, permute;
  double rtol;       // Newton's relative-step tolerance
  double lik_const;  // the likelihood's lambda-free constant (core/reml.py)
  double sqrt_df;    // sqrt(n - q), the Wald se's factor
};

template <typename F>
__host__ __device__ __forceinline__ F at(const View& v, int g, int b,
                                         int k = 0, int j = 0) {
  return static_cast<const F*>(v.p)[g * v.sg + b * v.sb + k * v.sk +
                                    j * v.sj];
}

// IEEE sqrt, log and fabs in the float type of the build.
template <typename F>
__host__ __device__ __forceinline__ F sqrt_(F x) {
  if constexpr (sizeof(F) == 4) return sqrtf(x); else return sqrt(x);
}
template <typename F>
__host__ __device__ __forceinline__ F log_(F x) {
  if constexpr (sizeof(F) == 4) return logf(x); else return log(x);
}
template <typename F>
__host__ __device__ __forceinline__ F fabs_(F x) {
  if constexpr (sizeof(F) == 4) return fabsf(x); else return fabs(x);
}

// torch.clamp_min: NaN passes through.
template <typename F>
__host__ __device__ __forceinline__ F clamp_min(F x, F lo) {
  return x < lo ? lo : x;
}

template <typename F>
__host__ __device__ __forceinline__ bool is_nan(F x) { return x != x; }

// torch.sign keeping NaN (solver._nan_sign).
template <typename F>
__host__ __device__ __forceinline__ F nan_sign(F x) {
  return is_nan(x) ? x : (x > F(0) ? F(1) : (x < F(0) ? F(-1) : F(0)));
}

// Entry (r, c), r <= c, of the raw Gram of power k + 1 in the builders'
// order [shared | per-SNP column], plus the complement's w^(k+1) R.
template <typename F, int T>
__host__ __device__ __forceinline__ F gram_entry(const Args& a, int g, int b,
                                                 int k, int r, int c, F wk) {
  constexpr int S = T - 1;  // shared columns; the per-SNP column is S
  F v;
  if (c < S) {
    v = at<F>(a.S, g, b, k, r * S - r * (r - 1) / 2 + (c - r));
  } else if (r < S) {
    v = at<F>(a.vS, g, b, k, r);
  } else {
    v = at<F>(a.vv, g, b, k);
  }
  if (a.eps != nullptr) {
    const F R = c < S   ? at<F>(a.R_S, 0, 0, r, c)
                : r < S ? at<F>(a.R_vS, 0, b, 0, r)
                        : at<F>(a.R_vv, 0, b);
    v = v + wk * R;
  }
  return v;
}

// Solve (L L') x = rhs in place with the leading N x N block of L:
// reml.chol_solve's forward and backward substitution, in its order.
template <typename F, int Q, int N>
__host__ __device__ __forceinline__ void chol_solve(const F (&L)[Q][Q],
                                                    F (&x)[Q]) {
  UNROLL
  for (int i = 0; i < N; ++i) {
    F s = x[i];
    UNROLL
    for (int j = 0; j < i; ++j) s = s - L[i][j] * x[j];
    x[i] = s / L[i][i];
  }
  UNROLL
  for (int i = N - 1; i >= 0; --i) {
    F s = x[i];
    UNROLL
    for (int j = i + 1; j < N; ++j) s = s - L[j][i] * x[j];
    x[i] = s / L[i][i];
  }
}

template <int N, typename F, int Q>
__host__ __device__ __forceinline__ F dot(const F (&u)[Q], const F (&v)[Q]) {
  F s = F(0);
  UNROLL
  for (int i = 0; i < N; ++i) s = s + u[i] * v[i];
  return s;
}

// d ell / d lambda and d^2 ell / d lambda^2 (reml.d1_* / reml.d2_*).
template <typename F>
__host__ __device__ __forceinline__ F d1_of(const Args& a, int q, F lam,
                                            F yPy, F yPPy, F trP, F sum_d) {
  const F yPy_c = clamp_min(yPy, F(MIN_VAL));
  if (a.restricted) {
    const F nf = (F)(a.n - q);
    return F(-0.5) * (nf - trP) / lam +
           F(0.5) * nf * ((yPy_c - clamp_min(yPPy, F(0))) / lam) / yPy_c;
  }
  const F nf = (F)a.n;
  return F(-0.5) * (nf - sum_d) / lam +
         F(0.5) * nf * (F(1) - clamp_min(yPPy, F(MIN_VAL)) / yPy_c) / lam;
}

template <typename F>
__host__ __device__ __forceinline__ F d2_of(const Args& a, int q, F lam,
                                            F yPy, F yPPy, F yPPPy, F trP,
                                            F trPP, F sum_d, F sum_d2) {
  const F yPy_c = clamp_min(yPy, F(MIN_VAL));
  const F yPPy_c = clamp_min(yPPy, F(MIN_VAL));
  const F yPPPy_c = clamp_min(yPPPy, F(MIN_VAL));
  const F lam2 = lam * lam;
  const F yPGPGPy = (yPy_c + yPPPy_c - F(2) * yPPy_c) / lam2;
  const F yPGPy = (yPy_c - yPPy_c) / lam;
  if (a.restricted) {
    const F nf = (F)(a.n - q);
    const F result = F(0.5) * (nf + trPP - F(2) * trP) / lam2;
    return result - nf * (yPGPGPy * yPy_c - F(0.5) * yPGPy * yPGPy) /
                        (yPy_c * yPy_c);
  }
  const F nf = (F)a.n;
  const F result = F(0.5) * (nf + sum_d2 - F(2) * sum_d) / lam2;
  return result -
         F(0.5) * nf * (F(2) * yPGPGPy - yPGPy * yPGPy / yPy_c) / yPy_c;
}

// One lane's evaluation and step (Mode), for Grams of size T.
template <typename F, int T>
__host__ __device__ void reml_lane(const Args& a, int g, int b) {
  constexpr int Q = T - 1;  // the design's width; the outcome is index Q
  constexpr int C = Q - 1;  // covariates before the predictor (Wald)
  constexpr bool REG = T <= T_MAX;  // the Grams held in registers
  const int mode = a.mode;
  const int kmax = mode == NEWTON ? 3 : (mode == D1 || mode == BISECT) ? 2 : 1;
  const F lam = at<F>(a.lam, g, b);
  const int out_i = g * a.B + b;
  F* const out = static_cast<F*>(a.out);

  // the complement's weights w^k = (lam * eps + 1)^-k (grams._complement_wc)
  F w[3] = {F(0), F(0), F(0)};
  F log_he = F(0);
  const F nc = (F)a.n_comp;
  if (a.eps != nullptr) {
    const F he = lam * *static_cast<const F*>(a.eps) + F(1);
    const F wc = F(1) / he;
    w[0] = wc;
    w[1] = wc * wc;
    w[2] = wc * wc * wc;
    log_he = log_(he);
  }

  // entry (i, j) of the Gram of power k + 1 in the design's order: [W, x, y]
  // from [W, y, x] when permuting (grams.permute_x_before_y swaps the last
  // two indices)
  auto entry = [&](int k, int i, int j) -> F {
    const int ri = a.permute && i >= T - 2 ? 2 * T - 3 - i : i;
    const int rj = a.permute && j >= T - 2 ? 2 * T - 3 - j : j;
    return gram_entry<F, T>(a, g, b, k, ri < rj ? ri : rj, ri < rj ? rj : ri,
                            w[k]);
  };
  F Ar[REG ? 3 : 1][REG ? T : 1][REG ? T : 1];
  if constexpr (REG) {
    UNROLL
    for (int k = 0; k < 3; ++k) {
      if (k >= kmax) break;
      UNROLL
      for (int i = 0; i < T; ++i) {
        UNROLL
        for (int j = 0; j <= i; ++j) {
          const F v = entry(k, i, j);
          Ar[k][i][j] = v;
          Ar[k][j][i] = v;
        }
      }
    }
  }
  auto A = [&](int k, int i, int j) -> F {
    if constexpr (REG) {
      return Ar[k][i][j];
    } else {
      return entry(k, i, j);
    }
  };

  // Cholesky-Crout of G_1, column by column (reml.small_cholesky)
  F L[Q][Q];
  UNROLL
  for (int j = 0; j < Q; ++j) {
    F s[Q];
    UNROLL
    for (int i = j; i < Q; ++i) {
      F x = A(0, i, j);
      UNROLL
      for (int k = 0; k < j; ++k) x = x - L[i][k] * L[j][k];
      s[i] = x;
    }
    // pivot clamp: a rank-deficient design gives huge-se finite output
    const F d = sqrt_(clamp_min(s[j], F(MIN_VAL)));
    L[j][j] = d;
    UNROLL
    for (int i = j + 1; i < Q; ++i) L[i][j] = s[i] / d;
  }

  F u1[Q], Mu1[Q];
  UNROLL
  for (int i = 0; i < Q; ++i) u1[i] = Mu1[i] = A(0, i, Q);
  chol_solve<F, Q, Q>(L, Mu1);
  const F yPy = A(0, Q, Q) - dot<Q>(u1, Mu1);

  if (mode == WALD) {
    // predictor terms against W (reml.predictor_terms) and the Wald
    // statistics at lambda* (reml.wald)
    F ux[Q], Mux[Q], Muy[Q];
    UNROLL
    for (int i = 0; i < Q; ++i) {
      ux[i] = Mux[i] = A(0, i, C);
      Muy[i] = A(0, i, Q);
    }
    chol_solve<F, Q, C>(L, Mux);
    chol_solve<F, Q, C>(L, Muy);
    const F xPx = A(0, C, C) - dot<C>(ux, Mux);
    const F xPy = A(0, C, Q) - dot<C>(ux, Muy);
    const F yPxy = clamp_min(yPy, F(MIN_VAL));
    const bool x_ok = xPx > F(MIN_VAL);
    const F xPx_c = clamp_min(xPx, F(MIN_VAL));
    F beta = F(NAN), se = F(NAN), tau = F(NAN), lam_o = F(NAN);
    if (x_ok) {
      beta = xPy / xPx_c;
      se = sqrt_(yPxy) / (sqrt_(xPx_c) * (F)a.sqrt_df);
      tau = (F)(a.n - Q) / yPxy;
      lam_o = lam;
    }
    const F z = beta / se;
    out[b] = beta;
    out[a.B + b] = se;
    out[2 * a.B + b] = tau;
    out[3 * a.B + b] = lam_o;
    out[4 * a.B + b] = z * z;
    a.ok[b] = x_ok;
    return;
  }

  if (mode == LIK) {
    F logdet = F(0);
    UNROLL
    for (int i = 0; i < Q; ++i) logdet = logdet + log_(L[i][i]);
    logdet = F(2) * logdet;
    F sum_logh = at<F>(a.sum_logh, g, b);
    if (a.eps != nullptr) sum_logh = sum_logh + nc * log_he;
    const F nf = a.restricted ? (F)(a.n - Q) : (F)a.n;
    F lik = (F)a.lik_const - F(0.5) * sum_logh;
    if (a.restricted) lik = lik - F(0.5) * logdet;
    lik = lik - F(0.5) * nf * log_(clamp_min(yPy, F(MIN_VAL)));
    if (a.valid != nullptr && !a.valid[b]) lik = -F(INFINITY);
    out[out_i] = lik;
    return;
  }

  // D1, BISECT, NEWTON: y'P^2 y and tr(P) from the k = 2 Gram
  F G2Mu1[Q], u2[Q];
  UNROLL
  for (int i = 0; i < Q; ++i) {
    u2[i] = A(1, i, Q);
    F s = F(0);
    UNROLL
    for (int j = 0; j < Q; ++j) s = s + A(1, i, j) * Mu1[j];
    G2Mu1[i] = s;
  }
  const F yPPy = A(1, Q, Q) - F(2) * dot<Q>(u2, Mu1) + dot<Q>(Mu1, G2Mu1);
  F MG2[Q][Q];  // M G_2, column by column
  UNROLL
  for (int j = 0; j < Q; ++j) {
    F x[Q];
    UNROLL
    for (int i = 0; i < Q; ++i) x[i] = A(1, i, j);
    chol_solve<F, Q, Q>(L, x);
    UNROLL
    for (int i = 0; i < Q; ++i) MG2[i][j] = x[i];
  }
  F trMG2 = F(0);
  UNROLL
  for (int i = 0; i < Q; ++i) trMG2 = trMG2 + MG2[i][i];
  F sum_d = at<F>(a.sum_d, g, b);
  if (a.eps != nullptr) sum_d = sum_d + nc * w[0];
  const F trP = sum_d - trMG2;
  const F d1 = d1_of(a, Q, lam, yPy, yPPy, trP, sum_d);

  if (mode == D1) {
    out[out_i] = d1;
    return;
  }
  if (mode == BISECT) {
    // the root lies in [mid, hi] when d1 keeps the low end's sign
    F* const lo = static_cast<F*>(a.lo);
    F* const hi = static_cast<F*>(a.hi);
    const bool go_right =
        (d1 >= F(0) ? F(1) : F(-1)) == static_cast<const F*>(a.flo)[b];
    if (go_right) {
      lo[b] = lam;
    } else {
      hi[b] = lam;
    }
    static_cast<F*>(a.lam_out)[b] = sqrt_(lo[b] * hi[b]);
    return;
  }

  // NEWTON: y'P^3 y and tr(P^2) from the k = 3 Gram
  F u3[Q], G3Mu1[Q], wv[Q], Mw[Q];
  UNROLL
  for (int i = 0; i < Q; ++i) {
    u3[i] = A(2, i, Q);
    F s = F(0);
    UNROLL
    for (int j = 0; j < Q; ++j) s = s + A(2, i, j) * Mu1[j];
    G3Mu1[i] = s;
    wv[i] = Mw[i] = u2[i] - G2Mu1[i];
  }
  chol_solve<F, Q, Q>(L, Mw);
  const F yPPPy = A(2, Q, Q) - F(2) * dot<Q>(u3, Mu1) + dot<Q>(Mu1, G3Mu1) -
                  dot<Q>(wv, Mw);
  F trMG3 = F(0);
  UNROLL
  for (int j = 0; j < Q; ++j) {
    F x[Q];
    UNROLL
    for (int i = 0; i < Q; ++i) x[i] = A(2, i, j);
    chol_solve<F, Q, Q>(L, x);
    trMG3 = trMG3 + x[j];
  }
  F trMG2MG2 = F(0);
  UNROLL
  for (int i = 0; i < Q; ++i) {
    UNROLL
    for (int j = 0; j < Q; ++j) trMG2MG2 = trMG2MG2 + MG2[i][j] * MG2[j][i];
  }
  F sum_d2 = at<F>(a.sum_d2, g, b);
  if (a.eps != nullptr) sum_d2 = sum_d2 + nc * w[1];
  const F trPP = sum_d2 - F(2) * trMG3 + trMG2MG2;
  const F d2 = d2_of(a, Q, lam, yPy, yPPy, yPPPy, trP, trPP, sum_d, sum_d2);
  if (a.done == nullptr) {  // the values alone
    out[out_i] = d1;
    out[a.G * a.B + out_i] = d2;
    return;
  }
  // the safeguarded step (solver.newton_step's rules): a three-way sign
  // product <= 0 stops without updating (NaN falls through to the NaN
  // guard), as do a NaN or infinite step and one that leaves the bracket
  const F ratio = d1 / d2;
  const F cand = lam - ratio;
  const bool bad_sign = nan_sign(ratio) * nan_sign(d1) * nan_sign(d2) <= F(0);
  const bool bad_num = is_nan(cand) || fabs_(cand) == F(INFINITY);
  const bool oob = cand < static_cast<const F*>(a.lo0)[b] ||
                   cand > static_cast<const F*>(a.hi0)[b];
  const F rel = fabs_(cand - lam) / fabs_(lam);
  const bool done = a.done[b] != 0;
  if (!done && !bad_sign && !bad_num && !oob) {
    static_cast<F*>(a.lam_out)[b] = cand;
  }
  a.done[b] = done || bad_sign || bad_num || oob || rel < (F)a.rtol;
}

// ---- the launch (not compiled on the host) ---------------------------------

__global__ void __launch_bounds__(THREADS) reml_kernel(const Args a) {
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (id >= (long long)a.G * a.B) return;
  reml_lane<REML_F, REML_T>(a, (int)(id / a.B), (int)(id % a.B));
}

}  // namespace

extern "C" {

// The widest Gram held in registers, this build's Gram size and float
// size, and the size of the argument block: the Python wrapper checks all
// four.
int reml_t_max() { return T_MAX; }
int reml_t() { return REML_T; }
int reml_f_bytes() { return (int)sizeof(REML_F); }
int reml_args_bytes() { return (int)sizeof(Args); }

// Launches one evaluation over G * B lanes on ``stream``; ``args`` points
// to an Args (a plain pointer: a parameter of the unnamed namespace's type
// would give the function internal linkage).  Returns a CUDA error code.
int reml_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const long long lanes = (long long)a.G * a.B;
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  reml_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
