// K1: fused per-SNP-lambda Gram statistics for Hopper (sm_90a).
//
// Replaces pygemma_tpu/ops/gram_kernel.py::_kernel (the Pallas TPU kernel
// launched by _fused_grams_padded).  For every SNP b, lambda slot r and
// k = 1..KMAX, with h_i = lam_br * ev_i + 1 and d_i = 1 / h_i:
//
//   S_k[p]  = sum_i d_i^k pairs[i, p]            p < m   (shared pair products)
//   sum_k   = sum_i d_i^k                        (the "ones" feature)
//   vS_k[j] = sum_i d_i^k v[i, b] shared[i, j]   j < s
//   vv_k    = sum_i d_i^k v[i, b]^2
//   logh    = sum_i log h_i                      (when want_logh)
//
// The (n, B) weight matrices d^k never reach device memory.
//
// What bounds it on the H100.  One Newton launch (KMAX = 3) at the main
// path's shape (n = 10,000, B = 2,048, c = 3) reads 82 MB of genotypes v:
// 0.025 ms at 3.35 TB/s.  Its products, 15 features x 3 powers per
// (sample, column), are ~0.03 ms on the FP32 pipes alone.  In this design
// the staging, the elementwise work that makes the weights d^k (a
// correctly rounded reciprocal, the powers, the operand splits below) and
// the three small-N tensor-core passes each take about a third of the
// time, one after the other (k1_ablation.py).  An earlier design with one
// thread per column, walking the samples one dependent global load of v
// at a time, ran at ~0.24 ms whatever KMAX.
//
// The design.
// - v and ev are staged in shared memory TS samples at a time through a
//   STAGES-deep cp.async ring (16-byte copies where the rows allow it); the
//   features [pairs | 1 | shared] through registers one stage ahead, split
//   into TF32 hi/lo once as they are stored.
// - The sums over samples are GEMMs with M = columns, N = features and
//   K = samples: S_k = D_k' [pairs | 1] and vS_k = (D_k o V)' shared.  Each
//   warpgroup owns 64 columns and runs them on the tensor cores with wgmma
//   in 3xTF32 (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, FP32 accumulation):
//   ~2^-22 per product, where a single TF32 pass keeps only ~3 digits and
//   breaks the float32 contract.  hi is cvt.rna.tf32.f32 (round to nearest,
//   ties away: add half a TF32 ulp to the bits, clear the low 13); lo =
//   x - hi is exact, and the tensor core reads its top 19 bits.
// - The A operand (d^k, or d^k v) is made in registers by the thread that
//   owns its fragment element, so the elementwise work is done once per
//   (sample, column); B comes from shared memory, K-major, unswizzled.
// - Each block holds a fixed set of feature tiles: two n8 tiles of
//   [pairs | 1] (one m64n16k8 wgmma) and one n8 tile of shared (m64n8k8),
//   which is the main path's c = 3 exactly.  Wider c takes more blocks over
//   gridDim.z (each recomputes d); narrower c pads with zero features.
//   Compile-time tiles keep branches out of the wgmma sequence.
// - vv_k (one FMA per k) and log h stay on the FP32 pipes; h = lam*ev + 1
//   is rounded as the plain version rounds it and d = __frcp_rn(h).
// - The sample axis is split over gridDim.y just far enough to fill the
//   card in one wave, and into splits of at most 1,024 samples: the tensor
//   cores add each product batch to the float32 accumulator rounding
//   toward zero, so a split's error grows with its length (the wrapper's
//   launch_plan sets both).  Each block writes partial sums to a scratch
//   buffer (nsplit, rows, B*R); k1_reduce_kernel adds them in a fixed
//   order.  No atomics, so two launches give bit-identical results.
//
// Measurement switches.  k1_ablation.py builds this file with one of these
// defined to see where the kernel's time and precision go; the library the
// wrapper builds defines none of them.
// - K1_ABLATE_STREAM_ONLY: the staging pipeline, no arithmetic;
// - K1_ABLATE_NO_PRODUCTS: the wgmma instructions replaced by a register
//   update;
// - K1_ABLATE_APPROX_RCP: __fdividef in place of the correctly rounded
//   reciprocal;
// - K1_ABLATE_ONE_PASS: only the a_hi * b_hi products (one TF32 pass);
// - K1_ABLATE_NO_SPLIT: one pass on the unsplit float32 operands, whose
//   low 13 bits the tensor core ignores (what a plain TF32 GEMM does);
// - K1_ABLATE_FP32_PRODUCTS: the products as FP32 FMAs on the unsplit
//   operands in the same fragment layout (each lane gathers its rows of A
//   from its quad), the staged FP32 baseline of the tensor-core design.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;       // (SNP, slot) columns per block
constexpr int THREADS = 256;    // 2 warpgroups x 64 columns
constexpr int TS = 32;          // samples per pipeline stage
constexpr int STAGES = 4;       // depth of the cp.async ring
constexpr int LDV = COLS + 8;   // v tile row stride: conflict-free reads
constexpr int NBASE = 16;       // [pairs | 1] features per block (2 tiles)
constexpr int NSH = 8;          // shared features per block (1 tile)
constexpr int NF = NBASE + NSH; // features per block
constexpr int SLOTS = 32;       // staging slots per sample (NF used)
// one stage's features: [8-sample step][hi, lo][3 tiles][8x8 K-major tile]
constexpr int FSTEP = 2 * (NF / 8) * 64;
constexpr int FSTAGE = (TS / 8) * FSTEP;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (STAGES * TS * LDV + STAGES * TS + 2 * FSTAGE);

struct Args {
  const float* lam;     // (B, R)
  const float* ev;      // (n,)
  const float* pairs;   // (n, m)
  const float* shared;  // (n, s)
  const float* v;       // (n, B)
  float* part;          // (nsplit, rows, B*R)
  int n, B, R, m, s, span, want_logh, vec_ok;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo with hi = cvt.rna.tf32.f32(x) and lo exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
#if defined(K1_ABLATE_NO_SPLIT) || defined(K1_ABLATE_FP32_PRODUCTS)
  hi = __float_as_uint(x);
  lo = 0u;
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
#endif
}

// Offset (floats) of sample ii, feature slot f of a stage's feature buffer:
// each 8x8 (sample x feature) tile is two core matrices of 8 feature rows
// x 4 consecutive samples (16 bytes), samples 0-3 then 4-7.
__device__ __forceinline__ int feat_at(int ii, int f, int hl) {
  return ((ii / 8) * 2 + hl) * (FSTEP / 2) + (f / 8) * 64 +
         (ii % 8) / 4 * 32 + (f % 8) * 4 + ii % 4;
}

// Feature slot f of feature block z -> row of the F = m + s + 2 output
// layout [pairs | 1 | shared | vv], or -1 for padding.
__device__ __forceinline__ int out_feature(int z, int f, int m, int s) {
  if (f < NBASE) {
    const int p = z * NBASE + f;
    return p <= m ? p : -1;
  }
  const int j = z * NSH + f - NBASE;
  return j < s ? m + 1 + j : -1;
}

// wgmma shared-memory descriptor, unswizzled: core matrices 128 bytes
// apart along K (LBO) and 256 bytes apart along N (SBO).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// c += a * b over the warpgroup's 64 rows: A (TF32, this warp's 16 rows in
// the mma.m16n8k8 fragment layout) from registers, B (8 x N, K-major) from
// shared memory.
__device__ __forceinline__ void wgmma_n16(float* c, const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]),
        "+f"(c[5]), "+f"(c[6]), "+f"(c[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n8(float* c, const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#ifdef K1_ABLATE_FP32_PRODUCTS
// What wgmma_n16 (NT = 2) or wgmma_n8 (NT = 1) adds, as FP32 FMAs: lane
// (g, t4) takes rows g and g + 8 of A over the step's 8 samples from the
// lanes of its quad; b is the step's first feature tile in shared memory.
template <int NT>
__device__ __forceinline__ void fp32_products(float* c, const uint32_t (&a)[4],
                                              const float* b, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int src = g * 4 + kk % 4;
    const float ag = __shfl_sync(0xffffffffu, __uint_as_float(a[kk / 4 * 2]),
                                 src);
    const float ag8 = __shfl_sync(0xffffffffu,
                                  __uint_as_float(a[kk / 4 * 2 + 1]), src);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = b[j * 64 + kk / 4 * 32 + (2 * t4 + e) * 4 + kk % 4];
        c[4 * j + e] = fmaf(ag, bv, c[4 * j + e]);
        c[4 * j + 2 + e] = fmaf(ag8, bv, c[4 * j + 2 + e]);
      }
  }
}
#endif

template <int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
k1_partials_kernel(const Args a) {
  constexpr int FPER = TS / (THREADS / SLOTS);  // staged rows per thread
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;                     // [STAGES][TS][LDV]
  float* evs = vs + STAGES * TS * LDV;  // [STAGES][TS]
  float* fs = evs + STAGES * TS;        // [2 buffers][FSTAGE]

  const int tid = threadIdx.x;
  const int BR = a.B * a.R;
  const int c0 = blockIdx.x * COLS;
  const int split = blockIdx.y;
  const int z = blockIdx.z;  // feature block
  const int F = a.m + a.s + 2;
  const bool lead = z == 0;  // writes vv and log h
  const bool do_logh = a.want_logh && lead;
  const int i_begin = split * a.span;
  const int i_end = min(a.n, i_begin + a.span);
  const int nst = (i_end - i_begin + TS - 1) / TS;

  // SNP columns [b0, b0 + nbv) of v that this block's columns read
  const int b0 = c0 / a.R;
  const int nbv = (min(c0 + COLS, BR) - 1) / a.R + 1 - b0;
  const bool vec = a.vec_ok && b0 % 4 == 0 && nbv % 4 == 0;

  // the feature slot this thread stages, the same for every stage
  const int fl = tid % SLOTS;
  const float* fsrc = nullptr;
  int fstride = 0;
  float fconst = 0.0f;
  {
    const int f = fl < NF ? out_feature(z, fl, a.m, a.s) : -1;
    if (f >= 0 && f < a.m) {
      fsrc = a.pairs + f;
      fstride = a.m;
    } else if (f == a.m) {
      fconst = 1.0f;
    } else if (f > a.m) {
      fsrc = a.shared + (f - a.m - 1);
      fstride = a.s;
    }
  }

  auto load_feat = [&](int st, float (&fr)[FPER]) {
    const int t0 = i_begin + st * TS;
#pragma unroll
    for (int r = 0; r < FPER; ++r) {
      const int i = t0 + tid / SLOTS + r * (THREADS / SLOTS);
      fr[r] = (st < nst && i < i_end)
                  ? (fsrc ? __ldg(fsrc + (size_t)i * fstride) : fconst)
                  : 0.0f;
    }
  };

  auto store_feat = [&](int buf, const float (&fr)[FPER]) {
    float* fb = fs + buf * FSTAGE;
    if (fl < NF) {
#pragma unroll
      for (int r = 0; r < FPER; ++r) {
        const int ii = tid / SLOTS + r * (THREADS / SLOTS);
        uint32_t h, l;
        split_tf32(fr[r], h, l);
        fb[feat_at(ii, fl, 0)] = __uint_as_float(h);
        fb[feat_at(ii, fl, 1)] = __uint_as_float(l);
      }
    }
    // the tensor cores read these through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // v and ev of stage st into ring slot st % STAGES; rows past the split
  // are zero-filled (h = 1, and every feature of theirs is 0)
  auto load_stage = [&](int st) {
    const int buf = st % STAGES;
    const int t0 = i_begin + st * TS;
    const int tn = min(TS, i_end - t0);
    float* vdst = vs + buf * TS * LDV;
    if (vec) {
      const int q = nbv / 4;
      for (int e = tid; e < TS * q; e += THREADS) {
        const int ii = e / q, c4 = e - ii * q;
        const bool ok = ii < tn;
        cp_async16(vdst + ii * LDV + 4 * c4,
                   ok ? a.v + (size_t)(t0 + ii) * a.B + b0 + 4 * c4 : a.v,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < TS * nbv; e += THREADS) {
        const int ii = e / nbv, c = e - ii * nbv;
        const bool ok = ii < tn;
        cp_async4(vdst + ii * LDV + c,
                  ok ? a.v + (size_t)(t0 + ii) * a.B + b0 + c : a.v,
                  ok ? 4 : 0);
      }
    }
    for (int ii = tid; ii < TS; ii += THREADS) {
      const bool ok = ii < tn;
      cp_async4(evs + buf * TS + ii, ok ? a.ev + t0 + ii : a.ev, ok ? 4 : 0);
    }
  };

  // --- per-thread column roles ---------------------------------------------
  // lane (g, t4) of warp w holds fragment rows (columns) g and g + 8 of the
  // warp's 16, and samples t4, t4 + 4 of each 8-sample step
  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int colA = c0 + (tid / 32) * 16 + g;
  const int colB = colA + 8;
  const bool okA = colA < BR, okB = colB < BR;
  const float lamA = okA ? a.lam[colA] : 0.0f;
  const float lamB = okB ? a.lam[colB] : 0.0f;
  const int vbA = okA ? colA / a.R - b0 : 0;
  const int vbB = okB ? colB / a.R - b0 : 0;

  // the wgmma fragments per power k: the two base tiles in [0, 8), the
  // shared tile in [8, 12)
  float acc[KMAX][12];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[k][j] = 0.0f;
  float vvA[KMAX], vvB[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) vvA[k] = vvB[k] = 0.0f;
  float lgA = 0.0f, lgB = 0.0f;

  auto compute = [&](const float* vt, const float* et, const float* fb) {
#ifdef K1_ABLATE_STREAM_ONLY
#pragma unroll
    for (int ks = 0; ks < TS / 8; ++ks) {
      const int r0 = ks * 8 + t4, r1 = r0 + 4;
      acc[0][0] += vt[r0 * LDV + vbA] + fb[feat_at(r0, g, 0)];
      acc[0][1] += vt[r1 * LDV + vbB] + fb[feat_at(r1, g, 1)] + et[r0];
    }
    return;
#endif
    const uint64_t desc0 = smem_desc(fb);
    // A operands of two batches in flight: [batch parity][dh, dl, wh, wl]
    uint32_t A[2][4][4];
#pragma unroll
    for (int ks = 0; ks < TS / 8; ++ks) {
      const int r0 = ks * 8 + t4, r1 = r0 + 4;
      // fragment element q: a0 (row g, r0), a1 (g+8, r0), a2 (g, r1),
      // a3 (g+8, r1)
      const float x[4] = {vt[r0 * LDV + vbA], vt[r0 * LDV + vbB],
                          vt[r1 * LDV + vbA], vt[r1 * LDV + vbB]};
      const float lq[4] = {lamA, lamB, lamA, lamB};
      const float eq[4] = {et[r0], et[r0], et[r1], et[r1]};
      float d[4], dk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // separate roundings, as the plain version computes lam * ev + 1
        const float h = __fadd_rn(__fmul_rn(lq[q], eq[q]), 1.0f);
#ifdef K1_ABLATE_APPROX_RCP
        d[q] = __fdividef(1.0f, h);
#else
        d[q] = __frcp_rn(h);  // == 1.0f / h, correctly rounded
#endif
        dk[q] = d[q];
        if (do_logh) {
          if (q & 1)
            lgB += logf(h);
          else
            lgA += logf(h);
        }
      }
      // the 8-sample step's hi and lo tiles, in wgmma units of 16 bytes
      const uint64_t hi = desc0 + (uint64_t)(ks * FSTEP / 4);
      const uint64_t lo = hi + FSTEP / 8;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k > 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) dk[q] *= d[q];
        }
        // batch (ks, k) writes A[p]; the batch that read it last (two
        // back) is complete, see the wait below
        uint32_t(&Ak)[4][4] = A[(ks * KMAX + k) & 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split_tf32(dk[q], Ak[0][q], Ak[1][q]);
          split_tf32(dk[q] * x[q], Ak[2][q], Ak[3][q]);
        }
        wgmma_fence();  // A was written above
        float* cb = &acc[k][0];
        float* cs = &acc[k][8];
        // base tiles with A = d^k, the shared tile (+ 512 bytes) with d^k v
#if defined(K1_ABLATE_NO_PRODUCTS)
        cb[0] += __uint_as_float(Ak[1][0] ^ Ak[0][1] ^ (uint32_t)hi);
        cb[1] += __uint_as_float(Ak[1][2] ^ Ak[0][3]);
        cs[0] += __uint_as_float(Ak[3][0] ^ Ak[2][1] ^ (uint32_t)lo);
        cs[1] += __uint_as_float(Ak[3][2] ^ Ak[2][3]);
#elif defined(K1_ABLATE_FP32_PRODUCTS)
        fp32_products<2>(cb, Ak[0], fb + ks * FSTEP, g, t4);
        fp32_products<1>(cs, Ak[2], fb + ks * FSTEP + 128, g, t4);
#else
#if !defined(K1_ABLATE_ONE_PASS) && !defined(K1_ABLATE_NO_SPLIT)
        wgmma_n16(cb, Ak[1], hi);
        wgmma_n8(cs, Ak[3], hi + 32);
        wgmma_n16(cb, Ak[0], lo);
        wgmma_n8(cs, Ak[2], lo + 32);
#endif
        wgmma_n16(cb, Ak[0], hi);
        wgmma_n8(cs, Ak[2], hi + 32);
#endif
        wgmma_commit();
        if (lead) {
          vvA[k] = fmaf(dk[0], x[0] * x[0], vvA[k]);
          vvA[k] = fmaf(dk[2], x[2] * x[2], vvA[k]);
          vvB[k] = fmaf(dk[1], x[1] * x[1], vvB[k]);
          vvB[k] = fmaf(dk[3], x[3] * x[3], vvB[k]);
        }
        wgmma_wait<1>();  // all but this batch: the other A is free again
      }
    }
    wgmma_wait<0>();  // the feature buffer is rewritten next stage
  };

  // --- the pipeline -------------------------------------------------------
  float fr[FPER];
  load_feat(0, fr);
  store_feat(0, fr);
  load_feat(1, fr);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();  // stage st has landed (this thread's part)
    __syncthreads();  // ... everyone's; stage st - 1 is fully consumed
    store_feat((st + 1) & 1, fr);  // features of stage st + 1
    load_feat(st + 2, fr);         // held in registers until the next stage
    if (st + STAGES - 1 < nst) load_stage(st + STAGES - 1);
    cp_async_commit();
    compute(vs + (st % STAGES) * TS * LDV, evs + (st % STAGES) * TS,
            fs + (st & 1) * FSTAGE);
  }

  // --- partial sums out ---------------------------------------------------
  float* out = a.part + (size_t)split * (KMAX * F + 1) * BR;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      // fragment value i: n8 tile i / 4, row g (+ 8 when i % 4 >= 2),
      // feature 2 t4 + i % 2 of the tile
      const int f = out_feature(z, (i / 4) * 8 + 2 * t4 + i % 2, a.m, a.s);
      const bool ok = i % 4 < 2 ? okA : okB;
      if (f >= 0 && ok)
        out[(size_t)(k * F + f) * BR + (i % 4 < 2 ? colA : colB)] = acc[k][i];
    }
  if (lead) {
    // each column's vv and log h are spread over the 4 lanes of a quad
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      vvA[k] += __shfl_xor_sync(0xffffffffu, vvA[k], 1);
      vvA[k] += __shfl_xor_sync(0xffffffffu, vvA[k], 2);
      vvB[k] += __shfl_xor_sync(0xffffffffu, vvB[k], 1);
      vvB[k] += __shfl_xor_sync(0xffffffffu, vvB[k], 2);
    }
    lgA += __shfl_xor_sync(0xffffffffu, lgA, 1);
    lgA += __shfl_xor_sync(0xffffffffu, lgA, 2);
    lgB += __shfl_xor_sync(0xffffffffu, lgB, 1);
    lgB += __shfl_xor_sync(0xffffffffu, lgB, 2);
    if (t4 == 0) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (okA) out[(size_t)(k * F + F - 1) * BR + colA] = vvA[k];
        if (okB) out[(size_t)(k * F + F - 1) * BR + colB] = vvB[k];
      }
      if (okA) out[(size_t)(KMAX * F) * BR + colA] = lgA;
      if (okB) out[(size_t)(KMAX * F) * BR + colB] = lgB;
    }
  }
}

__global__ void k1_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int nsplit,
                                 size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[(size_t)sp * total + idx];
  out[idx] = acc;
}

// Occupancy query (launch == false) or launch of one instantiation; returns
// the resident blocks per SM, or 0 after a launch, or minus a CUDA error.
template <int KMAX>
int run_partials(bool launch, const Args* a, dim3 grid, cudaStream_t st) {
  static bool ready = false;  // the > 48 KB dynamic shared memory opt-in
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_partials_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (e != cudaSuccess) return -(int)e;
    ready = true;
  }
  if (!launch) {
    int nb = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, k1_partials_kernel<KMAX>, THREADS, SMEM_BYTES);
    return e == cudaSuccess ? nb : -(int)e;
  }
  k1_partials_kernel<KMAX><<<grid, THREADS, SMEM_BYTES, st>>>(*a);
  return -(int)cudaGetLastError();
}

int select(int kmax, bool launch, const Args* a, dim3 grid, cudaStream_t st) {
  switch (kmax) {
    case 1: return run_partials<1>(launch, a, grid, st);
    case 2: return run_partials<2>(launch, a, grid, st);
    case 3: return run_partials<3>(launch, a, grid, st);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch geometry constants, read by the Python wrapper.
int gram_columns_per_block() { return COLS; }
int gram_base_features_per_block() { return NBASE; }
int gram_shared_features_per_block() { return NSH; }
int gram_sample_tile() { return TS; }

// Resident blocks per SM of the partial-sum kernel, or minus a CUDA error
// code.
int gram_blocks_per_sm(int kmax) {
  return select(kmax, false, nullptr, dim3(), nullptr);
}

// Launches the partial-sum kernel and the fixed-order reduction on
// ``stream``.  ``part`` holds nsplit * rows * B * R floats, ``out`` rows *
// B * R, with rows = kmax * (m + s + 2) + 1.  Returns a CUDA error code.
int gram_fused_launch(const void* lam, const void* ev, const void* pairs,
                      const void* shared, const void* v, void* part, void* out,
                      int n, int B, int R, int m, int s, int kmax,
                      int want_logh, int nsplit, int span, void* stream) {
  Args a;
  a.lam = static_cast<const float*>(lam);
  a.ev = static_cast<const float*>(ev);
  a.pairs = static_cast<const float*>(pairs);
  a.shared = static_cast<const float*>(shared);
  a.v = static_cast<const float*>(v);
  a.part = static_cast<float*>(part);
  a.n = n;
  a.B = B;
  a.R = R;
  a.m = m;
  a.s = s;
  a.span = span;
  a.want_logh = want_logh;
  a.vec_ok = B % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int zblocks = max((m + 1 + NBASE - 1) / NBASE, (s + NSH - 1) / NSH);
  const dim3 grid((B * R + COLS - 1) / COLS, nsplit, zblocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = -select(kmax, true, &a, grid, st);
  if (err != 0) return err;
  const size_t total = (size_t)(kmax * (m + s + 2) + 1) * B * R;
  const unsigned rblocks = (unsigned)((total + 255) / 256);
  k1_reduce_kernel<<<rblocks, 256, 0, st>>>(a.part, static_cast<float*>(out),
                                            nsplit, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
