// Fused per-SNP-lambda Gram statistics for Hopper (sm_90a), plain FP32.
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
// Feature layout.  Per sample i the summands are d^k times one of
// F = m + s + 2 features: [pairs (m) | 1 | shared * v (s) | v * v].  The
// b-independent bases ([pairs | 1 | shared | 1]) are staged in shared memory
// a tile of samples at a time; a thread multiplies each by 1, v or v^2.
//
// What bounds it on the H100: one Newton launch (KMAX = 3) at the main
// path's shape (n = 10,000, B = 2,048, c = 3 -> F = 16) does about 105 flops
// per (sample, SNP) against 4 bytes of genotype read, so the FP32 pipes
// (67 TFLOP/s without tensor cores) bound it, not the 3.35 TB/s of memory.
// The design therefore keeps every accumulator in registers, reads v once,
// coalesced along a sample row, and fills the card by splitting the sample
// axis over blocks as well (B = 2,048 columns are only ~16 blocks of 128).
// Tensor cores are not used: TF32 would break the float32 precision
// contract, and 3xTF32 / wgmma are left for a later change.
//
// Determinism: each block writes its partial sums to a scratch buffer
// (nsplit, rows, B*R); gram_reduce_kernel adds them in a fixed order.  No
// atomics, so repeated launches give bit-identical results.
//
// Width: any c.  A thread keeps KMAX x FC accumulators; when F > FC the
// features are split over gridDim.z and each part recomputes d.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TPB = 128;  // threads per block: one (SNP, slot) column each
constexpr int FC = 16;    // features per chunk (accumulators per k)
constexpr int TILE = 64;  // samples staged in shared memory per step

template <int KMAX>
__global__ void __launch_bounds__(TPB)
gram_partials_kernel(const float* __restrict__ lam,     // (B, R)
                     const float* __restrict__ ev,      // (n,)
                     const float* __restrict__ pairs,   // (n, m)
                     const float* __restrict__ shared,  // (n, s)
                     const float* __restrict__ v,       // (n, B)
                     float* __restrict__ part,  // (nsplit, rows, B*R)
                     int n, int B, int R, int m, int s, int span,
                     int want_logh) {
  const int BR = B * R;
  const int col = blockIdx.x * TPB + threadIdx.x;
  const int split = blockIdx.y;
  const int chunk = blockIdx.z;
  const int F = m + s + 2;
  const int f0 = chunk * FC;
  const int rows = KMAX * F + 1;
  const int i_begin = split * span;
  const int i_end = min(n, i_begin + span);
  const bool active = col < BR;
  const int b = active ? col / R : 0;
  const float lam_c = active ? lam[col] : 0.0f;  // lam[b * R + r]
  const bool do_logh = want_logh && chunk == 0;

  __shared__ float base_sh[TILE][FC];
  __shared__ float ev_sh[TILE];

  float acc[KMAX][FC];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[k][j] = 0.0f;
  float logh = 0.0f;

  for (int t0 = i_begin; t0 < i_end; t0 += TILE) {
    const int tn = min(TILE, i_end - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < TILE * FC; e += TPB) {
      const int ii = e / FC;
      const int f = f0 + e % FC;
      float val = 0.0f;
      if (ii < tn) {
        const size_t i = (size_t)(t0 + ii);
        if (f < m)
          val = pairs[i * m + f];
        else if (f == m)
          val = 1.0f;
        else if (f <= m + s)
          val = shared[i * s + (f - m - 1)];
        else if (f == m + s + 1)
          val = 1.0f;
      }
      base_sh[ii][e % FC] = val;
    }
    for (int ii = threadIdx.x; ii < TILE; ii += TPB)
      ev_sh[ii] = ii < tn ? ev[t0 + ii] : 0.0f;
    __syncthreads();
    if (!active) continue;
    for (int ii = 0; ii < tn; ++ii) {
      const float x = v[(size_t)(t0 + ii) * B + b];
      const float x2 = x * x;
      // separate roundings, as the plain version computes lam * ev + 1
      const float h = __fadd_rn(__fmul_rn(lam_c, ev_sh[ii]), 1.0f);
      float dk[KMAX];
      dk[0] = __frcp_rn(h);  // == 1.0f / h, correctly rounded
#pragma unroll
      for (int k = 1; k < KMAX; ++k) dk[k] = dk[k - 1] * dk[0];
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const int f = f0 + j;
        const float mult = f <= m ? 1.0f : (f <= m + s ? x : x2);
        const float t = base_sh[ii][j] * mult;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) acc[k][j] = fmaf(dk[k], t, acc[k][j]);
      }
      if (do_logh) logh += logf(h);
    }
  }

  if (!active) return;
  float* out = part + (size_t)split * rows * BR + col;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      const int f = f0 + j;
      if (f < F) out[(size_t)(k * F + f) * BR] = acc[k][j];
    }
  if (chunk == 0) out[(size_t)(KMAX * F) * BR] = logh;
}

__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nsplit,
                                   size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[(size_t)sp * total + idx];
  out[idx] = acc;
}

}  // namespace

extern "C" {

// Launch geometry constants, read by the Python wrapper.
int gram_threads_per_block() { return TPB; }
int gram_features_per_chunk() { return FC; }
int gram_sample_tile() { return TILE; }

// Launches the partial-sum kernel and the fixed-order reduction on
// ``stream``.  ``part`` holds nsplit * rows * B * R floats, ``out`` rows *
// B * R, with rows = kmax * (m + s + 2) + 1.  Returns cudaGetLastError().
int gram_fused_launch(const void* lam, const void* ev, const void* pairs,
                      const void* shared, const void* v, void* part, void* out,
                      int n, int B, int R, int m, int s, int kmax,
                      int want_logh, int nsplit, int span, void* stream) {
  const int F = m + s + 2;
  const int nchunks = (F + FC - 1) / FC;
  const dim3 grid((B * R + TPB - 1) / TPB, nsplit, nchunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(lam);
  const float* e = static_cast<const float*>(ev);
  const float* p = static_cast<const float*>(pairs);
  const float* sh = static_cast<const float*>(shared);
  const float* x = static_cast<const float*>(v);
  float* pt = static_cast<float*>(part);
  switch (kmax) {
    case 1:
      gram_partials_kernel<1><<<grid, TPB, 0, st>>>(a, e, p, sh, x, pt, n, B,
                                                    R, m, s, span, want_logh);
      break;
    case 2:
      gram_partials_kernel<2><<<grid, TPB, 0, st>>>(a, e, p, sh, x, pt, n, B,
                                                    R, m, s, span, want_logh);
      break;
    case 3:
      gram_partials_kernel<3><<<grid, TPB, 0, st>>>(a, e, p, sh, x, pt, n, B,
                                                    R, m, s, span, want_logh);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)(kmax * F + 1) * B * R;
  const unsigned rblocks = (unsigned)((total + 255) / 256);
  gram_reduce_kernel<<<rblocks, 256, 0, st>>>(pt, static_cast<float*>(out),
                                              nsplit, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
