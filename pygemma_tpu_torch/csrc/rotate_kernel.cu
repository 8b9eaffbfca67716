// The rotation of a SNP block into the kinship's eigenbasis, C = U' X, for
// Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves the rotation to an XLA
// dot (pygemma_tpu/core/eigen.py::rotate and the top-space rotation of
// pygemma_tpu/api.py), and the port first left it to torch.matmul, which on
// the card is cuBLAS's SGEMM on the FP32 pipes.  It was added because that
// GEMM took most of the card's time in every 2-bit biobank scan: U' is
// (r, n), the block (n, B); r = p_k = 16,384, n = 50,000 and B = 4,096
// (1,024 a rank on four cards) on the implicit low-rank path, r = n =
// 10,000 and B = 2,048 on the dense one.
//
// What bounds it on the H100.  Operations: 2 r n B a call (6.7e12 at the
// implicit shape), at 165 TFLOP/s for float32-grade products on the tensor
// cores (495 TFLOP/s TF32 over three passes): 40.7 ms.  Bytes: U, the block
// and C once, 4.4 GB, 1.3 ms at 3.35 TB/s.  So the tensor cores bound it
// on paper.  On the card the data path binds first: without its wgmmas
// this design takes ~68 ms at the implicit shape (the TMA ring and the
// producer's layout of B, ~3.1 TB/s into the SMs, as fast with its tiles
// held in L2), and 83 ms with them, 49% of the bound (55% at the dense
// shape), against cuBLAS's 122 ms.
//
// The design.
// - Layout.  Both operands come with the samples (K) as their slow index:
//   U is (n, r) row-major on the implicit path (or (r, n) row-major, i.e.
//   column-major U, as cuSOLVER returns a dense basis: the template flag
//   AK), the block (n, B) row-major.  For .tf32, wgmma reads only K-major
//   tiles from shared memory.  So A = U' comes through registers: each
//   consumer thread loads its fragment from the TMA tile (128-byte swizzle,
//   in either layout) with conflict-free 4-byte loads.  B = the block is
//   laid out K-major by the producer warpgroup: TMA lands its tile as it
//   lies in memory (32 samples x 128 SNPs), each producer thread reads one
//   SNP's 32 samples, and after a barrier writes them back in place, K-major
//   with the 128-byte swizzle, as the TF32 hi part, and the lo part beside
//   it.  No copy of U and no stored split of it exists; the kernel's only
//   memory is C.
// - Ragged shapes.  TMA reads rows of a whole number of 16 bytes from a
//   16-byte boundary.  The block always comes so: B is a multiple of 4 (the
//   wrapper pads a block of 2,049 SNPs into a block-sized scratch of 2,052
//   zero-filled columns).  U's rows (r floats row-major, n column-major; a
//   cohort of 10,001 samples) cannot be copied: where they are not, the
//   producer warpgroup copies U's tile with plain 4-byte cp.async,
//   coalesced, into the very places TMA would lay it, in the same ring and
//   as far ahead (a build of its own).  Both ways zero-fill past r and n,
//   and rows and columns of C past r and B are never stored.
// - Split.  3xTF32: hi = cvt.rna.tf32(x) (add half a TF32 ulp to the bits,
//   clear the low 13), lo = x - hi (exact in float32) rounded to TF32 the
//   same way; C += lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms
//   first: ~2^-22 relative a product, where one TF32 pass keeps ~3 digits
//   and breaks the float32 contract.  A is split in registers by the thread
//   that owns the fragment, B once a stage by the producer.
// - Accumulator.  The tensor cores add each batch of products to the
//   float32 accumulator rounding toward zero, so their error grows with the
//   length summed (2e-5 of the largest sum at 2,048 samples for K1;
//   k1_ablation.py).  K = n is 50,000 here.  The partial sums leave the
//   wgmma accumulator every PROMOTE stages (128 samples) for a
//   round-to-nearest float32 sum in registers, 64 more a thread.  Splitting
//   K instead would need a C-sized scratch per split and a second pass;
//   promotion needs neither, and the sums stay in a fixed order, so two
//   launches give bit-identical results.  The two consumer warpgroups
//   promote half an interval apart, so one keeps the tensor cores busy
//   while the other drains.
// - Tiles.  One persistent block a SM walks 128 x 128 tiles of C (grouped 8
//   row tiles at a time, so that the blocks in flight share their U and
//   block panels in L2); a producer warpgroup keeps a ring of STAGES stages
//   of 32 samples in flight with TMA (A and the raw B tile, 32 KB a stage,
//   zero-filled past the ragged edges) and lays B out; two consumer
//   warpgroups of 64 rows each run m64n128k8 wgmmas on it.  Rows and
//   columns past r and B are never stored.
// - A wait that never completes traps (an error, not a hung card).

#include <cuda.h>  // the tensor map's types; the driver is not linked
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows of C (columns of U) a tile
constexpr int BN = 128;       // columns of C (SNPs) a tile
constexpr int BK = 32;        // samples a stage: one 128-byte swizzle row
constexpr int STAGES = 4;     // depth of the ring
constexpr int PROMOTE = 4;    // stages between promotions (128 samples)
constexpr int GROUP_M = 8;    // row tiles a raster group
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int TILE_BYTES = BK * BM * 4;  // 16 KB: the A tile, the B tile
constexpr int STAGE_BYTES = 3 * TILE_BYTES;  // A | B (raw, then hi) | B lo
constexpr int BARRIERS = 3 * STAGES;
constexpr size_t SMEM_BYTES =
    (size_t)STAGES * STAGE_BYTES + BARRIERS * 8 + 1024;  // + alignment
static_assert(BM == BN, "the A and B tiles share TILE_BYTES");

struct Args {
  float* c;  // (M, N) row-major
  int M, N, K, tiles_m, tiles_n, nk;
  const float* u;  // U (K, M) row-major, or with AK (M, K) row-major: read
                   // by the cp.async build only
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait for the phase of ``parity`` to complete; the loop lives in PTX so
// that the compiler sees no divergent path around the wgmmas.  After 2^25
// polls it traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 i;\nmov.u32 i, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 i, i, 1;\n"
      "setp.ne.u32 p, i, 33554432;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One float from global to shared memory, asynchronously; zeros where
// ``in`` is false (nothing is read then).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// An arrival on ``bar`` once this thread's cp.async copies so far have
// landed (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// x = hi + lo + O(2^-22 x): hi = cvt.rna.tf32.f32(x) and lo the TF32
// rounding of x - hi, which is exact in float32 but has up to 13 bits.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// d (+)= a * b over the warpgroup's 64 rows and 128 columns: A (TF32, this
// warp's 16 rows in the mma.m16n8k8 fragment layout) from registers, B (8
// samples x 128 columns, K-major) from shared memory; scale_d = 0 writes
// the product instead of adding it.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Tile t of the raster -> (row tile, column tile): GROUP_M row tiles at a
// time, the column tiles of a group in turn.
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per = GROUP_M * tiles_n;
  const int first = (t / per) * GROUP_M;
  const int gm = min(GROUP_M, tiles_m - first);
  const int in = t % per;
  tm = first + in % gm;
  tn = in / gm;
}

// Byte offset of U'[m][k] (tile-local) in a stage's A tile.  AK: U' is
// K-major in memory, the tile one TMA box of 128 rows x 32 samples;
// otherwise four boxes of 32 samples x 32 rows.  Both with the 128-byte
// swizzle (16-byte chunk c of a 128-byte row stored at c ^ (row % 8)).
template <bool AK>
__device__ __forceinline__ int a_offset(int m, int k) {
  if (AK) return m * 128 + ((((k >> 2) ^ (m & 7))) << 4) + (k & 3) * 4;
  return (m >> 5) * 4096 + k * 128 + ((((m & 31) >> 2) ^ (k & 7)) << 4) +
         (m & 3) * 4;
}

// PLAIN: U is read by cp.async (a build of its own, so that the all-TMA
// build carries none of that code in its producer).
template <bool AK, bool PLAIN>
__global__ void __launch_bounds__(THREADS, 1)
    rotate_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(base);
  const uint32_t bars = sbase + STAGES * STAGE_BYTES;
  // raw_full: the stage's tiles landed; full: B laid out; empty: consumed
  auto raw_full = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // thread 0's arrival (with the TMA bytes), and where U is read by
      // cp.async each producer thread's
      mbar_init(raw_full(s), PLAIN ? 129 : 1);
      mbar_init(full(s), 128);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = a.tiles_m * a.tiles_n;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;  // tiles of this block
  const int total = mine * a.nk;      // stages of this block
  // warp-uniform as far as the compiler can tell: no divergent wgmma path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == 0) {
    // ---- producer: the loads and the K-major layout of B ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int t = tid;
    // stage q's B tile, landed as it lies: this thread's SNP, K-major in
    // place as TF32 hi with lo beside it, handed to the tensor cores
    auto lay_out = [&](int q) {
      const int s = q % STAGES;
      mbar_wait(raw_full(s), (q / STAGES) & 1);
      uint8_t* hi = base + s * STAGE_BYTES + TILE_BYTES;
      uint8_t* lo = hi + TILE_BYTES;
      const float* raw = reinterpret_cast<const float*>(hi);
      float v[BK];
#pragma unroll
      for (int k = 0; k < BK; ++k) v[k] = raw[k * BN + t];
      // every SNP's samples are read before the tile is written over (not
      // .aligned: thread 0 may be issuing loads while its warp waits here)
      asm volatile("barrier.sync 1, 128;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[4 * c + i], h[i], l[i]);
        const int off = t * 128 + ((c ^ (t & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      // the tensor cores read them through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full(s));
    };
    if constexpr (!PLAIN) {
      // both operands by TMA, from thread 0
      auto load = [&](int j) {
        const int s = j % STAGES;
        const int tile = (int)blockIdx.x + (j / a.nk) * (int)gridDim.x;
        const int k0 = (j % a.nk) * BK;
        int tm, tn;
        tile_of(tile, a.tiles_m, a.tiles_n, tm, tn);
        const int m0 = tm * BM;
        const uint32_t dst = sbase + s * STAGE_BYTES;
        if (AK) {
          mbar_expect_tx(raw_full(s), 2 * TILE_BYTES);
          tma_load(dst, &map_a, raw_full(s), k0, m0);
        } else {
          // boxes wholly past the last row are not loaded: their rows of C
          // are never stored
          const int boxes = min(4, (a.M - m0 + 31) / 32);
          mbar_expect_tx(raw_full(s), boxes * (TILE_BYTES / 4) + TILE_BYTES);
          for (int b = 0; b < boxes; ++b)
            tma_load(dst + b * (TILE_BYTES / 4), &map_a, raw_full(s),
                     m0 + 32 * b, k0);
        }
        tma_load(dst + TILE_BYTES, &map_b, raw_full(s), tn * BN, k0);
      };
      // the ring: the consumers on stage q - 1, this warpgroup laying out
      // q, TMA loading q + 1 and q + 2
      if (t == 0)
        for (int j = 0; j < STAGES - 2 && j < total; ++j) load(j);
      for (int q = 0; q < total; ++q) {
        if (t == 0 && q + STAGES - 2 < total) {
          const int j = q + STAGES - 2;  // into the slot of stage q - 2
          if (j >= STAGES) mbar_wait(empty(j % STAGES), (j / STAGES - 1) & 1);
          load(j);
        }
        lay_out(q);
      }
    } else {
      // U's tile by every producer thread's cp.async into the places TMA
      // would lay it; the block's by TMA from thread 0
      const int lane = t % 32, w = t / 32;
      auto load = [&](int j) {
        const int s = j % STAGES;
        const int tile = (int)blockIdx.x + (j / a.nk) * (int)gridDim.x;
        const int k0 = (j % a.nk) * BK;
        int tm, tn;
        tile_of(tile, a.tiles_m, a.tiles_n, tm, tn);
        const int m0 = tm * BM;
        const uint32_t dst = sbase + s * STAGE_BYTES;
        if (t == 0) {
          mbar_expect_tx(raw_full(s), TILE_BYTES);
          tma_load(dst + TILE_BYTES, &map_b, raw_full(s), tn * BN, k0);
        }
        // a warp copies 128 contiguous bytes a step (32 samples of one row
        // of U' with AK, 32 rows of U' at one sample without)
#pragma unroll 4
        for (int i = 0; i < BM * BK / 128; ++i) {
          const int m = AK ? w + 4 * i : 32 * (i % 4) + lane;
          const int k = AK ? lane : 4 * (i / 4) + w;
          const bool in = m0 + m < a.M && k0 + k < a.K;
          const float* src = AK ? a.u + (size_t)(m0 + m) * a.K + (k0 + k)
                                : a.u + (size_t)(k0 + k) * a.M + (m0 + m);
          cp_async4(dst + a_offset<AK>(m, k), in ? src : a.u, in);
        }
        // the phase needs thread 0's arrival and these 128 (init: 129)
        cp_async_arrive(raw_full(s));
      };
      for (int j = 0; j < STAGES - 2 && j < total; ++j) load(j);
      for (int q = 0; q < total; ++q) {
        if (q + STAGES - 2 < total) {
          const int j = q + STAGES - 2;  // into the slot of stage q - 2
          if (j >= STAGES) mbar_wait(empty(j % STAGES), (j / STAGES - 1) & 1);
          load(j);
        }
        lay_out(q);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each, wgmma and the promoted sums ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int c = wg - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, ga = g / 4, gb = g % 4;
  // the rows of C this thread's fragment holds (e = 0: row g of the warp's
  // 16, e = 1: row g + 8), placed so that the fragment loads of a warp hit
  // 32 distinct banks in either layout of A
  int row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    row[e] = 64 * c + 32 * (warp / 2) + 16 * ga + 8 * (warp % 2) +
             4 * (ga ^ e) + gb;

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t frag[2][2][4];  // [step parity][hi, lo][element]
  int q = 0, pending = -1;  // pending: a slot still to be released
  for (int tl = 0; tl < mine; ++tl) {
    int tm, tn;
    tile_of((int)blockIdx.x + tl * (int)gridDim.x, a.tiles_m, a.tiles_n, tm,
            tn);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
    int fresh = 1;  // the next product starts a promotion interval
    for (int kq = 0; kq < a.nk; ++kq, ++q) {
      const int s = q % STAGES;
      const uint32_t parity = (q / STAGES) & 1;
      mbar_wait(raw_full(s), parity);
      mbar_wait(full(s), parity);
      const uint8_t* at = base + s * STAGE_BYTES;
      const uint64_t dhi = desc_sw128(sbase + s * STAGE_BYTES + TILE_BYTES);
      const uint64_t dlo = dhi + (TILE_BYTES >> 4);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t(&f)[2][4] = frag[ks & 1];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(*reinterpret_cast<const float*>(
                         at + a_offset<AK>(row[e & 1], 8 * ks + t4 + 4 * (e >> 1))),
                     f[0][e], f[1][e]);
        wgmma_fence();
        wgmma_n128(acc, f[1], dhi + 2 * ks, !fresh);  // lo_a hi_b
        wgmma_n128(acc, f[0], dlo + 2 * ks, 1);       // hi_a lo_b
        wgmma_n128(acc, f[0], dhi + 2 * ks, 1);       // hi_a hi_b
        fresh = 0;
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its A is free again
        if (ks == 0 && pending >= 0) {  // ... and so is the stage before
          mbar_arrive(empty(pending));
          pending = -1;
        }
      }
      pending = s;
      if (kq == a.nk - 1 || (kq + c * (PROMOTE / 2)) % PROMOTE == PROMOTE - 1) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        fresh = 1;
        mbar_arrive(empty(pending));
        pending = -1;
      }
    }
    // fragment value 4j + 2e + h: row e, column 8j + 2 t4 + h of the tile
    const int n0 = tn * BN + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = tm * BM + row[e];
      if (m >= a.M) continue;
      float* out = a.c + (size_t)m * a.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j;
        if (col < a.N)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(sum[4 * j + 2 * e], sum[4 * j + 2 * e + 1]);
      }
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime (so the
// library links no driver of its own).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !p) return 200000 + (int)q;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return 0;
}

// A 2-D float32 tensor map: ``inner`` contiguous elements a row, ``outer``
// rows ``row_bytes`` apart; boxes of box_inner x box_outer.
int encode(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
           uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
           CUtensorMapSwizzle swizzle) {
  EncodeTiled fn;
  const int err = encoder(&fn);
  if (err) return err;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 100000 + (int)r;
}

template <bool AK, bool PLAIN>
int run(const CUtensorMap& ma, const CUtensorMap& mb, const Args& a, int grid,
        cudaStream_t st) {
  static bool ready = false;  // the > 48 KB dynamic shared memory opt-in
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        rotate_kernel<AK, PLAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  rotate_kernel<AK, PLAIN><<<grid, THREADS, SMEM_BYTES, st>>>(ma, mb, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry, read by the Python wrapper.
int rotate_tile_m() { return BM; }
int rotate_tile_n() { return BN; }
int rotate_promote_samples() { return PROMOTE * BK; }

// C (r, B) = U' X on ``stream`` for float32 U and X with the samples as
// their slow index: X (n, B) row-major, B a multiple of 4 and X on a
// 16-byte boundary; U (n, r) row-major, or with ``u_kmajor`` (r, n)
// row-major (a column-major U).  ``tma_u``: U's rows are a whole number of
// 16 bytes from a 16-byte boundary, and TMA reads them; else cp.async.
// ``blocks`` is the persistent grid's size (the card's SMs).  Returns 0, a
// CUDA error code, 100000 plus libcuda's error from encoding a tensor map,
// or 200000 plus the runtime's answer when it finds no encoder.
int rotate_launch(const void* u, const void* x, void* c, int n, int r, int b,
                  int u_kmajor, int tma_u, int blocks, void* stream) {
  CUtensorMap ma = {}, mb;  // U read by cp.async: ma unused
  int err = 0;
  if (tma_u)
    err = u_kmajor ? encode(&ma, u, n, r, (uint64_t)n * 4, BK, BM,
                            CU_TENSOR_MAP_SWIZZLE_128B)
                   : encode(&ma, u, r, n, (uint64_t)r * 4, 32, BK,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode(&mb, x, b, n, (uint64_t)b * 4, BN, BK,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  Args a;
  a.u = static_cast<const float*>(u);
  a.c = static_cast<float*>(c);
  a.M = r;
  a.N = b;
  a.K = n;
  a.tiles_m = (r + BM - 1) / BM;
  a.tiles_n = (b + BN - 1) / BN;
  a.nk = (n + BK - 1) / BK;
  const int grid = min(blocks, a.tiles_m * a.tiles_n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma_u)
    return u_kmajor ? run<true, false>(ma, mb, a, grid, st)
                    : run<false, false>(ma, mb, a, grid, st);
  return u_kmajor ? run<true, true>(ma, mb, a, grid, st)
                  : run<false, true>(ma, mb, a, grid, st);
}

}  // extern "C"
