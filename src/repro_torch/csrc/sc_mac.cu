// Moment-matched SC matmul for Hopper (sm_90a): kernels 5 and 6 of the
// port, on the tensor cores.
//
// Replaces the Pallas kernels src/repro/kernels/sc_mac.py:sc_mac_fused
// (body _sc_mac_kernel; noise streamed in as an (M, N) input) and
// sc_mac_fused_prng (body _sc_mac_kernel_prng; noise made in the kernel).
// On signed probabilities x (M, K) and w (K, N) both compute, in one pass
// over the operand tiles,
//
//   mean = x . w,   p = |x| . |w|,   p2 = x^2 . w^2,
//
// and emit out = mean + z * sqrt(max(p - p2, 0) * inv_nbit) with z a
// standard normal: the CLT law of the SOT-MRAM MAC pop-count.
//
// Float32 accuracy on TF32 tensor cores (3xTF32).  A TF32 operand keeps
// 11 significant bits, and an MMA fed raw float32 truncates the other
// 13.  So every operand v is split explicitly, hi = cvt.rna.tf32(v) and
// lo = cvt.rna.tf32(v - hi), and each sum takes three products,
// hi.hi + hi.lo + lo.hi, accumulated in float32: the dropped lo.lo term
// is 2^-22 of a product, below float32's own rounding of the sums.  On
// the operand grid (sc.encoding.quantize_grid with operand_bits <= 10,
// which pallas_moment says to kernel 5 through ``on_grid``) x, w, |x|
// and |w| are exact in TF32 (lo = 0), so only x^2 . w^2 needs its three
// products: 5 MMAs per operand pair instead of 9.  Kernel 6 has no caller
// that knows its operands' grid and always takes the 9.  p and p2 share one accumulator,
// d = p - p2 (the square products enter with A negated), so the
// cancellation happens inside the float32 sum and not after it.
//
// What bounds it on this card: tensor-core operations first.  9 (or 5)
// products per operand pair are 18 (10) * M*K*N TF32 flops at 2,048 a
// clock per SM (535 TFLOP/s at the 1,980 MHz max clock; the datasheet's
// 495 assumes ~1.83 GHz), against 6*M*K*N at 256 a clock (67 TFLOP/s)
// on the FP32 cores: 2.5x (4.5x) less time, far above the TF32 ridge
// (~160 flops per byte) at the trainer's shapes.  Second, shared memory: a TF32 wgmma at full rate
// reads 64 bytes of B a clock of the SM's 128, and the staging of x and
// w, the derived x operands and the A fragments take most of the rest
// (about 0.125 bytes per MAC on the grid: PERF.md has the budget).
//
// Design (computing the transposed tile out^T = w^T . x^T):
// * wgmma m64n64k8 TF32, A from registers, B from shared memory.  TF32
//   wgmma takes both operands K-major only.  x (M, K) row-major is
//   K-major: its tile is B, loaded by TMA with the 128-byte swizzle the
//   wgmma descriptor reads.  w is A: each thread loads its fragment from
//   the staged tile with ld.shared (offsets fixed per thread, a template
//   per layout), so w may be row-major (K, N) or the K-major view (the
//   tied unembed's table.T) without a copy, and the abs, square and
//   hi/lo split of w are register work.
// * A block is one producer warpgroup and two consumer warpgroups, each
//   owning 64 columns of the 128 x 64 (N x M) output tile in two 64 x 64
//   float32 accumulators (64 registers a thread).  One producer thread
//   keeps a ring of 4 stages of BK = 32 full with TMA loads (completion
//   on mbarriers); the producer's 128 threads make each stage's derived
//   B operands (x hi/lo, |x| hi/lo, x^2 hi/lo) from the staged x tile
//   into a double buffer in the same swizzled layout (elementwise, by
//   float4), a stage ahead of the MMAs.  Consumers wait on mbarriers
//   only, and keep the A fragments of two k8 steps in flight
//   (wgmma.wait_group 1).  Every warp keeps the 168 registers of the
//   launch bound: the consumers fit in them without spills, and the
//   producer's derive needs more than setmaxnreg could safely leave it.
// * The epilogue issues all of a thread's noise loads before its stores.
// * TMA zero-fills the ragged edges (zeros are inert in all the sums); it
//   needs 16-byte row strides, so the wrapper pads K and N to multiples
//   of 4.
// * Deterministic split-K where the output tiles underfill the 132 SMs
//   (kernels/sc_mac.py:sc_mac_plan): each split writes its partial sums
//   (x.w and p - p2) to a workspace and sc_mac_reduce_kernel adds them
//   in split order and applies the epilogue, so two launches are
//   bit-equal (no float atomics).
//
// Kernel 6's noise: the TPU's per-tile prng stream cannot be reproduced,
// so each output (i, j) draws two words from Threefry-2x32 keyed
// (0, seed) at counters (0, 2*idx) and (0, 2*idx + 1), idx = i*N + j
// (mod 2^32): the draw depends on the element, not on the tile.  The
// words go through the reference's _box_muller.

#include <cuda.h>

#include <algorithm>

#include "sc_device.cuh"

namespace {

constexpr int kBN = 128;  // output columns per block (w side, wgmma M)
constexpr int kBM = 64;   // output rows per block (x side, wgmma N)
constexpr int kBK = 32;   // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kWTileFloats = kBN * kBK;  // 16 KB
constexpr int kXTileFloats = kBM * kBK;  // 8 KB
constexpr int kDerived = 6;  // x hi, x lo, |x| hi, |x| lo, x^2 hi, x^2 lo

struct Smem {
  float w[kStages][kWTileFloats];
  float x[kStages][kXTileFloats];
  float d[2][kDerived][kXTileFloats];
  uint64_t full[kStages];   // TMA landed (raw x and w of a stage)
  uint64_t empty[kStages];  // both consumers done with a stage's w
  uint64_t dfull[2];        // derived x of a stage made
  uint64_t dempty[2];       // both consumers' MMAs on it retired
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The split of one operand: (hi, lo) of v, |v| and v^2.  |v|'s hi is
// |hi| and its lo is lo with v's sign taken off (cvt.rna is symmetric).
struct Split {
  float hi, lo, ahi, alo, qhi, qlo;
};

template <bool kGrid>
__device__ __forceinline__ Split split_of(float v) {
  Split s;
  if constexpr (kGrid) {
    s.hi = v;
    s.lo = 0.0f;
    s.ahi = fabsf(v);
    s.alo = 0.0f;
  } else {
    s.hi = tf32_rna(v);
    s.lo = tf32_rna(v - s.hi);
    s.ahi = fabsf(s.hi);
    const uint32_t sign = __float_as_uint(v) & 0x80000000u;
    s.alo = __uint_as_float(__float_as_uint(s.lo) ^ sign);
  }
  const float q = v * v;
  s.qhi = tf32_rna(q);
  s.qlo = tf32_rna(q - s.qhi);
  return s;
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  uint64_t d = (addr & 0x3FFFFull) >> 4;
  d |= 1ull << 16;                // LBO (ignored for swizzled K-major)
  d |= (1024ull >> 4) << 32;      // SBO
  d |= 1ull << 62;                // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of an operand
// that an in-flight wgmma owns across this point.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x 64 float32, this thread's 32) += kScaleA * A (64 x 8 TF32,
// registers) . B (64 x 8 TF32, shared memory, descriptor).
template <int kScaleA = 1>
__device__ __forceinline__ void wgmma_rs(float* d, float a0, float a1,
                                         float a2, float a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, %38, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)), "l"(desc),
        "r"(1), "n"(kScaleA));
}

// The reference's _box_muller: u = (bits >> 8) * 2^-24,
// u1 = max(u1, 1e-12), z = sqrt(-2 log u1) * cos(2 pi u2).
__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float inv24 = 1.0f / 16777216.0f;
  float u1 = static_cast<float>(a >> 8) * inv24;
  const float u2 = static_cast<float>(b >> 8) * inv24;
  u1 = fmaxf(u1, 1e-12f);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.2831855f * u2);
}

template <bool kPrng>
__device__ __forceinline__ float noise_at(const float* noise, uint32_t seed,
                                          size_t idx) {
  if constexpr (kPrng) {
    const uint32_t ctr = 2u * static_cast<uint32_t>(idx);
    return box_muller(repro::threefry2x32_x0(0u, seed, 0u, ctr),
                      repro::threefry2x32_x0(0u, seed, 0u, ctr + 1u));
  } else {
    return noise[idx];
  }
}

// d = p - p2, the sum of |x||w| - x^2 w^2 over K.
__device__ __forceinline__ float moment_out(float mean, float d, float z,
                                            float inv_nbit) {
  const float var = fmaxf(d, 0.0f) * inv_nbit;
  return mean + z * sqrtf(var);
}

// Byte offset of w element (k, n) of a staged tile (k < 8, n < kBN), and
// of (k + 8j, n).  Row-major w arrives as 4 boxes of 32 k-rows x 32
// columns, the K-major view as one box of kBN rows x 32 k; both carry the
// 128-byte swizzle (16-byte chunk c of 128-byte row r sits at chunk
// c ^ (r % 8)).  Row-major: k + 8j is 8j rows down, the same swizzle.
// K-major: it is chunk (k / 4 + 2j) ^ (n % 8) = the chunk of k XOR 2j.
template <bool kKMajor>
__device__ __forceinline__ uint32_t w_offset(int k, int n) {
  if constexpr (kKMajor) {
    return n * 128 + ((((k >> 2) ^ n) & 7) << 4) + ((k & 3) << 2);
  }
  const int nn = n & 31;
  return (n >> 5) * 4096 + k * 128 + ((((nn >> 2) ^ k) & 7) << 4) +
         ((nn & 3) << 2);
}

template <bool kKMajor>
__device__ __forceinline__ uint32_t w_step(uint32_t offset, int j) {
  return kKMajor ? offset ^ (j << 5) : offset + j * 1024;
}

// The derived B operands of one staged x tile, elementwise (the layout
// is the same, so a float4 maps to the same offset in every array): the
// producer warpgroup's 128 threads, 4 float4 each.
template <bool kGrid>
__device__ __forceinline__ void derive_x(const float* xs,
                                         float (*dst)[kXTileFloats],
                                         int ptid) {
#pragma unroll
  for (int r = 0; r < kXTileFloats / 4 / 128; ++r) {
    const int i = ptid + r * 128;
    const float4 v = reinterpret_cast<const float4*>(xs)[i];
    const Split e0 = split_of<kGrid>(v.x), e1 = split_of<kGrid>(v.y);
    const Split e2 = split_of<kGrid>(v.z), e3 = split_of<kGrid>(v.w);
    auto put = [&](int arr, float Split::*f) {
      reinterpret_cast<float4*>(dst[arr])[i] =
          make_float4(e0.*f, e1.*f, e2.*f, e3.*f);
    };
    put(0, &Split::hi);
    put(2, &Split::ahi);
    put(4, &Split::qhi);
    put(5, &Split::qlo);
    if constexpr (!kGrid) {  // on the grid the lo parts are 0, never read
      put(1, &Split::lo);
      put(3, &Split::alo);
    }
  }
}

// One k8 step of a consumer warpgroup.  mean += x.w; var += |x|.|w| -
// x^2.w^2 in one accumulator (the square products enter with A negated),
// so the cancellation of p - p2 happens inside the float32 sum.
template <bool kGrid>
__device__ __forceinline__ void mma_step(float* am, float* av,
                                         const Split (&a)[4],
                                         float (*xd)[kXTileFloats], int j) {
  const int off = j * 32;  // bytes: the k8 slice of the 128-byte row
  auto desc = [&](int arr) {
    return desc_sw128(reinterpret_cast<const char*>(xd[arr]) + off);
  };
  wgmma_rs(am, a[0].hi, a[1].hi, a[2].hi, a[3].hi, desc(0));
  wgmma_rs(av, a[0].ahi, a[1].ahi, a[2].ahi, a[3].ahi, desc(2));
  wgmma_rs<-1>(av, a[0].qhi, a[1].qhi, a[2].qhi, a[3].qhi, desc(4));
  wgmma_rs<-1>(av, a[0].qhi, a[1].qhi, a[2].qhi, a[3].qhi, desc(5));
  wgmma_rs<-1>(av, a[0].qlo, a[1].qlo, a[2].qlo, a[3].qlo, desc(4));
  if constexpr (!kGrid) {
    wgmma_rs(am, a[0].hi, a[1].hi, a[2].hi, a[3].hi, desc(1));
    wgmma_rs(am, a[0].lo, a[1].lo, a[2].lo, a[3].lo, desc(0));
    wgmma_rs(av, a[0].ahi, a[1].ahi, a[2].ahi, a[3].ahi, desc(3));
    wgmma_rs(av, a[0].alo, a[1].alo, a[2].alo, a[3].alo, desc(2));
  }
}

template <bool kGrid>
__device__ __forceinline__ void fence_split(Split (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    fence_reg(a[e].hi);
    fence_reg(a[e].ahi);
    fence_reg(a[e].qhi);
    fence_reg(a[e].qlo);
    if constexpr (!kGrid) {
      fence_reg(a[e].lo);
      fence_reg(a[e].alo);
    }
  }
}

struct Args {
  const float* noise;
  float* out;
  float* ws;  // split-K partials (splits, 2, M, N), or null
  int M, N, K, kper;
  uint32_t seed;
  float inv_nbit;
};

template <bool kPrng, bool kGrid, bool kKMajor>
__global__ void __launch_bounds__(kThreads, 1)
sc_mac_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, const Args args) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * args.kper;
  const int kend = min(args.K, kbeg + args.kper);
  const int nk = (kend - kbeg + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.dfull[b], 128);
      mbar_init(&sm.dempty[b], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: thread 0 keeps the TMA ring full; all 128
    // threads make each stage's derived x operands, one stage ahead of
    // the consumers.
    const int ptid = threadIdx.x;
    auto load = [&](int kt) {
      const int s = kt % kStages;
      mbar_expect_tx(&sm.full[s], (kWTileFloats + kXTileFloats) * 4);
      const int k = kbeg + kt * kBK;
      tma_load_2d(sm.x[s], &xmap, &sm.full[s], k, m0);
      if constexpr (kKMajor) {
        tma_load_2d(sm.w[s], &wmap, &sm.full[s], k, n0);
      } else {
#pragma unroll
        for (int b = 0; b < kBN / 32; ++b) {
          tma_load_2d(sm.w[s] + b * 1024, &wmap, &sm.full[s], n0 + 32 * b,
                      k);
        }
      }
    };
    if (ptid == 0) {
      for (int kt = 0; kt < min(nk, kStages); ++kt) load(kt);
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const int b = kt & 1;
      mbar_wait(&sm.full[s], (kt / kStages) & 1);
      if (kt >= 2) mbar_wait(&sm.dempty[b], ((kt - 2) >> 1) & 1);
      derive_x<kGrid>(sm.x[s], sm.d[b], ptid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&sm.dfull[b]);
      // every producer thread is done with x of stage kt (and kt - 1)
      asm volatile("bar.sync 1, 128;" ::: "memory");
      const int kr = kt - 1;  // refill the slot of stage kt - 1
      if (ptid == 0 && kr >= 0 && kr + kStages < nk) {
        mbar_wait(&sm.empty[kr % kStages], (kr / kStages) & 1);
        load(kr + kStages);
      }
    }
    return;
  }

  const int c = wg - 1;  // consumer: output columns c*64..
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int nr = c * 64 + warp * 16 + g;  // this thread's A rows nr, nr+8
  const bool leader = (threadIdx.x & 127) == 0;
  // this thread's A elements (k, n) of a k8 step: (t, nr), (t, nr + 8),
  // (t + 4, nr), (t + 4, nr + 8)
  const uint32_t wo0 = w_offset<kKMajor>(t, nr);
  const uint32_t wo1 = w_offset<kKMajor>(t, nr + 8);
  const uint32_t wo2 = w_offset<kKMajor>(t + 4, nr);
  const uint32_t wo3 = w_offset<kKMajor>(t + 4, nr + 8);

  float am[32], av[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    am[i] = 0.0f;
    av[i] = 0.0f;
  }

  Split af[2][4];  // A fragments of two k8 steps in flight
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const int d = kt & 1;
    const char* wt = reinterpret_cast<const char*>(sm.w[s]);
    mbar_wait(&sm.full[s], (kt / kStages) & 1);  // w tile landed
    mbar_wait(&sm.dfull[d], (kt >> 1) & 1);       // derived x made
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      Split(&a)[4] = af[j & 1];
      auto w_at = [&](uint32_t o) {
        return *reinterpret_cast<const float*>(wt + w_step<kKMajor>(o, j));
      };
      const float v0 = w_at(wo0), v1 = w_at(wo1);
      const float v2 = w_at(wo2), v3 = w_at(wo3);
      a[0] = split_of<kGrid>(v0);
      a[1] = split_of<kGrid>(v1);
      a[2] = split_of<kGrid>(v2);
      a[3] = split_of<kGrid>(v3);
      wgmma_fence();
      mma_step<kGrid>(am, av, a, sm.d[d], j);
      wgmma_commit();
      wgmma_wait<1>();
      // the group of step j - 1 has retired: its registers are free
      fence_split<kGrid>(af[(j + 1) & 1]);
      if (j == 0 && kt > 0 && leader) {
        // every MMA of stage kt - 1 has retired: its derived x is free
        mbar_arrive(&sm.dempty[d ^ 1]);
      }
    }
    // w of stage kt is in registers or retired: hand the slot back
    if (leader) mbar_arrive(&sm.empty[s]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    fence_reg(am[i]);
    fence_reg(av[i]);
  }

  // Epilogue.  Accumulator i of this thread is the out^T element
  // (row nr + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1)).
  const size_t MN = static_cast<size_t>(args.M) * args.N;
  auto index = [&](int i, size_t& idx) {
    const int n = n0 + nr + 8 * ((i >> 1) & 1);
    const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
    idx = static_cast<size_t>(m) * args.N + n;
    return m < args.M && n < args.N;
  };
  if (args.ws != nullptr) {
    float* part = args.ws + static_cast<size_t>(blockIdx.z) * 2 * MN;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      size_t idx;
      if (!index(i, idx)) continue;
      part[idx] = am[i];
      part[MN + idx] = av[i];
    }
    return;
  }
  // all 32 noise loads in flight before the first store
  float z[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    size_t idx;
    z[i] = index(i, idx) ? noise_at<kPrng>(args.noise, args.seed, idx) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    size_t idx;
    if (!index(i, idx)) continue;
    args.out[idx] = moment_out(am[i], av[i], z[i], args.inv_nbit);
  }
}

// The split-K reduction and epilogue: the partials of each output added
// in split order (deterministic), then the moment law.
template <bool kPrng>
__global__ void __launch_bounds__(256)
sc_mac_reduce_kernel(const float* __restrict__ ws, int splits,
                     const float* __restrict__ noise, uint32_t seed,
                     float* __restrict__ out, size_t MN, float inv_nbit) {
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < MN; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float mean = 0.0f, d = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* part = ws + static_cast<size_t>(s) * 2 * MN;
      mean += part[idx];
      d += part[MN + idx];
    }
    out[idx] = moment_out(mean, d, noise_at<kPrng>(noise, seed, idx),
                          inv_nbit);
  }
}

// cuTensorMapEncodeTiled, a libcuda entry point, looked up at run time
// so that the library links against the CUDA runtime only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D float32 tensor map: dims {inner, outer}, row stride ld floats,
// box {32, box_outer}, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* base, uint64_t inner,
              uint64_t outer, uint64_t ld, uint32_t box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 4};
  const cuuint32_t box[2] = {32, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kPrng, bool kGrid, bool kKMajor>
int launch_main(const CUtensorMap& xm, const CUtensorMap& wm, const Args& a,
                int splits, cudaStream_t stream) {
  auto kern = sc_mac_kernel<kPrng, kGrid, kKMajor>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.M + kBM - 1) / kBM, (a.N + kBN - 1) / kBN, splits);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(xm, wm, a);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* x, const void* w, int w_kmajor, int ldw, int nw,
        const void* noise, unsigned int seed, bool prng, int on_grid,
        void* out, void* ws, int splits, int kper, int M, int N, int K,
        float inv_nbit, void* stream) {
  CUtensorMap xm, wm;
  bool ok = make_map(&xm, x, K, M, K, kBM);
  ok = ok && (w_kmajor ? make_map(&wm, w, K, nw, ldw, kBN)
                       : make_map(&wm, w, nw, K, ldw, 32));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(noise), static_cast<float*>(out),
         splits > 1 ? static_cast<float*>(ws) : nullptr,
         M, N, K, kper, seed, inv_nbit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the 6 instantiations: kernel 5 (operand grid x w layout), kernel 6
  // (w layout)
  if (prng) {  // kernel 6: the general (9-product) route only
    return w_kmajor ? launch_main<true, false, true>(xm, wm, a, splits, st)
                    : launch_main<true, false, false>(xm, wm, a, splits, st);
  }
  const int variant = (on_grid ? 2 : 0) | (w_kmajor ? 1 : 0);
  switch (variant) {
    case 0: return launch_main<false, false, false>(xm, wm, a, splits, st);
    case 1: return launch_main<false, false, true>(xm, wm, a, splits, st);
    case 2: return launch_main<false, true, false>(xm, wm, a, splits, st);
    default: return launch_main<false, true, true>(xm, wm, a, splits, st);
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// x (M, K) contiguous float32 with K a multiple of 4.  w: K x nw float32,
// row-major (w_kmajor = 0: element (k, n) at k*ldw + n) or K-major
// (w_kmajor = 1: at n*ldw + k), ldw a multiple of 4, nw >= N; columns past
// N are never stored.  noise and out (M, N) contiguous.  Split-K: the
// K range of block z is [z*kper, (z+1)*kper) (kper a multiple of 32), and
// with splits > 1 the kernel writes its partial sums to ws
// (splits, 2, M, N) float32 and out is untouched: sc_mac_reduce finishes.
// on_grid: every x and w value is exact in TF32 (5 MMAs a pair, not 9).
// Returns the cudaGetLastError() code of the launch.
extern "C" int sc_mac_fused(const void* x, const void* w, int w_kmajor,
                            int ldw, int nw, const void* noise, void* out,
                            void* ws, int splits, int kper, int M, int N,
                            int K, int on_grid, float inv_nbit,
                            void* stream) {
  return run(x, w, w_kmajor, ldw, nw, noise, 0u, false, on_grid, out, ws,
             splits, kper, M, N, K, inv_nbit, stream);
}

// As sc_mac_fused with the noise made in the kernel from ``seed``, on
// the general route (no on_grid).
extern "C" int sc_mac_fused_prng(const void* x, const void* w, int w_kmajor,
                                 int ldw, int nw, unsigned int seed,
                                 void* out, void* ws, int splits, int kper,
                                 int M, int N, int K, float inv_nbit,
                                 void* stream) {
  return run(x, w, w_kmajor, ldw, nw, nullptr, seed, true, 0, out, ws,
             splits, kper, M, N, K, inv_nbit, stream);
}

// ws (splits, 2, M, N) partial sums (x.w and |x|.|w| - x^2.w^2 of each
// K range) -> out (M, N); the noise from
// ``noise`` (M, N), or from ``seed`` when noise is null.
extern "C" int sc_mac_reduce(const void* ws, int splits, const void* noise,
                             unsigned int seed, void* out, int M, int N,
                             float inv_nbit, void* stream) {
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      std::min<size_t>((mn + 255) / 256, static_cast<size_t>(132) * 16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (noise == nullptr) {
    sc_mac_reduce_kernel<true><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), splits, nullptr, seed,
        static_cast<float*>(out), mn, inv_nbit);
  } else {
    sc_mac_reduce_kernel<false><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), splits,
        static_cast<const float*>(noise), 0u, static_cast<float*>(out), mn,
        inv_nbit);
  }
  return static_cast<int>(cudaGetLastError());
}
