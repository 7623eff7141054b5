// Moment-matched SC matmul for Hopper (sm_90a): kernels 5 and 6 of the
// port.
//
// Replaces the Pallas kernels src/repro/kernels/sc_mac.py:sc_mac_fused
// (body _sc_mac_kernel; noise streamed in as an (M, N) input) and
// sc_mac_fused_prng (body _sc_mac_kernel_prng; noise made in the kernel).
// On signed probabilities x (M, K) and w (K, N) both compute three sums
// over K in one pass over the operand tiles,
//
//   mean = x . w,   p = |x| . |w|,   p2 = x^2 . w^2,
//
// and emit out = mean + z * sqrt(max(p - p2, 0) * inv_nbit) with z a
// standard normal: the CLT law of the SOT-MRAM MAC pop-count.
//
// What bounds it on this card: FP32 operations.  Each operand pair costs
// three fused multiply-adds (6 flops) in IEEE float32 on the CUDA cores,
// 6*M*K*N flops against 4*(M*K + K*N + 2*M*N) bytes; at the trainer's
// shapes (M = 512, K = 896) that is ~150 flops per byte, far above the
// card's FP32 ridge (67 TFLOP/s / 3.35 TB/s = 20).  TF32 tensor cores are
// not used: their 10-bit mantissa would break the reference's float32
// dots (preferred_element_type=float32).  wgmma / TMA / a 3xTF32 split
// are later work.
//
// Design: the TPU's sequential K grid axis with VMEM-resident
// accumulators becomes a loop inside the block.  One block of 256
// threads owns a 64 x 64 output tile; each thread keeps a 4 x 4 micro
// tile of all three accumulators in registers (48 floats).  Per K step
// of 16 the block stages x, x^2 (k-major) and w, w^2 in shared memory, so
// the inner loop is exactly three FFMAs per pair (|x|.|w| takes the abs
// as an operand modifier).  Bounds checks zero-fill the ragged edges
// (zeros are inert in all three sums), so the caller pads nothing.
//
// Kernel 6's noise: the TPU's per-tile prng stream cannot be reproduced,
// so each output (i, j) draws two words from Threefry-2x32 keyed
// (0, seed) at counters (0, 2*idx) and (0, 2*idx + 1), idx = i*N + j
// (mod 2^32): the draw depends on the element, not on the tile.  The
// words go through the reference's _box_muller.

#include "sc_device.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // keeps float4 alignment, breaks store conflicts

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
__global__ void __launch_bounds__(kThreads)
sc_mac_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ noise, uint32_t seed,
              float* __restrict__ out, int M, int N, int K,
              float inv_nbit) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float xq[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN + kPad];
  __shared__ __align__(16) float wq[kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc_m[kTM][kTN], acc_p[kTM][kTN], acc_q[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc_m[i][j] = 0.0f;
      acc_p[i][j] = 0.0f;
      acc_q[i][j] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile (kBM x kBK): consecutive threads read consecutive k.
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      const float v =
          (gr < M && gc < K) ? x[static_cast<size_t>(gr) * K + gc] : 0.0f;
      xs[c][r] = v;
      xq[c][r] = v * v;
    }
    // w tile (kBK x kBN): consecutive threads read consecutive columns.
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      const float v =
          (gr < K && gc < N) ? w[static_cast<size_t>(gr) * N + gc] : 0.0f;
      ws[r][c] = v;
      wq[r][c] = v * v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 aq = *reinterpret_cast<const float4*>(&xq[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float4 bq = *reinterpret_cast<const float4*>(&wq[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float aqv[kTM] = {aq.x, aq.y, aq.z, aq.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
      const float bqv[kTN] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc_m[i][j] = fmaf(av[i], bv[j], acc_m[i][j]);
          acc_p[i][j] = fmaf(fabsf(av[i]), fabsf(bv[j]), acc_p[i][j]);
          acc_q[i][j] = fmaf(aqv[i], bqv[j], acc_q[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c >= N) continue;
      const size_t idx = static_cast<size_t>(r) * N + c;
      float z;
      if constexpr (kPrng) {
        const uint32_t ctr = 2u * static_cast<uint32_t>(idx);
        z = box_muller(repro::threefry2x32_x0(0u, seed, 0u, ctr),
                       repro::threefry2x32_x0(0u, seed, 0u, ctr + 1u));
      } else {
        z = noise[idx];
      }
      const float var = fmaxf(acc_p[i][j] - acc_q[i][j], 0.0f) * inv_nbit;
      out[idx] = acc_m[i][j] + z * sqrtf(var);
    }
  }
}

dim3 grid_of(int M, int N) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// x (M, K), w (K, N), noise (M, N), out (M, N): contiguous float32 on one
// device.  Returns the cudaGetLastError() code of the launch.
extern "C" int sc_mac_fused(const void* x, const void* w, const void* noise,
                            void* out, int M, int N, int K, float inv_nbit,
                            void* stream) {
  sc_mac_kernel<false>
      <<<grid_of(M, N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(noise), 0u, static_cast<float*>(out), M,
          N, K, inv_nbit);
  return static_cast<int>(cudaGetLastError());
}

// As sc_mac_fused with the noise made in the kernel from ``seed``.
extern "C" int sc_mac_fused_prng(const void* x, const void* w,
                                 unsigned int seed, void* out, int M, int N,
                                 int K, float inv_nbit, void* stream) {
  sc_mac_kernel<true>
      <<<grid_of(M, N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          nullptr, seed, static_cast<float*>(out), M, N, K, inv_nbit);
  return static_cast<int>(cudaGetLastError());
}
