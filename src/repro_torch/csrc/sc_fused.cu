// Fused bit-exact SC matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sc_fused.py:sc_fused_popcount
// (body _sc_fused_kernel): per scalar product (i, k, j) it encodes |x|, |w|
// to fx16 words, draws nbit/32 words x 16 ladder slices per operand from
// Threefry-2x32 at counter c0 = i*row_stride + k*n_orig + j (mod 2^32),
// c1 = s*nwords + w, ANDs the two Bernoulli ladders, pop-counts, and sums
// sign_x * sign_w * count over K into an int32 total.
//
// What bounds it on this card: integer ALU issue.  Each product costs
// 2 * 16 * nwords Threefry evaluations of ~80 integer instructions
// (1,024 evaluations at nbit = 1024) against 8 bytes of operands, and
// no tensor-core path applies.  The design therefore computes the
// function, not the TPU tiling: one thread per output (i, j) with 128
// consecutive j per block so the w[k, j] loads coalesce, the whole
// 16-slice ladder unrolled in registers, no shared memory, and K split
// over blockIdx.z (int32 atomicAdd onto a zeroed output; integer sums are
// associative, so the split is bit-exact) so that narrow outputs such as
// wk/wv (N = 128) still fill every SM.
//
// Padding is skipped rather than materialised: the loop runs over the
// caller's real K and N, and the counters use the caller's n_orig.

#include "sc_device.cuh"

namespace {

__global__ void __launch_bounds__(128)
sc_fused_kernel(const uint32_t* __restrict__ keys,
                const float* __restrict__ x, const float* __restrict__ w,
                int32_t* __restrict__ out, int K, int N, int kchunk,
                uint32_t n_orig, uint32_t row_stride, int nwords, int levels,
                bool quantize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= N) return;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const uint32_t kx0 = keys[4 * i + 0];
  const uint32_t kx1 = keys[4 * i + 1];
  const uint32_t ky0 = keys[4 * i + 2];
  const uint32_t ky1 = keys[4 * i + 3];
  const uint32_t base = static_cast<uint32_t>(i) * row_stride +
                        static_cast<uint32_t>(j);
  const float* xrow = x + static_cast<size_t>(i) * K;
  int32_t acc = 0;
  for (int k = k_begin; k < k_end; ++k) {
    const float xv = xrow[k];
    const float wv = w[static_cast<size_t>(k) * N + j];
    const uint32_t px = repro::encode_fx16(fabsf(xv), levels, quantize);
    const uint32_t pw = repro::encode_fx16(fabsf(wv), levels, quantize);
    const uint32_t c0 = base + static_cast<uint32_t>(k) * n_orig;
    const int32_t cnt =
        repro::sc_mul_count(kx0, kx1, ky0, ky1, c0, px, pw, nwords);
    acc += repro::sign_of(xv) * repro::sign_of(wv) * cnt;
  }
  atomicAdd(out + static_cast<size_t>(i) * N + j, acc);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// keys (M, 4) u32 [kx0, kx1, ky0, ky1]; x (M, K) f32; w (K, N) f32, both
// signed probabilities; out (M, N) i32, ZEROED by the caller.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int sc_fused_popcount(const void* keys, const void* x,
                                 const void* w, void* out, int M, int K,
                                 int N, int ksplit, unsigned int n_orig,
                                 unsigned int row_stride, int nbit,
                                 int levels, int quantize, void* stream) {
  const int threads = 128;
  const int kchunk = (K + ksplit - 1) / ksplit;
  const dim3 grid((N + threads - 1) / threads, M, ksplit);
  sc_fused_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<int32_t*>(out), K, N, kchunk,
      n_orig, row_stride, nbit / repro::kLaneBits, levels, quantize != 0);
  return static_cast<int>(cudaGetLastError());
}
