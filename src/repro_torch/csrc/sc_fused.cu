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
// function, not the TPU tiling: one thread per output (i, j) with THREADS
// consecutive j per block so the w[k, j] loads coalesce, the whole
// 16-slice ladder unrolled in registers, no shared memory, and K split
// over blockIdx.z (int32 atomicAdd onto a zeroed output; integer sums are
// associative, so the split is bit-exact) so that narrow outputs such as
// wk/wv (N = 128) still fill every SM.
//
// The launch shape (threads a block, K split) comes from the autotuner
// (sc/autotune.py: FusedTile).  Each supported block size is its own
// instantiation, so __launch_bounds__ gives each its own register
// budget: the 128-thread launch compiles as it did before there was a
// choice.
//
// Padding is skipped rather than materialised: the loop runs over the
// caller's real K and N, and the counters use the caller's n_orig.

#include "sc_device.cuh"

namespace {

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
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

template <int THREADS>
int launch(const void* keys, const void* x, const void* w, void* out, int M,
           int K, int N, int ksplit, unsigned int n_orig,
           unsigned int row_stride, int nbit, int levels, int quantize,
           cudaStream_t stream) {
  const int kchunk = (K + ksplit - 1) / ksplit;
  const dim3 grid((N + THREADS - 1) / THREADS, M, ksplit);
  sc_fused_kernel<THREADS><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<int32_t*>(out), K, N, kchunk,
      n_orig, row_stride, nbit / repro::kLaneBits, levels, quantize != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// keys (M, 4) u32 [kx0, kx1, ky0, ky1]; x (M, K) f32; w (K, N) f32, both
// signed probabilities; out (M, N) i32, ZEROED by the caller; ksplit
// blocks along K of threads (64, 128 or 256) outputs each.  Returns the
// cudaGetLastError() code of the launch (cudaErrorInvalidValue for
// another block size).
extern "C" int sc_fused_popcount(const void* keys, const void* x,
                                 const void* w, void* out, int M, int K,
                                 int N, int ksplit, int threads,
                                 unsigned int n_orig,
                                 unsigned int row_stride, int nbit,
                                 int levels, int quantize, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 64:
      return launch<64>(keys, x, w, out, M, K, N, ksplit, n_orig, row_stride,
                        nbit, levels, quantize, s);
    case 128:
      return launch<128>(keys, x, w, out, M, K, N, ksplit, n_orig,
                         row_stride, nbit, levels, quantize, s);
    case 256:
      return launch<256>(keys, x, w, out, M, K, N, ksplit, n_orig,
                         row_stride, nbit, levels, quantize, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
