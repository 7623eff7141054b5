// Packed bit-exact SC MUL for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sc_mul.py:sc_mul_popcount
// (body _sc_mul_kernel): for each of M multiplications it runs the
// 16-slice Horner ladder over the caller's uniform words for both
// operands, ANDs the two Bernoulli words (two-pulse write), pop-counts
// and sums the W words of the MUL into an int32 total.  The random words
// are inputs, as in the reference: this is the engine that makes the
// fused kernel's bit identity checkable.
//
// What bounds it on this card: device-memory bytes.  Each MUL reads
// 2 * 16 * W words (4 KB at W = 32) and does ~130 integer ops per word
// pair, far below the ALU rate for that traffic.  The design therefore
// streams: one warp per MUL, lane w owning word w, so every slice load
// is 32 consecutive words (128 B, coalesced) and the 32 loads of a lane
// are independent and in flight together; the total is one
// __reduce_add_sync.  A W other than 32 loops the lanes over the words.
// Ragged M is masked here (the warp of a missing MUL exits as a whole),
// so no caller pads.

#include "sc_device.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sc_mul_kernel(const uint32_t* __restrict__ px,
              const uint32_t* __restrict__ py,
              const uint32_t* __restrict__ rx,
              const uint32_t* __restrict__ ry, int32_t* __restrict__ out,
              long long M, int W) {
  const int lane = threadIdx.x & 31;
  const long long m =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // m is warp-uniform: whole warps leave together
  const uint32_t bx = px[m];
  const uint32_t by = py[m];
  const size_t base = static_cast<size_t>(m) * repro::kNSlices * W;
  int cnt = 0;
  for (int w = lane; w < W; w += 32) {
    uint32_t tx = 0u, ty = 0u;
#pragma unroll
    for (int s = 0; s < repro::kNSlices; ++s) {
      const size_t at = base + static_cast<size_t>(s) * W + w;
      tx = repro::horner_step(tx, __ldg(rx + at), bx, s);
      ty = repro::horner_step(ty, __ldg(ry + at), by, s);
    }
    cnt += __popc(tx & ty);
  }
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) out[m] = cnt;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// px, py (M,) u32 fx16 biases; rx, ry (M, 16, W) u32 uniform words;
// out (M,) i32.  Returns the cudaGetLastError() code of the launch.
extern "C" int sc_mul_popcount(const void* px, const void* py,
                               const void* rx, const void* ry, void* out,
                               long long M, int W, void* stream) {
  const long long blocks = (M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sc_mul_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(rx), static_cast<const uint32_t*>(ry),
      static_cast<int32_t*>(out), M, W);
  return static_cast<int>(cudaGetLastError());
}
