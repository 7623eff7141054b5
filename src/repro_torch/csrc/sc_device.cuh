// Device functions shared by the port's bit-exact SC kernels.
//
// These are the CUDA counterparts of the JAX reference's shared helpers:
//   threefry2x32   <- src/repro/sc/ctr_rng.py:threefry2x32
//   encode_fx16    <- src/repro/kernels/sc_fused.py:encode_fx16
//                     (sc/encoding.py:quantize_grid + to_fx16)
//   horner_step    <- src/repro/kernels/sc_mul.py:bernoulli_words
//   __popc         <- src/repro/kernels/sc_mul.py:popcount32
// Bit equality with the reference hangs on: rintf (round half to even,
// as jnp.round), IEEE division by the level count (no fast math), the
// 65535 clamp of the fx16 word, and uint32 wrap-around of every counter.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kNSlices = 16;   // fixed-point precision of the bias
constexpr int kLaneBits = 32;  // stochastic cells per packed word

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// One Threefry-2x32 round group: four rounds with the given rotations.
#define REPRO_TF_ROUND(r)   \
  x0 += x1;                 \
  x1 = rotl32(x1, (r));     \
  x1 ^= x0;

// Threefry-2x32, 20 rounds; returns the first output word, the only one
// the SC stream uses (word(key, c0, c1) = Threefry(key, (c0, c1))[0]).
__device__ __forceinline__ uint32_t threefry2x32_x0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0,
                                                    uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k2;
  return x0;
}

// Threefry-2x32, 20 rounds, both output words: the key split of
// ctr_rng.split (a key's i-th child is threefry2x32(key, (0, i))).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef REPRO_TF_ROUND

// |probability| -> 16-bit bias word: optional clamped grid round
// clip(rint(p * levels), 0, levels - 1) / levels, then
// clip(rint(p * 2^16), 0, 65535).
__device__ __forceinline__ uint32_t encode_fx16(float p, int levels,
                                                bool quantize) {
  if (quantize) {
    const float fl = static_cast<float>(levels);
    float g = rintf(p * fl);
    g = fminf(fmaxf(g, 0.0f), fl - 1.0f);
    p = __fdiv_rn(g, fl);
  }
  float f = rintf(p * 65536.0f);
  f = fminf(fmaxf(f, 0.0f), 65535.0f);
  return static_cast<uint32_t>(f);
}

__device__ __forceinline__ int sign_of(float v) {
  return (v > 0.0f) - (v < 0.0f);
}

// One Horner-ladder slice: u | t where bit s of the bias is set, else u & t.
__device__ __forceinline__ uint32_t horner_step(uint32_t t, uint32_t u,
                                                uint32_t p, int s) {
  return ((p >> s) & 1u) ? (u | t) : (u & t);
}

// Surviving cells of word w of one SC MUL: the word is drawn over 16
// ladder slices from each operand's own key at counter
// (c0, s * nwords + w); the two ladders AND (two-pulse write) and
// pop-count.  2 * 16 Threefry calls, ~80 integer instructions each.
__device__ __forceinline__ int32_t sc_mul_word(uint32_t kx0, uint32_t kx1,
                                               uint32_t ky0, uint32_t ky1,
                                               uint32_t c0, uint32_t px,
                                               uint32_t py, int w,
                                               int nwords) {
  uint32_t tx = 0u, ty = 0u;
#pragma unroll
  for (int s = 0; s < kNSlices; ++s) {
    const uint32_t c1 = static_cast<uint32_t>(s * nwords + w);
    tx = horner_step(tx, threefry2x32_x0(kx0, kx1, c0, c1), px, s);
    ty = horner_step(ty, threefry2x32_x0(ky0, ky1, c0, c1), py, s);
  }
  return __popc(tx & ty);
}

// Surviving cells of one SC MUL: its nwords packed words.  This loop is
// what bounds every SC kernel.
__device__ __forceinline__ int32_t sc_mul_count(uint32_t kx0, uint32_t kx1,
                                                uint32_t ky0, uint32_t ky1,
                                                uint32_t c0, uint32_t px,
                                                uint32_t py, int nwords) {
  int32_t cnt = 0;
  for (int w = 0; w < nwords; ++w)
    cnt += sc_mul_word(kx0, kx1, ky0, ky1, c0, px, py, w, nwords);
  return cnt;
}

}  // namespace repro

// Each library exports the CUDA runtime's message for an error code.
#define REPRO_DEFINE_ERROR_STRING                                   \
  extern "C" const char* repro_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
