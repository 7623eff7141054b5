// Fused paged attention for Hopper (sm_90a): decode and chunked prefill
// over the paged K/V pools, with an exact or an SC-sampled QK^T.
//
// Replaces the Pallas kernels of src/repro/kernels/paged_attention.py:
//   paged_attention_fused     (body _paged_attn_kernel)
//   paged_attention_fused_sc  (body _paged_attn_sc_kernel, with
//                              _sc_logits / _sc_counts)
// Both compute, per (batch row, kv head), the GQA query rows in the
// _rows_layout order (row r is head kvh*g + r/sc at chunk offset r%sc)
// against the pages block_table names: logits masked to
// t <= lengths[b] + r%sc with -1e30, an online softmax carrying
// (max, denom, acc), and out = acc / max(denom, 1e-30).
//
// What bounds them on this card:
// * exact QK^T: the bytes of the K/V pages read (and the queries); the
//   arithmetic is ~4*hd flops per (row, position).  The design keeps one
//   page of K and V in shared memory per step, shared by the 16 query
//   rows of a block, computes QK^T and PV in f32 on CUDA cores (hd = 64,
//   block_size = 16 leave no tensor-core shape worth the setup), keeps
//   the running (max, denom) per row and the accumulator in shared
//   memory, and stops at the last page any row of the block can see, so
//   a short sequence in a long table reads only its own pages.
// * SC QK^T: integer ALU issue, as in sc_fused.cu: every live logit costs
//   hd SC MULs of 2 * 16 * nbit/32 Threefry evaluations.  One warp owns
//   one (row, position) logit; its lanes split d and a warp shuffle
//   reduces the signed int32 pop-counts, which keeps the total exact.
//   Masked positions draw nothing: their logit is -1e30 whatever the
//   bits, as in the reference.  The per-row max-abs scales and fx16
//   words are computed once per q tile / K page in shared memory.

#include <cuda_bf16.h>

#include "sc_device.cuh"

namespace {

constexpr int kRows = 16;  // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kDenomGuard = 1e-30f;
constexpr float kScaleGuard = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* q;            // (b, kvh, rows, hd) T, rows layout
  const void* k_pages;      // (P, bs, kvh, hd) T
  const void* v_pages;      // (P, bs, kvh, hd) T
  const int32_t* block_table;  // (b, nb)
  const int32_t* lengths;      // (b,)
  const uint32_t* keys4;       // (b, sc, 4) u32 (SC only)
  float* out;               // (b, kvh, rows, hd) f32
  int kvh, rows, hd, bs, nb, sc;
  int n_heads, group, nbit, levels, quantize;
};

// Shared-memory floats (and 32-bit words) one block uses.
__host__ __device__ inline size_t smem_words(int hd, int bs, bool sc) {
  size_t n = 2 * kRows * hd      // q tile, accumulator
             + 2 * bs * hd       // K page, V page
             + kRows * bs        // logits / probabilities
             + 3 * kRows;        // running max, denominator, alpha
  if (sc) n += 2 * kRows * hd + 2 * bs * hd + kRows + bs;
  return n;
}

template <typename T, bool SC>
__global__ void paged_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, bs = a.bs;
  float* q_s = smem;
  float* acc_s = q_s + kRows * hd;
  float* k_s = acc_s + kRows * hd;
  float* v_s = k_s + bs * hd;
  float* p_s = v_s + bs * hd;
  float* m_s = p_s + kRows * bs;
  float* d_s = m_s + kRows;
  float* alpha_s = d_s + kRows;
  // SC only: fx16 words and signs of the q tile and the K page, scales
  uint32_t* fxq_s = reinterpret_cast<uint32_t*>(alpha_s + kRows);
  int* sgq_s = reinterpret_cast<int*>(fxq_s + kRows * hd);
  uint32_t* fxk_s = reinterpret_cast<uint32_t*>(sgq_s + kRows * hd);
  int* sgk_s = reinterpret_cast<int*>(fxk_s + bs * hd);
  float* scq_s = reinterpret_cast<float*>(sgk_s + bs * hd);
  float* sck_s = scq_s + kRows;

  const int bi = blockIdx.x, kh = blockIdx.y, r0 = blockIdx.z * kRows;
  const int nrows = min(kRows, a.rows - r0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const T* q = static_cast<const T*>(a.q) +
               (static_cast<size_t>(bi) * a.kvh + kh) * a.rows * hd +
               static_cast<size_t>(r0) * hd;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  const int len = a.lengths[bi];
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int idx = tid; idx < nrows * hd; idx += nthreads) {
    q_s[idx] = to_f32(q[idx]);
    acc_s[idx] = 0.0f;
  }
  // the last kv position any row of this tile attends to
  int max_pos = 0;
  for (int r = 0; r < nrows; ++r) max_pos = max(max_pos, (r0 + r) % a.sc);
  max_pos += len;
  const int n_pages = min(a.nb, max_pos / bs + 1);
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    d_s[tid] = 0.0f;
  }
  __syncthreads();

  if (SC) {  // per-row max-abs scale, fx16 words and signs of the q tile
    for (int r = warp; r < nrows; r += nwarps) {
      float mx = 0.0f;
      for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(q_s[r * hd + d]));
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(mx, kScaleGuard);
      if (lane == 0) scq_s[r] = mx;
      for (int d = lane; d < hd; d += 32) {
        const float v = q_s[r * hd + d];
        fxq_s[r * hd + d] =
            repro::encode_fx16(__fdiv_rn(fabsf(v), mx), a.levels, a.quantize);
        sgq_s[r * hd + d] = repro::sign_of(v);
      }
    }
  }

  for (int j = 0; j < n_pages; ++j) {
    const size_t page = static_cast<size_t>(a.block_table[bi * a.nb + j]);
    for (int idx = tid; idx < bs * hd; idx += nthreads) {
      const int t = idx / hd, d = idx - t * hd;
      const size_t off = ((page * bs + t) * a.kvh + kh) * hd + d;
      k_s[idx] = to_f32(kp[off]);
      v_s[idx] = to_f32(vp[off]);
    }
    __syncthreads();

    if (SC) {
      for (int t = warp; t < bs; t += nwarps) {
        float mx = 0.0f;
        for (int d = lane; d < hd; d += 32)
          mx = fmaxf(mx, fabsf(k_s[t * hd + d]));
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mx = fmaxf(mx, kScaleGuard);
        if (lane == 0) sck_s[t] = mx;
        for (int d = lane; d < hd; d += 32) {
          const float v = k_s[t * hd + d];
          fxk_s[t * hd + d] = repro::encode_fx16(__fdiv_rn(fabsf(v), mx),
                                                 a.levels, a.quantize);
          sgk_s[t * hd + d] = repro::sign_of(v);
        }
      }
      __syncthreads();
      const int nwords = a.nbit / repro::kLaneBits;
      for (int pair = warp; pair < nrows * bs; pair += nwarps) {
        const int r = pair / bs, t = pair - r * bs;
        const int row = r0 + r, off = row % a.sc;
        const int t_abs = j * bs + t;
        if (t_abs > len + off) {  // masked: no draw
          if (lane == 0) p_s[pair] = kNegInf;
          continue;
        }
        const uint32_t* key = a.keys4 + (static_cast<size_t>(bi) * a.sc + off) * 4;
        const uint32_t head =
            static_cast<uint32_t>(kh * a.group + row / a.sc);
        const uint32_t cbase =
            (static_cast<uint32_t>(t_abs) * static_cast<uint32_t>(a.n_heads) +
             head) * static_cast<uint32_t>(hd);
        int32_t part = 0;
        for (int d = lane; d < hd; d += 32) {
          const int32_t cnt = repro::sc_mul_count(
              key[0], key[1], key[2], key[3], cbase + static_cast<uint32_t>(d),
              fxq_s[r * hd + d], fxk_s[t * hd + d], nwords);
          part += sgq_s[r * hd + d] * sgk_s[t * hd + d] * cnt;
        }
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) {
          // the reference's f32 order: ((total / nbit) * sq) * sk * scale
          float est = __fdiv_rn(static_cast<float>(part),
                                static_cast<float>(a.nbit));
          est = __fmul_rn(est, scq_s[r]);
          est = __fmul_rn(est, sck_s[t]);
          p_s[pair] = __fmul_rn(est, scale);
        }
      }
    } else {
      for (int pair = tid; pair < nrows * bs; pair += nthreads) {
        const int r = pair / bs, t = pair - r * bs;
        float s = 0.0f;
        for (int d = 0; d < hd; ++d) s += q_s[r * hd + d] * k_s[t * hd + d];
        const bool live = j * bs + t <= len + (r0 + r) % a.sc;
        p_s[pair] = live ? s * scale : kNegInf;
      }
    }
    __syncthreads();

    if (tid < nrows) {  // online softmax update of row tid
      const int r = tid;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, p_s[r * bs + t]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[r * bs + t] - m_new);
        p_s[r * bs + t] = p;
        sum += p;
      }
      m_s[r] = m_new;
      d_s[r] = d_s[r] * alpha + sum;
      alpha_s[r] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < nrows * hd; idx += nthreads) {
      const int r = idx / hd, d = idx - r * hd;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t) pv += p_s[r * bs + t] * v_s[t * hd + d];
      acc_s[idx] = acc_s[idx] * alpha_s[r] + pv;
    }
    __syncthreads();
  }

  float* out = a.out + (static_cast<size_t>(bi) * a.kvh + kh) * a.rows * hd +
               static_cast<size_t>(r0) * hd;
  for (int idx = tid; idx < nrows * hd; idx += nthreads) {
    out[idx] = acc_s[idx] / fmaxf(d_s[idx / hd], kDenomGuard);
  }
}

template <typename T, bool SC>
int launch(const Args& a, int b, void* stream) {
  const size_t bytes = smem_words(a.hd, a.bs, SC) * sizeof(float);
  auto kernel = paged_attn_kernel<T, SC>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b, a.kvh, (a.rows + kRows - 1) / kRows);
  const int threads = SC ? 256 : 128;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SC>
int dispatch(const Args& a, int b, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, SC>(a, b, stream)
              : launch<float, SC>(a, b, stream);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// q (b, kvh, rows, hd) and k/v pages (P, bs, kvh, hd) share one dtype,
// f32 (bf16 = 0) or bf16 (bf16 = 1); out (b, kvh, rows, hd) f32.
// keys4 (b, sc, 4) u32 is read only when sc_logits != 0.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* block_table,
                               const void* lengths, const void* keys4,
                               void* out, int b, int kvh, int rows, int hd,
                               int bs, int nb, int sc, int n_heads,
                               int group, int nbit, int levels, int quantize,
                               int bf16, int sc_logits, void* stream) {
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.block_table = static_cast<const int32_t*>(block_table);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.keys4 = static_cast<const uint32_t*>(keys4);
  a.out = static_cast<float*>(out);
  a.kvh = kvh;
  a.rows = rows;
  a.hd = hd;
  a.bs = bs;
  a.nb = nb;
  a.sc = sc;
  a.n_heads = n_heads;
  a.group = group;
  a.nbit = nbit;
  a.levels = levels;
  a.quantize = quantize;
  return sc_logits ? dispatch<true>(a, b, bf16, stream)
                   : dispatch<false>(a, b, bf16, stream);
}
