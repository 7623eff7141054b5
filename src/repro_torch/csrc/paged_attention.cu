// Fused paged attention for Hopper (sm_90a): decode and chunked prefill
// over the paged K/V pools, with an exact or an SC-sampled QK^T.
//
// Replaces the Pallas kernels of src/repro/kernels/paged_attention.py:
//   paged_attention_fused     (body _paged_attn_kernel)
//   paged_attention_fused_sc  (body _paged_attn_sc_kernel, with
//                              _sc_logits / _sc_counts)
// Both compute, per (batch row, kv head), the GQA query rows in the
// _rows_layout order (row r is head kvh*g + r/sc at chunk offset r%sc,
// read from and written to q's own (b, sc, h, hd) layout) against the
// pages block_table names: logits masked to t <= lengths[b] + r%sc with
// -1e30, a softmax, and out = acc / max(denom, 1e-30).
//
// What bounds them on this card, and what the design does about it.
// The TPU kernels walk a row's pages in order, one grid step a page;
// here the work of one call is spread over all 132 SMs at every context
// length, in up to three launches:
//
// 1. paged_attn_logits_kernel (SC only).  Integer ALU issue bounds it,
//    as it bounds sc_fused.cu: every live logit costs hd SC MULs of
//    2 * 16 * nbit/32 Threefry evaluations.  A logit's pop-count total
//    is an integer sum over (d, word), so any split of that work gives
//    the same bits.  A work unit is one (kv position, query row, batch
//    row, kv head) logit, the position slowest; the blocks (as many as
//    the card holds at once, not one a unit) take the units in that
//    order from a counter in global memory, so they share the live ones
//    evenly whatever the mask leaves, and stop at the first unit past
//    every row's last position: a long table with short rows costs no
//    more than its live logits.  A block's threads split the unit's
//    hd * nbit/32 (d, word) pairs (a warp is one MUL's 32 words at nbit
//    1024) and add the signed int32 counts exactly; masked units are
//    skipped before drawing.  Each unit makes its q row's and K row's
//    max-abs scales and fx16 words and its query token's operand keys
//    (ctr_rng.split of the raw key) itself, and writes the logit in the
//    reference's f32 order ((total / nbit) * sq) * sk * scale.
// 2. paged_attn_split_kernel (both): flash-decoding.  Each row's pages
//    are cut into splits of pages_per_split pages (kernels/
//    paged_attention.py:paged_attention_plan); one block per (batch row,
//    kv head, tile of 16 query rows, split) carries an online softmax
//    (max, denom, acc) over its split in chunks of 64 positions staged
//    in shared memory with 16-byte loads.  The exact kernel computes its
//    q.k there in float32 (the bytes of the K/V pages bound it); the SC
//    kernel reads pass 1's logits.  Splits past the tile's last live
//    page exit at once, and a row writes only the splits that hold one
//    of its live positions, so no split it merges is fully masked.
// 3. paged_attn_combine_kernel (when there is more than one split): per
//    row, the splits merge in split order: m = max m_i,
//    d = sum d_i e^(m_i - m), acc = sum acc_i e^(m_i - m), then
//    out = acc / max(d, 1e-30).
// No float atomics anywhere: two launches give the same bits.  The
// wrapper allocates the logits and the partials; the kernels allocate
// nothing.  Where the caller passes a counters array (a measurement,
// not the serving path), each pass adds the work it did to it with
// integer atomics: [0] logits, [1] logits-pass blocks that computed one,
// [2] split-pass blocks past the early exit, [3] combine blocks.

#include <cuda_bf16.h>

#include "sc_device.cuh"

namespace {

constexpr int kRowTile = 16;        // query rows per split-pass block
constexpr int kChunk = 64;          // kv positions staged at once
constexpr int kSplitThreads = 256;  // threads per split-pass block
constexpr int kMaxLogitThreads = 1024;
constexpr float kNegInf = -1e30f;
constexpr float kDenomGuard = 1e-30f;
constexpr float kScaleGuard = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of a K/V row -> floats
__device__ __forceinline__ void unpack16(uint4 u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, float* dst,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

struct Args {
  const void* q;               // (b, sc, h, hd) T
  const void* k_pages;         // (P, bs, kvh, hd) T
  const void* v_pages;         // (P, bs, kvh, hd) T
  const int32_t* block_table;  // (b, nb)
  const int32_t* lengths;      // (b,)
  const uint32_t* keys;        // (b, sc, 2) u32 raw token keys (SC only)
  float* logits;               // (b, kvh, rows, nb * bs) f32 (SC only)
  int32_t* next_unit;          // (1,) i32 the logits pass's unit counter
  float* parts;                // (b, kvh, rows, splits, hd + 2) f32
  void* out;                   // (b, sc, h, hd) T
  int32_t* counters;           // (4,) i32 work done, or nullptr
  int b, kvh, rows, hd, bs, nb, sc;
  int n_heads, group, nbit, levels, quantize;
  int pages_per_split, splits, logit_threads;
};

// The last kv position query row `row` sees (the mask, within the table).
__device__ __forceinline__ int last_pos(const Args& a, int len, int row) {
  return min(a.nb * a.bs - 1, len + row % a.sc);
}

// Element offset of query row `row` of (bi, kh) in q's (b, sc, h, hd).
__device__ __forceinline__ size_t q_offset(const Args& a, int bi, int kh,
                                           int row) {
  const int head = kh * a.group + row / a.sc;
  return ((static_cast<size_t>(bi) * a.sc + row % a.sc) * a.n_heads + head) *
         a.hd;
}

// Element offset of kv position t's row (kv head kh) in the page pools.
__device__ __forceinline__ size_t kv_offset(const Args& a, int bi, int kh,
                                            int t) {
  const size_t page = static_cast<size_t>(a.block_table[bi * a.nb + t / a.bs]);
  return ((page * a.bs + t % a.bs) * a.kvh + kh) * a.hd;
}

// ---------------------------------------------------------------------------
// Pass 1: the SC logits, a unit at a time from a shared counter
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxLogitThreads)
paged_attn_logits_kernel(Args a) {
  const int per_pos = a.rows * a.b * a.kvh;
  int t_stop = 0;  // one past the last position any row sees
  for (int i = 0; i < a.b; ++i)
    t_stop = max(t_stop, last_pos(a, a.lengths[i], a.sc - 1) + 1);
  extern __shared__ float smem[];
  __shared__ float scale_s[2];
  __shared__ int32_t part_s[kMaxLogitThreads / 32];
  const int hd = a.hd;
  float* qv = smem;
  float* kv = qv + hd;
  uint32_t* fxq = reinterpret_cast<uint32_t*>(kv + hd);
  uint32_t* fxk = fxq + hd;
  int* sg = reinterpret_cast<int*>(fxk + hd);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwords = a.nbit / repro::kLaneBits;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const int stop = t_stop * per_pos;  // every later unit is masked
  __shared__ int unit_s[2];
  int worked = 0;

  // Each shared buffer a unit writes was last read, by the unit before,
  // ahead of the barrier that opens the take (thread 0 reads part_s just
  // before it), and the taken unit alternates between two slots, so one
  // barrier a take keeps the units apart.
  for (int i = 0;; ++i) {
    if (tid == 0) unit_s[i & 1] = atomicAdd(a.next_unit, 1);
    __syncthreads();
    const int unit = unit_s[i & 1];
    if (unit >= stop) break;
    const int t = unit / per_pos;
    const int row = unit % a.rows;
    const int bk = unit % per_pos / a.rows;
    const int bi = bk / a.kvh, kh = bk - bi * a.kvh;
    const int off = row % a.sc;
    if (t > a.lengths[bi] + off) continue;  // masked: no draw

    const T* q = static_cast<const T*>(a.q) + q_offset(a, bi, kh, row);
    const T* k = static_cast<const T*>(a.k_pages) + kv_offset(a, bi, kh, t);
    for (int d = tid; d < hd; d += nthreads) {
      qv[d] = to_f32(q[d]);
      kv[d] = to_f32(k[d]);
    }
    __syncthreads();
    if (warp == 0) {  // max-abs scales of the q row and the K row
      float mq = 0.0f, mk = 0.0f;
      for (int d = lane; d < hd; d += 32) {
        mq = fmaxf(mq, fabsf(qv[d]));
        mk = fmaxf(mk, fabsf(kv[d]));
      }
      for (int o = 16; o > 0; o >>= 1) {
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
        mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
      }
      if (lane == 0) {
        scale_s[0] = fmaxf(mq, kScaleGuard);
        scale_s[1] = fmaxf(mk, kScaleGuard);
      }
    }
    __syncthreads();
    const float sq = scale_s[0], sk = scale_s[1];
    for (int d = tid; d < hd; d += nthreads) {
      fxq[d] = repro::encode_fx16(__fdiv_rn(fabsf(qv[d]), sq), a.levels,
                                  a.quantize);
      fxk[d] = repro::encode_fx16(__fdiv_rn(fabsf(kv[d]), sk), a.levels,
                                  a.quantize);
      sg[d] = repro::sign_of(qv[d]) * repro::sign_of(kv[d]);
    }
    __syncthreads();

    // the query token's operand keys: its raw key split in two
    // (split_keys4); c0 = (t_abs * n_heads + head) * hd + d (mod 2^32)
    const uint32_t* key = a.keys + (static_cast<size_t>(bi) * a.sc + off) * 2;
    const uint2 kq = repro::threefry2x32(key[0], key[1], 0u, 0u);
    const uint2 kk = repro::threefry2x32(key[0], key[1], 0u, 1u);
    const uint32_t head = static_cast<uint32_t>(kh * a.group + row / a.sc);
    const uint32_t cbase =
        (static_cast<uint32_t>(t) * static_cast<uint32_t>(a.n_heads) + head) *
        static_cast<uint32_t>(hd);
    int32_t part = 0;
    for (int task = tid; task < hd * nwords; task += nthreads) {
      const int d = task / nwords, w = task - d * nwords;
      part += sg[d] * repro::sc_mul_word(kq.x, kq.y, kk.x, kk.y,
                                         cbase + static_cast<uint32_t>(d),
                                         fxq[d], fxk[d], w, nwords);
    }
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) part_s[warp] = part;
    __syncthreads();
    if (tid == 0) {
      int32_t sum = 0;
      for (int i = 0; i < (nthreads >> 5); ++i) sum += part_s[i];
      // the reference's f32 order: ((total / nbit) * sq) * sk * scale
      float est = __fdiv_rn(static_cast<float>(sum),
                            static_cast<float>(a.nbit));
      est = __fmul_rn(est, sq);
      est = __fmul_rn(est, sk);
      a.logits[(static_cast<size_t>(bk) * a.rows + row) * (a.nb * a.bs) +
               t] = __fmul_rn(est, scale);
    }
    ++worked;
  }
  if (a.counters != nullptr && tid == 0 && worked > 0) {
    atomicAdd(&a.counters[0], worked);
    atomicAdd(&a.counters[1], 1);
  }
}

// ---------------------------------------------------------------------------
// Pass 2: online softmax and PV over one split of a tile of query rows
// ---------------------------------------------------------------------------

// Shared-memory floats one split-pass block uses.
__host__ __device__ inline size_t split_smem_words(int hd, bool sc) {
  size_t n = kChunk * hd          // V chunk
             + kRowTile * kChunk  // logits / probabilities
             + kRowTile * hd      // accumulator
             + 3 * kRowTile;      // running max, denominator, alpha
  if (!sc) n += kRowTile * hd + kChunk * (hd + 1);  // q tile, K chunk
  return n;
}

// Positions t0 .. t0+n-1 of kv head kh, as floats, into dst[t * stride + d],
// in 16-byte loads (the wrapper checks that every K/V row starts on 16
// bytes).
template <typename T>
__device__ __forceinline__ void load_chunk(const Args& a, const T* pool,
                                           int bi, int kh, int t0, int n,
                                           float* dst, int stride) {
  constexpr int per = 16 / sizeof(T);
  const int nvec = a.hd / per;
  for (int idx = threadIdx.x; idx < n * nvec; idx += blockDim.x) {
    const int t = idx / nvec, v = idx - t * nvec;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        pool + kv_offset(a, bi, kh, t0 + t)) + v);
    unpack16(u, dst + t * stride + v * per, T());
  }
}

template <typename T, bool SC>
__global__ void __launch_bounds__(kSplitThreads)
paged_attn_split_kernel(Args a) {
  const int split = blockIdx.x, r0 = blockIdx.y * kRowTile, bk = blockIdx.z;
  const int bi = bk / a.kvh, kh = bk - bi * a.kvh;
  const int hd = a.hd, nrows = min(kRowTile, a.rows - r0);
  const int len = a.lengths[bi];
  int tile_last = 0;  // the last position any row of the tile sees
  for (int r = 0; r < nrows; ++r)
    tile_last = max(tile_last, last_pos(a, len, r0 + r));
  const int p_begin = split * a.pages_per_split * a.bs;
  if (p_begin > tile_last) return;  // past the tile's last live page
  if (a.counters != nullptr && threadIdx.x == 0)
    atomicAdd(&a.counters[2], 1);
  const int p_end = min(p_begin + a.pages_per_split * a.bs, tile_last + 1);

  extern __shared__ float smem[];
  float* v_s = smem;
  float* p_s = v_s + kChunk * hd;
  float* acc_s = p_s + kRowTile * kChunk;
  float* m_s = acc_s + kRowTile * hd;
  float* d_s = m_s + kRowTile;
  float* alpha_s = d_s + kRowTile;
  float* q_s = alpha_s + kRowTile;  // exact QK^T only
  float* k_s = q_s + kRowTile * hd;  // exact QK^T only, rows padded to hd+1
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const size_t row0 = static_cast<size_t>(bk) * a.rows + r0;
  const int T_len = a.nb * a.bs;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int idx = tid; idx < nrows * hd; idx += nthreads) {
    acc_s[idx] = 0.0f;
    if (!SC) {
      const int r = idx / hd, d = idx - r * hd;
      const T* q = static_cast<const T*>(a.q) + q_offset(a, bi, kh, r0 + r);
      q_s[idx] = to_f32(q[d]);
    }
  }
  if (tid < kRowTile) {
    m_s[tid] = kNegInf;
    d_s[tid] = 0.0f;
  }

  for (int t0 = p_begin; t0 < p_end; t0 += kChunk) {
    const int n = min(kChunk, p_end - t0);
    __syncthreads();  // the previous chunk is done with v_s and p_s
    load_chunk<T>(a, static_cast<const T*>(a.v_pages), bi, kh, t0, n, v_s,
                  hd);
    if (!SC) {
      load_chunk<T>(a, static_cast<const T*>(a.k_pages), bi, kh, t0, n, k_s,
                    hd + 1);
      __syncthreads();
      for (int idx = tid; idx < nrows * n; idx += nthreads) {
        const int r = idx / n, t = idx - r * n;
        float s = 0.0f;
        for (int d = 0; d < hd; ++d)
          s += q_s[r * hd + d] * k_s[t * (hd + 1) + d];
        const bool live = t0 + t <= len + (r0 + r) % a.sc;
        p_s[r * kChunk + t] = live ? s * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax of the chunk, a warp a row
    for (int r = warp; r < nrows; r += nwarps) {
      const int last = len + (r0 + r) % a.sc;
      const float* lrow = SC ? a.logits + (row0 + r) * T_len + t0 : nullptr;
      float l[kChunk / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        float v = kNegInf;
        if (t < n) {
          if (SC) {
            v = t0 + t <= last ? lrow[t] : kNegInf;
          } else {
            v = p_s[r * kChunk + t];
          }
        }
        l[i] = v;
        mx = fmaxf(mx, v);
      }
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kChunk / 32; ++i) {
        const int t = lane + 32 * i;
        if (t < n) {
          const float p = expf(l[i] - m_new);
          p_s[r * kChunk + t] = p;
          sum += p;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        d_s[r] = d_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nrows * hd; idx += nthreads) {
      const int r = idx / hd, d = idx - r * hd;
      float pv = 0.0f;
      for (int t = 0; t < n; ++t) pv += p_s[r * kChunk + t] * v_s[t * hd + d];
      acc_s[idx] = acc_s[idx] * alpha_s[r] + pv;
    }
  }
  __syncthreads();
  // a row writes only a split that holds one of its live positions
  for (int idx = tid; idx < nrows * hd; idx += nthreads) {
    const int r = idx / hd, d = idx - r * hd;
    if (p_begin > last_pos(a, len, r0 + r)) continue;
    if (a.splits == 1) {
      store(static_cast<T*>(a.out) + q_offset(a, bi, kh, r0 + r) + d,
            acc_s[idx] / fmaxf(d_s[r], kDenomGuard));
    } else {
      float* part = a.parts + ((row0 + r) * a.splits + split) * (hd + 2);
      part[d] = acc_s[idx];
      if (d == 0) {
        part[hd] = m_s[r];
        part[hd + 1] = d_s[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the fixed-order combine of a row's splits
// ---------------------------------------------------------------------------

template <typename T>
__global__ void paged_attn_combine_kernel(Args a) {
  const int row = blockIdx.x, bk = blockIdx.y;
  const int bi = bk / a.kvh, kh = bk - bi * a.kvh, hd = a.hd;
  const int n_split =
      last_pos(a, a.lengths[bi], row) / (a.pages_per_split * a.bs) + 1;
  const size_t r = static_cast<size_t>(bk) * a.rows + row;
  const float* part = a.parts + r * a.splits * (hd + 2);
  if (a.counters != nullptr && threadIdx.x == 0)
    atomicAdd(&a.counters[3], 1);
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part[s * (hd + 2) + hd]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float den = 0.0f, acc = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = part + s * (hd + 2);
      const float e = expf(ps[hd] - m);
      den += ps[hd + 1] * e;
      acc += ps[d] * e;
    }
    store(static_cast<T*>(a.out) + q_offset(a, bi, kh, row) + d,
          acc / fmaxf(den, kDenomGuard));
  }
}

// Blocks of the logits pass: as many as the card holds at once (the
// occupancy of this instantiation at this block size, looked up once;
// hd changes only the few bytes of shared memory a block uses), never
// more than the units.  The unit counter starts at 0 on the stream.
template <typename T>
int launch_logits(const Args& a, cudaStream_t stream) {
  static int resident[kMaxLogitThreads / 32 + 1];  // blocks, by threads / 32
  const size_t bytes = 5 * static_cast<size_t>(a.hd) * sizeof(float);
  int& cap = resident[a.logit_threads / 32];
  if (cap == 0) {
    int dev = 0, sms = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, paged_attn_logits_kernel<T>, a.logit_threads, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = max(1, n) * sms;
  }
  const long long units =
      static_cast<long long>(a.nb) * a.bs * a.rows * a.b * a.kvh;
  const unsigned int blocks =
      static_cast<unsigned int>(units < cap ? units : cap);
  cudaError_t e = cudaMemsetAsync(a.next_unit, 0, sizeof(int32_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attn_logits_kernel<T><<<blocks, a.logit_threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SC>
int launch(const Args& a, cudaStream_t stream) {
  if (SC) {
    const int code = launch_logits<T>(a, stream);
    if (code != 0) return code;
  }
  const size_t bytes = split_smem_words(a.hd, SC) * sizeof(float);
  auto kernel = paged_attn_split_kernel<T, SC>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.splits, (a.rows + kRowTile - 1) / kRowTile,
                  a.b * a.kvh);
  kernel<<<grid, kSplitThreads, bytes, stream>>>(a);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || a.splits == 1) return code;
  const int threads = min(256, (a.hd + 31) / 32 * 32);
  paged_attn_combine_kernel<T><<<dim3(a.rows, a.b * a.kvh), threads, 0,
                                 stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k_pages, const void* v_pages,
               const void* block_table, const void* lengths,
               const void* keys, void* logits, void* next_unit, void* parts,
               void* out, void* counters, const int* dims) {
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.block_table = static_cast<const int32_t*>(block_table);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.keys = static_cast<const uint32_t*>(keys);
  a.logits = static_cast<float*>(logits);
  a.next_unit = static_cast<int32_t*>(next_unit);
  a.parts = static_cast<float*>(parts);
  a.out = out;
  a.counters = static_cast<int32_t*>(counters);
  int* f[] = {&a.b, &a.kvh, &a.rows, &a.hd, &a.bs, &a.nb, &a.sc,
              &a.n_heads, &a.group, &a.nbit, &a.levels, &a.quantize,
              &a.pages_per_split, &a.splits, &a.logit_threads};
  for (int i = 0; i < 15; ++i) *f[i] = dims[i];
  return a;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// q and out (b, sc, h, hd) and k/v pages (P, bs, kvh, hd) share one
// dtype, f32 (bf16 = 0) or bf16 (bf16 = 1); every K/V row starts on 16
// bytes.  dims: b, kvh, rows, hd, bs, nb, sc, n_heads, group, nbit,
// levels, quantize, pages_per_split, splits, logit_threads (15 ints).
// keys (b, sc, 2) u32, the logits scratch (b, kvh, rows, nb * bs) f32
// and the unit counter (1,) i32 are used only when sc_logits != 0; the
// partials scratch (b, kvh, rows,
// splits, hd + 2) f32 only when splits > 1; counters (4,) i32, zeroed
// by the caller, may be null.  Returns the first non-zero
// cudaGetLastError() code of the launches.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* block_table,
                               const void* lengths, const void* keys,
                               void* logits, void* next_unit, void* parts,
                               void* out, void* counters, const int* dims,
                               int bf16, int sc_logits, void* stream) {
  const Args a = make_args(q, k_pages, v_pages, block_table, lengths, keys,
                           logits, next_unit, parts, out, counters, dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sc_logits)
    return bf16 ? launch<__nv_bfloat16, true>(a, s) : launch<float, true>(a, s);
  return bf16 ? launch<__nv_bfloat16, false>(a, s) : launch<float, false>(a, s);
}

// Pass 1 alone: the SC logits of every live (row, position) into logits
// (masked entries are left unwritten).  Arguments as paged_attention.
extern "C" int paged_attention_sc_logits(const void* q, const void* k_pages,
                                         const void* block_table,
                                         const void* lengths,
                                         const void* keys, void* logits,
                                         void* next_unit, const int* dims,
                                         int bf16, void* stream) {
  const Args a = make_args(q, k_pages, nullptr, block_table, lengths, keys,
                           logits, next_unit, nullptr, nullptr, nullptr,
                           dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_logits<__nv_bfloat16>(a, s) : launch_logits<float>(a, s);
}
