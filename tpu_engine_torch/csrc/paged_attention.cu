// Paged-attention decode reads for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces two TPU kernels of tpu_engine/ops/paged_attention.py:
// - `_paged_kernel` (its pallas_call sits in `_paged_call`), entry point
//   `paged_attention` here: the q_len-1 decode read of the two-path paged
//   scheduler over a bf16/f32 block pool;
// - `_quant_paged_kernel` (with the fold `_quant_fold`; pallas_call in
//   `_quant_paged_call`), entry point `quant_paged_attention`: the same read
//   over the int8 pool with one f32 scale per (block slot, kv-head).
//
// Contract, exactly that of `paged_attention_reference` and
// `quant_paged_attention_reference` in tpu_engine_torch/ops/paged_attention.py:
//
//   q (B, 1, H, D) f32; k_pool/v_pool (NB, bs, H_kv, D) f32, bf16 or int8;
//   k_scale/v_scale (NB, bs, H_kv) f32 (int8 only); tables (B, nb) int32;
//   pos (B,) int32  ->  out (B, 1, H, D): the pool's dtype (f32/bf16 pool),
//   f32 (int8 pool, the dtype of q). Row b attends logical columns
//   kpos < pos[b] + 1, column c read from block tables[b, c / bs] at offset
//   c % bs. Query head h * G + g (G = H / H_kv) reads kv head h. With the
//   int8 pool the K scales multiply the score columns and the V scales fold
//   into the softmax weights: s = (q . Kq_c) * (ks_c / sqrt(D)),
//   acc += (p_c * vs_c) Vq_c, l += p_c; the dequantized block never exists
//   in device memory.
//
// What bounds it on an H100: device-memory bytes. A (row, kv-head) pair reads
// the K and V of its pos + 1 columns once: 2 * D bytes per column in bf16 (plus
// 8 bytes of scales per column in int8, at D bytes each for K and V), at
// 3.35 TB/s; the arithmetic is 4 * D flops per (query head, column).
//
// Design, translated from the TPU kernel rather than copied:
// - The TPU grid (B, H_kv, nb) walks the row's blocks in sequence and keeps
//   the online softmax of its G group queries in VMEM scratch. Here one
//   thread block owns one (kv head, row) pair and loops over the row's
//   columns itself; nothing crosses thread blocks.
// - The TPU kernel DMAs one (bs, D) block per grid step. A 16-column step is
//   too little work to hide the latency of device memory here, so each step
//   stages a tile of kTile (64) columns, i.e. several blocks, every thread
//   loading its share of K and V (and the scale vectors) into shared memory
//   as f32 before the barrier. Columns past the row's length are neither
//   loaded nor attended: blocks wholly past the length are never touched.
// - Scores for the G queries x kTile columns go through shared memory; one
//   warp per query row takes the tile's max and sum with shuffles; the
//   weighted sum of V stays in f32 registers, the G * D accumulators spread
//   over the 128 threads (at most kMaxAcc each).
// - A row whose weights sum to 0 gives 0, as the TPU kernel's l == 0 -> 1.
//
// Simple and right first: CUDA-core f32 products, one tile in flight. A split
// of long contexts over several thread blocks (to fill 132 SMs at 8 rows x 4
// kv heads), a cp.async ring and vectorised loads are later work.

#include "paged_attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // columns staged per step
constexpr int kMaxAcc = 16;    // accumulators a thread holds: G * D <= 2048

template <typename KV, typename Out, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos,
                    Out* __restrict__ out,
                    int H, int H_kv, int bs, int nb, float scale) {
  constexpr int kStride = D + 1;        // pad: no bank conflicts on K rows
  constexpr int kPStride = kTile + 1;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = H / H_kv;
  const int length = min(pos[b] + 1, nb * bs);  // columns kpos < pos + 1
  const int* row_table = tables + static_cast<int64_t>(b) * nb;
  const int64_t qo_base = (static_cast<int64_t>(b) * H + h * G) * D;

  extern __shared__ float smem[];
  float* q_s = smem;                      // [G][kStride]
  float* k_s = q_s + G * kStride;         // [kTile][kStride]
  float* v_s = k_s + kTile * kStride;     // [kTile][kStride]
  float* p_s = v_s + kTile * kStride;     // [G][kPStride] scores, then weights
  float* ks_s = p_s + G * kPStride;       // [kTile] K scales (int8 pool)
  float* vs_s = ks_s + kTile;             // [kTile] V scales
  float* m_s = vs_s + kTile;              // [G] running max
  float* l_s = m_s + G;                   // [G] running sum of weights
  float* corr_s = l_s + G;                // [G] this step's rescale factor

  for (int i = tid; i < G * D; i += kThreads) q_s[(i / D) * kStride + i % D] = q[qo_base + i];
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int e = 0; e < kMaxAcc; ++e) acc[e] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int t0 = 0; t0 < length; t0 += kTile) {
    const int n_cols = min(kTile, length - t0);
    __syncthreads();  // the previous step's readers are done with the tile
    for (int i = tid; i < n_cols * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = t0 + c;
      const int64_t blk = row_table[col / bs];
      const int64_t off = ((blk * bs + col % bs) * H_kv + h) * D + d;
      k_s[c * kStride + d] = to_f32(k_pool[off]);
      v_s[c * kStride + d] = to_f32(v_pool[off]);
    }
    if (kQuant) {
      for (int c = tid; c < n_cols; c += kThreads) {
        const int col = t0 + c;
        const int64_t blk = row_table[col / bs];
        const int64_t soff = (blk * bs + col % bs) * H_kv + h;
        ks_s[c] = k_scale[soff];
        vs_s[c] = v_scale[soff];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * n_cols; i += kThreads) {
      const int g = i / n_cols, c = i % n_cols;
      const float* qr = q_s + g * kStride;
      const float* kc = k_s + c * kStride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
      p_s[g * kPStride + c] = kQuant ? dot * (ks_s[c] * scale) : dot * scale;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* sr = p_s + g * kPStride;
      float mx = -INFINITY;
      for (int c = lane; c < n_cols; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < n_cols; c += 32) {
        const float p = expf(sr[c] - safe);
        sum += p;
        sr[c] = kQuant ? p * vs_s[c] : p;  // V scales fold into the weights
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - safe);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kMaxAcc; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* pr = p_s + g * kPStride;
        float a = acc[e] * corr_s[g];
        for (int c = 0; c < n_cols; ++c) a = fmaf(pr[c], v_s[c * kStride + d], a);
        acc[e] = a;
      }
    }
  }
  __syncthreads();  // l_s complete (and initialised, for an empty row)

#pragma unroll
  for (int e = 0; e < kMaxAcc; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < G * D) {
      const float l = l_s[idx / D];
      store(out + qo_base + idx, acc[e] / (l == 0.f ? 1.f : l));
    }
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (G * (D + 1) + 2 * kTile * (D + 1) + G * (kTile + 1)
                          + 2 * kTile + 3 * G);
}

template <typename KV, typename Out, bool kQuant, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* pos, void* out, int B, int H, int H_kv, int bs,
                   int nb, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<KV, Out, kQuant, D>;
  const size_t smem = smem_bytes(H / H_kv, D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<dim3(H_kv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<Out*>(out), H, H_kv, bs, nb, scale);
  return cudaGetLastError();
}

template <typename KV, typename Out, bool kQuant>
cudaError_t dispatch_d(const void* q, const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* tables, const void* pos, void* out, int B,
                       int H, int H_kv, int D, int bs, int nb,
                       cudaStream_t stream) {
  switch (D) {
    case 8:   return launch<KV, Out, kQuant, 8>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, bs, nb, stream);
    case 16:  return launch<KV, Out, kQuant, 16>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, bs, nb, stream);
    case 32:  return launch<KV, Out, kQuant, 32>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, bs, nb, stream);
    case 64:  return launch<KV, Out, kQuant, 64>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, bs, nb, stream);
    case 128: return launch<KV, Out, kQuant, 128>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, bs, nb, stream);
    default:  return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int H, int H_kv, int D, int bs, int nb) {
  return B <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0
         || (H / H_kv) * D > kThreads * kMaxAcc;
}

}  // namespace

extern "C" {

// kv_dtype: 0 = float32, 1 = bfloat16 (the output takes the pool's dtype).
// Returns the launch's cudaError_t (0 = success).
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* pos, void* out, int B, int H,
                    int H_kv, int D, int bs, int nb, int kv_dtype, void* stream) {
  if (bad_shape(B, H, H_kv, D, bs, nb)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return dispatch_d<float, float, false>(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, B, H, H_kv, D, bs, nb, s);
  if (kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, B, H, H_kv, D, bs, nb, s);
  return cudaErrorInvalidValue;
}

// int8 pool with f32 scales; the output is f32. Returns the launch's
// cudaError_t (0 = success).
int quant_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale,
                          const void* tables, const void* pos, void* out, int B,
                          int H, int H_kv, int D, int bs, int nb, void* stream) {
  if (bad_shape(B, H, H_kv, D, bs, nb)) return cudaErrorInvalidValue;
  return dispatch_d<int8_t, float, true>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, H_kv, D, bs, nb,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
