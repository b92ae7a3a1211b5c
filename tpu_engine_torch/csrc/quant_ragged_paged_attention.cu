// Ragged paged attention over the int8 block pool for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel `_quant_ragged_kernel` of
// tpu_engine/ops/paged_attention.py (with its fold `_quant_fold`; the
// pallas_call sits in `_quant_ragged_call`). The contract is exactly that of
// `quant_ragged_paged_attention_reference` in
// tpu_engine_torch/ops/paged_attention.py:
//
//   q (B, W, H, D) f32; k_pool/v_pool (NB, bs, H_kv, D) int8; k_scale/v_scale
//   (NB, bs, H_kv) f32; tables (B, nb) int32; pos0, qlen (B,) int32
//   ->  out (B, W, H, D) f32 (the dtype of q). Query slot i of row b sits at
//   logical position pos0[b] + i and attends keys kpos <= pos0[b] + i, read
//   through block tables[b, kpos / bs]. Slots i >= qlen[b] are padding (this
//   kernel writes zeros for a tile that holds only padding). A row with no
//   valid key gives 0. K scales multiply the score columns and V scales fold
//   into the softmax weights: s = (q . Kq_c) * (ks_c / sqrt(D)),
//   acc += (p_c * vs_c) Vq_c, l += p_c. The dequantized block never exists in
//   device memory.
//
// What bounds it on an H100: at decode widths device-memory bytes (D bytes of
// int8 payload and 4 bytes of scale per column, for each of K and V, per
// (row, kv-head) pair, at 3.35 TB/s); with a long prefill chunk the 4 * D flops
// per attended (query head, key) pair, which CUDA-core f32 products are far
// from the card's rate on.
//
// Design: that of ragged_paged_attention.cu (the port of `_ragged_kernel`),
// with the int8 block and its two scale vectors staged per step:
// - thread blocks are (query tile, kv head, row); a tile holds kRows (64) of
//   the row's W * G query rows (row r = slot r / G, group head r % G, as in
//   the TPU kernel) and loops over the row's blocks up to its own last causal
//   column; a tile of padding slots writes zeros and returns;
// - one int8 K block and one V block (bs x D) are converted to f32 in shared
//   memory beside their f32 scale vectors; scores go through shared memory,
//   the online softmax and the weighted sum of V stay in f32 registers (four
//   threads per query row, D / 4 accumulators each).
//
// Simple and right first; tensor-core products, a cp.async ring and a split
// over long contexts are later work.

#include "paged_attention_common.cuh"

namespace {

constexpr int kRows = 64;                          // query rows per thread block
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kRows;   // 4: PV product split over D

template <int D>
__global__ void __launch_bounds__(kThreads)
quant_ragged_kernel(const float* __restrict__ q,
                    const int8_t* __restrict__ k_pool,
                    const int8_t* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos0,
                    const int* __restrict__ qlen,
                    float* __restrict__ out,
                    int W, int H, int H_kv, int bs, int nb, float scale) {
  constexpr int kDPerThread = D / kThreadsPerRow;
  constexpr int kStride = D + 1;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / H_kv;
  const int row0 = tile * kRows;
  const int n_rows = min(kRows, W * G - row0);
  const int p0 = pos0[b];
  const int ql = min(qlen[b], W);
  const int64_t out_row_base = static_cast<int64_t>(b) * W * H * D;

  const int r_own = tid / kThreadsPerRow;
  const int d0 = (tid % kThreadsPerRow) * kDPerThread;
  const bool own_live = r_own < n_rows;
  const int own_row = row0 + r_own;
  float* own_out = out + out_row_base
      + (static_cast<int64_t>(own_row / G) * H + h * G + own_row % G) * D + d0;

  if (row0 / G >= ql) {
    if (own_live) {
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) own_out[e] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][kStride]
  float* k_s = q_s + kRows * kStride;       // [bs][kStride] int8 values as f32
  float* v_s = k_s + bs * kStride;          // [bs][kStride]
  float* s_s = v_s + bs * kStride;          // [kRows][bs + 1]
  float* ks_s = s_s + kRows * (bs + 1);     // [bs] K scales
  float* vs_s = ks_s + bs;                  // [bs] V scales
  const int s_stride = bs + 1;

  for (int idx = tid; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    q_s[r * kStride + d] =
        q[out_row_base + (static_cast<int64_t>(row / G) * H + h * G + row % G) * D + d];
  }

  const int slot_last = min((row0 + n_rows - 1) / G, ql - 1);
  const int n_blocks = min(nb, (p0 + slot_last) / bs + 1);

  float acc[kDPerThread];
#pragma unroll
  for (int e = 0; e < kDPerThread; ++e) acc[e] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j = 0; j < n_blocks; ++j) {
    const int64_t blk = tables[static_cast<int64_t>(b) * nb + j];
    __syncthreads();
    for (int idx = tid; idx < bs * D; idx += kThreads) {
      const int s = idx / D, d = idx % D;
      const int64_t off = ((blk * bs + s) * H_kv + h) * D + d;
      k_s[s * kStride + d] = to_f32(k_pool[off]);
      v_s[s * kStride + d] = to_f32(v_pool[off]);
    }
    for (int s = tid; s < bs; s += kThreads) {
      const int64_t soff = (blk * bs + s) * H_kv + h;
      ks_s[s] = k_scale[soff];
      vs_s[s] = v_scale[soff];
    }
    __syncthreads();
    for (int idx = tid; idx < n_rows * bs; idx += kThreads) {
      const int r = idx / bs, c = idx % bs;
      const float* qr = q_s + r * kStride;
      const float* kc = k_s + c * kStride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
      const int kpos = j * bs + c;
      const int qpos = p0 + (row0 + r) / G;
      s_s[r * s_stride + c] = kpos <= qpos ? dot * (ks_s[c] * scale) : -INFINITY;
    }
    __syncthreads();
    if (!own_live) continue;
    const float* sr = s_s + r_own * s_stride;
    float m_blk = -INFINITY;
    for (int c = 0; c < bs; ++c) m_blk = fmaxf(m_blk, sr[c]);
    const float m_new = fmaxf(m, m_blk);
    if (m_new == -INFINITY) continue;  // nothing valid yet for this row
    const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e) acc[e] *= corr;
    for (int c = 0; c < bs; ++c) {
      const float p = sr[c] == -INFINITY ? 0.f : expf(sr[c] - m_new);
      l += p;
      const float pv = p * vs_s[c];    // V scales fold into the weights
      const float* vc = v_s + c * kStride + d0;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) acc[e] = fmaf(pv, vc[e], acc[e]);
    }
    m = m_new;
  }

  if (own_live) {
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e) own_out[e] = l > 0.f ? acc[e] / l : 0.f;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* pos0, const void* qlen, void* out, int B, int W,
                   int H, int H_kv, int bs, int nb, cudaStream_t stream) {
  const int G = H / H_kv;
  const dim3 grid((W * G + kRows - 1) / kRows, H_kv, B);
  const size_t smem = sizeof(float)
      * (kRows * (D + 1) + 2 * bs * (D + 1) + kRows * (bs + 1) + 2 * bs);
  auto kernel = quant_ragged_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos0), static_cast<const int*>(qlen),
      static_cast<float*>(out), W, H, H_kv, bs, nb, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 = success).
int quant_ragged_paged_attention(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* pos0, const void* qlen, void* out,
                                 int B, int W, int H, int H_kv, int D, int bs,
                                 int nb, void* stream) {
  if (B <= 0 || W <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:   return launch<8>(q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, s);
    case 16:  return launch<16>(q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, s);
    case 32:  return launch<32>(q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, s);
    case 64:  return launch<64>(q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, s);
    case 128: return launch<128>(q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, s);
    default:  return cudaErrorInvalidValue;
  }
}

}  // extern "C"
