// Ragged paged attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_ragged_kernel` of
// tpu_engine/ops/paged_attention.py (its pallas_call sits in `_ragged_call`,
// wrapper `ragged_paged_attention`). The contract is exactly that of
// `ragged_paged_attention_reference` there and of the plain PyTorch version
// in tpu_engine_torch/ops/paged_attention.py:
//
//   q (B, W, H, D) f32; k_pool/v_pool (NB, bs, H_kv, D) f32 or bf16;
//   tables (B, nb) int32; pos0, qlen (B,) int32  ->  out (B, W, H, D) in the
//   pool's dtype. Query slot i of row b sits at logical position pos0[b] + i
//   and attends keys kpos <= pos0[b] + i, read through block
//   tables[b, kpos / bs]. Slots i >= qlen[b] are padding (any output; this
//   kernel writes zeros for a tile that holds only padding). A row with no
//   valid key gives 0.
//
// What bounds it on an H100: device-memory bytes. Every (row, kv-head) pair
// must read the K and V blocks of its history once, 2 * bs * D * sizeof(kv)
// bytes per block (2 KB each for K and V in bf16 at bs 16, D 64), at
// 3.35 TB/s; the arithmetic is 4 * D flops per (query row, key), far below
// the card's rate at decode widths.
//
// Design, translated from the TPU kernel rather than copied:
// - The TPU grid (B, H_kv, nb) runs its block axis in sequence and carries
//   the online-softmax state in VMEM scratch. Here the block axis is a loop
//   inside one thread block, and the thread blocks are
//   (query tile, kv head, row): nothing carries over between thread blocks.
// - The TPU holds all W * G query rows of a (row, kv head) at once. At a
//   256-token chunk with G = 8 that is 2048 rows of D f32 accumulators, far
//   more than one SM's registers, so the rows are tiled, kRows (64) per
//   thread block, over the grid's x axis. Row r of the tile is query slot
//   (row0 + r) / G, group head (row0 + r) % G, as in the TPU kernel.
// - A tile stops its block loop at its own last causal column
//   (pos0 + its last valid slot), not at the row's whole length; a tile of
//   padding slots writes zeros and returns.
// - Scalar prefetch of the block table becomes each thread block reading its
//   own row of `tables`. One K block and one V block (bs x D) at a time are
//   staged in shared memory as f32; scores for the tile go through shared
//   memory, and the online softmax and the weighted sum of V stay in f32
//   registers (four threads per query row, D / 4 accumulators each).
//
// This first version is simple and right: CUDA-core f32 products, one block
// staged at a time. wgmma/TMA tiles, a multi-stage cp.async ring and a
// split over long contexts (to fill 132 SMs at decode widths) are later
// work.
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "paged_attention_common.cuh"

namespace {

constexpr int kRows = 64;                          // query rows per thread block
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kRows;   // 4: PV product split over D

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const float* __restrict__ q,
                              const KV* __restrict__ k_pool,
                              const KV* __restrict__ v_pool,
                              const int* __restrict__ tables,
                              const int* __restrict__ pos0,
                              const int* __restrict__ qlen,
                              KV* __restrict__ out,
                              int W, int H, int H_kv, int bs, int nb,
                              float scale) {
  constexpr int kDPerThread = D / kThreadsPerRow;
  constexpr int kStride = D + 1;                   // pad: no bank conflicts on K rows
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

  // This thread's own query row in the PV product, and its slice of D.
  const int r_own = tid / kThreadsPerRow;
  const int d0 = (tid % kThreadsPerRow) * kDPerThread;
  const bool own_live = r_own < n_rows;
  const int own_row = row0 + r_own;
  KV* own_out = out + out_row_base
      + (static_cast<int64_t>(own_row / G) * H + h * G + own_row % G) * D + d0;

  if (row0 / G >= ql) {
    // Every slot of this tile is padding (qlen 0 rows included).
    if (own_live) {
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) store(own_out + e, 0.f);
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][kStride]
  float* k_s = q_s + kRows * kStride;       // [bs][kStride]
  float* v_s = k_s + bs * kStride;          // [bs][kStride]
  float* s_s = v_s + bs * kStride;          // [kRows][bs + 1]
  const int s_stride = bs + 1;

  for (int idx = tid; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    q_s[r * kStride + d] =
        q[out_row_base + (static_cast<int64_t>(row / G) * H + h * G + row % G) * D + d];
  }

  // The tile's last causal column bounds its block loop.
  const int slot_last = min((row0 + n_rows - 1) / G, ql - 1);
  const int n_blocks = min(nb, (p0 + slot_last) / bs + 1);

  float acc[kDPerThread];
#pragma unroll
  for (int e = 0; e < kDPerThread; ++e) acc[e] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j = 0; j < n_blocks; ++j) {
    const int64_t blk = tables[static_cast<int64_t>(b) * nb + j];
    __syncthreads();  // the previous block's readers are done with k_s/v_s/s_s
    for (int idx = tid; idx < bs * D; idx += kThreads) {
      const int s = idx / D, d = idx % D;
      const int64_t off = ((blk * bs + s) * H_kv + h) * D + d;
      k_s[s * kStride + d] = to_f32(k_pool[off]);
      v_s[s * kStride + d] = to_f32(v_pool[off]);
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
      s_s[r * s_stride + c] = kpos <= qpos ? dot * scale : -INFINITY;
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
      const float* vc = v_s + c * kStride + d0;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) acc[e] = fmaf(p, vc[e], acc[e]);
    }
    m = m_new;
  }

  if (own_live) {
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e)
      store(own_out + e, l > 0.f ? acc[e] / l : 0.f);
  }
}

template <typename KV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* pos0, const void* qlen,
                   void* out, int B, int W, int H, int H_kv, int bs, int nb,
                   cudaStream_t stream) {
  const int G = H / H_kv;
  const dim3 grid((W * G + kRows - 1) / kRows, H_kv, B);
  const size_t smem =
      sizeof(float) * (kRows * (D + 1) + 2 * bs * (D + 1) + kRows * (bs + 1));
  auto kernel = ragged_paged_attention_kernel<KV, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos0), static_cast<const int*>(qlen),
      static_cast<KV*>(out), W, H, H_kv, bs, nb, scale);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch_d(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* pos0, const void* qlen,
                       void* out, int B, int W, int H, int H_kv, int D, int bs,
                       int nb, cudaStream_t stream) {
  switch (D) {
    case 8:   return launch<KV, 8>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, stream);
    case 16:  return launch<KV, 16>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, stream);
    case 32:  return launch<KV, 32>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, stream);
    case 64:  return launch<KV, 64>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, stream);
    case 128: return launch<KV, 128>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, bs, nb, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kv_dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (0 = success); the caller checks it, since a refused launch never runs.
int ragged_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                           const void* tables, const void* pos0, const void* qlen,
                           void* out, int B, int W, int H, int H_kv, int D, int bs,
                           int nb, int kv_dtype, void* stream) {
  if (B <= 0 || W <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return dispatch_d<float>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, D, bs, nb, s);
  if (kv_dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, tables, pos0, qlen, out, B, W, H, H_kv, D, bs, nb, s);
  return cudaErrorInvalidValue;
}

// The library's one error-string entry point (every kernel of it returns a
// cudaError_t); it lives here because a symbol may be defined only once.
const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
