// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` of tpu_engine/ops/flash.py (its
// pallas_call sits in `_flash_fwd_call`, public wrapper `flash_attention`).
// The contract is that of `flash_attention_reference` in
// tpu_engine_torch/ops/flash.py:
//
//   q (B, Sq, H, D); k, v (B, Sk, H, D), f32 or bf16, read through their
//   (b, s, h) element strides (the last dimension contiguous); mask (B, Sk)
//   int32, 1 = valid, or null; causal (query i attends keys j <= i) and an
//   optional sliding window (keys j > i - window; causal only)
//   ->  out (B, Sq, H, D) in v's dtype, lse (B, H, Sq) f32.
//   A query row with no valid key gives out 0 and lse -inf, never NaN.
//   lse is the residual of the backward: the two kernels of
//   flash_attention_bwd.cu (the ports of `_bwd_dq_kernel` and
//   `_bwd_dkv_kernel`) recompute the probabilities from it, and its -inf
//   rows give them zero gradients.
//
// Rounding points are the TPU kernel's: scores are products of the input
// values summed in f32 and scaled by 1/sqrt(D); the softmax runs in f32;
// the weights are rounded to v's dtype before the weighted sum of V, which
// is accumulated in f32; the denominator sums the unrounded weights; the
// output is rounded to v's dtype once, at the end.
//
// What bounds it on an H100: operations. A causal prompt of S tokens does
// 4 * D flops per attended (query, key) pair, about S^2 / 2 pairs per head,
// against 4 * S * D elements of q, k, v and out per head: at S 2048, D 64 in
// bf16 that is ~500 flops per byte, above the card's ~295, so the tensor
// cores' rate is the roof.
//
// Design, translated from the TPU kernel rather than copied:
// - The TPU grid (B*H, Sq/bq, Sk/bk) runs its key axis in sequence and
//   carries the online softmax in VMEM scratch. Here the key axis is a loop
//   inside one thread block, and the thread blocks are (64-row query tile,
//   head, batch): nothing carries over between thread blocks.
// - The TPU wrapper transposes to (B*H, S, D) and pads S to the block; here
//   the kernel reads the (B, S, H, D) layout through strides and bounds-checks
//   the ragged tail tiles, so neither copy exists.
// - Key tiles wholly above the causal diagonal, and wholly below a sliding
//   window's band, are never loaded (the TPU kernel's `pl.when` skip).
// - 64 keys at a time are staged in shared memory as f32 with their padding
//   mask folded into one additive bias per key (0 or -inf). Each of the 256
//   threads computes a 4 x 4 block of the 64 x 64 score tile in registers;
//   the scores go through shared memory, where the four threads that own a
//   query row take its online softmax (max and sum by warp shuffles), write
//   the rounded weights back, and each accumulates D / 4 output columns
//   (interleaved, so the four threads hit four banks) in f32 registers.
//
// This first version is simple and right: CUDA-core f32 products. wgmma
// tiles fed by TMA, a cp.async ring, and reading grouped K/V without the
// caller's repeat_kv are later work.
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "paged_attention_common.cuh"

namespace {

constexpr int kRows = 64;                          // query rows per thread block
constexpr int kCols = 64;                          // keys per staged tile
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kRows;   // 4: softmax and PV per row
constexpr int kMicro = 4;                          // 4 x 4 scores per thread
constexpr int kSStride = kCols + 1;

static_assert(kRows == kCols && kRows * kCols == kThreads * kMicro * kMicro,
              "the score tile is split into one 4 x 4 block per thread");

struct Strides {
  long long b, s, h;
};

// p rounded to the value type before the PV product, as the TPU kernel's
// `p.astype(v.dtype)`.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ mask,
                       T* __restrict__ out, float* __restrict__ lse,
                       int Sq, int Sk, int H, Strides qs, Strides ks,
                       Strides vs, int causal, int window, float scale) {
  constexpr int kDPerThread = D / kThreadsPerRow;
  constexpr int kStride = D + 1;                   // pad: no bank conflicts on rows
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = tile * kRows;
  const int n_rows = min(kRows, Sq - q0);

  extern __shared__ float smem[];
  float* q_s = smem;                               // [kRows][kStride]
  float* k_s = q_s + kRows * kStride;              // [kCols][kStride]
  float* v_s = k_s + kCols * kStride;              // [kCols][kStride]
  float* s_s = v_s + kCols * kStride;              // [kRows][kSStride]
  float* bias_s = s_s + kRows * kSStride;          // [kCols]

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[r * kStride + d] = r < n_rows ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // The key tiles this query tile reaches.
  int j_end = (Sk + kCols - 1) / kCols;
  if (causal) j_end = min(j_end, (q0 + n_rows - 1) / kCols + 1);
  int j_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) j_begin = (q0 - window + 1) / kCols;

  // Score block of this thread: rows tr + 16 i, columns tc + 16 j.
  const int tr = tid / 16, tc = tid % 16;
  // Softmax and PV: this thread's row, and its interleaved quarter of D.
  const int r_own = tid / kThreadsPerRow;
  const int quarter = tid % kThreadsPerRow;
  const bool own_live = r_own < n_rows;

  float acc[kDPerThread];
#pragma unroll
  for (int e = 0; e < kDPerThread; ++e) acc[e] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kCols;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/s_s
    for (int idx = tid; idx < kCols * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int kpos = k0 + c;
      const bool in = kpos < Sk;
      k_s[c * kStride + d] = in ? to_f32(kb[kpos * ks.s + d]) : 0.f;
      v_s[c * kStride + d] = in ? to_f32(vb[kpos * vs.s + d]) : 0.f;
    }
    if (tid < kCols) {
      const int kpos = k0 + tid;
      const bool valid = kpos < Sk && (mb == nullptr || mb[kpos] > 0);
      bias_s[tid] = valid ? 0.f : -INFINITY;
    }
    __syncthreads();

    float sc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) sc[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kMicro], kv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) qv[i] = q_s[(tr + 16 * i) * kStride + d];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) kv[c] = k_s[(tc + 16 * c) * kStride + d];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = tr + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int col = tc + 16 * c;
        const int kpos = k0 + col;
        float s = sc[i][c] * scale + bias_s[col];
        if (causal && (kpos > qpos || (window > 0 && qpos - kpos >= window)))
          s = -INFINITY;
        s_s[r * kSStride + col] = s;
      }
    }
    __syncthreads();

    // Online softmax of this row's tile: the four threads of the row are
    // neighbouring lanes of one warp and reduce by shuffles.
    float* sr = s_s + r_own * kSStride;
    constexpr int kColsPerThread = kCols / kThreadsPerRow;
    const int c0 = quarter * kColsPerThread;
    float m_tile = -INFINITY;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) m_tile = fmaxf(m_tile, sr[c0 + c]);
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    // Rows with nothing valid yet (all four threads of a row agree).
    const bool fold = own_live && m_new != -INFINITY;
    float p_sum = 0.f;
    if (fold) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const float s = sr[c0 + c];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        p_sum += p;
        sr[c0 + c] = round_to(p, q);
      }
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    __syncwarp();  // the row's rounded weights are written
    if (fold) {
      const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
      l = l * corr + p_sum;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) acc[e] *= corr;
      for (int c = 0; c < kCols; ++c) {
        const float p = sr[c];
        const float* vc = v_s + c * kStride + quarter;
#pragma unroll
        for (int e = 0; e < kDPerThread; ++e)
          acc[e] = fmaf(p, vc[kThreadsPerRow * e], acc[e]);
      }
      m = m_new;
    }
  }

  if (own_live) {
    const int qpos = q0 + r_own;
    T* o = out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D + quarter;
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e)
      store(o + kThreadsPerRow * e, l > 0.f ? acc[e] / l : 0.f);
    if (quarter == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos] =
          l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, void* lse, int B, int Sq, int Sk, int H,
                   Strides qs, Strides ks, Strides vs, int causal, int window,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  const size_t smem = sizeof(float) * ((kRows + 2 * kCols) * (D + 1)
                                       + kRows * kSStride + kCols);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      Sq, Sk, H, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* mask,
                       void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                       Strides qs, Strides ks, Strides vs, int causal, int window,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(q, k, v, mask, out, lse, B, Sq, Sk, H, qs, ks, vs, causal, window, scale, stream);
    case 32:  return launch<T, 32>(q, k, v, mask, out, lse, B, Sq, Sk, H, qs, ks, vs, causal, window, scale, stream);
    case 64:  return launch<T, 64>(q, k, v, mask, out, lse, B, Sq, Sk, H, qs, ks, vs, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, lse, B, Sq, Sk, H, qs, ks, vs, causal, window, scale, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). window: 0 = no
// sliding window, else >= 1 (causal only). mask may be null. Returns the
// launch's cudaError_t (0 = success); the caller checks it, since a refused
// launch never runs.
int flash_attention(const void* q, const void* k, const void* v, const void* mask,
                    void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      window < 0 || (window > 0 && !causal))
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, mask, out, lse, B, Sq, Sk, H, D, qs, ks, vs, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, mask, out, lse, B, Sq, Sk, H, D, qs, ks, vs, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
