// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, one per gradient sweep.
//
// Replaces the TPU kernels of tpu_engine/ops/flash.py that `_flash_bwd_call`
// launches (the backward half of the `custom_vjp` around `_flash_core`):
//   - `_bwd_dq_kernel`  -> flash_attention_bwd_dq  (dq; sweeps the key tiles)
//   - `_bwd_dkv_kernel` -> flash_attention_bwd_dkv (dk, dv; sweeps the query
//     tiles)
// The contract is that of `flash_attention_bwd_dq_reference` and
// `flash_attention_bwd_dkv_reference` in tpu_engine_torch/ops/flash.py:
//
//   q, do (B, Sq, H, D); k, v (B, Sk, H, D), f32 or bf16, read through their
//   (b, s, h) element strides (the last dimension contiguous); mask (B, Sk)
//   int32, 1 = valid, or null; causal (query i attends keys j <= i, both
//   counted from 0) and an optional sliding window (keys j > i - window;
//   causal only); lse (B, H, Sq) f32 as the forward kernel writes it (-inf on
//   rows with no valid key); delta (B, H, Sq) f32 = sum_d do * out
//   ->  dq (B, Sq, H, D) in q's dtype; dk, dv (B, Sk, H, D) in k's and v's.
//
// The probabilities are recomputed from lse, as `_recompute_p` does: p =
// exp(s * scale - lse) on the pairs the forward attended, 0 on the others and
// on rows whose lse is -inf (so such a row gives dq 0 and adds nothing to dk
// or dv, never NaN). dp = do . v^T and the scores are products of the input
// values summed in f32; ds = p * (dp - delta) in f32. Rounding points are the
// TPU kernels': p is rounded to do's dtype before the dv product, ds to k's
// (dq) or q's (dk) dtype before its product; the sums run in f32 and each
// gradient is rounded to its dtype once, at the end.
//
// What bounds it on an H100: operations. A causal pass of S tokens does
// 6 * D (dq) or 8 * D (dk, dv) flops per attended (query, key) pair, about
// S^2 / 2 pairs per head, against about 7 * S * D elements moved per head. In
// float32 the products run on the CUDA cores (67 TFLOP/s, no TF32), so the
// roof is far lower than in bf16.
//
// Design, translated from the TPU kernels rather than copied:
// - The TPU grid runs its swept axis in sequence and carries dq (or dk, dv)
//   in VMEM scratch across it. Here the swept axis is a loop inside one
//   thread block: dq's thread blocks are (64-row query tile, head, batch) and
//   loop over the key tiles the forward visited; dk/dv's are (64-key tile,
//   head, batch) and loop over the query tiles that reach the key tile. Each
//   thread block owns its output tile and writes it once: no atomics, so the
//   gradients are bit-identical from run to run.
// - The TPU wrapper transposes to (B*H, S, D) and pads S to the block; here
//   the kernels read the (B, S, H, D) layout through strides and
//   bounds-check the ragged tail tiles.
// - The TPU kernels' tile skips: key tiles wholly above the causal diagonal
//   or below a sliding window's band are never visited (dq), and a key tile
//   only visits the query tiles from its diagonal down to its band's end
//   (dk, dv).
// - Tiles are staged in shared memory as f32 (row stride D + 1, so the
//   threads of a warp reading different rows hit different banks). Each of
//   the 256 threads computes a 4 x 4 block of the 64 x 64 score tile and the
//   same block of dp = do . v^T in one pass over D, forms p and ds in
//   registers and writes them (rounded) to shared memory. Then each group of
//   four threads owns one output row (a query row for dq, a key row for dk
//   and dv) and accumulates D / 4 interleaved columns of it in f32 registers.
// - Shared memory: four 64 x (D + 1) tiles plus one (dq) or two (dk, dv)
//   64 x 65 tiles: at D 128, 146 KB and 162 KB, above the 48 KB default, so
//   each launch opts in to dynamic shared memory (a refused launch returns
//   its error).
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

constexpr int kTile = 64;                          // rows per tile, both axes
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kTile;   // 4: one output row each
constexpr int kMicro = 4;                          // 4 x 4 scores per thread
constexpr int kSStride = kTile + 1;

static_assert(kTile * kTile == kThreads * kMicro * kMicro,
              "the score tile is split into one 4 x 4 block per thread");

struct Strides {
  long long b, s, h;
};

// A value rounded to the element type T (the TPU kernels' `.astype`).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + kTile) of one head of x, as f32, into dst[kTile][D + 1];
// zeros past the sequence end S.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* x, Strides st,
                                      int r0, int S, int tid) {
  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = r0 + r < S ? to_f32(x[(r0 + r) * st.s + d]) : 0.f;
  }
}

// The lse and delta rows [q0, q0 + kTile) of one head; rows past Sq get lse
// -inf (p = 0) and delta 0.
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* lse, const float* delta,
                                           long long row0, int n_rows, int tid) {
  if (tid < kTile) {
    const bool in = tid < n_rows;
    lse_s[tid] = in ? lse[row0 + tid] : -INFINITY;
    delta_s[tid] = in ? delta[row0 + tid] : 0.f;
  }
}

// Which keys [k0, k0 + kTile) exist and pass the padding mask.
__device__ __forceinline__ void stage_keys(int* kvalid_s, const int* mb, int k0,
                                           int Sk, int tid) {
  if (tid < kTile) {
    const int kpos = k0 + tid;
    kvalid_s[tid] = kpos < Sk && (mb == nullptr || mb[kpos] > 0);
  }
}

// This thread's 4 x 4 blocks of s = q . k^T and dp = do . v^T over a
// (query tile, key tile) pair: query rows tr + 16 i, keys tc + 16 c.
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* q_s, const float* k_s,
                                              const float* do_s, const float* v_s,
                                              int tr, int tc,
                                              float s[kMicro][kMicro],
                                              float dp[kMicro][kMicro]) {
  constexpr int kStride = D + 1;
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kMicro], dov[kMicro], kv[kMicro], vv[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      qv[i] = q_s[(tr + 16 * i) * kStride + d];
      dov[i] = do_s[(tr + 16 * i) * kStride + d];
    }
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      kv[c] = k_s[(tc + 16 * c) * kStride + d];
      vv[c] = v_s[(tc + 16 * c) * kStride + d];
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
      }
  }
}

// p of one (query, key) pair: 0 where the forward attended nothing.
__device__ __forceinline__ float recompute_p(float s, float scale, float lse,
                                             bool key_ok, int qpos, int kpos,
                                             int causal, int window) {
  bool keep = key_ok && lse != -INFINITY;
  if (causal) keep = keep && kpos <= qpos && (window == 0 || qpos - kpos < window);
  return keep ? expf(s * scale - lse) : 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ mask,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq,
                              int Sq, int Sk, int H, Strides qs, Strides ks,
                              Strides vs, Strides dos, int causal, int window,
                              float scale) {
  constexpr int kStride = D + 1;
  constexpr int kDPerThread = D / kThreadsPerRow;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = tile * kTile;
  const int n_rows = min(kTile, Sq - q0);

  extern __shared__ float smem[];
  float* q_s = smem;                               // [kTile][kStride]
  float* do_s = q_s + kTile * kStride;             // [kTile][kStride]
  float* k_s = do_s + kTile * kStride;             // [kTile][kStride]
  float* v_s = k_s + kTile * kStride;              // [kTile][kStride]
  float* ds_s = v_s + kTile * kStride;             // [kTile][kSStride]
  float* lse_s = ds_s + kTile * kSStride;          // [kTile]
  float* delta_s = lse_s + kTile;                  // [kTile]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  stage<T, D>(q_s, q + b * qs.b + h * qs.h, qs, q0, Sq, tid);
  stage<T, D>(do_s, dout + b * dos.b + h * dos.h, dos, q0, Sq, tid);
  stage_rows(lse_s, delta_s, lse, delta,
             (static_cast<long long>(b) * H + h) * Sq + q0, n_rows, tid);

  // The key tiles the forward visited for this query tile.
  int j_end = (Sk + kTile - 1) / kTile;
  if (causal) j_end = min(j_end, (q0 + n_rows - 1) / kTile + 1);
  int j_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) j_begin = (q0 - window + 1) / kTile;

  const int tr = tid / 16, tc = tid % 16;
  const int r_own = tid / kThreadsPerRow;
  const int quarter = tid % kThreadsPerRow;
  float acc[kDPerThread];
#pragma unroll
  for (int e = 0; e < kDPerThread; ++e) acc[e] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/ds_s
    stage<T, D>(k_s, kb, ks, k0, Sk, tid);
    stage<T, D>(v_s, vb, vs, k0, Sk, tid);
    stage_keys(kvalid_s, mb, k0, Sk, tid);
    __syncthreads();

    float s[kMicro][kMicro], dp[kMicro][kMicro];
    scores_and_dp<D>(q_s, k_s, do_s, v_s, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int col = tc + 16 * c;
        const float p = recompute_p(s[i][c], scale, lse_s[r], kvalid_s[col] != 0,
                                    q0 + r, k0 + col, causal, window);
        ds_s[r * kSStride + col] = round_to(p * (dp[i][c] - delta_s[r]), k);
      }
    }
    __syncthreads();

    // dq[r_own] += ds[r_own, :] . k
    const float* dsr = ds_s + r_own * kSStride;
    for (int c = 0; c < kTile; ++c) {
      const float w = dsr[c];
      const float* kc = k_s + c * kStride + quarter;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e)
        acc[e] = fmaf(w, kc[kThreadsPerRow * e], acc[e]);
    }
  }

  if (r_own < n_rows) {
    T* o = dq + ((static_cast<long long>(b) * Sq + q0 + r_own) * H + h) * D + quarter;
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e) store(o + kThreadsPerRow * e, acc[e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int* __restrict__ mask,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dk,
                               T* __restrict__ dv, int Sq, int Sk, int H,
                               Strides qs, Strides ks, Strides vs, Strides dos,
                               int causal, int window, float scale) {
  constexpr int kStride = D + 1;
  constexpr int kDPerThread = D / kThreadsPerRow;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = tile * kTile;
  const int n_keys = min(kTile, Sk - k0);

  extern __shared__ float smem[];
  float* k_s = smem;                               // [kTile][kStride]
  float* v_s = k_s + kTile * kStride;              // [kTile][kStride]
  float* q_s = v_s + kTile * kStride;              // [kTile][kStride]
  float* do_s = q_s + kTile * kStride;             // [kTile][kStride]
  float* p_s = do_s + kTile * kStride;             // [kTile][kSStride]
  float* ds_s = p_s + kTile * kSStride;            // [kTile][kSStride]
  float* lse_s = ds_s + kTile * kSStride;          // [kTile]
  float* delta_s = lse_s + kTile;                  // [kTile]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
  stage<T, D>(k_s, k + b * ks.b + h * ks.h, ks, k0, Sk, tid);
  stage<T, D>(v_s, v + b * vs.b + h * vs.h, vs, k0, Sk, tid);
  stage_keys(kvalid_s, mb, k0, Sk, tid);

  // The query tiles that reach this key tile: under causal from its
  // diagonal down, and with a window only to the band's end.
  const int nq = (Sq + kTile - 1) / kTile;
  int i_begin = 0, i_end = nq;
  if (causal) {
    i_begin = k0 / kTile;
    if (window > 0) i_end = min(nq, (k0 + n_keys - 1 + window - 1) / kTile + 1);
  }

  const int tr = tid / 16, tc = tid % 16;
  const int c_own = tid / kThreadsPerRow;          // this thread's key row
  const int quarter = tid % kThreadsPerRow;
  float dk_acc[kDPerThread], dv_acc[kDPerThread];
#pragma unroll
  for (int e = 0; e < kDPerThread; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  for (int i = i_begin; i < i_end; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // the previous tile's readers are done with q_s/do_s/p_s/ds_s
    stage<T, D>(q_s, qb, qs, q0, Sq, tid);
    stage<T, D>(do_s, dob, dos, q0, Sq, tid);
    stage_rows(lse_s, delta_s, lse, delta, rows + q0, min(kTile, Sq - q0), tid);
    __syncthreads();

    float s[kMicro][kMicro], dp[kMicro][kMicro];
    scores_and_dp<D>(q_s, k_s, do_s, v_s, tr, tc, s, dp);
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int r = tr + 16 * ii;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int col = tc + 16 * c;
        const float p = recompute_p(s[ii][c], scale, lse_s[r], kvalid_s[col] != 0,
                                    q0 + r, k0 + col, causal, window);
        p_s[r * kSStride + col] = round_to(p, dout);
        ds_s[r * kSStride + col] = round_to(p * (dp[ii][c] - delta_s[r]), q);
      }
    }
    __syncthreads();

    // dv[c_own] += p[:, c_own]^T . do;  dk[c_own] += ds[:, c_own]^T . q
    for (int r = 0; r < kTile; ++r) {
      const float pw = p_s[r * kSStride + c_own];
      const float dw = ds_s[r * kSStride + c_own];
      const float* dor = do_s + r * kStride + quarter;
      const float* qr = q_s + r * kStride + quarter;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) {
        dv_acc[e] = fmaf(pw, dor[kThreadsPerRow * e], dv_acc[e]);
        dk_acc[e] = fmaf(dw, qr[kThreadsPerRow * e], dk_acc[e]);
      }
    }
  }

  if (c_own < n_keys) {
    const long long off =
        ((static_cast<long long>(b) * Sk + k0 + c_own) * H + h) * D + quarter;
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e) {
      store(dk + off + kThreadsPerRow * e, dk_acc[e] * scale);
      store(dv + off + kThreadsPerRow * e, dv_acc[e]);
    }
  }
}

// Floats of dynamic shared memory: four staged 64 x (D + 1) tiles, `n_score`
// 64 x 65 tiles, and three 64-vectors (lse, delta, key validity).
constexpr size_t smem_bytes(int D, int n_score) {
  return sizeof(float) * (4 * kTile * (D + 1) + n_score * kTile * kSStride + 3 * kTile);
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *g0, *g1;  // dq; or dk, dv
  int B, Sq, Sk, H;
  Strides qs, ks, vs, dos;
  int causal, window;
  float scale;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  const size_t smem = smem_bytes(D, 1);
  auto kernel = flash_attention_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs, a.dos, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.H, a.B);
  const size_t smem = smem_bytes(D, 2);
  auto kernel = flash_attention_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.Sq, a.Sk, a.H, a.qs, a.ks,
      a.vs, a.dos, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16:  return kDq ? launch_dq<T, 16>(a, stream) : launch_dkv<T, 16>(a, stream);
    case 32:  return kDq ? launch_dq<T, 32>(a, stream) : launch_dkv<T, 32>(a, stream);
    case 64:  return kDq ? launch_dq<T, 64>(a, stream) : launch_dkv<T, 64>(a, stream);
    case 128: return kDq ? launch_dq<T, 128>(a, stream) : launch_dkv<T, 128>(a, stream);
    default:  return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535 ||
      a.window < 0 || (a.window > 0 && !a.causal))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, kDq>(a, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kDq>(a, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients alike).
// window: 0 = no sliding window, else >= 1 (causal only). mask may be null.
// Strides are the (b, s, h) element strides of q, k, v and do. Each returns
// the launch's cudaError_t (0 = success); the caller checks it, since a
// refused launch never runs.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* lse, const void* delta,
                           void* dq, int B, int Sq, int Sk, int H, int D,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long do_sb, long long do_ss, long long do_sh,
                           int causal, int window, float scale, int dtype, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dq, nullptr, B, Sq, Sk, H,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {do_sb, do_ss, do_sh}, causal, window, scale};
  return dispatch<true>(a, D, dtype, stream);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                            const void* dout, const void* lse, const void* delta,
                            void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            int causal, int window, float scale, int dtype, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dk, dv, B, Sq, Sk, H,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {do_sb, do_ss, do_sh}, causal, window, scale};
  return dispatch<false>(a, D, dtype, stream);
}

}  // extern "C"
