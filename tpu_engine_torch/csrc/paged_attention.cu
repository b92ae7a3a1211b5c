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
//   c % bs. Query head h * G + g (G = H / H_kv) reads kv head h. Rounding
//   points are the TPU kernels': the score is f32 q times the pool's K summed
//   in f32 and scaled by 1/sqrt(D); the softmax is in f32; over a bf16 pool
//   the weights are rounded to bf16 before the product with V, which sums in
//   f32; the denominator sums the unrounded weights; l == 0 gives 0. With the
//   int8 pool the K scales multiply the score columns and the V scales fold
//   into the softmax weights: s = (q . Kq_c) * (ks_c / sqrt(D)),
//   acc += (p_c * vs_c) Vq_c, l += p_c; the dequantized block never exists
//   in device memory.
//
// What bounds it on an H100: device-memory bytes and their latency. A (row,
// kv-head) pair reads the K and V of its pos + 1 columns once: 2 * D bytes
// per column in bf16 (plus 8 bytes of scales per column in int8, at D bytes
// each for K and V), at 3.35 TB/s; the arithmetic is 4 * D flops per (query
// head, column), about 8 flops per byte, far below the card's ~295.
//
// `paged_attention` (f32 and bf16 pools): a split read (flash-decoding).
// - Each row's range [0, pos + 1) is cut into splits of `split` keys, one
//   thread block per (split, kv head, row), so that the eight rows x four kv
//   heads of a decode step become a few hundred thread blocks on 132 SMs. A
//   row that takes one split writes its output directly; otherwise each
//   split writes its partial (base-2 maximum and sum per query head,
//   unnormalised f32 output) to scratch the caller allocates and a second
//   kernel merges them in split order by log-sum-exp: no atomics, two runs
//   give the same bits, and a row's split count and arithmetic depend on its
//   own pos only, so its output is the same alone and in any batch.
// - A thread block reads the K and V of its split once for all G query heads
//   of its kv head: it stages its slice of the block table, then issues
//   every 16-byte cp.async copy of the split at once (q, the K rows as one
//   group, the V rows as a second), so the bytes of a whole split are in
//   flight together and the scores are taken while V arrives.
// - CUDA-core f32 products (the bytes bound it, not the arithmetic), 256
//   threads: a thread takes the scores of one key for four query heads (its
//   K row read in 16-byte pieces, q broadcast from shared memory); the
//   scores of the split stay in shared memory, so the softmax is exact
//   within the split (one warp per query head); the weights, rounded to the
//   pool's dtype, multiply V with each output pair summed over the split by
//   one thread. No accumulator is held across tiles: G * D is bounded only
//   by shared memory.
// - Splits of 64 keys (the wrapper's DECODE_SPLIT_KEYS): a thread block's
//   time is mostly latency (the table, then K and V, then the partial), so
//   shorter splits, more of them in flight, finish sooner; the merge gives
//   each output its own thread, which keeps its cost low at 32 splits.
//
// `quant_paged_attention` (int8 pool): one thread block per (kv head, row)
// walks the row's columns in 64-column tiles staged as f32 in shared memory;
// scores through shared memory, one warp per query row for the softmax, the
// G * D accumulators spread over 128 threads (G * D <= 2048). A split, a
// cp.async ring and vectorised loads are its later work.

#include "mma_common.cuh"

#include <type_traits>

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

// ---- paged_attention: the split read (f32 and bf16 pools) ----------------------

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kHeadChunk = 4;  // query heads one pass over a K row scores
constexpr int kMergeThreads = 512;  // one merge thread per output of G * D <= 512
constexpr size_t kMaxSmem = 232448;

struct DecodeArgs {
  const float* q;
  const void *k_pool, *v_pool;
  const int *tables, *pos;
  void* out;
  float *part_acc, *part_ml;  // [B][H_kv][n_split][G][D], [B][H_kv][n_split][G][2]
  int H, H_kv, G, bs, nb, split, n_split;
  float scale2;  // log2(e) / sqrt(D): scores in base 2
};

template <typename T, int D>
struct DecodeCfg {
  static constexpr int kPer = 16 / sizeof(T);           // elements per 16-byte copy
  static constexpr int kChunks = D / kPer;              // copies per K or V row
  static constexpr int kRowBytes = D * sizeof(T) + 16;  // a staged row, padded 16 bytes
};

// Shared memory of one split: its K and V rows, q ([G][D] f32), the scores
// ([G][split] f32), each head's (maximum, sum) and the split's slice of the
// block table (at most split + 1 entries).
template <typename T, int D>
size_t decode_smem(int G, int split) {
  return 2 * static_cast<size_t>(split) * DecodeCfg<T, D>::kRowBytes +
         sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(G) * split + 2 * G) +
         sizeof(int) * (static_cast<size_t>(split) + 1);
}

// The row's valid keys: columns kpos < pos + 1 that the table holds.
__device__ __forceinline__ int decode_len(const DecodeArgs& a, int b) {
  return max(0, min(a.pos[b] + 1, a.nb * a.bs));
}

// 16 staged bytes of a K row as f32.
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}

// Two neighbouring staged V values as f32.
template <typename T>
__device__ __forceinline__ float2 load2(const unsigned char* p) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else
    return *reinterpret_cast<const float2*>(p);
}

// p as the product with V takes it: rounded to the pool's dtype.
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16(p));
  else
    return p;
}

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(DecodeArgs a) {
  using C = DecodeCfg<T, D>;
  constexpr int kPer = C::kPer, RB = C::kRowBytes;
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.G;
  const int len = decode_len(a, b);
  const int nsplit = (len + a.split - 1) / a.split;
  const long long qo = (static_cast<long long>(b) * a.H + kvh * G) * D;
  T* out = static_cast<T*>(a.out) + qo;
  if (split >= nsplit) {
    if (split == 0)  // no valid key: 0, as the TPU kernel's l == 0
      for (int i = tid; i < G * D; i += kSplitThreads) store(out + i, 0.f);
    return;
  }
  const int k0 = split * a.split, n = min(a.split, len - k0);
  unsigned char* k_s = split_smem;                            // [split][RB]
  unsigned char* v_s = k_s + a.split * RB;                    // [split][RB]
  float* q_s = reinterpret_cast<float*>(v_s + a.split * RB);  // [G][D]
  float* s_s = q_s + G * D;                                   // [G][split] scores, weights
  float* ml_s = s_s + G * a.split;                            // [G][2] maximum, sum
  int* tbl_s = reinterpret_cast<int*>(ml_s + 2 * G);           // the split's table slice

  // q first; the split's slice of the block table, then every K row of the
  // split as one group of copies and every V row as a second, so that the
  // scores are taken while V is still arriving.
  for (int i = tid; i < G * D / 4; i += kSplitThreads)
    cp_async16(q_s + 4 * i, a.q + qo + 4 * i, true);
  const int first = k0 / a.bs;
  const int* row_table = a.tables + static_cast<long long>(b) * a.nb + first;
  for (int i = tid; i <= (k0 + n - 1) / a.bs - first; i += kSplitThreads) tbl_s[i] = row_table[i];
  __syncthreads();
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? kp : vp;
    unsigned char* dst = pass == 0 ? k_s : v_s;
    for (int i = tid; i < n * C::kChunks; i += kSplitThreads) {
      const int c = i / C::kChunks, j = i % C::kChunks;
      const int kpos = k0 + c;
      const long long blk = tbl_s[kpos / a.bs - first];
      const long long off = ((blk * a.bs + kpos % a.bs) * a.H_kv + kvh) * D + j * kPer;
      cp_async16(dst + c * RB + j * 16, src + off, true);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();  // q and K have arrived
  __syncthreads();

  // Scores: one work item per (key, chunk of kHeadChunk query heads), its
  // K row read in 16-byte pieces, q broadcast.
  const int n_chunks = (G + kHeadChunk - 1) / kHeadChunk;
  for (int w = tid; w < n * n_chunks; w += kSplitThreads) {
    const int c = w % n, g0 = w / n * kHeadChunk;
    const unsigned char* kr = k_s + c * RB;
    float dot[kHeadChunk];
#pragma unroll
    for (int h = 0; h < kHeadChunk; ++h) dot[h] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kChunks; ++j) {
      float kf[kPer];
      unpack16(kr + j * 16, kf);
#pragma unroll
      for (int h = 0; h < kHeadChunk; ++h) {
        if (g0 + h < G) {
          const float4* q4 = reinterpret_cast<const float4*>(q_s + (g0 + h) * D + j * kPer);
#pragma unroll
          for (int e = 0; e < kPer / 4; ++e) {
            const float4 qv = q4[e];
            dot[h] = fmaf(qv.x, kf[4 * e], dot[h]);
            dot[h] = fmaf(qv.y, kf[4 * e + 1], dot[h]);
            dot[h] = fmaf(qv.z, kf[4 * e + 2], dot[h]);
            dot[h] = fmaf(qv.w, kf[4 * e + 3], dot[h]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kHeadChunk; ++h)
      if (g0 + h < G) s_s[(g0 + h) * a.split + c] = dot[h] * a.scale2;
  }
  __syncthreads();

  // The softmax of the split, one warp per query head; the weights replace
  // the scores, rounded to the pool's dtype, the sum taken unrounded.
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += kSplitWarps) {
    float* sr = s_s + g * a.split;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = exp2f(sr[c] - m_use);
      sum += p;
      sr[c] = round_to<T>(p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml_s[2 * g] = mx;
      ml_s[2 * g + 1] = sum;
    }
  }
  cp_async_wait<0>();  // V has arrived
  __syncthreads();

  // P V: each thread sums output pairs (head g, columns d, d + 1) over the split.
  const bool single = nsplit == 1;
  const long long pbase = ((static_cast<long long>(b) * a.H_kv + kvh) * a.n_split + split) * G;
  for (int i = tid; i < G * D / 2; i += kSplitThreads) {
    const int g = 2 * i / D, d = 2 * i % D;
    const float* pr = s_s + g * a.split;
    const unsigned char* vc = v_s + d * sizeof(T);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float2 v = load2<T>(vc + c * RB);
      a0 = fmaf(pr[c], v.x, a0);
      a1 = fmaf(pr[c], v.y, a1);
    }
    if (single) {
      const float l = ml_s[2 * g + 1];
      const float den = l == 0.f ? 1.f : l;
      store(out + g * D + d, a0 / den);
      store(out + g * D + d + 1, a1 / den);
    } else {
      float* acc = a.part_acc + (pbase + g) * D + d;
      acc[0] = a0;
      acc[1] = a1;
    }
  }
  if (!single)
    for (int g = tid; g < G; g += kSplitThreads) {
      a.part_ml[2 * (pbase + g)] = ml_s[2 * g];
      a.part_ml[2 * (pbase + g) + 1] = ml_s[2 * g + 1];
    }
}

// Merges the partials of every (row, kv head) that took more than one
// split, in split order: out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s,
// one thread per output (the loads of a thread's splits are its latency).
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(DecodeArgs a) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = a.G;
  const int ns = (decode_len(a, b) + a.split - 1) / a.split;
  if (ns <= 1) return;
  const long long base = (static_cast<long long>(b) * a.H_kv + kvh) * a.n_split;
  T* out = static_cast<T*>(a.out) + (static_cast<long long>(b) * a.H + kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kMergeThreads) {
    const int g = i / D;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, a.part_ml[2 * ((base + s) * G + g)]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const long long pr = (base + s) * G + g;
      const float w = exp2f(a.part_ml[2 * pr] - m_use);
      den = fmaf(w, a.part_ml[2 * pr + 1], den);
      num = fmaf(w, a.part_acc[pr * D + i % D], num);
    }
    store(out + i, den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_split(const DecodeArgs& a, int B, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, D>;
  const size_t smem = decode_smem<T, D>(a.G, a.split);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_split, a.H_kv, B), kSplitThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 1) return err;
  paged_merge_kernel<T, D><<<dim3(a.H_kv, B), kMergeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_split(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8:   return launch_split<T, 8>(a, B, stream);
    case 16:  return launch_split<T, 16>(a, B, stream);
    case 32:  return launch_split<T, 32>(a, B, stream);
    case 64:  return launch_split<T, 64>(a, B, stream);
    case 128: return launch_split<T, 128>(a, B, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kv_dtype: 0 = float32, 1 = bfloat16 (the output takes the pool's dtype).
// `split`: keys per split (any length; a split's K and V rows, q and scores
// must fit a thread block's shared memory); n_split = ceil(nb * bs / split).
// part_acc (B, H_kv, n_split, G, D) and part_ml (..., 2) f32 are the
// scratch of the partials, null when n_split is 1. q and the pools 16-byte
// aligned. Returns the launches' cudaError_t (0 = success).
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* pos, void* out, void* part_acc,
                    void* part_ml, int B, int H, int H_kv, int D, int bs, int nb, int split,
                    int kv_dtype, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0 || B > 65535 ||
      H_kv > 65535 || split <= 0)
    return cudaErrorInvalidValue;
  const int n_split = (nb * bs + split - 1) / split;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  for (const void* p : {q, k_pool, v_pool})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const float*>(q), k_pool, v_pool,
                     static_cast<const int*>(tables), static_cast<const int*>(pos), out,
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, H_kv,
                     H / H_kv, bs, nb, split, n_split,
                     kLog2e / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) return dispatch_split<float>(a, B, D, s);
  if (kv_dtype == 1) return dispatch_split<bf16>(a, B, D, s);
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
