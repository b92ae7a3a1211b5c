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
//   int8 pool the K scales multiply the score columns after the product and
//   the V scales fold into the softmax weights, unrounded:
//   s = (q . Kq_c) * (ks_c / sqrt(D)), acc += (p_c * vs_c) Vq_c, l += p_c;
//   the dequantized block never exists in device memory.
//
// What bounds it on an H100: device-memory bytes and their latency. A (row,
// kv-head) pair reads the K and V of its pos + 1 columns once: 2 * D bytes
// per column in bf16, 2 * (D + 4) in int8 (D int8 values and one f32 scale
// for each of K and V), at 3.35 TB/s; the arithmetic is 4 * D flops per
// (query head, column), a few flops per byte, far below the card's ~295.
//
// Both entry points run one split read (flash-decoding) and one merge,
// templated on the pool's element type (f32, bf16, int8):
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
//   every cp.async copy of the split at once (q; the K rows and, over the
//   int8 pool, both scale vectors as one group; the V rows as a second), so
//   the bytes of a whole split are in flight together and the scores are
//   taken while V arrives. A row is copied 16 bytes at a time (8 for the
//   8-byte int8 rows of D 8); a key's scales lie H_kv floats apart in
//   (NB, bs, H_kv), so they come by 4-byte copies.
// - CUDA-core f32 products (the bytes bound it, not the arithmetic), 256
//   threads: a thread takes the scores of one key for four query heads (its
//   K row read in 16-byte pieces and converted to f32, exactly for int8, q
//   broadcast from shared memory); the scores of the split stay in shared
//   memory, so the softmax is exact within the split (one warp per query
//   head); the weights (rounded to bf16 over a bf16 pool, times the V scale
//   over the int8 pool) multiply V with each output pair summed over the
//   split by one thread. No accumulator is held across tiles: G * D is
//   bounded only by shared memory.
// - Splits of 64 keys over every pool (the wrapper's DECODE_SPLIT_KEYS): a
//   thread block's time is mostly latency (the table, then K and V, then
//   the partial), so shorter splits, more of them in flight, finish sooner,
//   over the int8 pool too, whose split carries half the bytes; the merge
//   gives each output its own thread, which keeps its cost low at 32
//   splits.

#include "mma_common.cuh"

#include <type_traits>

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kHeadChunk = 4;  // query heads one pass over a K row scores
constexpr int kMergeThreads = 512;  // one merge thread per output of G * D <= 512
constexpr size_t kMaxSmem = 232448;

struct DecodeArgs {
  const float* q;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale;  // (NB, bs, H_kv): the int8 pool only
  const int *tables, *pos;
  void* out;
  float *part_acc, *part_ml;  // [B][H_kv][n_split][G][D], [B][H_kv][n_split][G][2]
  int H, H_kv, G, bs, nb, split, n_split;
  float scale2;  // log2(e) / sqrt(D): scores in base 2
};

template <typename T, int D>
struct DecodeCfg {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int kRowBytes = D * sizeof(T);               // one K or V row
  static constexpr int kCopy = kRowBytes < 16 ? kRowBytes : 16;  // bytes per copy
  static constexpr int kPer = kCopy / sizeof(T);                // elements per copy
  static constexpr int kChunks = kRowBytes / kCopy;             // copies per row
  static constexpr int kStride = kRowBytes + 16;                // a staged row, padded
};

// Bytes of a split's staged K (or V) rows, rounded up to 16 (the 24-byte
// rows of an int8 pool at D 8 over an odd split).
template <typename T, int D>
__host__ __device__ __forceinline__ int rows_bytes(int split) {
  return (split * DecodeCfg<T, D>::kStride + 15) & ~15;
}

// Shared memory of one split: its K and V rows, q ([G][D] f32), the scores
// ([G][split] f32), each head's (maximum, sum), over the int8 pool the K and
// V scales of its keys, and the split's slice of the block table (at most
// split + 1 entries).
template <typename T, int D>
size_t decode_smem(int G, int split) {
  using C = DecodeCfg<T, D>;
  return 2 * static_cast<size_t>(rows_bytes<T, D>(split)) +
         sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(G) * split + 2 * G) +
         (C::kQuant ? 2 * sizeof(float) * split : 0) +
         sizeof(int) * (static_cast<size_t>(split) + 1);
}

// The row's valid keys: columns kpos < pos + 1 that the table holds.
__device__ __forceinline__ int decode_len(const DecodeArgs& a, int b) {
  return max(0, min(a.pos[b] + 1, a.nb * a.bs));
}

// One copy's staged bytes of a K row as f32 (int8 -> f32 is exact).
template <typename T, int N>
__device__ __forceinline__ void unpack(const unsigned char* p, float (&f)[N]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    using V = typename std::conditional<N == 16, int4, int2>::type;  // 16 or 8 bytes
    const V u = *reinterpret_cast<const V*>(p);
    const int8_t* x = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = static_cast<float>(x[e]);
  } else if constexpr (std::is_same<T, bf16>::value) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      f[2 * j] = x.x;
      f[2 * j + 1] = x.y;
    }
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  }
}

// Two neighbouring staged V values as f32.
template <typename T>
__device__ __forceinline__ float2 load2(const unsigned char* p) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const char2 x = *reinterpret_cast<const char2*>(p);
    return make_float2(x.x, x.y);
  } else if constexpr (std::is_same<T, bf16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

// Key c's weight as the product with V takes it: p rounded to the pool's
// dtype, or over the int8 pool p times the key's V scale, in f32.
template <typename T>
__device__ __forceinline__ float weight(float p, const float* vs_s, int c) {
  if constexpr (std::is_same<T, int8_t>::value)
    return p * vs_s[c];
  else if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16(p));
  else
    return p;
}

// One row's bytes (16 or 8) global -> shared.
template <int N>
__device__ __forceinline__ void cp_async_row(void* smem, const void* gmem) {
  if constexpr (N == 16)
    cp_async16(smem, gmem, true);
  else
    cp_async8(smem, gmem, true);
}

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(DecodeArgs a) {
  using C = DecodeCfg<T, D>;
  using Out = OutOf<T>;
  constexpr int kPer = C::kPer, RS = C::kStride;
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.G;
  const int len = decode_len(a, b);
  const int nsplit = (len + a.split - 1) / a.split;
  const long long qo = (static_cast<long long>(b) * a.H + kvh * G) * D;
  Out* out = static_cast<Out*>(a.out) + qo;
  if (split >= nsplit) {
    if (split == 0)  // no valid key: 0, as the TPU kernel's l == 0
      for (int i = tid; i < G * D; i += kSplitThreads) store(out + i, 0.f);
    return;
  }
  const int k0 = split * a.split, n = min(a.split, len - k0);
  const int rows = rows_bytes<T, D>(a.split);
  unsigned char* k_s = split_smem;                       // [split][RS]
  unsigned char* v_s = k_s + rows;                       // [split][RS]
  float* q_s = reinterpret_cast<float*>(v_s + rows);     // [G][D]
  float* s_s = q_s + G * D;                              // [G][split] scores, weights
  float* ml_s = s_s + G * a.split;                       // [G][2] maximum, sum
  float* ks_s = ml_s + 2 * G;                            // [split] K scales (int8 pool)
  float* vs_s = ks_s + a.split;                          // [split] V scales
  int* tbl_s = reinterpret_cast<int*>(C::kQuant ? vs_s + a.split : ks_s);  // table slice

  // q first; the split's slice of the block table, then every K row of the
  // split (with the scales) as one group of copies and every V row as a
  // second, so that the scores are taken while V is still arriving.
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
      cp_async_row<C::kCopy>(dst + c * RS + j * C::kCopy, src + off);
    }
    if (C::kQuant && pass == 0)
      for (int c = tid; c < n; c += kSplitThreads) {
        const int kpos = k0 + c;
        const long long blk = tbl_s[kpos / a.bs - first];
        const long long at = (blk * a.bs + kpos % a.bs) * a.H_kv + kvh;
        cp_async4(ks_s + c, a.k_scale + at, true);
        cp_async4(vs_s + c, a.v_scale + at, true);
      }
    cp_async_commit();
  }
  cp_async_wait<1>();  // q, K and the scales have arrived
  __syncthreads();

  // Scores: one work item per (key, chunk of kHeadChunk query heads), its
  // K row read in 16-byte pieces, q broadcast; over the int8 pool the K
  // scale multiplies the sum.
  const int n_chunks = (G + kHeadChunk - 1) / kHeadChunk;
  for (int w = tid; w < n * n_chunks; w += kSplitThreads) {
    const int c = w % n, g0 = w / n * kHeadChunk;
    const unsigned char* kr = k_s + c * RS;
    float dot[kHeadChunk];
#pragma unroll
    for (int h = 0; h < kHeadChunk; ++h) dot[h] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kChunks; ++j) {
      float kf[kPer];
      unpack<T>(kr + j * C::kCopy, kf);
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
    const float sc = C::kQuant ? ks_s[c] * a.scale2 : a.scale2;
#pragma unroll
    for (int h = 0; h < kHeadChunk; ++h)
      if (g0 + h < G) s_s[(g0 + h) * a.split + c] = dot[h] * sc;
  }
  __syncthreads();

  // The softmax of the split, one warp per query head; the weights
  // (`weight`) replace the scores, the sum taken over the plain weights.
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
      sr[c] = weight<T>(p, vs_s, c);
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
      const float2 v = load2<T>(vc + c * RS);
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
  OutOf<T>* out = static_cast<OutOf<T>*>(a.out) + (static_cast<long long>(b) * a.H + kvh * G) * D;
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

// The checks and the launch both entry points share. kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (with its scales).
cudaError_t decode(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* tables, const void* pos, void* out,
                   void* part_acc, void* part_ml, int B, int H, int H_kv, int D, int bs, int nb,
                   int split, int kv_dtype, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0 || B > 65535 ||
      H_kv > 65535 || split <= 0)
    return cudaErrorInvalidValue;
  const int n_split = (nb * bs + split - 1) / split;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  for (const void* p : {q, k_pool, v_pool})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  if (kv_dtype == 2)
    for (const void* p : {k_scale, v_scale})
      if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 4 != 0) return cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const float*>(q), k_pool, v_pool,
                     static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables), static_cast<const int*>(pos), out,
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, H_kv,
                     H / H_kv, bs, nb, split, n_split,
                     kLog2e / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) return dispatch_split<float>(a, B, D, s);
  if (kv_dtype == 1) return dispatch_split<bf16>(a, B, D, s);
  if (kv_dtype == 2) return dispatch_split<int8_t>(a, B, D, s);
  return cudaErrorInvalidValue;
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
  if (kv_dtype != 0 && kv_dtype != 1) return cudaErrorInvalidValue;
  return decode(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, part_acc, part_ml, B, H,
                H_kv, D, bs, nb, split, kv_dtype, stream);
}

// The same over the int8 pool with its f32 scales (NB, bs, H_kv); the
// output is f32. Split and scratch as for paged_attention (the split's
// shared memory also holds its keys' scales).
int quant_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale, const void* tables,
                          const void* pos, void* out, void* part_acc, void* part_ml, int B,
                          int H, int H_kv, int D, int bs, int nb, int split, void* stream) {
  return decode(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part_acc, part_ml, B, H,
                H_kv, D, bs, nb, split, 2, stream);
}

}  // extern "C"
