// Ragged paged attention for Hopper (sm_90a), hand-written CUDA C++: a
// split read over the block pool (bf16 on the tensor cores, or f32 on the
// CUDA cores) and a merge pass.
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
//   kernel writes zeros there). A row with no valid key gives 0.
//
// Rounding points are the TPU kernel's: scores are f32 q times the pool's K
// summed in f32 and scaled by 1/sqrt(D); the softmax runs in f32; the
// weights are rounded to the pool's dtype before the weighted sum of V,
// which is accumulated in f32; the denominator sums the unrounded weights.
//
// What bounds it on an H100: at decode widths, device-memory bytes and
// latency. Every (row, kv-head) pair must read the K and V blocks of its
// history once (2 KB each per 16-token bf16 block at D 64), and the
// arithmetic is 4 * D flops per (query row, key); a grid of one thread
// block per (row, kv head) would fill 32 of the 132 SMs and walk each
// history in sequence, latency-bound.
// A 256-token prefill chunk does ~4 GFLOP over its 1,700-token history:
// there the products bound it.
//
// Design, for this card (the TPU blocks are not carried over):
// - Query rows: row r of a (row, kv head) is query slot r / G, group head
//   r % G, as in the TPU kernel; a thread block owns a tile of 64 of them.
// - Splits (flash-decoding). A tile's causal key range [0, kend), kend =
//   pos0 + its last valid slot + 1, is cut into splits of `split` keys (a
//   multiple of the block size, chosen by the caller), one thread block
//   each: grid (tile x split, kv head, row). A tile whose range needs one
//   split writes its output directly; otherwise each split writes its
//   partial (running maximum, sum, unnormalised f32 output) to scratch the
//   caller allocates, and a second pass merges the partials in split order
//   by log-sum-exp. No atomics: two runs give bit-identical output. A
//   tile's split count depends only on its own row's pos0 and qlen, and
//   the arithmetic of a row only on its own data, so a row's output is
//   bit-identical whatever rows share the batch.
// - A split stages its slice of the row's block table in shared memory
//   once; K and V are gathered through it 64 keys at a time (four 16-token
//   blocks) by 16-byte cp.async copies, zero-filled past the split's end.
// - bf16 pool, D >= 16 (every width: choosing by the batch's width W * G
//   would tie a decode row's numbers to the batch): mma.sync m16n8k16
//   bf16 -> f32. q is f32 and the pool bf16; the TPU kernel's f32 x bf16
//   product is kept by splitting q into bf16 terms hi + mid + lo (each the
//   bf16 rounding of what the terms before it leave), whose three products
//   with the exact bf16 K sum in the f32 accumulators: q's 24-bit
//   significand is carried whole. 4 warps own 16 query rows each; a warp
//   whose rows are all padding only helps stage. The K/V tiles are
//   double-buffered (rows padded 16 bytes), K enters through ldmatrix and V
//   through ldmatrix.trans; S stays in the accumulators, the row statistics
//   reduce over a row's four lanes by shuffles, and p is rounded to bf16
//   and repacked in registers as the A operand of O += P V.
// - f32 pool, and D 8 (below the k16 depth): CUDA-core f32 products over
//   the same splits, tiles staged as f32.
//
// Left to later work: wgmma/TMA tiles, a persistent schedule, grouped K/V
// shared by a row's G query heads in one pass of the decode path, and the
// split-q products' cost (three bf16 products for one f32 one).
//
// The split plan, arguments, offsets, the CUDA-core body, the merge and
// the launch live in ragged_common.cuh, shared with the int8 read.
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "ragged_common.cuh"

namespace {

// ---- bf16 pool: tensor cores --------------------------------------------------

template <int D>
struct MmaCfg {
  static constexpr int kStride = D + 8;  // bf16 elements per staged row
  static constexpr int kKD = D / 16;     // k16 steps over D
  static constexpr int kND = D / 8;      // n8 tiles over D
  static constexpr int kNB = kBN / 8;    // n8 tiles over the key tile
  static constexpr int kKB = kBN / 16;   // k16 steps over the key tile
  static constexpr size_t kSmem =
      (3 * kRows + 4 * kBN) * kStride * sizeof(bf16) + kMaxTable * sizeof(int);
};

// Keys [k0, k0 + kBN) of K and V into k_t, v_t through the staged table;
// keys at or past kstop are zeros.
template <int D>
__device__ __forceinline__ void stage_kv_mma(bf16* k_t, bf16* v_t, const Args& a,
                                             const Block& k, const int* tbl_s, int k0,
                                             int tid) {
  constexpr int ST = MmaCfg<D>::kStride, kChunks = D / 8;
  const bf16* kp = static_cast<const bf16*>(a.k_pool);
  const bf16* vp = static_cast<const bf16*>(a.v_pool);
#pragma unroll
  for (int i = 0; i < kBN * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int kpos = k0 + r;
    const bool in = kpos < k.kstop;
    const long long off = in ? key_offset<D>(a, k, tbl_s, kpos) + c * 8 : 0;
    cp_async16(k_t + r * ST + c * 8, kp + off, in);
    cp_async16(v_t + r * ST + c * 8, vp + off, in);
  }
}

template <int D>
__device__ __forceinline__ void split_mma(const Args& a, const Block& k, unsigned char* smem) {
  using C = MmaCfg<D>;
  constexpr int ST = C::kStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_valid = k.plan.n_valid;

  bf16* q3_s = reinterpret_cast<bf16*>(smem);   // hi, mid, lo: [3][kRows][ST]
  bf16* k_s = q3_s + 3 * kRows * ST;            // [2][kBN][ST]
  bf16* v_s = k_s + 2 * kBN * ST;               // [2][kBN][ST]
  int* tbl_s = reinterpret_cast<int*>(v_s + 2 * kBN * ST);

  stage_table(tbl_s, a, k, tid);
  stage_q_terms<D, ST>(q3_s, a, k, tid);
  __syncthreads();  // the table is staged

  const int n_tiles = (k.kstop - k.kbeg + kBN - 1) / kBN;
  stage_kv_mma<D>(k_s, v_s, a, k, tbl_s, k.kbeg, tid);
  cp_async_commit();

  const int row0w = warp * 16;
  const bool live = row0w < n_valid;           // a warp of padding rows only stages
  const int qpos[2] = {k.p0 + (k.row0 + row0w + g) / k.G,
                       k.p0 + (k.row0 + row0w + g + 8) / k.G};
  const int qpos_first = k.p0 + k.row0 / k.G;  // the tile's first row
  const float scale2 = a.scale * kLog2e;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns
  float acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = k.kbeg + it * kBN;
    if (it + 1 < n_tiles)  // the next key tile loads while this one multiplies
      stage_kv_mma<D>(k_s + (buf ^ 1) * kBN * ST, v_s + (buf ^ 1) * kBN * ST, a, k, tbl_s,
                      k0 + kBN, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const bf16* kt_s = k_s + buf * kBN * ST;
      const bf16* vt_s = v_s + buf * kBN * ST;

      // S = (q_lo + q_mid + q_hi) K^T, smallest term first, in base 2.
      float s[C::kNB][4];
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKD; ++kk) {
        unsigned qf[3][4];
#pragma unroll
        for (int term = 0; term < 3; ++term)
          ldsm_x4(qf[term], frag_a<ST>(q3_s + term * kRows * ST, row0w, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < C::kNB / 2; ++np) {
          unsigned bk[4];
          ldsm_x4(bk, frag_bt<ST>(kt_s, np * 16, kk * 16, lane));
#pragma unroll
          for (int term = 2; term >= 0; --term) {
            mma_16816(s[2 * np], qf[term], bk[0], bk[1]);
            mma_16816(s[2 * np + 1], qf[term], bk[2], bk[3]);
          }
        }
      }
      if (k0 + kBN <= k.kstop && k0 + kBN - 1 <= qpos_first) {
#pragma unroll
        for (int n = 0; n < C::kNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
      } else {
#pragma unroll
        for (int n = 0; n < C::kNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const bool keep = kpos < k.kstop && kpos <= qpos[e >> 1];
            s[n][e] = keep ? s[n][e] * scale2 : -INFINITY;
          }
      }

      // Online softmax of the two rows (g, g + 8) this lane holds.
      Rescale rs[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < C::kNB; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * hi], s[n][2 * hi + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        rs[hi] = rescale(m[hi], mt);
      }
      // p, its sums unrounded, its bf16 rounding repacked as A fragments.
      unsigned p_f[C::kKB][4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < C::kNB; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[n][e] - rs[e >> 1].m_use);
          ps[e >> 1] += p[e];
        }
        p_f[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        p_f[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) l[hi] = l[hi] * rs[hi].corr + ps[hi];
#pragma unroll
      for (int n = 0; n < C::kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= rs[e >> 1].corr;

      // O += P V, V as the B operand through ldmatrix.trans.
#pragma unroll
      for (int kb = 0; kb < C::kKB; ++kb)
#pragma unroll
        for (int dp = 0; dp < C::kND / 2; ++dp) {
          unsigned bv[4];
          ldsm_x4_trans(bv, frag_a<ST>(vt_s, kb * 16, dp * 16, lane));
          mma_16816(acc[2 * dp], p_f[kb], bv[0], bv[1]);
          mma_16816(acc[2 * dp + 1], p_f[kb], bv[2], bv[3]);
        }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (!live) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    const int r = row0w + g + 8 * hi;
    if (r >= n_valid) continue;
#pragma unroll
    for (int n = 0; n < C::kND; ++n)
      emit<bf16, D>(a, k, r, n * 8 + 2 * t, acc[n][2 * hi], acc[n][2 * hi + 1], m[hi], l[hi],
                    t == 0 && n == 0);
  }
}

// ---- the kernels -----------------------------------------------------------------

template <typename KV, int D>
__host__ __device__ constexpr bool use_mma() {
  return std::is_same<KV, bf16>::value && D >= 16;
}

template <typename KV, int D>
constexpr size_t smem_bytes() {
  if constexpr (use_mma<KV, D>())
    return MmaCfg<D>::kSmem;
  else
    return SimtCfg<KV, D>::kSmem;
}
static_assert(smem_bytes<float, 128>() <= 232448 && smem_bytes<bf16, 128>() <= 232448,
              "D 128 tiles fit a thread block's shared memory");

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / a.n_split, split = blockIdx.x % a.n_split;
  const Block k = block_of(a, tile, split, blockIdx.y, blockIdx.z);
  if (split == 0) zero_padding<KV, D>(a, k);
  if (split >= k.plan.nsplit) return;
  if constexpr (use_mma<KV, D>())
    split_mma<D>(a, k, smem);
  else
    split_simt<KV, D>(a, k, smem);
}

template <typename KV, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  return launch_split_merge<KV, D>(ragged_split_kernel<KV, D>, smem_bytes<KV, D>(), a, B, stream);
}

template <typename KV>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8:   return launch<KV, 8>(a, B, stream);
    case 16:  return launch<KV, 16>(a, B, stream);
    case 32:  return launch<KV, 32>(a, B, stream);
    case 64:  return launch<KV, 64>(a, B, stream);
    case 128: return launch<KV, 128>(a, B, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kv_dtype: 0 = float32, 1 = bfloat16. `split`: keys per split, a multiple
// of bs and at most 512 table entries; n_split = ceil(nb * bs / split).
// part_acc (B, H_kv, n_split, rows_pad, D) and part_ml (..., 2) f32 are
// the scratch of the partials (rows_pad = W * G rounded up to 64); null
// when n_split is 1. Every pointer 16-byte aligned. Returns the launches'
// cudaError_t (0 = success); the caller checks it, since a refused launch
// never runs.
int ragged_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                           const void* tables, const void* pos0, const void* qlen,
                           void* out, void* part_acc, void* part_ml, int B, int W, int H,
                           int H_kv, int D, int bs, int nb, int split, int kv_dtype,
                           void* stream) {
  Args a;
  if (!make_args(&a, q, k_pool, v_pool, nullptr, nullptr, tables, pos0, qlen, out, part_acc,
                 part_ml, B, W, H, H_kv, D, bs, nb, split))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (kv_dtype == 1) return dispatch_d<bf16>(a, B, D, s);
  return cudaErrorInvalidValue;
}

// The library's one error-string entry point (every kernel of it returns a
// cudaError_t); it lives here because a symbol may be defined only once.
const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
