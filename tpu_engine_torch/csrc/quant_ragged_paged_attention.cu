// Ragged paged attention over the int8 block pool for Hopper (sm_90a),
// hand-written CUDA C++: a split read on the tensor cores and a merge pass.
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
//   kernel writes zeros there). A row with no valid key gives 0. K scales
//   multiply the score columns after the product and V scales fold into the
//   softmax weights, in the TPU kernel's order: s = (q . Kq_c) * (ks_c /
//   sqrt(D)), acc += (p_c * vs_c) Vq_c in f32, l += p_c. The dequantized
//   block never exists in device memory.
//
// What bounds it on an H100: at decode widths device-memory bytes and
// latency (D bytes of int8 payload and 4 bytes of scale per key, for each of
// K and V, per (row, kv-head) pair, at 3.35 TB/s); a 256-token prefill chunk
// over a 1,700-token history does ~4 GFLOP, and there the products bound it.
//
// Design: that of ragged_paged_attention.cu (the port of `_ragged_kernel`),
// whose split structure it shares through ragged_common.cuh: 64-row query
// tiles, splits of `split` keys one thread block each, the staged table
// slice, partials merged by log-sum-exp in split order (no atomics: two runs
// give the same bits, and a row's bits do not depend on the other rows).
// What the int8 pool changes:
// - A key tile (64 keys) of int8 K and V is gathered through the table by
//   16-byte cp.async copies (16 int8 values each) beside its two f32 scale
//   vectors (4-byte copies: a key's scales lie H_kv floats apart), double-
//   buffered, then converted to bf16 in shared memory. The conversion is
//   exact: |x| <= 127 fits bf16's 8-bit significand.
// - D >= 16: mma.sync m16n8k16 bf16 -> f32. S = q Kq^T with q in three bf16
//   terms (ragged_common.cuh), which with the exact bf16 Kq give the TPU
//   kernel's f32 q . f32(Kq); each score column is then multiplied by its
//   ks * scale. PV keeps the TPU kernel's f32 weights: p * vs is split into
//   three bf16 terms the same way, so that their products with the exact
//   bf16 Vq, summed in the f32 accumulators, carry the f32 product (rounding
//   p * vs to bf16 would change the numbers). l sums the unscaled p.
// - D 8 (below the k16 depth): the shared CUDA-core body over the same
//   splits, in f32.
//
// Left to later work: wgmma/TMA tiles, a persistent schedule, and the cost
// of the split products (three bf16 products for each f32 one, on both
// sides).
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "ragged_common.cuh"

namespace {

template <int D>
struct QuantCfg {
  static constexpr int kStride = D + 8;    // bf16 elements per converted row
  static constexpr int kQStride = D + 16;  // bytes per staged int8 row
  static constexpr int kKD = D / 16;       // k16 steps over D
  static constexpr int kND = D / 8;        // n8 tiles over D
  static constexpr int kNB = kBN / 8;      // n8 tiles over the key tile
  static constexpr int kKB = kBN / 16;     // k16 steps over the key tile
  static constexpr size_t kSmem =
      (3 * kRows + 2 * kBN) * kStride * sizeof(bf16)  // q terms; K, V as bf16
      + 2 * 2 * kBN * kQStride                        // K, V int8, two buffers
      + 2 * 2 * kBN * sizeof(float)                   // their scales
      + kMaxTable * sizeof(int);
};

// Keys [k0, k0 + kBN) of int8 K and V and their scales into one buffer
// through the staged table; keys at or past kstop are zeros.
template <int D>
__device__ __forceinline__ void stage_int8(int8_t* k_q, int8_t* v_q, float* ks, float* vs,
                                           const Args& a, const Block& k, const int* tbl_s,
                                           int k0, int tid) {
  constexpr int QS = QuantCfg<D>::kQStride, kChunks = D / 16;
  constexpr int kCopies = kBN * kChunks;
  const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
  const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    if (kCopies % kThreads != 0 && idx >= kCopies) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const int kpos = k0 + r;
    const bool in = kpos < k.kstop;
    const long long off = in ? key_offset<D>(a, k, tbl_s, kpos) + c * 16 : 0;
    cp_async16(k_q + r * QS + c * 16, kp + off, in);
    cp_async16(v_q + r * QS + c * 16, vp + off, in);
  }
  if (tid < kBN) {
    const int kpos = k0 + tid;
    const bool in = kpos < k.kstop;
    const long long slot = in ? key_slot(a, k, tbl_s, kpos) : 0;
    cp_async4(ks + tid, a.k_scale + slot, in);
    cp_async4(vs + tid, a.v_scale + slot, in);
  }
}

// A staged int8 tile -> bf16 rows (exact).
template <int D>
__device__ __forceinline__ void to_bf16_tile(bf16* dst, const int8_t* src, int tid) {
  constexpr int ST = QuantCfg<D>::kStride, QS = QuantCfg<D>::kQStride, kChunks = D / 16;
  for (int idx = tid; idx < kBN * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int4 x = *reinterpret_cast<const int4*>(src + r * QS + c * 16);
    const int8_t* v = reinterpret_cast<const int8_t*>(&x);
    __nv_bfloat162 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __floats2bfloat162_rn(static_cast<float>(v[2 * j]), static_cast<float>(v[2 * j + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + r * ST + c * 16);
    d[0] = *reinterpret_cast<const uint4*>(&o[0]);
    d[1] = *reinterpret_cast<const uint4*>(&o[4]);
  }
}

// x as three bf16 terms hi + mid + lo (as floats), each the bf16 rounding of
// what the terms before it leave.
__device__ __forceinline__ void split3(float x, float (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = __bfloat162float(__float2bfloat16(x));
    x -= t[i];
  }
}

template <int D>
__device__ __forceinline__ void split_mma_int8(const Args& a, const Block& k,
                                               unsigned char* smem) {
  using C = QuantCfg<D>;
  constexpr int ST = C::kStride, QS = C::kQStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_valid = k.plan.n_valid;

  bf16* q3_s = reinterpret_cast<bf16*>(smem);     // hi, mid, lo: [3][kRows][ST]
  bf16* k_s = q3_s + 3 * kRows * ST;              // [kBN][ST] bf16 of the current tile
  bf16* v_s = k_s + kBN * ST;                     // [kBN][ST]
  int8_t* kq_s = reinterpret_cast<int8_t*>(v_s + kBN * ST);  // [2][kBN][QS]
  int8_t* vq_s = kq_s + 2 * kBN * QS;                        // [2][kBN][QS]
  float* ks_s = reinterpret_cast<float*>(vq_s + 2 * kBN * QS);  // [2][kBN]
  float* vs_s = ks_s + 2 * kBN;                                 // [2][kBN]
  int* tbl_s = reinterpret_cast<int*>(vs_s + 2 * kBN);

  stage_table(tbl_s, a, k, tid);
  stage_q_terms<D, ST>(q3_s, a, k, tid);
  __syncthreads();  // the table is staged

  const int n_tiles = (k.kstop - k.kbeg + kBN - 1) / kBN;
  stage_int8<D>(kq_s, vq_s, ks_s, vs_s, a, k, tbl_s, k.kbeg, tid);
  cp_async_commit();

  const int row0w = warp * 16;
  const bool live = row0w < n_valid;  // a warp of padding rows only stages
  const int qpos[2] = {k.p0 + (k.row0 + row0w + g) / k.G,
                       k.p0 + (k.row0 + row0w + g + 8) / k.G};
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
      stage_int8<D>(kq_s + (buf ^ 1) * kBN * QS, vq_s + (buf ^ 1) * kBN * QS,
                    ks_s + (buf ^ 1) * kBN, vs_s + (buf ^ 1) * kBN, a, k, tbl_s, k0 + kBN, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    to_bf16_tile<D>(k_s, kq_s + buf * kBN * QS, tid);
    to_bf16_tile<D>(v_s, vq_s + buf * kBN * QS, tid);
    __syncthreads();
    if (live) {
      const float* kst = ks_s + buf * kBN;
      const float* vst = vs_s + buf * kBN;

      // S = (q_lo + q_mid + q_hi) Kq^T, smallest term first.
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
          ldsm_x4(bk, frag_bt<ST>(k_s, np * 16, kk * 16, lane));
#pragma unroll
          for (int term = 2; term >= 0; --term) {
            mma_16816(s[2 * np], qf[term], bk[0], bk[1]);
            mma_16816(s[2 * np + 1], qf[term], bk[2], bk[3]);
          }
        }
      }
      // (q . Kq) * (ks * scale), in base 2; masked keys -inf.
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int kpos = k0 + c;
          const bool keep = kpos < k.kstop && kpos <= qpos[e >> 1];
          s[n][e] = keep ? s[n][e] * (kst[c] * scale2) : -INFINITY;
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
      // p and its sums unscaled; p * vs in three bf16 terms, repacked as
      // the A fragments of O += (p vs) Vq.
      unsigned p_f[3][C::kKB][4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < C::kNB; ++n) {
        float x[4][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - rs[e >> 1].m_use);
          ps[e >> 1] += p;
          split3(p * vst[n * 8 + 2 * t + (e & 1)], x[e]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          p_f[term][n >> 1][(n & 1) * 2] = pack_bf16(x[0][term], x[1][term]);
          p_f[term][n >> 1][(n & 1) * 2 + 1] = pack_bf16(x[2][term], x[3][term]);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) l[hi] = l[hi] * rs[hi].corr + ps[hi];
#pragma unroll
      for (int n = 0; n < C::kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= rs[e >> 1].corr;

      // O += P V, V as the B operand through ldmatrix.trans, smallest term first.
#pragma unroll
      for (int kb = 0; kb < C::kKB; ++kb)
#pragma unroll
        for (int dp = 0; dp < C::kND / 2; ++dp) {
          unsigned bv[4];
          ldsm_x4_trans(bv, frag_a<ST>(v_s, kb * 16, dp * 16, lane));
#pragma unroll
          for (int term = 2; term >= 0; --term) {
            mma_16816(acc[2 * dp], p_f[term][kb], bv[0], bv[1]);
            mma_16816(acc[2 * dp + 1], p_f[term][kb], bv[2], bv[3]);
          }
        }
    }
    __syncthreads();  // the bf16 tile is rewritten, this buffer refilled two tiles on
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
      emit<float, D>(a, k, r, n * 8 + 2 * t, acc[n][2 * hi], acc[n][2 * hi + 1], m[hi], l[hi],
                     t == 0 && n == 0);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  if constexpr (D >= 16)
    return QuantCfg<D>::kSmem;
  else
    return SimtCfg<int8_t, D>::kSmem;
}
static_assert(smem_bytes<128>() <= 232448, "D 128 tiles fit a thread block's shared memory");

template <int D>
__global__ void __launch_bounds__(kThreads)
quant_ragged_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / a.n_split, split = blockIdx.x % a.n_split;
  const Block k = block_of(a, tile, split, blockIdx.y, blockIdx.z);
  if (split == 0) zero_padding<float, D>(a, k);
  if (split >= k.plan.nsplit) return;
  if constexpr (D >= 16)
    split_mma_int8<D>(a, k, smem);
  else
    split_simt<int8_t, D>(a, k, smem);
}

template <int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  return launch_split_merge<float, D>(quant_ragged_split_kernel<D>, smem_bytes<D>(), a, B,
                                      stream);
}

}  // namespace

extern "C" {

// `split`, part_acc and part_ml as for ragged_paged_attention; the scales
// need no alignment beyond their f32. Returns the launches' cudaError_t
// (0 = success).
int quant_ragged_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* pos0, const void* qlen,
                                 void* out, void* part_acc, void* part_ml, int B, int W,
                                 int H, int H_kv, int D, int bs, int nb, int split,
                                 void* stream) {
  Args a;
  if (!make_args(&a, q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out, part_acc,
                 part_ml, B, W, H, H_kv, D, bs, nb, split))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:   return launch<8>(a, B, s);
    case 16:  return launch<16>(a, B, s);
    case 32:  return launch<32>(a, B, s);
    case 64:  return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default:  return cudaErrorInvalidValue;
  }
}

}  // extern "C"
