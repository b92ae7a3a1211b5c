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
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "mma_common.cuh"

#include <type_traits>

namespace {

constexpr int kRows = 64;        // query rows per thread block
constexpr int kBN = 64;          // keys per staged tile
constexpr int kMaxTable = 512;   // table entries of one split (split / bs)
constexpr int kThreads = 128;

// What a (row, kv head, tile) reads: its valid query rows (slots below
// qlen) and its causal key range [0, kend) in `nsplit` splits. A function
// of that row's pos0 and qlen alone.
struct Plan {
  int n_valid, kend, nsplit;
};
__device__ __forceinline__ Plan plan_of(int row0, int G, int p0, int ql, int nb, int bs,
                                        int split) {
  const int n_valid = min(kRows, ql * G - row0);
  if (n_valid <= 0) return {0, 0, 0};
  const int kend = min(p0 + (row0 + n_valid - 1) / G + 1, nb * bs);
  return {n_valid, kend, (kend + split - 1) / split};
}

struct Args {
  const float* q;
  const void *k_pool, *v_pool;
  const int *tables, *pos0, *qlen;
  void* out;
  float *part_acc, *part_ml;  // [B][H_kv][n_split][rows_pad][D], [...][2]
  int W, H, H_kv, bs, nb, split, n_split, rows_pad;
  float scale;
};

// Where one thread block works: its (row, kv head, tile, split) and plan.
struct Block {
  int b, kvh, row0, split, G, p0;
  Plan plan;
  int kbeg, kstop;
};

// Element offset of query row r of the tile in q and out (B, W, H, D).
template <int D>
__device__ __forceinline__ long long row_offset(const Args& a, const Block& k, int r) {
  const int rr = k.row0 + r;
  return ((static_cast<long long>(k.b) * a.W + rr / k.G) * a.H + k.kvh * k.G + rr % k.G) * D;
}

// Offset of row r's partial in the scratch, in units of one row.
__device__ __forceinline__ long long part_row(const Args& a, const Block& k, int split, int r) {
  return ((static_cast<long long>(k.b) * a.H_kv + k.kvh) * a.n_split + split) * a.rows_pad +
         k.row0 + r;
}

// Stages the split's slice of the row's block table.
__device__ __forceinline__ void stage_table(int* tbl_s, const Args& a, const Block& k, int tid) {
  const int first = k.kbeg / a.bs;
  const int n = (k.kstop - 1) / a.bs + 1 - first;
  for (int i = tid; i < n; i += kThreads)
    tbl_s[i] = a.tables[static_cast<long long>(k.b) * a.nb + first + i];
}

// Element offset in the pool of key kpos's (kv head) vector.
template <int D>
__device__ __forceinline__ long long key_offset(const Args& a, const Block& k, const int* tbl_s,
                                                int kpos) {
  const long long blk = tbl_s[kpos / a.bs - k.kbeg / a.bs];
  return ((blk * a.bs + kpos % a.bs) * a.H_kv + k.kvh) * D;
}

// One query row's result: the output (one split) or the partial.
template <typename KV, int D>
__device__ __forceinline__ void emit(const Args& a, const Block& k, int r, int col, float x0,
                                     float x1, float m2, float l, bool lead) {
  if (k.plan.nsplit == 1) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    KV* o = static_cast<KV*>(a.out) + row_offset<D>(a, k, r) + col;
    store(o, x0 * inv);
    store(o + 1, x1 * inv);
  } else {
    const long long pr = part_row(a, k, k.split, r);
    float* acc = a.part_acc + pr * D + col;
    acc[0] = x0;
    acc[1] = x1;
    if (lead) {
      a.part_ml[2 * pr] = m2;
      a.part_ml[2 * pr + 1] = l;
    }
  }
}

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
  // q split into three bf16 terms (rows past n_valid are zeros).
  for (int idx = tid; idx < kRows * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = *reinterpret_cast<const float4*>(a.q + row_offset<D>(a, k, r) + c);
    float rest[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(rest[0], rest[1]);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(rest[2], rest[3]);
      bf16* dst = q3_s + (term * kRows + r) * ST + c;
      *reinterpret_cast<__nv_bfloat162*>(dst) = lo2;
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = hi2;
      rest[0] -= __bfloat162float(lo2.x);
      rest[1] -= __bfloat162float(lo2.y);
      rest[2] -= __bfloat162float(hi2.x);
      rest[3] -= __bfloat162float(hi2.y);
    }
  }
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

// ---- f32 pool, and D 8: CUDA cores --------------------------------------------

template <int D>
struct SimtCfg {
  static constexpr int kStride = D + 1;              // floats per staged row
  static constexpr int kSStride = kBN + 1;           // floats per score row
  static constexpr int kCols = D / 2;                // output columns per thread
  static constexpr size_t kSmem =
      (3 * kRows * kStride + kRows * kSStride) * sizeof(float) + kMaxTable * sizeof(int);
};

template <typename KV, int D>
__device__ __forceinline__ void split_simt(const Args& a, const Block& k, unsigned char* smem) {
  using C = SimtCfg<D>;
  constexpr int ST = C::kStride, SS = C::kSStride, NC = C::kCols;
  const int tid = threadIdx.x;
  const int n_valid = k.plan.n_valid;

  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][ST]
  float* k_s = q_s + kRows * ST;                // [kBN][ST]
  float* v_s = k_s + kBN * ST;                  // [kBN][ST]
  float* s_s = v_s + kBN * ST;                  // [kRows][SS]
  int* tbl_s = reinterpret_cast<int*>(s_s + kRows * SS);

  stage_table(tbl_s, a, k, tid);
  for (int idx = tid; idx < n_valid * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[r * ST + d] = a.q[row_offset<D>(a, k, r) + d];
  }
  const KV* kp = static_cast<const KV*>(a.k_pool);
  const KV* vp = static_cast<const KV*>(a.v_pool);
  const float scale2 = a.scale * kLog2e;

  // Softmax and PV: two threads per row, each with half of D.
  const int r_own = tid / 2, c0 = (tid % 2) * NC;
  float m = -INFINITY, l = 0.f, acc[NC];
#pragma unroll
  for (int e = 0; e < NC; ++e) acc[e] = 0.f;

  for (int k0 = k.kbeg; k0 < k.kstop; k0 += kBN) {
    __syncthreads();  // the table is staged; the last tile's readers are done
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kpos = k0 + r;
      const bool in = kpos < k.kstop;
      const long long off = in ? key_offset<D>(a, k, tbl_s, kpos) + d : 0;
      k_s[r * ST + d] = in ? to_f32(kp[off]) : 0.f;
      v_s[r * ST + d] = in ? to_f32(vp[off]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < n_valid * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const float* qr = q_s + r * ST;
      const float* kc = k_s + c * ST;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
      const int kpos = k0 + c;
      const bool keep = kpos < k.kstop && kpos <= k.p0 + (k.row0 + r) / k.G;
      s_s[r * SS + c] = keep ? dot * scale2 : -INFINITY;
    }
    __syncthreads();
    if (r_own >= n_valid) continue;
    const float* sr = s_s + r_own * SS;
    float mt = -INFINITY;
    for (int c = 0; c < kBN; ++c) mt = fmaxf(mt, sr[c]);
    const Rescale rs = rescale(m, mt);
    l *= rs.corr;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[e] *= rs.corr;
    for (int c = 0; c < kBN; ++c) {
      const float p = exp2f(sr[c] - rs.m_use);
      l += p;
      // p rounded to the pool's dtype before the PV product.
      const float pr = std::is_same<KV, bf16>::value ? __bfloat162float(__float2bfloat16(p)) : p;
      const float* vc = v_s + c * ST + c0;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[e] = fmaf(pr, vc[e], acc[e]);
    }
  }
  if (r_own >= n_valid) return;
#pragma unroll
  for (int e = 0; e < NC; e += 2)
    emit<KV, D>(a, k, r_own, c0 + e, acc[e], acc[e + 1], m, l, tid % 2 == 0 && e == 0);
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
    return SimtCfg<D>::kSmem;
}
static_assert(smem_bytes<float, 128>() <= 232448 && smem_bytes<bf16, 128>() <= 232448,
              "D 128 tiles fit a thread block's shared memory");

__device__ __forceinline__ Block block_of(const Args& a, int tile, int split, int kvh, int b) {
  Block k;
  k.b = b;
  k.kvh = kvh;
  k.row0 = tile * kRows;
  k.split = split;
  k.G = a.H / a.H_kv;
  k.p0 = a.pos0[b];
  k.plan = plan_of(k.row0, k.G, k.p0, min(a.qlen[b], a.W), a.nb, a.bs, a.split);
  k.kbeg = split * a.split;
  k.kstop = min(k.plan.kend, k.kbeg + a.split);
  return k;
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / a.n_split, split = blockIdx.x % a.n_split;
  const Block k = block_of(a, tile, split, blockIdx.y, blockIdx.z);
  if (split == 0) {  // padding slots of the tile (all of it for qlen 0) get zeros
    const int n_rows = min(kRows, a.W * k.G - k.row0);
    KV* out = static_cast<KV*>(a.out);
    for (int idx = k.plan.n_valid * D + threadIdx.x; idx < n_rows * D; idx += kThreads)
      store(out + row_offset<D>(a, k, idx / D) + idx % D, 0.f);
  }
  if (split >= k.plan.nsplit) return;
  if constexpr (use_mma<KV, D>())
    split_mma<D>(a, k, smem);
  else
    split_simt<KV, D>(a, k, smem);
}

// Merges the partials of every tile that took more than one split, in
// split order: out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_merge_kernel(Args a) {
  const Block k = block_of(a, blockIdx.x, 0, blockIdx.y, blockIdx.z);
  const int ns = k.plan.nsplit;
  if (ns <= 1) return;
  for (int idx = threadIdx.x; idx < k.plan.n_valid * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, a.part_ml[2 * part_row(a, k, s, r)]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < ns; ++s) {
      const long long pr = part_row(a, k, s, r);
      const float w = exp2f(a.part_ml[2 * pr] - m_use);
      den = fmaf(w, a.part_ml[2 * pr + 1], den);
      num = fmaf(w, a.part_acc[pr * D + d], num);
    }
    store(static_cast<KV*>(a.out) + row_offset<D>(a, k, r) + d, den > 0.f ? num / den : 0.f);
  }
}

template <typename KV, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int n_tiles = a.rows_pad / kRows;
  constexpr size_t smem = smem_bytes<KV, D>();
  auto kernel = ragged_split_kernel<KV, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tiles * a.n_split, a.H_kv, B), kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 1) return err;
  ragged_merge_kernel<KV, D><<<dim3(n_tiles, a.H_kv, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
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
  if (B <= 0 || W <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0 || B > 65535 ||
      H_kv > 65535 || split <= 0 || split % bs != 0 || split / bs > kMaxTable)
    return cudaErrorInvalidValue;
  const int n_split = (nb * bs + split - 1) / split;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k_pool, v_pool})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const int G = H / H_kv;
  const Args a{static_cast<const float*>(q), k_pool, v_pool,
               static_cast<const int*>(tables), static_cast<const int*>(pos0),
               static_cast<const int*>(qlen), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), W, H, H_kv, bs, nb, split, n_split,
               (W * G + kRows - 1) / kRows * kRows,
               1.0f / sqrtf(static_cast<float>(D))};
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
