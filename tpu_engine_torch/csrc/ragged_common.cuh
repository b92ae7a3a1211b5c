// The split structure shared by the two ragged reads of this directory:
// ragged_paged_attention.cu (the port of `_ragged_kernel`, bf16/f32 pool)
// and quant_ragged_paged_attention.cu (the port of `_quant_ragged_kernel`,
// int8 pool).
//
// A thread block owns one (query tile, split, kv head, row): a tile is 64 of
// the row's W * G query rows (row r = query slot r / G, group head r % G, as
// in the TPU kernels); its causal key range [0, kend), kend = pos0 + its last
// valid slot + 1, is cut into splits of `split` keys. A tile whose range
// takes one split writes its output directly; otherwise every split writes
// its partial (base-2 running maximum, sum of the weights, unnormalised f32
// output) to scratch the caller allocates, and a second kernel merges the
// partials in split order by log-sum-exp. No atomics: two runs give the same
// bits. A tile's split count depends only on its own row's pos0 and qlen.
//
// Here: the plan of a tile, the launch arguments, the offsets into q, out,
// the pool and the scratch, the staged slice of the block table, the
// three-term bf16 split of q, the CUDA-core split body (f32 pools, and
// D 8, below the tensor cores' k16 depth, for every pool), the writes of
// one query row's result, the zeros of padding slots, the merge kernel and
// the launch of the pair. Each translation unit gets its own copy
// (anonymous namespace).

#pragma once

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
  const float *k_scale, *v_scale;  // (NB, bs, H_kv): the int8 pool only
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

// Index of key kpos's (kv head) slot in the pool, in units of one head
// vector: the offset of its scale, and of its vector times D.
__device__ __forceinline__ long long key_slot(const Args& a, const Block& k, const int* tbl_s,
                                              int kpos) {
  const long long blk = tbl_s[kpos / a.bs - k.kbeg / a.bs];
  return (blk * a.bs + kpos % a.bs) * a.H_kv + k.kvh;
}

// Element offset in the pool of key kpos's (kv head) vector.
template <int D>
__device__ __forceinline__ long long key_offset(const Args& a, const Block& k, const int* tbl_s,
                                                int kpos) {
  return key_slot(a, k, tbl_s, kpos) * D;
}

// The tile's q rows split into three bf16 terms hi, mid, lo ([3][kRows][ST];
// rows past n_valid are zeros): each the bf16 rounding of what the terms
// before it leave, so that their products with an exact bf16 operand,
// summed in f32, carry q's 24-bit significand.
template <int D, int ST>
__device__ __forceinline__ void stage_q_terms(bf16* q3_s, const Args& a, const Block& k,
                                              int tid) {
  for (int idx = tid; idx < kRows * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < k.plan.n_valid) x = *reinterpret_cast<const float4*>(a.q + row_offset<D>(a, k, r) + c);
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
}

// One query row's result: the output (one split) or the partial.
template <typename Out, int D>
__device__ __forceinline__ void emit(const Args& a, const Block& k, int r, int col, float x0,
                                     float x1, float m2, float l, bool lead) {
  if (k.plan.nsplit == 1) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    Out* o = static_cast<Out*>(a.out) + row_offset<D>(a, k, r) + col;
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

// Padding slots of the tile (all of it for qlen 0) get zeros.
template <typename Out, int D>
__device__ __forceinline__ void zero_padding(const Args& a, const Block& k) {
  const int n_rows = min(kRows, a.W * k.G - k.row0);
  Out* out = static_cast<Out*>(a.out);
  for (int idx = k.plan.n_valid * D + threadIdx.x; idx < n_rows * D; idx += kThreads)
    store(out + row_offset<D>(a, k, idx / D) + idx % D, 0.f);
}

// ---- CUDA cores: f32 pools, and D 8 -------------------------------------------

template <typename KV, int D>
struct SimtCfg {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStride = D + 1;              // floats per staged row
  static constexpr int kSStride = kBN + 1;           // floats per score row
  static constexpr int kCols = D / 2;                // output columns per thread
  static constexpr size_t kSmem =
      (3 * kRows * kStride + kRows * kSStride + (kQuant ? 2 * kBN : 0)) * sizeof(float) +
      kMaxTable * sizeof(int);
};

// One split on the CUDA cores: q, K and V staged as f32 a tile at a time,
// scores through shared memory, two threads per query row for the softmax
// and the weighted sum of V. Over the int8 pool the K scales multiply the
// score columns after the product and the V scales fold into the weights
// (in f32); over a bf16 pool the weights are rounded to bf16 before PV.
template <typename KV, int D>
__device__ __forceinline__ void split_simt(const Args& a, const Block& k, unsigned char* smem) {
  using C = SimtCfg<KV, D>;
  constexpr int ST = C::kStride, SS = C::kSStride, NC = C::kCols;
  constexpr bool kQuant = C::kQuant;
  const int tid = threadIdx.x;
  const int n_valid = k.plan.n_valid;

  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][ST]
  float* k_s = q_s + kRows * ST;                // [kBN][ST]
  float* v_s = k_s + kBN * ST;                  // [kBN][ST]
  float* s_s = v_s + kBN * ST;                  // [kRows][SS]
  float* ks_s = s_s + kRows * SS;               // [kBN] K scales (int8 pool)
  float* vs_s = ks_s + kBN;                     // [kBN] V scales
  int* tbl_s = reinterpret_cast<int*>(s_s + kRows * SS + (kQuant ? 2 * kBN : 0));

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
    if (kQuant) {
      for (int r = tid; r < kBN; r += kThreads) {
        const int kpos = k0 + r;
        const bool in = kpos < k.kstop;
        const long long slot = in ? key_slot(a, k, tbl_s, kpos) : 0;
        ks_s[r] = in ? a.k_scale[slot] : 0.f;
        vs_s[r] = in ? a.v_scale[slot] : 0.f;
      }
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
      // (q . Kq) * (ks * scale) over the int8 pool: the scale after the product.
      s_s[r * SS + c] = keep ? dot * (kQuant ? ks_s[c] * scale2 : scale2) : -INFINITY;
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
      // The weight PV takes: p * vs (int8), p rounded to bf16 (bf16 pool), p.
      const float pr = kQuant ? p * vs_s[c]
                       : std::is_same<KV, bf16>::value ? __bfloat162float(__float2bfloat16(p))
                                                       : p;
      const float* vc = v_s + c * ST + c0;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[e] = fmaf(pr, vc[e], acc[e]);
    }
  }
  if (r_own >= n_valid) return;
#pragma unroll
  for (int e = 0; e < NC; e += 2)
    emit<OutOf<KV>, D>(a, k, r_own, c0 + e, acc[e], acc[e + 1], m, l, tid % 2 == 0 && e == 0);
}

// ---- the merge and the launch ------------------------------------------------------

// Merges the partials of every tile that took more than one split, in
// split order: out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.
template <typename Out, int D>
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
    store(static_cast<Out*>(a.out) + row_offset<D>(a, k, r) + d, den > 0.f ? num / den : 0.f);
  }
}

// Launches the split kernel on grid (tile x split, kv head, row) and, when
// any tile can take more than one split, the merge.
template <typename Out, int D, typename Kernel>
cudaError_t launch_split_merge(Kernel kernel, size_t smem, const Args& a, int B,
                               cudaStream_t stream) {
  const int n_tiles = a.rows_pad / kRows;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tiles * a.n_split, a.H_kv, B), kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 1) return err;
  ragged_merge_kernel<Out, D><<<dim3(n_tiles, a.H_kv, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The arguments of one call, or false for a shape the kernels do not take.
// `split`: keys per split, a multiple of bs and at most kMaxTable table
// entries; part_acc/part_ml may be null only when n_split is 1; q and the
// pools 16-byte aligned.
inline bool make_args(Args* a, const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scale, const void* v_scale, const void* tables,
                      const void* pos0, const void* qlen, void* out, void* part_acc,
                      void* part_ml, int B, int W, int H, int H_kv, int D, int bs, int nb,
                      int split) {
  if (B <= 0 || W <= 0 || H_kv <= 0 || H % H_kv != 0 || bs <= 0 || nb <= 0 || B > 65535 ||
      H_kv > 65535 || split <= 0 || split % bs != 0 || split / bs > kMaxTable)
    return false;
  const int n_split = (nb * bs + split - 1) / split;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) return false;
  for (const void* p : {q, k_pool, v_pool})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int G = H / H_kv;
  *a = Args{static_cast<const float*>(q), k_pool, v_pool,
            static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
            static_cast<const int*>(tables), static_cast<const int*>(pos0),
            static_cast<const int*>(qlen), out, static_cast<float*>(part_acc),
            static_cast<float*>(part_ml), W, H, H_kv, bs, nb, split, n_split,
            (W * G + kRows - 1) / kRows * kRows, 1.0f / sqrtf(static_cast<float>(D))};
  return true;
}

}  // namespace
