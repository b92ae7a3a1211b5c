// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, one per gradient sweep, each in two designs (bf16 on the tensor
// cores, f32 on the CUDA cores).
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
//   (b, s, h) element strides (the last dimension contiguous, every row
//   16-byte aligned: the caller copies a tensor that is not); mask (B, Sk)
//   int32, 1 = valid, or null; causal (query i attends keys j <= i, both
//   counted from 0) and an optional sliding window (keys j > i - window;
//   causal only); lse (B, H, Sq) f32 as the forward kernel writes it (-inf on
//   rows with no valid key); delta (B, H, Sq) f32 = sum_d do * out
//   ->  dq (B, Sq, H, D) in q's dtype; dk, dv (B, Sk, H, D) in k's and v's.
//
// The probabilities are recomputed from lse, as `_recompute_p` does: p =
// exp(s * scale - lse) on the pairs the forward attended, 0 on the others and
// on rows whose lse is -inf (the mask test comes before the exp, so such a
// row gives dq 0 and adds nothing to dk or dv, never NaN). dp = do . v^T and
// the scores are products of the input values summed in f32; ds = p * (dp -
// delta) in f32. Rounding points are the TPU kernels': p is rounded to do's
// dtype before the dv product, ds to k's (dq) or q's (dk) dtype before its
// product; the sums run in f32 and each gradient is rounded to its dtype
// once, at the end.
//
// What bounds it on an H100: operations. A causal pass of S tokens does
// 6 * D (dq) or 8 * D (dk, dv) flops per attended (query, key) pair, about
// S^2 / 2 pairs per head, against about 7 * S * D elements moved per head:
// in bf16 the tensor cores' rate (989 TFLOP/s) is the roof; in f32, which
// keeps TF32 off so its products stay f32, the CUDA cores' (67 TFLOP/s).
//
// Design, for this card (the TPU blocks are not carried over):
// - Each thread block owns one 64-row output tile (query rows for dq, key
//   rows for dk and dv) and loops over the tiles of the other axis that the
//   forward visited: no atomics, so two runs give bit-identical gradients.
//   The grid is (head, batch, tile) with the tile slowest, and dq's tiles
//   run last-first: under causal the longest sweeps start first.
// - The TPU kernels' tile skips: key tiles wholly above the causal diagonal
//   or below a sliding window's band are never visited (dq), and a key tile
//   only visits the query tiles from its diagonal down to its band's end
//   (dk, dv). Ragged tails are zero-filled and masked.
// - Tiles move with 16-byte cp.async copies (zero-fill past the sequence
//   end); the output tile's own operands are loaded once.
// - bf16 (FlashAttention-2's backward shape, mma.sync m16n8k16 bf16 -> f32
//   with ldmatrix): 4 warps, each owning 16 rows of the output tile. The
//   swept tiles are double-buffered: the next loads while this one
//   multiplies. Tiles are staged in shared memory as bf16, rows padded by
//   16 bytes so the eight 16-byte rows an ldmatrix phase reads fall in
//   distinct banks.
//   dq: each warp keeps its Q and dO fragments in registers for the sweep
//   (D <= 64; at D 128 they are reread from shared memory, for registers),
//   computes S = Q K^T and dP = dO V^T with mma.sync, forms p and ds in the
//   accumulator registers, rounds ds to bf16 and repacks it in registers
//   from the accumulator layout into the A-operand layout (two adjacent n8
//   accumulator tiles make one k16 A fragment), and adds dS K with K as the
//   B operand through ldmatrix.trans: ds never goes to shared memory.
//   dk, dv: each warp owns 16 key rows and computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out one key per row, ready as the A
//   operands of dV += P^T dO and dK += dS^T Q (B through ldmatrix.trans);
//   lse and delta index columns here and are staged per query tile. The
//   swept tile is 64 rows (32 at D 128, for registers).
// - f32 (register-tiled CUDA-core products): 256 threads. Each computes a
//   4 x 4 block of the 64 x 64 s and dp tiles from float4 reads, writes p
//   and ds (dq: ds transposed) to shared memory, then owns a block of rows
//   x 4 columns of the output (4 x 4 of dq, or of each of dk and dv, at
//   D 64), read as float4: a float4 of ds (or p) and one of k (or q, do)
//   feed 16 multiply-adds. Tiles are staged with rows padded by 16 bytes.
//   Up to D 64 two thread blocks share an SM (registers capped at 128 a
//   thread, shared memory at 86 and 103 KB a block), each with one swept
//   tile in flight: a block's copy overlaps the other block's products.
//   Double buffering would cost a second 34 KB tile pair and leave one
//   thread block per SM, idle at each of its barriers; it ran slower on
//   the card.
// - A tile whose every pair the forward attended (full tiles, no padding
//   mask, on or below the diagonal, inside the band) skips the per-pair
//   tests; p is exp2 of a base-2 score (scale and lse times log2 e).
//
// Left to later work: wgmma tiles fed by TMA with warp-specialised
// producers, and reading grouped K/V without the caller's repeat_kv.
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "flash_common.cuh"
#include "mma_common.cuh"

#include <type_traits>

namespace {

constexpr int kTile = 64;  // rows of the output tile, both kernels, both types

// The lse and delta rows [row0, row0 + ROWS) of one head, lse in base 2
// (times log2 e); rows past n_rows get lse -inf (p = 0) and delta 0.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s, const float* lse,
                                           const float* delta, long long row0, int n_rows,
                                           int tid) {
  if (tid < ROWS) {
    const bool in = tid < n_rows;
    lse_s[tid] = in ? lse[row0 + tid] * kLog2e : -INFINITY;
    delta_s[tid] = in ? delta[row0 + tid] : 0.f;
  }
}

// p = exp(s * scale - lse) of one attended (query, key) pair, in base 2:
// scale2 = scale * log2 e and lse2 = lse * log2 e.
__device__ __forceinline__ float p_of(float s, float scale2, float lse2) {
  return exp2f(fmaf(s, scale2, -lse2));
}

// p of any (query, key) pair: 0 where the forward attended nothing. The
// mask test comes before the exp.
__device__ __forceinline__ float recompute_p(float s, float scale2, float lse2, bool key_ok,
                                             int qpos, int kpos, int causal, int window) {
  bool keep = key_ok && lse2 != -INFINITY;
  if (causal) keep = keep && kpos <= qpos && (window == 0 || qpos - kpos < window);
  return keep ? p_of(s, scale2, lse2) : 0.f;
}

template <int D>
struct MmaCfg {
  static constexpr int kThreads = 128;              // 4 warps x 16 output rows
  static constexpr int kBN = D == 128 ? 32 : 64;    // rows per swept tile
  static constexpr int kStride = D + 8;             // bf16 elements per staged row
  static constexpr bool kFragRegs = D <= 64;        // own operands kept in registers
  static constexpr int kKD = D / 16;                // k16 steps over D
  static constexpr int kND = D / 8;                 // n8 tiles over D
  static constexpr int kNB = kBN / 8;               // n8 tiles over the swept tile
  static constexpr int kKB = kBN / 16;              // k16 steps over the swept tile
  static constexpr size_t kOwnBytes = 2 * kTile * kStride * sizeof(bf16);
  static constexpr size_t kSweptBytes = 2 * 2 * kBN * kStride * sizeof(bf16);
};

// S = A B^T and dP = dA dB^T for one warp's 16 rows against a swept tile
// (kBN rows of b_t and db_t), accumulated over D.
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[MmaCfg<D>::kNB][4],
                                           float (&dp)[MmaCfg<D>::kNB][4],
                                           const unsigned (&a_reg)[MmaCfg<D>::kKD][4],
                                           const unsigned (&da_reg)[MmaCfg<D>::kKD][4],
                                           const bf16* a_t, const bf16* da_t,
                                           const bf16* b_t, const bf16* db_t, int row0,
                                           int lane) {
  using C = MmaCfg<D>;
#pragma unroll
  for (int n = 0; n < C::kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kKD; ++kk) {
    unsigned a[4], da[4];
    if constexpr (C::kFragRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = a_reg[kk][e], da[e] = da_reg[kk][e];
    } else {
      ldsm_x4(a, frag_a<C::kStride>(a_t, row0, kk * 16, lane));
      ldsm_x4(da, frag_a<C::kStride>(da_t, row0, kk * 16, lane));
    }
#pragma unroll
    for (int np = 0; np < C::kNB / 2; ++np) {
      unsigned b[4], db[4];
      ldsm_x4(b, frag_bt<C::kStride>(b_t, np * 16, kk * 16, lane));
      ldsm_x4(db, frag_bt<C::kStride>(db_t, np * 16, kk * 16, lane));
      mma_16816(s[2 * np], a, b[0], b[1]);
      mma_16816(s[2 * np + 1], a, b[2], b[3]);
      mma_16816(dp[2 * np], da, db[0], db[1]);
      mma_16816(dp[2 * np + 1], da, db[2], db[3]);
    }
  }
}

// acc (16 x D per warp) += A . t, A from registers (kKB k16 fragments over
// the swept tile), t a staged [kBN][D] tile read as the B operand through
// ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_out(float (&acc)[MmaCfg<D>::kND][4],
                                        const unsigned (&a)[MmaCfg<D>::kKB][4],
                                        const bf16* t, int lane) {
  using C = MmaCfg<D>;
#pragma unroll
  for (int ks = 0; ks < C::kKB; ++ks)
#pragma unroll
    for (int dp2 = 0; dp2 < C::kND / 2; ++dp2) {
      unsigned b[4];
      ldsm_x4_trans(b, frag_a<C::kStride>(t, ks * 16, dp2 * 16, lane));
      mma_16816(acc[2 * dp2], a[ks], b[0], b[1]);
      mma_16816(acc[2 * dp2 + 1], a[ks], b[2], b[3]);
    }
}

// Loads one warp's own 16 x D operand into A fragments.
template <int D>
__device__ __forceinline__ void load_frags(unsigned (&f)[MmaCfg<D>::kKD][4], const bf16* t,
                                           int row0, int lane) {
  if constexpr (MmaCfg<D>::kFragRegs) {
#pragma unroll
    for (int kk = 0; kk < MmaCfg<D>::kKD; ++kk)
      ldsm_x4(f[kk], frag_a<MmaCfg<D>::kStride>(t, row0, kk * 16, lane));
  }
}

// Writes one warp's 16 x D f32 accumulator tile, times `mul`, as bf16 rows
// [row0 + r] of out (row stride H * D), rows below n_rows only.
template <int D>
__device__ __forceinline__ void store_frags(bf16* out, long long row_stride,
                                            const float (&acc)[MmaCfg<D>::kND][4], float mul,
                                            int row0, int n_rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n_rows) continue;
    bf16* o = out + r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < MmaCfg<D>::kND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// ---- bf16 dq: tensor cores --------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_mma(const bf16* q, const bf16* k, const bf16* v,
                                       const int* mask, const bf16* dout, const float* lse,
                                       const float* delta, bf16* dq, int Sq, int Sk, int H,
                                       Strides qs, Strides ks, Strides vs, Strides dos,
                                       int causal, int window, float scale, int tile, int h,
                                       int b, unsigned char* smem) {
  using C = MmaCfg<D>;
  constexpr int BN = C::kBN, ST = C::kStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = tile * kTile;
  const int n_rows = min(kTile, Sq - q0);

  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [kTile][ST]
  bf16* do_s = q_s + kTile * ST;                      // [kTile][ST]
  bf16* k_s = do_s + kTile * ST;                      // [2][BN][ST]
  bf16* v_s = k_s + 2 * BN * ST;                      // [2][BN][ST]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * BN * ST);  // [kTile]
  float* delta_s = lse_s + kTile;                     // [kTile]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + kTile);     // [2][BN]

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const Range kt = key_tiles(q0, n_rows, Sk, BN, causal, window);
  const int n_tiles = max(0, kt.end - kt.begin);

  stage_async<bf16, D, kTile, ST, C::kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  stage_async<bf16, D, kTile, ST, C::kThreads>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0,
                                               Sq, tid);
  stage_rows<kTile>(lse_s, delta_s, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0,
                    n_rows, tid);
  stage_async<bf16, D, BN, ST, C::kThreads>(k_s, kb, ks.s, kt.begin * BN, Sk, tid);
  stage_async<bf16, D, BN, ST, C::kThreads>(v_s, vb, vs.s, kt.begin * BN, Sk, tid);
  stage_keys<BN>(kvalid_s, mb, kt.begin * BN, Sk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16;
  unsigned q_f[C::kKD][4], do_f[C::kKD][4];
  load_frags<D>(q_f, q_s, row0, lane);
  load_frags<D>(do_f, do_s, row0, lane);
  const float lse_r[2] = {lse_s[row0 + g], lse_s[row0 + g + 8]};  // base 2
  const float scale2 = scale * kLog2e;
  const float delta_r[2] = {delta_s[row0 + g], delta_s[row0 + g + 8]};
  const int qpos[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  float acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = (kt.begin + it) * BN;
    if (it + 1 < n_tiles) {  // the next key tile loads while this one multiplies
      const int nb = buf ^ 1;
      stage_async<bf16, D, BN, ST, C::kThreads>(k_s + nb * BN * ST, kb, ks.s, k0 + BN, Sk, tid);
      stage_async<bf16, D, BN, ST, C::kThreads>(v_s + nb * BN * ST, vb, vs.s, k0 + BN, Sk, tid);
      stage_keys<BN>(kvalid_s + nb * BN, mb, k0 + BN, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt_s = k_s + buf * BN * ST;
    const int* kv_s = kvalid_s + buf * BN;

    float s[C::kNB][4], dp[C::kNB][4];
    mma_scores<D>(s, dp, q_f, do_f, q_s, do_s, kt_s, v_s + buf * BN * ST, row0, lane);

    // p and ds in the accumulators; ds rounded to k's dtype and repacked
    // as A fragments of the dS K product (n8 tiles 2j, 2j + 1 -> k16 step j).
    // s becomes p in place; a fully attended tile skips the per-pair tests.
    if (all_attended(q0, kTile, k0, BN, Sq, Sk, mask, causal, window)) {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p_of(s[n][e], scale2, lse_r[e >> 1]);
    } else {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, col = n * 8 + 2 * t + (e & 1);
          s[n][e] = recompute_p(s[n][e], scale2, lse_r[hi], kv_s[col] != 0, qpos[hi],
                                k0 + col, causal, window);
        }
    }
    unsigned ds_f[C::kKB][4];
#pragma unroll
    for (int n = 0; n < C::kNB; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = s[n][e] * (dp[n][e] - delta_r[e >> 1]);
      ds_f[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      ds_f[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_out<D>(acc, ds_f, kt_s, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  store_frags<D>(dq + ((static_cast<long long>(b) * Sq + q0) * H + h) * D,
                 static_cast<long long>(H) * D, acc, scale, row0, n_rows, lane);
}

// ---- bf16 dk, dv: tensor cores ----------------------------------------------

template <int D>
__device__ __forceinline__ void dkv_mma(const bf16* q, const bf16* k, const bf16* v,
                                        const int* mask, const bf16* dout, const float* lse,
                                        const float* delta, bf16* dk, bf16* dv, int Sq, int Sk,
                                        int H, Strides qs, Strides ks, Strides vs, Strides dos,
                                        int causal, int window, float scale, int tile, int h,
                                        int b, unsigned char* smem) {
  using C = MmaCfg<D>;
  constexpr int BN = C::kBN, ST = C::kStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = tile * kTile;
  const int n_keys = min(kTile, Sk - k0);

  bf16* k_s = reinterpret_cast<bf16*>(smem);          // [kTile][ST]
  bf16* v_s = k_s + kTile * ST;                       // [kTile][ST]
  bf16* q_s = v_s + kTile * ST;                       // [2][BN][ST]
  bf16* do_s = q_s + 2 * BN * ST;                     // [2][BN][ST]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * ST);  // [2][BN]
  float* delta_s = lse_s + 2 * BN;                    // [2][BN]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + 2 * BN);     // [kTile]

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
  const Range qt = query_tiles(k0, n_keys, Sq, BN, causal, window);
  const int n_tiles = max(0, qt.end - qt.begin);

  stage_async<bf16, D, kTile, ST, C::kThreads>(k_s, k + b * ks.b + h * ks.h, ks.s, k0, Sk, tid);
  stage_async<bf16, D, kTile, ST, C::kThreads>(v_s, v + b * vs.b + h * vs.h, vs.s, k0, Sk, tid);
  stage_keys<kTile>(kvalid_s, mb, k0, Sk, tid);
  const int qf = qt.begin * BN;
  stage_async<bf16, D, BN, ST, C::kThreads>(q_s, qb, qs.s, qf, Sq, tid);
  stage_async<bf16, D, BN, ST, C::kThreads>(do_s, dob, dos.s, qf, Sq, tid);
  stage_rows<BN>(lse_s, delta_s, lse, delta, rows + qf, Sq - qf, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16;
  unsigned k_f[C::kKD][4], v_f[C::kKD][4];
  load_frags<D>(k_f, k_s, row0, lane);
  load_frags<D>(v_f, v_s, row0, lane);
  const int kpos[2] = {k0 + row0 + g, k0 + row0 + g + 8};
  const bool key_ok[2] = {kvalid_s[row0 + g] != 0, kvalid_s[row0 + g + 8] != 0};
  const float scale2 = scale * kLog2e;

  float dk_acc[C::kND][4], dv_acc[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int q0 = (qt.begin + it) * BN;
    if (it + 1 < n_tiles) {  // the next query tile loads while this one multiplies
      const int nb = buf ^ 1;
      stage_async<bf16, D, BN, ST, C::kThreads>(q_s + nb * BN * ST, qb, qs.s, q0 + BN, Sq, tid);
      stage_async<bf16, D, BN, ST, C::kThreads>(do_s + nb * BN * ST, dob, dos.s, q0 + BN, Sq,
                                                tid);
      stage_rows<BN>(lse_s + nb * BN, delta_s + nb * BN, lse, delta, rows + q0 + BN,
                     Sq - q0 - BN, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt_s = q_s + buf * BN * ST;
    const bf16* dot_s = do_s + buf * BN * ST;
    const float* lse_b = lse_s + buf * BN;
    const float* delta_b = delta_s + buf * BN;

    // S^T = K Q^T and dP^T = V dO^T: one key per accumulator row.
    float s[C::kNB][4], dp[C::kNB][4];
    mma_scores<D>(s, dp, k_f, v_f, k_s, v_s, qt_s, dot_s, row0, lane);

    // P^T rounded to do's dtype, dS^T to q's, repacked as A fragments.
    // s becomes p in place; a fully attended tile skips the per-pair tests.
    if (all_attended(q0, BN, k0, kTile, Sq, Sk, mask, causal, window)) {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p_of(s[n][e], scale2, lse_b[n * 8 + 2 * t + (e & 1)]);
    } else {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, col = n * 8 + 2 * t + (e & 1);
          s[n][e] = recompute_p(s[n][e], scale2, lse_b[col], key_ok[hi], q0 + col, kpos[hi],
                                causal, window);
        }
    }
    unsigned p_f[C::kKB][4], ds_f[C::kKB][4];
#pragma unroll
    for (int n = 0; n < C::kNB; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[n][e];
        ds[e] = p[e] * (dp[n][e] - delta_b[n * 8 + 2 * t + (e & 1)]);
      }
      p_f[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      p_f[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      ds_f[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      ds_f[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_out<D>(dv_acc, p_f, dot_s, lane);
    mma_out<D>(dk_acc, ds_f, qt_s, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  const long long off = (static_cast<long long>(b) * Sk + k0) * H + h;
  store_frags<D>(dk + off * D, static_cast<long long>(H) * D, dk_acc, scale, row0, n_keys, lane);
  store_frags<D>(dv + off * D, static_cast<long long>(H) * D, dv_acc, 1.f, row0, n_keys, lane);
}

// ---- f32: register-tiled CUDA cores -----------------------------------------

template <int D>
struct SimtCfg {
  static constexpr int kThreads = 256;
  static constexpr int kStride = D + 4;            // floats per staged row (16-byte rows)
  static constexpr int kPStride = kTile + 4;       // floats per p / ds row
  static constexpr int kColGroups = D / 4;         // 4 output columns per thread
  static constexpr int kRowGroups = kThreads / kColGroups;
  static constexpr int kR = kTile / kRowGroups;    // output rows per thread (D / 16)
  static constexpr size_t kTileBytes = kTile * kStride * sizeof(float);
  static constexpr size_t kPBytes = kTile * kPStride * sizeof(float);
  // Two resident thread blocks per SM up to D 64 (registers capped at 128
  // a thread): each block keeps one swept tile in flight, and its copy
  // overlaps the other block's products.
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

// This thread's 4 x 4 blocks of s = a . b^T and dp = da . db^T over two
// 64-row tiles (rows tr + 16 i of a, da; rows tc + 16 c of b, db), summed
// over D in order, read as float4.
template <int D>
__device__ __forceinline__ void simt_scores(const float* a_s, const float* b_s,
                                            const float* da_s, const float* db_s, int tr,
                                            int tc, float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int ST = SimtCfg<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], da[4], bb[4], db[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a_s + (tr + 16 * i) * ST + d);
      da[i] = *reinterpret_cast<const float4*>(da_s + (tr + 16 * i) * ST + d);
      bb[i] = *reinterpret_cast<const float4*>(b_s + (tc + 16 * i) * ST + d);
      db[i] = *reinterpret_cast<const float4*>(db_s + (tc + 16 * i) * ST + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = fmaf(a[i].x, bb[c].x, s[i][c]);
        s[i][c] = fmaf(a[i].y, bb[c].y, s[i][c]);
        s[i][c] = fmaf(a[i].z, bb[c].z, s[i][c]);
        s[i][c] = fmaf(a[i].w, bb[c].w, s[i][c]);
        dp[i][c] = fmaf(da[i].x, db[c].x, dp[i][c]);
        dp[i][c] = fmaf(da[i].y, db[c].y, dp[i][c]);
        dp[i][c] = fmaf(da[i].z, db[c].z, dp[i][c]);
        dp[i][c] = fmaf(da[i].w, db[c].w, dp[i][c]);
      }
  }
}

// This thread's 4 x 4 block of s (query rows q0 + tr + 16 i, keys
// k0 + tc + 16 c) becomes p in place; a fully attended tile skips the
// per-pair tests. lse2_s is the tile's base-2 lse by query row, kvalid_s
// its key validity.
template <int D>
__device__ __forceinline__ void simt_p(float (&s)[4][4], float scale2, const float* lse2_s,
                                       const int* kvalid_s, int q0, int k0, int tr, int tc,
                                       bool full, int causal, int window) {
  if (full) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = p_of(s[i][c], scale2, lse2_s[tr + 16 * i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[i][c] = recompute_p(s[i][c], scale2, lse2_s[tr + 16 * i],
                              kvalid_s[tc + 16 * c] != 0, q0 + tr + 16 * i,
                              k0 + tc + 16 * c, causal, window);
  }
}

// kR consecutive floats of a p / ds row, as float4 where there are four.
template <int R>
__device__ __forceinline__ void load_run(float (&w)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      w[i] = x.x, w[i + 1] = x.y, w[i + 2] = x.z, w[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = p[i];
  }
}

// acc[i][:] += w[i] * x[0..3] for this thread's kR rows and 4 columns.
template <int R>
__device__ __forceinline__ void fma_block(float (&acc)[R][4], const float (&w)[R], float4 x) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i][0] = fmaf(w[i], x.x, acc[i][0]);
    acc[i][1] = fmaf(w[i], x.y, acc[i][1]);
    acc[i][2] = fmaf(w[i], x.z, acc[i][2]);
    acc[i][3] = fmaf(w[i], x.w, acc[i][3]);
  }
}

template <int R>
__device__ __forceinline__ void store_block(float* out, long long row_stride,
                                            const float (&acc)[R][4], float mul, int r0,
                                            int n_rows) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i < n_rows)
      *reinterpret_cast<float4*>(out + (r0 + i) * row_stride) =
          make_float4(acc[i][0] * mul, acc[i][1] * mul, acc[i][2] * mul, acc[i][3] * mul);
}

template <int D>
__device__ __forceinline__ void dq_simt(const float* q, const float* k, const float* v,
                                        const int* mask, const float* dout, const float* lse,
                                        const float* delta, float* dq, int Sq, int Sk, int H,
                                        Strides qs, Strides ks, Strides vs, Strides dos,
                                        int causal, int window, float scale, int tile, int h,
                                        int b, unsigned char* smem) {
  using C = SimtCfg<D>;
  constexpr int ST = C::kStride, PT = C::kPStride, R = C::kR;
  const int tid = threadIdx.x;
  const int q0 = tile * kTile;
  const int n_rows = min(kTile, Sq - q0);

  float* q_s = reinterpret_cast<float*>(smem);   // [kTile][ST]
  float* do_s = q_s + kTile * ST;                // [kTile][ST]
  float* k_s = do_s + kTile * ST;                // [kTile][ST]
  float* v_s = k_s + kTile * ST;                 // [kTile][ST]
  float* dst_s = v_s + kTile * ST;               // ds^T: [kTile keys][PT]
  float* lse_s = dst_s + kTile * PT;             // [kTile]
  float* delta_s = lse_s + kTile;                // [kTile]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const Range kt = key_tiles(q0, n_rows, Sk, kTile, causal, window);
  const int n_tiles = max(0, kt.end - kt.begin);

  stage_async<float, D, kTile, ST, C::kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  stage_async<float, D, kTile, ST, C::kThreads>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0,
                                                Sq, tid);
  stage_rows<kTile>(lse_s, delta_s, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0,
                    n_rows, tid);
  auto stage_key_tile = [&](int k0) {
    stage_async<float, D, kTile, ST, C::kThreads>(k_s, kb, ks.s, k0, Sk, tid);
    stage_async<float, D, kTile, ST, C::kThreads>(v_s, vb, vs.s, k0, Sk, tid);
    stage_keys<kTile>(kvalid_s, mb, k0, Sk, tid);
  };
  stage_key_tile(kt.begin * kTile);
  cp_async_commit();

  const int tr = tid / 16, tc = tid % 16;                 // score block
  const int rg = tid / C::kColGroups, cg = tid % C::kColGroups;  // output block
  const float scale2 = scale * kLog2e;
  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt.begin + it) * kTile;
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4], dp[4][4];
    simt_scores<D>(q_s, k_s, do_s, v_s, tr, tc, s, dp);
    simt_p<D>(s, scale2, lse_s, kvalid_s, q0, k0, tr, tc,
              all_attended(q0, kTile, k0, kTile, Sq, Sk, mask, causal, window), causal,
              window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst_s[(tc + 16 * c) * PT + tr + 16 * i] =
            s[i][c] * (dp[i][c] - delta_s[tr + 16 * i]);
    __syncthreads();

    // dq[rows] += ds[rows, c] k[c, cols] over the tile's keys c.
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float w[R];
      load_run<R>(w, dst_s + c * PT + rg * R);
      fma_block<R>(acc, w, *reinterpret_cast<const float4*>(k_s + c * ST + cg * 4));
    }
    __syncthreads();  // this tile's buffers are refilled next
    if (it + 1 < n_tiles) {
      stage_key_tile(k0 + kTile);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (a sweep of no tiles)

  store_block<R>(dq + ((static_cast<long long>(b) * Sq + q0) * H + h) * D + cg * 4,
                 static_cast<long long>(H) * D, acc, scale, rg * R, n_rows);
}

template <int D>
__device__ __forceinline__ void dkv_simt(const float* q, const float* k, const float* v,
                                         const int* mask, const float* dout, const float* lse,
                                         const float* delta, float* dk, float* dv, int Sq,
                                         int Sk, int H, Strides qs, Strides ks, Strides vs,
                                         Strides dos, int causal, int window, float scale,
                                         int tile, int h, int b, unsigned char* smem) {
  using C = SimtCfg<D>;
  constexpr int ST = C::kStride, PT = C::kPStride, R = C::kR;
  const int tid = threadIdx.x;
  const int k0 = tile * kTile;
  const int n_keys = min(kTile, Sk - k0);

  float* k_s = reinterpret_cast<float*>(smem);   // [kTile][ST]
  float* v_s = k_s + kTile * ST;                 // [kTile][ST]
  float* q_s = v_s + kTile * ST;                 // [kTile][ST]
  float* do_s = q_s + kTile * ST;                // [kTile][ST]
  float* p_s = do_s + kTile * ST;                // [kTile queries][PT]
  float* ds_s = p_s + kTile * PT;                // [kTile queries][PT]
  float* lse_s = ds_s + kTile * PT;              // [kTile]
  float* delta_s = lse_s + kTile;                // [kTile]
  int* kvalid_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
  const Range qt = query_tiles(k0, n_keys, Sq, kTile, causal, window);
  const int n_tiles = max(0, qt.end - qt.begin);

  auto stage_query_tile = [&](int q0) {
    stage_async<float, D, kTile, ST, C::kThreads>(q_s, qb, qs.s, q0, Sq, tid);
    stage_async<float, D, kTile, ST, C::kThreads>(do_s, dob, dos.s, q0, Sq, tid);
    stage_rows<kTile>(lse_s, delta_s, lse, delta, rows + q0, Sq - q0, tid);
  };
  stage_async<float, D, kTile, ST, C::kThreads>(k_s, k + b * ks.b + h * ks.h, ks.s, k0, Sk,
                                                tid);
  stage_async<float, D, kTile, ST, C::kThreads>(v_s, v + b * vs.b + h * vs.h, vs.s, k0, Sk,
                                                tid);
  stage_keys<kTile>(kvalid_s, mb, k0, Sk, tid);
  stage_query_tile(qt.begin * kTile);
  cp_async_commit();

  const int tr = tid / 16, tc = tid % 16;
  const int rg = tid / C::kColGroups, cg = tid % C::kColGroups;
  const float scale2 = scale * kLog2e;
  float dk_acc[R][4], dv_acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (qt.begin + it) * kTile;
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4], dp[4][4];
    simt_scores<D>(q_s, k_s, do_s, v_s, tr, tc, s, dp);
    simt_p<D>(s, scale2, lse_s, kvalid_s, q0, k0, tr, tc,
              all_attended(q0, kTile, k0, kTile, Sq, Sk, mask, causal, window), causal,
              window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tc + 16 * c;
        p_s[r * PT + col] = s[i][c];
        ds_s[r * PT + col] = s[i][c] * (dp[i][c] - delta_s[r]);
      }
    }
    __syncthreads();

    // dv[keys] += p[r, keys]^T do[r, cols]; dk[keys] += ds[r, keys]^T q[r, cols].
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pw[R], dw[R];
      load_run<R>(pw, p_s + r * PT + rg * R);
      load_run<R>(dw, ds_s + r * PT + rg * R);
      fma_block<R>(dv_acc, pw, *reinterpret_cast<const float4*>(do_s + r * ST + cg * 4));
      fma_block<R>(dk_acc, dw, *reinterpret_cast<const float4*>(q_s + r * ST + cg * 4));
    }
    __syncthreads();  // this tile's buffers are refilled next
    if (it + 1 < n_tiles) {
      stage_query_tile(q0 + kTile);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (a sweep of no tiles)

  const long long off = ((static_cast<long long>(b) * Sk + k0) * H + h) * D + cg * 4;
  store_block<R>(dk + off, static_cast<long long>(H) * D, dk_acc, scale, rg * R, n_keys);
  store_block<R>(dv + off, static_cast<long long>(H) * D, dv_acc, 1.f, rg * R, n_keys);
}

// ---- the kernels --------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int threads_for() {
  return std::is_same<T, bf16>::value ? 128 : 256;
}

// Thread blocks each SM must hold at once: the registers a thread may use
// follow from it (f32 up to D 64: two, so 128 registers).
template <typename T, int D>
__host__ __device__ constexpr int min_blocks() {
  if constexpr (std::is_same<T, bf16>::value)
    return 1;
  else
    return SimtCfg<D>::kMinBlocks;
}

template <typename T, int D>
__global__ void __launch_bounds__(threads_for<T>(), min_blocks<T, D>())
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ mask,
                              const T* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                              int Sk, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                              int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = gridDim.z - 1 - blockIdx.z;  // the longest causal sweeps first
  if constexpr (std::is_same<T, bf16>::value)
    dq_mma<D>(q, k, v, mask, dout, lse, delta, dq, Sq, Sk, H, qs, ks, vs, dos, causal, window,
              scale, tile, blockIdx.x, blockIdx.y, smem);
  else
    dq_simt<D>(q, k, v, mask, dout, lse, delta, dq, Sq, Sk, H, qs, ks, vs, dos, causal,
               window, scale, tile, blockIdx.x, blockIdx.y, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(threads_for<T>(), min_blocks<T, D>())
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int* __restrict__ mask,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dk,
                               T* __restrict__ dv, int Sq, int Sk, int H, Strides qs,
                               Strides ks, Strides vs, Strides dos, int causal, int window,
                               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.z;  // under causal the first key tiles sweep longest
  if constexpr (std::is_same<T, bf16>::value)
    dkv_mma<D>(q, k, v, mask, dout, lse, delta, dk, dv, Sq, Sk, H, qs, ks, vs, dos, causal,
               window, scale, tile, blockIdx.x, blockIdx.y, smem);
  else
    dkv_simt<D>(q, k, v, mask, dout, lse, delta, dk, dv, Sq, Sk, H, qs, ks, vs, dos, causal,
                window, scale, tile, blockIdx.x, blockIdx.y, smem);
}

// Bytes of dynamic shared memory, laid out as the kernels carve it.
template <typename T, int D, bool kDq>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) {
    using C = MmaCfg<D>;
    return C::kOwnBytes + C::kSweptBytes +
           (kDq ? 2 * kTile * sizeof(float) + 2 * C::kBN * sizeof(int)
                : 2 * 2 * C::kBN * sizeof(float) + kTile * sizeof(int));
  } else {
    using C = SimtCfg<D>;
    return 4 * C::kTileBytes + (kDq ? 1 : 2) * C::kPBytes + 2 * kTile * sizeof(float) +
           kTile * sizeof(int);
  }
}
// A thread block may use 227 KB; an SM holds 228 KB, 1 KB of it reserved
// per resident thread block.
static_assert(smem_bytes<float, 128, true>() <= 232448 &&
                  smem_bytes<float, 128, false>() <= 232448,
              "f32 tiles at D 128 fit in a thread block's shared memory");
static_assert(2 * (smem_bytes<float, 64, true>() + 1024) <= 233472 &&
                  2 * (smem_bytes<float, 64, false>() + 1024) <= 233472,
              "two f32 thread blocks at D 64 fit on an SM");

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *g0, *g1;  // dq; or dk, dv
  int B, Sq, Sk, H;
  Strides qs, ks, vs, dos;
  int causal, window;
  float scale;
};

template <typename T, int D, bool kDq>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_tiles = ((kDq ? a.Sq : a.Sk) + kTile - 1) / kTile;
  const dim3 grid(a.H, a.B, n_tiles);
  constexpr size_t smem = smem_bytes<T, D, kDq>();
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* mask = static_cast<const int*>(a.mask);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (kDq) {
    auto kernel = flash_attention_bwd_dq_kernel<T, D>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, threads_for<T>(), smem, stream>>>(
        q, k, v, mask, dout, lse, delta, static_cast<T*>(a.g0), a.Sq, a.Sk, a.H, a.qs, a.ks,
        a.vs, a.dos, a.causal, a.window, a.scale);
  } else {
    auto kernel = flash_attention_bwd_dkv_kernel<T, D>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, threads_for<T>(), smem, stream>>>(
        q, k, v, mask, dout, lse, delta, static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.Sq,
        a.Sk, a.H, a.qs, a.ks, a.vs, a.dos, a.causal, a.window, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16, kDq>(a, stream);
    case 32:  return launch<T, 32, kDq>(a, stream);
    case 64:  return launch<T, 64, kDq>(a, stream);
    case 128: return launch<T, 128, kDq>(a, stream);
    default:  return cudaErrorInvalidValue;
  }
}

// The 16-byte copies need every row of q, k, v and do 16-byte aligned.
bool rows_aligned(const Args& a, size_t item) {
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const Strides& s : {a.qs, a.ks, a.vs, a.dos})
    for (long long x : {s.b, s.s, s.h})
      if (x * static_cast<long long>(item) % 16 != 0) return false;
  return true;
}

template <bool kDq>
int dispatch(const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0 || a.B > 65535 ||
      (a.Sq + kTile - 1) / kTile > 65535 || (a.Sk + kTile - 1) / kTile > 65535 ||
      a.window < 0 || (a.window > 0 && !a.causal))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && rows_aligned(a, sizeof(float))) return dispatch_d<float, kDq>(a, D, s);
  if (dtype == 1 && rows_aligned(a, sizeof(bf16))) return dispatch_d<bf16, kDq>(a, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients alike).
// window: 0 = no sliding window, else >= 1 (causal only). mask may be null.
// Strides are the (b, s, h) element strides of q, k, v and do; the pointers
// and strides must keep every row 16-byte aligned. Each returns the launch's
// cudaError_t (0 = success); the caller checks it, since a refused launch
// never runs.
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
