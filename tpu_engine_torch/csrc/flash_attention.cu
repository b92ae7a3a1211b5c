// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++, in two
// designs: bf16 on the tensor cores, f32 register-tiled on the CUDA cores.
//
// Replaces the TPU kernel `_flash_kernel` of tpu_engine/ops/flash.py (its
// pallas_call sits in `_flash_fwd_call`, public wrapper `flash_attention`).
// The contract is that of `flash_attention_reference` in
// tpu_engine_torch/ops/flash.py:
//
//   q (B, Sq, H, D); k, v (B, Sk, H, D), f32 or bf16, read through their
//   (b, s, h) element strides (the last dimension contiguous, every row
//   16-byte aligned: the caller copies a tensor that is not); mask (B, Sk)
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
// against 4 * S * D elements of q, k, v and out per head: at S 2048, D 64
// that is ~500 flops per byte in bf16, above the card's ~295, so the tensor
// cores' rate (989 TFLOP/s) is the roof; in f32, which keeps TF32 off so
// its products stay f32, the CUDA cores' (67 TFLOP/s).
//
// Design, for this card (the TPU blocks are not carried over):
// - Each thread block owns one 64-row query tile and loops over the key
//   tiles the TPU kernel visits (tiles wholly above the causal diagonal or
//   below a sliding window's band are skipped, its `pl.when`), keeping the
//   online softmax in registers: nothing carries over between thread
//   blocks. The grid is (head, batch, tile), tiles last-first: under causal
//   the longest sweeps start first. Operands are read in place through
//   their strides; ragged tails are zero-filled by the copies and masked.
// - Tiles move with 16-byte cp.async copies; a tile wholly attended (full,
//   no padding mask, on or below the diagonal, inside the band) skips the
//   per-pair masks; p is exp2 of a base-2 score (scale times log2 e).
// - bf16 (mma.sync m16n8k16 bf16 -> f32, the helpers of mma_common.cuh): 4
//   warps, each owning 16 query rows, its Q fragments held in registers for
//   the sweep. K and V tiles (64 keys; 32 at D 128, for registers) are
//   double-buffered in shared memory (rows padded 16 bytes) and enter as B
//   operands through ldmatrix (K) and ldmatrix.trans (V). S = Q K^T stays in
//   the accumulators, where each thread holds two rows: their maximum and
//   sum reduce over the row's four lanes by shuffles; p is rounded to bf16
//   and repacked in registers from the accumulator layout into the A
//   operand of O += P V. Nothing of S or P goes to shared memory.
// - f32 (register-tiled CUDA cores): 256 threads; thread (r, c) computes a
//   4 x 4 block of the 64 x 64 score tile (rows r + 16 i, keys c + 16 j)
//   from float4 reads, and owns the same 4 rows of the output, D / 16
//   columns each. The 16 threads of a row set are one half warp: the row
//   maximum reduces over it by shuffles, the sums stay per thread until
//   the end, and p crosses to the output's layout through a shared-memory
//   tile that the half warp alone writes and reads (a warp barrier, no
//   block barrier). Up to D 64 two thread blocks share an SM (registers
//   capped at 128 a thread), each with one key tile in flight: a block's
//   copy overlaps the other block's products.
//
// Left to later work: wgmma tiles fed by TMA with warp-specialised
// producers, a persistent schedule over the causal tiles, and reading
// grouped K/V without the caller's repeat_kv.
//
// Build: tpu_engine_torch/ops/kernels.py compiles every source of this
//        directory with nvcc -gencode arch=compute_90a,code=sm_90a at first
//        use, links one library and loads it with ctypes.

#include "flash_common.cuh"
#include "mma_common.cuh"

#include <type_traits>

namespace {

constexpr int kTile = 64;  // query rows per thread block, both types

// Whether (qpos, kpos) is attended under the causal and window masks.
__device__ __forceinline__ bool in_band(int qpos, int kpos, int causal, int window) {
  return !causal || (kpos <= qpos && (window == 0 || qpos - kpos < window));
}

// lse in natural units from the base-2 running maximum and the row sum.
__device__ __forceinline__ float lse_of(float m2, float l) {
  return l > 0.f ? m2 / kLog2e + logf(l) : -INFINITY;
}

// ---- bf16: tensor cores -------------------------------------------------------

template <int D>
struct MmaCfg {
  static constexpr int kThreads = 128;              // 4 warps x 16 query rows
  static constexpr int kBN = D == 128 ? 32 : 64;    // keys per tile
  static constexpr int kStride = D + 8;             // bf16 elements per staged row
  static constexpr int kKD = D / 16;                // k16 steps over D
  static constexpr int kND = D / 8;                 // n8 tiles over D
  static constexpr int kNB = kBN / 8;               // n8 tiles over the key tile
  static constexpr int kKB = kBN / 16;              // k16 steps over the key tile
  static constexpr size_t kSmem = (kTile + 4 * kBN) * kStride * sizeof(bf16) +
                                  2 * kBN * sizeof(int);
};

template <int D>
__device__ __forceinline__ void fwd_mma(const bf16* q, const bf16* k, const bf16* v,
                                        const int* mask, bf16* out, float* lse, int Sq,
                                        int Sk, int H, Strides qs, Strides ks, Strides vs,
                                        int causal, int window, float scale, int tile, int h,
                                        int b, unsigned char* smem) {
  using C = MmaCfg<D>;
  constexpr int BN = C::kBN, ST = C::kStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = tile * kTile;
  const int n_rows = min(kTile, Sq - q0);

  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [kTile][ST]
  bf16* k_s = q_s + kTile * ST;                       // [2][BN][ST]
  bf16* v_s = k_s + 2 * BN * ST;                      // [2][BN][ST]
  int* kvalid_s = reinterpret_cast<int*>(v_s + 2 * BN * ST);  // [2][BN]

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const Range kt = key_tiles(q0, n_rows, Sk, BN, causal, window);
  const int n_tiles = max(0, kt.end - kt.begin);

  stage_async<bf16, D, kTile, ST, C::kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  stage_async<bf16, D, BN, ST, C::kThreads>(k_s, kb, ks.s, kt.begin * BN, Sk, tid);
  stage_async<bf16, D, BN, ST, C::kThreads>(v_s, vb, vs.s, kt.begin * BN, Sk, tid);
  stage_keys<BN>(kvalid_s, mb, kt.begin * BN, Sk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16;
  unsigned q_f[C::kKD][4];
#pragma unroll
  for (int kk = 0; kk < C::kKD; ++kk) ldsm_x4(q_f[kk], frag_a<ST>(q_s, row0, kk * 16, lane));
  const int qpos[2] = {q0 + row0 + g, q0 + row0 + g + 8};
  const float scale2 = scale * kLog2e;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns
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
    const bf16* vt_s = v_s + buf * BN * ST;
    const int* kv_s = kvalid_s + buf * BN;

    // S = Q K^T for this warp's 16 rows, in base 2.
    float s[C::kNB][4];
#pragma unroll
    for (int n = 0; n < C::kNB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::kKD; ++kk)
#pragma unroll
      for (int np = 0; np < C::kNB / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, frag_bt<ST>(kt_s, np * 16, kk * 16, lane));
        mma_16816(s[2 * np], q_f[kk], bk[0], bk[1]);
        mma_16816(s[2 * np + 1], q_f[kk], bk[2], bk[3]);
      }
    if (all_attended(q0, kTile, k0, BN, Sq, Sk, mask, causal, window)) {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    } else {
#pragma unroll
      for (int n = 0; n < C::kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const bool keep = kv_s[col] != 0 && in_band(qpos[e >> 1], k0 + col, causal, window);
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
    for (int kb2 = 0; kb2 < C::kKB; ++kb2)
#pragma unroll
      for (int dp = 0; dp < C::kND / 2; ++dp) {
        unsigned bv[4];
        ldsm_x4_trans(bv, frag_a<ST>(vt_s, kb2 * 16, dp * 16, lane));
        mma_16816(acc[2 * dp], p_f[kb2], bv[0], bv[1]);
        mma_16816(acc[2 * dp + 1], p_f[kb2], bv[2], bv[3]);
      }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block (a sweep of no tiles)

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    const int r = row0 + g + 8 * hi;
    if (r >= n_rows) continue;
    const float inv = l[hi] > 0.f ? 1.f / l[hi] : 0.f;
    bf16* o = out + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < C::kND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * hi] * inv, acc[n][2 * hi + 1] * inv);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + q0 + r] = lse_of(m[hi], l[hi]);
  }
}

// ---- f32: register-tiled CUDA cores -------------------------------------------

template <int D>
struct SimtCfg {
  static constexpr int kThreads = 256;
  static constexpr int kStride = D + 4;            // floats per staged row (16-byte rows)
  static constexpr int kPStride = kTile + 4;       // floats per p row
  static constexpr int kOC = D / 16;               // output columns per thread
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static constexpr size_t kSmem =
      (3 * kTile * kStride + kTile * kPStride) * sizeof(float) + kTile * sizeof(int);
};

// OC consecutive floats at p (shared or global), as float4 where there are four.
template <int OC>
__device__ __forceinline__ void load_cols(float (&x)[OC], const float* p) {
  if constexpr (OC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < OC; i += 4) {
      const float4 y = *reinterpret_cast<const float4*>(p + i);
      x[i] = y.x, x[i + 1] = y.y, x[i + 2] = y.z, x[i + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < OC; ++i) x[i] = p[i];
  }
}

template <int D>
__device__ __forceinline__ void fwd_simt(const float* q, const float* k, const float* v,
                                         const int* mask, float* out, float* lse, int Sq,
                                         int Sk, int H, Strides qs, Strides ks, Strides vs,
                                         int causal, int window, float scale, int tile, int h,
                                         int b, unsigned char* smem) {
  using C = SimtCfg<D>;
  constexpr int ST = C::kStride, PT = C::kPStride, OC = C::kOC;
  const int tid = threadIdx.x;
  const int q0 = tile * kTile;
  const int n_rows = min(kTile, Sq - q0);

  float* q_s = reinterpret_cast<float*>(smem);   // [kTile][ST]
  float* k_s = q_s + kTile * ST;                 // [kTile][ST]
  float* v_s = k_s + kTile * ST;                 // [kTile][ST]
  float* p_s = v_s + kTile * ST;                 // [kTile][PT]
  int* kvalid_s = reinterpret_cast<int*>(p_s + kTile * PT);  // [kTile]

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const Range kt = key_tiles(q0, n_rows, Sk, kTile, causal, window);
  const int n_tiles = max(0, kt.end - kt.begin);

  stage_async<float, D, kTile, ST, C::kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  auto stage_key_tile = [&](int k0) {
    stage_async<float, D, kTile, ST, C::kThreads>(k_s, kb, ks.s, k0, Sk, tid);
    stage_async<float, D, kTile, ST, C::kThreads>(v_s, vb, vs.s, k0, Sk, tid);
    stage_keys<kTile>(kvalid_s, mb, k0, Sk, tid);
  };
  stage_key_tile(kt.begin * kTile);
  cp_async_commit();

  // Scores: rows tr + 16 i, keys tc + 16 j; output: rows tr + 16 i,
  // columns tc * OC ... The 16 threads of one tr are one half warp.
  const int tr = tid / 16, tc = tid % 16;
  const float scale2 = scale * kLog2e;
  float m[4], l[4], acc[4][OC];                  // l: this thread's columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY, l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt.begin + it) * kTile;
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(q_s + (tr + 16 * i) * ST + d);
        bb[i] = *reinterpret_cast<const float4*>(k_s + (tc + 16 * i) * ST + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(a[i].x, bb[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, bb[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, bb[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, bb[c].w, s[i][c]);
        }
    }
    if (all_attended(q0, kTile, k0, kTile, Sq, Sk, mask, causal, window)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] *= scale2;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tc + 16 * c;
          const bool keep = kvalid_s[col] != 0 &&
                            in_band(q0 + tr + 16 * i, k0 + col, causal, window);
          s[i][c] = keep ? s[i][c] * scale2 : -INFINITY;
        }
    }

    // Online softmax: the row maximum over the half warp; p to shared
    // memory for the half warp's own output rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const Rescale rs = rescale(m[i], mt);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - rs.m_use);
        ps += p;
        p_s[(tr + 16 * i) * PT + tc + 16 * c] = p;
      }
      l[i] = l[i] * rs.corr + ps;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= rs.corr;
    }
    __syncwarp();

    // O[rows, cols] += p[rows, keys] v[keys, cols], four keys at a time.
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (tr + 16 * i) * PT + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[OC];
        load_cols<OC>(vv, v_s + (c + cc) * ST + tc * OC);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int o = 0; o < OC; ++o) acc[i][o] = fmaf(w, vv[o], acc[i][o]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled next
    if (it + 1 < n_tiles) {
      stage_key_tile(k0 + kTile);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (a sweep of no tiles)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int r = tr + 16 * i;
    if (r >= n_rows) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    float* o = out + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + tc * OC;
    if constexpr (OC % 4 == 0) {
#pragma unroll
      for (int c = 0; c < OC; c += 4)
        *reinterpret_cast<float4*>(o + c) = make_float4(
            acc[i][c] * inv, acc[i][c + 1] * inv, acc[i][c + 2] * inv, acc[i][c + 3] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < OC; ++c) o[c] = acc[i][c] * inv;
    }
    if (tc == 0) lse[(static_cast<long long>(b) * H + h) * Sq + q0 + r] = lse_of(m[i], lt);
  }
}

// ---- the kernel -----------------------------------------------------------------

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
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value)
    return MmaCfg<D>::kSmem;
  else
    return SimtCfg<D>::kSmem;
}
// A thread block may use 227 KB; an SM holds 228 KB, 1 KB of it reserved
// per resident thread block.
static_assert(smem_bytes<float, 128>() <= 232448, "f32 tiles at D 128 fit a thread block");
static_assert(2 * (smem_bytes<float, 64>() + 1024) <= 233472,
              "two f32 thread blocks at D 64 fit on an SM");

template <typename T, int D>
__global__ void __launch_bounds__(threads_for<T>(), min_blocks<T, D>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ mask,
                       T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                       Strides qs, Strides ks, Strides vs, int causal, int window,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = gridDim.z - 1 - blockIdx.z;  // the longest causal sweeps first
  if constexpr (std::is_same<T, bf16>::value)
    fwd_mma<D>(q, k, v, mask, out, lse, Sq, Sk, H, qs, ks, vs, causal, window, scale, tile,
               blockIdx.x, blockIdx.y, smem);
  else
    fwd_simt<D>(q, k, v, mask, out, lse, Sq, Sk, H, qs, ks, vs, causal, window, scale, tile,
                blockIdx.x, blockIdx.y, smem);
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *lse;
  int B, Sq, Sk, H;
  Strides qs, ks, vs;
  int causal, window;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.H, a.B, (a.Sq + kTile - 1) / kTile);
  constexpr size_t smem = smem_bytes<T, D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads_for<T>(), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.mask), static_cast<T*>(a.out), static_cast<float*>(a.lse),
      a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(a, stream);
    case 32:  return launch<T, 32>(a, stream);
    case 64:  return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default:  return cudaErrorInvalidValue;
  }
}

// The 16-byte copies need every row of q, k and v 16-byte aligned.
bool rows_aligned(const Args& a, size_t item) {
  for (const void* p : {a.q, a.k, a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const Strides& s : {a.qs, a.ks, a.vs})
    for (long long x : {s.b, s.s, s.h})
      if (x * static_cast<long long>(item) % 16 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). window: 0 = no
// sliding window, else >= 1 (causal only). mask may be null. The pointers
// and strides must keep every row 16-byte aligned. Returns the launch's
// cudaError_t (0 = success); the caller checks it, since a refused launch
// never runs.
int flash_attention(const void* q, const void* k, const void* v, const void* mask,
                    void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || B > 65535 ||
      (Sq + kTile - 1) / kTile > 65535 || window < 0 || (window > 0 && !causal))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, mask, out, lse, B, Sq, Sk, H, {q_sb, q_ss, q_sh},
               {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && rows_aligned(a, sizeof(float))) return dispatch_d<float>(a, D, s);
  if (dtype == 1 && rows_aligned(a, sizeof(bf16))) return dispatch_d<bf16>(a, D, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
