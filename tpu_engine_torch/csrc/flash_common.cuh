// Tile bookkeeping shared by the flash forward (flash_attention.cu) and the
// flash backward (flash_attention_bwd.cu): the (b, s, h) strides a kernel
// reads its operands through, the tiles a thread block sweeps under causal
// and sliding-window masks, the test that lets a tile skip its per-pair
// masks, and the staging of a key tile's padding mask. Each translation
// unit gets its own copy (anonymous namespace).

#pragma once

#include "paged_attention_common.cuh"

namespace {

struct Strides {
  long long b, s, h;
};

// Whether the forward attended every pair of queries [q0, q0 + nq) and keys
// [k0, k0 + nk): both tiles full, no padding mask, and under causal the
// key tile wholly on or below the diagonal and inside the band. Such a
// tile (most of a long sequence's) skips the per-pair tests: every row
// there has a valid key, so its lse is finite.
__device__ __forceinline__ bool all_attended(int q0, int nq, int k0, int nk, int Sq, int Sk,
                                             const int* mask, int causal, int window) {
  if (mask != nullptr || q0 + nq > Sq || k0 + nk > Sk) return false;
  return !causal || (k0 + nk - 1 <= q0 && (window == 0 || q0 + nq - 1 - k0 < window));
}

// The swept tiles a thread block visits. The forward and dq: the key tiles of `bn` keys the
// forward visited for queries [q0, q0 + n); dk, dv: the query tiles of `bn`
// queries that reach keys [k0, k0 + n).
struct Range {
  int begin, end;
};
__device__ __forceinline__ Range key_tiles(int q0, int n, int Sk, int bn, int causal,
                                           int window) {
  int end = (Sk + bn - 1) / bn;
  if (causal) end = min(end, (q0 + n - 1) / bn + 1);
  int begin = 0;
  if (window > 0 && q0 - window + 1 > 0) begin = (q0 - window + 1) / bn;
  return {begin, end};
}
__device__ __forceinline__ Range query_tiles(int k0, int n, int Sq, int bn, int causal,
                                             int window) {
  const int nq = (Sq + bn - 1) / bn;
  Range r{0, nq};
  if (causal) {
    r.begin = k0 / bn;
    if (window > 0) r.end = min(nq, (k0 + n - 1 + window - 1) / bn + 1);
  }
  return r;
}

// Which keys [k0, k0 + ROWS) exist and pass the padding mask.
template <int ROWS>
__device__ __forceinline__ void stage_keys(int* kvalid_s, const int* mb, int k0, int Sk,
                                           int tid) {
  if (tid < ROWS) {
    const int kpos = k0 + tid;
    kvalid_s[tid] = kpos < Sk && (mb == nullptr || mb[kpos] > 0);
  }
}

}  // namespace
