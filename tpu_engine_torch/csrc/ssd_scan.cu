// The state_slab family's window recurrence for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package serves the recurrent family
// through `models/ssd.py` `ssd_window_scan`, a `lax.scan` over a window's
// tokens that XLA compiles into one device loop per dispatch. Eager PyTorch
// has no such loop, and a Python loop over the window would issue W x layers
// x about 15 small launches per dispatch. This kernel is one layer's masked
// window recurrence, everything of the mixer between its two dense products
// (`_mixer_step` in the JAX package), in one launch.
//
// Contract, exactly that of `ssd_scan_reference` in
// tpu_engine_torch/ops/ssd.py:
//
//   proj (B, W, 2*di + 2*N + H) f32, the layer's in_proj output per slot as
//   [z | x | B | C | dt]; state (R, state_dim) f32, one flat row per stream
//   (the conv tail (K-1, di) then the SSM state (H, P, N), P = di / H), the
//   slab's layer slice or a gathered batch; row_ids (B,) int32 rows of
//   `state`; qlen (B,) int32; conv_w (K, di), conv_b (di,), dt_bias (H,),
//   A_log (H,), D (H,) f32  ->  y (B, W, di) f32, and the rows' states
//   advanced in place. For each row r and slot j < qlen[r], in order:
//     xc    = silu(sum_k window[k] * conv_w[k] + conv_b), window = the
//             cached tail's K-1 inputs then this slot's x;
//     dtp   = softplus(dt + dt_bias) = log1p(exp(-|v|)) + max(v, 0);
//     s     = s * exp(dtp * A) + (dtp * xc) * B,   A = -exp(A_log);
//     y     = (C . s + D * xc) * silu(z);
//     tail  = the last K-1 inputs x (pre-activation).
//   Slots j >= qlen[r] give y = 0. A row with qlen 0 (a done or parked
//   row, the null row 0) reads and writes no state: its bits stay as they
//   are.
//
// Partition invariance, the property the serving path's byte identity
// rests on: each slot's arithmetic is the same instructions on the same
// values whatever W is and wherever the row sits in the batch, so a window
// of W slots in one launch gives the bits of W launches of one slot. No
// fast-math intrinsics (expf, log1pf, not __expf), fixed reduction orders,
// no atomics: two runs give the same bits.
//
// What bounds it on an H100: device-memory bytes. Per (row, head) the
// state (P x N f32) and the tail are read once and written once, and each
// valid slot's projections are read once; a decode tick at B 8 of the
// mamba2 geometry (H 24, P 64, N 64) moves 3.1 MB of state each way per
// layer, about 1.9 us at 3.35 TB/s, against a few flops per state value.
// A long window is bounded instead by its sequential chain of slots.
//
// Design (simple and right first):
// - one thread block per (head, row): 8 rows x 24 heads = 192 blocks at
//   B 8;
// - P x `lanes` threads, `lanes` the power of two that splits a channel's
//   N state values 16 to a thread (4 at N 64: 256 threads); each thread
//   keeps its 16 state values, its channel's K-1 tail values and K conv
//   weights in registers for the whole window;
// - a loop over the window's slots, each slot's projections loaded one
//   slot ahead of its use (the loads of slot j+1 are in flight while slot
//   j computes);
// - the readout C . s sums each thread's 16 products in order, then a
//   fixed xor-shuffle order over the channel's lanes, so every lane holds
//   the same bits and lane 0 writes y.

#include <cuda_runtime.h>

namespace {

constexpr int kPerThread = 16;   // state values a thread holds
constexpr int kMaxConv = 8;      // the conv window K, at most
constexpr int kMaxThreads = 256; // a block's threads, at most

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

// One slot's projections as one thread needs them: x and z of its channel,
// dt of its head, and B and C of its 16 state columns.
#define SSD_LOAD_SLOT(pj, X, Z, DT, BV, CV)                        \
  do {                                                             \
    X = act ? (pj)[di + d] : 0.0f;                                 \
    Z = act ? (pj)[d] : 0.0f;                                      \
    DT = (pj)[2 * di + 2 * N + h];                                 \
    _Pragma("unroll") for (int i = 0; i < kPerThread; ++i) {       \
      BV[i] = i < nv ? (pj)[2 * di + n0 + i] : 0.0f;               \
      CV[i] = i < nv ? (pj)[2 * di + N + n0 + i] : 0.0f;           \
    }                                                              \
  } while (0)

__global__ void __launch_bounds__(kMaxThreads)
    ssd_scan_kernel(const float* __restrict__ proj, float* __restrict__ state,
                    const int* __restrict__ row_ids, const int* __restrict__ qlen,
                    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
                    const float* __restrict__ dt_bias, const float* __restrict__ A_log,
                    const float* __restrict__ D, float* __restrict__ y, int W, int di, int N,
                    int H, int K, int state_dim, int lanes) {
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int P = di / H;
  const int p = threadIdx.x / lanes;
  const int q = threadIdx.x % lanes;
  // Threads past the head's P channels (the block is whole warps) hold
  // zeros and take part in the shuffles only.
  const bool act = p < P;
  const int d = h * P + (act ? p : 0);
  const int n0 = q * kPerThread;
  const int nv = act ? max(0, min(kPerThread, N - n0)) : 0;
  const bool writer = act && q == 0;
  const int ql = min(qlen[r], W);
  const size_t pw = 2 * static_cast<size_t>(di) + 2 * N + H;
  const float* pr = proj + static_cast<size_t>(r) * W * pw;
  float* yr = y + static_cast<size_t>(r) * W * di;
  if (writer) {
    for (int j = max(ql, 0); j < W; ++j) yr[static_cast<size_t>(j) * di + d] = 0.0f;
  }
  if (ql <= 0) return;  // the row's state is not touched

  float* srow = state + static_cast<size_t>(row_ids[r]) * state_dim;
  float* ssm = srow + static_cast<size_t>(K - 1) * di + (static_cast<size_t>(h) * P + p) * N + n0;
  float s[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) s[i] = i < nv ? ssm[i] : 0.0f;
  float tail[kMaxConv - 1];
  float w[kMaxConv];
#pragma unroll
  for (int k = 0; k < kMaxConv - 1; ++k)
    tail[k] = (act && k < K - 1) ? srow[static_cast<size_t>(k) * di + d] : 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxConv; ++k) w[k] = (act && k < K) ? conv_w[static_cast<size_t>(k) * di + d] : 0.0f;
  const float cb = act ? conv_b[d] : 0.0f;
  const float dh = D[h];
  const float A = -expf(A_log[h]);
  const float dtb = dt_bias[h];

  // This slot's projections, and the next slot's, loaded while this one
  // computes.
  float x, z, dt, bv[kPerThread], cv[kPerThread];
  float nx = 0.0f, nz = 0.0f, ndt = 0.0f, nb[kPerThread] = {}, nc[kPerThread] = {};
  SSD_LOAD_SLOT(pr, x, z, dt, bv, cv);
  for (int j = 0; j < ql; ++j) {
    if (j + 1 < ql) SSD_LOAD_SLOT(pr + (j + 1) * pw, nx, nz, ndt, nb, nc);
    // The depthwise conv over the cached tail and this slot's input, in
    // window order.
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k) {
      if (k < K) acc += (k < K - 1 ? tail[k] : x) * w[k];
    }
    const float xc = silu(acc + cb);
#pragma unroll
    for (int k = 0; k < kMaxConv - 1; ++k) {
      if (k < K - 2) tail[k] = tail[k + 1];
      else if (k == K - 2) tail[k] = x;
    }
    const float dtp = softplus(dt + dtb);
    const float dA = expf(dtp * A);
    const float dx = dtp * xc;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (i < nv) {
        s[i] = s[i] * dA + dx * bv[i];
        part += s[i] * cv[i];
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (writer) yr[static_cast<size_t>(j) * di + d] = (part + dh * xc) * silu(z);
    x = nx;
    z = nz;
    dt = ndt;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      bv[i] = nb[i];
      cv[i] = nc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (i < nv) ssm[i] = s[i];
  }
  if (writer) {
#pragma unroll
    for (int k = 0; k < kMaxConv - 1; ++k) {
      if (k < K - 1) srow[static_cast<size_t>(k) * di + d] = tail[k];
    }
  }
}

}  // namespace

extern "C" {

// B rows, W slots; di, N, H, K as in the contract above; state_dim the
// flat row's length ((K-1)*di + di*N), the stride between rows of `state`.
// di must divide by H, 2 <= K <= 8, and a (head, row) block's threads, P
// times the lanes that split N 16 to a thread, rounded to whole warps, at
// most 256. Returns the launch's cudaError_t (0 = success).
int ssd_scan(const void* proj, void* state, const void* row_ids, const void* qlen,
             const void* conv_w, const void* conv_b, const void* dt_bias, const void* A_log,
             const void* D, void* y, int B, int W, int di, int N, int H, int K, int state_dim,
             void* stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  if (H <= 0 || N <= 0 || di % H != 0 || K < 2 || K > kMaxConv) return cudaErrorInvalidValue;
  if (B > 65535) return cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes * kPerThread < N) lanes *= 2;
  if (lanes > 32) return cudaErrorInvalidValue;
  const int threads = ((di / H) * lanes + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  ssd_scan_kernel<<<dim3(H, B), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proj), static_cast<float*>(state),
      static_cast<const int*>(row_ids), static_cast<const int*>(qlen),
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<float*>(y), W, di, N, H, K, state_dim, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
