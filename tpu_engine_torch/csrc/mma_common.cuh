// Tensor-core and copy helpers shared by the kernels of this directory that
// stage tiles with cp.async (the flash forward, the flash backward, the
// ragged paged reads and the decode reads) and multiply on mma.sync:
// asynchronous copies of 16, 8 and 4 bytes,
// ldmatrix fragment loads, the m16n8k16 bf16 -> f32 product, the fragment
// addresses inside a staged row-major tile, and the online-softmax step.
// Each translation unit gets its own copy (anonymous namespace).

#pragma once

#include "paged_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The online-softmax step of one row: the new running maximum (base 2)
// gives the factor that rescales the old sums, and the maximum to subtract
// (0 while the row has seen no valid key, so every p is 0).
struct Rescale {
  float corr, m_use;
};
__device__ __forceinline__ Rescale rescale(float& m, float m_tile) {
  const float m_new = fmaxf(m, m_tile);
  const float m_use = m_new == -INFINITY ? 0.f : m_new;
  const Rescale r{exp2f(m - m_use), m_use};  // exp2(-inf) = 0 on the first
  m = m_new;
  return r;
}

// ---- copies -------------------------------------------------------------------

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 8 and 4 bytes the same way (through L1: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head of x into dst (row stride STRIDE
// elements), 16 bytes per copy; rows past S are zeros.
template <typename T, int D, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_async(T* dst, const T* x, long long ss, int r0,
                                            int S, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kChunks = D / kPer;     // copies per row
  constexpr int kCopies = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + THREADS - 1) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    if (kCopies % THREADS != 0 && idx >= kCopies) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = r0 + r < S;
    cp_async16(dst + r * STRIDE + c * kPer, in ? x + (r0 + r) * ss + c * kPer : x, in);
  }
}

// ---- tensor cores (bf16) --------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
// c += a . b for one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragment addresses inside a row-major [rows][STRIDE] bf16 tile. The A
// operand (16 rows x 16 columns at row0, col0) and, with .trans, the B
// operand of a product whose k index runs down the rows (16 rows x two n8
// column tiles at row0, col0) read the same addresses.
template <int STRIDE>
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int row0, int col0, int lane) {
  return t + (row0 + (lane & 15)) * STRIDE + col0 + (lane >> 4) * 8;
}
// The B operand of a product whose k index runs along the rows (x . t^T):
// rows row0..row0+15 as two n8 tiles, columns col0..col0+15 as k.
template <int STRIDE>
__device__ __forceinline__ const bf16* frag_bt(const bf16* t, int row0, int col0,
                                               int lane) {
  return t + (row0 + (lane & 7) + ((lane >> 4) << 3)) * STRIDE + col0 +
         ((lane >> 3) & 1) * 8;
}

}  // namespace
