// 3xTF32 tile product on Hopper's tensor cores: the device-side building
// block shared by blocked_chol.cu and fused_matvec.cu.
//
// Replaces, in both files, the FP32 FMA product out of shared memory that
// stood in for the TPU kernels' 3-pass bf16 hi/lo MXU products
// (gumbi_tpu/ops/pallas_kernels.py `_split_hi_lo` and the passes of
// `_fused_matvec_body` / `_fused_matvec_sym_body`; the MXU matmuls of
// gumbi_tpu/ops/pallas_chol.py). What carries over is the split: each f32
// operand x becomes hi = tf32(x) (cvt.rna.tf32.f32: 10 explicit mantissa
// bits, round to nearest, ties away) and lo = tf32(x - hi), and the product
// is lo*hi + hi*lo + hi*hi with f32 accumulation, small terms first; lo*lo
// (2^-22 of the product) is dropped, as the TPU kernels drop it.
//
// Bound: operations. The least time this card takes for an f32-class
// product is three TF32 passes at 495 TFLOP/s, 7.4x the FP32 FMA peak of 67
// divided by three: 2.5x the old ceiling.
//
// Two routes, both hand-written PTX:
//   * mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (first half of
//     this file), one warp per instruction, fragments loaded by each thread
//     from shared memory, so one f32 tile there serves all three passes and
//     either orientation. On one H100 at 700 W it reaches half the TF32
//     peak (243 TFLOP/s for one pass out of shared memory) and it holds the
//     warp's dispatch slot while it runs, so the split (cvt runs at a quarter
//     of the FP32 rate), the f32 adds and the loads add to its time instead
//     of hiding behind it: 58 TFLOP/s f32-equivalent for the three passes
//     where the tensor pipe alone would give 81, 74 with hi and lo ready in
//     shared memory (tools/probe_tf32x3.py). The blocked Cholesky uses it:
//     its operands are plain f32 tiles of the matrix.
//   * wgmma.mma_async m64nNk8 (second half), the only way to the full rate:
//     asynchronous, A from registers (any orientation, split on the fly), B
//     from shared memory through a descriptor, K-major only, as TF32
//     values in a fixed core-matrix layout; so hi and lo of B each need
//     their own copy in that layout. The symmetric matvec uses it: its B
//     operand, V, is split and laid out once per call. The Cholesky tried
//     it (each staged chunk of L_jk converted in shared memory) and was
//     slower, 53-66 ms against 44 ms at N = 16,384: the conversion and two
//     barriers for every 32 columns of K serialise with four short wgmma
//     steps.
//
// Accuracy: the tensor cores' f32 accumulation truncates. Carrying a
// 128-term sum in the accumulator operand left a mean error of -1.1e-6 of
// the sum on positive operands, against -4e-8 when only one 8-deep step is
// summed there (one H100, tools/probe_tf32x3.py). So no long sum
// is carried in the accumulator operand: both routes sum the 24 products
// of one 8-deep step from zero inside the tensor core, and the caller adds
// that partial to its running sum with an ordinary f32 add (round to
// nearest), as Ootomo and Yokota's error-corrected TF32 GEMM does.
//
// Operand layout ("K-major"): both operands lie in shared memory as rows
// with k contiguous, A[m][k] and B[n][k], and the product is A * B^T. With
// a row stride of 4 (mod 32) words, e.g. 36 for 32 staged k, the eight
// rows and four k of a fragment load fall in 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to 2^-22 |x|, both representable in TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, f32 accumulate. With
// g = lane / 4 and t = lane % 4 a thread holds a[0] = A[g][t],
// a[1] = A[g + 8][t], a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4];
// b[0] = B[k = t][n = g], b[1] = B[t + 4][g]; d[0], d[1] = D[g][2 t],
// D[g][2 t + 1]; d[2], d[3] = D[g + 8][2 t], D[g + 8][2 t + 1].
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment split once, used for several products.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// Rows m0 + {g, g + 8}, k = k0 + {t, t + 4} of a K-major tile.
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (m0 + g) * ld + k0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// Row n0 + g, k = k0 + {t, t + 4} of a K-major tile.
__device__ __forceinline__ FragB load_b(const float* tile, int ld, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (n0 + g) * ld + k0 + t;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// The A fragment from a tile that holds the operand the other way round
// (k along rows): A[m][k] = tile[k][m].
__device__ __forceinline__ FragA load_a_t(const float* tile, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + t) * ld + m0 + g;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[4 * ld], f.hi[2], f.lo[2]);
  split(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// acc[nt] += A (16 x 8) * B[nt] (8 x 8) at 3xTF32 for NT column tiles: each
// tile's three passes are summed from zero, small terms first, then added
// to acc in f32. The passes go tile by tile, so NT independent chains of
// dependent mma instructions are in flight.
template <int NT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], const FragA& a, const FragB (&b)[NT]) {
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.0f;
    mma_m16n8k8(d[nt], a.lo, b[nt].hi);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_m16n8k8(d[nt], a.hi, b[nt].lo);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_m16n8k8(d[nt], a.hi, b[nt].hi);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += d[nt][e];
}

// Row (0 or 1 selects g or g + 8) and column of accumulator entry e of a
// 16 x 8 output tile, for this thread.
__device__ __forceinline__ int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// 16-byte asynchronous copy, global to shared (through L2, not L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}


// ---------------------------------------------------------------------
// The warpgroup route, where the operand layouts allow it: wgmma.mma_async
// m64nNk8 TF32 with A from registers (each thread's fragment, as for
// mma.sync: warp w of the warpgroup holds rows 16 w.. of the 64) and B from
// shared memory through a matrix descriptor. B must lie K-major as TF32
// values in the unswizzled core-matrix layout: element (n, k) of an N x K
// tile at float offset ((n / 8) * (K / 4) + k / 4) * 32 + (n % 8) * 4 + k % 4,
// i.e. 8 x 4 core matrices of 128 bytes, the next along K 128 bytes on
// (the leading byte offset), the next along N K / 4 * 128 bytes on (the
// stride byte offset). The instruction runs beside the issuing warps, so
// the split, the f32 adds and the loads no longer take the tensor pipe's
// time as they do beside mma.sync. d is the 64 x N accumulator, four
// registers per 8 columns in mma.sync's layout; scale_d = 0 starts it from
// zero. A caller fences (wgmma_fence) before the first wgmma that reads
// registers it has just written, commits, and waits before it reads d.
// ---------------------------------------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t leading_bytes, uint32_t stride_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(leading_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32);  // no swizzle, base offset 0
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Makes shared-memory writes of this thread (st.shared, cp.async) visible
// to the tensor cores' reads; follow it with the CTA's barrier.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One 8-deep step of A (64 x 8, this thread's fragment) * B (8 x N) at 3xTF32
// through wgmma, started and not waited for: the step's three passes are
// summed from zero in d (scale_d = 0 on the first), small terms first, and
// committed as one group. The caller waits (wgmma_wait) and adds d to its
// running sum with f32 adds: the tensor cores' own accumulation truncates.
template <int ND>
__device__ __forceinline__ void wgmma3_start(float (&d)[ND], const FragA& a, uint64_t desc_hi, uint64_t desc_lo) {
  wgmma_fence();
  wgmma_rs(d, a.lo, desc_hi, 0);
  wgmma_rs(d, a.hi, desc_lo, 1);
  wgmma_rs(d, a.hi, desc_hi, 1);
  wgmma_commit();
}

}  // namespace tf32x3
