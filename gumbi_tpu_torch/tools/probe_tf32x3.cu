// Probe of the 3xTF32 tile product of csrc/tf32x3.cuh on the card: what the
// mma.sync route costs piece by piece, and what carrying sums inside the
// tensor cores' accumulator does to the error. Built and run by
// probe_tf32x3.py; prints one line per case.
//
// Part 1, rates: 264 CTAs of 8 warps multiply a 128 x 128 x 32 chunk that
// sits in shared memory 4,000 times (no global traffic), each warp a
// 64 x 32 piece as in blocked_chol.cu:
//   split3   cvt.rna split on the fly, three passes, f32 add per step (mma3)
//   split1   the same split, one pass
//   raw1     no split, one pass: the mma.sync TF32 rate out of shared memory
//   inacc3   split, three passes accumulated in the tensor core, no f32 adds
//   mask3    hi by masking the low 13 bits, lo = x - hi unrounded, then mma3
//   presplit hi and lo read ready-made from shared memory, then mma3
// Part 2, accuracy: C = A B^T (128 x 64 x K) with G 8-deep steps summed in
// the accumulator operand before each f32 add, against f64, on operands in
// [-0.5, 0.5) and in [0, 1).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>

#include "tf32x3.cuh"

using namespace tf32x3;

constexpr int NB = 128, NT = 256, BK = 32, LDS = 36;

enum Mode { SPLIT3, SPLIT1, RAW1, INACC3, MASK3, PRESPLIT };

__device__ __forceinline__ void mask_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int MODE>
__global__ void __launch_bounds__(NT, 2) rate_kernel(const float* X, float* out, int iters) {
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;
  float* Ys = sm + NB * LDS;
  for (int i = threadIdx.x; i < 4 * NB * LDS; i += NT) sm[i] = X[i % (NB * NB)];
  __syncthreads();
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int m0 = 64 * (warp / 4), n0 = 32 * (warp % 4);
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragB b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = Ys + (n0 + 8 * nt + g) * LDS + kk + t;
        if (MODE == PRESPLIT) {
          b[nt].hi[0] = __float_as_uint(p[0]), b[nt].hi[1] = __float_as_uint(p[4]);
          b[nt].lo[0] = __float_as_uint(p[2 * NB * LDS]), b[nt].lo[1] = __float_as_uint(p[2 * NB * LDS + 4]);
        } else if (MODE == MASK3) {
          mask_split(p[0], b[nt].hi[0], b[nt].lo[0]), mask_split(p[4], b[nt].hi[1], b[nt].lo[1]);
        } else if (MODE == RAW1) {
          b[nt].hi[0] = __float_as_uint(p[0]), b[nt].hi[1] = __float_as_uint(p[4]);
        } else {
          b[nt] = load_b(Ys, LDS, n0 + 8 * nt, kk);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = Xs + (m0 + 16 * mt + g) * LDS + kk + t;
        const float x[4] = {p[0], p[8 * LDS], p[4], p[8 * LDS + 4]};
        FragA a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (MODE == PRESPLIT) {
            a.hi[q] = __float_as_uint(x[q]), a.lo[q] = __float_as_uint(p[2 * NB * LDS + (q & 1) * 8 * LDS + (q >> 1) * 4]);
          } else if (MODE == MASK3) {
            mask_split(x[q], a.hi[q], a.lo[q]);
          } else if (MODE == RAW1) {
            a.hi[q] = __float_as_uint(x[q]);
          } else {
            split(x[q], a.hi[q], a.lo[q]);
          }
        }
        if (MODE == SPLIT3 || MODE == MASK3 || MODE == PRESPLIT) mma3<4>(acc[mt], a, b);
        if (MODE == SPLIT1 || MODE == RAW1) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_m16n8k8(acc[mt][nt], a.hi, b[nt].hi);
        }
        if (MODE == INACC3) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_m16n8k8(acc[mt][nt], a.lo, b[nt].hi);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_m16n8k8(acc[mt][nt], a.hi, b[nt].lo);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_m16n8k8(acc[mt][nt], a.hi, b[nt].hi);
        }
      }
    }
  }
  float s = 0;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b)
      for (int e = 0; e < 4; ++e) s += acc[a][b][e];
  out[blockIdx.x * NT + threadIdx.x] = s;
}

template <int MODE>
void rate(const char* name, const float* X, float* out) {
  const int ctas = 264, iters = 4000;
  const size_t smem = 4 * NB * LDS * sizeof(float);
  cudaFuncSetAttribute(rate_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rate_kernel<MODE><<<ctas, NT, smem>>>(X, out, 10);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a), cudaEventCreate(&b);
  cudaEventRecord(a);
  rate_kernel<MODE><<<ctas, NT, smem>>>(X, out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = 2.0 * NB * NB * BK * (double)iters * ctas;  // of the f32 product
  printf("rate %-8s: %.3f ms, %.1f TFLOP/s of the f32 product (CUDA error %d)\n", name, ms, flops / ms / 1e9,
         (int)cudaGetLastError());
}

// C (128 x 64) = A (128 x K) B (64 x K)^T, both K-major in device memory; G
// steps are summed in the accumulator operand before one f32 add.
template <int G>
__global__ void depth_kernel(const float* A, const float* B, float* C, int K) {
  const int m0 = 16 * (threadIdx.x / 32);
  float acc[8][4] = {};
  for (int k0 = 0; k0 < K; k0 += 8 * G) {
    float d[8][4] = {};
    for (int g = 0; g < G; ++g) {
      const FragA a = load_a(A, K, m0, k0 + 8 * g);
      FragB b[8];
      for (int n = 0; n < 8; ++n) b[n] = load_b(B, K, 8 * n, k0 + 8 * g);
      for (int n = 0; n < 8; ++n) mma_m16n8k8(d[n], a.lo, b[n].hi);
      for (int n = 0; n < 8; ++n) mma_m16n8k8(d[n], a.hi, b[n].lo);
      for (int n = 0; n < 8; ++n) mma_m16n8k8(d[n], a.hi, b[n].hi);
    }
    for (int n = 0; n < 8; ++n)
      for (int e = 0; e < 4; ++e) acc[n][e] += d[n][e];
  }
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) C[(m0 + acc_row(e)) * 64 + 8 * n + acc_col(e)] = acc[n][e];
}

template <int G>
void depth(const float* dA, const float* dB, float* dC, int K, const std::vector<float>& A,
           const std::vector<float>& B, const char* tag) {
  depth_kernel<G><<<1, 256>>>(dA, dB, dC, K);
  std::vector<float> C(128 * 64);
  cudaMemcpy(C.data(), dC, C.size() * 4, cudaMemcpyDeviceToHost);
  double worst = 0, bias = 0, chain = 0;
  for (int i = 0; i < 128; ++i)
    for (int j = 0; j < 64; ++j) {
      double r = 0, s = 0;
      float f = 0;
      for (int q = 0; q < K; ++q) {
        r += (double)A[i * K + q] * B[j * K + q];
        s += fabs((double)A[i * K + q] * B[j * K + q]);
        f = fmaf(A[i * K + q], B[j * K + q], f);
      }
      const double e = (C[i * 64 + j] - r) / s;
      worst = fmax(worst, fabs(e));
      bias += e * (r >= 0 ? 1 : -1);
      chain = fmax(chain, fabs(f - r) / s);
    }
  printf("depth %-8s K=%3d G=%2d: max err/(|a||b|) %.3e | mean err away from zero %.3e | f32 fma chain %.3e\n", tag, K,
         G, worst, bias / (128 * 64), chain);
}

int main() {
  float *X, *out;
  cudaMalloc(&X, NB * NB * 4);
  cudaMalloc(&out, 1024 * NT * 4);
  std::vector<float> h(NB * NB);
  for (int i = 0; i < NB * NB; ++i) h[i] = (float)((i * 2654435761u >> 8) % 1000) / 1000.f - 0.5f;
  cudaMemcpy(X, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
  rate<SPLIT3>("split3", X, out);
  rate<SPLIT1>("split1", X, out);
  rate<RAW1>("raw1", X, out);
  rate<INACC3>("inacc3", X, out);
  rate<MASK3>("mask3", X, out);
  rate<PRESPLIT>("presplit", X, out);
  for (int pos = 0; pos < 2; ++pos)
    for (int K : {64, 128}) {
      std::vector<float> A(128 * K), B(64 * K);
      srand(1);
      for (auto& x : A) x = (float)rand() / RAND_MAX - (pos ? 0.f : 0.5f);
      for (auto& x : B) x = (float)rand() / RAND_MAX - (pos ? 0.f : 0.5f);
      float *dA, *dB, *dC;
      cudaMalloc(&dA, A.size() * 4), cudaMalloc(&dB, B.size() * 4), cudaMalloc(&dC, 128 * 64 * 4);
      cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
      cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
      const char* tag = pos ? "positive" : "signed";
      depth<1>(dA, dB, dC, K, A, B, tag);
      depth<2>(dA, dB, dC, K, A, B, tag);
      depth<4>(dA, dB, dC, K, A, B, tag);
      depth<8>(dA, dB, dC, K, A, B, tag);
      if (K == 128) depth<16>(dA, dB, dC, K, A, B, tag);
    }
  return (int)cudaDeviceSynchronize();
}
