// Probe of the rbf_gram kernel's store path on the card (csrc/rbf_gram.cu):
// the shipped kernel against the same tile computation with other stores
// and grid sizes, at the paths' large shapes. Built and run by
// probe_rbf_store.py; prints one line per shape and variant.
//
// Variants (all compute rbf::tile_sums on 32 x 256 tiles, d = 2):
//   shipped    rbf_gram_f32: 16-byte st.global.cs stores, 264 CTAs
//   grid132    the shipped kernel on 132 CTAs (one per SM)
//   grid528    the shipped kernel on 528 CTAs (four per SM)
//   st.v4      16-byte stores with the default cache policy, 264 CTAs
//   tma        each tile written to shared memory (two 32 KB buffers) and
//              stored by one TMA tensor store (cp.async.bulk.tensor.2d),
//              264 CTAs; the tensor map clips the ragged edges
// Each variant's K is compared bit for bit with the shipped kernel's.
// Times: CUDA events over 100 launches, the median of 5 runs, variants in
// turns.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include "rbf_gram.cu"

#define CHECK(x)                                                                              \
  do {                                                                                        \
    cudaError_t e_ = (x);                                                                     \
    if (e_ != cudaSuccess) {                                                                  \
      fprintf(stderr, "%s:%d %s: %s\n", __FILE__, __LINE__, #x, cudaGetErrorString(e_));      \
      exit(1);                                                                                \
    }                                                                                         \
  } while (0)

namespace {

constexpr int TR = rbf::Shape<false>::ROWS, TC = rbf::Shape<false>::COLS;
enum Mode { ST_V4, TMA };

template <int MODE>
__global__ void __launch_bounds__(rbf::THREADS, 2)
probe_kernel(const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ ls,
             const float* __restrict__ eta, float* __restrict__ out, int n, int m, int d, long long tiles_m,
             long long tiles, const __grid_constant__ CUtensorMap map) {
  using namespace rbf;
  __shared__ Staged<false> s;
  extern __shared__ __align__(128) float tile_buf[];  // TMA: two TR x TC tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tcol = (warp % Shape<false>::WARPS_C) * WARP_COLS + lane * VEC;
  const int trow = (warp / Shape<false>::WARPS_C) * RPT;
  const float e2 = __fmul_rn(*eta, *eta);
  const long long first = tiles * blockIdx.x / gridDim.x, last = tiles * (blockIdx.x + 1) / gridDim.x;
  long long staged_rb = -1;
  int buf = 0;
  for (long long t = first; t < last; ++t, buf ^= 1) {
    const long long rb = t / tiles_m;
    const long long row0 = rb * TR, col0 = (t - rb * tiles_m) * TC;
    const int rows = (int)min((long long)TR, n - row0);
    float acc[RPT][VEC];
    tile_sums<false>(s, acc, x1, x2, ls, 1, m, d, row0, rows, col0, rb == staged_rb, trow, tcol);
    staged_rb = rb;
    if (MODE == ST_V4) {
      const int j = (int)col0 + tcol;
      if (j >= m) continue;
      float* p = out + (row0 + trow) * (long long)m + j;
#pragma unroll
      for (int r = 0; r < RPT; ++r, p += m) {
        if (trow + r >= rows) break;
        float v[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[c] = e2 * expf(-0.5f * acc[r][c]);
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      float* tb = tile_buf + buf * TR * TC;
      if (threadIdx.x == 0)  // the store issued from this buffer two tiles ago has read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float v[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[c] = e2 * expf(-0.5f * acc[r][c]);
        *reinterpret_cast<float4*>(tb + (trow + r) * TC + tcol) = make_float4(v[0], v[1], v[2], v[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned saddr = (unsigned)__cvta_generic_to_shared(tb);
        asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
                     :: "l"(&map), "r"((int)col0), "r"((int)row0), "r"(saddr) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if (MODE == TMA && threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
  CHECK(cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q));
  if (q != cudaDriverEntryPointSuccess || fn == nullptr) {
    fprintf(stderr, "cuTensorMapEncodeTiled not found\n");
    exit(1);
  }
  return (PFN_cuTensorMapEncodeTiled_v12000)fn;
}

CUtensorMap out_map(float* out, int n, int m) {
  CUtensorMap map;
  cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  cuuint64_t strides[1] = {(cuuint64_t)m * sizeof(float)};
  cuuint32_t box[2] = {TC, TR};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = encode_fn()(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box, estr,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "cuTensorMapEncodeTiled failed: %d\n", (int)r);
    exit(1);
  }
  return map;
}

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

}  // namespace

int main() {
  const int d = 2;
  const int shapes[][2] = {{5120, 10000}, {2500, 50000}, {16384, 16384}, {5120, 5120}, {1024, 1024}};
  const size_t tma_smem = 2 * TR * TC * sizeof(float);
  CHECK(cudaFuncSetAttribute(probe_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tma_smem));
  float *dls, *deta;
  const float hls[2] = {0.7f, 0.9f}, heta = 1.3f;
  CHECK(cudaMalloc(&dls, sizeof hls));
  CHECK(cudaMalloc(&deta, sizeof heta));
  CHECK(cudaMemcpy(dls, hls, sizeof hls, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(deta, &heta, sizeof heta, cudaMemcpyHostToDevice));
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  for (auto& sh : shapes) {
    const int n = sh[0], m = sh[1];
    std::vector<float> h1((size_t)n * d), h2((size_t)m * d);
    unsigned st = 12345u;
    auto uni = [&]() { st = st * 1664525u + 1013904223u; return (st >> 8) * (4.0f / 16777216.0f) - 2.0f; };
    for (auto& v : h1) v = uni();
    for (auto& v : h2) v = uni();
    float *x1, *x2, *ref, *out;
    const size_t bytes = (size_t)n * m * sizeof(float);
    CHECK(cudaMalloc(&x1, h1.size() * 4));
    CHECK(cudaMalloc(&x2, h2.size() * 4));
    CHECK(cudaMalloc(&ref, bytes));
    CHECK(cudaMalloc(&out, bytes));
    CHECK(cudaMemcpy(x1, h1.data(), h1.size() * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(x2, h2.data(), h2.size() * 4, cudaMemcpyHostToDevice));
    const rbf::Config c = rbf::config(n, m, d);
    const long long tiles_m = (m + TC - 1) / TC;
    const CUtensorMap map = out_map(out, n, m);
    const char* names[] = {"shipped", "grid132", "grid528", "st.v4", "tma"};
    auto launch = [&](int v, float* dst) {
      switch (v) {
        case 0:
          if (rbf_gram_f32(x1, x2, dls, 1, deta, dst, n, m, d, nullptr) != 0) exit(1);
          break;
        case 1:
        case 2:
          rbf::rbf_gram_kernel<false><<<v == 1 ? 132 : 528, rbf::THREADS>>>(x1, x2, dls, 1, deta, dst, n, m, d,
                                                                             TR, tiles_m, c.tiles);
          break;
        case 3:
          probe_kernel<ST_V4><<<(unsigned)c.ctas, rbf::THREADS>>>(x1, x2, dls, deta, dst, n, m, d, tiles_m, c.tiles,
                                                                  map);
          break;
        default:
          probe_kernel<TMA><<<(unsigned)c.ctas, rbf::THREADS, tma_smem>>>(x1, x2, dls, deta, dst, n, m, d, tiles_m,
                                                                          c.tiles, map);
      }
      CHECK(cudaGetLastError());
    };
    launch(0, ref);
    CHECK(cudaDeviceSynchronize());
    std::vector<float> href((size_t)n * m), hout((size_t)n * m);
    CHECK(cudaMemcpy(href.data(), ref, bytes, cudaMemcpyDeviceToHost));
    bool equal[5];
    for (int v = 0; v < 5; ++v) {
      CHECK(cudaMemset(out, 0xff, bytes));
      launch(v, out);  // the TMA map points at `out`
      CHECK(cudaDeviceSynchronize());
      CHECK(cudaMemcpy(hout.data(), out, bytes, cudaMemcpyDeviceToHost));
      equal[v] = memcmp(hout.data(), href.data(), bytes) == 0;
    }
    std::vector<float> ms[5];
    for (int run = 0; run < 5; ++run)
      for (int v = 0; v < 5; ++v) {
        launch(v, out);
        CHECK(cudaEventRecord(e0));
        for (int i = 0; i < 100; ++i) launch(v, out);
        CHECK(cudaEventRecord(e1));
        CHECK(cudaEventSynchronize(e1));
        float t;
        CHECK(cudaEventElapsedTime(&t, e0, e1));
        ms[v].push_back(t / 100);
      }
    const double bound = 1e3 * 4.0 * ((double)n * d + (double)m * d + (double)n * m) / 3.35e12;
    for (int v = 0; v < 5; ++v)
      printf("%dx%d d=%d %-8s %.4f ms (runs %.4f %.4f %.4f %.4f %.4f) | %.1f%% of the %.4f ms bytes bound | "
             "K bit-equal to shipped: %s\n",
             n, m, d, names[v], median(ms[v]), ms[v][0], ms[v][1], ms[v][2], ms[v][3], ms[v][4],
             100.0 * bound / median(ms[v]), bound, equal[v] ? "yes" : "NO");
    fflush(stdout);
    CHECK(cudaFree(x1));
    CHECK(cudaFree(x2));
    CHECK(cudaFree(ref));
    CHECK(cudaFree(out));
  }
  return 0;
}
