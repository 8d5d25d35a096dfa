// The cost a step of the cluster path's exchange (lstm_fwd.cu, lstm_bwd.cu,
// "widths above 64") with no other work: each step every CTA of a cluster
// sends R rows of V fp32 values (V = 32: kernel A's h of a CTA's units;
// V = 128: kernel C's da of its gate columns) into every CTA's shared
// memory (double-buffered), counted on the receiver's mbarrier (one local
// arrive.expect_tx a phase, one wait), and the next step reads them.  Two
// forms of the st.async stores, with lstm_common.cuh's helpers:
//   values  one 4-byte st.async a value (the exchange before the row bursts);
//   bursts  one 16-byte st.async a 4 values of a row (the kernels' exchange).
// Grids of 132 / K clusters of K = 4, 8 CTAs of 256 threads, R = 1, 4, 8,
// 4000 steps.  Build and run on the card (plain nvcc, no PyTorch), from the
// root of the checkout:
//   mkdir -p awm_tpu_torch/ops/_build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o awm_tpu_torch/ops/_build/bench_cluster_sync awm_tpu_torch/ops/bench_cluster_sync.cu \
//     && awm_tpu_torch/ops/_build/bench_cluster_sync
// Prints one line per (V, R, K, form): microseconds a step (CUDA events over
// 3 launches after one) and the launches' error strings.
#include <cstdio>

#include "csrc/lstm_common.cuh"

using namespace awm;

constexpr int STEPS = 4000;
constexpr int THREADS = 256;

template <bool BURST>
__global__ void exchange(int steps, int k, int values, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);          // [2]
  float* buf0 = reinterpret_cast<float*>(smem + 16);          // [2][the K CTAs' R V values]
  auto buf = [&](int b) { return buf0 + b * k * values; };
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&bar[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * k * values; i += blockDim.x) buf0[i] = 0.f;
  __syncthreads();
  cluster_sync_all();
  float acc = 0.f;
  const int per = BURST ? values / 4 : values;  // stores a peer and step
  for (int t = 0; t < steps; ++t) {
    const int b = t & 1;
    if (t > 0) mbar_wait_parity(&bar[(t - 1) & 1], ((t - 1) >> 1) & 1);
    acc += buf((t + 1) & 1)[tid % (values * k)];
    const float v = acc * 0.5f + 1.0f;
    if (tid == 0) mbar_expect(&bar[b], values * 4 * k);
    for (int i = tid; i < per * k; i += THREADS) {
      const int r = i / per, j = i % per;  // peer r, store j of this CTA's values
      if (BURST) {
        const uint32_t a = peer_addr(buf(b) + rank * values + 4 * j, r);
        const uint32_t u = __float_as_uint(v);
        st_async_peer_v4(a, make_uint4(u, u, u, u), peer_addr(&bar[b], r));
      } else {
        st_async_peer(peer_addr(buf(b) + rank * values + j, r), __float_as_uint(v), peer_addr(&bar[b], r));
      }
    }
  }
  mbar_wait_parity(&bar[(steps - 1) & 1], ((steps - 1) >> 1) & 1);
  cluster_sync_all();
  if (tid == 0) out[blockIdx.x] = acc;
}

int main() {
  float* out;
  cudaMalloc(&out, 1 << 20);
  const int max_smem = 16 + 2 * 8 * 8 * 128 * 4;  // K = 8, R = 8, V = 128
  cudaFuncSetAttribute(exchange<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  cudaFuncSetAttribute(exchange<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  for (int v : {32, 128})
    for (int rows : {1, 4, 8})
      for (int k : {4, 8})
        for (bool burst : {false, true}) {
          const int values = rows * v;  // a CTA's values a step, to each peer
          cudaLaunchAttribute attr[1];
          const cudaLaunchConfig_t cfg =
              cluster_config(attr, 132 / k, k * CU, THREADS, 16 + 2 * (size_t)k * values * 4, 0);
          auto run = [&]() {
            return burst ? cudaLaunchKernelEx(&cfg, exchange<true>, STEPS, k, values, out)
                         : cudaLaunchKernelEx(&cfg, exchange<false>, STEPS, k, values, out);
          };
          const cudaError_t first = run();
          cudaDeviceSynchronize();
          cudaEvent_t s0, s1;
          cudaEventCreate(&s0);
          cudaEventCreate(&s1);
          cudaEventRecord(s0);
          for (int i = 0; i < 3; ++i) run();
          cudaEventRecord(s1);
          cudaEventSynchronize(s1);
          float ms;
          cudaEventElapsedTime(&ms, s0, s1);
          const cudaError_t last = cudaGetLastError();
          printf("V=%d R=%d K=%d %s: %.3f us a step [%s, %s]\n", v, rows, k, burst ? "bursts" : "values",
                 ms / 3 / STEPS * 1e3, cudaGetErrorString(first), cudaGetErrorString(last));
        }
  return 0;
}
