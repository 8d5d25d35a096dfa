// The cost a step of the cluster path's exchange (lstm_fwd.cu, lstm_bwd.cu,
// "widths above 64") with no other work: each step 32 threads of each CTA
// write one float to every CTA of its cluster (double-buffered), and the
// next step reads them.  Two protocols, with lstm_common.cuh's helpers:
//   barrier  st.shared::cluster stores, then barrier.cluster (release /
//            acquire) across the cluster;
//   st.async the kernels' exchange: st.async stores that count their bytes
//            on the receiver's mbarrier, one local arrive.expect_tx a
//            phase, one wait.
// Grids of 132 / K clusters of K = 1, 2, 4, 8 CTAs of 256 threads, 16000
// steps.  Build and run on the card (plain nvcc, no PyTorch), from the root
// of the checkout:
//   mkdir -p awm_tpu_torch/ops/_build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o awm_tpu_torch/ops/_build/bench_cluster_sync awm_tpu_torch/ops/bench_cluster_sync.cu \
//     && awm_tpu_torch/ops/_build/bench_cluster_sync
// Prints one line per (K, protocol): microseconds a step (CUDA events over 3
// launches after one) and the launches' error strings.
#include <cstdio>

#include "csrc/lstm_common.cuh"

using namespace awm;

constexpr int STEPS = 16000;
constexpr int THREADS = 256;

template <bool ASYNC>
__global__ void exchange(int steps, int k, float* out) {
  __shared__ __align__(16) float buf[2][MAX_WIDTH];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  if (ASYNC && tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&bar[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * MAX_WIDTH; i += blockDim.x) (&buf[0][0])[i] = 0.f;
  __syncthreads();
  cluster_sync_all();
  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int b = t & 1;
    if (ASYNC && t > 0) mbar_wait_parity(&bar[(t - 1) & 1], ((t - 1) >> 1) & 1);
    acc += buf[(t + 1) & 1][tid % (CU * k)];
    const float v = acc * 0.5f + 1.0f;
    if (ASYNC && tid == 0) mbar_expect(&bar[b], CU * 4 * k);
    if (tid < CU) {
      for (int r = 0; r < k; ++r) {
        const uint32_t a = peer_addr(&buf[b][rank * CU + tid], r);
        if (ASYNC)
          st_async_peer(a, __float_as_uint(v), peer_addr(&bar[b], r));
        else
          asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
      }
    }
    if (!ASYNC) cluster_sync_all();
  }
  cluster_sync_all();
  if (tid == 0) out[blockIdx.x] = acc;
}

int main() {
  float* out;
  cudaMalloc(&out, 1 << 20);
  for (int k : {1, 2, 4, 8}) {
    for (bool async : {false, true}) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = cluster_config(attr, 132 / k, k * CU, THREADS, 0, 0);
      auto run = [&]() {
        return async ? cudaLaunchKernelEx(&cfg, exchange<true>, STEPS, k, out)
                     : cudaLaunchKernelEx(&cfg, exchange<false>, STEPS, k, out);
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
      printf("K=%d %s: %.3f us a step [%s, %s]\n", k, async ? "st.async" : "barrier", ms / 3 / STEPS * 1e3,
             cudaGetErrorString(first), cudaGetErrorString(last));
    }
  }
  return 0;
}
