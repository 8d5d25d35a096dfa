// Shapes and helpers shared by the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
//
// The register-held kernels are templates over a capacity W, instantiated
// for W = 64 (the base family's channel count), W = 32 (the strided family's
// hidden width) and W = 16 (the multi-process dry run of
// awm_tpu_torch/entry.py), and W = 48 (the base family at channels 33-48:
// three quads a lane, NQ = 3), torch gate order (i, f, g, o).  A call passes its
// real input width D and hidden width H (runtime arguments, max(D, H) <= W):
// the weights load row g H + j, column k < D (or k < H), zero elsewhere, x
// is read with row stride D, and y, c_{t-1}, da and the gradients are
// written only where j < H and k < D.  A padded hidden unit stays exactly
// zero: its gate pre-activations are 0, so g = tanh 0 = 0, c = 0 and h =
// sigmoid(0) tanh(0) = 0, and its zero h adds +0 to every sum.  At D = H = W
// the arithmetic is the one the kernels had before the runtime widths.
// Widths above 64 take a thread-block cluster (lstm_fwd_cluster.cu and lstm_bwd.cu,
// "widths above 64"), widths above 256 the wide path (lstm_wide.cu).  T is the operand type: float for the fp32 contract,
// __nv_bfloat16 for the bf16 one (bf16 operands, every product exact in
// fp32, fp32 sums and state).
//
// Both recurrent kernels are warp-specialised.  A block has 8 W threads
// (512 at W = 64, 384 at W = 48, 256 at W = 32, 128 at W = 16): the first half of the
// warps are the consumers, which run the sequential recurrence, and the
// second half the producers, which run ahead of them and fill a ring in
// shared memory with everything of a step that does not depend on the
// carried state.  Within each role (COLS = 4 W threads, one per gate
// column), thread p belongs to hidden unit p / 4 and is lane kp = p % 4 of
// it; it ends each product holding gate kp of its unit, column col(p) =
// (p % 4) * W + p / 4.  The four gates of a unit sit in four neighbouring
// lanes of one warp and are exchanged by shuffles.  (That is the CUDA-core
// mapping; the bf16 tensor-core paths map lanes as the mma fragments do,
// see below.)  At W = 16 a role is two warps, a lane's part of a product
// one quad (NQ = 1) and the mma's k one tile: the same code at its
// smallest.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace awm {

// The shapes of capacity W.  Every kernel declares them from its W as
//   D = W (input width), H = W (hidden width), G = 4 W (gate columns),
//   K = D + H (terms of one gate's dot product), COLS = G (threads of one
//   role: one per gate column), THREADS = 2 COLS (consumers, then producers);
// its shared-memory layouts are the capacity's, the call's real widths are
// runtime arguments d and h.
// The register-held weight rows: 1, 2, 3 or 4 quads a lane (NQ = W / 16)
// and as many mma k-tiles.  At W = 48 lane kp's quads 4 q + kp, q
// ascending, are capacity 64's without its last (q = 3), which is all zeros
// at widths up to 48, and the mma loses a k-tile of zeros: a call at 33-48
// keeps the bits it had on capacity 64.
template <int W>
constexpr bool valid_width = W == 16 || W == 32 || W == 48 || W == 64;

constexpr int NBUF = 2;      // buffers of the producers' ring

// Named barriers (0 is __syncthreads).
constexpr int BAR_CONS = 1;   // among the consumers, once per step
constexpr int BAR_PROD = 2;   // among the producers, twice per chunk
constexpr int BAR_FULL = 3;   // + buffer: producers arrive, consumers wait
constexpr int BAR_EMPTY = 5;  // + buffer: consumers arrive, producers wait

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// A value as the matrix products see it: rounded to the operand type.
__device__ __forceinline__ float operand(float v, const float*) { return v; }
__device__ __forceinline__ float operand(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// 1 / d for 1 <= d < 2^120: the hardware's approximate reciprocal and one
// Newton step.  Within 1 ulp, and no branch for special cases: a step's
// activations are on the sequential path, and a divergent warp walks every
// branch of expf's, tanhf's and the division's slow paths in turn.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}
// The clamp keeps 1 + e^-v finite; below v = -80 the sigmoid stays at 2e-35.
__device__ __forceinline__ float sigmoid(float v) {
  return rcp_newton(1.0f + expf(fminf(-v, 80.0f)));
}
// tanh v = 2 sigmoid(2 v) - 1: absolute error 2^-23, from the same
// full-precision expf as the sigmoid.
__device__ __forceinline__ float tanh_sig(float v) { return fmaf(2.0f, sigmoid(2.0f * v), -1.0f); }

// The activation of gate m (i, f, g, o) = (0, 1, 2, 3), with no branch:
// the four gates of a unit sit in four lanes of one warp.
__device__ __forceinline__ float activate(int gate, float v) {
  const bool is_g = gate == 2;
  const float s = sigmoid(is_g ? 2.0f * v : v);
  return is_g ? fmaf(2.0f, s, -1.0f) : s;
}

// One gate column's W-term dot product is split over the four lanes of
// its unit: lane kp takes quads 4q + kp, q = 0..NQ-1 (NQ = W / 16), of the
// W / 4 quads (a quad is four consecutive terms), for all four gates, so a
// lane reads W / 4 of the W operand values from shared memory and not all
// of them.  The summation order of a gate's pre-activation, shared by the
// forward and the backward's recompute so that the backward sees the gates
// the forward used:
//   a lane's part = its W / 4 terms in order (q, then the term in the quad),
//       one running sum from 0 (dot_quad);
//   a product = the four parts, brought to lane kp = gate by
//       transpose_reduce4 as (part[g] + part[g^2]) + (part[g^1] + part[g^3]);
//   gate = (px + b) + ph, px the x product and ph the h product.
__device__ __forceinline__ void dot_quad(float& acc, float w0, float w1, float w2, float w3,
                                         const float4 v) {
  acc = fmaf(w0, v.x, acc);
  acc = fmaf(w1, v.y, acc);
  acc = fmaf(w2, v.z, acc);
  acc = fmaf(w3, v.w, acc);
}

// Four lanes (XH and XL apart in lane number) each hold a[n][0..3], their
// parts of four sums, for N independent sets n.  Leaves in out[n], on the
// lane with bits (hi, lo), the whole sum number 2 hi + lo of set n: two
// exchanges, three shuffles a set, a fixed order.  A warp runs its
// instructions in order and shuffles keep their program order, so each
// exchange is written for all N sets before the next one: the sets'
// latencies overlap.
template <int XH, int XL, int N>
__device__ __forceinline__ void transpose_reduce4(const float (*a)[4], bool hi, bool lo,
                                                  float out[N]) {
  float b0[N], b1[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    b0[n] = (hi ? a[n][2] : a[n][0]) + __shfl_xor_sync(0xffffffffu, hi ? a[n][0] : a[n][2], XH);
    b1[n] = (hi ? a[n][3] : a[n][1]) + __shfl_xor_sync(0xffffffffu, hi ? a[n][1] : a[n][3], XH);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    out[n] = (lo ? b1[n] : b0[n]) + __shfl_xor_sync(0xffffffffu, lo ? b0[n] : b1[n], XL);
}

// The four activated gates (i, f, g, o) of this thread's unit, from the four
// lanes that hold one each, for N independent sets.
template <int N>
__device__ __forceinline__ void gather_gates(const float act[N], int quad_lane, float ig[N],
                                             float fg[N], float gg[N], float og[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ig[n] = __shfl_sync(0xffffffffu, act[n], quad_lane);
    fg[n] = __shfl_sync(0xffffffffu, act[n], quad_lane + 1);
    gg[n] = __shfl_sync(0xffffffffu, act[n], quad_lane + 2);
    og[n] = __shfl_sync(0xffffffffu, act[n], quad_lane + 3);
  }
}

// Weight (row, k) of a (4 h, ncols) fp32 matrix, or 0 where the row's unit
// (row_ok) or the column lies past the call's real widths.  The weights come
// fp32 to every instantiation; a bf16 one rounds them to nearest even as it
// loads them (operand, load_w2m), as Tensor.to(torch.bfloat16) does, so no
// cast kernel runs beside a launch.
__device__ __forceinline__ float load_wm(const float* w, bool row_ok, size_t row, int k, int ncols) {
  return row_ok && k < ncols ? w[row * ncols + k] : 0.0f;
}

// This lane's W weights of the split above (4 gates x NQ quads x 4 terms),
// in the operand type and widened into registers for the whole launch:
// w[(m * NQ + q) * 4 + e] = term 4 (4 q + kp) + e of gate m's row (row m h +
// unit of the (4 h, ncols) matrix; zero past the real widths) for this
// unit.  Every index is a compile-time constant after unrolling, so w stays
// in registers.
template <int W, typename T>
__device__ __forceinline__ void load_gate_weights(const float* __restrict__ wmat, int unit, int kp,
                                                  float w[W], int h, int ncols) {
  constexpr int NQ = W / 16;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[(m * NQ + q) * 4 + e] = operand(load_wm(wmat, unit < h, (size_t)(m * h + unit), 4 * (4 * q + kp) + e, ncols),
                                          static_cast<const T*>(nullptr));
}

// acc[m] += this lane's W / 4 terms of gate m, m = 0..3; v points at the W
// operand values in shared memory.
template <int W>
__device__ __forceinline__ void dot_parts(float acc[4], const float w[W], const float* v, int kp) {
  constexpr int NQ = W / 16;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 vq = *reinterpret_cast<const float4*>(v + 4 * (4 * q + kp));
#pragma unroll
    for (int m = 0; m < 4; ++m)
      dot_quad(acc[m], w[(m * NQ + q) * 4], w[(m * NQ + q) * 4 + 1], w[(m * NQ + q) * 4 + 2],
               w[(m * NQ + q) * 4 + 3], vq);
  }
}

// ---- bf16 only: the products on the tensor cores ----
//
// D[j][n] = sum_k Wt[j][k] v[n][k] is one mma.sync.m16n8k16 (bf16 in, products
// exact, fp32 sums) per 16 rows j and 16 terms k.  A producer's product has
// no carried state in it, so its N dimension is time, 8 steps n at once; the
// forward's recurrent product takes the block's rows as n.  A warp takes the
// 32 rows of its 8 units: tile 0 holds gate i in
// rows 0-7 and gate f in rows 8-15, tile 1 gates g and o, row % 8 = the unit.
// The weights sit in registers as A fragments for the whole launch.  Lane
// (g8 = lane / 4, t4 = lane % 4) then holds all four gates of unit g8 for
// columns n = 2 t4 and 2 t4 + 1: c[tile][e] and c[tile][2 + e], e = 0, 1.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// put(i, get(i)) for i = t, t + threads, ... < n: a role's threads staging a
// chunk from device memory into shared memory, SG loads in flight a thread
// before their stores, so that the chunk waits on the loads' latency once a
// SG elements and not once an element.
template <int SG, typename Get, typename Put>
__device__ __forceinline__ void stage(int n, int t, int threads, Get get, Put put) {
  for (int i0 = t; i0 < n; i0 += SG * threads) {
    float v[SG];
#pragma unroll
    for (int u = 0; u < SG; ++u) v[u] = i0 + u * threads < n ? get(i0 + u * threads) : 0.0f;
#pragma unroll
    for (int u = 0; u < SG; ++u)
      if (i0 + u * threads < n) put(i0 + u * threads, v[u]);
  }
}

// Two fp32 values as one bf16 pair, rounded to nearest even, the first in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}
// fp32 weights i and i + 1 (i even, 8-byte aligned) as one bf16 pair.
__device__ __forceinline__ uint32_t load_w2(const float* w, size_t i) {
  const float2 v = *reinterpret_cast<const float2*>(w + i);
  return pack_bf16(v.x, v.y);
}
// Weights (row, k) and (row, k + 1) of a (4 h, ncols) fp32 matrix as one
// bf16 pair (load_wm's zeros past the real widths).
__device__ __forceinline__ uint32_t load_w2m(const float* w, bool row_ok, size_t row, int k, int ncols) {
  return pack_bf16(load_wm(w, row_ok, row, k, ncols), load_wm(w, row_ok, row, k + 1, ncols));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 blocks of a row-major tile in shared memory, each
// transposed on the way into an mma fragment: lane l gives the address of
// row l % 8 of block l / 8 (16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragments of one fp32 (4 h, ncols) weight matrix, rounded to bf16,
// for this warp's 8 units (unit0 = the first), zero past the real widths:
// a[tile][kt][0..3], kt = 0..W/16-1 over W terms (a single k-tile at W = 16).
// MASKED = false: a square (4 W, W) matrix (h = ncols = W), two weights a
// load.
template <int W, bool MASKED = true>
__device__ __forceinline__ void load_a_fragments(const float* __restrict__ wmat, int unit0,
                                                 int lane, uint32_t a[2][W / 16][4], int h, int ncols) {
  const int g8 = lane >> 2, t4 = lane & 3, u = unit0 + g8;
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int kt = 0; kt < W / 16; ++kt) {
      const int k = kt * 16 + 2 * t4;
      if constexpr (MASKED) {
        const size_t lo = (size_t)(2 * tile * h + u), hi = lo + h;  // the tile's two gates, same unit
        a[tile][kt][0] = load_w2m(wmat, u < h, lo, k, ncols);
        a[tile][kt][1] = load_w2m(wmat, u < h, hi, k, ncols);
        a[tile][kt][2] = load_w2m(wmat, u < h, lo, k + 8, ncols);
        a[tile][kt][3] = load_w2m(wmat, u < h, hi, k + 8, ncols);
      } else {
        const size_t lo = (size_t)((2 * tile) * W + u) * W + k, hi = lo + W * W;
        a[tile][kt][0] = load_w2(wmat, lo);
        a[tile][kt][1] = load_w2(wmat, hi);
        a[tile][kt][2] = load_w2(wmat, lo + 8);
        a[tile][kt][3] = load_w2(wmat, hi + 8);
      }
    }
}

// c[tile] += A[tile] . v^T over W terms: v points at this lane's B row in
// shared memory (column n = g8's W operand values, bf16).
template <int W>
__device__ __forceinline__ void mma_w(float c[2][4], const uint32_t a[2][W / 16][4],
                                      const __nv_bfloat16* v, int t4) {
#pragma unroll
  for (int kt = 0; kt < W / 16; ++kt) {
    const uint32_t b0 = ld32(v + kt * 16 + 2 * t4), b1 = ld32(v + kt * 16 + 8 + 2 * t4);
    mma_bf16(c[0], a[0][kt], b0, b1);
    mma_bf16(c[1], a[1][kt], b0, b1);
  }
}

// ---- the cluster path (max(D, H) > 64; lstm_fwd_cluster.cu and lstm_bwd.cu) ----
constexpr int CU = 32;          // hidden units a CTA of a cluster owns
constexpr int CROWS = 4 * CU;   // their gate rows
constexpr int CPROD = 128;      // producer threads of a CTA
constexpr int CLANES = 8;       // CUDA-core consumers: lanes a unit
constexpr int CLUSTER_MAX_WIDTH = 256;  // the cluster path's widest D and H: 8 CTAs (the portable cluster size) of CU units; wider calls take lstm_wide.cu
__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The launch of `clusters` clusters of ceil(h / CU) CTAs, each of `threads`
// threads and `smem` bytes of dynamic shared memory (attr: the storage of the
// cluster-dimension attribute, which cfg points at).
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters, int h, int threads, size_t smem,
                                         cudaStream_t stream) {
  const unsigned n_cta = (unsigned)((h + CU - 1) / CU);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * n_cta);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---- mbarriers and thread-block clusters ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// An mbarrier: init to an arrival count.  A cluster's peers may arrive on it
// only after fence.mbarrier_init and a cluster-wide barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// This CTA's rank in its cluster, and the cluster's size.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of the cluster (exited ones aside) arrives, with release,
// and waits, with acquire: the peers' shared memory and mbarriers are set
// up before it, and no CTA leaves while a peer may still write to it.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}
// The shared::cluster address of this CTA's shared-memory object p in the
// CTA of the given rank (distributed shared memory).
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
// A 4-byte store into a peer CTA's shared memory (st.async) that counts its
// bytes on the peer's mbarrier (complete_tx), both addresses shared::cluster.
// No fence and no arrival a step: the receiver's phase completes when its
// own arrival (mbar_expect) and every byte it expects are in.  On the H100
// this exchange takes less a step than stores and a barrier.cluster
// (ops/bench_cluster_sync.cu times both; PERF.md section 6).
__device__ __forceinline__ void st_async_peer(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr), "r"(v),
               "r"(bar)
               : "memory");
}
// The 16-byte form: four 32-bit words (a row burst of the exchange: 4 fp32
// or 8 bf16 values, 16-byte aligned at both ends) counted as 16 bytes.
__device__ __forceinline__ void st_async_peer_v4(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
               : "memory");
}
// This CTA's one arrival on its mbarrier for a phase, expecting `bytes` of
// st.async traffic in it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of the given parity of this CTA's mbarrier to
// complete: the st.async bytes it counted are visible after it.
__device__ __forceinline__ void mbar_wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// 16 bytes from global (read past L1) into this CTA's shared memory, both
// 16-byte aligned, without a register: complete for this thread after the
// cp_async_wait that covers its commit group, visible to the CTA after a
// __syncthreads that follows it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Four 8 x 8 bf16 blocks of a row-major tile in shared memory as they are
// (an m16k16 A fragment where lane l gives row l % 16 at column 8 (l / 16)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The copy of `bytes` bytes (16-byte aligned at both ends, a multiple of
// 16) from global into this CTA's shared memory by the TMA (cp.async.bulk),
// counted on bar, whose phase this thread's arrive.expect_tx (or another's)
// expects them.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device for the instantiation that holds this object (a static of its
// launcher): a short call's cost is its host work, and the attribute is
// the same at every call.  bytes = 0: the most a block may opt in to on
// the device, for a kernel whose need grows with the call's shape (a shape
// past it fails at its launch).
struct SmemOnce {
  std::atomic<unsigned long long> done{0};  // bit d: set on device d
  template <typename Kernel>
  cudaError_t set(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    if (bytes == 0 &&
        (err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
      return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
  }
};

}  // namespace awm
