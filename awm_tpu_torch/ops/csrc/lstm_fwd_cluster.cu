// LSTM forward for Hopper (sm_90a) at widths above 64, kernels A and B
// (lstm_fwd.cu has the W <= 64 kernels, the precision contract and the
// TPU kernels these replace: awm_tpu/ops/pallas/lstm_kernel.py,
// lstm_pallas_forward + _lstm_kernel, the pallas_call at line 157, and
// _forward_train + _lstm_train_kernel, the pallas_call at line 342).  A
// library of its own, so that it builds in parallel with lstm_fwd.cu.
//
// Plain C interface, loaded with ctypes by awm_tpu_torch/ops/lstm_kernel.py.

#include "lstm_common.cuh"

namespace {

using namespace awm;

// ---- Widths above 64: a thread-block cluster per R batch rows ----
//
// At W = 128 every weight of W_hh would take the whole register file of an
// SM, so a call with max(D, H) > 64 runs on a cluster of K = ceil(H / 32)
// CTAs (K <= 8, the portable cluster size, for H <= 256; wider calls take
// lstm_wide.cu's time-windowed path), which together own
// R batch rows, R = 1, 2, 4 or 8 (the plan's choice: ops/lstm_kernel.py):
// - CTA r owns hidden units [32 r, 32 r + 32), all four gates of each: 128
//   gate rows of W_hh held on chip for the whole launch, as the W = 64
//   block's consumers hold theirs (fp32: 8 lanes a unit, each 4 gates x HW / 8
//   terms in registers, serving all R rows; bf16: 4 warps of mma A fragments,
//   8 units a warp, the R rows the columns of the mma's B operand: one mma
//   set a step whatever R), HW = 128 or 256 the terms of h the template is
//   built for, zero past H (bf16 skips the k-tiles past H);
// - the input projection does not depend on h: 128 producer threads run it
//   ahead of the recurrence into a two-buffer ring, a chunk of 32 (step, row)
//   pairs at a time (32 / R steps of R rows).  Its x comes by the TMA (one
//   cp.async.bulk a pair, into a second buffer while the last chunk is
//   projected) where x's rows are 16-byte aligned, else by the producers'
//   loads.  bf16 on the tensor cores, the chunk's 32 pairs the N dimension
//   of four mma tiles, W_ih's A fragments staged in shared memory once a
//   launch; fp32 on the CUDA cores, W_ih's rows staged in shared memory
//   once a launch, a thread the four gates of one unit for 8 pairs (one
//   16-byte load of W_ih and one of x feed 16 products);
// - each step the consumers compute the CTA's gates, c and h of the R rows,
//   then send its 32 units of h_t to every CTA's shared memory (distributed
//   shared memory) in row bursts: a warp stages its units' h of each row
//   (16 bytes: 8 bf16 or 4 fp32 units) and sends each row to each CTA with
//   one 16-byte st.async, counted on the receiving CTA's mbarrier for h_t;
//   one thread of each CTA arrives on its own mbarrier expecting the step's
//   bytes of all K CTAs, and a step waits on it before it reads h_{t-1}.  No
//   barrier, fence or remote arrival a step (stores, a barrier and a
//   release-arrive on each peer took 0.5-0.7 us a step on the H100; st.async
//   ~0.2: PERF.md section 6).  h is double-buffered, so that one wait a step
//   is enough: a CTA writes h_{t+1} into a peer's buffer only after every
//   CTA's h_t arrived, and every warp of a CTA sends its h_t only after
//   reading h_{t-1} there;
// - the sums run in a fixed order (no atomics): two calls give the same
//   bits.  bf16: a gate is bias, then x's k-tiles, then h's, in order, one
//   accumulator (kernel C's gate pass repeats it).
// What bounds it: as at W <= 64 the latency of a step, now with the
// exchange of h between SMs in it; in fp32 at large R the FMA slots of the
// projection and the recurrence (both R x 128 x HW a step and CTA).
// (CU, CPROD, CLANES, ...: lstm_common.cuh)
template <typename T> constexpr int CCONS = is_bf16<T> ? 128 : CU * CLANES;  // consumer threads
constexpr int CPAIRS = 32;  // (step, row) pairs of a chunk: pair n = s R + r
template <int R> constexpr int CSTEPS = CPAIRS / R;
constexpr int CHEAD = 32;   // four mbarriers
constexpr int CSTAGE = 128; // bytes of a consumer warp's burst staging: 8 rows x 16 bytes

// A pair's staged x: round_up(d, k) values, zero past d (bf16 k = 16, the
// mma's k-tile; fp32 k = 4, a quad), bf16 rows + 8 so
// that 8 pairs' B fragments fall in distinct banks; 16-byte aligned rows, so
// that the TMA lands each pair on its own.
template <typename T> __host__ __device__ constexpr int cx_len(int d) { return round_up(d, is_bf16<T> ? 16 : 4); }
template <typename T> __host__ __device__ constexpr int cx_pitch(int d) { return cx_len<T>(d) + (is_bf16<T> ? 8 : 0); }
// h_{t-1} as the consumers read it: fp32 R rows of HW; bf16 the mma's B
// operand, 8 rows (row r of the batch at column r; rows from R on stay
// zero) of HW + 8.
template <typename T, int HW> constexpr int ch_pitch = is_bf16<T> ? HW + 8 : HW;
template <typename T, int R> constexpr int ch_rows = is_bf16<T> ? 8 : R;
// W_ih for the producers, staged once a launch: bf16 its A fragments,
// [4 warps][k-tile][2 tiles][32 lanes] x 16 bytes (each lane reads back only
// its own); fp32 the CTA's 128 rows as [quad of terms][gate][unit] x 16
// bytes.
template <typename T> __host__ __device__ constexpr int cwf_bytes(int d) {
  return is_bf16<T> ? 4 * (cx_len<T>(d) / 16) * 2 * 32 * 16 : CROWS * cx_len<T>(d) * 4;
}
constexpr size_t SMEM_OPTIN = 232448;  // the most shared memory a block may opt in to on sm_90

// x_bufs: buffers of the staged x, 2 (the next chunk's copy in flight while
// this one is projected) where they fit the card, else 1 (fp32 at D > 128).
template <typename T, int R, int HW>
size_t fwd_cluster_smem_bytes(int d, int x_bufs) {
  return CHEAD + sizeof(float) * NBUF * CPAIRS * CROWS + sizeof(T) * (size_t)2 * ch_rows<T, R> * ch_pitch<T, HW> +
         (size_t)(CCONS<T> / 32) * CSTAGE + sizeof(T) * (size_t)x_bufs * CPAIRS * cx_pitch<T>(d) + cwf_bytes<T>(d);
}
template <typename T, int R, int HW>
int fwd_cluster_x_bufs(int d) {
  return fwd_cluster_smem_bytes<T, R, HW>(d, 2) <= SMEM_OPTIN ? 2 : 1;
}

// x_tma: x's pairs go by the TMA (every pair row 16-byte aligned: x is, and
// D sizeof(T) is a multiple of 16), else by the producers' loads.
template <typename T, bool TRAIN, int R, int HW>
__global__ void __launch_bounds__(CCONS<T> + CPROD, 1)
lstm_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
                        const float* __restrict__ w_hh, const float* __restrict__ bias,
                        T* __restrict__ y, float* __restrict__ cprev, int batch, int steps, int d, int h,
                        int x_tma, int x_bufs) {
  static_assert(R == 1 || R == 2 || R == 4 || R == 8, "rows a cluster: 1, 2, 4 or 8");
  constexpr int NC = CCONS<T>, THREADS = NC + CPROD, HP = ch_pitch<T, HW>, HR = ch_rows<T, R>, S = CSTEPS<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);             // [2]: h_t of every CTA is in s_h[t & 1]
  uint64_t* xbar = mbar + 2;                                      // [2]: chunk c's x is in s_x[c & 1]
  float* s_ring = reinterpret_cast<float*>(smem + CHEAD);         // [NBUF][CPAIRS][CROWS]: xp, column 4 unit + gate
  T* s_h = reinterpret_cast<T*>(s_ring + NBUF * CPAIRS * CROWS);  // [2][HR][HP]: h of all H units
  unsigned char* s_stage = reinterpret_cast<unsigned char*>(s_h + 2 * HR * HP);  // [NC / 32][CSTAGE]
  const int dp = cx_pitch<T>(d), KT = cx_len<T>(d) / 16;
  T* s_x = reinterpret_cast<T*>(s_stage + (NC / 32) * CSTAGE);         // [x_bufs][CPAIRS][dp]: a chunk's x
  uint4* s_wf = reinterpret_cast<uint4*>(s_x + x_bufs * CPAIRS * dp);  // W_ih (cwf_bytes)
  const uint32_t rank = cluster_rank(), n_cta = (h + CU - 1) / CU;  // n_cta = the cluster's size
  const int u0 = rank * CU;
  const int row0 = (blockIdx.x / n_cta) * R;
  const int n_chunks = (steps + S - 1) / S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(mbar + i, 1);  // one arrival a phase (mbar_expect) and its bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * HR * HP; i += THREADS) store_f(s_h + i, 0.0f);      // h_{-1} = 0, the pads
  for (int i = threadIdx.x; i < x_bufs * CPAIRS * dp; i += THREADS) store_f(s_x + i, 0.0f);  // x past d stays 0
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the zeros before the TMA's copies
  __syncthreads();
  cluster_sync_all();  // every CTA's mbarriers and zeros are in place before a peer writes to them

  if (threadIdx.x >= NC) {
    // ---- producers: xp = x . W_ih + b for this CTA's gate rows, a chunk at a time ----
    const int tp = threadIdx.x - NC;
    const int lane = tp & 31, g8 = lane >> 2, t4 = lane & 3;
    // Pair n of chunk c: step c S + n / R of row row0 + n % R (ok: both in range).
    auto pair_x = [&](int c, int n, bool& ok) {
      const int row = row0 + n % R, t = c * S + n / R;
      ok = row < batch && t < steps;
      return x + ((size_t)row * steps + t) * d;
    };
    auto issue_x = [&](int c) {  // one thread: chunk c's x into s_x[c % x_bufs] by the TMA
      const int xb = c % x_bufs;
      uint32_t bytes = 0;
      bool ok;
      for (int n = 0; n < CPAIRS; ++n) pair_x(c, n, ok), bytes += ok ? (uint32_t)(d * sizeof(T)) : 0u;
      mbar_expect(xbar + xb, bytes);
      for (int n = 0; n < CPAIRS; ++n) {
        const T* src = pair_x(c, n, ok);
        if (ok) bulk_copy(s_x + (xb * CPAIRS + n) * dp, src, (uint32_t)(d * sizeof(T)), xbar + xb);
      }
    };
    if (x_tma && tp == 0)
      for (int c = 0; c < x_bufs && c < n_chunks; ++c) issue_x(c);
    // bf16: warp tp / 32 owns units 8 (tp / 32) .. + 7 (tile 0 gates i and f, tile 1 g and o,
    // lstm_common.cuh); its A fragments of W_ih into shared memory once.
    const int unit_t = (tp >> 5) * 8 + g8, gu_t = u0 + unit_t;
    uint4* wf = s_wf + (size_t)(tp >> 5) * KT * 2 * 32 + lane;
    float b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (is_bf16<T>) {
      const bool ok = gu_t < h;
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          const size_t lo = (size_t)(2 * tile * h + gu_t), hi = lo + h;
          const int k = kt * 16 + 2 * t4;
          wf[(kt * 2 + tile) * 32] = make_uint4(load_w2m(w_ih, ok, lo, k, d), load_w2m(w_ih, ok, hi, k, d),
                                                load_w2m(w_ih, ok, lo, k + 8, d), load_w2m(w_ih, ok, hi, k + 8, d));
        }
#pragma unroll
      for (int m = 0; m < 4; ++m) b4[m] = ok ? bias[m * h + gu_t] : 0.0f;
    } else {
      // fp32: the CTA's 128 rows of W_ih as [quad][gate][unit] float4 (row gate h + unit),
      // read from device memory in order, zero past the real widths; and unit tp % 32's biases.
      float* sw = reinterpret_cast<float*>(s_wf);
      const int cxl = cx_len<T>(d);
      for (int i = tp; i < CROWS * cxl; i += CPROD) {
        const int k = i % cxl, m = i / cxl / CU, u = i / cxl % CU;
        sw[(((k >> 2) * 4 + m) * CU + u) * 4 + (k & 3)] = load_wm(w_ih, u0 + u < h, (size_t)(m * h + u0 + u), k, d);
      }
      const int u = tp & 31;
#pragma unroll
      for (int m = 0; m < 4; ++m) b4[m] = u0 + u < h ? bias[m * h + u0 + u] : 0.0f;
      bar_sync(BAR_PROD, CPROD);  // every row is staged
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % NBUF;
      T* xs = s_x + (c % x_bufs) * CPAIRS * dp;
      if (x_tma) {
        mbar_wait_parity(xbar + c % x_bufs, (c / x_bufs) & 1);
      } else {
        stage<8>(CPAIRS * dp, tp, CPROD, [&](int i) {
          bool ok;
          const T* src = pair_x(c, i / dp, ok);
          return ok && i % dp < d ? load_f(src + i % dp) : 0.0f;
        }, [&](int i, float v) { store_f(xs + i, v); });
        bar_sync(BAR_PROD, CPROD);
      }
      if (c >= NBUF) bar_sync(BAR_EMPTY + buf, THREADS);  // the consumers are done with chunk c - NBUF
      float* ring = s_ring + buf * CPAIRS * CROWS;
      if constexpr (is_bf16<T>) {
        // Tensor cores: the chunk's 32 pairs are four 8-column tiles; bias, then the k-tiles in order.
        float acc[CPAIRS / 8][2][4];
#pragma unroll
        for (int nt = 0; nt < CPAIRS / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][0][e] = b4[e / 2], acc[nt][1][e] = b4[2 + e / 2];
        for (int kt = 0; kt < KT; ++kt) {
          const uint4 f0 = wf[(kt * 2) * 32], f1 = wf[(kt * 2 + 1) * 32];
          const uint32_t a0[4] = {f0.x, f0.y, f0.z, f0.w}, a1[4] = {f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int nt = 0; nt < CPAIRS / 8; ++nt) {
            const T* v = xs + (nt * 8 + g8) * dp + kt * 16 + 2 * t4;
            const uint32_t b0 = ld32(v), b1 = ld32(v + 8);
            mma_bf16(acc[nt][0], a0, b0, b1);
            mma_bf16(acc[nt][1], a1, b0, b1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < CPAIRS / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float4*>(ring + (nt * 8 + 2 * t4 + e) * CROWS + unit_t * 4) =
                make_float4(acc[nt][0][e], acc[nt][0][2 + e], acc[nt][1][e], acc[nt][1][2 + e]);
      } else {
        // CUDA cores: thread tp computes the four gates of unit tp % 32 for the warp's 8 pairs
        // 8 (tp / 32) .. + 7: a quad of W_ih (4 gates) serves 8 pairs and a quad of x (one
        // load, the same for the whole warp) 4 gates.  Each sum's terms in order, then the bias.
        const int u = tp & 31, p0 = (tp >> 5) * 8;
        const float4* wq = reinterpret_cast<const float4*>(s_wf) + u;  // [quad][gate][unit]
        float acc[4][8];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[m][i] = 0.0f;
#pragma unroll 2
        for (int kq = 0; kq < cx_len<T>(d) / 4; ++kq) {
          float4 w4[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) w4[m] = wq[(kq * 4 + m) * CU];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(xs + (p0 + i) * dp + 4 * kq);
#pragma unroll
            for (int m = 0; m < 4; ++m) dot_quad(acc[m][i], w4[m].x, w4[m].y, w4[m].z, w4[m].w, v);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(ring + (p0 + i) * CROWS + 4 * u) =
              make_float4(acc[0][i] + b4[0], acc[1][i] + b4[1], acc[2][i] + b4[2], acc[3][i] + b4[3]);
      }
      __threadfence_block();
      bar_arrive(BAR_FULL + buf, THREADS);
      bar_sync(BAR_PROD, CPROD);  // every producer is done reading s_x[c & 1]
      if (x_tma && tp == 0 && c + x_bufs < n_chunks) issue_x(c + x_bufs);
    }
  } else {
    // ---- consumers: the recurrence, h exchanged through the cluster in row bursts ----
    const int tc = threadIdx.x, lane = tc & 31, warp = tc >> 5;
    unsigned char* stage_w = s_stage + warp * CSTAGE;
    const uint32_t step_bytes = n_cta * CU * R * sizeof(T);
    if constexpr (is_bf16<T>) {
      // Tensor cores, as lstm_fwd_kernel's bf16 consumers: lane (g8, t4) ends with the four
      // gates of unit unit_t for rows 2 t4 and 2 t4 + 1 (the tile's columns).
      const int g8 = lane >> 2, t4 = lane & 3, unit_t = warp * 8 + g8, gu = u0 + unit_t, r0 = 2 * t4;
      uint32_t a_hh[2][HW / 16][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile)
#pragma unroll
        for (int kt = 0; kt < HW / 16; ++kt) {
          const size_t lo = (size_t)(2 * tile * h + gu), hi = lo + h;
          const int k = kt * 16 + 2 * t4;
          a_hh[tile][kt][0] = load_w2m(w_hh, gu < h, lo, k, h);
          a_hh[tile][kt][1] = load_w2m(w_hh, gu < h, hi, k, h);
          a_hh[tile][kt][2] = load_w2m(w_hh, gu < h, lo, k + 8, h);
          a_hh[tile][kt][3] = load_w2m(w_hh, gu < h, hi, k + 8, h);
        }
      const bool live[2] = {r0 < R, r0 + 1 < R};
      const bool store[2] = {live[0] && row0 + r0 < batch && gu < h, live[1] && row0 + r0 + 1 < batch && gu < h};
      float c_state[2] = {0.0f, 0.0f};
      size_t at = (size_t)(row0 + r0) * steps * h + gu;  // (row r0, t, unit) of y and cprev; row r0 + 1's + steps h
      T* st = reinterpret_cast<T*>(stage_w);             // [8 rows][8 units]: this warp's h_t
      for (int c = 0; c < n_chunks; ++c) {
        const int buf = c % NBUF;
        bar_sync(BAR_FULL + buf, THREADS);
        const float* ring = s_ring + buf * CPAIRS * CROWS;
        const int n = steps - c * S < S ? steps - c * S : S;
        for (int s = 0; s < n; ++s) {
          const int t = c * S + s;
          if (t > 0) mbar_wait_parity(mbar + ((t - 1) & 1), ((t - 1) >> 1) & 1);
          if (tc == 0) mbar_expect(mbar + (t & 1), step_bytes);
          const T* h_prev = s_h + ((t + 1) & 1) * HR * HP;
          float g[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (live[e]) {
              const float4 xp = *reinterpret_cast<const float4*>(ring + (s * R + r0 + e) * CROWS + unit_t * 4);
              g[0][e] = xp.x; g[0][2 + e] = xp.y; g[1][e] = xp.z; g[1][2 + e] = xp.w;
            }
#pragma unroll
          for (int kt = 0; kt < HW / 16; ++kt)
            if (kt * 16 < h) {  // the k-tiles past H hold zeros only
              const T* v = h_prev + g8 * HP + kt * 16 + 2 * t4;
              const uint32_t b0 = ld32(v), b1 = ld32(v + 8);
              mma_bf16(g[0], a_hh[0][kt], b0, b1);
              mma_bf16(g[1], a_hh[1][kt], b0, b1);
            }
          float hv[2] = {0.0f, 0.0f}, c_prev[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c_prev[e] = c_state[e];
            if (live[e]) {
              const float ig = sigmoid(g[0][e]), fg = sigmoid(g[0][2 + e]);
              const float gg = tanh_sig(g[1][e]), og = sigmoid(g[1][2 + e]);
              c_state[e] = fg * c_state[e] + ig * gg;
              hv[e] = og * tanh_sig(c_state[e]);
            }
          }
          __syncwarp();  // the last step's bursts are read
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (live[e]) store_f(st + (r0 + e) * 8 + g8, hv[e]);
          __syncwarp();
          // one 16-byte burst a row and CTA: lane b sends row b % R to CTA b / R
          for (int b = lane; b < R * (int)n_cta; b += 32) {
            const int r = b % R, k = b / R;
            const uint32_t off = (uint32_t)((((t & 1) * HR + r) * HP + u0 + warp * 8) * sizeof(T));
            st_async_peer_v4(peer_addr(s_h, k) + off, reinterpret_cast<const uint4*>(stage_w)[r],
                             peer_addr(mbar + (t & 1), k));
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (store[e]) {
              const size_t a = at + (size_t)e * steps * h;
              if (TRAIN) cprev[a] = c_prev[e];
              store_f(y + a, hv[e]);
            }
          at += h;
        }
        if (c + NBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, THREADS);
      }
    } else {
      // CUDA cores: thread tc is lane l of unit tc / 8 (4 units a warp); it holds
      // quads 8 q + l (q < HW / 32) of the unit's four gate rows, for every row.  A gate's
      // sum: the lane's part in order (q, then the term), + the part of lane l ^ 4, then
      // transpose_reduce4 over the quad: lane l (and l ^ 4) ends with gate l % 4.  The rows
      // go through it in groups of RG, so that a group's sums are in flight together.
      constexpr int NQ = HW / 32, RG = R < 4 ? R : 4;
      const int unit = tc / CLANES, l = tc % CLANES, gate = l & 3, gu = u0 + unit, uj = unit & 3;
      const int quad_lane = lane & ~3;
      float w[4][NQ][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[m][q][e] = load_wm(w_hh, gu < h, (size_t)(m * h + gu), 4 * (8 * q + l) + e, h);
      float c_state[R];
#pragma unroll
      for (int r = 0; r < R; ++r) c_state[r] = 0.0f;
      // Lane 0 of a unit stores y (and c_{t-1}) of the rows in the batch.
      const int n_store = l == 0 && gu < h ? (batch - row0 < R ? batch - row0 : R) : 0;
      const size_t row_stride = (size_t)steps * h;
      size_t at = (size_t)row0 * row_stride + gu;  // (row0, t, unit) of y and cprev; row r's + r row_stride
      float* st = reinterpret_cast<float*>(stage_w);  // [8 rows][4 units]: this warp's h_t
      for (int c = 0; c < n_chunks; ++c) {
        const int buf = c % NBUF;
        bar_sync(BAR_FULL + buf, THREADS);
        const float* ring = s_ring + buf * CPAIRS * CROWS;
        const int n = steps - c * S < S ? steps - c * S : S;
        for (int s = 0; s < n; ++s) {
          const int t = c * S + s;
          if (t > 0) mbar_wait_parity(mbar + ((t - 1) & 1), ((t - 1) >> 1) & 1);
          if (tc == 0) mbar_expect(mbar + (t & 1), step_bytes);
          const float* h_prev = s_h + ((t + 1) & 1) * HR * HP;
          float c_prev[R], hv[R];
#pragma unroll
          for (int g0 = 0; g0 < R; g0 += RG) {
            float part[RG][4];
#pragma unroll
            for (int r = 0; r < RG; ++r) {
#pragma unroll
              for (int m = 0; m < 4; ++m) part[r][m] = 0.0f;
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(h_prev + (g0 + r) * HP + 4 * (8 * q + l));
#pragma unroll
                for (int m = 0; m < 4; ++m) dot_quad(part[r][m], w[m][q][0], w[m][q][1], w[m][q][2], w[m][q][3], v);
              }
            }
#pragma unroll
            for (int r = 0; r < RG; ++r)
#pragma unroll
              for (int m = 0; m < 4; ++m) part[r][m] += __shfl_xor_sync(0xffffffffu, part[r][m], 4);
            float pre[RG], act[RG], ig[RG], fg[RG], gg[RG], og[RG];
            transpose_reduce4<2, 1, RG>(part, gate & 2, gate & 1, pre);
#pragma unroll
            for (int r = 0; r < RG; ++r)
              act[r] = activate(gate, ring[(s * R + g0 + r) * CROWS + unit * 4 + gate] + pre[r]);
            gather_gates<RG>(act, quad_lane, ig, fg, gg, og);
#pragma unroll
            for (int r = 0; r < RG; ++r) {
              c_prev[g0 + r] = c_state[g0 + r];
              c_state[g0 + r] = fg[r] * c_state[g0 + r] + ig[r] * gg[r];
              hv[g0 + r] = og[r] * tanh_sig(c_state[g0 + r]);
            }
          }
          __syncwarp();  // the last step's bursts are read
          if (l == 0)
#pragma unroll
            for (int r = 0; r < R; ++r) st[r * 4 + uj] = hv[r];
          __syncwarp();
          for (int b = lane; b < R * (int)n_cta; b += 32) {
            const int r = b % R, k = b / R;
            const uint32_t off = (uint32_t)((((t & 1) * HR + r) * HP + u0 + warp * 4) * sizeof(float));
            st_async_peer_v4(peer_addr(s_h, k) + off, reinterpret_cast<const uint4*>(stage_w)[r],
                             peer_addr(mbar + (t & 1), k));
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < n_store) {
              if (TRAIN) cprev[at + r * row_stride] = c_prev[r];
              y[at + r * row_stride] = hv[r];
            }
          at += h;
        }
        if (c + NBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, THREADS);
      }
    }
  }
  if (threadIdx.x < NC) mbar_wait_parity(mbar + ((steps - 1) & 1), ((steps - 1) >> 1) & 1);  // the last h is in
  cluster_sync_all();  // and no CTA leaves while a peer may still send to it
}

template <typename T, bool TRAIN, int R, int HW>
int launch_cluster_rows(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,
                        float* cprev, int batch, int steps, int d, int h, void* stream) {
  static SmemOnce once;  // the card's opt-in limit: the need grows with D
  cudaError_t err = once.set(lstm_fwd_cluster_kernel<T, TRAIN, R, HW>, 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const int x_bufs = fwd_cluster_x_bufs<T, R, HW>(d);
  const cudaLaunchConfig_t cfg = cluster_config(attr, (batch + R - 1) / R, h, CCONS<T> + CPROD,
                                                fwd_cluster_smem_bytes<T, R, HW>(d, x_bufs), (cudaStream_t)stream);
  const int x_tma = (uintptr_t)x % 16 == 0 && ((size_t)d * sizeof(T)) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<T, TRAIN, R, HW>, (const T*)x, w_ih, w_hh, bias,
                           (T*)y, cprev, batch, steps, d, h, x_tma, x_bufs);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Clusters of R rows the device holds at once for widths (d, h), by
// cudaOccupancyMaxActiveClusters (a GPC holds whole clusters only, so fewer
// than sm_count / K), or -cudaError.
template <typename T, int R, int HW>
int cluster_slots_rows(int d, int h) {
  static SmemOnce once;
  cudaError_t err = once.set(lstm_fwd_cluster_kernel<T, false, R, HW>, 0);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, 1, h, CCONS<T> + CPROD,
                                                fwd_cluster_smem_bytes<T, R, HW>(d, fwd_cluster_x_bufs<T, R, HW>(d)), 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_fwd_cluster_kernel<T, false, R, HW>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int HW>
int cluster_slots_hw(int rows, int d, int h) {
  switch (rows) {
    case 1: return cluster_slots_rows<T, 1, HW>(d, h);
    case 2: return cluster_slots_rows<T, 2, HW>(d, h);
    case 4: return cluster_slots_rows<T, 4, HW>(d, h);
    case 8: return cluster_slots_rows<T, 8, HW>(d, h);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename T>
int cluster_slots(int rows, int d, int h) {
  if (d < 1 || h < 1 || d > CLUSTER_MAX_WIDTH || h > CLUSTER_MAX_WIDTH) return -(int)cudaErrorInvalidValue;
  return h <= 128 ? cluster_slots_hw<T, 128>(rows, d, h) : cluster_slots_hw<T, 256>(rows, d, h);
}

template <typename T, bool TRAIN, int HW>
int launch_cluster_hw(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,
                      float* cprev, int batch, int steps, int d, int h, int rows, void* stream) {
  switch (rows) {
    case 1: return launch_cluster_rows<T, TRAIN, 1, HW>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, stream);
    case 2: return launch_cluster_rows<T, TRAIN, 2, HW>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, stream);
    case 4: return launch_cluster_rows<T, TRAIN, 4, HW>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, stream);
    case 8: return launch_cluster_rows<T, TRAIN, 8, HW>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool TRAIN>
int launch_cluster(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,
                   float* cprev, int batch, int steps, int d, int h, int rows, void* stream) {
  if (d < 1 || h < 1 || d > CLUSTER_MAX_WIDTH || h > CLUSTER_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  return h <= 128 ? launch_cluster_hw<T, TRAIN, 128>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, rows, stream)
                  : launch_cluster_hw<T, TRAIN, 256>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, rows, stream);
}
}  // namespace

extern "C" {

// The cluster kernels (_cluster) for any 1 <= D, H <= 256.  x: (B, T, D)
// and y: (B, T, H) in the instantiation's type; w_ih: (4H, D), w_hh: (4H,
// H) fp32, bias: (4H,) fp32; cprev (kernel B): (B, T, H) fp32, c_{t-1} of
// every step; all contiguous on the current device.  rows: batch rows per
// cluster, 1, 2, 4 or 8.  short_path must be 0.  Returns the cudaError_t of
// the launch (0 = launched).
int awm_lstm_fwd_f32_cluster(const void* x, const float* w_ih, const float* w_hh, const float* bias,
                             void* y, int batch, int steps, int d, int h, int rows, int short_path,
                             void* stream) {
  return short_path ? (int)cudaErrorInvalidValue
                    : launch_cluster<float, false>(x, w_ih, w_hh, bias, y, nullptr, batch, steps, d, h, rows, stream);
}
int awm_lstm_fwd_bf16_cluster(const void* x, const float* w_ih, const float* w_hh, const float* bias,
                              void* y, int batch, int steps, int d, int h, int rows, int short_path,
                              void* stream) {
  return short_path ? (int)cudaErrorInvalidValue
                    : launch_cluster<__nv_bfloat16, false>(x, w_ih, w_hh, bias, y, nullptr, batch, steps, d, h,
                                                           rows, stream);
}
int awm_lstm_fwd_train_f32_cluster(const void* x, const float* w_ih, const float* w_hh, const float* bias,
                                   void* y, float* cprev, int batch, int steps, int d, int h, int rows,
                                   int short_path, void* stream) {
  return short_path ? (int)cudaErrorInvalidValue
                    : launch_cluster<float, true>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, rows, stream);
}
int awm_lstm_fwd_train_bf16_cluster(const void* x, const float* w_ih, const float* w_hh, const float* bias,
                                    void* y, float* cprev, int batch, int steps, int d, int h, int rows,
                                    int short_path, void* stream) {
  return short_path ? (int)cudaErrorInvalidValue
                    : launch_cluster<__nv_bfloat16, true>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h,
                                                          rows, stream);
}

// Clusters of `rows` rows (1, 2, 4 or 8) of kernel A that the current
// device holds at once for widths (d, h) on the cluster path; a negative
// value is -cudaError.  Kernel B's instantiations take the same resources.
int awm_lstm_fwd_cluster_slots(int bf16, int rows, int d, int h) {
  return bf16 ? cluster_slots<__nv_bfloat16>(rows, d, h) : cluster_slots<float>(rows, d, h);
}

const char* awm_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
