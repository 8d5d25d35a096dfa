// LSTM kernels A, B and C for Hopper (sm_90a) at widths past 256 (max(D, H)
// > 256): the wide path.  Replaces, at those widths, the three TPU kernels of
// awm_tpu/ops/pallas/lstm_kernel.py: lstm_pallas_forward + _lstm_kernel (the
// pallas_call at line 157, A), _forward_train + _lstm_train_kernel (line 342,
// B) and _backward + _lstm_bwd_kernel (line 391, C).  lstm_fwd.cu has the
// precision contract; A and B keep it here (fp32: full fp32, no TF32; bf16:
// bf16 operands with the recurrent h rounded to bf16 before its product, fp32
// sums, fp32 (h, c) and gates, y in bf16), and C's weight gradients are fp32,
// dx in x's type.  A library of its own, built in parallel with the others.
//
// Why a path of its own.  Past 256 a cluster CTA's slice of W_hh (128 gate
// rows x H terms) fits neither its registers nor its shared memory, a cluster
// stops at 16 CTAs, and the cluster backward's records for all of T grow
// without bound (16.8 GB at B = 128, H = 256).  So, as the TPU kernel's own
// grid does, the wide path works in windows of time: the plan
// (ops/lstm_kernel.py::launch_plan) picks a window of tc steps so that a
// call's scratch stays within a budget whatever T is, and the C entry points
// below loop over the windows on the stream, carrying the state between
// windows in small fp32 buffers ((h, c) forward, (dh, dc) backward).  h (and
// in the backward da) goes from SM to SM through global memory:
// - A / B, per window: the input projection xp = b + x W_ih^T of every (row,
//   step) of the window, (B, tc, 4H) fp32, by the gate pass of kernel C run
//   over x's terms only (XP = true: bf16 the tensor-core gate pass, fp32
//   the CUDA cores', both lstm_any.cuh's); then the recurrence, lstm_wide_fwd_kernel: a CTA owns
//   a tile of WU = 16 hidden units (all four gates: 64 rows of W_hh, in
//   shared memory in the operand type where they fit beside the step's h,
//   else read from a packed copy in global memory, L2-resident) for up to
//   WMAX_R batch rows; ceil(H / 16) CTAs form a row group (fewer, of more
//   tiles, past what the card holds: see Residency).  Each step a CTA stages h_{t-1} of its
//   rows (y of the step before, read past L1: the whole row where it fits
//   shared memory beside W_hh's slice in global memory, else in chunks of
//   512 bytes a row through a ring), forms its gates from xp and
//   its W_hh rows, updates c in registers, writes h_t to y (and c_{t-1}), and
//   meets the other CTAs of its row group at one barrier in global memory
//   (a counter a group: release-add after the step's stores, acquire-spin
//   before the next step's reads).  bf16: the gate sums continue xp's in
//   the gate pass's order (one mma accumulator over h's k-tiles in order).
//   fp32: every warp takes a tile of (gate rows x batch rows) at any rows a
//   group, four lanes the four interleaved segments of each sum
//   (wide_f32_sums), and a gate is xp + their sum (lstm_any.cuh's QSEGS
//   order); C's fp32 gate pass sums h in that order (gate_pass's SPLIT), so
//   C recomputes the forward's gates bit for bit in both types;
// - C, per window in reverse: the gate pass's records of the window (B, tc,
//   H, 8) (the same gate passes, XP = false); the recurrence, lstm_wide_bwd_kernel,
//   which carries (dh, dc): each step a CTA forms da of its 64 gate columns
//   from the records, writes it (rounded to the operand type) to the
//   window's da scratch, meets its group at the barrier, stages da_t of its
//   rows in chunks of 512 bytes a row (cp.async into a ring of 6 bf16, 4
//   fp32: the product starts on the first chunk while the rest are in
//   flight) and
//   forms dh_{t-1} of its units from W_hh's columns for them (fp32 on the
//   CUDA cores in fixed interleaved K segments; bf16 on mma.sync with
//   ldmatrix fragments, k-tiles interleaved over the warps, summed in a
//   fixed order whatever the chunk); then the window's dx and dW
//   (lstm_any.cuh's, which lstm_bwd.cu's paths run too: fp32 128 x 128
//   tiles of 8 x 8 a thread; bf16 on the tensor cores, 128 x 128 tiles fed
//   by a cp.async ring), the dW partials added across windows in the order
//   they run, and, after the last window, the ordered sum.  No atomics on values:
//   two calls give the same bits.
// Residency: a barrier through global memory deadlocks unless every CTA of a
// group is resident at once, so each recurrence is a cooperative launch
// (cudaLaunchCooperativeKernel) of as many row groups as the card holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, per call); more row
// groups run in successive launches.  Where the card does not hold a group's
// ceil(H / 16) CTAs at once (H > 2112 at one CTA an SM of an H100's 132), a
// CTA owns more than one tile of 16 units (group_ctas: as few CTAs as fit,
// the tiles spread evenly) and runs them in turn each step, W_hh's slices
// read from the packed copy and the tiles' state (c; dc, dh, db) kept in
// global memory between turns, each tile's sums as an untiled CTA's.  What
// bounds the width: nothing of a CTA's shared memory grows with H but
// W_hh's slice, which moves to global memory where it does not fit, and the
// staged h / da come in chunks; the card's memory bounds it (W_hh and its
// packed copy, fp32 2 x 4 (4H) H bytes: 54 GB each at H = 58096).  A
// refused launch (another kernel or an MPS client holding SMs) returns its
// error and the call raises; a spin that outlasts WAIT_NS traps, so that a
// fault cannot hang the card.
// What bounds it on this card: the step's latency (ops/bench_lstm.py
// --split, PERF.md section 6: C's step at one row ~7.5 us bf16, ~9 us fp32,
// mostly the staging of da through L2 and the dh product, the barrier ~1
// us); at large batches the products (fp32: B 4H H FMAs a step on the CUDA
// cores, their operands from shared memory: A / B's tiles spread them over
// every warp at any rows), far above the bound of the call's bytes and
// FLOPs.
//
// Plain C interface, loaded with ctypes by awm_tpu_torch/ops/lstm_kernel.py.

#include "lstm_any.cuh"
#include "lstm_common.cuh"

namespace {

using namespace awm;

constexpr int WTHREADS = 256;
constexpr int WMAX_R = 64;      // batch rows a row group at most
constexpr int PMAX = WMAX_R * WU / WTHREADS;  // (unit, row) pairs a thread at most
constexpr unsigned long long WAIT_NS = 20000000000ull;  // a barrier wait past 20 s traps

// Parts of a recurrence's step switched off, for ops/bench_lstm.py --split
// alone (a build of its own, -DAWM_WIDE_SPLIT=mask; the library the port
// loads has none): 1 the row group's barrier, 2 the staging of h / da, 4
// the recurrent product, 8 the rest of the step (A, B: xp, the gates, y and
// c; C: the records, da and its store).  The results are then wrong.
#ifndef AWM_WIDE_SPLIT
#define AWM_WIDE_SPLIT 0
#endif
constexpr int SPLIT = AWM_WIDE_SPLIT;
// A build for the gates check alone (-DAWM_WIDE_GATES=1, ops/bench_lstm.py
// --gates): fp32 A / B write each step's gates over the window's xp, and
// awm_lstm_wide_gates_check compares them with C's gate pass.
#ifndef AWM_WIDE_GATES
#define AWM_WIDE_GATES 0
#endif
constexpr bool GATES = AWM_WIDE_GATES;

// Terms of the staged operand (A / B: h_{t-1}, H; C: da_t, 4H) in whole
// k-tiles: a chunk of this many is the whole row.
__host__ __device__ constexpr int whole_terms(int bwd, int h) { return round_up(bwd ? 4 * h : h, 16); }
// Terms of a chunk where the operand is staged in chunks: 512 bytes a row.
template <typename T> __host__ __device__ constexpr int chunk_terms() { return is_bf16<T> ? 256 : 128; }
// Buffers of a chunked ring (all but one in flight while one is multiplied:
// a step's chunks wait on L2's latency, not its rate), as many as leave C's
// 32 rows W_hh's slice in shared memory at 512.
template <typename T> __host__ __device__ constexpr int ring_depth() { return is_bf16<T> ? 6 : 4; }
// Buffers of the ring at chunks of kc terms: one for the whole row.
template <typename T> __host__ __device__ constexpr int ring_bufs(int bwd, int h, int kc) {
  return kc >= whole_terms(bwd, h) ? 1 : ring_depth<T>();
}
// Rows of a ring buffer: bf16 in whole mma tiles (A / B: n-tiles of 8; C:
// m-tiles of 16, read by ldmatrix), the rows past a group's zero.
template <typename T> __host__ __device__ constexpr int ring_rows(int bwd, int r) {
  return is_bf16<T> ? round_up(r, bwd ? 16 : 8) : r;
}
// Dynamic shared memory of a CTA of `rows` rows whose staged operand comes in
// chunks of kc terms, with W_hh's slice (w_smem) or without it.  fp32 A / B:
// also the step's gate sums [rows][64] beside them.  C: the ring
// region also holds db [rows][64] fp32 at the end; then dh [rows][16] and the
// dh product's partials (bf16: [segments][m-tiles x 16 rows][16], segments x
// m-tiles <= 4; fp32: [8 warps][rows][16] from 8 rows, else segments x
// outputs <= 256).  Nothing grows with H but
// W_hh's slice, which a row group reads from global memory where it does not
// fit.
template <typename T> size_t wide_smem(int bwd, int h, int rows, int w_smem, int kc) {
  const size_t ring = sizeof(T) * (size_t)ring_bufs<T>(bwd, h, kc) * ring_rows<T>(bwd, rows) * wide_pitch<T>(kc);
  if (!bwd)
    return ring + (w_smem ? sizeof(T) * (size_t)WROWS * wide_pitch<T>(h) : 0) +
           (is_bf16<T> ? 0 : sizeof(float) * (size_t)rows * WROWS);
  const size_t db = sizeof(float) * (size_t)rows * WROWS;
  return (ring > db ? ring : db) + (w_smem ? sizeof(T) * (size_t)WU * wide_pitch<T>(4 * h) : 0) +
         sizeof(float) * (size_t)rows * WU + sizeof(float) * WU * (is_bf16<T> || 8 * rows < 64 ? 64 : 8 * rows);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// The row group's barrier: every CTA's thread 0 adds one with release after
// the step's stores (the CTA's other threads' stores are ordered before it
// by the __syncthreads that precedes the call, and a release is cumulative
// over them) and spins with acquire until the count reaches target; a
// __syncthreads after the wait orders the CTA's reads after it.  No fence
// beside them (a fence.sc a step cost more than the step's work).
__device__ __forceinline__ void group_arrive(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}
__device__ __forceinline__ void group_wait(const unsigned* count, unsigned target) {
  unsigned long long t0 = 0;
  for (unsigned spin = 0;; ++spin) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    if ((int)(v - target) >= 0) break;
    if ((spin & 1023) == 0) {  // the clock now and then: a wait past WAIT_NS traps
      const unsigned long long now = global_ns();
      if (spin == 0) t0 = now;
      else if (now - t0 > WAIT_NS) __trap();
    }
  }
}

// A chunk of len terms of `rows` rows (row r at src + r spitch, another SM
// wrote them this launch) into a ring buffer of row pitch kp, past L1: vec
// (both ends of every row 16-byte aligned) 16 bytes at a time, by cp.async
// (in flight until the caller's cp_async_wait) where ASYNC (C), else by
// loads and stores (A, B: cp.async's code would take bf16 A / B past two
// CTAs an SM); not vec one element at a time.
// The terms past len up to the next k-tile are zeroed (the product reads
// whole k-tiles).
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_chunk(T* dst, int kp, const T* src, size_t spitch, int rows, int len, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = len / V;
    for (int i = threadIdx.x; i < rows * nv; i += WTHREADS) {
      const int r = i / nv, q = i % nv;
      if constexpr (ASYNC) cp_async16(dst + (size_t)r * kp + q * V, src + r * spitch + q * V);
      else *reinterpret_cast<uint4*>(dst + (size_t)r * kp + q * V) = __ldcg(reinterpret_cast<const uint4*>(src + r * spitch) + q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * len; i += WTHREADS) {
      const int r = i / len, k = i % len;
      dst[(size_t)r * kp + k] = __ldcg(src + r * spitch + k);
    }
  }
  const int tail = round_up(len, 16) - len;
  for (int i = threadIdx.x; i < rows * tail; i += WTHREADS) store_f(dst + (size_t)(i / tail) * kp + len + i % tail, 0.0f);
}

// The recurrent product over the staged operand's chunks c = 0 .. nc - 1,
// chunk c in ring buffer c % nb: stage(c, buf) issues its copy, mul(c, buf)
// multiplies it.  nb = NB: NB - 1 chunks in flight while one is multiplied,
// one __syncthreads a chunk; nb = 1: the whole row (nc = 1).  load = false
// multiplies what the ring holds (zeros at a call's first step, or the
// whole row staged for an earlier unit tile of the step).  The caller keeps
// every thread past the ring's last use before it stages into it again.
template <int NB, typename Stage, typename Mul>
__device__ __forceinline__ void ring_run(int nc, int nb, bool load, Stage stage, Mul mul) {
  const int ahead = nb > 1 ? nb - 1 : 1;
  if (load)
    for (int c = 0; c < ahead; ++c) {
      if (c < nc) stage(c, c);
      cp_async_commit();
    }
  for (int c = 0; c < nc; ++c) {
    if (load) {
      if (nb > 1) cp_async_wait<NB - 2>();
      else cp_async_wait<0>();
    }
    __syncthreads();  // chunk c in for every thread, and every thread past chunk c - 1 (whose buffer is next)
    if (load) {
      if (c + ahead < nc) stage(c + ahead, (c + ahead) % nb);
      cp_async_commit();
    }
    mul(c, c % nb);
  }
}

// The fp32 gate sums of a step of lstm_wide_fwd_kernel: each gate row's h
// product over the staged chunks of h_{t-1} in the wide recurrence's order
// (lstm_any.cuh's QSEGS segments, then quad_sum), for every row of the group,
// into s_gate[row][gate row].  The tile of a warp follows the group's rows
// (up to the power of two GR BR >= rows; rows past the group's read its last
// row and are not written): gate rows wb .. (GR sets of 8, wb = 8 GR (w % (8
// / GR))) x batch rows bb .. bb + BR - 1 (bb = BR (w / (8 / GR))), so every
// warp works at any rows; lane group g = lane / 4 takes the gate rows rho(g)
// + 8 i of the warp's (rho(g) = g / 2 + 4 (g % 2): the two groups of a
// quarter-warp read W rows 4 apart, whose 64 bytes fall in distinct banks),
// lane % 4 its segment, and every group of a warp reads the same h quads.  A
// lane's GR + BR 16-byte loads feed 4 GR BR products.
template <int GR, int BR, typename Stage>
__device__ __forceinline__ void wide_f32_sums(int nc, int nb, bool load, Stage stage, const float* ring, int rp, int kp,
                                              int kc, int h, const float* w, int hp, int nrows, float* s_gate) {
  constexpr int N = GR * BR, WG = 8 / GR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, seg = lane & 3;
  const int wb = 8 * GR * (warp % WG) + (g >> 1) + 4 * (g & 1), bb = BR * (warp / WG);
  const float* wr = w + (size_t)wb * hp;
  float acc[N] = {};
  ring_run<ring_depth<float>()>(nc, nb, load, stage, [&](int c, int buf) {
    if (SPLIT & 4) return;
    const float* hb = ring + (size_t)buf * rp * kp;
    const int q0 = c * (kc / 4), nq = round_up(min(kc, h - c * kc), 16) / 4;
    for (int q = seg; q < nq; q += QSEGS) {
      float4 wq[GR], v[BR];
#pragma unroll
      for (int i = 0; i < GR; ++i) wq[i] = *reinterpret_cast<const float4*>(wr + (size_t)8 * i * hp + 4 * (q0 + q));
#pragma unroll
      for (int b = 0; b < BR; ++b)
        v[b] = *reinterpret_cast<const float4*>(hb + (size_t)min(bb + b, nrows - 1) * kp + 4 * q);
#pragma unroll
      for (int i = 0; i < GR; ++i)
#pragma unroll
        for (int b = 0; b < BR; ++b) dot_quad(acc[i * BR + b], wq[i].x, wq[i].y, wq[i].z, wq[i].w, v[b]);
    }
  });
  quad_sum(acc, lane);
  // the sums this lane holds (N < 4: one lane of those that hold the same)
  if (N == 2 ? (seg & 1) : N == 1 ? seg : 0) return;
#pragma unroll
  for (int e = 0; e < (N >= 4 ? N / 4 : 1); ++e) {
    const int idx = N >= 4 ? seg * (N / 4) + e : N == 2 ? seg >> 1 : 0, r = bb + idx % BR;
    if (r < nrows) s_gate[r * WROWS + wb + 8 * (idx / BR)] = acc[e];
  }
}

template <typename T>
struct WideFwd {
  float* xp;         // (B, tc, 4h) fp32: the window's b + x W_ih^T (GATES: the step's gates after)
  const T* wpack;    // lstm_wide_pack_kernel's forward slices
  T* y;              // (B, T, h)
  float* cprev;      // (B, T, h) fp32 (B) or null (A)
  float* c_state;    // (B, h) fp32: c after the last window (tiled: after the last step)
  unsigned* count;   // a counter a row group, zero at the call's start: ctas a step
  int batch, steps, h, t0, tc, rows, g0, w_smem, ctas, kc;  // kc: terms a staged chunk of h (whole_terms: the row)
};

// Kernel A / B's recurrence over one window, row groups g0 .. of `rows`
// rows, `ctas` CTAs each (blockIdx.x = (group - g0) ctas + cta).  CTA cta
// owns the unit tiles cta, cta + ctas, ... of the group's ceil(h / 16); with
// more than one tile a CTA (ctas < ceil(h / 16), tiled) it runs its tiles in
// turn each step, W_hh's slices read from the packed copy and c kept in
// c_state between turns (the same sums in the same order: the same bits).
// h_{t-1} is staged whole (kc = whole_terms) or in chunks of kc terms
// through a ring (each tile of a tiled CTA stages them again); either way
// each gate's sum runs over h's terms (fp32) or k-tiles (bf16) in order, so
// the chunks leave the bits as they are (bf16: each gate's sum over h's
// k-tiles in order; fp32: each segment's quads in order, wide_f32_sums).
// TILED: compiled apart, so that the untiled recurrence keeps its registers
// (and the CTAs an SM holds).
template <typename T, bool TRAIN, bool TILED>
__global__ void __launch_bounds__(WTHREADS, 1) lstm_wide_fwd_kernel(const WideFwd<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool tiled = TILED;
  const int h = a.h, hp = wide_pitch<T>(h), kc = a.kc, kp = wide_pitch<T>(kc), kk = n_cta(h), nct = a.ctas;
  const int tid = threadIdx.x, nb = ring_bufs<T>(0, h, kc), nc = (h + kc - 1) / kc;
  const bool whole = nb == 1;
  const int grp = a.g0 + blockIdx.x / nct, cta = blockIdx.x % nct, n_tiles = tiled ? (kk - cta + nct - 1) / nct : 1;
  const int row0 = grp * a.rows, nrows = min(a.rows, a.batch - row0), rp = ring_rows<T>(0, a.rows);
  const size_t steps = a.steps, g4 = 4 * (size_t)h;
  T* ring = reinterpret_cast<T*>(smem);  // [nb][rp][kp]: h_{t-1} of the group's rows by chunks, zero past nrows
  const T* s_w = a.wpack + (size_t)cta * WROWS * hp;
  for (int i = tid; i < nb * rp * kp; i += WTHREADS) store_f(ring + i, 0.0f);
  if (a.w_smem) {  // never tiled
    T* w = ring + (size_t)nb * rp * kp;
    const int n16 = WROWS * hp * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += WTHREADS)
      reinterpret_cast<uint4*>(w)[i] = reinterpret_cast<const uint4*>(s_w)[i];
    s_w = w;
  }
  // fp32: the step's gate sums [rows][64 gate rows] (wide_f32_sums), beside W_hh's slice
  float* s_gate = reinterpret_cast<float*>(ring + (size_t)nb * rp * kp + (a.w_smem ? (size_t)WROWS * hp : 0));
  unsigned* count = a.count + grp;
  const bool vec = (h * sizeof(T)) % 16 == 0;
  const int lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
  // fp32: thread pairs (unit tid % 16, row tid / 16 + 16 j); bf16: warp's unit group and n-tiles
  float c_st[PMAX][2];
  // c of the thread's pairs of the tile at unit u0, from c_state (else zero), and back
  auto load_c = [&](int u0, bool from) {
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      if constexpr (is_bf16<T>) {
        // bf16: item j of warp w is unit group w % 2 (units 8 (w % 2) + g8), n-tile w / 2 + 4 j (rows + 2 t4 + e)
        const int u = (warp & 1) * 8 + g8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ((warp >> 1) + 4 * j) * 8 + 2 * t4 + e;
          c_st[j][e] = from && j < 2 && r < nrows && u0 + u < h ? a.c_state[(size_t)(row0 + r) * h + u0 + u] : 0.0f;
        }
      } else {
        const int u = tid % WU, r = tid / WU + (WTHREADS / WU) * j;
        c_st[j][0] = from && r < nrows && u0 + u < h ? a.c_state[(size_t)(row0 + r) * h + u0 + u] : 0.0f;
        c_st[j][1] = 0.0f;
      }
    }
  };
  auto store_c = [&](int u0) {
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      if constexpr (is_bf16<T>) {
        const int u = (warp & 1) * 8 + g8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ((warp >> 1) + 4 * j) * 8 + 2 * t4 + e;
          if (j < 2 && r < nrows && u0 + u < h) a.c_state[(size_t)(row0 + r) * h + u0 + u] = c_st[j][e];
        }
      } else {
        const int u = tid % WU, r = tid / WU + (WTHREADS / WU) * j;
        if (r < nrows && u0 + u < h) a.c_state[(size_t)(row0 + r) * h + u0 + u] = c_st[j][0];
      }
    }
  };
  if (!tiled) load_c(cta * WU, a.t0 > 0);
  __syncthreads();
  const int r0 = tid / WU;
  int np = 0;  // fp32: pairs of this thread with a live row
#pragma unroll
  for (int j = 0; j < PMAX; ++j) np += r0 + 16 * j < nrows;
  for (int s = 0; s < a.tc; ++s) {
    const int t = a.t0 + s;
    // chunk c of h_{t-1} (y of the step before) of the group's rows into ring buffer buf
    auto stage = [&](int c, int buf) {
      stage_chunk<T, false>(ring + (size_t)buf * rp * kp, kp,
                            a.y + ((size_t)row0 * steps + t - 1) * h + (size_t)c * kc, steps * h, nrows,
                            min(kc, h - c * kc), vec);
    };
    for (int tile_i = 0; tile_i < n_tiles; ++tile_i) {
      const int tile = cta + tile_i * nct, u0 = tile * WU;
      const T* wsl = tiled ? a.wpack + (size_t)tile * WROWS * hp : s_w;
      if (tiled) load_c(u0, t > 0);
      // the gate sums start from xp, read (the first tile's) before the wait so that its latency overlaps the
      // barrier's: bf16 acc[2 j + tile][e] (item j), fp32 acc[j][gate] (pair j)
      float acc[PMAX][4];
      if constexpr (is_bf16<T>) {
        const int gu = u0 + (warp & 1) * 8 + g8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = (warp >> 1) + 4 * j;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = nt * 8 + 2 * t4 + e;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (!(SPLIT & 8) && r < nrows && gu < h) {
              const float* x4 = a.xp + ((size_t)(row0 + r) * a.tc + s) * g4 + gu;
              v = make_float4(x4[0], x4[h], x4[2 * h], x4[3 * h]);
            }
            acc[2 * j][e] = v.x, acc[2 * j][2 + e] = v.y, acc[2 * j + 1][e] = v.z, acc[2 * j + 1][2 + e] = v.w;
          }
        }
      } else {
        const int gu = u0 + tid % WU;
#pragma unroll
        for (int j = 0; j < PMAX; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[j][m] = !(SPLIT & 8) && j < np && gu < h
                            ? a.xp[((size_t)(row0 + r0 + 16 * j) * a.tc + s) * g4 + (size_t)m * h + gu] : 0.0f;
      }
      if (t > 0 && tile_i == 0) {
        if (!(SPLIT & 1) && tid == 0) group_wait(count, (unsigned)nct * (unsigned)t);
        __syncthreads();
      }
      if (!whole && tile_i > 0) __syncthreads();  // every thread past the tile before's last chunk
      const bool load = !(SPLIT & 2) && t > 0 && (tile_i == 0 || !whole);
      if constexpr (is_bf16<T>) {
        const int ug = warp & 1, u = ug * 8 + g8, gu = u0 + u;
        const bool live1 = ((warp >> 1) + 4) * 8 < nrows, live0 = (warp >> 1) * 8 < nrows;
        const T* w0 = wsl + (size_t)(ug * 32 + g8) * hp + 2 * t4;  // tile 0 (i | f); tile 1 (g | o) 16 rows on
        ring_run<ring_depth<T>()>(nc, nb, load, stage, [&](int c, int buf) {
          if ((SPLIT & 4) || !live0) return;
          const T* hb = ring + (size_t)buf * rp * kp + 2 * t4;
          const int kt0 = c * (kc / 16), ktn = (min(kc, h - c * kc) + 15) / 16;
          for (int kt = 0; kt < ktn; ++kt) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const T* p = w0 + (size_t)mt * 16 * hp + (kt0 + kt) * 16;
              af[mt][0] = ld32(p), af[mt][1] = ld32(p + 8 * hp), af[mt][2] = ld32(p + 8), af[mt][3] = ld32(p + 8 * hp + 8);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (j == 0 || live1) {
                const T* v = hb + (size_t)(((warp >> 1) + 4 * j) * 8 + g8) * kp + kt * 16;
                const uint32_t b0 = ld32(v), b1 = ld32(v + 8);
                mma_bf16(acc[2 * j], af[0], b0, b1);
                mma_bf16(acc[2 * j + 1], af[1], b0, b1);
              }
          }
        });
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = ((warp >> 1) + 4 * j) * 8 + 2 * t4 + e;
            if (!(SPLIT & 8) && r < nrows && gu < h) {
              const float ig = sigmoid(acc[2 * j][e]), fg = sigmoid(acc[2 * j][2 + e]);
              const float gg = tanh_sig(acc[2 * j + 1][e]), og = sigmoid(acc[2 * j + 1][2 + e]);
              const float c_prev = c_st[j][e];
              c_st[j][e] = fg * c_prev + ig * gg;
              const size_t at = ((size_t)(row0 + r) * steps + t) * h + gu;
              if (TRAIN) a.cprev[at] = c_prev;
              store_f(a.y + at, og * tanh_sig(c_st[j][e]));
            }
          }
      } else {
        // the gate sums in the wide recurrence's order (wide_f32_sums), then each pair's gates from xp + them
        const float* wf = reinterpret_cast<const float*>(wsl);
        const float* hr = reinterpret_cast<const float*>(ring);
        if (a.rows <= 1) wide_f32_sums<1, 1>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else if (a.rows <= 2) wide_f32_sums<1, 2>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else if (a.rows <= 4) wide_f32_sums<1, 4>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else if (a.rows <= 8) wide_f32_sums<1, 8>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else if (a.rows <= 16) wide_f32_sums<2, 8>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else if (a.rows <= 32) wide_f32_sums<4, 8>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        else wide_f32_sums<8, 8>(nc, nb, load, stage, hr, rp, kp, kc, h, wf, hp, nrows, s_gate);
        __syncthreads();  // every sum in s_gate
        const int u = tid % WU, gu = u0 + u;
#pragma unroll
        for (int j = 0; j < PMAX; ++j)
          if (!(SPLIT & 8) && j < np && gu < h) {
            const float* sg = s_gate + (size_t)(r0 + 16 * j) * WROWS + ((u >> 3) * 2) * 16 + (u & 7);
            float pre[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) pre[m] = acc[j][m] + sg[(m >> 1) * 16 + (m & 1) * 8];
            const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]), gg = tanh_sig(pre[2]), og = sigmoid(pre[3]);
            const float c_prev = c_st[j][0];
            c_st[j][0] = fg * c_prev + ig * gg;
            const size_t at = ((size_t)(row0 + r0 + 16 * j) * steps + t) * h + gu;
            if (TRAIN) a.cprev[at] = c_prev;
            a.y[at] = og * tanh_sig(c_st[j][0]);
            if constexpr (GATES)
#pragma unroll
              for (int m = 0; m < 4; ++m) a.xp[((size_t)(row0 + r0 + 16 * j) * a.tc + s) * g4 + (size_t)m * h + gu] = pre[m];
          }
      }
      if (tiled) store_c(u0);
    }
    __syncthreads();  // every store of the step is issued before the arrival
    if (!(SPLIT & 1) && tid == 0) group_arrive(count);
  }
  if (!tiled) store_c(cta * WU);  // c after the window, for the next one
}

template <typename T>
struct WideBwd {
  const float* rec;  // (B, tc, h, 8) fp32: the window's records (lstm_any.cuh's gate pass)
  const T* wpack;    // lstm_wide_pack_kernel's backward slices
  T* da;             // (B, tc, 4h): the window's da in the operand type
  float* db_part;    // (groups, 4h) fp32: each row group's db, added over the windows
  float* dh_state;   // (B, h) fp32: the carry into the window before (tiled: dh of the step before)
  float* dc_state;
  float* db_rows;    // (B, 4h) fp32, tiled only: each (row, column)'s db over the window so far
  unsigned* count;   // a counter a row group, zero at the call's start: ctas a step
  int batch, steps, h, t0, tc, rows, g0, w_smem, first, ctas, kc;  // first: the call's first window (its last steps)
};

// Kernel C's recurrence over one window, steps t0 + tc - 1 down to t0.  The
// CTAs and tiles of a group as in lstm_wide_fwd_kernel; tiled, a CTA keeps
// dc, dh and db of its tiles in dc_state, dh_state and db_rows between
// turns (the same sums in the same order: the same bits).  da_t is staged
// in chunks of kc terms through a ring (or whole, kc = whole_terms), and the
// dh product's sums take da's terms in a fixed order whatever kc is: fp32
// by K quads interleaved over segments summed in order (a group of 32 rows,
// past 16 of them: the 32 lanes of a warp, a warp 8 rows x 8 units, summed
// by shuffles; from 8 rows the 8 warps, a thread 4 rows x 4 units; below,
// segments of one output a thread),
// bf16 by k-tiles (interleaved over the warps' K segments, four accumulators
// each).  TILED as in lstm_wide_fwd_kernel.
template <typename T, bool TILED>
__global__ void __launch_bounds__(WTHREADS, 1) lstm_wide_bwd_kernel(const WideBwd<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool tiled = TILED;
  const int h = a.h, jp = wide_pitch<T>(4 * h), kc = a.kc, kp = wide_pitch<T>(kc), kk = n_cta(h), nct = a.ctas;
  const int tid = threadIdx.x, g4 = 4 * h, nb = ring_bufs<T>(1, h, kc), nc = (g4 + kc - 1) / kc;
  const bool whole = nb == 1;
  const int grp = a.g0 + blockIdx.x / nct, cta = blockIdx.x % nct, n_tiles = tiled ? (kk - cta + nct - 1) / nct : 1;
  const int row0 = grp * a.rows, nrows = min(a.rows, a.batch - row0), rp = ring_rows<T>(1, a.rows);
  const size_t ring_bytes = sizeof(T) * (size_t)nb * rp * kp, db_bytes = sizeof(float) * (size_t)a.rows * WROWS;
  T* ring = reinterpret_cast<T*>(smem);                                      // [nb][rp][kp]: da_t by chunks
  T* s_w = reinterpret_cast<T*>(smem + (ring_bytes > db_bytes ? ring_bytes : db_bytes));  // [16][jp] where w_smem
  float* s_dh = reinterpret_cast<float*>(s_w + (a.w_smem ? (size_t)WU * jp : 0));           // [rows][16]
  float* s_part = s_dh + a.rows * WU;                                        // the dh product's partials
  const T* wsl = a.wpack + (size_t)cta * WU * jp;
  for (int i = tid; i < nb * rp * kp; i += WTHREADS) store_f(ring + i, 0.0f);
  if (a.w_smem) {
    const int n16 = WU * jp * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += WTHREADS)
      reinterpret_cast<uint4*>(s_w)[i] = reinterpret_cast<const uint4*>(wsl)[i];
    wsl = s_w;
  }
  unsigned* count = a.count + grp;
  const bool vec = (g4 * sizeof(T)) % 16 == 0;
  const int u = tid % WU, r0 = tid / WU;
  // phase 1's pairs: (unit u of the tile, row r0 + 16 j); untiled, their dc and db live in registers for the
  // window and dh_t in s_dh
  float dc[PMAX], db[PMAX][4];
  if (!tiled) {
    const int gu = cta * WU + u;
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int r = r0 + 16 * j;
      const bool ok = !a.first && r < nrows && gu < h;
      dc[j] = ok ? a.dc_state[(size_t)(row0 + r) * h + gu] : 0.0f;
      if (r < a.rows) s_dh[r * WU + u] = ok ? a.dh_state[(size_t)(row0 + r) * h + gu] : 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) db[j][m] = 0.0f;
    }
  }
  const unsigned done0 = (unsigned)(a.steps - (a.t0 + a.tc));  // steps the call ran before this window
  // a step's records (factors i f g o; o (1 - tanh^2 c), f, dy, 0) of the thread's pairs at unit gu; untiled
  // read a step ahead, before the barrier, so that their latency overlaps it
  float4 rf[PMAX], rg[PMAX];
  auto load_records = [&](int s, int gu) {
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int r = r0 + 16 * j;
      if (!(SPLIT & 8) && r < nrows && gu < h) {
        const float4* e = reinterpret_cast<const float4*>(a.rec + (((size_t)(row0 + r) * a.tc + s) * h + gu) * CREC);
        rf[j] = __ldg(e), rg[j] = __ldg(e + 1);
      }
    }
  };
  if (!tiled) load_records(a.tc - 1, cta * WU + u);
  for (int s = a.tc - 1; s >= 0; --s) {
    __syncthreads();  // s_dh (dh_state, tiled) holds dh_t
    // phase 1: da_t of the CTA's columns, dc_{t-1}
    const bool carried = !(a.first && s == a.tc - 1);  // tiled: the state holds the step after's
    for (int tile_i = 0; tile_i < n_tiles && !(SPLIT & 8); ++tile_i) {
      const int gu = (cta + tile_i * nct) * WU + u;
      if (tiled) load_records(s, gu);
#pragma unroll
      for (int j = 0; j < PMAX; ++j) {
        const int r = r0 + 16 * j;
        if (r < nrows && gu < h) {
          const size_t n = (size_t)(row0 + r) * a.tc + s, at = (size_t)(row0 + r) * h + gu;
          float* dbr = a.db_rows + (size_t)(row0 + r) * g4 + gu;
          if (tiled) {
            dc[j] = carried ? a.dc_state[at] : 0.0f;
#pragma unroll
            for (int m = 0; m < 4; ++m) db[j][m] = s < a.tc - 1 ? dbr[(size_t)m * h] : 0.0f;
          }
          const float4 f = rf[j], g = rg[j];
          const float dh_total = g.z + (tiled ? (carried ? a.dh_state[at] : 0.0f) : s_dh[r * WU + u]);
          const float dc_total = dc[j] + dh_total * g.x;
          const float da[4] = {dc_total * f.x, dc_total * f.y, dc_total * f.z, dh_total * f.w};
          dc[j] = dc_total * g.y;
          T* out = a.da + n * g4 + gu;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            store_f(out + (size_t)m * h, da[m]);
            db[j][m] += da[m];
          }
          if (tiled) {
            a.dc_state[at] = dc[j];
#pragma unroll
            for (int m = 0; m < 4; ++m) dbr[(size_t)m * h] = db[j][m];
          }
        }
      }
    }
    if (s > 0 && !tiled) load_records(s - 1, cta * WU + u);
    __syncthreads();
    if (!(SPLIT & 1) && tid == 0) {
      group_arrive(count);
      group_wait(count, (unsigned)nct * (done0 + (unsigned)(a.tc - s)));
    }
    __syncthreads();
    if (a.t0 + s == 0) break;  // no step before: dh_{-1} is not needed
    // chunk c of da_t of the group's rows into ring buffer buf
    const T* src = a.da + (size_t)row0 * a.tc * g4 + (size_t)s * g4;
    auto stage = [&](int c, int buf) {
      stage_chunk<T, true>(ring + (size_t)buf * rp * kp, kp, src + (size_t)c * kc, (size_t)a.tc * g4, nrows,
                           min(kc, g4 - c * kc), vec);
    };
    // phase 2: dh_{t-1}[r][u] = sum_j da_t[r][j] W_hh[j][u], tile by tile (a tiled CTA stages the chunks again
    // for each tile; the whole row once a step)
    for (int tile_i = 0; tile_i < n_tiles; ++tile_i) {
      const int tile = cta + tile_i * nct;
      const T* wt = tiled ? a.wpack + (size_t)tile * WU * jp : wsl;
      const bool load = !(SPLIT & 2) && (tile_i == 0 || !whole);
      if constexpr (is_bf16<T>) {
        const int lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
        const int mt_n = (nrows + 15) / 16, items = 2 * mt_n, segs = 8 / items, span = 4 * segs;
        const int item = warp % items, seg = warp / items, mt = item >> 1, nt = item & 1;
        float acc[4][4] = {};
        const T* br = wt + (size_t)(nt * 8 + g8) * jp + 2 * t4;
        ring_run<ring_depth<T>()>(nc, nb, load, stage, [&](int c, int buf) {
          if ((SPLIT & 4) || seg >= segs) return;
          // A fragments by ldmatrix: lane l gives row mt 16 + l % 16 at column 8 (l / 16); the rows past nrows
          // are zero (never staged)
          const T* ab = ring + (size_t)buf * rp * kp + (size_t)(mt * 16 + (lane & 15)) * kp + (lane >> 4) * 8;
          const int kt0 = c * (kc / 16), kt1 = kt0 + (min(kc, g4 - c * kc) + 15) / 16;
          // k-tile kt goes to segment kt % segs, accumulator (kt / segs) % 4: spans of 4 segs k-tiles
          for (int s0 = kt0 / span * span; s0 < kt1; s0 += span)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kt = s0 + e * segs + seg;
              if (kt >= kt0 && kt < kt1) {
                uint32_t af[4];
                ldmatrix_x4(af, ab + (kt - kt0) * 16);
                const T* q = br + (size_t)kt * 16;
                mma_bf16(acc[e], af, ld32(q), ld32(q + 8));
              }
            }
        });
        if (seg < segs) {
          // the four accumulators in a fixed order, into [seg][row][unit]
          float* out = s_part + ((size_t)seg * mt_n * 16) * WU;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = mt * 16 + g8 + (e >> 1) * 8, uu = nt * 8 + 2 * t4 + (e & 1);
            out[rr * WU + uu] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
          }
        }
        __syncthreads();
        for (int o = tid; o < nrows * WU; o += WTHREADS) {
          float v = 0.0f;
          for (int sg = 0; sg < segs; ++sg) v += s_part[((size_t)sg * mt_n * 16) * WU + o];
          s_dh[o] = v;
        }
      } else {
        const int outs = nrows * WU, segs = WTHREADS / outs;  // segs: below 8 rows
        if (a.rows == 32 && nrows > 16) {
          // warp w: an 8 x 8 tile, units 8 (w & 1) .., rows 8 (w >> 1) ..; lane: the quads q = lane (mod 32).
          // 16 shared loads of 16 bytes feed 256 FMAs; the lanes' sums meet in a butterfly of shuffles (a fixed
          // tree: every lane ends with the same sums)
          const int warp = tid >> 5, lane = tid & 31, rt = warp >> 1;
          float acc[8][8] = {};
          const float* wr = reinterpret_cast<const float*>(wt) + (size_t)(warp & 1) * 8 * jp;
          ring_run<ring_depth<T>()>(nc, nb, load, stage, [&](int c, int buf) {
            if ((SPLIT & 4) || rt * 8 >= nrows) return;
            const float* dr = reinterpret_cast<const float*>(ring + (size_t)buf * rp * kp) + (size_t)rt * 8 * kp;
            const int q0 = c * (kc / 4), nq = round_up(min(kc, g4 - c * kc), 16) / 4;
            for (int q = ((lane - q0) % 32 + 32) % 32; q < nq; q += 32) {
              float4 v[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) v[i] = *reinterpret_cast<const float4*>(dr + (size_t)i * kp + 4 * q);
#pragma unroll
              for (int uu = 0; uu < 8; ++uu) {
                const float4 w4 = *reinterpret_cast<const float4*>(wr + (size_t)uu * jp + 4 * (q0 + q));
#pragma unroll
                for (int i = 0; i < 8; ++i) dot_quad(acc[i][uu], w4.x, w4.y, w4.z, w4.w, v[i]);
              }
            }
          });
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int uu = 0; uu < 8; ++uu)
#pragma unroll
              for (int m = 16; m >= 1; m >>= 1) acc[i][uu] += __shfl_xor_sync(0xffffffffu, acc[i][uu], m);
#pragma unroll
          for (int o = 0; o < 64; ++o)
            if ((o & 31) == lane && rt * 8 + (o >> 3) < nrows)
              s_dh[(rt * 8 + (o >> 3)) * WU + (warp & 1) * 8 + (o & 7)] = acc[o >> 3][o & 7];
        } else if (nrows >= 8) {
          // thread: units ug + 4 m, rows rg + 8 i, the quads q = warp (mod 8); the warps' partials summed in order.
          // A 16-byte shared-memory load feeds 16 FMAs (W_hh) or 16 (da): 4 x 4 outputs a thread.
          const int warp = tid >> 5, ug = tid & 3, rg = (tid >> 2) & 7, ni = (nrows - rg + 7) / 8;
          float acc[WMAX_R / 8][4] = {};
          const float* wr = reinterpret_cast<const float*>(wt) + (size_t)ug * jp;
          ring_run<ring_depth<T>()>(nc, nb, load, stage, [&](int c, int buf) {
            if (SPLIT & 4) return;
            const float* dr = reinterpret_cast<const float*>(ring + (size_t)buf * rp * kp) + (size_t)rg * kp;
            const float* wc = wr + (size_t)c * kc;
            const int q0 = c * (kc / 4), nq = round_up(min(kc, g4 - c * kc), 16) / 4;
            for (int q = ((warp - q0) % 8 + 8) % 8; q < nq; q += 8) {
              float4 w4[4];
#pragma unroll
              for (int m = 0; m < 4; ++m) w4[m] = *reinterpret_cast<const float4*>(wc + (size_t)4 * m * jp + 4 * q);
#pragma unroll
              for (int i = 0; i < WMAX_R / 8; ++i)
                if (i < ni) {
                  const float4 v = *reinterpret_cast<const float4*>(dr + (size_t)8 * i * kp + 4 * q);
#pragma unroll
                  for (int m = 0; m < 4; ++m) dot_quad(acc[i][m], w4[m].x, w4[m].y, w4[m].z, w4[m].w, v);
                }
            }
          });
          float* part = s_part + (size_t)warp * outs;  // [warp][row][unit]
#pragma unroll
          for (int i = 0; i < WMAX_R / 8; ++i)
            if (i < ni)
#pragma unroll
              for (int m = 0; m < 4; ++m) part[(rg + 8 * i) * WU + ug + 4 * m] = acc[i][m];
          __syncthreads();
          for (int o = tid; o < outs; o += WTHREADS) {
            float v = 0.0f;
            for (int w8 = 0; w8 < 8; ++w8) v += s_part[w8 * outs + o];
            s_dh[o] = v;
          }
        } else {
          // thread: output o, segment sg of the quads q = sg (mod segs), the segments summed in order
          const int o = tid % outs, sg = tid / outs;
          float acc = 0.0f;
          const float* wr = reinterpret_cast<const float*>(wt) + (size_t)(o % WU) * jp;
          ring_run<ring_depth<T>()>(nc, nb, load, stage, [&](int c, int buf) {
            if ((SPLIT & 4) || sg >= segs) return;
            const float* dr = reinterpret_cast<const float*>(ring + (size_t)buf * rp * kp) + (size_t)(o / WU) * kp;
            const int q0 = c * (kc / 4), nq = round_up(min(kc, g4 - c * kc), 16) / 4;
            for (int q = ((sg - q0) % segs + segs) % segs; q < nq; q += segs) {
              const float4 w4 = *reinterpret_cast<const float4*>(wr + 4 * (q0 + q));
              dot_quad(acc, w4.x, w4.y, w4.z, w4.w, *reinterpret_cast<const float4*>(dr + 4 * q));
            }
          });
          if (sg < segs) s_part[sg * outs + o] = acc;
          __syncthreads();
          for (int o2 = tid; o2 < outs; o2 += WTHREADS) {
            float v = 0.0f;
            for (int s2 = 0; s2 < segs; ++s2) v += s_part[s2 * outs + o2];
            s_dh[o2] = v;
          }
        }
      }
      if (tiled) {  // the tile's dh_{t-1} to dh_state, s_dh and s_part free for the next tile
        __syncthreads();
        for (int o = tid; o < nrows * WU; o += WTHREADS) {
          const int gu = tile * WU + o % WU;
          if (gu < h) a.dh_state[(size_t)(row0 + o / WU) * h + gu] = s_dh[o];
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  // the carry into the window before (tiled: already there), and the group's db of this window (rows in order)
  if (!tiled) {
    const int gu = cta * WU + u;
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int r = r0 + 16 * j;
      if (r < nrows && gu < h && a.t0 > 0) {
        a.dc_state[(size_t)(row0 + r) * h + gu] = dc[j];
        a.dh_state[(size_t)(row0 + r) * h + gu] = s_dh[r * WU + u];
      }
    }
  }
  float* s_db = reinterpret_cast<float*>(smem);  // [rows][64]: the pairs' db, then summed by column
  for (int tile_i = 0; tile_i < n_tiles; ++tile_i) {
    const int u0 = (cta + tile_i * nct) * WU, gu = u0 + u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int r = r0 + 16 * j;
      if (r < nrows)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          s_db[r * WROWS + m * WU + u] =
              !tiled ? db[j][m] : gu < h ? a.db_rows[(size_t)(row0 + r) * g4 + (size_t)m * h + gu] : 0.0f;
    }
    __syncthreads();
    if (tid < WROWS) {
      const int m = tid / WU, uu = tid % WU;
      if (u0 + uu < h) {
        float v = 0.0f;
        for (int r = 0; r < nrows; ++r) v += s_db[r * WROWS + tid];
        float* out = a.db_part + (size_t)grp * g4 + (size_t)m * h + u0 + uu;
        *out = a.first ? v : *out + v;
      }
    }
  }
}

// The card's SMs, and the CTAs of a recurrence it holds at once (0: none fits).
cudaError_t resident(const void* kernel, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WTHREADS, smem);
  *out = per_sm * sms;
  return err;
}

// CTAs a row group of kk tiles where the card holds `slots` CTAs at once:
// all kk where they fit, else as few as fit, with the tiles spread evenly
// (kk = 140 on 132 slots: 70 CTAs of two tiles).  0 where none fits.
__host__ __device__ constexpr int group_ctas(int kk, int slots) {
  return slots >= kk ? kk : slots < 1 ? 0 : (kk + (kk + slots - 1) / slots - 1) / ((kk + slots - 1) / slots);
}

struct RecShape {
  int ctas;     // CTAs a row group
  int tiled;    // 1: the TILED instantiation (and W_hh's slice in global memory)
  int w_smem;   // 1: W_hh's slice in shared memory (never tiled)
  size_t smem;  // dynamic shared memory of a CTA
  int slots;    // CTAs of this shape the card holds at once (0: none fits its shared memory)
  int chunk;    // terms a staged chunk of h / da (whole_terms: the whole row)
  int optin;    // the most shared memory a CTA may opt in to on the device
};

// The staged chunk of a recurrence at `rows` rows a group where the card
// lets a CTA opt in to `optin` bytes: the call's (want, in whole k-tiles, at
// most the row); else C's chunks of chunk_terms, A / B's whole row where it
// fits beside W_hh's slice in global memory (their plan and step times stay
// those of whole-row staging wherever it fits) and chunks past it.
template <typename T>
int rec_chunk(int bwd, int h, int rows, int want, int optin) {
  const int whole = whole_terms(bwd, h), part = chunk_terms<T>() < whole ? chunk_terms<T>() : whole;
  if (want > 0) return round_up(want, 16) < whole ? round_up(want, 16) : whole;
  return bwd || wide_smem<T>(0, h, rows, 0, whole) > (size_t)optin ? part : whole;
}

// The launch shape of one recurrence (kernel: its untiled and TILED
// instantiations) at `rows` rows a group and the chunk rec_chunk gives:
// every CTA of a group, untiled, with W_hh's slice in shared memory where
// that fits the card's opt-in limit and the card holds the group at once;
// else the slice in global memory, untiled where the card holds the group,
// else the TILED instantiation at `want` CTAs a group (0: group_ctas of
// what the card holds).
template <typename T>
cudaError_t rec_shape(const void* const kernel[2], SmemOnce* once, int bwd, int h, int rows, int want,
                      int want_chunk, RecShape* out) {
  cudaError_t err;
  for (int i = 0; i < 2; ++i)
    if ((err = once[i].set(kernel[i], 0)) != cudaSuccess) return err;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return err;
  const int kk = n_cta(h), kc = rec_chunk<T>(bwd, h, rows, want_chunk, optin);
  for (int w = 1; w >= 0; --w) {
    *out = RecShape{0, 0, w, wide_smem<T>(bwd, h, rows, w, kc), 0, kc, optin};
    if (out->smem > (size_t)optin) continue;
    if (want == 0 || want == kk) {
      if ((err = resident(kernel[0], out->smem, &out->slots)) != cudaSuccess) return err;
      out->ctas = kk;
      if (out->slots >= kk) return cudaSuccess;
    }
    if (w == 1) continue;
    out->tiled = 1;
    if ((err = resident(kernel[1], out->smem, &out->slots)) != cudaSuccess) return err;
    out->ctas = want ? want : group_ctas(kk, out->slots);
    return cudaSuccess;
  }
  return cudaSuccess;
}

template <typename T, bool TRAIN> SmemOnce* fwd_once() { static SmemOnce o[2]; return o; }
template <typename T> SmemOnce* bwd_once() { static SmemOnce o[2]; return o; }
template <typename T, bool TRAIN> const void* const* fwd_kernels() {
  static const void* const k[2] = {(const void*)lstm_wide_fwd_kernel<T, TRAIN, false>,
                                   (const void*)lstm_wide_fwd_kernel<T, TRAIN, true>};
  return k;
}
template <typename T> const void* const* bwd_kernels() {
  static const void* const k[2] = {(const void*)lstm_wide_bwd_kernel<T, false>, (const void*)lstm_wide_bwd_kernel<T, true>};
  return k;
}

// The launch shape of the recurrence (bwd = 0: A / B's, 1: C's) at `rows`
// rows a group, as a call with CTAs a group `want` (0: the card's choice)
// and chunk `chunk` (0: the card's choice) would launch it.
template <typename T>
cudaError_t wide_shape(int bwd, int h, int rows, int want, int chunk, RecShape* out) {
  if (h < 1 || rows < 1 || rows > WMAX_R || want < 0 || want > n_cta(h) || chunk < 0) return cudaErrorInvalidValue;
  return bwd ? rec_shape<T>(bwd_kernels<T>(), bwd_once<T>(), 1, h, rows, want, chunk, out)
             : rec_shape<T>(fwd_kernels<T, false>(), fwd_once<T, false>(), 0, h, rows, want, chunk, out);
}

// Row groups of `rows` rows over the batch, in cooperative launches of as
// many groups of `ctas` CTAs as the card holds: launch(g0, n) for each.
template <typename Launch>
cudaError_t over_groups(int batch, int rows, int ctas, int slots, Launch launch) {
  const int groups = (batch + rows - 1) / rows, per = slots / ctas;
  if (per < 1) return cudaErrorCooperativeLaunchTooLarge;  // a row group's CTAs do not fit the card at once
  for (int g0 = 0; g0 < groups; g0 += per) {
    const cudaError_t err = launch(g0, groups - g0 < per ? groups - g0 : per);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
BwdArgs<T> bwd_args(const void* x, const void* y, const float* cprev, const void* dy, const float* w_ih,
                    const float* w_hh, const float* bias, int batch, int steps, int d, int h) {
  return BwdArgs<T>{(const T*)x, (const T*)y, cprev, (const T*)dy, w_ih, w_hh, bias, batch, steps, d, h};
}

// Kernel A (TRAIN = false) / B over every window.
template <typename T, bool TRAIN>
int launch_fwd(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y, float* cprev,
               float* xp, void* wpack, void* wih, float* c_state, unsigned* count, int batch, int steps, int d,
               int h, int rows, int ctas, int chunk, int window, cudaStream_t stream) {
  if (d < 1 || h < 1 || rows < 1 || rows > WMAX_R || ctas < 0 || ctas > n_cta(h) || chunk < 0 || window < 1 ||
      (long long)batch * window >= (1ll << 31) || (is_bf16<T> && wih == nullptr))
    return (int)cudaErrorInvalidValue;
  RecShape sh;
  cudaError_t err = rec_shape<T>(fwd_kernels<T, TRAIN>(), fwd_once<T, TRAIN>(), 0, h, rows, ctas, chunk, &sh);
  if (err != cudaSuccess) return (int)err;
  if (sh.ctas < 1) return (int)cudaErrorCooperativeLaunchTooLarge;  // not one CTA of the group fits the card
  const int groups = (batch + rows - 1) / rows;
  if ((err = cudaMemsetAsync(count, 0, sizeof(unsigned) * groups, stream)) != cudaSuccess) return (int)err;
  if ((err = pack(w_hh, wpack, h, 0, is_bf16<T>, w_ih, is_bf16<T> ? wih : nullptr, d, stream)) != cudaSuccess)
    return (int)err;
  const BwdArgs<T> pa = bwd_args<T>(x, nullptr, nullptr, nullptr, w_ih, w_hh, bias, batch, steps, d, h);
  for (int t0 = 0; t0 < steps; t0 += window) {
    const int tc = steps - t0 < window ? steps - t0 : window;
    if ((err = gate_pass<T, true>(pa, wih, wpack, xp, nullptr, Win{t0, tc}, stream)) != cudaSuccess) return (int)err;
    err = over_groups(batch, rows, sh.ctas, sh.slots, [&](int g0, int n) {
      WideFwd<T> a{xp, (const T*)wpack, (T*)y, cprev, c_state, count, batch, steps, h, t0, tc, rows, g0, sh.w_smem,
                   sh.ctas, sh.chunk};
      void* args[] = {&a};
      return cudaLaunchCooperativeKernel(fwd_kernels<T, TRAIN>()[sh.tiled], dim3((unsigned)(n * sh.ctas)),
                                         dim3(WTHREADS), args, sh.smem, stream);
    });
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Kernel C over every window, the last first, then the ordered sum.
template <typename T>
int launch_bwd(const BwdArgs<T> a, void* dx, float* dw_ih, float* dw_hh, float* db, void* da, float* rec, float* part,
               float* db_part, void* wpack, void* wih, float* dh_state, float* dc_state, float* db_rows,
               unsigned* count, int rows, int ctas, int chunk, int window, int n_chunks, cudaStream_t stream) {
  const int batch = a.batch, steps = a.steps, d = a.d, h = a.h;
  if (d < 1 || h < 1 || rows < 1 || rows > WMAX_R || ctas < 0 || ctas > n_cta(h) || chunk < 0 || window < 1 ||
      n_chunks < 1 || (long long)batch * window >= (1ll << 31) || (is_bf16<T> && wih == nullptr))
    return (int)cudaErrorInvalidValue;
  RecShape sh;
  cudaError_t err = rec_shape<T>(bwd_kernels<T>(), bwd_once<T>(), 1, h, rows, ctas, chunk, &sh);
  if (err != cudaSuccess) return (int)err;
  if (sh.ctas < 1) return (int)cudaErrorCooperativeLaunchTooLarge;  // not one CTA of the group fits the card
  if (sh.tiled && db_rows == nullptr) return (int)cudaErrorInvalidValue;
  const int groups = (batch + rows - 1) / rows, g = 4 * h, kd = d + h;
  if ((err = cudaMemsetAsync(count, 0, sizeof(unsigned) * groups, stream)) != cudaSuccess) return (int)err;
  if ((err = pack(a.w_hh, wpack, h, 1, is_bf16<T>, a.w_ih, is_bf16<T> ? wih : nullptr, d, stream)) != cudaSuccess)
    return (int)err;
  const int n_win = (steps + window - 1) / window;
  for (int wi = n_win - 1; wi >= 0; --wi) {
    const int t0 = wi * window, tc = steps - t0 < window ? steps - t0 : window, first = wi == n_win - 1;
    const Win w{t0, tc};
    if ((err = gate_pass<T, false, true>(a, wih, wpack, rec, (float*)da, w, stream)) != cudaSuccess) return (int)err;
    err = over_groups(batch, rows, sh.ctas, sh.slots, [&](int g0, int n) {
      WideBwd<T> b{rec, (const T*)wpack, (T*)da, db_part, dh_state, dc_state, db_rows, count,
                   batch, steps, h, t0, tc, rows, g0, sh.w_smem, first, sh.ctas, sh.chunk};
      void* args[] = {&b};
      return cudaLaunchCooperativeKernel(bwd_kernels<T>()[sh.tiled], dim3((unsigned)(n * sh.ctas)),
                                         dim3(WTHREADS), args, sh.smem, stream);
    });
    if (err != cudaSuccess) return (int)err;
    err = launch_window_products<T>(a, (const T*)da, (const __nv_bfloat16*)wih, (T*)dx, part, n_chunks, w, first,
                                    stream);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_bwd_sum_any_kernel<<<(unsigned)(((long long)g * kd + 255) / 256), 256, 0, stream>>>(
      part, n_chunks, db_part, groups, dw_ih, dw_hh, db, d, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernels A (lstm_fwd_*_wide, cprev unused) and B (lstm_fwd_train_*_wide)
// for any D, H >= 1 (the plan sends max(D, H) > 256 here).  x: (B, T, D) and
// y: (B, T, H) in the instantiation's type; w_ih: (4H, D), w_hh: (4H, H),
// bias: (4H,) fp32; cprev: (B, T, H) fp32.  Scratch: xp (B, window, 4H)
// fp32; wpack: awm_lstm_wide_pack_elems(0, bf16, H) elements of the operand
// type; wih: (4H, D) bf16 (bf16 only; null for fp32); c_state (B, H) fp32;
// count: ceil(B / rows) 32-bit counters.  rows: batch rows a row group (1 ..
// 64); ctas: CTAs a row group (1 ..
// ceil(H / 16); 0: the card's choice, awm_lstm_wide_shape's); chunk: terms
// of h a staged chunk (0: the card's choice; else rounded up to a multiple
// of 16, at most the row); window: steps a window (B window < 2^31).  All
// contiguous on the current device.  Returns the first cudaError_t of the
// launches (0 = all launched).
#define AWM_LSTM_WIDE_FWD_ENTRY(NAME, TYPE, TRAIN)                                                        \
  int NAME(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y, float* cprev,  \
           float* xp, void* wpack, void* wih, float* c_state, unsigned* count, int batch, int steps,       \
           int d, int h, int rows, int ctas, int chunk, int window, void* stream) {                       \
    return launch_fwd<TYPE, TRAIN>(x, w_ih, w_hh, bias, y, TRAIN ? cprev : nullptr, xp, wpack, wih,       \
                                   c_state, count, batch, steps, d, h, rows, ctas, chunk, window,         \
                                   (cudaStream_t)stream);                                                 \
  }
AWM_LSTM_WIDE_FWD_ENTRY(awm_lstm_fwd_f32_wide, float, false)
AWM_LSTM_WIDE_FWD_ENTRY(awm_lstm_fwd_bf16_wide, __nv_bfloat16, false)
AWM_LSTM_WIDE_FWD_ENTRY(awm_lstm_fwd_train_f32_wide, float, true)
AWM_LSTM_WIDE_FWD_ENTRY(awm_lstm_fwd_train_bf16_wide, __nv_bfloat16, true)
#undef AWM_LSTM_WIDE_FWD_ENTRY

// Kernel C (lstm_bwd_*_wide): the operands and outputs of lstm_bwd.cu's
// entry points.  Scratch: da (B, window, 4H) in the operand type; rec (B,
// window, H, 8) fp32; part (n_chunks, 4H, D + H) fp32; db_part (ceil(B /
// rows), 4H) fp32; wpack: awm_lstm_wide_pack_elems(1, bf16, H) elements of
// the operand type; wih: (4H, D) bf16 (bf16 only; null for fp32);
// dh_state, dc_state (B, H) fp32; db_rows (B, 4H) fp32 (used where a CTA
// owns more than one tile); count: ceil(B / rows) 32-bit counters.  rows,
// ctas, window as above; chunk: terms of da a staged chunk (0: the card's
// choice).
#define AWM_LSTM_WIDE_BWD_ENTRY(NAME, TYPE)                                                               \
  int NAME(const void* x, const void* y, const float* cprev, const void* dy, const float* w_ih,          \
           const float* w_hh, const float* bias, void* dx, float* dw_ih, float* dw_hh, float* db,        \
           void* da, float* rec, float* part, float* db_part, void* wpack, void* wih, float* dh_state,   \
           float* dc_state, float* db_rows, unsigned* count, int batch, int steps, int d, int h, int rows, \
           int ctas, int chunk, int window, int n_chunks, void* stream) {                                 \
    return launch_bwd<TYPE>(bwd_args<TYPE>(x, y, cprev, dy, w_ih, w_hh, bias, batch, steps, d, h), dx,  \
                            dw_ih, dw_hh, db, da, rec, part, db_part, wpack, wih, dh_state, dc_state,     \
                            db_rows, count, rows, ctas, chunk, window, n_chunks, (cudaStream_t)stream);   \
  }
AWM_LSTM_WIDE_BWD_ENTRY(awm_lstm_bwd_f32_wide, float)
AWM_LSTM_WIDE_BWD_ENTRY(awm_lstm_bwd_bf16_wide, __nv_bfloat16)
#undef AWM_LSTM_WIDE_BWD_ENTRY

// The launch shape of the wide recurrence (bwd = 0: A and B's, 1: C's) at
// `rows` rows a row group on the current device, as a call with ctas = 0
// and the given chunk (0: the card's choice) launches it: out[0] the CTAs
// the card holds at once (0 where not one fits its shared memory), out[1]
// the CTAs a row group (ceil(H / 16), or fewer, each of more tiles, where
// the card does not hold that many), out[2] 1 where W_hh's slice is in
// shared memory (else read from the packed copy in global memory), out[3]
// the dynamic shared memory of a CTA, out[4] the terms a staged chunk,
// out[5] the most shared memory a CTA may opt in to.  Returns 0 or the
// cudaError_t.
int awm_lstm_wide_shape(int bwd, int bf16, int h, int rows, int chunk, int* out) {
  RecShape sh{};
  const cudaError_t err = bf16 ? wide_shape<__nv_bfloat16>(bwd, h, rows, 0, chunk, &sh)
                               : wide_shape<float>(bwd, h, rows, 0, chunk, &sh);
  out[0] = sh.slots, out[1] = sh.ctas, out[2] = sh.w_smem, out[3] = (int)sh.smem, out[4] = sh.chunk, out[5] = sh.optin;
  return (int)err;
}

#if AWM_WIDE_GATES
// The gates check (a build with -DAWM_WIDE_GATES=1 only): fp32 kernel B over
// one window of every step with rows, ctas and chunk as the entry points
// take them (its scratch xp_fwd (B, T, 4H) ends holding the gates of every
// step; wpack, c_state, count as awm_lstm_fwd_train_f32_wide's), then C's
// fp32 gate pass over the same steps on B's own y, its gates (not its
// records) into pre_c (B, T, 4H), its x sums into xp_c.  The caller compares
// xp_fwd with pre_c.
int awm_lstm_wide_gates_check(const float* x, const float* w_ih, const float* w_hh, const float* bias, float* y,
                              float* cprev, float* xp_fwd, float* wpack, float* c_state, unsigned* count,
                              float* xp_c, float* pre_c, int batch, int steps, int d, int h, int rows, int ctas,
                              int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_fwd<float, true>(x, w_ih, w_hh, bias, y, cprev, xp_fwd, wpack, nullptr, c_state, count, batch,
                                    steps, d, h, rows, ctas, chunk, steps, st);
  if (err) return err;
  const BwdArgs<float> a = bwd_args<float>(x, y, cprev, nullptr, w_ih, w_hh, bias, batch, steps, d, h);
  const Win w{0, steps};
  const long long n_rows = (long long)batch * steps;
  lstm_bwd_gates_f32_kernel<true><<<(unsigned)(((h + CU - 1) / CU) * ((n_rows + GP_ROWS - 1) / GP_ROWS)), 256, 0, st>>>(
      a, xp_c, w);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaFuncSetAttribute(lstm_bwd_gates_f32_split_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM);
  if (e != cudaSuccess) return (int)e;
  lstm_bwd_gates_f32_split_kernel<true><<<(unsigned)(n_cta(h) * ((n_rows + GS_T - 1) / GS_T)), 256, GS_SMEM, st>>>(
      a, xp_c, pre_c, w, h % 4 == 0 && aligned16(y) && aligned16(w_hh));
  return (int)cudaGetLastError();
}
#endif

// Elements of the packed W_hh the entry points take (bwd = 0: A and B's).
long long awm_lstm_wide_pack_elems(int bwd, int bf16, int h) {
  return bf16 ? pack_elems<__nv_bfloat16>(bwd, h) : pack_elems<float>(bwd, h);
}

const char* awm_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
