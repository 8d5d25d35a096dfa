// LSTM forward for Hopper (sm_90a), zero initial state: the inference
// forward and, with TRAIN, the training forward that also streams c_{t-1}.
//
// Replaces two kernels of awm_tpu/ops/pallas/lstm_kernel.py:
// - lstm_pallas_forward + _lstm_kernel (the pallas_call at line 157): the
//   <T, false, R> instantiations;
// - _forward_train + _lstm_train_kernel (the pallas_call at line 342): the
//   <T, true, R> instantiations, which store c_{t-1} (fp32, zero at t=0)
//   before each cell update.  h_{t-1} needs no stream of its own: it is y
//   shifted by one step, and the backward (lstm_bwd.cu) rebuilds it from y.
// Like those kernels it computes the input projection x_t @ W_ih^T + b
// inside its own body, then the cell step gates = xp_t + h_{t-1} @ W_hh^T,
// gate order (i, f, g, o).  y and c_{t-1} are batch-major (B, T, H), the
// port's layout; the TPU kernels' time-major layout is not carried over.
// The capacity W is a template parameter, instantiated for 64 (the base
// family, T = 16000 steps a 1-s chunk), 48 (the base family at channels
// 33-48: 384 threads, three quads a lane, three mma k-tiles, so that such a
// call no longer runs the width-64 block and its step chain), 32 (the
// strided family's two stacked LSTMs, T = 50 steps a chunk) and 16 (the dry
// run's gradient check, T = 32); a call passes its
// D, H <= W at run time and takes the smallest capacity that holds them
// (lstm_common.cuh has the thread mapping and the masking).  Kernel C
// (lstm_bwd.cu) has the same capacities and recomputes the gates in the
// order of lstm_common.cuh, which capacity 48 keeps bit for bit.  Widths
// above 64 run on a thread-block cluster (lstm_fwd_cluster.cu:
// its own library, so that the two build in parallel).
//
// What bounds it on this card: the recurrence is sequential in T, so the
// time is the latency of one step times T, not bytes or FLOPs (the whole
// call's bound is a few ms at most at T = 16000).  At T = 50 a launch's
// fixed cost (the weights into registers, the producers' first chunk) is a
// part of the time as well: there widths 32 and 16 take the short path below.  A step's
// latency is its dependent chain: read h, the products, two shuffle
// exchanges, the gate activations, the cell update and tanh c, write h, one
// barrier; and a warp runs its instructions in order, so whatever else the
// SM runs meanwhile lengthens it.  What the design does about it:
// - a block owns R batch rows and runs all T steps in one launch; R (1, 2
//   or 4) is chosen by the caller from the batch, the card's SM count and
//   the measured cost of a step of R rows (ops/lstm_kernel.py::launch_plan);
// - every weight lives in a register for the whole launch (the weights
//   come fp32; a bf16 instantiation rounds them itself as it loads them,
//   so no cast kernel runs beside the launch, and widens them or packs
//   them into mma fragments).  A W-term product is
//   split over the four lanes of its unit (lstm_common.cuh), so a step reads
//   W / 4 of the W h values per thread from shared memory, W / 16 16-byte
//   loads;
// - the input projection is off the sequential path: the producer warps
//   compute xp = x . W_ih + b for a chunk of 16 steps into a two-buffer ring
//   in shared memory, one chunk or more ahead of the consumers, prefetching
//   the next chunk's x from device memory meanwhile.  No device-memory
//   scratch.  In bf16 the producers use the tensor cores (mma.sync, 8 steps
//   a tile: time is the N dimension), which all but frees the instruction
//   slots they took from the consumers; in fp32 they stay on the CUDA cores;
// - fp32: the four gates of a unit sit in four neighbouring lanes, so the
//   cell update takes them by shuffle, with no trip through shared memory;
//   the rows of a block go through each phase of a step together, so that
//   their latencies overlap;
// - bf16: the recurrent product runs on the tensor cores too, W_hh as A
//   fragments in registers, h^T (the block's rows, zero-padded to 8) as B
//   from shared memory, the accumulator starting from xp: 8 mma a warp and
//   step, and each lane ends with the four gates of one (unit, row), so no
//   exchange between lanes at all;
// - h is double-buffered, so one barrier among the consumer warps
//   separates two steps;
// - the activations have no branch (lstm_common.cuh): a divergent warp
//   would walk both the sigmoid's and tanhf's paths in turn.
//
// Precision, as the TPU kernels' contract: the <float> instantiations are
// fp32 throughout (CUDA cores, no TF32, full-precision expf); the
// <__nv_bfloat16> ones round x, the weights and the h fed to the recurrent
// product to bf16, multiply exactly in fp32 and keep the sums, bias, gates
// and (h, c) state in fp32; y is stored bf16, c_{t-1} fp32.  The summation
// order is lstm_common.cuh's in fp32, the tensor cores' in bf16.
//
// Plain C interface, loaded with ctypes by awm_tpu_torch/ops/lstm_kernel.py.

#include "lstm_common.cuh"

namespace {

using namespace awm;

constexpr int S = 16;  // steps per chunk of the ring

// Row stride of the staged x: the bf16 rows are read as mma B fragments, 8
// rows at a time, and the pad puts them in distinct banks (W + 8 bf16 is 36
// words at 64, 28 at 48, 20 at 32, 12 at 16: 8 rows 4 banks apart or more).
template <typename T, int W> constexpr int XP = is_bf16<T> ? W + 8 : W;

// h_{t-1} in shared memory, double-buffered, in the operand type.  fp32: R
// rows of W.  bf16: the B operand of the recurrent mma, 8 rows (those from
// R on stay zero) with the same pad.
template <typename T, int R> constexpr int H_ROWS = is_bf16<T> ? 8 : R;

template <typename T, int R, int W>
constexpr int fwd_smem_bytes() {
  return (int)(sizeof(float) * NBUF * S * R * 4 * W +
               sizeof(T) * (2 * H_ROWS<T, R> * XP<T, W> + R * S * XP<T, W>));
}

// Blocks an SM each instantiation's registers are budgeted for.  One,
// except one row at W = 48: capped at 80 registers (two 384-thread blocks),
// a call of one row a block took 5.43 ms where the 110-124 registers of one
// block's budget took 5.80 (fp32 B, B=128, T=16000; bf16 4.50 against 4.67;
// H100, one block an SM in both).  At 2 and 4 rows the cap spilled and lost
// (fp32 A at B=512: 4 rows 18.6 against 13.2 ms), and two blocks of 2 rows
// an SM took longer than one of 4 (14.1 against 13.2; bf16 7.0 against 5.5),
// so the plan counts one block an SM at every W <= 64 but 16
// (lstm_kernel.BLOCKS_PER_SM).
template <int R, int W> constexpr int FWD_MIN_BLOCKS = W == 48 && R == 1 ? 2 : 1;

// MASKED = false: D = H = W, the widths folded in at compile time (the
// kernel the square widths had before the runtime widths); true: d_in, h_in.
template <typename T, bool TRAIN, int R, int W, bool MASKED>
__global__ void __launch_bounds__(8 * W, (FWD_MIN_BLOCKS<R, W>))
lstm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
                const float* __restrict__ w_hh, const float* __restrict__ bias,
                T* __restrict__ y, float* __restrict__ cprev, int batch, int steps, int d_in, int h_in) {
  static_assert(valid_width<W>, "instantiated for W = 16, 32, 48 and 64");
  constexpr int D = W, H = W, COLS = 4 * W, THREADS = 2 * COLS;
  const int d = MASKED ? d_in : W, h = MASKED ? h_in : W;
  constexpr int XPW = XP<T, W>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_ring = reinterpret_cast<float*>(smem);  // [NBUF][S][R][COLS]: xp of thread p's column
  T* s_h = reinterpret_cast<T*>(s_ring + NBUF * S * R * COLS);  // [2][H_ROWS][XP]: h_{t-1}
  T* s_x = s_h + 2 * H_ROWS<T, R> * XPW;                        // [R][S][XP]: the chunk's x

  const int p = threadIdx.x % COLS;  // COLS = 192 at W = 48: not a power of two
  const int unit = p >> 2, gate = p & 3;
  const int row0 = blockIdx.x * R;
  const int n_chunks = (steps + S - 1) / S;
  float w[W];

  if (threadIdx.x >= COLS) {
    // ---- producers: xp = x . W_ih + b, a chunk at a time ----
    const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
    const int unit_t = (unit & ~7) + g8;  // the unit whose gates this lane holds after an mma
    uint32_t a_ih[2][W / 16][4];
    float b = 0.0f, b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (is_bf16<T>) {
      load_a_fragments<W, MASKED>(w_ih, unit & ~7, lane, a_ih, h, d);
#pragma unroll
      for (int m = 0; m < 4; ++m) b4[m] = unit_t < h ? bias[m * h + unit_t] : 0.0f;
    } else {
      load_gate_weights<W, T>(w_ih, unit, gate, w, h, d);
      b = unit < h ? bias[gate * h + unit] : 0.0f;
    }
    constexpr int PER = R * S * D / COLS;  // staged x values per thread and chunk
    float xr[PER];
    auto fetch = [&](int c) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * COLS + p;  // [r][s][u], the layout of s_x
        const int r = e / (S * D), s = (e / D) % S, u = e % D;
        const int row = row0 + r, t = c * S + s;
        xr[i] = row < batch && t < steps && u < d ? load_f(x + ((size_t)row * steps + t) * d + u) : 0.0f;
      }
    };
    fetch(0);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % NBUF;
      bar_sync(BAR_PROD, COLS);  // every producer has finished reading the last chunk's s_x
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * COLS + p;
        store_f(s_x + (e / D) * XPW + e % D, xr[i]);
      }
      if (c + 1 < n_chunks) fetch(c + 1);
      bar_sync(BAR_PROD, COLS);
      if (c >= NBUF) bar_sync(BAR_EMPTY + buf, THREADS);  // the consumers are done with chunk c - NBUF
      float* ring = s_ring + buf * S * R * COLS;
      if constexpr (is_bf16<T>) {
        // Tensor cores: 8 steps of a row per mma tile (lstm_common.cuh).
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int nt = 0; nt < S / 8; ++nt) {
            float c[2][4] = {{b4[0], b4[0], b4[1], b4[1]}, {b4[2], b4[2], b4[3], b4[3]}};
            mma_w<W>(c, a_ih, s_x + (r * S + nt * 8 + g8) * XPW, t4);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float4*>(ring + ((nt * 8 + 2 * t4 + e) * R + r) * COLS + unit_t * 4) =
                  make_float4(c[0][e], c[0][2 + e], c[1][e], c[1][2 + e]);
          }
      } else {
        constexpr int SU = 4 / R;  // steps at a time: 4 gates x rows x steps = 16 running sums
#pragma unroll 1
        for (int s0 = 0; s0 < S; s0 += SU) {
          float acc[SU * R][4], px[SU * R];
#pragma unroll
          for (int ss = 0; ss < SU; ++ss)
#pragma unroll
            for (int r = 0; r < R; ++r) {
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[ss * R + r][m] = 0.0f;
              dot_parts<W>(acc[ss * R + r], w, s_x + (r * S + s0 + ss) * D, gate);
            }
          transpose_reduce4<2, 1, SU * R>(acc, gate & 2, gate & 1, px);
#pragma unroll
          for (int n = 0; n < SU * R; ++n) ring[(s0 * R + n) * COLS + p] = px[n] + b;
        }
      }
      __threadfence_block();
      bar_arrive(BAR_FULL + buf, THREADS);
    }
    return;
  }

  // ---- consumers: the recurrence ----
  for (int idx = p; idx < 2 * H_ROWS<T, R> * XPW; idx += COLS) store_f(s_h + idx, 0.0f);  // h_{-1} = 0
  bar_sync(BAR_CONS, COLS);
  int cur = 0;

  if constexpr (is_bf16<T>) {
    // Tensor cores: D[gate column][n] = W_hh . h^T, the block's rows as a tile's N
    // (lstm_common.cuh).  Row r is column n = 2 r of the tile (R <= 4; the odd
    // columns stay zero), so lane (g8, t4) ends with the four gates of unit_t for row
    // t4 alone: every row's activations run in lanes of their own, and no exchange
    // between lanes is needed.  The tile starts from xp.
    static_assert(R <= 4, "row r is column 2 r of an 8-column tile");
    const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
    const int unit_t = (unit & ~7) + g8;
    uint32_t a_hh[2][W / 16][4];
    load_a_fragments<W, MASKED>(w_hh, unit & ~7, lane, a_hh, h, h);
    float c_state = 0.0f;
    const bool live = t4 < R, store = live && row0 + t4 < batch && unit_t < h;
    size_t at = (size_t)(row0 + t4) * steps * h + unit_t;  // (row, t, unit_t) of y and cprev
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % NBUF;
      bar_sync(BAR_FULL + buf, THREADS);
      const float* ring = s_ring + buf * S * R * COLS;
      const int n = steps - c * S < S ? steps - c * S : S;
      for (int s = 0; s < n; ++s) {
        const T* h_prev = s_h + cur * 8 * XPW;
        T* h_next = s_h + (cur ^ 1) * 8 * XPW;
        float g[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        if (live) {
          const float4 xp = *reinterpret_cast<const float4*>(ring + (s * R + t4) * COLS + unit_t * 4);
          g[0][0] = xp.x; g[0][2] = xp.y; g[1][0] = xp.z; g[1][2] = xp.w;
        }
        mma_w<W>(g, a_hh, h_prev + g8 * XPW, t4);
        if (live) {
          const float ig = sigmoid(g[0][0]), fg = sigmoid(g[0][2]);
          const float gg = tanh_sig(g[1][0]), og = sigmoid(g[1][2]);
          if (TRAIN && store) cprev[at] = c_state;
          c_state = fg * c_state + ig * gg;
          const float hv = og * tanh_sig(c_state);
          store_f(h_next + 2 * t4 * XPW + unit_t, hv);
          if (store) store_f(y + at, hv);
          at += h;
        }
        cur ^= 1;
        bar_sync(BAR_CONS, COLS);
      }
      if (c + NBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
  } else {
    load_gate_weights<W, T>(w_hh, unit, gate, w, h, h);
    float c_state[R];
    const int quad_lane = (threadIdx.x & 31) & ~3;  // lane of this unit's gate i
    // Each of the unit's four lanes carries c; lane i stores y, c_{t-1} and h.
    bool store[R];
    size_t at[R];  // (row, t, unit) of y and cprev
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c_state[r] = 0.0f;
      store[r] = gate == 0 && row0 + r < batch && unit < h;
      at[r] = (size_t)(row0 + r) * steps * h + unit;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % NBUF;
      bar_sync(BAR_FULL + buf, THREADS);
      const float* ring = s_ring + buf * S * R * COLS;
      const int n = steps - c * S < S ? steps - c * S : S;
      for (int s = 0; s < n; ++s) {
        const float* h_prev = s_h + cur * R * H;
        float* h_next = s_h + (cur ^ 1) * R * H;
        float ph[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int m = 0; m < 4; ++m) ph[r][m] = 0.0f;
          dot_parts<W>(ph[r], w, h_prev + r * H, gate);
        }
        // Phase by phase over the rows, so that the rows' latencies overlap.
        float pre[R], act[R], ig[R], fg[R], gg[R], og[R], hv[R];
        transpose_reduce4<2, 1, R>(ph, gate & 2, gate & 1, pre);
#pragma unroll
        for (int r = 0; r < R; ++r) act[r] = activate(gate, ring[(s * R + r) * COLS + p] + pre[r]);
        gather_gates<R>(act, quad_lane, ig, fg, gg, og);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (TRAIN && store[r]) cprev[at[r]] = c_state[r];
          c_state[r] = fg[r] * c_state[r] + ig[r] * gg[r];
          hv[r] = og[r] * tanh_sig(c_state[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (gate == 0) h_next[r * H + unit] = hv[r];
          if (store[r]) y[at[r]] = hv[r];
          at[r] += h;
        }
        cur ^= 1;
        bar_sync(BAR_CONS, COLS);
      }
      if (c + NBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
  }
}

// ---- The short path: W = 32 and 16, T <= SHORT_MAX_STEPS (the plan's FWD_SHORT_MAX_STEPS) ----
//
// At the strided family's T = 50 the ring path's launch takes about 4 us
// before its first step and 0.26 us a step (bf16, B=512, H100; the T-sweep
// of ops/bench_lstm.py --steps): the steps are three quarters of it.  This
// kernel has no ring:
// - one thread copies the block's whole x (its R rows are one contiguous
//   span of R T W elements) into shared memory with one TMA bulk copy
//   (cp.async.bulk, completion on an mbarrier), issued before any weight
//   load, so the latencies overlap; a ragged last block copies its rows and
//   zero-fills the rest;
// - all warps project every step, xp = x . W_ih + b, into shared memory
//   before the first step (bf16 on the tensor cores as the ring's producers
//   do, the R rows' tiles of 8 steps in flight together; fp32 on the CUDA
//   cores in dot_parts' order), then the upper half exits.  Nothing runs
//   beside the steps: a version whose producer warps projected 8 steps
//   ahead of the recurrence, each 8 announced on an mbarrier, took longer
//   (bf16, B=512 and 128), its steps slowed by the producers;
// - the lower half runs the recurrence as the ring's consumers do, one barrier
//   a step, reading each step's xp a step ahead (after the step's mma, so
//   the load does not queue before h's), h's buffers swapped before the
//   barrier (no address arithmetic after it), and y (and c_{t-1}) stored to
//   global memory inside the step as the ring does (staging it in shared
//   memory made the step slower: the barrier waits on shared stores);
// - the arithmetic of every product, sum and activation is the ring path's
//   (lstm_common.cuh), so both paths give the same bits;
// - 2 barriers (0 and BAR_CONS, as immediates: with a register operand
//   ptxas reserves all 16 of the SM's) and at most 128 registers a thread,
//   so two blocks share an SM where shared memory allows it.
// W = 16 (the dry run's gradient check, T = 32; SHORT_MIN_BLOCKS): a block is
// 4 warps, 128 threads.  A step's recurrence needs COLS = 64 threads (4 lanes
// a unit, 16 units), so all 4 warps project (each half every other 8-step
// tile, or SU steps in fp32) and the lower 2 run the steps: halving the
// block instead (2 warps for both) would double the projection's time before
// the first step, and the steps run on 2 warps either way.  A lane's part
// of a product is one quad (NQ = 1) and the mma's k one tile.  The block
// holds a fraction of an SM's registers, so its budget is 4 blocks an SM (at
// most 128 registers a thread), as the plan's BLOCKS_PER_SM counts; at B = 4
// and T = 32 its 4 blocks take 4 SMs, and the call is x's copy, the
// weights' loads, 4 projection tiles and 32 dependent steps.
// Shared memory for R rows and T steps (fwd_short_smem_bytes; its Python
// copy is tests/test_torch_lstm_plan.py's, which holds it under the card's
// limit at SHORT_MAX_STEPS):
//   x's mbarrier, SHORT_HEADER bytes;
//   xp [R][T][4W + XPAD] fp32, a row's T steps padded to xp_row_floats: the
//     projection's 16-byte stores (lanes 2 steps apart) and the steps'
//     16-byte reads (lanes a row apart) both land in distinct banks;
//   x [R T + 8][XP] of T: the block's x, then 8 zero rows that the last
//     8-step tile of the projection reads past the end.  In bf16 its rows
//     are padded as the ring's are, so that the mma's B fragments read
//     distinct banks: the TMA copy lands in xp's space first, contiguous,
//     and all warps move it row by row;
//   h [2][H_ROWS][XP] of T, as the ring path's.
// Masked (MASKED, any 1 <= D, H <= W but D = H = W, at run time): the same
// buffers, the capacity's layout, so a block's shared memory is its square
// call's.  The weights load zeros past the real widths (lstm_common.cuh), y
// and c_{t-1} are stored at units j < H, and x's rows of D land in rows of
// XP with zeros at columns D .. W - 1 (the mma and dot_parts read W terms).
// That relayout exists in fp32 too (a square fp32 call's x lands in place),
// and x reaches it by one of two routes, chosen by short_x_tma from (D, T,
// the operand's size) alone: the TMA copy into xp's space, then every
// thread moves values to the padded rows, where a row's T D values are
// whole 16-byte pieces (so every block's span starts and ends 16-byte
// aligned, the TMA's rule); plain loads straight into the padded rows where
// they are not (bf16 at D = 17, T = 50: 1700 bytes a row).  Both put the
// same values in the same places, so the route never changes a bit; its
// Python copy is lstm_kernel.short_x_tma, which a CPU test holds on a model
// of both.  A masked call gives the masked ring's bits, and the square
// short call's on operands zero-padded to W.
constexpr int SHORT_MAX_STEPS = 64, XPAD = 4;
constexpr int SHORT_HEADER = 16;  // x's mbarrier; xp 16-byte aligned after it

// Floats from one row's xp to the next row's: T steps of xps floats, then
// a pad to 8 past a multiple of 32 (4 rows' 16-byte reads at one step take
// 4 distinct 32-byte bank groups).
__host__ __device__ constexpr int xp_row_floats(int steps, int xps) {
  return steps * xps + ((8 - steps * xps) % 32 + 32) % 32;
}

template <typename T, int R, int W>
constexpr size_t fwd_short_smem_bytes(int steps) {
  return SHORT_HEADER + sizeof(float) * (size_t)R * xp_row_floats(steps, 4 * W + XPAD) +
         sizeof(T) * ((size_t)(R * steps + 8) * XP<T, W>) + sizeof(T) * 2 * H_ROWS<T, R> * XP<T, W>;
}

template <int ID, int COUNT>
__device__ __forceinline__ void bar_sync_n() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}

// Wait for the first phase of an mbarrier (smem_addr, mbar_init:
// lstm_common.cuh) to complete (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(smem_addr(bar)) : "memory");
}
// The copy of `bytes` bytes (16-byte aligned, a multiple of 16) from global
// into shared memory, completing on bar (initialised to one arrival: this
// thread's).
__device__ __forceinline__ void bulk_copy_in(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Blocks an SM the short kernel's registers are budgeted for.
template <int W> constexpr int SHORT_MIN_BLOCKS = W == 16 ? 4 : 2;

// Whether a masked short call brings x in by the TMA (else plain loads):
// a row's T D values of elt bytes are whole 16-byte pieces.  The square
// widths always are (T 32 or 16 values of 2 or 4 bytes).
__host__ __device__ constexpr bool short_x_tma(int steps, int d, int elt) { return steps * d * elt % 16 == 0; }

template <typename T, bool TRAIN, int R, int W, bool MASKED>
__global__ void __launch_bounds__(8 * W, (SHORT_MIN_BLOCKS<W>))
lstm_fwd_short_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
                      const float* __restrict__ w_hh, const float* __restrict__ bias,
                      T* __restrict__ y, float* __restrict__ cprev, int batch, int steps, int d_in, int h_in) {
  static_assert(W == 32 || W == 16, "the short path is instantiated for W = 32 and 16");
  constexpr int D = W, H = W, COLS = 4 * W, XPS = COLS + XPAD;
  constexpr int XPW = XP<T, W>;
  const int d = MASKED ? d_in : D, h = MASKED ? h_in : H;
  // bf16, and every masked call: x lands contiguous (rows of d), then moves to padded rows
  constexpr bool PADDED = MASKED || XPW != D;
  const bool tma = !MASKED || short_x_tma(steps, d, (int)sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int xrf = xp_row_floats(steps, XPS);
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(smem);
  float* s_xp = reinterpret_cast<float*>(smem + SHORT_HEADER);  // [R][xrf]: step t of row r at r xrf + t XPS
  T* s_x = reinterpret_cast<T*>(s_xp + (size_t)R * xrf);       // [R T + 8][XPW]
  T* s_h = s_x + (size_t)(R * steps + 8) * XPW;                // [2][H_ROWS][XPW]
  T* x_in = PADDED ? reinterpret_cast<T*>(s_xp) : s_x;          // where the TMA copy lands

  const int p = threadIdx.x & (COLS - 1), half = threadIdx.x / COLS;
  const int unit = p >> 2, gate = p & 3, col = gate * H + unit;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int unit_t = (unit & ~7) + g8;  // bf16: the unit whose gates this lane holds after an mma
  const int row0 = blockIdx.x * R;
  const int nrows = batch - row0 < R ? batch - row0 : R;

  if (threadIdx.x == 0 && tma) {
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_copy_in(x_in, x + (size_t)row0 * steps * d, (uint32_t)(nrows * steps * d * sizeof(T)), x_bar);
  }
  for (int i = nrows * steps * XPW + threadIdx.x; i < (R * steps + 8) * XPW; i += 2 * COLS) store_f(s_x + i, 0.0f);
  for (int i = threadIdx.x; i < 2 * H_ROWS<T, R> * XPW; i += 2 * COLS) store_f(s_h + i, 0.0f);  // h_{-1} = 0

  // The weights into registers while x is in flight: W_ih for the
  // projection, and the lower warps' W_hh for the recurrence.
  uint32_t a_ih[2][W / 16][4], a_hh[2][W / 16][4];
  float b4[4], w[W], wh[W], b = 0.0f;
  if constexpr (is_bf16<T>) {
    load_a_fragments<W, MASKED>(w_ih, unit & ~7, lane, a_ih, h, d);
    if (half == 0) load_a_fragments<W, MASKED>(w_hh, unit & ~7, lane, a_hh, h, h);
#pragma unroll
    for (int m = 0; m < 4; ++m) b4[m] = !MASKED || unit_t < h ? bias[m * h + unit_t] : 0.0f;
  } else {
    load_gate_weights<W, T>(w_ih, unit, gate, w, h, d);
    if (half == 0) load_gate_weights<W, T>(w_hh, unit, gate, wh, h, h);
    b = !MASKED ? bias[col] : unit < h ? bias[gate * h + unit] : 0.0f;
  }
  __syncthreads();  // the mbarrier's init, the zeros
  if (tma) mbar_wait(x_bar);
  if constexpr (MASKED) {
    // Value a thread into rows of W, zeros at columns d .. W - 1: from the
    // contiguous copy, or (no TMA) straight from device memory.
    const T* src = tma ? x_in : x + (size_t)row0 * steps * d;
    for (int i = threadIdx.x; i < nrows * steps * W; i += 2 * COLS) {
      const int r = i / W, k = i % W;
      store_f(s_x + r * XPW + k, k < d ? load_f(src + r * d + k) : 0.0f);
    }
    __syncthreads();  // x in place; xp's space free again
  } else if constexpr (PADDED) {
    // 16 bytes a thread: row i's chunk j from the contiguous copy to its padded row
    constexpr int CH = 16 / sizeof(T), ROW_CH = D / CH;
    for (int i = threadIdx.x; i < nrows * steps * ROW_CH; i += 2 * COLS)
      *reinterpret_cast<int4*>(s_x + (i / ROW_CH) * XPW + (i % ROW_CH) * CH) =
          *reinterpret_cast<const int4*>(x_in + i * CH);
    __syncthreads();  // x in place; xp's space free again
  }

  // ---- xp = x . W_ih + b for every step, by all warps, the halves
  //      taking turns over 8-step tiles ----
  if constexpr (is_bf16<T>) {
    // Tensor cores: a tile is 8 steps of a row (lstm_common.cuh); the R
    // rows' tiles of the same steps are independent, so their mma chains
    // are in flight together.
    const int n_tiles = (steps + 7) / 8;
#pragma unroll 1
    for (int nt = half; nt < n_tiles; nt += 2) {
      float c[R][2][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[r][0][e] = b4[e / 2], c[r][1][e] = b4[2 + e / 2];
        mma_w<W>(c[r], a_ih, s_x + (r * steps + nt * 8 + g8) * XPW, t4);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = nt * 8 + 2 * t4 + e;
          if (t < steps)
            *reinterpret_cast<float4*>(s_xp + r * xrf + t * XPS + unit_t * 4) =
                make_float4(c[r][0][e], c[r][0][2 + e], c[r][1][e], c[r][1][2 + e]);
        }
    }
  } else {
    // 8 (step, row) sums of 4 gates in flight: 32 running sums a thread
    constexpr int SU = 8 / R, N = SU * R;
#pragma unroll 1
    for (int s0 = half * SU; s0 < steps; s0 += 2 * SU) {
      float acc[N][4], px[N];
#pragma unroll
      for (int ss = 0; ss < SU; ++ss)
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[ss * R + r][m] = 0.0f;
          dot_parts<W>(acc[ss * R + r], w, s_x + (r * steps + s0 + ss) * XPW, gate);
        }
      transpose_reduce4<2, 1, N>(acc, gate & 2, gate & 1, px);
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (s0 + n / R < steps) s_xp[(n % R) * xrf + (s0 + n / R) * XPS + p] = px[n] + b;
    }
  }
  __syncthreads();  // every xp is in place
  if (half) return;

  // ---- the recurrence: the ring path's consumers, reading xp in place ----
  if constexpr (is_bf16<T>) {
    static_assert(R <= 4, "row r is column 2 r of an 8-column tile");
    float c_state = 0.0f;
    const bool live = t4 < R, store = live && row0 + t4 < batch && (!MASKED || unit_t < h);
    size_t at = (size_t)(row0 + t4) * steps * h + unit_t;  // (row, t, unit_t) of y and cprev
    const float* xp_at = s_xp + t4 * xrf + unit_t * 4;     // step s at xp_at + s XPS
    float4 xp = live ? *reinterpret_cast<const float4*>(xp_at) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // This lane's B row of h_{t-1} and the place of its h, swapped between
    // the two buffers before each barrier: no address arithmetic after it.
    const T *rd = s_h + g8 * XPW, *rd2 = rd + 8 * XPW;
    T *wr = s_h + 8 * XPW + 2 * t4 * XPW + unit_t, *wr2 = wr - 8 * XPW;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      float g[2][4] = {{xp.x, 0.0f, xp.y, 0.0f}, {xp.z, 0.0f, xp.w, 0.0f}};
      mma_w<W>(g, a_hh, rd, t4);
      // The next step's xp, read while the mma runs: it does not wait on h.
      if (live && s + 1 < steps) xp = *reinterpret_cast<const float4*>(xp_at + (s + 1) * XPS);
      if (live) {
        const float ig = sigmoid(g[0][0]), fg = sigmoid(g[0][2]);
        const float gg = tanh_sig(g[1][0]), og = sigmoid(g[1][2]);
        if (TRAIN && store) cprev[at] = c_state;
        c_state = fg * c_state + ig * gg;
        const float hv = og * tanh_sig(c_state);
        store_f(wr, hv);
        if (store) store_f(y + at, hv);
        at += h;
      }
      const T* r0 = rd;
      rd = rd2, rd2 = r0;
      T* w0 = wr;
      wr = wr2, wr2 = w0;
      bar_sync_n<BAR_CONS, COLS>();
    }
  } else {
    float c_state[R], xp[R];  // xp: this step's, read a step ahead
    const int quad_lane = lane & ~3;  // lane of this unit's gate i
    // Each of the unit's four lanes carries c; lane i stores y, c_{t-1} and h.
    bool store[R];
    size_t at[R];  // (row, t, unit) of y and cprev
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c_state[r] = 0.0f;
      xp[r] = s_xp[r * xrf + p];
      store[r] = gate == 0 && row0 + r < batch && (!MASKED || unit < h);
      at[r] = (size_t)(row0 + r) * steps * h + unit;
    }
    const float *h_prev = s_h, *h_prev2 = s_h + R * H;  // swapped before each barrier, as in bf16
    float *h_next = s_h + R * H, *h_next2 = s_h;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      float ph[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int m = 0; m < 4; ++m) ph[r][m] = 0.0f;
        dot_parts<W>(ph[r], wh, h_prev + r * H, gate);
      }
      float pre[R], act[R], ig[R], fg[R], gg[R], og[R], hv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) act[r] = xp[r];
      if (s + 1 < steps)
#pragma unroll
        for (int r = 0; r < R; ++r) xp[r] = s_xp[r * xrf + (s + 1) * XPS + p];
      // Phase by phase over the rows, so that the rows' latencies overlap.
      transpose_reduce4<2, 1, R>(ph, gate & 2, gate & 1, pre);
#pragma unroll
      for (int r = 0; r < R; ++r) act[r] = activate(gate, act[r] + pre[r]);
      gather_gates<R>(act, quad_lane, ig, fg, gg, og);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (TRAIN && store[r]) cprev[at[r]] = c_state[r];
        c_state[r] = fg[r] * c_state[r] + ig[r] * gg[r];
        hv[r] = og[r] * tanh_sig(c_state[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (gate == 0) h_next[r * H + unit] = hv[r];
        if (store[r]) y[at[r]] = hv[r];
        at[r] += h;
      }
      const float* p0 = h_prev;
      h_prev = h_prev2, h_prev2 = p0;
      float* n0 = h_next;
      h_next = h_next2, h_next2 = n0;
      bar_sync_n<BAR_CONS, COLS>();
    }
  }
}

template <typename T, bool TRAIN, int R, int W>
int launch_rows(const void* x, const float* w_ih, const float* w_hh, const float* bias,
                void* y, float* cprev, int batch, int steps, int d, int h, bool short_path, void* stream) {
  const int blocks = (batch + R - 1) / R;
  if constexpr (W == 32 || W == 16) {
    if (short_path) {
      if (steps > SHORT_MAX_STEPS || d < 1 || h < 1 || d > W || h > W) return (int)cudaErrorInvalidValue;
      // The attribute is the card's opt-in limit, which the buffers at
      // SHORT_MAX_STEPS and four fp32 rows stay under; a masked call's
      // buffers are its capacity's.
      static SmemOnce once, once_masked;
      const bool square = d == W && h == W;
      auto kernel = square ? lstm_fwd_short_kernel<T, TRAIN, R, W, false> : lstm_fwd_short_kernel<T, TRAIN, R, W, true>;
      cudaError_t err = (square ? once : once_masked).set(kernel, 0);
      if (err != cudaSuccess) return (int)err;
      kernel<<<blocks, 8 * W, fwd_short_smem_bytes<T, R, W>(steps), (cudaStream_t)stream>>>(
          (const T*)x, w_ih, w_hh, bias, (T*)y, cprev, batch, steps, d, h);
      return (int)cudaGetLastError();
    }
  } else if (short_path) {
    return (int)cudaErrorInvalidValue;
  }
  if (d < 1 || h < 1 || d > W || h > W) return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem_bytes<T, R, W>();
  static SmemOnce once, once_masked;
  const bool square = d == W && h == W;
  auto kernel = square ? lstm_fwd_kernel<T, TRAIN, R, W, false> : lstm_fwd_kernel<T, TRAIN, R, W, true>;
  cudaError_t err = (square ? once : once_masked).set(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 8 * W, smem, (cudaStream_t)stream>>>((const T*)x, w_ih, w_hh, bias, (T*)y, cprev, batch,
                                                        steps, d, h);
  return (int)cudaGetLastError();
}

template <typename T, bool TRAIN, int W>
int launch(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,
           float* cprev, int batch, int steps, int d, int h, int rows, int short_path, void* stream) {
  const bool s = short_path != 0;
  switch (rows) {
    case 1: return launch_rows<T, TRAIN, 1, W>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, s, stream);
    case 2: return launch_rows<T, TRAIN, 2, W>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, s, stream);
    case 4: return launch_rows<T, TRAIN, 4, W>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Capacity 64 (no suffix), 48 (_w48), 32 (_w32) and 16 (_w16), for any 1 <=
// D, H <= the capacity (the cluster kernels, _cluster: lstm_fwd_cluster.cu).
// x: (B, T, D) and y: (B, T, H) in the instantiation's type; w_ih: (4H, D),
// w_hh: (4H, H) fp32, bias: (4H,) fp32; all contiguous on the current
// device.  rows: batch rows per block, 1, 2 or 4.  short_path: 1 for the
// short path (capacities 32 and 16 at any D, H within them, x 16-byte
// aligned, T small enough for its buffers; the plan's), 0 for the ring.  Returns the cudaError_t of the
// launch (0 = launched).
#define AWM_LSTM_FWD_ENTRY(NAME, TYPE, W)                                                        \
  int NAME(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,     \
           int batch, int steps, int d, int h, int rows, int short_path, void* stream) {        \
    return launch<TYPE, false, W>(x, w_ih, w_hh, bias, y, nullptr, batch, steps, d, h, rows,    \
                                  short_path, stream);                                          \
  }
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_f32, float, 64)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_bf16, __nv_bfloat16, 64)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_f32_w48, float, 48)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_bf16_w48, __nv_bfloat16, 48)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_f32_w32, float, 32)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_bf16_w32, __nv_bfloat16, 32)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_f32_w16, float, 16)
AWM_LSTM_FWD_ENTRY(awm_lstm_fwd_bf16_w16, __nv_bfloat16, 16)
#undef AWM_LSTM_FWD_ENTRY

// As above, plus cprev: (B, T, H) fp32, c_{t-1} of every step.
#define AWM_LSTM_FWD_TRAIN_ENTRY(NAME, TYPE, W)                                                  \
  int NAME(const void* x, const float* w_ih, const float* w_hh, const float* bias, void* y,     \
           float* cprev, int batch, int steps, int d, int h, int rows, int short_path,         \
           void* stream) {                                                                      \
    return launch<TYPE, true, W>(x, w_ih, w_hh, bias, y, cprev, batch, steps, d, h, rows,       \
                                 short_path, stream);                                           \
  }
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_f32, float, 64)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_bf16, __nv_bfloat16, 64)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_f32_w48, float, 48)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_bf16_w48, __nv_bfloat16, 48)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_f32_w32, float, 32)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_bf16_w32, __nv_bfloat16, 32)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_f32_w16, float, 16)
AWM_LSTM_FWD_TRAIN_ENTRY(awm_lstm_fwd_train_bf16_w16, __nv_bfloat16, 16)
#undef AWM_LSTM_FWD_TRAIN_ENTRY

const char* awm_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
