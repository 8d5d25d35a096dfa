// LSTM backward for Hopper (sm_90a): the gradient of lstm_fwd.cu's forward.
//
// Replaces awm_tpu/ops/pallas/lstm_kernel.py::_backward + _lstm_bwd_kernel
// (the pallas_call at line 391).  Same arithmetic as that kernel:
// - h_{t-1} is rebuilt from the y stream (zero at t = 0); under bf16, y is
//   stored bf16, which is exactly the operand the forward multiplied;
// - the gates are recomputed from x, h_{t-1} and c_{t-1} (in fp32 in the
//   forward's own summation order, lstm_common.cuh), never stored in device
//   memory;
// - (dh, dc) are carried in reverse time;
// - da = [da_i, da_f, da_g, da_o] is rounded to the operand type for
//   dh_{t-1} = da . W_hh, dx = da . W_ih, dW_ih = sum x^T da and
//   dW_hh = sum h_{t-1}^T da; db sums the fp32 da;
// - weight gradients come out fp32, dx in x's type.
// dy comes in the instantiation's type (autograd hands it in y's), the
// weights fp32 (a bf16 instantiation rounds them to nearest even as they
// load), so no cast kernel runs beside a call.
//
// Every register-held kernel is a template over the capacity W,
// instantiated for 64, 48, 32 and 16 (lstm_common.cuh); G = 4 W gate
// columns, K = 2 W terms.  A call passes its D, H <= W at run time; at D =
// H = W (64, 32, 16) the products below run at the capacity, else dx, dW
// and the sum run at the runtime widths (lstm_bwd_{dx,dw,sum}_any_kernel;
// bf16 dx / dW lstm_bwd_{dx,dw}_any_mma_kernel; in lstm_any.cuh, whose dx
// and dW lstm_wide.cu's windows run too).  Capacity 48 has no square
// products of its own: its 48 x 48 runs the runtime widths' set, one set
// of kernels fewer to build and hold (their times: PERF.md section 6).
// Widths above 64 run a gate pass over the whole card (lstm_bwd_gates_*,
// lstm_any.cuh), the recurrence on a
// thread-block cluster (lstm_bwd_cluster_kernel, below), and then those
// three; widths above 256 run lstm_wide.cu.  A call at the capacities takes one of two paths,
// chosen by the caller from the shape (ops/lstm_kernel.py::launch_plan):
//
// Four launches on one stream (every call at W = 64 and 48 and at the
// runtime widths; at W = 32 and 16 where the fused kernel's grid would not
// be resident at once, or T > 64, the plan's limit for the rows' da in
// shared memory):
//   1. lstm_bwd_rec: one block per R batch rows (R = 1 or 2, chosen by the
//      caller) runs all T steps in reverse.
//      It writes da, rounded to the operand type, to a (B, T, G) scratch
//      in device memory (2.1 GB fp32 / 1.05 GB bf16 at W=64, B=128,
//      T=16000) and a per-block partial db.
//   2. dx = da . W_ih over row tiles of the flattened (B*T) axis.
//   3. dW = da^T . [x | h_{t-1}] over chunks of the (B*T) axis; each block
//      writes partial sums of its chunk.
//   4. lstm_bwd_sum: sums the chunk partials and the db partials in a fixed
//      order.  No atomics: two runs give the same bits.
// One launch, lstm_bwd_fused (W = 32 and 16 at any D, H within them, T <= 64, every
// block of the grid resident at once: at W = 32 one block an SM, at W = 16
// the blocks an SM that the card's occupancy reading gives, read before the
// launch; W = 16's own design below): a block owns R batch rows and runs the same
// recurrence, keeping its rows' da (R T x G in the operand type, 12.8 KB a
// row at T = 50 in bf16) in shared memory; then dx of its rows and its
// (G x K) dW and db partials from that da and the x_t | h_{t-1} rows its
// producer warps staged on the way; then, after one grid-wide barrier
// (a cooperative launch), each block sums a fixed slice of the G K + G
// outputs over every block's partial in block order.  No atomics on the
// values: two runs give the same bits.
//
// What bounds it on this card: the recurrence is sequential in T, so it
// costs the latency of one step times T; dx and dW are real matrix
// products over the B T rows (2M at W = 64, T = 16000; 6400 at W = 32,
// T = 50).  The bound of the whole call (the products in fp32, bytes in
// bf16) is far below the recurrence's latency.  At T = 50 the four
// launches' fixed cost (each ramps up a grid and drains it, and the sum
// waits on all of dW) was a third of the call's device time and the host's
// work for them most of its wall time: the fused kernel keeps only the
// grid barrier of that.  What the design does about it:
// - only the (dh, dc) carry is sequential, so only it is on the sequential
//   path.  The gate recompute of a step needs x_t, y_{t-1} and c_{t-1}, all
//   saved by the forward: the producer warps (lstm_common.cuh) compute it
//   for a chunk of 8 steps at a time, ahead of the consumers, and leave in
//   a two-buffer ring in shared memory the step's local derivatives: for
//   each gate column the factor that turns the carried gradient into da,
//   and for each unit o (1 - tanh^2 c_t), f and dy.  In bf16 the recompute
//   runs on the tensor cores (mma.sync, the chunk's 8 steps are a tile's N)
//   with [W_ih | W_hh] in registers as fragments; in fp32 on the CUDA
//   cores, the weights read from shared memory, one 16-byte load per 4 terms
//   reused over the chunk's 8 steps;
// - a consumer step is: dc and da from the ring (5 flops), da to shared
//   memory, one barrier among the consumer warps, dh_{t-1} = da . W_hh from
//   register-held weights (bf16 widened once), split over the lanes of a
//   warp so that a thread reads 16 of the 256 da values (8 of 128 at
//   W = 32, 4 of 64 at W = 16; at W = 48 capacity 64's split, 16 of the
//   192 on 12 of 16 lanes and exact zeros on the other four, so that its
//   sums keep capacity 64's bits), summed by shuffles in a fixed order.  da
//   is double-buffered;
// - dx and dW: in bf16 on the tensor cores (da, x and y are bf16 already,
//   products exact, fp32 sums), staged through shared memory with 16-byte
//   loads; in fp32 on the CUDA cores in full fp32, dW with 8 x 8 outputs a
//   thread (8 x 4 at W = 32, 4 x 4 in W = 16's fused kernel) so that four
//   16-byte reads feed 64 products.
//
// Plain C interface, loaded with ctypes by awm_tpu_torch/ops/lstm_kernel.py.

#include <cooperative_groups.h>

#include "lstm_any.cuh"
#include "lstm_common.cuh"

namespace {

using namespace awm;
namespace cg = cooperative_groups;

constexpr int SB = 8;  // steps per chunk of the ring

// Floats of one (step, row) of the ring: factor[G] | dtanh[H] | f[H] | dy[H].
template <int W> constexpr int RING = 4 * W + 3 * W;
// Stride of one gate's da in shared memory: the four gates' reads fall in
// distinct banks.
template <int W> constexpr int DA_GATE = W + 8;
template <int W> constexpr int DA_ROW = 4 * DA_GATE<W>;

// The fp32 producers read [W_ih | W_hh] from shared memory; the bf16 ones
// hold them in registers as mma fragments.
template <typename T, int W>
constexpr int W_SMEM_BYTES = is_bf16<T> ? 0 : (int)sizeof(T) * (4 * W) * (2 * W);
// Row stride of the staged x_t | h_{t-1}: the bf16 rows are read as mma B
// fragments, 8 rows at a time, and the pad puts them in distinct banks.
template <typename T, int W> constexpr int KP = is_bf16<T> ? 2 * W + 8 : 2 * W;

template <typename T, int R, int W>
__host__ __device__ constexpr int rec_smem_bytes() {
  return (int)(W_SMEM_BYTES<T, W> +
               sizeof(float) * (NBUF * SB * R * RING<W> + R * SB * W + 2 * R * DA_ROW<W>) +
               sizeof(T) * R * SB * KP<T, W>);
}


// The reverse-time recurrence of the R batch rows from row0, the body of
// both paths' recurrence.  It stores da, rounded to the operand type, at
// da_dst + (r * steps + t) * da_stride + column (the device-memory scratch,
// rows past the batch skipped; or the fused kernel's shared memory, where
// those rows get zeros), and the block's db (its rows' fp32 da in a fixed
// order) at db_out[column].  Four launches: column = gate h + unit of the
// call's real width h, written for units < h only.  FUSED: column = gate W
// + unit, the capacity's layout, zeros at the padded units, so that the
// fused kernel's products and sum are the square call's on zero-padded
// operands.  FUSED: the producers also leave
// x_t | h_{t-1} of every (r, t) at s_v + (r * steps + t) * v_stride, and
// call producers_done() once they have handed over their last chunk.
// MASKED = false: D = H = W, the widths folded in at compile time (the code
// the square widths had before the runtime widths); true: a.d, a.h.
template <typename T, int R, int W, bool FUSED, bool MASKED, typename Tail>
__device__ __forceinline__ void bwd_recurrence(const BwdArgs<T> a, unsigned char* smem, int row0,
                                               T* da_dst, int da_stride, float* db_out, T* s_v,
                                               int v_stride, Tail producers_done) {
  static_assert(valid_width<W>, "instantiated for W = 16, 32, 48 and 64");
  constexpr int D = W, H = W, G = 4 * W, K = 2 * W, COLS = G, THREADS = 2 * COLS;
  constexpr int NQ = W / 16, RW = RING<W>, DG = DA_GATE<W>, DR = DA_ROW<W>, KPW = KP<T, W>;
  const int batch = a.batch, steps = a.steps, d = MASKED ? a.d : W, h = MASKED ? a.h : W;
  // fp32 only: s_w[((sec * 4 + m) * NQ + q) * COLS + p] = the four terms 4 (4 q + kp) .. + 3 of
  // gate m's row for thread p's unit, of W_ih (sec 0) or W_hh (sec 1): lstm_common.cuh's split.
  const float4* s_w = reinterpret_cast<const float4*>(smem);
  float* s_ring = reinterpret_cast<float*>(smem + W_SMEM_BYTES<T, W>);  // [NBUF][SB][R][RING]
  float* s_c = s_ring + NBUF * SB * R * RW;                             // [R][SB][H]: c_{t-1}
  float* s_da = s_c + R * SB * H;                                       // [2][R][DA_ROW], operands
  T* s_xh = reinterpret_cast<T*>(s_da + 2 * R * DR);                    // [R][SB][KP]: x_t | h_{t-1}

  const int p = threadIdx.x % COLS;  // COLS = 192 at W = 48: not a power of two
  const int unit = p >> 2, gate = p & 3, col = gate * h + unit;  // col: da's column at the real width
  const int fcol = gate * W + unit;                              // FUSED: at the capacity's
  const int n_chunks = (steps + SB - 1) / SB;
  // Chunk c holds steps t = t_hi - s, s = 0..SB-1, t_hi = steps - 1 - c * SB.

  if (threadIdx.x >= COLS) {
    // ---- producers: the gate recompute and each step's local derivatives ----
    const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
    const int unit_t = (unit & ~7) + g8;  // the unit whose gates this lane holds after an mma
    uint32_t a_ih[2][W / 16][4], a_hh[2][W / 16][4];
    float b = 0.0f, b4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (is_bf16<T>) {
      load_a_fragments<W, MASKED>(a.w_ih, unit & ~7, lane, a_ih, h, d);
      load_a_fragments<W, MASKED>(a.w_hh, unit & ~7, lane, a_hh, h, h);
#pragma unroll
      for (int m = 0; m < 4; ++m) b4[m] = unit_t < h ? a.bias[m * h + unit_t] : 0.0f;
    } else {
      T* s_w_t = reinterpret_cast<T*>(smem);
      for (int idx = p; idx < G * K; idx += COLS) {
        const int j = idx / K, k = idx % K;  // row j of the weights (gate m, unit u), term k
        const int sec = k / D, quad = (k % D) / 4, m = j / H, u = j % H;
        const size_t row = (size_t)(m * h + u);
        const float wv = sec == 0 ? load_wm(a.w_ih, u < h, row, k, d) : load_wm(a.w_hh, u < h, row, k - D, h);
        const int slot = ((sec * 4 + m) * NQ + quad / 4) * COLS + u * 4 + quad % 4;
        s_w_t[slot * 4 + k % 4] = wv;
      }
      b = unit < h ? a.bias[col] : 0.0f;
    }
    constexpr int PER = R * SB * H / COLS;  // staged values per thread, chunk and stream
    float xr[PER], yr[PER], cr[PER], dyr[PER];
    auto fetch = [&](int c) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * COLS + p;  // [r][s][u]
        const int r = e / (SB * H), s = (e / H) % SB, u = e % H;
        const int row = row0 + r, t = steps - 1 - c * SB - s;
        const bool ok = row < batch && t >= 0, uh = ok && u < h;
        const size_t at = (size_t)row * steps + t;  // (row, t) of the streams
        xr[i] = ok && u < d ? load_f(a.x + at * d + u) : 0.0f;
        yr[i] = uh && t > 0 ? load_f(a.y + (at - 1) * h + u) : 0.0f;  // h_{t-1} = y_{t-1}, zero at t = 0
        cr[i] = uh ? a.cprev[at * h + u] : 0.0f;
        dyr[i] = uh ? load_f(a.dy + at * h + u) : 0.0f;
      }
    };
    fetch(0);
    const int quad_lane = (threadIdx.x & 31) & ~3;
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % NBUF;
      float* ring = s_ring + buf * SB * R * RW;
      bar_sync(BAR_PROD, COLS);  // the last chunk's reads of s_xh and s_c are done (and s_w is staged)
      if (c >= NBUF) bar_sync(BAR_EMPTY + buf, THREADS);  // the consumers are done with chunk c - NBUF
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = i * COLS + p;
        const int r = e / (SB * H), s = (e / H) % SB, u = e % H;
        store_f(s_xh + (r * SB + s) * KPW + u, xr[i]);
        store_f(s_xh + (r * SB + s) * KPW + D + u, yr[i]);
        s_c[(r * SB + s) * H + u] = cr[i];
        ring[(s * R + r) * RW + G + 2 * H + u] = dyr[i];
        if constexpr (FUSED) {
          const int t = steps - 1 - c * SB - s;
          if (t >= 0) {
            store_f(s_v + (r * steps + t) * v_stride + u, xr[i]);
            store_f(s_v + (r * steps + t) * v_stride + D + u, yr[i]);
          }
        }
      }
      if (c + 1 < n_chunks) fetch(c + 1);
      bar_sync(BAR_PROD, COLS);
      if constexpr (is_bf16<T>) {
        // Tensor cores: a row's 8 steps are one mma tile (lstm_common.cuh); the lane
        // then holds the four gates of unit_t for steps 2 t4 and 2 t4 + 1.
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
          float c[2][4] = {{b4[0], b4[0], b4[1], b4[1]}, {b4[2], b4[2], b4[3], b4[3]}};
          const T* v = s_xh + (r * SB + g8) * KPW;
          mma_w<W>(c, a_ih, v, t4);
          mma_w<W>(c, a_hh, v + D, t4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = 2 * t4 + e;
            const float ig = sigmoid(c[0][e]), fg = sigmoid(c[0][2 + e]);
            const float gg = tanh_sig(c[1][e]), og = sigmoid(c[1][2 + e]);
            const float c_prev = s_c[(r * SB + s) * H + unit_t];
            const float tc = tanh_sig(fg * c_prev + ig * gg);
            float* en = ring + (s * R + r) * RW;
            *reinterpret_cast<float4*>(en + unit_t * 4) =
                make_float4(gg * ig * (1.0f - ig), c_prev * fg * (1.0f - fg),
                            ig * (1.0f - gg * gg), tc * og * (1.0f - og));
            en[G + unit_t] = og * (1.0f - tc * tc);
            en[G + H + unit_t] = fg;
          }
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
          // acc[sec][s][m]: this lane's part of gate m's x (sec 0) and h (sec 1) products.
          float acc[2][SB][4];
#pragma unroll
          for (int sec = 0; sec < 2; ++sec)
#pragma unroll
            for (int s = 0; s < SB; ++s)
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[sec][s][m] = 0.0f;
          const float* xh = s_xh + r * SB * K;  // T = float here, KP = K
#pragma unroll
          for (int sec = 0; sec < 2; ++sec)
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              float4 w[4];
#pragma unroll
              for (int m = 0; m < 4; ++m) w[m] = s_w[((sec * 4 + m) * NQ + q) * COLS + p];
#pragma unroll
              for (int s = 0; s < SB; ++s) {
                const float4 v =
                    *reinterpret_cast<const float4*>(xh + s * K + sec * D + 4 * (4 * q + gate));
#pragma unroll
                for (int m = 0; m < 4; ++m) dot_quad(acc[sec][s][m], w[m].x, w[m].y, w[m].z, w[m].w, v);
              }
            }
          // Phase by phase over the steps, so that their latencies overlap.
          float px[SB], ph[SB], act[SB], ig[SB], fg[SB], gg[SB], og[SB];
          transpose_reduce4<2, 1, SB>(acc[0], gate & 2, gate & 1, px);
          transpose_reduce4<2, 1, SB>(acc[1], gate & 2, gate & 1, ph);
#pragma unroll
          for (int s = 0; s < SB; ++s) act[s] = activate(gate, (px[s] + b) + ph[s]);
          gather_gates<SB>(act, quad_lane, ig, fg, gg, og);
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            const float c_prev = s_c[(r * SB + s) * H + unit];
            const float tc = tanh_sig(fg[s] * c_prev + ig[s] * gg[s]);
            // da of this column = factor * (dh_total for gate o, dc_total for i, f, g).
            const float factor = gate == 0 ? gg[s] * ig[s] * (1.0f - ig[s])
                               : gate == 1 ? c_prev * fg[s] * (1.0f - fg[s])
                               : gate == 2 ? ig[s] * (1.0f - gg[s] * gg[s])
                                           : tc * og[s] * (1.0f - og[s]);
            float* e = ring + (s * R + r) * RW;
            e[p] = factor;
            if (gate == 0) {
              e[G + unit] = og[s] * (1.0f - tc * tc);  // dc_total = dc + dh_total * this
              e[G + H + unit] = fg[s];                 // dc_{t-1} = dc_total * f
            }
          }
        }
      }
      __threadfence_block();
      bar_arrive(BAR_FULL + buf, THREADS);
    }
    producers_done();
    return;
  }

  // ---- consumers: the (dh, dc) carry ----
  // dh_{t-1} = da . W_hh in a warp: its 8 units x all G columns j of da.  Lane
  // (half og = lane / 16, part jp = lane % 16) takes the four units 4 og .. 4 og + 3 of
  // the warp and the 4 EP columns j = H q + EP jp + e (q = 0..3, e = 0..EP-1, EP = H / 16):
  // w[(q * EP + e) * 4 + o] = W_hh[H q + EP jp + e][unit o of its four].  Four reads
  // of 4 EP floats a step and row, not 4 EP one-float reads; the parts meet by shuffles.
  // W = 48 keeps capacity 64's EP = 4: lanes jp >= 12 hold zero weights, read
  // nothing (past column 47 lie the gate's pad, never written, and the next
  // row; 0 x NaN would be NaN) and give +0 parts, so each unit's dh is capacity
  // 64's sum less terms that are exactly zero, in the same tree.
  constexpr int EP = W == 48 ? 4 : H / 16;
  constexpr bool IDLE_LANES = 16 * EP > H;
  const int lane = threadIdx.x & 31, og = lane >> 4, jp = lane & 15;
  const bool live = !IDLE_LANES || EP * jp < H;
  const int unit0 = (unit & ~7) + 4 * og;
  float w[16 * EP];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < EP; ++e)
#pragma unroll
      for (int o = 0; o < 4; ++o)
        w[(q * EP + e) * 4 + o] = operand(load_wm(a.w_hh, EP * jp + e < h, (size_t)(q * h + EP * jp + e),
                                                   unit0 + o, h), a.x);
  float dh[R], dc[R], db_acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { dh[r] = 0.0f; dc[r] = 0.0f; db_acc[r] = 0.0f; }

  int cur = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c % NBUF;
    bar_sync(BAR_FULL + buf, THREADS);
    const float* ring = s_ring + buf * SB * R * RW;
    const int t_hi = steps - 1 - c * SB;
    const int n = t_hi + 1 < SB ? t_hi + 1 : SB;
    for (int s = 0; s < n; ++s) {
      const int t = t_hi - s;
      float* da_s = s_da + cur * R * DR;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* e = ring + (s * R + r) * RW;
        const float dh_total = e[G + 2 * H + unit] + dh[r];
        const float dc_total = dc[r] + dh_total * e[G + unit];
        const float da = (gate == 3 ? dh_total : dc_total) * e[p];
        dc[r] = dc_total * e[G + H + unit];
        db_acc[r] += da;
        da_s[r * DR + gate * DG + unit] = operand(da, a.x);
        if constexpr (FUSED)
          store_f(da_dst + (size_t)(r * steps + t) * da_stride + fcol, unit < h ? da : 0.0f);
        else if (row0 + r < batch && unit < h)
          store_f(da_dst + (size_t)(r * steps + t) * da_stride + col, da);
      }
      bar_sync(BAR_CONS, COLS);
      // Each output's 4 EP terms in order (q, e), one running sum; then the 16 parts:
      // a transposing exchange over lanes 8 and 4 apart leaves each lane one output,
      // and two butterfly sums finish it in all four lanes of its unit.
      float part[R][4], sum[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* av = da_s + r * DR + EP * jp;
#pragma unroll
        for (int o = 0; o < 4; ++o) part[r][o] = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float ve[EP];
          if constexpr (EP == 4) {
            const float4 v = live ? *reinterpret_cast<const float4*>(av + q * DG) : make_float4(0.f, 0.f, 0.f, 0.f);
            ve[0] = v.x; ve[1] = v.y; ve[2] = v.z; ve[3] = v.w;
          } else if constexpr (EP == 2) {
            const float2 v = *reinterpret_cast<const float2*>(av + q * DG);
            ve[0] = v.x; ve[1] = v.y;
          } else {
            ve[0] = av[q * DG];
          }
#pragma unroll
          for (int e = 0; e < EP; ++e)
#pragma unroll
            for (int o = 0; o < 4; ++o) part[r][o] = fmaf(ve[e], w[(q * EP + e) * 4 + o], part[r][o]);
        }
      }
      transpose_reduce4<8, 4, R>(part, jp & 8, jp & 4, sum);
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
#pragma unroll
      for (int r = 0; r < R; ++r) dh[r] = sum[r] + __shfl_xor_sync(0xffffffffu, sum[r], 1);
      // dh[r] is of unit (lane / 4) of the warp: this thread's unit.
      cur ^= 1;
    }
    if (c + NBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, THREADS);
  }

  // This block's db: the rows in a fixed order.
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) total += db_acc[r];
  if constexpr (FUSED)
    db_out[fcol] = unit < h ? total : 0.0f;
  else if (unit < h)
    db_out[col] = total;
}

template <typename T, int R, int W, bool MASKED>
__global__ void __launch_bounds__(8 * W, 1)
lstm_bwd_rec_kernel(const BwdArgs<T> a, T* __restrict__ da_out, float* __restrict__ db_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * R, g = MASKED ? 4 * a.h : 4 * W;
  bwd_recurrence<T, R, W, false, MASKED>(a, smem, row0, da_out + (size_t)row0 * a.steps * g, g,
                                         db_part + (size_t)blockIdx.x * g, nullptr, 0, [] {});
}

// ---- fp32: dx and dW on the CUDA cores, in full fp32 ----

constexpr int DX_ROWS = 32;  // rows of the (B*T) axis per dx tile

template <int W>
constexpr int dx_smem_bytes() { return (int)sizeof(float) * (4 * W * W + DX_ROWS * 4 * W); }

template <int W>
__global__ void __launch_bounds__(256)
lstm_bwd_dx_kernel(const float* __restrict__ da, const float* __restrict__ w_ih,
                   float* __restrict__ dx, long long n_rows) {
  constexpr int D = W, G = 4 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);  // [G][D], torch layout
  float* s_a = s_w + G * D;                     // [DX_ROWS][G]
  const int tid = threadIdx.x;
  for (int idx = tid; idx < G * D; idx += 256) s_w[idx] = w_ih[idx];
  constexpr int RG = 256 / D;  // row groups of PER rows: 4 of 8 at W = 64, 8 of 4 at W = 32
  constexpr int PER = DX_ROWS / RG;
  const int d = tid % D, rg = tid / D;

  for (long long tile = blockIdx.x; tile * DX_ROWS < n_rows; tile += gridDim.x) {
    const long long base = tile * DX_ROWS;
    __syncthreads();
    for (int idx = tid; idx < DX_ROWS * G; idx += 256) {
      const long long n = base + idx / G;
      s_a[idx] = n < n_rows ? da[n * G + idx % G] : 0.0f;
    }
    __syncthreads();
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
    for (int j = 0; j < G; j += 4) {
      const float w0 = s_w[(j + 0) * D + d], w1 = s_w[(j + 1) * D + d];
      const float w2 = s_w[(j + 2) * D + d], w3 = s_w[(j + 3) * D + d];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(s_a + (rg * PER + i) * G + j);
        acc[i] = fmaf(a.x, w0, acc[i]);
        acc[i] = fmaf(a.y, w1, acc[i]);
        acc[i] = fmaf(a.z, w2, acc[i]);
        acc[i] = fmaf(a.w, w3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const long long n = base + rg * PER + i;
      if (n < n_rows) dx[n * D + d] = acc[i];
    }
  }
}

constexpr int DW_ROWS = 32;   // rows of the (B*T) axis staged per dW step
constexpr int DW_COLS = 128;  // gate columns per dW block (blockIdx.y picks which of G / 128)
// The gate columns of one dW block: DW_COLS, or all G = 64 at W = 16.
template <int W> constexpr int dw_block_cols = 4 * W < DW_COLS ? 4 * W : DW_COLS;

// part[chunk][j][m] = sum over the chunk's rows n of da[n][j] * v[n][m],
// v = [x | h_{t-1}] (h_{t-1} = y of the previous row, zero at t = 0).  A
// block owns BC = 128 gate columns x all K terms, a thread 8 x (K / 16) of
// them (two groups of 4 columns and K / 64 groups of 4 terms, so that a
// warp's 16-byte reads are contiguous): 2 + K / 64 16-byte reads from
// shared memory feed 8 K / 16 products.  At W = 16 a block owns all BC = 64
// columns, a thread one group of 4 columns and one of 2 terms (CG = 1,
// V = 2).
template <int W>
__global__ void __launch_bounds__(256)
lstm_bwd_dw_kernel(const float* __restrict__ da, const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ part, long long n_rows, int steps, long long chunk_rows) {
  constexpr int D = W, H = W, G = 4 * W, K = 2 * W, BC = dw_block_cols<W>;
  constexpr int CG = BC / 64;                     // groups of 4 gate columns a thread, 64 apart
  constexpr int V = K >= 64 ? 4 : K / 16;         // consecutive terms a thread takes per group
  constexpr int VG = K >= 64 ? K / 64 : 1;        // groups of V terms a thread, 64 apart
  __shared__ __align__(16) float s_a[DW_ROWS * BC];
  __shared__ __align__(16) float s_v[DW_ROWS * K];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * BC;
  const int tj = tid / 16, tm = tid % 16;
  const long long begin = blockIdx.x * chunk_rows;
  const long long end = begin + chunk_rows < n_rows ? begin + chunk_rows : n_rows;
  float acc[4 * CG][V * VG];
#pragma unroll
  for (int a = 0; a < 4 * CG; ++a)
#pragma unroll
    for (int b = 0; b < V * VG; ++b) acc[a][b] = 0.0f;

  for (long long base = begin; base < end; base += DW_ROWS) {
    __syncthreads();
    // 16-byte loads; one row of 128 values is 32 of them.
    for (int idx = tid; idx < DW_ROWS * (BC / 4); idx += 256) {
      const int r = idx / (BC / 4), c4 = idx % (BC / 4);
      const long long n = base + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < end) v = reinterpret_cast<const float4*>(da + n * G + j0)[c4];
      reinterpret_cast<float4*>(s_a)[idx] = v;
    }
    for (int idx = tid; idx < DW_ROWS * (K / 4); idx += 256) {
      const int r = idx / (K / 4), c4 = idx % (K / 4);
      const long long n = base + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < end) {
        if (c4 < D / 4) v = reinterpret_cast<const float4*>(x + n * D)[c4];
        else if (n % steps != 0) v = reinterpret_cast<const float4*>(y + (n - 1) * H)[c4 - D / 4];
      }
      reinterpret_cast<float4*>(s_v)[idx] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int nn = 0; nn < DW_ROWS; ++nn) {
      float av[4 * CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(s_a + nn * BC + 64 * c + tj * 4);
        av[4 * c] = a.x; av[4 * c + 1] = a.y; av[4 * c + 2] = a.z; av[4 * c + 3] = a.w;
      }
      float vv[V * VG];
#pragma unroll
      for (int g = 0; g < VG; ++g) {
        if constexpr (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(s_v + nn * K + 64 * g + tm * 4);
          vv[4 * g] = v.x; vv[4 * g + 1] = v.y; vv[4 * g + 2] = v.z; vv[4 * g + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(s_v + nn * K + 64 * g + tm * 2);
          vv[2 * g] = v.x; vv[2 * g + 1] = v.y;
        }
      }
#pragma unroll
      for (int p = 0; p < 4 * CG; ++p)
#pragma unroll
        for (int q = 0; q < V * VG; ++q) acc[p][q] = fmaf(av[p], vv[q], acc[p][q]);
    }
  }
  float* out = part + (size_t)blockIdx.x * G * K;
#pragma unroll
  for (int p = 0; p < 4 * CG; ++p)
#pragma unroll
    for (int q = 0; q < V * VG; ++q) {
      const int j = j0 + (p / 4) * 64 + tj * 4 + p % 4;
      const int m = (q / V) * 64 + tm * V + q % V;
      out[(size_t)j * K + m] = acc[p][q];
    }
}

// ---- bf16: dx and dW on the tensor cores (bf16 in, exact products, fp32 sums) ----

// Row stride of a staged da tile: rows fall in distinct banks.
template <int W> constexpr int da_pitch = 4 * W + 8;
constexpr int DXM_ROWS = 128;    // rows of the (B*T) axis per dx tile: 16 per warp
template <int W>
constexpr int dxm_smem_bytes() { return (int)sizeof(__nv_bfloat16) * (W + DXM_ROWS) * da_pitch<W>; }

// dx = da . W_ih as mma tiles: M = 16 rows of (B*T) per warp, N = the W
// inputs, K = the G gate columns.  da rows are A fragments as they lie;
// W_ih is staged transposed, [d][j], so that a B fragment's two k are adjacent.
template <int W>
__global__ void __launch_bounds__(256)
lstm_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ da, const float* __restrict__ w_ih,
                       __nv_bfloat16* __restrict__ dx, long long n_rows) {
  constexpr int D = W, G = 4 * W, DA_P = da_pitch<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][DA_P]
  __nv_bfloat16* s_a = s_wt + D * DA_P;                          // [DXM_ROWS][DA_P]
  const int tid = threadIdx.x, warp = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
  for (int idx = tid; idx < G * D; idx += 256)
    s_wt[(idx % D) * DA_P + idx / D] = __float2bfloat16(w_ih[idx]);

  for (long long tile = blockIdx.x; tile * DXM_ROWS < n_rows; tile += gridDim.x) {
    const long long base = tile * DXM_ROWS;
    __syncthreads();
    for (int idx = tid; idx < DXM_ROWS * (G / 8); idx += 256) {
      const int r = idx / (G / 8), c8 = idx % (G / 8);
      const long long n = base + r;
      const uint4 v = n < n_rows ? reinterpret_cast<const uint4*>(da + n * G)[c8] : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(s_a + r * DA_P + c8 * 8) = v;
    }
    __syncthreads();
    float c[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = 0.0f;
    const __nv_bfloat16* a_lo = s_a + (warp * 16 + g8) * DA_P + 2 * t4;
#pragma unroll 4
    for (int kt = 0; kt < G / 16; ++kt) {
      const uint32_t a[4] = {ld32(a_lo + kt * 16), ld32(a_lo + 8 * DA_P + kt * 16),
                             ld32(a_lo + kt * 16 + 8), ld32(a_lo + 8 * DA_P + kt * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const __nv_bfloat16* b = s_wt + (nt * 8 + g8) * DA_P + kt * 16 + 2 * t4;
        mma_bf16(c[nt], a, ld32(b), ld32(b + 8));
      }
    }
    const long long n_lo = base + warp * 16 + g8;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int d = nt * 8 + 2 * t4;
      if (n_lo < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(dx + n_lo * D + d) = __floats2bfloat162_rn(c[nt][0], c[nt][1]);
      if (n_lo + 8 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(dx + (n_lo + 8) * D + d) = __floats2bfloat162_rn(c[nt][2], c[nt][3]);
    }
  }
}

constexpr int DWM_ROWS = 64;  // rows of the (B*T) axis per staged dW tile: four k steps of 16

// part[chunk][j][m] as mma tiles: M = the G gate columns j (G / 8 per warp:
// MT = G / 128 tiles of 16; at W = 16 one tile of 16 for each of the first
// four warps, and the other four only stage), N = W terms m (blockIdx.y =
// 0: x, 1: h_{t-1}), K = the chunk's rows.  Both operands lie row-major in
// the rows, so both fragments come transposed through ldmatrix.  The chunk's sum runs in the
// tensor cores' order, fixed for a given shape: two runs still give the
// same bits.
template <int W>
__global__ void __launch_bounds__(256)
lstm_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ da, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                       long long n_rows, int steps, long long chunk_rows) {
  constexpr int D = W, H = W, G = 4 * W, K = 2 * W, MT = G >= 128 ? G / 128 : 1, DA_P = da_pitch<W>;
  constexpr int MMA_WARPS = G / (16 * MT);  // warps that own gate columns: 8, or 4 at W = 16
  constexpr int V_P = D + 8;  // row stride of the staged x or h_{t-1} tile
  __shared__ __align__(16) __nv_bfloat16 s_a[DWM_ROWS * DA_P];
  __shared__ __align__(16) __nv_bfloat16 s_v[DWM_ROWS * V_P];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const bool h_half = blockIdx.y == 1;
  const bool owns = MMA_WARPS == 8 || warp < MMA_WARPS;  // a whole warp either way
  const long long begin = blockIdx.x * chunk_rows;
  const long long end = begin + chunk_rows < n_rows ? begin + chunk_rows : n_rows;
  float c[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.0f;
  const int blk = lane >> 3, blk_row = lane & 7;  // ldmatrix: this lane's block and row in it

  for (long long base = begin; base < end; base += DWM_ROWS) {
    __syncthreads();
    for (int idx = tid; idx < DWM_ROWS * (G / 8); idx += 256) {
      const int r = idx / (G / 8), c8 = idx % (G / 8);
      const long long n = base + r;
      const uint4 v = n < end ? reinterpret_cast<const uint4*>(da + n * G)[c8] : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(s_a + r * DA_P + c8 * 8) = v;
    }
    for (int idx = tid; idx < DWM_ROWS * (D / 8); idx += 256) {
      const int r = idx / (D / 8), c8 = idx % (D / 8);
      const long long n = base + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < end) {
        if (!h_half) v = reinterpret_cast<const uint4*>(x + n * D)[c8];
        else if (n % steps != 0) v = reinterpret_cast<const uint4*>(y + (n - 1) * H)[c8];
      }
      *reinterpret_cast<uint4*>(s_v + r * V_P + c8 * 8) = v;
    }
    __syncthreads();
    if (!owns) continue;
#pragma unroll
    for (int ks = 0; ks < DWM_ROWS / 16; ++ks) {
      // A[j][n] = da[n][j]: blocks (n 0-7, j 0-7), (n 0-7, j 8-15), (n 8-15, j 0-7), (n 8-15, j 8-15).
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(a[mt], s_a + (ks * 16 + (blk >> 1) * 8 + blk_row) * DA_P +
                                     warp * 16 * MT + mt * 16 + (blk & 1) * 8);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        // B[n][m] = v[n][m]: blocks (n 0-7, m 0-7), (n 8-15, m 0-7), (n 0-7, m 8-15), (n 8-15, m 8-15).
        uint32_t b[4];
        ldmatrix_x4_trans(b, s_v + (ks * 16 + (blk & 1) * 8 + blk_row) * V_P + np * 16 + (blk >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(c[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(c[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  if (!owns) return;
  float* out = part + (size_t)blockIdx.x * G * K + (h_half ? D : 0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int j = warp * 16 * MT + mt * 16 + g8, m = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(out + (size_t)j * K + m) = make_float2(c[mt][nt][0], c[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(j + 8) * K + m) = make_float2(c[mt][nt][2], c[mt][nt][3]);
    }
}

// dW_ih / dW_hh = the sum of the chunk partials; db = the sum of the
// recurrent blocks' partials.  Fixed order, one thread per output.
template <int W>
__global__ void __launch_bounds__(256)
lstm_bwd_sum_kernel(const float* __restrict__ part, int n_chunks,
                    const float* __restrict__ db_part, int n_blocks,
                    float* __restrict__ dw_ih, float* __restrict__ dw_hh, float* __restrict__ db) {
  constexpr int D = W, H = W, G = 4 * W, K = 2 * W;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx < G * K) {
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * G * K + idx];
    const int j = idx / K, m = idx % K;
    if (m < D) dw_ih[j * D + m] = s;
    else dw_hh[j * H + (m - D)] = s;
  }
  if (idx < G) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += db_part[(size_t)b * G + idx];
    db[idx] = s;
  }
}

// ---- W = 32 and 16: the fused path, one cooperative launch ----
//
// W = 16 is its own design, not W = 32's at half the width.  Its block has
// 128 threads, 4 warps: the recurrence's 2 consumer and 2 producer warps (8
// lanes' dh split, "4 of 64", above), then all 4 for the products and the
// sum.  At the dry run's B = 4, T = 32 (4 blocks of one row, 32 (row, step)
// pairs a block) the products are 64 x 32 x 32 multiply-adds of dW and 32 x
// 16 x 64 of dx a block: a few hundred cycles, nothing beside the latency of
// 32 dependent steps of the recurrence and one grid barrier, which bound
// the call.  What differs from W = 32, each for that latency or the block's
// size:
// - bf16 dx: a warp owns one column tile of 8 inputs (D / 8 = 2 tiles for 4
//   warps) and every other row tile of 16 (pairs, padded to whole tiles as
//   at 32: fused_rows); W_ih^T's B fragments for its tile sit in 8 registers
//   a lane, loaded (rounded to bf16) straight from the fp32 weights after
//   the recurrence, so no W_ih^T is staged in shared memory (W = 32 stages
//   it, [D][DAP], from the producers once they are done);
// - bf16 dW: the W = 32 mapping at its smallest, a warp 16 gate columns
//   (G = 64 = 4 warps x 16) by all K = 32 terms over the block's rows;
// - fp32 dx: thread (input d, row group rg), 8 row groups of 4 rows at a
//   time (8 at W = 32: at T = 32 and one row a block 4 rows fill every row
//   group), the G terms in lstm_bwd_dx_kernel's order;
// - fp32 dW: 4 x 4 outputs a thread (8 x 4 at W = 32): (G / 4) (K / 4) =
//   128 threads, one 16-byte read of da and one of x_t | h_{t-1} feed 16
//   products a row;
// - the sum: NOUT = G K + G = 2112 outputs over the blocks' partials.  A
//   block's slice is whole quads of outputs (16-byte loads); its threads
//   split into NG groups of a power of two, as many as the slice leaves
//   threads for, each taking every NG-th block in order; then the groups'
//   sums in group order.  At 4 blocks a thread takes one quad of 4 partials
//   (W = 32's four groups of 64 threads would leave a few blocks' 8320
//   outputs to 64 threads each); at 128 blocks 16 groups of 8 blocks.
//   Fixed for a given grid: two runs give the same bits.

// Row pitch of the block's da and of its x_t | h_{t-1} rows in shared
// memory: bf16 rows are read by ldmatrix and as mma fragments, and the pad
// puts 8 consecutive rows in distinct banks; fp32 rows are read as float4.
template <typename T, int W> constexpr int FDA_P = is_bf16<T> ? 4 * W + 8 : 4 * W + 4;
template <typename T, int W> constexpr int FV_P = is_bf16<T> ? 2 * W + 8 : 2 * W + 4;
__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
// The block's (row, step) pairs, padded to whole 16-row mma tiles.
__host__ __device__ constexpr int fused_rows(int rows, int steps) { return (rows * steps + 15) / 16 * 16; }
// bf16 W = 32 stages W_ih^T for dx; W = 16 holds its fragments in registers.
template <typename T, int W> constexpr bool FUSED_WT = is_bf16<T> && W == 32;

template <typename T, int R, int W>
constexpr int fused_smem_bytes(int steps) {
  return align16(rec_smem_bytes<T, R, W>()) +
         (int)sizeof(T) * (fused_rows(R, steps) * (FDA_P<T, W> + FV_P<T, W>) +
                           (FUSED_WT<T, W> ? W * FDA_P<T, W> : 0));
}

// Masked (MASKED: any 1 <= D, H <= W but D = H = W, at run time): the
// recurrence at runtime widths (bwd_recurrence's MASKED), and everything
// after it in the capacity's layout: the block's da at G = 4 W columns
// (gate m at m W + j, zeros at the padded units j >= H), x_t | h_{t-1} with
// x at columns < D and h_{t-1} at W + j < W + H, zeros up to W each, W_ih
// read with zeros past the real widths (load_wm).  So dx, the dW and db
// partials and the sum are the square call's arithmetic on zero-padded
// operands, each padded term an exact +0, and at W = 32 a masked call gives
// that call's bits (bf16 dx too: packed at 4 H columns, its k-tiles would
// straddle two gates wherever 16 does not divide H).  At W = 16 the square
// instantiation's recurrence rounds a few gates in the last bit unlike
// every other instantiation of bwd_recurrence (its own four-launch one
// included: measured, not designed), so there a masked call gives the
// masked four launches' da, and their db bits where both sum the blocks in
// order.  Only the stores map
// back: dx at k < D (row stride D), dW_ih / dW_hh / db at the real rows m H
// + j and columns.  Shared memory, and so the occupancy the plan reads
// (awm_lstm_bwd_fused_slots' masked argument), are the capacity's.
//
// part: (gridDim.x, G K + G) fp32, block b's dW partial [j][m] (m < W: x,
// else h_{t-1}) then its db, at the capacity.  The grid must be resident at
// once (cudaLaunchCooperativeKernel refuses it otherwise; the plan reads the
// blocks an SM holds, awm_lstm_bwd_fused_slots, before it sends a call here).
template <typename T, int R, int W, bool MASKED>
__global__ void __launch_bounds__(8 * W, 1)
lstm_bwd_fused_kernel(const BwdArgs<T> a, T* __restrict__ dx, float* __restrict__ part,
                      float* __restrict__ dw_ih, float* __restrict__ dw_hh, float* __restrict__ db) {
  static_assert(W == 32 || W == 16, "the fused backward is instantiated for W = 32 and 16");
  constexpr int D = W, H = W, G = 4 * W, K = 2 * W, THREADS = 8 * W, NOUT = G * K + G;
  constexpr int DAP = FDA_P<T, W>, VP = FV_P<T, W>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, row0 = blockIdx.x * R, steps = a.steps;
  const int d_real = MASKED ? a.d : D, h_real = MASKED ? a.h : H;  // the call's widths
  // W_ih at capacity row j (gate j / W, unit j % W) and column k: zero past the real widths
  auto w_ih_at = [&](int j, int k) -> float {
    if constexpr (MASKED)
      return load_wm(a.w_ih, j % W < h_real, (size_t)((j / W) * h_real + j % W), k, d_real);
    else
      return a.w_ih[(size_t)j * D + k];
  };
  // bf16 dx of flattened row n (of the call) at inputs k, k + 1 (k even), from fp32 sums
  auto store_dx2 = [&](long long n, int k, float lo, float hi) {
    if constexpr (MASKED) {
      if (k < d_real) store_f(dx + n * d_real + k, lo);
      if (k + 1 < d_real) store_f(dx + n * d_real + k + 1, hi);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dx + n * D + k) = __floats2bfloat162_rn(lo, hi);
    }
  };
  const int nr = R * steps, nrp = fused_rows(R, steps);
  T* s_da = reinterpret_cast<T*>(smem + align16(rec_smem_bytes<T, R, W>()));  // [nrp][DAP]
  T* s_v = s_da + nrp * DAP;                                                   // [nrp][VP]
  T* s_wt = s_v + nrp * VP;  // bf16 W = 32: [D][DAP], W_ih transposed, for dx's B fragments
  float* my_part = part + (size_t)blockIdx.x * NOUT;

  // 1. The recurrence.  Its producers, done with their last chunk while the
  // consumers still run, zero the padding rows (and at W = 32 stage W_ih^T).
  bwd_recurrence<T, R, W, true, MASKED>(a, smem, row0, s_da, DAP, my_part + G * K, s_v, VP, [&] {
    for (int i = tid - G; i < (nrp - nr) * DAP; i += G) store_f(s_da + nr * DAP + i, 0.0f);
    for (int i = tid - G; i < (nrp - nr) * VP; i += G) store_f(s_v + nr * VP + i, 0.0f);
    if constexpr (FUSED_WT<T, W>)
      for (int idx = tid - G; idx < G * D; idx += G)
        s_wt[(idx % D) * DAP + idx / D] = __float2bfloat16(w_ih_at(idx / D, idx % D));
  });
  const long long n_base = (long long)row0 * steps, n_end = (long long)a.batch * steps;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  // bf16 W = 16: this warp's column tile of dx and W_ih^T's B fragments for
  // it, b[kt] = (W_ih[16 kt + 2 t4 (+1)][d], W_ih[16 kt + 8 + 2 t4 (+1)][d]),
  // d = 8 nt + g8: loaded while the other warps reach the barrier.
  [[maybe_unused]] uint32_t bw[W == 16 ? G / 16 : 1][2];
  if constexpr (is_bf16<T> && W == 16) {
    const int k = (warp & 1) * 8 + g8;
#pragma unroll
    for (int kt = 0; kt < G / 16; ++kt) {
      const int j = kt * 16 + 2 * t4;
      bw[kt][0] = pack_bf16(w_ih_at(j, k), w_ih_at(j + 1, k));
      bw[kt][1] = pack_bf16(w_ih_at(j + 8, k), w_ih_at(j + 9, k));
    }
  }
  __syncthreads();

  if constexpr (is_bf16<T>) {
    if constexpr (W == 16) {
      // 2. dx = da . W_ih of the block's rows: warp w the 8 inputs of column
      // tile w % 2 for row tiles w / 2, w / 2 + 2, ...; K = the G gate columns.
      const int nt = warp & 1;
      for (int mt = warp >> 1; mt < nrp / 16; mt += 2) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const T* a_lo = s_da + (mt * 16 + g8) * DAP + 2 * t4;
#pragma unroll
        for (int kt = 0; kt < G / 16; ++kt) {
          const uint32_t af[4] = {ld32(a_lo + kt * 16), ld32(a_lo + 8 * DAP + kt * 16),
                                  ld32(a_lo + kt * 16 + 8), ld32(a_lo + 8 * DAP + kt * 16 + 8)};
          mma_bf16(c, af, bw[kt][0], bw[kt][1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = mt * 16 + g8 + 8 * half;
          if (n < nr && n_base + n < n_end) store_dx2(n_base + n, nt * 8 + 2 * t4, c[2 * half], c[2 * half + 1]);
        }
      }
    } else {
      // 2. dx = da . W_ih of the block's rows: tiles of 16 rows x 8 inputs, K =
      // the G gate columns (lstm_bwd_dx_mma_kernel's products).
      for (int job = warp; job < (nrp / 16) * (D / 8); job += THREADS / 32) {
        const int mt = job / (D / 8), nt = job % (D / 8);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const T* a_lo = s_da + (mt * 16 + g8) * DAP + 2 * t4;
        const T* b_lo = s_wt + (nt * 8 + g8) * DAP + 2 * t4;
#pragma unroll
        for (int kt = 0; kt < G / 16; ++kt) {
          const uint32_t af[4] = {ld32(a_lo + kt * 16), ld32(a_lo + 8 * DAP + kt * 16),
                                  ld32(a_lo + kt * 16 + 8), ld32(a_lo + 8 * DAP + kt * 16 + 8)};
          mma_bf16(c, af, ld32(b_lo + kt * 16), ld32(b_lo + kt * 16 + 8));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = mt * 16 + g8 + 8 * half;
          if (n < nr && n_base + n < n_end) store_dx2(n_base + n, nt * 8 + 2 * t4, c[2 * half], c[2 * half + 1]);
        }
      }
    }
    // 3. The block's dW partial: M = the G gate columns (16 a warp), N = the K
    // terms of x_t | h_{t-1}, K = the block's rows; both operands transposed
    // through ldmatrix (lstm_bwd_dw_mma_kernel's products).
    static_assert(G == 16 * (THREADS / 32), "a warp owns 16 gate columns");
    float c[K / 8][4];
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = 0.0f;
    const int blk = lane >> 3, blk_row = lane & 7;  // ldmatrix: this lane's block and row in it
    for (int ks = 0; ks < nrp / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, s_da + (ks * 16 + (blk >> 1) * 8 + blk_row) * DAP + warp * 16 + (blk & 1) * 8);
#pragma unroll
      for (int np = 0; np < K / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, s_v + (ks * 16 + (blk & 1) * 8 + blk_row) * VP + np * 16 + (blk >> 1) * 8);
        mma_bf16(c[2 * np], af, b[0], b[1]);
        mma_bf16(c[2 * np + 1], af, b[2], b[3]);
      }
    }
    const int j = warp * 16 + g8;
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      const int m = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(my_part + (size_t)j * K + m) = make_float2(c[nt][0], c[nt][1]);
      *reinterpret_cast<float2*>(my_part + (size_t)(j + 8) * K + m) = make_float2(c[nt][2], c[nt][3]);
    }
  } else {
    // 2. dx, fp32: thread (input d, row group rg) over rows rg, rg + RG, ...,
    // PR rows at a time, the G terms in order (lstm_bwd_dx_kernel's order),
    // W_ih from L1.
    constexpr int RG = THREADS / D, PR = W == 16 ? 4 : 8;
    const int k = tid % D, rg = tid / D;
    for (int n0 = rg; n0 < nr; n0 += PR * RG) {
      float acc[PR];
      const T* rows[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        acc[i] = 0.0f;
        rows[i] = s_da + min(n0 + RG * i, nr - 1) * DAP;  // a row past nr is read, never stored
      }
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float wv = w_ih_at(j, k);
#pragma unroll
        for (int i = 0; i < PR; ++i) acc[i] = fmaf(rows[i][j], wv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int n = n0 + RG * i;
        if (n < nr && n_base + n < n_end && k < d_real) dx[(n_base + n) * d_real + k] = acc[i];
      }
    }
    // 3. The block's dW partial, fp32: JT gate columns x 4 terms a thread
    // (8 at W = 32, 4 at W = 16), the rows in order.
    constexpr int JT = W == 16 ? 4 : 8;
    static_assert((G / JT) * (K / 4) == THREADS, "one thread per JT x 4 outputs");
    const int j0 = (tid / (K / 4)) * JT, m0 = (tid % (K / 4)) * 4;
    float acc[JT][4];
#pragma unroll
    for (int i = 0; i < JT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int n = 0; n < nr; ++n) {
      float av[JT];
#pragma unroll
      for (int i4 = 0; i4 < JT / 4; ++i4) {
        const float4 a4 = *reinterpret_cast<const float4*>(s_da + n * DAP + j0 + 4 * i4);
        av[4 * i4] = a4.x; av[4 * i4 + 1] = a4.y; av[4 * i4 + 2] = a4.z; av[4 * i4 + 3] = a4.w;
      }
      const float4 v = *reinterpret_cast<const float4*>(s_v + n * VP + m0);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < JT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], vv[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < JT; ++i)
      *reinterpret_cast<float4*>(my_part + (size_t)(j0 + i) * K + m0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  // 4. Every block's partial is written: each block sums a fixed slice of
  // the outputs over the partials in a fixed order.
  cg::this_grid().sync();
  float* s_red = reinterpret_cast<float*>(smem);  // the recurrence's region, free now
  const int nblk = gridDim.x;
  // Output o of the sum (capacity row j = o / K, term m; db: row o - G K):
  // dW_ih, dW_hh or db at the real row (j / W) h + j % W; a padded row or
  // term is not stored.
  auto put = [&](int o, float total) {
    const int j = o < G * K ? o / K : o - G * K, m = o < G * K ? o % K : -1;
    const int u = j % W, row = MASKED ? (j / W) * h_real + u : j;
    if (MASKED && u >= h_real) return;
    if (m < 0) db[row] = total;
    else if (m < D) { if (!MASKED || m < d_real) dw_ih[row * d_real + m] = total; }
    else if (!MASKED || m - D < h_real) dw_hh[row * h_real + (m - D)] = total;
  };
  if constexpr (W == 16) {
    // Whole quads of outputs a block, NG groups of SPAN threads (NG a power
    // of two, NG x the slice's quads <= THREADS): group g sums blocks g, g +
    // NG, ... in order, then group 0 adds the groups' sums in group order.
    constexpr int NQ4 = NOUT / 4;
    static_assert(NOUT % 4 == 0, "whole quads");
    const int per = (NQ4 + nblk - 1) / nblk, q0 = blockIdx.x * per, q1 = min(q0 + per, NQ4);
    int ng = 1;
    while (ng < 32 && 2 * ng * per <= THREADS) ng *= 2;
    const int span = THREADS / ng, grp = tid / span, ql = tid % span;
    float4* s_red4 = reinterpret_cast<float4*>(s_red);
    const float4* part4 = reinterpret_cast<const float4*>(part);
    for (int base = q0; base < q1; base += span) {
      const int q = base + ql;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < q1) {
#pragma unroll 4
        for (int b = grp; b < nblk; b += ng) {
          const float4 v = __ldcg(part4 + (size_t)b * NQ4 + q);
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
      }
      if (ng > 1) {
        s_red4[tid] = sum;
        __syncthreads();
        if (grp == 0)
          for (int g = 1; g < ng; ++g) {
            const float4 v = s_red4[g * span + ql];
            sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
          }
        __syncthreads();
      }
      if (grp == 0 && q < q1) {
        put(4 * q, sum.x);
        put(4 * q + 1, sum.y);
        put(4 * q + 2, sum.z);
        put(4 * q + 3, sum.w);
      }
    }
  } else {
    // Four groups of 64 threads taking every fourth block in order, then the
    // four sums in a fixed order.
    static_assert(THREADS == 256, "four groups of 64 threads");
    const int per = (NOUT + nblk - 1) / nblk;
    const int o0 = blockIdx.x * per, o1 = min(o0 + per, NOUT);
    const int grp = tid / 64, ol = tid % 64;
    for (int base = o0; base < o1; base += 64) {
      const int o = base + ol;
      float sum = 0.0f;
      if (o < o1) {
#pragma unroll 8
        for (int b = grp; b < nblk; b += 4) sum += __ldcg(part + (size_t)b * NOUT + o);
      }
      s_red[tid] = sum;
      __syncthreads();
      if (grp == 0 && o < o1) put(o, (s_red[ol] + s_red[64 + ol]) + (s_red[128 + ol] + s_red[192 + ol]));
      __syncthreads();
    }
  }
}

// The fused instantiation's shared-memory opt-in, once per device: its need
// grows with T, so the card's limit (a T past it fails at the launch, and
// its occupancy reads 0 blocks).
template <typename T, int R, int W, bool MASKED>
cudaError_t fused_smem_attr() {
  static SmemOnce once;
  return once.set(lstm_bwd_fused_kernel<T, R, W, MASKED>, 0);
}

template <typename T, int R, int W, bool MASKED>
cudaError_t launch_fused(BwdArgs<T> a, T* dx, float* part, float* dw_ih, float* dw_hh, float* db,
                         cudaStream_t stream) {
  cudaError_t err = fused_smem_attr<T, R, W, MASKED>();
  if (err != cudaSuccess) return err;
  void* params[] = {&a, &dx, &part, &dw_ih, &dw_hh, &db};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_fused_kernel<T, R, W, MASKED>,
                                    dim3((a.batch + R - 1) / R), dim3(8 * W), params,
                                    fused_smem_bytes<T, R, W>(a.steps), stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// Blocks of the fused instantiation an SM holds at once at T = steps
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the call's dynamic
// shared memory), or -cudaError.
template <typename T, int R, int W, bool MASKED>
int fused_slots_rows(int steps) {
  cudaError_t err = fused_smem_attr<T, R, W, MASKED>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lstm_bwd_fused_kernel<T, R, W, MASKED>, 8 * W,
                                                      (size_t)fused_smem_bytes<T, R, W>(steps));
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int W, bool MASKED>
int fused_slots(int rows, int steps) {
  if (steps < 1) return -(int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return fused_slots_rows<T, 1, W, MASKED>(steps);
    case 2: return fused_slots_rows<T, 2, W, MASKED>(steps);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename T, int R, int W>
cudaError_t launch_rec(BwdArgs<T> a, T* da, float* db_part, cudaStream_t stream) {
  constexpr int smem = rec_smem_bytes<T, R, W>();
  static SmemOnce once, once_masked;
  const bool square = a.d == W && a.h == W;
  auto kernel = square ? lstm_bwd_rec_kernel<T, R, W, false> : lstm_bwd_rec_kernel<T, R, W, true>;
  cudaError_t err = (square ? once : once_masked).set(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.batch + R - 1) / R, 8 * W, smem, stream>>>(a, da, db_part);
  return cudaGetLastError();
}


// ---- Widths above 64: the gate pass, then the recurrence on a thread-block cluster ----
//
// The forward's cluster (lstm_fwd_cluster.cu) transposed, with
// everything that does not depend on the carried (dh, dc) taken off the
// recurrence, in windows of time (the plan's: a window's records and da
// stay within a scratch budget whatever B T is; lstm_wide.cu's windows),
// the last window first, (dh, dc) and each row's db carried between them:
// - the gate pass (lstm_any.cuh's gate_pass), over the whole card before
//   the window's recurrence: the gates of every (row, step) from x_t and
//   h_{t-1} = y_{t-1} (a product of (B tc) x (D + H) by (D + H) x 4H), their
//   activations and, with c_{t-1} and dy, each step's local derivatives: a
//   record of CREC floats a (row, step, unit) in a (B, tc, H, CREC) fp32
//   scratch (factor_i, factor_f, factor_g, factor_o: what turns the carried
//   gradient into da; o (1 - tanh^2 c_t); f; dy; 0).  bf16: the forward's
//   products on the tensor cores in the forward's order (the bias, x's
//   k-tiles, h's), so the gates are the forward's bit for bit; fp32: the
//   CUDA cores, the bias, then x's terms and h's in order (the forward's
//   fp32 sums run in another order: C stays within KERNEL_TOL of plain);
// - the recurrence (lstm_bwd_cluster_kernel): K = ceil(H / 32) CTAs own R
//   batch rows (R = 1, 2, 4 or 8), CTA r hidden units [32 r, 32 r + 32).
//   One producer warp brings each chunk's records (32 (step, row) pairs, a
//   contiguous 1 KB of the CTA's units each) into a two-buffer ring by the
//   TMA; 256 consumer threads, 8 lanes a unit, carry (dh, dc) of the R rows:
//   each step they form da of the CTA's 128 gate columns from the records
//   (5 flops a value), send it in row bursts to every CTA (a warp stages its
//   4 units' 16 values of a row, then 16-byte st.async stores counted on the
//   receiving CTA's mbarrier for the step, lstm_fwd.cu's exchange), wait on
//   their own mbarrier for all K slices, and form dh_{t-1} of their own
//   units from W_hh's columns for those units (4 HW rows x 32 columns in
//   registers, HW = 128 or 256: the forward's byte count), each unit's 4 HW
//   terms split over its 8 lanes (the same weights for every row) and summed
//   by three butterfly exchanges, the same sum in all 8 lanes.  da is
//   double-buffered, one wait a step;
// - da goes to the window's (B, tc, 4H) scratch; lstm_any.cuh's dx and dW
//   take the window (the dW partials added across windows in the order they
//   run), and after the last window each cluster's db goes to its row of
//   the partials and the ordered sum finishes the call.  No atomics: two
//   calls give the same bits, and a call of one window those of one pass
//   over all T.
// (CU, CROWS, CLANES, ...: lstm_common.cuh)
constexpr int CPAIRS = 32;            // (step, row) pairs of a chunk of the ring: pair n = s R + r
constexpr int CBUF = 2;               // buffers of the ring
constexpr int CCONS = CU * CLANES;    // consumer threads
constexpr int CTHREADS = CCONS + 32;  // and the producer warp
template <int R> constexpr int CSTEPS = CPAIRS / R;


// da in shared memory, [2][rows][pitch] of T: fp32 the R rows of 4 HW
// (read as quads); bf16 the B operand of the dh product, 8 rows (rows from R
// on stay zero) of 4 HW + 8 (8 rows' fragments in distinct banks).
template <typename T, int R> constexpr int cda_rows = is_bf16<T> ? 8 : R;
template <typename T, int HW> constexpr int cda_pitch = is_bf16<T> ? 4 * HW + 8 : 4 * HW;

template <typename T, int R, int HW>
constexpr size_t bwd_cluster_smem_bytes() {
  return 64 + sizeof(float) * (size_t)CBUF * CPAIRS * CU * CREC + sizeof(T) * (size_t)2 * cda_rows<T, R> * cda_pitch<T, HW> +
         sizeof(T) * (size_t)(CCONS / 32) * R * 16 + (is_bf16<T> ? sizeof(float) * 2 * 8 * CU * 4 : 0);
}

// A window of the cluster recurrence: steps t0 .. t0 + tc - 1, and the state
// carried to the window before it, (B, h) fp32 dh and dc and each (row,
// gate column)'s db so far (B, 4h).
struct ClusterWin {
  int t0, tc;
  float* dh_state;
  float* dc_state;
  float* db_rows;
};

// bf16 at HW = 128 and up to four rows: two CTAs an SM (the plan's slots
// count on them), so at most 113 registers a thread.
template <typename T, int R, int HW>
__global__ void __launch_bounds__(CTHREADS, (is_bf16<T> && HW == 128 && R <= 4) ? 2 : 1)
lstm_bwd_cluster_kernel(const BwdArgs<T> a, const float* __restrict__ rec, T* __restrict__ da_out,
                        float* __restrict__ db_part, const ClusterWin cw) {
  static_assert(R == 1 || R == 2 || R == 4 || R == 8, "rows a cluster: 1, 2, 4 or 8");
  constexpr int S = CSTEPS<R>, NQ = HW / 8, NBR = 16 * (int)sizeof(T) / 16;  // NBR: bursts a row
  constexpr int DAR = cda_rows<T, R>, DAP = cda_pitch<T, HW>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);  // [2]: step i's da of every CTA is in s_da[i & 1]
  uint64_t* full = mbar + 2;                           // [CBUF]: chunk c's records are in ring buffer c % CBUF
  float* s_ring = reinterpret_cast<float*>(smem + 64); // [CBUF][CPAIRS][CU][CREC]
  T* s_da = reinterpret_cast<T*>(s_ring + CBUF * CPAIRS * CU * CREC);  // [2][DAR][DAP]: unit u, gate m at 4 u + m
  T* s_stage = s_da + 2 * DAR * DAP;                   // [CCONS / 32][R][16]: a warp's 4 units x 4 gates a row
  float* s_part = reinterpret_cast<float*>(s_stage + (CCONS / 32) * R * 16);  // bf16: [2][8][CU][4] dh partials
  const int batch = a.batch, steps = cw.tc, h = a.h;  // steps: the window's; rec and da_out are the window's
  const bool first = cw.t0 + cw.tc == a.steps;        // the call's last steps: (dh, dc, db) start at zero
  const uint32_t rank = cluster_rank(), n_cta = (h + CU - 1) / CU;
  const int u0 = rank * CU, cluster = blockIdx.x / n_cta, row0 = cluster * R;
  const int nu = h - u0 < CU ? h - u0 : CU, nr = batch - row0 < R ? batch - row0 : R;  // real units, rows
  const int n_chunks = (steps + S - 1) / S;
  // Step i of the recurrence is local step t = steps - 1 - i; chunk c holds i = c S .. c S + S - 1.

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + CBUF; ++i) mbar_init(mbar + i, 1);  // one arrival a phase and its bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * DAR * DAP; i += CTHREADS) store_f(s_da + i, 0.0f);  // units no CTA owns stay 0
  // Rows past the batch and units past H are never copied: their records stay 0, so their da is 0.
  for (int i = threadIdx.x; i < CBUF * CPAIRS * CU * CREC; i += CTHREADS) s_ring[i] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the zeros before the TMA's copies
  __syncthreads();
  cluster_sync_all();

  if (threadIdx.x >= CCONS) {
    // ---- the producer warp: each chunk's records by the TMA, one copy a (step, row) ----
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % CBUF, n = steps - c * S < S ? steps - c * S : S;
      if (c >= CBUF) bar_sync(BAR_EMPTY + buf, CTHREADS);  // the consumers are done with chunk c - CBUF
      if ((threadIdx.x & 31) == 0) {
        const uint32_t bytes = (uint32_t)(nu * CREC * sizeof(float));
        mbar_expect(full + buf, bytes * n * nr);
        for (int s = 0; s < n; ++s)
          for (int r = 0; r < nr; ++r) {
            const int t = steps - 1 - (c * S + s);
            bulk_copy(s_ring + ((size_t)(buf * CPAIRS + s * R + r) * CU) * CREC,
                      rec + (((size_t)(row0 + r) * steps + t) * h + u0) * CREC, bytes, full + buf);
          }
      }
    }
  } else {
    // ---- consumers: the (dh, dc) carry, da exchanged through the cluster in row bursts ----
    // Thread tc is lane l of unit tc / 8 (gate l % 4 of it, lanes l and l + 4 alike).
    // fp32: it takes quads 8 q + l (q < HW / 8) of the 4 HW da values (unit 8 q + l's four
    // gates), w[q][e] = W_hh[gate e of unit 8 q + l][its unit], for every row.  bf16: dh of
    // the CTA's units is one mma product, M = the 32 units (two tiles), N = the rows, K =
    // the 4 HW da values: warp w takes tile w % 2 and quarter w / 2 of K, W_hh^T's fragments
    // in registers; the quarters' partials meet in shared memory, one barrier a step.
    const int tc = threadIdx.x, lane = tc & 31, warp = tc >> 5;
    const int unit = tc / CLANES, l = tc % CLANES, gate = l & 3, gu = u0 + unit, uj = unit & 3;
    constexpr int KQ = HW / 16;  // bf16: k-tiles of a quarter
    float w[is_bf16<T> ? 1 : NQ][4];
    uint32_t a_hh[is_bf16<T> ? KQ : 1][4];
    if constexpr (is_bf16<T>) {
      const int g8 = lane >> 2, t4 = lane & 3, mt = warp & 1, kq0 = (warp >> 1) * KQ;
      // A[unit][j] = W_hh[gate j % 4 of unit j / 4][unit], rounded to bf16, zero past H
      auto wv = [&](int j, int u) {
        return load_wm(a.w_hh, j / 4 < h, (size_t)((j % 4) * h + j / 4), u0 + u, h);
      };
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const int j = (kq0 + kk) * 16 + 2 * t4, u = mt * 16 + g8;
        a_hh[kk][0] = pack_bf16(wv(j, u), wv(j + 1, u));
        a_hh[kk][1] = pack_bf16(wv(j, u + 8), wv(j + 1, u + 8));
        a_hh[kk][2] = pack_bf16(wv(j + 8, u), wv(j + 9, u));
        a_hh[kk][3] = pack_bf16(wv(j + 8, u + 8), wv(j + 9, u + 8));
      }
    } else {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = 8 * q + l;
          w[q][e] = operand(load_wm(a.w_hh, uu < h, (size_t)(e * h + uu), gu, h), a.x);
        }
    }
    float dh[R], dc[R], db_acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = !first && r < nr && gu < h;
      const size_t at = (size_t)(row0 + r) * h + gu;
      dh[r] = ok ? cw.dh_state[at] : 0.0f;
      dc[r] = ok ? cw.dc_state[at] : 0.0f;
      db_acc[r] = ok ? cw.db_rows[(size_t)(row0 + r) * 4 * h + gate * h + gu] : 0.0f;
    }
    T* st = s_stage + warp * R * 16;
    const uint32_t step_bytes = n_cta * CROWS * R * sizeof(T);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c % CBUF, n = steps - c * S < S ? steps - c * S : S;
      mbar_wait_parity(full + buf, (c / CBUF) & 1);
      const float* ring = s_ring + (size_t)buf * CPAIRS * CU * CREC;
      for (int s = 0; s < n; ++s) {
        const int i = c * S + s, t = steps - 1 - i;
        if (tc == 0) mbar_expect(mbar + (i & 1), step_bytes);
        float da[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float* e = ring + ((s * R + r) * CU + unit) * CREC;
          const float4 f4 = *reinterpret_cast<const float4*>(e), g4 = *reinterpret_cast<const float4*>(e + 4);
          const float factor = gate == 0 ? f4.x : gate == 1 ? f4.y : gate == 2 ? f4.z : f4.w;
          const float dh_total = g4.z + dh[r];
          const float dc_total = dc[r] + dh_total * g4.x;
          da[r] = (gate == 3 ? dh_total : dc_total) * factor;
          dc[r] = dc_total * g4.y;
          db_acc[r] += da[r];  // rows past the batch: 0
        }
        __syncwarp();  // the last step's bursts are read
        if (l < 4)
#pragma unroll
          for (int r = 0; r < R; ++r) store_f(st + r * 16 + uj * 4 + gate, da[r]);
        __syncwarp();
        for (int b = lane; b < R * NBR * (int)n_cta; b += 32) {
          const int r = b % R, p = (b / R) % NBR, k = b / (R * NBR);
          const uint32_t off = (uint32_t)(((((i & 1) * DAR + r) * DAP + 4 * (u0 + 4 * warp)) * sizeof(T)) + 16 * p);
          st_async_peer_v4(peer_addr(s_da, k) + off, reinterpret_cast<const uint4*>(st + r * 16)[p],
                           peer_addr(mbar + (i & 1), k));
        }
        if (l < 4 && gu < h)
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) store_f(da_out + ((size_t)(row0 + r) * steps + t) * (4 * h) + gate * h + gu, da[r]);
        mbar_wait_parity(mbar + (i & 1), (i >> 1) & 1);
        if constexpr (is_bf16<T>) {
          // dh_{t-1} = da . W_hh[:, units] on the tensor cores: this warp's tile and quarter,
          // then the four quarters' partials in order (s_part double-buffered: a step's
          // barrier keeps the writes of the next from the reads of the last).
          const int g8 = lane >> 2, t4 = lane & 3, mt = warp & 1, kq0 = (warp >> 1) * KQ;
          const T* bv = s_da + (i & 1) * DAR * DAP + g8 * DAP + kq0 * 16 + 2 * t4;
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) mma_bf16(c, a_hh[kk], ld32(bv + kk * 16), ld32(bv + kk * 16 + 8));
          float* part = s_part + (i & 1) * 8 * CU * 4;  // [row][unit][quarter]
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[((2 * t4 + (e & 1)) * CU + mt * 16 + g8 + 8 * (e >> 1)) * 4 + (warp >> 1)] = c[e];
          bar_sync(BAR_CONS, CCONS);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(part + (r * CU + unit) * 4);
            dh[r] = ((p4.x + p4.y) + p4.z) + p4.w;
          }
        } else {
          // dh_{t-1} of this unit = da . W_hh[:, unit]: the lane's terms in order (q, e),
          // then lanes 4, 2 and 1 apart.
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const T* av = s_da + ((i & 1) * DAR + r) * DAP + 4 * l;
            float part = 0.0f;
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              dot_quad(part, w[q][0], w[q][1], w[q][2], w[q][3], *reinterpret_cast<const float4*>(av + 32 * q));
            part += __shfl_xor_sync(0xffffffffu, part, 4);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            dh[r] = part + __shfl_xor_sync(0xffffffffu, part, 1);
          }
        }
      }
      if (c + CBUF < n_chunks) bar_arrive(BAR_EMPTY + buf, CTHREADS);
    }
    if (cw.t0 > 0) {  // the carry into the window before
      // the state's addresses anew (the loads' kept live over the steps would cost registers)
      int r0 = row0, u = gu;
      asm volatile("" : "+r"(r0), "+r"(u));
      if (u < h)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nr) {
            const size_t at = (size_t)(r0 + r) * h + u;
            if (l == 0) cw.dh_state[at] = dh[r], cw.dc_state[at] = dc[r];
            if (l < 4) cw.db_rows[(size_t)(r0 + r) * 4 * h + gate * h + u] = db_acc[r];
          }
    } else if (l < 4 && gu < h) {
      float total = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) total += db_acc[r];
      db_part[(size_t)cluster * 4 * h + gate * h + gu] = total;
    }
  }
  cluster_sync_all();  // no CTA leaves while a peer may still write its da or arrive on its mbarriers
}

template <typename T, int R, int HW>
cudaError_t launch_cluster_rec(BwdArgs<T> a, const float* rec, T* da, float* db_part, ClusterWin cw,
                               cudaStream_t stream) {
  static SmemOnce once;
  constexpr size_t smem = bwd_cluster_smem_bytes<T, R, HW>();
  cudaError_t err = once.set(lstm_bwd_cluster_kernel<T, R, HW>, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, (a.batch + R - 1) / R, a.h, CTHREADS, smem, stream);
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<T, R, HW>, a, rec, da, db_part, cw);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// Clusters of R rows the device holds at once for widths (d, h), by
// cudaOccupancyMaxActiveClusters, or -cudaError (lstm_fwd.cu's).
template <typename T, int R, int HW>
int cluster_slots_rows(int h) {
  static SmemOnce once;
  constexpr size_t smem = bwd_cluster_smem_bytes<T, R, HW>();
  cudaError_t err = once.set(lstm_bwd_cluster_kernel<T, R, HW>, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, 1, h, CTHREADS, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_bwd_cluster_kernel<T, R, HW>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int HW>
int cluster_slots_hw(int rows, int h) {
  switch (rows) {
    case 1: return cluster_slots_rows<T, 1, HW>(h);
    case 2: return cluster_slots_rows<T, 2, HW>(h);
    case 4: return cluster_slots_rows<T, 4, HW>(h);
    case 8: return cluster_slots_rows<T, 8, HW>(h);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename T>
int cluster_slots(int rows, int d, int h) {
  if (d < 1 || h < 1 || d > CLUSTER_MAX_WIDTH || h > CLUSTER_MAX_WIDTH) return -(int)cudaErrorInvalidValue;
  return h <= 128 ? cluster_slots_hw<T, 128>(rows, h) : cluster_slots_hw<T, 256>(rows, h);
}

// fp32 dx where D <= 64 (the masked widths): dx[n][k] = sum_j da[n][j]
// W_ih[j][k] in tiles of 64 x 64 outputs, 4 x 4 a thread, the gate columns
// in order (lstm_any.cuh's dx sums them in the same order: the same bits).
// Its 128 x 128 tiles leave 80 of 128 columns idle at D = 48, where they
// took 2.53 ms of C against this kernel's 2.32 (B=128, T=16000; PERF.md
// section 6).  Grid (ceil(rows / 64), ceil(d / 64)).
constexpr int DXN_T = 64;  // outputs of a tile's side
constexpr int DXN_K = 16;  // gate columns staged a step
__global__ void __launch_bounds__(256)
lstm_bwd_dx_narrow_kernel(const float* __restrict__ da, const float* __restrict__ w_ih, float* __restrict__ dx,
                          long long n_rows, int d, int h) {
  __shared__ __align__(16) float s_a[DXN_K][DXN_T + 4];  // [j][n]
  __shared__ __align__(16) float s_w[DXN_K][DXN_T + 4];  // [j][k]
  const int g = 4 * h, tid = threadIdx.x, tn = tid / 16, tk = tid % 16;
  const long long n0 = (long long)blockIdx.x * DXN_T;
  const int k0 = blockIdx.y * DXN_T;
  float acc[4][4] = {};
  for (int j0 = 0; j0 < g; j0 += DXN_K) {
    __syncthreads();
    for (int i = tid; i < DXN_K * DXN_T; i += 256) {
      const int jj = i % DXN_K, nn = i / DXN_K;  // da is row-major in n: consecutive threads take consecutive j
      const long long n = n0 + nn;
      s_a[jj][nn] = n < n_rows && j0 + jj < g ? da[n * g + j0 + jj] : 0.0f;
      const int kk = i % DXN_T, jw = i / DXN_T;
      s_w[jw][kk] = load_wm(w_ih, j0 + jw < g, (size_t)(j0 + jw), k0 + kk, d);
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < DXN_K; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[jj][tn * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&s_w[jj][tk * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], wv[q], acc[i][q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long n = n0 + tn * 4 + i;
      const int k = k0 + tk * 4 + q;
      if (n < n_rows && k < d) dx[n * d + k] = acc[i][q];
    }
}

// dx, dW and the sum at runtime widths (the four-launch path's last three;
// bf16 on the tensor cores, fp32 on the CUDA cores): lstm_any.cuh's window
// products over the window of every step, Win{0, T}, in slabs of batch rows
// whose (B*T) rows index in 32 bits (one slab below 2^31 rows); fp32 dx at
// D <= 64 by the narrow kernel above, fp32 dW over all rows at once.  bf16
// dx reads W_ih rounded to bf16 from the first 8 G D bytes of part, which
// dW writes only after the last dx (one stream).
template <typename T>
cudaError_t launch_any_products(BwdArgs<T> a, T* dx, float* dw_ih, float* dw_hh, float* db, const T* da,
                                float* part, const float* db_part, int n_chunks, int n_blocks,
                                cudaStream_t stream) {
  const long long n_rows = (long long)a.batch * a.steps, span = ((1ll << 31) - 1) / a.steps;
  const int g = 4 * a.h, kk = a.d + a.h, slab = span < a.batch ? (int)span : a.batch;
  const Win w{0, a.steps};
  auto slab_rows = [&](int b0) { return (long long)(a.batch - b0 < slab ? a.batch - b0 : slab) * a.steps; };
  __nv_bfloat16* wih = reinterpret_cast<__nv_bfloat16*>(part);
  cudaError_t err = cudaSuccess;
  if constexpr (is_bf16<T>) {
    const long long n = (long long)g * a.d;
    lstm_bwd_wih_bf16_kernel<<<(unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, stream>>>(
        a.w_ih, wih, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bool narrow = false;
  if constexpr (!is_bf16<T>) {
    if ((narrow = a.d <= DXN_T)) {
      lstm_bwd_dx_narrow_kernel<<<dim3((unsigned)((n_rows + DXN_T - 1) / DXN_T), (a.d + DXN_T - 1) / DXN_T), 256, 0,
                                  stream>>>(da, a.w_ih, dx, n_rows, a.d, a.h);
      err = cudaGetLastError();
    }
  }
  for (int b0 = 0; b0 < a.batch && !narrow && err == cudaSuccess; b0 += slab) {
    const long long off = (long long)b0 * a.steps, rows = slab_rows(b0);
    err = launch_dx_any<T>(da + off * g, a.w_ih, wih, dx + off * a.d, rows, a.d, a.h, a.steps, w, stream);
  }
  if (err != cudaSuccess) return err;
  if constexpr (is_bf16<T>) {
    for (int b0 = 0; b0 < a.batch && err == cudaSuccess; b0 += slab) {
      const long long off = (long long)b0 * a.steps, rows = slab_rows(b0);
      err = launch_dw_any_mma(da + off * g, a.x + off * a.d, a.y + off * a.h, part, rows, a.steps,
                              (rows + n_chunks - 1) / n_chunks, n_chunks, a.d, a.h, w, b0 > 0, stream);
    }
  } else {
    lstm_bwd_dw_any_kernel<false><<<dim3(n_chunks, (g + FT - 1) / FT, (kk + FT - 1) / FT), 256, 0, stream>>>(
        da, a.x, a.y, part, n_rows, a.steps, (n_rows + n_chunks - 1) / n_chunks, a.d, a.h, Win{}, 0);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  lstm_bwd_sum_any_kernel<<<(unsigned)(((long long)g * kk + 255) / 256), 256, 0, stream>>>(
      part, n_chunks, db_part, n_blocks, dw_ih, dw_hh, db, a.d, a.h);
  return cudaGetLastError();
}

template <typename T, int HW>
cudaError_t launch_cluster_rec_hw(BwdArgs<T> a, const float* rec, T* da, float* db_part, int rows, ClusterWin cw,
                                  cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_cluster_rec<T, 1, HW>(a, rec, da, db_part, cw, stream);
    case 2: return launch_cluster_rec<T, 2, HW>(a, rec, da, db_part, cw, stream);
    case 4: return launch_cluster_rec<T, 4, HW>(a, rec, da, db_part, cw, stream);
    case 8: return launch_cluster_rec<T, 8, HW>(a, rec, da, db_part, cw, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The cluster path, window by window from the last: the gate pass into rec,
// the recurrence, dx and dW; then the ordered sum.  bf16 packs W_hh's
// columns (the gate pass's) and rounds W_ih (dx's) first.
template <typename T>
int launch_cluster(BwdArgs<T> a, void* dx, float* dw_ih, float* dw_hh, float* db, void* da, float* rec, float* part,
                   float* db_part, void* wpack, void* wih, float* dh_state, float* dc_state, float* db_rows, int rows,
                   int n_chunks, int window, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (a.d < 1 || a.h < 1 || a.d > CLUSTER_MAX_WIDTH || a.h > CLUSTER_MAX_WIDTH || n_chunks < 1 || window < 1 ||
      (long long)a.batch * window >= (1ll << 31) || rec == nullptr || (is_bf16<T> && (wpack == nullptr || wih == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if constexpr (is_bf16<T>)
    if ((err = pack(a.w_hh, wpack, a.h, 1, true, a.w_ih, wih, a.d, stream)) != cudaSuccess) return (int)err;
  const int n_win = (a.steps + window - 1) / window;
  for (int wi = n_win - 1; wi >= 0; --wi) {
    const int t0 = wi * window, tc = a.steps - t0 < window ? a.steps - t0 : window;
    const Win w{t0, tc};
    if ((err = gate_pass<T, false>(a, wih, wpack, rec, nullptr, w, stream)) != cudaSuccess) return (int)err;
    const ClusterWin cw{t0, tc, dh_state, dc_state, db_rows};
    err = a.h <= 128 ? launch_cluster_rec_hw<T, 128>(a, rec, (T*)da, db_part, rows, cw, stream)
                     : launch_cluster_rec_hw<T, 256>(a, rec, (T*)da, db_part, rows, cw, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_window_products<T>(a, (const T*)da, (const __nv_bfloat16*)wih, (T*)dx, part, n_chunks, w,
                                    wi == n_win - 1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_bwd_sum_any_kernel<<<(unsigned)(((long long)4 * a.h * (a.d + a.h) + 255) / 256), 256, 0, stream>>>(
      part, n_chunks, db_part, (a.batch + rows - 1) / rows, dw_ih, dw_hh, db, a.d, a.h);
  return (int)cudaGetLastError();
}

// dx, dW and the sum at D = H = W: the four-launch path's last three at the
// capacity (64, 32 and 16).
template <typename T, int W>
cudaError_t launch_square_products(BwdArgs<T> a, T* dx, float* dw_ih, float* dw_hh, float* db, const T* da,
                                   float* part, const float* db_part, int n_chunks, int n_blocks, int dx_blocks,
                                   cudaStream_t stream) {
  constexpr int G = 4 * W, K = 2 * W;
  const long long n_rows = (long long)a.batch * a.steps;
  const long long chunk_rows = (n_rows + n_chunks - 1) / n_chunks;
  static SmemOnce dx_once;
  cudaError_t err = cudaSuccess;
  if constexpr (is_bf16<T>) {
    constexpr int smem = dxm_smem_bytes<W>();
    if ((err = dx_once.set(lstm_bwd_dx_mma_kernel<W>, smem)) != cudaSuccess) return err;
    lstm_bwd_dx_mma_kernel<W><<<dx_blocks, 256, smem, stream>>>(da, a.w_ih, dx, n_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lstm_bwd_dw_mma_kernel<W><<<dim3(n_chunks, 2), 256, 0, stream>>>(da, a.x, a.y, part, n_rows, a.steps, chunk_rows);
  } else {
    constexpr int smem = dx_smem_bytes<W>();
    if ((err = dx_once.set(lstm_bwd_dx_kernel<W>, smem)) != cudaSuccess) return err;
    lstm_bwd_dx_kernel<W><<<dx_blocks, 256, smem, stream>>>(da, a.w_ih, dx, n_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lstm_bwd_dw_kernel<W><<<dim3(n_chunks, G / dw_block_cols<W>), 256, 0, stream>>>(da, a.x, a.y, part, n_rows,
                                                                                     a.steps, chunk_rows);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lstm_bwd_sum_kernel<W><<<(G * K + 255) / 256, 256, 0, stream>>>(part, n_chunks, db_part, n_blocks, dw_ih, dw_hh,
                                                                   db);
  return cudaGetLastError();
}

template <typename T, int W>
int launch(BwdArgs<T> a, void* dx, float* dw_ih, float* dw_hh, float* db, void* da, float* part,
           float* db_part, int rows, int n_chunks, int dx_blocks, int fused, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool square = a.d == W && a.h == W;  // else masked: D, H <= W at runtime
  if (rows != 1 && rows != 2) return (int)cudaErrorInvalidValue;
  if (a.d < 1 || a.h < 1 || a.d > W || a.h > W) return (int)cudaErrorInvalidValue;
  if (fused) {
    if constexpr (W == 32 || W == 16) {
      if (square)
        return (int)(rows == 1 ? launch_fused<T, 1, W, false>(a, (T*)dx, part, dw_ih, dw_hh, db, stream)
                               : launch_fused<T, 2, W, false>(a, (T*)dx, part, dw_ih, dw_hh, db, stream));
      return (int)(rows == 1 ? launch_fused<T, 1, W, true>(a, (T*)dx, part, dw_ih, dw_hh, db, stream)
                             : launch_fused<T, 2, W, true>(a, (T*)dx, part, dw_ih, dw_hh, db, stream));
    }
    return (int)cudaErrorInvalidValue;
  }
  if (n_chunks < 1 || dx_blocks < 1) return (int)cudaErrorInvalidValue;
  const int rec_blocks = (a.batch + rows - 1) / rows;

  cudaError_t err = rows == 1 ? launch_rec<T, 1, W>(a, (T*)da, db_part, stream)
                              : launch_rec<T, 2, W>(a, (T*)da, db_part, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (W != 48)  // capacity 48 has no square products: the runtime widths' at 48 x 48 too
    if (square)
      return (int)launch_square_products<T, W>(a, (T*)dx, dw_ih, dw_hh, db, (const T*)da, part, db_part, n_chunks,
                                               rec_blocks, dx_blocks, stream);
  return (int)launch_any_products<T>(a, (T*)dx, dw_ih, dw_hh, db, (const T*)da, part, db_part, n_chunks,
                                     rec_blocks, stream);
}

}  // namespace

extern "C" {

// Capacity 64 (no suffix), 48 (_w48), 32 (_w32) and 16 (_w16), for any 1 <=
// D, H <= the capacity.  G =
// 4 H.  x: (B, T, D), y: (B, T, H) (the forward's output) and dy: (B, T, H),
// all three in the instantiation's type; w_ih: (G, D), w_hh: (G, H) fp32,
// 8-byte aligned; cprev: (B, T, H) fp32; bias: (G,) fp32.  Outputs, every
// element written: dx (B, T, D) in the instantiation's type, dw_ih (G, D),
// dw_hh (G, H) and db (G,) fp32.  rows: batch rows per recurrent block,
// 1 or 2.  fused = 0, the four launches: scratch da (B, T, G) in the
// instantiation's type, part (n_chunks, G, D + H) fp32, db_part (ceil(B /
// rows), G) fp32; dx_blocks: the square dx kernel's grid (>= 1, unused at
// capacity 48 and at runtime widths).  fused = 1 (capacities 32 and 16,
// any D, H within them; its rows' da must fit a block's shared memory,
// which the plan's T <= 64 keeps): one cooperative launch of ceil(B / rows)
// blocks, which must all be resident at once (awm_lstm_bwd_fused_slots);
// scratch part (ceil(B / rows), 4 W 2 W + 4 W) fp32 at the capacity W; da, db_part, n_chunks and
// dx_blocks unused; rec unused.  All contiguous on the current device; B, T
// >= 1.
// Returns the first cudaError_t of the launches (0 = all launched).
#define AWM_LSTM_BWD_ENTRY(NAME, TYPE, W)                                                         \
  int NAME(const void* x, const void* y, const float* cprev, const void* dy, const float* w_ih,  \
           const float* w_hh, const float* bias, void* dx,                                        \
           float* dw_ih, float* dw_hh, float* db, void* da, float* rec, float* part,             \
           float* db_part, int batch, int steps, int d, int h, int rows, int n_chunks,            \
           int dx_blocks, int fused, void* stream) {                                              \
    const BwdArgs<TYPE> a{(const TYPE*)x, (const TYPE*)y, cprev, (const TYPE*)dy, w_ih, w_hh,   \
                          bias, batch, steps, d, h};                                              \
    (void)rec;                                                                                    \
    return launch<TYPE, W>(a, dx, dw_ih, dw_hh, db, da, part, db_part, rows, n_chunks,           \
                           dx_blocks, fused, stream);                                             \
  }
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_f32, float, 64)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_bf16, __nv_bfloat16, 64)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_f32_w48, float, 48)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_bf16_w48, __nv_bfloat16, 48)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_f32_w32, float, 32)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_bf16_w32, __nv_bfloat16, 32)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_f32_w16, float, 16)
AWM_LSTM_BWD_ENTRY(awm_lstm_bwd_bf16_w16, __nv_bfloat16, 16)
#undef AWM_LSTM_BWD_ENTRY

// The cluster path (_cluster), any 1 <= D, H <= 256: the operands and
// outputs above; scratch per window of `window` steps (B window < 2^31): da
// (B, window, G) in the instantiation's type, rec (B, window, H, 8) fp32;
// part (n_chunks, G, D + H) fp32, db_part (ceil(B / rows), G) fp32; bf16
// only (null for fp32): wpack awm_lstm_wide_pack_elems(1, 1, H) bf16 and wih
// (G, D) bf16; the state carried between windows: dh_state, dc_state (B, H)
// and db_rows (B, G) fp32.  rows: 1, 2, 4 or 8 a cluster.
#define AWM_LSTM_BWD_CLUSTER_ENTRY(NAME, TYPE)                                                    \
  int NAME(const void* x, const void* y, const float* cprev, const void* dy, const float* w_ih,  \
           const float* w_hh, const float* bias, void* dx,                                        \
           float* dw_ih, float* dw_hh, float* db, void* da, float* rec, float* part,             \
           float* db_part, void* wpack, void* wih, float* dh_state, float* dc_state,             \
           float* db_rows, int batch, int steps, int d, int h, int rows, int n_chunks,            \
           int window, void* stream) {                                                            \
    const BwdArgs<TYPE> a{(const TYPE*)x, (const TYPE*)y, cprev, (const TYPE*)dy, w_ih, w_hh,   \
                          bias, batch, steps, d, h};                                              \
    return launch_cluster<TYPE>(a, dx, dw_ih, dw_hh, db, da, rec, part, db_part, wpack, wih,     \
                                dh_state, dc_state, db_rows, rows, n_chunks, window, stream);     \
  }
AWM_LSTM_BWD_CLUSTER_ENTRY(awm_lstm_bwd_f32_cluster, float)
AWM_LSTM_BWD_CLUSTER_ENTRY(awm_lstm_bwd_bf16_cluster, __nv_bfloat16)
#undef AWM_LSTM_BWD_CLUSTER_ENTRY

// Blocks of the fused backward (capacity `width`, 32 or 16; masked 0: the
// square instantiation, D = H = width, 1: the masked one, any other D, H
// within it; `rows` 1 or 2 a block) that one SM of the current device holds
// at once at T = steps (the block's shared memory grows with T); 0 where
// the card's opt-in limit refuses its shared memory; negative: -cudaError.
int awm_lstm_bwd_fused_slots(int bf16, int width, int rows, int steps, int masked) {
#define AWM_FUSED_SLOTS(TYPE, W) \
  (masked ? fused_slots<TYPE, W, true>(rows, steps) : fused_slots<TYPE, W, false>(rows, steps))
  switch (width) {
    case 32: return bf16 ? AWM_FUSED_SLOTS(__nv_bfloat16, 32) : AWM_FUSED_SLOTS(float, 32);
    case 16: return bf16 ? AWM_FUSED_SLOTS(__nv_bfloat16, 16) : AWM_FUSED_SLOTS(float, 16);
    default: return -(int)cudaErrorInvalidValue;
  }
#undef AWM_FUSED_SLOTS
}

// Clusters of `rows` rows (1, 2, 4 or 8) of kernel C's recurrence that the
// current device holds at once for widths (d, h); negative: -cudaError.
int awm_lstm_bwd_cluster_slots(int bf16, int rows, int d, int h) {
  return bf16 ? cluster_slots<__nv_bfloat16>(rows, d, h) : cluster_slots<float>(rows, d, h);
}

const char* awm_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
