// The runtime-width kernels of kernel C, shared by lstm_bwd.cu (the masked
// and cluster paths) and lstm_wide.cu (the wide path, max(D, H) > 256):
// the gate passes of a window (gate_pass: fp32 lstm_bwd_gates_f32_kernel,
// and for the wide C lstm_bwd_gates_f32_split_kernel; bf16
// lstm_bwd_gates_wide_mma_kernel, which reads the wide path's packed W_hh,
// also here), dx, dW and the ordered sum at runtime D and H.
//
// Each product runs over rows of the flattened (B*T) axis.  WIN = false: all
// of them, row n is (row n / T, step n % T) (the masked path's dW).  WIN =
// true: a window of w.tc steps from step w.t0 of every batch row (the
// cluster and wide paths work in windows of time, so that their scratch
// does not grow with T): local row n = b tc + s is global row
// b T + t0 + s, the scratch (records, da, xp) is indexed by the local row and
// x, y, c_{t-1}, dy and dx by the global one; h_{t-1} = y of the global row
// before, zero at t0 + s = 0.  A window's B tc stays below 2^31, so a local
// row is an int.  The gate passes with XP = true stop after x's terms and
// write the sums (the bias, then x's terms) to an fp32 (rows, 4H) tile: the
// wide forward's input projection, which its recurrence continues with h's
// terms (bf16 in the gate pass's order, fp32 in QSEGS segments), so kernel C
// recomputes the forward's gates bit for bit.

#pragma once

#include "lstm_common.cuh"

namespace {

using namespace awm;

// A window of steps (WIN = true): steps t0 .. t0 + tc - 1 of every batch row.
struct Win {
  int t0, tc;
};
// The global row of local row n, and whether it has an h_{t-1} (its step is
// not 0); WIN = false: the identity and n % steps.
template <bool WIN>
__device__ __forceinline__ long long global_row(long long n, long long steps, Win w) {
  if constexpr (WIN) {
    const int ni = (int)n;
    return (long long)(ni / w.tc) * steps + w.t0 + ni % w.tc;
  } else {
    return n;
  }
}
template <bool WIN>
__device__ __forceinline__ bool has_prev(long long n, long long steps, Win w) {
  if constexpr (WIN) return w.t0 + (int)n % w.tc != 0;
  else return n % steps != 0;
}

// The operands of one call, shared by every path.
template <typename T>
struct BwdArgs {
  const T* x;          // (B, T, d)
  const T* y;          // (B, T, h), the forward's output: h_{t-1} = y_{t-1}
  const float* cprev;  // (B, T, h) fp32
  const T* dy;         // (B, T, h)
  const float* w_ih;   // (4h, d) fp32
  const float* w_hh;   // (4h, h) fp32
  const float* bias;   // (G,) fp32
  int batch, steps;
  int d, h;            // the real widths: x (B, T, d), y (B, T, h), W_ih (4h, d), W_hh (4h, h)
};

// ---- Any width: dx, dW and the ordered sum at runtime D and H ----
//
// The products of every call whose widths are not a capacity's square
// (D != H, or a width other than 16, 32, 64; every call above 64, the wide
// path's windows too): G = 4 H gate columns, K = D + H terms, tails masked,
// each output's terms summed in order (two runs give the same bits).  fp32
// stays fp32 (CUDA cores, no TF32): dx and dW in tiles of 128 x 128
// outputs, 8 x 8 a thread.  bf16 on the tensor cores (below): da is bf16
// already and W_ih is rounded to bf16 once a call, so every product is exact
// in fp32 and sums in fp32.  dx and bf16 dW take a window of rows (WIN =
// true: da local, x, y and dx global); lstm_bwd.cu's calls pass the window
// of every step, Win{0, T}, over slabs of batch rows whose (B*T) rows index
// in 32 bits.

// fp32: part[chunk][j][m] = sum over the chunk's rows n of da[n][j] v[n][m],
// v = [x | h_{t-1}] (h_{t-1} = y of the previous row, zero at t = 0), j <
// 4h, m < d + h.  A block owns 128 x 128 outputs, a thread 8 x 8 (two groups
// of 4 gate columns 64 apart, two of 4 terms 64 apart): the chunk's rows
// staged FK at a time (the next FK in registers meanwhile), one 16-byte
// load of each operand feeding 16 products.  Every output sums its rows in
// order (two runs give the same bits).  Grid (n_chunks, ceil(4h / 128),
// ceil((d + h) / 128)).  WIN: the window's rows (da local, x and y global),
// and accum = 1 adds the chunk's sums to the partial already there (the wide
// path's windows, in the order they run), 0 writes them.
constexpr int FT = 128;  // outputs of a tile's side
constexpr int FK = 8;    // rows staged a step
template <bool WIN>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_dw_any_kernel(const float* __restrict__ da, const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ part, long long n_rows, int steps, long long chunk_rows, int d, int h,
                       Win w, int accum) {
  __shared__ __align__(16) float s_a[2][FK][FT];  // [buf][n][j]
  __shared__ __align__(16) float s_v[2][FK][FT];  // [buf][n][m]
  const int g = 4 * h, kk = d + h, tid = threadIdx.x, tj = tid >> 4, tm = tid & 15;
  const int j0 = blockIdx.y * FT, m0 = blockIdx.z * FT;
  const long long begin = blockIdx.x * chunk_rows;
  const long long end = begin + chunk_rows < n_rows ? begin + chunk_rows : n_rows;
  // Staging: this thread loads column c of rows r0 + 2 q (q < 4) of each step; t[q] is that
  // row's step index t (0: h_{t-1} = 0), kept up to date from one division.
  const int c = tid & (FT - 1), r0 = tid >> 7;
  int t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = WIN ? 0 : (int)((begin + r0 + 2 * q) % steps);
  float ra[4], rv[4];
  auto fetch = [&](long long base) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long n = base + r0 + 2 * q;
      const int m = m0 + c;
      ra[q] = n < end && j0 + c < g ? da[n * g + j0 + c] : 0.0f;
      float v = 0.0f;
      if constexpr (WIN) {
        if (n < end && m < kk) {
          const long long gn = global_row<WIN>(n, steps, w);
          if (m < d) v = x[gn * d + m];
          else if (has_prev<WIN>(n, steps, w)) v = y[(gn - 1) * h + (m - d)];
        }
      } else {
        if (n < end && m < kk) {
          if (m < d) v = x[n * d + m];
          else if (t[q] != 0) v = y[(n - 1) * h + (m - d)];
        }
        for (t[q] += FK; t[q] >= steps;) t[q] -= steps;
      }
      rv[q] = v;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_a[buf][r0 + 2 * q][c] = ra[q];
      s_v[buf][r0 + 2 * q][c] = rv[q];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  if (begin < end) {
    fetch(begin);
    put(0);
  }
  __syncthreads();
  int cur = 0;
  for (long long base = begin; base < end; base += FK, cur ^= 1) {
    const bool more = base + FK < end;
    if (more) fetch(base + FK);
#pragma unroll
    for (int nn = 0; nn < FK; ++nn) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[cur][nn][4 * tj]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[cur][nn][64 + 4 * tj]);
      const float4 v0 = *reinterpret_cast<const float4*>(&s_v[cur][nn][4 * tm]);
      const float4 v1 = *reinterpret_cast<const float4*>(&s_v[cur][nn][64 + 4 * tm]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], vv[q], acc[p][q]);
    }
    if (more) put(cur ^ 1);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * g * kk;
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (p / 4) * 64 + 4 * tj + p % 4, m = m0 + (q / 4) * 64 + 4 * tm + q % 4;
      if (j < g && m < kk) out[(size_t)j * kk + m] = WIN && accum ? out[(size_t)j * kk + m] + acc[p][q] : acc[p][q];
    }
}

// dW_ih / dW_hh = the sum of the chunk partials; db = the sum of the
// recurrent blocks' partials.  Fixed order, one thread per output.
__global__ void __launch_bounds__(256)
lstm_bwd_sum_any_kernel(const float* __restrict__ part, int n_chunks, const float* __restrict__ db_part,
                        int n_blocks, float* __restrict__ dw_ih, float* __restrict__ dw_hh,
                        float* __restrict__ db, int d, int h) {
  const int g = 4 * h, kk = d + h;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx < (long long)g * kk) {
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * g * kk + idx];
    const int j = (int)(idx / kk), m = (int)(idx % kk);
    if (m < d) dw_ih[(size_t)j * d + m] = s;
    else dw_hh[(size_t)j * h + (m - d)] = s;
  }
  if (idx < g) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += db_part[(size_t)b * g + idx];
    db[idx] = s;
  }
}

// fp32: dx[global row of n][k] = sum_j da[n][j] W_ih[j][k] over a window's rows:
// a block owns 128 rows x 128 inputs, a thread 8 x 8 (two groups of 4 rows
// 64 apart, two of 4 inputs 64 apart), the gate columns staged FK at a time
// (the next FK in registers meanwhile), so that one 16-byte load of each
// operand feeds 16 FMAs, full fp32 on the CUDA cores.  Each output sums its
// gate columns in order.  Grid (ceil(rows / 128), ceil(d / 128)).  vec: D a
// multiple of 4 and W_ih, dx 16-byte aligned, else one value a load.
__global__ void __launch_bounds__(256, 2)
lstm_bwd_dx_any_kernel(const float* __restrict__ da, const float* __restrict__ w_ih, float* __restrict__ dx,
                       long long n_rows, int d, int h, int vec, long long steps, Win w) {
  __shared__ __align__(16) float s_a[2][FK][FT + 4];  // [buf][j][n]: da transposed (the pad spreads the stores)
  __shared__ __align__(16) float s_w[2][FK][FT];      // [buf][j][k]
  const int g = 4 * h, tid = threadIdx.x, tn = tid >> 4, tk = tid & 15;
  const long long n0 = (long long)blockIdx.x * FT;
  const int k0 = blockIdx.y * FT;
  // staging: da row n0 + tid / 2, gate columns 4 (tid % 2) .. + 3 of the step; W_ih row tid / 32, inputs 4 (tid % 32) ..
  const int an = tid >> 1, aj = (tid & 1) * 4, wj = tid >> 5, wk = (tid & 31) * 4;
  float ra[4], rw[4];
  auto fetch = [&](int j0) {
    const long long n = n0 + an;
    if (n < n_rows && j0 + aj < g) {  // 4h is a multiple of 4: a da row's 16-byte pieces lie within it
      const float4 v = *reinterpret_cast<const float4*>(da + n * g + j0 + aj);
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
      ra[0] = ra[1] = ra[2] = ra[3] = 0.0f;
    }
    const int j = j0 + wj, k = k0 + wk;
    if (vec && j < g && k < d) {
      const float4 v = *reinterpret_cast<const float4*>(w_ih + (size_t)j * d + k);
      rw[0] = v.x, rw[1] = v.y, rw[2] = v.z, rw[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) rw[i] = load_wm(w_ih, j < g, (size_t)j, k + i, d);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_a[buf][aj + i][an] = ra[i];
    *reinterpret_cast<float4*>(&s_w[buf][wj][wk]) = make_float4(rw[0], rw[1], rw[2], rw[3]);
  };
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  fetch(0);
  put(0);
  __syncthreads();
  int cur = 0;
  for (int j0 = 0; j0 < g; j0 += FK, cur ^= 1) {
    const bool more = j0 + FK < g;
    if (more) fetch(j0 + FK);
#pragma unroll
    for (int jj = 0; jj < FK; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[cur][jj][4 * tn]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[cur][jj][64 + 4 * tn]);
      const float4 w0 = *reinterpret_cast<const float4*>(&s_w[cur][jj][4 * tk]);
      const float4 w1 = *reinterpret_cast<const float4*>(&s_w[cur][jj][64 + 4 * tk]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], wv[q], acc[p][q]);
    }
    if (more) put(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const long long n = n0 + (p / 4) * 64 + 4 * tn + p % 4;
    if (n >= n_rows) continue;
    float* row = dx + global_row<true>(n, steps, w) * d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + half * 64 + 4 * tk;
      if (vec && k < d) {
        *reinterpret_cast<float4*>(row + k) =
            make_float4(acc[p][4 * half], acc[p][4 * half + 1], acc[p][4 * half + 2], acc[p][4 * half + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < d) row[k + i] = acc[p][4 * half + i];
      }
    }
  }
}

// bf16: dW and dx of a window on the tensor cores, in block tiles of 128 x
// 128 outputs, a warp 64 x 32 (2 x 4 warps, 16 mma.sync.m16n8k16 a k-tile),
// the reduction axis staged 32 at a time by cp.async into a ring of 4 stages
// (three in flight while one is multiplied, one __syncthreads a stage),
// every fragment by ldmatrix.  Each output sums its k-tiles in order in one
// accumulator: two calls give the same bits.
constexpr int MT = 128;             // outputs of a block tile's side
constexpr int MK = 32;              // terms of the reduction a stage
constexpr int MS = 4;               // stages of the ring
constexpr int MP = MT + 8;          // row pitch (bf16) of a staged [MK][MT] tile: ldmatrix rows in distinct banks
constexpr int MKP = MK + 8;         // row pitch of dx's staged da tile [MT][MK]
constexpr int DW_SMEM = (int)sizeof(__nv_bfloat16) * MS * 2 * MK * MP;
constexpr int DX_SMEM = (int)sizeof(__nv_bfloat16) * MS * (MT * MKP + MK * MP);

// Ring stages st = 0 .. ns - 1 of a product, stage(st, buf) issuing stage
// st's copies into buffer buf, mul(buf) multiplying it.
template <typename Stage, typename Mul>
__device__ __forceinline__ void stage_ring(long long ns, Stage stage, Mul mul) {
  for (int st = 0; st < MS - 1; ++st) {
    if (st < ns) stage(st, st);
    cp_async_commit();
  }
  for (long long st = 0; st < ns; ++st) {
    cp_async_wait<MS - 2>();
    __syncthreads();  // stage st in for every thread, every thread past stage st - 1 (whose buffer is next)
    if (st + MS - 1 < ns) stage(st + MS - 1, (int)((st + MS - 1) % MS));
    cp_async_commit();
    mul((int)(st % MS));
  }
}

// 8 bf16 into shared memory: 16 bytes by cp.async where vec and the source
// lies within the operand (ok), zeros where it does not; one at a time from
// get(i) (zero past the operand) where not vec.
template <typename Get>
__device__ __forceinline__ void put8(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok, bool vec, Get get) {
  if (vec) {
    if (ok) cp_async16(dst, src);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = get(i);
  }
}

// part[chunk][j][m] (+)= sum over the chunk's rows n of the window of da[n][j]
// v[n][m], v = [x | h_{t-1}] (h_{t-1} = y of the global row before, zero at
// step 0), j < 4h, m < d + h.  Grid (n_chunks, ceil(4h / 128), ceil((d + h)
// / 128)).  vec: D, H multiples of 8 and x, y, da 16-byte aligned, else
// plain loads.  accum: add to the partial there (the wide path's windows
// after the call's first, in the order they run), else write it.
__global__ void __launch_bounds__(256, 2)
lstm_bwd_dw_any_mma_kernel(const __nv_bfloat16* __restrict__ da, const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ y, float* __restrict__ part, long long n_rows,
                           int steps, long long chunk_rows, int d, int h, int vec, Win w, int accum) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);  // [MS][MK][MP]: da, rows x gate columns
  __nv_bfloat16* s_v = s_a + MS * MK * MP;                       // [MS][MK][MP]: v, rows x terms
  const int g = 4 * h, kk = d + h, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.y * MT, m0 = blockIdx.z * MT, wj = (warp & 1) * 64, wm = (warp >> 1) * 32;
  const int blk = lane >> 3, blk_row = lane & 7;  // ldmatrix: this lane's block and row in it
  const long long begin = blockIdx.x * chunk_rows;
  const long long end = begin + chunk_rows < n_rows ? begin + chunk_rows : n_rows;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  // a stage: 32 rows x 16 pieces of 8 values of each operand, pieces tid and tid + 256 of each
  auto stage = [&](long long st, int buf) {
    const long long base = begin + st * MK;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = tid + 256 * e, r = p >> 4, cc = (p & 15) * 8;
      const long long n = base + r;
      const bool live = n < end;
      const long long gn = live ? global_row<true>(n, steps, w) : 0;
      const bool prev = live && has_prev<true>(n, steps, w);
      const int j = j0 + cc, m = m0 + cc;
      put8(s_a + (buf * MK + r) * MP + cc, da + n * g + j, live && j < g, vec,
           [&](int i) { return live && j + i < g ? da[n * g + j + i] : zero; });
      const __nv_bfloat16* src = m < d ? x + gn * d + m : y + (gn - 1) * h + (m - d);
      put8(s_v + (buf * MK + r) * MP + cc, src, live && m < kk && (m < d || prev), vec, [&](int i) {
        const int mi = m + i;
        return !live || mi >= kk ? zero : mi < d ? x[gn * d + mi] : prev ? y[(gn - 1) * h + (mi - d)] : zero;
      });
    }
  };
  float c[4][4][4] = {};
  auto mul = [&](int buf) {
    const __nv_bfloat16* a_buf = s_a + buf * MK * MP;
    const __nv_bfloat16* v_buf = s_v + buf * MK * MP;
#pragma unroll
    for (int ks = 0; ks < MK / 16; ++ks) {
      uint32_t a[4][4];  // A[j][n] = da[n][j]
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], a_buf + (ks * 16 + (blk >> 1) * 8 + blk_row) * MP + wj + mt * 16 + (blk & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];  // B[n][m] = v[n][m]
        ldmatrix_x4_trans(b, v_buf + (ks * 16 + (blk & 1) * 8 + blk_row) * MP + wm + np * 16 + (blk >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(c[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(c[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };
  stage_ring(begin < end ? (end - begin + MK - 1) / MK : 0, stage, mul);
  float* out = part + (size_t)blockIdx.x * g * kk;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + wj + mt * 16 + g8 + (e >> 1) * 8, m = m0 + wm + nt * 8 + 2 * t4 + (e & 1);
        if (j < g && m < kk) out[(size_t)j * kk + m] = accum ? out[(size_t)j * kk + m] + c[mt][nt][e] : c[mt][nt][e];
      }
}

// dx[global row of n][k] = sum_j da[n][j] W_ih[j][k] over the window's rows,
// W_ih in bf16 (wih, rounded once a call, as the gate passes round it): A
// fragments from da [row][j] by ldmatrix, B fragments from W_ih [j][k]
// transposed by ldmatrix.  Grid (ceil(rows / 128), ceil(d / 128)).  vec:
// D, H multiples of 8 and da, wih, dx 16-byte aligned, else one value a load.
__global__ void __launch_bounds__(256, 2)
lstm_bwd_dx_any_mma_kernel(const __nv_bfloat16* __restrict__ da, const __nv_bfloat16* __restrict__ wih,
                           __nv_bfloat16* __restrict__ dx, long long n_rows, int d, int h, int vec, long long steps,
                           Win w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);  // [MS][MT][MKP]: da, rows x gate columns
  __nv_bfloat16* s_w = s_a + MS * MT * MKP;                      // [MS][MK][MP]: W_ih, gate columns x inputs
  const int g = 4 * h, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const long long n0 = (long long)blockIdx.x * MT;
  const int k0 = blockIdx.y * MT, wn = (warp & 1) * 64, wk = (warp >> 1) * 32;
  const int blk = lane >> 3, blk_row = lane & 7;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  auto stage = [&](long long st, int buf) {
    const int j0 = (int)st * MK;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = tid + 256 * e;
      {  // da: 128 rows x 4 pieces
        const int r = p >> 2, cc = (p & 3) * 8, j = j0 + cc;
        const long long n = n0 + r;
        const bool live = n < n_rows;
        put8(s_a + ((size_t)buf * MT + r) * MKP + cc, da + n * g + j, live && j < g, vec,
             [&](int i) { return live && j + i < g ? da[n * g + j + i] : zero; });
      }
      {  // W_ih: 32 gate columns x 16 pieces
        const int r = p >> 4, cc = (p & 15) * 8, j = j0 + r, k = k0 + cc;
        put8(s_w + ((size_t)buf * MK + r) * MP + cc, wih + (size_t)j * d + k, j < g && k < d, vec,
             [&](int i) { return j < g && k + i < d ? wih[(size_t)j * d + k + i] : zero; });
      }
    }
  };
  float c[4][4][4] = {};
  auto mul = [&](int buf) {
    const __nv_bfloat16* a_buf = s_a + (size_t)buf * MT * MKP;
    const __nv_bfloat16* w_buf = s_w + (size_t)buf * MK * MP;
#pragma unroll
    for (int ks = 0; ks < MK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a[mt], a_buf + (wn + mt * 16 + (lane & 15)) * MKP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];  // B[j][k] = W_ih[j][k]
        ldmatrix_x4_trans(b, w_buf + (ks * 16 + (blk & 1) * 8 + blk_row) * MP + wk + np * 16 + (blk >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(c[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(c[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };
  stage_ring((g + MK - 1) / MK, stage, mul);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long n = n0 + wn + mt * 16 + g8 + half * 8;
      if (n >= n_rows) continue;
      __nv_bfloat16* row = dx + global_row<true>(n, steps, w) * d;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int k = k0 + wk + nt * 8 + 2 * t4;
        const float v0 = c[mt][nt][2 * half], v1 = c[mt][nt][2 * half + 1];
        if (vec && k + 1 < d) *reinterpret_cast<uint32_t*>(row + k) = pack_bf16(v0, v1);
        else {
          if (k < d) row[k] = __float2bfloat16(v0);
          if (k + 1 < d) row[k + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// W_ih (n = 4H D values) rounded to bf16 for bf16 dx, as the mma kernels round it.
__global__ void __launch_bounds__(256)
lstm_bwd_wih_bf16_kernel(const float* __restrict__ w_ih, __nv_bfloat16* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    out[i] = __float2bfloat16(w_ih[i]);
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// dx of a window's n_rows rows: bf16 on the tensor cores from wih (W_ih in
// bf16), fp32 on the CUDA cores from w_ih.
template <typename T>
cudaError_t launch_dx_any(const T* da, const float* w_ih, const __nv_bfloat16* wih, T* dx, long long n_rows, int d,
                          int h, long long steps, Win w, cudaStream_t stream) {
  if constexpr (is_bf16<T>) {
    static SmemOnce once;
    const cudaError_t err = once.set(lstm_bwd_dx_any_mma_kernel, DX_SMEM);
    if (err != cudaSuccess) return err;
    const int vec = d % 8 == 0 && h % 8 == 0 && aligned16(da) && aligned16(wih) && aligned16(dx);
    lstm_bwd_dx_any_mma_kernel<<<dim3((unsigned)((n_rows + MT - 1) / MT), (d + MT - 1) / MT), 256, DX_SMEM, stream>>>(
        da, wih, dx, n_rows, d, h, vec, steps, w);
  } else {
    const int vec = d % 4 == 0 && aligned16(w_ih) && aligned16(dx);
    lstm_bwd_dx_any_kernel<<<dim3((unsigned)((n_rows + FT - 1) / FT), (d + FT - 1) / FT), 256, 0, stream>>>(
        da, w_ih, dx, n_rows, d, h, vec, steps, w);
  }
  return cudaGetLastError();
}

// bf16 dW partials of a window's n_rows rows in n_chunks chunks of
// chunk_rows: written (accum = 0) or added to the partials there (1).
inline cudaError_t launch_dw_any_mma(const __nv_bfloat16* da, const __nv_bfloat16* x, const __nv_bfloat16* y,
                                     float* part, long long n_rows, int steps, long long chunk_rows, int n_chunks,
                                     int d, int h, Win w, int accum, cudaStream_t stream) {
  static SmemOnce once;
  const cudaError_t err = once.set(lstm_bwd_dw_any_mma_kernel, DW_SMEM);
  if (err != cudaSuccess) return err;
  const int g = 4 * h, kk = d + h;
  const int vec = d % 8 == 0 && h % 8 == 0 && aligned16(da) && aligned16(x) && aligned16(y);
  lstm_bwd_dw_any_mma_kernel<<<dim3(n_chunks, (g + MT - 1) / MT, (kk + MT - 1) / MT), 256, DW_SMEM, stream>>>(
      da, x, y, part, n_rows, steps, chunk_rows, d, h, vec, w, accum);
  return cudaGetLastError();
}

// dx and dW of a window's rows (da the window's, local): dx by rows; the dW
// partials, n_chunks chunks of the window's rows, written in the call's
// first window and added to in the others, in the order they run.
template <typename T>
cudaError_t launch_window_products(const BwdArgs<T>& a, const T* da, const __nv_bfloat16* wih, T* dx, float* part,
                                   int n_chunks, Win w, bool first, cudaStream_t stream) {
  const long long n_rows = (long long)a.batch * w.tc, chunk_rows = (n_rows + n_chunks - 1) / n_chunks;
  cudaError_t err = launch_dx_any<T>(da, a.w_ih, wih, dx, n_rows, a.d, a.h, a.steps, w, stream);
  if (err != cudaSuccess) return err;
  if constexpr (is_bf16<T>) {
    return launch_dw_any_mma(da, a.x, a.y, part, n_rows, a.steps, chunk_rows, n_chunks, a.d, a.h, w, !first, stream);
  } else {
    const int g = 4 * a.h, kk = a.d + a.h;
    lstm_bwd_dw_any_kernel<true><<<dim3(n_chunks, (g + FT - 1) / FT, (kk + FT - 1) / FT), 256, 0, stream>>>(
        da, a.x, a.y, part, n_rows, a.steps, chunk_rows, a.d, a.h, w, !first);
    return cudaGetLastError();
  }
}

// A record holds dy and a pad beside the six derivatives: 32 bytes keep every
// record and every CTA's slice 16-byte aligned for the TMA and the float4
// reads, and dy in the ring spares the consumers a global load a step (read
// a step ahead instead, in six floats, it cost the bf16 recurrence up to 30
// registers, its second CTA an SM at R = 2 and 4, and up to twice its time).
constexpr int CREC = 8;               // floats of a (row, step, unit) record

// A (row, step, unit) record from its four gate pre-activations, c_{t-1}
// and dy (the derivatives lstm_bwd_rec's producers leave in their ring).
__device__ __forceinline__ void write_record(float* dst, float ai, float af, float ag, float ao, float c_prev,
                                             float dyv) {
  const float ig = sigmoid(ai), fg = sigmoid(af), gg = tanh_sig(ag), og = sigmoid(ao);
  const float tc = tanh_sig(fg * c_prev + ig * gg);
  reinterpret_cast<float4*>(dst)[0] = make_float4(gg * ig * (1.0f - ig), c_prev * fg * (1.0f - fg),
                                                  ig * (1.0f - gg * gg), tc * og * (1.0f - og));
  reinterpret_cast<float4*>(dst)[1] = make_float4(og * (1.0f - tc * tc), fg, dyv, 0.0f);
}

constexpr int GP_ROWS = 128;  // fp32 gate pass: (B*T) rows a block (and its 128 gate columns: 32 units)
constexpr int GP_K = 16;      // fp32 gate pass: terms staged a step

// fp32, over a window's rows (records local, x, y, c_{t-1}, dy global):
// block b = (row tile b / ub, unit block b % ub of 32 units), ub = ceil(h /
// 32), 128 rows x 128 gate columns (column 4 unit + gate); thread (rows 8
// (tid / 16) .., units 2 (tid % 16) and + 1): 8 x 8 sums, each step's 16
// terms of x_t | h_{t-1} and of the weights staged in shared memory (the
// next step's in registers meanwhile), one 16-byte load of each feeding 32
// products.  A sum is the bias, then x's terms and h's in order (the
// cluster path's records).  The unit blocks of one row tile are neighbours
// in the grid, so x and y are read from L2 for all but the first.  XP: the
// sums after x's terms into out (rows, 4h) instead of records (the wide
// forward's projection, and the first half of the wide C's gate pass).
template <bool XP>
__global__ void __launch_bounds__(256)
lstm_bwd_gates_f32_kernel(const BwdArgs<float> a, float* __restrict__ rec, Win w) {
  // [buf][k][column]: W row gate h + unit, term k; [buf][k][row]: x_t | h_{t-1}; rows padded
  // by 4 so that the transposing stores fall in distinct banks
  __shared__ __align__(16) float s_w[2][GP_K][GP_ROWS + 4];
  __shared__ __align__(16) float s_v[2][GP_K][GP_ROWS + 4];
  __shared__ int s_row[GP_ROWS];                          // -1 past the rows, 0 at t = 0, 1 else
  __shared__ long long s_gn[GP_ROWS];                     // a row's global row
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15, h = a.h, d = a.d, ub = (h + CU - 1) / CU;
  const int u0 = (int)(blockIdx.x % ub) * CU;
  const long long n0 = (long long)(blockIdx.x / ub) * GP_ROWS;
  const long long n_rows = (long long)a.batch * w.tc;
  if (tid < GP_ROWS) {
    s_row[tid] = n0 + tid < n_rows ? (int)has_prev<true>(n0 + tid, a.steps, w) : -1;
    s_gn[tid] = global_row<true>(n0 + tid, a.steps, w);
  }
  auto gn_of = [&](int r) { return s_gn[r]; };  // row r's global row
  const int kx = (d + GP_K - 1) / GP_K, n_steps = kx + (XP ? 0 : (h + GP_K - 1) / GP_K);  // x's steps, then h's
  // x | h_{t-1} 4 terms a load where every row of both is 16-byte aligned
  const bool vec = d % 4 == 0 && h % 4 == 0 && (uintptr_t)a.x % 16 == 0 && (uintptr_t)a.y % 16 == 0;
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int u = u0 + 2 * tc + c / 4;
    const float b = u < h ? a.bias[(c % 4) * h + u] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][c] = b;
  }
  float rw[8], rv[8];  // the next step's weights and x | h values of this thread
  auto fetch = [&](int s) {
    const bool xs = s < kx;
    const int k0 = (xs ? s : s - kx) * GP_K, len = xs ? d : h;
    const float* wm = xs ? a.w_ih : a.w_hh;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + 256 * q, k = e % GP_K, col = e / GP_K, u = u0 + col / 4;
      rw[q] = load_wm(wm, u < h, (size_t)((col % 4) * h + u), k0 + k, len);
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = tid + 256 * q, r = e / 4, k = k0 + 4 * (e % 4), row = s_row[r];
        const long long n = gn_of(r);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row >= 0 && k < len) {
          if (xs) v = *reinterpret_cast<const float4*>(a.x + n * d + k);
          else if (row) v = *reinterpret_cast<const float4*>(a.y + (n - 1) * h + k);
        }
        rv[4 * q] = v.x, rv[4 * q + 1] = v.y, rv[4 * q + 2] = v.z, rv[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = tid + 256 * q, k = k0 + e % GP_K, r = e / GP_K, row = s_row[r];
        const long long n = gn_of(r);
        float v = 0.0f;
        if (row >= 0 && k < len) {
          if (xs) v = a.x[n * d + k];
          else if (row) v = a.y[(n - 1) * h + k];
        }
        rv[q] = v;
      }
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + 256 * q;
      s_w[buf][e % GP_K][e / GP_K] = rw[q];
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = tid + 256 * q, r = e / 4, k = 4 * (e % 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) s_v[buf][k + i][r] = rv[4 * q + i];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = tid + 256 * q;
        s_v[buf][e % GP_K][e / GP_K] = rv[q];
      }
    }
  };
  __syncthreads();  // s_row
  fetch(0);
  put(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_steps) fetch(s + 1);
#pragma unroll
    for (int k = 0; k < GP_K; ++k) {
      const float4 w0 = *reinterpret_cast<const float4*>(&s_w[cur][k][8 * tc]);
      const float4 w1 = *reinterpret_cast<const float4*>(&s_w[cur][k][8 * tc + 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&s_v[cur][k][8 * tr]);
      const float4 v1 = *reinterpret_cast<const float4*>(&s_v[cur][k][8 * tr + 4]);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(wv[c], vv[i], acc[i][c]);
    }
    if (s + 1 < n_steps) put(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long n = n0 + 8 * tr + i;
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int u = u0 + 2 * tc + uu;
      if (n < n_rows && u < h) {
        if constexpr (XP) {
#pragma unroll
          for (int m = 0; m < 4; ++m) rec[(size_t)n * 4 * h + m * h + u] = acc[i][4 * uu + m];
        } else {
          const long long gn = gn_of(8 * tr + i);
          write_record(rec + ((size_t)n * h + u) * CREC, acc[i][4 * uu], acc[i][4 * uu + 1], acc[i][4 * uu + 2],
                       acc[i][4 * uu + 3], a.cprev[gn * h + u], a.dy[gn * h + u]);
        }
      }
    }
  }
}

// ---- The wide path's packed W_hh, and the gate passes of a window ----
//
// The wide path (lstm_wide.cu) tiles the hidden units by WU; its packed W_hh
// is also what the bf16 gate pass reads W_hh's columns from, on the wide path
// and the cluster path alike.
constexpr int WU = 16;          // hidden units a CTA of the wide path owns
constexpr int WROWS = 4 * WU;   // their gate rows
// Row pitches (elements of the operand type) of the staged operands, 16-byte
// rows whose fragment or quad reads fall in distinct banks: W_hh's rows (H
// terms, A / B) and columns (4H terms, C), and a staged chunk of kc terms.
template <typename T> __host__ __device__ constexpr int wide_pitch(int n) { return round_up(n, 16) + (is_bf16<T> ? 8 : 4); }
__host__ __device__ constexpr int n_cta(int h) { return (h + WU - 1) / WU; }
// Elements of the packed W_hh (every CTA's slice, in the operand type).
template <typename T> __host__ __device__ constexpr long long pack_elems(int bwd, int h) {
  return (long long)n_cta(h) * (bwd ? WU * wide_pitch<T>(4 * h) : WROWS * wide_pitch<T>(h));
}

// W_hh (4h, h) fp32 into each CTA's slice in the operand type (rounded to
// nearest even), zero past the real widths.  Forward: [cta][row][hp], row =
// ((u / 8) 2 + m / 2) 16 + (m % 2) 8 + u % 8 for unit u, gate m (a unit
// group's two mma tiles: i | f, g | o); backward: [cta][u][jp], the columns
// of the CTA's units.  Beside it, where wih_out is given, W_ih (4h, d) fp32
// rounded to bf16 as it is (bf16 C's dx).
template <typename T>
__global__ void __launch_bounds__(256) lstm_wide_pack_kernel(const float* __restrict__ w_hh, T* __restrict__ out, int h,
                                                             int bwd, const float* __restrict__ w_ih,
                                                             __nv_bfloat16* __restrict__ wih_out, int d) {
  const int pitch = bwd ? wide_pitch<T>(4 * h) : wide_pitch<T>(h), per = bwd ? WU : WROWS;
  const long long total = pack_elems<T>(bwd, h), n_ih = wih_out ? 4ll * h * d : 0;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < total + n_ih; i += (long long)gridDim.x * 256) {
    if (i >= total) {
      wih_out[i - total] = __float2bfloat16(w_ih[i - total]);
      continue;
    }
    const int k = (int)(i % pitch);
    const long long rowi = i / pitch;
    const int cta = (int)(rowi / per), rr = (int)(rowi % per);
    float v = 0.0f;
    if (bwd) {
      const int gu = cta * WU + rr;
      if (gu < h && k < 4 * h) v = w_hh[(size_t)k * h + gu];
    } else {
      const int u = (rr / 32) * 8 + rr % 8, m = ((rr / 16) % 2) * 2 + (rr % 16) / 8, gu = cta * WU + u;
      if (gu < h && k < h) v = w_hh[((size_t)m * h + gu) * h + k];
    }
    store_f(out + i, v);
  }
}

// W_hh packed (and, where wih_out is given, W_ih rounded to bf16) in one launch.
cudaError_t pack(const float* w_hh, void* out, int h, int bwd, bool bf16, const float* w_ih, void* wih_out, int d,
                 cudaStream_t stream) {
  const long long n = (bf16 ? pack_elems<__nv_bfloat16>(bwd, h) : pack_elems<float>(bwd, h)) +
                      (wih_out ? 4ll * h * d : 0);
  const unsigned blocks = (unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  if (bf16)
    lstm_wide_pack_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(w_hh, (__nv_bfloat16*)out, h, bwd, w_ih,
                                                                    (__nv_bfloat16*)wih_out, d);
  else
    lstm_wide_pack_kernel<float><<<blocks, 256, 0, stream>>>(w_hh, (float*)out, h, bwd, w_ih, (__nv_bfloat16*)wih_out, d);
  return cudaGetLastError();
}

// The bf16 gate pass of a window: C's records, and with XP = true A and B's
// input projection (the sums after x's terms into an fp32 (rows, 4H) tile,
// which their recurrence continues with h's).  A gate's sum is the bias, then
// x's k-tiles, then h's, in one m16n8k16 accumulator: the sums of the wide
// recurrence and of the cluster forward (lstm_fwd_cluster.cu's producer and
// consumer products), so C recomputes the forward's gates bit for bit on
// both paths, and one kernel gives the wide forward its projection.  A block owns 128 rows x 32 units (8 warps: 4 groups of 8 units x 2
// halves of 64 rows, so each weight fragment feeds 16 mma); x_t | h_{t-1}
// of its rows and the gate rows of W staged 32 terms a stage through
// stage_ring: W_ih's rows from its bf16 copy (wih, [j][k], A fragments by
// ldmatrix), W_hh's from the packed backward slices (wpack, [k][j], A
// fragments transposed by ldmatrix; unused with XP).  vec: D, H multiples of
// 8 and x, y, wih, wpack 16-byte aligned, else one value a load.
constexpr int GW_ROWS = 128;        // rows of the (B*T) axis a block
constexpr int GW_P = MK + 8;        // row pitch of a staged [rows][MK] tile (x | h, W_ih)
constexpr int GW_JP = CROWS + 8;    // row pitch of a staged [MK][128 gate rows] tile (W_hh)
constexpr int GW_STAGE = GW_ROWS * GW_P * 2 * (int)sizeof(__nv_bfloat16);  // x | h, then W (W_hh's [MK][GW_JP] fits)
constexpr int GW_SMEM = MS * GW_STAGE;

template <bool XP>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_gates_wide_mma_kernel(const BwdArgs<__nv_bfloat16> a, const __nv_bfloat16* __restrict__ wih,
                               const __nv_bfloat16* __restrict__ wpack, float* __restrict__ rec, Win w, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_row[GW_ROWS];         // -1 past the rows, 0 at t = 0, 1 else
  __shared__ long long s_gn[GW_ROWS];    // a row's global row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3, h = a.h, d = a.d;
  const int ub = (h + CU - 1) / CU, u0 = (int)(blockIdx.x % ub) * CU, ug = warp & 3, rh = warp >> 2;
  const int gu = u0 + ug * 8 + g8, jp = wide_pitch<__nv_bfloat16>(4 * h);
  const bool ok = gu < h;
  const long long n0 = (long long)(blockIdx.x / ub) * GW_ROWS, n_rows = (long long)a.batch * w.tc;
  if (tid < GW_ROWS) {
    s_row[tid] = n0 + tid < n_rows ? (int)has_prev<true>(n0 + tid, a.steps, w) : -1;
    s_gn[tid] = global_row<true>(n0 + tid, a.steps, w);
  }
  __syncthreads();
  const int ns_x = (d + MK - 1) / MK, ns = ns_x + (XP ? 0 : (h + MK - 1) / MK);  // x's stages, then h's
  auto buf_v = [&](int buf) { return reinterpret_cast<__nv_bfloat16*>(smem + (size_t)buf * GW_STAGE); };
  auto buf_w = [&](int buf) { return buf_v(buf) + GW_ROWS * GW_P; };
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  auto stage = [&](long long st, int buf) {
    const bool xs = st < ns_x;
    const int k0 = (int)(xs ? st : st - ns_x) * MK, len = xs ? d : h;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = tid + 256 * e;
      {  // x_t | h_{t-1}: 128 rows x 4 pieces
        const int r = p >> 2, k = k0 + (p & 3) * 8, row = s_row[r];
        const long long gn = s_gn[r];
        const __nv_bfloat16* src = xs ? a.x + gn * d + k : a.y + (gn - 1) * h + k;
        const bool live = row >= 0 && (xs || row);
        put8(buf_v(buf) + r * GW_P + (p & 3) * 8, src, live && k < len, vec,
             [&](int i) { return live && k + i < len ? src[i] : zero; });
      }
      if (xs) {  // W_ih's gate rows [m 32 + unit][k]: 128 rows x 4 pieces
        const int jj = p >> 2, k = k0 + (p & 3) * 8, u = u0 + (jj & 31);
        const __nv_bfloat16* src = wih + ((size_t)(jj >> 5) * h + u) * d + k;
        put8(buf_w(buf) + jj * GW_P + (p & 3) * 8, src, u < h && k < d, vec,
             [&](int i) { return u < h && k + i < d ? src[i] : zero; });
      } else {  // W_hh's [k][m 32 + unit] from the packed columns: 32 terms x 16 pieces
        const int kr = p >> 4, q = p & 15, k = k0 + kr, u = u0 + (q & 3) * 8;
        const __nv_bfloat16* src = wpack + (size_t)k * jp + (q >> 2) * h + u;
        put8(buf_w(buf) + kr * GW_JP + (q >> 2) * 32 + (q & 3) * 8, src, k < h && u < h, vec,
             [&](int i) { return k < h && u + i < h ? src[i] : zero; });
      }
    }
  };
  float acc[8][2][4];
  {
    float b4[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) b4[m] = ok ? a.bias[m * h + gu] : 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][0][e] = b4[e / 2], acc[nt][1][e] = b4[2 + e / 2];
  }
  const int blk = lane >> 3, blk_row = lane & 7;
  long long st_now = 0;  // the stage mul multiplies (stage_ring calls mul once a stage, in order)
  auto mul = [&](int buf) {
    const bool xs = st_now < ns_x;
    const int k0 = (int)(xs ? st_now : st_now - ns_x) * MK, len = xs ? d : h;
    ++st_now;
    const __nv_bfloat16* v = buf_v(buf);
    const __nv_bfloat16* wt = buf_w(buf);
#pragma unroll
    for (int ks = 0; ks < MK / 16; ++ks) {
      if (k0 + ks * 16 >= len) break;
      uint32_t af[2][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        if (xs)  // rows gate 2 tile (lanes 0-7, 16-23) and 2 tile + 1 (8-15, 24-31) of the group's units
          ldmatrix_x4(af[tile], wt + ((2 * tile + (blk & 1)) * 32 + ug * 8 + blk_row) * GW_P + ks * 16 + (blk >> 1) * 8);
        else
          ldmatrix_x4_trans(af[tile], wt + (ks * 16 + (blk >> 1) * 8 + blk_row) * GW_JP + (2 * tile + (blk & 1)) * 32 +
                                          ug * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // n-tiles 2 np and 2 np + 1: B[k][n] = v[n][k]
        ldmatrix_x4(b, v + (rh * 64 + np * 16 + (blk >> 1) * 8 + blk_row) * GW_P + ks * 16 + (blk & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[2 * np + i][0], af[0], b[2 * i], b[2 * i + 1]);
          mma_bf16(acc[2 * np + i][1], af[1], b[2 * i], b[2 * i + 1]);
        }
      }
    }
  };
  stage_ring(ns, stage, mul);
  if (!ok) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rh * 64 + nt * 8 + 2 * t4 + e;
      const long long n = n0 + r;
      if (n >= n_rows) continue;
      if constexpr (XP) {
        float* o = rec + (size_t)n * 4 * h + gu;
        o[0] = acc[nt][0][e], o[h] = acc[nt][0][2 + e], o[2 * h] = acc[nt][1][e], o[3 * h] = acc[nt][1][2 + e];
      } else {
        const long long gn = s_gn[r];
        write_record(rec + ((size_t)n * h + gu) * CREC, acc[nt][0][e], acc[nt][0][2 + e], acc[nt][1][e],
                     acc[nt][1][2 + e], a.cprev[gn * h + gu], __bfloat162float(a.dy[gn * h + gu]));
      }
    }
}

// The wide recurrence's fp32 order of a gate's h product (lstm_wide.cu's
// fp32 A and B, and the wide C's gate pass below): h's round_up(H, 16) terms
// (zeros past H) as quads, quad q to segment q % QSEGS; each segment one
// running sum from 0 over its quads in order (dot_quad); the four sums meet
// as (s0 + s2) + (s1 + s3) (quad_sum); the gate is xp + that, xp the sum of
// the bias and x's terms in order (the XP gate pass).  Four lanes of a warp
// carry the four segments of the same sums, whatever the chunk of h staged.
constexpr int QSEGS = 4;

// Lanes 4 g .. 4 g + 3 (segment lane % 4) each hold their parts of N sums in
// v; leaves the whole sums in the fixed order (p0 + p2) + (p1 + p3): for N >=
// 4 those of sums s N / 4 .. s N / 4 + N / 4 - 1 in v[0 ..] of lane s (a
// reduce-scatter: a lane sends the half its partner keeps), for N = 2 sum s /
// 2 on lane s, for N = 1 the sum on every lane.
template <int N>
__device__ __forceinline__ void quad_sum(float (&v)[N], int lane) {
  if constexpr (N >= 2) {
    const bool hi = lane & 2;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = hi ? v[i] : v[i + N / 2], keep = hi ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  }
  if constexpr (N >= 4) {
    const bool lo = lane & 1;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float send = lo ? v[i] : v[i + N / 4], keep = lo ? v[i + N / 4] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  }
}

// 4 fp32 into shared memory: 16 bytes by cp.async where vec and the source
// lies within the operand (ok), zeros where it does not; one at a time from
// get(i) where not vec.
template <typename Get>
__device__ __forceinline__ void put4(float* dst, const float* src, bool ok, bool vec, Get get) {
  if (vec) {
    if (ok) cp_async16(dst, src);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = get(i);
  }
}

// The wide C's fp32 gate pass, its h half: gate = xp + h's product in the
// wide recurrence's order, xp (rows, 4h) the XP pass's sums (the window's da
// scratch).  A block owns 64 rows x 16 units (64 gate columns, slot c = gate
// c / 16 of unit u0 + c % 16); warp w rows 8 w .., lane group g = lane / 4
// the slots g + 8 j, each lane its segment of an 8 x 8 tile, so one 16-byte
// load of W_hh (a row per slot) or h_{t-1} (the warp's groups read the same
// one) feeds 8 x 4 products.  h and W_hh staged 32 terms a stage through
// stage_ring (GS_P: two neighbouring rows' 64-byte quad reads in distinct
// banks); two blocks an SM (96 KB of shared memory and at most 128
// registers each: W_hh's quads are loaded one slot at a time).  Then the sums
// into shared memory and the records out; RAW (a check build only): the
// gates into out (rows, 4h).  vec: H a multiple of 4 and y, W_hh 16-byte
// aligned, else one value a load.
constexpr int GS_T = 64;            // rows, and gate columns, of a block
constexpr int GS_K = 32;            // terms staged a stage
constexpr int GS_P = GS_K + 16;     // row pitch (floats) of a staged tile
constexpr int GS_SMEM = (int)sizeof(float) * MS * 2 * GS_T * GS_P;

template <bool RAW>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_gates_f32_split_kernel(const BwdArgs<float> a, const float* __restrict__ xp, float* __restrict__ out, Win w,
                                int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_row[GS_T];        // -1 past the rows, 0 at t = 0, 1 else
  __shared__ long long s_gn[GS_T];   // a row's global row
  float* s_v = reinterpret_cast<float*>(smem);  // [MS][GS_T][GS_P]: h_{t-1} of the block's rows
  float* s_w = s_v + MS * GS_T * GS_P;          // [MS][GS_T][GS_P]: W_hh's row of each slot
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = lane >> 2, seg = lane & 3, h = a.h;
  const int ub = n_cta(h), u0 = (int)(blockIdx.x % ub) * WU;
  const long long n0 = (long long)(blockIdx.x / ub) * GS_T, n_rows = (long long)a.batch * w.tc;
  if (tid < GS_T) {
    s_row[tid] = n0 + tid < n_rows ? (int)has_prev<true>(n0 + tid, a.steps, w) : -1;
    s_gn[tid] = global_row<true>(n0 + tid, a.steps, w);
  }
  __syncthreads();
  const int kq = round_up(h, 16);  // h's terms with the zeros of its last k-tile
  auto stage = [&](long long st, int buf) {
    const int k0 = (int)st * GS_K;
#pragma unroll
    for (int e = 0; e < GS_T * GS_K / 4 / 256; ++e) {  // 16-byte pieces of each operand, GS_K / 4 a row
      const int p = tid + 256 * e, r = p / (GS_K / 4), c = (p % (GS_K / 4)) * 4, k = k0 + c;
      const bool live = s_row[r] > 0;  // a row with an h_{t-1}
      const float* hs = a.y + (s_gn[r] - 1) * h + k;
      put4(s_v + ((size_t)buf * GS_T + r) * GS_P + c, hs, live && k < h, vec,
           [&](int i) { return live && k + i < h ? hs[i] : 0.0f; });
      const int u = u0 + (r & 15);
      const float* ws = a.w_hh + ((size_t)(r >> 4) * h + u) * h + k;
      put4(s_w + ((size_t)buf * GS_T + r) * GS_P + c, ws, u < h && k < h, vec,
           [&](int i) { return u < h && k + i < h ? ws[i] : 0.0f; });
    }
  };
  float acc[GS_T] = {};  // [8 i + j]: row 8 warp + i, slot grp + 8 j, this lane's segment
  long long st_now = 0;
  auto mul = [&](int buf) {
    const int k0 = (int)(st_now++) * GS_K;
    const float* vb = s_v + ((size_t)buf * GS_T + 8 * warp) * GS_P;
    const float* wb = s_w + ((size_t)buf * GS_T + grp) * GS_P;
#pragma unroll
    for (int qq = 0; qq < GS_K / 16; ++qq) {
      if (k0 + 16 * qq >= kq) break;  // the quads past round_up(h, 16): none in the recurrence
      const int q = seg + 4 * qq;
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = *reinterpret_cast<const float4*>(vb + (size_t)i * GS_P + 4 * q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 wq = *reinterpret_cast<const float4*>(wb + (size_t)8 * j * GS_P + 4 * q);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot_quad(acc[8 * i + j], wq.x, wq.y, wq.z, wq.w, v[i]);
      }
    }
  };
  stage_ring((kq + GS_K - 1) / GS_K, stage, mul);
  quad_sum(acc, lane);  // lane s: rows 8 warp + 2 s, + 1, slots grp + 8 j
  __syncthreads();      // every warp past the ring: its first buffer takes the gates
  float* s_pre = s_v;   // [GS_T][GS_T + 1]: row, slot
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = 8 * warp + 2 * seg + e / 8, c = grp + 8 * (e % 8), u = u0 + (c & 15);
    const long long n = n0 + r;
    if (n >= n_rows || u >= h) continue;
    const float pre = xp[(size_t)n * 4 * h + (size_t)(c >> 4) * h + u] + acc[e];
    if constexpr (RAW) out[(size_t)n * 4 * h + (size_t)(c >> 4) * h + u] = pre;
    else s_pre[r * (GS_T + 1) + c] = pre;
  }
  if constexpr (!RAW) {
    __syncthreads();
    for (int i = tid; i < GS_T * WU; i += 256) {
      const int r = i / WU, uu = i % WU, u = u0 + uu;
      const long long n = n0 + r;
      if (n >= n_rows || u >= h) continue;
      const float* p = s_pre + r * (GS_T + 1) + uu;
      const long long gn = s_gn[r];
      write_record(out + ((size_t)n * h + u) * CREC, p[0], p[16], p[32], p[48], a.cprev[gn * h + u], a.dy[gn * h + u]);
    }
  }
}

// The gate pass over one window: with XP the forward's projection (the sums
// after x's terms) into out (rows, 4h), else C's records into out.  bf16 on
// the tensor cores, W_ih from wih and W_hh from wpack (the packed backward
// slices).  fp32 on the CUDA cores: SPLIT = false (the cluster path's C)
// sums h's terms in order after x's; SPLIT = true (the wide path's C, whose
// forward sums h in segments) first the x sums into xp (rows, 4h: the
// window's da scratch, which the recurrence then overwrites), then h's in
// the wide recurrence's order.
template <typename T, bool XP, bool SPLIT = false>
cudaError_t gate_pass(const BwdArgs<T>& a, const void* wih, const void* wpack, float* out, float* xp, Win w,
                      cudaStream_t stream) {
  const long long n_rows = (long long)a.batch * w.tc, unit_blocks = (a.h + CU - 1) / CU;
  if constexpr (is_bf16<T>) {
    static SmemOnce once;
    const cudaError_t err = once.set(lstm_bwd_gates_wide_mma_kernel<XP>, GW_SMEM);
    if (err != cudaSuccess) return err;
    const int vec = a.d % 8 == 0 && a.h % 8 == 0 && aligned16(a.x) && aligned16(a.y) && aligned16(wih) &&
                    aligned16(wpack);
    lstm_bwd_gates_wide_mma_kernel<XP><<<(unsigned)(unit_blocks * ((n_rows + GW_ROWS - 1) / GW_ROWS)), 256, GW_SMEM,
                                         stream>>>(a, (const T*)wih, (const T*)wpack, out, w, vec);
  } else if constexpr (SPLIT && !XP) {
    lstm_bwd_gates_f32_kernel<true>
        <<<(unsigned)(unit_blocks * ((n_rows + GP_ROWS - 1) / GP_ROWS)), 256, 0, stream>>>(a, xp, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    static SmemOnce once;
    if ((err = once.set(lstm_bwd_gates_f32_split_kernel<false>, GS_SMEM)) != cudaSuccess) return err;
    const int vec = a.h % 4 == 0 && aligned16(a.y) && aligned16(a.w_hh);
    lstm_bwd_gates_f32_split_kernel<false><<<(unsigned)(n_cta(a.h) * ((n_rows + GS_T - 1) / GS_T)), 256, GS_SMEM,
                                             stream>>>(a, xp, out, w, vec);
  } else {
    lstm_bwd_gates_f32_kernel<XP>
        <<<(unsigned)(unit_blocks * ((n_rows + GP_ROWS - 1) / GP_ROWS)), 256, 0, stream>>>(a, out, w);
  }
  return cudaGetLastError();
}

}  // namespace
