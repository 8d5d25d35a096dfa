// The runtime-width kernels of kernel C, shared by lstm_bwd.cu (the masked
// and cluster paths) and lstm_wide.cu (the wide path, max(D, H) > 256):
// the gate pass (lstm_bwd_gates_{f32,bf16}_kernel, lstm_bwd.cu's "widths
// above 64" has its design), dx, dW and the ordered sum at runtime D and H.
//
// Each product runs over rows of the flattened (B*T) axis.  WIN = false: all
// of them, row n is (row n / T, step n % T), the code lstm_bwd.cu's paths
// had before the wide path.  WIN = true: a window of w.tc steps from step
// w.t0 of every batch row (the wide path works in windows of time, so that
// its scratch does not grow with T): local row n = b tc + s is global row
// b T + t0 + s, the scratch (records, da, xp) is indexed by the local row and
// x, y, c_{t-1}, dy and dx by the global one; h_{t-1} = y of the global row
// before, zero at t0 + s = 0.  The wide path's plan keeps B tc below 2^31,
// so a local row is an int.  The gate pass with XP = true stops after x's
// terms and writes the sums, bias then x's terms in order, to an fp32 (rows,
// 4H) tile: the wide forward's input projection, which its recurrence
// continues with h's terms in the gate pass's order (so kernel C recomputes
// the forward's gates bit for bit in both types).

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
// The four-launch path's products for a call whose widths are not a
// capacity's square (D != H, or a width other than 16, 32, 64; and every
// call above 64): G = 4 H gate columns, K = D + H terms, tails masked, the
// reduction's terms in order (two runs give the same bits).  fp32 stays
// fp32 (CUDA cores, no TF32): dx in tiles of 64 x 64 outputs, 4 x 4 a
// thread; dW in tiles of 128 x 128, 8 x 8 a thread.  bf16 on the tensor
// cores (below): da is bf16 already and W_ih is rounded as it is staged, so
// every product is exact in fp32 and sums in fp32.
constexpr int AT = 64;   // outputs of a tile's side
constexpr int AK = 16;   // fp32 dx: gate columns staged per step
constexpr int AN = 32;   // dW: rows of the (B*T) axis staged per step

// fp32: dx[n][k] = sum_j da[n][j] W_ih[j][k], j < 4h, k < d.  Grid (ceil(rows / 64), ceil(d / 64)).
// WIN: da's rows are the window's, dx's the global rows.
template <bool WIN>
__global__ void __launch_bounds__(256)
lstm_bwd_dx_any_kernel(const float* __restrict__ da, const float* __restrict__ w_ih, float* __restrict__ dx,
                       long long n_rows, int d, int h, long long steps, Win w) {
  __shared__ __align__(16) float s_a[AK][AT + 4];  // [j][n]
  __shared__ __align__(16) float s_w[AK][AT + 4];  // [j][k]
  const int g = 4 * h, tid = threadIdx.x, tn = tid / 16, tk = tid % 16;
  const long long n0 = (long long)blockIdx.x * AT;
  const int k0 = blockIdx.y * AT;
  float acc[4][4] = {};
  for (int j0 = 0; j0 < g; j0 += AK) {
    __syncthreads();
    for (int i = tid; i < AK * AT; i += 256) {
      const int jj = i % AK, nn = i / AK;  // da is row-major in n: consecutive threads take consecutive j
      const long long n = n0 + nn;
      s_a[jj][nn] = n < n_rows && j0 + jj < g ? da[n * g + j0 + jj] : 0.0f;
      const int kk = i % AT, jw = i / AT;
      s_w[jw][kk] = load_wm(w_ih, j0 + jw < g, (size_t)(j0 + jw), k0 + kk, d);
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < AK; ++jj) {
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
      if (n < n_rows && k < d) dx[global_row<WIN>(n, steps, w) * d + k] = acc[i][q];
    }
}

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

// bf16: dx and dW at runtime widths on the tensor cores (bf16 in, exact
// products, fp32 sums), the square kernels' mma tiles with the edge tiles
// zero-masked.  Tiles of 64 x 64 outputs again; the reduction's tiles in
// order, so two runs give the same bits.
constexpr int AMP = AT + 8;  // row pitch (bf16) of a staged tile: 8 rows' fragments in distinct banks
constexpr int AXM = 128;     // dx: rows of the (B*T) axis a block, 16 a warp

// 4 bf16 of row-major (rows, g) da at (n, j), zero past the rows or g (g and
// j are multiples of 4: one 8-byte load or none).
__device__ __forceinline__ uint2 load_da4(const __nv_bfloat16* da, long long n, long long n_end, int j, int g) {
  return n < n_end && j < g ? *reinterpret_cast<const uint2*>(da + n * g + j) : make_uint2(0u, 0u);
}

// dx[n][k] = sum_j da[n][j] W_ih[j][k]: M = 16 rows a warp, N = 8 inputs a
// tile (8 tiles: 64 inputs), K = the gate columns, 64 staged a step.  Grid
// (ceil(rows / 128), ceil(d / 64)).  WIN: as lstm_bwd_dx_any_kernel's.
template <bool WIN>
__global__ void __launch_bounds__(256)
lstm_bwd_dx_any_mma_kernel(const __nv_bfloat16* __restrict__ da, const float* __restrict__ w_ih,
                           __nv_bfloat16* __restrict__ dx, long long n_rows, int d, int h, long long steps, Win w) {
  __shared__ __align__(16) __nv_bfloat16 s_a[AXM * AMP];  // [n][j]
  __shared__ __align__(16) __nv_bfloat16 s_w[AT * AMP];   // [k][j]: W_ih transposed, B fragments' k adjacent
  const int g = 4 * h, tid = threadIdx.x, warp = tid >> 5, g8 = (tid & 31) >> 2, t4 = tid & 3;
  const long long n0 = (long long)blockIdx.x * AXM;
  const int k0 = blockIdx.y * AT;
  float c[AT / 8][4] = {};
  for (int j0 = 0; j0 < g; j0 += AT) {
    __syncthreads();
    for (int i = tid; i < AXM * (AT / 4); i += 256) {
      const int r = i / (AT / 4), q = i % (AT / 4);
      *reinterpret_cast<uint2*>(s_a + r * AMP + 4 * q) = load_da4(da, n0 + r, n_rows, j0 + 4 * q, g);
    }
    for (int i = tid; i < AT * AT; i += 256) {
      const int kk = i % AT, jj = i / AT;  // consecutive threads read consecutive k of a row of W_ih
      s_w[kk * AMP + jj] = __float2bfloat16(load_wm(w_ih, j0 + jj < g, (size_t)(j0 + jj), k0 + kk, d));
    }
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < AT / 16; ++kt) {
      if (j0 + kt * 16 >= g) break;
      const __nv_bfloat16* a_lo = s_a + (warp * 16 + g8) * AMP + kt * 16 + 2 * t4;
      const uint32_t a[4] = {ld32(a_lo), ld32(a_lo + 8 * AMP), ld32(a_lo + 8), ld32(a_lo + 8 * AMP + 8)};
#pragma unroll
      for (int nt = 0; nt < AT / 8; ++nt) {
        const __nv_bfloat16* b = s_w + (nt * 8 + g8) * AMP + kt * 16 + 2 * t4;
        mma_bf16(c[nt], a, ld32(b), ld32(b + 8));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < AT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long n = n0 + warp * 16 + g8 + (e >> 1) * 8;
      const int k = k0 + nt * 8 + 2 * t4 + (e & 1);
      if (n < n_rows && k < d) dx[global_row<WIN>(n, steps, w) * d + k] = __float2bfloat16(c[nt][e]);
    }
}

// part[chunk][j][m] = sum over the chunk's rows n of da[n][j] v[n][m], v = [x
// | h_{t-1}]: M = 16 gate columns a warp (4 tiles), N = 32 terms a warp (two
// halves), K = the rows, 32 staged a step; both operands row-major in the
// rows, both fragments transposed through ldmatrix (lstm_bwd_dw_mma_kernel's
// products).  Grid (n_chunks, ceil(4h / 64), ceil((d + h) / 64)).
// vec: x and y 16-byte aligned and D, H multiples of 8 (x | h_{t-1} staged 8
// values a load), else one value a load.  WIN, accum: as lstm_bwd_dw_any_kernel's.
template <bool WIN>
__global__ void __launch_bounds__(256)
lstm_bwd_dw_any_mma_kernel(const __nv_bfloat16* __restrict__ da, const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ y, float* __restrict__ part, long long n_rows,
                           int steps, long long chunk_rows, int d, int h, int vec, Win w, int accum) {
  __shared__ __align__(16) __nv_bfloat16 s_a[AN * AMP];  // [n][j]
  __shared__ __align__(16) __nv_bfloat16 s_v[AN * AMP];  // [n][m]
  __shared__ int s_row[AN];  // a staged row: -1 past the chunk, 0 at t = 0 (h_{t-1} = 0), 1 else
  __shared__ long long s_gn[WIN ? AN : 1];  // WIN: a staged row's global row
  const int g = 4 * h, kk = d + h, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.y * AT, m0 = blockIdx.z * AT, wj = (warp & 3) * 16, wm = (warp >> 2) * 32;
  const long long begin = blockIdx.x * chunk_rows;
  const long long end = begin + chunk_rows < n_rows ? begin + chunk_rows : n_rows;
  const int blk = lane >> 3, blk_row = lane & 7;  // ldmatrix: this lane's block and row in it
  float c[4][4] = {};
  for (long long base = begin; base < end; base += AN) {
    __syncthreads();
    if (tid < AN) {
      s_row[tid] = base + tid < end ? (int)has_prev<WIN>(base + tid, steps, w) : -1;
      if constexpr (WIN) s_gn[tid] = global_row<WIN>(base + tid, steps, w);
    }
    __syncthreads();
    for (int i = tid; i < AN * (AT / 4); i += 256) {
      const int r = i / (AT / 4), q = i % (AT / 4);
      *reinterpret_cast<uint2*>(s_a + r * AMP + 4 * q) = load_da4(da, base + r, end, j0 + 4 * q, g);
    }
    if (vec) {
      for (int i = tid; i < AN * (AT / 8); i += 256) {
        const int r = i / (AT / 8), m = m0 + 8 * (i % (AT / 8)), row = s_row[r];
        const long long n = WIN ? s_gn[WIN ? r : 0] : base + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row >= 0 && m < kk) {
          if (m < d) v = *reinterpret_cast<const uint4*>(x + n * d + m);
          else if (row) v = *reinterpret_cast<const uint4*>(y + (n - 1) * h + (m - d));
        }
        *reinterpret_cast<uint4*>(s_v + r * AMP + (m - m0)) = v;
      }
    } else {
      for (int i = tid; i < AN * AT; i += 256) {
        const int r = i / AT, mm = i % AT, m = m0 + mm, row = s_row[r];
        const long long n = WIN ? s_gn[WIN ? r : 0] : base + r;
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (row >= 0 && m < kk) {
          if (m < d) v = x[n * d + m];
          else if (row) v = y[(n - 1) * h + (m - d)];
        }
        s_v[r * AMP + mm] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < AN / 16; ++ks) {
      uint32_t a[4];  // A[j][n] = da[n][j]
      ldmatrix_x4_trans(a, s_a + (ks * 16 + (blk >> 1) * 8 + blk_row) * AMP + wj + (blk & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];  // B[n][m] = v[n][m]
        ldmatrix_x4_trans(b, s_v + (ks * 16 + (blk & 1) * 8 + blk_row) * AMP + wm + np * 16 + (blk >> 1) * 8);
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  float* out = part + (size_t)blockIdx.x * g * kk;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + wj + g8 + (e >> 1) * 8, m = m0 + wm + nt * 8 + 2 * t4 + (e & 1);
      if (j < g && m < kk) out[(size_t)j * kk + m] = WIN && accum ? out[(size_t)j * kk + m] + c[nt][e] : c[nt][e];
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

// fp32: block b = (row tile b / ub, unit block b % ub of 32 units), ub =
// ceil(h / 32), 128 rows x 128 gate columns (column 4 unit + gate); thread
// (rows 8 (tid / 16) .., units 2 (tid % 16) and + 1): 8 x 8 sums, each
// step's 16 terms of x_t | h_{t-1} and of the weights staged in shared
// memory (the next step's in registers meanwhile), one 16-byte load of
// each feeding 32 products.  A sum is the bias, then x's terms and h's in
// order.  The unit blocks of one row tile are neighbours in the grid, so x
// and y are read from L2 for all but the first.  WIN: the window's rows
// (records local); XP: the sums after x's terms into out (rows, 4h) instead
// of records.
template <bool WIN, bool XP>
__global__ void __launch_bounds__(256)
lstm_bwd_gates_f32_kernel(const BwdArgs<float> a, float* __restrict__ rec, Win w) {
  // [buf][k][column]: W row gate h + unit, term k; [buf][k][row]: x_t | h_{t-1}; rows padded
  // by 4 so that the transposing stores fall in distinct banks
  __shared__ __align__(16) float s_w[2][GP_K][GP_ROWS + 4];
  __shared__ __align__(16) float s_v[2][GP_K][GP_ROWS + 4];
  __shared__ int s_row[GP_ROWS];                          // -1 past the rows, 0 at t = 0, 1 else
  __shared__ long long s_gn[WIN ? GP_ROWS : 1];           // WIN: a row's global row
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15, h = a.h, d = a.d, ub = (h + CU - 1) / CU;
  const int u0 = (int)(blockIdx.x % ub) * CU;
  const long long n0 = (long long)(blockIdx.x / ub) * GP_ROWS;
  const long long n_rows = (long long)a.batch * (WIN ? w.tc : a.steps);
  if (tid < GP_ROWS) {
    s_row[tid] = n0 + tid < n_rows ? (int)has_prev<WIN>(n0 + tid, a.steps, w) : -1;
    if constexpr (WIN) s_gn[tid] = global_row<WIN>(n0 + tid, a.steps, w);
  }
  auto gn_of = [&](int r) { return WIN ? s_gn[WIN ? r : 0] : n0 + r; };  // row r's global row
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

constexpr int GPM_ROWS = 64;  // bf16 gate pass: (B*T) rows a block (8 mma tiles)
constexpr int GPM_K = 64;     // bf16 gate pass: terms staged a step (4 k-tiles)

// bf16: block b = (row tile b / ub, unit block b % ub of 32 units), 4 warps of
// 8 units (tile 0 gates i and f, tile 1 g and o, lstm_common.cuh), the rows
// the tiles' N: the forward's producer and consumer products, one
// accumulator from the bias through x's k-tiles and h's.  WIN, XP: as
// lstm_bwd_gates_f32_kernel's.
template <bool WIN, bool XP>
__global__ void __launch_bounds__(128)
lstm_bwd_gates_bf16_kernel(const BwdArgs<__nv_bfloat16> a, float* __restrict__ rec, Win w) {
  __shared__ __align__(16) __nv_bfloat16 s_v[GPM_ROWS][GPM_K + 8];  // [row][k]: x_t | h_{t-1}
  __shared__ int s_row[GPM_ROWS];                                    // -1 past the rows, 0 at t = 0, 1 else
  __shared__ long long s_gn[WIN ? GPM_ROWS : 1];                     // WIN: a row's global row
  const int tid = threadIdx.x, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3, h = a.h, d = a.d;
  const int ub = (h + CU - 1) / CU, gu = (int)(blockIdx.x % ub) * CU + (tid >> 5) * 8 + g8;
  const bool ok = gu < h;
  const long long n0 = (long long)(blockIdx.x / ub) * GPM_ROWS;
  const long long n_rows = (long long)a.batch * (WIN ? w.tc : a.steps);
  if (tid < GPM_ROWS) {
    s_row[tid] = n0 + tid < n_rows ? (int)has_prev<WIN>(n0 + tid, a.steps, w) : -1;
    if constexpr (WIN) s_gn[tid] = global_row<WIN>(n0 + tid, a.steps, w);
  }
  auto gn_of = [&](int r) { return WIN ? s_gn[WIN ? r : 0] : n0 + r; };  // row r's global row
  // x | h_{t-1} 8 values a load where every row of both is 16-byte aligned
  const bool vec = d % 8 == 0 && h % 8 == 0 && (uintptr_t)a.x % 16 == 0 && (uintptr_t)a.y % 16 == 0;
  float acc[GPM_ROWS / 8][2][4];
  {
    float b4[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) b4[m] = ok ? a.bias[m * h + gu] : 0.0f;
#pragma unroll
    for (int nt = 0; nt < GPM_ROWS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][0][e] = b4[e / 2], acc[nt][1][e] = b4[2 + e / 2];
  }
  for (int sec = 0; sec < (XP ? 1 : 2); ++sec) {
    const int len = sec == 0 ? d : h;
    const float* wm = sec == 0 ? a.w_ih : a.w_hh;
    for (int k0 = 0; k0 < len; k0 += GPM_K) {
      __syncthreads();
      if (vec) {
        for (int i = tid; i < GPM_ROWS * GPM_K / 8; i += 128) {
          const int k = 8 * (i % (GPM_K / 8)), r = i / (GPM_K / 8), row = s_row[r];
          const long long n = gn_of(r);
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row >= 0 && k0 + k < len) {
            if (sec == 0) v = *reinterpret_cast<const uint4*>(a.x + n * d + k0 + k);
            else if (row) v = *reinterpret_cast<const uint4*>(a.y + (n - 1) * h + k0 + k);
          }
          *reinterpret_cast<uint4*>(&s_v[r][k]) = v;
        }
      } else {
        for (int i = tid; i < GPM_ROWS * GPM_K; i += 128) {
          const int k = i % GPM_K, r = i / GPM_K, row = s_row[r];
          const long long n = gn_of(r);
          __nv_bfloat16 v = __float2bfloat16(0.0f);
          if (row >= 0 && k0 + k < len) {
            if (sec == 0) v = a.x[n * d + k0 + k];
            else if (row) v = a.y[(n - 1) * h + k0 + k];
          }
          s_v[r][k] = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < GPM_K / 16; ++kt) {
        const int k = k0 + kt * 16 + 2 * t4;
        if (k0 + kt * 16 >= len) break;
        uint32_t af[2][4];
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          const size_t lo = (size_t)(2 * tile * h + gu), hi = lo + h;
          af[tile][0] = load_w2m(wm, ok, lo, k, len);
          af[tile][1] = load_w2m(wm, ok, hi, k, len);
          af[tile][2] = load_w2m(wm, ok, lo, k + 8, len);
          af[tile][3] = load_w2m(wm, ok, hi, k + 8, len);
        }
#pragma unroll
        for (int nt = 0; nt < GPM_ROWS / 8; ++nt) {
          const __nv_bfloat16* v = &s_v[nt * 8 + g8][kt * 16 + 2 * t4];
          const uint32_t b0 = ld32(v), b1 = ld32(v + 8);
          mma_bf16(acc[nt][0], af[0], b0, b1);
          mma_bf16(acc[nt][1], af[1], b0, b1);
        }
      }
    }
  }
  if (!ok) return;
#pragma unroll
  for (int nt = 0; nt < GPM_ROWS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long n = n0 + nt * 8 + 2 * t4 + e;
      if (n < n_rows) {
        if constexpr (XP) {
          float* o = rec + (size_t)n * 4 * h + gu;
          o[0] = acc[nt][0][e], o[h] = acc[nt][0][2 + e], o[2 * h] = acc[nt][1][e], o[3 * h] = acc[nt][1][2 + e];
        } else {
          const long long gn = gn_of(nt * 8 + 2 * t4 + e);
          write_record(rec + ((size_t)n * h + gu) * CREC, acc[nt][0][e], acc[nt][0][2 + e], acc[nt][1][e],
                       acc[nt][1][2 + e], a.cprev[gn * h + gu], __bfloat162float(a.dy[gn * h + gu]));
        }
      }
    }
}

}  // namespace
