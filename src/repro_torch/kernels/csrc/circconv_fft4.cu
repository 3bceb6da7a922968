// C3-SL's HRR codec kernels for Hopper (sm_90a) in the four-step FFT form:
// bind+superpose and unbind for every D = 2^a 3^b 5^c past shared memory
// (16384 < D <= 2^22) that splits into two sub-transforms of at most 2048
// points, each a multiple of 4; three launches through device memory.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/circconv.py at those D:
//   circconv_fft4_bind_superpose  <- bind_superpose_kernel (:134, body _bind_kernel)
//   circconv_fft4_unbind          <- unbind_kernel         (:157, body _unbind_kernel)
//
//   bind:    S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
//   unbind:  Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]
//
// Same operands as circconv_fft.cu and circconv.cu: data (Z, S, outputs)
// float32 or bfloat16; the keys enter as their spectra, made once per key
// tensor by circconv_fft4_key_spectra from Kext = [K || K] (R, 2D) float32
// (the wrapper keeps them while the keys are unchanged).  Data is converted
// to float32 on load, every operation is float32, and the output is
// rounded once.
//
// Bound on this card.  The function's least work is its bytes: at (G, R, D)
// = (4, 4, 655360), the LM training path's shape for qwen2.5-32b (B 16, S
// 128, R 4, D = S d_model), Z 41.9 MB + K 10.5 MB + S 10.5 MB = 62.9 MB
// cross HBM once, 18.8 us at 3.35 TB/s (15.0 us for 50.3 MB at 524288,
// 45.1 us for 151.0 MB at 1572864); the FFT-form operations (about 0.8
// GFLOP at 655360) take 12 us at the 67 TFLOP/s float32 rate, so it is
// bound by bytes.
//
// Why three launches through HBM.  A row of D = 655360 complex points is
// 5 MB, past one block's 227 KB of shared memory and past a cluster's.  So
// the transform is cut into sub-transforms that fit a block, D = D1 D2 with
// D1, D2 <= 2048 (1280 x 512 at 655360, 1536 x 1024 at 1572864, 1024 x 512
// at 524288; circconv.plan), and the four-step's exchange between them goes
// through a float32 complex scratch that the wrapper allocates; a kernel
// boundary is the grid-wide barrier.  With j = j1 D2 + j2 and k = k1 + D1 k2:
//
//   X[k1 + D1 k2] = sum_j2 e^{-2 pi i j2 k2 / D2} e^{-2 pi i j2 k1 / D}
//                          sum_j1 x[j1 D2 + j2] e^{-2 pi i j1 k1 / D1}
//
// - Two real rows are one complex row.  Circular convolution and
//   correlation with a real key are linear over the complex numbers, so
//   the data rows of two groups, z_{2a,i} + i z_{2a+1,i} (bind) or
//   s_{2a} + i s_{2a+1} (unbind), go through the whole transform, product
//   and inverse as one row, and the real and imaginary parts of the result
//   are the two groups' outputs.  No spectrum is ever separated, so pass B
//   needs no mirrored row.  That halves the transforms and the scratch of
//   the data and output rows (an odd G packs its last group with zeros).
//   The price: a zero row's output holds its partner's rounding (~1e-7 of
//   it), not exact zeros as the plain version and circconv_fft.cu give.
// - Pass A (columns_kernel): for every packed data row, the length-D1 FFT
//   of each column j2, to scratch row Y[k1 D2 + j2].  A block takes C = 8
//   (or 4) adjacent columns, so its loads are runs of 32 bytes and its
//   stores runs of 64.  Every pass loads 16 bytes a thread, 4 loads in
//   flight before the first store to shared memory (PERF.md gives what
//   that moved, pass by pass).
// - Pass B (bind_rows_kernel, unbind_rows_kernel): one block per k1 for
//   every group pair.  It loads row k1 of the packed rows times the twiddle
//   e^{-2 pi i j2 k1 / D}, takes their length-D2 FFTs (the spectra at (k1,
//   k2)), forms the products with the keys' spectra (bind: sum_i Kf_i X_i in
//   key order; unbind: conj(Kf_i) S_f), takes the inverse length-D2 FFT,
//   multiplies by the conjugate twiddle and writes row k1 of the output's
//   scratch rows.  The spectra stay in the four-step's (k1, k2) order: a
//   pointwise product does not care about the order, so no transpose pass
//   is needed.  A block reads its row of twiddles once (D2 points of a
//   table of D made once per D) and its R key rows once.
// - Pass C (inverse_columns_kernel): the inverse length-D1 FFT of each
//   column, the scale 1/D, and the real and imaginary parts stored as the
//   two groups' rows in the data's dtype.
// - The keys' spectra: pass A on the key rows (unpacked), then the row FFTs
//   of rows k1 <= D1/2 only (key_rows_kernel): a real key's spectrum has
//   Kf[k1, k2] = conj(Kf[D1 - k1, D2 - 1 - k2]) for k1 > 0, so pass B
//   reads the other rows mirrored.  R (D1/2 + 1) D2 complex points, about
//   the keys' own bytes.
// - Tables: the twiddles e^{-2 pi i (j2 k1) / D} in pass B's layout and the
//   sub-transforms' quarter tables, made once per D in double precision and
//   rounded once (circconv_fft4_tables): sincospif of j2 k1 (2 / D) is
//   exact only for a power of two D.
//
// The sub-transforms are circconv_fft_common.cuh's fft_rows: the radix-8/4/2
// passes, then a pass per radix-3 or radix-5 stage, over swizzled rows in
// shared memory.  No atomics: every sum has a fixed order, so results are
// bitwise reproducible run to run.  Bytes at (4, 4, 524288) in float32,
// bind (unbind alike): Z 33.6 MB read, packed column spectra 33.6 MB written
// and read, key spectra 8.4 MB and twiddles 4.2 MB read, packed output rows
// 8.4 MB written and read, S 8.4 MB written: 138.6 MB, 2.8x the bound's
// 50.3 MB.  Times on the card: PERF.md (chip_smoke.py, phase 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "circconv_fft_common.cuh"

// the dynamic shared memory of every kernel here, carved by each
extern __shared__ __align__(16) unsigned char circconv_fft4_smem[];

namespace {

constexpr int TILE_THREADS = 512;   // passes A and C
constexpr int ROW_THREADS = 256;    // pass B
constexpr int MAX_SIDE = 2048;      // points of a sub-transform
constexpr int MAX_TILE = 16384;     // points of a pass A / C tile: 128 KB
constexpr int ROW_POINTS = 4096;    // points of a pass B chunk of rows
constexpr int UNROLL = 4;           // 16-byte loads a thread issues before it stores

// The two real rows of packed row pr: with `pack`, rows (2a) Rx + i and
// (2a + 1) Rx + i for pr = a Rx + i (the second absent, -1, past G groups);
// without, row pr alone.
struct Pair {
  long long re, im;
};
__device__ __forceinline__ Pair pair_rows(int pr, int G, int Rx, bool pack) {
  if (!pack) return {pr, -1};
  const int a = pr / Rx, i = pr - a * Rx;
  return {static_cast<long long>(2 * a) * Rx + i,
          2 * a + 1 < G ? static_cast<long long>(2 * a + 1) * Rx + i : -1};
}

// Pass A.  Block (packed row pr, column group): C columns [c0, c0 + C) of
// the row pair, as C rows of D1 points; out: Y[pr][k1 D2 + j2], the
// columns' spectra.  A thread takes 4 adjacent columns of a j1 (16-byte
// loads, UNROLL of them in flight), so a warp's lanes take 8 or 16 j1 and
// its scatter into the bit-reversed rows spreads over the banks.  Shared
// memory: the tile, the padded D1/4 twiddles.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
columns_kernel(const T* __restrict__ x, long long x_stride, int G, int Rx, int pack,
               const float2* __restrict__ tables, float2* __restrict__ y, Plan p) {
  const Radices& r1 = p.d1;
  const int D1 = r1.n, D2 = p.d2.n, C = p.cols, logQ = C == 8 ? 1 : 0;
  const int items = D1 << logQ;   // (j1, 4 columns)
  const long long D = static_cast<long long>(D1) * D2;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* tw = buf + C * D1;
  const int groups = D2 / C;
  const int pr = blockIdx.x / groups, c0 = (blockIdx.x - pr * groups) * C;
  const Pair rows = pair_rows(pr, G, Rx, pack != 0);
  load_table(tw, tables + D, D1 >> 2);
  const T* xre = x + rows.re * x_stride + c0;
  const T* xim = rows.im >= 0 ? x + rows.im * x_stride + c0 : nullptr;
  for (int b0 = threadIdx.x; b0 < items; b0 += UNROLL * blockDim.x) {
    float4 re[UNROLL], im[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const long long at =
          static_cast<long long>(b >> logQ) * D2 + 4 * (b & ((1 << logQ) - 1));
      re[u] = Io<T>::load4(xre + at);
      im[u] = xim ? Io<T>::load4(xim + at) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const int j1 = b >> logQ, c = 4 * (b & ((1 << logQ) - 1));
      float2* col = buf + c * D1 + addr(drev(j1, r1), r1.la);
      col[0] = make_float2(re[u].x, im[u].x);
      col[D1] = make_float2(re[u].y, im[u].y);
      col[2 * D1] = make_float2(re[u].z, im[u].z);
      col[3 * D1] = make_float2(re[u].w, im[u].w);
    }
  }
  __syncthreads();
  fft_rows<false, false>(buf, tw, nullptr, r1, C, 1);
  float2* dst = y + pr * D + c0;
  for (int b = threadIdx.x; b < items; b += blockDim.x) {
    const int k1 = b >> logQ, c = 4 * (b & ((1 << logQ) - 1));
    const float2* col = buf + c * D1 + addr(k1, r1.la);
    float4* d = reinterpret_cast<float4*>(dst + static_cast<long long>(k1) * D2 + c);
    d[0] = make_float4(col[0].x, col[0].y, col[D1].x, col[D1].y);
    d[1] = make_float4(col[2 * D1].x, col[2 * D1].y, col[3 * D1].x, col[3 * D1].y);
  }
}

// nb rows of D2 points, row rr = src[rr stride + j2] times tws[j2], loaded
// in the DIT's order; two points a 16-byte load, UNROLL loads in flight
__device__ void load_rows_k1(float2* buf, const float2* __restrict__ src, long long stride,
                             const float2* tws, int nb, const Radices& r2) {
  const int half = r2.n >> 1, items = nb * half;
  for (int b0 = threadIdx.x; b0 < items; b0 += UNROLL * blockDim.x) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const int rr = div_m(b >> (r2.la - 1), r2.m, r2.magic), j = 2 * (b - rr * half);
      v[u] = __ldg(reinterpret_cast<const float4*>(src + rr * stride + j));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const int rr = div_m(b >> (r2.la - 1), r2.m, r2.magic), j = 2 * (b - rr * half);
      float2* row = buf + rr * r2.n;
      row[addr(drev(j, r2), r2.la)] = cmul(make_float2(v[u].x, v[u].y), tws[j]);
      row[addr(drev(j + 1, r2), r2.la)] = cmul(make_float2(v[u].z, v[u].w), tws[j + 1]);
    }
  }
}

// row k1 of keys [i0, i0 + nb): the stored rows k1 <= D1/2 as they are, the
// others mirrored, Kf[k1, k2] = conj(Kf[D1 - k1, D2 - 1 - k2]); two points
// a 16-byte load
__device__ void load_keys(float2* keys, const float2* __restrict__ spec, int i0, int nb,
                          int k1, int D1, int D2) {
  const int H = D1 / 2 + 1;
  const bool mirror = k1 >= H;
  const int row = mirror ? D1 - k1 : k1;
  for (int rr = 0; rr < nb; ++rr) {
    const float2* src = spec + (static_cast<long long>(i0 + rr) * H + row) * D2;
    float2* dst = keys + rr * D2;
#pragma unroll 4
    for (int j = 2 * threadIdx.x; j < D2; j += 2 * blockDim.x) {
      if (mirror) {   // points D2 - 2 - j and D2 - 1 - j, conjugated, swapped
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + D2 - 2 - j));
        dst[j] = make_float2(v.z, -v.w);
        dst[j + 1] = make_float2(v.x, -v.y);
      } else {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
        dst[j] = make_float2(v.x, v.y);
        dst[j + 1] = make_float2(v.z, v.w);
      }
    }
  }
}

// the twiddles of row k1, e^{-2 pi i j2 k1 / D} for j2 < D2, and the quarter
// table of D2 points
__device__ void load_row_tables(float2* tws, float2* tw, const float2* __restrict__ tables,
                                int k1, const Plan& p) {
  const int D1 = p.d1.n, D2 = p.d2.n;
  const long long D = static_cast<long long>(D1) * D2;
  load_table(tw, tables + D + D1 / 4, D2 >> 2);
  for (int j2 = threadIdx.x; j2 < D2; j2 += blockDim.x)
    tws[j2] = tables[static_cast<long long>(k1) * D2 + j2];
}

// The keys' pass B.  Block k1 <= D1/2: row k1 of the R key rows of pass A
// times the twiddles, their length-D2 FFTs, to spec[i][k1][k2].  Shared
// memory: kc rows, the twiddles, the padded D2/4 quarter table.
__global__ void __launch_bounds__(ROW_THREADS)
key_rows_kernel(const float2* __restrict__ yk, const float2* __restrict__ tables,
                float2* __restrict__ spec, int R, Plan p, int kc) {
  const Radices& r2 = p.d2;
  const int D1 = p.d1.n, D2 = r2.n, H = D1 / 2 + 1, k1 = blockIdx.x;
  const long long D = static_cast<long long>(D1) * D2;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* tws = buf + kc * D2;
  float2* tw = tws + D2;
  load_row_tables(tws, tw, tables, k1, p);
  __syncthreads();
  for (int i0 = 0; i0 < R; i0 += kc) {
    const int nb = min(kc, R - i0);
    load_rows_k1(buf, yk + i0 * D + static_cast<long long>(k1) * D2, D, tws, nb, r2);
    __syncthreads();
    fft_rows<false, false>(buf, tw, nullptr, r2, nb, 1);
    for (int rr = 0; rr < nb; ++rr)
      for (int k2 = threadIdx.x; k2 < D2; k2 += blockDim.x)
        spec[(static_cast<long long>(i0 + rr) * H + k1) * D2 + k2] =
            buf[rr * D2 + addr(k2, r2.la)];
    __syncthreads();   // the rows are read before the next chunk's load
  }
}

// Pass B of bind.  Block k1, for each group pair a: row k1 of the packed
// data rows (a R + i), in chunks of kc keys, times the twiddles and
// transformed; the products Kf_i X_i summed into acc in key order; then
// the inverse of the sum, times the conjugate twiddles, to q row a, points
// [k1 D2, (k1 + 1) D2).  Shared memory: kc key rows, kc data rows, the sum,
// the twiddles, the padded D2/4 quarter table.
__global__ void __launch_bounds__(ROW_THREADS)
bind_rows_kernel(const float2* __restrict__ y, const float2* __restrict__ spec,
                 const float2* __restrict__ tables, float2* __restrict__ q, int G, int R,
                 Plan p, int kc) {
  const Radices& r2 = p.d2;
  const int D1 = p.d1.n, D2 = r2.n, la = r2.la, k1 = blockIdx.x;
  const long long D = static_cast<long long>(D1) * D2;
  float2* keys = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* data = keys + kc * D2;
  float2* acc = data + kc * D2;
  float2* tws = acc + D2;
  float2* tw = tws + D2;
  const bool resident = R <= kc;   // all keys at once, loaded once
  load_row_tables(tws, tw, tables, k1, p);
  if (resident) load_keys(keys, spec, 0, R, k1, D1, D2);
  __syncthreads();
  for (int a = 0; a < (G + 1) / 2; ++a) {
    for (int f = threadIdx.x; f < D2; f += blockDim.x) acc[f] = make_float2(0.f, 0.f);
    for (int i0 = 0; i0 < R; i0 += kc) {
      const int nb = min(kc, R - i0);
      if (!resident) load_keys(keys, spec, i0, nb, k1, D1, D2);
      load_rows_k1(data, y + (static_cast<long long>(a) * R + i0) * D +
                             static_cast<long long>(k1) * D2,
                   D, tws, nb, r2);
      __syncthreads();
      fft_rows<false, false>(data, tw, nullptr, r2, nb, 1);
      const float2* kr = keys + (resident ? i0 : 0) * D2;
      for (int f = threadIdx.x; f < D2; f += blockDim.x) {
        const int fa = addr(f, la);
        float2 s = acc[f];
        for (int rr = 0; rr < nb; ++rr) s = cadd(s, cmul(kr[rr * D2 + f], data[rr * D2 + fa]));
        acc[f] = s;
      }
      __syncthreads();   // the chunk's rows and keys are read
    }
    for (int f = threadIdx.x; f < D2; f += blockDim.x) data[addr(drev(f, r2), la)] = acc[f];
    __syncthreads();
    fft_rows<false, true>(data, tw, nullptr, r2, 1, 1);
    float2* dst = q + static_cast<long long>(a) * D + static_cast<long long>(k1) * D2;
    for (int j2 = threadIdx.x; j2 < D2; j2 += blockDim.x)
      dst[j2] = cmul(data[addr(j2, la)], cconj(tws[j2]));
    __syncthreads();   // the inverse is read before the next pair's load
  }
}

// Pass B of unbind.  Block k1, for each group pair a: row k1 of the packed
// S row a, times the twiddles, transformed once; then for the keys in
// chunks of kc the products conj(Kf_i) S_f, their inverses times the
// conjugate twiddles to q rows (a R + i).  Shared memory: kc key rows, kc
// product rows, the S row, the twiddles, the padded D2/4 quarter table.
__global__ void __launch_bounds__(ROW_THREADS)
unbind_rows_kernel(const float2* __restrict__ y, const float2* __restrict__ spec,
                   const float2* __restrict__ tables, float2* __restrict__ q, int G, int R,
                   Plan p, int kc) {
  const Radices& r2 = p.d2;
  const int D1 = p.d1.n, D2 = r2.n, la = r2.la, k1 = blockIdx.x;
  const long long D = static_cast<long long>(D1) * D2;
  float2* keys = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* prod = keys + kc * D2;
  float2* sdat = prod + kc * D2;
  float2* tws = sdat + D2;
  float2* tw = tws + D2;
  const bool resident = R <= kc;
  load_row_tables(tws, tw, tables, k1, p);
  if (resident) load_keys(keys, spec, 0, R, k1, D1, D2);
  __syncthreads();
  for (int a = 0; a < (G + 1) / 2; ++a) {
    load_rows_k1(sdat, y + static_cast<long long>(a) * D + static_cast<long long>(k1) * D2,
                 D, tws, 1, r2);
    __syncthreads();
    fft_rows<false, false>(sdat, tw, nullptr, r2, 1, 1);
    for (int i0 = 0; i0 < R; i0 += kc) {
      const int nb = min(kc, R - i0);
      if (!resident) {
        load_keys(keys, spec, i0, nb, k1, D1, D2);
        __syncthreads();
      }
      const float2* kr = keys + (resident ? i0 : 0) * D2;
      for (int rr = 0; rr < nb; ++rr)
        for (int f = threadIdx.x; f < D2; f += blockDim.x)
          prod[rr * D2 + addr(drev(f, r2), la)] =
              cmul(cconj(kr[rr * D2 + f]), sdat[addr(f, la)]);
      __syncthreads();
      fft_rows<false, true>(prod, tw, nullptr, r2, nb, 1);
      for (int rr = 0; rr < nb; ++rr) {
        float2* dst = q + (static_cast<long long>(a) * R + i0 + rr) * D +
                      static_cast<long long>(k1) * D2;
        for (int j2 = threadIdx.x; j2 < D2; j2 += blockDim.x)
          dst[j2] = cmul(prod[rr * D2 + addr(j2, la)], cconj(tws[j2]));
      }
      __syncthreads();   // the products (and keys) are read before the next chunk
    }
  }
}

// Pass C.  Block (packed output row o, column group) of the pass-B rows q:
// the inverse length-D1 FFT of each column, scaled by 1/D; the real parts
// to output row re, the imaginary parts to row im (pair_rows), rounded
// once to T.  Loads and stores as pass A's: 4 columns of a j1 a thread.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
inverse_columns_kernel(const float2* __restrict__ q, const float2* __restrict__ tables,
                       T* __restrict__ out, int G, int Ro, Plan p, float scale) {
  const Radices& r1 = p.d1;
  const int D1 = r1.n, D2 = p.d2.n, C = p.cols, logQ = C == 8 ? 1 : 0;
  const int items = D1 << logQ;
  const long long D = static_cast<long long>(D1) * D2;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* tw = buf + C * D1;
  const int groups = D2 / C;
  const int o = blockIdx.x / groups, c0 = (blockIdx.x - o * groups) * C;
  const Pair rows = pair_rows(o, G, Ro, true);
  load_table(tw, tables + D, D1 >> 2);
  const float2* src = q + o * D + c0;
  for (int b0 = threadIdx.x; b0 < items; b0 += UNROLL * blockDim.x) {
    float4 v[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const float4* s4 = reinterpret_cast<const float4*>(
          src + static_cast<long long>(b >> logQ) * D2 + 4 * (b & ((1 << logQ) - 1)));
      v[u][0] = __ldg(s4);
      v[u][1] = __ldg(s4 + 1);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b >= items) continue;
      const int k1 = b >> logQ, c = 4 * (b & ((1 << logQ) - 1));
      float2* col = buf + c * D1 + addr(drev(k1, r1), r1.la);
      col[0] = make_float2(v[u][0].x, v[u][0].y);
      col[D1] = make_float2(v[u][0].z, v[u][0].w);
      col[2 * D1] = make_float2(v[u][1].x, v[u][1].y);
      col[3 * D1] = make_float2(v[u][1].z, v[u][1].w);
    }
  }
  __syncthreads();
  fft_rows<false, true>(buf, tw, nullptr, r1, C, 1);
  T* re = out + rows.re * D + c0;
  T* im = rows.im >= 0 ? out + rows.im * D + c0 : nullptr;
  for (int b = threadIdx.x; b < items; b += blockDim.x) {
    const int j1 = b >> logQ, c = 4 * (b & ((1 << logQ) - 1));
    const float2* col = buf + c * D1 + addr(j1, r1.la);
    const float2 v0 = col[0], v1 = col[D1], v2 = col[2 * D1], v3 = col[3 * D1];
    const long long at = static_cast<long long>(j1) * D2 + c;
    Io<T>::store4(re + at, make_float4(v0.x * scale, v1.x * scale, v2.x * scale,
                                       v3.x * scale));
    if (im)
      Io<T>::store4(im + at, make_float4(v0.y * scale, v1.y * scale, v2.y * scale,
                                         v3.y * scale));
  }
}

// g[k1 D2 + j2] = e^{-2 pi i j2 k1 / D}, in double, rounded once
__global__ void four_step_twiddles(float2* __restrict__ g, int D1, int D2) {
  const long long D = static_cast<long long>(D1) * D2;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < D; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k1 = idx / D2, j2 = idx - k1 * D2;
    double s, c;
    sincospi(-2.0 * static_cast<double>(j2 * k1) / static_cast<double>(D), &s, &c);
    g[idx] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
}

bool plan_ok(const Plan& p) {
  return radices_ok(p.d1, MAX_SIDE) && radices_ok(p.d2, MAX_SIDE) &&
         p.d.n == p.d1.n * p.d2.n &&
         (p.cols == 4 || p.cols == 8) && p.d2.n % p.cols == 0 &&
         p.cols * p.d1.n <= MAX_TILE;
}

// keys (or data rows) a pass B chunk: within ROW_POINTS points, at most R
int row_keys(const Plan& p, int R) {
  const int kc = ROW_POINTS / p.d2.n;
  return kc < 1 ? 1 : (kc < R ? kc : R);
}

size_t tile_bytes(const Plan& p) {
  return (static_cast<size_t>(p.cols) * p.d1.n + pad16(p.d1.n / 4)) * sizeof(float2);
}

// pass B's shared memory: 2 kc rows, 2 more (sum or S row, twiddles), the
// quarter table (the keys' pass B takes less)
size_t rows_bytes(const Plan& p, int kc) {
  return (static_cast<size_t>(2 * kc + 2) * p.d2.n + pad16(p.d2.n / 4)) * sizeof(float2);
}

template <typename T>
int launch(bool bind, const Plan& p, const void* x, const void* spec, const void* tables,
           void* out, void* scratch, long long scratch_bytes, int G, int R, cudaStream_t st) {
  const long long D = p.d.n;
  const long long na = (G + 1) / 2;
  const long long np = bind ? na * R : na, nq = bind ? na : na * R;
  if (scratch_bytes < (np + nq) * D * static_cast<long long>(sizeof(float2)))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* y = static_cast<float2*>(scratch);
  float2* q = y + np * D;
  const int kc = row_keys(p, R);
  const size_t tb = tile_bytes(p), rb = rows_bytes(p, kc);
  int dev = 0;
  cudaGetDevice(&dev);
  // one set of flags per kernel (allow_smem sets a kernel's attribute once)
  static std::atomic<bool> allowed_a[MAX_DEVICES], allowed_bind[MAX_DEVICES],
      allowed_unbind[MAX_DEVICES], allowed_c[MAX_DEVICES];
  cudaError_t e = allow_smem(columns_kernel<T>, allowed_a, dev, tb);
  if (e == cudaSuccess)
    e = bind ? allow_smem(bind_rows_kernel, allowed_bind, dev, rb)
             : allow_smem(unbind_rows_kernel, allowed_unbind, dev, rb);
  if (e == cudaSuccess) e = allow_smem(inverse_columns_kernel<T>, allowed_c, dev, tb);
  if (e != cudaSuccess) return static_cast<int>(e);

  const unsigned groups = static_cast<unsigned>(p.d2.n / p.cols);
  const float2* tab = static_cast<const float2*>(tables);
  const float2* kspec = static_cast<const float2*>(spec);
  columns_kernel<T><<<static_cast<unsigned>(np) * groups, TILE_THREADS, tb, st>>>(
      static_cast<const T*>(x), D, G, bind ? R : 1, 1, tab, y, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bind)
    bind_rows_kernel<<<p.d1.n, ROW_THREADS, rb, st>>>(y, kspec, tab, q, G, R, p, kc);
  else
    unbind_rows_kernel<<<p.d1.n, ROW_THREADS, rb, st>>>(y, kspec, tab, q, G, R, p, kc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  inverse_columns_kernel<T><<<static_cast<unsigned>(nq) * groups, TILE_THREADS, tb, st>>>(
      q, tab, static_cast<T*>(out), G, bind ? 1 : R, p, 1.f / static_cast<float>(D));
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool bind, const void* plan, const void* x, const void* spec, const void* tables,
             void* out, void* scratch, long long scratch_bytes, int G, int R, int dtype,
             void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p) || G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(bind, p, x, spec, tables, out, scratch, scratch_bytes, G, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(bind, p, x, spec, tables, out, scratch, scratch_bytes, G,
                                 R, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `plan` is a struct Plan (D =
// d1.n x d2.n, each side 2^la 3^n3 5^n5 <= 2048 with la >= 2, `cols` 4 or
// 8).  `tables` holds what circconv_fft4_tables made for the plan: D + D1/4
// + D2/4 complex points.  `spec` holds what circconv_fft4_key_spectra made
// for the keys: R (D1/2 + 1) D2 complex points.  Each launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.

extern "C" int circconv_fft4_tables(const void* plan, void* tables, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* g = static_cast<float2*>(tables);
  const int D1 = p.d1.n, D2 = p.d2.n;
  four_step_twiddles<<<1024, 256, 0, st>>>(g, D1, D2);
  roots_kernel<<<(D1 / 4 + 255) / 256, 256, 0, st>>>(g + p.d.n, D1 / 4, D1);
  roots_kernel<<<(D2 / 4 + 255) / 256, 256, 0, st>>>(g + p.d.n + D1 / 4, D2 / 4, D2);
  return static_cast<int>(cudaGetLastError());
}

// the keys' spectra from Kext (R, 2D) float32; `scratch` holds R D complex
// points (pass A's rows)
extern "C" int circconv_fft4_key_spectra(const void* plan, const void* kext,
                                         const void* tables, void* spec, void* scratch,
                                         long long scratch_bytes, int R, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const long long D = p.d.n;
  if (!plan_ok(p) || R < 1 ||
      scratch_bytes < R * D * static_cast<long long>(sizeof(float2)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kc = row_keys(p, R);
  const size_t tb = tile_bytes(p), rb = rows_bytes(p, kc);
  int dev = 0;
  cudaGetDevice(&dev);
  static std::atomic<bool> allowed_a[MAX_DEVICES], allowed_k[MAX_DEVICES];
  cudaError_t e = allow_smem(columns_kernel<float>, allowed_a, dev, tb);
  if (e == cudaSuccess) e = allow_smem(key_rows_kernel, allowed_k, dev, rb);
  if (e != cudaSuccess) return static_cast<int>(e);
  float2* yk = static_cast<float2*>(scratch);
  const float2* tab = static_cast<const float2*>(tables);
  const unsigned groups = static_cast<unsigned>(p.d2.n / p.cols);
  columns_kernel<float><<<static_cast<unsigned>(R) * groups, TILE_THREADS, tb, st>>>(
      static_cast<const float*>(kext), 2 * D, R, 1, 0, tab, yk, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  key_rows_kernel<<<p.d1.n / 2 + 1, ROW_THREADS, rb, st>>>(yk, tab,
                                                           static_cast<float2*>(spec), R, p,
                                                           kc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int circconv_fft4_bind_superpose(const void* plan, const void* Z,
                                            const void* spec, const void* tables, void* out,
                                            void* scratch, long long scratch_bytes, int G,
                                            int R, int dtype, void* stream) {
  return dispatch(true, plan, Z, spec, tables, out, scratch, scratch_bytes, G, R, dtype,
                  stream);
}

extern "C" int circconv_fft4_unbind(const void* plan, const void* S, const void* spec,
                                    const void* tables, void* out, void* scratch,
                                    long long scratch_bytes, int G, int R, int dtype,
                                    void* stream) {
  return dispatch(false, plan, S, spec, tables, out, scratch, scratch_bytes, G, R, dtype,
                  stream);
}
