// C3-SL's HRR codec kernels for Hopper (sm_90a) in the four-step FFT form:
// bind+superpose and unbind for a power of two D past shared memory
// (16384 < D <= 2^22), each three launches through device memory.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/circconv.py at those D:
//   circconv_fft4_bind_superpose  <- bind_superpose_kernel (:134, body _bind_kernel)
//   circconv_fft4_unbind          <- unbind_kernel         (:157, body _unbind_kernel)
//
//   bind:    S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
//   unbind:  Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]
//
// Same operands as circconv_fft.cu and circconv.cu: data (Z, S, outputs)
// float32 or bfloat16, the doubled keys Kext = [K || K] (R, 2D) float32, of
// which these kernels read the first half.  Data is converted to float32 on
// load, every operation is float32, and the output is rounded once.
//
// Bound on this card.  The function's least work is its bytes: at (G, R, D)
// = (4, 4, 524288), the LM training path's shape (deepseek-7b, B 16, S 128,
// R 4, D = S d_model), Z 33.6 MB + K 8.4 MB + S 8.4 MB = 50.3 MB cross HBM
// once, 15.0 us at 3.35 TB/s; its FFT-form operations (about 0.6 GFLOP)
// take 9 us at the 67 TFLOP/s float32 rate, so it is bound by bytes.
//
// Why three launches through HBM.  A row of D = 2^19 complex points is 4 MB,
// past one block's 227 KB of shared memory and past a cluster's (16 blocks
// at most, 3.6 MB).  So the transform is cut into sub-transforms that each
// fit a block, D = D1 D2 with D1 = 2^ceil(n/2), D2 = 2^floor(n/2) (1024 x
// 512 at D = 2^19), and the exchange between them, the four-step's
// transpose, goes through a float32 complex scratch in device memory that
// the wrapper allocates; a kernel boundary is the grid-wide barrier.  With
// j = j1 D2 + j2 and k = k1 + D1 k2:
//
//   X[k1 + D1 k2] = sum_j2 e^{-2 pi i j2 k2 / D2} e^{-2 pi i j2 k1 / D}
//                          sum_j1 x[j1 D2 + j2] e^{-2 pi i j1 k1 / D1}
//
// - Pass A (columns_kernel): for every data row and every key row (the
//   keys' spectra are made anew every call), the length-D1 FFT of each
//   column j2, times the twiddle e^{-2 pi i j2 k1 / D}, to scratch row
//   Y[k1 D2 + j2].  A block takes C = 2^13 / D1 adjacent columns, so its
//   loads and stores are runs of C points.
// - Pass B (bind_rows_kernel, unbind_rows_kernel): one block per (g, k1).
//   It loads row k1 of the R data and R key scratch rows (bind) or of S_g
//   and the R keys (unbind), takes their length-D2 FFTs, which gives the
//   spectra at (k1, k2), forms the products (bind: sum_i Kf_i X_i in key
//   order; unbind: conj(Kf_i) S_f), takes the inverse length-D2 FFT and
//   writes row k1 of the output's scratch rows.  The spectra stay in the
//   four-step's (k1, k2) order throughout: a pointwise product does not
//   care about the order, so no transpose pass is needed.
// - Pass C (inverse_columns_kernel): the conjugate twiddle, the inverse
//   length-D1 FFT of each column, the scale 1/D, and the real part stored
//   in the data's dtype.
//
// A real row is taken as a complex one with a zero imaginary part (the
// x + i a k packing of circconv_fft.cu would halve the transforms; later
// work).  The sub-transforms are circconv_fft.cu's radix-8 DIT passes over
// a quarter-wave table (circconv_fft_common.cuh).  The twiddles between the
// passes are made with sincospif on the product j2 k1, an integer reduced
// mod D first, so the argument is exact; __sinf / __cosf would exceed the
// 1e-5 budget (the note in circconv_fft.cu).  No atomics: every sum has a
// fixed order, so results are bitwise reproducible run to run.  Each pass
// moves its scratch once: at (4, 4, 2^19) bind writes and reads 84 MB of
// column spectra and 17 MB of row results, about five times the bound's
// bytes.  Times on the card: PERF.md (chip_smoke.py, phase 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "circconv_fft_common.cuh"

// the dynamic shared memory of every kernel here, carved by each
extern __shared__ __align__(16) unsigned char circconv_fft4_smem[];

namespace {

constexpr int THREADS = 512;
constexpr int MIN_LOG_D = 15, MAX_LOG_D = 22;   // 16384 < D <= 2^22
constexpr int LOG_TILE = 13;   // points of a pass A / C tile: 2^13, 64 KB

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// e^{-2 pi i m / D} (forward) or e^{+2 pi i m / D} (INV) for 0 <= m < D =
// 2^logD: sincospif of m 2^(1 - logD), exact as an argument (m < 2^24)
template <bool INV>
__device__ __forceinline__ float2 twiddle_d(int m, int logD) {
  float s, c;
  sincospif(static_cast<float>(m) * pow2(1 - logD), &s, &c);
  return INV ? make_float2(c, s) : make_float2(c, -s);
}

// C = 2^logC adjacent columns [c0, c0 + C) of a row of D = D1 D2 points
// (point j1 D2 + j2), as C rows of D1 points in bit-reversed, swizzled order
template <typename S>
__device__ void load_columns(float2* buf, const S* __restrict__ src, int logD1,
                             int logD2, int logC) {
  const int C = 1 << logC;
  for (int b = threadIdx.x; b < (1 << LOG_TILE); b += blockDim.x) {
    const int c = b & (C - 1), j1 = b >> logC;
    const float v = to_f(src[(static_cast<long long>(j1) << logD2) + c]);
    buf[(c << logD1) + swz(bitrev(j1, logD1))] = make_float2(v, 0.f);
  }
}

// Pass A.  Block (row, column group): rows [0, nd) are the data rows (type
// T, D apart), rows [nd, nd + R) the keys (Kext rows, 2D apart).  Out: the
// scratch row Y[k1 D2 + j2] = twiddle(j2 k1) * FFT_D1(column j2)[k1].
template <typename T>
__global__ void __launch_bounds__(THREADS)
columns_kernel(const T* __restrict__ x, int nd, const float* __restrict__ kext,
               float2* __restrict__ y, int logD1, int logD2) {
  const int logD = logD1 + logD2, logC = LOG_TILE - logD1, C = 1 << logC;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* tw = buf + (1 << LOG_TILE);
  const int groups_log = logD2 - logC;
  const long long row = blockIdx.x >> groups_log;
  const int c0 = static_cast<int>(blockIdx.x & ((1u << groups_log) - 1)) << logC;
  build_table(tw, logD1);
  if (row < nd)
    load_columns(buf, x + (row << logD) + c0, logD1, logD2, logC);
  else
    load_columns(buf, kext + ((row - nd) << (logD + 1)) + c0, logD1, logD2, logC);
  __syncthreads();
  fft<false, false>(buf, tw, nullptr, C, logD1, logD1);
  float2* dst = y + (row << logD) + c0;
  for (int b = threadIdx.x; b < (1 << LOG_TILE); b += blockDim.x) {
    const int c = b & (C - 1), k1 = b >> logC;
    dst[(static_cast<long long>(k1) << logD2) + c] =
        cmul(buf[(c << logD1) + swz(k1)], twiddle_d<false>((c0 + c) * k1, logD));
  }
}

// rows r in [0, nb) of D2 points: row r of the block's tile is src row
// (first + r) of the scratch, its points [k1 D2, (k1 + 1) D2), bit-reversed
__device__ void load_rows_k1(float2* buf, const float2* __restrict__ y, long long first,
                             int nb, int k1, int logD, int logD2) {
  const int D2 = 1 << logD2;
  for (int b = threadIdx.x; b < (nb << logD2); b += blockDim.x) {
    const int r = b >> logD2, j2 = b & (D2 - 1);
    buf[(r << logD2) + swz(bitrev(j2, logD2))] =
        y[((first + r) << logD) + (static_cast<long long>(k1) << logD2) + j2];
  }
}

// Pass B of bind.  Block (g, k1), keys in chunks of kc: the data rows
// (g R + i) and the key rows (G R + i) of the scratch, their row k1 loaded
// and transformed together (data rows [0, nb), keys [nb, 2 nb)), the
// products Kf_i X_i summed into acc in key order; then the inverse of the
// sum to q row g, points [k1 D2, (k1 + 1) D2).  Shared memory: 2 kc rows
// of D2, the D2-point sum, the D2/4 twiddles.
__global__ void __launch_bounds__(THREADS)
bind_rows_kernel(const float2* __restrict__ y, float2* __restrict__ q, int G, int R,
                 int logD1, int logD2, int kc) {
  const int logD = logD1 + logD2, D2 = 1 << logD2;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* acc = buf + (2 * kc << logD2);
  float2* tw = acc + D2;
  const long long g = blockIdx.x >> logD1;
  const int k1 = static_cast<int>(blockIdx.x & ((1u << logD1) - 1));
  build_table(tw, logD2);
  for (int f = threadIdx.x; f < D2; f += blockDim.x) acc[f] = make_float2(0.f, 0.f);
  for (int i0 = 0; i0 < R; i0 += kc) {
    const int nb = min(kc, R - i0);
    __syncthreads();   // the previous chunk's spectra are read
    load_rows_k1(buf, y, g * R + i0, nb, k1, logD, logD2);
    load_rows_k1(buf + (nb << logD2), y, static_cast<long long>(G) * R + i0, nb, k1,
                 logD, logD2);
    __syncthreads();
    fft<false, false>(buf, tw, nullptr, 2 * nb, logD2, logD2);
    for (int f = threadIdx.x; f < D2; f += blockDim.x) {
      float2 a = acc[f];
      for (int r = 0; r < nb; ++r)
        a = cadd(a, cmul(buf[((nb + r) << logD2) + swz(f)], buf[(r << logD2) + swz(f)]));
      acc[f] = a;
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < D2; f += blockDim.x)
    buf[swz(bitrev(f, logD2))] = acc[f];
  __syncthreads();
  fft<false, true>(buf, tw, nullptr, 1, logD2, logD2);
  float2* dst = q + (g << logD) + (static_cast<long long>(k1) << logD2);
  for (int j2 = threadIdx.x; j2 < D2; j2 += blockDim.x) dst[j2] = buf[swz(j2)];
}

// Pass B of unbind.  Block (g, k1): row k1 of S_g (scratch row g) loaded
// and transformed once; then the keys (scratch rows G + i) in chunks of
// kc: their row k1 transformed, the products conj(Kf_i) S_f written
// bit-reversed, their inverses to q rows (g R + i), points [k1 D2, (k1 +
// 1) D2).  Shared memory: D2 for S, kc rows for the keys and kc for the
// products, the D2/4 twiddles.
__global__ void __launch_bounds__(THREADS)
unbind_rows_kernel(const float2* __restrict__ y, float2* __restrict__ q, int G, int R,
                   int logD1, int logD2, int kc) {
  const int logD = logD1 + logD2, D2 = 1 << logD2;
  float2* sbuf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* kbuf = sbuf + D2;
  float2* pbuf = kbuf + (kc << logD2);
  float2* tw = pbuf + (kc << logD2);
  const long long g = blockIdx.x >> logD1;
  const int k1 = static_cast<int>(blockIdx.x & ((1u << logD1) - 1));
  build_table(tw, logD2);
  load_rows_k1(sbuf, y, g, 1, k1, logD, logD2);
  __syncthreads();
  fft<false, false>(sbuf, tw, nullptr, 1, logD2, logD2);
  for (int i0 = 0; i0 < R; i0 += kc) {
    const int nb = min(kc, R - i0);
    load_rows_k1(kbuf, y, G + i0, nb, k1, logD, logD2);
    __syncthreads();
    fft<false, false>(kbuf, tw, nullptr, nb, logD2, logD2);
    for (int b = threadIdx.x; b < (nb << logD2); b += blockDim.x) {
      const int r = b >> logD2, f = b & (D2 - 1);
      pbuf[(r << logD2) + swz(bitrev(f, logD2))] =
          cmul(cconj(kbuf[(r << logD2) + swz(f)]), sbuf[swz(f)]);
    }
    __syncthreads();
    fft<false, true>(pbuf, tw, nullptr, nb, logD2, logD2);
    for (int b = threadIdx.x; b < (nb << logD2); b += blockDim.x) {
      const int r = b >> logD2, j2 = b & (D2 - 1);
      q[((g * R + i0 + r) << logD) + (static_cast<long long>(k1) << logD2) + j2] =
          pbuf[(r << logD2) + swz(j2)];
    }
  }
}

// Pass C.  Block (row, column group) of the pass-B rows q: each column j2
// times twiddle(-j2 k1), the inverse length-D1 FFT, scaled by 1/D; the real
// parts to out[j1 D2 + j2], rounded once to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
inverse_columns_kernel(const float2* __restrict__ q, T* __restrict__ out, int logD1,
                       int logD2) {
  const int logD = logD1 + logD2, logC = LOG_TILE - logD1, C = 1 << logC;
  float2* buf = reinterpret_cast<float2*>(circconv_fft4_smem);
  float2* tw = buf + (1 << LOG_TILE);
  const int groups_log = logD2 - logC;
  const long long row = blockIdx.x >> groups_log;
  const int c0 = static_cast<int>(blockIdx.x & ((1u << groups_log) - 1)) << logC;
  build_table(tw, logD1);
  const float2* src = q + (row << logD) + c0;
  for (int b = threadIdx.x; b < (1 << LOG_TILE); b += blockDim.x) {
    const int c = b & (C - 1), k1 = b >> logC;
    buf[(c << logD1) + swz(bitrev(k1, logD1))] =
        cmul(src[(static_cast<long long>(k1) << logD2) + c],
             twiddle_d<true>((c0 + c) * k1, logD));
  }
  __syncthreads();
  fft<false, true>(buf, tw, nullptr, C, logD1, logD1);
  const float s = pow2(-logD);
  T* dst = out + (row << logD) + c0;
  for (int b = threadIdx.x; b < (1 << LOG_TILE); b += blockDim.x) {
    const int c = b & (C - 1), j1 = b >> logC;
    store_f(dst + (static_cast<long long>(j1) << logD2) + c,
            buf[(c << logD1) + swz(j1)].x * s);
  }
}

// log2 D for a power of two D in (16384, 2^22], else -1
int log2_of(int D) {
  for (int l = MIN_LOG_D; l <= MAX_LOG_D; ++l)
    if (D == (1 << l)) return l;
  return -1;
}

// the scratch both functions need, in bytes: the pass-A rows (data rows
// and keys) and the pass-B rows (the output's rows), D complex points each
long long scratch_need(bool bind, int G, int R, int logD) {
  const long long nd = bind ? static_cast<long long>(G) * R : G;
  const long long nq = bind ? G : static_cast<long long>(G) * R;
  return (nd + R + nq) * (1LL << logD) * static_cast<long long>(sizeof(float2));
}

template <typename T>
int launch(bool bind, const void* x, const void* kext, void* out, void* scratch,
           long long scratch_bytes, int G, int R, int logD, cudaStream_t st) {
  if (scratch_bytes < scratch_need(bind, G, R, logD))
    return static_cast<int>(cudaErrorInvalidValue);
  const int logD1 = (logD + 1) / 2, logD2 = logD / 2;
  const int logC = LOG_TILE - logD1;
  const long long nd = bind ? static_cast<long long>(G) * R : G;
  const long long nq = bind ? G : static_cast<long long>(G) * R;
  float2* y = static_cast<float2*>(scratch);
  float2* q = y + ((nd + R) << logD);
  // pass B's keys a chunk: 2 kc rows of D2 within 2^13 points, at most R
  const int kc = max(1, min(R, (1 << (LOG_TILE - 1)) >> logD2));
  const size_t tile_bytes = ((1 << LOG_TILE) + (1 << (logD1 - 2))) * sizeof(float2);
  const size_t rows_bytes =
      ((static_cast<size_t>(2 * kc + 1) << logD2) + (1 << (logD2 - 2))) * sizeof(float2);
  int dev = 0;
  cudaGetDevice(&dev);
  // one set of flags per kernel (allow_smem sets a kernel's attribute once)
  static std::atomic<bool> allowed_a[MAX_DEVICES], allowed_bind[MAX_DEVICES],
      allowed_unbind[MAX_DEVICES], allowed_c[MAX_DEVICES];
  cudaError_t e = allow_smem(columns_kernel<T>, allowed_a, dev, tile_bytes);
  if (e == cudaSuccess)
    e = bind ? allow_smem(bind_rows_kernel, allowed_bind, dev, rows_bytes)
             : allow_smem(unbind_rows_kernel, allowed_unbind, dev, rows_bytes);
  if (e == cudaSuccess) e = allow_smem(inverse_columns_kernel<T>, allowed_c, dev, tile_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);

  const unsigned groups = 1u << (logD2 - logC);
  columns_kernel<T><<<static_cast<unsigned>(nd + R) * groups, THREADS, tile_bytes, st>>>(
      static_cast<const T*>(x), static_cast<int>(nd), static_cast<const float*>(kext), y,
      logD1, logD2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned row_blocks = static_cast<unsigned>(G) << logD1;
  if (bind)
    bind_rows_kernel<<<row_blocks, THREADS, rows_bytes, st>>>(y, q, G, R, logD1, logD2, kc);
  else
    unbind_rows_kernel<<<row_blocks, THREADS, rows_bytes, st>>>(y, q, G, R, logD1, logD2,
                                                                kc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  inverse_columns_kernel<T><<<static_cast<unsigned>(nq) * groups, THREADS, tile_bytes,
                              st>>>(q, static_cast<T*>(out), logD1, logD2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool bind, const void* x, const void* kext, void* out, void* scratch,
             long long scratch_bytes, int G, int R, int D, int dtype, void* stream) {
  const int logD = log2_of(D);
  if (logD < 0 || G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(bind, x, kext, out, scratch, scratch_bytes, G, R, logD, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(bind, x, kext, out, scratch, scratch_bytes, G, R, logD,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 float32, 1 bfloat16.
// D must be a power of two in (16384, 2^22]; `scratch` is device memory of
// scratch_bytes >= (nd + R + nq) D 8 bytes, 8-byte aligned, where nd, nq =
// G R, G for bind and G, G R for unbind (the wrapper allocates it).
// Each launches its three passes on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.

extern "C" int circconv_fft4_bind_superpose(const void* Z, const void* kext, void* out,
                                            void* scratch, long long scratch_bytes, int G,
                                            int R, int D, int dtype, void* stream) {
  return dispatch(true, Z, kext, out, scratch, scratch_bytes, G, R, D, dtype, stream);
}

extern "C" int circconv_fft4_unbind(const void* S, const void* kext, void* out,
                                    void* scratch, long long scratch_bytes, int G, int R,
                                    int D, int dtype, void* stream) {
  return dispatch(false, S, kext, out, scratch, scratch_bytes, G, R, D, dtype, stream);
}
