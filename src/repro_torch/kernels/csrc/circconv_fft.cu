// C3-SL's HRR codec kernels for Hopper (sm_90a) in the FFT form:
// bind+superpose and unbind, each one pass over its rows in shared memory.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/circconv.py:
//   circconv_fft_bind_superpose  <- bind_superpose_kernel (body _bind_kernel)
//   circconv_fft_unbind          <- unbind_kernel         (body _unbind_kernel)
//
//   bind:    S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
//   unbind:  Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]
//
// Same operands as the direct kernels of circconv.cu: data (Z, S, outputs)
// float32 or bfloat16, the doubled keys Kext = [K || K] (R, 2D) float32, of
// which these kernels read the first half.  Data is converted to float32 on
// load, every operation is float32, and the output is rounded once.  They
// take every power of two 4 <= D <= 16384 (circconv.route picks them by D);
// every other D goes to the direct kernels.
//
// Bound on this card.  The function's least work is its bytes: Z or S, K
// (R, D) and the output cross HBM once, 0.69 MB at (G, R, D) = (16, 4,
// 2048) and 1.38 MB at (16, 4, 4096), 0.21 and 0.41 us at 3.35 TB/s.  In
// the FFT form its operations (about 5 and 11 MFLOP) take 0.08 and 0.17 us
// at the 67 TFLOP/s float32 rate, so it is bound by bytes.  At these sizes
// no kernel comes near that bound: one block's chain of dependent steps (a
// load from HBM, log2 D butterfly stages each ending in a barrier, a
// store) and the instructions one SM issues for its transforms set the
// time.  So the design keeps everything between the load and the store in
// shared memory, fuses stages, and spreads a row's transforms over SMs.
//
// Design.
// - One complex FFT gives two real spectra.  A row of data x and a key k
//   are loaded as c = x + i a k (16-byte loads), transformed in shared
//   memory, and split: with A = C[f], B = conj(C[(D - f) mod D]),
//   X[f] = (A + B) / 2 and a Kf[f] = (A - B) / (2i).  So the keys' spectra
//   are made in the kernel, from the same read, and never by a library.
// - The scale a = 2^s (s = exponent of max|x| minus that of max|k|) puts x
//   and a k at one magnitude.  Without it the key's spectrum (|Kf| ~ 1 for
//   unit keys) is read off the difference of two values of the data's size
//   (|X| ~ sqrt(D) for unit-variance data), which costs about sqrt(D) = 64
//   times the float32 rounding at D = 4096, past the 1e-5 contract.  Being
//   a power of two, a is undone exactly.  The maxima are reduced with warp
//   votes and shared-memory atomicMax, which is order-free, so results are
//   bitwise deterministic.
// - Products: bind Kf_i X_i = -i (A - B)(A + B) / 4 summed over the keys,
//   unbind conj(Kf_i) S_f = i conj(A - B)(A + B) / 4, each for f in
//   [0, D/2].  Each output row is real, so the inverse is a complex FFT of
//   D/2 points: z[m] = y[2m] + i y[2m+1] from Y[k] + conj(Y[D/2 - k]) + i
//   w^k (Y[k] - conj(Y[D/2 - k])), w = e^{2 pi i / D}, stored as pairs.
// - The FFT is iterative radix-2 decimation in time on bit-reversed input
//   (the load and the inverse's pre-twiddle write bit-reversed), with three
//   stages fused per pass (a radix-8 butterfly in registers, 8 points a
//   thread), so a transform of log2 D = 12 takes 4 passes and 4 barriers.
//   At these sizes a block is bound by the instructions its SM issues, so
//   the passes keep them few: a stage reads one twiddle from a quarter-wave
//   table e^{-2 pi i k / D}, k < D/4, and makes the pass's others by
//   constant rotations (1/8, 1/4, 3/8 of a turn).  Each block fills the
//   table once with sincospif (accurate to an ulp; __sinf / __cosf would
//   eat the 1e-5 budget at D = 4096); the inverse conjugates it, and its
//   D/2 points use every other entry.  Blocks of up to 512 threads leave
//   up to 128 registers a thread, so the radix-8 state does not spill (at
//   1024 threads, 64 registers, it does); both kernels use under 64, so
//   two 512-thread blocks share an SM where shared memory allows (the
//   128-group prefill chunk).
// - Shared-memory addresses, the table's too, are XOR-swizzled within
//   16-point rows (p ^ ((p >> 4 ^ p >> 8 ^ p >> 12) & 15)), which spreads
//   the bit-reversed scatters and the strided butterfly and twiddle reads
//   over the banks; in the plain layout the 32 lanes of a scatter at
//   D >= 2048 write points a multiple of 16 (128 bytes) apart, all on the
//   same two banks.
// - Unbind: one block per (g, i), no reduction: it transforms S_g + i a K_i
//   (D points) and runs the D/2-point inverse in a second buffer.  64
//   blocks at (16, 4, D), 8 at decode (2, 4).
// - Bind: one thread-block cluster per g, of C = min(R, 8) blocks; block
//   `rank` takes the keys rank, rank + C, ... (kc of them transformed
//   together, as many as fit in shared memory, balanced over its chunks)
//   and sums its products into its own D/2 + 1 accumulator in key order.
//   After a cluster barrier each block sums a slice of the frequencies
//   over the C accumulators, read through distributed shared memory in
//   rank order, into block 0's; after a second barrier block 0 runs the
//   inverse and stores S_g.  The order of every sum is fixed, so results
//   are bitwise deterministic, with no atomics on data and no second pass.
//   64 blocks at (16, 4, D), 8 at decode, where one block per g would run
//   16 and 2, each issuing R transforms' instructions on one SM.
//
// Shared memory past 48 KB is dynamic, allowed once per kernel and device
// with cudaFuncSetAttribute; D = 16384 takes 224 KB a block of the 227 KB.
// Times on the card against the torch.fft route and the direct kernels:
// PERF.md (chip_smoke.py, phase 5).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

// the dynamic shared memory of both kernels, carved by each
extern __shared__ __align__(16) unsigned char circconv_fft_smem[];

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 512;   // 128 registers a thread for the radix-8 passes
constexpr int MIN_LOG_D = 2, MAX_LOG_D = 14;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int LOG_RADIX = 3;       // radix-2 stages a pass fuses (radix 8)

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// 2^e for e in [-126, 127], exact
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

__device__ __forceinline__ int swz(int p) {
  return p ^ (((p >> 4) ^ (p >> 8) ^ (p >> 12)) & 15);
}

__device__ __forceinline__ int bitrev(int j, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - bits)) : 0;
}

// tw[swz(k)] = e^{-2 pi i k / D} for k < D/4
__device__ void build_table(float2* tw, int logN) {
  const float step = -pow2(1 - logN);   // -2 / D: sincospif takes units of pi
  for (int k = threadIdx.x; k < (1 << (logN - 2)); k += blockDim.x) {
    float s, c;
    sincospif(static_cast<float>(k) * step, &s, &c);
    tw[swz(k)] = make_float2(c, s);
  }
}

// e^{-2 pi i k / D} for k < D/2 from the quarter table (Q = D/4 entries):
// e^{-2 pi i (k + Q) / D} = -i e^{-2 pi i k / D}; branch-free
__device__ __forceinline__ float2 twiddle(const float2* tw, int k, int logQ) {
  const float2 t = tw[swz(k & ((1 << logQ) - 1))];
  return (k >> logQ) ? make_float2(t.y, -t.x) : t;
}

// w e^{-+2 pi i m / 2^(s+1)} (sign - forward, + inverse) for m < 2^s <= 4:
// a rotation by 0, 1/8, 1/4 or 3/8 of a turn, with the constants folded
// once the stage loops are unrolled
template <bool INV>
__device__ __forceinline__ float2 rotate(float2 w, int m, int s) {
  constexpr float r = 0.70710678118654752f;
  const int eighths = (m << (3 - s - 1));   // the angle in eighths of a turn
  const float2 c = eighths == 1 ? make_float2(r, -r)
                 : eighths == 2 ? make_float2(0.f, -1.f)
                 : make_float2(-r, -r);     // eighths == 3
  if (eighths == 0) return w;
  if (eighths == 2) return INV ? make_float2(-w.y, w.x) : make_float2(w.y, -w.x);
  return cmul(w, INV ? cconj(c) : c);
}

// s of a row's scale a = 2^s, from the bits of max|x| and max|k| (mx[0], mx[1])
__device__ __forceinline__ int key_shift(const unsigned* mx) {
  const unsigned bx = mx[0], bk = mx[1];
  if (bx == 0u || bk == 0u) return 0;
  const int s = static_cast<int>(bx >> 23) - static_cast<int>(bk >> 23);
  return max(-100, min(100, s));
}

// The factor that turns (A - B)(A + B) into the row's product spectrum:
// 1/4 with the key's scale undone, or 0 for an all-zero data row, whose
// product is then exactly zero (its transform holds only the key's
// rounding noise)
__device__ __forceinline__ float product_scale(const unsigned* mx) {
  return mx[0] == 0u ? 0.f : 0.25f * pow2(-key_shift(mx));
}

__device__ __forceinline__ unsigned max_abs_bits(float4 v) {
  return __float_as_uint(fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
}

template <typename T>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Stage nb rows (D = 2^logN points each, bit-reversed, swizzled):
// row r = x[r x_stride + j] + i k[r k_stride + j], unscaled; mx[2r] and
// mx[2r+1] take max|x_r| and max|k_r| as bits (zeroed by the caller).
template <typename T>
__device__ void load_rows(float2* buf, unsigned* mx, const T* __restrict__ x,
                          long long x_stride, const float* __restrict__ k,
                          long long k_stride, int nb, int logN) {
  const int logQ = logN - 2, Q = 1 << logQ;
  for (int b = threadIdx.x; b < (nb << logQ); b += blockDim.x) {
    const int r = b >> logQ, u = b & (Q - 1);
    const float4 xv = Io<T>::load4(x + r * x_stride + 4 * u);
    const float4 kv = __ldg(reinterpret_cast<const float4*>(k + r * k_stride + 4 * u));
    float2* row = buf + (r << logN);
    row[swz(bitrev(4 * u + 0, logN))] = make_float2(xv.x, kv.x);
    row[swz(bitrev(4 * u + 1, logN))] = make_float2(xv.y, kv.y);
    row[swz(bitrev(4 * u + 2, logN))] = make_float2(xv.z, kv.z);
    row[swz(bitrev(4 * u + 3, logN))] = make_float2(xv.w, kv.w);
    unsigned bx = max_abs_bits(xv), bk = max_abs_bits(kv);
    if (Q >= 32) {   // a warp's 32 iterations lie in one row
      bx = __reduce_max_sync(0xffffffffu, bx);
      bk = __reduce_max_sync(0xffffffffu, bk);
      if ((threadIdx.x & 31) != 0) continue;
    }
    atomicMax(mx + 2 * r, bx);
    atomicMax(mx + 2 * r + 1, bk);
  }
}

// K radix-2 DIT stages fused into one pass, lengths 2h, 4h, ..., 2^K h
// (h = 2^logh), over nb rows of 2^logN points: a thread owns the 2^K points
// p + j h of one butterfly group and runs the K stages in registers.  The
// table is for 2^logT points.  SCALE: this is the first read of the loaded
// rows, which scales each key by its 2^s.  INV: the inverse (conjugate
// twiddles, unnormalised).
template <int K, bool SCALE, bool INV>
__device__ void stage(float2* buf, const float2* tw, const unsigned* mx, int nb,
                      int logN, int logT, int logh) {
  static_assert(K >= 1 && K <= 3, "rotate() covers passes of up to 3 stages");
  constexpr int P = 1 << K;
  const int logB = logN - K, h = 1 << logh;
  for (int b = threadIdx.x; b < (nb << logB); b += blockDim.x) {
    const int r = b >> logB, u = b & ((1 << logB) - 1);
    const int q = u & (h - 1);
    const int p = ((u >> logh) << (logh + K)) + q;
    float2* row = buf + (r << logN);
    float2 x[P];
    int at[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      at[j] = swz(p + j * h);
      x[j] = row[at[j]];
    }
    if (SCALE) {
      const float a = pow2(key_shift(mx + 2 * r));
#pragma unroll
      for (int j = 0; j < P; ++j) x[j].y *= a;
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // stage of length 2L, L = 2^s h: pairs (j, j + 2^s) with twiddle
      // e^{-+2 pi i (q + m h) / 2L}, m = j mod 2^s: the table's entry for q
      // rotated by m / 2^(s+1) of a turn
      float2 w0 = twiddle(tw, q << (logT - 1 - logh - s), logT - 2);
      if (INV) w0 = cconj(w0);
      float2 w[P / 2];
#pragma unroll
      for (int m = 0; m < (1 << s); ++m) w[m] = rotate<INV>(w0, m, s);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j & (1 << s)) continue;
        const float2 t = cmul(w[j & ((1 << s) - 1)], x[j + (1 << s)]);
        x[j + (1 << s)] = csub(x[j], t);
        x[j] = cadd(x[j], t);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) row[at[j]] = x[j];
  }
}

// In-place FFT of nb rows of 2^logN bit-reversed points; natural order out:
// passes of LOG_RADIX = 3 stages, the first taking the remainder (log2 D =
// 12: four passes).  Ends with __syncthreads.
template <bool SCALE, bool INV>
__device__ void fft(float2* buf, const float2* tw, const unsigned* mx, int nb, int logN,
                    int logT) {
  const int first = (logN - 1) % LOG_RADIX + 1;
  if (first == 1)
    stage<1, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  else if (first == 2)
    stage<2, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  else
    stage<3, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  __syncthreads();
  for (int logh = first; logh < logN; logh += LOG_RADIX) {
    stage<LOG_RADIX, false, INV>(buf, tw, mx, nb, logN, logT, logh);
    __syncthreads();
  }
}

// The real inverse's input: with M = D/2 and Y(f) the half spectrum
// (f in [0, M]), inv[bitrev(k)] = Y(k) + conj Y(M-k) + i w^k (Y(k) - conj Y(M-k)).
template <typename F>
__device__ void pretwiddle(float2* inv, const float2* tw, int logN, F Y) {
  const int logM = logN - 1, M = 1 << logM;
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 a = Y(k), b = cconj(Y(M - k));
    const float2 w = cconj(twiddle(tw, k, logN - 2));   // e^{2 pi i k / D}
    const float2 iwd = cmul(make_float2(-w.y, w.x), csub(a, b));
    inv[swz(bitrev(k, logM))] = cadd(cadd(a, b), iwd);
  }
}

// out[2m], out[2m+1] = the inverse's point m over D
template <typename T>
__device__ void store_row(T* __restrict__ out, const float2* inv, int logN) {
  const int M = 1 << (logN - 1);
  const float s = pow2(-logN);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float2 z = inv[swz(m)];
    Io<T>::store2(out + 2 * m, z.x * s, z.y * s);
  }
}

// One cluster of C blocks per g.  Shared memory of a block: kc rows of D
// points, the D/2 + 1 accumulator, the D/4 twiddles, 4 kc maxima.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
fft_bind_superpose_kernel(const T* __restrict__ Z, const float* __restrict__ kext,
                          T* __restrict__ out, int R, int logN, int kc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 1 << logN, M = N >> 1;
  float2* buf = reinterpret_cast<float2*>(circconv_fft_smem);
  float2* acc = buf + (kc << logN);
  float2* tw = acc + M + 1;
  unsigned* mx = reinterpret_cast<unsigned*>(tw + (N >> 2));
  const long long g = blockIdx.x / C;
  for (int f = threadIdx.x; f <= M; f += blockDim.x) acc[f] = make_float2(0.f, 0.f);
  build_table(tw, logN);
  const int nkeys = (R - rank + C - 1) / C;   // keys rank, rank + C, ...
  for (int j0 = 0, c = 0; j0 < nkeys; j0 += kc, ++c) {
    const int nb = min(kc, nkeys - j0), i0 = rank + j0 * C;
    // maxima by chunk parity: the previous chunk's may still be in use
    unsigned* m = mx + (c & 1) * 2 * kc;
    for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) m[t] = 0u;
    __syncthreads();
    load_rows<T>(buf, m, Z + ((g * R + i0) << logN), static_cast<long long>(C) << logN,
                 kext + (static_cast<long long>(i0) << (logN + 1)),
                 static_cast<long long>(C) << (logN + 1), nb, logN);
    __syncthreads();
    fft<true, false>(buf, tw, m, nb, logN, logN);
    for (int f = threadIdx.x; f <= M; f += blockDim.x) {
      const int fn = (N - f) & (N - 1);
      float2 a = acc[f];
      for (int r = 0; r < nb; ++r) {
        const float2* row = buf + (r << logN);
        const float2 A = row[swz(f)], B = cconj(row[swz(fn)]);
        const float2 P = cmul(csub(A, B), cadd(A, B));
        const float s = product_scale(m + 2 * r);
        a.x += P.y * s;    // Kf X = -i P / 4, the key unscaled
        a.y -= P.x * s;
      }
      acc[f] = a;
    }
  }
  cluster.sync();   // every block's accumulator is complete
  // this block's slice of frequencies, summed over the ranks in order into
  // block 0's accumulator
  const int per = (M + C) / C;   // ceil((M + 1) / C)
  const int hi = min(M + 1, (rank + 1) * per);
  float2* acc0 = cluster.map_shared_rank(acc, 0);
  for (int f = rank * per + threadIdx.x; f < hi; f += blockDim.x) {
    float2 s = make_float2(0.f, 0.f);
    for (int r = 0; r < C; ++r) s = cadd(s, cluster.map_shared_rank(acc, r)[f]);
    acc0[f] = s;
  }
  cluster.sync();   // block 0's accumulator holds the sum; no more remote reads
  if (rank != 0) return;
  pretwiddle(buf, tw, logN, [&](int f) { return acc[f]; });
  __syncthreads();
  fft<false, true>(buf, tw, nullptr, 1, logN - 1, logN);
  store_row<T>(out + (g << logN), buf, logN);
}

// One block per (g, i).  Shared memory: D points, the D/2-point inverse,
// the D/4 twiddles, 2 maxima.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
fft_unbind_kernel(const T* __restrict__ S, const float* __restrict__ kext,
                  T* __restrict__ out, int R, int logN) {
  const int N = 1 << logN, M = N >> 1;
  float2* buf = reinterpret_cast<float2*>(circconv_fft_smem);
  float2* inv = buf + N;
  float2* tw = inv + M;
  unsigned* mx = reinterpret_cast<unsigned*>(tw + (N >> 2));
  const long long row = blockIdx.x;   // g R + i
  const long long g = row / R;
  const int i = static_cast<int>(row - g * R);
  if (threadIdx.x < 2) mx[threadIdx.x] = 0u;
  build_table(tw, logN);
  __syncthreads();
  load_rows<T>(buf, mx, S + (g << logN), 0,
               kext + (static_cast<long long>(i) << (logN + 1)), 0, 1, logN);
  __syncthreads();
  fft<true, false>(buf, tw, mx, 1, logN, logN);
  const float s = product_scale(mx);
  pretwiddle(inv, tw, logN, [&](int f) {
    const float2 A = buf[swz(f)], B = cconj(buf[swz((N - f) & (N - 1))]);
    const float2 P = cmul(cconj(csub(A, B)), cadd(A, B));
    return make_float2(-P.y * s, P.x * s);   // conj(Kf) X = i conj(A - B)(A + B) / 4
  });
  __syncthreads();
  fft<false, true>(inv, tw, nullptr, 1, logN - 1, logN);
  store_row<T>(out + (row << logN), inv, logN);
}

// log2 D for a power of two D in [4, 16384], else -1
int log2_of(int D) {
  for (int l = MIN_LOG_D; l <= MAX_LOG_D; ++l)
    if (D == (1 << l)) return l;
  return -1;
}

size_t bind_bytes(int kc, int logN) {
  const size_t points = (static_cast<size_t>(kc) << logN) + (1 << (logN - 1)) + 1 +
                        (1 << (logN - 2));
  return points * sizeof(float2) + 4 * kc * sizeof(unsigned);
}

size_t unbind_bytes(int logN) {
  return (static_cast<size_t>(7) << (logN - 2)) * sizeof(float2) + 2 * sizeof(unsigned);
}

// The launch set-up is made once per device and kept, so a launch after the
// first on its device makes no driver query (cudaGetDevice reads the
// thread's state): the shared memory a block may opt in to (0 until read),
// and for each kernel whether it has been allowed all of it.  Both are
// idempotent, so threads that race here do the same work twice, no harm.
constexpr int MAX_DEVICES = 64;   // devices past this are queried at every launch
std::atomic<int> optin_bytes[MAX_DEVICES];

size_t smem_optin(int dev) {
  int v = dev < MAX_DEVICES ? optin_bytes[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      return 0;
    if (dev < MAX_DEVICES) optin_bytes[dev].store(v, std::memory_order_relaxed);
  }
  return static_cast<size_t>(v);
}

// a quarter of a row's points (the loads' float4 chunks), 32 to MAX_THREADS
int threads_for(int points) {
  const int work = points >> 2;
  return work < 32 ? 32 : (work > MAX_THREADS ? MAX_THREADS : work);
}

// Lets `kernel` take past 48 KB of dynamic shared memory: the device's whole
// opt-in, set once per device (`allowed` is the kernel's own flags).
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<bool>* allowed, int dev, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < MAX_DEVICES && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_optin(dev)));
  if (e == cudaSuccess && dev < MAX_DEVICES)
    allowed[dev].store(true, std::memory_order_release);
  return e;
}

template <typename T>
int launch_bind(const void* Z, const void* kext, void* out, int G, int R, int logN,
                cudaStream_t st) {
  const int C = R < MAX_CLUSTER ? R : MAX_CLUSTER;
  const int keys = (R + C - 1) / C;   // keys of block 0, the most any block has
  // keys transformed together: as many as fit, balanced over the chunks
  int dev = 0;
  cudaGetDevice(&dev);
  const size_t optin = smem_optin(dev);
  int kmax = keys;
  while (kmax > 1 && bind_bytes(kmax, logN) > optin) --kmax;
  if (bind_bytes(kmax, logN) > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (keys + kmax - 1) / kmax;
  const int kc = (keys + chunks - 1) / chunks;
  const size_t bytes = bind_bytes(kc, logN);
  static std::atomic<bool> allowed[MAX_DEVICES];
  cudaError_t e = allow_smem(fft_bind_superpose_kernel<T>, allowed, dev, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G) * C);
  cfg.blockDim = dim3(threads_for(kc << logN));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fft_bind_superpose_kernel<T>, static_cast<const T*>(Z),
                         static_cast<const float*>(kext), static_cast<T*>(out), R, logN,
                         kc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_unbind(const void* S, const void* kext, void* out, int G, int R, int logN,
                  cudaStream_t st) {
  const size_t bytes = unbind_bytes(logN);
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > smem_optin(dev)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> allowed[MAX_DEVICES];
  const cudaError_t e = allow_smem(fft_unbind_kernel<T>, allowed, dev, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_unbind_kernel<T><<<static_cast<unsigned>(G) * R, threads_for(1 << logN),
                         bytes, st>>>(
      static_cast<const T*>(S), static_cast<const float*>(kext), static_cast<T*>(out),
      R, logN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 float32, 1 bfloat16.
// D must be a power of two in [4, 16384]; data pointers 16-byte aligned
// (the wrapper copies a view that is not).  Each launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it does not take.

extern "C" int circconv_fft_bind_superpose(const void* Z, const void* kext, void* out,
                                           int G, int R, int D, int dtype, void* stream) {
  const int logN = log2_of(D);
  if (logN < 0 || G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bind<float>(Z, kext, out, G, R, logN, st);
  if (dtype == 1) return launch_bind<__nv_bfloat16>(Z, kext, out, G, R, logN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int circconv_fft_unbind(const void* S, const void* kext, void* out, int G,
                                   int R, int D, int dtype, void* stream) {
  const int logN = log2_of(D);
  if (logN < 0 || G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_unbind<float>(S, kext, out, G, R, logN, st);
  if (dtype == 1) return launch_unbind<__nv_bfloat16>(S, kext, out, G, R, logN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
