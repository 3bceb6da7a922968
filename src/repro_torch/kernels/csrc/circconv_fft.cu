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
// PERF.md (chip_smoke.py, phase 6).  The complex arithmetic, the twiddle
// table, the radix-8 passes and the load/store traits live in
// circconv_fft_common.cuh, shared with the four-step kernels of
// circconv_fft4.cu (D past shared memory).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "circconv_fft_common.cuh"

// the dynamic shared memory of both kernels, carved by each
extern __shared__ __align__(16) unsigned char circconv_fft_smem[];

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 512;   // 128 registers a thread for the radix-8 passes
constexpr int MIN_LOG_D = 2, MAX_LOG_D = 14;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

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

// a quarter of a row's points (the loads' float4 chunks), 32 to MAX_THREADS
int threads_for(int points) {
  const int work = points >> 2;
  return work < 32 ? 32 : (work > MAX_THREADS ? MAX_THREADS : work);
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
