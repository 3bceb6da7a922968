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
// take every D = 2^a 3^b 5^c with a >= 2 and 4 <= D <= 16384
// (circconv.route picks them by D); a larger such D goes to the four-step
// kernels of circconv_fft4.cu and every other D to the direct kernels.
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
// - D that is not a power of two (mixed radix; 5120 = 2^10 5 and 12288 =
//   2^12 3 are the d_model of qwen2.5-32b / pixtral-12b and of
//   mistral-large-123b, the serving codec's D): the same kernels, each a
//   template on its row's layout, so a power of two runs the code above.
//   Pow2 is that code (the radix-8 passes, the bit-reversed load, the
//   table built in the block); Mixed, for every other D, the transforms of
//   circconv_fft_common.cuh's fft_rows (the radix-8/4/2 passes over the
//   2^a-point sub-rows, then one pass per radix-3 or radix-5 stage, the
//   load in that order's digit reversal), with the quarter table
//   e^{-2 pi i k / D} made once per D on the device in double precision
//   (circconv_fft_table) and copied into each block: sincospif of k (2 / D)
//   is not exact when D is not a power of two.  The real inverse's D/2
//   points, the x + i a k packing and the cluster reduction are the
//   kernels' own, shared by both.  Where D/4 is not a multiple of 32 the
//   row maxima are taken with one shared-memory atomicMax a thread (a
//   warp's lanes may span two rows).
//
// Shared memory past 48 KB is dynamic, allowed once per kernel and device
// with cudaFuncSetAttribute; D = 16384 takes 224 KB a block of the 227 KB
// (12288: 172 KB).
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
constexpr int MAX_D = 16384;
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

// A row's layout and transforms, the kernels' template argument.  Both
// give: n() points and rows(q), the points of q rows; the quarter table's
// points in shared memory and its fill; the data row of a quarter-row item
// b (the loads' float4 chunks) and its chunk u in the row;
// where input point j is staged (in_at) and where spectrum point f and its
// mirror (D - f) mod D are read (at, mirror_at); the forward transform of
// nb staged rows; for the real inverse's D/2 points, the pre-twiddle w^k =
// e^{2 pi i k / D}, where its input k is staged (half_in_at), its
// transform, where its point m is read (half_at) and the scale 1/D.

// D = 2^logN: the radix-8 passes on bit-reversed, swizzled rows, the table
// built in the block with sincospif
struct Pow2 {
  int logN;
  __host__ __device__ int n() const { return 1 << logN; }
  __device__ int rows(int q) const { return q << logN; }
  __device__ long long rows(long long q) const { return q << logN; }
  __host__ __device__ int table_points() const { return 1 << (logN - 2); }
  __device__ void table(float2* tw, const float2*) const { build_table(tw, logN); }
  __device__ int quarter_row(int b, int& u) const {
    u = b & ((1 << (logN - 2)) - 1);
    return b >> (logN - 2);
  }
  __device__ int in_at(int j) const { return swz(bitrev(j, logN)); }
  __device__ int at(int f) const { return swz(f); }
  __device__ int mirror_at(int f) const { return swz((n() - f) & (n() - 1)); }
  template <bool SCALE>
  __device__ void forward(float2* buf, const float2* tw, const unsigned* mx, int nb) const {
    fft<SCALE, false>(buf, tw, mx, nb, logN, logN);
  }
  __device__ float2 w(const float2* tw, int k) const {
    return cconj(twiddle(tw, k, logN - 2));
  }
  __device__ int half_in_at(int k) const { return swz(bitrev(k, logN - 1)); }
  __device__ void inverse(float2* buf, const float2* tw) const {
    fft<false, true>(buf, tw, nullptr, 1, logN - 1, logN);
  }
  __device__ int half_at(int m) const { return swz(m); }
  __device__ float scale() const { return pow2(-logN); }
};

// D = 2^la 3^n3 5^n5 with la >= 2 and m = 3^n3 5^n5 > 1: fft_rows on
// digit-reversed rows of swizzled 2^la-point sub-rows; the quarter table
// (padded to whole 16-point swizzle rows) copied from the one made for D;
// h is the half-length transform of the real inverse
struct Mixed {
  Radices r, h;
  __host__ __device__ int n() const { return r.n; }
  __device__ int rows(int q) const { return q * r.n; }
  __device__ long long rows(long long q) const { return q * r.n; }
  __host__ __device__ int table_points() const { return pad16(r.n >> 2); }
  __device__ void table(float2* tw, const float2* __restrict__ g) const {
    load_table(tw, g, r.n >> 2);
  }
  __device__ int quarter_row(int b, int& u) const {
    const int q = div_m(b >> (r.la - 2), r.m, r.magic);
    u = b - q * (r.n >> 2);
    return q;
  }
  __device__ int in_at(int j) const { return addr(drev(j, r), r.la); }
  __device__ int at(int f) const { return addr(f, r.la); }
  __device__ int mirror_at(int f) const { return addr(f ? r.n - f : 0, r.la); }
  template <bool SCALE>
  __device__ void forward(float2* buf, const float2* tw, const unsigned* mx, int nb) const {
    fft_rows<SCALE, false>(buf, tw, mx, r, nb, 1);
  }
  __device__ float2 w(const float2* tw, int k) const {
    return twiddle_full<true>(tw, k, r.n >> 2);
  }
  __device__ int half_in_at(int k) const { return addr(drev(k, h), h.la); }
  __device__ void inverse(float2* buf, const float2* tw) const {
    fft_rows<false, true>(buf, tw, nullptr, h, 1, 2);
  }
  __device__ int half_at(int m) const { return addr(m, h.la); }
  __device__ float scale() const { return 1.f / r.n; }
};

// Stage nb rows of D points: row q = x[q x_stride + j] + i k[q k_stride +
// j], unscaled, point j at in_at(j); mx[2q] and mx[2q+1] take max|x_q| and
// max|k_q| as bits (zeroed by the caller)
template <typename T, typename L>
__device__ void load_rows(float2* buf, unsigned* mx, const T* __restrict__ x,
                          long long x_stride, const float* __restrict__ k,
                          long long k_stride, int nb, const L& lay) {
  const int Q = lay.n() >> 2;
  for (int b = threadIdx.x; b < nb * Q; b += blockDim.x) {
    int u;
    const int q = lay.quarter_row(b, u);
    const float4 xv = Io<T>::load4(x + q * x_stride + 4 * u);
    const float4 kv = __ldg(reinterpret_cast<const float4*>(k + q * k_stride + 4 * u));
    float2* row = buf + lay.rows(q);
    row[lay.in_at(4 * u + 0)] = make_float2(xv.x, kv.x);
    row[lay.in_at(4 * u + 1)] = make_float2(xv.y, kv.y);
    row[lay.in_at(4 * u + 2)] = make_float2(xv.z, kv.z);
    row[lay.in_at(4 * u + 3)] = make_float2(xv.w, kv.w);
    unsigned bx = max_abs_bits(xv), bk = max_abs_bits(kv);
    if ((Q & 31) == 0) {   // a warp's 32 iterations lie in one row
      bx = __reduce_max_sync(0xffffffffu, bx);
      bk = __reduce_max_sync(0xffffffffu, bk);
      if ((threadIdx.x & 31) != 0) continue;
    }
    atomicMax(mx + 2 * q, bx);
    atomicMax(mx + 2 * q + 1, bk);
  }
}

// The real inverse's input: with M = D/2 and Y(f) the half spectrum
// (f in [0, M]), inv[bitrev(k)] = Y(k) + conj Y(M-k) + i w^k (Y(k) - conj Y(M-k)).
template <typename L, typename F>
__device__ void pretwiddle(float2* inv, const float2* tw, const L& lay, F Y) {
  const int M = lay.n() >> 1;
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const float2 a = Y(k), b = cconj(Y(M - k));
    const float2 w = lay.w(tw, k);   // e^{2 pi i k / D}
    const float2 iwd = cmul(make_float2(-w.y, w.x), csub(a, b));
    inv[lay.half_in_at(k)] = cadd(cadd(a, b), iwd);
  }
}

// out[2m], out[2m+1] = the inverse's point m over D
template <typename T, typename L>
__device__ void store_row(T* __restrict__ out, const float2* inv, const L& lay) {
  const int M = lay.n() >> 1;
  const float s = lay.scale();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float2 z = inv[lay.half_at(m)];
    Io<T>::store2(out + 2 * m, z.x * s, z.y * s);
  }
}

// One cluster of C blocks per g.  Shared memory of a block: kc rows of D
// points, the D/2 + 1 accumulator, the quarter table, 4 kc maxima.
// `table`: the quarter table made for D (Mixed; unread by Pow2).
template <typename T, typename L>
__global__ void __launch_bounds__(MAX_THREADS)
fft_bind_superpose_kernel(const T* __restrict__ Z, const float* __restrict__ kext,
                          const float2* __restrict__ table, T* __restrict__ out, int R,
                          L lay, int kc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int M = lay.n() >> 1;
  float2* buf = reinterpret_cast<float2*>(circconv_fft_smem);
  float2* acc = buf + lay.rows(kc);
  float2* tw = acc + M + 1;
  unsigned* mx = reinterpret_cast<unsigned*>(tw + lay.table_points());
  const long long g = blockIdx.x / C;
  for (int f = threadIdx.x; f <= M; f += blockDim.x) acc[f] = make_float2(0.f, 0.f);
  lay.table(tw, table);
  const int nkeys = (R - rank + C - 1) / C;   // keys rank, rank + C, ...
  for (int j0 = 0, c = 0; j0 < nkeys; j0 += kc, ++c) {
    const int nb = min(kc, nkeys - j0), i0 = rank + j0 * C;
    // maxima by chunk parity: the previous chunk's may still be in use
    unsigned* m = mx + (c & 1) * 2 * kc;
    for (int t = threadIdx.x; t < 2 * nb; t += blockDim.x) m[t] = 0u;
    __syncthreads();
    load_rows<T>(buf, m, Z + lay.rows(g * R + i0), lay.rows(static_cast<long long>(C)),
                 kext + 2 * lay.rows(static_cast<long long>(i0)),
                 2 * lay.rows(static_cast<long long>(C)), nb, lay);
    __syncthreads();
    lay.template forward<true>(buf, tw, m, nb);
    for (int f = threadIdx.x; f <= M; f += blockDim.x) {
      const int fa = lay.at(f), fn = lay.mirror_at(f);
      float2 a = acc[f];
      for (int q = 0; q < nb; ++q) {
        const float2* row = buf + lay.rows(q);
        const float2 A = row[fa], B = cconj(row[fn]);
        const float2 P = cmul(csub(A, B), cadd(A, B));
        const float s = product_scale(m + 2 * q);
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
    for (int q = 0; q < C; ++q) s = cadd(s, cluster.map_shared_rank(acc, q)[f]);
    acc0[f] = s;
  }
  cluster.sync();   // block 0's accumulator holds the sum; no more remote reads
  if (rank != 0) return;
  pretwiddle(buf, tw, lay, [&](int f) { return acc[f]; });
  __syncthreads();
  lay.inverse(buf, tw);
  store_row<T>(out + lay.rows(g), buf, lay);
}

// One block per (g, i).  Shared memory: D points, the D/2-point inverse,
// the quarter table, 2 maxima.
template <typename T, typename L>
__global__ void __launch_bounds__(MAX_THREADS)
fft_unbind_kernel(const T* __restrict__ S, const float* __restrict__ kext,
                  const float2* __restrict__ table, T* __restrict__ out, int R, L lay) {
  const int N = lay.n(), M = N >> 1;
  float2* buf = reinterpret_cast<float2*>(circconv_fft_smem);
  float2* inv = buf + N;
  float2* tw = inv + M;
  unsigned* mx = reinterpret_cast<unsigned*>(tw + lay.table_points());
  const long long row = blockIdx.x;   // g R + i
  const long long g = row / R;
  const int i = static_cast<int>(row - g * R);
  if (threadIdx.x < 2) mx[threadIdx.x] = 0u;
  lay.table(tw, table);
  __syncthreads();
  load_rows<T>(buf, mx, S + lay.rows(g), 0, kext + 2 * lay.rows(static_cast<long long>(i)),
               0, 1, lay);
  __syncthreads();
  lay.template forward<true>(buf, tw, mx, 1);
  const float s = product_scale(mx);
  pretwiddle(inv, tw, lay, [&](int f) {
    const float2 A = buf[lay.at(f)], B = cconj(buf[lay.mirror_at(f)]);
    const float2 P = cmul(cconj(csub(A, B)), cadd(A, B));
    return make_float2(-P.y * s, P.x * s);   // conj(Kf) X = i conj(A - B)(A + B) / 4
  });
  __syncthreads();
  lay.inverse(inv, tw);
  store_row<T>(out + lay.rows(row), inv, lay);
}

template <typename L>
size_t bind_bytes(int kc, const L& lay) {
  const int N = lay.n();
  const size_t points = static_cast<size_t>(kc) * N + N / 2 + 1 + lay.table_points();
  return points * sizeof(float2) + 4 * kc * sizeof(unsigned);
}

template <typename L>
size_t unbind_bytes(const L& lay) {
  const int N = lay.n();
  return (static_cast<size_t>(N) + N / 2 + lay.table_points()) * sizeof(float2) +
         2 * sizeof(unsigned);
}

// a quarter of a row's points (the loads' float4 chunks), rounded up to
// whole warps, 32 to MAX_THREADS
int threads_for(int points) {
  const int work = ((points >> 2) + 31) & ~31;
  return work < 32 ? 32 : (work > MAX_THREADS ? MAX_THREADS : work);
}

template <typename T, typename L>
int launch_bind(const void* Z, const void* kext, const void* table, void* out, int G, int R,
                const L& lay, cudaStream_t st) {
  const int C = R < MAX_CLUSTER ? R : MAX_CLUSTER;
  const int keys = (R + C - 1) / C;   // keys of block 0, the most any block has
  // keys transformed together: as many as fit, balanced over the chunks
  int dev = 0;
  cudaGetDevice(&dev);
  const size_t optin = smem_optin(dev);
  int kmax = keys;
  while (kmax > 1 && bind_bytes(kmax, lay) > optin) --kmax;
  if (bind_bytes(kmax, lay) > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (keys + kmax - 1) / kmax;
  const int kc = (keys + chunks - 1) / chunks;
  const size_t bytes = bind_bytes(kc, lay);
  static std::atomic<bool> allowed[MAX_DEVICES];
  cudaError_t e = allow_smem(fft_bind_superpose_kernel<T, L>, allowed, dev, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G) * C);
  cfg.blockDim = dim3(threads_for(kc * lay.n()));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fft_bind_superpose_kernel<T, L>, static_cast<const T*>(Z),
                         static_cast<const float*>(kext), static_cast<const float2*>(table),
                         static_cast<T*>(out), R, lay, kc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int launch_unbind(const void* S, const void* kext, const void* table, void* out, int G,
                  int R, const L& lay, cudaStream_t st) {
  const size_t bytes = unbind_bytes(lay);
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > smem_optin(dev)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> allowed[MAX_DEVICES];
  const cudaError_t e = allow_smem(fft_unbind_kernel<T, L>, allowed, dev, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_unbind_kernel<T, L><<<static_cast<unsigned>(G) * R, threads_for(lay.n()), bytes, st>>>(
      static_cast<const T*>(S), static_cast<const float*>(kext),
      static_cast<const float2*>(table), static_cast<T*>(out), R, lay);
  return static_cast<int>(cudaGetLastError());
}

// bind (or unbind) in the data's dtype on the layout of `lay`
template <typename L>
int launch(bool bind, const void* x, const void* kext, const void* table, void* out, int G,
           int R, int dtype, const L& lay, cudaStream_t st) {
  if (dtype == 0)
    return bind ? launch_bind<float>(x, kext, table, out, G, R, lay, st)
                : launch_unbind<float>(x, kext, table, out, G, R, lay, st);
  if (dtype == 1)
    return bind ? launch_bind<__nv_bfloat16>(x, kext, table, out, G, R, lay, st)
                : launch_unbind<__nv_bfloat16>(x, kext, table, out, G, R, lay, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(bool bind, const void* plan, const void* table, const void* x,
             const void* kext, void* out, int G, int R, int dtype, void* stream) {
  const Radices& r = static_cast<const Plan*>(plan)->d;
  if (!radices_ok(r, MAX_D) || G < 1 || R < 1 || (r.m > 1 && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r.m == 1) return launch(bind, x, kext, table, out, G, R, dtype, Pow2{r.la}, st);
  Radices h = r;   // the real inverse's D/2 points
  h.n >>= 1;
  h.la -= 1;
  return launch(bind, x, kext, table, out, G, R, dtype, Mixed{r, h}, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 float32, 1 bfloat16.
// `plan` is a struct Plan whose `d` is D = 2^la 3^n3 5^n5 in [4, 16384]
// with la >= 2; where D is not a power of two, `table` holds the quarter
// table that circconv_fft_table made for it.  Data pointers 16-byte aligned
// (the wrapper copies a view that is not).  Each launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it does not take.

// table[k] = e^{-2 pi i k / D} for k < D/4, in double, rounded once
extern "C" int circconv_fft_table(const void* plan, void* table, void* stream) {
  const Radices& r = static_cast<const Plan*>(plan)->d;
  if (!radices_ok(r, MAX_D)) return static_cast<int>(cudaErrorInvalidValue);
  const int count = r.n / 4;
  roots_kernel<<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(table), count, r.n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int circconv_fft_bind_superpose(const void* plan, const void* table,
                                           const void* Z, const void* kext, void* out,
                                           int G, int R, int dtype, void* stream) {
  return dispatch(true, plan, table, Z, kext, out, G, R, dtype, stream);
}

extern "C" int circconv_fft_unbind(const void* plan, const void* table, const void* S,
                                   const void* kext, void* out, int G, int R, int dtype,
                                   void* stream) {
  return dispatch(false, plan, table, S, kext, out, G, R, dtype, stream);
}
