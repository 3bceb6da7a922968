// C3-SL's HRR codec kernels for Hopper (sm_90a): bind+superpose and unbind.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/circconv.py:
//   circconv_bind_superpose  <- bind_superpose_kernel (body _bind_kernel)
//   circconv_unbind          <- unbind_kernel         (body _unbind_kernel)
//
//   bind:    S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
//   unbind:  Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]
//
// Both read the doubled keys Kext = [K || K] (R, 2D), always float32, so
// that K_i[(d - j) mod D] == Kext[i, d - j + D] for every d, j in [0, D).
// Data (Z, S, outputs) is float32 or bfloat16; bfloat16 is converted with
// the intrinsics on load and store, and every sum is taken in float32.
//
// Design.  One block owns one output tile of GT rows x T columns and loops
// over the j-tiles itself, so there are no atomics and no second pass
// (the TPU kernel instead carried its sum in scratch across a sequential
// grid axis).  For each j-tile the block stages the data tile and the
// (2T-1)-long key window Kext[i, d0 - j0 + D - (T-1) ...] in shared
// memory; a thread owning column b reads the Toeplitz entry for row a as
// win[b - a + T - 1] (bind) or win[a - b + T - 1] (unbind), so the T x T
// Toeplitz matrix is never built.  The block's 256 threads are NS slices
// of T columns: slice s walks j-tiles s, s + NS, ..., each thread keeps
// GT float32 accumulators (one per row, the data read as one float4
// broadcast), and the slices' partial sums are added in shared memory in
// a fixed order at the end, so results are deterministic.  Each staged
// tile's T products go into a fresh partial before joining the running
// sum: a two-level sum whose float32 rounding stays within 1e-5 of a
// float64 oracle at D = 4096 (one running sum over 4096 products per
// slice drifted to 1.4e-5 there).
// Unbind puts the key index on the grid's z axis (one key per block)
// instead of keeping R accumulators per thread: R is a run-time value,
// and the z axis gives R times more blocks at the main-path shape.
//
// Any D: the last tile is ragged, and every load outside [0, D) (data) or
// [0, 2D) (window) is masked to zero, every store outside the output is
// skipped.  So no alignment rule like the TPU's MIN_TILE is needed.
//
// Tiles: T = 64, GT = 4, NS = 4 (256 threads, 10 KB of shared memory).
// At the main-path shape (G = 16, D = 2048) bind launches 32 x 4 = 128
// blocks and unbind 32 x 4 x R = 512 (R = 4); at D = 4096, 256 and 1024.
//
// Bound at the main-path shapes (G = 16, R = 4).  The function's least
// work is its data: Z or S, K (R, D) and the output cross HBM once, 0.69
// MB at D = 2048 and 1.38 MB at D = 4096, 0.21 us and 0.41 us at 3.35
// TB/s.  Its operations in the FFT form, about 5 and 11 MFLOP, take less
// (0.08 and 0.17 us at the float32 peak), so the function is bound by
// bytes.  The direct form these kernels run does 2 G R D^2 FLOPs, 0.54
// GFLOP at D = 2048 and 2.15 GFLOP at D = 4096 (the paper's Table 1
// figures): 8.0 us and 32 us at the 67 TFLOP/s float32 rate of the CUDA
// cores, some 40x and 80x the function's bound, so no direct-form kernel
// on the CUDA cores comes near that bound.  This simple design spends two
// shared-memory loads per four FMAs, so it is held below even the direct
// form's rate by shared-memory bandwidth.  Left for later: Toeplitz tiles
// fed to the tensor cores (mma / wgmma in TF32 or bf16), TMA staging with
// a multi-stage mbarrier pipeline, more outputs per thread to raise the
// FMA-to-load ratio.  The FFT-form kernels of circconv_fft.cu take every
// power-of-two D up to 16384 (circconv.route); these take every other D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;   // tile width along d and along j
constexpr int GT = 4;   // rows (groups) per block
constexpr int NS = 4;   // j-slices per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename scalar_t>
__device__ __forceinline__ scalar_t from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared staging of one slice: data tile transposed to [a][gg] so that a
// thread reads its GT rows as one float4, and the (2T-1) key window.
struct Stage {
  float data[NS][T][GT];
  float win[NS][2 * T];
};

// Stage win[s][t] = Kext[i, w0 + t] for t in [0, 2T-1), zero outside [0, 2D).
__device__ __forceinline__ void stage_window(float* win, const float* kext_i,
                                             long long w0, long long twoD,
                                             bool live, int b) {
  for (int t = b; t < 2 * T - 1; t += T) {
    const long long k = w0 + t;
    win[t] = (live && k >= 0 && k < twoD) ? kext_i[k] : 0.f;
  }
}

// Add the NS slices' partial sums in a fixed order; thread (s, b) writes
// row g0 + s, column d0 + b.
template <typename scalar_t>
__device__ __forceinline__ void reduce_store(float (&red)[NS][GT][T],
                                             const float (&acc)[GT], int s,
                                             int b, scalar_t* out_row,
                                             bool row_ok, int d, int D) {
  __syncthreads();
#pragma unroll
  for (int gg = 0; gg < GT; ++gg) red[s][gg][b] = acc[gg];
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NS; ++k) sum += red[k][s][b];
  if (row_ok && d < D) out_row[d] = from_float<scalar_t>(sum);
}

template <typename scalar_t>
__global__ void __launch_bounds__(T * NS)
bind_superpose_kernel(const scalar_t* __restrict__ Z,
                      const float* __restrict__ kext,
                      scalar_t* __restrict__ out, int G, int R, int D) {
  __shared__ __align__(16) Stage st;
  __shared__ float red[NS][GT][T];
  const int b = threadIdx.x, s = threadIdx.y;
  const int d0 = blockIdx.x * T, g0 = blockIdx.y * GT;
  const int n_jt = (D + T - 1) / T;
  const long long twoD = 2LL * D;
  float acc[GT] = {0.f, 0.f, 0.f, 0.f};

  for (int jt0 = 0; jt0 < n_jt; jt0 += NS) {
    const int jt = jt0 + s;
    const bool live = jt < n_jt;
    const int j = jt * T + b;
    // Kext[i, w0 + (b - a + T - 1)] == K_i[(d0 + b - j0 - a) mod D]
    const long long w0 = (long long)d0 - (long long)jt * T + D - (T - 1);
    for (int i = 0; i < R; ++i) {
      __syncthreads();
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        float v = 0.f;
        if (live && g < G && j < D)
          v = to_float(Z[((long long)g * R + i) * D + j]);
        st.data[s][b][gg] = v;
      }
      stage_window(st.win[s], kext + i * twoD, w0, twoD, live, b);
      __syncthreads();
      float part[GT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
      for (int a = 0; a < T; ++a) {
        const float w = st.win[s][b - a + T - 1];
        const float4 z = *reinterpret_cast<const float4*>(&st.data[s][a][0]);
        part[0] = fmaf(z.x, w, part[0]);
        part[1] = fmaf(z.y, w, part[1]);
        part[2] = fmaf(z.z, w, part[2]);
        part[3] = fmaf(z.w, w, part[3]);
      }
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) acc[gg] += part[gg];
    }
  }
  const int g = g0 + s;
  reduce_store<scalar_t>(red, acc, s, b, out + (long long)g * D, g < G,
                         d0 + b, D);
}

template <typename scalar_t>
__global__ void __launch_bounds__(T * NS)
unbind_kernel(const scalar_t* __restrict__ S, const float* __restrict__ kext,
              scalar_t* __restrict__ out, int G, int R, int D) {
  __shared__ __align__(16) Stage st;
  __shared__ float red[NS][GT][T];
  const int b = threadIdx.x, s = threadIdx.y;
  const int d0 = blockIdx.x * T, g0 = blockIdx.y * GT, i = blockIdx.z;
  const int n_jt = (D + T - 1) / T;
  const long long twoD = 2LL * D;
  const float* kext_i = kext + i * twoD;
  float acc[GT] = {0.f, 0.f, 0.f, 0.f};

  for (int jt0 = 0; jt0 < n_jt; jt0 += NS) {
    const int jt = jt0 + s;
    const bool live = jt < n_jt;
    const int j = jt * T + b;
    // Kext[i, w0 + (a - b + T - 1)] == K_i[(j0 + a - d0 - b) mod D]
    const long long w0 = (long long)jt * T - d0 + D - (T - 1);
    __syncthreads();
#pragma unroll
    for (int gg = 0; gg < GT; ++gg) {
      const int g = g0 + gg;
      float v = 0.f;
      if (live && g < G && j < D) v = to_float(S[(long long)g * D + j]);
      st.data[s][b][gg] = v;
    }
    stage_window(st.win[s], kext_i, w0, twoD, live, b);
    __syncthreads();
    float part[GT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int a = 0; a < T; ++a) {
      const float w = st.win[s][a - b + T - 1];
      const float4 z = *reinterpret_cast<const float4*>(&st.data[s][a][0]);
      part[0] = fmaf(z.x, w, part[0]);
      part[1] = fmaf(z.y, w, part[1]);
      part[2] = fmaf(z.z, w, part[2]);
      part[3] = fmaf(z.w, w, part[3]);
    }
#pragma unroll
    for (int gg = 0; gg < GT; ++gg) acc[gg] += part[gg];
  }
  const int g = g0 + s;
  reduce_store<scalar_t>(red, acc, s, b, out + ((long long)g * R + i) * D,
                         g < G, d0 + b, D);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 float32, 1 bfloat16.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).

extern "C" int circconv_bind_superpose(const void* Z, const void* kext,
                                       void* out, int G, int R, int D,
                                       int dtype, void* stream) {
  const dim3 block(T, NS);
  const dim3 grid((D + T - 1) / T, (G + GT - 1) / GT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kext);
  if (dtype == 0) {
    bind_superpose_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(Z), k, static_cast<float*>(out), G, R, D);
  } else if (dtype == 1) {
    bind_superpose_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(Z), k,
        static_cast<__nv_bfloat16*>(out), G, R, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int circconv_unbind(const void* S, const void* kext, void* out,
                               int G, int R, int D, int dtype, void* stream) {
  const dim3 block(T, NS);
  const dim3 grid((D + T - 1) / T, (G + GT - 1) / GT, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kext);
  if (dtype == 0) {
    unbind_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(S), k, static_cast<float*>(out), G, R, D);
  } else if (dtype == 1) {
    unbind_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(S), k,
        static_cast<__nv_bfloat16*>(out), G, R, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
