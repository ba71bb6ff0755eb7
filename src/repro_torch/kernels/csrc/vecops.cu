// N_Vector kernels over flat contiguous vectors of n elements.
//
// Replaces src/repro/kernels/vecops.py:
//   _lincomb_kernel -> lincomb_kernel            (z = sum_k c_k x_k)
//   _dot_kernel     -> dot_partial_kernel, then dot_final_kernel
//
// Bound: memory.  The linear combination does 2K-1 flops per element
// against (K+1) values moved; the dot 2 flops against 2 values: both
// far below the H100's ~10 flops per byte of float64 balance, so the
// least time is the bytes over 3.35 TB/s.  Each input is read once and
// the output written once, coalesced (thread i touches element i).
//
// The coefficients are device scalars (Krylov's alpha, beta, omega are
// computed on the card): each term's coefficient is its own pointer,
// read once per thread, so no host read and no stacking copy is needed.
// The sum runs in the reference's order, c_0 x_0 + c_1 x_1 + ... .
//
// The dot product is deterministic: the partition of the n elements
// over blocks depends only on n, each thread sums its elements in a
// fixed order, a block reduces its 256 sums in a fixed tree (warp
// shuffles, then the eight warp sums in order), and a second launch of
// one block sums the partials the same way.  No floating-point atomics:
// the same input gives the same bits on every run.
#include "common.cuh"

#define LINCOMB_MAX_K 8
// the most partial sums a dot writes: the size of the caller's scratch
#define DOT_MAX_BLOCKS 1024

template <typename T>
struct LincombArgs {
  const T* x[LINCOMB_MAX_K];
  const T* c[LINCOMB_MAX_K];
};

template <typename T, int K>
__global__ void lincomb_kernel(LincombArgs<T> a, T* __restrict__ z,
                               long long n) {
  T c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = *a.c[k];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = system_index(); i < n; i += stride) {
    T acc = c[0] * a.x[0][i];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + c[k] * a.x[k][i];
    z[i] = acc;
  }
}

// sum of v over the block's threads in a fixed order; the result is
// valid in thread 0
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[REPRO_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = warp_sums[0];
#pragma unroll
    for (int w = 1; w < REPRO_THREADS / 32; ++w) v = v + warp_sums[w];
  }
  return v;
}

template <typename T>
__global__ void dot_partial_kernel(const T* __restrict__ x,
                                   const T* __restrict__ y,
                                   T* __restrict__ partial, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  T acc = T(0);
  for (long long i = system_index(); i < n; i += stride)
    acc = acc + x[i] * y[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

template <typename T>
__global__ void dot_final_kernel(const T* __restrict__ partial, int nparts,
                                 T* __restrict__ out) {
  T acc = T(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x)
    acc = acc + partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

static inline unsigned stream_blocks(long long n, long long cap) {
  const long long g = (n + REPRO_THREADS - 1) / REPRO_THREADS;
  return (unsigned)(g < cap ? (g > 0 ? g : 1) : cap);
}

template <typename T>
static int lincomb(int K, const void* const* xs, const void* const* cs,
                   void* z, long long n, void* stream) {
  if (K < 1 || K > LINCOMB_MAX_K) return (int)cudaErrorInvalidValue;
  LincombArgs<T> a;
  for (int k = 0; k < LINCOMB_MAX_K; ++k) {
    a.x[k] = k < K ? (const T*)xs[k] : nullptr;
    a.c[k] = k < K ? (const T*)cs[k] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = stream_blocks(n, 1 << 16);
  T* zv = (T*)z;
  switch (K) {
    case 1: lincomb_kernel<T, 1><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 2: lincomb_kernel<T, 2><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 3: lincomb_kernel<T, 3><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 4: lincomb_kernel<T, 4><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 5: lincomb_kernel<T, 5><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 6: lincomb_kernel<T, 6><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    case 7: lincomb_kernel<T, 7><<<g, REPRO_THREADS, 0, st>>>(a, zv, n); break;
    default: lincomb_kernel<T, 8><<<g, REPRO_THREADS, 0, st>>>(a, zv, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int dot(const void* x, const void* y, void* partial, void* out,
               long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = stream_blocks(n, DOT_MAX_BLOCKS);
  dot_partial_kernel<T><<<g, REPRO_THREADS, 0, st>>>(
      (const T*)x, (const T*)y, (T*)partial, n);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dot_final_kernel<T><<<1, REPRO_THREADS, 0, st>>>((const T*)partial, (int)g,
                                                   (T*)out);
  return (int)cudaGetLastError();
}

extern "C" int linear_combination_f32(int K, const void* const* xs,
                                      const void* const* cs, void* z,
                                      long long n, void* stream) {
  return lincomb<float>(K, xs, cs, z, n, stream);
}

extern "C" int linear_combination_f64(int K, const void* const* xs,
                                      const void* const* cs, void* z,
                                      long long n, void* stream) {
  return lincomb<double>(K, xs, cs, z, n, stream);
}

extern "C" int dot_f32(const void* x, const void* y, void* partial,
                       void* out, long long n, void* stream) {
  return dot<float>(x, y, partial, out, n, stream);
}

extern "C" int dot_f64(const void* x, const void* y, void* partial,
                       void* out, long long n, void* stream) {
  return dot<double>(x, y, partial, out, n, stream);
}
