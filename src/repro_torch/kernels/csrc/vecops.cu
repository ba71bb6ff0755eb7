// N_Vector kernels over flat contiguous vectors of n elements.
//
// Replaces src/repro/kernels/vecops.py:
//   _lincomb_kernel         -> lincomb_kernel       (z = sum_k c_k x_k)
//   _scale_add_multi_kernel -> scale_add_multi_kernel
//                                                (z_k = c_k x + y_k)
//   _wrms_kernel            -> wrms_partial_kernel<T, false>, then
//                              dot_final_kernel   (sum (x w)^2)
//   _wrms_mask_kernel       -> wrms_partial_kernel<T, true>, then
//                              dot_final_kernel   (sum (x w m)^2)
//   _dot_kernel             -> dot_partial_kernel, then dot_final_kernel
//   _multidot_kernel        -> multi_dot_partial_kernel, then
//                              multi_final_kernel  (d_k = <x, y_k>)
//
// Bound: memory.  Every kernel here does a few flops per element
// against one to nine values moved: far below the H100's ~10 flops per
// byte of float64 balance, so the least time is the bytes over
// 3.35 TB/s.  Each input is read once and each output written once,
// coalesced (thread i touches element i).  The multi-vector kernels
// read x once for all K terms (the point of the fused N_Vector ops):
// scale_add_multi moves (2K+1) vectors, not 3K; the multi-dot K+1, not
// 2K.  The weighted norms square x*w in registers: x*w is never
// written out.
//
// The coefficients are device scalars (Krylov's alpha, beta, omega are
// computed on the card): each term's coefficient is its own pointer,
// read once per thread, so no host read and no stacking copy is needed.
// The sum runs in the reference's order, c_0 x_0 + c_1 x_1 + ... .
//
// The reductions are deterministic: the partition of the n elements
// over blocks depends only on n, each thread sums its elements in a
// fixed order, a block reduces its 256 sums in a fixed tree (warp
// shuffles, then the eight warp sums in order), and a second launch of
// one block sums the partials the same way.  No floating-point atomics:
// the same input gives the same bits on every run, so an integrator's
// host decisions (the Newton convergence test, the error test) repeat.
#include "common.cuh"

#define LINCOMB_MAX_K 8
// vectors the fused multi-vector ops take (scale_add_multi, multi-dot)
#define MULTI_MAX_K 8
// the most partial sums a reduction writes per output: the size of the
// caller's scratch (times K for the multi-dot)
#define DOT_MAX_BLOCKS 1024

template <typename T>
struct LincombArgs {
  const T* x[LINCOMB_MAX_K];
  const T* c[LINCOMB_MAX_K];
};

template <typename T>
struct MultiArgs {
  const T* y[MULTI_MAX_K];
  const T* c[MULTI_MAX_K];   // scale_add_multi only
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

// z[k*n + i] = c_k x_i + y_k[i]: x read once for all K outputs
template <typename T, int K>
__global__ void scale_add_multi_kernel(const T* __restrict__ x,
                                       MultiArgs<T> a, T* __restrict__ z,
                                       long long n) {
  T c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = *a.c[k];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = system_index(); i < n; i += stride) {
    const T xi = x[i];
#pragma unroll
    for (int k = 0; k < K; ++k) z[k * n + i] = c[k] * xi + a.y[k][i];
  }
}

// sums of v[0..K) over the block's threads, each in a fixed order; the
// results are valid in thread 0
template <typename T, int K>
__device__ void block_sum_multi(T (&v)[K]) {
  __shared__ T warp_sums[K][REPRO_THREADS / 32];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = v[k] + __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = warp_sums[k][0];
#pragma unroll
      for (int w = 1; w < REPRO_THREADS / 32; ++w)
        v[k] = v[k] + warp_sums[k][w];
    }
  }
}

template <typename T>
__device__ T block_sum(T v) {
  T a[1] = {v};
  block_sum_multi<T, 1>(a);
  return a[0];
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

// sum of (x w)^2, or with MASK of (x w m)^2, per block: the products
// stay in registers
template <typename T, bool MASK>
__global__ void wrms_partial_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const T* __restrict__ m,
                                    T* __restrict__ partial, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  T acc = T(0);
  for (long long i = system_index(); i < n; i += stride) {
    T v = x[i] * w[i];
    if (MASK) v = v * m[i];
    acc = acc + v * v;
  }
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

// partial[k*gridDim.x + block] = this block's share of <x, y_k>; x read
// once for all K dots, K accumulators in registers
template <typename T, int K>
__global__ void multi_dot_partial_kernel(const T* __restrict__ x,
                                         MultiArgs<T> a,
                                         T* __restrict__ partial,
                                         long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  for (long long i = system_index(); i < n; i += stride) {
    const T xi = x[i];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = acc[k] + xi * a.y[k][i];
  }
  block_sum_multi<T, K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partial[k * gridDim.x + blockIdx.x] = acc[k];
  }
}

template <typename T, int K>
__global__ void multi_final_kernel(const T* __restrict__ partial,
                                   int nparts, T* __restrict__ out) {
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = acc[k] + partial[k * nparts + i];
  }
  block_sum_multi<T, K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = acc[k];
  }
}

static inline unsigned stream_blocks(long long n, long long cap) {
  const long long g = (n + REPRO_THREADS - 1) / REPRO_THREADS;
  return (unsigned)(g < cap ? (g > 0 ? g : 1) : cap);
}

template <int K>
struct IntK {
  static constexpr int value = K;
};

// launch(IntK<K>{}) for the runtime K in [1, 8], then the launch's error
template <typename Launch>
static int with_k(int K, Launch&& launch) {
  switch (K) {
    case 1: launch(IntK<1>{}); break;
    case 2: launch(IntK<2>{}); break;
    case 3: launch(IntK<3>{}); break;
    case 4: launch(IntK<4>{}); break;
    case 5: launch(IntK<5>{}); break;
    case 6: launch(IntK<6>{}); break;
    case 7: launch(IntK<7>{}); break;
    case 8: launch(IntK<8>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  return with_k(K, [&](auto k) {
    lincomb_kernel<T, decltype(k)::value><<<g, REPRO_THREADS, 0, st>>>(
        a, (T*)z, n);
  });
}

template <typename T>
static MultiArgs<T> multi_args(int K, const void* const* ys,
                               const void* const* cs) {
  MultiArgs<T> a;
  for (int k = 0; k < MULTI_MAX_K; ++k) {
    a.y[k] = k < K ? (const T*)ys[k] : nullptr;
    a.c[k] = k < K && cs != nullptr ? (const T*)cs[k] : nullptr;
  }
  return a;
}

template <typename T>
static int scale_add_multi(int K, const void* x, const void* const* ys,
                           const void* const* cs, void* z, long long n,
                           void* stream) {
  if (K < 1 || K > MULTI_MAX_K) return (int)cudaErrorInvalidValue;
  const MultiArgs<T> a = multi_args<T>(K, ys, cs);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = stream_blocks(n, 1 << 16);
  return with_k(K, [&](auto k) {
    scale_add_multi_kernel<T, decltype(k)::value>
        <<<g, REPRO_THREADS, 0, st>>>((const T*)x, a, (T*)z, n);
  });
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

// m == nullptr: the plain weighted sum of squares
template <typename T>
static int wrms_ss(const void* x, const void* w, const void* m,
                   void* partial, void* out, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = stream_blocks(n, DOT_MAX_BLOCKS);
  if (m == nullptr)
    wrms_partial_kernel<T, false><<<g, REPRO_THREADS, 0, st>>>(
        (const T*)x, (const T*)w, nullptr, (T*)partial, n);
  else
    wrms_partial_kernel<T, true><<<g, REPRO_THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)m, (T*)partial, n);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dot_final_kernel<T><<<1, REPRO_THREADS, 0, st>>>((const T*)partial, (int)g,
                                                   (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int multi_dot(int K, const void* x, const void* const* ys,
                     void* partial, void* out, long long n, void* stream) {
  if (K < 1 || K > MULTI_MAX_K) return (int)cudaErrorInvalidValue;
  const MultiArgs<T> a = multi_args<T>(K, ys, nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = stream_blocks(n, DOT_MAX_BLOCKS);
  const int rc = with_k(K, [&](auto k) {
    multi_dot_partial_kernel<T, decltype(k)::value>
        <<<g, REPRO_THREADS, 0, st>>>((const T*)x, a, (T*)partial, n);
  });
  if (rc != 0) return rc;
  return with_k(K, [&](auto k) {
    multi_final_kernel<T, decltype(k)::value><<<1, REPRO_THREADS, 0, st>>>(
        (const T*)partial, (int)g, (T*)out);
  });
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

extern "C" int scale_add_multi_f32(int K, const void* x,
                                   const void* const* ys,
                                   const void* const* cs, void* z,
                                   long long n, void* stream) {
  return scale_add_multi<float>(K, x, ys, cs, z, n, stream);
}

extern "C" int scale_add_multi_f64(int K, const void* x,
                                   const void* const* ys,
                                   const void* const* cs, void* z,
                                   long long n, void* stream) {
  return scale_add_multi<double>(K, x, ys, cs, z, n, stream);
}

extern "C" int dot_f32(const void* x, const void* y, void* partial,
                       void* out, long long n, void* stream) {
  return dot<float>(x, y, partial, out, n, stream);
}

extern "C" int dot_f64(const void* x, const void* y, void* partial,
                       void* out, long long n, void* stream) {
  return dot<double>(x, y, partial, out, n, stream);
}

extern "C" int wrms_ss_f32(const void* x, const void* w, const void* m,
                           void* partial, void* out, long long n,
                           void* stream) {
  return wrms_ss<float>(x, w, m, partial, out, n, stream);
}

extern "C" int wrms_ss_f64(const void* x, const void* w, const void* m,
                           void* partial, void* out, long long n,
                           void* stream) {
  return wrms_ss<double>(x, w, m, partial, out, n, stream);
}

extern "C" int dot_prod_multi_f32(int K, const void* x,
                                  const void* const* ys, void* partial,
                                  void* out, long long n, void* stream) {
  return multi_dot<float>(K, x, ys, partial, out, n, stream);
}

extern "C" int dot_prod_multi_f64(int K, const void* x,
                                  const void* const* ys, void* partial,
                                  void* out, long long n, void* stream) {
  return multi_dot<double>(K, x, ys, partial, out, n, stream);
}
