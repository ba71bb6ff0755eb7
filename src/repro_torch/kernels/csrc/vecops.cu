// N_Vector kernels over flat contiguous vectors of n elements.
//
// Replaces src/repro/kernels/vecops.py:
//   _lincomb_kernel         -> lincomb_kernel       (z = sum_k c_k x_k)
//   _scale_add_multi_kernel -> scale_add_multi_kernel
//                                                (z_k = c_k x + y_k)
//   _wrms_kernel            -> onepass_reduce_kernel<T, 2, RED_WRMS>
//                                                (sum (x w)^2)
//   _wrms_mask_kernel       -> onepass_reduce_kernel<T, 3, RED_WRMS_MASK>
//                                                (sum (x w m)^2)
//   _dot_kernel             -> onepass_reduce_kernel<T, 2, RED_DOT>
//                                                (<x, y>)
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
// The reductions are deterministic: the same values give the same bits
// on every run and wherever they lie in memory, so an integrator's host
// decisions (the Newton convergence test, the error test) repeat.  No
// floating-point atomics.
//
// The dot and the weighted sums of squares (onepass_reduce_kernel) take
// one launch.  The caller's plan (kernels/vecops.py reduction_plan, from
// n and the dtype alone) gives each of at most RED_MAX_BLOCKS blocks
// (two a SM on the H100's 132) one chunk of `chunk` elements, the last
// block the rest.  Thread t sums the chunk's elements t, t+256, t+512,
// ... in increasing order, RED_UNROLL of them a trip, every input's
// loads of the trip issued before the first add (eight 8-byte loads an
// input in flight a thread, any alignment, so views at any offset need
// no special case).  The loads are streaming (ld.global.cs): in GMRES,
// where the vector op before each dot leaves L2 full of dirty lines,
// the dot ran faster with them than with plain loads by more than the
// plain product after it, which reads V[i] again, lost (device time on
// the Arnoldi cycle of tools/reduction_variants.py and on paths H and I
// of chip_smoke.py; PERF.md).  Then the warp-shuffle tree and the eight
// warp sums in order (block_sum): the order depends on n alone, so the
// same values give the same bits wherever they lie.  Each block writes
// its partial, fences, and takes a ticket; the last to arrive sums the
// partials in index order (the same thread-strided sum and tree),
// writes the result and resets the ticket counter to 0 for the next
// launch on the stream.  A float32 reduction sums its float32 terms in
// float64 (RedAcc: the threads' sums, the block sums, the partials)
// and rounds once at the end: a thread's sequential sum runs over up to
// n / (264 * 256) terms (~2800 on a 189.5 M-element gradient), where a
// float32 sum lost 1.9e-6 against a float64 dot of the same leaf, 13x
// the plain version's tree (PERF.md, PR 26).
#include "common.cuh"

#define LINCOMB_MAX_K 8
// vectors the fused multi-vector ops take (scale_add_multi, multi-dot)
#define MULTI_MAX_K 8
// the most partial sums the multi-dot writes per output: the size of
// the caller's scratch over K
#define DOT_MAX_BLOCKS 1024
// blocks of a one-launch reduction, at most: two a SM on the H100's 132
// (a constant, not read from the device, so the bits repeat on any
// card); the size of the caller's partial sums (RED_MAX_BLOCKS in
// kernels/vecops.py)
#define RED_MAX_BLOCKS 264
// elements a thread loads from each input before it adds them
#define RED_UNROLL 8

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

enum { RED_DOT = 0, RED_WRMS = 1, RED_WRMS_MASK = 2 };

// one element's term: x*y; (x*w)^2; (x*w*m)^2, rounded as the plain
// versions round them
template <typename T, int OP>
__device__ __forceinline__ T red_term(const T (&v)[3]) {
  if (OP == RED_DOT) return v[0] * v[1];
  T u = v[0] * v[1];
  if (OP == RED_WRMS_MASK) u = u * v[2];
  return u * u;
}

// the end of a one-launch reduction: the block's sum of acc goes to
// partial[blockIdx.x]; the last block to take a ticket sums the
// gridDim.x partials in index order (thread-strided, then block_sum),
// writes out[0] (rounded to T) and sets the counter back to 0
template <typename A, typename T>
__device__ void finish_reduce(A acc, A* __restrict__ partial,
                              unsigned* __restrict__ ticket,
                              T* __restrict__ out) {
  __shared__ int is_last;
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // every other block's partial is written and fenced
  __threadfence();
  A sum = A(0);
  for (int i = threadIdx.x; i < (int)gridDim.x; i += REPRO_THREADS)
    sum = sum + __ldcg(partial + i);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    out[0] = (T)sum;
    *ticket = 0u;
  }
}

template <typename T>
struct RedArgs {
  const T* p[3];
};

// a reduction's accumulator: float64 for float32 terms
template <typename T>
struct RedAcc {
  using type = T;
};
template <>
struct RedAcc<float> {
  using type = double;
};

// sum over all n elements of red_term<T, OP> of the NIN inputs, into
// out[0]; partial holds gridDim.x block sums (in RedAcc<T>), ticket is 0
// at entry and is left 0.  Block b owns elements [b*chunk, min((b+1)*
// chunk, n)).
template <typename T, int NIN, int OP>
__global__ void __launch_bounds__(REPRO_THREADS, 2)
    onepass_reduce_kernel(RedArgs<T> a,
                          typename RedAcc<T>::type* __restrict__ partial,
                          unsigned* __restrict__ ticket,
                          T* __restrict__ out, long long n,
                          long long chunk) {
  using A = typename RedAcc<T>::type;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long len = n - c0 < chunk ? n - c0 : chunk;
  const T* p[NIN];
#pragma unroll
  for (int v = 0; v < NIN; ++v) p[v] = a.p[v] + c0;
  A acc = A(0);
  for (long long base = threadIdx.x; base < len;
       base += (long long)RED_UNROLL * REPRO_THREADS) {
    T val[RED_UNROLL][3];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      const long long i = base + (long long)u * REPRO_THREADS;
#pragma unroll
      for (int v = 0; v < NIN; ++v)
        val[u][v] = i < len ? __ldcs(p[v] + i) : T(0);
    }
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u)
      if (base + (long long)u * REPRO_THREADS < len)
        acc = acc + (A)red_term<T, OP>(val[u]);
  }
  finish_reduce(acc, partial, ticket, out);
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

// one onepass_reduce_kernel launch over the plan (blocks, chunk); a plan
// that does not cover [0, n) with whole 16-byte chunks is refused
template <typename T, int NIN, int OP>
static int reduce(const void* const* ps, void* partial, void* ticket,
                  void* out, long long n, int blocks, long long chunk,
                  void* stream) {
  const long long align = 16 / (long long)sizeof(T);
  if (n < 0 || blocks < 1 || blocks > RED_MAX_BLOCKS || chunk < 1 ||
      chunk % align != 0 || (long long)blocks * chunk < n ||
      (long long)(blocks - 1) * chunk >= (n > 0 ? n : 1))
    return (int)cudaErrorInvalidValue;
  RedArgs<T> a;
  for (int v = 0; v < 3; ++v) a.p[v] = v < NIN ? (const T*)ps[v] : nullptr;
  onepass_reduce_kernel<T, NIN, OP>
      <<<(unsigned)blocks, REPRO_THREADS, 0, (cudaStream_t)stream>>>(
          a, (typename RedAcc<T>::type*)partial, (unsigned*)ticket,
          (T*)out, n, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
static int dot(const void* x, const void* y, void* partial, void* ticket,
               void* out, long long n, int blocks, long long chunk,
               void* stream) {
  const void* ps[2] = {x, y};
  return reduce<T, 2, RED_DOT>(ps, partial, ticket, out, n, blocks, chunk,
                               stream);
}

// m == nullptr: the plain weighted sum of squares
template <typename T>
static int wrms_ss(const void* x, const void* w, const void* m,
                   void* partial, void* ticket, void* out, long long n,
                   int blocks, long long chunk, void* stream) {
  const void* ps[3] = {x, w, m};
  if (m == nullptr)
    return reduce<T, 2, RED_WRMS>(ps, partial, ticket, out, n, blocks, chunk,
                                  stream);
  return reduce<T, 3, RED_WRMS_MASK>(ps, partial, ticket, out, n, blocks,
                                     chunk, stream);
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
                       void* ticket, void* out, long long n, int blocks,
                       long long chunk, void* stream) {
  return dot<float>(x, y, partial, ticket, out, n, blocks, chunk, stream);
}

extern "C" int dot_f64(const void* x, const void* y, void* partial,
                       void* ticket, void* out, long long n, int blocks,
                       long long chunk, void* stream) {
  return dot<double>(x, y, partial, ticket, out, n, blocks, chunk, stream);
}

extern "C" int wrms_ss_f32(const void* x, const void* w, const void* m,
                           void* partial, void* ticket, void* out,
                           long long n, int blocks, long long chunk,
                           void* stream) {
  return wrms_ss<float>(x, w, m, partial, ticket, out, n, blocks, chunk,
                      stream);
}

extern "C" int wrms_ss_f64(const void* x, const void* w, const void* m,
                           void* partial, void* ticket, void* out,
                           long long n, int blocks, long long chunk,
                           void* stream) {
  return wrms_ss<double>(x, w, m, partial, ticket, out, n, blocks, chunk,
                      stream);
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
