// Block-diagonal SpMV y[:, s] = A[:, :, s] x[:, s], SoA layout, one
// thread per system.
//
// Replaces src/repro/kernels/blockdiag_spmv.py:_spmv_kernel (the
// lsolve of BlockDiagGJ(factor_once=True): A is the saved inverse).
//
// Bound: memory.  2*b*b flops per system against (b*b + 2*b) values
// moved, i.e. under 0.2 flops per byte at b = 3.  The design reads each
// entry of A and x once, coalesced across the warp; for b <= 8 the
// system's x stays in registers (template on B), and the b*b products
// accumulate in the reference's order (j = 0..b-1).  Larger b takes a
// runtime-b loop that reads x through the cache.
#include "common.cuh"

template <typename T, int B>
__global__ void spmv_fixed_kernel(const T* __restrict__ A,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  T xr[B];
#pragma unroll
  for (int j = 0; j < B; ++j) xr[j] = x[j * nb + s];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    T acc = A[(i * B) * nb + s] * xr[0];
#pragma unroll
    for (int j = 1; j < B; ++j) acc = acc + A[(i * B + j) * nb + s] * xr[j];
    y[i * nb + s] = acc;
  }
}

template <typename T>
__global__ void spmv_any_kernel(const T* __restrict__ A,
                                const T* __restrict__ x, T* __restrict__ y,
                                int b, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  for (int i = 0; i < b; ++i) {
    T acc = A[((long long)i * b) * nb + s] * x[s];
    for (int j = 1; j < b; ++j)
      acc = acc + A[((long long)i * b + j) * nb + s] * x[j * nb + s];
    y[i * nb + s] = acc;
  }
}

template <typename T>
static int spmv(const void* A, const void* x, void* y, int b, long long nb,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* a = (const T*)A;
  const T* xv = (const T*)x;
  T* yv = (T*)y;
  const dim3 g = system_grid(nb);
  switch (b) {
    case 1: spmv_fixed_kernel<T, 1><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 2: spmv_fixed_kernel<T, 2><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 3: spmv_fixed_kernel<T, 3><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 4: spmv_fixed_kernel<T, 4><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 5: spmv_fixed_kernel<T, 5><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 6: spmv_fixed_kernel<T, 6><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 7: spmv_fixed_kernel<T, 7><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    case 8: spmv_fixed_kernel<T, 8><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb); break;
    default: spmv_any_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, b, nb);
  }
  return (int)cudaGetLastError();
}

extern "C" int blockdiag_spmv_f32(const void* A, const void* x, void* y,
                                  int b, long long nb, void* stream) {
  return spmv<float>(A, x, y, b, nb, stream);
}

extern "C" int blockdiag_spmv_f64(const void* A, const void* x, void* y,
                                  int b, long long nb, void* stream) {
  return spmv<double>(A, x, y, b, nb, stream);
}
