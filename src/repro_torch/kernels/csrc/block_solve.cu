// Batched no-pivot Gauss-Jordan of every b x b block, SoA layout, one
// thread per system: the inverse (the lsetup of BlockDiagGJ) and the
// solve A x = r (its factor_once=False lsolve, and the DIRK stage
// Newton solve).
//
// Replaces src/repro/kernels/block_solve.py:
//   _gj_inverse_kernel        (b <= 8) -> gj_inverse_unrolled_kernel
//   _gj_tiled_inverse_kernel  (b > 8)  -> gj_inverse_inplace_kernel
//   _gj_kernel                (b <= 8) -> gj_solve_unrolled_kernel
//   _gj_tiled_kernel          (b > 8)  -> gj_solve_tiled_kernel
// with the reference's arithmetic: no pivoting, row scaling by
// 1/max(max_j |A_ij|, 1e-30) applied to A and to r (or I), the same
// elimination order (normalise the pivot row, then eliminate column k
// from every other row); the b > 8 inverse works in place and
// post-scales the columns (block_solve.py:186-189).
//
// Bound: memory.  At b = 3 a system moves 2*b*b values for the inverse
// (144 bytes in float64) or b*b + 2*b for the solve (120 bytes) and
// does ~100 flops, under 1 flop per byte, below the H100's float64
// balance (~10 flops per byte).  The design reads A (and r) once and
// writes the result once, coalesced across the warp.  For b <= 8 the
// augmented [A | I] or [A | r] lives in registers (template on B; at
// b = 8 in float64 the inverse's 128 values exceed the register file
// and spill to local memory, which is off every ported path).  For
// b > 8 the elimination runs in device memory with the system axis
// last, so every access stays coalesced and b has no cap: the inverse
// in the output tensor, the solve in a (b, b+1, nb) scratch tensor the
// wrapper allocates.  Those b > 8 forms stream their working set
// (b*b or b*(b+1) values a system, 8.4 KB at b = 32 in float64) about
// b times through L2 and HBM, once per pivot step, instead of reading
// A once: their time is far above the bound.  Keeping the working set
// in shared memory is a later redesign.
#include "common.cuh"

template <typename T, int B>
__global__ void gj_inverse_unrolled_kernel(const T* __restrict__ A,
                                           T* __restrict__ X, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  T a[B][B], r[B][B];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) {
      a[i][j] = A[(i * B + j) * nb + s];
      r[i][j] = (i == j) ? T(1) : T(0);
    }
#pragma unroll
  for (int i = 0; i < B; ++i) {
    T m = fabs(a[i][0]);
#pragma unroll
    for (int j = 1; j < B; ++j) m = nan_max(m, fabs(a[i][j]));
    const T inv = T(1) / nan_max(m, T(1e-30));
#pragma unroll
    for (int j = 0; j < B; ++j) {
      a[i][j] = a[i][j] * inv;
      r[i][j] = r[i][j] * inv;
    }
  }
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const T inv_piv = T(1) / a[k][k];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      a[k][j] = a[k][j] * inv_piv;
      r[k][j] = r[k][j] * inv_piv;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (i == k) continue;
      const T f = a[i][k];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        a[i][j] = a[i][j] - f * a[k][j];
        r[i][j] = r[i][j] - f * r[k][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) X[(i * B + j) * nb + s] = r[i][j];
}

// 1/max(max_j |A[row, j]|, 1e-30) of one system's row
template <typename T>
__device__ __forceinline__ T row_scale(const T* __restrict__ A, int row,
                                       int b, long long nb, long long s) {
  T m = fabs(A[((long long)row * b) * nb + s]);
  for (int j = 1; j < b; ++j)
    m = nan_max(m, fabs(A[((long long)row * b + j) * nb + s]));
  return T(1) / nan_max(m, T(1e-30));
}

template <typename T>
__global__ void gj_inverse_inplace_kernel(const T* __restrict__ A,
                                          T* __restrict__ X, int b,
                                          long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
#define S(i, j) X[((long long)(i) * b + (j)) * nb + s]
  for (int i = 0; i < b; ++i) {
    const T inv = row_scale(A, i, b, nb, s);
    for (int j = 0; j < b; ++j)
      S(i, j) = A[((long long)i * b + j) * nb + s] * inv;
  }
  for (int k = 0; k < b; ++k) {
    const T inv = T(1) / S(k, k);
    for (int j = 0; j < b; ++j)
      if (j != k) S(k, j) = S(k, j) * inv;
    S(k, k) = inv;
    for (int i = 0; i < b; ++i) {
      if (i == k) continue;
      const T f = S(i, k);
      for (int j = 0; j < b; ++j)
        if (j != k) S(i, j) = S(i, j) - f * S(k, j);
      S(i, k) = -f * inv;
    }
  }
  // rows were pre-scaled by D: S = (D A)^-1 = A^-1 D^-1, so scale the
  // COLUMNS by the same factors to recover A^-1
  for (int j = 0; j < b; ++j) {
    const T inv = row_scale(A, j, b, nb, s);
    for (int i = 0; i < b; ++i) S(i, j) = S(i, j) * inv;
  }
#undef S
}

template <typename T, int B>
__global__ void gj_solve_unrolled_kernel(const T* __restrict__ A,
                                         const T* __restrict__ r,
                                         T* __restrict__ X, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  T a[B][B], x[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
#pragma unroll
    for (int j = 0; j < B; ++j) a[i][j] = A[(i * B + j) * nb + s];
    x[i] = r[i * nb + s];
  }
#pragma unroll
  for (int i = 0; i < B; ++i) {
    T m = fabs(a[i][0]);
#pragma unroll
    for (int j = 1; j < B; ++j) m = nan_max(m, fabs(a[i][j]));
    const T inv = T(1) / nan_max(m, T(1e-30));
#pragma unroll
    for (int j = 0; j < B; ++j) a[i][j] = a[i][j] * inv;
    x[i] = x[i] * inv;
  }
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const T inv_piv = T(1) / a[k][k];
#pragma unroll
    for (int j = 0; j < B; ++j) a[k][j] = a[k][j] * inv_piv;
    x[k] = x[k] * inv_piv;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (i == k) continue;
      const T f = a[i][k];
#pragma unroll
      for (int j = 0; j < B; ++j) a[i][j] = a[i][j] - f * a[k][j];
      x[i] = x[i] - f * x[k];
    }
  }
#pragma unroll
  for (int i = 0; i < B; ++i) X[i * nb + s] = x[i];
}

// The augmented [A | r] in S (b, b+1, nb).  Column k of a row is read as
// that row's factor at pivot step k and never again, so each step
// updates only the columns right of k and the r column: the solution
// column gets exactly the reference's arithmetic.  A step walks those
// columns in chunks of SOLVE_CHUNK: the chunk of the normalised pivot
// row stays in registers while every other row loads its chunk, so a
// thread keeps a chunk's loads in flight at once (each element still
// sees the same updates in the same order).
#define SOLVE_CHUNK 8

template <typename T>
__global__ void gj_solve_tiled_kernel(const T* __restrict__ A,
                                      const T* __restrict__ r,
                                      T* __restrict__ X, T* __restrict__ Sm,
                                      int b, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  const int w = b + 1;
#define S(i, j) Sm[((long long)(i) * w + (j)) * nb + s]
  for (int i = 0; i < b; ++i) {
    const T inv = row_scale(A, i, b, nb, s);
    for (int j = 0; j < b; ++j)
      S(i, j) = A[((long long)i * b + j) * nb + s] * inv;
    S(i, b) = r[(long long)i * nb + s] * inv;
  }
  for (int k = 0; k < b; ++k) {
    const T inv = T(1) / S(k, k);
    for (int j0 = k + 1; j0 <= b; j0 += SOLVE_CHUNK) {
      T p[SOLVE_CHUNK];
#pragma unroll
      for (int c = 0; c < SOLVE_CHUNK; ++c)
        if (j0 + c <= b) {
          p[c] = S(k, j0 + c) * inv;
          S(k, j0 + c) = p[c];
        }
      for (int i = 0; i < b; ++i) {
        if (i == k) continue;
        const T f = S(i, k);
        T v[SOLVE_CHUNK];
#pragma unroll
        for (int c = 0; c < SOLVE_CHUNK; ++c)
          if (j0 + c <= b) v[c] = S(i, j0 + c);
#pragma unroll
        for (int c = 0; c < SOLVE_CHUNK; ++c)
          if (j0 + c <= b) S(i, j0 + c) = v[c] - f * p[c];
      }
    }
  }
  for (int i = 0; i < b; ++i) X[(long long)i * nb + s] = S(i, b);
#undef S
}

template <typename T>
static int block_inverse(const void* A, void* X, int b, long long nb,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* a = (const T*)A;
  T* x = (T*)X;
  const dim3 g = system_grid(nb);
  switch (b) {
#define REPRO_CASE(B)                                                       \
  case B:                                                                   \
    gj_inverse_unrolled_kernel<T, B><<<g, REPRO_THREADS, 0, st>>>(a, x, nb); \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      gj_inverse_inplace_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, x, b, nb);
  }
  return (int)cudaGetLastError();
}

extern "C" int block_inverse_f32(const void* A, void* X, int b, long long nb,
                                 void* stream) {
  return block_inverse<float>(A, X, b, nb, stream);
}

extern "C" int block_inverse_f64(const void* A, void* X, int b, long long nb,
                                 void* stream) {
  return block_inverse<double>(A, X, b, nb, stream);
}

template <typename T>
static int block_solve(const void* A, const void* r, void* X, void* S, int b,
                       long long nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* a = (const T*)A;
  const T* rr = (const T*)r;
  T* x = (T*)X;
  const dim3 g = system_grid(nb);
  switch (b) {
#define REPRO_CASE(B)                                                  \
  case B:                                                              \
    gj_solve_unrolled_kernel<T, B><<<g, REPRO_THREADS, 0, st>>>(a, rr, \
                                                                x, nb); \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      gj_solve_tiled_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, rr, x, (T*)S,
                                                            b, nb);
  }
  return (int)cudaGetLastError();
}

// S: the (b, b+1, nb) scratch of the b > 8 form; unused (may be null)
// for b <= 8
extern "C" int block_solve_f32(const void* A, const void* r, void* X,
                               void* S, int b, long long nb, void* stream) {
  return block_solve<float>(A, r, X, S, b, nb, stream);
}

extern "C" int block_solve_f64(const void* A, const void* r, void* X,
                               void* S, int b, long long nb, void* stream) {
  return block_solve<double>(A, r, X, S, b, nb, stream);
}
