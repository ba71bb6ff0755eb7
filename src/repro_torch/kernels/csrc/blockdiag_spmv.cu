// Block-diagonal SpMV y[:, s] = A[:, :, s] x[:, s], SoA layout.
//
// Replaces src/repro/kernels/blockdiag_spmv.py:_spmv_kernel (the
// lsolve of BlockDiagGJ(factor_once=True): A is the saved inverse).
//
// Bound: memory.  2*b*b flops per system against (b*b + 2*b) values
// moved, i.e. under 0.25 flops per byte at any b.  Every form reads each
// entry of A once, coalesced across the warp, and sums each row in the
// reference's order: acc = A[i,0]*x[0], then acc = acc + A[i,j]*x[j] for
// j = 1..b-1, product and sum rounded separately (-fmad=false), so every
// form gives the plain version's bits.  Three forms, by block size:
//
// * b <= 8 (spmv_fixed_kernel): one thread per system, the system's x
//   in registers (template on B).
//
// * 9 <= b <= 32 (spmv_rows_kernel): a block of SPMV_WARPS = 8 warps
//   covers 32 consecutive systems, one a lane; warp w computes rows
//   i = w, w + 8, ... < b, each in its own accumulator (four at b = 32).
//   One thread per system would give 256 blocks at 2**16 systems, two a
//   SM, with one load in flight a thread behind a serial sum and x
//   re-read b times through L1; here there are nb / 32 blocks and each
//   A load, A[(i*b + j)*nb + s0 + lane], is one coalesced 256-byte run
//   (float64) a warp.  The block first stages x[0:b, s0:s0+32] in
//   shared memory, one warp a row of 32 systems; after one barrier every
//   thread reads x[j] there (lane = system: no bank conflicts) once for
//   all its rows.  The columns go in chunks of SPMV_CHUNK = 8 whose A
//   loads, for all the thread's rows, depend on no sum, so they issue
//   ahead of the sums; at b = 32 in float64 the body takes 48 registers
//   (no spills), five blocks fit a SM, and their 40 warps keep far more
//   than the ~20 KB a SM that Little's law asks of HBM in flight (chunks
//   of 4 time alike).
//   The path widths 16, 24 and 32 are template arguments (every guard
//   folds away); the other widths take the same body with a run-time b
//   and guarded loads.  A is read with plain read-only loads: streaming
//   loads (__ldcs) were faster alone after a reading L2 flush but not in
//   path K's device time (tools/spmv_variants.py).
//
// * b > 32 (spmv_any_kernel): one thread per system, x read through the
//   cache once for every row; no path of the port has b > 32.
#include "common.cuh"

#define SPMV_WARPS 8      // row groups of the row form, one a warp
#define SPMV_SYSTEMS 32   // systems a block of the row form covers, one a lane
#define SPMV_MAX_B 32     // widest block of the row form
#define SPMV_CHUNK 8      // columns whose loads a thread issues together

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

// B = 16, 24, 32, or 0: any 9 <= b <= 32, given at run time
template <typename T, int B>
__global__ void __launch_bounds__(32 * SPMV_WARPS)
spmv_rows_kernel(const T* __restrict__ A, const T* __restrict__ x,
                 T* __restrict__ y, int b_run, long long nb) {
  constexpr int WIDTH = B ? B : SPMV_MAX_B;     // columns unrolled
  constexpr int R = WIDTH / SPMV_WARPS;         // rows a thread may own
  const int b = B ? B : b_run;
  __shared__ T xs[WIDTH][SPMV_SYSTEMS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * SPMV_SYSTEMS + lane;
  const bool live = s < nb;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = w + SPMV_WARPS * r;
    if (B || j < b) xs[j][lane] = live ? x[j * nb + s] : T(0);
  }
  __syncthreads();
  if (!live) return;
  // row r of this thread is i = w + 8r; A[i, j] lies at (i*b + j)*nb + s
  const T* a = A + (long long)w * b * nb + s;
  T acc[R];
#pragma unroll
  for (int j0 = 0; j0 < WIDTH; j0 += SPMV_CHUNK) {
    if (!B && j0 >= b) break;
    T v[R][SPMV_CHUNK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < SPMV_CHUNK; ++k)
        if (B || (w + SPMV_WARPS * r < b && j0 + k < b))
          v[r][k] = __ldg(a + (long long)(SPMV_WARPS * r * b + j0 + k) * nb);
#pragma unroll
    for (int k = 0; k < SPMV_CHUNK; ++k) {
      if (!B && j0 + k >= b) break;
      const T xj = xs[j0 + k][lane];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (B || w + SPMV_WARPS * r < b)
          acc[r] = j0 + k == 0 ? v[r][k] * xj : acc[r] + v[r][k] * xj;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + SPMV_WARPS * r;
    if (B || i < b) y[i * nb + s] = acc[r];
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
  const dim3 rows((unsigned)((nb + SPMV_SYSTEMS - 1) / SPMV_SYSTEMS));
  switch (b) {
#define REPRO_CASE(B)                                                       \
  case B:                                                                   \
    spmv_fixed_kernel<T, B><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, nb);    \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
#define REPRO_CASE(B)                                                       \
  case B:                                                                   \
    spmv_rows_kernel<T, B><<<rows, 32 * SPMV_WARPS, 0, st>>>(a, xv, yv, b,  \
                                                              nb);          \
    break;
    REPRO_CASE(16) REPRO_CASE(24) REPRO_CASE(32)
#undef REPRO_CASE
    default:
      if (b <= SPMV_MAX_B)
        spmv_rows_kernel<T, 0><<<rows, 32 * SPMV_WARPS, 0, st>>>(a, xv, yv, b,
                                                                 nb);
      else
        spmv_any_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, xv, yv, b, nb);
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
