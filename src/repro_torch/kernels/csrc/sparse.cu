// Ensemble block-sparse SpMV with one pattern shared by every system,
// SoA layout: values (nnzb, b, b, nb), x (nblk, b, nb) -> y (nblk, b, nb),
// y_I = sum over the blocks e of block row I of A_e x_{bcols[e]}.
//
// Replaces src/repro/kernels/sparse.py:_bsr_spmv_kernel (the Krylov
// matvec of the sparse ensemble: 1x1 blocks over the Jacobian pattern).
//
// The TPU kernel compiles the pattern into its instruction stream.
// Here the pattern is a property of the run, not of the compiled code:
// the caller hands it over as three small int32 device arrays, built
// once per pattern: the block-row pointer, the block column of each
// entry, and the entry's value slot (entries sorted stably by block
// row, so each row keeps the reference's e order).
//
// Bound: memory.  2*b*b flops per block entry and system against
// (b*b + b) values read: under 0.1 flops per byte.  One thread owns one
// (block row, system) pair, systems fastest across the warp, so every
// load of values[e, i, j, s] and x[J, j, s] and every store of y is
// coalesced; the pattern arrays are the same for the whole warp (one
// broadcast load).  For b <= 8 the row's b sums stay in registers
// (template on B); they accumulate in the reference's order: per
// entry, the inner j sum, then added to the row's running total.  A
// block row with no entries writes zeros.  Each value is read once; x
// is read once per entry of its block column (from L2 after the first).
#include "common.cuh"

template <typename T, int B>
__global__ void bsr_spmv_fixed_kernel(const T* __restrict__ values,
                                      const T* __restrict__ x,
                                      T* __restrict__ y,
                                      const int* __restrict__ row_ptr,
                                      const int* __restrict__ cols,
                                      const int* __restrict__ slots,
                                      long long nb) {
  const long long s = system_index();
  const int I = blockIdx.y;
  if (s >= nb) return;
  const int e0 = row_ptr[I], e1 = row_ptr[I + 1];
  T acc[B];
#pragma unroll
  for (int i = 0; i < B; ++i) acc[i] = T(0);
  for (int e = e0; e < e1; ++e) {
    const long long J = cols[e];
    const long long v = slots[e];
    T xr[B];
#pragma unroll
    for (int j = 0; j < B; ++j) xr[j] = x[(J * B + j) * nb + s];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const T* a = values + ((v * B + i) * B) * nb + s;
      T c = a[0] * xr[0];
#pragma unroll
      for (int j = 1; j < B; ++j) c = c + a[j * nb] * xr[j];
      acc[i] = e == e0 ? c : acc[i] + c;
    }
  }
#pragma unroll
  for (int i = 0; i < B; ++i) y[((long long)I * B + i) * nb + s] = acc[i];
}

// any b: the row's running sums live in y itself
template <typename T>
__global__ void bsr_spmv_any_kernel(const T* __restrict__ values,
                                    const T* __restrict__ x,
                                    T* __restrict__ y,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ cols,
                                    const int* __restrict__ slots, int b,
                                    long long nb) {
  const long long s = system_index();
  const int I = blockIdx.y;
  if (s >= nb) return;
  const int e0 = row_ptr[I], e1 = row_ptr[I + 1];
  T* yr = y + ((long long)I * b) * nb + s;
  if (e0 == e1) {
    for (int i = 0; i < b; ++i) yr[i * nb] = T(0);
    return;
  }
  for (int e = e0; e < e1; ++e) {
    const long long J = cols[e];
    const long long v = slots[e];
    const T* xr = x + (J * b) * nb + s;
    for (int i = 0; i < b; ++i) {
      const T* a = values + ((v * b + i) * b) * nb + s;
      T c = a[0] * xr[0];
      for (int j = 1; j < b; ++j) c = c + a[(long long)j * nb] * xr[j * nb];
      yr[i * nb] = e == e0 ? c : yr[i * nb] + c;
    }
  }
}

template <typename T>
static int bsr_spmv(const void* values, const void* x, void* y,
                    const void* row_ptr, const void* cols, const void* slots,
                    int b, int nblk, long long nb, void* stream) {
  if (nblk < 1 || nblk > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* v = (const T*)values;
  const T* xv = (const T*)x;
  T* yv = (T*)y;
  const int* rp = (const int*)row_ptr;
  const int* cs = (const int*)cols;
  const int* sl = (const int*)slots;
  const dim3 g(system_grid(nb).x, (unsigned)nblk);
#define REPRO_BSR(B)                                                   \
  bsr_spmv_fixed_kernel<T, B><<<g, REPRO_THREADS, 0, st>>>(v, xv, yv, rp, \
                                                             cs, sl, nb)
  switch (b) {
    case 1: REPRO_BSR(1); break;
    case 2: REPRO_BSR(2); break;
    case 3: REPRO_BSR(3); break;
    case 4: REPRO_BSR(4); break;
    case 5: REPRO_BSR(5); break;
    case 6: REPRO_BSR(6); break;
    case 7: REPRO_BSR(7); break;
    case 8: REPRO_BSR(8); break;
    default:
      bsr_spmv_any_kernel<T><<<g, REPRO_THREADS, 0, st>>>(v, xv, yv, rp, cs,
                                                          sl, b, nb);
  }
#undef REPRO_BSR
  return (int)cudaGetLastError();
}

extern "C" int bsr_spmv_f32(const void* values, const void* x, void* y,
                            const void* row_ptr, const void* cols,
                            const void* slots, int b, int nblk, long long nb,
                            void* stream) {
  return bsr_spmv<float>(values, x, y, row_ptr, cols, slots, b, nblk, nb,
                         stream);
}

extern "C" int bsr_spmv_f64(const void* values, const void* x, void* y,
                            const void* row_ptr, const void* cols,
                            const void* slots, int b, int nblk, long long nb,
                            void* stream) {
  return bsr_spmv<double>(values, x, y, row_ptr, cols, slots, b, nblk, nb,
                          stream);
}

// ---------------------------------------------------------------------------
// Scalar CSR SpMV: y = A x for one matrix, data (nnz,), x (ncols,),
// y (nrows,), with the pattern as int32 row pointer (nrows+1,) and
// columns (nnz,), built once per pattern on the device.
//
// Replaces src/repro/kernels/sparse.py:_csr_ell_kernel (entry
// csr_spmv_ell; SparseCSR.matvec, the Newton-Krylov matvec of a CSR
// Newton matrix).
//
// The TPU kernel pads the pattern to ELL form, (kmax, rows) with rows
// on the 128 lanes and padded slots (data 0, column 0), and gathers
// from a VMEM-resident x.  ELL is a TPU layout device and is not
// carried over: here one thread owns one row and reads the row's
// entries straight from the CSR arrays, so every value and index is
// read once and no gather pass to ELL runs on each call; the row count
// is bounds-checked instead of padded, and a row with no entries gives
// 0.  The sum keeps the TPU kernel's order: slot 0 first, then
// acc + d*x slot by slot (with -fmad=false a rounded product and a
// rounded sum, as the plain version's separate ops round).
//
// Bound: memory.  2 flops per entry against 12-16 bytes of data and
// column, plus the row pointer, x and y.  Neighbouring threads own
// neighbouring rows, so the row pointer and y are coalesced; data and
// columns are read in strides of the row length (4 entries a row on
// the Brusselator's pattern), which sectors serve only partly, and x
// is gathered (from L2 where rows are local).  A warp per row with
// vectorised loads is later work.
template <typename T>
__global__ void csr_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                long long nrows) {
  const long long i = system_index();
  if (i >= nrows) return;
  const int k0 = indptr[i], k1 = indptr[i + 1];
  T acc = T(0);
  if (k0 < k1) {
    acc = data[k0] * x[indices[k0]];
    for (int k = k0 + 1; k < k1; ++k) acc = acc + data[k] * x[indices[k]];
  }
  y[i] = acc;
}

template <typename T>
static int csr_spmv(const void* data, const void* x, void* y,
                    const void* indptr, const void* indices, long long nrows,
                    void* stream) {
  if (nrows < 1) return (int)cudaErrorInvalidValue;
  csr_spmv_kernel<T><<<system_grid(nrows), REPRO_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const T*)data, (const T*)x, (T*)y, (const int*)indptr,
      (const int*)indices, nrows);
  return (int)cudaGetLastError();
}

extern "C" int csr_spmv_f32(const void* data, const void* x, void* y,
                            const void* indptr, const void* indices,
                            long long nrows, void* stream) {
  return csr_spmv<float>(data, x, y, indptr, indices, nrows, stream);
}

extern "C" int csr_spmv_f64(const void* data, const void* x, void* y,
                            const void* indptr, const void* indices,
                            long long nrows, void* stream) {
  return csr_spmv<double>(data, x, y, indptr, indices, nrows, stream);
}
