// Batched no-pivot Gauss-Jordan of every b x b block, SoA layout: the
// inverse (the lsetup of BlockDiagGJ) and the solve A x = r (its
// factor_once=False lsolve, and the DIRK stage Newton solve).
//
// Replaces src/repro/kernels/block_solve.py:
//   _gj_inverse_kernel        (b <= 8) -> gj_inverse_unrolled_kernel, and
//                                         with the Newton blocks formed
//                                         in it, newton_block_inverse_kernel
//   _gj_tiled_inverse_kernel  (b > 8)  -> gj_inverse_warp_kernel (b <= 32),
//                                         gj_inverse_inplace_kernel (b > 32)
//   _gj_kernel                (b <= 8) -> gj_solve_unrolled_kernel
//   _gj_tiled_kernel          (b > 8)  -> gj_solve_warp_kernel (b <= 32),
//                                         gj_solve_tiled_kernel (b > 32)
// with the reference's arithmetic: no pivoting, row scaling by
// 1/max(max_j |A_ij|, 1e-30) applied to A and to r (or I), the same
// elimination order (normalise the pivot row, then eliminate column k
// from every other row); the b > 8 inverse works in place and
// post-scales the columns (block_solve.py:186-189).
//
// Three forms, by block size:
//
// * b <= 8: one thread per system, the augmented [A | I] or [A | r] in
//   registers (template on B).  Bound: memory.  At b = 3 a system moves
//   2*b*b values for the inverse (144 bytes in float64) or b*b + 2*b
//   for the solve (120 bytes) and does ~100 flops, under 1 flop per
//   byte, below the H100's float64 balance (~10 flops per byte).  A is
//   read once and the result written once, coalesced across the warp.
//   At b = 8 in float64 the inverse's 128 values exceed the register
//   file and spill to local memory (off every ported path).
//
// * 9 <= b <= 32: one warp per system, row i of the system in lane i.
//   A block of GJ_WARPS = 4 warps owns as many consecutive systems.  Its
//   threads copy the block's (b, b, 4) slice of A (and (b, 4) of r)
//   into a shared-memory tile with cp.async, consecutive threads on
//   consecutive systems, so each (i, j) entry is one run of 4 values
//   (32 bytes in float64, one sector) and HBM sees each byte once; the
//   result goes back out the same way.  Lane i keeps row i in
//   registers, T a[32], loops over columns unrolled to 32 and guarded
//   by < b, so the array is never indexed at run time.  At pivot step k
//   lane k stores its row into a per-warp pivot row in shared memory,
//   the lanes normalise one column each, and every lane reads the
//   normalised row back as broadcasts (two columns a load) and
//   eliminates.  Bound: at b = 32 in float64 the inverse moves 16 KB a
//   system and does ~131k flops (the solve 8.7 KB, ~34k flops): with
//   -fmad=false each update is a product and a difference, so the
//   float64 pipes (64 lanes a SM) take about as long as HBM.  On the
//   H100 the copies in and out take a large share of the kernel (32-byte
//   runs from 1024 places at once reach only part of HBM's rate) and
//   the elimination, float64 bound, the rest.  The inverse runs its
//   pivot loop at run time over rotated rows, the solve unrolls it
//   (gj_inverse_rows, gj_solve_rows).  Rows lie in the tile at an odd
//   stride (b + 1 rounded up), so lane i's reads of row i hit distinct
//   banks; the systems' slots are padded so the copies spread over the
//   banks too.  Lanes i >= b hold nothing.
//
// * b > 32: one thread per system working in device memory with the
//   system axis last, so b has no cap: the inverse in the output
//   tensor, the solve in a (b, b+1, nb) scratch tensor the wrapper
//   allocates.  This form streams its working set about b times
//   through L2 and HBM, once per pivot step, far above its bound; no
//   path of the port has b > 32.
//
// The lsetup of BlockDiagGJ(factor_once=True) at b <= 8 is one launch,
// newton_block_inverse_kernel: it forms each Newton block M = I -
// gamma*J as the plain newton_blocks_soa does, entry (i, j) T(i == j) -
// gamma*J[i][j] with the product rounded alone, and inverts it with
// gj_inverse_unrolled_kernel's arithmetic.  Composed, the plain build
// wrote M (an eye, a product and a difference over (b, b, nb)) and row
// 6 read it back; fused, a system reads J and gamma and writes M^-1
// once, 152 bytes at b = 3 in float64.  One thread a system, M and the
// identity's half in registers (gj_inverse_regs: every update kept, so
// the bits are row 6's, zero signs and non-finite systems included), in
// blocks of INVERSE_THREADS = 64: 16384 systems (path M's decay chain at
// b = 6) fill 256 blocks on the 132 SMs, where blocks of 256 filled 64.
// Float64: 46 registers at b = 3, 116 at 6, 190 at 8, no spills.  Over
// 16384 systems blocks of 256 took 7 % longer at b = 6 and 10 % at
// b = 8; a group of 8 lanes a system, lane r holding row r of [M | I]
// and taking the pivot row by shuffles, 24 % and 22 % longer (48
// registers, 24 bytes spilled), its shuffles as costly as the updates
// they spread (tools/newton_fused_variants.py: inverse_256; the group
// form was timed by an earlier version of that tool and is not kept);
// at b = 3 over 2**20 the three take the same time.
#include <cuda_pipeline.h>

#include "common.cuh"

#define INVERSE_THREADS 64  // block of newton_block_inverse_kernel

// [a | r] with r the identity, eliminated in registers: the row
// scaling, then for each pivot the pivot row's scaling and the update of
// every other row; r ends as a^-1
template <typename T, int B>
__device__ __forceinline__ void gj_inverse_regs(T (&a)[B][B], T (&r)[B][B]) {
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
}

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
  gj_inverse_regs<T, B>(a, r);
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) X[(i * B + j) * nb + s] = r[i][j];
}

// (I - gamma*J)^-1 of every b = B <= 8 block (see the note above)
template <typename T, int B>
__global__ void __launch_bounds__(INVERSE_THREADS)
newton_block_inverse_kernel(const T* __restrict__ J,
                            const T* __restrict__ gam, T* __restrict__ X,
                            long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  const T g = gam[s];
  T a[B][B], r[B][B];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) {
      a[i][j] = T(i == j) - g * J[(i * B + j) * nb + s];
      r[i][j] = (i == j) ? T(1) : T(0);
    }
  gj_inverse_regs<T, B>(a, r);
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


// ---------------------------------------------------------------------------
// 9 <= b <= 32: one warp per system, one row per lane, tile in shared memory
// ---------------------------------------------------------------------------

#define GJ_WARPS 4          // systems (one per warp) in a block's group
#define GJ_WARP_MAX_B 32
#define GJ_PIVOT_SLOTS 34   // a warp's pivot row: 32 columns, r at 32, a pad

template <typename T> struct pair_of;
template <> struct pair_of<double> { typedef double2 type; };
template <> struct pair_of<float> { typedef float2 type; };

// Row stride of a system in a tile: b + 1 (room for r) rounded up to
// odd, so the lanes' reads of their rows hit distinct banks.
__host__ __device__ inline int gj_row_stride(int b) { return b + 1 + (b & 1); }

// Stride between a group's systems, padded so that the GJ_WARPS systems
// of one entry fall on different banks in the copies.
template <typename T>
__host__ __device__ inline int gj_system_stride(int b) {
  const int wave = 128 / (int)sizeof(T);  // values one wavefront serves
  const int n = b * gj_row_stride(b);
  return n + ((wave / GJ_WARPS - n) % wave + wave) % wave;
}

// Offset of the warps' pivot rows, after the tile, 16-byte aligned.
template <typename T>
__host__ __device__ inline int gj_pivot_offset(int b) {
  return (GJ_WARPS * gj_system_stride<T>(b) + 3) & ~3;
}

template <typename T>
static size_t gj_smem_bytes(int b) {
  return (size_t)(gj_pivot_offset<T>(b) + GJ_WARPS * GJ_PIVOT_SLOTS) *
         sizeof(T);
}

// Systems in group grp: GJ_WARPS from grp * GJ_WARPS, fewer in the last.
__device__ __forceinline__ int gj_group_size(long long grp, long long nb) {
  return (int)min((long long)GJ_WARPS, nb - grp * GJ_WARPS);
}

// A group's systems of a (b, b, nb) matrix between device memory and
// the tile (IN: into the tile).  Thread t copies system t % GJ_WARPS of
// entries t / GJ_WARPS, + 32, + 64, ...: consecutive threads take
// consecutive systems of one entry.  The copy in is asynchronous
// (cp.async), so a thread has all its loads in flight at once;
// gj_copy_wait ends it.
template <typename T, bool IN>
__device__ __forceinline__ void gj_copy_matrix(const T* src, T* dst, int b,
                                               long long nb, long long grp) {
  const int g = threadIdx.x % GJ_WARPS;
  if (g >= gj_group_size(grp, nb)) return;
  const int rs = gj_row_stride(b), ss = gj_system_stride<T>(b);
  int ij = threadIdx.x / GJ_WARPS, i = ij / b, j = ij % b;
  long long m = (long long)ij * nb + grp * GJ_WARPS + g;
  for (; ij < b * b; ij += 32, m += 32 * nb) {
    const int t = g * ss + i * rs + j;
    if (IN)
      __pipeline_memcpy_async(dst + t, src + m, sizeof(T));
    else
      dst[m] = src[t];
    for (j += 32; j >= b; j -= b) ++i;
  }
}

// The same for a (b, nb) vector, which lies in the tile's column b.
template <typename T, bool IN>
__device__ __forceinline__ void gj_copy_vector(const T* src, T* dst, int b,
                                               long long nb, long long grp) {
  const int g = threadIdx.x % GJ_WARPS, i = threadIdx.x / GJ_WARPS;
  if (g >= gj_group_size(grp, nb) || i >= b) return;
  const int t = g * gj_system_stride<T>(b) + i * gj_row_stride(b) + b;
  const long long m = (long long)i * nb + grp * GJ_WARPS + g;
  if (IN)
    __pipeline_memcpy_async(dst + t, src + m, sizeof(T));
  else
    dst[m] = src[t];
}

// Waits for this thread's copies in, then for the whole block's.
__device__ __forceinline__ void gj_copy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Lane's row of the tile into registers, scaled by the row scale
// 1/max(max_j |a_j|, 1e-30), which it returns.  Lanes >= b and columns
// >= b hold zeros.
template <typename T>
__device__ __forceinline__ T gj_load_scaled_row(T (&a)[32], const T* row,
                                                int lane, int b) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = T(0);
    if (lane < b && j < b) a[j] = row[j];
  }
  T m = fabs(a[0]);
#pragma unroll
  for (int j = 1; j < 32; ++j)
    if (j < b) m = nan_max(m, fabs(a[j]));
  const T inv = T(1) / nan_max(m, T(1e-30));
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j < b) a[j] = a[j] * inv;
  return inv;
}

// Lane k's slots from lo (rounded down to even) to n from the
// normalised pivot row in buf.  Lane k runs the other lanes' update
// too and drops its result: one load for two slots costs less than a
// select for each.
template <typename T>
__device__ __forceinline__ void gj_reload(T (&a)[32], const T* buf, int lo,
                                          int n) {
  typedef typename pair_of<T>::type P;
#pragma unroll
  for (int p = 0; p < 32; p += 2) {
    if (p >= n) break;
    if (p + 1 < lo) continue;
    const P q = reinterpret_cast<const P*>(buf)[p / 2];
    a[p] = q.x;
    a[p + 1] = q.y;
  }
}

// The inverse runs its k loop at run time, with each lane's row kept
// ROTATED: at step k register slot p holds column (p + k) mod 32, so the
// pivot column is always slot 0 and no register is indexed at run time.
// A step ends by rotating one more slot, which the compiler resolves by
// renaming within GJ_UNROLL unrolled steps (moves once per group of
// steps).  All 32 steps unrolled make more code than the SM's
// instruction cache holds.
#define GJ_UNROLL 4

template <typename T>
__device__ __forceinline__ void gj_rotate(T (&a)[32]) {
  const T t = a[0];
#pragma unroll
  for (int p = 0; p < 31; ++p) a[p] = a[p + 1];
  a[31] = t;
}

// Inverse step k: lane k stores its row into the warp's pivot row buf;
// every lane takes 1/pivot and normalises slot lane (slot 0, the pivot
// column, becomes 1/pivot itself); the lanes eliminate, the pivot
// column becoming -f/pivot in place, and lane k takes the normalised
// row.  Columns >= b ride along as zeros (or junk); nothing reads them.
template <typename T>
__device__ __forceinline__ void gj_inverse_step(T (&a)[32], T* buf, int k,
                                                int lane) {
  typedef typename pair_of<T>::type P;
  if (lane == k) {
#pragma unroll
    for (int p = 0; p < 32; p += 2)
      reinterpret_cast<P*>(buf)[p / 2] = P{a[p], a[p + 1]};
  }
  __syncwarp();
  const T inv = T(1) / buf[0];
  const T v = lane == 0 ? inv : buf[lane] * inv;
  __syncwarp();
  buf[lane] = v;
  __syncwarp();
  const T f = a[0];
#pragma unroll
  for (int p = 0; p < 32; p += 2) {
    const P q = reinterpret_cast<const P*>(buf)[p / 2];
    a[p] = p == 0 ? -f * q.x : a[p] - f * q.x;
    a[p + 1] = a[p + 1] - f * q.y;
  }
  if (lane == k) gj_reload(a, buf, 0, 32);
  __syncwarp();
  gj_rotate(a);
}

// The in-place inverse of the lane's scaled row; returns with slot p
// holding column (p + b) mod 32.
template <typename T>
__device__ __forceinline__ void gj_inverse_rows(T (&a)[32], T* buf, int lane,
                                                int b) {
  int k = 0;
  for (; k + GJ_UNROLL <= b; k += GJ_UNROLL) {
#pragma unroll
    for (int u = 0; u < GJ_UNROLL; ++u) gj_inverse_step(a, buf, k + u, lane);
  }
  for (; k < b; ++k) gj_inverse_step(a, buf, k, lane);
}

// The solve of the lane's scaled row and r, its k loop unrolled to 32
// (k < b guarded): column k of a row is read as its factor at step k and
// never again, so step k touches only the columns right of k and r, and
// the unrolled code is small enough for the instruction cache.  Lane
// k stores its columns from the pair that holds k and r; lanes j in
// (k, b) normalise column j and lane k r; the lanes eliminate and lane
// k takes the normalised row.  Returns x_lane.
template <typename T>
__device__ __forceinline__ T gj_solve_rows(T (&a)[32], T x, T* buf, int lane,
                                           int b) {
  typedef typename pair_of<T>::type P;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k >= b) break;
    if (lane == k) {
#pragma unroll
      for (int p = 0; p < 32; p += 2)
        if (p + 1 >= k && p < b)
          reinterpret_cast<P*>(buf)[p / 2] = P{a[p], a[p + 1]};
      buf[32] = x;
    }
    __syncwarp();
    const T inv = T(1) / buf[k];
    const int slot = lane == k ? 32 : lane;
    const T v = buf[slot] * inv;
    __syncwarp();
    if (lane == k || (lane > k && lane < b)) buf[slot] = v;
    __syncwarp();
    const T f = a[k];
#pragma unroll
    for (int p = 0; p < 32; p += 2) {
      if (p >= b) break;
      if (p + 1 <= k) continue;
      const P q = reinterpret_cast<const P*>(buf)[p / 2];
      if (p > k) a[p] = a[p] - f * q.x;
      a[p + 1] = a[p + 1] - f * q.y;
    }
    x = x - f * buf[32];
    if (lane == k) {
      gj_reload(a, buf, k + 1, b);
      x = buf[32];
    }
    __syncwarp();
  }
  return x;
}

// Block x takes group x: its threads copy the group into the tile, each
// warp takes its system's rows into registers, eliminates and writes
// its result back into its slot, and the threads copy the results out.
// (Keeping blocks resident and copying the next group in while the
// warps eliminate, through a second tile, ran slower on the H100: twice
// the shared memory leaves fewer warps a SM.)
template <typename T, bool SOLVE>
__device__ __forceinline__ void gj_warp_form(const T* __restrict__ A,
                                             const T* __restrict__ r,
                                             T* __restrict__ X, int b,
                                             long long nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long grp = blockIdx.x;
  gj_copy_matrix<T, true>(A, tile, b, nb, grp);
  if (SOLVE) gj_copy_vector<T, true>(r, tile, b, nb, grp);
  gj_copy_wait();
  if (g < gj_group_size(grp, nb)) {  // warp-uniform: no __syncthreads inside
    T* row = tile + g * gj_system_stride<T>(b) + lane * gj_row_stride(b);
    T* buf = tile + gj_pivot_offset<T>(b) + g * GJ_PIVOT_SLOTS;
    T a[32];
    T x = SOLVE && lane < b ? row[b] : T(0);
    const T scale = gj_load_scaled_row(a, row, lane, b);
    if (SOLVE) {
      x = gj_solve_rows(a, x * scale, buf, lane, b);
      if (lane < b) row[b] = x;
    } else {
      gj_inverse_rows(a, buf, lane, b);
      // slot p holds column (p + b) mod 32.  Rows were pre-scaled by D:
      // a = (D A)^-1 = A^-1 D^-1, so scale the COLUMNS by the same
      // factors (lane c's) to recover A^-1
#pragma unroll
      for (int p = 0; p < 32; ++p) {
        const int c = (p + b) & 31;
        const T sc = __shfl_sync(0xffffffffu, scale, c);
        if (lane < b && c < b) row[c] = a[p] * sc;
      }
    }
  }
  __syncthreads();
  if (SOLVE)
    gj_copy_vector<T, false>(tile, X, b, nb, grp);
  else
    gj_copy_matrix<T, false>(tile, X, b, nb, grp);
}

template <typename T>
__global__ void __launch_bounds__(32 * GJ_WARPS)
gj_inverse_warp_kernel(const T* __restrict__ A, T* __restrict__ X, int b,
                       long long nb) {
  gj_warp_form<T, false>(A, nullptr, X, b, nb);
}

template <typename T>
__global__ void __launch_bounds__(32 * GJ_WARPS)
gj_solve_warp_kernel(const T* __restrict__ A, const T* __restrict__ r,
                     T* __restrict__ X, int b, long long nb) {
  gj_warp_form<T, true>(A, r, X, b, nb);
}

template <typename T, typename Kernel, typename... Args>
static int launch_warp_form(Kernel kernel, int b, long long nb,
                            cudaStream_t st, Args... args) {
  const size_t smem = gj_smem_bytes<T>(b);
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel was allowed that much
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((nb + GJ_WARPS - 1) / GJ_WARPS));
  kernel<<<grid, 32 * GJ_WARPS, smem, st>>>(args..., b, nb);
  return 0;
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
      if (b <= GJ_WARP_MAX_B) {
        const int e = launch_warp_form<T>(gj_inverse_warp_kernel<T>, b, nb,
                                          st, a, x);
        if (e != 0) return e;
      } else {
        gj_inverse_inplace_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, x, b,
                                                                  nb);
      }
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
static int newton_block_inverse(const void* J, const void* gam, void* X,
                                int b, long long nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g((unsigned)((nb + INVERSE_THREADS - 1) / INVERSE_THREADS));
  switch (b) {
#define REPRO_CASE(B)                                                      \
  case B:                                                                  \
    newton_block_inverse_kernel<T, B><<<g, INVERSE_THREADS, 0, st>>>(      \
        (const T*)J, (const T*)gam, (T*)X, nb);                            \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int newton_block_inverse_f32(const void* J, const void* gam,
                                        void* X, int b, long long nb,
                                        void* stream) {
  return newton_block_inverse<float>(J, gam, X, b, nb, stream);
}

extern "C" int newton_block_inverse_f64(const void* J, const void* gam,
                                        void* X, int b, long long nb,
                                        void* stream) {
  return newton_block_inverse<double>(J, gam, X, b, nb, stream);
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
      if (b <= GJ_WARP_MAX_B) {
        const int e = launch_warp_form<T>(gj_solve_warp_kernel<T>, b, nb, st,
                                          a, rr, x);
        if (e != 0) return e;
      } else {
        gj_solve_tiled_kernel<T><<<g, REPRO_THREADS, 0, st>>>(a, rr, x,
                                                              (T*)S, b, nb);
      }
  }
  return (int)cudaGetLastError();
}

// S: the (b, b+1, nb) scratch of the b > 32 form; unused (may be null)
// for b <= 32
extern "C" int block_solve_f32(const void* A, const void* r, void* X,
                               void* S, int b, long long nb, void* stream) {
  return block_solve<float>(A, r, X, S, b, nb, stream);
}

extern "C" int block_solve_f64(const void* A, const void* r, void* X,
                               void* S, int b, long long nb, void* stream) {
  return block_solve<double>(A, r, X, S, b, nb, stream);
}
