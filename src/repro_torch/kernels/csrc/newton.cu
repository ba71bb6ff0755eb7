// Ensemble Newton hot-loop kernels, SoA layout.
//
// Replaces src/repro/kernels/newton.py:
//   _newton_residual_kernel     -> newton_residual_kernel, and, fused
//                                  with blockdiag_spmv.py's _spmv_kernel
//                                  (b <= 8), newton_residual_lsolve_kernel
//   _masked_update_wrms_kernel  -> masked_update_wrms_kernel, and, fused
//                                  with the two above (b <= 8),
//                                  newton_update_kernel
//   _history_rescale_kernel     -> history_rescale_kernel (n <= 4),
//                                  history_rescale_loop_kernel (n > 4)
//   _wrms_soa_kernel            -> wrms_soa_kernel
//
// Bound: memory.  Each kernel does a handful of flops per element it
// streams (at most 2*q1 per output of the history rescale, and about
// 550 a system to form its rebuild matrix, see below), far below the
// H100's ~10 flops per byte of float64 balance, so the least time is
// the bytes moved over 3.35 TB/s.  The design moves each byte once:
// every input element is read once and every output element written
// once, in coalesced warp-wide accesses, with the per-system reduction
// of the WRMS kernels kept in registers instead of a second pass.
// Residual, masked update and WRMS: thread s owns system s.  (A block
// of 8 warps over 32 systems for the WRMS at n > 4, warp g summing
// components g, g+8, ..., times the same and sums in another order:
// tools/rescale_variants.py, wrms_rows.)
//
// The Newton iteration of BlockDiagGJ(factor_once=True) at b <= 8 is
// one launch, newton_residual_lsolve_kernel: dz = corr * (Minv @ -g),
// g = z - gamma*f - psi, corr = 2/(1+gamrat), CVODE's correction for
// the gamma drift since lsetup.  Composed, the same work took six
// launches: the residual (row 1) wrote -g, the SpMV (row 2) read it
// back, and four plain ops (1 + gamrat, its reciprocal, times 2, times
// the SpMV's output) formed corr and rescaled all of dz.  Fused, a
// thread reads z, f, psi (3b values), gamma, gamrat and its inverse
// (b*b) once and writes dz (b) once: at b = 3 in float64, 184 bytes a
// system against the composition's 328.  It forms -g in row 1's order
// (z - g*f, then - psi, then the sign), sums each row of Minv @ x in
// row 2's order (acc = A[i,0]*x[0], then acc + A[i,j]*x[j]) and corr as
// PyTorch's 2.0 / t does (the reciprocal of 1 + gamrat, times 2), each
// product, sum and quotient rounded alone: bit for bit the composition
// of the plain versions, and of the two kernels with the plain corr.
//
// The whole Newton iteration of BlockDiagGJ(factor_once=True) at b <= 8
// is one launch, newton_update_kernel: the dz of
// newton_residual_lsolve_kernel, never written, then the masked update
// z' = where(mask, z + dz, z) and the correction norm dn = sqrt(sum_k
// (dz*w)^2 / b) of masked_update_wrms_kernel, for every system, masked
// or not, each in its kernel's order: bit for bit the two launches it
// replaces.  A system reads z, f, psi, w (4b values), gamma, gamrat,
// Minv (b*b) and its mask byte and writes z' (b) and dn once: at b = 3
// in float64, 217 bytes a system against the two launches' 184 + 129
// (dz written and read back, z read twice).  Two forms by the number
// of systems nb, chosen at launch:
//
// * nb > GROUP_MAX_NB = 32768 (the main path's b = 3 over 2**20, path
//   M's bundles of 65536): one thread a system, as in the two kernels
//   it replaces, blocks of 256; float64 32 registers at b = 3, 48 at 6,
//   63 at 8, no spills.
//
// * nb <= GROUP_MAX_NB (path M's bundles of 4096 and 16384, its decay
//   chain at b = 6): a group of GROUP_LANES = 8 lanes a system, lane r
//   its row: it reads z, f, psi, w of row r and row r of Minv, forms -g
//   of its row, takes the other rows' from their lanes (group_shfl) to
//   sum its row of Minv @ x in row 2's order, updates its z, and lane 0
//   sums the rows' (dz*w)^2 in row 3's order; float64 32 registers at
//   b = 3 and 6, 40 at 8, no spills.  One thread a system puts 32768
//   systems in 128 blocks of 256, at most one a SM of the 132, each
//   thread a serial chain of b*b products after b*b + 4b loads; the
//   groups put 8x the threads on the card, each lane b products after
//   b + 4 loads.
//
// Measured (tools/newton_fused_variants.py, float64, H100 80GB HBM3,
// each form forced at every nb): over 4096 to 32768 systems the groups
// take 5-45 % less time at b = 3..8 (at b = 6 over 16384, 0.0113
// against 0.0146 ms), at b = 2 the same up to 16384 and 6 % more at
// 32768, at b = 1 5 % more; over 65536 they are within 3 % at b = 5..8
// and take 8-18 % more at b = 1..4 (b = 3: 0.0140 against 0.0129 ms);
// over 2**17 to 2**20 7-81 % more (at b = 3 over 2**20, 0.1131 against
// 0.0857 ms: five of eight lanes idle).  Blocks of 64 in place of 256
// changed neither form's best time (update_thread64, update_group64).
//
// The history rescale Z'[j] = sum_i W[j,i] Z[i] (Z (q1, n, nb)) takes W
// from one of two sources (RescaleSource):
//
// * W_FROM_MEMORY: the (q1, q1, nb) tensor W, entry history_rescale
//   (the reference's op history_rescale_soa);
// * W_FROM_ETA: the BDF's Lagrange rebuild matrix (q1 = 6), formed in
//   the kernel from each system's step ratio eta and valid history
//   count q, entry lagrange_rescale.  Its plain version builds W with
//   lagrange_matrix_soa, some 60 launches over (6, 6, nb) tensors; the
//   kernel reads 13 bytes a system instead of W's 288 and never writes
//   W.  Each entry takes the plain build's arithmetic in its order
//   (lagrange_entry), so the two give the same bits.  Forming W is the
//   kernel's only real arithmetic (about 550 operations a system at
//   q = 5): of its 180 quotients by k - i only the 48 by +-3 and +-5
//   take a division, the others are products with exact reciprocals.
//
// Every system loads its Z column and writes its output, active ? acc
// : Z[j], selected without a branch (the TPU kernel's jnp.where), so
// the active and inactive systems of a warp do not diverge (a branch to
// a copy loop for the inactive ones took 2.5x the all-active time at
// n = 32 with 60 % of the systems active).  An inactive system never
// reads W, and a warp without an active system forms none.  Each
// output sums acc = W[j,0]*Z[0], then acc + W[j,i]*Z[i], product and sum
// rounded alone (-fmad=false), the plain version's order: both entries
// equal their plain versions bit for bit.  One thread a system, in two
// forms by state size n:
//
// * n <= 4 (the main path's n = 3 over 2**20 systems): the system's Z
//   column (q1 x n values) is loaded first, then W is formed or loaded a
//   row at a time while those loads are in flight.  Blocks of
//   SMALL_THREADS = 128: at 94 registers (float64, W formed) five fit a
//   SM against two of 256, which the fused entry, bound by forming W as
//   much as by memory, needs: it takes 8 % longer in blocks of 256 and
//   12 % longer in the n > 4 form (tools/rescale_variants.py, b256 and
//   loop_all).
//
// * n > 4 (paths B, K, D, E, F: n = 32 over 2**16): W is formed or
//   loaded once into registers (36 values), then the components go in
//   chunks of LOOP_CHUNK = 2 whose 12 loads issue together; built for
//   two blocks a SM (at most 128 registers).  A block of 8 warps over 32
//   systems, W staged in shared memory and warp g rescaling components
//   g, g+8, ..., takes 31 % longer in the fused entry and 19 % longer
//   in path K's rescales (tools/rescale_variants.py, block).
#include "common.cuh"

#define RESIDUAL_MAX_N 8   // widest block of newton_residual_lsolve_kernel
#define GROUP_MAX_NB 32768 // most systems newton_update_kernel runs as groups
#define GROUP_LANES 8      // lanes of a group, one a row

static inline dim3 group_grid(long long nb) {
  return dim3((unsigned)((nb * GROUP_LANES + REPRO_THREADS - 1) /
                         REPRO_THREADS));
}

// lane `lane` of the caller's group's value of v; every lane of the
// warp must call it
template <typename T>
__device__ __forceinline__ T group_shfl(T v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane, GROUP_LANES);
}

// g = z - gamma*f - psi over (n, nb); negate -> -g, the sign applied to
// the computed g so both variants round alike (ref.py:67-74).
template <typename T>
__device__ __forceinline__ T residual(T z, T g_s, T f, T psi, int negate) {
  const T g = z - g_s * f - psi;
  return negate ? -g : g;
}

// dz = (2 / (1 + gamrat)) * (Minv @ -(z - gamma*f - psi)) per system,
// b = B <= RESIDUAL_MAX_N: the fused Newton iteration (see the note
// above).  Minv (B, B, nb) is BlockDiagGJ's saved inverse.
template <typename T, int B>
__global__ void newton_residual_lsolve_kernel(const T* __restrict__ z,
                                              const T* __restrict__ f,
                                              const T* __restrict__ psi,
                                              const T* __restrict__ gam,
                                              const T* __restrict__ gamrat,
                                              const T* __restrict__ Minv,
                                              T* __restrict__ dz,
                                              long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  T zr[B], fr[B], pr[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    zr[k] = z[k * nb + s];
    fr[k] = f[k * nb + s];
    pr[k] = psi[k * nb + s];
  }
  const T g_s = gam[s];
  const T corr = (T(1) / (T(1) + gamrat[s])) * T(2);
  T x[B];
#pragma unroll
  for (int k = 0; k < B; ++k) x[k] = residual(zr[k], g_s, fr[k], pr[k], 1);
#pragma unroll
  for (int i = 0; i < B; ++i) {
    T acc = Minv[(i * B) * nb + s] * x[0];
#pragma unroll
    for (int j = 1; j < B; ++j)
      acc = acc + Minv[(i * B + j) * nb + s] * x[j];
    dz[i * nb + s] = corr * acc;
  }
}

// the residual, thread s over system s's n components
template <typename T>
__global__ void newton_residual_kernel(const T* __restrict__ z,
                                       const T* __restrict__ f,
                                       const T* __restrict__ psi,
                                       const T* __restrict__ gam,
                                       T* __restrict__ out, int n,
                                       long long nb, int negate) {
  const long long s = system_index();
  if (s >= nb) return;
  const T g_s = gam[s];
  for (int k = 0; k < n; ++k) {
    const long long i = k * nb + s;
    out[i] = residual(z[i], g_s, f[i], psi[i], negate);
  }
}

// z' = where(mask, z + dz, z); dn[s] = sqrt(sum_k (dz*w)^2 / n) for
// EVERY system, masked or not (newton.py:90-91).  mask: bool/uint8,
// nonzero = update.
template <typename T>
__global__ void masked_update_wrms_kernel(const T* __restrict__ z,
                                          const T* __restrict__ dz,
                                          const T* __restrict__ w,
                                          const unsigned char* __restrict__ mask,
                                          T* __restrict__ zout,
                                          T* __restrict__ dn, int n,
                                          long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  const bool m = mask[s] != 0;
  T acc = T(0);
  for (int k = 0; k < n; ++k) {
    const long long i = k * nb + s;
    const T d = dz[i];
    const T zi = z[i];
    zout[i] = m ? zi + d : zi;
    const T t = d * w[i];
    acc = acc + t * t;
  }
  dn[s] = sqrt(acc / T(n));
}

// The Newton iteration of BlockDiagGJ(factor_once=True) at b = B <=
// RESIDUAL_MAX_N in one launch (see the note above): dz =
// newton_residual_lsolve_kernel's, z' = where(mask, z + dz, z) and dn =
// sqrt(sum_k (dz*w)^2 / B) as masked_update_wrms_kernel forms them.
template <typename T, int B, bool GROUPED>
__global__ void __launch_bounds__(REPRO_THREADS)
newton_update_kernel(const T* __restrict__ z, const T* __restrict__ f,
                     const T* __restrict__ psi, const T* __restrict__ gam,
                     const T* __restrict__ gamrat,
                     const T* __restrict__ Minv, const T* __restrict__ w,
                     const unsigned char* __restrict__ mask,
                     T* __restrict__ zout, T* __restrict__ dn, long long nb) {
  if constexpr (!GROUPED) {
    const long long s = system_index();
    if (s >= nb) return;
    const T g_s = gam[s];
    const T corr = (T(1) / (T(1) + gamrat[s])) * T(2);
    const bool m = mask[s] != 0;
    T zr[B], x[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      zr[k] = z[k * nb + s];
      x[k] = residual(zr[k], g_s, f[k * nb + s], psi[k * nb + s], 1);
    }
    T ss = T(0);
#pragma unroll
    for (int i = 0; i < B; ++i) {
      T acc = Minv[(i * B) * nb + s] * x[0];
#pragma unroll
      for (int j = 1; j < B; ++j)
        acc = acc + Minv[(i * B + j) * nb + s] * x[j];
      const T d = corr * acc;
      zout[i * nb + s] = m ? zr[i] + d : zr[i];
      const T t = d * w[i * nb + s];
      ss = ss + t * t;
    }
    dn[s] = sqrt(ss / T(B));
  } else {
    // lane r of the system's group owns row r; every lane stays for the
    // shuffles
    const long long s = system_index() / GROUP_LANES;
    const int r = threadIdx.x % GROUP_LANES;
    const bool live = s < nb, row = live && r < B;
    T g_s = T(0), gr = T(0);
    bool m = false;
    if (live) {
      g_s = gam[s];
      gr = gamrat[s];
      m = mask[s] != 0;
    }
    T zr = T(0), x = T(0), wr = T(0), a[B];
    if (row) {
      const long long i = (long long)r * nb + s;
      zr = z[i];
      x = residual(zr, g_s, f[i], psi[i], 1);
      wr = w[i];
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      a[j] = row ? Minv[((long long)r * B + j) * nb + s] : T(0);
    const T corr = (T(1) / (T(1) + gr)) * T(2);
    T acc = a[0] * group_shfl(x, 0);
#pragma unroll
    for (int j = 1; j < B; ++j) acc = acc + a[j] * group_shfl(x, j);
    const T d = corr * acc;
    if (row) zout[(long long)r * nb + s] = m ? zr + d : zr;
    const T t = d * wr;
    T ss = T(0);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const T tk = group_shfl(t, k);
      ss = ss + tk * tk;
    }
    if (live && r == 0) dn[s] = sqrt(ss / T(B));
  }
}

#define SMALL_N 4          // widest state of the n <= 4 rescale
#define SMALL_THREADS 128  // block of the n <= 4 rescale
#define LOOP_CHUNK 2       // components the n > 4 rescale loads together
#define LAGRANGE_Q1 6      // BDF history rows (orders 1-5): W of W_FROM_ETA

enum RescaleSource { W_FROM_MEMORY, W_FROM_ETA };

// p / d for d = k - i in [-5, 5] \ {0}: a division by +-1, +-2 or +-4
// is a product with its exact reciprocal (the same bits), so only
// d = +-3 and +-5 take a division.
template <typename T>
__device__ __forceinline__ T lagrange_quotient(T p, int d) {
  switch (d) {
    case 1: return p;
    case -1: return -p;
    case 2: return p * T(0.5);
    case -2: return p * T(-0.5);
    case 4: return p * T(0.25);
    case -4: return p * T(-0.25);
    default: return p / T(d);
  }
}

// W[j][i] of the rebuild onto the grid of step ratio eta from the q + 1
// valid history rows: rows j > q are the identity's, columns i > q zero;
// else 1 times, for k = 0..5 with k != i and k <= q, the factor
// ((-j)*eta + k) / (k - i) -- lagrange_matrix_soa's arithmetic, each
// product, sum and quotient rounded alone, in its k order.
template <typename T>
__device__ __forceinline__ T lagrange_entry(int j, int i, T eta, int q) {
  const T p = -T(j) * eta;  // -0 * eta at j = 0, as the plain -idx * eta
  T w = T(1);
#pragma unroll
  for (int k = 0; k < LAGRANGE_Q1; ++k) {
    if (k == i) continue;
    const T f = lagrange_quotient(p + T(k), k - i);
    w = k <= q ? w * f : w;
  }
  return j > q ? T(i == j) : (i > q ? T(0) : w);
}

// Z'[j,k,s] = sum_i W[j,i,s] Z[i,k,s] where active[s], else Z[j,k,s]
// (bit-exactly), n <= SMALL_N, one thread a system.  Out of place, so
// a thread may write Z'[j] while other rows of its column are unread.
template <typename T, int Q1, int SRC>
__global__ void history_rescale_kernel(const T* __restrict__ W,
                                       const T* __restrict__ eta,
                                       const int* __restrict__ q,
                                       const T* __restrict__ Z,
                                       const unsigned char* __restrict__ active,
                                       T* __restrict__ out, int n,
                                       long long nb) {
  const long long s = system_index();
  const bool live = s < nb;   // every lane stays for the warp vote
  const bool a = live && active[s] != 0;
  T z[Q1][SMALL_N];
#pragma unroll
  for (int i = 0; i < Q1; ++i)
#pragma unroll
    for (int k = 0; k < SMALL_N; ++k)
      z[i][k] = live && k < n ? Z[((long long)i * n + k) * nb + s] : T(0);
  T e = T(0);
  int qs = 0;
  bool form = false;
  if constexpr (SRC == W_FROM_ETA) {
    if (live) {
      e = eta[s];
      qs = q[s];
    }
    form = __any_sync(0xffffffffu, a);
  }
#pragma unroll
  for (int j = 0; j < Q1; ++j) {
    T w[Q1];
#pragma unroll
    for (int i = 0; i < Q1; ++i) {
      if constexpr (SRC == W_FROM_ETA)
        w[i] = form ? lagrange_entry(j, i, e, qs) : T(0);
      else
        w[i] = a ? W[(long long)(j * Q1 + i) * nb + s] : T(0);
    }
#pragma unroll
    for (int k = 0; k < SMALL_N; ++k) {
      if (!live || k >= n) continue;
      T acc = w[0] * z[0][k];
#pragma unroll
      for (int i = 1; i < Q1; ++i) acc = acc + w[i] * z[i][k];
      out[((long long)j * n + k) * nb + s] = a ? acc : z[j][k];
    }
  }
}

// The same for n > SMALL_N, one thread a system: W formed or loaded once
// into registers, then the components in chunks of LOOP_CHUNK whose
// loads issue together.
template <typename T, int Q1, int SRC>
__global__ void __launch_bounds__(REPRO_THREADS, 2)
history_rescale_loop_kernel(const T* __restrict__ W,
                            const T* __restrict__ eta,
                            const int* __restrict__ q,
                            const T* __restrict__ Z,
                            const unsigned char* __restrict__ active,
                            T* __restrict__ out, int n, long long nb) {
  const long long s = system_index();
  const bool live = s < nb;   // every lane stays for the warp vote
  const bool a = live && active[s] != 0;
  T w[Q1][Q1];
  if constexpr (SRC == W_FROM_ETA) {
    const T e = live ? eta[s] : T(0);
    const int qs = live ? q[s] : 0;
    const bool form = __any_sync(0xffffffffu, a);
#pragma unroll
    for (int j = 0; j < Q1; ++j)
#pragma unroll
      for (int i = 0; i < Q1; ++i)
        w[j][i] = form ? lagrange_entry(j, i, e, qs) : T(0);
  } else {
#pragma unroll
    for (int j = 0; j < Q1; ++j)
#pragma unroll
      for (int i = 0; i < Q1; ++i)
        w[j][i] = a ? W[(long long)(j * Q1 + i) * nb + s] : T(0);
  }
  if (!live) return;
  for (int k0 = 0; k0 < n; k0 += LOOP_CHUNK) {
    T z[Q1][LOOP_CHUNK];
#pragma unroll
    for (int i = 0; i < Q1; ++i)
#pragma unroll
      for (int c = 0; c < LOOP_CHUNK; ++c)
        z[i][c] = k0 + c < n ? Z[((long long)i * n + k0 + c) * nb + s]
                             : T(0);
#pragma unroll
    for (int j = 0; j < Q1; ++j)
#pragma unroll
      for (int c = 0; c < LOOP_CHUNK; ++c) {
        if (k0 + c >= n) continue;
        T acc = w[j][0] * z[0][c];
#pragma unroll
        for (int i = 1; i < Q1; ++i) acc = acc + w[j][i] * z[i][c];
        out[((long long)j * n + k0 + c) * nb + s] = a ? acc : z[j][c];
      }
  }
}

// sqrt(sum_k (v*w)^2 / n) per system: (n, nb) -> (nb,)
template <typename T>
__global__ void wrms_soa_kernel(const T* __restrict__ v,
                                const T* __restrict__ w,
                                T* __restrict__ out, int n, long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  T acc = T(0);
  for (int k = 0; k < n; ++k) {
    const long long i = k * nb + s;
    const T t = v[i] * w[i];
    acc = acc + t * t;
  }
  out[s] = sqrt(acc / T(n));
}

template <typename T, int Q1, int SRC>
static void launch_rescale(const void* W, const void* eta, const void* q,
                           const void* Z, const void* a, void* out, int n,
                           long long nb, cudaStream_t st) {
  const T* w = (const T*)W;
  const T* e = (const T*)eta;
  const int* qv = (const int*)q;
  const T* z = (const T*)Z;
  const unsigned char* av = (const unsigned char*)a;
  if (n <= SMALL_N)
    history_rescale_kernel<T, Q1, SRC><<<
        dim3((unsigned)((nb + SMALL_THREADS - 1) / SMALL_THREADS)),
        SMALL_THREADS, 0, st>>>(w, e, qv, z, av, (T*)out, n, nb);
  else
    history_rescale_loop_kernel<T, Q1, SRC><<<system_grid(nb), REPRO_THREADS,
                                              0, st>>>(w, e, qv, z, av,
                                                       (T*)out, n, nb);
}

template <typename T>
static int history_rescale(const void* W, const void* Z, const void* a,
                           void* out, int q1, int n, long long nb,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (q1) {
#define REPRO_CASE(Q1)                                                      \
  case Q1:                                                                  \
    launch_rescale<T, Q1, W_FROM_MEMORY>(W, nullptr, nullptr, Z, a, out, n, \
                                         nb, st);                           \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int newton_residual_lsolve(const void* z, const void* f,
                                  const void* psi, const void* gam,
                                  const void* gamrat, const void* Minv,
                                  void* dz, int b, long long nb,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (b) {
#define REPRO_CASE(B)                                                       \
  case B:                                                                   \
    newton_residual_lsolve_kernel<T, B><<<system_grid(nb), REPRO_THREADS, 0, \
                                          st>>>(                            \
        (const T*)z, (const T*)f, (const T*)psi, (const T*)gam,             \
        (const T*)gamrat, (const T*)Minv, (T*)dz, nb);                      \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int B, bool GROUPED>
static void launch_update(const void* z, const void* f, const void* psi,
                          const void* gam, const void* gamrat,
                          const void* Minv, const void* w, const void* mask,
                          void* zout, void* dn, long long nb,
                          cudaStream_t st) {
  const dim3 g = GROUPED ? group_grid(nb) : system_grid(nb);
  newton_update_kernel<T, B, GROUPED><<<g, REPRO_THREADS, 0, st>>>(
      (const T*)z, (const T*)f, (const T*)psi, (const T*)gam,
      (const T*)gamrat, (const T*)Minv, (const T*)w,
      (const unsigned char*)mask, (T*)zout, (T*)dn, nb);
}

template <typename T>
static int newton_update(const void* z, const void* f, const void* psi,
                         const void* gam, const void* gamrat,
                         const void* Minv, const void* w, const void* mask,
                         void* zout, void* dn, int b, long long nb,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool grouped = nb <= GROUP_MAX_NB;
  switch (b) {
#define REPRO_CASE(B)                                                       \
  case B:                                                                   \
    (grouped ? launch_update<T, B, true> : launch_update<T, B, false>)(     \
        z, f, psi, gam, gamrat, Minv, w, mask, zout, dn, nb, st);           \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define REPRO_EXPORT(T, SUF)                                                  \
  extern "C" int newton_residual_##SUF(const void* z, const void* f,          \
                                       const void* psi, const void* gam,      \
                                       void* out, int n, long long nb,        \
                                       int negate, void* stream) {            \
    newton_residual_kernel<T><<<system_grid(nb), REPRO_THREADS, 0,            \
                                (cudaStream_t)stream>>>(                      \
        (const T*)z, (const T*)f, (const T*)psi, (const T*)gam, (T*)out, n,   \
        nb, negate);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int newton_residual_lsolve_##SUF(                                \
      const void* z, const void* f, const void* psi, const void* gam,         \
      const void* gamrat, const void* Minv, void* dz, int b, long long nb,    \
      void* stream) {                                                         \
    return newton_residual_lsolve<T>(z, f, psi, gam, gamrat, Minv, dz, b, nb, \
                                     stream);                                 \
  }                                                                           \
  extern "C" int newton_update_##SUF(                                         \
      const void* z, const void* f, const void* psi, const void* gam,         \
      const void* gamrat, const void* Minv, const void* w, const void* mask,  \
      void* zout, void* dn, int b, long long nb, void* stream) {              \
    return newton_update<T>(z, f, psi, gam, gamrat, Minv, w, mask, zout, dn,  \
                            b, nb, stream);                                   \
  }                                                                           \
  extern "C" int masked_update_wrms_##SUF(const void* z, const void* dz,      \
                                          const void* w, const void* mask,    \
                                          void* zout, void* dn, int n,        \
                                          long long nb, void* stream) {       \
    masked_update_wrms_kernel<T><<<system_grid(nb), REPRO_THREADS, 0,         \
                                   (cudaStream_t)stream>>>(                   \
        (const T*)z, (const T*)dz, (const T*)w, (const unsigned char*)mask,   \
        (T*)zout, (T*)dn, n, nb);                                             \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int history_rescale_##SUF(const void* W, const void* Z,          \
                                       const void* active, void* out, int q1, \
                                       int n, long long nb, void* stream) {   \
    return history_rescale<T>(W, Z, active, out, q1, n, nb, stream);          \
  }                                                                           \
  extern "C" int lagrange_rescale_##SUF(const void* eta, const void* q,       \
                                        const void* Z, const void* active,    \
                                        void* out, int n, long long nb,       \
                                        void* stream) {                       \
    launch_rescale<T, LAGRANGE_Q1, W_FROM_ETA>(nullptr, eta, q, Z, active,    \
                                               out, n, nb,                    \
                                               (cudaStream_t)stream);         \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int wrms_soa_##SUF(const void* v, const void* w, void* out,      \
                                int n, long long nb, void* stream) {          \
    wrms_soa_kernel<T><<<system_grid(nb), REPRO_THREADS, 0,                   \
                         (cudaStream_t)stream>>>((const T*)v, (const T*)w,    \
                                                 (T*)out, n, nb);             \
    return (int)cudaGetLastError();                                           \
  }

REPRO_EXPORT(float, f32)
REPRO_EXPORT(double, f64)
