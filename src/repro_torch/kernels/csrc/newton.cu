// Ensemble Newton hot-loop kernels, SoA layout, one thread per system.
//
// Replaces src/repro/kernels/newton.py:
//   _newton_residual_kernel     -> newton_residual_kernel
//   _masked_update_wrms_kernel  -> masked_update_wrms_kernel
//   _history_rescale_kernel     -> history_rescale_kernel
//   _wrms_soa_kernel            -> wrms_soa_kernel
//
// Bound: memory.  Each kernel does a handful of flops per element it
// streams (at most 2*q1 per output of history_rescale), far below the
// H100's ~10 flops per byte of float64 balance, so the least time is
// the bytes moved over 3.35 TB/s.  The design moves each byte once:
// every input element is read once and every output element written
// once, in coalesced warp-wide accesses (thread s touches column s),
// with the per-system reduction of the WRMS kernels kept in a register
// instead of a second pass.  The TPU kernels' whole-bundle short-circuit
// of history_rescale becomes a per-thread branch: an inactive system
// copies its history column and never reads its W.
#include "common.cuh"

// g = z - gamma*f - psi over (n, nb); negate -> -g, the sign applied to
// the computed g so both variants round alike (ref.py:67-74).
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
    const T g = z[i] - g_s * f[i] - psi[i];
    out[i] = negate ? -g : g;
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

// Z'[j,k,s] = sum_i W[j,i,s] Z[i,k,s] where active[s], else Z[j,k,s]
// (copied bit-exactly).  W (Q1,Q1,nb), Z (Q1,n,nb).  Out of place, so a
// thread may write Z'[j] while other rows of its column are unread.
template <typename T, int Q1>
__global__ void history_rescale_kernel(const T* __restrict__ W,
                                       const T* __restrict__ Z,
                                       const unsigned char* __restrict__ active,
                                       T* __restrict__ out, int n,
                                       long long nb) {
  const long long s = system_index();
  if (s >= nb) return;
  if (!active[s]) {
    for (int r = 0; r < Q1 * n; ++r) out[r * nb + s] = Z[r * nb + s];
    return;
  }
  T w[Q1][Q1];
#pragma unroll
  for (int j = 0; j < Q1; ++j)
#pragma unroll
    for (int i = 0; i < Q1; ++i) w[j][i] = W[(j * Q1 + i) * nb + s];
  for (int k = 0; k < n; ++k) {
    T zc[Q1];
#pragma unroll
    for (int i = 0; i < Q1; ++i) zc[i] = Z[((long long)i * n + k) * nb + s];
#pragma unroll
    for (int j = 0; j < Q1; ++j) {
      T acc = w[j][0] * zc[0];
#pragma unroll
      for (int i = 1; i < Q1; ++i) acc = acc + w[j][i] * zc[i];
      out[((long long)j * n + k) * nb + s] = acc;
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

template <typename T, int Q1>
static void launch_rescale(const void* W, const void* Z, const void* a,
                           void* out, int n, long long nb, cudaStream_t st) {
  history_rescale_kernel<T, Q1><<<system_grid(nb), REPRO_THREADS, 0, st>>>(
      (const T*)W, (const T*)Z, (const unsigned char*)a, (T*)out, n, nb);
}

template <typename T>
static int history_rescale(const void* W, const void* Z, const void* a,
                           void* out, int q1, int n, long long nb,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (q1) {
    case 1: launch_rescale<T, 1>(W, Z, a, out, n, nb, st); break;
    case 2: launch_rescale<T, 2>(W, Z, a, out, n, nb, st); break;
    case 3: launch_rescale<T, 3>(W, Z, a, out, n, nb, st); break;
    case 4: launch_rescale<T, 4>(W, Z, a, out, n, nb, st); break;
    case 5: launch_rescale<T, 5>(W, Z, a, out, n, nb, st); break;
    case 6: launch_rescale<T, 6>(W, Z, a, out, n, nb, st); break;
    case 7: launch_rescale<T, 7>(W, Z, a, out, n, nb, st); break;
    case 8: launch_rescale<T, 8>(W, Z, a, out, n, nb, st); break;
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
  extern "C" int wrms_soa_##SUF(const void* v, const void* w, void* out,      \
                                int n, long long nb, void* stream) {          \
    wrms_soa_kernel<T><<<system_grid(nb), REPRO_THREADS, 0,                   \
                         (cudaStream_t)stream>>>((const T*)v, (const T*)w,    \
                                                 (T*)out, n, nb);             \
    return (int)cudaGetLastError();                                           \
  }

REPRO_EXPORT(float, f32)
REPRO_EXPORT(double, f64)
