// Candidate bodies of the history rescale and the per-system WRMS that
// tools/rescale_variants.py times beside src/repro_torch/kernels/csrc/
// newton.cu.  Not a source of the package: the tool pastes a section
// (a "//@ name" line starts one) into a copy of newton.cu and builds it.

//@ quotient
// Candidate "fma": the quotients by 3 and 5 of lagrange_entry without a
// division, the IEEE quotient all the same.
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// p / M for M = 3 or 5 in three operations instead of a division's ten
// or so: y = RN(1/M) lies within half an ulp of 1/M, so q = RN(p*y)
// lies within one ulp of p/M, the remainder p - q*M is exact in one fma,
// and RN(q + rem*y) is the correctly rounded p/M (Markstein's theorem).
// It needs the remainder neither to underflow nor to overflow: zero,
// tiny, huge and non-finite p divide.
template <typename T, int M>
__device__ __forceinline__ T div_small(T p) {
  T y, lo, hi;
  if constexpr (sizeof(T) == 8) {
    y = M == 3 ? 0x1.5555555555555p-2 : 0x1.999999999999ap-3;
    lo = 0x1p-900;
    hi = 0x1p900;
  } else {
    y = M == 3 ? 0x1.555556p-2f : 0x1.99999ap-3f;
    lo = 0x1p-100f;
    hi = 0x1p100f;
  }
  const T a = fabs(p);
  if (!(a >= lo && a <= hi)) return p / T(M);
  const T q = p * y;
  return fma_rn(fma_rn(-q, T(M), p), y, q);
}

// p / d for d = +-3, +-5 (RN(p / -M) = -RN(p / M)).
template <typename T>
__device__ __forceinline__ T fma_quotient(T p, int d) {
  switch (d) {
    case 3: return div_small<T, 3>(p);
    case -3: return -div_small<T, 3>(p);
    case 5: return div_small<T, 5>(p);
    default: return -div_small<T, 5>(p);  // d = -5
  }
}

//@ kernels
// Candidates "block" and "wrms_rows": for n > 4 a block of 8 warps covers
// 32 consecutive systems, one a lane, and warp g takes components g,
// g+8, ..., so each load of a component is a warp-wide coalesced run.
#define CAND_GROUPS (REPRO_THREADS / 32)  // warps of a block
#define CAND_CHUNK 4                      // WRMS loads of an input in flight

static inline dim3 block_grid(long long nb) {
  return dim3((unsigned)((nb + 31) / 32));
}

// The rescale: the block's 32 W matrices formed (from eta, q) or loaded
// once into shared memory, warp g the entries g, g+8, ... of its lane's
// system (9.2 KB in float64), then warp g rescales its components.
// lagrange_entry's arithmetic, so the bits of the port's forms.
template <typename T, int Q1, int SRC>
__global__ void __launch_bounds__(REPRO_THREADS)
history_rescale_block_kernel(const T* __restrict__ W,
                             const T* __restrict__ eta,
                             const int* __restrict__ q,
                             const T* __restrict__ Z,
                             const unsigned char* __restrict__ active,
                             T* __restrict__ out, int n, long long nb) {
  __shared__ T ws[Q1 * Q1][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * 32 + lane;
  const bool live = s < nb;
  const bool a = live && active[s] != 0;
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
  for (int ji = g; ji < Q1 * Q1; ji += CAND_GROUPS) {
    T v = T(0);
    if constexpr (SRC == W_FROM_ETA) {
      if (form) v = lagrange_entry(ji / Q1, ji % Q1, e, qs);
      v = a ? v : T(0);
    } else {
      v = a ? W[(long long)ji * nb + s] : T(0);
    }
    ws[ji][lane] = v;
  }
  __syncthreads();
  if (!live) return;
  for (int k = g; k < n; k += CAND_GROUPS) {
    T z[Q1];
#pragma unroll
    for (int i = 0; i < Q1; ++i) z[i] = Z[((long long)i * n + k) * nb + s];
#pragma unroll
    for (int j = 0; j < Q1; ++j) {
      T acc = ws[j * Q1][lane] * z[0];
#pragma unroll
      for (int i = 1; i < Q1; ++i) acc = acc + ws[j * Q1 + i][lane] * z[i];
      out[((long long)j * n + k) * nb + s] = a ? acc : z[j];
    }
  }
}

// The WRMS: warp g sums the squares of its components, CAND_CHUNK loads
// of each input in flight; lane s of warp 0 then adds the 8 partial sums
// in warp order (an order other than the plain version's).
template <typename T>
__global__ void __launch_bounds__(REPRO_THREADS)
wrms_rows_kernel(const T* __restrict__ v, const T* __restrict__ w,
                 T* __restrict__ out, int n, long long nb) {
  __shared__ T part[CAND_GROUPS][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * 32 + lane;
  const bool live = s < nb;
  T acc = T(0);
  for (int k0 = g; live && k0 < n; k0 += CAND_GROUPS * CAND_CHUNK) {
    T t[CAND_CHUNK];
#pragma unroll
    for (int c = 0; c < CAND_CHUNK; ++c) {
      const int k = k0 + CAND_GROUPS * c;
      const long long i = (long long)k * nb + s;
      t[c] = k < n ? v[i] * w[i] : T(0);
    }
#pragma unroll
    for (int c = 0; c < CAND_CHUNK; ++c)
      if (k0 + CAND_GROUPS * c < n) acc = acc + t[c] * t[c];
  }
  part[g][lane] = acc;
  __syncthreads();
  if (g != 0 || !live) return;
  T sum = part[0][lane];
#pragma unroll
  for (int h = 1; h < CAND_GROUPS; ++h) sum = sum + part[h][lane];
  out[s] = sqrt(sum / T(n));
}

template <typename T>
static void wrms_rows_launch(const void* v, const void* w, void* out, int n,
                             long long nb, void* stream) {
  wrms_rows_kernel<T><<<block_grid(nb), REPRO_THREADS, 0,
                        (cudaStream_t)stream>>>((const T*)v, (const T*)w,
                                                (T*)out, n, nb);
}
