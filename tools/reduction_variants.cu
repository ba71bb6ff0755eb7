// Candidate bodies of the one-launch reductions (dot, weighted sums of
// squares), float64, for tools/reduction_variants.py to time side by
// side on one card.  Not part of the port: src/repro_torch/kernels/
// csrc/vecops.cu holds the one body the port launches.
//
// Every candidate takes the same plan (blocks, chunk) as the port
// (kernels/vecops.py reduction_plan) and sums in the same order: thread
// t sums its block's elements t, t+256, t+512, ... in increasing order,
// then block_sum, then the last block to take a ticket sums the
// partials in index order.  So every candidate must give the same bits
// as the port's kernel; the script checks that.
//
//   BODY_RING: a two-stage shared-memory ring of 8 KB tiles per input,
//     fed by cp.async.bulk on an mbarrier; each copy covers the whole
//     16-byte granules around the tile, read at the input's offset.
//   BODY_REG: eight 8-byte loads per input in flight per thread, from
//     registers, any alignment.
//   HINT_NONE: plain loads / copies.  HINT_EVICT_FIRST: an L2 policy
//     that marks the lines read evict-first.  HINT_CS (BODY_REG only):
//     ld.global.cs, the streaming load.
#include "common.cuh"

#define RED_MAX_BLOCKS 264
#define RING_STAGES 2
#define RING_TILE_BYTES 8192
#define REG_UNROLL 8

enum { BODY_RING = 0, BODY_REG = 1 };
enum { HINT_NONE = 0, HINT_EVICT_FIRST = 1, HINT_CS = 2 };
enum { RED_DOT = 0, RED_WRMS = 1, RED_WRMS_MASK = 2 };

struct RedArgs {
  const double* p[3];
};

__device__ double block_sum(double v) {
  __shared__ double warp_sums[REPRO_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = warp_sums[0];
#pragma unroll
    for (int w = 1; w < REPRO_THREADS / 32; ++w) v = v + warp_sums[w];
  }
  return v;
}

template <int OP>
__device__ __forceinline__ double red_term(const double (&v)[3]) {
  if (OP == RED_DOT) return v[0] * v[1];
  double u = v[0] * v[1];
  if (OP == RED_WRMS_MASK) u = u * v[2];
  return u * u;
}

__device__ void finish_reduce(double acc, double* __restrict__ partial,
                              unsigned* __restrict__ ticket,
                              double* __restrict__ out) {
  __shared__ int is_last;
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  double sum = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += REPRO_THREADS)
    sum = sum + __ldcg(partial + i);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    out[0] = sum;
    *ticket = 0u;
  }
}

__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// --- BODY_REG ---

template <int HINT>
__device__ __forceinline__ double load(const double* p,
                                       unsigned long long policy) {
  if (HINT == HINT_CS) return __ldcs(p);
  if (HINT == HINT_EVICT_FIRST) {
    double v;
    asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
        : "=d"(v)
        : "l"(p), "l"(policy));
    return v;
  }
  return __ldg(p);
}

template <int NIN, int OP, int HINT>
__global__ void __launch_bounds__(REPRO_THREADS, 2)
    reg_reduce_kernel(RedArgs a, double* __restrict__ partial,
                      unsigned* __restrict__ ticket,
                      double* __restrict__ out, long long n,
                      long long chunk) {
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long len = n - c0 < chunk ? n - c0 : chunk;
  const unsigned long long policy =
      HINT == HINT_EVICT_FIRST ? l2_evict_first() : 0ull;
  const double* p[NIN];
#pragma unroll
  for (int v = 0; v < NIN; ++v) p[v] = a.p[v] + c0;
  double acc = 0.0;
  for (long long base = threadIdx.x; base < len;
       base += (long long)REG_UNROLL * REPRO_THREADS) {
    double val[REG_UNROLL][3];
#pragma unroll
    for (int u = 0; u < REG_UNROLL; ++u) {
      const long long i = base + (long long)u * REPRO_THREADS;
#pragma unroll
      for (int v = 0; v < NIN; ++v)
        val[u][v] = i < len ? load<HINT>(p[v] + i, policy) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < REG_UNROLL; ++u)
      if (base + (long long)u * REPRO_THREADS < len)
        acc = acc + red_term<OP>(val[u]);
  }
  finish_reduce(acc, partial, ticket, out);
}

// --- BODY_RING ---

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <int HINT>
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar,
                                              unsigned long long policy) {
  if (HINT == HINT_EVICT_FIRST)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes),
        "r"(smem_u32(bar)), "l"(policy)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes),
        "r"(smem_u32(bar))
        : "memory");
}

template <int NIN, int OP, int HINT>
__global__ void __launch_bounds__(REPRO_THREADS, 2)
    ring_reduce_kernel(RedArgs a, double* __restrict__ partial,
                       unsigned* __restrict__ ticket,
                       double* __restrict__ out, long long n,
                       long long chunk) {
  constexpr int TILE = RING_TILE_BYTES / 8;
  constexpr int ALIGN = 2;
  constexpr int SLOT = TILE + ALIGN;
  extern __shared__ __align__(128) unsigned char red_smem[];
  double* stage = reinterpret_cast<double*>(red_smem);
  __shared__ __align__(8) unsigned long long full[RING_STAGES];

  const long long c0 = (long long)blockIdx.x * chunk;
  const long long len = n - c0 < chunk ? n - c0 : chunk;
  const double* g[NIN];
  int off[NIN];
#pragma unroll
  for (int v = 0; v < NIN; ++v) {
    const double* c = a.p[v] + c0;
    off[v] = (int)(((unsigned long long)c & 15u) / 8u);
    g[v] = c - off[v];
  }
  const long long ntiles = (len + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < RING_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const unsigned long long policy =
      threadIdx.x == 0 && HINT == HINT_EVICT_FIRST ? l2_evict_first() : 0ull;
  auto issue = [&](long long k) {
    const int s = (int)(k % RING_STAGES);
    const long long left = len - k * TILE;
    const int cnt = left < TILE ? (int)left : TILE;
    unsigned bytes[NIN], total = 0;
#pragma unroll
    for (int v = 0; v < NIN; ++v) {
      bytes[v] = ((unsigned)(off[v] + cnt) * 8u + 15u) & ~15u;
      total += bytes[v];
    }
    mbar_arrive_expect_tx(&full[s], total);
#pragma unroll
    for (int v = 0; v < NIN; ++v)
      bulk_copy_g2s<HINT>(stage + ((long long)s * NIN + v) * SLOT,
                          g[v] + k * TILE, bytes[v], &full[s], policy);
  };
  if (threadIdx.x == 0) {
    for (long long k = 0; k < ntiles && k < RING_STAGES; ++k) issue(k);
  }
  double acc = 0.0;
  for (long long k = 0; k < ntiles; ++k) {
    const int s = (int)(k % RING_STAGES);
    mbar_wait(&full[s], (unsigned)((k / RING_STAGES) & 1));
    const long long left = len - k * TILE;
    const double* st = stage + (long long)s * NIN * SLOT;
#pragma unroll
    for (int e = 0; e < TILE / REPRO_THREADS; ++e) {
      const int o = e * REPRO_THREADS + (int)threadIdx.x;
      if (o < left) {
        double val[3];
#pragma unroll
        for (int v = 0; v < NIN; ++v) val[v] = st[v * SLOT + off[v] + o];
        acc = acc + red_term<OP>(val);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + RING_STAGES < ntiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + RING_STAGES);
    }
  }
  finish_reduce(acc, partial, ticket, out);
}

template <int NIN, int OP, int HINT>
static int launch(int body, const void* const* ps, void* partial,
                  void* ticket, void* out, long long n, int blocks,
                  long long chunk, cudaStream_t st) {
  RedArgs a;
  for (int v = 0; v < 3; ++v) a.p[v] = v < NIN ? (const double*)ps[v] : nullptr;
  if (body == BODY_REG) {
    reg_reduce_kernel<NIN, OP, HINT><<<blocks, REPRO_THREADS, 0, st>>>(
        a, (double*)partial, (unsigned*)ticket, (double*)out, n, chunk);
    return (int)cudaGetLastError();
  }
  if (HINT == HINT_CS) return (int)cudaErrorInvalidValue;
  constexpr int smem = RING_STAGES * NIN * (RING_TILE_BYTES + 16);
  auto kern = ring_reduce_kernel<NIN, OP, HINT == HINT_CS ? 0 : HINT>;
  int rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kern<<<blocks, REPRO_THREADS, smem, st>>>(
      a, (double*)partial, (unsigned*)ticket, (double*)out, n, chunk);
  return (int)cudaGetLastError();
}

template <int NIN, int OP>
static int with_hint(int body, int hint, const void* const* ps,
                     void* partial, void* ticket, void* out, long long n,
                     int blocks, long long chunk, cudaStream_t st) {
  switch (hint) {
    case HINT_NONE:
      return launch<NIN, OP, HINT_NONE>(body, ps, partial, ticket, out, n,
                                        blocks, chunk, st);
    case HINT_EVICT_FIRST:
      return launch<NIN, OP, HINT_EVICT_FIRST>(body, ps, partial, ticket,
                                               out, n, blocks, chunk, st);
    case HINT_CS:
      return launch<NIN, OP, HINT_CS>(body, ps, partial, ticket, out, n,
                                      blocks, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// op: RED_DOT (x, y), RED_WRMS (x, w), RED_WRMS_MASK (x, w, m)
extern "C" int variant_reduce_f64(int body, int hint, int op, const void* x,
                                  const void* y, const void* m,
                                  void* partial, void* ticket, void* out,
                                  long long n, int blocks, long long chunk,
                                  void* stream) {
  const void* ps[3] = {x, y, m};
  if (blocks < 1 || blocks > RED_MAX_BLOCKS || chunk % 2 != 0 ||
      (long long)blocks * chunk < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case RED_DOT:
      return with_hint<2, RED_DOT>(body, hint, ps, partial, ticket, out, n,
                                   blocks, chunk, st);
    case RED_WRMS:
      return with_hint<2, RED_WRMS>(body, hint, ps, partial, ticket, out, n,
                                    blocks, chunk, st);
    case RED_WRMS_MASK:
      return with_hint<3, RED_WRMS_MASK>(body, hint, ps, partial, ticket,
                                         out, n, blocks, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}
