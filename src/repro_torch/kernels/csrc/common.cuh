// Shared launch conventions of the port's kernels.
//
// Layout: structure of arrays with the system axis LAST, as in the JAX
// package; entry (i, j) of system s of a (b, b, nb) tensor lives at
// (i*b + j)*nb + s.  In every kernel but the 9 <= b <= 32 forms of
// block_solve.cu (a warp per system) and blockdiag_spmv.cu (a lane per
// system and a warp per row group; each source's note says how) one
// thread owns one system, so the threads of a warp read neighbouring
// addresses and every load is coalesced.  For those the grid is
// ceil(nb / 256) blocks of 256 threads (128 for newton.cu's n <= 4
// history rescale) and each kernel bounds-checks s, which replaces the
// TPU wrapper's batch padding.
#pragma once

#include <cuda_runtime.h>

#define REPRO_THREADS 256

static inline dim3 system_grid(long long nb) {
  return dim3((unsigned)((nb + REPRO_THREADS - 1) / REPRO_THREADS));
}

__device__ __forceinline__ long long system_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// max that propagates NaN from either side, as jnp.maximum does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
