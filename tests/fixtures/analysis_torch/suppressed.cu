// Suppression-semantics fixture for CUDA sources: one inline disable and
// one exponent left active. Never compiled — parsed only.
#include <cuda_fp16.h>

__device__ __half tolerated(__half s) {
  return hexp2(s);  // repro-lint: disable=RL205
}

__device__ __half flagged(__half s) {
  return hexp(s);
}
