// Clean twin of bad_wrapper.cu: fp32 exponents only (expf, exp2f of
// promoted halves), every extern "C" entry declared by clean_wrapper.py.
// The checker must stay silent. Never compiled — parsed only.
#include <cuda_fp16.h>

__device__ float row_exp(__half s, float m) {
  return expf(__half2float(s) - m);   /* not hexp(s): fp32 */
}

extern "C" int clean_fwd_f32(const void* x, const void* y, void* out,
                             int n, int k, float scale, void* stream) {
  return 0;
}

extern "C" int clean_bwd_f32(const void* x, const void* dy, void* dx,
                             void* scratch0, void* scratch1, int n,
                             void* stream) {
  return 0;
}
