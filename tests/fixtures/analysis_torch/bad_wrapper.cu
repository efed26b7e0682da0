// Seeded-bad fixture for the kernel contract checker's CUDA side (RL203
// unreferenced entries, RL205), paired with bad_wrapper.py.
//
// Each `// expect: RL###` marker pins the exact line the analyzer must
// report. Never compiled — parsed only. hexp() in this comment is no call.
#include <cuda_fp16.h>

__device__ float half_exp(__half s) {
  return __half2float(hexp(s));                      // expect: RL205
}

__device__ __half2 half2_log(__half2 s) {
  return h2log(s);                                   // expect: RL205
}

extern "C" int short_args_f32(const void* x, void* y, int n, float scale,
                              void* stream) {
  return 0;
}

extern "C" int kind_args_f32(const void* x, void* y, int n, float scale,
                             void* stream) {
  return 0;
}

extern "C" int extra_call_f32(const void* x, void* y, int n,
                              void* stream) {
  return 0;
}

extern "C" int orphan_f32(const void* x, int n, void* stream) {  // expect: RL203
  return 0;
}
