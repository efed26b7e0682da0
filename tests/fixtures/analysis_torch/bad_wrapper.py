"""Seeded-bad fixture for the kernel contract checker's wrapper side
(RL203), paired with ``bad_wrapper.cu``.

Each `# expect: RL###` marker pins the exact line the analyzer must
report. Never imported at runtime — parsed only.
"""
import ctypes

from repro_torch.kernels import _build

# x, y; n; stream: one short of short_args_f32's (x, y, n, scale, stream)
_SHORT = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]  # expect: RL203
# x, y; n, scale; stream: a c_int where kind_args_f32 takes a float
_KIND = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2  # expect: RL203
         + [ctypes.c_void_p])
# x, y; n; stream
_EXTRA = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]


def short_args(x, y):
    fn = _build.entry("bad_wrapper", "short_args_f32", _SHORT)
    return fn(x.data_ptr(), y.data_ptr(), 4, None)


def kind_args(x, y):
    fn = _build.entry("bad_wrapper", "kind_args_f32", _KIND)
    return fn(x.data_ptr(), y.data_ptr(), 4, 1, None)


def extra_call(x, y):
    fn = _build.entry("bad_wrapper", "extra_call_f32", _EXTRA)
    ptrs = (x.data_ptr(), y.data_ptr())
    return fn(*ptrs, 4, 0.5, None)                   # expect: RL203


def missing_symbol(x, y):
    fn = _build.entry("bad_wrapper", "renamed_f32", _EXTRA)  # expect: RL203
    return fn(x.data_ptr(), y.data_ptr(), 4, None)
