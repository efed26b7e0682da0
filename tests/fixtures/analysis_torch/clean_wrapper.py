"""Clean twin of ``bad_wrapper.py``: every ``argtypes`` list matches its
``extern "C"`` signature in ``clean_wrapper.cu`` (pointers, ints, a float
and a stream, built with ``*`` and ``+``, through a splatted tuple and a
helper that returns a tuple literal), and every call passes one argument
per argtype. The checker must stay silent. Never imported at runtime —
parsed only.
"""
import ctypes

from repro_torch.kernels import _build

# x, y, out; n, k; scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])
# x, dy, dx, scratch0, scratch1; n; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p]


def scratch_shapes(n):
    return ((n, 4), (n,))


def forward(x, y, out, k, scale):
    fn = _build.entry("clean_wrapper", "clean_fwd_f32", _ARGTYPES)
    rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], k,
            float(scale), None)
    return rc


def backward(x, dy, dx):
    scratch = tuple(dx.new_empty(s) for s in scratch_shapes(x.shape[0]))
    fn = _build.entry("clean_wrapper", "clean_bwd_f32", _BWD_ARGTYPES)
    return fn(*(t.data_ptr() for t in (x, dy, dx) + scratch), x.shape[0],
              None)
