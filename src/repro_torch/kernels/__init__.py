# Hand-written Hopper kernels for the served planner's attention
# (flash_prefill.py, flash_decode.py; CUDA sources in ../csrc/), their
# plain PyTorch versions (ref.py), the nvcc/ctypes build (_build.py) and
# the device-dispatching op surface (backend.py).
