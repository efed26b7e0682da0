"""PyTorch/CUDA port of the GeckOpt serving stack.

Mirrors the JAX package module by module. The served planner's attention
runs on hand-written Hopper kernels (``kernels/``, sources in ``csrc/``)
whenever its tensors live on a CUDA device; on the CPU every kernel op
takes its plain PyTorch version, which is what the tests run.
"""
