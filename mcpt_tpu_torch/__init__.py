"""PyTorch and CUDA port of the mcpt_tpu path tracer.

Mirrors `mcpt_tpu`'s module layout. Importing the package builds nothing:
`ops/_build.py` compiles the CUDA kernels under `csrc/` the first time a
kernel is launched on a CUDA tensor, and the host BVH builder under
`csrc/host/` the first time a BVH is built.
"""
