"""PyTorch and CUDA port of the mcpt_tpu path tracer.

Mirrors `mcpt_tpu`'s module layout. Importing the package builds nothing:
the CUDA kernels under `csrc/` are compiled by `ops/_build.py` the first
time a kernel is launched on a CUDA tensor.
"""
