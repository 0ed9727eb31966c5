"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Sources live in ``paddle_tpu_torch/csrc``; ``_build`` compiles each into a
shared library with a plain C interface at first use and loads it with
``ctypes``. Nothing here imports or builds anything at import time.
"""
