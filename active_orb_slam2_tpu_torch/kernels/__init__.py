"""Hand-written CUDA kernels: build, bindings and launch wrappers.

Importing these modules builds nothing; the kernel library is compiled
at its first launch (``build.library()``).
"""
