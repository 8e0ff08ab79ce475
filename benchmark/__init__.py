"""The benchmark of the PyTorch and CUDA port on an NVIDIA card."""
