"""active_orb_slam2_tpu_torch — the PyTorch/CUDA port of active_orb_slam2_tpu.

The package mirrors the JAX package's layout (``geometry/``, ``ops/``,
``models/``, ``io/``, ``utils/``) so each module's counterpart sits under
the same path.  Plain tensor code is PyTorch; the two Pallas TPU kernels
of the JAX package are hand-written CUDA kernels for Hopper
(``csrc/*.cu``), built at first use and bound with ``ctypes``
(``kernels/``).  Every kernel has a plain PyTorch version beside it,
which a tensor on the CPU takes.

This package never imports ``jax``.  What it covers so far is the RGB-D
tracking path with local mapping off:
``System(cfg, use_mapping=False).track_rgbd``.
"""

__version__ = "0.1.0"
