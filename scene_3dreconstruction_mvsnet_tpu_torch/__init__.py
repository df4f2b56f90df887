"""scene_3dreconstruction_mvsnet_tpu_torch — the PyTorch/CUDA port of the
MVSNet package ``scene_3dreconstruction_mvsnet_tpu``.

The JAX package is the reference; this package mirrors its layout module for
module and keeps its public layouts (images ``[B, V, H, W, 3]``, projections
``[B, V, 4, 4]``, depth values ``[B, D]``, cost volume ``[B, D, H, W, C]``),
converting to NCHW / NCDHW only inside the conv stacks.

The inference forward runs through two kernels written by hand for Hopper:
the plane-sweep variance kernel (CUDA C++, ``csrc/sweep_variance.cu``) and
the softmax-regression kernel (Triton). Each kernel's wrapper takes its plain
PyTorch version for CPU tensors and launches the kernel (or raises) for CUDA
tensors. Nothing here imports JAX.
"""

__version__ = "0.1.0"
