"""scene_3dreconstruction_mvsnet_tpu_torch — the PyTorch/CUDA port of the
MVSNet package ``scene_3dreconstruction_mvsnet_tpu``.

The JAX package is the reference; this package mirrors its layout module for
module and keeps its public layouts (images ``[B, V, H, W, 3]``, projections
``[B, V, 4, 4]``, depth values ``[B, D]``, cost volume ``[B, D, H, W, C]``),
converting to NCHW / NCDHW only inside the conv stacks.

Inference, training and the two-stage eval CLI (``eval_cli``) run through
six kernels written by hand in CUDA C++ for Hopper (``ops/kernels``): the
plane-sweep variance kernel K1 (with a mode that also emits the warps for
training), the softmax-regression kernel K2, the variance's backward terms
K3-terms, the warp-backward kernel K3, the fused CostRegNet conv0 K4 and the
single-view warp K5. Each kernel's wrapper takes its plain PyTorch version
for CPU tensors and launches the kernel (or raises) for CUDA tensors.
Nothing here imports JAX or the JAX package; ``interop.from_jax`` reads the
JAX package's variables as numpy arrays, and the file formats and datasets
are the port's own ``io`` and ``data`` packages.
"""

__version__ = "0.1.0"
