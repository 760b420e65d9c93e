"""algebra_tpu_torch — the PyTorch/CUDA port of the algebra framework.

Prime-field arithmetic and radix-2 NTT polynomial products over batched
limb tensors, with the hot loops (Montgomery product, NTT butterfly
stage) as hand-written CUDA kernels for Hopper.  The package mirrors the
JAX package's module and function names; values are limb-major
``torch.int32[L, *batch]`` tensors of 16-bit limbs in Montgomery form.
"""

__version__ = "0.1.0"
