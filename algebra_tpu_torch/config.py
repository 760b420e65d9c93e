"""Runtime configuration of the port.

There is no switch that chooses between a kernel and its plain version:
a CUDA tensor launches the kernel, a CPU tensor takes the plain version,
and nothing else decides.
"""

from __future__ import annotations

import os

# Device used by entry points and field kinds when the caller names none.
default_device: str = "cuda"

# Smallest batch that ``PrimeField.inverse`` sends through the blocked
# batched inversion (``ops/mont.batch_inverse``).  A single element, such as
# a leading coefficient, has nothing to share the one inversion with and takes
# ``ops/mont.inv`` on the CPU; on the card it takes the blocked inversion
# all the same, which for one element is K3's safegcd alone, one launch
# against ~490 of ``mont.inv``'s products.
inverse_min_batch: int = 2

# MSM bucket phase.  False: the lockstep Jacobian mixed-add rounds (kernel
# K8), which is what the JAX package runs on any backend but a TPU.  True:
# the sorted-run affine halving tree (kernels K11-K16 around the batched
# inversion), the JAX package's TPU path; it needs a prime base field.  On
# an H100 (700 W) the 2^20 G1 MSM took 125.49-147.13 ms on the lockstep path
# and 152.40-167.30 ms through the tree, in turns in one run (PERF.md), so
# the default is the lockstep path.
msm_affine_tree: bool = False

# Where the CUDA sources are compiled to shared libraries at first use.
build_dir: str = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
