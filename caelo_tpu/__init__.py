"""caelo_tpu: a JAX LiDAR odometry framework on accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
SRainGit/CAE-LO (arXiv:2001.01354): spherical-ring projection, unsupervised
CNN interest-point detection, multi-scale voxel-patch description, robust
registration, odometry chaining, ICP refinement, loop closure and KITTI
evaluation — engineered for accelerators (batched matmuls, fixed shapes,
device meshes) rather than translated from the reference's CUDA/Keras code.
"""

__version__ = "0.1.0"

from .config import DEFAULT_CONFIG, PipelineConfig  # noqa: F401
