"""Direct LiDAR Odometry in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
vectr-ucla/direct_lidar_odometry (DLO, RA-L 2022): two-stage GICP LiDAR
odometry (scan-to-scan + scan-to-submap), adaptive keyframing with
convex/concave-hull keyframe selection, IMU priors, and map aggregation —
built as pure-functional fixed-shape array programs, with multi-sequence
batching and multi-device sharding layered on top.

This is NOT a port: the reference is C++/PCL/OpenMP/ROS (cited throughout
as ``reference file:line``); here the kd-tree becomes a hash-grid gather
kernel, the OpenMP loops become fused XLA ops, the ROS graph becomes
in-process functional composition, and the (nonexistent in the reference)
distributed layer is JAX shard_map.

Importing the package points JAX's persistent compilation cache at
``JAX_COMPILATION_CACHE_DIR`` or, when that is unset, at
``<checkout>/.jax_cache`` (utils/cachedir.py).
"""

__version__ = "0.2.0"

from direct_lidar_odometry_tpu.utils import cachedir as _cachedir

_cachedir.configure()

from direct_lidar_odometry_tpu.config import DloConfig, load_config

__all__ = ["DloConfig", "load_config", "__version__"]
