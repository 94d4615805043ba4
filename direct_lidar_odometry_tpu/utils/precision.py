"""Matmul precision guard.

Float32 matrix products may run at reduced precision unless asked not to:
on an NVIDIA GPU, XLA may route them through TF32 tensor cores, which keep
a 10-bit mantissa (about three decimal digits). For neural nets that is
the right trade; for geometry it is not. Point transforms, Jacobian
products and pose compositions at map-scale coordinates (tens to hundreds
of meters) then carry ~1e-3 relative error, which is centimeters per
transform, and odometry drifts by meters over a sequence.

Every public jitted entry point of this framework traces under
``jax.default_matmul_precision("float32")`` via this decorator, so every
``dot_general`` it lowers carries ``HIGHEST`` precision (full float32, no
TF32) whatever the caller's global config. tests/test_precision.py checks
the lowered step, chunked step and pose-graph refine for it.
"""

from __future__ import annotations

from functools import wraps

import jax


def f32_matmuls(fn):
    """Trace ``fn`` with full-float32 matmul precision (no TF32)."""

    @wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
