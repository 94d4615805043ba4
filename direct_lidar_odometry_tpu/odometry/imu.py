"""IMU handling: host-side buffering + calibration, device-side integration.

Reference:
- ``imuCB`` (``odom.cc:704-785``): 3 s static calibration averaging gyro &
  accel, then bias-corrected gyro measurements into a circular buffer.
- ``integrateIMU`` (``odom.cc:859-919``): collect measurements between the
  two scan stamps, sort, integrate quaternion kinematics gyro-only to form
  a rotational prior for S2S.
- ``gravityAlign`` (``odom.cc:535-579``): average 1 s of accelerometer,
  rotate measured gravity onto +z for the initial orientation.

The buffer/calibration is host Python (it is sensor-rate bookkeeping, the
analog of the reference's ROS callback); integration runs inside jit from
a fixed-size window so the whole odometry step stays on device.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.core import se3


class ImuBuffer:
    """Host-side circular buffer with static-bias calibration.

    Rows: (stamp, wx, wy, wz, ax, ay, az). Gyro is stored bias-corrected
    once calibrated (accel is stored raw, as the reference does).
    """

    def __init__(self, calib_time: float = 3.0, buffer_size: int = 2000):
        self.calib_time = calib_time
        self.buffer = np.zeros((buffer_size, 7), np.float64)
        self.size = 0
        self.head = 0
        self.first_stamp: float | None = None
        self.calibrated = calib_time <= 0.0
        self._calib_sum = np.zeros(6)
        self._calib_n = 0
        self.gyro_bias = np.zeros(3)
        self.accel_mean = np.zeros(3)

    def push(self, stamp: float, gyro, accel) -> None:
        gyro = np.asarray(gyro, np.float64)
        accel = np.asarray(accel, np.float64)
        if self.first_stamp is None:
            self.first_stamp = stamp
        if not self.calibrated:
            if stamp - self.first_stamp < self.calib_time:
                self._calib_sum += np.concatenate([gyro, accel])
                self._calib_n += 1
                return
            if self._calib_n > 0:
                avg = self._calib_sum / self._calib_n
                self.gyro_bias = avg[:3]
                self.accel_mean = avg[3:]
            self.calibrated = True
        row = np.concatenate([[stamp], gyro - self.gyro_bias, accel])
        self.buffer[self.head] = row
        self.head = (self.head + 1) % len(self.buffer)
        self.size = min(self.size + 1, len(self.buffer))

    def window(self, t0: float, t1: float, width: int) -> tuple[np.ndarray, int]:
        """Measurements with t0 <= stamp <= t1, sorted, padded to ``width``.

        Mirrors the collection at reference ``odom.cc:864-881``.
        """
        data = self.buffer[: self.size]
        sel = data[(data[:, 0] >= t0) & (data[:, 0] <= t1)]
        sel = sel[np.argsort(sel[:, 0])][:width]
        out = np.zeros((width, 7), np.float32)
        out[: len(sel)] = sel
        return out, len(sel)


def integrate_window(window: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """Gyro-only quaternion integration -> rotation-only 4x4 prior.

    Faithful to reference ``odom.cc:885-918``: the first in-window sample
    only seeds the previous stamp; each subsequent sample integrates
    ``q <- q + 0.5 * q (x) (0, w) * dt`` with its own angular velocity;
    the result is normalized and placed in an identity-translation SE(3).

    window: [W, 7] rows (stamp, wx, wy, wz, ax, ay, az); count: int32.
    """
    w = window.shape[0]

    def body(carry, inp):
        q, prev_stamp, idx = carry
        stamp = inp[0]
        omega = inp[1:4]
        active = (idx < count) & (idx > 0)
        dt = jnp.where(active, stamp - prev_stamp, 0.0)
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]
        ox, oy, oz = omega[0], omega[1], omega[2]
        dq = jnp.stack(
            [
                -0.5 * (qx * ox + qy * oy + qz * oz),
                0.5 * (qw * ox - qz * oy + qy * oz),
                0.5 * (qz * ox + qw * oy - qx * oz),
                0.5 * (qx * oy - qy * ox + qw * oz),
            ]
        )
        q_new = q + dq * dt
        new_prev = jnp.where(idx < count, stamp, prev_stamp)
        return (q_new, new_prev, idx + 1), None

    init = (se3.quat_identity(), window[0, 0], jnp.int32(0))
    (q, _, _), _ = jax.lax.scan(body, init, window)
    q = se3.quat_normalize(q)
    return se3.make_se3(se3.quat_to_rotmat(q), jnp.zeros(3, jnp.float32))


def integrate_window_host(window: np.ndarray, count: int) -> np.ndarray:
    """NumPy mirror of :func:`integrate_window` for the host prior path.

    The prior is consumed as a host array by process_scan/process_chunk;
    running the ~10-sample quaternion chain as its own device program
    would cost one dispatch and one device-to-host sync PER FRAME.
    Sensor-rate bookkeeping belongs on the host; the in-jit version remains for
    fully-fused device pipelines. Semantics identical (same Euler
    quaternion kinematics, reference odom.cc:885-918); agreement is
    pinned by a test.
    """
    q = np.array([1.0, 0.0, 0.0, 0.0])
    if count <= 0:
        out = np.eye(4, dtype=np.float32)
        return out
    prev = window[0, 0]
    for i in range(1, int(count)):
        stamp = window[i, 0]
        ox, oy, oz = window[i, 1:4]
        dt = stamp - prev
        qw, qx, qy, qz = q
        dq = np.array([
            -0.5 * (qx * ox + qy * oy + qz * oz),
            0.5 * (qw * ox - qz * oy + qy * oz),
            0.5 * (qz * ox + qw * oy - qx * oz),
            0.5 * (qx * oy - qy * ox + qw * oz),
        ])
        q = q + dq * dt
        prev = stamp
    q = q / max(np.linalg.norm(q), 1e-12)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    return out


def gravity_align_quat(accel_mean: jnp.ndarray) -> jnp.ndarray:
    """Quaternion rotating the measured gravity direction onto +z.

    Reference ``odom.cc:556-560`` (FromTwoVectors onto (0,0,1)).
    """
    grav = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    return se3.quat_from_two_vectors(accel_mean.astype(jnp.float32), grav)
