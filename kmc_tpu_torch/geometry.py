"""Rigid-body geometry on tensors (port of ``kmc_tpu/geometry.py``).

Every function broadcasts over arbitrary leading axes (replicas, molecules,
points); the last axis is the vector.  The expressions keep the JAX
package's operation order, so results agree to the float32 rounding of the
two libraries' cos/sin/atan2/sqrt.
"""

from __future__ import annotations

import math

import torch


def angle_between_deg(u, v, eps=1e-12):
    """Angle in degrees between u and v, acos-clamped (reference
    ``gettheta``, main.cpp:2329-2366)."""
    nu = torch.linalg.vector_norm(u, dim=-1)
    nv = torch.linalg.vector_norm(v, dim=-1)
    c = (u * v).sum(-1) / torch.clamp(nu * nv, min=eps)
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def _dot3(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def angle_gate_above_deg(u, v, thresh_deg):
    """True where angle(u, v) > thresh_deg, in the cosine domain:
    theta > T  <=>  cos(theta) < cos(T)."""
    dot = _dot3(u, v)
    n2 = _dot3(u, u) * _dot3(v, v)
    return dot < math.cos(math.radians(thresh_deg)) * torch.sqrt(n2)


def angle_gate_below_deg(u, v, thresh_deg):
    """True where angle(u, v) < thresh_deg (same construction)."""
    dot = _dot3(u, v)
    n2 = _dot3(u, u) * _dot3(v, v)
    return dot > math.cos(math.radians(thresh_deg)) * torch.sqrt(n2)


def wrap_shift(coord, box):
    """Minimum-image shift ``box * round(coord / box)`` (main.cpp:597-598)."""
    return box * torch.round(coord / box)


def reflect_z(z, box_z):
    """Reference z reflection for ligands (main.cpp:925-931)."""
    return -z + 2.0 * wrap_shift(z, box_z)


# --------------------------------------------------------------------------
# Quaternions (w, x, y, z).  The reference Euler matrix factors as
# Rz(phi) @ Rx(theta) @ Rz(psai), so its quaternion is
# qz(phi) * qx(theta) * qz(psai).

def quat_identity(shape=(), device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q


def quat_axis_z(angle):
    h = angle / 2.0
    z = torch.zeros_like(h)
    return torch.stack([torch.cos(h), z, z, torch.sin(h)], dim=-1)


def quat_axis_x(angle):
    h = angle / 2.0
    z = torch.zeros_like(h)
    return torch.stack([torch.cos(h), torch.sin(h), z, z], dim=-1)


def quat_mul(a, b):
    """Hamilton product; broadcasts."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_from_euler(theta, phi, psai):
    """Quaternion of the reference Euler convention Rz(phi)Rx(theta)Rz(psai)."""
    return quat_mul(quat_axis_z(phi), quat_mul(quat_axis_x(theta),
                                               quat_axis_z(psai)))


def mat3_apply(r, v):
    """Batched 3x3 matrix-vector product: r (..., 3, 3), v (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            r[..., 0, 0] * x + r[..., 0, 1] * y + r[..., 0, 2] * z,
            r[..., 1, 0] * x + r[..., 1, 1] * y + r[..., 1, 2] * z,
            r[..., 2, 0] * x + r[..., 2, 1] * y + r[..., 2, 2] * z,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4):
    v' = v + 2 w (u x v) + 2 u x (u x v), u = q.xyz."""
    w, ux, uy, uz = q.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    tx = uy * vz - uz * vy
    ty = uz * vx - ux * vz
    tz = ux * vy - uy * vx
    ox = vx + 2.0 * (w * tx + uy * tz - uz * ty)
    oy = vy + 2.0 * (w * ty + uz * tx - ux * tz)
    oz = vz + 2.0 * (w * tz + ux * ty - uy * tx)
    return torch.stack([ox, oy, oz], dim=-1)


def quat_to_mat(q):
    """Rotation matrix (..., 3, 3) of a unit quaternion (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def align_angle_2d(a, b, eps=1e-12):
    """CCW angle that rotates 2D vector ``a`` onto the direction of ``b``
    (the reference's ``atan2(-det, -dot) + pi``, main.cpp:1479-1486)."""
    dot = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    det = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return torch.atan2(det, dot + eps * (dot == 0))
