"""Particle systems and RK4 integration — port of `rpt_tpu/ode.py`
(`rpt/src/ode/*`).

``ParticleState`` holds positions and velocities as (n,) component
`Vec3`s; a system defines ``time_derivative``; ``rk4_integrate`` runs
classic fixed-step RK4 with a remainder step (particle_system.rs:10-25) as
a Python loop over tensors (the JAX package scans on its device). Forces
are dense (n, n) pair tensors. No kernel: the largest system, the marbles
example's, has 25 particles.

Powers with integer exponents multiply as XLA's ``integer_pow`` does
(`_ipow`), so they round as the JAX package's do. The closest-point grid
(``linspace``) may differ from XLA's by an ulp at some samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dtypes import DTYPE, resolve_device
from .vec import Vec3, where


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an integer n by binary exponentiation, as XLA's
    ``integer_pow`` rounds it (a negative n: the reciprocal of x ** -n)."""
    acc, base, m = None, x, abs(n)
    while m:
        if m & 1:
            acc = base if acc is None else acc * base
        m >>= 1
        if m:
            base = base * base
    return 1.0 / acc if n < 0 else acc


@dataclass(frozen=True)
class ParticleState:
    """Positions + velocities (particle_state.rs:5-10)."""

    pos: Vec3
    vel: Vec3

    @staticmethod
    def of(pos, vel, device="cuda") -> "ParticleState":
        """From (n, 3) arrays, on ``device`` (the card unless the caller
        asks for the CPU)."""
        dev = resolve_device(device)
        return ParticleState(Vec3.from_array(np.asarray(pos), dev),
                             Vec3.from_array(np.asarray(vel), dev))

    def __add__(self, other: "ParticleState") -> "ParticleState":
        return ParticleState(self.pos + other.pos, self.vel + other.vel)

    def __mul__(self, s) -> "ParticleState":
        return ParticleState(self.pos * s, self.vel * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "ParticleState":
        return ParticleState(self.pos * (1.0 / s), self.vel * (1.0 / s))


class ParticleSystem:
    """Base: subclasses implement `time_derivative(state) -> ParticleState`
    (particle_system.rs:5-8)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        raise NotImplementedError

    def rk4_integrate(self, state: ParticleState, time: float, step: float) -> ParticleState:
        """Classic RK4 with fixed step + remainder (particle_system.rs:10-25)."""
        n_steps = int(np.floor(time / step)) if time > step else 0
        remainder = time - n_steps * step

        def one(state, h):
            k1 = self.time_derivative(state)
            k2 = self.time_derivative(state + k1 * (h / 2.0))
            k3 = self.time_derivative(state + k2 * (h / 2.0))
            k4 = self.time_derivative(state + k3 * h)
            return state + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (h / 6.0)

        for _ in range(n_steps):
            state = one(state, step)
        return one(state, remainder)


class SimpleCircleSystem(ParticleSystem):
    """d(pos)/dt = (-y, x, 0) (particle_system.rs:27-40)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        p = state.pos
        return ParticleState(Vec3(-p.y, p.x, torch.zeros_like(p.z)), Vec3.zeros(p.shape, p.device))


def _pairwise(pos: Vec3):
    """(n, n) pair displacement d_ij = pos_i - pos_j and distance."""
    dx = pos.x[:, None] - pos.x[None, :]
    dy = pos.y[:, None] - pos.y[None, :]
    dz = pos.z[:, None] - pos.z[None, :]
    dist = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
    return Vec3(dx, dy, dz), dist


def _row_sum(v: Vec3, mag: torch.Tensor) -> Vec3:
    return Vec3(torch.sum(v.x * mag, dim=1), torch.sum(v.y * mag, dim=1),
                torch.sum(v.z * mag, dim=1))


class SolidGravitySystem(ParticleSystem):
    """Pairwise r^-2 attraction with r^-5 core repulsion
    (particle_system.rs:43-63)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        d, dist = _pairwise(state.pos)
        eye = torch.eye(dist.shape[0], dtype=torch.bool, device=dist.device)
        # force on j from i (reference: acc[j] += dir*(r^-2 - 1e-4 r^-5))
        mag = torch.where(eye, 0.0, _ipow(dist, -2) - 1e-4 * _ipow(dist, -5))
        return ParticleState(state.vel, -_row_sum(d / dist, mag))


class MarblesSystem(ParticleSystem):
    """Marbles in a monomial-surface glass over a table
    (particle_system.rs:66-129): pair spring+damping contacts, glass
    contact via `closest_point`, table plane, air resistance."""

    def __init__(self, radius: float):
        self.radius = radius

    def time_derivative(self, state: ParticleState) -> ParticleState:
        pos, vel = state.pos, state.vel
        n, dev = pos.x.shape[0], pos.x.device
        radius = self.radius
        zeros = torch.zeros(n, dtype=DTYPE, device=dev)
        ones = torch.ones(n, dtype=DTYPE, device=dev)
        none = Vec3.zeros(n, dev)
        acc = Vec3(zeros, -ones, zeros)

        # marble-marble springs (particle_system.rs:74-85), net per particle
        d, dist = _pairwise(pos)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        touching = ~eye & (dist < 2.0 * radius)
        mag = torch.where(touching, 5.0 * (2.0 * radius - dist) / radius, 0.0)
        acc = acc + _row_sum(d / dist, mag)
        # contact damping: -0.5 * vel per touching pair (both sides)
        acc = acc + vel * (-0.5 * torch.sum(touching, dim=1).to(DTYPE))

        # glass surface contact (particle_system.rs:87-104)
        cvec = pos - monomial_closest_point(2.0, pos)
        clen = cvec.length()
        normal = cvec / torch.clamp(clen, min=1e-20)
        ratio = (radius - clen) / radius
        nvel = vel.dot(normal)
        damp_zone = (ratio > -0.1) & (ratio < 0.0)
        push_zone = ratio >= 0.0
        acc = acc + where(damp_zone, normal * (-30.0 * _ipow(nvel, 3)), none)
        acc = acc + where(push_zone, normal * (100.0 * ratio), none)

        # table plane (particle_system.rs:106-118)
        t_ratio = ((radius - 0.06) - pos.y) / radius
        off_glass = pos.length() > 0.1
        t_damp = off_glass & (t_ratio > -0.1) & (t_ratio < 0.0)
        t_push = off_glass & (t_ratio >= 0.0)
        up = Vec3(zeros, ones, zeros)
        acc = acc + where(t_damp, up * (-20.0 * vel.y), none)
        acc = acc + where(t_push, up * (300000.0 * t_ratio), none)

        # air resistance (particle_system.rs:119-122)
        acc = acc + vel * (-1.0 / 5.0)
        return ParticleState(vel, acc)


def monomial_closest_point(height: float, point: Vec3, samples: int = 201) -> Vec3:
    """Closest point on y = height*(x^2+z^2)^2 via the reference's 2D grid
    search (monomial_surface.rs:128-151; 201 samples = `closest_point`,
    20001 = `closest_point_precise`), vectorized over points."""
    length = point.length()
    px = torch.hypot(point.x, point.z)
    xs = torch.linspace(-1.0, 1.0, samples, dtype=DTYPE, device=point.x.device)
    ys = height * _ipow(xs, 4)
    d2 = _ipow(px[:, None] - xs[None, :], 2) + _ipow(point.y[:, None] - ys[None, :], 2)
    xf = xs[torch.argmin(d2, dim=1)]
    # back to 3D: scale the (x, z) unit direction by xf
    inv = 1.0 / torch.clamp(px, min=1e-30)
    xz_x = xf * point.x * inv
    xz_z = xf * point.z * inv
    out = Vec3(xz_x, height * _ipow(xz_x * xz_x + xz_z * xz_z, 2), xz_z)
    # degenerate near-origin case (monomial_surface.rs:129-132)
    return where(length < 1e-12, point, out)


def monomial_closest_point_precise(height: float, point: Vec3) -> Vec3:
    """20001-sample variant (monomial_surface.rs:154-177)."""
    return monomial_closest_point(height, point, samples=20001)
