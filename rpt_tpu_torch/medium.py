"""Participating media — port of `rpt_tpu/medium.py`
(`rpt/src/medium.rs`).

Fields are callables ``Vec3 -> tensor`` over position. Distance sampling
and transmittance follow the reference exactly, including evaluating
extinction at the ray origin only (medium.rs:126-130). Presets: the two
isotropic fogs of the reference and the JAX package's Henyey-Greenstein
medium, whose phase depends on the directions (``phase_const`` is None).
Each preset also records its constants as a `MediumPreset`, which
K-shoot (`ops/photon_shoot.py`) reads in place of the callables; a medium
built from bare callables has none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from . import sampling
from .color import hex_color
from .ray import Ray
from .vec import Vec3, from_local, where


ISOTROPIC = 1  # homogeneous_isotropic
GLOWING = 2  # colored_glowing_fog
HENYEY_GREENSTEIN = 3  # henyey_greenstein
GLOW_SPLIT_Y = 250.0  # colored_glowing_fog is red above this height, blue below


@dataclass(frozen=True)
class MediumPreset:
    """What a preset's callables compute, as numbers: its ``kind``, the
    absorption and scattering coefficients, the asymmetry ``g`` (0 for the
    isotropic kinds, whose phase is `Medium.phase_const`) and its colour,
    float32 values (for the glowing fog ``color`` above `GLOW_SPLIT_Y` and
    ``color_below`` under it)."""

    kind: int
    absorption: float
    scattering: float
    g: float
    color: tuple
    color_below: tuple


@dataclass(frozen=True)
class Medium:
    """Fields are callables over position (medium.rs:9-27); ``phase`` takes
    (wo, wi) and ``sample_ph`` takes (wo, keys) -> (wi, pdf)."""

    absorption: Callable
    scattering: Callable
    emission: Callable
    color: Callable
    phase: Callable
    sample_ph: Callable
    #: set when `phase` is a direction-independent constant (isotropic
    #: presets) — the sphere sweep kernel folds it into one scale
    phase_const: float | None = None
    #: the constants of a preset; None for a medium of the caller's own
    #: callables
    preset: MediumPreset | None = None

    def extinction(self, pos: Vec3):
        """sigma_t = sigma_a + sigma_s (medium.rs:56-60)."""
        return self.absorption(pos) + self.scattering(pos)

    def transmittence(self, ray: Ray, t_max):
        """Beer-Lambert using extinction at the ray origin (medium.rs:126-130).
        (Spelling kept from the reference.)"""
        return torch.exp(-self.extinction(ray.origin) * t_max)

    def sample_d(self, ray: Ray, keys):
        """Exponential free-flight sampling; returns (dist, pdf, cdf)
        (medium.rs:133-146)."""
        u = sampling.uniform(sampling.fold(keys, 0x5D), 0.0, 1.0)
        ext = self.extinction(ray.origin)
        dist = -torch.log(torch.clamp(u, min=1e-38)) / ext
        transmittence = torch.exp(-ext * dist)
        return dist, ext * transmittence, 1.0 - transmittence

    # presets -------------------------------------------------------------
    @staticmethod
    def homogeneous_isotropic(absorption: float, scattering: float) -> "Medium":
        """Uniform tan fog, isotropic phase (medium.rs:80-96); ``sample_ph``
        draws the exact uniform sphere its 1/(4 pi) pdf describes."""
        tan = hex_color(0xD2B48C)

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            return sampling.uniform_sphere(r1, r2), torch.full_like(r1, sampling.INV_4PI)

        return Medium(
            absorption=lambda p: torch.full_like(p.x, absorption),
            scattering=lambda p: torch.full_like(p.x, scattering),
            emission=lambda p: torch.zeros_like(p.x),
            color=lambda p: _const(tan, p),
            phase=lambda wo, wi: torch.full_like(wo.x, sampling.INV_4PI),
            sample_ph=sample_ph,
            phase_const=sampling.INV_4PI,
            preset=MediumPreset(ISOTROPIC, absorption, scattering, 0.0, _floats(tan),
                                _floats(tan)),
        )

    @staticmethod
    def colored_glowing_fog(absorption: float, scattering: float) -> "Medium":
        """Emissive two-color fog (medium.rs:99-121). Its phase constant is
        the reference's ``1/4 * pi`` (= pi/4, medium.rs:111), kept."""
        red, blue = hex_color(0xFF0000), hex_color(0x0000FF)
        phase_const = 0.25 * math.pi  # sic, medium.rs:111

        def color(p: Vec3) -> Vec3:
            return where(p.y > GLOW_SPLIT_Y, _const(red, p), _const(blue, p))

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            return sampling.uniform_sphere(r1, r2), torch.full_like(r1, phase_const)

        return Medium(
            absorption=lambda p: torch.full_like(p.x, absorption),
            scattering=lambda p: torch.full_like(p.x, scattering),
            emission=lambda p: torch.full_like(p.x, 10.0),
            color=color,
            phase=lambda wo, wi: torch.full_like(wo.x, phase_const),
            sample_ph=sample_ph,
            phase_const=phase_const,
            preset=MediumPreset(GLOWING, absorption, scattering, 0.0, _floats(red),
                                _floats(blue)),
        )

    @staticmethod
    def henyey_greenstein(absorption: float, scattering: float, g: float,
                          color=None) -> "Medium":
        """Homogeneous medium with a Henyey-Greenstein phase function of
        asymmetry ``g`` in (-1, 1) (`rpt_tpu/medium.py:112`; not in the
        reference). ``sample_ph`` inverts the CDF around ``-wo`` and returns
        the phase value as its pdf; ``abs(g) < 1e-6`` samples the uniform
        sphere."""
        col = color if color is not None else hex_color(0xD2B48C)

        def phase(wo: Vec3, wi: Vec3):
            # wo and wi both point away from the scattering point
            # (medium.rs:63-65): the angle between the transport directions
            cos_t = (-wo).dot(wi)
            denom = (1.0 + g * g + 2.0 * g * cos_t) ** 1.5
            return sampling.INV_4PI * (1.0 - g * g) / torch.clamp(denom, min=1e-12)

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            if abs(g) < 1e-6:
                return sampling.uniform_sphere(r1, r2), torch.full_like(r1, sampling.INV_4PI)
            sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * r1)
            cos_t = torch.clamp(-(1.0 + g * g - sq * sq) / (2.0 * g), -1.0, 1.0)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            phi = sampling.TWO_PI * r2
            local = Vec3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
            wi = from_local(local, -wo).normalize()
            return wi, phase(wo, wi)

        return Medium(
            absorption=lambda p: torch.full_like(p.x, absorption),
            scattering=lambda p: torch.full_like(p.x, scattering),
            emission=lambda p: torch.zeros_like(p.x),
            color=lambda p: _const(col, p),
            phase=phase,
            sample_ph=sample_ph,
            preset=MediumPreset(HENYEY_GREENSTEIN, absorption, scattering, g, _floats(col),
                                _floats(col)),
        )


def _floats(c: Vec3) -> tuple:
    """A host constant color as three Python floats."""
    return (float(c.x), float(c.y), float(c.z))


def _const(c: Vec3, p: Vec3) -> Vec3:
    """A host constant color broadcast to the shape and device of ``p``."""
    return Vec3(torch.full_like(p.x, float(c.x)), torch.full_like(p.x, float(c.y)),
                torch.full_like(p.x, float(c.z)))
