"""Materials: the reference's 4-way BSDF enum, compiled to a table + masks.

Port of `rpt_tpu/materials.py` (`rpt/src/material.rs:8-289`):
one row per distinct material in a small table, every hit tagged with a
material id, and ``sample_f``/``bsdf`` evaluated branchlessly across the
wavefront (all four lobes computed, selected by the kind mask).

Reference quirks kept (see the JAX module): ``bsdf`` is 0 unless both
``wi`` and ``wo`` are above the surface; Mirror/Transmissive ``bsdf`` is
(1,1,1); ``is_mirror`` is true for Mirror AND Transmissive.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import sampling
from .dtypes import DTYPE
from .vec import Vec3, reflect, take, where

LAMBERTIAN = 0
PHONG = 1
MIRROR = 2
TRANSMISSIVE = 3


@dataclass(frozen=True)
class Material:
    """Host-side material description (one enum variant of material.rs:8-23)."""

    kind: int = LAMBERTIAN
    albedo: tuple = (0.5, 0.5, 0.5)  # default grey lambertian (material.rs:25-32)
    emittance: float = 0.0
    shininess: float = 0.0
    ior: float = 1.0

    # constructors mirroring material.rs:36-97 ---------------------------
    @staticmethod
    def diffuse(color) -> "Material":
        return Material(LAMBERTIAN, _tup(color))

    @staticmethod
    def specular(color, roughness: float) -> "Material":
        return Material(PHONG, _tup(color), shininess=roughness)

    @staticmethod
    def mirror() -> "Material":
        return Material(MIRROR, (0.0, 0.0, 0.0))

    @staticmethod
    def transmissive(ior: float) -> "Material":
        return Material(TRANSMISSIVE, (0.0, 0.0, 0.0), ior=ior)

    @staticmethod
    def clear(index: float, _roughness: float = 0.0) -> "Material":
        return Material(TRANSMISSIVE, (0.0, 0.0, 0.0), ior=index)

    @staticmethod
    def transparent(color, index: float, _roughness: float = 0.0) -> "Material":
        return Material(TRANSMISSIVE, _tup(color), ior=index)

    @staticmethod
    def metallic(color, roughness: float) -> "Material":
        return Material(PHONG, _tup(color), shininess=roughness)

    @staticmethod
    def light(color, emittance: float) -> "Material":
        return Material(LAMBERTIAN, _tup(color), emittance=emittance)

    # queries mirroring material.rs:100-141 ------------------------------
    def emittance_value(self) -> float:
        return self.emittance if self.kind in (LAMBERTIAN, PHONG) else 0.0

    def color_value(self) -> tuple:
        return self.albedo if self.kind in (LAMBERTIAN, PHONG) else (0.0, 0.0, 0.0)

    def is_mirror(self) -> bool:
        return self.kind in (MIRROR, TRANSMISSIVE)


def _tup(c) -> tuple:
    if isinstance(c, Vec3):
        return (float(c.x), float(c.y), float(c.z))
    return tuple(float(v) for v in c)


# -------------------------------------------------------------------------
# Compiled material table


@dataclass(frozen=True)
class MaterialTable:
    """Device-side SoA table; every hit carries an int32 row index."""

    kind: torch.Tensor  # (M,) int32
    albedo: Vec3  # (M,)
    emittance: torch.Tensor  # (M,)
    shininess: torch.Tensor  # (M,)
    ior: torch.Tensor  # (M,)

    @staticmethod
    def build(materials: list, device=None) -> "MaterialTable":
        if not materials:
            materials = [Material()]
        f = dict(dtype=DTYPE, device=device)
        return MaterialTable(
            torch.tensor([m.kind for m in materials], dtype=torch.int32, device=device),
            Vec3.from_array(np.array([m.albedo for m in materials], np.float64), device),
            torch.tensor(np.array([m.emittance for m in materials], np.float64), **f),
            torch.tensor(np.array([m.shininess for m in materials], np.float64), **f),
            torch.tensor(np.array([m.ior for m in materials], np.float64), **f),
        )

    def lookup(self, ids) -> "MaterialLanes":
        ids = torch.clamp(ids, min=0).long()  # -1 (miss) reads row 0; callers mask
        return MaterialLanes(
            self.kind[ids],
            take(self.albedo, ids),
            self.emittance[ids],
            self.shininess[ids],
            self.ior[ids],
        )


@dataclass(frozen=True)
class MaterialLanes:
    """Per-ray material parameters (gathered rows of MaterialTable)."""

    kind: torch.Tensor
    albedo: Vec3
    emittance: torch.Tensor
    shininess: torch.Tensor
    ior: torch.Tensor

    def emittance_query(self) -> torch.Tensor:
        return torch.where(self.kind <= PHONG, self.emittance, torch.zeros_like(self.emittance))

    def color_query(self) -> Vec3:
        zero = Vec3.zeros(self.kind.shape, self.kind.device)
        return where(self.kind <= PHONG, self.albedo.broadcast_to(self.kind.shape), zero)

    def is_mirror(self) -> torch.Tensor:
        return self.kind >= MIRROR

    def repeat(self, k: int) -> "MaterialLanes":
        """Each lane repeated k times, lane-major: (n,) -> (n*k,)."""
        def r(a):
            return a.repeat_interleave(k)
        return MaterialLanes(r(self.kind), self.albedo.map(r), r(self.emittance),
                             r(self.shininess), r(self.ior))


def _schlick(ni, nt, cos_theta_i):
    """material.rs:159-162."""
    r0 = ((ni - nt) / (ni + nt)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta_i) ** 5


def sample_f(mat: MaterialLanes, normal: Vec3, wo: Vec3, keys):
    """Sample a bounce direction per lane; returns (wi, pdf, valid) —
    vectorized port of material.rs:166-263 (``valid`` is False on total
    internal reflection)."""
    r1, r2, rr = sampling.draw(keys, sampling.Draw((0xB5DF,), 2), sampling.Draw((0xF7E5,)))

    wi_lam, pdf_lam = sampling.cosine_hemisphere(r1, r2, normal)

    reflected = -reflect(wo, normal)
    wi_phong, pdf_phong = sampling.phong_lobe(r1, r2, mat.shininess, reflected)

    wi_mirror = -reflect(wo, normal.normalize())

    inside = normal.dot(wo) < 0.0
    n_eff = where(inside, -normal, normal)
    cos_i = torch.clamp(wo.dot(n_eff), 0.0, 1.0)
    ior = mat.ior
    one = torch.ones_like(pdf_lam)
    ni = torch.where(inside, ior, one)
    nt = torch.where(inside, one, ior)
    schlick_ratio = torch.clamp(_schlick(ni, nt, cos_i), 0.0, 1.0)
    reflect_branch = rr < schlick_ratio
    eta = ni / nt
    disc = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = disc < 0.0
    cos_t = torch.sqrt(torch.clamp(disc, min=0.0))
    refracted = (-wo) * eta + n_eff * (eta * cos_i - cos_t)
    wi_trans = where(reflect_branch, -reflect(wo, normal), refracted)
    valid_trans = reflect_branch | ~tir

    kind = mat.kind
    wi = where(
        kind == LAMBERTIAN,
        wi_lam,
        where(kind == PHONG, wi_phong, where(kind == MIRROR, wi_mirror, wi_trans)),
    )
    pdf = torch.where(kind == LAMBERTIAN, pdf_lam, torch.where(kind == PHONG, pdf_phong, one))
    valid = torch.where(kind == TRANSMISSIVE, valid_trans, torch.ones_like(valid_trans))
    return wi, pdf, valid


def bsdf(mat: MaterialLanes, normal: Vec3, wo: Vec3, wi: Vec3) -> Vec3:
    """Evaluate the BSDF per lane — port of material.rs:266-289."""
    n_dot_wi = normal.dot(wi)
    n_dot_wo = normal.dot(wo)
    above = (n_dot_wi >= 0.0) & (n_dot_wo >= 0.0)

    f_lam = mat.albedo * sampling.INV_PI

    norm = mat.albedo * ((mat.shininess + 2.0) / sampling.TWO_PI)
    reflected = (-reflect(wi, normal)).normalize()
    f_phong = norm * torch.clamp(reflected.dot(wo), 0.0, 1.0) ** mat.shininess

    shape = n_dot_wi.shape
    dev = n_dot_wi.device
    ones = Vec3.ones(shape, dev)
    kind = mat.kind
    f = where(kind == LAMBERTIAN, f_lam, where(kind == PHONG, f_phong, ones))
    return where(above, f, Vec3.zeros(shape, dev))
