"""Host-side shape descriptions and transforms (numpy copy of
`rpt_tpu/shapes.py`).

Parity: `rpt/src/shape.rs` and `src/shape/*.rs`. In the
reference these are trait objects intersected one ray at a time; here they
are *scene-description* values that the scene compiler
(`rpt_tpu_torch.scene`) lowers into SoA device tables, with intersection
done in vectorized torch code (`rpt_tpu_torch.intersect`).

Transforms follow `shape.rs:102-285`: a ``Transformed`` shape stores the
forward matrix; chaining ``translate/scale/rotate*`` composes matrices
without nesting. The compiler pre-bakes mesh vertices to world space and
stores inverse + normal matrices for analytic primitives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# 4x4 transform builders (glm semantics)


def translation_matrix(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def scale_matrix(v) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotation_matrix(angle: float, axis) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    m = np.eye(4)
    m[:3, :3] = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return m


class Transformable:
    """Fluent transform API (shape.rs:180-231). Each call wraps the shape in
    a ``Transformed`` (or composes with the existing transform)."""

    def translate(self, v) -> "Transformed":
        return Transformed(self, translation_matrix(v))

    def scale(self, v) -> "Transformed":
        return Transformed(self, scale_matrix(v))

    def rotate(self, angle: float, axis) -> "Transformed":
        return Transformed(self, rotation_matrix(angle, axis))

    def rotate_x(self, angle: float) -> "Transformed":
        return Transformed(self, rotation_matrix(angle, (1.0, 0.0, 0.0)))

    def rotate_y(self, angle: float) -> "Transformed":
        return Transformed(self, rotation_matrix(angle, (0.0, 1.0, 0.0)))

    def rotate_z(self, angle: float) -> "Transformed":
        return Transformed(self, rotation_matrix(angle, (0.0, 0.0, 1.0)))

    def transform(self, matrix) -> "Transformed":
        return Transformed(self, np.asarray(matrix, np.float64))


@dataclass(frozen=True)
class Sphere(Transformable):
    """Unit sphere at the origin (shape/sphere.rs)."""

    def bounding_box(self):
        return np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0])


@dataclass(frozen=True)
class Plane(Transformable):
    """x . normal = value (shape/plane.rs)."""

    normal: tuple
    value: float


@dataclass(frozen=True)
class Cube(Transformable):
    """Unit cube centered at the origin (shape/cube.rs)."""

    def bounding_box(self):
        return np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5])


@dataclass(frozen=True)
class MonomialSurface(Transformable):
    """y = height * (x^2 + z^2)^(exp/2), x^2+z^2 <= 1; exp must be 4
    (shape/monomial_surface.rs:8-19)."""

    height: float
    exp: float = 4.0

    def bounding_box(self):
        return np.array([-1.0, 0.0, -1.0]), np.array([1.0, 1.0, 1.0]) * np.array(
            [1.0, self.height, 1.0]
        )


class Mesh(Transformable):
    """A triangle soup stored as SoA numpy arrays.

    The reference's ``Mesh = KdTree<Triangle>`` (shape/mesh.rs:103) builds a
    per-mesh recursive kd-tree; this port instead keeps the raw
    triangles here and lets the scene compiler build one flattened world-space
    BVH over *all* scene triangles (`rpt_tpu_torch.accel.bvh`).

    ``vertices``: (n, 3, 3) float64 — per-triangle v1,v2,v3.
    ``normals``: (n, 3, 3) float64 — per-triangle n1,n2,n3 (may be
    unnormalized after transform baking; interpolation + final normalize
    matches the reference exactly, see shape.rs:133).
    """

    def __init__(self, vertices: np.ndarray, normals: np.ndarray | None = None):
        vertices = np.asarray(vertices, np.float64).reshape(-1, 3, 3)
        if normals is None:
            normals = flat_normals(vertices)
        self.vertices = vertices
        self.normals = np.asarray(normals, np.float64).reshape(-1, 3, 3)

    def __len__(self):
        return len(self.vertices)


def flat_normals(vertices: np.ndarray) -> np.ndarray:
    """Infer flat per-triangle normals (shape/mesh.rs:27-37)."""
    d0 = vertices[:, 1] - vertices[:, 0]
    d1 = vertices[:, 2] - vertices[:, 0]
    n = np.cross(d0, d1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm == 0.0, 1.0, norm)
    return np.repeat(n[:, None, :], 3, axis=1)


@dataclass
class Transformed(Transformable):
    """A shape composed with a homogeneous transform (shape.rs:102-152).

    Chained transforms compose without nesting (shape.rs:235-285).
    """

    shape: object
    matrix: np.ndarray = field(default_factory=lambda: np.eye(4))

    def translate(self, v) -> "Transformed":
        return Transformed(self.shape, translation_matrix(v) @ self.matrix)

    def scale(self, v) -> "Transformed":
        return Transformed(self.shape, scale_matrix(v) @ self.matrix)

    def rotate(self, angle: float, axis) -> "Transformed":
        return Transformed(self.shape, rotation_matrix(angle, axis) @ self.matrix)

    def rotate_x(self, angle: float) -> "Transformed":
        return Transformed(self.shape, rotation_matrix(angle, (1, 0, 0)) @ self.matrix)

    def rotate_y(self, angle: float) -> "Transformed":
        return Transformed(self.shape, rotation_matrix(angle, (0, 1, 0)) @ self.matrix)

    def rotate_z(self, angle: float) -> "Transformed":
        return Transformed(self.shape, rotation_matrix(angle, (0, 0, 1)) @ self.matrix)

    def transform(self, matrix) -> "Transformed":
        return Transformed(self.shape, np.asarray(matrix, np.float64) @ self.matrix)


def unwrap(shape) -> tuple[object, np.ndarray]:
    """Return (base_shape, forward 4x4 matrix)."""
    if isinstance(shape, Transformed):
        return shape.shape, shape.matrix
    return shape, np.eye(4)


class ShapeGroup(Transformable):
    """A collection of shapes treated as one object (the analog of the
    reference's ``KdTree::new(Vec<Box<dyn Bounded>>)`` used e.g. by
    `examples/fractal_spheres.rs:45-48`). The scene compiler flattens
    members into their per-type batches; acceleration is automatic."""

    def __init__(self, shapes):
        self.shapes = list(shapes)


#: Reference-API alias: ``KdTree::new(shapes)`` — acceleration structures
#: are implicit in this framework, so this is just a shape group.
KdTree = ShapeGroup


# ---------------------------------------------------------------------------
# Helper constructors (shape.rs:287-314)


def sphere() -> Sphere:
    return Sphere()


def plane(normal, value: float) -> Plane:
    return Plane(tuple(np.asarray(normal, np.float64)), float(value))


def cube() -> Cube:
    return Cube()


def monomial_surface(height: float, exp: float = 4.0) -> MonomialSurface:
    return MonomialSurface(height, exp)


def polygon(verts) -> Mesh:
    """Fan triangulation of a simple polygon (shape.rs:307-314)."""
    verts = [np.asarray(v, np.float64) for v in verts]
    tris = []
    for i in range(1, len(verts) - 1):
        tris.append([verts[0], verts[i], verts[i + 1]])
    return Mesh(np.asarray(tris))


def transform_mesh(mesh: Mesh, matrix: np.ndarray) -> Mesh:
    """Bake a transform into mesh vertices/normals.

    Vertices map by M; normals by M^-T *unnormalized* — interpolating
    unnormalized transformed vertex normals and normalizing at the end is
    algebraically identical to the reference's normalize(M^-T * n_interp)
    (shape.rs:133)."""
    m = np.asarray(matrix, np.float64)
    lin = m[:3, :3]
    nmat = np.linalg.inv(lin).T
    v = mesh.vertices @ lin.T + m[:3, 3]
    n = mesh.normals @ nmat.T
    return Mesh(v, n)


def mesh_bounding_box(mesh: Mesh):
    return mesh.vertices.reshape(-1, 3).min(0), mesh.vertices.reshape(-1, 3).max(0)
