"""The open-ceiling foggy Cornell scene of the skybox examples on the
PyTorch port (the port's side of `examples/_skybox.py`, which imports
`rpt_tpu`; reference `examples/skybox.rs:10-110`): a box 1,409 units
deep with a hole in its ceiling, a light of emittance 50,000 above the
hole, a sky-blue `ColorEnvironment` and a homogeneous isotropic fog."""

import math

import numpy as np

import rpt_tpu_torch as rpt


def camera() -> rpt.Camera:
    return rpt.Camera(
        eye=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0), fov=0.686
    )


def build_scene() -> rpt.Scene:
    """`examples/_skybox.py:20-102`."""
    scene = rpt.Scene()
    white = rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
    red = rpt.Material.diffuse(rpt.hex_color(0xBC0000))
    green = rpt.Material.diffuse(rpt.hex_color(0x00BC00))
    light_mtl = rpt.Material.light(rpt.hex_color(0xFFFEFA), 50000.0)

    floor = rpt.polygon([(0, 0, -850.0), (0, 0, 559.2), (556, 0, 559.2), (556, 0, -850.0)])
    p1 = np.array([343.0 - 50.0, 548.9, 227.0])
    p2 = np.array([343.0 - 50.0, 548.9, 332.0])
    p3 = np.array([213.0 + 50.0, 548.9, 332.0])
    p4 = np.array([213.0 + 50.0, 548.9, 227.0])
    c1 = np.array([0.0, 548.9, -850.0])
    c2 = np.array([556.0, 548.9, -850.0])
    c3 = np.array([556.0, 548.9, 559.2])
    c4 = np.array([0.0, 548.9, 559.2])
    br = np.array([p3[0], c4[1], c4[2]])
    bl = np.array([p2[0], c3[1], c3[2]])
    fr = np.array([p4[0], c1[1], c1[2]])
    fl = np.array([p1[0], c2[1], c2[2]])

    ceilings = (rpt.polygon([c1, fr, br, c4]), rpt.polygon([p3, p2, bl, br]),
                rpt.polygon([fl, c2, c3, bl]), rpt.polygon([fr, fl, p1, p4]))

    shift = np.array([0.0, 500.0, 0.0])
    light_rect = rpt.polygon([p1 + shift, p2 + shift, p3 + shift, p4 + shift]).translate(
        (-50.0, 0.0, 50.0)
    )

    back_wall = rpt.polygon(
        [(0, 0, 559.2), (0, 548.9, 559.2), (556, 548.9, 559.2), (556, 0, 559.2)]
    )
    front_wall = rpt.polygon(
        [(0, 0, -850.0), (556, 0, -850.0), (556, 548.9, -850.0), (0, 548.9, -850.0)]
    )
    right_wall = rpt.polygon(
        [(0, 0, -850.0), (0, 548.9, -850.0), (0, 548.9, 559.2), (0, 0, 559.2)]
    )
    left_wall = rpt.polygon(
        [(556, 0, -850.0), (556, 0, 559.2), (556, 548.9, 559.2), (556, 548.9, -850.0)]
    )
    large_box = (
        rpt.cube()
        .scale((165.0, 330.0, 165.0))
        .rotate_y(2 * math.pi * (-253.0 / 360.0))
        .translate((368.0, 165.0, 351.0))
    )
    small_box = (
        rpt.cube()
        .scale((165.0, 165.0, 165.0))
        .rotate_y(2 * math.pi * (-197.0 / 360.0))
        .translate((185.0, 82.5, 169.0))
    )

    scene.add(rpt.Object(floor).material(white))
    for c in ceilings:
        scene.add(rpt.Object(c).material(white))
    scene.add(rpt.Object(back_wall).material(white))
    scene.add(rpt.Object(front_wall).material(white))
    scene.add(rpt.Object(left_wall).material(red))
    scene.add(rpt.Object(right_wall).material(green))
    scene.add(rpt.Object(large_box).material(white))
    scene.add(rpt.Object(small_box).material(white))
    scene.add((light_rect, light_mtl))
    scene.add(rpt.ColorEnvironment(tuple(float(v) for v in rpt.hex_color(0x87CEEB).to_numpy())))
    scene.add(rpt.Medium.homogeneous_isotropic(0.0003, 0.0003))
    return scene
