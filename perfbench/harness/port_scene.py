"""A scene description (`perfbench.scenes`) handed to the port through
its public scene API: the system under test gets the same inputs as the
plain reference, and nothing else.

`build_renderer` here is the default builder, for descriptions in its
vocabulary (diffuse, specular and light materials; meshes from arrays,
planes, cubes and spheres; ambient and sphere lights; a homogeneous
medium). A configuration whose scene needs more defines its own
``build_renderer(desc, seed, device)`` in its scene module, and
`builder` finds it there."""

from __future__ import annotations


def _material(rpt, m: dict):
    c = m["color"]
    col = rpt.hex_color(c) if isinstance(c, int) else tuple(c)
    if m["kind"] == "diffuse":
        return rpt.Material.diffuse(col)
    if m["kind"] == "specular":
        return rpt.Material.specular(col, m["roughness"])
    if m["kind"] == "light":
        return rpt.Material.light(col, m["emittance"])
    raise ValueError(f"unknown material kind {m['kind']!r}")


def _transformed(shape, steps):
    for op, arg in steps:
        shape = getattr(shape, op)(arg)
    return shape


def _shape(rpt, o: dict):
    if o["shape"] == "mesh":
        return _transformed(rpt.Mesh(o["vertices"], o["normals"]), o["transform"])
    if o["shape"] == "plane":
        return rpt.plane(o["normal"], o["value"])
    if o["shape"] == "cube":
        return _transformed(rpt.cube(), o["transform"])
    if o["shape"] == "sphere":
        return _transformed(rpt.sphere(), o["transform"])
    raise ValueError(f"unknown shape {o['shape']!r}")


def camera(rpt, cam: dict):
    if "look_at" in cam:
        la = cam["look_at"]
        return rpt.Camera.look_at(tuple(la["eye"]), tuple(la["center"]), tuple(la["up"]),
                                  la["fov"])
    return rpt.Camera(eye=tuple(cam["eye"]), direction=tuple(cam["direction"]),
                      up=tuple(cam["up"]), fov=cam["fov"])


def builder(scene):
    """The function that builds the port's `Renderer` for the scene module
    ``scene`` (`perfbench/scenes/<config>.py`): the module's own
    ``build_renderer`` where it defines one, else `build_renderer`."""
    return getattr(scene, "build_renderer", build_renderer)


def build_renderer(desc: dict, seed: int, device: str):
    """The port's `Renderer` for ``desc``: objects first (an object marked
    ``light`` is added with its material, as geometry and as a light),
    then the lights in order, then the medium."""
    import rpt_tpu_torch as rpt

    scene = rpt.Scene()
    for o in desc["objects"]:
        shape, mat = _shape(rpt, o), _material(rpt, o["material"])
        scene.add((shape, mat) if o.get("light") else rpt.Object(shape).material(mat))
    for light in desc["lights"]:
        if light["kind"] == "ambient":
            scene.add(rpt.Light.Ambient(tuple(light["color"])))
        else:
            scene.add(rpt.Light.Object(rpt.Object(_shape(rpt, light))
                                       .material(_material(rpt, light["material"]))))
    med = desc["medium"]
    if med is not None:
        scene.add(rpt.Medium.homogeneous_isotropic(med["absorption"], med["scattering"]))
    return (rpt.Renderer(scene, camera(rpt, desc["camera"]), device=device)
            .width(desc["width"]).height(desc["height"]).max_bounces(desc["max_bounces"])
            .media_max_depth(desc["media_max_depth"]).exposure_value(desc["exposure_value"])
            .num_samples(1).seed(seed))
