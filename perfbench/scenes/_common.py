"""Helpers of the scene builders."""

from __future__ import annotations


def color(value):
    """A colour of a configuration file: a hex string such as "0xAAAAAA"
    (an sRGB hex colour, as `hex_color`) or three linear floats."""
    if isinstance(value, str):
        return int(value, 16)
    return tuple(float(c) for c in value)


def transform(scale=None, rotate_y=None, translate=None) -> list:
    """The transform steps in the order the scene API applies them."""
    steps = []
    if scale is not None:
        steps.append(("scale", tuple(float(c) for c in scale)))
    if rotate_y is not None:
        steps.append(("rotate_y", float(rotate_y)))
    if translate is not None:
        steps.append(("translate", tuple(float(c) for c in translate)))
    return steps
