"""The revisiting plaza of the full-SLAM lap (harness/render.py
`plaza_world`): its geometry is fixed, the seed is not read."""

from perfbench.harness.render import World, plaza_world


def build(seed: int) -> World:
    return plaza_world()
