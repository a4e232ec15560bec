"""City blocks with cars along the streets (harness/render.py
`make_world`), laid out from the traffic's `world_seed`."""

from perfbench.harness.render import World, make_world


def build(seed: int) -> World:
    return make_world(seed)
