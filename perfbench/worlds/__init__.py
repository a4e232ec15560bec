"""One module per world the traffic drives through, found by the traffic's
`world`: `<name>.py` defines `build(seed) -> harness.render.World`."""
