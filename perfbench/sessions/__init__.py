"""One session driver per kind of traffic, found by the traffic's
`session`: `<name>.py` defines `Sessions(cfg, config, traffic, device,
probes)` with `run(traced=False, capture=True) -> harness.program.Session`
(harness/program.py)."""
