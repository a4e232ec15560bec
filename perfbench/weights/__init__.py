"""Weights that a configuration names, one module per kind, found by
name: a configuration file's `"weights": {"rangenet": <name>, "seed":
<n>}` hands `perfbench/weights/<name>.py`'s `build(cfg, seed, device)` the
program's configuration, the configuration's seed (weights are the
model, not the traffic: `--seed` does not change them) and the cell's
device. Set-up builds them once, and the session driver gives them to
the program (sessions/semantic_slam.py). A configuration that names no
weights runs the program's own default."""
