"""One reader per per-layer metric, found by the metric's name.

Each module `<name>.py` defines `read(run) -> float | None`, where `run` is
the harness's `harness.window.RunRecord`. A reader that finds nothing to
read returns None and the metric is left out of the result line."""
