"""k1_roofline: kernel K1 (exact kNN, csrc/knn.cu) in the profiled
session, in %: the sum of each launch's least time (harness/bounds.py
`k1_bound_s`, from the inputs the probes kept) over the sum of its device
time (the profiler's knn_prepass_kernel and knn_tiles_kernel). Null where
the probes did not see every launch the program counted. Moves
scans_per_s."""


def read(run):
    t, b = run.trace, run.kernel_bound_s.get("K1")
    if t is None or b is None or not t.kernel_s.get("K1"):
        return None
    return 100.0 * b / t.kernel_s["K1"]
