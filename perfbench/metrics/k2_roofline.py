"""k2_roofline: kernel K2 (one GN iteration's H/g build, csrc/gn.cu) in
the profiled session, in %: the sum of each launch's least time
(harness/bounds.py `k2_bound_s`) over the sum of its device time (the
profiler's gn_iteration_kernel). Null where the probes did not see every
launch the program counted. Moves scans_per_s."""


def read(run):
    t, b = run.trace, run.kernel_bound_s.get("K2")
    if t is None or b is None or not t.kernel_s.get("K2"):
        return None
    return 100.0 * b / t.kernel_s["K2"]
