"""k3_roofline: kernel K3 (the batched 6x6 GN solve, csrc/gn_solve.cu)
in the profiled session, in %: the sum of each launch's least time
(harness/bounds.py `k3_bound_s`, from the lane states the probes kept)
over the sum of its device time (the profiler's gn_solve_kernel). Null
where the probes did not see every launch the program counted. Moves
scans_per_s."""


def read(run):
    t, b = run.trace, run.kernel_bound_s.get("K3")
    if t is None or b is None or not t.kernel_s.get("K3"):
        return None
    return 100.0 * b / t.kernel_s["K3"]
