"""imu_chain_ms: the LIO chain on the host (`LioOdometry.diag.imu_s`:
preintegration before the scan, velocity and bias refresh after it, in
float64), ms a scan over the window's sessions that ran without the
profiler. Moves scans_per_s."""


def read(run):
    if not run.span_scans or run.imu_s <= 0:
        return None
    return 1e3 * run.imu_s / run.span_scans
