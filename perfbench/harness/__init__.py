"""The benchmark harness of lis_slam_torch (see perfbench/run.py)."""
