"""Batched multi-sequence replay (port of lis_slam_tpu/parallel)."""
