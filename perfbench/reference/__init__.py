"""Plain float64 references that judge the program's answers.

Nothing here imports jax, lis_slam_tpu or lis_slam_torch: each module
restates the mathematics it checks in numpy."""
