"""The plain reference the benchmark judges the program by.

Plain NumPy (float64) and, for the lower-precision control, bfloat16
rounding through PyTorch on the CPU. Nothing here imports the program, JAX
or the JAX package, and nothing takes a table, weight or intermediate that
the program made: the reference reads the program's outputs (its node
store's keypoints, its edges, its poses) only to judge them.
"""
