"""Plain references of the benchmark's configurations (PyTorch and NumPy).

They import neither JAX nor anything of the program under test, take
only the raw inputs and the frozen model that the benchmark hands both
sides, and compute in float64 on whatever device the inputs lie on.
"""
