"""Plain references the benchmark judges the program's outputs by.

Plain PyTorch and NumPy only: nothing here imports the program under
test, its kernels or its JAX original.
"""
