"""The plain reference the benchmark holds the program to: NumPy, SciPy and plain PyTorch,
importing nothing of mesheditor_tpu_torch (nor JAX, nor the JAX package)."""
