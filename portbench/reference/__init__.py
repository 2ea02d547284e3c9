"""The plain reference the benchmark compares the program with: torch and
NumPy only, nothing of the program and nothing of JAX."""
