"""The plain reference: NumPy and plain PyTorch, importing nothing of the
program (hulk_tpu_torch) nor of the JAX package, and taking nothing the
program made."""
