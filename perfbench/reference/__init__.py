"""The plain references: plain PyTorch and NumPy, importing neither JAX,
nor the JAX package, nor anything of the port."""
