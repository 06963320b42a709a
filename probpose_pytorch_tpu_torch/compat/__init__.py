"""Weight interchange with the JAX package (numpy in, no jax imported)."""
