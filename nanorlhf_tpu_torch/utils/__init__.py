"""Host-side helpers (copies of the JAX package's jax-free `utils/` modules)."""
