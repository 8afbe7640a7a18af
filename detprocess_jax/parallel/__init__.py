from detprocess_jax.parallel import mesh, multihost  # noqa: F401
