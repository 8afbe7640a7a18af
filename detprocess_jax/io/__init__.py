from detprocess_jax.io.filterfile import FilterData  # noqa: F401
