from detprocess_jax.models import pulse  # noqa: F401
