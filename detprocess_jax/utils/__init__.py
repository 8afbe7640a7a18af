from detprocess_jax.utils import channels, windows, freq, misc, logging  # noqa: F401
