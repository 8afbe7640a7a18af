from detprocess_jax.ops import (  # noqa: F401
    spectral,
    filterbank,
    of1x1,
    tracestats,
    psdfeatures,
)
