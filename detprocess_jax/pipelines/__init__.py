from detprocess_jax.pipelines.features import FeatureProcessing  # noqa: F401
