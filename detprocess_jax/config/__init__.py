from detprocess_jax.config.yamlconfig import YamlConfig  # noqa: F401
