"""detprocess_jax — a JAX framework for cryogenic TES detector data processing.

A from-scratch rebuild (JAX/XLA) of the capabilities of
`spice-herald/detprocess` plus the QETpy numerical kernels it delegates to.
The design inverts the reference's per-event Python loop: fixed-shape batches
of traces ``[batch, channel, samples]`` flow through jit-compiled, vmapped
kernels; filter precomputation (optimal filters, weight matrices) is done once
as arrays; sharding over a device mesh replaces the reference's
multiprocessing.Pool-over-series (reference: detprocess/process/features.py:391-420).

Layers
------
- ``ops``       : device kernels — FFT/PSD, optimal filters, trigger, autocuts, fits
- ``models``    : physics models — pulse templates, dIdV admittance, TES noise, IV bias
- ``parallel``  : device-mesh sharding helpers (shard_map/pjit over an `events` axis)
- ``io``        : host-side HDF5 IO — raw pytesdaq-format data, filter files, tables
- ``config``    : YAML processing-configuration compiler
- ``pipelines`` : orchestration — feature extraction, triggering, randoms, noise,
                  filter generation, IV sweep, salting
- ``utils``     : channel-name algebra, windowing, frequency helpers
"""

__version__ = "0.1.0"

from detprocess_jax.utils import channels, windows, freq  # noqa: F401


def __getattr__(name):
    """Lazy top-level access to the main user-facing classes."""
    _exports = {
        "FeatureProcessing": "detprocess_jax.pipelines.features",
        "TriggerProcessing": "detprocess_jax.pipelines.triggers",
        "EventBuilder": "detprocess_jax.pipelines.triggers",
        "OptimumFilterTrigger": "detprocess_jax.pipelines.oftrigger",
        "Randoms": "detprocess_jax.pipelines.randoms",
        "Salting": "detprocess_jax.pipelines.salting",
        "Noise": "detprocess_jax.pipelines.noise",
        "NoiseModel": "detprocess_jax.pipelines.noisemodel",
        "DIDVAnalysis": "detprocess_jax.pipelines.didv",
        "IVSweepProcessing": "detprocess_jax.pipelines.ivsweep",
        "IVSweepAnalysis": "detprocess_jax.pipelines.ivsweep",
        "Template": "detprocess_jax.pipelines.template",
        "FilterBuilder": "detprocess_jax.pipelines.template",
        "FilterDataProcessing": "detprocess_jax.pipelines.filtergen",
        "FilterData": "detprocess_jax.io.filterfile",
        "RawData": "detprocess_jax.io.rawdata",
        "YamlConfig": "detprocess_jax.config.yamlconfig",
    }
    if name in _exports:
        import importlib
        module = importlib.import_module(_exports[name])
        return getattr(module, name)
    if name == "cli":
        import importlib
        return importlib.import_module("detprocess_jax.cli")
    raise AttributeError(f"module 'detprocess_jax' has no attribute {name!r}")
