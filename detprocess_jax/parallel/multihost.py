"""Multi-host scale-out: series sharding across hosts + global meshes.

The reference scales across nodes with SLURM + ipyparallel, workers never
communicating (scripts/savio_processing.sh:22-25,
scripts/process_parallel.py:33-36; SURVEY.md §2.2). The equivalents
here:

1. **Embarrassingly parallel series split** (`split_series_for_host`):
   each host processes a disjoint slice of the raw series and writes
   uniquely-named output series (`output_series_num + node_num`
   convention, features.py:502-504) — a drop-in for the SLURM pattern,
   no inter-host communication.
2. **Single-controller multi-host JAX** (`initialize`, `global_mesh`):
   `jax.distributed.initialize()` + one global mesh over all devices;
   event batches shard over the global `events` axis and PSD/CSD psums
   run as collectives within and across hosts (parallel.mesh kernels
   are mesh-agnostic and work unchanged).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


def split_series_for_host(series_list: Sequence[str],
                          node_num: Optional[int] = None,
                          nb_nodes: Optional[int] = None) -> List[str]:
    """Disjoint per-host series slice (np.array_split semantics, matching
    the reference's per-worker split, features.py:1137-1171).

    Defaults pull node identity from SLURM (SLURM_PROCID/SLURM_NTASKS) or
    jax.process_index when initialized.
    """
    if node_num is None:
        node_num = int(os.environ.get("SLURM_PROCID", 0))
    if nb_nodes is None:
        nb_nodes = int(os.environ.get("SLURM_NTASKS", 0)) or 1
    if nb_nodes <= 1:
        return list(series_list)
    chunks = np.array_split(np.asarray(series_list, dtype=object), nb_nodes)
    return [str(s) for s in chunks[node_num]]


def output_series_num_for_host(base_series_num: int,
                               node_num: Optional[int] = None) -> int:
    """Unique output series number per node (features.py:502-504)."""
    if node_num is None:
        node_num = int(os.environ.get("SLURM_PROCID", 0))
    return base_series_num + node_num


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """jax.distributed.initialize wrapper (no-op when single-process)."""
    import jax

    if num_processes in (None, 0, 1) and coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis_name: str = "events"):
    """1-D mesh over ALL devices across hosts (requires initialize() in
    multi-process settings)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))
