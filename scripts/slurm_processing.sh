#!/bin/bash
# SLURM launcher for multi-node processing (reference equivalent:
# scripts/savio_processing.sh). Each task processes a disjoint slice of
# the raw series (parallel/multihost.split_series_for_host) and writes
# uniquely-numbered output series — no inter-node communication needed.
# One GPU per task: a JAX process reserves most of a card's memory when
# it starts, so two tasks on one card would starve each other.
#
#SBATCH --job-name=detprocess-jax
#SBATCH --ntasks=4
#SBATCH --gpus-per-task=1
#SBATCH --time=12:00:00

RAW_PATH=${1:?usage: sbatch slurm_processing.sh RAW_PATH CONFIG OUT}
CONFIG=${2:?config yaml required}
OUT=${3:?output path required}

# ONE output-series base for the whole job: each node adds its
# node_num to this (reference output_series_num + node_num). Deriving
# the base from per-node clocks instead would let skewed launches
# collide (node 0 starting a second late lands on node 1's name).
export DETPROC_BASE_SERIES=${DETPROC_BASE_SERIES:-$(date +I1_D%Y%m%d_T%H%M%S)}

srun --gpus-per-task=1 python "$(dirname "$0")/process_distributed.py" \
    --raw_path "$RAW_PATH" --processing_setup "$CONFIG" \
    --output_group_path "$OUT" --enable-trig --enable-feature
