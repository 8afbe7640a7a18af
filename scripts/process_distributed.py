"""Multi-node driver: per-host series slice + the standard CLI chain.

Reference equivalent: scripts/process_parallel.py (ipyparallel map over
files). Here each SLURM task takes a disjoint slice of the raw series
(parallel.multihost) and runs the normal pipelines on it; outputs carry
per-node unique series numbers, so results concatenate trivially.

Usage (under srun / or standalone with --node_num/--nb_nodes):
    python scripts/process_distributed.py --raw_path ... \
        --processing_setup process.yaml --enable-trig --enable-feature
"""

import os
import sys

from detprocess_jax import cli
from detprocess_jax.io.rawdata import (RawData, series_number_to_name,
                                       series_to_number)
from detprocess_jax.parallel import multihost
from detprocess_jax.utils.misc import create_series_name


def main(argv=None):
    parser = cli.build_parser()
    parser.add_argument("--node_num", type=int, default=None)
    parser.add_argument("--nb_nodes", type=int, default=None)
    args, remaining = parser.parse_known_args(argv)

    rawdata = RawData(args.raw_path,
                      data_type="calib" if args.calib else "continuous",
                      restricted=args.restricted)
    all_series = rawdata.get_series_list()
    my_series = multihost.split_series_for_host(
        all_series, node_num=args.node_num, nb_nodes=args.nb_nodes)
    if not my_series:
        print("INFO: no series assigned to this node")
        return 0
    print(f"INFO: node processes {len(my_series)}/{len(all_series)} series")

    # strip the node args INCLUDING their value tokens (`--node_num 0`
    # is two tokens; filtering only the flag left a stray "0" that the
    # CLI rejected)
    src = list(argv if argv is not None else sys.argv[1:])
    forwarded = []
    i = 0
    while i < len(src):
        a = src[i]
        if a.startswith(("--node_num", "--nb_nodes")):
            if "=" not in a and i + 1 < len(src) \
                    and not src[i + 1].startswith("-"):
                i += 1               # skip the separate value token
            i += 1
            continue
        forwarded.append(a)
        i += 1
    forwarded += ["--series", *my_series]
    if args.output_series_name is None:
        # node-unique output series (reference features.py:502-504:
        # output_series_num + node_num). The BASE series must be the
        # same on every node or skewed launches still collide (node 0
        # starting one second after node 1 lands on node 1's name), so
        # the launcher exports one base for the whole job
        # (DETPROC_BASE_SERIES, set by scripts/slurm_processing.sh
        # at submission); per-node clocks are only a fallback.
        node_num = args.node_num
        if node_num is None:
            node_num = int(os.environ.get("SLURM_PROCID", 0))
        base_name = os.environ.get("DETPROC_BASE_SERIES")
        if base_name is not None and "_" in base_name:
            # the launcher only supplies a shared TIMESTAMP; the
            # facility digit follows this job's --facility (the shell
            # fallback hardcodes I1 and must not leak into a
            # facility-2 dataset's series numbers)
            base_name = (f"I{args.facility}_"
                         + base_name.split("_", 1)[1])
        if base_name is None:
            base_name = create_series_name(args.facility)
            if (args.nb_nodes or int(os.environ.get("SLURM_NTASKS",
                                                    0) or 1)) > 1:
                print("WARNING: DETPROC_BASE_SERIES not set — "
                      "deriving the output series base from this "
                      "node's clock; nodes launched with sub-minute "
                      "skew can still collide. Export one base series "
                      "for the job (see scripts/slurm_processing.sh).")
        base = series_to_number(base_name)
        forwarded += ["--output-series-name", series_number_to_name(
            multihost.output_series_num_for_host(base, node_num))]
    return cli.main(forwarded)


if __name__ == "__main__":
    sys.exit(main())
