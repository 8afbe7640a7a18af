"""Command-line driver: chain salting → randoms → trigger → feature
processing over a raw data group.

Replacement for the reference CLI (scripts/process.py:27-794). Workloads
are selected with --enable-* flags and chained in the reference's order
(salting feeds the trigger, the trigger dataframe feeds feature
extraction). Example:

    python -m detprocess_jax.cli \
        --raw_path /data/run42/raw --processing_setup process.yaml \
        --enable-rand --enable-trig --enable-feature \
        --output_group_path /data/run42/processed

Multi-chip scaling is SPMD over the event batch (parallel/mesh) rather
than the reference's multiprocessing pool; --batch-size controls the
per-step batch.
"""

from __future__ import annotations

import argparse
import os
import sys


from detprocess_jax.config import YamlConfig
from detprocess_jax.io.rawdata import RawData, RawReader
from detprocess_jax.utils.misc import create_series_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="detprocess-jax",
        description="Detector data processing on accelerators (JAX)")
    p.add_argument("--raw_path", "--input_group_path", type=str,
                   required=True, help="raw data group directory")
    p.add_argument("--processing_setup", type=str,
                   help="processing YAML configuration")
    p.add_argument("--filter_file", type=str, default=None)
    p.add_argument("--output_group_path", "--save_path", type=str,
                   default=None)
    p.add_argument("-s", "--series", "--input_series", nargs="+",
                   default=None)
    p.add_argument("--processing_id", type=str, default=None)
    p.add_argument("--facility", type=int, default=1)
    p.add_argument("--output-series-name", "--output_series_name",
                   default=None,
                   help="output series name override (default: "
                        "timestamp-derived). Multi-node drivers pass a "
                        "node-offset name here so concurrent nodes "
                        "never collide (scripts/process_distributed.py; "
                        "reference features.py:502-504)")
    p.add_argument("--nevents", type=int, default=-1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--restricted", action="store_true")
    p.add_argument("--calib", action="store_true",
                   help="process calibration data")
    p.add_argument("--output-format", choices=("hdf5", "parquet"),
                   default="hdf5")

    p.add_argument("--enable-salting", "--enable_salting",
                   dest="enable_salting", action="store_true")
    p.add_argument("--enable-rand", "--enable-randoms", "--enable_rand",
                   dest="enable_rand", action="store_true")
    p.add_argument("--enable-trig", "--enable-triggers", "--enable_trig",
                   dest="enable_trig", action="store_true")
    p.add_argument("--enable-feature", "--enable_feature",
                   dest="enable_feature", action="store_true")
    p.add_argument("--enable-ivsweep", dest="enable_ivsweep",
                   action="store_true",
                   help="process IV/dIdV sweep data (discovered bias "
                        "points) into the filter file")
    p.add_argument("--calc-filter", "--calc_filter", dest="calc_filter",
                   action="store_true",
                   help="generate the filter file (noise/didv/template)")

    p.add_argument("--trigger_dataframe_path", type=str, default=None,
                   help="existing trigger dataframe for feature processing")
    p.add_argument("--trigger_series", nargs="+", default=None,
                   help="restrict the trigger dataframe to these series")
    p.add_argument("--salting_dataframe_path", type=str, default=None,
                   help="existing salting dataframe (skip generation)")
    p.add_argument("--ntriggers", type=int, default=-1,
                   help="max triggers to feature-process")
    p.add_argument("--ncores", type=int, default=None,
                   help="concurrent host reader threads feeding the "
                        "device pipeline (the reference forks this many "
                        "Pool workers; here the device is shared so the "
                        "cores feed one batched dispatch stream)")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="shard trigger/feature batches over this many "
                        "accelerator devices (jax.sharding.Mesh over the "
                        "events axis); default: single device")
    p.add_argument("--random_rate", type=float, default=None)
    p.add_argument("--nrandoms", type=int, default=None)
    p.add_argument("--salting_energies", type=float, nargs="+",
                   default=None)
    p.add_argument("--nsalt", type=int, default=100)
    p.add_argument("--device-salting", "--device_salting",
                   dest="device_salting", action="store_true",
                   help="inject salts ON DEVICE (host only plans "
                        "index/amplitude arrays): salted runs keep the "
                        "raw int16 upload path — half the host->device "
                        "bytes. Default: host injection (reference "
                        "parity path)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--prewarm", action="store_true",
                   help="compile-and-cache run: process a few events "
                        "through each enabled workload WITHOUT saving "
                        "output, so the persistent XLA executable cache "
                        "(utils/jaxcache.py) holds every kernel for the "
                        "real shapes. Run once after changing configs/"
                        "trace lengths; production runs then start "
                        "without the cold-start compile")
    p.add_argument("--verbose", action="store_true", default=True,
                   help="verbose output (default; see --quiet)")
    p.add_argument("--quiet", dest="verbose", action="store_false",
                   help="suppress per-batch INFO output")
    return p


def _cli_mesh(args):
    """Mesh from --mesh-devices (cached on args: one mesh per run)."""
    if getattr(args, "mesh_devices", None) in (None, 0, 1):
        return None
    if getattr(args, "_mesh", None) is None:
        from detprocess_jax.parallel import mesh as pmesh
        args._mesh = pmesh.make_mesh(args.mesh_devices)
    return args._mesh


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    data_type = "calib" if args.calib else "continuous"
    rawdata = RawData(args.raw_path, data_type=data_type,
                      series=args.series, restricted=args.restricted)
    series_map = rawdata.get_data_files()
    raw_files = sorted(f for files in series_map.values() for f in files)
    needs_continuous = (args.enable_rand or args.enable_trig
                        or args.enable_feature or args.enable_salting)
    if not raw_files:
        if needs_continuous:
            print(f"ERROR: no {data_type} raw files found in "
                  f"{args.raw_path}")
            return 1
        # ivsweep / filter-generation runs: any data type provides the
        # channel list
        for alt in ("iv", "didv", "rand", "calib"):
            alt_map = RawData(args.raw_path, data_type=alt,
                              series=args.series,
                              restricted=args.restricted).get_data_files()
            raw_files = sorted(f for files in alt_map.values()
                               for f in files)
            if raw_files:
                break
        if not raw_files:
            print(f"ERROR: no raw files found in {args.raw_path}")
            return 1

    out_base = args.output_group_path or os.path.join(args.raw_path, "..",
                                                      "processed")
    os.makedirs(out_base, exist_ok=True)
    out_series = (args.output_series_name
                  or create_series_name(args.facility))

    config = None
    if args.processing_setup:
        reader = RawReader(raw_files)
        config = YamlConfig(args.processing_setup, reader.channels,
                            sample_rate=reader.sample_rate)

    if args.prewarm:
        # a prewarm IS a tiny normal run: compiling the real shapes
        # requires the real configs, so just cap the events and skip
        # the saves — every jitted kernel lands in the persistent
        # cache. Only trigger/feature have a no-save mode; the other
        # workloads are host-side anyway (nothing to compile) and WOULD
        # write real outputs, so they are skipped with a notice.
        args.nevents = max(args.batch_size, 8)
        skipped = [flag for flag, on in (
            ("--enable-salting", args.enable_salting),
            ("--enable-rand", args.enable_rand),
            ("--enable-ivsweep", args.enable_ivsweep),
            ("--calc-filter", args.calc_filter)) if on]
        args.enable_salting = args.enable_rand = False
        args.enable_ivsweep = args.calc_filter = False
        args.salting_dataframe_path = None
        if skipped and args.verbose:
            print(f"INFO: prewarm skips {', '.join(skipped)} (host-side "
                  "workloads with nothing to compile; they would write "
                  "real outputs)")
        if args.verbose:
            from detprocess_jax.utils import jaxcache
            print(f"INFO: prewarm run ({args.nevents} events/rows per "
                  f"workload); executable cache: "
                  f"{jaxcache.enable() or 'DISABLED'}")
    nreaders = max(int(args.ncores or 1), 1)
    if nreaders > 1 and args.verbose:
        print(f"INFO: --ncores {nreaders}: host reads run in "
              f"{nreaders} reader threads feeding the device pipeline")

    filter_file = args.filter_file
    if filter_file is None and config is not None:
        filter_file = (config.get_config("feature").get("overall", {})
                       or {}).get("filter_file")

    # ---- filter generation --------------------------------------------
    if args.calc_filter:
        from detprocess_jax.pipelines.filtergen import FilterDataProcessing
        proc = FilterDataProcessing(raw_path=args.raw_path, config=config,
                                    series=args.series,
                                    facility=args.facility,
                                    verbose=args.verbose)
        out_dir = os.path.join(out_base, "filterdata")
        proc.process(lgc_save=True, output_path=out_dir,
                     nrandoms=args.nrandoms, random_rate=args.random_rate,
                     seed=args.seed)
        print(f"INFO: filter data written to {out_dir}")

    # ---- IV/dIdV sweep ------------------------------------------------
    if args.enable_ivsweep:
        from detprocess_jax.pipelines.ivsweep import (IVSweepProcessing,
                                                      discover_bias_points)
        sweep_proc = IVSweepProcessing(verbose=args.verbose)
        didv_cfg = (config.get_config("didv").get("overall", {})
                    if config else {}) or {}
        nproc = 0
        for chan in RawReader(raw_files).channels:
            bias_points = discover_bias_points(args.raw_path, chan,
                                               series=args.series)
            if not bias_points:
                continue
            df = sweep_proc.process(
                chan, bias_points,
                sgfreq=didv_cfg.get("sgfreq", 100.0),
                sgamp=didv_cfg.get("sgamp", 1e-8),
                rsh=didv_cfg.get("rshunt", 5e-3))
            nproc += 1
            print(f"INFO: IV sweep processed for {chan}: "
                  f"{len(df)} bias points")
        if nproc == 0:
            print("ERROR: no IV/dIdV sweep bias points discovered")
            return 1
        out_dir = os.path.join(out_base, "ivsweep")
        os.makedirs(out_dir, exist_ok=True)
        sweep_proc.save_hdf5(os.path.join(
            out_dir, f"ivsweep_{out_series}.hdf5"))
        print(f"INFO: IV sweep data written to {out_dir}")

    # ---- salting ------------------------------------------------------
    salting = None
    if args.salting_dataframe_path:
        from detprocess_jax.pipelines.salting import Salting
        from detprocess_jax.io import tables as _tables
        import glob as _glob
        paths = sorted(
            _glob.glob(os.path.join(args.salting_dataframe_path, "*.hdf5"))
            + _glob.glob(os.path.join(args.salting_dataframe_path,
                                      "*.parquet")))
        if not paths and os.path.isfile(args.salting_dataframe_path):
            paths = [args.salting_dataframe_path]
        if not paths:
            print("ERROR: no salting dataframe found at "
                  f"{args.salting_dataframe_path}")
            return 1
        if filter_file is None:
            print("ERROR: salting requires a filter file")
            return 1
        salting = Salting(filter_file, verbose=args.verbose)
        salting.set_dataframe(_tables.concat_tables(paths))
        print(f"INFO: loaded {len(salting.dataframe)} salts from "
              f"{args.salting_dataframe_path}")
    elif args.enable_salting:
        from detprocess_jax.pipelines.salting import Salting
        if filter_file is None:
            print("ERROR: salting requires a filter file")
            return 1
        salting_cfg = (config.get_config("salting")
                       if config else {"overall": {}, "channel_list": []})
        channels = salting_cfg.get("channel_list") or RawReader(
            raw_files).channels
        overall = salting_cfg.get("overall", {}) or {}
        pdf_file = overall.get("dm_pdf_file") or overall.get("pdf_file")
        energies = None
        if pdf_file is None:
            energies = (args.salting_energies or overall.get("energies")
                        or [100.0])
        salting = Salting(filter_file, verbose=args.verbose)
        salt_kwargs = {k: overall[k] for k in (
            "energy_norm_ev_per_amp", "channel_fractions", "template_tag",
            "min_separation_msec", "edge_exclusion_msec", "coincident",
            "pdf_xrange_kev") if k in overall}
        salting.generate_salt(
            raw_files, channels, energies=energies, pdf_file=pdf_file,
            nsalt=overall.get("nsalt", args.nsalt), seed=args.seed,
            **salt_kwargs)
        out_dir = os.path.join(out_base, "salting")
        path = salting.save(out_dir, series_name=out_series,
                            facility=args.facility,
                            output_format=args.output_format)
        print(f"INFO: salting dataframe written to {path}")

    # ---- randoms ------------------------------------------------------
    if args.enable_rand:
        from detprocess_jax.pipelines.randoms import Randoms
        randoms = Randoms(raw_files, processing_id=args.processing_id,
                          facility=args.facility, verbose=args.verbose)
        out_dir = os.path.join(out_base, "randoms")
        randoms.process(random_rate=args.random_rate,
                        nrandoms=args.nrandoms, seed=args.seed,
                        lgc_save=True, output_path=out_dir,
                        output_format=args.output_format,
                        series_name=out_series, lgc_output=False)
        print(f"INFO: randoms written to {out_dir}")

    # ---- triggering ---------------------------------------------------
    trigger_df = None
    if args.enable_trig:
        from detprocess_jax.pipelines.triggers import TriggerProcessing
        proc = TriggerProcessing(raw_files, config,
                                 filter_data=filter_file,
                                 processing_id=args.processing_id,
                                 restricted=args.restricted,
                                 calib=args.calib,
                                 facility=args.facility,
                                 verbose=args.verbose)
        if salting is not None:
            chans = RawReader(raw_files).channels
            proc.set_salting(
                salting.make_device_injector(chans)
                if args.device_salting else salting.make_injector(chans))
        out_dir = os.path.join(out_base, "trigger")
        trigger_df = proc.process(nevents=args.nevents,
                                  lgc_save=not args.prewarm,
                                  output_path=out_dir,
                                  output_format=args.output_format,
                                  series_name=out_series,
                                  mesh=_cli_mesh(args),
                                  nreaders=(nreaders if args.nevents < 0
                                            else 1))
        print(f"INFO: {len(trigger_df)} triggers "
              + ("computed (prewarm: not saved)" if args.prewarm
                 else f"written to {out_dir}"))

    # ---- feature extraction ------------------------------------------
    if args.enable_feature:
        from detprocess_jax.pipelines.features import FeatureProcessing
        tdf = trigger_df
        if tdf is None and args.trigger_dataframe_path:
            from detprocess_jax.io import tables
            import glob
            paths = sorted(glob.glob(os.path.join(
                args.trigger_dataframe_path, "*.hdf5")) + glob.glob(
                os.path.join(args.trigger_dataframe_path, "*.parquet")))
            if args.trigger_series:
                paths = [pp for pp in paths
                         if any(sn in os.path.basename(pp)
                                for sn in args.trigger_series)]
            paths = [pp for pp in paths
                     if not pp.endswith("_summary.json")]
            if not paths:
                print("ERROR: no trigger dataframes found in "
                      f"{args.trigger_dataframe_path}"
                      + (f" matching series {args.trigger_series}"
                         if args.trigger_series else "")
                      + " — refusing to silently fall back to "
                      "full-stream feature processing")
                return 1
            tdf = tables.concat_tables(paths)
        if tdf is not None and args.ntriggers > 0:
            tdf = tdf.iloc[: args.ntriggers]
        proc = FeatureProcessing(raw_files, config,
                                 filter_data=filter_file,
                                 trigger_dataframe=tdf,
                                 processing_id=args.processing_id,
                                 restricted=args.restricted,
                                 calib=args.calib,
                                 facility=args.facility,
                                 verbose=args.verbose)
        if salting is not None:
            # salts live only in the injector, not in the raw files — the
            # feature reads must re-inject them (processing_data.py:539-553)
            chans = RawReader(raw_files).channels
            proc.set_salting(
                salting.make_device_injector(chans)
                if args.device_salting else salting.make_injector(chans))
        out_dir = os.path.join(out_base, "feature")
        proc.process(nevents=args.nevents, batch_size=args.batch_size,
                     lgc_save=not args.prewarm, output_path=out_dir,
                     output_format=args.output_format,
                     series_name=out_series, lgc_output=False,
                     mesh=_cli_mesh(args),
                     nreaders=(nreaders
                               if proc._trigger_df is not None
                               or args.nevents < 0 else 1))
        print("INFO: features "
              + ("computed (prewarm: not saved)" if args.prewarm
                 else f"written to {out_dir}"))

    return 0


if __name__ == "__main__":
    sys.exit(main())
