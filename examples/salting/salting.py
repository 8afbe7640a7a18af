"""Salting: inject simulated dark-matter pulses into raw data and
measure trigger efficiency.

Mirrors the reference's examples/salting notebooks (DM_PDF_gen.ipynb +
salting.ipynb + saltchecks.ipynb; detprocess Salting: core/salting.py):
energies are drawn from a DM recoil spectrum by inverse-transform
sampling, normalized to amps through the dPdI energy normalization, and
injected on the fly into BOTH the trigger and the feature reads.

Run:  python examples/salting/salting.py [output_dir]
"""

import os
import pickle
import sys
import tempfile


def dm_rate(e_kev):
    """Toy falling DM recoil spectrum dR/dE over E in keV (module-level
    so plain pickle can store it by reference; the reference uses
    cloudpickle for closure-based rate models)."""
    import numpy as _np
    return _np.exp(-e_kev / 0.3)

import numpy as np
import yaml

from detprocess_jax import Noise, Salting, TriggerProcessing
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse

FS = 1.25e6
NT, PRETRIG = 4096, 1024
L = 625_000
CHANNELS = ["Mv2301"]


def main(out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="salting_")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((3, 1, L)) * sigma
    RawWriter(os.path.join(out_dir, "raw"), "I1_D20260816_T120000", FS,
              CHANNELS).write_dump(traces, dump_num=1)
    raw_files = sorted(os.path.join(out_dir, "raw", f)
                       for f in os.listdir(os.path.join(out_dir, "raw")))

    noise = Noise(raw_files, verbose=False)
    noise.generate_randoms(random_rate=40.0, seed=1,
                           min_separation_msec=5.0,
                           edge_exclusion_msec=5.0)
    noise.calc_psd(CHANNELS, trace_length_samples=NT,
                   pretrigger_length_samples=PRETRIG)
    noise.set_template(CHANNELS[0], tmpl, FS,
                       pretrigger_length_samples=PRETRIG)
    filter_path = os.path.join(out_dir, "filter.h5")
    noise.save_hdf5(filter_path)

    # ---- a DM recoil spectrum as a pickled pdf file (DM_PDF_gen) -------
    # format: {mass_MeV: {"dmrate": callable(E_keV)}}
    pdf_path = os.path.join(out_dir, "mass_dict.pkl")
    with open(pdf_path, "wb") as f:
        pickle.dump({1.0: {"dmrate": dm_rate}}, f)

    # ---- generate + inject salts ---------------------------------------
    salting = Salting(filter_path, verbose=True)
    salting.generate_salt(raw_files, CHANNELS, pdf_file=pdf_path,
                          pdf_xrange_kev=(0.05, 1.0), nsalt=12,
                          energy_norm_ev_per_amp=4e7,
                          channel_fractions={CHANNELS[0]: 1.0}, seed=2,
                          min_separation_msec=30.0,
                          edge_exclusion_msec=10.0)
    df_salt = salting.dataframe
    print(f"{len(df_salt)} salts, energies "
          f"{np.round(np.sort(df_salt['salt_energy_ev']), 0)} eV")

    # ---- trigger with salts injected on the fly ------------------------
    config = {"trigger": {CHANNELS[0]: {
        "run": True, "template_tag": "default", "threshold_sigma": 5.0,
        "pileup_window_msec": 0.5}}}
    cfg = os.path.join(out_dir, "trigger.yaml")
    yaml.safe_dump(config, open(cfg, "w"))
    trig = TriggerProcessing(raw_files, cfg, filter_data=filter_path,
                             verbose=False)
    trig.set_salting(salting.make_injector(CHANNELS))
    df = trig.process()

    # ---- saltchecks: efficiency vs energy ------------------------------
    from detprocess_jax.pipelines.salting import salt_efficiency

    eff = salt_efficiency(df_salt, df, match_window_samples=20,
                          energy_bins=[0, 150, 300, 600])
    print(eff[["energy_lo_ev", "energy_hi_ev", "n_injected",
               "n_recovered", "efficiency"]].to_string(index=False))
    found = int(eff["n_recovered"].sum())
    print(f"overall trigger efficiency: {found}/{len(df_salt)} "
          f"({found/len(df_salt):.0%}) at 5σ")
    assert found >= len(df_salt) * 0.5, "efficiency unexpectedly low"
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
