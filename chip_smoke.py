"""Smoke test of the trigger → feature main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card: the main path
    python chip_smoke.py --four-cards    # four cards: the mesh paths only

One card: synthesizes continuous events (1.25 MHz, two channels,
template pulses at known times and amplitudes on PSD-matched noise, int16
ADC codes, all from ``--seed``) and the filter data (32768-sample
template, pretrigger 16384, PSD); runs the calls the CLI makes for
``--enable-rand --enable-trig --enable-feature`` twice (cold, then warm
on the persistent compile cache) with the upstream feature windows;
compares the warm run's own tables with the float64 loop reference
(tests/reference_impl.py) and the injected truth; runs the
``gpu``-marked tests. The events reach the pipelines from memory
(``io.rawdata.ArrayReader``) and the tables are parquet: the card's
machine has no h5py, so the HDF5 file legs (raw files in, filter file,
vaex tables out) are not exercised there. Four cards: the same events
through ``FeatureProcessing.process(mesh=)``, ``TriggerProcessing.
process(mesh=)``, ``Noise.calc_psd(mesh=)`` and ``sharded_longtrace_
trigger``, each against the same work on a 1-device mesh.

The parent process never imports JAX: every phase runs in a child, one
at a time, so only one process ever holds the card. Any failed phase or
comparison exits non-zero with no result line; so does a machine without
a GPU. The last line of a passing run is the JSON contract
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# ---- the configuration (upstream widths) ---------------------------------
FS = 1.25e6
CHANNELS = ("Mv2301", "Mv2302")
NT = 32768                      # feature trace / template length
PRETRIG = 16384
N_EVENTS = 24                   # continuous events ...
FOUR_CARD_EVENTS = 8            # (--four-cards: enough for the mesh check)
EVENT_LEN = 5_000_000           # ... of 4 s each
SPACING = 3 * NT                # pulse grid (jittered), no pileup
AMP_SIGMA = (350.0, 700.0)      # injected amplitude range, in σ_A units:
                                # σ_t ≈ 71 samples / (σ_A units), so the
                                # weaker channel still times to < 0.3 sample
CHAN2_SCALE = 0.7               # second channel sees 0.7× the pulse
FEATURE_BATCH = 1024
N_COMPARE = 128                 # feature rows compared with the reference
THRESHOLD_SIGMA = 10.0
SERIES = "I1_D20261016_T120000"
PER_DUMP = 6                    # events per dump, as a DAQ writes them

# Tolerances of the reference comparison. The device path is float32
# (cuFFT transforms, every contraction at Precision.HIGHEST); the
# reference is float64. OF amplitudes and χ² are sums over 16k bins of
# float32 products: relative error ~1e-6, so rtol 1e-4 holds with
# margin while a TF32 contraction (~1e-3) would fail it. A t0 may move
# by one sample where two neighbouring delays nearly tie in Δχ².
RTOL_OF = 1e-4
T0_TOL_SAMPLES = 1
# χ² = χ²₀ − Δχ² cancels the digits of χ²₀/χ² (large pulses): its float32
# error scales with the no-pulse χ²₀, so χ² also gets this share of χ²₀
CHI2_CANCEL = 1e-5
# baseline/integral: float32 sums over 32k samples, error ~1e-6 of the
# largest sample; compared on that scale
RTOL_SUM = 1e-5
# 4 devices vs 1 (--four-cards): each device runs a quarter of the batch,
# and XLA may sum in another order at another batch size. Float columns
# are held to the reference comparison's rtol on each column's scale;
# the PSD (a psum of float32 partial sums) to 1e-5.
MESH_RTOL = RTOL_OF
MESH_RTOL_PSD = 1e-5


# ---- pieces the tests call directly ---------------------------------------

def contract_line(device: dict) -> str:
    """The result line for ``device`` (platform, kind, count); raises
    ValueError unless the platform is a GPU."""
    if device.get("platform") != "gpu":
        raise ValueError(f"not a GPU run: {device}")
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def run_phases(phases, env=None, timeout=1200):
    """Run ``phases`` — (name, argv) pairs — one child at a time, in
    order; stop at the first failure. Returns the failed phase's name,
    or None when every phase exited 0."""
    for name, argv in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(argv, env=env, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"== phase {name}: rc={rc} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if rc != 0:
            return name
    return None


def compare_rows(got: dict, ref: dict, scale: float, chi2_0: float) -> list:
    """Reference comparison of one feature row: ``got`` and ``ref`` map
    column → value. amp_* agree to RTOL_OF; chi2_* to RTOL_OF plus
    CHI2_CANCEL of ``chi2_0``, the row's no-pulse χ²; t0_* to
    T0_TOL_SAMPLES; baseline_* (a mean) and integral_* (a sum / fs) to
    RTOL_SUM of ``scale``, the trace's largest |sample|, times the
    window length for the integral. Returns the failures as strings."""
    bad = []
    for col, want in ref.items():
        have = float(got[col])
        if col.startswith("t0_"):
            ok = abs(have - want) * FS <= T0_TOL_SAMPLES + 1e-6
        elif col.startswith("baseline_"):
            ok = abs(have - want) <= RTOL_SUM * scale
        elif col.startswith("integral_"):
            ok = abs(have - want) <= RTOL_SUM * scale * NT / FS
        elif col.startswith("chi2_"):
            ok = (abs(have - want)
                  <= RTOL_OF * abs(want) + CHI2_CANCEL * chi2_0)
        else:
            ok = abs(have - want) <= RTOL_OF * abs(want)
        if not ok:
            bad.append(f"{col}: got {have!r}, reference {want!r}")
    return bad


def frame_diffs(d1, d4):
    """Compare a 1-device table ``d1`` with the 4-device one ``d4``:
    non-float columns (indices, channels, event numbers: the merge
    decisions) must be identical; t0_* within T0_TOL_SAMPLES (a float32
    tie between neighbouring delays may pick the other one); every other
    float column within MESH_RTOL of that column's largest |value|.
    Returns (failures, (column, largest scaled float difference))."""
    import numpy as np
    import pandas as pd

    d1 = d1.reset_index(drop=True)
    d4 = d4.reset_index(drop=True)
    if list(d1.columns) != list(d4.columns) or len(d1) != len(d4):
        return [f"shape/columns differ {d1.shape} {d4.shape}"], ("", 0.0)
    bad, worst = [], ("", 0.0)
    for col in d1.columns:
        x, y = d1[col], d4[col]
        if not pd.api.types.is_float_dtype(x.dtype):
            if not x.equals(y):
                bad.append(f"column {col} differs")
            continue
        x, y = x.to_numpy(), y.to_numpy()
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            bad.append(f"column {col}: NaN pattern differs")
            continue
        diff = np.nan_to_num(np.abs(x - y))
        if col.startswith("t0_"):
            if np.max(diff, initial=0.0) * FS > T0_TOL_SAMPLES + 1e-6:
                bad.append(f"column {col}: t0 differs by more than "
                           f"{T0_TOL_SAMPLES} sample")
            continue
        scale = float(np.nanmax(np.abs(x), initial=0.0)) or 1.0
        rel = float(np.max(diff, initial=0.0)) / scale
        if rel > worst[1]:
            worst = (col, rel)
        if rel > MESH_RTOL:
            bad.append(f"column {col}: differs by {rel:.2e} of its scale")
    return bad, worst


def feature_config() -> dict:
    """The processing YAML: per-channel triggers, and the upstream
    feature windows on each channel."""
    trig = {"coincident_window_msec": 0.1}
    for c in CHANNELS:
        trig[c] = {"run": True, "template_tag": "default",
                   "threshold_sigma": THRESHOLD_SIGMA,
                   "pileup_window_msec": 0.5}
    return {
        "trigger": trig,
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            ",".join(CHANNELS): {
                "of1x1_nodelay": {"run": True, "template_tag": "default",
                                  "lowchi2_fcutoff": 10000},
                "of1x1_unconstrained": {"run": True,
                                        "template_tag": "default"},
                "of1x1_constrained": {"run": True,
                                      "template_tag": "default",
                                      "window_min_from_trig_usec": -40.0,
                                      "window_max_from_trig_usec": 40.0},
                "baseline": {"run": True},
                "integral": {"run": True},
            },
        },
    }


def noise_psd(freqs):
    """Two-sided noise PSD [A²/Hz]: white plus a 1/f knee at 100 Hz."""
    import numpy as np
    f = np.abs(np.asarray(freqs, float))
    f = np.where(f == 0, np.min(f[f > 0]), f)
    return 1e-22 * (1.0 + 100.0 / f)


def synthesize(workdir, seed, n_events=N_EVENTS, event_len=EVENT_LEN):
    """The events as int16 ADC codes (``codes.npy``), the injected truth
    and the filter inputs (``truth.npz``), and the processing YAML, under
    ``workdir``."""
    import numpy as np
    import yaml

    from detprocess_jax.models import pulse
    from detprocess_jax.ops import filterbank

    rng = np.random.default_rng(seed)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = noise_psd(np.fft.fftfreq(NT, 1 / FS))
    sigma_a = float(filterbank.make_of1x1_bank(
        tmpl, psd, FS, PRETRIG).resolution[0])
    # PSD-matched noise on the long grid: E|X_k|² = L·fs·S(f_k)
    psd_long = noise_psd(np.fft.rfftfreq(event_len, 1 / FS))
    scale = np.sqrt(psd_long * FS * event_len / 2.0)
    codes = np.empty((n_events, len(CHANNELS), event_len), np.int16)
    truth = []
    grid = np.arange(2 * NT, event_len - 2 * NT, SPACING)
    cal = None
    for ev in range(n_events):
        x = np.empty((len(CHANNELS), event_len))
        for ch in range(len(CHANNELS)):
            z = (rng.standard_normal(scale.size)
                 + 1j * rng.standard_normal(scale.size)) * scale
            z[0] = 0.0
            x[ch] = np.fft.irfft(z, n=event_len)
        if cal is None:   # volts/bit: ~20 codes of white-noise rms
            cal = float(np.std(x[0, :NT])) / 20.0
        pos = grid + rng.integers(-NT // 4, NT // 4, grid.size)
        amp = rng.uniform(*AMP_SIGMA, grid.size) * sigma_a
        for t, a in zip(pos, amp):
            seg = slice(t - PRETRIG, t - PRETRIG + NT)
            x[0, seg] += a * tmpl
            x[1, seg] += CHAN2_SCALE * a * tmpl
            truth.append((ev, int(t), float(a)))
        codes[ev] = np.rint(x / cal)
    np.save(os.path.join(workdir, "codes.npy"), codes)
    np.savez(os.path.join(workdir, "truth.npz"),
             truth=np.asarray(truth), template=tmpl, psd=psd,
             sigma_a=sigma_a, cal=cal)
    with open(os.path.join(workdir, "processing.yaml"), "w") as f:
        yaml.safe_dump(feature_config(), f)
    print(f"synthesized {n_events} events x {len(CHANNELS)} channels x "
          f"{event_len} samples, {len(truth)} pulses, "
          f"sigma_A {sigma_a:.3e} A", flush=True)


def load_inputs(workdir):
    """(reader, filter data, truth): the synthesized events as the
    in-memory ArrayReader the pipelines read (PER_DUMP events per dump,
    int16 codes as a DAQ stores them) and the filter data in memory."""
    import numpy as np

    from detprocess_jax.io.filterfile import FilterData
    from detprocess_jax.io.rawdata import ArrayReader

    codes = np.load(os.path.join(workdir, "codes.npy"), mmap_mode="r")
    truth = np.load(os.path.join(workdir, "truth.npz"))
    cal = float(truth["cal"])
    reader = ArrayReader(
        [codes[d:d + PER_DUMP] * cal for d in range(0, len(codes), PER_DUMP)],
        SERIES, FS, list(CHANNELS), adc_conversion_factor=cal)
    fd = FilterData(verbose=False)
    for c in CHANNELS:
        fd.set_template(c, truth["template"], FS,
                        pretrigger_length_samples=PRETRIG)
        fd.set_psd(c, truth["psd"], FS)
    return reader, fd, truth


def run_chain(reader, fd, workdir, out, seed):
    """The calls ``python -m detprocess_jax.cli --enable-rand
    --enable-trig --enable-feature`` makes, on ``reader``, writing
    parquet tables under ``out``. Returns the trigger and feature
    pipelines."""
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.randoms import Randoms
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    cfg = os.path.join(workdir, "processing.yaml")
    Randoms(reader, verbose=False).process(
        random_rate=2.0, seed=seed, lgc_save=True,
        output_path=os.path.join(out, "randoms"), output_format="parquet",
        lgc_output=False)
    tp = TriggerProcessing(reader, cfg, filter_data=fd, verbose=False)
    tdf = tp.process(lgc_save=True, output_path=os.path.join(out, "trigger"),
                     output_format="parquet")
    fp = FeatureProcessing(reader, cfg, filter_data=fd,
                           trigger_dataframe=tdf, verbose=False)
    fp.process(batch_size=FEATURE_BATCH, lgc_save=True,
               output_path=os.path.join(out, "feature"),
               output_format="parquet", lgc_output=False)
    return tp, fp


def read_table(directory):
    from detprocess_jax.io import tables
    paths = sorted(os.path.join(directory, p) for p in os.listdir(directory)
                   if p.endswith((".hdf5", ".parquet")))
    if not paths:
        raise RuntimeError(f"no output table in {directory}")
    return tables.concat_tables(paths)


def check_triggers(trig_df, truth):
    """Every injected pulse has a trigger within T0_TOL_SAMPLES of its
    injected time in its own event. Returns the failures."""
    import numpy as np

    found = {}
    for dump, evn, idx in zip(trig_df["dump_number"].to_numpy(),
                              trig_df["event_number"].to_numpy(),
                              trig_df["trigger_index"].to_numpy()):
        ev = (int(dump) - 1) * PER_DUMP + int(evn) - 1
        found.setdefault(ev, []).append(int(idx))
    bad = []
    for ev, t, _ in truth:
        got = np.asarray(found.get(int(ev), [-10**9]))
        if np.min(np.abs(got - int(t))) > T0_TOL_SAMPLES:
            bad.append(f"pulse at event {int(ev)} sample {int(t)}: nearest "
                       f"trigger {int(got[np.argmin(np.abs(got - t))])}")
    return bad


# ---- phases (each runs in its own child process) --------------------------

def phase_env(a):
    import importlib
    import importlib.metadata as md

    import jax
    import jaxlib

    from detprocess_jax.utils import device

    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    plugins = sorted(d.metadata["Name"] for d in md.distributions()
                     if "cuda" in (d.metadata["Name"] or "").lower()
                     and "jax" in (d.metadata["Name"] or "").lower())
    for name in plugins:
        print(f"{name} {md.version(name)}")
    for mod in ("h5py", "pandas", "yaml", "pyarrow"):
        try:
            importlib.import_module(mod)
            print(f"import {mod}: ok")
        except ImportError as exc:
            print(f"import {mod}: MISSING ({exc})")
    dev = device.require_gpu()
    print(f"device: {dev}")
    with open(os.path.join(a.workdir, "device.json"), "w") as f:
        json.dump(dev, f)


def phase_synth(a):
    # the mesh check needs fewer events than the one-card run
    synthesize(a.workdir, a.seed,
               n_events=FOUR_CARD_EVENTS if a.tag == "four" else N_EVENTS)


def phase_pipeline(a):
    """The chain in this process, timed; then the compiled trigger and
    feature steps' memory analysis and the device's peak memory."""
    import jax
    import numpy as np

    from detprocess_jax.utils import jaxcache

    reader, fd, _ = load_inputs(a.workdir)
    cache = jaxcache.cache_dir(jaxcache._platform())
    n_cached = (sum(len(f) for _, _, f in os.walk(cache))
                if cache and os.path.isdir(cache) else 0)
    t0 = time.perf_counter()
    tp, fp = run_chain(reader, fd, a.workdir,
                       os.path.join(a.workdir, f"out_{a.tag}"), a.seed)
    wall = time.perf_counter() - t0
    print(f"smoke timing (not a benchmark number): {a.tag} run of the "
          f"randoms -> trigger -> feature chain {wall:.2f} s wall; compile "
          f"cache {cache} held {n_cached} entries before it", flush=True)
    if a.tag != "warm":
        return
    tc = tp._channels[0]
    fn = tp._channel_fn_cached(tc, tp.DEFAULT_CAPACITY, None)
    spec = jax.ShapeDtypeStruct(
        (tp.DEFAULT_EVENT_BATCH, len(tc.chan_indices), EVENT_LEN),
        np.float32)
    print(f"trigger step {spec.shape} float32 memory_analysis: "
          f"{fn.lower(spec).compile().memory_analysis()}")
    banks = fp.device_banks(np.float32)[0]
    spec = jax.ShapeDtypeStruct((FEATURE_BATCH, len(CHANNELS), NT),
                                np.float32)
    print(f"feature step {spec.shape} float32 memory_analysis: "
          f"{fp._group_fns[0].lower(spec, banks).compile().memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_compare(a):
    """The warm run's own tables against the injected truth and the
    float64 loop reference."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from reference_impl import RefOF1x1

    from detprocess_jax.utils import windows as winutils

    reader, _, t = load_inputs(a.workdir)
    truth, tmpl, psd = t["truth"], t["template"], t["psd"]
    out = os.path.join(a.workdir, "out_warm")
    read_table(os.path.join(out, "randoms"))
    trig = read_table(os.path.join(out, "trigger"))
    feat = read_table(os.path.join(out, "feature"))
    bad = check_triggers(trig, truth)
    print(f"triggers: {len(trig)} rows for {len(truth)} injected pulses; "
          f"{len(bad)} pulses missed by more than {T0_TOL_SAMPLES} sample")
    if len(feat) < N_COMPARE:
        bad.append(f"only {len(feat)} feature rows (< {N_COMPARE})")

    ref = RefOF1x1(tmpl, psd, FS, PRETRIG)
    lo, hi = winutils.extract_window_indices(
        NT, PRETRIG, FS, window_min_from_trig_usec=-40.0,
        window_max_from_trig_usec=40.0)
    rows = np.linspace(0, len(feat) - 1, min(N_COMPARE, len(feat)))
    rows = np.unique(rows.astype(int))
    worst = {}
    for r in rows:
        row = feat.iloc[int(r)]
        start = int(row["trigger_index"]) - PRETRIG
        tr, _ = reader.read_single_event(
            int(row["event_number"]),
            reader.files[int(row["dump_number"]) - 1],
            trace_window=(start, NT))
        for ci, c in enumerate(CHANNELS):
            x = tr[ci]
            a0, c0, l0 = ref.fit_nodelay(x, lowchi2_fcutoff=10000.0)
            a1, t1, c1, _ = ref.fit_withdelay(x)
            a2, t2, c2, _ = ref.fit_withdelay(x, window=(lo, hi))
            want = {f"amp_of1x1_nodelay_{c}": a0,
                    f"chi2_of1x1_nodelay_{c}": c0,
                    f"amp_of1x1_unconstrained_{c}": a1,
                    f"t0_of1x1_unconstrained_{c}": t1,
                    f"chi2_of1x1_unconstrained_{c}": c1,
                    f"amp_of1x1_constrained_{c}": a2,
                    f"t0_of1x1_constrained_{c}": t2,
                    f"chi2_of1x1_constrained_{c}": c2,
                    f"baseline_{c}": float(np.mean(x[:NT - 1])),
                    f"integral_{c}": float(np.trapezoid(x[:NT - 1]) / FS)}
            got = {k: row[k] for k in want}
            bad += [f"row {int(r)}: {e}" for e in compare_rows(
                got, want, float(np.max(np.abs(x))), ref.chi2_nopulse(x))]
            for k, w in want.items():
                if k.startswith(("amp_", "chi2_")):
                    err = abs(float(got[k]) - w) / abs(w)
                    base = k.rsplit("_", 1)[0]
                    worst[base] = max(worst.get(base, 0.0), err)
    print(f"reference comparison on {len(rows)} rows x {len(CHANNELS)} "
          f"channels (rtol {RTOL_OF} on amp, {RTOL_OF} + {CHI2_CANCEL} of "
          f"the no-pulse chi2 on chi2, |dt0| <= {T0_TOL_SAMPLES} sample):")
    for k in sorted(worst):
        print(f"  max relative error {k}: {worst[k]:.3e}")
    for line in bad[:20]:
        print(f"FAIL {line}")
    if bad:
        raise SystemExit(f"{len(bad)} comparison failures")
    print("reference comparison: pass")


def phase_gpu_tests(a):
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests",
                                                "test_gpu_device.py")],
        cwd=REPO, env=env, timeout=900).returncode
    if rc != 0:
        raise SystemExit(f"gpu tests failed (rc={rc})")


def phase_four(a):
    """The multi-device paths users reach, on 4 devices in this one
    process, each against the same work on a 1-device mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from detprocess_jax.ops import filterbank
    from detprocess_jax.ops import trigger as trig_ops
    from detprocess_jax.parallel import mesh as pmesh
    from detprocess_jax.pipelines.features import FeatureProcessing
    from detprocess_jax.pipelines.noise import Noise
    from detprocess_jax.pipelines.triggers import TriggerProcessing

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh4 = Mesh(np.array(devs[:4]), (pmesh.EVENTS_AXIS,))
    mesh1 = Mesh(np.array(devs[:1]), (pmesh.EVENTS_AXIS,))
    raw, filt, truth = load_inputs(a.workdir)
    cfg = os.path.join(a.workdir, "processing.yaml")
    bad = []

    def same_frames(name, d1, d4):
        errs, worst = frame_diffs(d1, d4)
        bad.extend(f"{name}: {e}" for e in errs)
        print(f"{name}: {len(d1)} rows x {len(d1.columns)} columns; "
              f"largest float difference {worst[1]:.2e} of the column "
              f"scale ({worst[0]})", flush=True)

    tp = TriggerProcessing(raw, cfg, filter_data=filt, verbose=False,
                           auto_prewarm=False)
    t1 = tp.process(mesh=mesh1)
    t4 = tp.process(mesh=mesh4)
    same_frames("TriggerProcessing.process(mesh=)", t1, t4)

    fp = FeatureProcessing(raw, cfg, filter_data=filt, trigger_dataframe=t1,
                           verbose=False, auto_prewarm=False)
    f1 = fp.process(batch_size=FEATURE_BATCH, mesh=mesh1)
    f4 = fp.process(batch_size=FEATURE_BATCH, mesh=mesh4)
    same_frames("FeatureProcessing.process(mesh=)", f1, f4)

    noise = Noise(raw, verbose=False)
    noise.generate_randoms(nrandoms=256, seed=a.seed)
    psds = {}
    for name, m in (("1", mesh1), ("4", mesh4)):
        noise.calc_psd(CHANNELS[0], trace_length_samples=NT,
                       pretrigger_length_samples=PRETRIG, mesh=m,
                       tag=f"mesh{name}")
        psds[name] = np.asarray(noise.get_psd(CHANNELS[0],
                                              tag=f"mesh{name}")[0])
    rel = float(np.max(np.abs(psds["4"] / psds["1"] - 1)))
    if rel > MESH_RTOL_PSD:
        bad.append(f"Noise.calc_psd(mesh=): PSDs differ by {rel:.2e}")
    print(f"Noise.calc_psd(mesh=): 4-device vs 1-device PSD, max relative "
          f"difference {rel:.2e}", flush=True)

    kernel = trig_ops.make_trigger_kernel(filterbank.make_ofnxm_bank(
        truth["template"], truth["psd"].astype(complex), FS, PRETRIG))
    thr = trig_ops.chi2_threshold(THRESHOLD_SIGMA, 1)
    tr, _ = raw.read_single_event(1, raw.files[0], dtype=np.float32)
    # one long trace: the shard length must be a multiple of 256
    x = tr[:1, :EVENT_LEN // 1024 * 1024]
    res = {}
    for name, m in (("1", mesh1), ("4", mesh4)):
        fn = pmesh.sharded_longtrace_trigger(m, kernel, thr, 625, 256)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(
            m, P(None, pmesh.EVENTS_AXIS)))
        res[name] = pmesh.merge_sharded_triggers(*fn(xs)[:3])
    if not np.array_equal(res["1"][0], res["4"][0]):
        bad.append("sharded_longtrace_trigger: indices differ")
    elif not np.allclose(res["1"][1], res["4"][1], rtol=1e-5):
        bad.append("sharded_longtrace_trigger: delta-chi2 differs")
    print(f"sharded_longtrace_trigger: {len(res['4'][0])} triggers on a "
          f"{x.shape[-1]}-sample trace, 4 shards == 1 shard", flush=True)
    for line in bad:
        print(f"FAIL {line}")
    if bad:
        raise SystemExit(f"{len(bad)} mesh comparisons failed")


PHASES = {"env": phase_env, "synth": phase_synth,
          "pipeline": phase_pipeline, "compare": phase_compare,
          "gpu_tests": phase_gpu_tests, "four": phase_four}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh paths")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: .smoke_work in the "
                         "checkout, removed at the end)")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.phase:
        PHASES[a.phase](a)
        return 0

    from detprocess_jax.utils.device import gpu_board   # no JAX import
    try:
        print(gpu_board(), flush=True)
    except RuntimeError as exc:
        print(f"no GPU: {exc}", file=sys.stderr)
        return 1

    workdir = a.workdir or os.path.join(REPO, ".smoke_work")
    own = a.workdir is None
    if own:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    def child(phase, tag=""):
        return (f"{phase} {tag}".strip(),
                [sys.executable, os.path.abspath(__file__), "--phase", phase,
                 "--workdir", workdir, "--seed", str(a.seed), "--tag", tag])

    if a.four_cards:
        phases = [child("env"), child("synth", "four"), child("four")]
    else:
        phases = [child("env"), child("synth"), child("pipeline", "cold"),
                  child("pipeline", "warm"), child("compare"),
                  child("gpu_tests")]
    try:
        failed = run_phases(phases, env=env)
        if failed is not None:
            print(f"chip smoke FAILED in phase {failed}", file=sys.stderr)
            return 1
        with open(os.path.join(workdir, "device.json")) as f:
            dev = json.load(f)
        if a.four_cards and dev["count"] < 4:
            print("chip smoke FAILED: fewer than 4 devices", file=sys.stderr)
            return 1
        if a.four_cards:
            dev["count"] = 4
        line = contract_line(dev)
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
