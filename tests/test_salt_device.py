"""On-device salting injection (ops.saltinject + pipeline wiring).

The host injector (inject_raw_salt) is the reference-parity path; the
device injector plans tiny [E, K] arrays on the host and adds templates
on device, so salted runs keep the raw int16 upload path. These tests
pin the device op against the host injector and the two pipeline paths
against each other.
"""

import numpy as np
import pytest
import yaml

import jax.numpy as jnp

from detprocess_jax.io.filterfile import FilterData
from detprocess_jax.io.rawdata import RawWriter
from detprocess_jax.models import pulse
from detprocess_jax.ops import saltinject
from detprocess_jax.pipelines.salting import Salting
from detprocess_jax.pipelines.triggers import TriggerProcessing

FS = 1.25e6
L = 250000
NT = 4096
PRETRIG = 1024
CHANNELS = ["chan1", "chan2"]
CAL = 2.0 ** -22


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("saltdev")
    rng = np.random.default_rng(21)
    sigma = 2e-6
    traces = rng.standard_normal((4, 2, L)) * sigma

    detcfg = {c: {"close_loop_norm": 1.0} for c in CHANNELS}
    writer = RawWriter(str(root / "raw"), "I1_D20260816_T160000", FS,
                       CHANNELS, data_type="continuous",
                       detector_config=detcfg,
                       adc_conversion_factor=CAL)   # int16 codes on disk
    writer.write_dump(traces, dump_num=1)
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))

    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    fd = FilterData(verbose=False)
    for chan in CHANNELS:
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, np.full(NT, sigma ** 2 / FS), FS)

    salting = Salting(fd, verbose=False)
    df = salting.generate_salt(
        raw_files, CHANNELS, energies=[100.0], nsalt=6,
        energy_norm_ev_per_amp=2e6,            # 50 eV → 2.5e-5 A: loud
        seed=31, min_separation_msec=30.0, edge_exclusion_msec=15.0)
    return dict(root=root, raw_files=raw_files, fd=fd, salting=salting,
                df=df, tmpl=tmpl, sigma=sigma)


class TestInjectOp:
    def test_matches_host_injector(self, setup):
        salting, df = setup["salting"], setup["df"]
        inj = salting.make_device_injector(CHANNELS)
        rng = np.random.default_rng(3)
        traces = (rng.standard_normal((2, len(CHANNELS), L)) * 1e-6
                  ).astype(np.float32)
        evs = sorted(df["event_number"].unique())[:2]
        admins = [{"series_number": df["series_number"].iloc[0],
                   "event_number": ev} for ev in evs]
        plan = inj.plan(admins)
        out = np.asarray(saltinject.inject_salts(
            jnp.asarray(traces), jnp.asarray(plan.idx),
            jnp.asarray(plan.chan), jnp.asarray(plan.tid),
            jnp.asarray(plan.amp), jnp.asarray(inj.templates)))
        for e, admin in enumerate(admins):
            want = salting.inject_raw_salt(
                traces[e].astype(np.float64), admin, CHANNELS)
            np.testing.assert_allclose(out[e], want, atol=3e-11)

    def test_edge_clipping(self, setup):
        # salts whose template sticks out both ends of the trace
        import pandas as pd

        salting = Salting(setup["fd"], verbose=False)
        sdf = pd.DataFrame({
            "series_number": [1, 1],
            "event_number": [1, 1],
            "salt_channel": ["chan1", "chan2"],
            "salt_amplitude": [1e-5, 2e-5],
            "salt_template_tag": ["default", "default"],
            "trigger_index": [100, L - 100],    # start<0 / end>L
            "salt_energy_ev": [50.0, 50.0],
        })
        salting.set_dataframe(sdf)
        inj = salting.make_device_injector(CHANNELS)
        traces = np.zeros((1, 2, L), np.float32)
        admin = [{"series_number": 1, "event_number": 1}]
        plan = inj.plan(admin)
        out = np.asarray(saltinject.inject_salts(
            jnp.asarray(traces), jnp.asarray(plan.idx),
            jnp.asarray(plan.chan), jnp.asarray(plan.tid),
            jnp.asarray(plan.amp), jnp.asarray(inj.templates)))
        want = salting.inject_raw_salt(
            traces[0].astype(np.float64), admin[0], CHANNELS)
        np.testing.assert_allclose(out[0], want, atol=3e-11)
        # chan1: start = 100-PRETRIG < 0 → clipped head; the template
        # rise (at its pretrigger point) lands at sample 100
        assert out[0, 0, 90:200].any()
        assert not out[0, 0, NT:].any()        # nothing beyond the tail
        # chan2: start near L → template truncated at the end
        assert out[0, 1, -50:].any()

    def test_window_start_shift(self, setup):
        salting, df = setup["salting"], setup["df"]
        inj = salting.make_device_injector(CHANNELS)
        row = df.iloc[0]
        admin = {"series_number": row["series_number"],
                 "event_number": row["event_number"]}
        ws = int(row["trigger_index"]) - PRETRIG
        win = np.zeros((1, 2, NT), np.float32)
        plan = inj.plan([admin], window_starts=[ws])
        out = np.asarray(saltinject.inject_salts(
            jnp.asarray(win), jnp.asarray(plan.idx),
            jnp.asarray(plan.chan), jnp.asarray(plan.tid),
            jnp.asarray(plan.amp), jnp.asarray(inj.templates)))
        want = salting.inject_raw_salt(
            win[0].astype(np.float64), admin, CHANNELS, window_start=ws)
        np.testing.assert_allclose(out[0], want, atol=3e-11)

    def test_overflow_warns(self, setup, capsys):
        salting, df = setup["salting"], setup["df"]
        inj = salting.make_device_injector(CHANNELS,
                                           max_salts_per_event=1)
        evs = df["event_number"].unique()
        admins = [{"series_number": df["series_number"].iloc[0],
                   "event_number": evs[0]}]
        inj.plan(admins)
        out = capsys.readouterr().out
        assert "max_salts_per_event" in out


class TestPipelineParity:
    @pytest.fixture(scope="class")
    def config_path(self, setup):
        config = {"trigger": {
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 10.0,
                      "pileup_window_msec": 0.5},
            "chan2": {"run": True, "template_tag": "default",
                      "threshold_sigma": 10.0,
                      "pileup_window_msec": 0.5}}}
        p = str(setup["root"] / "trig.yaml")
        yaml.safe_dump(config, open(p, "w"))
        return p

    def test_trigger_device_vs_host(self, setup, config_path):
        out = {}
        for mode in ("host", "device"):
            proc = TriggerProcessing(setup["raw_files"], config_path,
                                     filter_data=setup["fd"],
                                     verbose=False)
            if mode == "host":
                proc.set_salting(
                    setup["salting"].make_injector(CHANNELS))
                assert proc._device_injector is None
            else:
                proc.set_salting(
                    setup["salting"].make_device_injector(CHANNELS))
                assert proc._salt_injector is None
            df = proc.process(capacity=128)
            out[mode] = df.sort_values(
                ["event_number", "trigger_index"]).reset_index(drop=True)
        dh, dd = out["host"], out["device"]
        assert len(dh) == len(dd) > 0
        np.testing.assert_array_equal(dh["trigger_index"],
                                      dd["trigger_index"])
        np.testing.assert_allclose(dh["trigger_amplitude"],
                                   dd["trigger_amplitude"], rtol=1e-4)
        # every salt recovered
        found = dd["trigger_index"].to_numpy()
        for ti in setup["df"]["trigger_index"]:
            assert np.min(np.abs(found - ti)) <= 2

    def test_trigger_device_salting_mesh(self, setup, config_path):
        """int16 reads + on-device ADC conversion + device salt
        injection compose with ``mesh=``: the conv factors and the
        SaltPlan shard (and pad) with the event batch, and the salted
        sharded trigger set equals the single-device one."""
        from detprocess_jax.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(8)
        dfs = {}
        for m in (None, mesh):
            proc = TriggerProcessing(setup["raw_files"], config_path,
                                     filter_data=setup["fd"],
                                     verbose=False)
            proc.set_salting(
                setup["salting"].make_device_injector(CHANNELS))
            # event_batch=3 on 4 events: every batch takes the padding
            # path (3 and 1 both indivisible by 8 devices), so the conv
            # stack and SaltPlan padding are exercised too
            dfs[m is not None] = proc.process(
                capacity=128, event_batch=3, mesh=m)
        import pandas as pd

        assert len(dfs[True]) == len(dfs[False]) > 0
        pd.testing.assert_frame_equal(
            dfs[True].reset_index(drop=True),
            dfs[False].reset_index(drop=True))

    def test_feature_reinjection_device(self, setup, config_path):
        from detprocess_jax.pipelines.features import FeatureProcessing

        proc = TriggerProcessing(setup["raw_files"], config_path,
                                 filter_data=setup["fd"], verbose=False)
        proc.set_salting(
            setup["salting"].make_device_injector(CHANNELS))
        trig_df = proc.process(capacity=128)

        fcfg = {"feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "chan1": {"of1x1_nodelay": {"run": True,
                                        "template_tag": "default"}}}}
        cpath = str(setup["root"] / "feat.yaml")
        yaml.safe_dump(fcfg, open(cpath, "w"))

        feats = {}
        for mode in ("host", "device"):
            fp = FeatureProcessing(setup["raw_files"], cpath,
                                   filter_data=setup["fd"],
                                   trigger_dataframe=trig_df,
                                   verbose=False)
            if mode == "host":
                fp.set_salting(setup["salting"].make_injector(CHANNELS))
            else:
                fp.set_salting(
                    setup["salting"].make_device_injector(CHANNELS))
            feats[mode] = fp.process(batch_size=16, dtype=np.float32)
            # device salting keeps the raw (int16) read path
            assert fp._raw_reads is (mode == "device")
        fh, fdv = feats["host"], feats["device"]
        acol = [c for c in fdv.columns
                if c.startswith("amp_of1x1_nodelay")][0]
        np.testing.assert_allclose(fh[acol], fdv[acol], rtol=1e-4)
        # salts recovered at their amplitude in chan1 rows
        amp_true = setup["df"]["salt_amplitude"].iloc[0]
        chan1 = fdv[fdv["trigger_channel"] == "chan1"]
        assert len(chan1)
        np.testing.assert_allclose(chan1[acol], amp_true, rtol=0.2)
