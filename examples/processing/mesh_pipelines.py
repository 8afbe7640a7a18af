"""Trigger → feature processing SPMD over a device mesh from the
public pipeline API (no shard_map in user code).

`TriggerProcessing.process(mesh=...)` and
`FeatureProcessing.process(mesh=...)` shard every dispatch's event
batch along the mesh's events axis (events are independent — no
collectives; filter banks replicate). The same switch is the CLI's
``--mesh-devices N``. This replaces the reference's
multiprocessing-Pool-over-series (detprocess/process/triggers.py)
with data parallelism over devices inside one pipeline instance.

Runs on every device JAX finds (the GPUs of the host); ``--cpu-mesh N``
runs it on N virtual CPU devices instead.

Run:  python examples/processing/mesh_pipelines.py [--cpu-mesh 8]
"""

import os
import sys
import tempfile

# --cpu-mesh N: N virtual CPU devices instead of the machine's own
# devices (decided before jax is imported)
if "--cpu-mesh" in sys.argv:
    n_cpu = int(sys.argv[sys.argv.index("--cpu-mesh") + 1])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = " ".join(
        [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
        + [f"--xla_force_host_platform_device_count={n_cpu}"])

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402
import yaml                                                  # noqa: E402

from detprocess_jax.io.filterfile import FilterData          # noqa: E402
from detprocess_jax.io.rawdata import RawWriter              # noqa: E402
from detprocess_jax.models import pulse                      # noqa: E402
from detprocess_jax.parallel import mesh as pmesh            # noqa: E402
from detprocess_jax.pipelines.features import FeatureProcessing  # noqa: E402
from detprocess_jax.pipelines.triggers import TriggerProcessing  # noqa: E402

FS = 1.25e6
NT, PRETRIG, L, NEV = 1024, 256, 120000, 12


def main():
    tmp = tempfile.mkdtemp(prefix="mesh_pipelines_")
    rng = np.random.default_rng(0)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = float(np.sqrt(psd[0] * FS))

    # NEV continuous events, three pulses each
    traces = rng.standard_normal((NEV, 1, L)) * sigma
    for ev in range(NEV):
        for pos in (20000, 60000, 100000):
            traces[ev, 0, pos - PRETRIG:pos - PRETRIG + NT] += 25e-6 * tmpl
    writer = RawWriter(os.path.join(tmp, "raw"), "I1_D20260818_T100000",
                       FS, ["chan1"], data_type="continuous")
    writer.write_dump(traces, dump_num=1)
    raw_files = sorted(
        os.path.join(tmp, "raw", f)
        for f in os.listdir(os.path.join(tmp, "raw"))
        if f.endswith(".hdf5"))

    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd, FS)

    tpath = os.path.join(tmp, "trig.yaml")
    yaml.safe_dump({"trigger": {"chan1": {
        "run": True, "template_tag": "default", "threshold_sigma": 8.0,
        "pileup_window_msec": 0.1}}}, open(tpath, "w"))
    fpath = os.path.join(tmp, "feat.yaml")
    yaml.safe_dump({"feature": {
        "trace_length_samples": NT,
        "pretrigger_length_samples": PRETRIG,
        "chan1": {
            "of1x1_nodelay": {"run": True, "template_tag": "default"},
            "of1x1_unconstrained": {"run": True,
                                    "template_tag": "default"},
            "baseline": {"run": True}}}}, open(fpath, "w"))

    mesh = pmesh.make_mesh()
    print(f"mesh: {mesh.devices.size} devices, axes {mesh.axis_names}")

    tp = TriggerProcessing(raw_files, tpath, filter_data=fd, verbose=False)
    trig_df = tp.process(capacity=64, event_batch=8, mesh=mesh)
    print(f"triggers: {len(trig_df)} "
          f"(expect {3 * NEV} = 3 pulses x {NEV} events)")

    fp = FeatureProcessing(raw_files, fpath, filter_data=fd,
                           trigger_dataframe=trig_df, verbose=False)
    feat = fp.process(batch_size=16, mesh=mesh)
    amp = feat["amp_of1x1_nodelay_chan1"].to_numpy()
    print(f"features: {len(feat)} rows; amp mean {amp.mean():.3e} "
          f"(injected 2.5e-05), max |t0| "
          f"{np.abs(feat['t0_of1x1_unconstrained_chan1']).max():.2e} s")
    assert len(trig_df) == 3 * NEV
    assert np.allclose(amp.mean(), 25e-6, rtol=0.05)
    print("OK")


if __name__ == "__main__":
    main()
