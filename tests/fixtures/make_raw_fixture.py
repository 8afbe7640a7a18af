#!/usr/bin/env python
"""Generate a pytesdaq-style raw HDF5 fixture with bare h5py.

This script deliberately never imports detprocess_jax: it writes the
documented raw layout (see docs/MIGRATION.md "Raw-data layout") the way
an independent DAQ would, so tests/test_rawdata_interop.py proves the
reader against the documented contract, not against RawWriter.

Layout written (pytesdaq conventions as used by the reference's
pytesio.H5Reader path, /root/reference/detprocess/core/rawdata.py:186-259
and process/processing_data.py:520-526):

- file name:  {prefix}_I{fac}_D{yyyymmdd}_T{hhmmss}_F{dump:04d}.hdf5
- file attrs: series_name, series_num (I*1e14 + D*1e6 + T), dump_num,
  facility, data_type, group_name, (optional run/start-time stamps)
- group /adc1 attrs: nb_events, nb_samples, nb_channels, sample_rate,
  nb_pretrigger_samples, channel_list, adc_conversion_factor,
  dataset_prefix
- datasets /adc1/event_{k} (k = 1..nb_events), dtype int16 ADC counts,
  shape [nb_channels, nb_samples], attrs event_id, event_num,
  event_time, trigger_type
- group /detconfig1/{channel} attrs: close_loop_norm, tes_bias, ...
- conversion: amps = adc * adc_conversion_factor / close_loop_norm
"""

import os

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FS = 1.25e6
NB_SAMPLES = 4096
NB_EVENTS = 3
CHANNELS = ["Melange1pc1ch", "Melange4pc1ch"]
CAL = 2.5e-7            # adc_conversion_factor (volts-ish per count)
CLN = [1.6e4, 2.4e4]    # close_loop_norm per channel
SERIES = "I2_D20260817_T101500"
SERIES_NUM = 2 * 10**14 + 20260817 * 10**6 + 101500


def main(path=None):
    path = path or os.path.join(HERE, "raw_fixture")
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"cont_{SERIES}_F0001.hdf5")
    rng = np.random.RandomState(20260817)

    # integer ADC traces with a deterministic ramp so tests can predict
    # the converted amps exactly
    adc = np.zeros((NB_EVENTS, len(CHANNELS), NB_SAMPLES), dtype=np.int16)
    for k in range(NB_EVENTS):
        for c in range(len(CHANNELS)):
            base = 100 * (k + 1) + 10 * c
            adc[k, c] = base + (np.arange(NB_SAMPLES) % 7)
            adc[k, c, ::50] += rng.randint(-3, 4, NB_SAMPLES // 50 + 1)[
                : len(adc[k, c, ::50])]

    with h5py.File(fname, "w") as f:
        f.attrs["series_name"] = SERIES
        f.attrs["series_num"] = SERIES_NUM
        f.attrs["dump_num"] = 1
        f.attrs["facility"] = 2
        f.attrs["data_type"] = "continuous"
        f.attrs["data_purpose"] = "continuous"
        f.attrs["group_name"] = "raw_fixture"
        f.attrs["daq_version"] = "independent-fixture-generator"
        f.attrs["fridge_run"] = 12
        f.attrs["series_start_time"] = 1787000000
        g = f.create_group("adc1")
        g.attrs["nb_events"] = NB_EVENTS
        g.attrs["nb_samples"] = NB_SAMPLES
        g.attrs["nb_channels"] = len(CHANNELS)
        g.attrs["sample_rate"] = FS
        g.attrs["nb_pretrigger_samples"] = NB_SAMPLES // 2
        g.attrs["channel_list"] = CHANNELS
        g.attrs["adc_conversion_factor"] = CAL
        g.attrs["dataset_prefix"] = "event_"
        for k in range(NB_EVENTS):
            ds = g.create_dataset(f"event_{k + 1}", data=adc[k])
            ds.attrs["event_id"] = k + 1
            ds.attrs["event_num"] = k + 1
            ds.attrs["event_time"] = 1787000000.0 + k * NB_SAMPLES / FS
            ds.attrs["trigger_type"] = 1
        dc = f.create_group("detconfig1")
        dc.attrs["channel_list"] = CHANNELS
        for c, chan in enumerate(CHANNELS):
            cg = dc.create_group(chan)
            cg.attrs["close_loop_norm"] = CLN[c]
            cg.attrs["tes_bias"] = 120e-6 + 10e-6 * c
            cg.attrs["output_gain"] = 1.0

    np.save(os.path.join(path, "expected_adc.npy"), adc)
    print(f"wrote {fname}")
    return fname


if __name__ == "__main__":
    main()
