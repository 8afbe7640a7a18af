"""Processing-configuration (YAML) compiler.

Re-implements the semantics of the reference YamlConfig
(detprocess/process/config.py:18-684):

- top-level split into global / salting / feature / didv / noise / template /
  trigger sections; bare top-level channels belong to ``feature``
- per-section ``overall`` parameters vs per-channel blocks
- channel keys may use the ',' separator or 'all' (expanded over available
  channels); '+', '-', '|' combinations are kept as compound channels
- per-algorithm blocks with a mandatory ``run`` switch; disabled algorithms
  and channels are dropped
- trace-length inheritance: global → channel → algorithm, with msec↔samples
  conversion (requires sample_rate for msec)
- obsolete-key migration (config.py:71-79) and duplicate-key rejection
  (config.py:666-684)
- ``include`` files merged into the top level
- feature section gains ``traces_config`` {(nb_samples, nb_pretrigger):
  [channels]} and ``weights`` maps (config.py:594-641)

The output is plain nested dicts — the downstream pipeline compilers
(pipelines/*) turn these into static kernel plans.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import yaml
from yaml.loader import SafeLoader

from detprocess_jax.utils import channels as chutils
from detprocess_jax.utils.misc import unique_list

CONFIGURATION_FIELDS = ["salting", "feature", "didv", "noise", "template",
                        "trigger"]

OVERALL_PARAMETERS = {
    "global": ["filter_file", "didv_file"],
    "trigger": ["coincident_window_msec", "coincident_window_samples"],
    "salting": ["dm_pdf_file", "pdf_file", "pdf_xrange_kev",
                "coincident_salts", "coincident", "energies", "nsalt",
                "do_salt_deadtime", "energy_norm_ev_per_amp",
                "channel_fractions", "template_tag",
                "min_separation_msec", "edge_exclusion_msec"],
    "feature": ["trace_length_samples", "pretrigger_length_samples",
                "trace_length_msec", "pretrigger_length_msec"],
}

OBSOLETE_KEYS = {
    "trigger_name": "trigger_channel",
    "nb_samples": "trace_length_samples",
    "nb_pretrigger_samples": "pretrigger_length_samples",
    "template_time_tags": "template_group_ids",
    "psd_tag": "csd_tag",
    "noise_tag": "csd_tag",
    "deadtime_salt": "do_salt_deadtime",
}


def convert_length_msec_to_samples(length_msec: float, fs: float) -> int:
    """msec → samples (round to nearest; pytesio-compatible)."""
    return int(round(length_msec * 1e-3 * fs))


class _UniqueKeyLoader(SafeLoader):
    """YAML loader that rejects duplicate keys (config.py:666-684)."""

    def construct_mapping(self, node, deep=False):
        if not isinstance(node, yaml.MappingNode):
            raise yaml.constructor.ConstructorError(
                None, None, f"expected a mapping node, but found {node.id}",
                node.start_mark)
        mapping = {}
        for key_node, value_node in node.value:
            key = self.construct_object(key_node, deep=deep)
            if key in mapping:
                raise ValueError(
                    f'Duplicate key "{key}" found in the yaml file for the '
                    f"same channel and algorithm — not allowed"
                )
            mapping[key] = self.construct_object(value_node, deep=deep)
        return mapping


def _rename_key_recursively(d, old_key, new_key):
    if not isinstance(d, dict):
        return d
    for key in list(d.keys()):
        if isinstance(d[key], dict):
            _rename_key_recursively(d[key], old_key, new_key)
        if key == old_key:
            d[new_key] = d.pop(old_key)
    return d


class YamlConfig:
    """Parse and normalize a processing YAML file."""

    def __init__(self, yaml_file: str,
                 available_channels: Sequence[str] | str,
                 sample_rate: Optional[float] = None,
                 verbose: bool = True):
        self._yaml_file = yaml_file
        self._sample_rate = sample_rate
        if isinstance(available_channels, str):
            available_channels = [available_channels]
        self._available_channels = list(available_channels)
        self._verbose = verbose
        self._processing_config = None
        self._read_config()

    # ------------------------------------------------------------------
    def get_config(self, processing_type: Optional[str] = None):
        if self._processing_config is None:
            return None
        if processing_type is not None:
            if processing_type not in CONFIGURATION_FIELDS:
                raise ValueError(
                    f'Configuration type "{processing_type}" not found')
            return copy.deepcopy(self._processing_config[processing_type])
        return copy.deepcopy(self._processing_config)

    @property
    def available_channels(self):
        return list(self._available_channels)

    # ------------------------------------------------------------------
    def _read_config(self):
        with open(self._yaml_file) as f:
            yaml_dict = yaml.load(f, Loader=_UniqueKeyLoader)
        if not yaml_dict:
            raise ValueError("No configuration loaded — empty yaml file?")

        # include files merged at top level
        if "include" in yaml_dict:
            include_files = yaml_dict.pop("include")
            if isinstance(include_files, str):
                include_files = [include_files]
            for afile in include_files:
                with open(afile) as f:
                    yaml_dict.update(yaml.load(f, Loader=_UniqueKeyLoader))

        for old_key, new_key in OBSOLETE_KEYS.items():
            yaml_dict = _rename_key_recursively(yaml_dict, old_key, new_key)

        configs = {"global": {}}
        for field in CONFIGURATION_FIELDS:
            configs[field] = {"overall": {}, "channels": {}}

        for param in OVERALL_PARAMETERS["global"]:
            configs["global"][param] = yaml_dict.pop(param, None)

        # split known sections
        for field in CONFIGURATION_FIELDS:
            if field not in yaml_dict:
                continue
            field_map = {"overall": {}, "channels": {}}
            overall_params = OVERALL_PARAMETERS.get(field, [])
            config_dict = yaml_dict.pop(field)
            for key, items in config_dict.items():
                if key in overall_params or not isinstance(items, dict):
                    # channel configs are always mappings; scalar values
                    # at section level are overall parameters even when
                    # not pre-declared (e.g. noise trace_length_samples)
                    field_map["overall"][key] = items
                elif field == "feature" and key == "global":
                    field_map["overall"].update(items)
                else:
                    field_map["channels"][key] = items
            configs[field] = field_map

        # remaining top-level keys are feature config (short-hand form)
        for param, val in yaml_dict.items():
            if param == "global":
                # MERGE into the feature overall dict — replacing it would
                # silently wipe trace/pretrigger lengths already parsed
                # from the feature section
                configs["feature"]["overall"].update(copy.deepcopy(val))
            else:
                configs["feature"]["channels"][param] = copy.deepcopy(val)

        # expand ','-separated and 'all' channel keys
        for field in CONFIGURATION_FIELDS:
            new_channels = {}
            for chan, chan_dict in configs[field]["channels"].items():
                if isinstance(chan_dict, dict) and (
                        chan_dict.get("disable", False)
                        or chan_dict.get("run") is False):
                    continue
                if chan == "all":
                    for single in self._available_channels:
                        new_channels[single] = copy.deepcopy(chan_dict)
                else:
                    split, _ = chutils.split_channel_name(
                        chan, self._available_channels, separator=",")
                    for sub in split:
                        new_channels[sub] = copy.deepcopy(chan_dict)
            configs[field]["channels"] = new_channels

        configs["feature"] = self._configure_features(
            configs["feature"], configs["global"])
        configs["trigger"] = self._configure_triggers(
            configs["trigger"], configs["global"])
        configs["salting"] = self._configure_salting(
            configs["salting"], configs["global"])

        self._processing_config = configs

    # ------------------------------------------------------------------
    def _msec_to_samples(self, msec):
        if self._sample_rate is None:
            raise ValueError(
                "sample rate is required when trace length is in msec")
        return convert_length_msec_to_samples(msec, self._sample_rate)

    def _resolve_lengths(self, cfg, nb_samples, nb_pretrigger):
        if "trace_length_samples" in cfg:
            nb_samples = cfg["trace_length_samples"]
        elif "trace_length_msec" in cfg:
            nb_samples = self._msec_to_samples(cfg["trace_length_msec"])
        if "pretrigger_length_samples" in cfg:
            nb_pretrigger = cfg["pretrigger_length_samples"]
        elif "pretrigger_length_msec" in cfg:
            nb_pretrigger = self._msec_to_samples(cfg["pretrigger_length_msec"])
        return nb_samples, nb_pretrigger

    def _configure_features(self, feature_config, global_config):
        feature_dict = copy.deepcopy(feature_config)
        for key, val in (global_config or {}).items():
            feature_dict["overall"].setdefault(key, val)

        split_channel_list = []
        for chan in list(feature_dict["channels"].keys()):
            chan_config = feature_dict["channels"][chan]
            if not isinstance(chan_config, dict):
                raise ValueError(
                    f"Channel {chan} has no configuration — remove it from "
                    f"the yaml file or disable it")
            split_chans, _ = chutils.split_channel_name(
                chan, self._available_channels)
            split_channel_list.extend(split_chans)

            nb_samples, nb_pretrigger = self._resolve_lengths(
                feature_dict["overall"], None, None)
            nb_samples, nb_pretrigger = self._resolve_lengths(
                chan_config, nb_samples, nb_pretrigger)
            if nb_samples is not None and nb_pretrigger is None:
                raise ValueError(
                    f'Missing "pretrigger_length_samples" for channel {chan}')
            if nb_samples is None and nb_pretrigger is not None:
                raise ValueError(
                    f'Missing "trace_length_samples" for channel {chan}')

            algorithm_list = []
            for algo in list(chan_config.keys()):
                algo_config = chan_config[algo]
                if not isinstance(algo_config, dict):
                    continue
                if "run" not in algo_config:
                    raise ValueError(
                        f'Missing "run" parameter for channel {chan}, '
                        f"algorithm {algo}")
                if not algo_config["run"]:
                    chan_config.pop(algo)
                    continue
                algorithm_list.append(algo)
                nb_s, nb_p = self._resolve_lengths(
                    algo_config, nb_samples, nb_pretrigger)
                # the same half-specified-geometry validation applied at
                # channel level must hold after algorithm-level overrides
                if nb_s is not None and nb_p is None:
                    raise ValueError(
                        f'Missing "pretrigger_length_samples" for channel '
                        f"{chan}, algorithm {algo}")
                if nb_s is None and nb_p is not None:
                    raise ValueError(
                        f'Missing "trace_length_samples" for channel '
                        f"{chan}, algorithm {algo}")
                algo_config["nb_samples"] = nb_s
                algo_config["nb_pretrigger_samples"] = nb_p

            if not algorithm_list:
                feature_dict["channels"].pop(chan)
            else:
                chan_config.pop("trace_length_samples", None)
                chan_config.pop("pretrigger_length_samples", None)

        feature_dict["channel_list"] = unique_list(split_channel_list)

        # trace groups and weights
        traces_config = {}
        weights = {}
        for chan, chan_config in feature_dict["channels"].items():
            chan_list, _ = chutils.split_channel_name(
                chan, feature_dict["channel_list"])
            for sub in chan_list:
                param = f"weight_{sub}"
                if param in chan_config:
                    weights.setdefault(chan, {})[param] = chan_config[param]
            for algo, algo_config in chan_config.items():
                if not isinstance(algo_config, dict) or not algo_config.get(
                        "run"):
                    continue
                key = (algo_config["nb_samples"],
                       algo_config["nb_pretrigger_samples"])
                traces_config.setdefault(key, []).extend(chan_list)
        for key in traces_config:
            traces_config[key] = unique_list(traces_config[key])
        feature_dict["traces_config"] = traces_config or None
        feature_dict["weights"] = weights
        return feature_dict

    def _configure_triggers(self, trigger_config, global_config):
        trigger_dict = copy.deepcopy(trigger_config)
        for key, val in (global_config or {}).items():
            trigger_dict["overall"].setdefault(key, val)

        split_channel_list = []
        trigger_channel_dict = {}
        for chan, chan_config in trigger_dict["channels"].items():
            if not isinstance(chan_config, dict):
                raise ValueError(
                    f"Channel {chan} has no configuration — remove it from "
                    f"the yaml file or disable it")
            split_chans, _ = chutils.split_channel_name(
                chan, self._available_channels)
            split_channel_list.extend(split_chans)

            chan_config = copy.deepcopy(chan_config)
            trigger_channel = chan_config.pop("trigger_channel", chan)
            if "run" in chan_config:
                if not chan_config["run"]:
                    continue
                chan_config["channel_name"] = chan
                trigger_channel_dict[trigger_channel] = chan_config
            else:
                for algo, algo_dict in chan_config.items():
                    if not isinstance(algo_dict, dict) or "run" not in algo_dict:
                        raise ValueError(
                            f'Missing "run" parameter for trigger channel '
                            f"{chan}")
                    if not algo_dict["run"]:
                        continue
                    algo_dict["channel_name"] = chan
                    trigger_channel_dict[f"{algo}_{trigger_channel}"] = algo_dict

        trigger_dict["channels"] = trigger_channel_dict
        trigger_dict["channel_list"] = unique_list(split_channel_list)
        return trigger_dict

    def _configure_salting(self, salting_config, global_config):
        salting_dict = copy.deepcopy(salting_config)
        for key, val in (global_config or {}).items():
            salting_dict["overall"].setdefault(key, val)
        split_channel_list = []
        for chan, chan_config in salting_dict["channels"].items():
            if not isinstance(chan_config, dict):
                raise ValueError(
                    f"Channel {chan} has no configuration — remove it from "
                    f"the yaml file or disable it")
            split_chans, _ = chutils.split_channel_name(
                chan, self._available_channels)
            split_channel_list.extend(split_chans)
        salting_dict["channel_list"] = unique_list(split_channel_list)
        return salting_dict
