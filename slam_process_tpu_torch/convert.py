"""Carry the JAX package's pipeline state over to the port.

The system has no weights.  What its pipeline is handed is the stage
configs, the colormap LUT (a numpy array, passed as it is), the
corrector's static bounds (plain integers), for the estimators the beam
dictionary, the classifier thresholds and the packed dataset scenes, and
for the device streaming session its online-paths spec.
Configs are read field by field, and dictionaries array by array, from any
objects that have the port's field names, so this module needs no import
of the JAX package:

  * ``configs_from_reference``: the stage configs;
  * ``render_config_from_reference``: the heatmap's render config;
  * ``dictionary_from_reference``: a beam dictionary;
  * ``classifier_config_from_reference``: the v1-6 / v1-7 classifier's
    thresholds;
  * ``packed_scenes_from_reference``: a ``PackedScenes`` of the padded
    dataset scenes, as tensors on a device;
  * ``paths_spec_from_reference``: a streaming ``StreamPathsSpec`` and its
    dictionary arrays, so one spec drives both packages' streams.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from slam_process_tpu_torch.config import (
    ClassifierConfig, CorrectConfig, DecodeConfig, DictionaryConfig, OmpConfig, RenderConfig,
    SceneConfig)
from slam_process_tpu_torch.models.dictionary import BeamDictionary, dictionary_to_device
from slam_process_tpu_torch.pipeline.device import resolve_device


def _copy(cls, src):
    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def configs_from_reference(decode_cfg, correct_cfg, scene_cfg, dictionary_cfg=None,
                           omp_cfg=None) -> Tuple[DecodeConfig, CorrectConfig, SceneConfig,
                                                  DictionaryConfig, OmpConfig]:
    """Port's frozen (DecodeConfig, CorrectConfig, SceneConfig,
    DictionaryConfig, OmpConfig) from the reference objects' fields (raises
    AttributeError on a missing field); a dictionary or OMP config not given
    takes the port's defaults."""
    return (_copy(DecodeConfig, decode_cfg), _copy(CorrectConfig, correct_cfg),
            _copy(SceneConfig, scene_cfg),
            DictionaryConfig() if dictionary_cfg is None else _copy(DictionaryConfig,
                                                                    dictionary_cfg),
            OmpConfig() if omp_cfg is None else _copy(OmpConfig, omp_cfg))


def render_config_from_reference(render_cfg) -> RenderConfig:
    """The port's frozen RenderConfig from a reference object's nine fields
    (raises AttributeError on a missing field)."""
    cfg = _copy(RenderConfig, render_cfg)
    return dataclasses.replace(cfg, grid_size=tuple(cfg.grid_size))


def classifier_config_from_reference(cls_cfg) -> ClassifierConfig:
    """The port's frozen ClassifierConfig from a reference object's five
    thresholds (raises AttributeError on a missing field)."""
    return _copy(ClassifierConfig, cls_cfg)


def packed_scenes_from_reference(packed, device=None):
    """The port's PackedScenes of tensors on ``device`` (None: CUDA) from a
    reference ``PackedScenes``' nine arrays, read by field name: float32
    scenes, dictionaries and grids, int32 extents."""
    from slam_process_tpu_torch.models.batch_estimation import PackedScenes, packed_to_device

    host = PackedScenes(*(np.asarray(getattr(packed, f)) for f in PackedScenes._fields))
    return packed_to_device(host, resolve_device(device))


def dictionary_from_reference(d, device=None) -> BeamDictionary:
    """The port's BeamDictionary of float32 tensors on ``device`` (None:
    CUDA) from a reference dictionary's four arrays."""
    host = BeamDictionary(*(np.asarray(getattr(d, f)) for f in BeamDictionary._fields))
    return dictionary_to_device(host, resolve_device(device))


def paths_spec_from_reference(spec, dict_args, device=None):
    """(the port's StreamPathsSpec, dictionary tensors) from a reference
    streaming spec and its (phi_rx, phi_tx, aoa_grid, aod_grid) arrays, for
    ``DeviceStreamingSession(collect_paths=...)``.  The spec is read field
    by field; its estimator key's config becomes the port's OmpConfig; the
    arrays become float32 tensors on ``device`` (None: CUDA)."""
    from slam_process_tpu_torch.parallel.streaming_device import StreamPathsSpec

    name, cfg, keep_rule, stop_nonpositive = spec.est_key
    fields = {f: getattr(spec, f) for f in StreamPathsSpec._fields}
    fields["est_key"] = (name, _copy(OmpConfig, cfg), keep_rule, stop_nonpositive)
    dev = resolve_device(device)
    return (StreamPathsSpec(**fields),
            tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev) for a in dict_args))
