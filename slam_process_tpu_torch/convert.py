"""Carry the JAX package's pipeline state over to the port.

The system has no weights.  What its pipeline is handed is the stage
configs, the colormap LUT (a numpy array, passed as it is), the
corrector's static bounds (plain integers) and, for the estimators, the
beam dictionary.  Configs are read field by field, and dictionaries array
by array, from any objects that have the port's field names, so this
module needs no import of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from slam_process_tpu_torch.config import (
    CorrectConfig, DecodeConfig, DictionaryConfig, OmpConfig, SceneConfig)
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


def dictionary_from_reference(d, device=None) -> BeamDictionary:
    """The port's BeamDictionary of float32 tensors on ``device`` (None:
    CUDA) from a reference dictionary's four arrays."""
    host = BeamDictionary(*(np.asarray(getattr(d, f)) for f in BeamDictionary._fields))
    return dictionary_to_device(host, resolve_device(device))
