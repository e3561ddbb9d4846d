"""Carry the JAX package's pipeline state over to the port.

The system has no weights.  What its session pipeline is handed is the
three stage configs, the colormap LUT (a numpy array, passed as it is) and
the corrector's static bounds (plain integers).  The configs are read
field by field from any objects that have the port's field names, so this
module needs no import of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from slam_process_tpu_torch.config import CorrectConfig, DecodeConfig, SceneConfig


def _copy(cls, src):
    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def configs_from_reference(decode_cfg, correct_cfg, scene_cfg
                           ) -> Tuple[DecodeConfig, CorrectConfig, SceneConfig]:
    """Port's frozen (DecodeConfig, CorrectConfig, SceneConfig) from the
    reference objects' fields (raises AttributeError on a missing field)."""
    return (_copy(DecodeConfig, decode_cfg), _copy(CorrectConfig, correct_cfg),
            _copy(SceneConfig, scene_cfg))
