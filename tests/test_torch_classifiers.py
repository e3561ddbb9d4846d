"""The port's path classifiers (slam_process_tpu_torch.models.classifiers)
== the JAX package's, label for label.

Seeded path sets of K = 20 slots go through the four classifiers of both
packages (``classify_argmax``, ``classify_weak_far``,
``classify_cross_region``, ``classify_advanced`` with the default and the
v1-7 reference script's thresholds): random paths, ties in power (the LoS and the
NLoS candidates' order), all slots invalid, non-positive power, and paths
exactly at a separation threshold (integer angle offsets whose distance is
exactly 15 or 20 degrees, and a power ratio exactly at -3 dB's power).
Labels, and the arrays passed through, must be equal exactly.
``classifier_config_from_reference`` carries JAX's thresholds across.
"""

import numpy as np
import pytest

from slam_process_tpu.config import ClassifierConfig as JaxClassifierConfig
from slam_process_tpu.models import classifiers as jax_classifiers
from slam_process_tpu_torch.config import ClassifierConfig
from slam_process_tpu_torch.convert import classifier_config_from_reference
from slam_process_tpu_torch.models import classifiers

K = 20


def random_paths(rng):
    aoa = np.round(rng.uniform(-43.6, 45.0, K), 1)
    aod = np.round(rng.uniform(-43.6, 45.0, K), 1)
    power = np.abs(rng.normal(size=K)) * 10 + 0.1
    valid = rng.random(K) < 0.8
    return aoa, aod, power, valid


def case_paths(case, seed):
    rng = np.random.default_rng(seed)
    aoa, aod, power, valid = random_paths(rng)
    if case == "power_ties":
        power = rng.choice([1.0, 2.0, 4.0], K)            # LoS and candidates tie
        power[0] = power[1] = power.max()
    elif case == "near_los_powers":
        power = power.max() * (1 - rng.choice([0.001, 0.02, 0.03], K))   # ratios in (-0.15, -0.01) dB
    elif case == "all_invalid":
        valid = np.zeros(K, bool)
    elif case == "non_positive_power":
        power[rng.random(K) < 0.4] = 0.0
        power[rng.random(K) < 0.2] *= -1
    elif case == "separation_threshold":
        # Offsets (9, 12) and (12, 16) from the strongest path: distances
        # exactly 15 and 20 degrees; (5, 0) exactly the sidelobe width.
        top = int(np.argmax(np.where(valid, power, -np.inf)))
        offsets = [(9.0, 12.0), (12.0, 16.0), (5.0, 0.0), (0.0, 5.0), (45.0, 45.0)]
        for j, (da, dd) in enumerate(offsets, start=1):
            k = (top + j) % K
            aoa[k], aod[k], valid[k] = aoa[top] + da, aod[top] + dd, True
            power[k] = power[top] * (0.5 if j == 1 else 0.99)   # exactly -3.0103 dB
    elif case == "f32":
        aoa, aod, power = (x.astype(np.float32) for x in (aoa, aod, power))
    return aoa, aod, power, valid


CASES = ["random", "power_ties", "near_los_powers", "all_invalid", "non_positive_power",
         "separation_threshold", "f32"]
V17 = dict(sidelobe_width_aoa=5.0, sidelobe_width_aod=5.0, nlos_power_thresh_db=0.01,
           nlos_angle_separation=15.0, sidelobe_power_ratio_db=0.15)


def classifier_pairs():
    wide = dict(sidelobe_width_aoa=10.0, sidelobe_width_aod=10.0, nlos_power_thresh_db=3.0,
                nlos_min_angle_sep=15.0)
    loose = dict(sidelobe_width_aoa=3.0, sidelobe_width_aod=3.0, nlos_power_thresh_db=0.001,
                 nlos_angle_separation=20.0, sidelobe_power_ratio_db=3.0103)
    return {
        "argmax": (jax_classifiers.classify_argmax, classifiers.classify_argmax, {}, {}),
        "weak_far": (jax_classifiers.classify_weak_far, classifiers.classify_weak_far, {}, {}),
        "weak_far_ratio": (jax_classifiers.classify_weak_far, classifiers.classify_weak_far,
                           dict(nlos_max_ratio=0.99, nlos_min_distance=15.0),
                           dict(nlos_max_ratio=0.99, nlos_min_distance=15.0)),
        "cross_region": (jax_classifiers.classify_cross_region,
                         classifiers.classify_cross_region, {}, {}),
        "cross_region_wide": (jax_classifiers.classify_cross_region,
                              classifiers.classify_cross_region, wide, wide),
        "advanced_default": (jax_classifiers.classify_advanced, classifiers.classify_advanced,
                             {}, {}),
        "advanced_v17": (jax_classifiers.classify_advanced, classifiers.classify_advanced,
                         dict(cfg=JaxClassifierConfig(**V17)),
                         dict(cfg=ClassifierConfig(**V17))),
        "advanced_loose": (jax_classifiers.classify_advanced, classifiers.classify_advanced,
                           dict(cfg=JaxClassifierConfig(**loose)),
                           dict(cfg=classifier_config_from_reference(
                               JaxClassifierConfig(**loose)))),
    }


PAIRS = classifier_pairs()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", sorted(PAIRS))
def test_classifiers_match_jax(which, case):
    jax_fn, fn, jax_kw, kw = PAIRS[which]
    labels = set()
    for seed in range(4):
        args = case_paths(case, seed)
        want = jax_fn(*args, **jax_kw)
        got = fn(*args, **kw)
        assert got.label.dtype == want.label.dtype
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"seed {seed} {field}")
        labels.update(got.label.tolist())
    if case == "all_invalid":
        assert labels == {classifiers.NOISE}
    elif case == "random":
        assert classifiers.LOS in labels and len(labels) >= 2


def test_label_names_and_config_carry_across():
    assert classifiers.LABEL_NAMES == jax_classifiers.LABEL_NAMES
    assert (classifiers.LOS, classifiers.NLOS, classifiers.SIDELOBE, classifiers.NOISE) == (
        jax_classifiers.LOS, jax_classifiers.NLOS, jax_classifiers.SIDELOBE,
        jax_classifiers.NOISE)
    assert classifier_config_from_reference(JaxClassifierConfig()) == ClassifierConfig()
    assert classifier_config_from_reference(JaxClassifierConfig(**V17)) == ClassifierConfig(**V17)
