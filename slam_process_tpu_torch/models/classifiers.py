"""Path classifiers: LoS / NLoS / Sidelobe / Noise labels.

A numpy copy of ``slam_process_tpu/models/classifiers.py``, unchanged in
behaviour.  Each classifier is a sequential loop over at most ``max_paths``
(<= 20) paths on the host:

  * ``classify_argmax`` (v1): the strongest kept path is LoS, the rest NLoS;
  * ``classify_weak_far`` (v1-4): NLoS iff weaker than a ratio of the LoS
    and far from it, near-but-weak Sidelobe, else Noise;
  * ``classify_cross_region`` (v1-5): sidelobes (the cross around the LoS)
    labelled before NLoS;
  * ``classify_advanced`` (v1-6 / v1-7): a unique max-power LoS; NLoS needs
    a relative power in (-sidelobe_power_ratio_db, -nlos_power_thresh_db)
    dB, an angle distance from the LoS above the separation and from every
    accepted NLoS at least it; remaining weak paths inside the cross are
    Sidelobe; the rest Noise.

Labels: 0 = LoS, 1 = NLoS, 2 = Sidelobe, 3 = Noise (also every invalid slot).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slam_process_tpu_torch.config import ClassifierConfig

LOS, NLOS, SIDELOBE, NOISE = 0, 1, 2, 3
LABEL_NAMES = {LOS: "LoS", NLOS: "NLoS", SIDELOBE: "Sidelobe", NOISE: "Noise"}


class ClassifiedPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray
    label: np.ndarray   # [K] int, NOISE for invalid slots
    valid: np.ndarray   # [K] bool


def classify_argmax(aoa, aod, power, valid) -> ClassifiedPaths:
    """v1 rule: the strongest kept path is LoS; everything else NLoS."""
    aoa, aod, power, valid = map(np.asarray, (aoa, aod, power, valid))
    label = np.full(len(power), NOISE, dtype=np.int32)
    if valid.any():
        masked = np.where(valid, power, -np.inf)
        label[valid] = NLOS
        label[int(np.argmax(masked))] = LOS
    return ClassifiedPaths(aoa, aod, power, label, valid)


def classify_advanced(
    aoa, aod, power, valid, cfg: ClassifierConfig = ClassifierConfig()
) -> ClassifiedPaths:
    """AdvancedPathClassifier (v1-7) with reference-exact ordering."""
    aoa, aod, power, valid = map(np.asarray, (aoa, aod, power, valid))
    k = len(power)
    label = np.full(k, NOISE, dtype=np.int32)
    if not valid.any():
        return ClassifiedPaths(aoa, aod, power, label, valid)

    unclassified = valid.copy()

    # Step 1: unique LoS = max power.
    los = int(np.argmax(np.where(valid, power, -np.inf)))
    label[los] = LOS
    unclassified[los] = False
    los_p, los_aoa, los_aod = power[los], aoa[los], aod[los]

    # Step 2: NLoS — iterate candidates in descending power order (stable).
    order = np.argsort(-np.where(unclassified, power, -np.inf), kind="stable")
    accepted: list[int] = []
    for idx in order:
        if not unclassified[idx]:
            continue
        p = power[idx]
        if p <= 0 or los_p <= 0:
            ratio_db = -100.0
        else:
            ratio_db = 10.0 * np.log10(p / los_p)
        ok_power = (-cfg.sidelobe_power_ratio_db < ratio_db
                    < -cfg.nlos_power_thresh_db)
        d_los = float(np.hypot(aod[idx] - los_aod, aoa[idx] - los_aoa))
        ok_geom = d_los > cfg.nlos_angle_separation
        ok_sep = all(
            np.hypot(aod[idx] - aod[j], aoa[idx] - aoa[j])
            >= cfg.nlos_angle_separation
            for j in accepted
        )
        if ok_power and ok_geom and ok_sep:
            label[idx] = NLOS
            unclassified[idx] = False
            accepted.append(int(idx))

    # Step 3: sidelobe — weak paths inside the cross region.
    for idx in range(k):
        if not unclassified[idx]:
            continue
        diff_aod = abs(aod[idx] - los_aod)
        diff_aoa = abs(aoa[idx] - los_aoa)
        in_region = (diff_aod <= cfg.sidelobe_width_aod
                     or diff_aoa <= cfg.sidelobe_width_aoa)
        if power[idx] > 0 and los_p > 0:
            ratio_db = 10.0 * np.log10(power[idx] / los_p)
        else:
            ratio_db = -100.0
        if in_region and ratio_db < -cfg.sidelobe_power_ratio_db:
            label[idx] = SIDELOBE
            unclassified[idx] = False

    # Step 4: the rest stay Noise.
    return ClassifiedPaths(aoa, aod, power, label, valid)


def classify_cross_region(
    aoa, aod, power, valid,
    sidelobe_width_aoa: float = 45.0,
    sidelobe_width_aod: float = 45.0,
    nlos_power_thresh_db: float = 10.0,
    nlos_min_angle_sep: float = 20.0,
) -> ClassifiedPaths:
    """v1-5 PathClassifier (heatmap_gemini_v1-5.py:255-466).

    Order matters: sidelobes are labeled BEFORE NLoS (unlike v1-6/7):
    any path sharing the LoS AoD or AoA within the widths is Sidelobe; the
    remaining candidates (power-descending) become NLoS if weak enough,
    outside the cross on BOTH axes, and separated from accepted NLoS;
    rejected candidates are Noise.
    """
    aoa, aod, power, valid = map(np.asarray, (aoa, aod, power, valid))
    k = len(power)
    label = np.full(k, NOISE, dtype=np.int32)
    if not valid.any():
        return ClassifiedPaths(aoa, aod, power, label, valid)

    unclassified = valid.copy()
    los = int(np.argmax(np.where(valid, power, -np.inf)))
    label[los] = LOS
    unclassified[los] = False
    los_p, los_aoa, los_aod = power[los], aoa[los], aod[los]

    for idx in range(k):
        if not unclassified[idx]:
            continue
        diff_aod = abs(aod[idx] - los_aod)
        diff_aoa = abs(aoa[idx] - los_aoa)
        aod_side = diff_aod <= sidelobe_width_aod and diff_aoa > sidelobe_width_aoa
        aoa_side = diff_aoa <= sidelobe_width_aoa and diff_aod > sidelobe_width_aod
        near_los = diff_aod <= sidelobe_width_aod and diff_aoa <= sidelobe_width_aoa
        if aod_side or aoa_side or near_los:
            label[idx] = SIDELOBE
            unclassified[idx] = False

    order = np.argsort(-np.where(unclassified, power, -np.inf), kind="stable")
    accepted: list[int] = []
    for idx in order:
        if not unclassified[idx]:
            continue
        p = power[idx]
        ratio_db = 10.0 * np.log10(p / los_p) if (p > 0 and los_p > 0) else -100.0
        weak = ratio_db < -nlos_power_thresh_db
        diff_aod = abs(aod[idx] - los_aod)
        diff_aoa = abs(aoa[idx] - los_aoa)
        outside = diff_aod > sidelobe_width_aod and diff_aoa > sidelobe_width_aoa
        separated = all(
            np.hypot(aod[idx] - aod[j], aoa[idx] - aoa[j]) >= nlos_min_angle_sep
            for j in accepted
        )
        if weak and outside and separated:
            label[idx] = NLOS
            accepted.append(int(idx))
        # else stays Noise
        unclassified[idx] = False
    return ClassifiedPaths(aoa, aod, power, label, valid)


def classify_weak_far(
    aoa, aod, power, valid,
    nlos_max_ratio: float = 0.5,
    nlos_min_distance: float = 10.0,
) -> ClassifiedPaths:
    """v1-4 inline rule: NLoS iff weaker than ratio*LoS AND far from LoS
    (heatmap_gemini_v1-4.py:318-375); near-but-weak -> Sidelobe, else Noise."""
    aoa, aod, power, valid = map(np.asarray, (aoa, aod, power, valid))
    label = np.full(len(power), NOISE, dtype=np.int32)
    if not valid.any():
        return ClassifiedPaths(aoa, aod, power, label, valid)
    los = int(np.argmax(np.where(valid, power, -np.inf)))
    label[los] = LOS
    for idx in np.nonzero(valid)[0]:
        if idx == los:
            continue
        weak = power[idx] < nlos_max_ratio * power[los]
        dist = float(np.hypot(aod[idx] - aod[los], aoa[idx] - aoa[los]))
        if weak and dist > nlos_min_distance:
            label[idx] = NLOS
        elif weak:
            label[idx] = SIDELOBE
    return ClassifiedPaths(aoa, aod, power, label, valid)
