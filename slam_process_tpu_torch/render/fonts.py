"""CJK font discovery for figure chrome (a copy of
``slam_process_tpu/render/fonts.py``).

The figures' titles and labels are Chinese.  ``setup_cjk_font`` registers
the first CJK-capable font it finds with matplotlib:

  1. a font file under ``slam_process_tpu_torch/assets/fonts/``;
  2. the file named by the ``SLAM_PROCESS_TPU_CJK_FONT`` environment
     variable;
  3. a CJK family matplotlib already knows (SimHei, Noto Sans CJK SC, ...).

With none, figures still draw: DejaVu renders the Latin chrome and CJK
labels show as boxes.  matplotlib (and fontTools) are imported inside the
functions, so importing this module needs neither.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional

ASSET_FONT_DIR = Path(__file__).resolve().parent.parent / "assets" / "fonts"
_CJK_FAMILIES = ("SimHei", "Noto Sans CJK SC", "Noto Sans SC", "Source Han Sans SC",
                 "WenQuanYi Zen Hei", "Microsoft YaHei")
# A character of the figure titles, used as the coverage probe.
_PROBE_CHAR = 0x6CE2   # 波


def _has_cjk(font_path: str) -> bool:
    try:
        from fontTools.ttLib import TTFont

        return _PROBE_CHAR in TTFont(font_path, fontNumber=0).getBestCmap()
    except Exception:   # a missing fontTools or an unreadable font: not usable
        return False


@functools.lru_cache(maxsize=1)
def setup_cjk_font() -> Optional[str]:
    """Register a CJK font with matplotlib and return its family name, or
    None when no CJK font exists.  ``axes.unicode_minus`` is turned off only
    with a CJK font, which draws no Unicode minus."""
    import matplotlib
    import matplotlib.font_manager as fm

    candidates = []
    if ASSET_FONT_DIR.is_dir():
        for ext in ("*.ttf", "*.otf", "*.ttc"):
            candidates += sorted(ASSET_FONT_DIR.glob(ext))
    env = os.environ.get("SLAM_PROCESS_TPU_CJK_FONT")
    if env:
        candidates.append(Path(env))

    def _activate(family):
        matplotlib.rcParams["axes.unicode_minus"] = False
        matplotlib.rcParams["font.sans-serif"] = [family] + list(
            matplotlib.rcParams["font.sans-serif"])
        return family

    for path in candidates:
        if path.is_file() and _has_cjk(str(path)):
            fm.fontManager.addfont(str(path))
            return _activate(fm.FontProperties(fname=str(path)).get_name())
    installed = {f.name: f.fname for f in fm.fontManager.ttflist}
    for family in _CJK_FAMILIES:
        fname = installed.get(family)
        if fname and _has_cjk(fname):
            return _activate(family)
    return None
