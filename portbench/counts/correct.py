"""K2, the corrector's verdicts (``correct_verdicts_kernel``): 8 bytes of
(group, CLK) read and 9 written per frame, each baseline's (CLK, BS)
read once; ``k2_ops`` of the candidates and search steps that the
reference counts (``reference/pipeline.correct``, ``judge.search_steps``)."""


def k2_ops(candidates, steps, rows):
    """K2's int32 operations: 8 per candidate scored (difference, two
    compares, the wrap, |.|, the test, the packed score, the minimum), 2 per
    search step (a compare and a select), 10 per row (the floor division,
    the outputs).  A frozen copy of ``chip_smoke.k2_ops``."""
    return candidates * 8 + steps * 2 + rows * 10


def work(s: dict):
    if not s.get("frames"):
        return None
    return (s["frames"] * 17 + s.get("baselines", 0) * 8,
            {"int32": k2_ops(s["k2_candidates"], s["k2_steps"], s["frames"])})
