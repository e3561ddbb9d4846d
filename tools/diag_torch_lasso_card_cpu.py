#!/usr/bin/env python3
"""The LASSO solve on the card against the CPU, on one set of inputs.

    python3 tools/diag_torch_lasso_card_cpu.py

Builds the small synthetic sessions of ``tests/test_torch_cuda.py``'s
estimator fixture (6 and 3 groups, 2 frames a beam, 6 baselines a group),
decoded on the card and on the CPU, and the LASSO program's inputs of
sessions 0 and 1 as phase 21 makes them (``chip_smoke.lasso_program_inputs``,
up to 20 peaks).  For each input set it prints one JSON line: whether the
card-decoded and CPU-decoded sessions give the same inputs, the largest
difference between ``models/lasso_refine.patch_lasso_torch`` on the card and
on the CPU for the same CPU-made inputs, and, for the coefficient that
differs most, its raw column norm and its set-up terms (diag, b) on both
devices and its value after 1, 2, 5, 20 and 200 sweeps on both.  Then the
same for each set-up term alone (``patch_setup`` on the card against the
CPU).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from chip_smoke import lasso_program_inputs
    from slam_process_tpu_torch.models import lasso_refine as lr
    from slam_process_tpu_torch.ops.lasso import lasso_sweep_
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        synthetic_session_bytes, to_hex_text, write_angle_table)

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_lasso_card_cpu: needs an NVIDIA GPU")
    card = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        paths = []
        for i, (g, seed) in enumerate(((6, 1), (6, 2), (3, 3), (3, 4))):
            paths.append(tmp / f"s{i}.txt")
            paths[-1].write_bytes(to_hex_text(synthetic_session_bytes(
                n_groups=g, frames_per_beam=2, baselines_per_group=6, seed=seed, n_paths=3)))
        angles = write_angle_table(tmp / "angles.xlsx")
        on_card, on_cpu = ({f"{tag}_{k}": x for tag, pair in lasso_program_inputs(
            [Session.from_log(p, device=dev) for p in paths], angles, dev)
            for k, x in enumerate(pair)} for dev in (card, "cpu"))

    def stepped(ins, dev):
        *gram, norms = lr.patch_setup(*(x.to(dev) for x in ins))
        w, out, done = torch.zeros_like(gram[1]), {}, 0
        for n in (1, 2, 5, 20, lr.N_SWEEPS):
            for _ in range(n - done):
                lasso_sweep_(w, *gram, 0.1)
            done = n
            out[n] = (w / norms).cpu()
        return [g.cpu() for g in gram], norms.cpu(), out

    for tag, ins in on_cpu.items():
        same = all(torch.equal(a, b) for a, b in zip(ins, on_card[tag]))
        g_cpu, n_cpu, w_cpu = stepped(ins, "cpu")
        g_card, n_card, w_card = stepped(ins, card)
        diff = (w_card[lr.N_SWEEPS] - w_cpu[lr.N_SWEEPS]).abs()
        p, j = divmod(int(diff.argmax()), diff.shape[1])
        row = {"inputs": tag, "card_decode_equals_cpu_decode": same,
               "max_abs_diff": float(diff.max()),
               "differing": int((diff > 1e-9 * w_cpu[lr.N_SWEEPS].abs().clamp(min=1e-12)).sum()),
               "worst": [p, j], "norm": [float(n_cpu[p, j]), float(n_card[p, j])],
               "diag": [float(g_cpu[2][p, j]), float(g_card[2][p, j])],
               "b": [float(g_cpu[1][p, j]), float(g_card[1][p, j])],
               "w_by_sweeps_cpu_card": {n: [float(w_cpu[n][p, j]), float(w_card[n][p, j])]
                                        for n in w_cpu},
               "setup_max_abs_diff": {name: float((a.double() - b.double()).abs().max())
                                      for name, a, b in zip(
                                          ("G", "b", "diag", "live", "safe"), g_cpu, g_card)}
               | {"norms": float((n_cpu - n_card).abs().max())}}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
