"""K4, the per-sweep grids of the stream's paths (``sweep_sums_kernel``):
each kept row's sweep, BS and RSS (12 bytes) read once, each closed
sweep's 64 x 64 sums and counts (float32) written once; two atomic adds
per kept row (``chip_smoke.py``'s K4 bound, closed sweeps in place of the
program's lanes)."""


def work(s: dict):
    if not s.get("sweeps"):
        return None
    return s["kept"] * 12 + s["sweeps"] * 64 * 64 * 8, {"int32": 2 * s["kept"]}
