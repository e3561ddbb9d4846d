"""K3, blur, norm and colours of one 64 x 64 tile (``raster_kernel``): the
tile, the 256-entry table and the 7 x 7 taps read once, RGBA, norm and
blurred (24 bytes a cell) written once; 49 taps x 4 operations and 30 for
the norm and colour per cell, float32 (``chip_smoke.py``'s K3 bound)."""


def work(s: dict):
    n = s.get("rasters")
    if not n:
        return None
    return (n * (64 * 64 * 4 + 256 * 16 + 49 * 4 + 64 * 64 * 24),
            {"f32": n * 64 * 64 * (49 * 4 + 30)})
