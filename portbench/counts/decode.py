"""K1, the frame decode (``decode_rows_kernel``): each byte fed read once
and each decoded frame's five 32-bit fields written once; a flag test (3
operations) at every byte, the ten tag-class tests (30) where a flag byte
sits, the assembly and the row write (28) at each frame start (the count
arithmetic of ``chip_smoke.py``'s K1 bound, with the frames the log
holds in place of the program's row layout)."""


def work(s: dict):
    if not s.get("frames"):
        return None
    return (s["bytes"] + 20 * s["frames"],
            {"int32": 3 * s["bytes"] + 30 * s["flags"] + 28 * s["frames"]})
