"""K5, the stream's row compaction (``compact_kernel``,
``compact_chunks_kernel``): one mask byte per frame and a test and a rank
add per frame for the open group's carry; with the paths, the kept rows'
16 bytes read and written once more into the paths' buffer, with their
own test and rank add.  The carried rows' own payload is not counted
(an undercount: the share can only read low)."""


def work(s: dict):
    if not s.get("streams") or not s.get("frames"):
        return None
    passes = 2 if s.get("carry_paths") else 1
    return (s["frames"] * passes + (32 * s["kept"] if s.get("carry_paths") else 0),
            {"int32": 2 * s["frames"] * passes})
