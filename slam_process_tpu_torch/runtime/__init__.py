"""Native host accelerators, loaded with ctypes.

``hexscan``: the hex-token scanner of the serial-log ingest (``hexscan.c``,
an AVX-512 block path for regular ``"XX "`` streams and a scalar path for
the full grammar), built lazily with the system C compiler.  The numpy
tokenizer (``io/hexlog.tokenize_hex``) gives the same bytes.
"""

from slam_process_tpu_torch.runtime import hexscan  # noqa: F401
