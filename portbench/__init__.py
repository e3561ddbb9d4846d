"""The benchmark of ``slam_process_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``portbench/run.py``).  The folder holds
the traffic generator (``traffic/``), the plain reference and the
comparison that decides ``correct`` (``reference/``), one driver per kind
of traffic (``drivers/``), the kernels' operation and byte counts with
the table of peaks (``counts/``), one reader per per-layer metric
(``metrics/``), the configurations and cells as data (``configs/``,
``workloads/``), the controls (``control.py``) and its own CPU tests
(``tests/``).  Nothing here imports JAX or the JAX package.
"""
