"""The benchmark of ``tiny_audio_tpu_torch`` on NVIDIA H100 cards.

One run of one cell: ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``README.md``).  Configurations, cells
and per-layer metrics are files found by name under ``configs/``,
``workloads/`` and ``metrics/``.
"""
