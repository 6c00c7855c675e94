"""Benchmark of the PyTorch and CUDA port (``sbayes_tpu_torch``) on one card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one metric is a
file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``. The yardstick (data
generators, the plain reference, the comparison that decides ``correct``,
the peaks and the counts of bytes and operations) lives here too, and
imports nothing of the port.
"""
