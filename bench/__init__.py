"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Everything a cell is made of is
found by name: its configuration in ``bench/configs/`` and the family that
makes its structure in ``bench/families/``, its traffic mix (data) in
``bench/traffic/`` and the driver the mix names in ``bench/drivers/``, its
limits in ``bench/limits/`` and each metric's reader in ``bench/metrics/``.
The yardstick lives here too: the structure generators, the roofline
arithmetic, the profile reader and the plain reference
(``bench/reference/``), none of which imports the port.
"""
