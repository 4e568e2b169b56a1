"""The benchmark of ``repro_torch``'s warp-size study on the card.

One command runs one cell once (``python3 -m warpbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, see :mod:`warpbench.run`). A
cell ``<config>.<traffic>`` and each metric are found by name in files of
their own: ``configs/``, ``traffic/``, ``metrics/``. The plain reference
that decides ``correct`` is ``reference/``; it imports nothing of the
program.
"""
