"""The benchmark of the emulator's PyTorch and CUDA port (``repro_torch``)
on one card or four: a data-driven harness.

``BENCHMARK.json`` at the root of the checkout names the cells; each
cell's configuration, traffic mix, entry point and metrics are files of
their own here (``configs/``, ``traffic/``, ``entries/``, ``metrics/``),
found by name (:mod:`hmes_bench.discover`). ``python3 hmes_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
once and prints one JSON line. The yardstick lives here and nowhere in
the program: the traffic generator (:mod:`tracegen`, and
:mod:`tracegen_large` past the recipe table's footprints), the byte count
(:mod:`hbm_bytes`), the peaks (``peaks.json``), the plain reference
(``reference/``) and the comparison that decides ``correct``
(:mod:`judge`).
"""
