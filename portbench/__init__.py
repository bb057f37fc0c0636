"""The benchmark of ``databend_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell is
made of is found by name: its configuration in ``configs/``, its traffic
mix in ``traffic/<mix>.json`` (read by the driver ``traffic/<driver>.py``),
its rows from ``data/<generator>.py``, its per-layer metrics from
``metrics/<metric>.py`` and its check from ``reference/<name>.py``. Nothing
here imports ``jax`` or the JAX package ``databend_tpu``.
"""
