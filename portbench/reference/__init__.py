"""Plain references the benchmark judges the port's answers by. They import
nothing of ``databend_tpu_torch``, ``databend_tpu`` or ``jax`` and take
nothing the port made: only the generated rows and queries, and the port's
answers to judge them."""
