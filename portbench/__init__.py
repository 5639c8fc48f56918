"""The port's benchmark: one cell of ``BENCHMARK.json`` run once on the
card by ``python3 portbench/run.py``.  It imports the program
(``repro_torch``) and never JAX or the JAX package."""
