"""portbench: the benchmark of ``wavelets_tpu_torch`` on the CUDA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Nothing here imports JAX or the JAX package ``wavelets_tpu``;
the references under ``reference/`` import nothing of the program.
"""
