"""The benchmark of gsdr_tpu_torch on one NVIDIA H100.

``python3 sdr_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. The harness is driven by data: a configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json``, the
benchmark's side of a kind of system (what both sides are handed, the
seeded capture, the numbers compared) ``kinds/<kind>.py``, the program's
entry ``entries/<entry>.py``, a per-layer metric ``metrics/<name>.py``, a
roofline's work ``work/<name>.py`` and a plain receiver
``reference/<name>.py``, each found by the name that ``BENCHMARK.json`` or
the configuration gives. Nothing here imports JAX or the JAX package; the
plain receivers import nothing of the port either.
"""
