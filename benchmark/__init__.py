"""The benchmark of the PyTorch and CUDA port (``tacotron2_tpu_torch``).

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card(s) of the
machine it starts on and prints one JSON line. Everything that measures
(traffic, the reference, the counts of work, the reading of traces) lives
in this folder; the program is only called.
"""
