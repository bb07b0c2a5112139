"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA GPUs.

``python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
