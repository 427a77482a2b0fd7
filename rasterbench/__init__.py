"""The benchmark of ``tinyrenderder_tpu_torch``: frames delivered on
NVIDIA GPUs, checked against a plain PyTorch reference.

``run`` is the entry point (``python -m rasterbench.run``); ``catalog``
finds the configurations (``configs/``), traffic mixes (``traffic/``) and
metric readers (``metrics/``) that ``BENCHMARK.json`` names.  Nothing here
imports JAX or the JAX package, and ``reference`` imports nothing of the
program.
"""
