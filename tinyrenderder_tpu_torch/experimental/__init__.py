"""The JAX repository's experimental kernels, ported: one module per
script of ``scripts/``, named after it, each with its wrapper, plain
PyTorch version, CUDA kernel (``csrc/``) and a ``main()`` that runs the
script's own check on the port:

  scripts/experimental_fine_raster.py  ->  fine_raster.py + csrc/fine_raster.cu
  scripts/experimental_rank_kernel.py  ->  rank_kernel.py + csrc/rank_kernel.cu
  scripts/probe_inplace_blocks.py      ->  inplace_blocks.py + csrc/inplace_blocks.cu

    python -m tinyrenderder_tpu_torch.experimental.<module> [--device cpu]

No render path of the package calls them.
"""
