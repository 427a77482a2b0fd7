"""tinyrenderder_tpu_torch — the renderer's single-pass image route in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``tinyrenderder_tpu`` is the reference this package is
held against.  Module names mirror it so each counterpart is easy to
find:

  tinyrenderder_tpu                 tinyrenderder_tpu_torch
  ops/semantics.py              ->  ops/semantics.py
  shaders.py (device halves)    ->  shaders.py
  ops/raster_tiled.py           ->  ops/raster_tiled.py
  ops/raster_pallas.py          ->  ops/raster_coarse.py + csrc/raster_coarse.cu
  ops/raster_sparse.py          ->  ops/raster_sparse.py + csrc/untile.cu
  scene.render_scene_image      ->  scene.render_scene_image

Host-only modules of the JAX package (``scene.Scene``, the shader
classes and ``build_uniforms``, ``models``, ``camera``, ``math3d``,
``utils`` and the NumPy ``oracle``) import no jax and are reused as they
are; ``convert.pass_to_torch`` carries their NumPy outputs across.

This package imports torch and never jax.  It runs eagerly (no
``torch.compile``: fusion may contract multiply-adds and break bitwise
parity with the reference).  Each kernel wrapper runs the kernel's plain
PyTorch version for CPU tensors and launches the CUDA kernel for CUDA
tensors.
"""

__version__ = "0.1.0"
