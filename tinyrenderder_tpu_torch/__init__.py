"""tinyrenderder_tpu_torch — the renderer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a): the single-pass image route, the
multi-pass tiled frame with exact render stats, the post pass and the
CLI.

The JAX package ``tinyrenderder_tpu`` is the reference this package is
held against.  Module names mirror it so each counterpart is easy to
find:

  tinyrenderder_tpu                 tinyrenderder_tpu_torch
  ops/semantics.py              ->  ops/semantics.py
  shaders.py (device halves)    ->  shaders.py
  ops/raster_tiled.py           ->  ops/raster_tiled.py
  ops/raster_pallas.py          ->  ops/raster_coarse.py + csrc/raster_coarse.cu
  ops/raster_sparse.py          ->  ops/raster_sparse.py + csrc/untile.cu
  ops/raster.py (pass_stats)    ->  ops/raster.py
  ops/post.py                   ->  ops/post.py
  scene.render_scene (tiled)    ->  scene.render_scene
  scene.render_scene_image      ->  scene.render_scene_image
  cli.py                        ->  cli.py

Host-only modules of the JAX package (``scene.Scene``, the shader
classes and ``build_uniforms``, ``models``, ``camera``, ``math3d``,
``utils``, ``cli.build_default_scene``, the NumPy path of ``ops/post.py``
and the NumPy ``oracle``) import no jax and are reused as they are;
``convert.pass_to_torch`` carries their NumPy outputs across.

This package imports torch and never jax.  It runs eagerly (no
``torch.compile``: fusion may contract multiply-adds and break bitwise
parity with the reference).  Each kernel wrapper runs the kernel's plain
PyTorch version for CPU tensors and launches the CUDA kernel for CUDA
tensors.
"""

__version__ = "0.1.0"
