"""tinyrenderder_tpu_torch — the renderer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a): the single-pass image route, the
multi-pass tiled frame with exact render stats, each pass on the coarse,
the strip or the grouped strip raster, depth-only passes and the
two-pass shadowed frame, the dense-grid raster entry, the post pass, the
orbit animation and the CLI, the frame split over the ranks of a
``torch.distributed`` process group (row bands or screen blocks), and the
JAX repository's three experimental kernels of ``scripts/``.

The JAX package ``tinyrenderder_tpu`` is the reference this package is
held against.  Module names mirror it so each counterpart is easy to
find:

  tinyrenderder_tpu                 tinyrenderder_tpu_torch
  math3d.py, camera.py          ->  math3d.py, camera.py
  models/ (mesh, procedural,    ->  models/ (all of them: the seven
    the seven loaders, manager)       loaders and the full manager)
  utils/ (tga, stats, native)   ->  utils/ (tga, stats, native: builds
                                      native/*.cpp with g++ on first use)
  ops/semantics.py              ->  ops/semantics.py
  shaders.py                    ->  shaders.py (host classes + device half)
  ops/raster_tiled.py           ->  ops/raster_tiled.py
  ops/raster_pallas.py          ->  ops/raster_coarse.py + csrc/raster_coarse.cu
    (sparse and dense launches)       (coarse_raster, rasterize, depth_resolve)
  ops/raster_fine.py            ->  ops/raster_fine.py + csrc/raster_fine.cu
  ops/raster_fine2.py           ->  ops/raster_fine2.py + csrc/raster_fine2.cu
  ops/raster_sparse.py          ->  ops/raster_sparse.py + csrc/untile.cu
  ops/raster.py (pass_stats)    ->  ops/raster.py
  ops/post.py                   ->  ops/post.py
  oracle.py                     ->  oracle.py (NumPy, imports no torch)
  scene.py (Scene, cull, tiled) ->  scene.py
  shadows.py                    ->  shadows.py
  animation.py                  ->  animation.py
  parallel/dist.py (row-band    ->  parallel/dist.py (torch.distributed:
    and block backends)               NCCL or gloo ranks, or emulated ones)
  cli.py                        ->  cli.py
  scripts/experimental_fine_raster.py,  experimental/ (fine_raster,
    experimental_rank_kernel.py,          rank_kernel, inplace_blocks)
    probe_inplace_blocks.py       ->      + csrc/{fine_raster,rank_kernel,
                                          inplace_blocks}.cu

The host layer (scene description, cull, ``build_uniforms``, meshes,
the NumPy oracle and post) is the port's own NumPy copy of the JAX
package's; ``convert.pass_to_torch`` carries its NumPy outputs to the
device.

This package imports torch, never jax and nothing of the JAX package.
It runs eagerly (no ``torch.compile``: fusion may contract multiply-adds
and break bitwise parity with the reference).  Each kernel wrapper runs
the kernel's plain PyTorch version for CPU tensors and launches the CUDA
kernel for CUDA tensors.
"""

__version__ = "0.1.0"
