"""sugar_tpu_torch — the PyTorch/CUDA port of ``sugar_tpu``.

The JAX package ``sugar_tpu`` is the reference; each module here names its
counterpart there. Plain tensor code is PyTorch; every Pallas TPU kernel on
the ported path is a hand-written CUDA kernel for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound through ``ctypes``. On CPU tensors each
kernel wrapper runs the kernel's plain PyTorch version instead.

Ported so far: the render path (preprocess -> fused binning -> dup gather
-> tile compositing), the 3DGS and mesh PLY formats, the Gaussian model,
vanilla 3DGS training (the compositing backward and the gradient
segment-sum), scene loading, coarse SuGaR, coarse mesh extraction
(``meshing/``, with the host C++ QEM decimation of ``csrc/qem.cpp``),
mesh-bound refinement and the texture bake (``refine/``, ``io/obj.py``,
``io/png.py``), evaluation (``eval/``), the whole pipeline
(``pipeline.py``) with its entry points (``scripts/``), the viewer and
profiling auxiliaries, every render mode of the JAX package, and the
multi-device paths (``parallel/``, one process per rank under
``torch.distributed``).

Importing the package builds nothing and needs neither a GPU nor ``nvcc``.
"""
