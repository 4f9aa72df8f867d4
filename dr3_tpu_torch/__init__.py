"""dr3_tpu_torch — the PyTorch + CUDA port of ``dr3_tpu``.

The package mirrors ``dr3_tpu``'s layout and module names so each ported
module's reference is easy to find; the JAX package stays the reference the
port is held against (tests/test_torch_*.py). This package imports ``torch``
and never ``jax`` or ``dr3_tpu``.

Ported so far: the monocular VO main path (``pipelines.vo.MonoVO``:
``process``, ``process_batch``, loop closure, ``global_refine``; on the card
a general frame is one CUDA-graph replay) and its CLI (``run_slam``, with
KITTI sequences, format-2 checkpoints and the map rendering), the
stitch/panorama path (``pipelines.stitch``, ``pipelines.panorama``,
``run_panorama``), BAL bundle adjustment (``io.bal``, ``ba.snavely``: the
exact 9-parameter objective with the square-root dense Schur and
matrix-free PCG solves; ``ba.lm``, the generic dense LM; ``run_ba``), the
repository's root entry points (``entry``: the VO tracking step and the
distributed dry run; ``bench``: the benchmark's one JSON line), and
their hand-written CUDA kernels (``csrc/lk.cu``, ``csrc/sample.cu``,
``csrc/detect.cu``, ``csrc/warp.cu``), built with nvcc for ``sm_90a`` on
first use (``ops/_native.py``). On a CPU tensor each kernel wrapper runs
its plain PyTorch twin instead.

Package layout (as dr3_tpu):
  dr3_tpu_torch.geometry   SO3/SE3, small linear algebra, epipolar,
                           homography, RANSAC
  dr3_tpu_torch.models     pinhole camera
  dr3_tpu_torch.ops        pyramid, sampling and warps, LK, sparse
                           alignment, corners, matching, blending, and the
                           CUDA kernel loader
  dr3_tpu_torch.ba         BA problem, Schur core, LM drivers, the Snavely
                           (BAL) objective, generic dense LM
  dr3_tpu_torch.io         image files, KITTI sequences, checkpoints, BAL
                           files
  dr3_tpu_torch.native     the prefetching PNG/JPEG decoder (g++, ctypes)
  dr3_tpu_torch.pipelines  two-view init, loop closure, MonoVO, Stitch,
                           Panorama
  dr3_tpu_torch.utils      config, timing, CUDA-graph runner, numpy scene
                           renderers (two planes, forward corridor)
  dr3_tpu_torch.tools      card timing (kernels, BA, BAL), bounds, the
                           real-structure BAL export
  dr3_tpu_torch.viz        trajectory error (numpy), map rendering
"""

__version__ = "0.1.0"

from dr3_tpu_torch.utils.config import Config  # noqa: F401,E402
