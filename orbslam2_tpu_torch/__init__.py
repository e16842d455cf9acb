"""orbslam2_tpu_torch — the PyTorch/CUDA port of orbslam2_tpu.

A second package beside the JAX reference (`orbslam2_tpu/`), keeping its
module names so every counterpart is easy to find. Plain tensor code is
PyTorch; each device kernel on the stereo tracking path is CUDA C++
written for Hopper (`csrc/`, built at first use by `kernels/build.py`).

Conventions that differ from the JAX package:
  * an explicit `device` is threaded from `System(..., device=...)`
    down; nothing auto-detects an accelerator;
  * descriptors are int32 [N, 8] tensors holding the same bits as the
    JAX package's uint32 words;
  * on a CPU tensor every kernel wrapper runs its plain PyTorch version;
    on a CUDA tensor it launches the kernel or raises.

The package imports `torch` and never `jax`, and nothing of the JAX
package either, so that it runs on a machine that has neither, nor
OpenCV, matplotlib or PIL (`datasets/png.py` reads and writes PNGs; the
viewer draws into numpy rasters). Where a JAX-package module that the
port needs is JAX-free or nearly so (`config`, `slam.timing`,
`evaluation.ate`, `evaluation.associate`, `evaluation.analyze`,
`slam.map`, `slam.pipeline`, `datasets.synthetic`, `vocab.train`, the
ORB pattern file), the port carries a copy; each copy says so. The
command-line drivers are `drivers/run_euroc.py`, `run_kitti.py` and
`run_synthetic.py`.
"""

__version__ = "0.1.0"
