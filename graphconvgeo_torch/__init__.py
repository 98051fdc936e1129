"""graphconvgeo_torch — the Highway-GCN geolocation framework in PyTorch, for
one NVIDIA H100.

A port of ``graphconvgeo_tpu`` (the JAX package, which stays as the
reference): the same sub-package layout (``data/``, ``native/``, ``sparse/``,
``ops/``, ``models/``, ``train/``, ``utils/``, ``cli.py``), PyTorch idiom
(``nn.Module``, explicit devices and generators, ``autograd.Function``), and
the JAX package's one Pallas kernel on the training path rewritten as a
hand-written CUDA kernel for ``sm_90a`` (``csrc/bsr_flat.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
