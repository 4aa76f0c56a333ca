"""PyTorch/CUDA port of ``sparse_rcnn_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``sparse``, ``ops/``, ``models/``, ``data/``, ``train/``,
``utils/``) and imports neither jax nor anything of ``sparse_rcnn_tpu``. Its one
hand-written kernel is the fused gather-GEMM sparse convolution
(``ops/csrc/sparse_conv.cu``), which carries every sparse conv of the UNet.
"""
