"""Frozen float32 copy of the plain paths of ``sparse_rcnn_tpu_torch`` at
commit 4dd78ef (see each module's first lines for what was changed)."""
