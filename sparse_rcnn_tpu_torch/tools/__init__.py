"""Command-line tools of the port: capacity sizing, ScanNet preprocessing
and checkpoint form conversion (``python -m sparse_rcnn_tpu_torch.tools.<name>``)."""
