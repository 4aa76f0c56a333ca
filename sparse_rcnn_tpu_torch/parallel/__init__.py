"""Data parallel over processes, one per device (port of
``sparse_rcnn_tpu/parallel/``): :mod:`.context` holds the thread-local
context that the models' batch reductions consult; :mod:`.data_parallel`
the process group, the parallel train and eval steps and
``replicate_state``."""
