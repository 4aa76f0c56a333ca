"""The sparse-conv kernels' share of their roofline in a train step with
rematerialised residual blocks, the recompute counted as work done: the
sum of every launch's bound (``core/flops_remat.py::
step_conv_bound_remat_s`` from the reference's rulebooks of each traced
batch: the train step's forwards, dgrads but the stem's and wgrads, and
the blocks' forwards run again in the backward) over the sum of the traced
device time of ``sparse_conv_fwd_kernel`` (forwards, recomputed forwards
and dgrads), ``sparse_conv_wgrad_partial_kernel`` and
``sparse_conv_wgrad_reduce_kernel``, in %. None without remat."""

from portbench.core.flops_remat import step_conv_bound_remat_s

KERNELS = ("sparse_conv_fwd_kernel", "sparse_conv_wgrad_partial_kernel",
           "sparse_conv_wgrad_reduce_kernel")


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if (record.get("mode") != "train" or tr is None or not stats
            or not record["cfg"].model.backbone.remat):
        return None
    t = sum(tr.sum_kernels(k)[0] for k in KERNELS)
    if t <= 0:
        return None
    bound = sum(step_conv_bound_remat_s(record["cfg"], record["n_sparse"], s) for s in stats)
    return 100.0 * bound / t
