"""The sparse-conv kernels' share of their roofline in the train step: the
sum of every launch's bound (``core/flops.py::step_conv_bound_s`` from the
reference's rulebooks of each traced batch: forwards, dgrads but the
stem's, wgrads) over the sum of the traced device time of
``sparse_conv_fwd_kernel`` (forwards and dgrads),
``sparse_conv_wgrad_partial_kernel`` and ``sparse_conv_wgrad_reduce_kernel``,
in %."""

from portbench.core.flops import step_conv_bound_s

KERNELS = ("sparse_conv_fwd_kernel", "sparse_conv_wgrad_partial_kernel",
           "sparse_conv_wgrad_reduce_kernel")


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if record.get("mode") != "train" or tr is None or not stats:
        return None
    t = sum(tr.sum_kernels(k)[0] for k in KERNELS)
    if t <= 0:
        return None
    bound = sum(step_conv_bound_s(record["cfg"], record["n_sparse"], s, train=True)
                for s in stats)
    return 100.0 * bound / t
