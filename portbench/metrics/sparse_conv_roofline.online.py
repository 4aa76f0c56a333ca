"""The sparse-conv forward kernel's share of its roofline in the online
requests: the sum of every forward launch's bound
(``core/flops.py::step_conv_bound_s`` from the reference's rulebooks of
each traced sweep) over the traced device time of
``sparse_conv_fwd_kernel``, in %."""

from portbench.core.flops import step_conv_bound_s


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if record.get("mode") != "online" or tr is None or not stats:
        return None
    t, _ = tr.sum_kernels("sparse_conv_fwd_kernel")
    if t <= 0:
        return None
    bound = sum(step_conv_bound_s(record["cfg"], record["n_sparse"], s, train=False)
                for s in stats)
    return 100.0 * bound / t
