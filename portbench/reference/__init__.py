"""The benchmark's plain reference: a frozen float32 copy of the port's
plain paths (``srcnn/``), the scene readers and the Loader's order worked
out again (``batches.py``), the rulebook counts (``stats.py``) and the
comparisons that decide ``correct`` (``check.py``). Nothing here imports
the port, the JAX package or JAX."""


def precision_mode(mode: str) -> None:
    """Switch the reference between float32 and the fp8 control."""
    from .srcnn import precision
    precision.set_mode(mode)
