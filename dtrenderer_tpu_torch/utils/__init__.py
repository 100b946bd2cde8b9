"""Helpers shared by the port's modules."""


def tensor_version(t):
    """t's version counter (it moves with every in-place edit of t or of a
    view of it), or None for an inference tensor, which keeps none."""
    try:
        return t._version
    except RuntimeError:
        return None
