from . import spatial  # noqa: F401
