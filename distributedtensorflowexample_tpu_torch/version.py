# graftlint: stdlib-only
"""The port's version (the JAX package's ``version.py``)."""

__version__ = "0.1.0"
