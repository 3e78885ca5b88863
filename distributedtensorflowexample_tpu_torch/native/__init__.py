"""Native (C++) host runtime of the input path (the JAX package's
``native/``): ``dataio.cc`` with ctypes bindings in ``loader.py`` —
dataset parsing, the parallel batch gather and the fused gather plus
crop and flip, on the host.  Numpy fallbacks give the same arrays when
the toolchain is absent (``available()`` is then False)."""

from distributedtensorflowexample_tpu_torch.native.loader import (
    augment_crop_flip, available, gather, gather_augment, omp_threads,
    parse_cifar, parse_idx_images, parse_idx_labels)

__all__ = [
    "augment_crop_flip",
    "available",
    "gather",
    "gather_augment",
    "omp_threads",
    "parse_cifar",
    "parse_idx_images",
    "parse_idx_labels",
]
