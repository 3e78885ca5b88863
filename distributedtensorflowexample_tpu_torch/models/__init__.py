"""The port's models, by the names the trainer CLIs use (the JAX package's
``models/__init__.py`` registry, for the models ported so far)."""

import torch

from distributedtensorflowexample_tpu_torch.models.mnist_cnn import MnistCNN
from distributedtensorflowexample_tpu_torch.models.resnet import (
    ResNet20, ResNetCIFAR)
from distributedtensorflowexample_tpu_torch.models.softmax import (
    SoftmaxRegression)
from distributedtensorflowexample_tpu_torch.models.transformer_lm import (
    LM_SIZES, LM_VOCAB, TransformerLM, build_lm)
from distributedtensorflowexample_tpu_torch.parallel.mesh import ONE_RANK


def _lm_entry(size):
    # Dropout defaults to 0.0 for the LM family (trainer_lm overrides the
    # RunConfig's 0.5 CNN default).
    return lambda **kw: build_lm(size, dropout=kw.get("dropout", 0.0),
                                 dtype=kw.get("dtype", torch.bfloat16),
                                 remat=kw.get("remat", "none"))


_REGISTRY = {
    "softmax": lambda **kw: SoftmaxRegression(num_classes=10),
    "mnist_cnn": lambda **kw: MnistCNN(num_classes=10,
                                       dropout_rate=kw.get("dropout", 0.5),
                                       dtype=kw.get("dtype", torch.bfloat16)),
    # ``mesh``: the group whose global batch batch norm normalizes over.
    "resnet20": lambda **kw: ResNet20(num_classes=10,
                                      dtype=kw.get("dtype", torch.bfloat16),
                                      mesh=kw.get("mesh", ONE_RANK),
                                      remat=kw.get("remat", "none")),
    **{size: _lm_entry(size) for size in LM_SIZES},
}


def build_model(name: str, **kw):
    """``build_model(name, dropout=..., dtype=..., remat=..., mesh=...)``;
    keywords a model does not take are ignored, as in the JAX package."""
    try:
        entry = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; the PyTorch package has "
                         f"{sorted(_REGISTRY)}") from None
    return entry(**kw)


__all__ = ["LM_SIZES", "LM_VOCAB", "MnistCNN", "ResNet20", "ResNetCIFAR",
           "SoftmaxRegression", "TransformerLM", "build_lm", "build_model"]
