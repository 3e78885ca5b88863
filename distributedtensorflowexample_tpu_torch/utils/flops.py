"""Train-step FLOPs counted from the layer shapes: the numerator of the
port's MFU and of ``tools.bench``'s ``roofline_cost_per_step``.

A layer's multiply-adds (MACs) for one row are its output positions times
its output channels times the products that make each output (kernel
area times input channels; a dense layer's ``in x out``).  One training
step on one row then costs, over the products only,

* ``2 x MACs`` for the forward pass,
* ``2 x MACs`` for the weight gradients, and
* ``2 x MACs`` for the input gradients of every layer but the first,
  whose input is the data and needs none.

Bias adds, activations, pooling, batch norm, the loss and the optimizer
apply are not counted: they are a few operations an element against
hundreds a product (``MnistCNN``'s 13,883,904 MACs a row are 627,200 +
10,035,200 + 3,211,264 + 10,240, its two convolutions, ``fc1`` and the
head).

This replaces the JAX package's XLA ``cost_analysis`` figure, which has
no PyTorch counterpart; on XLA:CPU the JAX package's two counts of one
compiled ``mnist_cnn`` step at B=8 disagree by two orders of magnitude
(``cost_analysis`` 617,842,304; ``flops_audit`` 6,526,112, no
convolution rows), so neither is an oracle for this one.

The transformer LM (``lm_tiny``, ``lm_small``, ``lm_base``:
``models/transformer_lm.LM_SIZES``, vocabulary 250, the head tied to the
embedding) is counted per sequence of ``seq_len`` tokens, so a "row" is
one sequence.  Per token and block: the QKV projection (``d x 3d``), the
output projection (``d x d``), the two FFN products (``d x d_ff`` each)
and the attention's score and value products over the whole ``T x T``
square (``T x d`` each a token: the causal mask is applied to the
scores, not skipped); then the head (``d x vocab``).  The embedding
lookup is a gather and is not counted.  What the LM adds to the
convention above: every product also pays its input gradient, the first
one included, since the first block's input comes from the trainable
embedding; so the LM's step is ``6 x MACs``.  In the attention products
both operands are activations, and the "weight" gradient is the one into
the keys (or the values): the same MACs.  This equals the JAX package's
``flops_audit`` (dot rows: ``2 x`` output elements ``x`` contracted
elements) of its compiled LM step exactly
(``tests/test_torch_bench_lm.py``).
"""

from __future__ import annotations

#: The models whose layer shapes this module knows.
MODELS = ("softmax", "mnist_cnn", "resnet20", "lm_tiny", "lm_small",
          "lm_base")


def _conv(out_hw: int, kernel: int, cin: int, cout: int) -> int:
    """MACs of one square convolution with ``out_hw x out_hw`` outputs."""
    return out_hw * out_hw * cout * kernel * kernel * cin


def _resnet_layers(blocks_per_stage: int = 3,
                   widths: tuple = (16, 32, 64), size: int = 32,
                   num_classes: int = 10) -> list:
    """ResNet-20's products (``models/resnet.py``): the 3x3 stem, then
    per block two 3x3 convolutions (the first strided 2 into stages 1
    and 2, flax ``SAME``: ``ceil(size / 2)`` outputs) and, where the
    shape changes, a strided 1x1 projection; the pooled head."""
    layers = [("conv_init", _conv(size, 3, 3, widths[0]))]
    filters = widths[0]
    for stage, width in enumerate(widths):
        for block in range(blocks_per_stage):
            stride = 2 if stage > 0 and block == 0 else 1
            size = -(-size // stride)
            name = f"stage{stage}_block{block}"
            layers.append((f"{name}.conv1", _conv(size, 3, filters, width)))
            layers.append((f"{name}.conv2", _conv(size, 3, width, width)))
            if stride != 1 or filters != width:
                layers.append((f"{name}.proj", _conv(size, 1, filters,
                                                     width)))
            filters = width
    layers.append(("logits", filters * num_classes))
    return layers


def _lm_layers(size: str, seq_len: int | None) -> list:
    """The LM's products for one sequence of ``seq_len`` tokens (the
    shipped splits' ``data/lm.LM_SEQ_LEN`` by default), per block and then
    the tied head (module docstring)."""
    from distributedtensorflowexample_tpu_torch.data.lm import LM_SEQ_LEN
    from distributedtensorflowexample_tpu_torch.models.transformer_lm import (
        LM_SIZES, LM_VOCAB)
    dims = LM_SIZES[size]
    t = LM_SEQ_LEN if seq_len is None else int(seq_len)
    d, ff = dims["d_model"], dims["d_ff"]
    layers = []
    for i in range(dims["n_layers"]):
        layers += [(f"block{i}.qkv", t * d * 3 * d),
                   (f"block{i}.scores", t * t * d),
                   (f"block{i}.values", t * t * d),
                   (f"block{i}.attn_out", t * d * d),
                   (f"block{i}.mlp_in", t * d * ff),
                   (f"block{i}.mlp_out", t * ff * d)]
    layers.append(("head", t * d * LM_VOCAB))
    return layers


def layer_macs(model: str,
               seq_len: int | None = None) -> list[tuple[str, int]]:
    """``[(layer, multiply-adds for one row)]`` in forward order (an LM's
    row: one sequence of ``seq_len`` tokens)."""
    if model.startswith("lm_") and model in MODELS:
        return _lm_layers(model, seq_len)
    if model == "softmax":
        return [("logits", 28 * 28 * 10)]
    if model == "mnist_cnn":
        return [("conv1", _conv(28, 5, 1, 32)),
                ("conv2", _conv(14, 5, 32, 64)),
                ("fc1", 7 * 7 * 64 * 1024),
                ("logits", 1024 * 10)]
    if model == "resnet20":
        return _resnet_layers()
    raise ValueError(f"no layer shapes for model {model!r} (one of "
                     f"{MODELS})")


def forward_macs(model: str, seq_len: int | None = None) -> int:
    """Multiply-adds of one row's forward pass."""
    return sum(m for _, m in layer_macs(model, seq_len))


def train_flops_per_row(model: str, seq_len: int | None = None) -> int:
    """FLOPs of one row's training step: forward, weight gradients, and
    the input gradients of every layer but the first (of every layer, the
    first included, for the LM)."""
    macs = [m for _, m in layer_macs(model, seq_len)]
    first_input = model.startswith("lm_")
    return 4 * sum(macs) + 2 * sum(macs[0 if first_input else 1:])


def train_flops_per_step(model: str, global_batch: int,
                         seq_len: int | None = None) -> int:
    """FLOPs of one training step over ``global_batch`` rows (an LM's
    rows are sequences of ``seq_len`` tokens)."""
    return train_flops_per_row(model, seq_len) * int(global_batch)
