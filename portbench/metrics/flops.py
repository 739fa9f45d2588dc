"""The model FLOPs of a DFedPGP round, from the shapes: products only
(convolutions and matrix products; norms, activations and the optimizer
are not counted), and no recomputation (the remat replay is not work the
model asks for).  A personal (v) step differentiates only the personal
part, so its backward stops at the head; a shared (u) step
differentiates everything but the head's weights."""
from __future__ import annotations


def conv(batch: int, side: int, k: int, cin: int, cout: int) -> float:
    """A SAME k x k convolution over batch x side x side positions."""
    return 2.0 * batch * side * side * k * k * cin * cout


def cnn_round(n: int, k_v: int, k_u: int, batch: int, image: int,
              channels: int, widths: tuple, d_feature: int,
              n_classes: int) -> float:
    """n clients' k_v personal and k_u shared steps of the CNN: conv 3x3
    -> pool -> conv 3x3 -> pool -> dense -> head."""
    c1, c2 = widths
    f1 = conv(batch, image, 3, channels, c1)
    f2 = conv(batch, image // 2, 3, c1, c2)
    fd = 2.0 * batch * c2 * (image // 4) ** 2 * d_feature
    fh = 2.0 * batch * d_feature * n_classes
    fwd = f1 + f2 + fd + fh
    # weight gradients of conv1, conv2, dense; input gradients of the
    # head, dense and conv2 (none into the images)
    bwd_u = f1 + 2 * f2 + 2 * fd + fh
    bwd_v = fh                      # the head's weight gradient
    return n * (k_v * (fwd + bwd_v) + k_u * (fwd + bwd_u))


def lm_round(n: int, k_v: int, k_u: int, batch: int, seq: int, layers: int,
             d: int, heads: int, kv_heads: int, d_ff: int,
             vocab: int) -> float:
    """n clients' k_v personal and k_u shared steps of a dense decoder on
    batch x seq tokens: 6 N per trained token with N the matrix weights
    (attention, SwiGLU and the head; the embedding lookup is no product)
    plus PaLM's attention term 12 L d S (arXiv:2204.02311, App. B); a
    personal step counts the forward (2 N + 4 L d S) and the head's
    backward (its input and weight gradients, 4 d V)."""
    hd = d // heads
    n_w = layers * (2 * d * heads * hd + 2 * d * kv_heads * hd
                    + 3 * d * d_ff) + d * vocab
    tokens = batch * seq
    u = (6.0 * n_w + 12.0 * layers * d * seq) * tokens
    v = (2.0 * n_w + 4.0 * layers * d * seq + 4.0 * d * vocab) * tokens
    return n * (k_v * v + k_u * u)
