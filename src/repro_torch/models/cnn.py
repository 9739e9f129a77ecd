"""The paper's CNN (§2.4) in PyTorch: three conv layers (16, 12, 10
filters, 3x3), two max-pool layers, ReLU hidden activations, for 28x28
grayscale inputs and 10 classes (port of `repro.models.cnn`).

  conv1 16@3x3 -> ReLU -> maxpool 2x2
  conv2 12@3x3 -> ReLU -> maxpool 2x2
  conv3 10@3x3 -> ReLU -> flatten -> dense 10 (logits)

Parameters and images keep the reference layout at every public
function: conv kernels HWIO, the dense kernel (in, out), images NHWC.
The convolutions permute to NCHW/OIHW inside, and the features are
permuted back to (h, w, c) order before the flatten that feeds `head`,
so the same parameters give the same logits as the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, init_dense


def _init_conv(generator, kh, kw, cin, cout, dtype=torch.float32):
    fan_in = kh * kw * cin
    return {"kernel": (torch.randn((kh, kw, cin, cout), generator=generator)
                       / math.sqrt(fan_in)).to(dtype),
            "bias": torch.zeros((cout,), dtype=dtype)}


def _conv(params, x):
    """x: (B, cin, H, W); params['kernel']: HWIO. Stride 1, SAME."""
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)     # OIHW
    return F.conv2d(x, w, params["bias"].to(x.dtype), padding="same")


def init_cnn(generator, num_classes=10, in_channels=1, image_size=28,
             dtype=torch.float32):
    """Random CNN parameters drawn from `generator` (a CPU
    torch.Generator) with the reference's distributions. The draws are
    not jax.random's: parity tests inject the reference's parameters
    through `repro_torch.convert.params_from_jax` instead."""
    p = {
        "conv1": _init_conv(generator, 3, 3, in_channels, 16, dtype),
        "conv2": _init_conv(generator, 3, 3, 16, 12, dtype),
        "conv3": _init_conv(generator, 3, 3, 12, 10, dtype),
    }
    feat = image_size // 4              # two 2x2 pools
    p["head"] = init_dense(generator, feat * feat * 10, num_classes,
                           use_bias=True, dtype=dtype)
    return p


def cnn_apply(params, images):
    """images: (B, 28, 28, 1) float -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(params["conv1"], x)), 2)
    x = F.max_pool2d(F.relu(_conv(params["conv2"], x)), 2)
    x = F.relu(_conv(params["conv3"], x))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC flatten
    return dense(params["head"], x).float()


def _nll_acc(logits, labels):
    """Mean NLL and accuracy over the batch axis (the last but one)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    acc = (logits.argmax(-1) == labels).float()
    return nll.mean(-1), acc.mean(-1)


def cnn_loss(params, batch):
    """batch: {'image': (B,28,28,1), 'label': (B,)} -> (loss, accuracy)."""
    return _nll_acc(cnn_apply(params, batch["image"]), batch["label"])


# ---------------------------------------------------------------------------
# stacked-federation forward path (vectorized engine)
# ---------------------------------------------------------------------------
# Every parameter leaf carries a leading client axis C and every client has
# its OWN weights. The client axis is folded into the channels and each
# layer is one grouped convolution (groups=C): a library call for the work
# the reference leaves to XLA, outside any Pallas kernel. Activations stay
# in the folded (B, C*ch, H, W) layout from the first conv to the head.

def _conv_stacked(params, x):
    """x: (B, C*cin, H, W); params['kernel']: (C, kh, kw, cin, cout)."""
    k = params["kernel"].to(x.dtype)
    C, kh, kw, cin, cout = k.shape
    w = k.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, kh, kw)
    b = params["bias"].to(x.dtype).reshape(C * cout)
    return F.conv2d(x, w, b, padding="same", groups=C)


def cnn_apply_stacked(params, images):
    """Per-client forward: (C, B, 28, 28, 1) -> logits (C, B, 10) under
    per-client parameters (leading C axis on every leaf)."""
    C, B, H, W, cin = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(B, C * cin, H, W)
    x = F.max_pool2d(F.relu(_conv_stacked(params["conv1"], x)), 2)
    x = F.max_pool2d(F.relu(_conv_stacked(params["conv2"], x)), 2)
    x = F.relu(_conv_stacked(params["conv3"], x))
    h, w = x.shape[2], x.shape[3]
    x = (x.reshape(B, C, -1, h, w).permute(1, 0, 3, 4, 2)
         .reshape(C, B, -1))                                # per-client NHWC
    head = params["head"]
    y = torch.bmm(x, head["kernel"].to(x.dtype))
    return (y + head["bias"].to(x.dtype)[:, None, :]).float()


def cnn_loss_stacked(params, batch):
    """Per-client loss/accuracy: batch leaves (C, B, ...) -> ((C,), (C,)).
    Summing the returned losses and differentiating yields exactly the
    per-client gradients (clients are independent — no cross terms)."""
    return _nll_acc(cnn_apply_stacked(params, batch["image"]),
                    batch["label"])
