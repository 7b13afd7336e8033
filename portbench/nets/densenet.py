"""DenseNet-BC (Huang, Liu, van der Maaten, Weinberger 2017, "Densely
Connected Convolutional Networks", arXiv 1608.06993), with the widths and
key names of torchvision's ``densenet121`` / ``densenet169`` /
``densenet201``, which the port's ``models/densenet.py`` loads. The config
gives ``block_config`` (the dense layers of each block), ``growth_rate``
(k), ``bn_size`` (the bottleneck's width in units of k), ``num_init_features``
and ``compression``. Written from the paper's section 3 and Table 1:

- the stem: a 7x7/2 convolution with BatchNorm and ReLU, then a 3x3/2 max
  pool over a padding of 1;
- dense blocks; each dense layer is BatchNorm, ReLU, a 1x1 convolution to
  ``bn_size * k`` channels, BatchNorm, ReLU, a 3x3 convolution (padding 1)
  to k channels, its output concatenated onto the layer's input, so that a
  layer reads the concatenation of every earlier feature map of its block;
- between blocks a transition: BatchNorm, ReLU, a 1x1 convolution to
  ``compression`` of the channels, a 2x2/2 average pool;
- after the last block BatchNorm (``norm5``) and ReLU, the global average
  and the head ``classifier``.

Every convolution is bias-free. Departures from the paper: no dropout (eval);
the head's average is the global mean, as the port's 7x7 average pool is at
224^2, its one resolution for these nets.

What every module of ``portbench/nets/`` gives, here for this family:
``state_shapes(cfg)``, ``HEAD``, ``residual_bn_keys(cfg)``, ``Plain`` and
``forward_flops(cfg)``; and, for the dense connectivity alone, the bytes its
concatenations write (``concat_bytes(cfg, batch, itemsize)``). It imports
nothing of the program."""

from __future__ import annotations

from typing import Dict, Iterator, Set, Tuple

import torch
import torch.nn.functional as F

from portbench import costs, reference as ref

HEAD = ("classifier.weight", "classifier.bias")   # the head's weight [classes, features] and bias
BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _stem_side(cfg: dict) -> int:
    """The side after the 7x7/2 stem and the 3x3/2 max pool."""
    return costs.conv_out(costs.conv_out(cfg["resolution"], 7, 2, 3), 3, 2, 1)


def layers(cfg: dict) -> Iterator[Tuple[str, int, int]]:
    """(prefix, input channels, side) of every dense layer and transition,
    in torchvision's order; a transition's prefix ends in ``transition<i>``,
    its side the one before its pool."""
    c, side = cfg["num_init_features"], _stem_side(cfg)
    blocks = cfg["block_config"]
    for i, n in enumerate(blocks, start=1):
        for j in range(1, n + 1):
            yield f"features.denseblock{i}.denselayer{j}", c, side
            c += cfg["growth_rate"]
        if i != len(blocks):
            yield f"features.transition{i}", c, side
            c, side = int(c * cfg["compression"]), costs.conv_out(side, 2, 2, 0)


def features(cfg: dict) -> int:
    """The channels after the last dense block (1,920 for DenseNet-201)."""
    *_, (_, c, _) = layers(cfg)
    return c + cfg["growth_rate"]


def _is_transition(prefix: str) -> bool:
    return prefix.rsplit(".", 1)[1].startswith("transition")


def state_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every tensor of the config's state dict under torchvision's key
    names, in its order: ``features.conv0``, ``features.norm0``, each dense
    layer's ``norm1``, ``conv1``, ``norm2``, ``conv2``, each transition's
    ``norm``, ``conv``, then ``features.norm5`` and ``classifier``."""
    k, width = cfg["growth_rate"], cfg["bn_size"] * cfg["growth_rate"]
    shapes: Dict[str, tuple] = {"features.conv0.weight": (cfg["num_init_features"], 3, 7, 7)}

    def bn(prefix, c):
        shapes.update({f"{prefix}.{key}": (c,) for key in BN_KEYS})

    bn("features.norm0", cfg["num_init_features"])
    for p, c, _ in layers(cfg):
        if _is_transition(p):
            bn(f"{p}.norm", c)
            shapes[f"{p}.conv.weight"] = (int(c * cfg["compression"]), c, 1, 1)
        else:
            bn(f"{p}.norm1", c)
            shapes[f"{p}.conv1.weight"] = (width, c, 1, 1)
            bn(f"{p}.norm2", width)
            shapes[f"{p}.conv2.weight"] = (k, width, 3, 3)
    bn("features.norm5", features(cfg))
    shapes[HEAD[0]] = (cfg["num_classes"], features(cfg))
    shapes[HEAD[1]] = (cfg["num_classes"],)
    return shapes


def residual_bn_keys(cfg: dict) -> Set[str]:
    """None: DenseNet has no residual add, and the undamped random net
    already tells the bf16 program from the fp8 control. On the card over
    12 seeds at 224^2 the program read rel_logit_err 0.153 to 0.286 and the
    fp8 control 1.418 to 2.591, five times apart, so the generic rule's
    damping, ``init.residual_scale``, goes to no BatchNorm."""
    return set()


class Plain(ref.PlainNet):
    """The f32 forward: stem, max pool, the dense blocks and transitions,
    ``norm5``, the mean, the head."""

    def conv(self, x: torch.Tensor, key: str, stride: int = 1, padding: int = 0) -> torch.Tensor:
        """The bias-free convolution ``key`` (a key prefix)."""
        return self.q(F.conv2d(x, self.q(self.state[key + ".weight"]), None, stride, padding))

    def bn_relu(self, x: torch.Tensor, bn: str) -> torch.Tensor:
        """The eval-mode BatchNorm ``bn`` (with ``calibrating`` set, the
        batch's biased statistics, stored as its running ones, as
        ``PlainNet.conv_bn`` does), then ReLU."""
        s = self.state
        if self.calibrating:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            s[bn + ".running_mean"].copy_(mean)
            s[bn + ".running_var"].copy_(var)
        scale = s[bn + ".weight"] / torch.sqrt(s[bn + ".running_var"] + ref.BN_EPS)
        shift = s[bn + ".bias"] - s[bn + ".running_mean"] * scale
        return self.q(torch.relu(x * scale[None, :, None, None] + shift[None, :, None, None]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.q
        x = self.bn_relu(self.conv(x, "features.conv0", 2, 3), "features.norm0")
        x = F.max_pool2d(x, 3, 2, 1)
        for p, _, _ in layers(self.cfg):
            if _is_transition(p):
                y = self.conv(self.bn_relu(x, f"{p}.norm"), f"{p}.conv")
                x = q(F.avg_pool2d(y, 2, 2))
            else:
                y = self.conv(self.bn_relu(x, f"{p}.norm1"), f"{p}.conv1")
                y = self.conv(self.bn_relu(y, f"{p}.norm2"), f"{p}.conv2", padding=1)
                x = q(torch.cat([x, y], dim=1))
        x = self.bn_relu(x, "features.norm5")
        return self.linear(q(x.mean(dim=(2, 3))), *HEAD)


def forward_flops(cfg: dict) -> float:
    """Multiply-add operations (2 per MAC) of one image's forward through the
    config's convolutions and head; BatchNorm, ReLU, pooling and the
    concatenations are not counted."""
    h = costs.conv_out(cfg["resolution"], 7, 2, 3)
    flops = 2.0 * cfg["num_init_features"] * 3 * 49 * h * h   # stem
    k, width = cfg["growth_rate"], cfg["bn_size"] * cfg["growth_rate"]
    for p, c, side in layers(cfg):
        if _is_transition(p):
            flops += 2.0 * c * int(c * cfg["compression"]) * side * side
        else:
            flops += 2.0 * c * width * side * side + 2.0 * width * k * 9 * side * side
    return flops + 2.0 * features(cfg) * cfg["num_classes"]


def concat_bytes(cfg: dict, batch: int, itemsize: int) -> int:
    """The bytes the dense layers' concatenations write in one forward of
    ``batch`` images whose activations take ``itemsize`` bytes: each
    layer's output, its input and k new channels, written once."""
    return sum((c + cfg["growth_rate"]) * side * side * batch * itemsize
               for p, c, side in layers(cfg) if not _is_transition(p))
