"""Inception-v3 (Szegedy, Vanhoucke, Ioffe, Shlens, Wojna 2016, "Rethinking
the Inception Architecture for Computer Vision", arXiv 1512.00567), with
the widths and key names of torchvision's ``inception_v3``, which the port's
``models/inception.py`` loads. Written from the paper's Table 1 and
torchvision's definition:

- torchvision's ``transform_input``: the ImageNet-normalized input mapped
  to the [-1, 1] range of its published weights, channel by channel;
- the stem: five convolutions, each bias-free with BatchNorm (eps 1e-3)
  and ReLU, with VALID 3x3/2 max pools after ``Conv2d_2b_3x3`` and
  ``Conv2d_4a_3x3``: 299 -> 149 -> 147 -> 147 -> 73 -> 73 -> 71 -> 35;
- Mixed_5b-5d (Inception-A at 35^2, pool features 32, 64, 64), Mixed_6a
  (the grid reduction to 17^2), Mixed_6b-6e (Inception-C at 17^2 with the
  factorised 1x7 / 7x1 convolutions, c7 = 128, 160, 160, 192), Mixed_7a
  (the reduction to 8^2), Mixed_7b-7c (Inception-E, the 1x3 / 3x1 splits);
  each branch's pool a 3x3/1 average over a zero padding of 1 that counts
  the zeros; the branches concatenated in torchvision's order;
- the global mean and the head ``fc``.

Departures from the published net: no dropout before ``fc`` (eval), and no
auxiliary head (train-only; ``AuxLogits.*`` is neither drawn nor run).

What every module of ``portbench/nets/`` gives, here for this family:
``state_shapes(cfg)``, ``HEAD``, ``residual_bn_keys(cfg)``, ``Plain`` and
``forward_flops(cfg)``. It imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import torch
import torch.nn.functional as F

from portbench import costs, reference as ref

HEAD = ("fc.weight", "fc.bias")   # the head's weight [classes, 2048] and bias
BN_EPS = 1e-3                     # every BatchNorm of the net (torchvision's BasicConv2d)

# (name, in, out, (kh, kw), stride, (ph, pw)) of one convolution with its BatchNorm.
Conv = Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]

STEM: List[Conv] = [
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
]
STEM_POOL_AFTER = ("Conv2d_2b_3x3", "Conv2d_4a_3x3")   # a VALID 3x3/2 max pool follows each
# (name, kind, input channels, the kind's width: A pool features, C its c7).
BLOCKS = [("Mixed_5b", "A", 192, 32), ("Mixed_5c", "A", 256, 64), ("Mixed_5d", "A", 288, 64),
          ("Mixed_6a", "B", 288, 0), ("Mixed_6b", "C", 768, 128), ("Mixed_6c", "C", 768, 160),
          ("Mixed_6d", "C", 768, 160), ("Mixed_6e", "C", 768, 192), ("Mixed_7a", "D", 768, 0),
          ("Mixed_7b", "E", 1280, 0), ("Mixed_7c", "E", 2048, 0)]
FEATURES = 2048

_1, _3, _5 = (1, 1), (3, 3), (5, 5)
_1x7, _7x1, _1x3, _3x1 = (1, 7), (7, 1), (1, 3), (3, 1)
_P0, _P1, _P2 = (0, 0), (1, 1), (2, 2)


def block_convs(kind: str, cin: int, width: int) -> List[Conv]:
    """The convolutions of one mixed block, in torchvision's order (the
    order of its state dict), names relative to the block."""
    if kind == "A":
        return [("branch1x1", cin, 64, _1, 1, _P0), ("branch5x5_1", cin, 48, _1, 1, _P0),
                ("branch5x5_2", 48, 64, _5, 1, _P2), ("branch3x3dbl_1", cin, 64, _1, 1, _P0),
                ("branch3x3dbl_2", 64, 96, _3, 1, _P1), ("branch3x3dbl_3", 96, 96, _3, 1, _P1),
                ("branch_pool", cin, width, _1, 1, _P0)]
    if kind == "B":
        return [("branch3x3", cin, 384, _3, 2, _P0), ("branch3x3dbl_1", cin, 64, _1, 1, _P0),
                ("branch3x3dbl_2", 64, 96, _3, 1, _P1), ("branch3x3dbl_3", 96, 96, _3, 2, _P0)]
    if kind == "C":
        c7 = width
        return [("branch1x1", cin, 192, _1, 1, _P0), ("branch7x7_1", cin, c7, _1, 1, _P0),
                ("branch7x7_2", c7, c7, _1x7, 1, (0, 3)), ("branch7x7_3", c7, 192, _7x1, 1, (3, 0)),
                ("branch7x7dbl_1", cin, c7, _1, 1, _P0),
                ("branch7x7dbl_2", c7, c7, _7x1, 1, (3, 0)),
                ("branch7x7dbl_3", c7, c7, _1x7, 1, (0, 3)),
                ("branch7x7dbl_4", c7, c7, _7x1, 1, (3, 0)),
                ("branch7x7dbl_5", c7, 192, _1x7, 1, (0, 3)), ("branch_pool", cin, 192, _1, 1, _P0)]
    if kind == "D":
        return [("branch3x3_1", cin, 192, _1, 1, _P0), ("branch3x3_2", 192, 320, _3, 2, _P0),
                ("branch7x7x3_1", cin, 192, _1, 1, _P0),
                ("branch7x7x3_2", 192, 192, _1x7, 1, (0, 3)),
                ("branch7x7x3_3", 192, 192, _7x1, 1, (3, 0)),
                ("branch7x7x3_4", 192, 192, _3, 2, _P0)]
    if kind == "E":
        return [("branch1x1", cin, 320, _1, 1, _P0), ("branch3x3_1", cin, 384, _1, 1, _P0),
                ("branch3x3_2a", 384, 384, _1x3, 1, (0, 1)),
                ("branch3x3_2b", 384, 384, _3x1, 1, (1, 0)),
                ("branch3x3dbl_1", cin, 448, _1, 1, _P0), ("branch3x3dbl_2", 448, 384, _3, 1, _P1),
                ("branch3x3dbl_3a", 384, 384, _1x3, 1, (0, 1)),
                ("branch3x3dbl_3b", 384, 384, _3x1, 1, (1, 0)),
                ("branch_pool", cin, 192, _1, 1, _P0)]
    raise ValueError(f"no Inception block of kind {kind!r}")


def all_convs() -> List[Conv]:
    """Every convolution of the net, full key prefixes, in state-dict order."""
    convs = list(STEM)
    for name, kind, cin, width in BLOCKS:
        convs += [(f"{name}.{n}", *rest) for n, *rest in block_convs(kind, cin, width)]
    return convs


def state_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every tensor inference reads, under torchvision's key names, in the
    order of its state dict (``AuxLogits.*`` left out): each convolution's
    ``<prefix>.conv.weight``, then its ``<prefix>.bn.*``; then the head."""
    shapes: Dict[str, tuple] = {}
    for prefix, cin, cout, k, _, _ in all_convs():
        shapes[f"{prefix}.conv.weight"] = (cout, cin, *k)
        for key in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.bn.{key}"] = (cout,)
    shapes[HEAD[0]] = (cfg["num_classes"], FEATURES)
    shapes[HEAD[1]] = (cfg["num_classes"],)
    return shapes


def residual_bn_keys(cfg: dict) -> Set[str]:
    """The scale of every BatchNorm. Inception-v3 has no residual branch, so
    the generic rule's one damping, ``init.residual_scale``, goes to every
    BatchNorm: its scale becomes s (1 + 0.1 n) while its shift stays 0.1 n.
    With s = 1 every ReLU cuts its channel near the middle of its calibrated
    distribution and the random net is chaotic: a rounding at the input
    grows about a thousandfold by the logits, and on the card the bf16
    program read up to 1.99 logit spreads from the f32 net, the fp8 control
    from 3.32. With the configuration's s = 0.05 each channel's ReLU cuts
    at its own random point, typically two standard deviations from the
    mean: the large-bias, ordered side of the random net's order-to-chaos
    transition (Poole et al. 2016, arXiv 1606.05340), where a trained net
    lies too. There the program read 0.27 to 0.92 and the control 7.16 to
    11.61 over 12 seeds."""
    return {f"{prefix}.bn.weight" for prefix, *_ in all_convs()}


class Plain(ref.PlainNet):
    """The f32 forward: the input transform, the stem, the eleven mixed
    blocks, the mean and the head."""

    def cbr(self, x: torch.Tensor, prefix: str, stride: int = 1, padding=0) -> torch.Tensor:
        """One of torchvision's ``BasicConv2d``: convolution, BatchNorm, ReLU."""
        return self.q(torch.relu(self.conv_bn(x, f"{prefix}.conv", f"{prefix}.bn", stride,
                                              padding, eps=BN_EPS)))

    def pool_branch(self, x: torch.Tensor, block: str) -> torch.Tensor:
        """A 3x3/1 average over a zero padding of 1 (the zeros counted), then
        the 1x1 ``branch_pool``."""
        return self.cbr(self.q(F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)),
                        f"{block}.branch_pool")

    def block(self, x: torch.Tensor, name: str, kind: str, cin: int, width: int) -> torch.Tensor:
        """One mixed block: its branches, concatenated in torchvision's order."""
        convs = {spec[0]: spec for spec in block_convs(kind, cin, width)}

        def branch(y, *names):
            for n in names:
                y = self.cbr(y, f"{name}.{n}", convs[n][4], convs[n][5])
            return y

        if kind == "A":
            parts = [branch(x, "branch1x1"), branch(x, "branch5x5_1", "branch5x5_2"),
                     branch(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                     self.pool_branch(x, name)]
        elif kind == "B":
            parts = [branch(x, "branch3x3"),
                     branch(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                     F.max_pool2d(x, 3, 2)]
        elif kind == "C":
            parts = [branch(x, "branch1x1"), branch(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
                     branch(x, *[f"branch7x7dbl_{i}" for i in range(1, 6)]),
                     self.pool_branch(x, name)]
        elif kind == "D":
            parts = [branch(x, "branch3x3_1", "branch3x3_2"),
                     branch(x, *[f"branch7x7x3_{i}" for i in range(1, 5)]), F.max_pool2d(x, 3, 2)]
        else:  # E: each 3x3 branch ends in a 1x3 and a 3x1 side by side
            b3 = branch(x, "branch3x3_1")
            bd = branch(x, "branch3x3dbl_1", "branch3x3dbl_2")
            parts = [branch(x, "branch1x1"), branch(b3, "branch3x3_2a"), branch(b3, "branch3x3_2b"),
                     branch(bd, "branch3x3dbl_3a"), branch(bd, "branch3x3dbl_3b"),
                     self.pool_branch(x, name)]
        return self.q(torch.cat(parts, dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(ref.IMAGENET_MEAN, dtype=x.dtype, device=x.device)[None, :, None, None]
        std = torch.tensor(ref.IMAGENET_STD, dtype=x.dtype, device=x.device)[None, :, None, None]
        x = self.q(x * (std / 0.5) + (mean - 0.5) / 0.5)   # torchvision's transform_input
        for prefix, _, _, _, stride, pad in STEM:
            x = self.cbr(x, prefix, stride, pad)
            if prefix in STEM_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        for name, kind, cin, width in BLOCKS:
            x = self.block(x, name, kind, cin, width)
        return self.linear(self.q(x.mean(dim=(2, 3))), *HEAD)


def forward_flops(cfg: dict) -> float:
    """Multiply-add operations (2 per MAC) of one image's forward through the
    94 convolutions and the head; the input transform, BatchNorm, ReLU,
    pooling and concatenation are not counted. Within a block every
    convolution but the last of a grid reduction's branch keeps the side,
    so each reads the block's input side."""
    flops = 0.0

    def conv(h, w, spec):
        _, cin, cout, (kh, kw), stride, (ph, pw) = spec
        ho, wo = costs.conv_out(h, kh, stride, ph), costs.conv_out(w, kw, stride, pw)
        return ho, wo, 2.0 * cin * cout * kh * kw * ho * wo

    h = w = cfg["resolution"]
    for spec in STEM:
        h, w, f = conv(h, w, spec)
        flops += f
        if spec[0] in STEM_POOL_AFTER:
            h, w = costs.conv_out(h, 3, 2, 0), costs.conv_out(w, 3, 2, 0)
    for _, kind, cin, width in BLOCKS:
        flops += sum(conv(h, w, spec)[2] for spec in block_convs(kind, cin, width))
        if kind in ("B", "D"):   # the grid reductions: VALID 3x3/2
            h, w = costs.conv_out(h, 3, 2, 0), costs.conv_out(w, 3, 2, 0)
    return flops + 2.0 * FEATURES * cfg["num_classes"]
