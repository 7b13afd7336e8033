"""The harness's operation and byte counts against hand counts, and the
ResNet family's forward operations pinned to what they read before the
family moved to ``portbench/nets/bottleneck_resnet.py``."""

import pytest

from portbench import costs
from portbench.spec import load_json, net, ROOT

RESNET101 = load_json(f"{ROOT}/portbench/configs/resnet101-224-bf16.json")
WIDE50 = load_json(f"{ROOT}/portbench/configs/wide_resnet50_2-224-bf16.json")
RESNET = net(RESNET101)


def hand_flops(blocks, width_mult):
    """Layer by layer at 224^2: stem 7x7/2 to 112^2, max-pool to 56^2, then
    per stage (side after the stage's stride, in, inner, out, blocks)."""
    total = 2 * 64 * 3 * 7 * 7 * 112 * 112
    stages = ((56, 56, 64, 64 * width_mult, 256, blocks[0]),
              (56, 28, 256, 128 * width_mult, 512, blocks[1]),
              (28, 14, 512, 256 * width_mult, 1024, blocks[2]),
              (14, 7, 1024, 512 * width_mult, 2048, blocks[3]))
    for side_in, side, cin, inner, out, n in stages:
        # first block: 1x1 at the input side, 3x3 (stride here) and 1x1, projection
        total += 2 * cin * inner * side_in ** 2 + 2 * 9 * inner * inner * side ** 2
        total += 2 * inner * out * side ** 2 + 2 * cin * out * side ** 2
        # the other n - 1 blocks, all at the stage's side
        total += (n - 1) * (2 * out * inner + 2 * 9 * inner * inner + 2 * inner * out) * side ** 2
    return total + 2 * 2048 * 1000


def test_forward_flops_resnet101():
    assert RESNET.forward_flops(RESNET101) == hand_flops((3, 4, 23, 3), 1)
    # 15.60 GFLOP: convolutions and head only (bench.py's 15.66 counts more)
    assert round(RESNET.forward_flops(RESNET101) / 1e9, 2) == 15.60


def test_forward_flops_wide_resnet50_2():
    assert RESNET.forward_flops(WIDE50) == hand_flops((3, 4, 6, 3), 2)
    assert round(RESNET.forward_flops(WIDE50) / 1e9, 1) == 22.8


@pytest.mark.parametrize("config, flops", [("resnet101-224-bf16", 15_602_810_880),
                                           ("wide_resnet50_2-224-bf16", 22_796_042_240)])
def test_forward_flops_pinned(config, flops):
    cfg = load_json(f"{ROOT}/portbench/configs/{config}.json")
    assert "net" not in cfg and net(cfg).__name__ == "portbench_net_bottleneck_resnet"
    assert net(cfg).forward_flops(cfg) == flops


def test_float32_bounds():
    """The f32 instance's chains: 4-byte activations and weights against
    the CUDA cores' 67 TFLOP/s; B1 writes 4-byte masked images."""
    flops, nbytes = costs.b2_costs(14, 1024, 256, 22, 256, itemsize=4)
    bf16 = costs.b2_costs(14, 1024, 256, 22, 256)
    m = 256 * 14 * 14
    assert flops == bf16[0]
    assert nbytes == m * 1024 * 2 * 4 + 22 * ((1024 * 256 * 2 + 9 * 256 * 256) * 4
                                              + (256 + 256 + 1024) * 4)
    want = sum(max(f / 67e12, b / 3.35e12) * 1e3 for f, b in (
        costs.b2_costs(h, c, p, n, 256, 4) for h, c, p, n in RESNET101["chains"]))
    assert costs.b2_bound_ms(RESNET101["chains"], 256, "float32") == pytest.approx(want)
    assert costs.b2_bound_ms(RESNET101["chains"], 256, "float32") == pytest.approx(48.393, abs=5e-4)
    assert costs.b1_bound_ms(224, 224, 3, 256, 4) == pytest.approx(
        costs.b1_bytes(224, 224, 3, 256, 4) / 3.35e12 * 1e3)


def test_b2_costs_stage3_at_256():
    flops, nbytes = costs.b2_costs(14, 1024, 256, 22, 256)
    m = 256 * 14 * 14
    per_block = 2 * m * 1024 * 256 + 2 * 9 * m * 256 * 256 + 2 * m * 256 * 1024
    assert flops == 22 * per_block
    weights = 1024 * 256 * 2 + 9 * 256 * 256 * 2 + 256 * 1024 * 2
    biases = (256 + 256 + 1024) * 4
    assert nbytes == m * 1024 * 2 * 2 + 22 * (weights + biases)
    assert costs.chain_bound_ms(flops, nbytes) == pytest.approx(flops / 989e12 * 1e3)


def test_b2_bound_of_a_resnet101_forward():
    """A ResNet-101 forward of 256: 3.278 ms of operations over the four
    chains, and stage 1's chain is bound by its bytes (0.2455 ms against
    0.2261 of operations), so the sum of the chains' bounds is 3.298 ms."""
    flops = sum(costs.b2_costs(h, c, p, n, 256)[0] for h, c, p, n in RESNET101["chains"])
    assert flops / 989e12 * 1e3 == pytest.approx(3.278, abs=5e-4)
    stage1 = costs.b2_costs(*RESNET101["chains"][0], 256)
    assert stage1[1] / 3.35e12 > stage1[0] / 989e12
    assert costs.b2_bound_ms(RESNET101["chains"], 256) == pytest.approx(3.2977, abs=1e-4)


def test_b1_bytes_at_224():
    k = 256
    want = 224 * 224 * 3 * 4 + 224 * 224 * 4 + k * 4 + k * 224 * 224 * 3 * 2
    assert costs.b1_bytes(224, 224, 3, k) == want
    assert costs.b1_bound_ms(224, 224, 3, k) == pytest.approx(want / 3.35e12 * 1e3)
