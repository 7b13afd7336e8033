"""The bf16 differentiable path (gradient methods under bf16 autocast, as
the card runs a bf16 bundle) against the JAX package's bf16 flax model, on
the CPU: a witness that bf16's distance from f32 in the gradient maps is a
property of the network, which both packages show alike, and not a fault of
the port's bf16 arithmetic. Tolerances are stated in the test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.models.resnet_imagenet import Bottleneck as JBottleneck
from network_interpretation_imagenet_tpu.models.resnet_imagenet import ResNet as JaxResNet
from network_interpretation_imagenet_tpu.saliency import gradient as jg
from network_interpretation_imagenet_tpu_torch.data.imagenet_loc import ImagenetLocalizationDataset
from network_interpretation_imagenet_tpu_torch.models import Bottleneck, ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.saliency import gradient as g
from network_interpretation_imagenet_tpu_torch.saliency.sanity import spearman_abs
from network_interpretation_imagenet_tpu_torch.utils.convert import resnet_from_jax
from torch_port_util import flax_resnet_variables, randomize_bn

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "imagenet_loc")
RHO_TOL = 0.05   # bf16-vs-f32 Spearman |rank| correlation, port vs JAX package


def jax_noise(seed, samples, shape):
    """SmoothGrad's jax.random draws, in place of the port's."""
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                         (samples, *shape))))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the depth-101 backwards dominate this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bf16_gradients_track_jax_bf16(monkeypatch):
    """The card's bf16 differentiable path against the JAX package's bf16
    model, on the CPU at ResNet-101's depth (stages 3, 4, 23, 3; 64^2, 1000
    classes, random BatchNorm statistics). The port runs its f32-parameter
    module under bf16 autocast (as on the card); JAX builds its flax model
    with dtype=bfloat16 (as its CLIs do). bf16 moves this net's logits by
    0.6-0.7 % of max |logit| in both packages, and the gradient maps' bf16
    vs f32 Spearman |rank| correlation is a property of the net in both:
    the port's must stay within RHO_TOL of JAX's own (measured on this CPU
    over three fixture images: within 0.013, JAX's own 0.79-0.91), and the
    two packages' bf16 logits stay within twice JAX's own bf16-vs-f32
    distance of each other (measured: 0.97-1.3 times it)."""
    stages = (3, 4, 23, 3)
    bundle = ModelBundle("r", ResNet(stages, num_classes=1000, block=Bottleneck), 64, 3, 1000)
    v = flax_resnet_variables(bundle.init(3), stages)
    randomize_bn(v["params"], v["batch_stats"], np.random.RandomState(4))
    sd = resnet_from_jax(v)
    for k, u in bundle.module.state_dict().items():
        sd.setdefault(k, u)   # num_batches_tracked
    sd = {k: torch.as_tensor(np.asarray(u)) for k, u in sd.items()}
    j32, j16 = (jmodels.ModelBundle("r", JaxResNet(stage_sizes=stages, block=JBottleneck,
                                                   num_classes=1000, dtype=dt), 64, 3, 1000)
                for dt in (jnp.float32, jnp.bfloat16))

    def p16(variables, x):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return bundle.logits(variables, x)

    img = ImagenetLocalizationDataset(FIXTURE, crop=64)[0][0]
    t = int(bundle.logits(sd, torch.from_numpy(img)[None]).argmax())
    x = torch.from_numpy(img)[None]
    logits = {"p32": bundle.logits(sd, x), "p16": p16(sd, x).float(),
              "j32": j32.logits(v, img[None]), "j16": j16.logits(v, img[None])}
    logits = {k: np.asarray(u.detach().numpy() if isinstance(u, torch.Tensor) else u,
                            np.float64) for k, u in logits.items()}
    scale = np.abs(logits["j32"]).max()

    def dist(a, b):
        return np.abs(logits[a] - logits[b]).max() / scale

    assert dist("p32", "j32") <= 1e-5
    assert dist("p16", "p32") <= 2 * dist("j16", "j32")
    assert dist("p16", "j16") <= 2 * dist("j16", "j32")
    monkeypatch.setattr(g, "smoothgrad_noise", jax_noise)
    lines = [f"logits bf16 vs f32: port {dist('p16', 'p32'):.3g}, JAX {dist('j16', 'j32'):.3g}, "
             f"port bf16 vs JAX bf16 {dist('p16', 'j16'):.3g}"]
    for name, port, ref in (
            ("gradient", lambda f: g.input_gradient(f, sd, img, t),
             lambda b: jg.input_gradient(b.logits, v, img, t)),
            ("integrated", lambda f: g.integrated_gradients(f, sd, img, t, steps=4),
             lambda b: jg.integrated_gradients(b.logits, v, img, t, steps=4)),
            ("smoothgrad", lambda f: g.smoothgrad(f, sd, img, t, samples=4, seed=0),
             lambda b: jg.smoothgrad(b.logits, v, img, t, samples=4, seed=0))):
        m = {"p32": port(bundle.logits).numpy(), "p16": port(p16).numpy(),
             "j32": np.asarray(ref(j32), np.float64), "j16": np.asarray(ref(j16), np.float64)}
        rho_port = spearman_abs(m["p16"], m["p32"])
        rho_jax = spearman_abs(m["j16"], m["j32"])
        rho_across = spearman_abs(m["p16"], m["j16"])
        assert abs(rho_port - rho_jax) <= RHO_TOL, (name, rho_port, rho_jax)
        assert rho_across >= min(rho_port, rho_jax) - RHO_TOL, (name, rho_across)
        lines.append(f"{name}: Spearman bf16 vs f32 port {rho_port:.4f}, JAX {rho_jax:.4f}; "
                     f"port bf16 vs JAX bf16 {rho_across:.4f}")
    print("\n".join(lines))
