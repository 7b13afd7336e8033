"""The port stands alone: it imports neither jax nor the JAX package (nor
flax or msgpack, which the weights artifact's format comes from).

A subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``,
``network_interpretation_imagenet_tpu``, ``flax`` and ``msgpack`` imports
every module of the port
and runs the CPU slice end to end (segment, predict, masked evals,
heatmap, localization score), one small BO explanation, the knockout,
threshold-search and multi-image paths, both GP surrogates, a
checkpoint round trip, one attribution of each kind (an input
gradient, an occlusion map, a fidelity AUC, a SLIC segmentation), and the
val-set sweeps (window with a journal, BO, attribution) and the sweep CLI,
a zoo net's masked evals, a weights artifact written and read back, and
the MNIST generator from it, in the spirit of tests/test_weights_artifact.py's torch-blocked run."""

import os
import pkgutil
import re
import subprocess
import sys

import network_interpretation_imagenet_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "network_interpretation_imagenet_tpu", "flax", "msgpack")

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked in this test: " + name)
        return None

sys.meta_path.insert(0, _Blocker())

import numpy as np
import torch
import network_interpretation_imagenet_tpu_torch as port

for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

from network_interpretation_imagenet_tpu_torch.config import BOConfig, SegmentConfig
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, ResNet
from network_interpretation_imagenet_tpu_torch.saliency.bo_pipeline import bo_window_saliency
from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8
from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
from network_interpretation_imagenet_tpu_torch.saliency.pipeline import (
    knockout_saliency, localization_score, minimal_mask_search, random_window_saliency)
from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
from network_interpretation_imagenet_tpu_torch.gp import kron, variational
from network_interpretation_imagenet_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
import tempfile
tmp = tempfile.mkdtemp()

rng = np.random.RandomState(0)
image = np.zeros((32, 32, 3), np.float32)
image[4:20, 6:26] = rng.randn(3)
image += rng.randn(32, 32, 3).astype(np.float32) * 0.05
segments = segment_image(to_display_uint8(torch.from_numpy(image)).numpy(),
                         SegmentConfig(min_size=5))
bundle = ModelBundle("r", ResNet((1, 2, 1, 2), num_classes=10), 32, 3, 10)
engine = SaliencyEngine(bundle, bundle.init(0), mask_batch=8,
                        compute_dtype=torch.float32, device="cpu")
out = random_window_saliency(engine, image, segments, num_samples=12, seed=0)
iou, box = localization_score(out.heatmap, (6, 4, 20, 16))
assert out.heatmap.shape == (32, 32) and np.isfinite(out.heatmap).all()
assert 0.0 <= iou <= 1.0
bo_out, trace = bo_window_saliency(engine, image, segments, BOConfig(n_iters=2, n_pre_samples=2))
assert len(trace.xp) == 4 and np.isfinite(bo_out.heatmap).all()
ko = knockout_saliency(engine, image, segments, num_samples=6, num_knockout=2, seed=0)
thr, keep, levels = minimal_mask_search(engine, image, ko.heatmap, int(ko.eval.preds[0]))
assert ko.masks.shape == (6, 32, 32) and len(keep) == len(levels)
multi = engine.eval_window_masks_multi(np.stack([image, image]), np.stack([segments] * 2),
                                       np.stack([out.firsts[:3]] * 2), [out.width] * 2, [0, 1])
assert [len(r.survived) for r in multi] == [3, 3]
params, losses = kron.fit_adam(out.heatmap, iters=3, device="cpu")
mean, var = kron.posterior(params, out.heatmap, device="cpu")
xs = np.stack(np.meshgrid(np.arange(32), np.arange(32), indexing="ij"), -1).reshape(-1, 2)
vgp, vlosses = variational.fit_adam(variational.init_model(32, 4, 4.0, device="cpu"),
                                    xs.astype(np.float32), (out.heatmap.ravel() > 0) * 1.0,
                                    iters=3)
probs = variational.predict_proba(vgp, xs.astype(np.float32))
save_checkpoint({"mean": mean}, tmp, is_best=True)
assert np.array_equal(restore_checkpoint(tmp, "model_best")["mean"], mean.numpy())
assert np.isfinite(var.numpy()).all() and np.isfinite(probs.numpy()).all()
from network_interpretation_imagenet_tpu_torch.saliency import gradient
from network_interpretation_imagenet_tpu_torch.saliency.eval_metrics import deletion_insertion_auc
grad = gradient.input_gradient(bundle.logits, engine.variables, image, 3)
occ = gradient.occlusion_map(engine.folded_logits, engine.variables, image, 3, batch=16,
                             compute_dtype=torch.float32)
assert grad.shape == occ.shape == (32, 32) and float(grad.max()) > 0
fid = deletion_insertion_auc(engine, image, grad.numpy(), 3, steps=4)
assert 0.0 <= fid["deletion_auc"] <= 1.0 and 0.0 <= fid["insertion_auc"] <= 1.0
slic_seg = segment_image(to_display_uint8(torch.from_numpy(image)).numpy(),
                         SegmentConfig(method="slic", n_segments=9), device="cpu")
assert slic_seg.shape == (32, 32) and slic_seg.max() >= 1
from network_interpretation_imagenet_tpu_torch.saliency import sweep
from network_interpretation_imagenet_tpu_torch.saliency.journal import SweepJournal
from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep_cli
items = [(image, None, (6, 4, 20, 16)), (image[::-1].copy(), None, None)]
journal = SweepJournal(tmp + "/j.jsonl", config={"k": 6})
swept = sweep.saliency_sweep(engine, items, SegmentConfig(min_size=5), num_mask_samples=6,
                             image_batch=2, journal=journal)
journal.close()
bo_swept = sweep.bo_saliency_sweep(engine, items, SegmentConfig(min_size=5),
                                   BOConfig(n_iters=1, n_pre_samples=2), image_batch=2)
attr_swept = sweep.attribution_sweep(engine, items, method="gradient", image_batch=2)
assert [r.images_explained for r in (swept, bo_swept, attr_swept)] == [2, 2, 2]
sweep_cli.main(["--synthetic", "--num-images", "1", "--num_mask_samples", "4",
                "--mask-batch", "4", "--dtype", "float32", "--device", "cpu",
                "--out", tmp + "/cli"])
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.utils import convert
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_mnist as gen
zoo = create_model("squeezenet1_1", num_classes=10)
zoo_engine = SaliencyEngine(zoo, zoo.init(0), mask_batch=8, compute_dtype=torch.float32,
                            device="cpu")
assert len(zoo_engine.eval_window_masks(image, segments, out.firsts[:5], out.width, 1).preds) == 5
mnist = create_model("mnist_cnn", "mnist")
sd = mnist.init(0)
convert.save_weights_artifact(convert.jax_variables(sd, mnist.module), tmp + "/w",
                              meta={"arch": "mnist_cnn"})
back = convert.from_jax(convert.load_weights_artifact(tmp + "/w")[0], mnist.module)
assert all(torch.equal(back[k], sd[k]) for k in sd)
payload, _ = gen.compute(gen.parse_args(["--synthetic", "--ckpt", tmp + "/w", "--device", "cpu",
                                         "--num_mask_samples", "8", "--out", tmp + "/g"]))
assert payload["num_mask_samples"] == 8
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("ISOLATED_OK", out.num_segments, len(out.eval.survived))
"""


def test_port_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax|.*network_interpretation_imagenet_tpu\.)",
                         re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in ("ops.bottleneck_chain", "gp.kron", "gp.variational", "utils.checkpoint",
                 "cli.generate_gp_training_data_imagenet", "cli.gp_superpixel_data_imagenet",
                 "cli.gp_regression", "cli.gp_classification", "saliency.eval_metrics",
                 "saliency.gradient", "saliency.xrai", "saliency.learned_mask",
                 "saliency.sanity", "segment.slic", "ops.resize", "cli.occlusion_saliency",
                 "cli.compare_saliency_methods", "cli.attribution_sanity", "saliency.sweep",
                 "saliency.journal", "cli.saliency_sweep", "data.prefetch", "utils.logging",
                 "utils.meters", "models.mnist_cnn", "models.resnet_cifar", "models.densenet",
                 "models.vgg", "models.alexnet", "models.squeezenet", "models.inception",
                 "models.googlenet", "models.mobilenet", "models.shufflenet", "models.mnasnet",
                 "data.loaders", "utils.convert", "cli.convert_checkpoint",
                 "cli.generate_gp_training_data_mnist", "cli.generate_gp_training_data_cifar"):
        assert f"network_interpretation_imagenet_tpu_torch.{name}" in modules, name
