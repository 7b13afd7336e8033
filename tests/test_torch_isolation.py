"""The port stands alone: it imports neither jax nor the JAX package.

A subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib`` and
``network_interpretation_imagenet_tpu`` imports every module of the port
and runs the CPU slice end to end (segment, predict, masked evals,
heatmap, localization score) and one small BO explanation, in the spirit of
tests/test_weights_artifact.py's torch-blocked run."""

import os
import pkgutil
import re
import subprocess
import sys

import network_interpretation_imagenet_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "network_interpretation_imagenet_tpu")

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
    localization_score, random_window_saliency)
from network_interpretation_imagenet_tpu_torch.segment.common import segment_image

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
    assert "network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain" in modules
