"""The port's parallel/ (mesh, multihost, sharded_engine) and every
explanation function's ``mesh=`` against the JAX package's, f32 on the CPU.

The port's mesh is a process group (one process per device); the JAX
package's is a set of devices in one process (the tests' 8 virtual CPU
devices). Both run the same sharded computations, so at any world size the
outcomes must equal the unsharded ones:

* in-process, a world of one on gloo (``make_mesh`` starts it; a fixture
  destroys it afterwards): the four sharded evals against JAX's on
  ``make_mesh(jax.devices()[:2])``, the mesh's shapes, the rank-result
  protocol, ``merge_sweep_metrics`` against JAX's on the same dicts, and
  the CLI's exit 2 without a coordinator;
* one spawned 2-rank gloo world (tests/torch_parallel_worker.py, which
  imports only the port; the JAX references are computed here): the
  sharded evals, BO with its proposals and with its images sharded (JAX's
  traces as the draws), both batched GP fits, the batched attributions, a
  --multihost strided sweep and --data-parallel sweeps against the
  single-process sweep, and --multihost with --data-parallel failing every
  image, as the JAX package does (its mesh then spans every process's
  devices, and no image's result can be fetched; pinned from a run of the
  JAX CLI on two CPU processes).

Tolerances: survive labels, predictions and counts equal; probabilities
within 1e-5 (tests/test_parallel.py's); GP losses rtol 1e-4, posteriors
1e-4 of their scale, classification probabilities 2e-4 (the bounds of
tests/test_torch_gp_surrogates.py); attribution maps 1e-4 of max |JAX map|
(tests/test_torch_attribution.py's MAP_TOL). Every spawn ends within its
``communicate`` timeout, so a hang fails one test."""

import argparse
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import saliency_sweep as jcli
from network_interpretation_imagenet_tpu.config import BOConfig as JBOConfig
from network_interpretation_imagenet_tpu.gp import kron as jkron
from network_interpretation_imagenet_tpu.gp import variational as jvar
from network_interpretation_imagenet_tpu.parallel import make_mesh as jmake_mesh
from network_interpretation_imagenet_tpu.parallel import multihost as jmultihost
from network_interpretation_imagenet_tpu.parallel import sharded_engine as jsharded
from network_interpretation_imagenet_tpu.saliency import bo_pipeline as jbo
from network_interpretation_imagenet_tpu.saliency import gradient as jgradient
from network_interpretation_imagenet_tpu.saliency.engine import SaliencyEngine as JaxEngine
from network_interpretation_imagenet_tpu.saliency.sweep import SweepResult as JSweepResult
from network_interpretation_imagenet_tpu_torch import parallel
from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as cli
from network_interpretation_imagenet_tpu_torch.config import DATASETS, SegmentConfig
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.parallel import mesh as pmesh
from network_interpretation_imagenet_tpu_torch.parallel import multihost
from network_interpretation_imagenet_tpu_torch.saliency import sweep
from network_interpretation_imagenet_tpu_torch.saliency.sweep import SweepResult
from network_interpretation_imagenet_tpu_torch.utils import convert
from torch_parallel_worker import _engine
from torch_port_util import calibrate_bn

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PROB_TOL = 1e-5
MAP_TOL = 1e-4
SPAWN_TIMEOUT_S = 240
ONE = 2              # the image of the single-image calls: a mix of its masks survives
KINDS = ("window", "window_multi", "knockout", "knockout_multi")
BASE = ["--synthetic", "--arch", "mnist_cnn", "--dataset", "mnist", "--dtype", "float32",
        "--device", "cpu", "--mask-batch", "16", "--num_mask_samples", "16",
        "--segmenter", "slic", "--n_segments", "16"]   # FH finds one segment at 28^2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world1():
    """A world of one on gloo, started by ``make_mesh`` and destroyed after."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def _blocks(h, w, size):
    hh, ww = np.mgrid[0:h, 0:w]
    return ((hh // size) * -(-w // size) + ww // size).astype(np.int32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The MNIST CNN, inputs for every call and the JAX references on a
    2-device JAX mesh. The weights: a seeded init with its BatchNorm
    statistics measured on the CLI's first 4 synthetic images and 4 random
    ones (random statistics saturate the softmax on one class, and every
    mask would survive), as the JAX package's variables, written as a
    weights artifact; the port's net is built from that artifact through
    ``from_jax``. A mix of masks survives."""
    d = tmp_path_factory.mktemp("parallel")
    bundle = create_model("mnist_cnn", "mnist", dtype=torch.float32)
    synthetic = [x for x, _, _ in cli._synthetic_dataset(argparse.Namespace(seed=0),
                                                         DATASETS["mnist"], 4)]
    cal = np.concatenate([np.stack(synthetic),
                          np.random.RandomState(1).rand(4, 28, 28, 1).astype(np.float32)])
    jvars = convert.jax_variables(calibrate_bn(bundle, bundle.init(1), cal), bundle.module)
    convert.save_weights_artifact(jvars, str(d / "art"), {"arch": "mnist_cnn"})
    jbundle = jmodels.create_model("mnist_cnn", "mnist")
    engine = _engine(str(d / "art"))
    jengine = JaxEngine(jbundle, jvars, mask_batch=16, compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 28, 28, 1).astype(np.float32)
    segs = np.stack([_blocks(28, 28, s) for s in (7, 6, 7)])
    inp = {
        "image": imgs[ONE], "seg": segs[ONE], "imgs": imgs, "segs": segs,
        "firsts": rng.randint(0, 13, 10).astype(np.int32), "width": np.int32(4),
        "kids": rng.randint(-1, 16, (10, 12)).astype(np.int32),
        "mfirsts": rng.randint(0, 12, (3, 7)).astype(np.int32),
        "mwidths": np.asarray([3, 4, 3], np.int32),
        "mkids": rng.randint(-1, 16, (3, 7, 12)).astype(np.int32),
    }
    inp["mtargets"] = np.asarray([int(np.argmax(jengine.predict(imgs[i:i + 1])[0]))
                                  for i in range(3)], np.int32)
    inp["target"] = np.int32(inp["mtargets"][ONE])
    jmesh = jmake_mesh(jax.devices()[:2])
    ref = {}
    for kind, fn, args in (
            ("window", jsharded.sharded_window_eval,
             (inp["image"], inp["seg"], inp["firsts"], 4, int(inp["target"]))),
            ("knockout", jsharded.sharded_knockout_eval,
             (inp["image"], inp["seg"], inp["kids"], int(inp["target"]))),
            ("window_multi", jsharded.sharded_window_eval_multi,
             (imgs, segs, inp["mfirsts"], inp["mwidths"], inp["mtargets"])),
            ("knockout_multi", jsharded.sharded_knockout_eval_multi,
             (imgs, segs, inp["mkids"], inp["mtargets"]))):
        ref[kind] = fn(jmesh, jbundle.logits, jvars, *args, compute_dtype=jnp.float32)
    # BO: q = 4 proposals sharded on one image, and N = 3 images sharded.
    inp.update(bo_iters=np.int32(3), bo_pre=np.int32(2), bo_q=np.int32(4))
    cfg = JBOConfig(n_iters=3, n_pre_samples=2)
    _, ref["bo"] = jbo.bo_window_saliency(jengine, inp["image"], inp["seg"], cfg,
                                          target=int(inp["target"]), proposals_per_iter=4,
                                          mesh=jmesh)
    inp["bo_draws"] = ref["bo"].xp.astype(np.int64)
    ref["bo_multi"] = [t for _, t in jbo.bo_window_saliency_multi(
        jengine, imgs, list(segs), cfg, targets=inp["mtargets"], per_image_seeds=[0, 1, 2],
        mesh=jmesh)]
    inp["bo_mdraws"] = np.stack([t.xp for t in ref["bo_multi"]]).astype(np.int64)
    # GP grids and labels.
    yy, xx = np.mgrid[0:16, 0:16]
    inp["heats"] = np.stack([np.exp(-((yy - c) ** 2 + (xx - 6.0) ** 2) / 20.0)
                             + 0.1 * rng.rand(16, 16) for c in (4.0, 8.0, 11.0)]
                            ).astype(np.float32)
    ref["kron"] = jkron.fit_posterior_batch(inp["heats"], iters=8, mesh=jmesh)
    x = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float32)
    inp["vgp_x"], inp["vgp_xt"] = x, x[::3] + 0.5
    inp["vgp_ys"] = np.stack([(x[:, 0] + x[:, 1] + rng.randn(256) * 2 > c).astype(np.float32)
                              for c in (12.0, 15.0, 18.0)])
    ref["vgp"] = jvar.fit_predict_batch(jvar.init_model(16, grid_size=4, lengthscale=3.0),
                                        x, inp["vgp_ys"], inp["vgp_xt"], iters=10, mesh=jmesh,
                                        return_models=False)
    for method in ("gradient", "integrated"):
        ref[f"attr_{method}"] = np.asarray(jgradient.attribute_batch(
            jbundle.logits, jvars, imgs, inp["mtargets"], method, steps=4, mesh=jmesh))
    # JAX's mask_method_batch masks in bf16 only: its f32 occlusion per image.
    ref["attr_occlusion"] = np.stack([np.asarray(jgradient.occlusion_map(
        jbundle.logits, jvars, imgs[i], int(inp["mtargets"][i]), patch=7, stride=7,
        compute_dtype=jnp.float32)) for i in range(3)])
    return d, inp, ref, engine


def _check_sharded(kind, got, want):
    """Labels and count equal, probabilities within PROB_TOL; some masks
    survive and some do not."""
    assert 0 < np.asarray(want[0]).mean() < 1, "all masks alike: a weak test"
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=PROB_TOL)
    if kind in ("window", "knockout"):
        assert int(got[2]) == int(want[2]) == int(np.asarray(want[0]).sum())


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_evals_world1_match_jax(setup, world1, kind):
    _, inp, ref, engine = setup
    f32 = dict(compute_dtype=torch.float32)
    if kind == "window":
        got = parallel.sharded_window_eval(world1, engine.folded_logits, engine.variables,
                                           inp["image"], inp["seg"], inp["firsts"], 4,
                                           int(inp["target"]), **f32)
    elif kind == "knockout":
        got = parallel.sharded_knockout_eval(world1, engine.folded_logits, engine.variables,
                                             inp["image"], inp["seg"], inp["kids"],
                                             int(inp["target"]), **f32)
    elif kind == "window_multi":
        got = parallel.sharded_window_eval_multi(world1, engine.folded_logits, engine.variables,
                                                 inp["imgs"], inp["segs"], inp["mfirsts"],
                                                 inp["mwidths"], inp["mtargets"], **f32)
    else:
        got = parallel.sharded_knockout_eval_multi(world1, engine.folded_logits,
                                                   engine.variables, inp["imgs"], inp["segs"],
                                                   inp["mkids"], inp["mtargets"], **f32)
    _check_sharded(kind, got, ref[kind])


def test_make_mesh_shapes_and_indivisible_fallback(world1):
    assert tuple(world1.shape) == (1, 1) and world1.mesh_dim_names == ("data", "model")
    assert pmesh.axis_size(world1) == 1 and pmesh.axis_index(world1) == 0
    # JAX's rule (tests/test_parallel.py): 1 device with model_parallel=2 -> (1, 1).
    assert dict(jmake_mesh(jax.devices()[:1], model_parallel=2).shape) == {"data": 1, "model": 1}
    assert tuple(parallel.make_mesh([0], model_parallel=2, device="cpu").shape) == (1, 1)
    x = torch.arange(6.0)
    assert torch.equal(parallel.shard_batch(world1, x), x)
    tree = {"a": x}
    assert parallel.replicate(world1, tree) is tree


def test_process_strided_indices(world1):
    assert list(multihost.process_strided_indices(5)) == [0, 1, 2, 3, 4]
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    # With torchrun's variables unset and no arguments: a single-process run.
    assert multihost.initialize_distributed() is False
    assert jmultihost.initialize_distributed() is False


def _results():
    a = SweepResult(images_total=3, images_explained=2, images_skipped_misclassified=1,
                    mean_iou=0.5, mean_survival=0.8, p50_latency_s=0.2, evals_per_sec=100.0,
                    per_image=[{"index": 0, "iou": 0.4, "survival": 0.7, "seconds": 0.1,
                                "deletion_auc": 0.2, "insertion_auc": 0.6, "pointing": True},
                               {"index": 2, "iou": 0.6, "survival": 0.9, "seconds": 0.3,
                                "deletion_auc": 0.4, "insertion_auc": 0.5, "pointing": False}])
    b = SweepResult(images_total=2, images_explained=1, images_failed=1, mean_iou=0.7,
                    mean_survival=0.6, p50_latency_s=0.9, evals_per_sec=50.0,
                    per_image=[{"index": 1, "iou": 0.7, "survival": 0.6, "seconds": 0.9,
                                "deletion_auc": 0.1, "insertion_auc": 0.9, "pointing": True}])
    return a, b


def _jax_twin(r):
    return jmultihost.sweep_result_from_dict(multihost.sweep_result_to_dict(r))


def _fields(r):
    return {k: getattr(r, k) for k in (
        "images_total", "images_explained", "images_skipped_misclassified", "images_failed",
        "mean_iou", "mean_survival", "p50_latency_s", "evals_per_sec", "mean_deletion_auc",
        "mean_insertion_auc", "pointing_game_acc")}


@pytest.mark.parametrize("rows", ["latencies", "no_latencies"])
def test_merge_sweep_metrics_matches_jax(rows):
    a, b = _results()
    if rows == "no_latencies":   # the median of the medians
        for r in (a, b):
            for row in r.per_image:
                row.pop("seconds")
    merged = multihost.merge_sweep_metrics([a, b])
    want = jmultihost.merge_sweep_metrics([_jax_twin(a), _jax_twin(b)])
    assert _fields(merged) == pytest.approx(_fields(want), rel=1e-12)
    assert merged.per_image == want.per_image
    assert isinstance(want, JSweepResult)


def test_rank_result_round_trip_and_stale_cleanup(tmp_path):
    a, b = _results()
    out = str(tmp_path)
    multihost.write_rank_result(out, a, rank=0)
    multihost.write_rank_result(out, b, rank=1)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    merged = multihost.merge_rank_results(out, 2, timeout_s=5)
    # The JAX package reads the port's rank files to the same merge.
    jmerged = jmultihost.merge_rank_results(out, 2, timeout_s=5)
    assert _fields(merged) == pytest.approx(_fields(jmerged), rel=1e-12)
    assert _fields(merged) == pytest.approx(_fields(multihost.merge_sweep_metrics([a, b])))
    with open(multihost.rank_result_path(out, 1)) as f:
        assert json.load(f)["process_id"] == 1
    np.savez(os.path.join(out, "gp_heatmaps.rank1.npz"), x=np.zeros(1))
    multihost.clear_stale_rank_result(out, rank=1)
    assert sorted(os.listdir(out)) == ["sweep_result.rank0.json"]
    with pytest.raises(TimeoutError, match="rank1"):
        multihost.merge_rank_results(out, 2, timeout_s=0.1)


def test_cli_multihost_without_coordinator_exits_2(capsys, tmp_path):
    assert jcli.main(["--synthetic", "--multihost", "--out", str(tmp_path / "j")]) == 2
    jerr = capsys.readouterr().err
    assert cli.main(["--synthetic", "--multihost", "--device", "cpu",
                     "--out", str(tmp_path / "p")]) == 2
    err = capsys.readouterr().err
    assert "--multihost could not initialize jax.distributed" in jerr
    assert "--multihost could not initialize torch.distributed" in err
    assert not os.path.exists(tmp_path / "p")


def test_a_failed_collective_ends_the_sweep(setup, monkeypatch):
    """A collective's error is never one image's failure: the sweep raises."""
    _, inp, _, engine = setup

    def broken(*_a, **_k):
        raise pmesh.CollectiveError("all_gather over 'data' failed")

    monkeypatch.setattr(engine, "collect", broken)
    items = [(inp["imgs"][i], None, None) for i in range(2)]
    with pytest.raises(pmesh.CollectiveError):
        sweep.saliency_sweep(engine, items, SegmentConfig(), num_mask_samples=4)
    monkeypatch.setattr(engine, "collect", lambda h: (_ for _ in ()).throw(ValueError("x")))
    res = sweep.saliency_sweep(engine, items, SegmentConfig(), num_mask_samples=4)
    assert res.images_failed == 2   # any other error fails only its image


# --- the spawned 2-rank world -------------------------------------------------


def _cli_runs(art):
    base = BASE + ["--ckpt", art]
    return {
        "multihost": base + ["--num-images", "6", "--multihost", "--gp-heatmaps"],
        "data_parallel": base + ["--num-images", "4", "--data-parallel"],
        "data_parallel_knockout": base + ["--num-images", "4", "--data-parallel", "--mode",
                                          "knockout", "--num-knockout", "2", "--image-batch",
                                          "2", "--gp-heatmaps", "--no-journal"],
        "both": base + ["--num-images", "4", "--multihost", "--data-parallel", "--no-journal"],
    }


def _single(flags, out):
    """The single-process sweep of the same flags (no process group)."""
    flags = [f for f in flags if f not in ("--multihost", "--data-parallel")]
    assert cli.main(flags + ["--out", out]) == 0
    with open(os.path.join(out, "sweep_result.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def world2(setup):
    """Runs tests/torch_parallel_worker.py as ranks 0 and 1 of a gloo world,
    once for every test below; the single-process sweeps run here first."""
    d, inp, _, _ = setup
    runs = _cli_runs(str(d / "art"))
    singles = {name: _single(flags, str(d / f"single_{name}")) for name, flags in runs.items()}
    np.savez(d / "inputs.npz", cli_runs=json.dumps(runs), **inp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               "--rank", str(r), "--port", str(port), "--dir", str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-6000:]}"
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    metas = []
    for r in range(2):
        with open(d / f"rank{r}.json") as f:
            metas.append(json.load(f))
    return d, ranks, metas, singles


def test_world2_mesh_and_strides(world2):
    _, _, metas, _ = world2
    assert metas[0]["strided"] == [0, 2, 4] and metas[1]["strided"] == [1, 3]
    for m in metas:
        assert m["mesh"] == [2, 1] and m["data_size"] == 2
        assert m["mesh_mp2"] == [1, 2]
        assert m["mesh_mp3"] == [2, 1]   # 3 does not divide 2 ranks: pure data parallelism


@pytest.mark.parametrize("kind", KINDS)
def test_world2_sharded_evals_match_jax(setup, world2, kind):
    _, _, ref, _ = setup
    _, ranks, _, _ = world2
    for out in ranks:   # every rank holds the whole outcomes
        got = [out[f"{kind}_s"], out[f"{kind}_p"]]
        if kind in ("window", "knockout"):
            got.append(out[f"{kind}_c"])
        _check_sharded(kind, got, ref[kind])


def test_world2_bo_proposal_sharding_matches_jax(setup, world2):
    _, _, ref, _ = setup
    _, ranks, _, _ = world2
    jtr = ref["bo"]
    for out in ranks:
        np.testing.assert_array_equal(out["bo_xp"], jtr.xp)
        np.testing.assert_array_equal(out["bo_survived"], jtr.survived)
        np.testing.assert_allclose(out["bo_yp"], jtr.yp, rtol=0, atol=PROB_TOL)
    assert len(jtr.xp) == 2 + 3 * 4 and 0 < jtr.survived.mean() < 1


def test_world2_bo_image_sharding_matches_jax(setup, world2):
    _, _, ref, _ = setup
    _, ranks, _, _ = world2
    for out in ranks:
        for i, jtr in enumerate(ref["bo_multi"]):
            np.testing.assert_array_equal(out["bom_xp"][i], jtr.xp)
            np.testing.assert_array_equal(out["bom_survived"][i], jtr.survived)
            np.testing.assert_allclose(out["bom_yp"][i], jtr.yp, rtol=0, atol=PROB_TOL)


def _assert_scaled(got, want, rtol):
    want = np.asarray(want, np.float64)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= rtol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("fit", ["kron", "vgp"])
def test_world2_gp_fits_match_jax(setup, world2, fit):
    _, _, ref, _ = setup
    _, ranks, _, _ = world2
    for out in ranks:
        if fit == "kron":
            jparams, jmeans, jvars, jlosses = ref["kron"]
            np.testing.assert_array_equal(out["kron_ls"], [float(p.log_lengthscale)
                                                           for p in jparams])
            np.testing.assert_allclose(out["kron_losses"], np.asarray(jlosses), rtol=1e-4)
            _assert_scaled(out["kron_means"], jmeans, 1e-4)
            _assert_scaled(out["kron_vars"], jvars, 1e-4)
        else:
            _, jprobs, jlosses = ref["vgp"]
            np.testing.assert_allclose(out["vgp_losses"], np.asarray(jlosses), rtol=1e-4)
            np.testing.assert_allclose(out["vgp_probs"], np.asarray(jprobs), rtol=0, atol=2e-4)


@pytest.mark.parametrize("method", ["gradient", "integrated", "occlusion"])
def test_world2_attributions_match_jax(setup, world2, method):
    _, _, ref, _ = setup
    _, ranks, _, _ = world2
    want = ref[f"attr_{method}"]
    for out in ranks:
        got = out[f"attr_{method}"]
        assert got.shape == want.shape == (3, 28, 28)
        np.testing.assert_allclose(got, want, rtol=0, atol=MAP_TOL * np.abs(want).max())


def _rows(result):
    return {r["index"]: {k: v for k, v in r.items() if k != "seconds"}
            for r in result["per_image"]} if "per_image" in result else None


def _merged_rows(d, name, world=2):
    rows = []
    for r in range(world):
        with open(os.path.join(d, name, f"sweep_result.rank{r}.json")) as f:
            rows += json.load(f)["per_image"]
    return {r["index"]: {k: v for k, v in r.items() if k != "seconds"} for r in rows}


COUNTS = ("images_total", "images_explained", "images_skipped_misclassified", "images_failed")


def test_world2_multihost_sweep_equals_single_process(world2):
    """Each image runs whole on one rank, so the merged rows equal the
    single-process sweep's exactly; the JAX package's merge of the same
    rank files gives the same result."""
    d, _, metas, singles = world2
    assert [m["cli_multihost"] for m in metas] == [0, 0]
    with open(d / "multihost" / "sweep_result.json") as f:
        merged = json.load(f)
    single = singles["multihost"]
    assert merged["process_count"] == 2 and 0 < single["mean_survival"] < 1
    for k in COUNTS:
        assert merged[k] == single[k], k
    assert merged["mean_survival"] == pytest.approx(single["mean_survival"], abs=1e-12)
    rows = _merged_rows(d, "multihost")
    with open(d / "single_multihost" / "sweep_journal.jsonl") as f:
        single_rows = {r["index"]: r for r in map(json.loads, f) if r.get("event") ==
                       "image_done"}
    assert sorted(rows) == sorted(single_rows) == list(range(6))
    for i, row in rows.items():
        for k in ("target", "num_segments", "survival"):
            assert row[k] == single_rows[i][k], (i, k)
    jmerged = jmultihost.merge_rank_results(str(d / "multihost"), 2, timeout_s=5)
    for k in COUNTS + ("mean_survival", "mean_iou", "p50_latency_s"):
        assert merged[k] == pytest.approx(getattr(jmerged, k), rel=1e-12), k
    gp = merged["gp_heatmaps"]
    assert gp["artifacts"] == ["gp_heatmaps.rank0.npz", "gp_heatmaps.rank1.npz"]
    for r in range(2):
        assert os.path.exists(d / "multihost" / f"sweep_journal.rank{r}.jsonl")
        with np.load(d / "multihost" / f"gp_heatmaps.rank{r}.npz") as z:
            assert list(z["indices"]) == list(range(r, 6, 2))


@pytest.mark.parametrize("name", ["data_parallel", "data_parallel_knockout"])
def test_world2_data_parallel_sweep_equals_single_process(world2, name):
    """Each image's masks (one image at a time, or a flush's grid) split
    over the two ranks: the result equals the single-process sweep's."""
    d, _, metas, singles = world2
    assert [m[f"cli_{name}"] for m in metas] == [0, 0]
    with open(d / name / "sweep_result.json") as f:
        got = json.load(f)
    want = singles[name]
    assert 0 < want["mean_survival"] < 1
    for k in COUNTS:
        assert got[k] == want[k], k
    assert got["images_explained"] == 4
    assert got["mean_survival"] == pytest.approx(want["mean_survival"], abs=1e-12)
    assert "process_count" not in got
    if name == "data_parallel_knockout":
        with np.load(d / name / "gp_heatmaps.npz") as z, \
                np.load(d / f"single_{name}" / "gp_heatmaps.npz") as w:
            np.testing.assert_array_equal(z["heatmaps"], w["heatmaps"])
            _assert_scaled(z["gp_mean"], w["gp_mean"], 1e-4)


def test_world2_multihost_with_data_parallel_fails_every_image(world2):
    """Both flags: each process sweeps its own stride while the mesh spans
    every process, so every sharded call sees inputs that differ across
    ranks and fails that image on every rank; the run goes on and exits 0.
    A run of the JAX CLI on two CPU processes with both flags ends the same
    way: images_failed equal to the image count, nothing explained."""
    d, _, metas, _ = world2
    assert [m["cli_both"] for m in metas] == [0, 0]
    with open(d / "both" / "sweep_result.json") as f:
        got = json.load(f)
    assert got["images_total"] == got["images_failed"] == 4
    assert got["images_explained"] == 0 and got["process_count"] == 2
