"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped; a window of 0 seconds hands over one image): the result line, the
check passing on the program, and the cell's own limits failing the fp8
control, the BO loop without GP-EI and faults planted where the answers are
produced. Then the import isolation and the refusal without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness, spec

# The tiny cells' limits, from runs of one image on the CPU over seeds 1-5,
# 2**31 + 7 and 2**31 + 8: the window cell's program read rel_logit_err
# 0.0006-0.204 and its control 0.27-2.32; the BO cell's program 0.032-0.085,
# its control 0.52-1.19. ei_choice_mismatch_share, over windows of 3
# requests on seeds 1, 2, 3, 5 and 2**31 + 7: the program read 0, the loop
# that takes its draws 0.69-1.00; its limit is the ResNet-101 BO cell's.
TINY_LIMIT = 0.25
SEEDS = (1, 3, 2 ** 31 + 8)        # program 0.074, 0.068, 0.053; control 0.77, 0.89, 1.82
TINY_BO_LIMIT = 0.25
TINY_EI_LIMIT = 0.17
BO_SEEDS = (1, 3, 2 ** 31 + 7)     # program 0.085, 0.059, 0.054; control 1.19, 1.03, 0.92


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(os.path.join(spec.ROOT, "portbench", "metrics"), root / "portbench" / "metrics")
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir()
    cfg = spec.load_json(os.path.join(spec.ROOT, "portbench/configs/resnet101-224-bf16.json"))
    cfg.update(name="tiny", arch="resnet50", stage_sizes=[3, 4, 6, 3], num_classes=10,
               resolution=64, chains=[[16, 256, 64, 2], [8, 512, 128, 3], [4, 1024, 256, 5],
                                      [2, 2048, 512, 2]])
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/window-1024.json"))
    mix.update(masks_per_image=20, mask_batch=8, pool_images=6, calibration_images=4,
               warm_images=1, check_images=2, check_batch=8)
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    (root / "portbench/limits/t.tiny.json").write_text(json.dumps({"limits": {
        "segments_heatmap_mismatch": 0, "iou_mismatch": 0, "outcome_mismatch": 0,
        "rel_logit_err": TINY_LIMIT}}))
    cfg.update(name="tiny112", resolution=112, chains=[[28, 256, 64, 2], [14, 512, 128, 3],
                                                       [7, 1024, 256, 5], [4, 2048, 512, 2]])
    (root / "portbench/configs/tiny112.json").write_text(json.dumps(cfg))
    bo = spec.load_json(os.path.join(spec.ROOT, "portbench/traffic/bo.json"))
    bo.update(min_size=20, pool_images=6, calibration_images=4, warm_images=1, check_images=3,
              warm_segment_counts=[20, 40])
    (root / "portbench/traffic/tbo.json").write_text(json.dumps(bo))
    (root / "portbench/limits/t.bo.json").write_text(json.dumps({"limits": {
        "segments_heatmap_mismatch": 0, "iou_mismatch": 0, "draws_mismatch": 0,
        "ei_choice_mismatch_share": TINY_EI_LIMIT, "rel_logit_err": TINY_BO_LIMIT}}))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": n, "source": "test", "file": f"portbench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in ("tiny", "tiny112")]
    bench["workloads"] = [{"name": "t.tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "test"},
                          {"name": "t.bo", "config": "tiny112", "traffic": "tbo", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["t.bo" if m["name"].endswith(".bo") or "explain" in m["name"]
                              else "t.tiny"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def tiny_run(root, seed=1, cell="t.tiny", **kw):
    return harness.run(spec.Cell(cell, root=root), seed, 0.0, False, time.perf_counter(),
                       device="cpu", **kw)


class ThreeRequests(harness.ClosedLoop):
    """A window that hands over the pool's first three images, whatever the
    clock says."""

    def items(self):
        for i in range(3):
            self.handed += 1
            yield self.images[i], None, tuple(int(v) for v in self.boxes[i])


def test_result_line(tiny_root):
    out = tiny_run(tiny_root, seed=SEEDS[0])
    line = out["line"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, out["checks"]
    assert line["failed"] == 0 and line["attempted"] == 1
    assert set(line["metrics"]) == {"evals_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"segments_heatmap_mismatch", "iou_mismatch",
                                   "outcome_mismatch", "rel_logit_err"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert out["forbidden"] == []
    json.dumps(line)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_fails(tiny_root, seed):
    out = tiny_run(tiny_root, seed=seed, control=True)
    assert out["line"]["correct"] is True, out["checks"]
    assert out["verdicts"] == {"program": True, "control": False}, out["readings"]


def _alter_answer(engine):
    """A mask's prediction moved to another class where the outcomes are
    produced, its survive outcome kept consistent with it."""
    collect = engine.collect

    def altered(handle):
        out = collect(handle)
        if len(out.preds):
            out.preds[0] = (out.preds[0] + 1) % 10
            out.survived[0] = False
        return out

    engine.collect = altered


def _half_left_out(engine):
    """The second half of each image's masks never evaluated: their
    outcomes copied from the first half's."""
    collect = engine.collect

    def half(handle):
        out = collect(handle)
        k = len(out.preds)
        for a in (out.survived, out.preds, out.prob_target, out.prob_max):
            a[k - k // 2:] = a[:k // 2]
        return out

    engine.collect = half


@pytest.mark.parametrize("fault", [_alter_answer, _half_left_out], ids=["altered", "half"])
def test_faults_fail_the_check(tiny_root, fault):
    out = tiny_run(tiny_root, seed=SEEDS[0], engine_hook=fault)
    assert out["line"]["correct"] is False
    assert out["readings"]["program"]["rel_logit_err"] > TINY_LIMIT


def test_bo_result_line(tiny_root):
    out = tiny_run(tiny_root, seed=BO_SEEDS[0], cell="t.bo")
    line = out["line"]
    assert line["correct"] is True, out["checks"]
    assert set(line["metrics"]) == {"explain_p50_ms", "explain_p95_ms", "setup_s"}
    assert line["metrics"]["explain_p95_ms"]["value"] >= line["metrics"]["explain_p50_ms"]["value"]
    assert set(line["checks"]) == set(harness._bo_blank())


@pytest.mark.parametrize("seed", BO_SEEDS)
def test_the_bo_control_fails(tiny_root, seed, monkeypatch):
    """The cell's limits pass the program and fail both of the reference's
    stand-ins: the fp8 net (by its logits) and the loop that takes its
    draws in place of GP-EI (by its choices). The window holds 3 requests,
    all of which the check samples: a single request's scores may never
    spread enough for a step to be judged."""
    monkeypatch.setattr(harness, "ClosedLoop", ThreeRequests)
    out = tiny_run(tiny_root, seed=seed, cell="t.bo", control=True)
    assert out["line"]["correct"] is True, out["checks"]
    assert out["verdicts"] == {"program": True, "control": False, "proposals_drawn": False}
    assert out["readings"]["proposals_drawn"]["ei_choice_mismatch_share"] > TINY_EI_LIMIT


def _shrink_bo_scores(engine):
    """Every BO evaluation's score altered where it is produced: the
    probability of the target a tenth of what the net gave."""
    outcomes = engine.masked_outcomes

    def altered(images, target):
        prob, survived = outcomes(images, target)
        return prob * 0.1, survived

    engine.masked_outcomes = altered


def test_an_altered_bo_score_fails_the_check(tiny_root):
    out = tiny_run(tiny_root, seed=BO_SEEDS[0], cell="t.bo", engine_hook=_shrink_bo_scores)
    assert out["line"]["correct"] is False
    assert out["readings"]["program"]["rel_logit_err"] > TINY_BO_LIMIT


def test_ei_of_the_wrong_sign_fails_the_check(tiny_root, monkeypatch):
    """The port's fused loop proposing the start of least EI: its choices
    fail ``ei_choice_mismatch_share`` while every other number still passes."""
    import torch

    from network_interpretation_imagenet_tpu_torch.bo import loop

    fused_ei = loop.fused_ei

    def least(gp, xs, ys, count, cand, ls_grid, cand_ok):
        ei = fused_ei(gp, xs, ys, count, cand, ls_grid, cand_ok)
        return torch.where(cand_ok, -ei, -torch.inf)

    monkeypatch.setattr(loop, "fused_ei", least)
    out = tiny_run(tiny_root, seed=BO_SEEDS[0], cell="t.bo")
    assert out["line"]["correct"] is False
    assert out["readings"]["program"]["ei_choice_mismatch_share"] > TINY_EI_LIMIT
    assert out["readings"]["program"]["rel_logit_err"] <= TINY_BO_LIMIT


def test_bo_counts(tiny_root):
    cell = spec.Cell("t.bo", root=tiny_root)
    ctx = harness.Context(cell, harness.DeviceTrace(False), harness.Spans())
    driver = harness.BORequests(None, cell.traffic, harness.derived_seeds(1), harness.Spans())
    driver.done = [{"ms": v} for v in (10.0, 30.0, 20.0)]
    driver.attempted = 3
    attempted, failed, sound, finished, picks = driver.finish(ctx, [])
    assert (attempted, failed, sound, finished, len(picks)) == (3, 0, True, 3, 3)
    assert ctx.forwards == {1: 33, 3: 3} and ctx.b1_calls == {1: 30, 3: 3} and ctx.evals == 39
    got = spec.read_metrics(cell, "end_to_end", ctx)
    assert got["explain_p50_ms"]["value"] == 20.0
    assert got["explain_p95_ms"]["value"] == pytest.approx(29.0)


def test_window_counts_and_readers(tiny_root):
    cell = spec.Cell("t.tiny", root=tiny_root)
    ctx = harness.Context(cell, harness.DeviceTrace(False), harness.Spans())
    harness._window_counts(ctx, images=3, k=20, mask_batch=8)
    assert ctx.evals == 60 and ctx.forwards == {1: 3, 8: 6, 4: 3} and ctx.b1_calls == {8: 6, 4: 3}
    flops = spec.load_json(os.path.join(tiny_root, "portbench/configs/tiny.json"))
    assert ctx.flops() == pytest.approx(63 * harness.costs.forward_flops(flops))
    ctx.trace.kernels = [("void (anonymous namespace)::b2_conv_wgmma<64>(x)", 0, 2_000_000),
                         ("void (anonymous namespace)::b2_conv_wgmma<64>(x)", 1_000_000, 3_000_000),
                         ("b1_masked_batch", 3_000_000, 3_500_000),
                         ("void at::native::elementwise_kernel<128, 4>(int)", 5_000_000, 6_000_000)]
    ctx.trace.enabled, ctx.trace.t0, ctx.trace.t1 = True, 0, 10_000_000
    assert ctx.trace.union_ms("b2") == 3.0 and ctx.trace.union_ms("b1") == 0.5
    assert ctx.trace.union_ms() == 4.5
    assert ctx.trace.top_ops()[0] == ["b2_conv_wgmma", 0.003]   # overlapping launches once
    got = spec.read_metrics(cell, "per_layer", ctx)
    assert got["device_idle.window"]["value"] == pytest.approx(0.55)
    assert got["other_kernels_ms_per_kevals.window"]["value"] == pytest.approx(1.0 / 0.06)
    assert got["b2_roofline.window"]["value"] == pytest.approx(100 * ctx.b2_bound_ms() / 3.0)
    spans = harness.Spans()
    spans.spans = [("sweep", 0, 10_000_000), ("segment", 3_600_000, 4_900_000)]
    gaps = ctx.trace.idle_gaps(spans)
    assert gaps[0] == ["sweep", 0.004] and ["segment", 0.0015] in gaps


def _isolated(code):
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=spec.ROOT, timeout=120)


def test_harness_and_reference_load_neither_jax_nor_the_port():
    code = ("import sys\n"
            "from portbench import harness, reference, spec, trace, traffic, costs\n"
            "print(harness.forbidden_modules(extra=(harness.PORT,)))\n")
    proc = _isolated(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_the_port_loads_no_jax(tiny_root):
    tiny_run(tiny_root, seed=SEEDS[0])
    assert harness.forbidden_modules() == []
    assert harness.PORT in {m.split(".")[0] for m in sys.modules}


def test_jax_loaded_by_a_metric_prints_no_line(tiny_root, tmp_path, capsys):
    """A metric reader, run after the window, that loads a module named
    ``jax``: the run's line says not correct, and the report prints no line
    and exits non-zero, naming what it found."""
    import types

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "portbench/metrics/loads_jax.py").write_text(
        "import sys, types\n"
        "def read(ctx):\n"
        "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
        "    return 1.0\n")
    bench = spec.load_json(str(root / "BENCHMARK.json"))
    bench["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "jax" not in sys.modules
    try:
        out = tiny_run(str(root), seed=SEEDS[0])
        assert out["forbidden"] == ["jax"] and out["line"]["correct"] is False
        capsys.readouterr()
        assert harness.report(out) != 0
        got = capsys.readouterr()
        assert got.out == "" and "jax" in got.err
        # Loaded after the run itself: the report reads sys.modules again.
        sys.modules.pop("jax")
        clean = tiny_run(tiny_root, seed=SEEDS[0])
        sys.modules["jax"] = types.ModuleType("jax")
        assert clean["forbidden"] == [] and harness.report(clean) != 0
        assert capsys.readouterr().out == ""
    finally:
        sys.modules.pop("jax", None)
    assert harness.report(clean) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == clean["line"]


def test_whole_word_names():
    sys.modules.setdefault("network_interpretation_imagenet_tpu_torch_x", None)
    try:
        assert "network_interpretation_imagenet_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("network_interpretation_imagenet_tpu_torch_x", None)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "r101.window-1024",
                           "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.card
def test_a_cell_on_the_card(card):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "r101.window-1024",
                           "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert np.isfinite(line["metrics"]["evals_per_s"]["value"])
