"""Test harness: force CPU with 8 virtual devices.

Multi-chip sharding code (parallel/) is exercised on a fake 8-device CPU mesh
— the TPU-idiomatic stand-in for a pod (see SURVEY.md §4). jax may already be
imported by site customization before conftest runs, so we use
``jax.config.update`` (honored until the backend is first initialized) rather
than environment variables.
"""

import os

import jax

if not os.environ.get("NIT_TEST_TPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# CLI mains enable the persistent XLA compilation cache by default
# (~/.cache/...); tests must not write artifacts into the real user home.
os.environ.setdefault("NIT_COMPILATION_CACHE", "off")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_backend():
    if not os.environ.get("NIT_TEST_TPU"):
        assert jax.default_backend() == "cpu", (
            "tests must run on CPU; backend initialized too early: "
            + jax.default_backend()
        )
        assert len(jax.devices()) == 8
    yield


# ---------------------------------------------------------------------------
# Test tiers (r3): `-m fast` = quick unit tier (<60 s total on one core);
# everything else is `slow` (compile-heavy zoo/CLI/parallel/subprocess
# tests). `-m tpu_smoke` is the subset recorded running on a real chip via
# NIT_TEST_TPU=1 (see docs/profiles/tpu_test_run.txt).
# ---------------------------------------------------------------------------

_FAST_MODULES = {
    "test_masking", "test_metrics", "test_data", "test_preprocess",
    "test_segment", "test_pallas", "test_weights_artifact", "test_gp",
    "test_prefetch",
}

_TPU_SMOKE = (
    "test_masking.py",
    "test_segment.py",
    "test_knockout_machinery.py::test_knockout_async_matches_sync",
    "test_serving.py::test_export_load_matches_engine",
    "test_bo.py::test_bo_window_saliency_end_to_end",
    # r3 attribution family: cheap analytic cases, real-chip autodiff and
    # soft-mask forwards covered in one short pass.
    "test_gradient_sweep.py::test_smoothgrad_localizes_and_reduces_to_plain_grad",
    "test_gradient_sweep.py::test_rise_map_localizes_and_is_deterministic",
    "test_gradient_sweep.py::test_gradcam_analytic_and_zoo_layer_pick",
    "test_gradient_sweep.py::test_scorecam_analytic_and_zoo",
    "test_gradient_sweep.py::test_xrai_saliency_end_to_end",
    "test_gradient_sweep.py::test_learned_mask_deletes_evidence_region",
    # Batched attribution machinery: one-program N-image backwards (the
    # r3 bench entry's code path) + exact chunked accumulation.
    "test_gradient_sweep.py::test_attribute_batch_matches_single_all_methods",
    "test_gradient_sweep.py::test_grad_mean_chunked_is_exact",
    # r4: serving twins of the newest lanes — knockout forwards from the
    # artifact, and XRAI's AOT signed-IG + host ranking path.
    "test_serving.py::test_export_knockout_matches_engine",
    "test_serving.py::test_export_xrai_matches_live",
    # r4: the mask-batched sweep lane (occlusion/rise/scorecam as ONE
    # lax.map program per flush) — real-chip coverage of the scan body.
    "test_gradient_sweep.py::test_mask_batched_sweep_matches_one_shot",
    # r5: the sign-preserving f16 attribution wire for xrai — real-chip
    # coverage of the halved fetch + f32 reconstruct.
    "test_gradient_sweep.py::test_attribution_sweep_xrai_f16_wire",
    # r5: the resolution-adaptive defaults that fixed the constant-map
    # degeneracies (224²-calibrated FH/occlusion params on small inputs).
    "test_gradient_sweep.py::test_xrai_adaptive_default_not_constant_on_small_photo",
    "test_gradient_sweep.py::test_occlusion_map_adaptive_patch_small_image",
)

# Individually-slow tests inside otherwise-fast modules (compile-heavy
# vmapped/shard_map fits) — demoted so `-m fast` keeps its quick-tier
# contract.
_FORCE_SLOW = (
    "test_gp.py::test_variational_fit_predict_batch_matches_per_image",
    "test_gp.py::test_variational_fit_predict_batch_sharded_matches_single_device",
    "test_gp.py::test_incremental_gp_matches_cholesky",
    "test_prefetch.py::test_sweep_cli_workers_real_jpegs",
    # Measured ≥5 s each on one core (compile-heavy fits / a full engine
    # build / a 16-min-compile-class Pallas kernel in interpret mode) —
    # together they broke the tier's <60 s contract.
    "test_gp.py::test_variational_gp_learns_halfspace",
    "test_gp.py::test_kron_fit_posterior_batch_sharded_matches_single_device",
    "test_gp.py::test_kron_fit_posterior_batch_matches_per_image",
    "test_weights_artifact.py::test_engine_runs_from_artifact_with_torch_blocked",
    "test_pallas.py::test_fused_bottleneck_chain_matches_xla",
    "test_gp.py::test_lengthscale_sweep_picks_reasonable_scale",
    "test_gp.py::test_incremental_gp_duplicate_points",
    "test_gp.py::test_incremental_mll_selects_same_lengthscale_as_f64",
    "test_gp.py::test_exact_gp_matches_sklearn",
    "test_segment.py::test_slic_batch_matches_per_image",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        module = item.nodeid.split("::")[0].rsplit("/", 1)[-1]
        rel_id = item.nodeid.rsplit("/", 1)[-1]
        tier = "fast" if module[:-3] in _FAST_MODULES or module.startswith("test_torch_") else "slow"
        if any(rel_id == p or rel_id.startswith(p + "[") for p in _FORCE_SLOW):
            tier = "slow"
        item.add_marker(getattr(pytest.mark, tier))
        rel = item.nodeid.rsplit("/", 1)[-1]
        if any(rel == p or rel.startswith(p + "::") or rel.startswith(p + "[")
               for p in _TPU_SMOKE):
            item.add_marker(pytest.mark.tpu_smoke)
