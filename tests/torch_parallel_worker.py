"""One rank of the port's 2-process gloo world (tests/test_torch_parallel.py
spawns two; pytest does not collect this file).

It imports the port only: the JAX references are computed in the test
process, which hands this rank its inputs (``inputs.npz``: images, segment
maps, starts, knockout ids, targets, the BO draws of JAX's traces, GP grids)
and a weights artifact of the MNIST CNN. The rank joins the world through
``parallel.multihost.initialize_distributed`` and runs every collective the
test holds against JAX: the mesh's shapes, the four sharded evals, BO with
its proposals and with its images sharded, both batched GP fits, the batched
attributions, then the sweep CLI three times (--multihost, --data-parallel,
and both), writing ``rank<r>.npz`` and ``rank<r>.json`` for the test.

    python tests/torch_parallel_worker.py --rank R --port P --dir DIR
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

WORLD = 2


def _engine(art):
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
    from network_interpretation_imagenet_tpu_torch.utils import convert

    bundle = create_model("mnist_cnn", "mnist", dtype=torch.float32)
    variables, _ = convert.load_weights_artifact(art)
    return SaliencyEngine(bundle, convert.from_jax(variables, bundle.module), mask_batch=16,
                          compute_dtype=torch.float32, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep_cli
    from network_interpretation_imagenet_tpu_torch.config import BOConfig
    from network_interpretation_imagenet_tpu_torch.gp import kron, variational
    from network_interpretation_imagenet_tpu_torch.parallel import (
        make_mesh,
        multihost,
        sharded_knockout_eval,
        sharded_knockout_eval_multi,
        sharded_window_eval,
        sharded_window_eval_multi,
    )
    from network_interpretation_imagenet_tpu_torch.parallel.mesh import axis_size
    from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, gradient

    coordinator = f"127.0.0.1:{args.port}"
    assert multihost.initialize_distributed(coordinator, WORLD, args.rank, backend="gloo",
                                            device="cpu", timeout_s=120)
    assert multihost.process_count() == WORLD and multihost.process_index() == args.rank
    meta = {"strided": list(multihost.process_strided_indices(5))}
    mesh = make_mesh(device="cpu")
    meta["mesh"] = list(mesh.shape)
    meta["mesh_mp2"] = list(make_mesh(device="cpu", model_parallel=2).shape)
    meta["mesh_mp3"] = list(make_mesh(device="cpu", model_parallel=3).shape)
    meta["data_size"] = axis_size(mesh)

    inp = dict(np.load(os.path.join(args.dir, "inputs.npz")))
    art = os.path.join(args.dir, "art")
    engine = _engine(art)
    f32 = dict(compute_dtype=torch.float32)
    out = {}
    s, p, c = sharded_window_eval(mesh, engine.folded_logits, engine.variables, inp["image"],
                                  inp["seg"], inp["firsts"], int(inp["width"]),
                                  int(inp["target"]), **f32)
    out.update(window_s=s, window_p=p, window_c=c)
    s, p, c = sharded_knockout_eval(mesh, engine.folded_logits, engine.variables, inp["image"],
                                    inp["seg"], inp["kids"], int(inp["target"]), **f32)
    out.update(knockout_s=s, knockout_p=p, knockout_c=c)
    s, p = sharded_window_eval_multi(mesh, engine.folded_logits, engine.variables, inp["imgs"],
                                     inp["segs"], inp["mfirsts"], inp["mwidths"],
                                     inp["mtargets"], **f32)
    out.update(window_multi_s=s, window_multi_p=p)
    s, p = sharded_knockout_eval_multi(mesh, engine.folded_logits, engine.variables,
                                       inp["imgs"], inp["segs"], inp["mkids"], inp["mtargets"],
                                       **f32)
    out.update(knockout_multi_s=s, knockout_multi_p=p)

    # BO: one image with its q proposals sharded, then N images sharded,
    # both on JAX's traces as the draws.
    cfg = BOConfig(n_iters=int(inp["bo_iters"]), n_pre_samples=int(inp["bo_pre"]))
    bo_out, tr = bo_pipeline.bo_window_saliency(
        engine, inp["image"], inp["seg"], cfg, target=int(inp["target"]),
        proposals_per_iter=int(inp["bo_q"]), draws=torch.from_numpy(inp["bo_draws"]), mesh=mesh)
    out.update(bo_xp=tr.xp, bo_yp=tr.yp, bo_survived=tr.survived, bo_heat=bo_out.heatmap)
    bo_pipeline._multi_draws = lambda *a: torch.from_numpy(inp["bo_mdraws"])
    pairs = bo_pipeline.bo_window_saliency_multi(
        engine, list(inp["imgs"]), list(inp["segs"]), cfg, targets=inp["mtargets"],
        per_image_seeds=[0, 1, 2], mesh=mesh)
    out.update(bom_xp=np.stack([t.xp for _, t in pairs]),
               bom_yp=np.stack([t.yp for _, t in pairs]),
               bom_survived=np.stack([t.survived for _, t in pairs]))

    params, means, vars_, losses = kron.fit_posterior_batch(inp["heats"], iters=8, device="cpu",
                                                            mesh=mesh)
    out.update(kron_ls=np.asarray([float(pp.log_lengthscale) for pp in params]),
               kron_means=means.numpy(), kron_vars=vars_.numpy(), kron_losses=losses.numpy())
    model = variational.init_model(16, grid_size=4, lengthscale=3.0, device="cpu")
    _, probs, vlosses = variational.fit_predict_batch(model, inp["vgp_x"], inp["vgp_ys"],
                                                      inp["vgp_xt"], iters=10, mesh=mesh,
                                                      return_models=False)
    out.update(vgp_probs=probs.numpy(), vgp_losses=vlosses.numpy())

    for method in ("gradient", "integrated"):
        out[f"attr_{method}"] = gradient.attribute_batch(
            engine.bundle.logits, engine.variables, inp["imgs"], inp["mtargets"], method,
            steps=4, mesh=mesh).numpy()
    out["attr_occlusion"] = gradient.mask_method_batch(
        engine.folded_logits, engine.variables, inp["imgs"], inp["mtargets"], "occlusion",
        patch=7, stride=7, compute_dtype=torch.float32, mesh=mesh).numpy()

    # The sweep CLI: each run's flags, this rank's joining flags appended.
    join = ["--coordinator", coordinator, "--num-processes", str(WORLD), "--process-id",
            str(args.rank), "--dist-backend", "gloo"]
    for name, flags in json.loads(str(inp["cli_runs"])).items():
        meta[f"cli_{name}"] = sweep_cli.main(flags + join + ["--out", os.path.join(
            args.dir, name)])
    np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **out)
    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(meta, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
