"""Multi-process runs on ``torch.distributed`` (port of ``parallel/multihost.py``
of the JAX package).

One process per device. A val-set sweep shards its image axis coarsely
across processes: each sweeps a disjoint stride of the dataset
(:func:`process_strided_indices`) and writes its result to a shared
directory, which rank 0 merges (:func:`write_rank_result`,
:func:`merge_rank_results`); only scalar metrics and rows cross processes.
The mask axis of one image shards over a mesh instead (``parallel.mesh``).

Single-process runs skip :func:`initialize_distributed` (it returns False
when it finds no coordinator), and the same code runs unchanged.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from network_interpretation_imagenet_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           *, device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a multi-process run; False when there is none.

    The coordinator (``host:port``), the world size and this process's rank
    come from the arguments, or where they are omitted from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. With
    neither a coordinator nor a process count anywhere it returns False
    (a single-process run), so callers may call it unconditionally.

    ``backend=None`` takes NCCL on a CUDA ``device`` (the card unless
    ``"cpu"`` is asked for) and gloo on the CPU; any other backend (gloo for
    ranks that share one card) only when asked for. A rank on a card binds
    to device ``LOCAL_RANK`` (else its rank) modulo the card count. A
    collective that waits longer than ``timeout_s`` for a peer raises, so a
    dead rank cannot leave the others hanging. Calling it again in a
    process that already joined a group of the same size and rank returns
    True; a different world raises."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = _env_int("WORLD_SIZE") if num_processes is None else int(num_processes)
    process_id = _env_int("RANK") if process_id is None else int(process_id)
    if addr is None and num_processes is None:
        return False
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(f"initialize_distributed: coordinator {addr!r}, num_processes "
                         f"{num_processes!r} and process_id {process_id!r}: all three are needed")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(
                f"initialize_distributed: already rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for rank {process_id} of {num_processes}")
        return True
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_strided_indices(total: int) -> range:
    """The image-axis split across processes: process i sweeps images i, i+P,
    i+2P, ... Deterministic and balanced, and it needs no coordination
    beyond the process count."""
    return range(process_index(), total, process_count())


def barrier() -> None:
    """Wait for every process (no-op without a process group). Multi-process
    sweeps call it between clearing each rank's stale result and the sweep:
    ``init_process_group`` is no barrier, so without it rank 0's merge could
    read a stale ``sweep_result.rank1.json`` of an earlier run."""
    if dist.is_initialized():
        dist.barrier()


def sweep_result_to_dict(res) -> dict:
    """JSON-safe dict of a SweepResult (heatmaps excluded: per-process sweep
    artifacts stay with their process; only metrics and rows cross)."""
    return {
        "images_total": int(res.images_total),
        "images_explained": int(res.images_explained),
        "images_skipped_misclassified": int(res.images_skipped_misclassified),
        "images_failed": int(res.images_failed),
        "mean_iou": float(res.mean_iou),
        "mean_survival": float(res.mean_survival),
        "p50_latency_s": float(res.p50_latency_s),
        "evals_per_sec": float(res.evals_per_sec),
        "mean_deletion_auc": float(res.mean_deletion_auc),
        "mean_insertion_auc": float(res.mean_insertion_auc),
        "pointing_game_acc": float(res.pointing_game_acc),
        "per_image": [{k: (v.item() if hasattr(v, "item") else v) for k, v in row.items()}
                      for row in res.per_image],
    }


def sweep_result_from_dict(d: dict):
    """Inverse of :func:`sweep_result_to_dict`."""
    from network_interpretation_imagenet_tpu_torch.saliency.sweep import SweepResult

    res = SweepResult()
    for k, v in d.items():
        setattr(res, k, v)
    return res


def rank_result_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"sweep_result.rank{rank}.json")


def clear_stale_rank_result(out_dir: str, rank: Optional[int] = None) -> None:
    """Remove THIS rank's result file (and its per-rank GP artifacts) from any
    previous run in ``out_dir``. Follow it with :func:`barrier` before the
    sweep, so that no rank can finish and write before every rank cleared."""
    rank = process_index() if rank is None else rank
    stale = [rank_result_path(out_dir, rank)]
    # Per-rank GP artifacts of an earlier run with a different world size
    # would otherwise pass for this run's.
    stale += [os.path.join(out_dir, f"{key}.rank{rank}.npz")
              for key in ("gp_heatmaps", "gp_class_heatmaps")]
    for path in stale:
        if os.path.exists(path):
            os.remove(path)


def write_rank_result(out_dir: str, res, rank: Optional[int] = None) -> str:
    """Write this rank's SweepResult JSON atomically (to ``.tmp``, then a
    rename: a reader never sees a partial file)."""
    rank = process_index() if rank is None else rank
    os.makedirs(out_dir, exist_ok=True)
    payload = sweep_result_to_dict(res)
    payload["process_id"] = rank
    path = rank_result_path(out_dir, rank)
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)
    return path


def merge_rank_results(out_dir: str, num_processes: int,
                       timeout_s: float = DEFAULT_TIMEOUT_S):
    """Rank 0's side of the shared-directory merge: wait for every rank's
    file (at most ``timeout_s``; a missing rank then raises, naming the
    missing files), then reduce with :func:`merge_sweep_metrics`."""
    paths = [rank_result_path(out_dir, r) for r in range(num_processes)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            raise TimeoutError(f"missing rank results after {timeout_s:.0f}s: "
                               f"{[p for p in paths if not os.path.exists(p)]}")
        time.sleep(0.5)
    parts = []
    for p in paths:
        with open(p) as f:
            parts.append(sweep_result_from_dict(json.load(f)))
    return merge_sweep_metrics(parts)


def merge_sweep_metrics(results):
    """Reduce per-process SweepResults: counters summed, means weighted by
    their counts, the p50 pooled over every row's latency, the fidelity
    means from the merged rows."""
    from network_interpretation_imagenet_tpu_torch.saliency.sweep import (
        SweepResult,
        _finalize_fidelity_means,
    )

    out = SweepResult()
    total_iou_w = 0.0
    total_surv_w = 0.0
    for r in results:
        out.images_total += r.images_total
        out.images_explained += r.images_explained
        out.images_skipped_misclassified += r.images_skipped_misclassified
        out.images_failed += r.images_failed
        out.per_image.extend(r.per_image)
        iou_n = sum(1 for row in r.per_image if "iou" in row)
        out.mean_iou += r.mean_iou * iou_n
        total_iou_w += iou_n
        out.mean_survival += r.mean_survival * r.images_explained
        total_surv_w += r.images_explained
    out.mean_iou = out.mean_iou / total_iou_w if total_iou_w else 0.0
    out.mean_survival = out.mean_survival / total_surv_w if total_surv_w else 0.0
    # The pooled p50 over every image's latency (rows carry "seconds"); a
    # median of the medians for results whose rows carry none.
    pooled = sorted(row["seconds"] for r in results for row in r.per_image if "seconds" in row)
    if pooled:
        out.p50_latency_s = pooled[len(pooled) // 2]
    else:
        lats = [r.p50_latency_s for r in results if r.p50_latency_s > 0]
        out.p50_latency_s = sorted(lats)[len(lats) // 2] if lats else 0.0
    out.evals_per_sec = sum(r.evals_per_sec for r in results)
    _finalize_fidelity_means(out)
    return out
