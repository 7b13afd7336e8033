"""Checkpoint save/restore with the reference's best-copy semantics (port of
``utils/checkpoint.py`` of the JAX package, single process).

The directory layout and the crash-safe swap are the JAX package's: a
checkpoint ``<dir>/<name>`` is written in full under ``<name>.new``, marked
complete (``nit_complete``) and only then renamed into place, so a crash at
any point leaves the old checkpoint or a marked ``.new`` that restore falls
back to; ``model_best`` is a marked copy. Arrays go into ``arrays.npz``
(nested dicts flattened with ``/`` in the keys), which numpy and torch both
read; string and JSON-scalar entries go to ``nit_meta.json``. Reading the
JAX package's Orbax checkpoints is not part of this module.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

_ARRAYS = "arrays.npz"
_MARKER = "nit_complete"
_META = "nit_meta.json"


def _is_complete(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, _MARKER))


def _is_json_scalar_tree(v) -> bool:
    if isinstance(v, dict):
        return all(_is_json_scalar_tree(x) for x in v.values())
    return v is None or isinstance(v, (str, bool, int, float))


def _split_meta(state: Dict[str, Any]):
    """Top-level strings, None and dicts of JSON scalars go to the JSON
    sidecar; numbers and array trees to the npz."""
    arrays, meta = {}, {}
    for k, v in state.items():
        if isinstance(v, bytes):
            meta[k] = v.decode()
        elif _is_json_scalar_tree(v) and not isinstance(v, (int, float, bool)):
            meta[k] = v
        else:
            arrays[k] = v
    return arrays, meta


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"checkpoint key {k!r} holds '/', the nesting separator")
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
    return flat


def _unflatten(flat) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def _mark(ckpt_dir: str) -> None:
    with open(os.path.join(ckpt_dir, _MARKER), "w") as f:
        f.write("ok")


def _replace(src: str, dst: str) -> None:
    """Move the complete ``src`` into ``dst``'s place. ``dst``'s marker goes
    first: rmtree removes the array file before the top-level files, so a
    kill during it would otherwise leave a torn dir that looks complete."""
    if os.path.exists(dst):
        old_marker = os.path.join(dst, _MARKER)
        if os.path.exists(old_marker):
            os.remove(old_marker)
        shutil.rmtree(dst)
    os.rename(src, dst)


def _clear_stale(path: str) -> None:
    """Before a new write to ``path``: a marked ``.new`` beside an unmarked
    ``path`` is the only complete checkpoint left by a save that died inside
    its swap, so it is promoted; any other ``.new`` is a torn write and goes."""
    tmp = path + ".new"
    if os.path.exists(tmp):
        if _is_complete(tmp) and not _is_complete(path):
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        else:
            shutil.rmtree(tmp)


def save_checkpoint(state: Dict[str, Any], save_dir: str, is_best: bool = False,
                    name: str = "checkpoint") -> str:
    """Save a dict of arrays, tensors, nested dicts and JSON metadata under
    ``save_dir/name``; mirror it to ``save_dir/model_best`` when ``is_best``.
    Returns the checkpoint's path."""
    path = os.path.abspath(os.path.join(save_dir, name))
    tmp = path + ".new"
    _clear_stale(path)
    os.makedirs(tmp)
    arrays, meta = _split_meta(state)
    np.savez(os.path.join(tmp, _ARRAYS), **_flatten(arrays))
    if meta:
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
    _mark(tmp)
    _replace(tmp, path)
    if is_best:
        best = os.path.abspath(os.path.join(save_dir, "model_best"))
        _clear_stale(best)
        # Copy without the marker (copytree's order is arbitrary, so the
        # marker must not be able to precede the payload), then mark.
        shutil.copytree(path, best + ".new", ignore=shutil.ignore_patterns(_MARKER))
        _mark(best + ".new")
        _replace(best + ".new", best)
    return path


def restore_checkpoint(save_dir: str, name: str = "checkpoint") -> Optional[Dict[str, Any]]:
    """The saved state (numpy arrays and metadata), or None if absent. A
    marked ``<name>`` is complete; else a marked ``<name>.new`` (a save that
    died inside its swap); else an unmarked ``<name>`` is a checkpoint from
    before the marker and is trusted as it is."""
    path = os.path.abspath(os.path.join(save_dir, name))
    if not _is_complete(path):
        if _is_complete(path + ".new"):
            path = path + ".new"
        elif not os.path.exists(path):
            return None
    with np.load(os.path.join(path, _ARRAYS), allow_pickle=False) as flat:
        out = _unflatten(flat)
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out.update(json.load(f))
    return out
