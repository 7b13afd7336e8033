"""Weights across formats (port of ``utils/convert.py`` of the JAX package).

Three formats meet here:

  * torch checkpoints (``.pth``, ``.pth.tar``, ``.tar``): the reference's own
    (``{'model': sd}`` for MNIST, ``{'state_dict': sd}`` with DataParallel's
    ``module.`` prefix for CIFAR) and torchvision's. The port's modules keep
    torchvision's and the reference's key names, so :func:`convert_checkpoint`
    only unwraps them and renames the reference era's dotted DenseNet keys
    (``norm.1`` -> ``norm1``).
  * flax variables, ``{"params": ..., "batch_stats": ...}`` as nested dicts of
    numpy arrays: the JAX package's weights. :func:`from_jax` maps them onto
    a port ``state_dict`` of any family through the module's ``torch_name``;
    :func:`jax_variables` is the inverse, through its ``flax_paths``. Layout: conv kernel HWIO [kH, kW, I, O] <->
    weight OIHW [O, I, kH, kW] (a grouped or depthwise kernel [kH, kW, I/g, O]
    <-> [O, I/g, kH, kW] by the same transpose); dense kernel [in, out] <->
    weight [out, in]; BatchNorm scale / bias / mean / var <-> weight / bias /
    running_mean / running_var.
  * the JAX package's torch-free weights artifact: a directory holding
    ``weights.msgpack`` (flax's msgpack serialization of the variables) and
    ``meta.json`` (``format: nit-weights-v1``, the arch flags). The port reads
    and writes it with its own codec for exactly the msgpack subset flax
    writes (maps, strings, and each array as extension type 1, a numpy
    scalar as type 3, holding ``(shape, dtype name, bytes)``), so neither
    package needs the other, nor ``msgpack`` or ``flax``: an artifact written
    by either loads in the other bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import parts_of
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import torch_name

WEIGHTS_FILE = "weights.msgpack"
META_FILE = "meta.json"
FORMAT = "nit-weights-v1"

# --- torch checkpoints -------------------------------------------------------------

# torchvision's own rule for its DenseNet checkpoints of the reference's era.
_DOTTED_DENSE = re.compile(
    r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|running_mean"
    r"|running_var|num_batches_tracked))$")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's flat ``{name: tensor}``: its ``model`` or
    ``state_dict`` entry, or the whole file, with DataParallel's ``module.``
    prefix stripped (JAX ``utils/convert.py:25-45``). Read with
    ``weights_only=True``: tensors, numbers, strings and containers only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = (blob.get("model") or blob.get("state_dict") or blob) if isinstance(blob, dict) else blob
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def meta_module(arch: str, depth: int = 56, bn_size: int = 4, **kw) -> nn.Module:
    """``arch``'s module on the meta device (names, no storage)."""
    from network_interpretation_imagenet_tpu_torch.models import create_model

    with torch.device("meta"):
        return create_model(arch, depth=depth, bn_size=bn_size, **kw).module


def convert_checkpoint(path: str, arch: str, depth: int = 56,
                       bn_size: int = 4) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint of ``arch`` (``depth`` and ``bn_size`` for the
    reference's CIFAR ResNet and DenseNet-BC) as the port's ``state_dict``:
    :func:`load_state_dict`, then the reference's dotted DenseNet names
    renamed. Raises ``KeyError`` unless the keys are the module's (its
    optional train-only heads aside; ``num_batches_tracked``, which older
    torch did not save, may be missing)."""
    sd = {}
    for k, v in load_state_dict(path).items():
        m = _DOTTED_DENSE.match(k)
        sd[m.group(1) + m.group(2) if m else k] = v
    module = meta_module(arch, depth, bn_size)
    want = set(module.state_dict())
    optional = getattr(module, "optional_prefixes", ())
    missing = sorted(k for k in want - set(sd)
                     if not k.startswith(optional) and not k.endswith("num_batches_tracked"))
    unexpected = sorted(set(sd) - want)
    if missing or unexpected:
        raise KeyError(f"{path} does not hold {arch} weights: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return sd


# --- flax variables <-> state_dict ----------------------------------------------------


def _from_jax(variables: Mapping[str, Any], name: Callable) -> Dict[str, torch.Tensor]:
    """Walk flax ``params`` (and ``batch_stats``): every conv/dense/BatchNorm
    leaf module at path ``p`` becomes the entries of ``name(p)``."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    def walk(params, stats, path):
        if "kernel" in params:
            k = np.asarray(params["kernel"], np.float32)
            sd[name(path) + ".weight"] = t(np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T)
            if "bias" in params:
                sd[name(path) + ".bias"] = t(params["bias"])
            return
        if "scale" in params:
            n = name(path)
            sd[f"{n}.weight"], sd[f"{n}.bias"] = t(params["scale"]), t(params["bias"])
            sd[f"{n}.running_mean"], sd[f"{n}.running_var"] = t(stats["mean"]), t(stats["var"])
            sd[f"{n}.num_batches_tracked"] = torch.tensor(0)
            return
        for key in params:
            walk(params[key], stats.get(key, {}), path + (key,))

    walk(variables["params"], variables.get("batch_stats", {}), ())
    return sd


def from_jax(variables: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX variables of ``module``'s arch -> its ``state_dict`` entries."""
    return _from_jax(variables, module.torch_name)


def resnet_from_jax(variables) -> Dict[str, torch.Tensor]:
    """An ImageNet ResNet / ResNeXt / Wide-ResNet, or the CIFAR ResNet:
    :func:`from_jax` with no module at hand (their names are one rule)."""
    return _from_jax(variables, torch_name)


def jax_variables(state_dict: Mapping[str, torch.Tensor], module: nn.Module) -> Dict[str, Any]:
    """The JAX package's variables for ``module``'s arch: every conv, dense
    and BatchNorm of ``module.flax_paths()`` from ``state_dict`` (f32 numpy;
    train-only heads, which the JAX model lacks, are left out)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(root, path, leaf, value):
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value.detach().cpu().float().numpy() if
                                isinstance(value, torch.Tensor) else value, np.float32)

    for path in module.flax_paths():
        sub = module.get_submodule(module.torch_name(path))
        n, parts = module.torch_name(path), parts_of(path)
        if isinstance(sub, (nn.Conv2d, nn.Linear)):
            w = state_dict[n + ".weight"]
            w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
            put(params, parts, "kernel", w)
            if n + ".bias" in state_dict:
                put(params, parts, "bias", state_dict[n + ".bias"])
        elif isinstance(sub, nn.BatchNorm2d):
            put(params, parts, "scale", state_dict[n + ".weight"])
            put(params, parts, "bias", state_dict[n + ".bias"])
            put(stats, parts, "mean", state_dict[n + ".running_mean"])
            put(stats, parts, "var", state_dict[n + ".running_var"])
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


# --- msgpack: the subset flax writes --------------------------------------------------

_NDARRAY_EXT, _NPSCALAR_EXT = 1, 3  # flax's ext types: an array, a numpy scalar
_MAX_ARRAY_BYTES = 2 ** 30  # flax splits larger arrays into chunks; none of the models has one


def _head(out: bytearray, n: int, small: int, small_max: int, codes) -> None:
    """A length header: ``small | n`` below ``small_max``, else the first of
    ``codes`` ((code, struct format, limit), ...) whose limit holds ``n``."""
    if small is not None and n < small_max:
        out.append(small | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


_U16, _U32 = 1 << 16, 1 << 32


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode()
    _head(out, len(b), 0xA0, 32, ((0xD9, ">B", 256), (0xDA, ">H", _U16), (0xDB, ">I", _U32)))
    out += b


def _pack_uint(out: bytearray, n: int) -> None:
    if n < 128:
        out.append(n)
        return
    for code, fmt, limit in ((0xCC, ">B", 256), (0xCD, ">H", _U16), (0xCE, ">I", _U32),
                             (0xCF, ">Q", 1 << 64)):
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return


def _pack_array(out: bytearray, a) -> None:
    """Extension type 1 (3 for a numpy scalar) holding msgpack ``(shape,
    dtype name, C-order bytes)``."""
    kind = _NPSCALAR_EXT if isinstance(a, np.generic) else _NDARRAY_EXT
    a = np.asarray(a)
    if a.dtype.hasobject or a.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"msgpack: cannot write a {a.dtype} array of {a.nbytes} bytes")
    body = bytearray()
    _head(body, 3, 0x90, 16, ((0xDC, ">H", _U16),))
    _head(body, a.ndim, 0x90, 16, ((0xDC, ">H", _U16), (0xDD, ">I", _U32)))
    for d in a.shape:
        _pack_uint(body, int(d))
    _pack_str(body, a.dtype.name)
    raw = np.ascontiguousarray(a).tobytes()
    _head(body, len(raw), None, 0, ((0xC4, ">B", 256), (0xC5, ">H", _U16), (0xC6, ">I", _U32)))
    body += raw
    n = len(body)
    if n in (1, 2, 4, 8, 16):
        out.append({1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}[n])
    else:
        _head(out, n, None, 0, ((0xC7, ">B", 256), (0xC8, ">H", _U16), (0xC9, ">I", _U32)))
    out.append(kind)
    out += body


def msgpack_dumps(tree: Mapping[str, Any]) -> bytes:
    """Serialize nested dicts of numpy arrays as the JAX package's
    ``save_weights_artifact`` does (flax's ``msgpack_serialize`` of the
    ``jax.tree.map``-ped tree: every dict's keys in sorted order)."""
    out = bytearray()

    def pack(obj):
        if isinstance(obj, Mapping):
            _head(out, len(obj), 0x80, 16, ((0xDE, ">H", _U16), (0xDF, ">I", _U32)))
            for k in sorted(obj):
                _pack_str(out, str(k))
                pack(obj[k])
        else:
            _pack_array(out, obj if isinstance(obj, np.generic) else np.asarray(obj))

    pack(tree)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return b

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
            n = c & 0x0F if c <= 0x8F else self.num(">H" if c == 0xDE else ">I")
            d = {}
            for _ in range(n):
                k = self.value()
                d[k] = self.value()
            if "__msgpack_chunked_array__" in d:
                raise ValueError("msgpack: chunked arrays (over 1 GiB) are not supported")
            return d
        if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
            n = c & 0x0F if c <= 0x9F else self.num(">H" if c == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
            n = c & 0x1F if c <= 0xBF else self.num({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c])
            return self.take(n).decode()
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(self.num({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c]))
        if c in (0xCC, 0xCD, 0xCE, 0xCF):
            return self.num({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[c])
        if c in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[c]
        if 0xD4 <= c <= 0xD8 or c in (0xC7, 0xC8, 0xC9):
            n = (1 << (c - 0xD4)) if c >= 0xD4 else self.num({0xC7: ">B", 0xC8: ">H",
                                                              0xC9: ">I"}[c])
            kind = self.take(1)[0]
            body = self.take(n)
            if kind not in (_NDARRAY_EXT, _NPSCALAR_EXT):
                raise ValueError(f"msgpack: extension type {kind} is not supported")
            shape, dtype, raw = _Reader(body).value()
            if dtype == "bfloat16":
                raise ValueError("msgpack: bfloat16 arrays are not supported")
            a = np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
            return a[()] if kind == _NPSCALAR_EXT else a
        raise ValueError(f"msgpack: type byte 0x{c:02x} is not supported")


def msgpack_loads(data: bytes) -> Dict[str, Any]:
    """Nested dicts of numpy arrays from flax's msgpack serialization."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return tree


# --- the weights artifact -------------------------------------------------------------


def save_weights_artifact(variables, out_dir: str, meta: Dict[str, Any] = None) -> Dict[str, Any]:
    """Write the JAX package's weights artifact: ``weights.msgpack`` with
    ``variables`` (flax-style nested dicts, numpy or torch leaves; see
    :func:`jax_variables`) and ``meta.json`` (``meta`` plus the format)."""
    def host(tree):
        return {k: host(v) if isinstance(v, Mapping) else
                (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in tree.items()}

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, WEIGHTS_FILE), "wb") as f:
        f.write(msgpack_dumps(host(variables)))
    meta = dict(meta or {})
    meta.setdefault("format", FORMAT)
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def is_weights_artifact(path: str) -> bool:
    if path.endswith(".msgpack"):
        return os.path.isfile(path)
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, WEIGHTS_FILE))


def load_weights_artifact(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(variables, meta)`` from an artifact directory or a bare
    ``.msgpack`` (whose meta is empty)."""
    if os.path.isdir(path):
        weights_path, meta_path = os.path.join(path, WEIGHTS_FILE), os.path.join(path, META_FILE)
    else:
        weights_path, meta_path = path, None
    with open(weights_path, "rb") as f:
        variables = msgpack_loads(f.read())
    meta = {}
    if meta_path and os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return variables, meta
