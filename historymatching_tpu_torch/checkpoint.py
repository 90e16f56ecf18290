"""Checkpoints of ensemble states (PyTorch counterpart of
`historymatching_tpu.checkpoint`, in the same file format).

Format: one .npz holding the leaf arrays under their tree-path names plus
a JSON structure descriptor (`__treespec__`): no pickle, and the arrays
load as plain NumPy anywhere. `load_checkpoint` rebuilds the container
structure that was saved: nested dicts, lists and tuples, Python scalars,
None, and registered NamedTuple or dataclass node types (`SimResult` is
registered; add others with `register_node_type`). Tensors on any device
are saved as NumPy arrays; a `torch.Generator` state (a uint8 tensor) is
an ordinary leaf, restored with `generator.set_state(torch.from_numpy(a))`.
The format is the JAX package's, so a file written by either package loads
in the other. Resume entry point: `da.update.es_mda(..., callback=,
start_pass=)`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

_SEP = "//"

# Structured node types by registered name. NamedTuples rebuild as
# cls(*children), dataclasses as cls(**{field: child}).
_NODE_TYPES: dict = {}


def register_node_type(cls, name=None):
    """Allow `cls` (a NamedTuple or dataclass whose fields are trees of
    arrays) as an interior node of checkpointed states."""
    _NODE_TYPES[name or cls.__name__] = cls
    return cls


def _default_registry():
    from historymatching_tpu_torch.models.ressim import SimResult

    register_node_type(SimResult)


_default_registry()


def _unregistered(kind, tname, name):
    return TypeError(f"unregistered {kind} {tname!r} at {name!r}: call "
                     "checkpoint.register_node_type first")


def _encode(obj, path, leaves):
    """Split `obj` into a JSON spec and named leaf arrays."""
    name = _SEP.join(path) if path else "root"
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, dict):
        keys = list(obj)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpoint dict keys must be str at {name!r}")
        return {"t": "dict", "k": keys,
                "c": [_encode(obj[k], path + [k], leaves) for k in keys]}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        tname = type(obj).__name__
        if tname not in _NODE_TYPES:
            raise _unregistered("NamedTuple", tname, name)
        return {"t": "node", "n": tname,
                "c": [_encode(v, path + [f], leaves) for f, v in zip(obj._fields, obj)]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tname = type(obj).__name__
        if tname not in _NODE_TYPES:
            raise _unregistered("dataclass", tname, name)
        fields = [f.name for f in dataclasses.fields(obj)]
        return {"t": "node", "n": tname, "f": fields,
                "c": [_encode(getattr(obj, f), path + [f], leaves) for f in fields]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "c": [_encode(v, path + [str(i)], leaves) for i, v in enumerate(obj)]}
    arr = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)
    if arr.dtype == object:
        raise TypeError(f"non-array leaf of type {type(obj)} at {name!r}")
    leaves[name] = arr
    return {"t": "leaf", "k": name}


def _decode(spec, data):
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "leaf":
        return data[spec["k"]]
    if t == "dict":
        return {k: _decode(c, data) for k, c in zip(spec["k"], spec["c"])}
    if t == "list":
        return [_decode(c, data) for c in spec["c"]]
    if t == "tuple":
        return tuple(_decode(c, data) for c in spec["c"])
    if t == "node":
        cls = _NODE_TYPES.get(spec["n"])
        if cls is None:
            raise TypeError(f"checkpoint contains unregistered node type {spec['n']!r}: "
                            "call checkpoint.register_node_type before loading")
        children = [_decode(c, data) for c in spec["c"]]
        if "f" in spec:  # dataclass
            return cls(**dict(zip(spec["f"], children)))
        return cls(*children)
    raise ValueError(f"corrupt checkpoint spec node {t!r}")


def save_checkpoint(path, state):
    """Save a tree of arrays and tensors to `path` (.npz), atomically
    (write, then rename). Returns `path`."""
    leaves: dict = {}
    spec = _encode(state, [], leaves)
    if not leaves:
        raise ValueError("empty checkpoint state (no array leaves)")
    arrays = dict(leaves)
    arrays["__treespec__"] = np.asarray(json.dumps(spec))
    tmp = f"{path}.tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to a name without it
    os.replace(tmp if os.path.exists(tmp) else f"{tmp}.npz", path)
    return path


def load_checkpoint(path):
    """Load a checkpoint, rebuilding the saved structure; leaves come back
    as NumPy arrays with the saved bytes. A structureless .npz loads as
    nested dicts of its path-flattened keys."""
    with np.load(path) as data:
        files = dict(data)
    spec_arr = files.pop("__treespec__", None)
    if spec_arr is None:
        out: dict = {}
        for k, v in files.items():
            parts = k.split(_SEP)
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        return out
    return _decode(json.loads(str(spec_arr)), files)
