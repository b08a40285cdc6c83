"""Numpy-backed checkpoints of torch trees, in the reference's on-disk
format (counterpart of ``repro/checkpoint/io.py``), so that each package
reads the other's.

Layout: ``<dir>/manifest.json`` (each leaf's path, dtype and shape, the
caller's metadata, the tree's structure as ``jax.tree_util`` prints it,
the name of the arrays file and its sha256) and ``<dir>/arrays-<step>.npz``
(the leaves in flattening order, keyed ``a<i>``).  bfloat16 leaves are
stored as their uint16 bits and recorded as ``"bfloat16"``.

Writes are atomic at the manifest: the arrays file is written under a
fresh name (temp file, fsync, ``os.replace``), then the manifest, the one
commit point, the same way, and only then are stale arrays files pruned.
A crash at any byte of the sequence leaves the previous (manifest,
arrays) pair intact.  Manifests without an ``arrays`` key point at
``arrays.npz``; manifests without ``sha256`` are not checked.

The engine's :class:`~repro_torch.optim.sequences.FlatState` is written as
the reference's ``FlatState`` is: fields ``vars, mom, step, stale, retry,
ef, deadline``, the step a 0-d int32 leaf, ``retry`` the fault engine's
0-d int32 retry counter (empty without faults).  The port's own field
order (``vars, mom, step, ef, stale, deadline, retry``) is mapped on save
and load.  The unfused path's pytree train states (``FedBiOTrainState``
… ``FedAvgTrainState`` of ``federation/trainer.py``) are written as the
reference's: their empty ``deadline`` and ``retry`` slots, which the
reference's states lack, are left out, and the step is a 0-d int32 leaf.

A state sharded over a mesh of ranks is written whole, as the reference
writes one: ``sharding.rules.gather_state`` assembles its shard-major
[M, N] buffers on rank 0, which saves them here, and on resume rank 0
loads them into ``sharding.rules.whole_like`` and ``scatter_state`` sends
every rank its block (``launch/train.py``).

``experiment=`` (an :class:`repro_torch.api.Experiment`) also writes
``<dir>/experiment.json``, so ``load_experiment(ckpt_dir)`` and
``repro_torch.api.build`` rebuild the run the checkpoint came from.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.tree_util import tree_flatten
from repro_torch.optim.sequences import FlatState

EXPERIMENT_FILE = "experiment.json"


class CheckpointCorruptError(RuntimeError):
    """An arrays file's bytes do not match the sha256 digest recorded in
    the manifest: the checkpoint was damaged at rest (bit rot, a torn copy,
    tampering).  The message names the corrupt file."""


# the reference's FlatState, field for field (repro/optim/sequences.py)
_ReferenceFlatState = NamedTuple("FlatState", [
    ("vars", Any), ("mom", Any), ("step", Any), ("stale", Any),
    ("retry", Any), ("ef", Any), ("deadline", Any)])


_PORT_ONLY = ("deadline", "retry")
_REFERENCE_STATES: Dict[type, type] = {}


def _is_tree_state(tree) -> bool:
    """A pytree train state of the unfused path: a NamedTuple with a host
    ``step`` and empty ``deadline`` and ``retry`` slots."""
    fields = getattr(type(tree), "_fields", ())
    return "step" in fields and all(
        isinstance(getattr(tree, f, None), tuple) and not getattr(tree, f)
        for f in _PORT_ONLY)


def _reference_state(cls) -> type:
    """The reference's class of the same name: ``cls``'s fields without
    the port's own slots."""
    if cls not in _REFERENCE_STATES:
        _REFERENCE_STATES[cls] = NamedTuple(cls.__name__, [
            (f, Any) for f in cls._fields if f not in _PORT_ONLY])
    return _REFERENCE_STATES[cls]


def _to_reference(tree):
    if isinstance(tree, FlatState):
        return _ReferenceFlatState(
            vars=tree.vars, mom=tree.mom,
            step=torch.tensor(tree.step, dtype=torch.int32),
            stale=tree.stale, retry=tree.retry, ef=tree.ef,
            deadline=tree.deadline)
    if _is_tree_state(tree):
        ref = _reference_state(type(tree))
        return ref(**{f: getattr(tree, f) for f in ref._fields})._replace(
            step=torch.tensor(int(tree.step), dtype=torch.int32))
    return tree


def _from_reference(tree, like):
    if isinstance(like, FlatState):
        return FlatState(vars=tree.vars, mom=tree.mom, step=int(tree.step),
                         ef=tree.ef, stale=tree.stale,
                         deadline=tree.deadline, retry=tree.retry)
    if _is_tree_state(like):
        return like._replace(**{**tree._asdict(), "step": int(tree.step)})
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_replace(path: str, write_fn):
    """Write through ``write_fn(open file)`` into a sibling temp file, fsync
    it and ``os.replace`` it over ``path``: readers see the old bytes or the
    new ones, never a partial write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        write_fn(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _host_array(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir: str, tree: Any, metadata: Optional[Dict] = None,
                    *, experiment: Any = None):
    """Write ``tree`` (tensors on any device) and ``metadata`` (JSON) into
    ``ckpt_dir``; the arrays file is named after ``metadata["step"]``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if experiment is not None:
        _atomic_replace(os.path.join(ckpt_dir, EXPERIMENT_FILE),
                        lambda fh: fh.write(
                            (experiment.to_json() + "\n").encode()))
    leaves, treedef = tree_flatten(_to_reference(tree))
    arrays, manifest_leaves = {}, []
    for i, (path, leaf) in enumerate(zip(treedef.paths(), leaves)):
        t = torch.as_tensor(leaf)
        arr = _host_array(t)
        arrays[f"a{i}"] = arr
        manifest_leaves.append({"path": path, "dtype": _dtype_name(t.dtype),
                                "shape": list(arr.shape)})
    arrays_name = f"arrays-{int((metadata or {}).get('step', 0)):08d}.npz"
    arrays_path = os.path.join(ckpt_dir, arrays_name)
    _atomic_replace(arrays_path, lambda fh: np.savez(fh, **arrays))
    del arrays
    manifest = {"leaves": manifest_leaves, "metadata": metadata or {},
                "treedef": str(treedef), "arrays": arrays_name,
                "sha256": {arrays_name: _sha256(arrays_path)}}
    _atomic_replace(os.path.join(ckpt_dir, "manifest.json"),
                    lambda fh: fh.write(json.dumps(manifest, indent=1)
                                        .encode()))
    for name in os.listdir(ckpt_dir):
        if (name.startswith("arrays") and name != arrays_name
                and (name.endswith(".npz") or name.endswith(".tmp"))):
            os.remove(os.path.join(ckpt_dir, name))


def load_checkpoint(ckpt_dir: str, like: Any) -> Any:
    """Restore the checkpoint into ``like``: each leaf is copied in place
    into ``like``'s tensor, on its device and in its dtype, and ``like``'s
    structure is returned with those tensors (a ``FlatState``'s step as an
    int).  Raises if the digest, the number of leaves, or a leaf's shape or
    dtype differs."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    arrays_name = manifest.get("arrays", "arrays.npz")
    arrays_path = os.path.join(ckpt_dir, arrays_name)
    want = (manifest.get("sha256") or {}).get(arrays_name)
    if want is not None:
        got = _sha256(arrays_path)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint arrays file {arrays_path} is corrupt: sha256 "
                f"{got[:16]}... does not match the manifest's "
                f"{want[:16]}... — the file was damaged at rest (bit rot, "
                f"torn copy, tampering); restore it from a replica or "
                f"delete the checkpoint and restart from an earlier one")
    leaves, treedef = tree_flatten(_to_reference(like))
    metas = manifest["leaves"]
    if len(leaves) != len(metas):
        raise ValueError(f"checkpoint has {len(metas)} leaves, target "
                         f"structure has {len(leaves)}")
    paths = treedef.paths()
    with np.load(arrays_path) as data:
        for i, (leaf, meta) in enumerate(zip(leaves, metas)):
            if not torch.is_tensor(leaf):
                raise TypeError(f"leaf {paths[i]} of the target is "
                                f"{type(leaf).__name__}, not a tensor")
            if (meta["dtype"] != _dtype_name(leaf.dtype)
                    or list(meta["shape"]) != list(leaf.shape)):
                raise ValueError(
                    f"checkpoint leaf {meta['path']} is {meta['dtype']} "
                    f"{meta['shape']}, the target's {paths[i]} is "
                    f"{_dtype_name(leaf.dtype)} {list(leaf.shape)}")
            arr = data[f"a{i}"]
            if meta["dtype"] == "bfloat16":
                src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                src = torch.from_numpy(arr)
            leaf.copy_(src.reshape(leaf.shape))
            del arr, src
    return _from_reference(treedef.unflatten(leaves), like)


def checkpoint_metadata(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        return json.load(fh)["metadata"]


def load_experiment(ckpt_dir: str):
    """The :class:`repro_torch.api.Experiment` embedded in a checkpoint, or
    None for a checkpoint written without one."""
    path = os.path.join(ckpt_dir, EXPERIMENT_FILE)
    if not os.path.exists(path):
        return None
    from repro_torch.api.spec import Experiment
    return Experiment.load(path)
